"""The port's scale-out of batch inference against the JAX package, on the CPU:
`parallel/dist.py` (`get_task_list`, `init_pod`), the pod and Spark
distributors, the SLURM distributor (each case of
tests/test_inference/test_slurm.py, with the same fake sbatch/squeue/sacct/
scancel binaries) and the `inference.slurm_worker` rank entry.

The multi-rank runs start each rank as its own process (`RANK`/`WORLD_SIZE`/
`LOCAL_RANK`, or `SLURM_PROCID`/`SLURM_NTASKS`/`SLURM_LOCALID`) over the
test-tiny model with random weights, one thread each, with a timeout; the
ranks coordinate only through the output folder, so the partitions they
write together must equal, bit for bit, those of one sequential run in the
same conditions.
"""

import json
import os
import stat
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from clip_retrieval_tpu.parallel.dist import get_task_list as jax_get_task_list
from clip_retrieval_tpu_torch.inference import distributor as tdist
from clip_retrieval_tpu_torch.inference.slurm import SlurmDistributor
from clip_retrieval_tpu_torch.parallel import dist as pdist
from clip_retrieval_tpu_torch.parallel.dist import get_task_list, init_pod

from tests.test_inference.fixtures import make_files_corpus

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240
RANK_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS",
            "SLURM_LOCALID")


# -- the rank math and init_pod -----------------------------------------------


@pytest.mark.parametrize("num_tasks", [0, 1, 5, 7, 16, 33])
@pytest.mark.parametrize("world", [1, 2, 3, 8])
def test_get_task_list_matches_jax(num_tasks, world):
    blocks = [get_task_list(num_tasks, world, r) for r in range(world)]
    assert blocks == [jax_get_task_list(num_tasks, world, r) for r in range(world)]
    assert [t for b in blocks for t in b] == list(range(num_tasks))
    with pytest.raises(ValueError):
        get_task_list(num_tasks, 0, 0)


@pytest.fixture
def clean_env(monkeypatch):
    for name in RANK_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,want", [({}, (0, 1)), ({"RANK": "1", "WORLD_SIZE": "3"}, (1, 3)),
                                      ({"SLURM_PROCID": "2", "SLURM_NTASKS": "4"}, (2, 4)),
                                      ({"RANK": "0", "WORLD_SIZE": "2", "SLURM_PROCID": "5", "SLURM_NTASKS": "8"},
                                       (0, 2))])
def test_init_pod_reads_the_launcher(clean_env, env, want):
    """Without a rendezvous address no group is opened: the ranks of a batch
    job coordinate through the filesystem."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert init_pod() == want
    assert not torch.distributed.is_initialized()


def test_init_pod_rejects_a_rank_outside_the_world(clean_env):
    clean_env.setenv("RANK", "2")
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="outside a world of 2"):
        init_pod()


def test_init_pod_joins_the_group_and_raises_when_the_rendezvous_fails(clean_env):
    calls = []

    def fake_init(backend, **kw):
        calls.append((backend, kw))
        raise RuntimeError("rendezvous timed out")

    clean_env.setattr(torch.distributed, "init_process_group", fake_init)
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in {"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        clean_env.setenv(k, v)
    with pytest.raises(RuntimeError, match="rendezvous timed out"):
        init_pod()
    assert calls == [("gloo", {"init_method": "env://", "rank": 1, "world_size": 2, "timeout": pdist.PG_TIMEOUT})]
    clean_env.setenv("WORLD_SIZE", "1")  # a world of one opens no group
    clean_env.setenv("RANK", "0")
    assert init_pod() == (0, 1) and len(calls) == 1


def test_local_rank_and_device_binding(clean_env):
    assert pdist.local_rank() == 0
    clean_env.setenv("SLURM_LOCALID", "3")
    assert pdist.local_rank() == 3
    clean_env.setenv("LOCAL_RANK", "5")
    assert pdist.local_rank() == 5
    bound = []
    clean_env.setattr(torch.cuda, "set_device", bound.append)
    pdist.bind_local_device("cpu", 5)
    pdist.bind_local_device("cuda", 5)
    assert bound == [5]


# -- the SLURM distributor: each case of tests/test_inference/test_slurm.py ----


def _make_distributor(tmp_path, **overrides):
    args = {
        "slurm_job_name": "myjob",
        "slurm_partition": "gpu",
        "slurm_nodes": 3,
        "slurm_job_comment": "quota:research",
        "slurm_nodelist": None,
        "slurm_exclude": "node[7-9]",
        "slurm_job_timeout": 120,
        "slurm_cache_path": str(tmp_path / "slurm"),
        "slurm_verbose_wait": False,
        "batch_size": 4,
    }
    args.update(overrides)
    return SlurmDistributor(tasks=[0, 1, 2], worker_args=args)


def _fake_bin(path, name, body):
    p = path / name
    p.write_text("#!/bin/bash\n" + body)
    p.chmod(p.stat().st_mode | stat.S_IEXEC)


@pytest.fixture
def bindir(tmp_path, monkeypatch):
    d = tmp_path / "bin"
    d.mkdir()
    monkeypatch.setenv("PATH", f"{d}:{os.environ['PATH']}")
    return d


def test_sbatch_script_rendering(tmp_path):
    """The script runs the port's rank entry with one task per GPU, 8 per
    node, as the reference's did (the JAX package asks for one per host)."""
    dist = _make_distributor(tmp_path)
    args_path, sbatch_path = dist._write_inputs()
    script = open(sbatch_path).read()
    assert script.startswith("#!/bin/bash\n")
    for line in ("#SBATCH --job-name=myjob", "#SBATCH --nodes=3", "#SBATCH --ntasks-per-node=8",
                 "#SBATCH --gres=gpu:8", "#SBATCH --exclusive", "#SBATCH --partition=gpu",
                 "#SBATCH --comment=quota:research", "#SBATCH --exclude=node[7-9]"):
        assert line + "\n" in script
    assert "--ntasks-per-node=1" not in script and "--nodelist" not in script  # unset options are omitted
    assert (f"srun python -m clip_retrieval_tpu_torch.inference.slurm_worker --worker_args_path={args_path}"
            in script)
    payload = json.load(open(args_path))
    assert payload == {"tasks": [0, 1, 2], "worker_args": {"batch_size": 4}}  # slurm_* keys stripped


def test_submit_and_poll(tmp_path, bindir):
    state = tmp_path / "squeue_calls"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 4242"\n')
    _fake_bin(bindir, "squeue", f'if [ ! -f {state} ]; then touch {state}; echo "4242 R"; fi\n')
    _fake_bin(bindir, "sacct", 'echo "COMPLETED"\n')
    _make_distributor(tmp_path)()  # returns once squeue shows the job gone


def test_finish_raises_on_failed_state(tmp_path, bindir):
    state = tmp_path / "sq"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 99"\n')
    _fake_bin(bindir, "squeue", f'if [ ! -f {state} ]; then touch {state}; echo "99 R"; fi\n')
    _fake_bin(bindir, "sacct", 'echo "NODE_FAIL"\n')
    with pytest.raises(RuntimeError, match="NODE_FAIL"):
        _make_distributor(tmp_path)()


def test_finish_retries_lagging_sacct(tmp_path, bindir, monkeypatch):
    lag = tmp_path / "lag"
    _fake_bin(bindir, "sacct", f'if [ ! -f {lag} ]; then touch {lag}; echo "RUNNING"; else echo "COMPLETED"; fi\n')
    monkeypatch.setattr("time.sleep", lambda s: None)
    _make_distributor(tmp_path)._finish("5", "test")  # lag then COMPLETED -> no raise


def test_finish_raises_on_persistent_non_terminal(tmp_path, bindir, monkeypatch):
    _fake_bin(bindir, "sacct", 'echo "RUNNING"\n')
    monkeypatch.setattr("time.sleep", lambda s: None)
    with pytest.raises(RuntimeError, match="RUNNING"):
        _make_distributor(tmp_path)._finish("6", "test")


def test_finish_best_effort_without_sacct(tmp_path, bindir, monkeypatch):
    monkeypatch.setenv("PATH", str(bindir))  # empty: sacct lookup fails
    monkeypatch.setattr("time.sleep", lambda s: None)
    _make_distributor(tmp_path)._finish("7", "test")  # no raise


def test_sbatch_federated_output_parses(tmp_path, bindir):
    state = tmp_path / "sq2"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 4242 on cluster gpu"\n')
    _fake_bin(bindir, "squeue", f'if [ ! -f {state} ]; then touch {state}; echo "4242 R"; fi\n')
    _fake_bin(bindir, "sacct", 'echo "COMPLETED"\n')
    _make_distributor(tmp_path)()


def test_unknown_job_id_fails_fast(tmp_path, bindir, monkeypatch):
    cancel_log = tmp_path / "scancel.log"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 13"\n')
    _fake_bin(bindir, "squeue", 'echo "slurm_load_jobs error: Invalid job id specified" >&2\nexit 1\n')
    _fake_bin(bindir, "scancel", f'echo "$@" >> {cancel_log}\n')
    slept = []
    monkeypatch.setattr("time.sleep", lambda s: slept.append(s))
    with pytest.raises(RuntimeError, match="does not recognize job 13"):
        _make_distributor(tmp_path)()
    assert len(slept) < 10  # short lag window, not the 30x10s outage loop
    assert cancel_log.read_text().split() == ["13"]


def test_transient_invalid_job_id_recovers(tmp_path, bindir, monkeypatch):
    count = tmp_path / "polls"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 15"\n')
    _fake_bin(
        bindir, "squeue",
        f'echo x >> {count}\n'
        f'if [ "$(wc -l < {count})" -le 2 ]; then '
        'echo "slurm_load_jobs error: Invalid job id specified" >&2; exit 1; fi\n'
        f'if [ "$(wc -l < {count})" -le 3 ]; then echo "15 R"; fi\n',
    )
    _fake_bin(bindir, "sacct", 'echo "COMPLETED"\n')
    monkeypatch.setattr("time.sleep", lambda s: None)
    _make_distributor(tmp_path)()  # no raise


def test_invalid_job_id_after_sighting_verifies_via_sacct(tmp_path, bindir):
    state = tmp_path / "seen"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 14"\n')
    _fake_bin(bindir, "squeue", f'if [ ! -f {state} ]; then touch {state}; echo "14 R"; exit 0; fi\n'
                                'echo "slurm_load_jobs error: Invalid job id specified" >&2\nexit 1\n')
    _fake_bin(bindir, "sacct", 'echo "COMPLETED"\n')
    _make_distributor(tmp_path)()  # no raise


def test_timeout_cancels_job(tmp_path, bindir):
    cancel_log = tmp_path / "scancel.log"
    _fake_bin(bindir, "sbatch", 'echo "Submitted batch job 7"\n')
    _fake_bin(bindir, "squeue", 'echo "7 R"\n')  # never finishes
    _fake_bin(bindir, "sacct", 'echo "CANCELLED"\n')
    _fake_bin(bindir, "scancel", f'echo "$@" > {cancel_log}\n')
    with pytest.raises(TimeoutError):
        _make_distributor(tmp_path, slurm_job_timeout=0)()
    assert cancel_log.read_text().strip() == "7"


def test_main_hands_the_slurm_options_to_the_distributor(tmp_path, monkeypatch):
    """`inference --distribution_strategy slurm` carries the slurm_* options
    to the distributor and the rest (device included) to the ranks."""
    from clip_retrieval_tpu_torch.inference import main as tmain

    seen = {}

    def fake_make(strategy, tasks, worker_args):
        seen.update(strategy=strategy, tasks=tasks, args=dict(worker_args))
        return lambda: None

    monkeypatch.setattr(tmain, "make_distributor", fake_make)
    dataset = make_files_corpus(str(tmp_path / "c"), n=3)
    tmain.main(input_dataset=dataset, output_folder=str(tmp_path / "out"), clip_model="test-tiny",
               distribution_strategy="slurm", slurm_nodes=2, slurm_partition="gpu", device="cpu")
    d = SlurmDistributor(seen["tasks"], seen["args"])
    assert (seen["strategy"], d.nodes, d.partition, d.job_name) == ("slurm", 2, "gpu", "clip-retrieval-tpu-torch")
    assert d.worker_args["device"] == "cpu" and not any(k.startswith("slurm_") for k in d.worker_args)


# -- Spark ---------------------------------------------------------------------


class _FakeRDD:
    def __init__(self, items, slices):
        self.items, self.slices = list(items), slices

    def foreach(self, fn):
        for item in self.items:
            fn(item)


class _FakeSession:
    active = None
    built = []

    def __init__(self):
        self.sparkContext = types.SimpleNamespace(parallelize=self._parallelize)
        self.rdds = []

    def _parallelize(self, items, numSlices):
        self.rdds.append(_FakeRDD(items, numSlices))
        return self.rdds[-1]

    @classmethod
    def getActiveSession(cls):
        return cls.active

    class builder:  # noqa: N801  (pyspark's spelling)
        @staticmethod
        def config(*args):
            _FakeSession.built.append(("config", args))
            return _FakeSession.builder

        @staticmethod
        def master(m):
            _FakeSession.built.append(("master", m))
            return _FakeSession.builder

        @staticmethod
        def appName(name):  # noqa: N802
            _FakeSession.built.append(("appName", name))
            return _FakeSession.builder

        @staticmethod
        def getOrCreate():  # noqa: N802
            _FakeSession.active = _FakeSession()
            return _FakeSession.active


@pytest.mark.parametrize("active", [True, False])
def test_pyspark_distributor_runs_one_spark_task_per_partition(tmp_path, monkeypatch, active):
    """pyspark is an optional dependency: a fake session stands in for it
    (the reference's test runs a real local one), and the real worker
    writes each partition."""
    _FakeSession.active = _FakeSession() if active else None
    _FakeSession.built = []
    sql = types.ModuleType("pyspark.sql")
    sql.SparkSession = _FakeSession
    monkeypatch.setitem(sys.modules, "pyspark", types.ModuleType("pyspark"))
    monkeypatch.setitem(sys.modules, "pyspark.sql", sql)
    dataset = make_files_corpus(str(tmp_path / "c"), n=7, with_text=False)
    out = tmp_path / "out"
    args = {"input_dataset": dataset, "output_folder": str(out), "output_partition_count": 2,
            "num_prepro_workers": 1, "batch_size": 2, "enable_text": False, "enable_image": True,
            "enable_metadata": False, "clip_model": "test-tiny", "device": "cpu"}
    tdist.make_distributor("pyspark", [0, 1], args)()
    rdd = _FakeSession.active.rdds[-1]
    assert (rdd.items, rdd.slices) == ([0, 1], 2)
    assert bool(_FakeSession.built) is not active  # a local session is built only without an active one
    # the modulo sampler: partition 0 gets items 0,2,4,6 and partition 1 gets 1,3,5
    assert np.load(out / "img_emb" / "img_emb_0.npy").shape[0] == 4
    assert np.load(out / "img_emb" / "img_emb_1.npy").shape[0] == 3


# -- multi-rank runs -------------------------------------------------------------


def _spawn(args: list, env: dict) -> subprocess.Popen:
    full = {k: v for k, v in os.environ.items() if k not in RANK_ENV}
    full.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", **env)
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=full, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _wait_all(procs: list) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _inference_args(dataset: str, out: str, strategy: str, partitions: int) -> list:
    return ["-m", "clip_retrieval_tpu_torch.cli", "inference", "--input_dataset", dataset, "--output_folder", out,
            "--clip_model", "test-tiny", "--batch_size", "2", "--num_prepro_workers", "1", "--device", "cpu",
            "--output_partition_count", str(partitions), "--distribution_strategy", strategy]


@pytest.fixture(scope="module")
def sequential_run(tmp_path_factory):
    """9 samples in 3 partitions, written by one sequential process."""
    root = tmp_path_factory.mktemp("ranks")
    dataset = make_files_corpus(str(root / "corpus"), n=9)
    out = str(root / "sequential")
    _wait_all([_spawn(_inference_args(dataset, out, "sequential", 3), {})])
    return dataset, out


def _same_partitions(got: str, want: str, partitions: int = 3):
    for kind in ("img_emb", "text_emb"):
        for i in range(partitions):
            a, b = np.load(f"{got}/{kind}/{kind}_{i}.npy"), np.load(f"{want}/{kind}/{kind}_{i}.npy")
            assert a.dtype == b.dtype == np.float16 and a.shape == b.shape and a.shape[0] == 3
            np.testing.assert_array_equal(a, b, f"{kind} partition {i}")


def test_two_pod_ranks_write_the_sequential_partitions(sequential_run, tmp_path):
    """Two hosts with one card each: RANK 0/1 of WORLD_SIZE 2, LOCAL_RANK 0.
    Rank 0 takes partitions [0, 1] and rank 1 takes [2]."""
    dataset, want = sequential_run
    out = str(tmp_path / "pod")
    logs = _wait_all([_spawn(_inference_args(dataset, out, "pod", 3), {"RANK": str(r), "WORLD_SIZE": "2",
                                                                       "LOCAL_RANK": "0"}) for r in range(2)])
    assert "worker: 2 tasks [0, 1]" in logs[0] and "worker: 1 tasks [2]" in logs[1]
    _same_partitions(out, want)


def test_two_slurm_worker_ranks_write_the_sequential_partitions(sequential_run, tmp_path):
    """`inference.slurm_worker` ranks with SLURM_PROCID/SLURM_NTASKS/
    SLURM_LOCALID set by hand, over the args file the distributor writes."""
    dataset, want = sequential_run
    out = str(tmp_path / "slurm")
    args = {"input_dataset": dataset, "output_folder": out, "output_partition_count": 3, "batch_size": 2,
            "num_prepro_workers": 1, "clip_model": "test-tiny", "device": "cpu",
            "slurm_cache_path": str(tmp_path / "cache")}
    args_path, _ = SlurmDistributor([0, 1, 2], args)._write_inputs()
    logs = _wait_all([_spawn(["-m", "clip_retrieval_tpu_torch.cli", "inference.slurm_worker", "--worker_args_path",
                              args_path], {"SLURM_PROCID": str(r), "SLURM_NTASKS": "2", "SLURM_LOCALID": "0"})
                      for r in range(2)])
    assert "worker: 2 tasks [0, 1]" in logs[0] and "worker: 1 tasks [2]" in logs[1]
    _same_partitions(out, want)


def test_slurm_worker_module_entry_runs_its_rank(tmp_path):
    """`python -m clip_retrieval_tpu_torch.inference.slurm_worker`, the
    command the sbatch script runs, with a rank that owns no task."""
    dataset = make_files_corpus(str(tmp_path / "c"), n=2)
    args_path, _ = SlurmDistributor([0], {"input_dataset": dataset, "output_folder": str(tmp_path / "o"),
                                          "output_partition_count": 1, "clip_model": "test-tiny", "device": "cpu",
                                          "slurm_cache_path": str(tmp_path / "cache")})._write_inputs()
    (log,) = _wait_all([_spawn(["-m", "clip_retrieval_tpu_torch.inference.slurm_worker", "--worker_args_path",
                                args_path], {"SLURM_PROCID": "1", "SLURM_NTASKS": "2"})])
    assert "worker: 0 tasks []" in log and not (tmp_path / "o" / "img_emb").exists()


def test_scale_out_tool_needs_two_cards(capsys):
    """`tools/scale_out.py` measures only what one card cannot: with fewer
    than two visible cards it refuses and measures nothing."""
    from clip_retrieval_tpu_torch.tools import scale_out

    assert scale_out.main([]) == 2
    assert "at least two visible cards" in capsys.readouterr().err
