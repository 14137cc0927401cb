"""SLURM distributor and rank worker for GPU clusters.

Counterpart of `clip_retrieval_tpu/inference/slurm.py`, with the same
submit/poll/finish state machine.  The distributor writes the worker args to
a JSON file, renders an sbatch script that runs
`python -m clip_retrieval_tpu_torch.inference.slurm_worker` on every rank,
submits it, and polls squeue until the job ends or times out (scancel on
timeout).  The script asks for one task per GPU, 8 per node, as the
reference's did: on GPUs one rank drives one card (the JAX package asks for
one task per TPU host, whose single rank drives all of its cores).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import time
from typing import Any, Sequence

from ..parallel.dist import bind_local_device, get_task_list


class SlurmDistributor:
    def __init__(self, tasks: Sequence[int], worker_args: dict[str, Any]):
        self.tasks = list(tasks)
        self.worker_args = dict(worker_args)
        slurm = {
            k: self.worker_args.pop(k, None)
            for k in (
                "slurm_job_name",
                "slurm_partition",
                "slurm_nodes",
                "slurm_job_comment",
                "slurm_nodelist",
                "slurm_exclude",
                "slurm_job_timeout",
                "slurm_cache_path",
                "slurm_verbose_wait",
            )
        }
        self.job_name = slurm["slurm_job_name"] or "clip-retrieval-tpu-torch"
        self.partition = slurm["slurm_partition"]
        self.nodes = slurm["slurm_nodes"] or 1
        self.job_comment = slurm["slurm_job_comment"]
        self.nodelist = slurm["slurm_nodelist"]
        self.exclude = slurm["slurm_exclude"]
        # `is None` (not `or`): a 0 timeout must mean "fail immediately",
        # not silently become the 2-week default
        self.job_timeout = (
            slurm["slurm_job_timeout"]
            if slurm["slurm_job_timeout"] is not None
            else 60 * 60 * 24 * 14
        )
        self.cache_path = os.path.expanduser(
            slurm["slurm_cache_path"] or "~/.cache/clip_retrieval_tpu_torch/slurm"
        )
        self.verbose_wait = bool(slurm["slurm_verbose_wait"])

    # -- script generation -------------------------------------------------

    def _write_inputs(self) -> tuple[str, str]:
        os.makedirs(self.cache_path, exist_ok=True)
        args_path = os.path.join(self.cache_path, "worker_args.json")
        with open(args_path, "w") as f:
            json.dump(
                {"tasks": self.tasks, "worker_args": self.worker_args}, f
            )
        sbatch_path = os.path.join(self.cache_path, "sbatch_script.sh")
        with open(sbatch_path, "w") as f:
            f.write(self._sbatch_script(args_path))
        return args_path, sbatch_path

    def _sbatch_script(self, args_path: str) -> str:
        lines = [
            "#!/bin/bash",
            f"#SBATCH --job-name={self.job_name}",
            f"#SBATCH --nodes={self.nodes}",
            "#SBATCH --ntasks-per-node=8",  # one rank per GPU
            "#SBATCH --gres=gpu:8",
            "#SBATCH --exclusive",
            f"#SBATCH --output={self.cache_path}/slurm-%j.out",
        ]
        if self.partition:
            lines.append(f"#SBATCH --partition={self.partition}")
        if self.job_comment:
            lines.append(f"#SBATCH --comment={self.job_comment}")
        if self.nodelist:
            lines.append(f"#SBATCH --nodelist={self.nodelist}")
        if self.exclude:
            lines.append(f"#SBATCH --exclude={self.exclude}")
        lines += [
            "",
            f"srun python -m clip_retrieval_tpu_torch.inference.slurm_worker "
            f"--worker_args_path={args_path}",
        ]
        return "\n".join(lines) + "\n"

    # -- submission / polling ---------------------------------------------

    @staticmethod
    def _final_state(job_id: str) -> str | None:
        """Best-effort terminal state via sacct ('COMPLETED', 'FAILED',
        'NODE_FAIL', ...), or None when sacct is unavailable."""
        try:
            r = subprocess.run(
                ["sacct", "-j", job_id, "-n", "-X", "-o", "State"],
                capture_output=True,
                universal_newlines=True,
                timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            return None
        if r.returncode != 0 or not r.stdout.strip():
            return None
        return r.stdout.strip().split()[0].rstrip("+")

    def _finish(self, job_id: str, context: str):
        """Job left the queue: verify it actually COMPLETED when sacct can
        tell us — 'gone from squeue' also covers FAILED/NODE_FAIL/OOM,
        where a clean return would let downstream stages build over
        partial output.

        Semantics, settled: COMPLETED → success.  sacct unavailable after
        retries → success with a caveat (best-effort; the reference never
        verified at all).  ANY other state after the lag-retry window —
        known failure states, REVOKED, a stale RUNNING — raises: when
        accounting contradicts the queue, aborting loudly beats building
        an index over output that may not exist."""
        state = None
        for attempt in range(6):
            state = self._final_state(job_id)
            if state in ("COMPLETED", "COMPLETING"):
                break
            if state is None and attempt >= 2:
                break  # sacct genuinely unavailable → best-effort success
            time.sleep(5)  # slurmdbd can lag squeue (or blip); re-poll
        if state is not None and state not in ("COMPLETED", "COMPLETING"):
            raise RuntimeError(
                f"slurm job {job_id} ended in state {state} ({context})"
            )
        print(f"slurm job {job_id} finished ({context}, state={state})")

    def __call__(self):
        _, sbatch_path = self._write_inputs()
        out = subprocess.check_output(
            ["sbatch", sbatch_path], universal_newlines=True
        )
        # canonical 'Submitted batch job N' only (federated clusters append
        # 'on cluster X'); no loose-digits fallback — guessing a wrong id
        # would poll (and eventually scancel) someone else's job
        m = re.search(r"Submitted batch job (\d+)", out)
        if m is None:
            raise RuntimeError(f"could not parse sbatch output: {out!r}")
        job_id = m.group(1)
        print(f"submitted slurm job {job_id}")
        start = time.time()
        squeue_failures = 0
        invalid_unseen = 0
        seen_running = False
        try:
            while True:
                try:
                    r = subprocess.run(
                        ["squeue", "-j", job_id, "-h"],
                        capture_output=True,
                        universal_newlines=True,
                    )
                    if r.returncode != 0:
                        if "invalid job id" in r.stderr.lower():
                            if seen_running:
                                # record purged past MinJobAge → probably
                                # finished; _finish verifies via sacct (a
                                # lost-state controller restart purges
                                # PENDING jobs too).
                                self._finish(job_id, "purged from squeue")
                                return
                            # never sighted: usually a bad id / lost
                            # controller state — but right after sbatch a
                            # busy/failing-over slurmctld (or a federated
                            # origin routing to a sibling) can briefly not
                            # resolve a job that IS real, so tolerate a
                            # short window before concluding
                            invalid_unseen += 1
                            if invalid_unseen < 6:
                                time.sleep(10)
                                continue
                            # before concluding bad-id, ask accounting: a
                            # short-MinJobAge cluster purges a fast job
                            # from squeue before our first successful poll
                            # ever sights it — sacct still knows it
                            state = self._final_state(job_id)
                            if state in ("COMPLETED", "COMPLETING"):
                                self._finish(
                                    job_id,
                                    "completed before first squeue sighting",
                                )
                                return
                            if state in ("RUNNING", "PENDING", "SUSPENDED"):
                                # real job, squeue lied (federation/lag):
                                # resume polling; a later purge now
                                # resolves through _finish
                                seen_running = True
                                invalid_unseen = 0
                                time.sleep(10)
                                continue
                            if state is not None:
                                raise RuntimeError(
                                    f"slurm job {job_id} ended in state "
                                    f"{state} (never seen in squeue)"
                                )
                            # the job may exist despite squeue's answer
                            # (federation/lag) — cancel best-effort so a
                            # real job doesn't keep running unsupervised
                            subprocess.run(["scancel", job_id], check=False)
                            raise RuntimeError(
                                f"slurm does not recognize job {job_id} "
                                f"(squeue: {r.stderr.strip()!r}) and it was "
                                "never seen in the queue after ~1 min — bad "
                                "job id or controller lost state at submit"
                            )
                        raise subprocess.CalledProcessError(
                            r.returncode, r.args, r.stdout, r.stderr
                        )
                    q = r.stdout.strip()
                    squeue_failures = 0
                except subprocess.CalledProcessError as e:
                    # transient slurmctld outage: retry with backoff
                    squeue_failures += 1
                    if squeue_failures >= 30:
                        # ~5 min of failures could mean the job is STILL
                        # RUNNING — declaring success would let downstream
                        # stages build over partial output. Cancel
                        # best-effort and raise.
                        subprocess.run(["scancel", job_id], check=False)
                        raise RuntimeError(
                            f"squeue failing persistently for job "
                            f"{job_id} ({e.stderr or e}); cancelled and "
                            "aborting rather than assuming completion"
                        )
                    time.sleep(10)
                    continue
                if self.verbose_wait:
                    print(f"squeue: {q!r}")
                if not q:
                    self._finish(job_id, "left the queue")
                    return
                seen_running = True
                if time.time() - start > self.job_timeout:
                    print(f"slurm job {job_id} timed out; cancelling")
                    subprocess.run(["scancel", job_id], check=False)
                    raise TimeoutError(f"slurm job {job_id} timed out")
                time.sleep(1)
        except KeyboardInterrupt:
            subprocess.run(["scancel", job_id], check=False)
            raise


def slurm_worker(worker_args_path: str):
    """Entry run by each srun rank: bind the rank's card, pick a contiguous
    task block and work it.  Rank and world come from SLURM's environment
    (reference `slurm_worker.py:40-61`), or from torchrun's."""
    from .worker import worker

    with open(worker_args_path) as f:
        payload = json.load(f)
    tasks = payload["tasks"]
    worker_args = payload["worker_args"]
    world_size = int(os.environ.get("SLURM_NTASKS", os.environ.get("WORLD_SIZE", 1)))
    rank = int(os.environ.get("SLURM_PROCID", os.environ.get("RANK", 0)))
    bind_local_device(worker_args.get("device", "cuda"), int(os.environ.get("SLURM_LOCALID", 0)))
    mine = get_task_list(len(tasks), world_size, rank)
    worker(tasks=[tasks[i] for i in mine], **worker_args)
