"""Stats logging: per-worker JSON writer + cross-worker aggregator.

Same filesystem coordination protocol as the reference
(rom1504/clip-retrieval `clip_retrieval/clip_inference/logger.py`): each partition
accumulates stat dicts and writes `stats/wip_<id>.json` every ~5 s, renamed
to `<id>.json` on completion; a reader process/thread polls the folder,
aggregates across workers, derives sample/s, and prints a progress line
(+ optional wandb when available). Write-then-rename keeps readers safe
without locks — the concurrency model the reference relies on.

Copy of `clip_retrieval_tpu/inference/logger.py`.  Background work uses
daemon threads instead of spawned processes: the writer only serializes
small dicts.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import defaultdict


class LoggerWriter:
    """Accumulates per-batch stats for one partition, writes stats JSON."""

    def __init__(self, partition_id: int, stats_folder: str):
        self.partition_id = partition_id
        self.stats_folder = stats_folder
        self.queue: queue.Queue = queue.Queue()
        self.thread: threading.Thread | None = None

    def start(self):
        self.thread = threading.Thread(target=self._updater, daemon=True)
        self.thread.start()

    def end(self):
        self.queue.put(None)
        if self.thread is not None:
            self.thread.join()

    def __call__(self, stats: dict[str, float]):
        self.queue.put(stats)

    def _updater(self):
        import fsspec

        totals: dict[str, float] = defaultdict(float)
        fs, path = fsspec.core.url_to_fs(self.stats_folder)
        last_write = 0.0
        while True:
            item = self.queue.get()
            if item is None:
                self._write(totals, fs, path, wip=False)
                return
            for k, v in item.items():
                totals[k] += v
            if time.time() - last_write > 5:
                self._write(totals, fs, path, wip=True)
                last_write = time.time()

    def _write(self, totals, fs, path, wip: bool):
        fs.makedirs(path, exist_ok=True)
        wip_file = f"{path}/wip_{self.partition_id}.json"
        target = wip_file if wip else f"{path}/{self.partition_id}.json"
        # write-then-rename so the polling reader never observes partial
        # JSON (the .tmp suffix keeps it outside the reader's *.json glob)
        tmp = target + ".tmp"
        with fs.open(tmp, "w") as f:
            f.write(json.dumps(totals))
        fs.mv(tmp, target)
        if not wip and fs.exists(wip_file):
            fs.rm(wip_file)


class LoggerReader:
    """Polls stats/*.json across workers, prints aggregate progress."""

    def __init__(
        self,
        stats_folder: str,
        wandb_project: str = "clip_retrieval",
        enable_wandb: bool = False,
    ):
        self.stats_folder = stats_folder
        self.enable_wandb = enable_wandb
        self.wandb_project = wandb_project
        self.stop_event = threading.Event()
        self.thread: threading.Thread | None = None
        self.start_time: float | None = None

    def start(self):
        self.start_time = time.time()
        self.thread = threading.Thread(target=self._reader, daemon=True)
        self.thread.start()

    def end(self):
        self.stop_event.set()
        if self.thread is not None:
            self.thread.join()

    def _read_stats(self, fs, path) -> dict[str, dict]:
        stats: dict[str, dict] = {}
        try:
            files = fs.glob(path + "/*.json")
        except Exception:
            return stats
        for fp in files:
            name = fp.split("/")[-1].replace(".json", "")
            for _ in range(5):  # retry partial reads (writer may be mid-write)
                try:
                    with fs.open(fp, "r") as f:
                        stats[name.replace("wip_", "")] = json.loads(f.read())
                    break
                except Exception:
                    time.sleep(0.1)
        return stats

    def _aggregate(self, per_worker: dict[str, dict]) -> dict[str, float]:
        agg: dict[str, float] = defaultdict(float)
        for st in per_worker.values():
            for k, v in st.items():
                agg[k] += v
        elapsed = time.time() - (self.start_time or time.time())
        agg["worker_count"] = len(per_worker)
        if elapsed > 0:
            agg["sample_per_sec"] = agg.get("sample_count", 0) / elapsed
        for stage in ("read", "inference", "write"):
            total = agg.get("total_duration", 0)
            if total > 0:
                agg[f"{stage}_share"] = agg.get(f"{stage}_duration", 0) / total
        return dict(agg)

    def _reader(self):
        import fsspec

        fs, path = fsspec.core.url_to_fs(self.stats_folder)
        wandb_run = None
        if self.enable_wandb:
            try:
                import wandb

                wandb_run = wandb.init(project=self.wandb_project)
            except Exception as e:  # not just ImportError: a login/network
                # failure must degrade to stdout-only, not kill the reader
                print(f"wandb unavailable ({e}); disabling wandb logging")
        last: dict[str, float] = {}
        while True:
            stopped = self.stop_event.wait(timeout=1.0)
            agg = self._aggregate(self._read_stats(fs, path))
            # compare ignoring wall-clock-derived fields: sample_per_sec
            # changes every tick even with no new data, which would spam a
            # progress line + wandb step per second on stalled runs
            changed = {
                k: v for k, v in agg.items() if k != "sample_per_sec"
            } != {k: v for k, v in last.items() if k != "sample_per_sec"}
            if agg.get("sample_count", 0) and (changed or stopped):
                print(
                    f"sample_count={int(agg['sample_count'])} "
                    f"sample_per_sec={agg['sample_per_sec']:.1f} "
                    f"workers={int(agg['worker_count'])} "
                    f"read={agg.get('read_share', 0):.0%} "
                    f"infer={agg.get('inference_share', 0):.0%} "
                    f"write={agg.get('write_share', 0):.0%}",
                    flush=True,
                )
                if wandb_run is not None:
                    wandb_run.log(agg)
                last = agg
            if stopped:
                break
        if wandb_run is not None:
            wandb_run.finish()
