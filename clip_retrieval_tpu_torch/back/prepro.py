"""parquet_to_arrow: one-time serving prep for billion-scale metadata.

Counterpart of `clip_retrieval_tpu/back/prepro.py` (pyarrow only, copied):
streams metadata parquet shards into large arrow IPC files that
`back/metadata.py::ArrowMetadataProvider` mmaps zero-copy at serve time.
Files are split when they exceed `max_rows_per_file`; each parquet read is
retried once (transient fs failures); a failure never leaves a footer-less
.arrow file behind.  It touches no device.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

LOGGER = logging.getLogger("parquet_to_arrow")


def parquet_to_arrow(
    parquet_folder: str,
    output_arrow_folder: str,
    columns_to_return=None,
    max_rows_per_file: int = 10 ** 10,
):
    import pyarrow as pa
    import pyarrow.parquet as pq

    Path(output_arrow_folder).mkdir(parents=True, exist_ok=True)
    files = sorted(Path(parquet_folder).glob("*.parquet"))
    if not files:
        raise ValueError(f"no parquet files in {parquet_folder}")

    writer = None
    sink = None
    file_idx = 0
    rows_in_file = 0
    cur_path = None  # path of the currently-open (footer-less) file

    def open_writer(schema):
        nonlocal writer, sink, file_idx, rows_in_file, cur_path
        writer = None  # if new_file below raises, nothing is half-open
        cur_path = str(Path(output_arrow_folder) / f"{file_idx}.arrow")
        sink = pa.OSFile(cur_path, "wb")
        writer = pa.ipc.new_file(sink, schema)
        file_idx += 1
        rows_in_file = 0

    try:
        for f in files:
            table = None
            last_err = None
            for attempt in range(2):  # retry-once contract
                try:
                    table = pq.read_table(str(f), columns=columns_to_return)
                    break
                except Exception as e:
                    last_err = e
                    LOGGER.warning(
                        "read of %s failed (try %d): %s", f, attempt, e
                    )
                    time.sleep(1)  # the retry exists for transient fs blips
            if table is None:
                raise IOError(f"could not read {f}") from last_err
            if writer is None:
                open_writer(table.schema)
            elif rows_in_file + table.num_rows > max_rows_per_file:
                writer.close()
                sink.close()
                open_writer(table.schema)
            writer.write_table(table)
            rows_in_file += table.num_rows
        if writer is not None:
            writer.close()
            sink.close()
    except BaseException:
        # never leave a footer-less .arrow behind: a truncated IPC file
        # cannot be mmap'd at serve time, and a rerun would pick it up.
        # cur_path tracks the open sink directly — deriving it from
        # file_idx would delete the previous COMPLETE file when the
        # exception lands inside open_writer during rotation
        try:
            if writer is not None:
                writer.close()
            if sink is not None:
                sink.close()
        except Exception:
            pass
        if cur_path is not None and Path(cur_path).exists():
            Path(cur_path).unlink()
        raise
    LOGGER.info("wrote %d arrow file(s)", file_idx)
