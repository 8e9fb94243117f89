"""Parquet write (reference: GpuParquetFileFormat.scala:48 and
ColumnarOutputWriter.scala): one part file a physical partition and a
`_SUCCESS` marker, the JAX package's `io/parquet.py` layout.

Unlike the JAX `write_parquet`, which executes the partitions without
the stage driver, the port writes through `DataFrame._partition_tables`,
which runs the driver first: every shuffle stage materializes before its
consumer. The rows are the same; on a plan with an exchange, adaptive
coalescing may change how many part files there are.
"""
from __future__ import annotations

import os
import shutil

__all__ = ["write_parquet"]


def write_parquet(df, path: str, mode: str = "overwrite",
                  compression: str = "snappy",
                  row_group_rows: int = 1 << 20):
    import pyarrow.parquet as pq

    if os.path.exists(path):
        if mode == "errorifexists":
            raise FileExistsError(path)
        if mode == "overwrite":
            shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)
    wrote = 0
    for pid, at in df._partition_tables():
        pq.write_table(at, os.path.join(path, f"part-{pid:05d}.parquet"),
                       compression=compression,
                       row_group_size=row_group_rows)
        wrote += 1
    if wrote == 0:  # an empty result still writes its schema
        pq.write_table(df.schema.to_arrow().empty_table(),
                       os.path.join(path, "part-00000.parquet"),
                       compression=compression)
    open(os.path.join(path, "_SUCCESS"), "w").close()
