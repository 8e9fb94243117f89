"""LORE: operator-level dump and replay for debugging, the port of the
JAX package's `utils/lore.py` (reference: lore/GpuLore.scala:30-70,
lore/dump.scala, replay.scala, docs/dev/lore.md).

Every physical operator gets a stable LORE id after planning (pre-order,
the root 1); explain prints it as `[loreId=N]`, the audit's verdicts
and the profiler's records carry it. The ids listed in
`spark.rapids.tpu.sql.lore.idsToDump` dump their INPUT batches as
Parquet under `sql.lore.dumpPath`, so a failing operator can be re-run
alone: `load_input(session, path, lore_id)` reads a dumped input back
as a DataFrame.
"""
from __future__ import annotations

import json
import os

from ..config import LORE_DUMP_IDS, LORE_DUMP_PATH
from ..exec.base import TpuExec

__all__ = ["assign_lore_ids", "apply_lore_dump", "load_input",
           "LoreDumpExec"]


def assign_lore_ids(root: TpuExec) -> None:
    """Stable pre-order ids, like GpuLore.tagForLore."""
    counter = [0]

    def walk(node: TpuExec):
        counter[0] += 1
        node.lore_id = counter[0]
        for c in node.children:
            walk(c)

    walk(root)


class LoreDumpExec(TpuExec):
    """Pass-through operator that writes every batch it forwards, its
    live rows only, as one Parquet file (one D2H copy a batch)."""

    def __init__(self, child: TpuExec, dump_dir: str, lore_id: int,
                 child_idx: int):
        super().__init__([child], child.schema)
        self.dump_dir = dump_dir
        self.lore_id = -lore_id  # not a selectable id itself
        self._base = os.path.join(dump_dir, f"loreId-{lore_id}",
                                  f"input-{child_idx}")
        self._counter = 0

    def num_partitions(self, ctx):
        return self.children[0].num_partitions(ctx)

    def execute_partition(self, ctx, pid):
        import pyarrow.parquet as pq

        from ..exec.nodes import _batch_to_arrow
        os.makedirs(self._base, exist_ok=True)
        for batch in self.children[0].execute_partition(ctx, pid):
            fname = os.path.join(
                self._base, f"part-{pid}-batch-{self._counter}.parquet")
            pq.write_table(_batch_to_arrow(batch), fname)
            self._counter += 1
            yield batch


def apply_lore_dump(root: TpuExec, conf) -> TpuExec:
    """Wrap the children of the selected operators with dump
    pass-throughs, and write `lore-meta.json` (id -> describe)."""
    ids_str = conf.get(LORE_DUMP_IDS)
    if not ids_str:
        return root
    wanted = {int(x) for x in str(ids_str).split(",") if x.strip()}
    dump_path = conf.get(LORE_DUMP_PATH)
    meta = {}

    def walk(node: TpuExec):
        if getattr(node, "lore_id", None) in wanted:
            meta[node.lore_id] = node.describe()
            node.children = [
                LoreDumpExec(c, dump_path, node.lore_id, i)
                for i, c in enumerate(node.children)]
        for c in node.children:
            walk(c)

    walk(root)
    if meta:
        os.makedirs(dump_path, exist_ok=True)
        with open(os.path.join(dump_path, "lore-meta.json"), "w") as f:
            json.dump({str(k): v for k, v in meta.items()}, f, indent=2)
    return root


def load_input(session, dump_path: str, lore_id: int, child_idx: int = 0):
    """Reload a dumped operator input as a DataFrame for replay."""
    base = os.path.join(dump_path, f"loreId-{lore_id}",
                        f"input-{child_idx}")
    return session.read.parquet(base)
