"""Adaptive execution: post-shuffle partition re-planning.

The port of the JAX package's `exec/aqe.py` (the analog of the
reference's GpuCustomShuffleReaderExec over MapOutputStatistics):

  - A shuffle stage materializes on first demand
    (`ShuffleExchangeExec.stage_stats`), giving the bytes of each reduce
    partition: the stage barrier at which the plan changes.
  - `AqeShufflePlan` computes task groups from those sizes: adjacent
    small partitions COALESCE toward the advisory target; a stream
    partition larger than max(skew_factor x median, skew_min) SPLITS into
    byte-balanced slices (only where splitting is legal for the
    consumer).
  - `AQEShuffleReadExec` serves the re-planned partitions. For a join,
    the stream-side reader serves the split slices while the build-side
    reader (role "build") replays the FULL reduce partition for every
    slice, so each slice probes the complete build partition.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Tuple

from .base import ExecContext, TpuExec

__all__ = ["AqeShufflePlan", "AQEShuffleReadExec"]


class AqeShufflePlan:
    """One re-plan shared by the exchanges that feed one consumer (both
    sides of a join must re-plan identically: one key space)."""

    def __init__(self, exchanges, target_bytes: int, skew_factor: int,
                 skew_min_bytes: int, allow_split: bool,
                 allow_coalesce: bool = True):
        self.exchanges = list(exchanges)
        self.target = max(1, target_bytes)
        self.skew_factor = skew_factor
        self.skew_min = skew_min_bytes
        self.allow_split = allow_split
        self.allow_coalesce = allow_coalesce
        self._groups: Optional[List[List[Tuple[int, int, int]]]] = None
        self._lock = threading.Lock()
        # the decision record, set the one time groups() computes
        self.decision: Optional[dict] = None

    def groups(self, ctx: ExecContext):
        """The task groups, each [(rpid, chunk, nchunks), ...]: a
        coalesced group holds several whole partitions, a split group one
        slice of one partition."""
        with self._lock:
            if self._groups is not None:
                return self._groups
            n = self.exchanges[0].num_partitions(ctx)
            # skew is a property of the stream side: splitting because
            # the build is big would only replay the build more often
            stream = list(self.exchanges[0].stage_stats(ctx))
            sizes = list(stream)
            for ex in self.exchanges[1:]:
                for i, b in enumerate(ex.stage_stats(ctx)):
                    sizes[i] += b
            nonzero = sorted(b for b in stream if b) or [0]
            median = nonzero[len(nonzero) // 2]
            skew_cut = max(self.skew_factor * median, self.skew_min)
            groups: List[List[Tuple[int, int, int]]] = []
            cur: List[Tuple[int, int, int]] = []
            cur_bytes = 0
            skewed_rps, split_slices = 0, 0
            for rp in range(n):
                sb = stream[rp]
                if self.allow_split and sb > skew_cut and median > 0:
                    if cur:
                        groups.append(cur)
                        cur, cur_bytes = [], 0
                    nchunks = max(2, -(-sb // self.target))
                    skewed_rps += 1
                    split_slices += nchunks
                    for c in range(nchunks):
                        groups.append([(rp, c, nchunks)])
                    continue
                if cur and (not self.allow_coalesce
                            or cur_bytes + sizes[rp] > self.target):
                    groups.append(cur)
                    cur, cur_bytes = [], 0
                cur.append((rp, 0, 1))
                cur_bytes += sizes[rp]
            if cur:
                groups.append(cur)
            if not groups:
                groups = [[(0, 0, 1)]]
            self._groups = groups
            self.decision = {
                "rule": "shuffle_read",
                "partitions_before": n,
                "partitions_after": len(groups),
                "coalesced_away": sum(len(g) - 1 for g in groups
                                      if len(g) > 1),
                "skewed_partitions": skewed_rps,
                "split_slices": split_slices,
                "median_bytes": int(median),
                "skew_cut_bytes": int(skew_cut),
                "target_bytes": int(self.target)}
            return groups


class AQEShuffleReadExec(TpuExec):
    """Reads the re-planned partitions of one exchange.

    role "stream": serves every group as planned, split slices included.
    role "build": serves each group's reduce partitions whole, so a split
    stream slice still probes the complete build partition."""

    def __init__(self, exchange, plan: AqeShufflePlan,
                 role: str = "stream"):
        super().__init__([exchange], exchange.schema)
        self.plan = plan
        self.role = role

    def describe(self):
        d = self.plan.decision
        if d is None:
            return f"AQEShuffleReadExec[{self.role}]"
        parts = [self.role]
        if d["partitions_after"] != d["partitions_before"] \
                or d["coalesced_away"]:
            parts.append(f"coalesced {d['partitions_before']}"
                         f"→{d['partitions_after']}")
        if d["split_slices"]:
            parts.append(f"skewSplits={d['skewed_partitions']}"
                         f"→{d['split_slices']}")
        return f"AQEShuffleReadExec[{', '.join(parts)}]"

    def num_partitions(self, ctx: ExecContext):
        if getattr(ctx, "planning", False):
            # a planner's probe: the static count, without running the
            # map stage
            return self.children[0].num_partitions(ctx)
        return len(self.plan.groups(ctx))

    def execute_partition(self, ctx: ExecContext, pid: int):
        group = self.plan.groups(ctx)[pid]
        ex = self.children[0]
        d = self.plan.decision
        if d is not None:
            # set, not add: every task writes the same summary
            ctx.set_metric(self._op_id, "aqePartitionsBefore",
                           d["partitions_before"])
            ctx.set_metric(self._op_id, "aqePartitionsAfter",
                           d["partitions_after"])
            if d["split_slices"]:
                ctx.set_metric(self._op_id, "aqeSkewSplits",
                               d["split_slices"])
        seen = set()
        for rpid, chunk, nchunks in group:
            if self.role == "build":
                if rpid in seen:
                    continue
                seen.add(rpid)
                chunk, nchunks = 0, 1
            batch = ex.read_slice(ctx, rpid, chunk, nchunks)
            if batch is not None:
                ctx.add_metric(self._op_id, "numOutputBatches", 1)
                yield batch
