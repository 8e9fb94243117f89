"""Hash join: inner, left, right, full, left_semi, left_anti and cross
joins, with an optional non-equi condition; and the nested-loop join.

The port of the JAX package's `exec/join.py` `HashJoinExec` (`:64`). The
left child is the stream side, the right child the build side. The build
batches (compacted when sparse, `exec/batch.py` `maybe_compact`)
concatenate into one table on the device; then every stream batch is
probed against it on one of three builds, as in the JAX package:

  - direct-address (`_try_build_direct`, JAX `:255`): one int key whose
    value span fits `max(8 x build rows, 2^22)` slots. The build is two
    scatters into an `R + 1` table (a match count and the last matching
    row a slot, dead rows sent to slot R; `index_add_` and
    `scatter_reduce_("amax")`), the probe two gathers. One host read of
    the key range decides it.
  - sorted (`_build_sorted`, JAX `:223`): one fixed-width key of any
    other span, or a direct build whose stream batch meets a duplicate
    build key, which promotes the join to this build once. The keys map
    to a monotone int64 (torch has no uint64; an int64 key is already
    monotone, narrower keys widen), null or dead rows pin to the int64
    maximum and sort last (`sortkeys.lexsort([invalid, key])`), and a
    probe is two `searchsorted` clipped to the valid count.
  - generic count (`_count`, JAX `:391`): several keys, a string, float64
    or decimal128 key. Build and stream keys sort together per stream
    batch; equal-key segments count their build and stream rows.

A probe gives each stream row its match count. One counted host read of
the batch's totals (`_probe_stats`) then picks the output: when no row
has two matches (an FK join) the stream columns stay in place under a
holey row mask and the build columns gather at the stream's length;
else the expand pass (JAX `:441`) gathers both sides into exactly
`n_out` rows, each stream row's matches in build order, through
`ops/gather.py` `row_of_unit`. Semi and anti joins are a mask update.
Right and full joins mark matched build rows across stream batches and
end with one batch of the unmatched build rows, the left side null.

Null keys never match; NaN matches NaN. A per-partition join (both
children hash exchanges on the keys) joins each partition alone.

A join with a `condition` (JAX `_probe_cond`, `:923`) takes the direct
build never: its sorted or count build gives every equal-key pair, both
sides gather at the pairs, and the condition, bound over the combined
schema, runs on them. Only the passing pairs count as matches: they are
the output's rows (its mask), they mark the stream rows that a semi,
anti, left or full join keeps or null-extends, and the build rows that
a right or full join does not emit again. A cross join (JAX
`_execute_cross`, `:976`) pairs every live stream row with every live
build row, stream-major. `NestedLoopJoinExec` (JAX `:1006`) runs a
condition with no equi keys: the build is collected once, and each
stream batch crosses it in chunks of about `_CHUNK_TARGET` pairs, each
judged as in the conditional hash join.

Not ported: the out-of-core sub-partitioned join (`:599-790`): a build
over `sql.join.buildSideBudgetBytes` raises NotPorted here.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..columnar import dtypes as dt
from ..columnar.table import Schema
from ..config import JOIN_BUILD_BUDGET
from ..errors import NotPorted
from ..expr.aggregates import seg_any
from ..expr.expressions import EmitCtx, Expression
from ..ops import sortkeys as sk
from ..ops.concat import concat_cvs, concat_masks
from ..ops.gather import gather_cols, gather_groups, row_of_unit
from ..ops.kernel_utils import CV
from ..utils import transfer
from ..utils.transfer import fetch_int, fetch_ints
from .base import ExecContext, TpuExec
from .batch import DeviceBatch, maybe_compact
from .nodes import make_table

__all__ = ["HashJoinExec", "NestedLoopJoinExec"]

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


def _null_cvs(fields, n: int, device) -> List[CV]:
    """All-null columns of n rows (the outer joins' missing side)."""
    out = []
    for f in fields:
        valid = torch.zeros(n, dtype=torch.bool, device=device)
        if f.dtype.is_variable_width:
            out.append(CV(torch.zeros(0, dtype=torch.uint8, device=device),
                          valid, torch.zeros(n + 1, dtype=torch.int32,
                                             device=device)))
        else:
            out.append(CV(torch.zeros(dt.alloc_shape(f.dtype, n),
                                      dtype=dt.torch_dtype(f.dtype),
                                      device=device), valid))
    return out


def _live_rows(mask: torch.Tensor) -> torch.Tensor:
    """The int64 positions of a mask's live rows, in order (one host
    read)."""
    transfer.note_sync()
    return torch.nonzero(mask).squeeze(1)


def _single_key(kcv: CV, dtype: dt.DataType) -> Optional[torch.Tensor]:
    """The key as a monotone int64 (JAX `_single_key_u64` without
    uint64), or None when its order needs more than one word."""
    arrs = sk.order_keys(kcv, dtype)
    return arrs[0].to(torch.int64) if len(arrs) == 1 else None


class _Build:
    """One join pass's build side: its columns, mask and keys, and the
    structures built over them (the direct table, the sorted keys, the
    matched-row marks of a right or full join)."""

    def __init__(self, cvs, mask, key_cvs):
        self.cvs, self.mask, self.key_cvs = cvs, mask, key_cvs
        self.rows = int(mask.shape[0])
        self.direct = None      # dict(R, kmin, kmax, cnt_t, idx_t)
        self.sorted = None      # (sorted keys, perm sorted -> row, n_valid)
        self.matched = None


class HashJoinExec(TpuExec):
    _DIRECT_SPAN_FACTOR = 8
    _DIRECT_SPAN_MIN = 1 << 22

    def __init__(self, left: TpuExec, right: TpuExec,
                 bound_left_keys: Sequence[Expression],
                 bound_right_keys: Sequence[Expression], how: str,
                 schema: Schema, per_partition: bool = False,
                 condition: Optional[Expression] = None):
        """how: one of inner, left, right, full, left_semi, left_anti,
        cross. per_partition: both children are hash exchanges on the
        join keys, so partition p of the stream joins partition p of the
        build; else the build is every partition of the right child (a
        BroadcastExchangeExec) and the stream every partition of the
        left. condition: a predicate bound over the left then the right
        columns, which a pair must pass to match."""
        super().__init__([left, right], schema)
        self.lkeys = list(bound_left_keys)
        self.rkeys = list(bound_right_keys)
        self.how = how
        self.per_partition = per_partition
        self.condition = condition

    def num_partitions(self, ctx):
        if self.per_partition:
            return self.children[0].num_partitions(ctx)
        return 1

    def _fast_path_ok(self) -> bool:
        """One key whose order is one word: the direct and sorted
        builds."""
        if len(self.rkeys) != 1:
            return False
        d = self.rkeys[0].dtype
        if isinstance(d, dt.DecimalType) and d.is_decimal128:
            return False
        return not (d.is_variable_width or isinstance(d, dt.DoubleType))

    # ------------------------------------------------------------------
    def execute_partition(self, ctx: ExecContext, pid: int):
        if self.how == "cross":
            yield from self._execute_cross(ctx)
            return
        left, right = self.children
        build_pids = ([pid] if self.per_partition
                      else range(right.num_partitions(ctx)))
        with ctx.timer(self._op_id, "buildTime"):
            bbatches = [b for bpid in build_pids
                        for b in right.execute_partition(ctx, bpid)]
        budget = ctx.conf.get(JOIN_BUILD_BUDGET)
        total = sum(b.nbytes for b in bbatches)
        if budget > 0 and total > budget:
            raise NotPorted(
                f"a join build of {total} bytes, over "
                f"sql.join.buildSideBudgetBytes ({budget}): the "
                f"out-of-core sub-partitioned join")
        stream = (b for lpid in ([pid] if self.per_partition
                                 else range(left.num_partitions(ctx)))
                  for b in left.execute_partition(ctx, lpid))
        yield from self._join_pass(ctx, bbatches, stream)

    def _join_pass(self, ctx: ExecContext, bbatches, stream_batches):
        """Build once, probe every stream batch, then (right, full) emit
        the unmatched build rows."""
        op, dev = self._op_id, ctx.device
        left, right = self.children
        with ctx.timer(op, "buildTime"):
            bbatches = [maybe_compact(b, right.schema) for b in bbatches]
            bcvs, bmask = self._concat_batches(bbatches, right.schema, dev)
            bkeys = [k.emit(EmitCtx(bcvs, bmask.shape[0], dev))
                     for k in self.rkeys]
            build = _Build(bcvs, bmask, bkeys)
            fast = self._fast_path_ok()
            if fast and self.condition is None and self.how in (
                    "inner", "left", "left_semi", "left_anti"):
                build.direct = self._try_build_direct(build)
            if fast and build.direct is None:
                build.sorted = self._build_sorted(build)
            if self.how in ("right", "full"):
                build.matched = torch.zeros(build.rows, dtype=torch.bool,
                                            device=dev)
        for batch in stream_batches:
            ctx.add_metric(op, "streamBatches", 1)
            batch = maybe_compact(batch, left.schema, factor=8)
            if self.condition is not None:
                outs = self._probe_cond(ctx, batch, build, fast)
            else:
                outs = [self._probe_batch(ctx, batch, build, fast)]
            for out in outs:
                if out is not None:
                    ctx.add_metric(op, "numOutputBatches", 1)
                    yield out
        if build.matched is not None:
            out = self._unmatched_build(ctx, bcvs, bmask & ~build.matched)
            if out is not None:
                yield out

    def _unmatched_build(self, ctx, bcvs, unmatched):
        """The build rows no pair matched, the left side null (right and
        full joins), or None when there are none: one host read."""
        if fetch_int(unmatched.sum()) == 0:
            return None
        n = int(unmatched.shape[0])
        out_cvs = _null_cvs(self.children[0].schema.fields, n,
                            unmatched.device)
        out_cvs += [CV(cv.data, cv.validity & unmatched, cv.offsets)
                    for cv in bcvs]
        ctx.add_metric(self._op_id, "numOutputBatches", 1)
        return DeviceBatch(make_table(self.schema, out_cvs, n), n,
                           unmatched)

    @staticmethod
    def _concat_batches(batches, schema: Schema, device):
        if not batches:
            return _null_cvs(schema.fields, 0, device), \
                torch.zeros(0, dtype=torch.bool, device=device)
        if len(batches) == 1:
            return batches[0].cvs(), batches[0].row_mask
        cvs = [concat_cvs([b.cvs()[i] for b in batches], f.dtype)
               for i, f in enumerate(schema.fields)]
        return cvs, concat_masks([b.row_mask for b in batches])

    # ---- direct-address build: two scatters, no sort ------------------
    def _try_build_direct(self, build: _Build) -> Optional[dict]:
        """The direct table when the key span allows it, else None: one
        host read of the key range."""
        if build.rows == 0:
            return None
        kcv = build.key_cvs[0]
        key = _single_key(kcv, self.rkeys[0].dtype)
        valid = build.mask & kcv.validity
        kmin, kmax, nv = fetch_ints([
            torch.where(valid, key, _I64_MAX).min(),
            torch.where(valid, key, _I64_MIN).max(), valid.sum()])
        if nv == 0:
            return None
        span = kmax - kmin + 1
        if span > max(self._DIRECT_SPAN_FACTOR * build.rows,
                      self._DIRECT_SPAN_MIN):
            return None
        R = span
        off = torch.where(valid, torch.where(valid, key, kmin) - kmin, R)
        cnt_t = torch.zeros(R + 1, dtype=torch.int32, device=key.device)
        cnt_t.index_add_(0, off, valid.to(torch.int32))
        idx_t = torch.zeros(R + 1, dtype=torch.int32, device=key.device)
        idx_t.scatter_reduce_(0, off, torch.arange(
            build.rows, dtype=torch.int32, device=key.device), "amax",
            include_self=True)
        return {"R": R, "kmin": kmin, "kmax": kmax, "cnt_t": cnt_t,
                "idx_t": idx_t}

    def _direct_probe(self, direct: dict, skcv: CV, smask):
        """(match count, the matching build row when the count is 1)."""
        R, kmin = direct["R"], direct["kmin"]
        key = _single_key(skcv, self.lkeys[0].dtype)
        in_r = (smask & skcv.validity & (key >= kmin)
                & (key <= direct["kmax"]))
        # rows out of range never subtract (no int64 wrap)
        poff = torch.where(in_r, torch.where(in_r, key, kmin) - kmin, R)
        return direct["cnt_t"][poff].to(torch.int64), direct["idx_t"][poff]

    # ---- sorted build: one sort per join, two searchsorted per batch --
    def _build_sorted(self, build: _Build):
        kcv = build.key_cvs[0]
        key = _single_key(kcv, self.rkeys[0].dtype)
        valid = build.mask & kcv.validity
        pinned = torch.where(valid, key, _I64_MAX)
        perm = sk.lexsort([(~valid).to(torch.uint8), pinned])
        return pinned[perm].contiguous(), perm, valid.sum()

    def _sorted_probe(self, build: _Build, skcv: CV, smask, mark: bool):
        """(cnt, offsets, first match's sorted position, touched sorted
        build positions, or None unless `mark`)."""
        sorted_key, _, n_valid = build.sorted
        key = _single_key(skcv, self.lkeys[0].dtype).contiguous()
        joinable = smask & skcv.validity
        lo = torch.minimum(torch.searchsorted(sorted_key, key), n_valid)
        hi = torch.minimum(torch.searchsorted(sorted_key, key, right=True),
                           n_valid)
        cnt = torch.where(joinable, hi - lo, 0)
        touched = None
        if mark:
            # matched sorted positions: +1 / -1 at each range's ends,
            # then a running sum
            cap_b = build.rows
            diff = torch.zeros(cap_b + 1, dtype=torch.int32,
                               device=key.device)
            ones = torch.ones_like(lo, dtype=torch.int32)
            diff.index_add_(0, torch.where(joinable, lo, cap_b), ones)
            diff.index_add_(0, torch.where(joinable, hi, cap_b), -ones)
            touched = torch.cumsum(diff[:-1], 0) > 0
        return cnt, torch.cumsum(cnt, 0) - cnt, lo, touched

    # ---- generic count: build and stream keys sorted together ---------
    def _key_nchunks(self, build: _Build, skeys, smask):
        """Chunk count of each string key over both sides: one host
        read."""
        lens, idx = [], []
        for i, k in enumerate(self.rkeys):
            if k.dtype.is_variable_width:
                for kcv, mask in ((build.key_cvs[i], build.mask),
                                  (skeys[i], smask)):
                    if mask.shape[0]:
                        ln = kcv.offsets[1:] - kcv.offsets[:-1]
                        lens.append(torch.where(mask & kcv.validity, ln,
                                                0).max())
                        idx.append(i)
        maxlen = {}
        for i, v in zip(idx, fetch_ints(lens)):
            maxlen[i] = max(maxlen.get(i, 1), v)
        return tuple(sk.nchunks_for_len(max(maxlen.get(i, 1), 1))
                     if k.dtype.is_variable_width else 0
                     for i, k in enumerate(self.rkeys))

    def _count(self, build: _Build, skeys, smask, nchunks):
        """(cnt, offsets, first match's combined position, combined
        perm, matched build rows)."""
        bkeys, bmask = build.key_cvs, build.mask
        cap_b, cap_s = build.rows, int(smask.shape[0])
        dev = smask.device
        joinable_b, joinable_s = bmask, smask
        arrays, widths = [], []
        for i, k in enumerate(self.rkeys):
            joinable_b = joinable_b & bkeys[i].validity
            joinable_s = joinable_s & skeys[i].validity
            comb = concat_cvs([bkeys[i], skeys[i]], k.dtype)
            arrays += sk.order_keys(comb, k.dtype, nchunks[i])
            widths += sk.key_widths(k.dtype, nchunks[i])
        joinable = torch.cat([joinable_b, joinable_s])
        is_build = torch.arange(cap_b + cap_s, device=dev) < cap_b
        arrays = [(~joinable).to(torch.uint8)] + arrays
        perm = sk.lexsort(arrays, [None] + widths)
        seg = torch.cumsum(sk.group_boundaries(
            [a[perm] for a in arrays]).to(torch.int64), 0) - 1
        n = cap_b + cap_s
        jb = (is_build & joinable)[perm]
        js = (joinable & ~is_build)[perm]
        seg_bcnt = torch.zeros(n, dtype=torch.int64, device=dev)
        seg_bcnt.index_add_(0, seg, jb.to(torch.int64))
        seg_scnt = torch.zeros(n, dtype=torch.int64, device=dev)
        seg_scnt.index_add_(0, seg, js.to(torch.int64))
        pos = torch.arange(n, device=dev)
        seg_bstart = torch.full((n,), n, dtype=torch.int64, device=dev)
        seg_bstart.scatter_reduce_(0, seg, torch.where(jb, pos, n), "amin",
                                   include_self=True)
        seg_of = torch.empty(n, dtype=torch.int64, device=dev)
        seg_of[perm] = seg
        seg_s = seg_of[cap_b:]
        cnt = torch.where(joinable_s, seg_bcnt[seg_s], 0)
        matched = torch.zeros(n, dtype=torch.bool, device=dev)
        matched[perm] = jb & (seg_scnt[seg] > 0)
        return (cnt, torch.cumsum(cnt, 0) - cnt, seg_bstart[seg_s], perm,
                matched[:cap_b])

    # ---- one stream batch ---------------------------------------------
    @staticmethod
    def _probe_stats(cnt, smask):
        """(pairs, rows out of a left join, matched rows, the largest
        count): one host read."""
        eff = torch.where(smask & (cnt == 0), 1, cnt)
        return fetch_ints([cnt.sum(), eff.sum(),
                           ((cnt > 0) & smask).sum(), cnt.max()])

    def _probe_batch(self, ctx: ExecContext, batch: DeviceBatch,
                     build: _Build, fast: bool) -> Optional[DeviceBatch]:
        op, how = self._op_id, self.how
        scvs, smask = batch.cvs(), batch.row_mask
        cap_s = int(smask.shape[0])
        if cap_s == 0:
            return None
        with ctx.timer(op, "probeTime"):
            skeys = [k.emit(EmitCtx(scvs, cap_s, smask.device))
                     for k in self.lkeys]
            stats = None
            if build.direct is not None:
                ctx.add_metric(op, "directProbeBatches", 1)
                cnt, bidx = self._direct_probe(build.direct, skeys[0],
                                               smask)
                if how in ("left_semi", "left_anti"):
                    return self._semi(batch, cnt)
                stats = self._probe_stats(cnt, smask)
                if stats[3] <= 1:
                    return self._fk_output(ctx, batch, build, bidx, cnt,
                                           stats)
                # a duplicate build key matched: promote to the sorted
                # build, once for the join
                if build.sorted is None:
                    ctx.add_metric(op, "promotedToSorted", 1)
                    build.sorted = self._build_sorted(build)
            cnt, offsets, bstart, perm = self._candidates(
                ctx, build, skeys, smask, fast)
            if how in ("left_semi", "left_anti"):
                return self._semi(batch, cnt)
            if stats is None:
                stats = self._probe_stats(cnt, smask)
        if stats[3] <= 1 and how in ("inner", "left"):
            if perm.shape[0]:
                rg = perm[bstart.clamp(0, perm.shape[0] - 1)]
            else:
                rg = torch.zeros_like(bstart)
            return self._fk_output(ctx, batch, build, rg, cnt, stats)
        return self._expand(ctx, batch, build, cnt, offsets, bstart, perm,
                            stats)

    def _candidates(self, ctx, build: _Build, skeys, smask, fast: bool):
        """(cnt, offsets, first match's position, perm) of every
        equal-key pair, on the sorted build (`fast`) or the count build.
        Without a condition a right or full join marks its matched build
        rows here; with one, only the pairs that pass mark them."""
        op = self._op_id
        mark = build.matched is not None and self.condition is None
        if fast:
            ctx.add_metric(op, "sortedProbeBatches", 1)
            cnt, offsets, bstart, touched = self._sorted_probe(
                build, skeys[0], smask, mark)
            perm = build.sorted[1]
            if mark:
                upd = torch.zeros_like(build.matched)
                upd[perm] = touched & (torch.arange(
                    build.rows, device=perm.device) < build.sorted[2])
                build.matched |= upd
            return cnt, offsets, bstart, perm
        ctx.add_metric(op, "countProbeBatches", 1)
        cnt, offsets, bstart, perm, matched_b = self._count(
            build, skeys, smask, self._key_nchunks(build, skeys, smask))
        if mark:
            build.matched |= matched_b
        return cnt, offsets, bstart, perm

    def _passes(self, cols, n: int, device) -> torch.Tensor:
        """The condition over gathered (left ++ right) pair columns: true
        where it holds and is not null."""
        ccv = self.condition.emit(EmitCtx(cols, n, device))
        return ccv.validity & ccv.data.bool()

    def _probe_cond(self, ctx: ExecContext, batch: DeviceBatch,
                    build: _Build, fast: bool) -> List[DeviceBatch]:
        """One stream batch of a conditional join (JAX `_probe_cond`):
        every equal-key pair gathered, the condition judged on it, and
        the match state of both sides taken from the passing pairs
        only."""
        op = self._op_id
        scvs, smask = batch.cvs(), batch.row_mask
        cap_s = int(smask.shape[0])
        if cap_s == 0:
            return []
        dev = smask.device
        with ctx.timer(op, "probeTime"):
            skeys = [k.emit(EmitCtx(scvs, cap_s, dev)) for k in self.lkeys]
            cnt, offsets, bstart, perm = self._candidates(
                ctx, build, skeys, smask, fast)
            n_pairs = fetch_int(cnt.sum())
        outs = []
        seg_matched = torch.zeros(cap_s, dtype=torch.bool, device=dev)
        if n_pairs > 0:
            with ctx.timer(op, "expandTime"):
                t = torch.arange(n_pairs, dtype=torch.int64, device=dev)
                i = row_of_unit(offsets, cap_s, n_pairs).clamp(0, cap_s - 1)
                comb = (bstart[i] + t - offsets[i]).clamp(
                    0, perm.shape[0] - 1)
                rg = perm[comb].clamp(0, build.rows - 1)
                lcols, rcols = gather_groups([(scvs, i, None),
                                              (build.cvs, rg, None)])
                pass_ = self._passes(lcols + rcols, n_pairs, dev)
                seg_matched = seg_any(pass_, i, cap_s)
                if build.matched is not None:
                    build.matched |= seg_any(pass_, rg, build.rows)
            if self.how not in ("left_semi", "left_anti"):
                ctx.add_metric(op, "expandOutputBatches", 1)
                ctx.add_metric(op, "numOutputRows", n_pairs)
                outs.append(DeviceBatch(make_table(
                    self.schema, lcols + rcols, n_pairs), n_pairs, pass_))
        outs.append(self._stream_rest(batch, seg_matched))
        return outs

    def _stream_rest(self, batch: DeviceBatch, seg_matched):
        """After a conditional join's pairs: a semi or anti join's stream
        rows, a left or full join's stream rows with no passing pair
        (the right side null), else None."""
        smask = batch.row_mask
        if self.how == "left_semi":
            return DeviceBatch(batch.table, batch.num_rows,
                               smask & seg_matched)
        if self.how == "left_anti":
            return DeviceBatch(batch.table, batch.num_rows,
                               smask & ~seg_matched)
        if self.how in ("left", "full"):
            out_cvs = list(batch.cvs()) + _null_cvs(
                self.children[1].schema.fields, int(smask.shape[0]),
                smask.device)
            return DeviceBatch(make_table(self.schema, out_cvs,
                                          batch.num_rows),
                               batch.num_rows, smask & ~seg_matched)
        return None

    def _collect_build(self, ctx: ExecContext):
        """(columns, mask, live row positions) of the right child's every
        partition as one table."""
        right = self.children[1]
        bbatches = [b for bpid in range(right.num_partitions(ctx))
                    for b in right.execute_partition(ctx, bpid)]
        bcvs, bmask = self._concat_batches(bbatches, right.schema,
                                           ctx.device)
        return bcvs, bmask, _live_rows(bmask)

    def _stream_all(self, ctx: ExecContext):
        left = self.children[0]
        for lpid in range(left.num_partitions(ctx)):
            for batch in left.execute_partition(ctx, lpid):
                ctx.add_metric(self._op_id, "streamBatches", 1)
                yield batch

    def _execute_cross(self, ctx: ExecContext):
        """Every live stream row with every live build row (JAX
        `_execute_cross`): n_s * n_b rows a stream batch, stream-major."""
        op = self._op_id
        with ctx.timer(op, "buildTime"):
            bcvs, _, bidx = self._collect_build(ctx)
        n_b = int(bidx.shape[0])
        for batch in self._stream_all(ctx):
            with ctx.timer(op, "expandTime"):
                sidx = _live_rows(batch.row_mask)
                n_out = int(sidx.shape[0]) * n_b
                if n_out == 0:
                    continue
                t = torch.arange(n_out, dtype=torch.int64,
                                 device=batch.device)
                lcols, rcols = gather_groups([
                    (batch.cvs(), sidx[t // n_b], None),
                    (bcvs, bidx[t % n_b], None)])
                tbl = make_table(self.schema, lcols + rcols, n_out)
            ctx.add_metric(op, "numOutputRows", n_out)
            ctx.add_metric(op, "numOutputBatches", 1)
            yield DeviceBatch(tbl, n_out, device=batch.device)

    def _semi(self, batch, cnt):
        keep = cnt > 0 if self.how == "left_semi" else cnt == 0
        return DeviceBatch(batch.table, batch.num_rows,
                           batch.row_mask & keep)

    def _fk_output(self, ctx, batch, build, rg, cnt, stats):
        """No stream row has two matches: the stream columns stay in
        place (holey mask), the build columns gather at the stream's
        length."""
        n_total, n_eff, n_matched, _ = stats
        if self.how == "inner" and n_matched == 0:
            return None
        ctx.add_metric(self._op_id, "fkOutputBatches", 1)
        with ctx.timer(self._op_id, "expandTime"):
            smask = batch.row_mask
            matched = (cnt > 0) & smask
            out_cvs = list(batch.cvs()) + self._take_build(
                build, rg, matched, smask.shape[0], smask.device)
            tbl = make_table(self.schema, out_cvs, batch.num_rows)
        ctx.add_metric(self._op_id, "numOutputRows",
                       n_matched if self.how == "inner" else n_eff)
        return DeviceBatch(tbl, batch.num_rows,
                           matched if self.how == "inner" else smask)

    def _take_build(self, build, rg, valid, n, device) -> List[CV]:
        if build.rows == 0:
            return _null_cvs(self.children[1].schema.fields, n, device)
        return gather_cols(build.cvs, rg.to(torch.int64).clamp(
            0, build.rows - 1), valid)

    def _expand(self, ctx, batch, build, cnt, offsets, bstart, perm,
                stats):
        """Each stream row once per match (left, full: an unmatched live
        row once, its build side null), exactly n_out rows."""
        n_total, n_eff, _, _ = stats
        with_left_nulls = self.how in ("left", "full")
        n_out = n_eff if with_left_nulls else n_total
        if n_out == 0:
            return None
        op = self._op_id
        ctx.add_metric(op, "expandOutputBatches", 1)
        with ctx.timer(op, "expandTime"):
            smask = batch.row_mask
            cap_s = int(smask.shape[0])
            dev = smask.device
            if with_left_nulls:
                eff = torch.where(smask & (cnt == 0), 1, cnt)
                offsets = torch.cumsum(eff, 0) - eff
            t = torch.arange(n_out, dtype=torch.int64, device=dev)
            i = row_of_unit(offsets, cap_s, n_out).clamp(0, cap_s - 1)
            j = t - offsets[i]
            rvalid = cnt[i] > 0
            if perm.shape[0]:
                comb = (bstart[i] + j).clamp(0, perm.shape[0] - 1)
                rg = perm[comb]
            else:
                rg = torch.zeros_like(i)
            if build.rows == 0:
                scols = gather_cols(batch.cvs(), i, None)
                bcols = _null_cvs(self.children[1].schema.fields, n_out,
                                  dev)
            else:
                scols, bcols = gather_groups([
                    (batch.cvs(), i, None),
                    (build.cvs, rg.clamp(0, build.rows - 1), rvalid)])
            tbl = make_table(self.schema, scols + bcols, n_out)
        ctx.add_metric(op, "numOutputRows", n_out)
        return DeviceBatch(tbl, n_out, device=dev)


class NestedLoopJoinExec(HashJoinExec):
    """Broadcast nested-loop join: no equi keys, any condition (JAX
    `exec/join.py:1006`). The build side is collected once; each stream
    batch crosses it in chunks of stream rows x every build row, about
    `_CHUNK_TARGET` pairs each; the condition judges the gathered pairs,
    and the outer, semi and anti semantics come from the passing pairs
    as in the conditional hash join."""

    _CHUNK_TARGET = 1 << 20

    def __init__(self, left: TpuExec, right: TpuExec, how: str,
                 schema: Schema, condition: Expression):
        super().__init__(left, right, [], [], how, schema,
                         condition=condition)

    def num_partitions(self, ctx):
        return 1

    def execute_partition(self, ctx: ExecContext, pid: int):
        op, how = self._op_id, self.how
        with ctx.timer(op, "buildTime"):
            bcvs, bmask, bidx = self._collect_build(ctx)
        n_b, cap_b = int(bidx.shape[0]), int(bmask.shape[0])
        matched_b = torch.zeros(cap_b, dtype=torch.bool, device=ctx.device)
        chunk = max(1, self._CHUNK_TARGET // max(n_b, 1))
        for batch in self._stream_all(ctx):
            scvs, smask = batch.cvs(), batch.row_mask
            cap_s, dev = int(smask.shape[0]), smask.device
            with ctx.timer(op, "probeTime"):
                sidx = _live_rows(smask)
            n_s = int(sidx.shape[0]) if n_b else 0
            seg_matched = torch.zeros(cap_s, dtype=torch.bool, device=dev)
            for s0 in range(0, n_s, chunk):
                n_out = min(chunk, n_s - s0) * n_b
                with ctx.timer(op, "probeTime"):
                    t = torch.arange(n_out, dtype=torch.int64, device=dev)
                    li, ri = sidx[s0 + t // n_b], bidx[t % n_b]
                    lcols, rcols = gather_groups([(scvs, li, None),
                                                  (bcvs, ri, None)])
                    pass_ = self._passes(lcols + rcols, n_out, dev)
                    seg_matched |= seg_any(pass_, li, cap_s)
                    if how in ("right", "full"):
                        matched_b |= seg_any(pass_, ri, cap_b)
                ctx.add_metric(op, "nestedLoopChunks", 1)
                if how not in ("left_semi", "left_anti"):
                    ctx.add_metric(op, "numOutputBatches", 1)
                    yield DeviceBatch(make_table(self.schema, lcols + rcols,
                                                 n_out), n_out, pass_)
            out = self._stream_rest(batch, seg_matched)
            if out is not None:
                yield out
        if how in ("right", "full"):
            out = self._unmatched_build(ctx, bcvs, bmask & ~matched_b)
            if out is not None:
                yield out
