"""Aggregation: ungrouped reductions, the grouped hash aggregate and the
sort-path `CollectAggExec`.

Ungrouped: the filter/project chain below the aggregate is applied
inside it, per batch (the JAX package's collapse_fusable), then each
aggregate updates its state and merges into the running state. States
stay on the device until finalize; the one-row result is the only thing
built afterwards.

Grouped (`HashAggregateExec`, the port of the JAX package's
`exec/aggregate.py:334`, modes complete / partial / final): each input
batch first goes through a sort-free hash pass (rows bucket by key hash,
each row is checked against its bucket's representative on the exact
equality keys, matching rows segment-reduce; collisions retry in a
second round with more buckets). If any row is still left over, the
batch instead runs the sort-segmented path (one stable sort on the
normalized keys, group boundaries, segment reductions), and the hash
pass is off for the rest of the query. Each batch's first pass runs under
`with_retry`, so a device OOM splits the batch. Per-batch partials are
parked in the spill store as partial-format batches (priority 8; JAX
`:452-476`), merged eagerly while merging still shrinks them, and
merged by the sort-segmented path and finalized at the end; above
`sql.agg.maxMergeRows` buffered rows they split into 16 at most hash
buckets of disjoint keys (`numBucketSplits`) that merge one at a time,
a bucket still too big splitting again with a fresh seed
(`numBucketRecursions`, 10 levels at most). Every handle closes when
the stream ends, fails or is abandoned. The port keeps exact lengths
where the JAX package pads to power-of-two capacities: a partial holds
its live groups only, so the same groups and values come out, in an
order only a sort defines.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.table import Field, Schema
from ..config import AGG_MAX_MERGE_ROWS, AGG_STRING_HASH_KEYS
from ..expr.aggregates import (AggExpr, Count, CountDistinct, Percentile,
                                _Collect, _FirstLast, _pick,
                                _seg_extreme_pos, ident, percentile_list,
                                seg_any, seg_min_max, seg_sum)
from ..expr.expressions import (Alias, BoundRef, EmitCtx, Expression,
                                UnsupportedExpr)
from ..memory.retry import retry_no_split, with_retry
from ..ops import sortkeys as sk
from ..ops.concat import concat_cvs, concat_masks
from ..ops.gather import compact, compaction_perm, gather_cols, take
from ..ops.hash import (_mul32, hash_once_rows, murmur3_row_hash,
                        partition_ids)
from ..ops.kernel_utils import CV, fma, null_cv
from ..utils import transfer
from ..utils.transfer import fetch_ints
from .base import ExecContext, TpuExec, collapse_fusable
from .batch import DeviceBatch
from .nodes import make_table

__all__ = ["UngroupedAggExec", "HashAggregateExec", "CollectAggExec"]

# Hash first pass: round 0 scatter-reduces into _HASH_BUCKETS buckets,
# later rounds into ~rows/4 (at most _HASH_BUCKETS_MAX); rows whose bucket
# another key owns retry the next round, and a batch with rows left after
# _HASH_ROUNDS rounds goes to the sort-segmented path.
_HASH_BUCKETS = 4096
_HASH_ROUNDS = 2
_HASH_BUCKETS_MAX = 1 << 18
_M32 = 0xFFFFFFFF
# deepest bucket recursion of the merge split (10 levels x 16 buckets)
_MAX_BUCKET_DEPTH = 10
# key types of the hash first pass (the JAX package's list); any other
# key takes the sort path
_HASHABLE = (dt.BooleanType, dt.ByteType, dt.ShortType, dt.IntegerType,
             dt.DateType, dt.LongType, dt.TimestampType, dt.DecimalType,
             dt.FloatType, dt.DoubleType, dt.StringType, dt.BinaryType)

#: a partial: (key CVs, flat state tensors, live-row mask, rows)
Partial = Tuple[List[CV], List[torch.Tensor], torch.Tensor, int]


def _hash_buckets_for(cap: int) -> int:
    """~cap/4 buckets (a power of two, at least _HASH_BUCKETS), which keeps
    two rounds enough for high-cardinality batches."""
    b = _HASH_BUCKETS
    target = min(cap // 4, _HASH_BUCKETS_MAX)
    while b < target:
        b <<= 1
    return b


def _seg_reduce(reducer: str, arr, live, seg_ids, num_segments):
    if reducer == "sum":
        return seg_sum(torch.where(live, arr, torch.zeros_like(arr)),
                       seg_ids, num_segments)
    if reducer == "or":
        return seg_any(live & arr.bool(), seg_ids, num_segments)
    if reducer in ("min", "max"):
        for_min = reducer == "min"
        return seg_min_max(torch.where(live, arr, ident(arr.dtype, for_min)),
                           seg_ids, num_segments, for_min)
    raise ValueError(reducer)


def _state_width(a: AggExpr) -> int:
    """The number of state columns of an aggregate."""
    if "custom" in a.state_reducers:
        return a.num_state_cols()
    return len(a.state_reducers)


def _pack_pair(hi, lo):
    """Two unsigned 32-bit words as the int64 with bits hi:lo."""
    return torch.where(hi >= (1 << 31), hi - (1 << 32), hi) * (1 << 32) + lo


def _packed_eq_arrays(key_cvs, keys, nchunks):
    """Per key column, its equality arrays: the null flag and the order
    keys, adjacent 32-bit chunk words packed into one int64 (half the
    gathers and compares of the verify step)."""
    out = []
    for kcv, k, nc in zip(key_cvs, keys, nchunks):
        arrs = [(~kcv.validity).to(torch.uint8)] \
            + sk.order_keys(kcv, k.dtype, nc)
        widths = [8] + sk.key_widths(k.dtype, nc)
        packed, i = [], 0
        while i < len(arrs):
            if widths[i] == 32 and i + 1 < len(arrs) \
                    and widths[i + 1] == 32:
                packed.append(_pack_pair(arrs[i], arrs[i + 1]))
                i += 2
            else:
                packed.append(arrs[i])
                i += 1
        out.append(packed)
    return out


def _remix_round(h1, r: int):
    """Round-r bucket hash from the base row hash (unsigned 32-bit words):
    an integer finalizer, so only round 0 reads the keys."""
    if r == 0:
        return h1
    hm = h1 ^ ((0x9E3779B9 * r) & _M32)
    hm = _mul32(hm, 0x85EBCA6B)
    hm = hm ^ (hm >> 13)
    return _mul32(hm, 0xC2B2AE35)


class UngroupedAggExec(TpuExec):
    def __init__(self, child: TpuExec, agg_names: Sequence[str],
                 bound_aggs: Sequence[AggExpr], schema: Schema):
        super().__init__([child], schema)
        self.agg_names = list(agg_names)
        self.aggs = list(bound_aggs)
        self._base, self._stages, _ = collapse_fusable(child)

    def describe(self):
        return f"UngroupedAggExec[{self.agg_names}]"

    def num_partitions(self, ctx):
        return 1

    def _update(self, cvs, mask):
        cvs, mask = self._stages(cvs, mask)
        ctx = EmitCtx(cvs, mask.shape[0], mask.device)
        states = []
        for a in self.aggs:
            if a.child is not None:
                cv = a.child.emit(ctx)
            else:
                cv = CV(torch.zeros(mask.shape[0], dtype=torch.int8,
                                    device=mask.device),
                        torch.ones_like(mask))
            states.append(a.update(cv, mask))
        return states

    def execute_partition(self, ctx: ExecContext, pid: int):
        acc = None
        base = self._base
        for cpid in range(base.num_partitions(ctx)):
            for batch in base.execute_partition(ctx, cpid):
                st = self._update(batch.cvs(), batch.row_mask)
                acc = st if acc is None else [
                    a.merge(x, y) for a, x, y in zip(self.aggs, acc, st)]
        if acc is None:
            # an aggregate over empty input still yields one row: the
            # stages run over zero-length base columns
            cvs = [null_cv(f.dtype, 0, ctx.device)
                   for f in base.schema.fields]
            acc = self._update(cvs, torch.zeros(0, dtype=torch.bool,
                                                device=ctx.device))
        out = []
        for a, s in zip(self.aggs, acc):
            v, ok = a.finalize(s)
            out.append(_with_valid(v.reshape((1,) + tuple(v.shape))
                                   if not isinstance(v, CV) else v,
                                   ok.reshape(1)))
        ctx.add_metric(self._op_id, "numOutputRows", 1)
        yield DeviceBatch(make_table(self.schema, out, 1), 1)


def _with_valid(v, ok) -> CV:
    """A finalized value as a column: a tensor with validity `ok`, or an
    array-valued finalize (a list of percentages) with `ok` ANDed into
    its rows' validity."""
    if isinstance(v, CV):
        return dataclasses.replace(v, validity=v.validity & ok)
    return CV(v, ok)


class HashAggregateExec(TpuExec):
    """Grouped aggregation. Modes (the reference's partial / final
    GpuHashAggregateExec around GpuShuffleExchangeExec):
      complete - drain every child partition, merge, finalize (one
                 output partition);
      partial  - per child partition: first pass and merges, emit the
                 keys and state columns (the exchange's input);
      final    - merge the partial-format batches of one exchange
                 partition and finalize."""

    def __init__(self, child: TpuExec, key_names: Sequence[str],
                 bound_keys: Sequence[Expression], agg_names: Sequence[str],
                 bound_aggs: Sequence[AggExpr], schema: Schema,
                 mode: str = "complete"):
        if mode not in ("complete", "partial", "final"):
            raise ValueError(f"aggregate mode {mode!r}")
        self.mode = mode
        self.key_names = list(key_names)
        self.keys = list(bound_keys)
        self.agg_names = list(agg_names)
        self.aggs = list(bound_aggs)
        for a in self.aggs:
            if a.state_reducers is None:
                raise UnsupportedExpr(f"{a!r} does not support grouped "
                                      f"merge")
            if (a.child is not None and a.child.dtype.is_variable_width
                    and not isinstance(a, Count)):
                raise UnsupportedExpr(f"{a!r} over variable-width input")
        if mode == "partial":
            schema = self._partial_schema()
        super().__init__([child], schema)
        self._base = None
        self._stages = None
        # an aggregate whose update sorts (the t-digest) would defeat
        # the sort-free first pass (JAX `:398-406`)
        self._hash_ok = (all(isinstance(k.dtype, _HASHABLE)
                             for k in self.keys)
                         and all(getattr(a, "sort_free_update", True)
                                 for a in self.aggs))
        # set once, by whichever task meets the first overflow: either
        # path sums a group's rows in row order, so the result does not
        # depend on which batches took which
        self._hash_disabled = False
        self._wire = self.schema if mode == "partial" \
            else self._partial_schema()

    def describe(self):
        return (f"HashAggregateExec[{self.mode}, keys={self.key_names}, "
                f"aggs={self.agg_names}]")

    def _partial_schema(self) -> Schema:
        """The partial-state wire schema: the keys, then one column per
        state tensor."""
        fields = [Field(f"_k_{nm}", k.dtype)
                  for nm, k in zip(self.key_names, self.keys)]
        states = [t for a in self.aggs for t in a.state_dtypes()]
        return Schema(fields + [Field(f"_s{i}", t)
                                for i, t in enumerate(states)])

    def num_partitions(self, ctx):
        if self.mode in ("partial", "final"):
            return self.children[0].num_partitions(ctx)
        return 1

    def _resolve_fusion(self):
        if self._base is None:
            if self.mode == "final":
                self._base = self.children[0]
                self._stages = lambda cvs, mask: (cvs, mask)
            else:
                self._base, self._stages, _ = collapse_fusable(
                    self.children[0], require_ordinals=True)

    def _has_string_keys(self) -> bool:
        return any(k.dtype.is_variable_width for k in self.keys)

    # -- sizes read on the host ----------------------------------------
    def _nchunks_for(self, key_cvs, mask) -> Tuple[int, ...]:
        return sk.key_nchunks(key_cvs, [k.dtype for k in self.keys], mask)

    def _batch_nchunks(self, batch: DeviceBatch) -> Tuple[int, ...]:
        """nchunks of an input batch; a string key that is a plain column
        reference reads the batch's offsets without evaluating the key."""
        if not self._has_string_keys():
            return tuple(0 for _ in self.keys)
        cvs = batch.cvs()
        key_cvs = []
        for k in self.keys:
            e = k.child if isinstance(k, Alias) else k
            if not k.dtype.is_variable_width:
                key_cvs.append(None)
            elif isinstance(e, BoundRef):
                key_cvs.append(cvs[e.ordinal])
            else:
                key_cvs.append(k.emit(EmitCtx(cvs, batch.capacity,
                                              batch.device)))
        return self._nchunks_for(key_cvs, batch.row_mask)

    # -- per-batch first pass ------------------------------------------
    def _emit_inputs(self, cvs, mask):
        cvs, mask = self._stages(cvs, mask)
        cap = mask.shape[0]
        ectx = EmitCtx(cvs, cap, mask.device)
        key_cvs = [k.emit(ectx) for k in self.keys]
        inputs = []
        for a in self.aggs:
            if a.child is None:
                inputs.append(CV(torch.zeros(cap, dtype=torch.int8,
                                             device=mask.device),
                                 torch.ones_like(mask)))
                continue
            cv = a.child.emit(ectx)
            if cv.offsets is not None or cv.children:
                # count reads the validity only
                cv = CV(torch.zeros(cap, dtype=torch.int8,
                                    device=mask.device), cv.validity)
            inputs.append(cv)
        return key_cvs, inputs, mask

    def _hash_update(self, cvs, mask, nchunks, hash_once: bool):
        """The sort-free first pass. Returns (key CVs, rep row per slot,
        flat states, live slots, leftover rows, live slots count) over
        _HASH_ROUNDS rounds of buckets; the counts are 0-d tensors."""
        key_cvs, inputs, mask = self._emit_inputs(cvs, mask)
        cap = mask.shape[0]
        dev = mask.device
        eq_arrays = _packed_eq_arrays(key_cvs, self.keys, nchunks)
        if hash_once:
            h1 = hash_once_rows(eq_arrays)
        else:
            h1 = murmur3_row_hash(key_cvs, [k.dtype for k in self.keys],
                                  seed=42)
        remaining = mask
        rowidx = torch.arange(cap, device=dev)
        reps, lives, round_states = [], [], None
        for r in range(_HASH_ROUNDS):
            nb = _HASH_BUCKETS if r == 0 else _hash_buckets_for(cap)
            b = _remix_round(h1, r) % nb
            repmin = torch.full((nb,), cap, dtype=torch.int64, device=dev)
            repmin.scatter_reduce_(0, b, torch.where(remaining, rowidx, cap),
                                   "amin", include_self=True)
            has = repmin < cap
            rep = repmin.clamp(0, max(cap - 1, 0))
            rep_of_row = rep[b]
            match = remaining
            for arrs in eq_arrays:
                for arr in arrs:
                    match = match & (arr == arr[rep_of_row])
            flat = [c for a, icv in zip(self.aggs, inputs)
                    for c in a.g_update(icv, match, b, nb)]
            round_states = ([[f] for f in flat] if round_states is None
                            else [o + [f] for o, f in
                                  zip(round_states, flat)])
            reps.append(rep)
            lives.append(has)
            remaining = remaining & ~match
        live = torch.cat(lives)
        return (key_cvs, torch.cat(reps),
                [torch.cat(parts) for parts in round_states], live,
                remaining.sum(), live.sum())

    def _materialize_hash_partial(self, key_cvs, rep_rows, st, sl,
                                  n_live: int) -> Partial:
        """A hash-pass result as a partial of its live slots: the keys
        gather from the batch's key columns at the live groups only."""
        idx = compaction_perm(sl)[0][:n_live]
        ks = gather_cols(key_cvs, rep_rows[idx], None)
        return (ks, [s[idx] for s in st],
                torch.ones(n_live, dtype=torch.bool, device=sl.device),
                n_live)

    def _sort_and_segment(self, key_cvs, mask, nchunks):
        """One stable sort of (dead last, then each key's null flag and
        order keys), group boundaries, segment ids; the first row of each
        segment gives its keys. Output has the input's rows; live
        segments come first."""
        cap = mask.shape[0]
        dev = mask.device
        arrays = [(~mask).to(torch.uint8)]
        widths = [None]
        for kcv, k, nc in zip(key_cvs, self.keys, nchunks):
            arrays.append((~kcv.validity).to(torch.uint8))
            arrays += sk.order_keys(kcv, k.dtype, nc)
            widths += [None] + sk.key_widths(k.dtype, nc)
        words = sk.pack_keys(arrays, widths)
        perm = sk.lexsort(words)
        boundary = sk.group_boundaries([w[perm] for w in words])
        seg_ids = torch.cumsum(boundary.to(torch.int64), 0) - 1
        live_sorted = mask[perm]
        seg_live = seg_any(live_sorted, seg_ids, cap)
        seg_start = torch.full((cap,), cap, dtype=torch.int64, device=dev)
        seg_start.scatter_reduce_(0, seg_ids,
                                  torch.arange(cap, device=dev), "amin",
                                  include_self=True)
        src_rows = perm[seg_start.clamp(0, max(cap - 1, 0))]
        key_out = [take(kcv, src_rows, in_bounds=seg_live)
                   for kcv in key_cvs]
        return perm, seg_ids, live_sorted, seg_live, key_out

    def _update_sorted(self, cvs, mask, nchunks):
        key_cvs, inputs, mask = self._emit_inputs(cvs, mask)
        cap = mask.shape[0]
        perm, seg_ids, live, seg_live, key_out = \
            self._sort_and_segment(key_cvs, mask, nchunks)
        flat = []
        for a, cv in zip(self.aggs, inputs):
            scv = CV(cv.data[perm], cv.validity[perm])
            flat += a.g_update(scv, live, seg_ids, cap)
        return key_out, flat, seg_live

    def _update_one(self, ctx: ExecContext, batch: DeviceBatch,
                    hash_once: bool) -> Partial:
        """The first pass over one input batch. Host seconds go to
        hashPassTime or sortPassTime; each ends in a host read, so it
        also absorbs the device work queued before it (the upload)."""
        if self._hash_ok and not self._hash_disabled \
                and batch.capacity > 0:
            with ctx.timer(self._op_id, "hashPassTime"):
                nchunks = self._batch_nchunks(batch)
                key_cvs, rep_rows, st, sl, leftover, n_live = \
                    self._hash_update(batch.cvs(), batch.row_mask, nchunks,
                                      hash_once)
                lo, nl = fetch_ints([leftover, n_live])
                if lo == 0:
                    ctx.add_metric(self._op_id, "hashPassBatches", 1)
                    return self._materialize_hash_partial(
                        key_cvs, rep_rows, st, sl, nl)
            # bucket collisions past the last round: the exact sort path
            # takes this batch and the rest of the query
            self._hash_disabled = True
        with ctx.timer(self._op_id, "sortPassTime"):
            ctx.add_metric(self._op_id, "sortPassBatches", 1)
            ks, st, sl = self._update_sorted(
                batch.cvs(), batch.row_mask, self._batch_nchunks(batch))
            return (ks, st, sl, batch.capacity)

    # -- merge and finalize --------------------------------------------
    def _merge_sorted(self, key_cvs, flat_states, mask, nchunks):
        cap = mask.shape[0]
        perm, seg_ids, live, seg_live, key_out = \
            self._sort_and_segment(key_cvs, mask, nchunks)
        out, i = [], 0
        for a in self.aggs:
            width = _state_width(a)
            if "custom" in a.state_reducers:
                out.extend(a.g_merge_custom(
                    [flat_states[i + j][perm] for j in range(width)], live,
                    seg_ids, cap))
            else:
                for j, r in enumerate(a.state_reducers):
                    out.append(_seg_reduce(r, flat_states[i + j][perm],
                                           live, seg_ids, cap))
            i += width
        return key_out, out, seg_live

    def _merge_partials(self, ctx: ExecContext, parts) -> Partial:
        ctx.add_metric(self._op_id, "mergePasses", 1)
        if len(parts) == 1:
            ks, st, sl, _ = parts[0]
        else:
            ks = [concat_cvs([p[0][ki] for p in parts], k.dtype)
                  for ki, k in enumerate(self.keys)]
            st = [torch.cat([p[1][si] for p in parts])
                  for si in range(len(parts[0][1]))]
            sl = concat_masks([p[2] for p in parts])
        nchunks = self._nchunks_for(ks, sl)
        return self._compact_partial(*self._merge_sorted(ks, st, sl,
                                                         nchunks))

    def _compact_partial(self, ks, st, sl) -> Partial:
        """A merged partial cut to its live groups, which the merge put
        first: one host read for the group count and the string keys'
        byte counts."""
        cap = sl.shape[0]
        nlive_t = sl.sum()
        strs = [i for i, kcv in enumerate(ks) if kcv.offsets is not None]
        got = fetch_ints([nlive_t] + [ks[i].offsets[nlive_t] for i in strs])
        nlive, nbytes = got[0], dict(zip(strs, got[1:]))
        if nlive == cap:
            return (ks, st, sl, cap)
        ks2 = [CV(kcv.data[:nbytes[i]], kcv.validity[:nlive],
                  kcv.offsets[:nlive + 1]) if i in nbytes
               else CV(kcv.data[:nlive], kcv.validity[:nlive])
               for i, kcv in enumerate(ks)]
        return (ks2, [s[:nlive] for s in st], sl[:nlive], nlive)

    def _finalize(self, ks, st, sl):
        outs, i = list(ks), 0
        for a in self.aggs:
            k = _state_width(a)
            v, ok = a.finalize(tuple(st[i:i + k]))
            i += k
            outs.append(_with_valid(v, ok & sl))
        return outs

    def _emit_batch(self, part: Partial, emit_partial: bool) -> DeviceBatch:
        ks, st, sl, cap = part
        if emit_partial:
            cvs = list(ks) + [CV(s, torch.ones_like(sl)) for s in st]
        else:
            cvs = self._finalize(ks, st, sl)
        return DeviceBatch(make_table(self.schema, cvs, cap), cap, sl)

    def _bucket_slice(self, part: Partial, bucket: int, nbuckets: int,
                      seed: int) -> Optional[Partial]:
        """The live rows of a partial whose keys hash to `bucket` of
        `nbuckets` (murmur3 under `seed`), compacted; None when empty."""
        ks, st, sl, _ = part
        pids = partition_ids(ks, [k.dtype for k in self.keys], nbuckets,
                             seed=seed)
        cvs = list(ks) + [CV(s, torch.ones_like(sl)) for s in st]
        out, n = compact(cvs, sl & (pids == bucket))
        if n == 0:
            return None
        nk = len(ks)
        return (out[:nk], [cv.data for cv in out[nk:]],
                torch.ones(n, dtype=torch.bool, device=sl.device), n)

    # -- spillable partials --------------------------------------------
    def _park(self, ctx: ExecContext, part: Partial):
        """A partial as a partial-format batch in the spill store
        (priority 8): (handle, rows)."""
        ks, st, sl, n = part
        cvs = list(ks) + [CV(s, torch.ones_like(sl)) for s in st]
        batch = DeviceBatch(make_table(self._wire, cvs, n), n, sl)
        store = ctx.spill_store
        h = retry_no_split(lambda: store.add_batch(batch, priority=8),
                           dm=ctx.device_manager)
        return ctx.track(h), n

    def _unpark(self, h, close: bool = True) -> Partial:
        b = h.materialize()
        if close:
            h.close()
        cvs = b.cvs()
        nk = len(self.keys)
        return (cvs[:nk], [cv.data for cv in cvs[nk:]], b.row_mask,
                b.capacity)

    def _emit_final(self, ctx: ExecContext, handles, force_merge=False,
                    depth: int = 0):
        """Merge the parked partials and emit finalized (or
        partial-format) batches. Above maxMergeRows buffered rows, every
        partial splits into K hash buckets of disjoint keys, and each
        bucket merges on its own, recursing with a fresh seed on a bucket
        still too big. Handles close on generator exit, also when the
        consumer abandons the stream."""
        max_rows = ctx.conf.get(AGG_MAX_MERGE_ROWS)
        total = sum(n for _, n in handles)
        nb = 1
        while nb < 16 and total > nb * max_rows:
            nb *= 2
        emit_partial = self.mode == "partial"
        if nb == 1:
            with ctx.timer(self._op_id, "mergeTime"):
                parts = [self._unpark(h) for h, _ in handles]
                if (len(parts) > 1 or force_merge
                        or (not emit_partial and parts[0][3] > 4096)):
                    part = self._merge_partials(ctx, parts)
                else:
                    part = parts[0]
                out = self._emit_batch(part, emit_partial)
            yield out
            return
        ctx.add_metric(self._op_id, "numBucketSplits", 1)
        seed = (0x5EED ^ (depth * 0x9E3779B9)) & 0x7FFFFFFF
        open_handles = {h for h, _ in handles}
        try:
            for b in range(nb):
                sub = out = None
                with ctx.timer(self._op_id, "mergeTime"):
                    parts_b = []
                    for h, _ in handles:
                        last = b == nb - 1
                        part = self._unpark(h, close=last)
                        if last:
                            open_handles.discard(h)
                        q = self._bucket_slice(part, b, nb, seed)
                        if q is not None:
                            parts_b.append(q)
                    rows = sum(p[3] for p in parts_b)
                    if (rows > max_rows and depth + 1 < _MAX_BUCKET_DEPTH
                            and rows < total):
                        # still too big: park this bucket and split it
                        # again; rows < total stops a split that one key
                        # dominates
                        ctx.add_metric(self._op_id, "numBucketRecursions",
                                       1)
                        sub = [self._park(ctx, p) for p in parts_b]
                    elif parts_b:
                        out = self._emit_batch(
                            self._merge_partials(ctx, parts_b),
                            emit_partial)
                del parts_b
                if sub is not None:
                    yield from self._emit_final(ctx, sub, force_merge,
                                                depth + 1)
                elif out is not None:
                    yield out
        finally:
            for h in open_handles:
                h.close()

    def _execute_final(self, ctx: ExecContext, pid: int):
        """Park the partial-format batches of one exchange partition,
        then merge and finalize; a merge always runs, since one exchanged
        batch holds same-key rows of different map partitions."""
        store, dm = ctx.spill_store, ctx.device_manager
        handles = []
        try:
            for batch in self.children[0].execute_partition(ctx, pid):
                h = retry_no_split(lambda b=batch: store.add_batch(
                    b, priority=8), dm=dm)
                handles.append((ctx.track(h), batch.capacity))
            if handles:
                yield from self._emit_final(ctx, handles, force_merge=True)
        finally:
            for h, _ in handles:
                h.close()

    def _empty_batch(self, device) -> DeviceBatch:
        cvs = [null_cv(f.dtype, 0, device) for f in self.schema.fields]
        return DeviceBatch(make_table(self.schema, cvs, 0), 0,
                           torch.zeros(0, dtype=torch.bool, device=device))

    def execute_partition(self, ctx: ExecContext, pid: int):
        self._resolve_fusion()
        if self.mode == "final":
            yield from self._execute_final(ctx, pid)
            return
        child = self._base
        child_pids = ([pid] if self.mode == "partial"
                      else range(child.num_partitions(ctx)))
        hash_once = (self._has_string_keys()
                     and bool(ctx.conf.get(AGG_STRING_HASH_KEYS)))
        max_rows = ctx.conf.get(AGG_MAX_MERGE_ROWS)
        dm = ctx.device_manager

        def update(b):
            return self._update_one(ctx, b, hash_once)

        handles = []            # (handle, rows)
        buffered = 0
        compactable = True      # do eager merges still shrink the state?
        try:
            for cpid in child_pids:
                for batch in child.execute_partition(ctx, cpid):
                    ctx.add_metric(self._op_id, "inputBatches", 1)
                    for part in with_retry(batch, update, dm=dm):
                        handles.append(self._park(ctx, part))
                        buffered += part[3]
                    if (compactable and buffered > max_rows
                            and len(handles) > 1):
                        with ctx.timer(self._op_id, "mergeTime"):
                            parts = [self._unpark(h) for h, _ in handles]
                            merged = self._merge_partials(ctx, parts)
                            del parts
                            handles = [self._park(ctx, merged)]
                        buffered = merged[3]
                        # high cardinality: merging no longer shrinks
                        compactable = merged[3] <= max_rows // 2
                        del merged
            if not handles:
                if self.mode != "partial":
                    yield self._empty_batch(ctx.device)
                return
            yield from self._emit_final(ctx, handles)
        finally:
            for h, _ in handles:
                h.close()


def _list_output(vs: CV, keep, seg_ids, nseg: int) -> CV:
    """A list column of `nseg` rows from the kept rows of `vs` (in
    segment order, each segment's rows in order): per-segment counts
    give the offsets, the kept rows in order the element child (JAX
    `exec/aggregate.py:1425`). One host read, the kept count."""
    cnt = seg_sum(keep.to(torch.int64), seg_ids, nseg)
    off = torch.zeros(nseg + 1, dtype=torch.int32, device=keep.device)
    if nseg:
        torch.cumsum(cnt, 0, dtype=torch.int32, out=off[1:])
    idx = torch.nonzero(keep).squeeze(1)
    transfer.note_sync()
    child = take(vs, idx)
    return CV(torch.zeros(0, dtype=torch.int8, device=keep.device),
              torch.ones(nseg, dtype=torch.bool, device=keep.device), off,
              (child,))


class CollectAggExec(TpuExec):
    """Grouped aggregation on the sort path, for the aggregates the
    fixed-width state wire cannot carry (the port of the JAX package's
    `exec/aggregate.py:1267-1515`): count(DISTINCT) beside another
    aggregate or over several children, percentile and median (a list
    of percentages too), first / last of a string, collect_list and
    collect_set. The partition's batches concatenate on the device
    and compact to their live rows (like the JAX class, a whole
    partition at once and outside any retry scope, ROADMAP C.10); one
    stable sort by the keys makes each group's rows contiguous, in input
    order. Plain aggregates ride that segmentation (`g_update`, then
    `finalize`); a count(DISTINCT), a percentile and a collect_set add a
    second sort of each group's values; a collect's kept rows, in order,
    are its list child. The output holds the groups only (the JAX class
    pads to the partition's rows): one host read counts them.

    The planner first hash-exchanges the input rows on the grouping
    keys, so each partition's groups are whole and final
    (`per_partition`); without keys the aggregate is one group, which an
    empty input still yields (count 0, other values null)."""

    def __init__(self, child: TpuExec, key_names, bound_keys, agg_names,
                 bound_aggs, schema: Schema, per_partition: bool = False):
        super().__init__([child], schema)
        self.key_names = list(key_names)
        self.keys = list(bound_keys)
        self.agg_names = list(agg_names)
        self.aggs = list(bound_aggs)
        self.per_partition = per_partition

    def describe(self):
        return (f"CollectAggExec[keys={self.key_names}, "
                f"aggs={self.agg_names}]")

    def num_partitions(self, ctx):
        if self.per_partition:
            return self.children[0].num_partitions(ctx)
        return 1

    def _segments(self, key_cvs, n, dev):
        """(perm, seg_ids, first row of each segment in sorted order):
        one stable sort by each key's null flag and order keys."""
        if not self.keys:
            return (torch.arange(n, device=dev),
                    torch.zeros(n, dtype=torch.int64, device=dev),
                    torch.zeros(1, dtype=torch.int64, device=dev))
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        nchunks = sk.key_nchunks(key_cvs, [k.dtype for k in self.keys],
                                 ones)
        arrays, widths = [], []
        for kcv, k, nc in zip(key_cvs, self.keys, nchunks):
            arrays += [(~kcv.validity).to(torch.uint8)] \
                + sk.order_keys(kcv, k.dtype, nc)
            widths += [None] + sk.key_widths(k.dtype, nc)
        words = sk.pack_keys(arrays, widths)
        perm = sk.lexsort(words)
        boundary = sk.group_boundaries([w[perm] for w in words])
        seg_ids = torch.cumsum(boundary.to(torch.int64), 0) - 1
        starts = torch.nonzero(boundary).squeeze(1)
        transfer.note_sync()
        return perm, seg_ids, starts

    def _value_order(self, a, vs: CV, seg_ids):
        """The second sort: (segment, [valid first,] value) of one
        aggregate's sorted input."""
        nc = (sk.string_nchunks(vs, torch.ones_like(vs.validity))
              if a.child.dtype.is_variable_width else 0)
        varrs = [(~vs.validity).to(torch.uint8)] \
            + sk.order_keys(vs, a.child.dtype, nc)
        widths = [None, None] + sk.key_widths(a.child.dtype, nc)
        order2 = sk.lexsort([seg_ids] + varrs, widths)
        return order2, varrs

    def _collect_output(self, a, vs: CV, seg_ids, starts, nseg):
        valid = vs.validity
        if isinstance(a, _FirstLast):
            # a string's first / last: the row by position (the key
            # sort is stable, so positions keep the input order)
            elig = valid if a.ignore_nulls else torch.ones_like(valid)
            sel, has = _seg_extreme_pos(elig, seg_ids, nseg, a.take_first)
            return take(vs, sel, in_bounds=has)
        if isinstance(a, _Collect) and not a.is_set:
            # collect_list: the key sort is stable, so input order
            return _list_output(vs, valid, seg_ids, nseg)
        order2, varrs = self._value_order(a, vs, seg_ids)
        if isinstance(a, CountDistinct):
            seg2 = seg_ids[order2]
            first = sk.group_boundaries([seg2] + [x[order2] for x in varrs])
            keep = valid[order2] & first
            cnt = seg_sum(keep.to(torch.int64), seg2, nseg)
            return CV(cnt, torch.ones(nseg, dtype=torch.bool,
                                      device=cnt.device))
        if isinstance(a, Percentile):
            return self._percentile_output(a, vs, valid, seg_ids, order2,
                                           starts, nseg)
        # collect_set: each value's first occurrence in the value order
        # (a stable sort: the first in input order)
        seg2 = seg_ids[order2]
        firsts = sk.group_boundaries([seg2] + [x[order2] for x in varrs])
        first = torch.zeros_like(firsts)
        first[order2] = firsts
        return _list_output(vs, valid & first, seg_ids, nseg)

    @staticmethod
    def _percentile_output(a, vs, valid, seg_ids, order2, starts, nseg):
        """Rank selection from the value order: the valid values of
        segment g lie at order2 positions [starts[g], starts[g] +
        nvalid[g]), ascending (nulls sort after them). Interpolated
        linearly between the ranks floor(p (n - 1)) and ceil."""
        n = vs.validity.shape[0]
        nvalid = seg_sum(valid.to(torch.int32), seg_ids, nseg)
        sorted_vals = vs.data[order2]
        outs = []
        for p in a.percentages:
            fi = p * (nvalid - 1).clamp(min=0).to(torch.float64)
            lo = torch.floor(fi).to(torch.int64)
            hi = torch.ceil(fi).to(torch.int64)
            vlo = _pick(sorted_vals, (starts + lo).clamp(0, max(n - 1, 0)))
            vhi = _pick(sorted_vals, (starts + hi).clamp(0, max(n - 1, 0)))
            frac = fi - lo.to(torch.float64)
            # vlo (1 - frac) + vhi frac, as the JAX package's CPU compile
            # contracts it: one rounding of vhi * frac + (vlo (1 - frac))
            outs.append(fma(vhi.to(torch.float64), frac,
                            vlo.to(torch.float64) * (1 - frac)))
        ok = nvalid > 0
        if a.scalar_out:
            return CV(outs[0], ok)
        return percentile_list(outs, ok)

    def _run(self, cvs, n: int, dev) -> DeviceBatch:
        ectx = EmitCtx(cvs, n, dev)
        key_cvs = [k.emit(ectx) for k in self.keys]
        perm, seg_ids, starts = self._segments(key_cvs, n, dev)
        nseg = starts.shape[0]
        live = torch.ones(n, dtype=torch.bool, device=dev)
        outs = [take(kcv, perm[starts]) for kcv in key_cvs]
        for a in self.aggs:
            if a.child is None:
                cv = CV(torch.zeros(n, dtype=torch.int8, device=dev), live)
            else:
                cv = a.child.emit(ectx)
            if getattr(a, "is_collect", False):
                outs.append(self._collect_output(a, take(cv, perm),
                                                 seg_ids, starts, nseg))
                continue
            if cv.offsets is not None or cv.children:
                # count reads the validity
                scv = CV(torch.zeros(n, dtype=torch.int8, device=dev),
                         cv.validity[perm])
            else:
                scv = CV(cv.data[perm], cv.validity[perm])
            v, ok = a.finalize(a.g_update(scv, live, seg_ids, nseg))
            # a count's validity is one 0-d True
            outs.append(_with_valid(v, ok & torch.ones(
                nseg, dtype=torch.bool, device=dev)))
        return DeviceBatch(make_table(self.schema, outs, nseg), nseg)

    def execute_partition(self, ctx: ExecContext, pid: int):
        child = self.children[0]
        pids = [pid] if self.per_partition \
            else range(child.num_partitions(ctx))
        batches = [b for cpid in pids
                   for b in child.execute_partition(ctx, cpid)]
        if not batches and self.keys:
            return
        with ctx.timer(self._op_id, "opTime"):
            fields = child.schema.fields
            if batches:
                cvs = [concat_cvs([b.cvs()[i] for b in batches], f.dtype)
                       for i, f in enumerate(fields)]
                mask = concat_masks([b.row_mask for b in batches])
            else:
                cvs = [null_cv(f.dtype, 0, ctx.device) for f in fields]
                mask = torch.zeros(0, dtype=torch.bool, device=ctx.device)
            del batches
            cvs, n = compact(cvs, mask)
            out = self._run(cvs, n, ctx.device)
        ctx.add_metric(self._op_id, "numOutputBatches", 1)
        yield out
