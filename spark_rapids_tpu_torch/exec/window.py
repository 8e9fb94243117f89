"""Window function execution, in core or chunked.

The port of the JAX package's `exec/window.py` (reference:
window/GpuWindowExec.scala and GpuRunningWindowExec). One sort by the
(partition, order) keys, then every window function is a scan or a
reduction over the sorted layout: ranking from boundary scans, running
and bounded sums from prefix sums that restart at each partition,
running min / max from a doubling (Hillis-Steele) scan that stops at the
partition's first row, bounded min / max from a sparse table, RANGE
offsets from a per-row binary search, lag / lead from shifted gathers.
Output rows come in (partition, order) order; Spark promises none.

Where the JAX package differs from Spark, the port does not follow it
(ROADMAP C.23-C.26):

  - A double sum or average is exact and rounded once (`_xsum_*`): each
    finite value splits into 32-bit limbs of one fixed-point grid, the
    limbs' prefix sums are exact int64, and a frame's sum is the
    difference of two prefixes, rounded to the nearest double. No value
    of another partition reaches a frame (the JAX package differences
    one float prefix over the whole batch), the result equals
    `math.fsum` of the frame, and it is the same whatever the chunking.
    NaN and the infinities are counted apart: a frame holding a NaN, or
    both infinities, sums to NaN, one infinity to itself.
  - The chunked path carries a decimal128 running sum as its limb sums,
    so a sum that widens past 18 digits streams exactly.
  - lag / lead take their default for any type (a string, a decimal128).
  - A decimal average divides the sum by 10^scale.

`sql.window.chunkRows` (`WINDOW_CHUNK_ROWS`): above that many input rows
a spec whose functions are all running frames or ranking over
fixed-width keys streams through the out-of-core sort (partition keys
nulls first) chunk by chunk, with the state of the partition that
crosses a chunk's end carried into the next chunk and the last peer
group of each chunk held back for it (`numChunks`). Anything else runs
in core: every child batch concatenated into one. Host reads: the
longest partition and each double sum's exponent range (one read a
chunk or a batch), a chunk's emitted and live counts (one more), and
one for the string keys' chunk counts.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..columnar import dtypes as dt
from ..columnar.table import Schema
from ..expr.expressions import EmitCtx, Literal, UnsupportedExpr
from ..memory.retry import retry_no_split
from ..ops import sortkeys as sk
from ..ops.concat import concat_cvs, concat_masks
from ..ops.decimal128 import (combine_limb_sums, split_d128_limbs,
                              split_i64_limbs)
from ..ops.gather import gather_cols, take
from ..ops.kernel_utils import CV
from ..utils.transfer import fetch_ints
from ..window import CURRENT_ROW, UNBOUNDED, WindowExpr
from .base import ExecContext, TpuExec
from .batch import DeviceBatch
from .nodes import make_table

__all__ = ["WindowExec", "spec_signature", "xsum_frames"]

_M32 = 0xFFFFFFFF
_I64_MIN = -(1 << 63)
_NO_EXP = 1 << 20        # exponent sentinel of a frame set with no value


def spec_signature(spec):
    """Hashable (partition keys, orders) identity, the frame excluded: one
    sort serves every frame over the same keys (the reference's stage
    split, GpuWindowExecMeta.scala:182)."""
    return (tuple(repr(k) for k in spec.partition_keys),
            tuple((repr(o.expr), o.ascending, o.nulls_first)
                  for o in spec.orders))


# ----------------------------------------------------------------------
# segment layout and scans
# ----------------------------------------------------------------------
def _starts(boundary, pos):
    """The first row of each row's run (a run starts where boundary)."""
    return torch.cummax(torch.where(boundary, pos, 0), 0).values


def _ends(boundary, pos):
    """The last row of each row's run."""
    cap = boundary.shape[0]
    last = torch.ones_like(boundary)
    last[:-1] = boundary[1:]
    e = torch.where(last, pos, cap - 1)
    return torch.flip(torch.cummin(torch.flip(e, [0]), 0).values, [0])


def _ident(dtype: torch.dtype, for_min: bool):
    if dtype.is_floating_point:
        return math.inf if for_min else -math.inf
    if dtype == torch.bool:
        return for_min
    info = torch.iinfo(dtype)
    return info.max if for_min else info.min


def _shifted_back(x, sh: int, fill):
    """x[i - sh], `fill` where i < sh."""
    out = torch.full_like(x, fill)
    if sh < x.shape[0]:
        out[sh:] = x[:x.shape[0] - sh]
    return out


def _running(x, seg_start):
    """Segmented running sum of an integer array: the prefix minus the
    segment's base prefix (exact, wrapping as Java's long does)."""
    pre = torch.cumsum(x, 0)
    base = torch.where(seg_start > 0,
                       pre[(seg_start - 1).clamp(min=0)], 0)
    return pre - base


def _frame_diff(pre, lo, hi):
    """Sum over rows [lo, hi] from an inclusive prefix (0 when empty)."""
    cap = pre.shape[-1]
    top = pre[..., hi.clamp(0, cap - 1)]
    bot = torch.where(lo > 0, pre[..., (lo - 1).clamp(0, cap - 1)], 0)
    return torch.where(hi < lo, 0, top - bot)


def _seg_scan(vals, seg_start, pos, red, steps: int):
    """Segmented running reduce: the doubling scan (Hillis-Steele) whose
    every step stops at the row's partition start. After the step of
    shift `sh` a row holds the reduce over its last 2 sh rows of the
    partition; `steps` covers the longest partition."""
    out = vals
    for k in range(steps):
        sh = 1 << k
        if sh >= vals.shape[0]:
            break
        prev = _shifted_back(out, sh, 0)
        cond = pos - sh >= seg_start
        if out.dim() == 2:
            cond = cond[:, None]
        out = torch.where(cond, red(out, prev), out)
    return out


def _d128_lt(al, ah, bl, bh):
    """Two's-complement 128-bit a < b over (lo, hi) words: the signed hi
    word, then the lo word in unsigned order (its sign bit flipped)."""
    return (ah < bh) | ((ah == bh) & ((al ^ _I64_MIN) < (bl ^ _I64_MIN)))


def _d128_red(is_min: bool):
    def red(a, b):
        al, ah = a[:, 0], a[:, 1]
        bl, bh = b[:, 0], b[:, 1]
        a_wins = _d128_lt(al, ah, bl, bh) if is_min \
            else _d128_lt(bl, bh, al, ah)
        return torch.where(a_wins[:, None], a, b)
    return red


def _d128_ident(is_min: bool, n: int, device):
    hi = (1 << 63) - 1 if is_min else _I64_MIN
    lo = -1 if is_min else 0
    return torch.tensor([lo, hi], dtype=torch.int64,
                        device=device).expand(n, 2).clone()


def _floor_log2(n):
    """floor(log2(n)) of positive int64 lengths."""
    j = torch.floor(torch.log2(n.to(torch.float64))).to(torch.int64)
    one = torch.ones_like(j)
    j = torch.where(torch.bitwise_left_shift(one, j) > n, j - 1, j)
    return torch.where(torch.bitwise_left_shift(one, j + 1) <= n, j + 1, j)


def _nlev(max_len: int) -> int:
    return max(1, int(math.ceil(math.log2(max(2, max_len)))) + 1)


def _rmq(v, ok, lo, hi, red, ident_rows, nlev: int):
    """Range reduce over [lo, hi] a row through a sparse table:
    T[j][i] = reduce(v[i .. i + 2^j - 1]), `nlev` levels. `v` holds the
    identity at invalid rows ([n] or decimal128 [n, 2]); returns
    (reduced, any valid row in the frame)."""
    cap = v.shape[0]
    T = torch.empty((nlev,) + tuple(v.shape), dtype=v.dtype,
                    device=v.device)
    TO = torch.empty((nlev, cap), dtype=torch.bool, device=v.device)
    T[0], TO[0] = v, ok
    for j in range(1, nlev):
        sh = 1 << (j - 1)
        cur, cok = T[j - 1], TO[j - 1]
        if sh >= cap:
            T[j], TO[j] = cur, cok
            continue
        shifted = torch.cat([cur[sh:], ident_rows[:sh]])
        T[j] = red(cur, shifted)
        TO[j] = cok | torch.cat([cok[sh:], torch.zeros(
            sh, dtype=torch.bool, device=v.device)])
    length = (hi - lo + 1).clamp(min=1)
    j = _floor_log2(length).clamp(0, nlev - 1)
    a = lo.clamp(0, cap - 1)
    b = (hi - torch.bitwise_left_shift(torch.ones_like(j), j) + 1).clamp(
        0, cap - 1)
    out = red(T[j, a], T[j, b])
    return out, (TO[j, a] | TO[j, b]) & (hi >= lo)


def _bsearch(skey, q, lo, hi, nbits: int, left: bool, descending: bool):
    """Per-row binary search of the (segment-) sorted key: the first index
    in [lo, hi) whose key is >= q (left) or > q (right), under the sort
    direction; every row searches at once, `nbits` + 1 halvings."""
    cap = skey.shape[0]
    for _ in range(nbits + 1):
        mid = (lo + hi) // 2
        kv = skey[mid.clamp(0, cap - 1)]
        if descending:
            below = (kv > q) if left else (kv >= q)
        else:
            below = (kv < q) if left else (kv <= q)
        active = lo < hi
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


# ----------------------------------------------------------------------
# exact double sums
# ----------------------------------------------------------------------
def _pow2(e):
    """2.0 ** e for int64 e in [-1022, 1023], built from its bits."""
    return torch.bitwise_left_shift(e + 1023, 52).view(torch.float64)


def _xsum_range(x, ok):
    """(lowest, highest) binary exponent E of x = m 2^E (m a 53-bit
    integer) over the finite nonzero values under `ok`, as 0-d int64
    tensors; (+_NO_EXP, -_NO_EXP) when there are none."""
    use = ok & torch.isfinite(x) & (x != 0)
    _, ex = torch.frexp(torch.where(use, x, 1.0))
    e = ex.to(torch.int64) - 53
    lo = torch.where(use, e, _NO_EXP).min() if x.numel() else \
        torch.tensor(_NO_EXP, device=x.device)
    hi = torch.where(use, e, -_NO_EXP).max() if x.numel() else \
        torch.tensor(-_NO_EXP, device=x.device)
    return lo, hi


def _xsum_grid(elo: int, ehi: int, rows: int, carry=None):
    """(base, limbs): the fixed-point grid of 32-bit limbs, base a
    multiple of 32 at or below every value's lowest bit, enough limbs
    for `rows` values' sum and the carried limb sums (base_c, limbs_c)
    with room for the sign."""
    grow = max(1, int(rows)).bit_length() + 1
    if elo > ehi:
        elo = ehi = 0
    base = 32 * (elo // 32)
    top = ehi + 53 + grow
    if carry is not None:
        cbase, climbs = carry
        base = min(base, cbase)
        top = max(top, cbase + 32 * climbs + grow)
    return base, (top - base) // 32 + 2


def _xsum_limbs(x, ok, base: int, limbs: int):
    """[limbs, n] int64: row i's finite value as 32-bit limbs of the grid
    (the top contribution signed), zeros elsewhere."""
    n = x.shape[0]
    dev = x.device
    use = ok & torch.isfinite(x) & (x != 0)
    mant, ex = torch.frexp(torch.where(use, x, 0.0))
    m = (mant * 2.0 ** 53).to(torch.int64)
    s = torch.where(use, ex.to(torch.int64) - 53 - base, 0)
    j0, r = s >> 5, s & 31
    ml, mh = m & _M32, m >> 32
    one = torch.ones_like(r)
    keep = torch.bitwise_left_shift(one, 32 - r) - 1
    c0 = torch.bitwise_left_shift(ml & keep, r)
    hr = torch.bitwise_left_shift(mh, r)
    c1 = torch.bitwise_right_shift(ml, 32 - r) + (hr & _M32)
    c2 = hr >> 32
    D = torch.zeros(limbs * n, dtype=torch.int64, device=dev)
    idx = j0 * n + torch.arange(n, device=dev)
    D.index_add_(0, idx, c0)
    D.index_add_(0, idx + n, c1)
    D.index_add_(0, idx + 2 * n, c2)
    return D.view(limbs, n)


def _negate(limbs):
    out, carry = [], 1
    for l in limbs:
        v = (l ^ _M32) + carry
        out.append(v & _M32)
        carry = v >> 32
    return out


def _xsum_round(S, base: int):
    """The doubles nearest to the exact values sum_j S[j] 2^(32 j + base)
    ([limbs, n] int64 limb sums, each below 2^62): carries propagate to
    32-bit limbs, the top 62 bits (and a sticky bit for the rest) convert
    once (round to odd, then to nearest), then the exponent applies."""
    J, n = S.shape
    dev = S.device
    limbs, carry = [], torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(J):
        v = S[j] + carry
        limbs.append(v & _M32)
        carry = v >> 32
    neg = carry < 0
    mag = torch.stack([torch.where(neg, a, b)
                       for a, b in zip(_negate(limbs), limbs)])
    nz = mag != 0
    any_nz = nz.any(0)
    jj = torch.arange(J, device=dev)[:, None]
    t = torch.where(nz, jj, 0).amax(0)

    def limb(k):
        got = mag.gather(0, k.clamp(min=0)[None])[0]
        return torch.where(k >= 0, got, 0)
    u2, u1, u0 = limb(t), limb(t - 1), limb(t - 2)
    cnz = torch.cumsum(nz.to(torch.int64), 0)
    lower = torch.where(t >= 3, cnz.gather(0, (t - 3).clamp(min=0)[None])[0],
                        0) > 0
    _, nb = torch.frexp(torch.where(any_nz, u2, 1).to(torch.float64))
    nb = nb.to(torch.int64)
    sh = nb + 2
    one = torch.ones_like(nb)
    w = torch.bitwise_left_shift(u2, 62 - nb)
    w = w | torch.where(nb <= 30,
                        torch.bitwise_left_shift(u1, (30 - nb).clamp(min=0)),
                        torch.bitwise_right_shift(u1, (nb - 30).clamp(min=0)))
    w = w | torch.bitwise_right_shift(u0, sh)
    lost_lo = (u0 & (torch.bitwise_left_shift(one, sh.clamp(max=32)) - 1)) \
        != 0
    lost_hi = (u0 != 0) | ((u1 & (torch.bitwise_left_shift(
        one, (sh - 32).clamp(min=0)) - 1)) != 0)
    sticky = torch.where(sh <= 32, lost_lo, lost_hi) | lower
    d = (w | sticky.to(torch.int64)).to(torch.float64)
    e = sh + 32 * (t - 2) + base
    e1 = e >> 1
    val = d * _pow2(e1) * _pow2(e - e1)
    val = torch.where(neg, -val, val)
    return torch.where(any_nz, val, 0.0)


def _nonfinite(x, ok):
    """[3, n] int64 flags of NaN, +inf and -inf under `ok`."""
    return torch.stack([ok & torch.isnan(x), ok & (x == math.inf),
                        ok & (x == -math.inf)]).to(torch.int64)


def _nonfinite_result(val, counts):
    nan = (counts[0] > 0) | ((counts[1] > 0) & (counts[2] > 0))
    val = torch.where(counts[1] > 0, math.inf, val)
    val = torch.where(counts[2] > 0, -math.inf, val)
    return torch.where(nan, math.nan, val)


def xsum_frames(x, ok, lo, hi, elo: int, ehi: int):
    """The exact double sum of x over rows [lo, hi] a row (valid rows
    `ok`; an empty frame sums to 0.0), rounded once: equal to
    `math.fsum` of the frame's values. `elo` / `ehi` bound the values'
    exponents (`_xsum_range`, read on the host)."""
    base, J = _xsum_grid(elo, ehi, x.shape[0])
    P = torch.cumsum(_xsum_limbs(x, ok, base, J), 1)
    val = _xsum_round(_frame_diff(P, lo, hi), base)
    F = torch.cumsum(_nonfinite(x, ok), 1)
    return _nonfinite_result(val, _frame_diff(F, lo, hi))


# ----------------------------------------------------------------------
class WindowExec(TpuExec):
    def __init__(self, child: TpuExec, names: Sequence[str],
                 wexprs: Sequence[WindowExpr], schema: Schema):
        super().__init__([child], schema)
        self.names = list(names)
        self.wexprs = list(wexprs)
        spec = self.wexprs[0].spec
        sig = spec_signature(spec)
        for w in self.wexprs[1:]:
            if spec_signature(w.spec) != sig:
                raise UnsupportedExpr(
                    "one WindowExec handles one (partition, order) spec; "
                    "the planner stages differing specs into a chain")
        self.spec = spec

    def num_partitions(self, ctx):
        return 1

    def describe(self):
        return f"WindowExec[{[w.fn for w in self.wexprs]}]"

    # ---- the sorted layout -------------------------------------------
    def _prepare(self, cvs, mask, nchunks, pk_nulls_first=False,
                 presorted=False):
        """Sort and segment a batch: (EmitCtx, window context). Partition
        keys sort nulls last, or first (`pk_nulls_first`, the chunk
        stream's order, so a null partition stays contiguous across
        chunks). `presorted` (the chunk stream, already in order) only
        moves the dead rows to the back."""
        cap = mask.shape[0]
        dev = mask.device
        ctx = EmitCtx(list(cvs), cap, dev)
        pkeys = [k.emit(ctx) for k in self.spec.partition_keys]
        okeys = [o.expr.emit(ctx) for o in self.spec.orders]
        dead = (~mask).to(torch.uint8)
        nk = len(pkeys)
        pk_arrays, pk_widths = [], []
        for kcv, kexpr, nc in zip(pkeys, self.spec.partition_keys,
                                  nchunks[:nk]):
            nullkey = kcv.validity if pk_nulls_first else ~kcv.validity
            pk_arrays.append(nullkey.to(torch.uint8))
            pk_widths.append(None)
            pk_arrays += sk.order_keys(kcv, kexpr.dtype, nc)
            pk_widths += sk.key_widths(kexpr.dtype, nc)
        ok_arrays, ok_widths = [], []
        for kcv, o, nc in zip(okeys, self.spec.orders, nchunks[nk:]):
            vkey = kcv.validity.to(torch.uint8)
            ok_arrays.append(vkey if o.nulls_first else ~vkey)
            ok_widths.append(None)
            ok_arrays += sk.order_keys(kcv, o.expr.dtype, nc,
                                       descending=not o.ascending)
            ok_widths += sk.key_widths(o.expr.dtype, nc)
        if presorted:
            perm = torch.argsort(dead, stable=True)
        else:
            perm = sk.lexsort([dead] + pk_arrays + ok_arrays,
                              [None] + pk_widths + ok_widths)
        live = mask[perm]
        pos = torch.arange(cap, device=dev)
        pb = sk.group_boundaries([a[perm] for a in [dead] + pk_arrays])
        ob = pb | sk.group_boundaries([a[perm] for a in ok_arrays]) \
            if ok_arrays else pb
        seg_start, seg_end = _starts(pb, pos), _ends(pb, pos)
        # the sorted first order key (RANGE offsets search it); an
        # integer key widens to int64 before the null sentinel applies,
        # so key + offset cannot reach the sentinel
        skey = None
        if okeys and okeys[0].offsets is None and okeys[0].data.dim() == 1:
            o0 = self.spec.orders[0]
            kcv = take(okeys[0], perm, in_bounds=live)
            kdata = kcv.data
            if not kdata.dtype.is_floating_point \
                    and kdata.dtype != torch.bool:
                kdata = kdata.to(torch.int64)
            sentinel = _ident(kdata.dtype,
                              for_min=(o0.nulls_first != o0.ascending))
            skey = (torch.where(kcv.validity & live, kdata, sentinel),
                    kcv.validity & live)
        wc = dict(perm=perm, live=live, pb=pb, ob=ob, pos=pos,
                  seg_ids=torch.cumsum(pb.to(torch.int64), 0) - 1,
                  seg_start=seg_start, seg_end=seg_end,
                  pos_in_seg=pos - seg_start,
                  cnt_row=seg_end - seg_start + 1,
                  peer_start=_starts(ob, pos), peer_end=_ends(ob, pos),
                  skey=skey, cap=cap, pkeys=pkeys, dev=dev)
        return ctx, wc

    def _inputs(self, ctx, wc):
        """Each expression's sorted input column (None for ranking), and
        the 0-d tensors the host must read before the functions run: the
        longest partition (of live rows: the dead rows' outputs are
        masked), then each exact double sum's exponent range."""
        scvs, reads = [], [torch.where(wc["live"], wc["cnt_row"], 1).max()
                           if wc["cap"] else torch.tensor(1)]
        for w in self.wexprs:
            if w.child is None:
                scvs.append(None)
                continue
            scv = take(w.child.emit(ctx), wc["perm"], in_bounds=wc["live"])
            scvs.append(scv)
            if self._exact_double(w, scv):
                reads += list(_xsum_range(scv.data,
                                          scv.validity & wc["live"]))
        return scvs, reads

    @staticmethod
    def _exact_double(w, scv) -> bool:
        return w.fn in ("sum", "avg") and scv.offsets is None \
            and scv.data.dim() == 1 and scv.data.dtype.is_floating_point

    def _compute(self, cvs, mask, nchunks, dm=None):
        ctx, wc = self._prepare(cvs, mask, nchunks)
        scvs, reads = self._inputs(ctx, wc)
        got = list(fetch_ints(reads))
        wc["max_seg"] = max(1, got.pop(0))
        outs = []
        for w, scv in zip(self.wexprs, scvs):
            exp = None
            if scv is not None and self._exact_double(w, scv):
                exp = (got.pop(0), got.pop(0))
            outs.append(self._one(w, wc, scv, exp, dm))
        sorted_cols = [take(cv, wc["perm"], in_bounds=wc["live"])
                       for cv in cvs]
        return sorted_cols, outs, wc["live"]

    # ---- frames --------------------------------------------------------
    def _steps(self, wc) -> int:
        return max(1, int(wc["max_seg"] - 1).bit_length())

    def _frame_bounds(self, w: WindowExpr, wc):
        """Any frame as per-row [lo, hi] row bounds over the sorted
        layout, and the longest frame it can give."""
        k, m_ = w.spec.frame
        seg_start, seg_end = wc["seg_start"], wc["seg_end"]
        pos, cap = wc["pos"], wc["cap"]
        if w.spec.frame_mode == "rows":
            lo = (seg_start if k is UNBOUNDED
                  else torch.maximum(pos + k, seg_start))
            hi = (seg_end if m_ is UNBOUNDED
                  else torch.minimum(pos + m_, seg_end))
            max_len = (cap if (k is UNBOUNDED or m_ is UNBOUNDED)
                       else max(int(m_) - int(k) + 1, 1))
            return lo, hi, max_len

        # RANGE: a CURRENT ROW bound lands on the peer group, a numeric
        # offset binary-searches the one sorted order key
        def side(bound, is_lo):
            if bound is UNBOUNDED:
                return seg_start if is_lo else seg_end
            if bound == 0:
                return wc["peer_start"] if is_lo else wc["peer_end"]
            if wc["skey"] is None or len(w.spec.orders) != 1:
                raise UnsupportedExpr(
                    "RANGE offset frames need exactly one numeric "
                    "order key")
            skey, skvalid = wc["skey"]
            desc = not w.spec.orders[0].ascending
            off = -bound if desc else bound
            if not skey.dtype.is_floating_point:
                # the key is int64 here: saturate at the domain's edges
                # so key + offset cannot wrap
                q = skey + int(off)
                if off >= 0:
                    q = torch.where(q < skey, (1 << 63) - 1, q)
                else:
                    q = torch.where(q > skey, _I64_MIN, q)
            else:
                q = skey + off
            nbits = max(1, int(wc["max_seg"]).bit_length())
            idx = _bsearch(skey, q, seg_start, seg_end + 1, nbits,
                           left=is_lo, descending=desc)
            if not is_lo:
                idx = idx - 1
            # a null key's frame is its peer (null) group
            return torch.where(skvalid, idx, wc["peer_start"] if is_lo
                               else wc["peer_end"])
        return side(k, True), side(m_, False), cap

    # ---- one function, in core -------------------------------------------
    def _one(self, w: WindowExpr, wc, scv, exp, dm=None):
        live, cap = wc["live"], wc["cap"]
        pos, pos_in_seg = wc["pos"], wc["pos_in_seg"]
        seg_start, cnt_row = wc["seg_start"], wc["cnt_row"]
        if w.fn == "row_number":
            return CV((pos_in_seg + 1).to(torch.int32), live)
        if w.fn in ("rank", "percent_rank"):
            last_ob = torch.cummax(torch.where(wc["ob"], pos, -1), 0).values
            rk = last_ob - seg_start + 1
            if w.fn == "rank":
                return CV(rk.to(torch.int32), live)
            denom = (cnt_row - 1).clamp(min=1).to(torch.float64)
            return CV(torch.where(cnt_row > 1,
                                  (rk - 1).to(torch.float64) / denom, 0.0),
                      live)
        if w.fn == "dense_rank":
            c2 = torch.cumsum(wc["ob"].to(torch.int64), 0)
            base = c2[seg_start.clamp(0, cap - 1)]
            return CV((c2 - base + 1).to(torch.int32), live)
        if w.fn == "cume_dist":
            frac = ((wc["peer_end"] - seg_start + 1).to(torch.float64)
                    / cnt_row.to(torch.float64))
            return CV(frac, live)
        if w.fn == "ntile":
            n = w.offset
            q, r = cnt_row // n, cnt_row % n
            big = r * (q + 1)
            bucket = torch.where(
                pos_in_seg < big, pos_in_seg // (q + 1).clamp(min=1),
                r + (pos_in_seg - big) // q.clamp(min=1))
            return CV((bucket + 1).to(torch.int32), live)

        if w.fn in ("lag", "lead"):
            return self._lag_lead(w, wc, scv)
        if w.fn in ("first_value", "last_value", "nth_value"):
            lo, hi, _ = self._frame_bounds(w, wc)
            idx = lo if w.fn == "first_value" else \
                hi if w.fn == "last_value" else lo + w.offset - 1
            ok = live & (idx >= lo) & (idx <= hi) & (hi >= lo)
            return gather_cols([scv], idx.clamp(0, cap - 1), ok)[0]

        valid = scv.validity & live
        frame = w.spec.frame
        x = scv.data
        if w.fn != "count" and (x.dim() == 2 or (
                isinstance(w.dtype, dt.DecimalType)
                and w.dtype.is_decimal128)):
            return self._one_d128(w, wc, scv, valid, dm)
        lo, hi, max_len = self._frame_bounds(w, wc)
        c = _frame_diff(torch.cumsum(valid.to(torch.int64), 0), lo, hi)
        if w.fn == "count":
            return self._finish(w, None, c, live)
        if w.fn in ("min", "max"):
            is_min = w.fn == "min"
            red = torch.minimum if is_min else torch.maximum
            ident = _ident(x.dtype, is_min)
            v = torch.where(valid, x, ident)
            if frame == (UNBOUNDED, UNBOUNDED):
                s = torch.full_like(v, ident).scatter_reduce(
                    0, wc["seg_ids"], v, "amin" if is_min else "amax",
                    include_self=False)[wc["seg_ids"]]
            elif frame == (UNBOUNDED, CURRENT_ROW):
                s = _seg_scan(v, seg_start, pos, red, self._steps(wc))[hi]
            else:
                nlev = _nlev(min(max_len, wc["max_seg"], cap))
                s, ok = self._reserved(
                    dm, nlev * cap * (x.element_size() + 1),
                    lambda: _rmq(v, valid, lo, hi, red,
                                 torch.full_like(v, ident), nlev))
                c = ok.to(torch.int64)
            return self._finish(w, s, c, live)
        if exp is not None:
            s = self._reserved(
                dm, 3 * _xsum_grid(*exp, cap)[1] * cap * 8,
                lambda: xsum_frames(x.to(torch.float64), valid, lo, hi,
                                    *exp))
            return self._finish(w, s, c, live)
        xz = torch.where(valid, x.to(torch.int64), 0)
        s = _frame_diff(torch.cumsum(xz, 0), lo, hi)
        return self._finish(w, s, c, live)

    @staticmethod
    def _reserved(dm, nbytes: int, fn):
        """Run `fn` with `nbytes` of scratch reserved against the device
        budget (a sparse table, the limb grid of an exact sum)."""
        if dm is None:
            return fn()
        dm.reserve(nbytes)
        try:
            return fn()
        finally:
            dm.release(nbytes)

    def _lag_lead(self, w, wc, scv):
        """The value `offset` rows back (lag) or ahead (lead) in the
        partition, else the default (any type but a nested one)."""
        live, cap, pos = wc["live"], wc["cap"], wc["pos"]
        off = w.offset if w.fn == "lag" else -w.offset
        j = pos - off
        in_seg = (j >= wc["seg_start"]) & (j <= wc["seg_end"])
        j = j.clamp(0, cap - 1)
        if w.default is None or w.dtype.is_nested:
            return take(scv, j, in_bounds=in_seg & live)
        dcv = Literal(w.default, w.dtype).emit(EmitCtx([], cap, wc["dev"]))
        if scv.offsets is None:
            out = take(scv, j, in_bounds=in_seg & live)
            cond = in_seg if out.data.dim() == 1 else in_seg[:, None]
            return CV(torch.where(cond, out.data, dcv.data),
                      torch.where(in_seg, out.validity, live))
        both = concat_cvs([scv, dcv], w.dtype)
        return take(both, torch.where(in_seg, j, cap + pos), in_bounds=live)

    def _one_d128(self, w, wc, scv, valid, dm=None):
        """Decimal128 aggregates by limbs: four 32-bit limbs (two for a
        64-bit input) in int64 lanes, whose prefix sums stay exact, and
        one carry pass an output (`combine_limb_sums`); min / max over
        (lo, hi) words in two's-complement order."""
        live, cap, pos = wc["live"], wc["cap"], wc["pos"]
        frame = w.spec.frame
        x = scv.data
        lo, hi, max_len = self._frame_bounds(w, wc)
        c = _frame_diff(torch.cumsum(valid.to(torch.int64), 0), lo, hi)
        if w.fn in ("min", "max"):
            is_min = w.fn == "min"
            x2 = x if x.dim() == 2 else torch.stack(
                [x.to(torch.int64), x.to(torch.int64) >> 63], 1)
            idr = _d128_ident(is_min, cap, x.device)
            v = torch.where(valid[:, None], x2, idr)
            red = _d128_red(is_min)
            if frame in ((UNBOUNDED, UNBOUNDED), (UNBOUNDED, CURRENT_ROW)):
                s = _seg_scan(v, wc["seg_start"], pos, red,
                              self._steps(wc))[hi]
                ok = live & (c > 0)
            else:
                nlev = _nlev(min(max_len, wc["max_seg"], cap))
                s, ok = self._reserved(
                    dm, nlev * cap * 17,
                    lambda: _rmq(v, valid, lo, hi, red, idr, nlev))
                ok = ok & live
            return CV(torch.where(ok[:, None], s, 0), ok)
        limbs = (split_d128_limbs(x) if x.dim() == 2
                 else split_i64_limbs(x.to(torch.int64)))
        sums = [_frame_diff(torch.cumsum(torch.where(valid, l, 0), 0),
                            lo, hi) for l in limbs]
        return self._finish_d128(w, sums, c, live)

    @staticmethod
    def _finish_d128(w, sums, c, live):
        """An exact decimal128 sum (null past its precision), or the
        average as a double, from per-limb sums."""
        prec = 38 if w.fn == "avg" else w.dtype.precision
        packed, ovf = combine_limb_sums(sums, prec)
        ok = live & (c > 0) & ~ovf
        packed = torch.where(ok[:, None], packed, 0)
        if w.fn == "avg":
            lo = packed[:, 0].to(torch.float64)
            f = (packed[:, 1].to(torch.float64) * (2.0 ** 64)
                 + torch.where(packed[:, 0] < 0, lo + 2.0 ** 64, lo))
            safe = c.clamp(min=1).to(torch.float64)
            return CV(f / safe / (10.0 ** w.child.dtype.scale), ok)
        return CV(packed, ok)

    @staticmethod
    def _finish(w, s, c, live):
        if w.fn == "count":
            return CV(c.to(torch.int64), live)
        if w.fn == "avg":
            safe = torch.where(c > 0, c, 1)
            out = s.to(torch.float64) / safe
            if isinstance(w.child.dtype, dt.DecimalType):
                out = out / (10.0 ** w.child.dtype.scale)
            return CV(out, live & (c > 0))
        return CV(s.to(dt.torch_dtype(w.dtype)), live & (c > 0))

    # ---- chunked (out-of-core) windows -----------------------------------
    _CHUNK_RUNNING = ("sum", "avg", "count", "min", "max")
    _CHUNK_RANKING = ("row_number", "rank", "dense_rank")

    def _chunkable(self) -> bool:
        """Running frames and ranking over fixed-width keys stream chunk
        by chunk with carried per-partition state (reference:
        GpuRunningWindowExec.scala's batched running windows); anything
        else needs whole partitions resident."""
        if not self.spec.orders:
            return False

        def fixed(e):
            return not (e.dtype.is_variable_width or e.dtype.is_nested
                        or (isinstance(e.dtype, dt.DecimalType)
                            and e.dtype.is_decimal128))
        if not all(fixed(k) for k in self.spec.partition_keys):
            return False
        if not all(fixed(o.expr) for o in self.spec.orders):
            return False
        for w in self.wexprs:
            if w.fn in self._CHUNK_RANKING:
                continue
            if (w.fn in self._CHUNK_RUNNING
                    and w.spec.frame == (UNBOUNDED, CURRENT_ROW)
                    and w.child is not None and fixed(w.child)):
                continue
            return False
        return True

    def _zero_carry(self, dev):
        """The carried state before the first chunk: no partition yet."""
        def z(dtype=torch.int64):
            return torch.zeros((), dtype=dtype, device=dev)
        pk = tuple((z(dt.torch_dtype(k.dtype)), z(torch.bool))
                   for k in self.spec.partition_keys)
        aggs = []
        for w in self.wexprs:
            if w.fn in self._CHUNK_RANKING:
                aggs.append(None)       # ranking carries part_rows, dense
            elif w.fn in ("min", "max"):
                aggs.append({"s": z(dt.torch_dtype(w.child.dtype)),
                             "c": z()})
            elif isinstance(w.dtype, dt.DecimalType) \
                    and w.dtype.is_decimal128:
                aggs.append({"limbs": torch.zeros(2, dtype=torch.int64,
                                                  device=dev), "c": z()})
            elif w.child.dtype.is_floating and w.fn != "count":
                # an exact double sum: its limb sums on the last chunk's
                # grid (host-known), and the non-finite counts
                aggs.append({"limbs": torch.zeros(0, dtype=torch.int64,
                                                  device=dev),
                             "grid": None, "nf": torch.zeros(
                                 3, dtype=torch.int64, device=dev),
                             "c": z()})
            else:
                aggs.append({"s": z(), "c": z()})
        return dict(valid=z(torch.bool), pk=pk, part_rows=z(), dense=z(),
                    aggs=aggs)

    def _one_chunked(self, w, wc, scv, carry_agg, cont, carry, exp):
        """One chunkable function over a chunk whose first partition
        continues the carried one when `cont`: (output CV, state at every
        row for the next carry)."""
        live, pos = wc["live"], wc["pos"]
        seg_start = wc["seg_start"]
        adj = live & (wc["seg_ids"] == 0) & cont
        if w.fn in self._CHUNK_RANKING:
            # the chunk's own ranks, shifted in the continued partition
            # by its rows (row_number, rank) or peer groups so far
            local = self._one(w, wc, None, None).data.to(torch.int64)
            add = carry["dense"] if w.fn == "dense_rank" \
                else carry["part_rows"]
            return CV((local + torch.where(adj, add, 0)).to(torch.int32),
                      live), None
        valid = scv.validity & live
        x = scv.data
        at = wc["peer_end"] if w.spec.frame_mode == "range" else pos
        vz = valid.to(torch.int64)
        c = _running(vz, seg_start)[at] + torch.where(adj, carry_agg["c"], 0)
        if w.fn == "count":
            return self._finish(w, None, c, live), {"c": c}
        if w.fn in ("min", "max"):
            is_min = w.fn == "min"
            red = torch.minimum if is_min else torch.maximum
            ident = _ident(x.dtype, is_min)
            s = _seg_scan(torch.where(valid, x, ident), seg_start, pos, red,
                          self._steps(wc))[at]
            have = adj & (carry_agg["c"] > 0)
            cs = carry_agg["s"].to(s.dtype)
            s = torch.where(have, red(s, cs), s)
            return self._finish(w, s, c, live), {"s": s, "c": c}
        if "grid" in carry_agg:
            return self._chunk_xsum(w, wc, x, valid, at, adj, carry_agg,
                                    cont, c, exp)
        if "limbs" in carry_agg:
            limbs = split_i64_limbs(x.to(torch.int64))
            sums = [_running(torch.where(valid, l, 0), seg_start)[at]
                    + torch.where(adj, carry_agg["limbs"][k], 0)
                    for k, l in enumerate(limbs)]
            return self._finish_d128(w, sums, c, live), \
                {"limbs": torch.stack(sums), "c": c}
        s = _running(torch.where(valid, x.to(torch.int64), 0), seg_start)[at]
        s = s + torch.where(adj, carry_agg["s"], 0)
        return self._finish(w, s, c, live), {"s": s, "c": c}

    def _chunk_xsum(self, w, wc, x, valid, at, adj, carry_agg, cont, c,
                    exp):
        """An exact double running sum across chunks: the carried limb sums
        (and non-finite counts) enter at the chunk's first row when it
        continues the carried partition, so every later row's prefix
        holds them; the state is the limb sums at every row."""
        cap = wc["cap"]
        x = x.to(torch.float64)
        grid = carry_agg["grid"]
        base, J = _xsum_grid(exp[0], exp[1], cap, grid)
        D = _xsum_limbs(x, valid, base, J)
        F = _nonfinite(x, valid)
        if grid is not None and cap:
            k = (grid[0] - base) // 32
            n = carry_agg["limbs"].shape[0]
            D[k:k + n, 0] += carry_agg["limbs"] * cont.to(torch.int64)
            F[:, 0] += carry_agg["nf"] * cont.to(torch.int64)
        lo = wc["seg_start"]
        S = _frame_diff(torch.cumsum(D, 1), lo, at)
        NF = _frame_diff(torch.cumsum(F, 1), lo, at)
        s = _nonfinite_result(_xsum_round(S, base), NF)
        return self._finish(w, s, c, live=wc["live"]), \
            {"limbs": S, "nf": NF, "c": c, "grid": (base, J)}

    def _compute_chunk(self, cvs, mask, carry, emit_all: bool):
        """One streamed chunk: the window outputs with the carry applied,
        the rows it emits (all but the holdback: the last peer group of
        its last partition, which may continue in the next chunk), and
        what the next carry is taken from. One host read here (the
        longest partition, the double sums' exponent ranges)."""
        nchunks = (0,) * (len(self.spec.partition_keys)
                          + len(self.spec.orders))
        ctx, wc = self._prepare(cvs, mask, nchunks, pk_nulls_first=True,
                                presorted=True)
        live, cap, perm = wc["live"], wc["cap"], wc["perm"]
        seg_ids = wc["seg_ids"]
        spkeys = [CV(kcv.data[perm], kcv.validity[perm])
                  for kcv in wc["pkeys"]]
        # does the first sorted row continue the carried partition?
        cont = carry["valid"]
        for (cd, cvl), kcv in zip(carry["pk"], spkeys):
            eq = (kcv.data[0] == cd) & kcv.validity[0] & cvl
            cont = cont & (eq | (~kcv.validity[0] & ~cvl))
        scvs, reads = self._inputs(ctx, wc)
        got = list(fetch_ints(reads))
        wc["max_seg"] = max(1, got.pop(0))
        outs, states = [], []
        for w, scv, agg in zip(self.wexprs, scvs, carry["aggs"]):
            exp = None
            if scv is not None and self._exact_double(w, scv):
                exp = (got.pop(0), got.pop(0))
            o, st = self._one_chunked(w, wc, scv, agg, cont, carry, exp)
            outs.append(o)
            states.append(st)
        n_live = live.sum()
        if emit_all:
            emitted = live
        else:
            last_seg = seg_ids[(n_live - 1).clamp(0, cap - 1)]
            holdback = live & (seg_ids == last_seg) \
                & (wc["peer_end"] == wc["seg_end"])
            emitted = live & ~holdback
        c2 = torch.cumsum(wc["ob"].to(torch.int64), 0)
        at_end = dict(
            pk=spkeys, states=states, cont=cont, seg_ids=seg_ids,
            pos_in_seg=wc["pos_in_seg"],
            dense=c2 - c2[wc["seg_start"].clamp(0, cap - 1)] + 1)
        sorted_cols = [take(cv, perm, in_bounds=live) for cv in cvs]
        return sorted_cols, outs, emitted, emitted.sum(), n_live, at_end

    @staticmethod
    def _next_carry(carry, at_end, n_emit: int):
        """The carry after a chunk: the state at its last emitted row (the
        live rows are a sorted prefix, the holdback its tail), or the
        same carry when the chunk emitted nothing."""
        if n_emit == 0:
            return carry
        e = n_emit - 1
        cont_e = at_end["cont"] & (at_end["seg_ids"][e] == 0)
        aggs = []
        for st, agg in zip(at_end["states"], carry["aggs"]):
            if agg is None:
                aggs.append(None)
                continue
            nxt = dict(agg)
            for key, val in st.items():
                nxt[key] = val if key == "grid" else val[..., e]
            aggs.append(nxt)
        return dict(
            valid=torch.ones_like(carry["valid"]),
            pk=tuple((kcv.data[e], kcv.validity[e]) for kcv in at_end["pk"]),
            part_rows=at_end["pos_in_seg"][e] + 1
            + torch.where(cont_e, carry["part_rows"], 0),
            dense=at_end["dense"][e] + torch.where(cont_e, carry["dense"], 0),
            aggs=aggs)

    def _execute_chunked(self, ctx: ExecContext, m, sorted_stream):
        """Drive the chunk stream: carry the state forward, emit a batch a
        chunk, and put each chunk's holdback in front of the next."""
        carry = None
        hold_cvs, hold_mask = None, None
        fields = self.children[0].schema.fields
        stream = iter(sorted_stream)
        nxt = next(stream, None)
        while nxt is not None:
            batch = nxt
            nxt = next(stream, None)
            is_last = nxt is None
            if hold_cvs is None:
                cvs, mask = list(batch.cvs()), batch.row_mask
            else:
                cvs = [concat_cvs([h, c], f.dtype) for h, c, f in
                       zip(hold_cvs, batch.cvs(), fields)]
                mask = concat_masks([hold_mask, batch.row_mask])
            if carry is None:
                carry = self._zero_carry(mask.device)
            with m.timer("opTime"):
                # the chunk is already the streaming unit: an OOM retries
                # after a spill, without a split
                (sorted_cols, outs, emitted, n_emit_d, n_live_d,
                 at_end) = retry_no_split(
                    lambda: self._compute_chunk(cvs, mask, carry, is_last),
                    dm=ctx.device_manager)
                n_emit, n_live = fetch_ints([n_emit_d, n_live_d])
                carry = self._next_carry(carry, at_end, n_emit)
            cap = mask.shape[0]
            if n_emit > 0:
                m.add("numOutputBatches", 1)
                m.add("numChunks", 1)
                yield DeviceBatch(make_table(self.schema, list(sorted_cols)
                                             + list(outs), cap),
                                  cap, emitted)
            # the holdback rows [n_emit, n_live) come before the next chunk
            if not is_last and n_live > n_emit:
                nh = n_live - n_emit
                idx = torch.arange(nh, device=mask.device) + n_emit
                hold_cvs = gather_cols(sorted_cols, idx, None)
                hold_mask = torch.ones(nh, dtype=torch.bool,
                                       device=mask.device)
            else:
                hold_cvs, hold_mask = None, None

    # ------------------------------------------------------------------
    def execute_partition(self, ctx: ExecContext, pid: int):
        from ..config import WINDOW_CHUNK_ROWS
        m = ctx.metrics_for(self._op_id)
        chunk_rows = ctx.conf.get(WINDOW_CHUNK_ROWS)
        if chunk_rows > 0 and self._chunkable():
            yield from self._execute_spillable(ctx, m, chunk_rows)
            return
        child = self.children[0]
        batches = []
        for cpid in range(child.num_partitions(ctx)):
            batches.extend(child.execute_partition(ctx, cpid))
        yield from self._execute_incore(ctx, m, batches)

    def _execute_spillable(self, ctx: ExecContext, m, chunk_rows: int):
        """Park the child's batches in the spill store while their rows
        are counted (the device budget bounds them, as in SortExec); past
        `chunk_rows` they stream, in order, through the out-of-core sort
        (partition keys nulls first), else they run in core."""
        from ..plan.logical import SortOrder
        from .sort import SortExec, _HandleScanExec
        child = self.children[0]
        store, dm = ctx.spill_store, ctx.device_manager
        handles, total_rows = [], 0
        try:
            for cpid in range(child.num_partitions(ctx)):
                for b in child.execute_partition(ctx, cpid):
                    total_rows += b.num_rows
                    handles.append(ctx.track(retry_no_split(
                        lambda b=b: store.add_batch(b), dm=dm)))
            if total_rows <= chunk_rows:
                yield from self._execute_incore(
                    ctx, m, [h.materialize() for h in handles])
                return
            orders = ([SortOrder(k, True, nulls_first=True)
                       for k in self.spec.partition_keys]
                      + list(self.spec.orders))
            sorter = SortExec(_HandleScanExec(handles, child.schema),
                              orders, child.schema)

            def stream():
                for spid in range(sorter.num_partitions(ctx)):
                    yield from sorter.execute_partition(ctx, spid)

            yield from self._execute_chunked(ctx, m, stream())
        finally:
            for h in handles:
                h.close()

    def _execute_incore(self, ctx: ExecContext, m, batches):
        if not batches:
            return
        child = self.children[0]
        if len(batches) == 1:
            cvs, mask = batches[0].cvs(), batches[0].row_mask
        else:
            cvs = [concat_cvs([b.cvs()[i] for b in batches], f.dtype)
                   for i, f in enumerate(child.schema.fields)]
            mask = concat_masks([b.row_mask for b in batches])
        del batches
        if mask.shape[0] == 0:
            return
        with m.timer("opTime"):
            nchunks = self._nchunks(cvs, mask)
            # a window frame spans its whole partition: the input cannot
            # split, so an OOM retries after a spill only
            dm = ctx.device_manager
            sorted_cols, outs, live = retry_no_split(
                lambda: self._compute(cvs, mask, nchunks, dm), dm=dm)
        cap = live.shape[0]
        m.add("numOutputBatches", 1)
        yield DeviceBatch(make_table(self.schema, list(sorted_cols)
                                     + list(outs), cap), cap, live)

    def _nchunks(self, cvs, mask) -> Tuple[int, ...]:
        """String-chunk counts of the partition and order keys (one host
        read when any is a string)."""
        ctx = EmitCtx(list(cvs), mask.shape[0], mask.device)
        exprs = list(self.spec.partition_keys) + [o.expr for o in
                                                  self.spec.orders]
        dtypes = [e.dtype for e in exprs]
        return sk.key_nchunks([e.emit(ctx) if t.is_variable_width else None
                               for e, t in zip(exprs, dtypes)],
                              dtypes, mask)
