"""The port's string functions against the JAX package on the CPU, over
seeded strings with nulls, empty strings, runs of spaces and multi-byte
UTF-8: length (characters), upper / lower (ASCII, other bytes pass),
concat, trim / ltrim / rtrim, reverse, instr / locate, lpad / rpad,
repeat and concat_ws; then the ops the expressions do not reach alone
(`literal_column`, `rebuild_strings` with a period, `str_equal_rowmap`)
on the same buffers in both packages. Exact throughout.

reverse reverses bytes in both packages, so a multi-byte row comes out
as bytes that are not UTF-8: the JAX package cannot return that column
(its Arrow conversion decodes it) and the port's is held to Python's
byte reversal instead (ROADMAP C.17).
"""
import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from torch_parity import assert_same, project

WORDS = ["", " ", "a", "abc", "  lead", "trail  ", "  both  ", "Mixed Case",
         "ÀÉÎõü", "日本語", "naïve café", "x y z", "UPPER", "lower",
         "special requests", "1-URGENT", "a  b", "tab\there", "é", "ß"]


def _strings(seed, n=80, ascii_only=False):
    rng = np.random.default_rng(seed)
    words = [w for w in WORDS if not ascii_only or w.isascii()]
    vals = [words[i] for i in rng.integers(0, len(words), n)]
    vals[:len(words)] = words
    nul = rng.random(n) < 0.15
    nul[:len(words)] = False
    return [None if m else v for v, m in zip(vals, nul)]


def _data(ascii_only=False):
    return {"s": pa.array(_strings(1, ascii_only=ascii_only)),
            "t": pa.array(_strings(2, ascii_only=ascii_only)),
            "u": pa.array(_strings(3, ascii_only=ascii_only))}


GROUPS = {
    "case_length": lambda F: [
        F.length("s"), F.upper("s"), F.lower("t"),
        F.upper(F.lower("u")), F.length(F.lit("日本"))],
    "concat_trim": lambda F: [
        F.concat("s", "t"), F.concat("s", F.lit("|"), "u"),
        F.trim("s"), F.ltrim("t"), F.rtrim("u"),
        F.trim(F.concat(F.lit("  "), "s", F.lit(" ")))],
    "find": lambda F: [
        F.instr("s", "a"), F.instr("t", "re"), F.locate("é", "s"),
        F.instr("u", "")],
    "repeat_ws": lambda F: [
        F.repeat("s", 3), F.repeat("t", 0), F.repeat("u", -1),
        F.concat_ws("|", "s", "t", "u"), F.concat_ws("", "s", "t"),
        F.concat_ws(", ", "u"), F.concat_ws("-")],
}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_string_functions(group):
    jt, ptab = project(_data(), GROUPS[group])
    assert_same(jt, ptab, group)


PADS = [(8, "*", True), (5, "ab", False), (0, "-", True), (3, "", False),
        (-2, "x", True), (12, "日", False)]


def test_pad():
    """lpad / rpad by bytes: over ASCII against the JAX package; over
    multi-byte rows against Python's bytes (a cut can split a character,
    which the JAX package cannot return, ROADMAP C.17)."""
    def pads(F):
        return [(F.lpad if left else F.rpad)(c, n, pad)
                for c in ("s", "t") for n, pad, left in PADS[:5]]
    jt, ptab = project(_data(ascii_only=True), pads)
    assert_same(jt, ptab, "pad")
    s = pt.TpuSession({}, device="cpu")
    vals = _strings(1)
    out = s.create_dataframe({"s": pa.array(vals)}).select(*[
        (PF.lpad if left else PF.rpad)("s", n, pad).alias(f"c{i}")
        for i, (n, pad, left) in enumerate(PADS)]).to_arrow()
    for i, (n, pad, left) in enumerate(PADS):
        want = []
        for v in vals:
            if v is None:
                want.append(None)
                continue
            b, pb, n0 = v.encode(), pad.encode(), max(n, 0)
            if not pb or len(b) >= n0:
                want.append(b[:n0])
                continue
            fill = (pb * n0)[:n0 - len(b)]
            want.append(fill + b if left else b + fill)
        assert out.column(i).cast(pa.binary()).to_pylist() == want, i


def test_reverse():
    jt, ptab = project(_data(ascii_only=True), lambda F: [
        F.reverse("s"), F.reverse(F.concat("t", "u"))])
    assert_same(jt, ptab, "reverse of ASCII")
    s = pt.TpuSession({}, device="cpu")
    vals = _strings(1)
    out = s.create_dataframe({"s": pa.array(vals)}).select(
        PF.reverse("s").alias("r")).to_arrow().column(0)
    got = out.cast(pa.binary()).to_pylist()
    assert got == [None if v is None else v.encode()[::-1] for v in vals]


def _jax_cv(arr):
    """A JAX-package CV of a string array, and the same buffers as a
    port CV (data, validity, offsets as numpy)."""
    import jax.numpy as jnp
    from spark_rapids_tpu.ops.kernel_utils import CV as JCV
    import torch
    from spark_rapids_tpu_torch.ops.kernel_utils import CV as PCV
    vals = arr.to_pylist()
    raw = [b"" if v is None else v.encode() for v in vals]
    off = np.concatenate([[0], np.cumsum([len(r) for r in raw])]).astype(
        np.int32)
    data = np.frombuffer(b"".join(raw) or b"\0", np.uint8).copy()
    valid = np.array([v is not None for v in vals])
    return (JCV(jnp.asarray(data), jnp.asarray(valid), jnp.asarray(off)),
            PCV(torch.from_numpy(data), torch.from_numpy(valid),
                torch.from_numpy(off)))


def _rows(data, off, n):
    data, off = np.asarray(data), np.asarray(off)
    return [bytes(data[off[i]:off[i + 1]]) for i in range(n)]


def test_ops_beside_the_expressions():
    import jax.numpy as jnp
    import torch
    from spark_rapids_tpu.ops import strings as js
    from spark_rapids_tpu_torch.ops import strings as ps
    arr = pa.array(_strings(4, n=30))
    jcv, pcv = _jax_cv(arr)
    n = len(arr)
    rng = np.random.default_rng(5)
    present = rng.random(n) < 0.5
    j = js.literal_column(b"<>", jnp.asarray(present), 2 * n)
    p = ps.literal_column(b"<>", torch.from_numpy(present), 2 * n)
    assert _rows(j.data, j.offsets, n) == _rows(p.data, p.offsets, n)
    lens = np.asarray(jcv.offsets[1:] - jcv.offsets[:-1])
    j = js.repeat_str(jcv, 3, 3 * jcv.data.shape[0])
    p = ps.repeat_str(pcv, 3, 3 * pcv.data.shape[0])
    assert _rows(j.data, j.offsets, n) == _rows(p.data, p.offsets, n)
    starts = np.asarray(jcv.offsets[:-1]) + np.minimum(lens, 1)
    new_lens = np.maximum(lens - 2, 0).astype(np.int32)
    j = js.rebuild_strings(jcv, jnp.asarray(starts), jnp.asarray(new_lens))
    p = ps.rebuild_strings(pcv, torch.from_numpy(starts),
                           torch.from_numpy(new_lens))
    assert _rows(j.data, j.offsets, n) == _rows(p.data, p.offsets, n)
    # element i against value row rows[i]
    rows = rng.integers(0, n, n).astype(np.int32)
    rows[:5] = np.arange(5)
    live = rng.random(n) < 0.9
    j = js.str_equal_rowmap(jcv, jcv, jnp.asarray(rows), jnp.asarray(live))
    p = ps.str_equal_rowmap(pcv, pcv, torch.from_numpy(rows).long(),
                            torch.from_numpy(live))
    assert np.asarray(j).tolist() == p.tolist()
    assert p[:5].tolist() == [bool(v) for v in (live[:5] &
                                                 np.asarray(pcv.validity[:5]))]
