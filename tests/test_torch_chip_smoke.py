"""chip_smoke.py's readers of the compiler's output and its kernel bound,
on listings in the formats nvcc's `-Xptxas -v` and `cuobjdump -sass`
print. They run on the card only inside chip_smoke.py, so they are
checked here on fixed text."""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

VEC = "_ZN12_GLOBAL__N_131partition_ids_i32_vector_kernelEPK4int4PKjPS0_ljm"
SCA = "_ZN12_GLOBAL__N_131partition_ids_i32_scalar_kernelEPKiPKhPiljm"
TAIL = "_ZN12_GLOBAL__N_19tail_rowsEPKiPKhPiijm"

PTXAS = f"""\
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for {TAIL}
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '{SCA}' for 'sm_90a'
ptxas info    : Function properties for {SCA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 22 registers, used 0 barriers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '{VEC}' for 'sm_90a'
ptxas info    : Function properties for {VEC}
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 0 barriers, 392 bytes cmem[0]
"""

SASS = f"""
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

	code for sm_90a
		Function : {SCA}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;              /* 0x0000000000007919 */
                                                                   /* 0x000e220000002100 */
        /*0020*/              @P0 EXIT ;                           /* 0x000000000000094d */
                                                                   /* 0x000fea0003800000 */
.L_x_0:
        /*0030*/                   IMAD R3, R0, 0x5, RZ ;          /* 0x0000000500037824 */
                                                                   /* 0x000fca00078e02ff */
        /*0040*/                   LOP3.LUT R3, R3, 0x4, RZ, 0x3c, !PT ;
        /*0050*/              @!P0 BRA `(.L_x_0) ;                 /* 0xfffffffc00f08947 */
        /*0060*/                   EXIT ;                          /* 0x000000000000794d */
.L_x_1:
        /*0070*/                   BRA `(.L_x_1);                  /* 0xfffffffc00fc7947 */
        /*0080*/                   NOP;                            /* 0x0000000000007918 */
        /*0090*/                   NOP;                            /* 0x0000000000007918 */
		..........

		Function : {VEC}
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
""" + "".join(f"        /*{0x10 * i:04x}*/                   IMAD R2, R2, 0x5, RZ ;\n"
              for i in range(1, 32)) + """\
        /*0200*/                   EXIT ;
        /*0210*/                   BRA 0x210;
        /*0220*/                   NOP;
"""


def test_ptxas_report_reads_registers_and_spills():
    rep = chip_smoke.ptxas_report(PTXAS)
    assert rep[SCA] == {"stack": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 22}
    assert rep[VEC] == {"stack": 8, "spill_stores": 4, "spill_loads": 8,
                        "registers": 48}
    assert rep[TAIL] == {"stack": 24, "spill_stores": 0, "spill_loads": 0}


def test_sass_counts_skip_nops_and_the_branch_to_self():
    counts = chip_smoke.sass_counts(SASS)
    # LDC S2R EXIT IMAD LOP3 BRA EXIT; the loop is IMAD LOP3 BRA
    assert counts[SCA] == {"instructions": 7, "loop_instructions": 3}
    # LDC, 31 IMADs, EXIT; no loop (BRA 0x210 branches to itself)
    assert counts[VEC] == {"instructions": 33, "loop_instructions": 0}


def test_instr_per_row_per_kernel():
    per_row = chip_smoke.instr_per_row(chip_smoke.sass_counts(SASS))
    assert per_row == {"scalar": 3.0, "vector": 33 / 4}
    assert chip_smoke.kernel_of(TAIL) is None


@pytest.mark.parametrize("per_row,bound_by", [(10.0, "bytes"),
                                              (400.0, "operations")])
def test_partition_bound_is_the_larger_of_bytes_and_issue(per_row,
                                                          bound_by):
    rows, sms, clock = 1 << 20, 132, 1.98e9
    b = chip_smoke.partition_bound(rows, per_row, sms, clock)
    assert b["bytes_bound_ms"] == pytest.approx(rows * 9 / 3.35e12 * 1e3)
    assert b["instr_bound_ms"] == pytest.approx(
        rows * per_row / (sms * 128 * clock) * 1e3)
    assert b["bound_ms"] == max(b["bytes_bound_ms"], b["instr_bound_ms"])
    assert b["bound_by"] == bound_by


# ----------------------------------------------------------------------
# Q1's exact reference and the grouped path's checks, on the CPU
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def small_lineitem():
    from spark_rapids_tpu_torch.workloads import tpch
    return tpch.gen_lineitem(0.0005, seed=21)


def _python_q1(lineitem):
    """Q1 in Python Decimals, row by row: the reference's reference."""
    import decimal
    out = {}
    rows = lineitem.select(["l_quantity", "l_extendedprice", "l_discount",
                            "l_tax", "l_returnflag", "l_linestatus",
                            "l_shipdate"]).to_pylist()
    for r in rows:
        if r["l_shipdate"] > 10471:
            continue
        g = out.setdefault((r["l_returnflag"], r["l_linestatus"]),
                           [0, 0, 0, 0, 0, 0])
        q, p, d, t = (r[c] for c in ("l_quantity", "l_extendedprice",
                                     "l_discount", "l_tax"))
        dp = p * (1 - d)
        g[0] += q
        g[1] += p
        g[2] += dp
        g[3] += dp * (1 + t)
        g[4] += d
        g[5] += 1
    ref = {}
    six = decimal.Decimal("0.000001")
    for k, (q, p, dp, ch, d, n) in out.items():
        def avg(total):
            return int((total / n).quantize(
                six, rounding=decimal.ROUND_HALF_UP).scaleb(6))
        ref[k] = {"sum_qty": int(q.scaleb(2)),
                  "sum_base_price": int(p.scaleb(2)),
                  "sum_disc_price": int(dp.scaleb(4)),
                  "sum_charge": int(ch.scaleb(6)), "avg_qty": avg(q),
                  "avg_price": avg(p), "avg_disc": avg(d),
                  "count_order": n}
    return ref


def test_q1_reference_equals_decimal_arithmetic(small_lineitem):
    assert chip_smoke.q1_reference(small_lineitem) == \
        _python_q1(small_lineitem)


def test_check_q1_accepts_the_port_and_rejects_faults(small_lineitem):
    import decimal

    import pyarrow as pa

    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.workloads import tpch
    # the written plan: the adaptive reader is off (its case below)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024,
                       **chip_smoke.WRITTEN_CONF}, device="cpu")
    q = chip_smoke.sorted_q1(tpch, s.create_dataframe(small_lineitem))
    assert chip_smoke.plan_chain(q)[:4] == [
        "SortExec", "HashAggregateExec[final]", "ShuffleExchangeExec",
        "HashAggregateExec[partial]"]
    out = q.to_arrow()
    expect = chip_smoke.q1_reference(small_lineitem)
    chip_smoke.check_q1(out, expect, "port")
    with pytest.raises(AssertionError, match="groups"):
        chip_smoke.check_q1(out.take(pa.array([1, 0, 2, 3, 4, 5])),
                            expect, "reordered")
    bad = out.to_pylist()
    bad[2]["avg_disc"] += decimal.Decimal("0.000001")
    with pytest.raises(AssertionError, match="group"):
        chip_smoke.check_q1(pa.Table.from_pylist(bad, out.schema), expect,
                            "off by one unit")


def test_q1_adaptive_plan_coalesces_the_final_stage(small_lineitem):
    """At the default conf the final aggregate reads its exchange through
    an adaptive reader; the stage driver coalesces the small partial
    states into one task, and the result is the reference's."""
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.workloads import tpch
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024},
                      device="cpu")
    q = chip_smoke.sorted_q1(tpch, s.create_dataframe(small_lineitem))
    assert chip_smoke.plan_chain(q)[:5] == [
        "SortExec", "HashAggregateExec[final]", "AQEShuffleReadExec",
        "ShuffleExchangeExec", "HashAggregateExec[partial]"]
    out = q.to_arrow()
    chip_smoke.check_q1(out, chip_smoke.q1_reference(small_lineitem),
                        "adaptive")
    info = chip_smoke.adaptive_info(q)
    assert info["aqe"]["stages"] == 1
    assert info["aqe"]["partitions_before"] == 8
    assert info["aqe"]["partitions_after"] == 1
    assert info["aqe"]["coalesced_away"] == 7


@pytest.mark.parametrize("num,den,want", [(7, 2, 4), (5, 2, 3), (4, 3, 1),
                                          (-7, 2, -4), (-4, 3, -1),
                                          (0, 5, 0), (10**20 + 1, 2,
                                                      5 * 10**19 + 1)])
def test_half_up_div(num, den, want):
    assert chip_smoke._half_up_div(num, den) == want


def test_shipdate_reference_and_check(small_lineitem):
    import numpy as np

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024},
                      device="cpu")
    expect = chip_smoke.shipdate_reference(small_lineitem)
    dates, sums, counts = expect
    assert counts.sum() == small_lineitem.num_rows
    assert sums.sum() == chip_smoke.unscaled(small_lineitem,
                                             "l_quantity").sum()
    out = chip_smoke.grouped_shipdate(
        s.create_dataframe(small_lineitem)).to_arrow()
    chip_smoke.check_shipdate(out, expect, "port")
    with pytest.raises(AssertionError):
        chip_smoke.check_shipdate(out, (dates, sums + (np.arange(
            len(sums)) == 3), counts), "one sum off")


@pytest.mark.parametrize("name,group", [
    ("void at::native::indexFuncLargeIndex<long, long, unsigned int, 1>",
     "scatter_index_add"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>",
     "scatter_index_add"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather"),
    ("void at::native::vectorized_elementwise_kernel<2, at::native::"
     "CUDAFunctor_add<long> >", "elementwise"),
    ("Memcpy HtoD (Pinned -> Device)", "h2d"),
    ("Memcpy DtoH (Device -> Pinned)", "d2h"),
    ("void cub::DeviceRadixSortOnesweepKernel<>", "sort"),
    ("void cub::DeviceScanKernel<>", "scan"),
    ("void at::native::reduce_kernel<512, 1>", "reduce"),
    ("partition_ids_i32_vector_kernel", "partition_kernel"),
    ("void cub::DeviceSelectSweepKernel<>", "other")])
def test_q1_kernel_groups(name, group):
    assert chip_smoke.q1_group_of(name) == group


# ----------------------------------------------------------------------
# Q3's exact reference, its tie rule and plan checks, on the CPU
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def q3_small():
    tables = chip_smoke.q3_tables(0.002)
    return tables, chip_smoke.q3_reference(*tables)


def _python_q3(customer, orders, lineitem):
    """Q3 before its limit in Python ints, row by row."""
    from collections import defaultdict
    building = {k for k, s in zip(customer.column(0).to_pylist(),
                                  customer.column(1).to_pylist())
                if s == "BUILDING"}
    omap = {}
    for ok, ck, od, sp in zip(*(orders.column(c).to_pylist() for c in (
            "o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"))):
        if ck in building and od < 9204:
            omap[ok] = (od, sp)
    rev = defaultdict(int)
    for lk, sd, p, d in zip(*(lineitem.column(c).to_pylist() for c in (
            "l_orderkey", "l_shipdate", "l_extendedprice", "l_discount"))):
        if lk in omap and sd > 9204:
            rev[lk] += int(p.scaleb(2)) * (100 - int(d.scaleb(2)))
    rows = [(k, *omap[k], v) for k, v in rev.items()]
    return sorted(rows, key=lambda r: (-r[3], r[1], r[0]))


def test_q3_reference_equals_python(q3_small):
    tables, expect = q3_small
    assert chip_smoke._ref_rows(expect) == _python_q3(*tables)
    assert len(expect[0]) > chip_smoke.Q3_LIMIT


def _q3_port(tables, conf, limit=True):
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.workloads import tpch
    s = pt.TpuSession(conf, device="cpu")
    q = chip_smoke.q3_query(tpch, s, tables, limit)
    return q, q.to_arrow()


def test_check_q3_accepts_the_port_and_rejects_faults(q3_small):
    import pyarrow as pa
    tables, expect = q3_small
    q, full = _q3_port(tables, {}, limit=False)
    chip_smoke.check_q3_full(full, expect, "port")
    _, top = _q3_port(tables, {})
    chip_smoke.check_q3_top(top, expect, "port")
    with pytest.raises(AssertionError, match="order"):
        chip_smoke.check_q3_top(top.take(pa.array([1, 0] + list(
            range(2, top.num_rows)))), expect, "reordered")
    with pytest.raises(AssertionError, match="differ"):
        chip_smoke.check_q3_full(full.slice(1), expect, "a row short")
    bad = top.to_pylist()
    bad[9]["l_orderkey"] += 1
    with pytest.raises(AssertionError, match="not in the reference"):
        chip_smoke.check_q3_top(pa.Table.from_pylist(bad, top.schema),
                                expect, "a wrong key")


def test_check_q3_top_allows_ties_at_the_last_row():
    import decimal

    import numpy as np
    import pyarrow as pa
    # rows 9-11 tie on (revenue, o_orderdate): any of them may be 10th
    keys = np.arange(12)
    rev = np.array([90, 80, 70, 60, 50, 40, 30, 20, 10, 5, 5, 5, 1][:12])
    date = np.array([1] * 12)
    expect = (keys, date, np.zeros(12, np.int64), rev)

    def table(order):
        return pa.table({
            "l_orderkey": pa.array(keys[order]),
            "o_orderdate": pa.array(date[order].astype(np.int32)),
            "o_shippriority": pa.array(np.zeros(len(order), np.int32)),
            "revenue": pa.array([decimal.Decimal(int(v)).scaleb(-4)
                                 for v in rev[order]],
                                pa.decimal128(28, 4))})
    chip_smoke.check_q3_top(table(list(range(9)) + [11]), expect, "tie")
    chip_smoke.check_q3_full(table([0, 1, 2, 3, 4, 5, 6, 7, 8, 11, 9, 10]),
                             expect, "tied rows in another order")
    with pytest.raises(AssertionError, match="keys"):
        chip_smoke.check_q3_top(table(list(range(8)) + [9, 10]), expect,
                                "a skipped row")


def test_q3_plan_shapes(q3_small):
    # the written plans (the adaptive features off; their case below)
    tables, _ = q3_small
    q, _ = _q3_port(tables, dict(chip_smoke.WRITTEN_CONF))
    root = q.last_plan()
    assert chip_smoke.check_q3_plan(root, shuffled=False)[
        "broadcast_exchanges"] == 2
    with pytest.raises(AssertionError, match="shuffled"):
        chip_smoke.check_q3_plan(root, shuffled=True)
    q, _ = _q3_port(tables, {
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1,
        **chip_smoke.WRITTEN_CONF})
    shape = chip_smoke.check_q3_plan(q.last_plan(), shuffled=True)
    assert [j["per_partition"] for j in shape["joins"]] == [True, True]
    assert [j["children"] for j in shape["joins"]] == \
        [["ShuffleExchangeExec"] * 2] * 2


def test_q3_plan_shapes_adaptive(q3_small):
    """At the default conf a shuffled join reads its exchanges through
    adaptive readers; a join whose build materializes under the
    threshold is demoted to a broadcast join over its shuffled build,
    and check_q3_plan holds the plan to the decisions."""
    tables, expect = q3_small
    q, _ = _q3_port(tables, {
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1})
    shape = chip_smoke.check_q3_plan(q.last_plan(), True,
                                     q.last_aqe_decisions())
    assert [j["children"] for j in shape["joins"]] == \
        [["AQEShuffleReadExec(ShuffleExchangeExec)"] * 2] * 2
    assert chip_smoke.adaptive_info(q)["aqe"]["demotions"] == 0
    # a threshold under the orders' estimate but over their filtered
    # rows: the inner join is demoted
    q, got = _q3_port(tables, {
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1 << 16})
    chip_smoke.check_q3_top(got, expect, "demoted")
    decisions = q.last_aqe_decisions()
    shape = chip_smoke.check_q3_plan(q.last_plan(), True, decisions)
    info = chip_smoke.adaptive_info(q)
    assert info["aqe"]["demotions"] >= 1
    assert shape["broadcast_exchanges"] == info["aqe"]["demotions"]
    with pytest.raises(AssertionError, match="shuffled"):
        chip_smoke.check_q3_plan(q.last_plan(), True, ())


def test_q3_phases_rehearse_on_the_cpu(q3_small, capsys):
    """Phases 11-13 at a small scale factor, the shuffled phase forced by
    a threshold of -1: every check passes and the partition kernel never
    launches."""
    import json

    import spark_rapids_tpu_torch as pt
    tables, expect = q3_small
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024,
                       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                       -1}, device="cpu")
    launches = chip_smoke.q3_phases(s, tables, expect)
    assert set(launches) == {"q3_shuffled", "q3_shuffled_no_limit",
                             "q3_broadcast"}
    assert all(v == {"all": 0, "vector": 0, "scalar": 0}
               for v in launches.values())
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    phases = {d["phase"]: d for d in lines}
    assert set(phases) == {"q3_shuffled", "q3_broadcast", "q3_profiled"}
    paths = phases["q3_shuffled"]["runs"][0]["join_paths"]
    assert len(paths) == 2
    for p in paths.values():
        assert p["streamBatches"] == p["directProbeBatches"] > 0
        assert p["expandOutputBatches"] + p["fkOutputBatches"] > 0
    assert phases["q3_broadcast"]["plan"]["broadcast_exchanges"] == 2
    assert phases["q3_profiled"]["host_syncs_per_batch"] > 0


@pytest.mark.parametrize("name,group", [
    ("void at::native::(anonymous namespace)::searchsorted_cuda_kernel"
     "<long, long>", "searchsorted"),
    ("void at::native::_scatter_gather_elementwise_kernel<128, 8>",
     "scatter_index_add"),
    ("void cub::DeviceRadixSortOnesweepKernel<>", "sort"),
    ("Memcpy HtoD (Pinned -> Device)", "h2d")])
def test_q3_kernel_groups(name, group):
    assert chip_smoke.q1_group_of(name, chip_smoke.Q3_GROUPS) == group


# ----------------------------------------------------------------------
# TPC-H Q4, Q5, Q7, Q10, Q12, Q18 and Q19: the exact numpy references
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpch_small():
    from spark_rapids_tpu_torch.workloads import tpch
    return tpch.gen_all(0.01, seed=11)


#: Q18 at the spec's 300 (41 rows at sf 0.01, seed 11) and at 150 (the
#: limit of 100 cuts)
TPCH_CASES = [(4, 300), (5, 300), (7, 300), (10, 300), (12, 300),
              (18, 300), (18, 150), (19, 300)]


def _port_rows(n, tables, qty, conf=None):
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession(dict(conf or {}), device="cpu")
    return chip_smoke.tpch_query(n, s, tables, qty).to_arrow()


@pytest.mark.parametrize("n,qty", TPCH_CASES)
def test_tpch_reference_equals_the_port(tpch_small, n, qty):
    """Each reference equals the port's result on the CPU, exactly (the
    default plan: broadcast joins at this size)."""
    expect = chip_smoke.tpch_reference(n, tpch_small, qty)
    assert expect
    chip_smoke.check_tpch(n, _port_rows(n, tpch_small, qty), expect, "cpu")


@pytest.mark.parametrize("n,qty", TPCH_CASES)
def test_tpch_reference_equals_the_pandas_oracle(tpch_small, n, qty):
    """Each reference against the JAX package's pandas oracle: money
    within its rtol (1e-6; the oracle sums float64), the rest exact."""
    from spark_rapids_tpu.workloads.tpch_oracle import ORACLES, to_pandas
    import numpy as np
    kw = {"qty": qty} if n == 18 else {}
    exp = ORACLES[n](to_pandas(tpch_small), **kw).reset_index(drop=True)
    if n == 5:
        exp = exp.sort_values(["revenue", "n_name"],
                              ascending=[False, True]).reset_index(drop=True)
    ref = chip_smoke.tpch_reference(n, tpch_small, qty)
    assert list(exp.columns) == list(chip_smoke.TPCH_COLUMNS[n])
    assert len(ref) == len(exp) > 0
    scale = {"revenue": 4, "c_acctbal": 2, "o_totalprice": 2, "sum_qty": 2}
    for i, c in enumerate(exp.columns):
        got = [r[i] for r in ref]
        if c in scale:
            np.testing.assert_allclose(
                np.array(got, float) / 10**scale[c],
                exp[c].astype(float), rtol=1e-6, atol=1e-6)
        else:
            assert got == exp[c].tolist(), c


def test_check_tpch_rejects_faults(tpch_small):
    import pyarrow as pa
    got = _port_rows(10, tpch_small, 300)
    expect = chip_smoke.tpch_reference(10, tpch_small)
    chip_smoke.check_tpch(10, got, expect, "cpu")
    with pytest.raises(AssertionError, match="rows differ"):
        chip_smoke.check_tpch(10, got.slice(0, 19), expect, "cpu")
    swapped = pa.concat_tables([got.slice(1, 1), got.slice(0, 1),
                                got.slice(2)])
    with pytest.raises(AssertionError, match="rows differ"):
        chip_smoke.check_tpch(10, swapped, expect, "cpu")
    with pytest.raises(AssertionError, match="columns"):
        chip_smoke.check_tpch(10, got.rename_columns(
            ["k"] + got.column_names[1:]), expect, "cpu")
    q5 = _port_rows(5, tpch_small, 300)
    ref5 = chip_smoke.tpch_reference(5, tpch_small)
    with pytest.raises(AssertionError, match="revenue increases"):
        chip_smoke.check_tpch(5, q5.take([1, 0, 2, 3, 4]), ref5, "cpu")


def test_tpch_rows_give_unscaled_decimals():
    import decimal
    import pyarrow as pa
    at = pa.table({"a": pa.array([decimal.Decimal("1.25"), None],
                                 pa.decimal128(12, 2)),
                   "b": pa.array(["x", "y"])})
    assert chip_smoke.tpch_rows(at) == [(125, "x"), (None, "y")]


def test_reference_guards():
    import numpy as np
    import pyarrow as pa
    with pytest.raises(AssertionError, match="overflow"):
        chip_smoke._group_sum(np.zeros(4, np.int64),
                              np.full(4, 2**62, np.int64), 1)
    with pytest.raises(AssertionError, match="not 0..n-1"):
        chip_smoke._arange_keys(pa.table({"k": [0, 2, 1]}), "k")
    lok, ok = chip_smoke._lineitem_orders({
        "orders": pa.table({"o_orderkey": [0, 1, 2]}),
        "lineitem": pa.table({"l_orderkey": [2, 3, 0]})})
    assert lok.tolist() == [2, 0, 0] and ok.tolist() == [True, False, True]


def test_tpch_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """The SF10 phases at sf 0.01 on the shuffled plan: every query
    equals its reference, every batch is on the session's device, the
    partition kernel never launches, and the phase lines carry the plan
    shape, layers and join paths."""
    import json

    import spark_rapids_tpu_torch as pt
    expects = {n: chip_smoke.tpch_reference(n, tpch_small)
               for n in chip_smoke.TPCH_QUERIES}
    # the written plans (the adaptive features off; their case below)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096,
                       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                       -1, **chip_smoke.WRITTEN_CONF}, device="cpu")
    launches = chip_smoke.tpch_phases(s, tpch_small, expects, runs=1)
    assert set(launches) == {f"q{n}" for n in chip_smoke.TPCH_QUERIES}
    assert all(v == {"all": 0, "vector": 0, "scalar": 0}
               for v in launches.values())
    phases = {d["phase"]: d for d in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    assert set(phases) == {f"tpch_q{n}" for n in chip_smoke.TPCH_QUERIES} \
        | {"tpch_q5_profiled", "tpch_q13_profiled"}
    plans = {n: phases[f"tpch_q{n}"]["plan"] for n in chip_smoke.TPCH_QUERIES}
    assert plans[4]["join_kinds"] == ["left_semi"]
    assert plans[5]["per_partition_joins"] == 5
    assert plans[18]["aggregates"] == ["final", "partial"] * 2
    assert plans[19]["aggregates"] == ["ungrouped"]
    run = phases["tpch_q5"]["runs"][0]
    assert len(run["join_paths"]) == 5 and run["layers_s"]["scanTime"] > 0
    assert phases["tpch_q5_profiled"]["host_syncs_per_batch"] > 0
    # Q8's year is an int32 key of a partial -> final aggregate here
    assert plans[13]["aggregates"] == ["final", "partial"] * 2
    assert phases["tpch_q8"]["int32_exchanges"] == 1
    assert "cummax" in chip_smoke.q1_group_of(
        "void at::native::tensor_kernel_scan_innermost_dim_with_indices",
        chip_smoke.Q13_GROUPS)


def test_adaptive_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """The adaptive default at sf 0.01 with thresholds cut to the data:
    every query equals its reference with its plan held to its
    decisions, the double-valued queries' runs bit-equal; the skewed
    join splits and equals numpy's count and sum; the written-plan pass
    runs all 22 queries on the plans without the four features."""
    import json

    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.workloads import tpch
    li = tpch_small["lineitem"]
    expects = {n: chip_smoke.tpch_reference(n, tpch_small)
               for n in chip_smoke.TPCH_QUERIES}
    conf = {"spark.rapids.tpu.sql.batchSizeRows": 4096,
            "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1 << 16,
            "spark.rapids.tpu.sql.adaptive.advisoryPartitionSizeInBytes":
            1 << 15}
    s = pt.TpuSession(conf, device="cpu")
    queries = (5, 8, 15, 17, 18)
    chip_smoke.tpch_phases(s, tpch_small, expects, runs=2, queries=queries,
                           profile=False)
    sk = pt.TpuSession(dict(conf, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1 << 13,
        "spark.rapids.tpu.sql.adaptive.skewJoin."
        "skewedPartitionThresholdInBytes": 1 << 16}), device="cpu")
    assert chip_smoke.skew_join_phase(sk, tpch_small) == {
        "skewed_join": {"all": 0, "vector": 0, "scalar": 0}}
    expects.update({
        1: chip_smoke.q1_reference(li),
        3: chip_smoke.q3_reference(*(tpch_small[k] for k in (
            "customer", "orders", "lineitem"))),
        6: tpch.q6_numpy_baseline(
            li.column("l_shipdate").to_numpy(),
            chip_smoke.unscaled(li, "l_discount"),
            chip_smoke.unscaled(li, "l_quantity"),
            chip_smoke.unscaled(li, "l_extendedprice"))})
    launches = chip_smoke.tpch_phases(
        chip_smoke.written_session(s), tpch_small, expects, runs=1,
        queries=chip_smoke.ALL_QUERIES, label="written", profile=False)
    assert set(launches) == {f"written_q{n}" for n in chip_smoke.ALL_QUERIES}
    phases = {d["phase"]: d for d in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    for n in queries:
        ph = phases[f"tpch_q{n}"]
        runs = ph["runs"]
        assert len(runs) in (2, 3)
        assert ph["plan_signatures"] == [r["plan_signature"] for r in runs]
        for r in runs:
            assert r["peak_host_rss_bytes"] >= r["host_rss_before_bytes"] > 0
            assert r["aqe"]["partitions_after"] <= \
                r["aqe"]["partitions_before"]
        if n in chip_smoke.TPCH_DOUBLE_QUERIES:
            assert ph["runs_bit_equal"] is True
    assert phases["tpch_q5"]["join_order_differs"] is True
    assert phases["tpch_q15"]["runs"][0]["reuse_hits"] == 1
    assert sum(phases[f"tpch_q{n}"]["runs"][0]["aqe"]["demotions"]
               for n in queries) > 0
    skew = phases["skewed_join"]
    assert skew["aqe_skew_splits"] > 0 and skew["aqe"]["demotions"] == 0
    for n in chip_smoke.ALL_QUERIES:
        ph = phases[f"written_q{n}"]
        assert ph["plan"] == ph["written_plan"]
        assert ph["join_order_differs"] is False
        run = ph["runs"][0]
        assert run["aqe"]["stages"] == 0 and run["reuse_hits"] == 0


def test_tpch_data_prints_rows_and_seconds(capsys):
    """tpch_data's tables, timed one generator at a time, are gen_all's."""
    import json

    from spark_rapids_tpu_torch.workloads import tpch
    tables, expects = chip_smoke.tpch_data(0.002, seed=3, qty=150)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["phase"] == "tpch_data"
    exp = tpch.gen_all(0.002, seed=3)
    assert list(tables) == list(exp)
    assert all(tables[k].equals(exp[k]) for k in exp)
    assert line["rows"] == {k: v.num_rows for k, v in tables.items()}
    assert set(line["gen_s"]) == set(tables)
    assert set(expects) == set(chip_smoke.TPCH_QUERIES)
    assert line["result_rows"] == {f"q{n}": len(e)
                                   for n, e in expects.items()}
    assert line["q18_orders_over_qty"] == len(
        chip_smoke.q18_reference(tables, 150, limit=None)) >= \
        line["result_rows"]["q18"] > 0


def test_tpch_data_in_processes_with_the_phase_references(capsys):
    """main's form of tpch_data: all tables but lineitem made in spawned
    processes, every reference on the thread pool, the other phases'
    references among them; the tables are gen_all's and every reference
    equals the one made alone."""
    import json
    import pickle

    from spark_rapids_tpu_torch.workloads import tpch
    tables, expects = chip_smoke.tpch_data(
        0.002, seed=3, qty=150, extra=chip_smoke.PHASE_REFERENCES, procs=2)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line["gen_processes"] == 2 and line["reference_threads"] == 8
    assert set(line["reference_s"]) == {
        f"q{n}" for n in chip_smoke.TPCH_QUERIES} \
        | set(chip_smoke.PHASE_REFERENCES)
    exp = tpch.gen_all(0.002, seed=3)
    assert list(tables) == list(exp)
    assert all(tables[k].equals(exp[k]) for k in exp)
    assert set(expects) == set(chip_smoke.TPCH_QUERIES) \
        | set(chip_smoke.PHASE_REFERENCES)
    for n in chip_smoke.TPCH_QUERIES:
        alone = (chip_smoke.q18_reference(exp, 150)[:100] if n == 18 else
                 chip_smoke.tpch_reference(n, exp, 150))
        assert pickle.dumps(expects[n]) == pickle.dumps(alone), n
    for k, fn in chip_smoke.PHASE_REFERENCES.items():
        assert pickle.dumps(expects[k]) == pickle.dumps(fn(exp)), k


class _Event:
    def __init__(self, name, device, ns):
        self._v = (name, device, ns)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]


def test_device_entries_sum_the_device_events_by_name():
    """profiled_query's reading of a trace: the device-side events summed
    by name, each with its count; host events and empty ones left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType
    events = [_Event("k1", DeviceType.CUDA, 3000),
              _Event("Memcpy HtoD", DeviceType.CUDA, 500),
              _Event("k1", DeviceType.CUDA, 1000),
              _Event("k2", DeviceType.CUDA, 0),
              _Event("aten::add", DeviceType.CPU, 9000)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert sorted(chip_smoke.device_entries(prof)) == [
        ("Memcpy HtoD", 0.5, 1), ("k1", 4.0, 2)]


def test_adaptive_pool_ab_pairs_only_the_ab_queries(tpch_small, capsys):
    """With `ab_queries` the pool A/B reads only those queries twice; the
    others run once, at the session's map pool."""
    import json

    import spark_rapids_tpu_torch as pt
    queries = (4, 18)
    expects = {n: chip_smoke.tpch_reference(n, tpch_small) for n in queries}
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    chip_smoke.tpch_phases(s, tpch_small, expects, runs=2, queries=queries,
                           profile=False, ab_threads=1, ab_queries=(4,))
    phases = {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    q4, q18 = phases["tpch_q4"], phases["tpch_q18"]
    assert q4["runs_bit_equal"] is True and "default_conf_first" in q4
    assert sorted(r["map_threads"] for r in q4["runs"][:2]) == sorted(
        [1, chip_smoke.map_threads_of(s)])
    assert len(q18["runs"]) == 1 and "default_conf_first" not in q18
    assert q18["runs"][0]["map_threads"] == chip_smoke.map_threads_of(s)
    # the card's pairs: double-valued queries, whose runs must be bit-equal
    assert chip_smoke.AB_QUERIES and set(chip_smoke.AB_QUERIES) <= set(
        chip_smoke.TPCH_DOUBLE_QUERIES)


def test_partition_launches_follow_the_plan(tpch_small):
    """A plan with an exchange on one int32 key must launch the kernel
    on the card, every launch the vector variant; any other plan must
    not launch it; off the card nothing launches."""
    import torch

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096,
                       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                       -1}, device="cpu")
    q8 = chip_smoke.tpch_query(8, s, tpch_small)
    q8.to_arrow()
    q9 = chip_smoke.tpch_query(9, s, tpch_small)
    q9.to_arrow()
    assert chip_smoke.int32_exchanges(q8.last_plan()) == 1
    assert chip_smoke.int32_exchanges(q9.last_plan()) == 0
    none = {"all": 0, "vector": 0, "scalar": 0}
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    chip_smoke.check_partition_launches(8, q8.last_plan(), none, cpu)
    chip_smoke.check_partition_launches(
        8, q8.last_plan(), {"all": 3, "vector": 3, "scalar": 0}, cuda)
    for got in (none, {"all": 3, "vector": 2, "scalar": 1}):
        with pytest.raises(AssertionError, match="int32 key"):
            chip_smoke.check_partition_launches(8, q8.last_plan(), got,
                                                cuda)
    with pytest.raises(AssertionError, match="no exchange key"):
        chip_smoke.check_partition_launches(
            9, q9.last_plan(), {"all": 1, "vector": 1, "scalar": 0}, cuda)


def test_check_tpch_holds_doubles_to_the_relative_tolerance():
    import pyarrow as pa
    at = pa.table({"o_year": pa.array([1995, 1996], pa.int32()),
                   "mkt_share": [0.25, 0.5]})
    chip_smoke.check_tpch(8, at, [(1995, 0.25 * (1 + 5e-10)), (1996, 0.5)],
                          "cpu")
    with pytest.raises(AssertionError, match="rows differ"):
        chip_smoke.check_tpch(8, at, [(1995, 0.25 * (1 + 5e-9)),
                                      (1996, 0.5)], "cpu")
    with pytest.raises(AssertionError, match="rows differ"):
        chip_smoke.check_tpch(8, at, [(1994, 0.25), (1996, 0.5)], "cpu")


def test_q17_reference_notes_its_near_ties(tpch_small):
    notes = {}
    assert chip_smoke.q17_reference(tpch_small, notes=notes) == \
        chip_smoke.q17_reference(tpch_small)
    assert notes["q17_lines"] > 0 and 0 <= notes["q17_near_ties"] \
        <= notes["q17_lines"]


def test_join_condition_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """The SF10 conditional-join phases at sf 0.01: the conditional hash
    join (orders with customer, per partition here) and the nested-loop
    join (customer with nation) equal numpy, the nested-loop join also
    the equi-join, and neither launches the partition kernel."""
    import json

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096,
                       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                       -1}, device="cpu")
    launches = chip_smoke.join_condition_phases(s, tpch_small)
    none = {"all": 0, "vector": 0, "scalar": 0}
    assert launches == {"join_condition": none, "nested_loop": none}
    phases = {d["phase"]: d for d in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    cond, nlj = phases["join_condition"], phases["nested_loop_join"]
    assert cond["per_partition"] and 0 < cond["rows"] < cond["stream_rows"]
    assert nlj["rows"] == nlj["stream_rows"] == 1500
    assert nlj["pairs"] == 1500 * 25
    # 1,048,576 // 25 stream rows a chunk: one chunk a 4096-row batch
    assert nlj["chunks"] == 1
    assert "NestedLoopJoinExec" in nlj["plan"]


def test_double_sum_and_bit_equal_runs_rehearse_on_the_cpu(tpch_small,
                                                           capsys):
    """The repeat of a fixed double group sum, and two runs of each
    double-valued query of the new five held bit for bit."""
    import json

    import pyarrow as pa
    import torch

    import spark_rapids_tpu_torch as pt
    info = chip_smoke.double_sum_repeat(torch.device("cpu"), rows=20_000,
                                        segments=1_000, repeats=3)
    assert info["bit_equal"] and info["bit_equal_to_cpu"]
    assert info["max_rel_diff_vs_cpu"] == 0.0
    queries = (11, 15, 22)
    expects = {n: chip_smoke.tpch_reference(n, tpch_small) for n in queries}
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    capsys.readouterr()
    chip_smoke.tpch_phases(s, tpch_small, expects, runs=2, queries=queries)
    phases = [json.loads(x) for x in capsys.readouterr().out.splitlines()
              if x.startswith("{")]
    assert [p["phase"] for p in phases] == [f"tpch_q{n}" for n in queries]
    assert all(p["runs_bit_equal"] is True and len(p["runs"]) == 2
               for p in phases)
    a = pa.table({"x": pa.array([1.0, None, 0.1 + 0.2])})
    assert chip_smoke.same_bits(a, a)
    assert not chip_smoke.same_bits(a, pa.table({"x": [1.0, None, 0.3]}))
    assert not chip_smoke.same_bits(a, pa.table({"x": [1.0, 2.0,
                                                       0.1 + 0.2]}))


class _InjectedCap:
    """The CPU's stand-in for chip_smoke.CudaCap at a share of 4096
    rows: while it is entered, the aggregate's first pass over a batch
    longer than the share raises torch.OutOfMemoryError, as a capped CUDA
    allocator would for a big enough allocation (inside `with_retry`);
    under half, so does every merge of partials (outside any retry
    scope)."""

    def __init__(self, share):
        self.rows = int(4096 * share)
        self.merges_fail = share < 0.5

    def __enter__(self):
        import torch
        from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
        cls = HashAggregateExec
        self._orig = (cls._update_one, cls._merge_partials)
        update, merge = self._orig
        rows, merges_fail = self.rows, self.merges_fail

        def oom():
            return torch.OutOfMemoryError("CUDA out of memory (injected)")

        def capped_update(agg, ctx, batch, *a):
            if batch.capacity > rows:
                raise oom()
            return update(agg, ctx, batch, *a)

        def capped_merge(agg, *a):
            if merges_fail:
                raise oom()
            return merge(agg, *a)

        cls._update_one, cls._merge_partials = capped_update, capped_merge
        return self

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
        HashAggregateExec._update_one, HashAggregateExec._merge_partials = \
            self._orig


def test_memory_runtime_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """The four memory-runtime phases at sf 0.01: the sort over a 64 KiB
    threshold goes out of core and equals numpy; Q9, Q18 and Q21 under a
    conf scaled to the data spill to host and disk and sub-partition,
    exact, leaving no handle, reservation or file; the injected cap
    splits Q18's aggregate and retries it, twice; the concurrency
    readings hold the permit bound and the rows."""
    import json

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096,
                       "spark.rapids.tpu.sql.adaptive."
                       "advisoryPartitionSizeInBytes": 1 << 15},
                      device="cpu")
    queries = (5, 9, 18, 21)
    expects = {n: chip_smoke.tpch_reference(n, tpch_small) for n in queries}
    defaults = {n: chip_smoke.tpch_query(n, s, tpch_small).to_arrow()
                for n in chip_smoke.CONSTRAINED_QUERIES}

    def q18():
        return chip_smoke.tpch_query(18, s, tpch_small)

    def check18(out, what):
        chip_smoke.check_tpch(18, out, expects[18], what)

    capsys.readouterr()
    out = chip_smoke.memory_runtime_phases(
        s, tpch_small, expects, defaults,
        sort_conf={"spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes":
                   1 << 16},
        constrained_confs={"scaled": {
            "spark.rapids.tpu.memory.tpu.poolBytes": 512 << 10,
            "spark.rapids.tpu.sql.join.buildSideBudgetBytes": 256 << 10,
            "spark.rapids.tpu.sql.agg.maxMergeRows": 4096,
            "spark.rapids.tpu.memory.host.spillStorageSize": 128 << 10}},
        oom_subjects=[("q18_merges", q18, check18, (0.3,)),
                      ("q18", q18, check18, (1.0, 0.9, 0.5))],
        oom_cap=_InjectedCap)
    phases = {d["phase"]: d for d in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    ooc, inc = phases["ooc_sort_out_of_core"], phases["ooc_sort_in_core"]
    assert ooc["oocRangePartitions"] > 0 and inc["oocRangePartitions"] == 0
    assert ooc["rows"] == inc["rows"] == tpch_small["lineitem"].num_rows
    assert out["ooc_sort"]["out_of_core"]["extendedprice_unscaled_sum"] \
        == inc["extendedprice_unscaled_sum"]
    con = phases["constrained_memory"]["runs"]
    assert set(con) == {"scaled_q9", "scaled_q18", "scaled_q21"}
    assert any(q["spillToHost"] for q in con.values())
    assert any(q["spillToDisk"] for q in con.values())
    assert any(q["numSubPartitions"] for q in con.values())
    for name, q in con.items():
        assert q["spill_dir_files_after"] == 0
        assert q["device_reserved_after"] == 0
        assert 0 < q["parked_peak_bytes"] <= 512 << 10
        if name != "scaled_q9":
            assert q["equal_to_default_conf_bit_for_bit"] is True
    assert con["scaled_q9"]["max_rel_diff_to_default_conf"] < 1e-12
    oom = phases["real_oom"]["subjects"]
    # under half a share the merges (outside any retry scope) fail: the
    # OOM escapes and names the frames it passed; the next subject at
    # share 1.0 leaves 4096-row batches whole and at 0.9 splits them
    esc = oom["q18_merges"]["attempts"]
    assert len(esc) == 1 and esc[0]["site"].endswith("_emit_final")
    assert [a["share"] for a in oom["q18"]["attempts"]] == [1.0, 0.9]
    assert oom["q18"]["attempts"][0]["ooms"] == 0
    assert oom["q18"]["chosen_share"] == 0.9
    assert oom["q18"]["second_run"]["ooms"] > 0
    assert oom["q18"]["second_run"]["splits"] > 0
    assert out["real_oom"]["split_and_retried"] == "q18"
    # the card's default subjects: Q18, then lineitem's exchange, whose
    # check holds its rows and sums to numpy's
    subj = chip_smoke.oom_subjects(s, tpch_small, expects)
    assert [x[0] for x in subj] == ["q18", "q18_lineitem_exchange"]
    _, make, check, shares = subj[1]
    check(make().to_arrow(), "uncapped")
    assert shares == chip_smoke.OOM_SHARES
    conc = phases["concurrency"]["queries"]
    # Q18's own reading was cut to pay for slice 18's phases
    assert set(conc) == {"q5", "q18_inner_aggregate"}
    inner = conc["q18_inner_aggregate"]
    assert inner["tasks_2"]["root_partitions"] > 1
    assert 1 <= inner["tasks_2"]["semaphorePeakHeld"] <= 2
    assert inner["tasks_1"]["semaphorePeakHeld"] == 1
    assert conc["q5"]["tasks_2"]["root_partitions"] == 1


def test_an_escaped_oom_names_its_site():
    import torch
    from spark_rapids_tpu_torch.memory import retry
    with pytest.raises(torch.OutOfMemoryError) as e:
        retry.retry_no_split(lambda: (_ for _ in ()).throw(
            torch.OutOfMemoryError("CUDA out of memory")), retries=0)
    assert chip_smoke.port_site(e.value).startswith(
        "/memory/retry.py:") and "retry_no_split" in \
        chip_smoke.port_site(e.value)


def test_grouping_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """Slice 11's phases at sf 0.01 in 4096-row batches: the new
    aggregates by date equal their numpy references, the distinct count
    beside a sum is exact, every row of the double and decimal128
    exchanges sits where numpy's version of the JAX hash puts it; and
    numpy's hash equals the JAX package's partition ids."""
    import json

    import numpy as np

    import jax.numpy as jnp
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.ops.hash import partition_ids
    from spark_rapids_tpu.ops.kernel_utils import CV as JCV
    rng = np.random.default_rng(2)
    d = np.concatenate([rng.standard_normal(2000) * 1e5,
                        [0.0, -0.0, 5e-324, np.inf, -np.inf, np.nan]])
    valid = rng.random(len(d)) > 0.1
    want = np.asarray(partition_ids([JCV(jnp.asarray(d),
                                         jnp.asarray(valid))],
                                    [jdt.FLOAT64], 200))
    got = chip_smoke.np_partition_ids(chip_smoke.np_double_word(d), valid,
                                      200)
    assert np.array_equal(got, want)
    m = rng.integers(-2**63, 2**63, (2000, 2), dtype=np.int64)
    want = np.asarray(partition_ids([JCV(jnp.asarray(m),
                                         jnp.asarray(valid[:2000]))],
                                    [jdt.DecimalType(30, 4)], 200))
    got = chip_smoke.np_partition_ids(m[:, 0] ^ m[:, 1], valid[:2000], 200)
    assert np.array_equal(got, want)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    launches = chip_smoke.grouping_phases(s, tpch_small["lineitem"])
    assert launches == {"stats_by_shipdate": {"all": 0, "vector": 0,
                                              "scalar": 0}}
    phases = {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    st = phases["stats_by_shipdate"]
    assert st["plan"][:3] == ["CollectAggExec", "AQEShuffleReadExec",
                              "ShuffleExchangeExec"]
    assert st["worst"]["pa_rank_err"] <= st["bounds"]["pa_rank_err"]
    assert phases["distinct_beside_sum"]["groups"] == 100
    fd = phases["float_decimal_keys"]
    assert fd["double_key"]["groups"] == 50
    dec = fd["decimal128_repartition"]
    assert dec["rows"] == dec["rows_placed"] == \
        tpch_small["lineitem"].num_rows


@pytest.mark.parametrize("offset", [0, 1])
def test_adaptive_pool_ab_rehearses_on_the_cpu(tpch_small, capsys, offset):
    """The adaptive pass's A/B: one reading at the default map pool, one
    at mapThreads = 1, alternating which runs first, in the order the
    offset gives; every pair bit-equal."""
    import json

    import spark_rapids_tpu_torch as pt
    queries = (4, 9, 18)
    expects = {n: chip_smoke.tpch_reference(n, tpch_small) for n in queries}
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096,
                       "spark.rapids.tpu.sql.adaptive."
                       "advisoryPartitionSizeInBytes": 1 << 15},
                      device="cpu")
    chip_smoke.tpch_phases(s, tpch_small, expects, runs=2, queries=queries,
                           profile=False, ab_threads=1, ab_offset=offset)
    phases = {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    for i, n in enumerate(queries):
        ph = phases[f"tpch_q{n}"]
        assert ph["runs_bit_equal"] is True
        threads = [r["map_threads"] for r in ph["runs"][:2]]
        serial_first = (i + offset) % 2
        assert threads[1 - serial_first] == 1
        assert threads[serial_first] == chip_smoke.map_threads_of(s)
        assert ph["default_conf_first"] is (serial_first == 0)
        assert all("mapPoolWaitMs" in r for r in ph["runs"])


def test_pool_ab_offset_from_the_argument_or_the_start_second():
    assert chip_smoke.pool_ab_offset(["--pool-ab-offset=1"], 10.0) == 1
    assert chip_smoke.pool_ab_offset(["--pool-ab-offset=0"], 11.0) == 0
    assert [chip_smoke.pool_ab_offset([], t) for t in (10.9, 11.2)] \
        == [0, 1]


def test_scalar_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """Slice 12's phases at sf 0.01 in 4096-row batches: the date
    functions by year, the strings, casts, math and hashes by order
    status, and the time-zone round trips, each against its numpy,
    pyarrow or zoneinfo reference; no kernel launch off the card."""
    import json

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    launches = chip_smoke.scalar_phases(s, tpch_small)
    assert launches == {"dates_by_year": {"all": 0, "vector": 0,
                                          "scalar": 0}}
    phases = {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    d = phases["dates_by_year"]
    assert d["groups"] == 7 and d["plan"][2] == "ShuffleExchangeExec"
    st = phases["strings_casts_hashes"]
    assert st["groups"] == 3 and st["worst_double_rel"] <= 1e-9
    assert st["string_hash_rows"] == tpch_small["orders"].num_rows
    tz = phases["timestamps_tz"]
    assert tz["back_diff_s"] == -3600 * tz["rows_at_overlap"]


def test_numpy_hash_twins_equal_the_jax_package():
    """`np_xxhash64_long` and `np_hive_hash_long`, the references of the
    strings phase, equal the JAX package's xxhash64 and hive_hash of an
    int64 column; the plain-Python string hashes equal its string
    hashes."""
    import jax.numpy as jnp
    import numpy as np

    from spark_rapids_tpu.columnar import dtypes as jdt
    from spark_rapids_tpu.ops import hash as jh
    from spark_rapids_tpu.ops.kernel_utils import CV as JCV
    rng = np.random.default_rng(9)
    x = rng.integers(-2**63, 2**63, 500, dtype=np.int64)
    x[:3] = [-2**63, 2**63 - 1, 0]
    cv = JCV(jnp.asarray(x), jnp.ones(500, bool))
    assert np.array_equal(
        np.asarray(jh.xxhash64_row_hash([cv], [jdt.INT64])),
        chip_smoke.np_xxhash64_long(x))
    assert np.array_equal(
        np.asarray(jh.hive_hash_row_hash([cv], [jdt.INT64])),
        chip_smoke.np_hive_hash_long(x))
    words = [b"", b"a", b"special requests", b"\xc3\xa9t\xc3\xa9", b"z" * 31]
    off = np.cumsum([0] + [len(w) for w in words]).astype(np.int32)
    data = np.frombuffer(b"".join(words), np.uint8)
    scv = JCV(jnp.asarray(data), jnp.ones(len(words), bool),
              jnp.asarray(off))
    for fn, py in ((jh.murmur3_row_hash, chip_smoke.py_murmur3_bytes),
                   (jh.xxhash64_row_hash, chip_smoke.py_xxhash64_bytes)):
        assert np.asarray(fn([scv], [jdt.STRING])).tolist() == \
            [py(w) for w in words]
    assert np.asarray(jh.hive_hash_row_hash([scv], [jdt.STRING])).tolist() \
        == [chip_smoke.py_hive_hash_bytes(w) for w in words]


# ----------------------------------------------------------------------
# Slice 13: nested columns, grouping sets, the DataFrame surface
# ----------------------------------------------------------------------
def test_nested_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """Slice 13's phases at sf 0.01 in 4096-row batches: collect_list /
    collect_set per customer with the collection functions over them and
    explode by date, a map column exploded by position, rollup and cube,
    and a cached year counted, grouped and unioned, each against numpy;
    no kernel launch off the card."""
    import json

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    launches = chip_smoke.nested_phases(s, tpch_small)
    none = {"all": 0, "vector": 0, "scalar": 0}
    assert launches == {"collect_explode": none, "map_explode": none}
    phases = {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    ce = phases["collect_explode"]
    orders = tpch_small["orders"]
    assert ce["elements"] == ce["explode_rows"] == orders.num_rows
    assert "GenerateExec" in ce["explode_plan"]
    assert ce["explode_plan"][2] == "ShuffleExchangeExec"
    me = phases["map_explode"]
    assert me["entries"] == tpch_small["lineitem"].num_rows
    assert me["functions"]["entries"] == me["entries"]
    rc = phases["rollup_cube"]
    assert rc["rollup"]["rows_out"] == 10 and rc["cube"]["rows_out"] == 24
    assert "ExpandExec" in rc["rollup"]["plan"]
    uc = phases["union_cache_count"]
    assert uc["plan"][-1] == "CachedScanExec"
    assert uc["explain_names_cached_scan"]


def test_nested_checks_reject_a_wrong_row(tpch_small):
    """Each check of the nested phases fails on one wrong value: a
    customer's last date, one date's exploded count, one position's sum,
    one rollup cell."""
    import numpy as np
    import pyarrow as pa

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    orders, li = tpch_small["orders"], tpch_small["lineitem"]
    expect = chip_smoke.collect_reference(orders)
    collected = chip_smoke.collected_query(s, orders)
    out = chip_smoke.collection_query(collected).to_arrow()
    chip_smoke.check_collect(out, expect, "ok")
    i = out.column_names.index("n_from")
    bad = np.asarray(out.column(i)).copy()
    bad[7] += 1
    with pytest.raises(AssertionError, match="n_from differs"):
        chip_smoke.check_collect(out.set_column(i, "n_from", pa.array(bad)),
                                 expect, "wrong")
    counts = chip_smoke.explode_query(collected).to_arrow()
    chip_smoke.check_date_counts(counts, expect, "ok")
    c = counts.column("c").to_numpy().copy()
    c[3] -= 1
    with pytest.raises(AssertionError, match="exploded counts"):
        chip_smoke.check_date_counts(counts.set_column(
            counts.column_names.index("c"), "c", pa.array(c)), expect,
            "wrong")
    table, mexpect = chip_smoke.map_table(li)
    mout = chip_smoke.map_explode_query(s, table).to_arrow()
    fout = chip_smoke.map_functions_query(s, table).to_arrow()
    chip_smoke.check_map(mout, fout, mexpect, "ok")
    wrong = dict(mexpect, sums=mexpect["sums"] + (
        np.arange(len(mexpect["sums"])) == 2))
    with pytest.raises(AssertionError, match="by position"):
        chip_smoke.check_map(mout, fout, wrong, "wrong")
    g = chip_smoke.grouping_reference(li, orders)
    rows = chip_smoke.rollup_rows(chip_smoke.rollup_query(s, li).to_arrow())
    chip_smoke.check_grouping(rows, g["rollup"], 10, "ok")
    moved = {r[:4] + (r[4] + 1,) + r[5:] if r[5] == 3 else r for r in rows}
    with pytest.raises(AssertionError, match="differ from numpy"):
        chip_smoke.check_grouping(moved, g["rollup"], 10, "wrong")


WINDOW_STREAM = {"spark.rapids.tpu.sql.window.chunkRows": 1024,
                 "spark.rapids.tpu.sql.sort.outOfCore.thresholdBytes":
                 64 << 10}


def test_window_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """Slice 14's phases at sf 0.01 in 4096-row batches: the running
    window read at the session's conf, streamed in chunks and in core,
    bit-equal; three specs chained; the daily revenue's window over a
    grouped exchange on the date. No kernel launch off the card."""
    import json

    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    launches = chip_smoke.window_phases(s, tpch_small,
                                        stream_conf=WINDOW_STREAM)
    assert launches == {"daily_revenue_window": {"all": 0, "vector": 0,
                                                 "scalar": 0}}
    phases = {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}
    wr = phases["window_running"]
    assert wr["readings"]["streamed"]["window"]["numChunks"] > 2
    assert wr["bit_equal_to_in_core"] == {"default": True, "streamed": True}
    assert wr["rows"] == tpch_small["orders"].num_rows
    wf = phases["window_frames"]
    assert wf["window"]["window_execs"] == 3
    assert wf["plan"].count("WindowExec") == 3
    dr = phases["daily_revenue_window"]
    assert dr["window"]["window_execs"] == 2
    assert "ShuffleExchangeExec" in dr["plan"]


def _set(at, name, values):
    import pyarrow as pa
    i = at.column_names.index(name)
    return at.set_column(i, name, pa.array(values, at.schema.field(i).type))


def test_window_checks_reject_a_wrong_row(tpch_small):
    """Each window check accepts the port's rows and fails on one wrong
    value: a running rank, a frame's lag (a null made a value), the
    7-day revenue sum, a running double sum past 1e-9."""
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    orders, li = tpch_small["orders"], tpch_small["lineitem"]
    ref = chip_smoke.window_running_reference(orders)
    out = chip_smoke.window_running_query(s, orders).to_arrow()
    chip_smoke.check_window_running(out, ref, "ok")
    rk = out.column("rk").to_pylist()
    rk[5] += 1
    with pytest.raises(AssertionError, match="rk differs"):
        chip_smoke.check_window_running(_set(out, "rk", rk), ref, "wrong")
    ds = out.column("ds").to_pylist()
    ds[9] *= 1 + 1e-8
    with pytest.raises(AssertionError, match="ds off"):
        chip_smoke.check_window_running(_set(out, "ds", ds), ref, "wrong")

    ref = chip_smoke.window_frames_reference(orders)
    out = chip_smoke.window_frames_query(s, orders).to_arrow()
    chip_smoke.check_window_frames(out, ref, "ok")
    lag = out.column("lag_p").to_pylist()
    lag[lag.index(None)] = next(v for v in lag if v is not None)
    with pytest.raises(AssertionError, match="lag_p validity"):
        chip_smoke.check_window_frames(_set(out, "lag_p", lag), ref,
                                       "wrong")

    ref = chip_smoke.daily_revenue_reference(li)
    out = chip_smoke.daily_revenue_query(s, li).to_arrow()
    chip_smoke.check_daily_revenue(out, ref, "ok")
    r7 = out.column("rev7").to_pylist()
    r7[3] += type(r7[3])("0.0001")
    with pytest.raises(AssertionError, match="rev7 differs"):
        chip_smoke.check_daily_revenue(_set(out, "rev7", r7), ref, "wrong")


# ----------------------------------------------------------------------
# Slice 15: the SQL frontend, the host fallback, degrade-to-host
# ----------------------------------------------------------------------
def _phase_lines(capsys):
    import json
    return {p["phase"]: p for p in (
        json.loads(x) for x in capsys.readouterr().out.splitlines()
        if x.startswith("{"))}


def test_sql_surface_phase_rehearses_on_the_cpu(tpch_small, capsys):
    """Q6, the per-date group-by and Q17 in SQL over the tables as views,
    each held to its reference; EXPLAIN all `*`. No kernel launch off the
    card; the group-by's exchange on the date is counted."""
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    li = tpch_small["lineitem"]
    launches = chip_smoke.sql_surface_phase(
        s, tpch_small, chip_smoke._q6_reference(tpch_small),
        chip_smoke.shipdate_reference(li),
        chip_smoke.q17_reference(tpch_small))
    assert launches == {"sql_group_by_shipdate": {"all": 0, "vector": 0,
                                                  "scalar": 0}}
    line = _phase_lines(capsys)["sql_surface"]
    assert line["explain_tags"] == ["*"]
    assert line["group_by_shipdate"]["dates"] == len(
        chip_smoke.shipdate_reference(li)[0])
    assert "ShuffleExchangeExec" in line["group_by_shipdate"]["plan"]
    assert line["q17"]["rel_err"] <= chip_smoke.TPCH_RTOL
    with pytest.raises(AssertionError, match="revenue differs"):
        chip_smoke.sql_surface_phase(
            s, tpch_small, chip_smoke._q6_reference(tpch_small) + 1,
            chip_smoke.shipdate_reference(li),
            chip_smoke.q17_reference(tpch_small))


def test_host_fallback_phase_rehearses_on_the_cpu(tpch_small, capsys):
    """The host Project and Filter over supplier, nation under the CBO,
    and the degrade runs (batches of 25 rows at sf 0.01): every check
    exact, and the degradations counter at the injected count."""
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.exec import degrade
    from spark_rapids_tpu_torch.exec.nodes import FilterExec
    orig = FilterExec.fusable_stage
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    degrade.reset_degradations()
    runs = chip_smoke.host_fallback_phase(s, tpch_small,
                                          degrade_batch_rows=25)
    assert degrade.degradations() == sum(chip_smoke.DEGRADE_INJECTED)
    assert FilterExec.fusable_stage is orig
    assert runs["project"]["host_nodes"] == ["HostProjectExec"]
    assert runs["filter"]["rows"] > 0
    assert runs["cbo_nation"]["rows"] == 5
    assert runs["degrade_1"]["degradedToHost"] == 1
    assert runs["degrade_1"]["events"] == []
    assert runs["degrade_2"]["events"] == ["degrade_to_host"]
    assert runs["degrade_2"]["degradedToHost"] >= 2
    assert _phase_lines(capsys)["host_fallback"]["check"] == "exact"


@pytest.mark.parametrize("build,conf", [
    ("fallback_project", {}), ("fallback_filter", {}),
    ("cbo_query", {"spark.rapids.tpu.sql.optimizer.cbo.enabled": True})])
def test_host_fallback_queries_are_cpu_in_both_planners(tpch_small, build,
                                                        conf):
    """The JAX planner tags the phase's queries `!cpu` on the same
    schema, with the same reasons as the port, and answers alike."""
    import contextlib
    import io
    import re

    import spark_rapids_tpu as st
    import spark_rapids_tpu.functions as JF
    import spark_rapids_tpu_torch as pt
    import spark_rapids_tpu_torch.functions as PF
    table = tpch_small["nation" if build == "cbo_query" else "supplier"]
    make = getattr(chip_smoke, build)
    outs, tags = [], []
    for s, F in ((st.TpuSession(dict(conf)), JF),
                 (pt.TpuSession(dict(conf), device="cpu"), PF)):
        q = make(F, s.create_dataframe(table))
        with contextlib.redirect_stdout(io.StringIO()):
            text = q.explain("NOT_ON_TPU")
        # the tag, lore id and node name, and the reason (lore ids
        # numbered alike in both planners)
        tags.append([(re.sub(r"^(\s*\S+( \[loreId=\d+\])? \w+).*", r"\1",
                             ln.partition("  <-- ")[0]).strip(),
                      ln.partition("  <-- ")[2])
                     for ln in text.splitlines()])
        outs.append(q.to_arrow())
    assert tags[1] == tags[0]
    assert any(t.startswith("!cpu") for t, _ in tags[1])
    assert outs[1].equals(outs[0])


def test_tpch_data_defers_the_named_references(capsys):
    """The deferred references come back as Futures, made on their own
    thread, equal to the ones made alone once resolved."""
    import pickle

    from spark_rapids_tpu_torch.workloads import tpch
    extra = {k: chip_smoke.PHASE_REFERENCES[k]
             for k in ("q6",) + chip_smoke.DEFERRED_REFERENCES}
    tables, expects = chip_smoke.tpch_data(
        0.002, seed=3, qty=150, extra=extra,
        deferred=chip_smoke.DEFERRED_REFERENCES)
    line = _phase_lines(capsys)["tpch_data"]
    assert line["deferred_references"] == list(
        chip_smoke.DEFERRED_REFERENCES)
    assert "q6" in line["reference_s"] and not any(
        k in line["reference_s"] for k in chip_smoke.DEFERRED_REFERENCES)
    refs = {k: expects.pop(k) for k in extra}
    chip_smoke.resolve_deferred(refs, chip_smoke.DEFERRED_REFERENCES)
    exp = tpch.gen_all(0.002, seed=3)
    for k, fn in extra.items():
        assert pickle.dumps(refs[k]) == pickle.dumps(fn(exp)), k
    assert _phase_lines(capsys)["deferred_references"]["waited_s"] >= 0


def _bloom_regex_refs(tables):
    return {k: chip_smoke.PHASE_REFERENCES[k](tables)
            for k in ("runtime_bloom", "regex")}


def test_bloom_regex_json_phases_rehearse_on_the_cpu(tpch_small, capsys):
    """runtime_bloom, regex_surface and json_url over gen_all(0.01): every
    check exact, the bloom runs' stream rows held, no kernel launch."""
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    refs = _bloom_regex_refs(tpch_small)
    by_path = chip_smoke.bloom_regex_json_phases(
        s, tpch_small, chip_smoke.tpch_reference(13, tpch_small), refs)
    assert by_path == {"runtime_bloom": {"all": 0, "vector": 0,
                                         "scalar": 0}}
    lines = _phase_lines(capsys)
    assert {lines[p]["check"] for p in ("runtime_bloom", "regex_surface",
                                        "json_url")} == {"exact"}
    runs = lines["runtime_bloom"]["runs"]
    li = tpch_small["lineitem"].num_rows
    for how in chip_smoke.BLOOM_HOWS:
        assert runs[f"{how}_off"]["stream_rows"] == li
        assert runs[f"{how}_on"]["stream_rows"] < li // 10
        assert runs[f"{how}_on"]["num_bits"] == refs["runtime_bloom"]["bits"]
    assert lines["json_url"]["runs"]["host_bridge_supplier"]["rows"] == \
        tpch_small["supplier"].num_rows


@pytest.mark.parametrize("what", ["bloom_rows", "replace_hash"])
def test_bloom_regex_checks_reject_a_wrong_reference(tpch_small, what):
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    refs = _bloom_regex_refs(tpch_small)
    with pytest.raises(AssertionError):
        if what == "bloom_rows":
            refs["runtime_bloom"]["rows"] += 1
            chip_smoke.runtime_bloom_phase(s, tpch_small,
                                           refs["runtime_bloom"])
        else:
            refs["regex"]["sha256"] = "0" * 64
            chip_smoke.regex_surface_phase(
                s, tpch_small, chip_smoke.tpch_reference(13, tpch_small),
                refs["regex"])


@pytest.mark.parametrize("rows", [1, 63, 64, 2000, 2_000_000, 4_000_000])
def test_bloom_bits_follow_the_aggregate(rows):
    from spark_rapids_tpu_torch.expr.aggregates import BloomFilterAggregate
    from spark_rapids_tpu_torch.expr.expressions import col
    assert chip_smoke.bloom_bits(rows) == BloomFilterAggregate(
        col("k"), estimated_items=max(64, rows)).num_bits
    assert chip_smoke.bloom_bits(2_000_000) == 1 << 24


def test_file_formats_phase_rehearses_on_the_cpu(tpch_small, capsys,
                                                 tmp_path, monkeypatch):
    """file_formats over gen_all(0.01): every piece exact, the seven year
    directories, the Delta versions and Iceberg snapshots equal numpy's,
    no kernel launch off the card, the temporary directory removed."""
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    ref = chip_smoke.PHASE_REFERENCES["file_formats"](tpch_small)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    by_path = chip_smoke.file_formats_phase(s, tpch_small, ref)
    assert by_path == {"file_formats": {"all": 0, "vector": 0,
                                        "scalar": 0}}
    line = _phase_lines(capsys)["file_formats"]
    assert line["check"] == "exact"
    runs = line["runs"]
    assert runs["parquet_partitioned"]["directories"] == 7
    assert runs["parquet_partitioned"]["rows"] == \
        tpch_small["orders"].num_rows
    assert runs["parquet_partitioned"]["map_batches"] == 4
    assert runs["delta"]["operations"] == ["WRITE", "WRITE", "DELETE",
                                           "UPDATE", "MERGE", "OPTIMIZE"]
    assert [tuple(v) for v in runs["delta"]["versions"]] == ref["delta"]
    assert set(line["wall_s"]) >= {"parquet_partitioned_write",
                                   "delta_commits", "iceberg_reads",
                                   "avro_read", "json_read", "csv_read"}
    assert os.listdir(tmp_path) == []       # the phase's directory went


def test_file_formats_reference_follows_the_steps():
    """The Delta references on a tiny customer table, by hand: the
    split, the deleted segment, the update, the merge's matched and new
    rows; the years and segments by hand too."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.workloads import tpch
    cust = pa.table({
        "c_custkey": pa.array([1, 2, 3, 4, 5, 6], pa.int64()),
        "c_mktsegment": pa.array(["AUTOMOBILE", "BUILDING", "BUILDING",
                                  "AUTOMOBILE", "MACHINERY", "BUILDING"]),
        "c_nationkey": pa.array([0, 0, 1, 2, 0, 3], pa.int64()),
        "c_acctbal": tpch.dec_from_unscaled(
            np.array([100, 200, 300, 400, 500, 600], np.int64), 12, 2)})
    src = chip_smoke.delta_merge_source(cust)
    # two live rows (of 4) matched, two new keys past 6
    assert src.column("c_custkey").to_pylist() == [2, 5, 7, 8]
    sbal = [int(x) for x in chip_smoke.unscaled(src, "c_acctbal")]
    assert sbal == [-99999, -99962, -99925, -99888]
    got = chip_smoke.delta_versions_reference(cust)
    # v2: keys 1 and 4 deleted; v3: keys 2 and 5 (nation 0) at 0; v4:
    # keys 2 and 5 take the source's balance, 3 and 6 keep 300 + 600,
    # keys 7 and 8 join
    assert got == [(3, 600), (6, 2100), (4, 1600), (4, 900),
                   (6, sum(sbal) + 900), (6, sum(sbal) + 900)]
    orders = pa.table({
        "o_orderdate": pa.array([tpch.day("1992-03-01"),
                                 tpch.day("1998-07-01"),
                                 tpch.day("1992-12-31")], pa.int32()),
        "o_totalprice": tpch.dec_from_unscaled(
            np.array([5, 7, 11], np.int64), 15, 2)})
    supplier = pa.table({"s_suppkey": pa.array([1, 2], pa.int64()),
                         "s_name": pa.array(["a", None])})
    ref = chip_smoke.file_formats_reference(
        {"orders": orders, "customer": cust, "supplier": supplier})
    assert ref["by_year"][1992] == (2, 16) and ref["by_year"][1998] == (1, 7)
    assert ref["by_year"][1995] == (0, 0)
    assert ref["by_segment"] == {"AUTOMOBILE": (2, 500),
                                 "BUILDING": (3, 1100),
                                 "MACHINERY": (1, 500)}
    assert ref["iceberg"] == [(3, 600), (6, 2100)]
    assert ref["json"] == (b'{"s_suppkey": 1, "s_name": "a"}\n'
                           b'{"s_suppkey": 2, "s_name": null}\n')
    assert ref["hive_text"] == b"1\x01a\n2\x01\\N\n"


def test_partition_dirs_reject_a_stray_entry(tmp_path):
    for y in (1992, 1993):
        (tmp_path / f"o_year={y}").mkdir()
        (tmp_path / f"o_year={y}" / "part-00000-abc.parquet").write_bytes(
            b"x")
    (tmp_path / "_SUCCESS").write_bytes(b"")
    assert list(chip_smoke.partition_dirs(str(tmp_path))) == [1992, 1993]
    (tmp_path / "o_year=1993" / "stray.txt").write_bytes(b"x")
    with pytest.raises(AssertionError):
        chip_smoke.partition_dirs(str(tmp_path))
    (tmp_path / "o_year=1993" / "stray.txt").unlink()
    (tmp_path / "loose.parquet").write_bytes(b"x")
    with pytest.raises(AssertionError):
        chip_smoke.partition_dirs(str(tmp_path))


@pytest.mark.parametrize("what", ["year_sum", "delta_version", "json"])
def test_file_formats_checks_reject_a_wrong_reference(tpch_small, what):
    import spark_rapids_tpu_torch as pt
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    ref = chip_smoke.file_formats_reference(tpch_small)
    if what == "year_sum":
        n, x = ref["by_year"][1995]
        ref["by_year"][1995] = (n, x + 1)
    elif what == "delta_version":
        ref["delta"][3] = (ref["delta"][3][0], ref["delta"][3][1] - 1)
    else:
        ref["json"] = ref["json"].replace(b"Supplier", b"Supp1ier", 1)
    with pytest.raises(AssertionError):
        chip_smoke.file_formats_phase(s, tpch_small, ref)


def test_python_udfs_and_profiler_phases_rehearse_on_the_cpu(
        tpch_small, capsys, tmp_path, monkeypatch):
    """python_udfs and profiler over gen_all(0.01): every piece exact
    against numpy, no kernel launch off the card (the year exchange
    counted), the worker pools closed; the profiler's log, lore ids,
    trace shares, root counts and ANALYZE text as the card's run checks
    them, its temporary directory removed."""
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.exec import python_exec
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    ref = chip_smoke.PHASE_REFERENCES["python_udfs"](tpch_small)
    by_path = chip_smoke.python_udfs_phase(s, tpch_small, ref)
    assert by_path == {"python_udfs": {"all": 0, "vector": 0,
                                       "scalar": 0}}
    line = _phase_lines(capsys)["python_udfs"]
    assert line["check"] == "exact" and line["workers_spawned"] >= 1
    runs = line["runs"]
    assert runs["udf"]["bit_equal_compiled_host"]
    assert runs["apply_in_pandas"]["rows"] == 70      # 7 years x 10
    assert runs["apply_in_pandas"]["map_batches"] == 4
    assert runs["apply_in_pandas"]["numGroupChunks"] >= 1
    assert runs["agg_in_pandas"]["groups"] == 5
    assert runs["cogroup"]["groups"] == 25
    assert runs["to_torch"]["loss_after"] < runs["to_torch"]["loss_before"]
    assert set(line["wall_s"]) == {
        "udf_host_call", "udf_compiled", "df_udf", "map_in_pandas",
        "apply_in_pandas", "agg_in_pandas", "cogroup", "to_torch",
        "train"}
    assert python_exec.pool_stats()["pools"] == 0
    tables = tuple(tpch_small[k] for k in ("customer", "orders",
                                           "lineitem"))
    q3 = chip_smoke.q3_reference(*tables)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    chip_smoke.profiler_phase(s, tables, q3)
    line = _phase_lines(capsys)["profiler"]
    assert line["check"] == "exact"
    assert line["spans"] >= 4 and line["nodes"] >= 10
    assert abs(sum(line["trace_summary"]["share_pct"].values()) - 100) \
        <= 0.5
    assert line["root_counts"]["kernelLaunches"] == 0
    assert line["analyze"][0] == "== EXPLAIN ANALYZE =="
    assert os.listdir(tmp_path) == []


def test_python_udfs_and_profiler_checks_reject_a_fault(tpch_small,
                                                        monkeypatch):
    """The phases' checks fail on a wrong answer: a net price off by a
    cent, an op_metrics record lost, trace shares that do not add up."""
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.profiler import critical_path, event_log
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    ref = chip_smoke.PHASE_REFERENCES["python_udfs"](tpch_small)
    bad = dict(ref, net=ref["net"].copy())
    bad["net"][len(bad["net"]) // 2] += 0.01
    with pytest.raises(AssertionError, match="udf_host_call differs"):
        chip_smoke.python_udfs_phase(s, tpch_small, bad)
    tables = tuple(tpch_small[k] for k in ("customer", "orders",
                                           "lineitem"))
    q3 = chip_smoke.q3_reference(*tables)
    records = event_log.op_metrics_records
    monkeypatch.setattr(event_log, "op_metrics_records",
                        lambda *a, **k: records(*a, **k)[1:])
    with pytest.raises(AssertionError, match="lore ids"):
        chip_smoke.profiler_phase(s, tables, q3)
    monkeypatch.setattr(event_log, "op_metrics_records", records)
    summarize = critical_path.summarize

    def skewed(spans, wall_s=None):
        out = summarize(spans, wall_s)
        out["share_pct"]["compute"] += 5.0
        return out

    monkeypatch.setattr(critical_path, "summarize", skewed)
    with pytest.raises(AssertionError, match="trace shares"):
        chip_smoke.profiler_phase(s, tables, q3)


def test_witnesses_phase_rehearses_on_the_cpu(tpch_small, capsys,
                                              monkeypatch):
    """The witnesses phase over gen_all(0.01) in 4096-row batches, as
    the card runs it: the witnesses off at its start (the suite's are
    set aside), so it reads `group_by` and Q3 off first, then turns them
    on by conf in raise mode. The split group-by, Q3 (its joins shuffled
    here) and the degraded projection exact; one injection each where
    planned, the OOM split once, one batch recovered on the host; no
    lock-order, ledger or race finding; no kernel launch off the card;
    the witnesses it turned on off again and the plan cleared."""
    import spark_rapids_tpu_torch as pt
    from spark_rapids_tpu_torch.runtime import (faults, ledger, lockdep,
                                                racedep)
    monkeypatch.setattr(lockdep, "_WITNESS", None)
    monkeypatch.setattr(ledger, "_LEDGER", None)
    monkeypatch.setattr(racedep, "_WITNESS", None)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                      device="cpu")
    li = tpch_small["lineitem"]
    tables = tuple(tpch_small[k] for k in ("customer", "orders",
                                           "lineitem"))
    by_path = chip_smoke.witnesses_phase(
        s, tpch_small, chip_smoke.shipdate_reference(li),
        chip_smoke.q3_reference(*tables),
        q3_conf={"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1})
    assert by_path == {"witnesses_groupby_shipdate": {
        "all": 0, "vector": 0, "scalar": 0}}
    line = _phase_lines(capsys)["witnesses"]
    assert line["check"] == "exact"
    r = {x["name"]: x for x in line["readings"]}
    assert list(r) == ["groupby_shipdate", "q3", "degraded_projection"]
    assert r["groupby_shipdate"]["retry"]["splits"] == 1
    assert r["groupby_shipdate"]["injections"] == {"injected": 1,
                                                   "raise": 1}
    assert r["q3"]["injections"] == {}
    assert r["degraded_projection"]["recoveries"] == {"degradations": 1}
    assert set(line["cost_s"]) == {"groupby_shipdate", "q3"}
    for x in r.values():
        assert x["lockdep"]["findings"] == 0
        assert x["racedep"]["findings"] == 0
        assert x["ledger"]["balancedQueries"] >= 1
    assert (lockdep.witness(), ledger.ledger(), racedep.witness()) \
        == (None, None, None)
    assert not faults.ACTIVE


def _witness_reading(**over):
    r = {"name": "groupby_shipdate", "kind": "map_split",
         "lockdep": {"resources": 6, "orderEdges": 7, "acquires": 900,
                     "findings": 0},
         "ledger": {"kinds": {"permit": {"acquires": 40, "releases": 40},
                              "ride": {"acquires": 18, "releases": 18},
                              "spill_handle": {"acquires": 5,
                                               "releases": 3}},
                    "balancedQueries": 1, "imbalancedQueries": 0,
                    "findings": 0},
         "racedep": {"tracked": 80, "shared": 12, "accesses": 500,
                     "findings": 0},
         "planned": {"injected": 1, "raise": 1},
         "injections": {"injected": 1, "raise": 1},
         "retry": {"ooms": 1, "splits": 1, "retries": 0},
         "recoveries": {},
         "launches": {"all": 59, "vector": 59, "scalar": 0}}
    for k, v in over.items():
        r[k] = v
    return r


@pytest.mark.parametrize("fault", [
    "none", "finding", "imbalance", "query_imbalance", "race",
    "injection_off_by_one", "split_missing", "no_launches",
    "scalar_launch", "degrade_missing", "no_pool_witnessed"])
def test_witness_checks_reject_a_fault(fault):
    """`check_witness_reading` passes a clean reading and fails one with
    a lock-order finding, a strict kind out of balance, an unbalanced
    query, a race, an injection count off by one, recoveries unlike the
    injections, 0 launches on the card, a scalar launch, or a broadcast
    query whose pool nobody witnessed."""
    check = chip_smoke.check_witness_reading
    r = _witness_reading()
    lg = r["ledger"]
    bad = {
        "finding": dict(r, lockdep=dict(r["lockdep"], findings=1)),
        "imbalance": dict(r, ledger=dict(lg, kinds=dict(
            lg["kinds"], ride={"acquires": 18, "releases": 17}))),
        "query_imbalance": dict(r, ledger=dict(lg, imbalancedQueries=1)),
        "race": dict(r, racedep=dict(r["racedep"], findings=1)),
        "injection_off_by_one": dict(r, injections={"injected": 2,
                                                    "raise": 2}),
        "split_missing": dict(r, retry={"ooms": 1, "splits": 0,
                                        "retries": 0}),
        "no_launches": dict(r, launches={"all": 0, "vector": 0,
                                         "scalar": 0}),
        "scalar_launch": dict(r, launches={"all": 59, "vector": 58,
                                           "scalar": 1}),
        "degrade_missing": dict(r, name="degraded_projection",
                                kind="degrade", recoveries={}),
        "no_pool_witnessed": dict(
            r, name="q3", kind="broadcast", planned={}, injections={},
            ledger=dict(lg, kinds={"spill_handle": {"acquires": 2,
                                                    "releases": 2}})),
    }
    if fault == "none":
        check(r)
        check(dict(r, launches={"all": 0, "vector": 0, "scalar": 0}),
              "cpu")                  # off the card the plain version
        check(dict(r, name="degraded_projection", kind="degrade",
                   recoveries={"degradations": 1}))
        return
    with pytest.raises(AssertionError, match="witnesses"):
        check(bad[fault])
