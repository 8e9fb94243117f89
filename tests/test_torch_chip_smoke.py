"""chip_smoke.py's readers of the compiler's output and its kernel bound,
on listings in the formats nvcc's `-Xptxas -v` and `cuobjdump -sass`
print. They run on the card only inside chip_smoke.py, so they are
checked here on fixed text."""
import sys
from pathlib import Path

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
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 1024},
                      device="cpu")
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
    tables, _ = q3_small
    q, _ = _q3_port(tables, {})
    root = q.last_plan()
    assert chip_smoke.check_q3_plan(root, shuffled=False)[
        "broadcast_exchanges"] == 2
    with pytest.raises(AssertionError, match="shuffled"):
        chip_smoke.check_q3_plan(root, shuffled=True)
    q, _ = _q3_port(tables, {
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1})
    shape = chip_smoke.check_q3_plan(q.last_plan(), shuffled=True)
    assert [j["per_partition"] for j in shape["joins"]] == [True, True]


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
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096,
                       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold":
                       -1}, device="cpu")
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
