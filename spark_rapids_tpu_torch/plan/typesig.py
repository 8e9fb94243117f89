"""TypeSig: per-expression supported-type signatures, the plan-time
gate of the port's binders.

The port's copy of the JAX package's `plan/typesig.py` (reference:
TypeChecks.scala:125 TypeSig algebra). A TypeSig is a set of supported
DataType classes; each expression class is registered with the
signature of its primary input, exactly as the JAX registry has it, so
both packages send the same expressions to the host fallback.
`check_tree` walks a bound tree at each bind site of `plan/logical.py`
and raises `UnsupportedExpr` with the JAX package's text and bind-site
suffix; `AUDIT_CHECKS` holds the narrower kernel-truth refinements the
plan auditor (`analysis/audit.py`) reads; `generate_supported_ops()`
returns the supported-expressions table as text and writes no file.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Type

from ..columnar import dtypes as dt

__all__ = ["TypeSig", "SIGS", "register", "check", "check_tree",
           "AUDIT_CHECKS", "audit_register", "audit_check",
           "generate_supported_ops"]


class TypeSig:
    def __init__(self, *classes: Type[dt.DataType], note: str = ""):
        self.classes = tuple(classes)
        self.note = note

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(*(self.classes + other.classes),
                       note=self.note or other.note)

    def supports(self, dtype: dt.DataType) -> bool:
        return isinstance(dtype, self.classes)

    def describe(self) -> str:
        names = sorted({c.__name__.replace("Type", "")
                        for c in self.classes})
        s = ", ".join(names)
        return f"{s} ({self.note})" if self.note else s


BOOL = TypeSig(dt.BooleanType)
INTEGRAL = TypeSig(dt.ByteType, dt.ShortType, dt.IntegerType, dt.LongType)
FLOATING = TypeSig(dt.FloatType, dt.DoubleType)
DECIMAL = TypeSig(dt.DecimalType,
                  note="up to 38 digits (exact decimal128 kernels); "
                       "see docs/compatibility.md")
NUMERIC = INTEGRAL + FLOATING + DECIMAL
DATETIME = TypeSig(dt.DateType, dt.TimestampType)
STRING = TypeSig(dt.StringType, dt.BinaryType)
NULL = TypeSig(dt.NullType)
ALL_COMMON = NUMERIC + DATETIME + STRING + BOOL + NULL

# expression class name -> (input TypeSig, description)
SIGS: Dict[str, Tuple[TypeSig, str]] = {}


def register(name: str, sig: TypeSig, desc: str = ""):
    SIGS[name] = (sig, desc)


def _at(where: str = "", lore_id=None) -> str:
    """Render the bind-site context suffix for check errors: the node
    path of the failing bind site (and, when the audit pass supplies
    one, the lore id) instead of just the expression name."""
    parts = []
    if lore_id is not None:
        parts.append(f"loreId={lore_id}")
    if where:
        parts.append(f"at {where}")
    return f" [{', '.join(parts)}]" if parts else ""


def check(name: str, dtype: dt.DataType, what: str = "",
          where: str = "", lore_id=None):
    from ..expr.expressions import UnsupportedExpr
    ent = SIGS.get(name)
    if ent is not None and not ent[0].supports(dtype):
        raise UnsupportedExpr(
            f"{what or name} does not support input type {dtype} on TPU "
            f"(supported: {ent[0].describe()})" + _at(where, lore_id))


def check_tree(expr, where: str = ""):
    """Uniform binder gate: walk a BOUND expression tree and check each
    node's primary input (first child) dtype against its registered
    signature (reference: TypeChecks.tagExprForGpu, TypeChecks.scala:716
    — there per-parameter; here the subject input, with later params
    enforced by the binders). Unregistered nodes pass — signatures are
    deliberately no STRICTER than the binders, so this adds uniform
    error text and the docs table without shadowing real support.
    `where` names the bind site (logical node + role) for error text."""
    if expr is None:
        return expr
    name = type(expr).__name__
    ent = SIGS.get(name)
    kids = getattr(expr, "children", None) or []
    if ent is not None and kids:
        cdt = getattr(kids[0], "dtype", None)
        if cdt is not None and not ent[0].supports(cdt):
            from ..expr.expressions import UnsupportedExpr
            raise UnsupportedExpr(
                f"{name} does not support input type {cdt} on TPU "
                f"(supported: {ent[0].describe()})" + _at(where))
    for c in kids:
        check_tree(c, where)
    return expr


# -- audit checks -------------------------------------------------------
# Kernel-truth refinements NARROWER than the bind-time signatures: the
# binders accept these shapes, but the device kernels cannot actually run
# them (dtype layouts the emit path mishandles, decimal/timezone edges).
# The plan auditor (analysis/audit.py) evaluates them pre-execution and
# turns what used to be an opaque mid-query XLA/Arrow error into a
# plan-time `will_not_work` verdict. Each entry: expression class name
# -> (fn(dtype) -> reason-or-None, doc note).
AUDIT_CHECKS: Dict[str, Tuple[Callable[[dt.DataType], Optional[str]],
                              str]] = {}


def audit_register(name: str, fn: Callable[[dt.DataType], Optional[str]],
                   note: str = ""):
    AUDIT_CHECKS[name] = (fn, note)


def audit_check(name: str, dtype: dt.DataType) -> Optional[str]:
    """Reason this (expression, primary-input dtype) pair will NOT work
    at runtime despite binding, or None when no audit rule objects."""
    ent = AUDIT_CHECKS.get(name)
    if ent is None or dtype is None:
        return None
    return ent[0](dtype)


# -- registry (mirrors the expression surface; the binders stay the
# source of truth for enforcement, this drives docs + uniform errors) ----
for _n in ("Add", "Subtract", "Multiply", "Divide", "IntDivide",
           "Remainder", "Pmod", "Negate", "Abs", "Round"):
    register(_n, NUMERIC, "arithmetic")
for _n in ("Eq", "Ne", "Lt", "Le", "Gt", "Ge", "EqNullSafe"):
    register(_n, ALL_COMMON, "comparison")
for _n in ("And", "Or", "Not"):
    register(_n, BOOL, "boolean")
NESTED = TypeSig(dt.ArrayType, dt.MapType, dt.StructType)
for _n in ("IsNull", "IsNotNull"):
    register(_n, ALL_COMMON + NESTED, "null test (validity only)")
for _n in ("Coalesce", "If", "CaseWhen", "In"):
    register(_n, ALL_COMMON, "conditional (no nested branches)")
register("IsNaN", FLOATING, "NaN test")
for _n in ("BitwiseAnd", "BitwiseOr", "BitwiseXor", "BitwiseNot",
           "ShiftLeft", "ShiftRight"):
    register(_n, INTEGRAL, "bitwise")
for _n in ("MathUnary", "Pow", "Atan2"):
    register(_n, NUMERIC, "double math")
for _n in ("Length", "Upper", "Lower", "Substring", "ConcatStr",
           "Contains", "StartsWith", "EndsWith", "Like", "Trim",
           "Reverse", "Instr", "Pad", "Repeat", "ConcatWs"):
    register(_n, STRING, "string")
for _n in ("RLike", "RegexpExtract", "RegexpReplace"):
    register(_n, STRING,
             "regex (NFA subset; others run via CPU fallback)")
register("Cast", ALL_COMMON, "cast matrix per docs/compatibility.md")
for _n in ("Sum", "Min", "Max"):
    register(_n, NUMERIC + DATETIME + BOOL + NULL, "aggregate")
for _n in ("Count", "CountStar"):
    register(_n, ALL_COMMON + NESTED, "aggregate over any type")
for _n in ("First", "Last"):
    register(_n, NUMERIC + DATETIME + BOOL + STRING + NULL,
             "aggregate; string/binary via the sort-collect path")
DEC64 = TypeSig(dt.DecimalType, note="precision <= 18 only")
for _n in ("Avg", "VarianceSamp", "StddevSamp", "Variance", "Stddev"):
    register(_n, INTEGRAL + FLOATING + DEC64 + BOOL + NULL,
             "aggregate; decimal limited to p<=18 "
             "(sum/count explicitly for p>18)")
register("Greatest", NUMERIC + DATETIME + STRING, "n-ary minmax")
register("Least", NUMERIC + DATETIME + STRING, "n-ary minmax")
for _n in ("Size", "GetArrayItem", "ElementAt", "ArrayContains",
           "SortArray", "Explode", "PosExplode", "ArrayTransform",
           "ArrayFilter", "ArrayExists", "ArrayForAll", "ArrayAggregate"):
    register(_n, TypeSig(dt.ArrayType, dt.MapType), "collection")
for _n in ("CreateArray", "CreateNamedStruct"):
    register(_n, ALL_COMMON + NESTED, "nested constructor")
register("GetStructField", TypeSig(dt.StructType), "struct extractor")
for _n in ("MapKeys", "MapValues"):
    register(_n, TypeSig(dt.MapType), "map extractor")
for _n in ("ArrayMin", "ArrayMax"):
    register(_n, TypeSig(dt.ArrayType),
             "numeric/temporal elements; decimal p<=18")
register("CountDistinct", ALL_COMMON,
         "exact distinct count via segmented sort")
register("ApproxCountDistinct", ALL_COMMON,
         "HyperLogLog++ sketch, O(2^p) state; rsd -> p in [4,12] "
         "(docs/compatibility.md: 32-bit hash, no bias table)")
for _n in ("Percentile", "Median"):
    register(_n, INTEGRAL + FLOATING,
             "exact rank selection via segmented sort")
register("ApproxPercentile", INTEGRAL + FLOATING,
         "t-digest sketch, O(C) centroid state; float64 interpolated "
         "results (docs/compatibility.md)")
for _n in ("CollectList", "CollectSet"):
    register(_n, ALL_COMMON,
             "aggregate -> array<T>; requires GROUP BY (sort-collect)")

register("BloomFilterAggregate", ALL_COMMON,
         "Bloom filter build, fixed num_bits bit-vector state "
         "(ungrouped; reference GpuBloomFilterAggregate)")
register("BloomFilterMightContain", ALL_COMMON,
         "membership probe against a foldable bloom_filter_agg result")

# -- datetime fields / arithmetic ---------------------------------------
DATE = TypeSig(dt.DateType)
TS = TypeSig(dt.TimestampType)
for _n in ("Year", "Quarter", "Month", "DayOfMonth", "DayOfWeek",
           "DayOfYear"):
    register(_n, DATETIME, "datetime field extraction")
for _n in ("Hour", "Minute", "Second"):
    register(_n, TS, "time field extraction")
for _n in ("DateAdd", "DateSub", "LastDay"):
    register(_n, DATE, "date arithmetic")
register("DateDiff", DATE, "day difference")
register("ToDate", STRING + DATE + TS,
         "string parse per format (docs/compatibility.md pattern subset)")
register("ToTimestamp", STRING + DATE + TS,
         "string parse per format (docs/compatibility.md pattern subset)")
for _n in ("FromUTCTimestamp", "ToUTCTimestamp"):
    register(_n, TS, "TZif-backed zone conversion (utils/tzdb)")

# -- JSON / URL ---------------------------------------------------------
register("GetJsonObject", STRING,
         "device byte-tape for scalar paths; wildcard paths via CPU "
         "bridge (docs/compatibility.md)")
register("FromJson", STRING,
         "schema-driven; runs via CPU bridge (host row interpreter)")
register("ToJson", ALL_COMMON + NESTED,
         "runs via CPU bridge (host row interpreter)")
register("ParseUrl", STRING,
         "runs via CPU bridge (host row interpreter)")

# -- misc ---------------------------------------------------------------
register("Murmur3Hash", ALL_COMMON,
         "Spark-compatible murmur3_x86_32, device kernel")
register("XxHash64", ALL_COMMON,
         "Spark-compatible xxhash64 (seed 42, int64), device kernel; "
         "strings exact under 32 bytes (docs/compatibility.md)")
register("HiveHash", ALL_COMMON,
         "Hive 31-polynomial hashCode (int32), device kernel")
register("Literal", ALL_COMMON + NESTED, "constant")
register("Alias", ALL_COMMON + NESTED, "name binding (pass-through)")
register("ColumnRef", ALL_COMMON + NESTED, "column reference")
register("PyUDF", ALL_COMMON,
         "AST-compiled to expressions when possible, else a host "
         "call over numpy (udf-compiler analog)")
register("WindowExpr", NUMERIC + DATETIME + STRING + BOOL + NULL,
         "window function over its input column; ranking functions "
         "take no input (per-function frame rules enforced at bind)")


# -- audit refinements (see AUDIT_CHECKS above) -------------------------
def _no_decimal128(path_desc: str):
    def chk(d: dt.DataType) -> Optional[str]:
        if isinstance(d, dt.DecimalType) and d.is_decimal128:
            return (f"{path_desc} reads the flat unscaled int64 buffer, "
                    f"but decimal precision > 18 travels as two-limb "
                    f"[cap, 2] pairs (ops/decimal128.py) — the result "
                    f"shape breaks downstream kernels")
        return None
    return chk


audit_register("MathUnary", _no_decimal128("the double-math path"),
               "decimal limited to precision <= 18")


def generate_supported_ops() -> str:
    lines = ["# Supported expressions (TPU)",
             "",
             "Generated from the TypeSig registry "
             "(`spark_rapids_tpu_torch/plan/typesig.py`), the analog of the "
             "reference's docs/supported_ops.md from TypeChecks.",
             "",
             "Expression | Supported input types | Notes",
             "-----------|----------------------|------"]
    for name in sorted(SIGS):
        sig, desc = SIGS[name]
        lines.append(f"{name} | {sig.describe()} | {desc}")
    return "\n".join(lines) + "\n"
