"""Column functions (`import spark_rapids_tpu_torch.functions as F`): the
port's copy of the JAX package's `functions.py`, pyspark.sql.functions
naming.

Every public name of the JAX module is here. The aggregates, the null,
condition and math functions, the string functions, the hash functions,
the date and time functions, the time-zone conversions, the array,
struct and map functions, explode, the higher-order functions,
collect_list / collect_set, grouping_id, the window functions (to call
`.over(spec)` on, `window.py`), bloom_filter_agg and might_contain, and
the regex, JSON and URL functions build the port's expressions, and
udf and df_udf wrap Python functions (`expr/udf.py`).
"""
from __future__ import annotations

from .expr import aggregates as _agg
from .expr import collection_exprs as _ce
from .expr import datetime_exprs as _de
from .expr import string_exprs as _se
from .expr.expressions import (Abs, CaseWhen, Cast, Coalesce,  # noqa: F401
                               ColumnRef, EqNullSafe, Expression, Greatest,
                               If, In, IsNaN, IsNull, Least, Literal,
                               MathUnary, Negate, Pmod, Round, col, lit)
from .expr.udf import df_udf, udf  # noqa: F401  (public re-exports)

__all__ = [
    "col", "lit", "sum", "count", "countDistinct", "count_distinct", "min",
    "max", "avg", "mean", "first", "last", "stddev", "stddev_samp",
    "variance", "var_samp", "approx_count_distinct", "percentile",
    "percentile_approx", "median", "when", "coalesce", "isnull", "isnan",
    "abs", "sqrt", "exp", "log", "log10", "log2", "floor", "ceil", "round",
    "greatest", "least", "pmod", "negate", "signum",
    "length", "upper", "lower", "substring", "concat", "contains",
    "startswith", "endswith", "like", "trim", "ltrim", "rtrim", "reverse",
    "instr", "locate", "lpad", "rpad", "repeat", "concat_ws",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "shiftleft", "shiftright", "pow", "atan2",
    "hash", "xxhash64", "hive_hash",
    "year", "month", "dayofmonth", "dayofweek", "dayofyear", "quarter",
    "hour", "minute", "second", "date_add", "date_sub", "datediff",
    "last_day", "to_date", "to_timestamp", "from_utc_timestamp",
    "to_utc_timestamp", "array", "struct", "named_struct", "get_field",
    "size", "element_at", "array_contains", "array_min", "array_max",
    "sort_array", "map_keys", "map_values", "explode", "explode_outer",
    "posexplode", "posexplode_outer", "transform", "filter", "exists",
    "forall", "aggregate", "collect_list", "collect_set", "grouping_id",
    "row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
    "ntile", "lag", "lead", "first_value", "last_value", "nth_value",
    "bloom_filter_agg", "might_contain", "rlike", "regexp_extract",
    "regexp_replace", "get_json_object", "from_json", "to_json",
    "parse_url", "udf", "df_udf",
]


def sum(e):  # noqa: A001 - match pyspark naming
    return _agg.Sum(_to_expr(e))


def count(e):
    if isinstance(e, str) and e == "*":
        return _agg.CountStar()
    return _agg.Count(_to_expr(e))


def countDistinct(e):
    return _agg.CountDistinct(_to_expr(e))


count_distinct = countDistinct


def min(e):  # noqa: A001
    return _agg.Min(_to_expr(e))


def max(e):  # noqa: A001
    return _agg.Max(_to_expr(e))


def avg(e):
    return _agg.Avg(_to_expr(e))


mean = avg


def first(e, ignorenulls=False):
    return _agg.First(_to_expr(e), ignorenulls)


def last(e, ignorenulls=False):
    return _agg.Last(_to_expr(e), ignorenulls)


def stddev(e):
    return _agg.Stddev(_to_expr(e))


stddev_samp = stddev


def variance(e):
    return _agg.Variance(_to_expr(e))


var_samp = variance


def approx_count_distinct(e, rsd: float = 0.05):
    return _agg.ApproxCountDistinct(_to_expr(e), rsd)


def percentile(e, percentages, frequency=1):
    return _agg.Percentile(_to_expr(e), percentages)


def percentile_approx(e, percentages, accuracy: int = 10000):
    return _agg.ApproxPercentile(_to_expr(e), percentages, accuracy)


def median(e):
    return _agg.Median(_to_expr(e))


def _to_expr(e) -> Expression:
    if isinstance(e, Expression):
        return e
    if isinstance(e, str):
        return col(e)
    return lit(e)


class _WhenBuilder:
    """`when(c, v).when(...).otherwise(d)`; an unfinished chain serves as
    the CASE WHEN without ELSE (null)."""

    def __init__(self, branches):
        self._branches = branches

    def when(self, cond, value):
        return _WhenBuilder(self._branches + [(_to_expr(cond),
                                               _to_expr(value))])

    def otherwise(self, value):
        return CaseWhen(self._branches, _to_expr(value))

    def __getattr__(self, item):
        return getattr(CaseWhen(self._branches, None), item)


def when(cond, value):
    return _WhenBuilder([(_to_expr(cond), _to_expr(value))])


def coalesce(*exprs):
    return Coalesce(*[_to_expr(e) for e in exprs])


def isnull(e):
    return IsNull(_to_expr(e))


def isnan(e):
    return IsNaN(_to_expr(e))


def abs(e):  # noqa: A001
    return Abs(_to_expr(e))


def negate(e):
    return Negate(_to_expr(e))


def _math(name):
    def fn(e):
        return MathUnary(name, _to_expr(e))
    fn.__name__ = name
    return fn


sqrt = _math("sqrt")
exp = _math("exp")
log = _math("log")
log10 = _math("log10")
log2 = _math("log2")
floor = _math("floor")
ceil = _math("ceil")
signum = _math("signum")


def round(e, scale=0):  # noqa: A001
    return Round(_to_expr(e), scale)


def greatest(*es):
    return Greatest(*[_to_expr(e) for e in es])


def least(*es):
    return Least(*[_to_expr(e) for e in es])


def pmod(a, b):
    return Pmod(_to_expr(a), _to_expr(b))


def length(e):
    return _se.Length(_to_expr(e))


def upper(e):
    return _se.Upper(_to_expr(e))


def lower(e):
    return _se.Lower(_to_expr(e))


def substring(e, start, length=None):
    return _se.Substring(_to_expr(e), start, length)


def concat(*es):
    return _se.ConcatStr(*[_to_expr(e) for e in es])


def _to_pattern(p):
    # a pattern argument is a literal, not a column name
    return Literal(p) if isinstance(p, (str, bytes)) else _to_expr(p)


def contains(e, pattern):
    return _se.Contains(_to_expr(e), _to_pattern(pattern))


def startswith(e, pattern):
    return _se.StartsWith(_to_expr(e), _to_pattern(pattern))


def endswith(e, pattern):
    return _se.EndsWith(_to_expr(e), _to_pattern(pattern))


def like(e, pattern: str):
    return _se.Like(_to_expr(e), pattern)


def trim(e):
    return _se.Trim(_to_expr(e))


def ltrim(e):
    return _se.Trim(_to_expr(e), left=True, right=False)


def rtrim(e):
    return _se.Trim(_to_expr(e), left=False, right=True)


def reverse(e):
    return _se.Reverse(_to_expr(e))


def instr(e, sub):
    return _se.Instr(_to_expr(e), _to_pattern(sub))


def locate(sub, e):
    return _se.Instr(_to_expr(e), _to_pattern(sub))


def lpad(e, length, pad=" "):
    return _se.Pad(_to_expr(e), length, pad, left=True)


def rpad(e, length, pad=" "):
    return _se.Pad(_to_expr(e), length, pad, left=False)


def repeat(e, n):
    return _se.Repeat(_to_expr(e), n)


def concat_ws(sep, *es):
    return _se.ConcatWs(sep, *[_to_expr(e) for e in es])


def bitwise_and(a, b):
    from .expr.expressions import BitwiseAnd
    return BitwiseAnd(_to_expr(a), _to_expr(b))


def bitwise_or(a, b):
    from .expr.expressions import BitwiseOr
    return BitwiseOr(_to_expr(a), _to_expr(b))


def bitwise_xor(a, b):
    from .expr.expressions import BitwiseXor
    return BitwiseXor(_to_expr(a), _to_expr(b))


def bitwise_not(a):
    from .expr.expressions import BitwiseNot
    return BitwiseNot(_to_expr(a))


def shiftleft(a, b):
    from .expr.expressions import ShiftLeft
    return ShiftLeft(_to_expr(a), _to_expr(b))


def shiftright(a, b):
    from .expr.expressions import ShiftRight
    return ShiftRight(_to_expr(a), _to_expr(b))


def pow(a, b):  # noqa: A001
    from .expr.expressions import Pow
    return Pow(_to_expr(a), _to_expr(b))


def atan2(a, b):
    from .expr.expressions import Atan2
    return Atan2(_to_expr(a), _to_expr(b))


def hash(*cols):  # noqa: A001 - pyspark naming
    from .expr.hash_expr import Murmur3Hash
    return Murmur3Hash([_to_expr(c) for c in cols])


def xxhash64(*cols):
    from .expr.hash_expr import XxHash64
    return XxHash64([_to_expr(c) for c in cols])


def hive_hash(*cols):
    from .expr.hash_expr import HiveHash
    return HiveHash([_to_expr(c) for c in cols])


def year(e):
    return _de.Year(_to_expr(e))


def month(e):
    return _de.Month(_to_expr(e))


def dayofmonth(e):
    return _de.DayOfMonth(_to_expr(e))


def dayofweek(e):
    return _de.DayOfWeek(_to_expr(e))


def dayofyear(e):
    return _de.DayOfYear(_to_expr(e))


def quarter(e):
    return _de.Quarter(_to_expr(e))


def hour(e):
    return _de.Hour(_to_expr(e))


def minute(e):
    return _de.Minute(_to_expr(e))


def second(e):
    return _de.Second(_to_expr(e))


def date_add(e, days):
    return _de.DateAdd(_to_expr(e), _to_expr(days))


def date_sub(e, days):
    return _de.DateSub(_to_expr(e), _to_expr(days))


def datediff(end, start):
    return _de.DateDiff(_to_expr(end), _to_expr(start))


def last_day(e):
    return _de.LastDay(_to_expr(e))


def to_date(e):
    return _de.ToDate(_to_expr(e))


def to_timestamp(e):
    return _de.ToTimestamp(_to_expr(e))


def from_utc_timestamp(e, tz: str):
    return _de.FromUTCTimestamp(_to_expr(e), tz)


def to_utc_timestamp(e, tz: str):
    return _de.ToUTCTimestamp(_to_expr(e), tz)


# ----------------------------------------------------------------------
# arrays, structs and maps
# ----------------------------------------------------------------------
def array(*es):
    return _ce.CreateArray([_to_expr(e) for e in es])


def struct(*es):
    """A struct of the given columns: a field is named by its alias or
    column name, else col<i>."""
    from .expr.expressions import Alias
    names, children = [], []
    for i, e in enumerate(es):
        ex = _to_expr(e)
        if isinstance(ex, Alias):
            names.append(ex.name)
            children.append(ex.child)
        elif isinstance(ex, ColumnRef):
            names.append(ex.name)
            children.append(ex)
        else:
            names.append(f"col{i + 1}")
            children.append(ex)
    return _ce.CreateNamedStruct(names, children)


def named_struct(*pairs):
    names = [pairs[i] for i in range(0, len(pairs), 2)]
    children = [_to_expr(pairs[i]) for i in range(1, len(pairs), 2)]
    return _ce.CreateNamedStruct(names, children)


def get_field(e, name: str):
    return _ce.GetStructField(_to_expr(e), name)


def size(e):
    return _ce.Size(_to_expr(e))


def element_at(e, key):
    return _ce.ElementAt(_to_expr(e), key)


def array_contains(e, value):
    return _ce.ArrayContains(_to_expr(e), value)


def array_min(e):
    return _ce.ArrayMin(_to_expr(e))


def array_max(e):
    return _ce.ArrayMax(_to_expr(e))


def sort_array(e, asc: bool = True):
    return _ce.SortArray(_to_expr(e), asc)


def map_keys(e):
    return _ce.MapKeys(_to_expr(e))


def map_values(e):
    return _ce.MapValues(_to_expr(e))


def explode(e):
    return _ce.Explode(_to_expr(e))


def explode_outer(e):
    g = _ce.Explode(_to_expr(e))
    g.outer = True
    return g


def posexplode(e):
    return _ce.PosExplode(_to_expr(e))


def posexplode_outer(e):
    g = _ce.PosExplode(_to_expr(e))
    g.outer = True
    return g


def transform(e, fn):
    return _ce.ArrayTransform(_to_expr(e), fn)


def filter(e, fn):  # noqa: A001 - pyspark naming
    return _ce.ArrayFilter(_to_expr(e), fn)


def exists(e, fn):
    return _ce.ArrayExists(_to_expr(e), fn)


def forall(e, fn):
    return _ce.ArrayForAll(_to_expr(e), fn)


def aggregate(e, zero, merge):
    return _ce.ArrayAggregate(_to_expr(e), zero, merge)


def collect_list(e):
    return _agg.CollectList(_to_expr(e))


def collect_set(e):
    return _agg.CollectSet(_to_expr(e))


def grouping_id():
    """Marker for a rollup / cube / grouping_sets agg list: the row's
    grouping-set id column."""
    from .session import GroupingID
    return GroupingID()


# -- window functions (pyspark-style re-exports of `window.py`) --------
def row_number():
    from . import window as _w
    return _w.row_number()


def rank():
    from . import window as _w
    return _w.rank()


def dense_rank():
    from . import window as _w
    return _w.dense_rank()


def percent_rank():
    from . import window as _w
    return _w.percent_rank()


def cume_dist():
    from . import window as _w
    return _w.cume_dist()


def ntile(n: int):
    from . import window as _w
    return _w.ntile(n)


def lag(e, offset: int = 1, default=None):
    from . import window as _w
    return _w.lag(_to_expr(e), offset, default)


def lead(e, offset: int = 1, default=None):
    from . import window as _w
    return _w.lead(_to_expr(e), offset, default)


def first_value(e):
    from . import window as _w
    return _w.first_value(_to_expr(e))


def last_value(e):
    from . import window as _w
    return _w.last_value(_to_expr(e))


def nth_value(e, n: int):
    from . import window as _w
    return _w.nth_value(_to_expr(e), n)


# ----------------------------------------------------------------------
# the bloom filter (ROADMAP A.9)
# ----------------------------------------------------------------------
def bloom_filter_agg(e, estimated_items: int = 1_000_000,
                     num_bits: int = None):
    """A Bloom filter over the column (reference:
    GpuBloomFilterAggregate); returns BinaryType. Probe with
    might_contain."""
    return _agg.BloomFilterAggregate(_to_expr(e), estimated_items,
                                     num_bits)


def might_contain(filter_e, value_e):
    """Membership probe against a bloom_filter_agg result (reference:
    GpuBloomFilterMightContain)."""
    from .expr.hash_expr import BloomFilterMightContain
    return BloomFilterMightContain(_to_expr(filter_e), _to_expr(value_e))


# ----------------------------------------------------------------------
# regex, JSON and URL (ROADMAP A.10)
# ----------------------------------------------------------------------
def rlike(e, pattern: str):
    from .expr.regex_exprs import RLike
    return RLike(_to_expr(e), pattern)


def regexp_extract(e, pattern: str, idx: int = 0):
    from .expr.regex_exprs import RegexpExtract
    return RegexpExtract(_to_expr(e), pattern, idx)


def regexp_replace(e, pattern: str, replacement: str):
    from .expr.regex_exprs import RegexpReplace
    return RegexpReplace(_to_expr(e), pattern, replacement)


def get_json_object(e, path: str):
    from .expr.json_exprs import GetJsonObject
    return GetJsonObject(_to_expr(e), path)


def from_json(e, schema):
    from .expr.json_exprs import FromJson
    return FromJson(_to_expr(e), schema)


def to_json(e):
    from .expr.json_exprs import ToJson
    return ToJson(_to_expr(e))


def parse_url(e, part: str, key=None):
    from .expr.json_exprs import ParseUrl
    return ParseUrl(_to_expr(e), part, key)
