"""The port's `functions.py` has every public name of the JAX package's
`functions.py`. Each name that builds an expression in the port does so
without raising; each that the port does not implement yet raises
NotPorted, and its message names the ROADMAP item that ports it. The
array, struct and map functions, explode, the higher-order functions,
collect_list / collect_set and grouping_id (ROADMAP A.5), the window
functions (A.6), bloom_filter_agg and might_contain (A.9), and the regex,
JSON and URL functions (A.10), and udf and df_udf (A.12) build since
they were ported: their cases moved from WAITING to the building side,
one case a name as before. No name waits now.
"""
import inspect
import re

import pytest

import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu_torch.columnar import dtypes as pdt
from spark_rapids_tpu_torch.errors import NotPorted

PUBLIC = sorted(n for n in dir(JF) if not n.startswith("_")
                and not inspect.ismodule(getattr(JF, n))
                and n != "annotations")

#: the entries that wait, by ROADMAP item
WAITING = {}
ITEM_OF = {n: item for item, names in WAITING.items() for n in names}

#: arguments for the ported functions that take more than one column
ARGS = {"round": ("x", 2), "lpad": ("x", 5, "*"), "rpad": ("x", 5),
        "repeat": ("x", 2), "concat_ws": ("|", "x", "y"),
        "date_add": ("x", 1), "date_sub": ("x", 1),
        "from_utc_timestamp": ("x", "UTC"),
        "to_utc_timestamp": ("x", "UTC"), "substring": ("x", 1, 2),
        "instr": ("x", "a"), "locate": ("a", "x"), "contains": ("x", "a"),
        "startswith": ("x", "a"), "endswith": ("x", "a"),
        "like": ("x", "a%"), "when": ("x", 1), "percentile": ("x", 0.5),
        "percentile_approx": ("x", 0.5),
        "transform": ("x", lambda v: v + 1),
        "filter": ("x", lambda v: v > 0),
        "exists": ("x", lambda v: v > 0),
        "forall": ("x", lambda v: v > 0),
        "aggregate": ("x", 0, lambda acc, v: acc + v),
        "ntile": (4,), "nth_value": ("x", 2), "lag": ("x",),
        "lead": ("x",), "regexp_replace": ("x", "a+", "b"),
        "regexp_extract": ("x", "(a)b", 1), "get_json_object": ("x", "$.a"),
        "from_json": ("x", pdt.StructType((pdt.StructField("a",
                                                          pdt.INT64),))),
        "parse_url": ("x", "QUERY", "k"),
        "bloom_filter_agg": ("x", 1000),
        "udf": (lambda v: v + 1, pdt.INT64), "df_udf": (lambda v: v + 1,)}

#: the UDF factories: what they return builds an expression of a column
FACTORIES = ("udf", "df_udf")


def test_every_public_name_exists():
    missing = [n for n in PUBLIC if not hasattr(PF, n)]
    assert not missing, missing


@pytest.mark.parametrize("name", PUBLIC)
def test_each_name_builds_or_names_its_item(name):
    fn = getattr(PF, name)
    if name in ITEM_OF:
        with pytest.raises(NotPorted) as e:
            fn("x", "y")
        assert re.search(rf"ROADMAP {re.escape(ITEM_OF[name])}\b",
                         str(e.value)), str(e.value)
        return
    if inspect.isclass(fn) or not callable(fn):
        return      # the re-exported expression classes and constants
    args = ARGS.get(name)
    if args is None:
        params = inspect.signature(fn).parameters.values()
        star = any(p.kind == p.VAR_POSITIONAL for p in params)
        need = sum(1 for p in params if p.default is p.empty
                   and p.kind in (p.POSITIONAL_ONLY,
                                  p.POSITIONAL_OR_KEYWORD))
        args = ("x", "y") if star else ("x", "y")[:need]
    out = fn(*args)
    if name in FACTORIES:
        assert isinstance(out("x"), PF.Expression)
