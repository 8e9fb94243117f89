"""JSON and URL expressions: get_json_object, from_json, to_json,
parse_url.

The port of the JAX package's `expr/json_exprs.py` (reference:
GpuGetJsonObject.scala / GpuJsonToStructs.scala / GpuStructsToJson.scala
via JNI JSONUtils; GpuParseUrl.scala via JNI ParseURI). A scalar
get_json_object path (field and index steps) runs on the device over the
byte tape (`ops/json_tape.py`); a wildcard path, and every from_json,
to_json and parse_url, goes to the host interpreter through the CPU
bridge: bind() raises UnsupportedExpr, the planner keeps the unbound
tree under `sql.allowCpuFallback` (`!cpu`), and the rows evaluate on the
host between device stages (`expr/host_eval.py`). `SRTPU_JSON_HOST=1`
sends get_json_object to the host as well, as in the JAX package.
`parse_json_path`, `walk_json_path` and `render_json_value` are the JAX
module's plain-Python helpers, copied.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ..columnar import dtypes as dt
from .expressions import Expression, UnsupportedExpr, _wrap

__all__ = ["GetJsonObject", "FromJson", "ToJson", "ParseUrl",
           "parse_json_path", "walk_json_path", "render_json_value"]


def parse_json_path(path: str) -> List[Tuple[str, object]]:
    """Parse a Spark get_json_object path ($.a.b[0]['c'][*]) into steps:
    ("field", name) | ("index", i) | ("wild", None)."""
    if not path or path[0] != "$":
        raise ValueError(f"JSON path must start with $: {path!r}")
    steps: List[Tuple[str, object]] = []
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            j = i + 1
            while j < n and path[j] not in ".[":
                j += 1
            name = path[i + 1:j]
            if name == "*":
                steps.append(("wild", None))
            elif name:
                steps.append(("field", name))
            else:
                raise ValueError(f"empty field in path {path!r}")
            i = j
        elif c == "[":
            j = path.index("]", i)
            tok = path[i + 1:j].strip()
            if tok == "*":
                steps.append(("wild", None))
            elif tok.startswith(("'", '"')) and tok.endswith(tok[0]):
                steps.append(("field", tok[1:-1]))
            else:
                steps.append(("index", int(tok)))
            i = j + 1
        else:
            raise ValueError(f"bad JSON path at {i}: {path!r}")
    return steps


def walk_json_path(obj, steps):
    """Apply parsed steps; returns a list of matches (wildcards fan
    out)."""
    cur = [obj]
    for kind, arg in steps:
        nxt = []
        for o in cur:
            if kind == "field":
                if isinstance(o, dict) and arg in o:
                    nxt.append(o[arg])
                elif isinstance(o, list):
                    # Spark: a field step over an array maps over elems
                    for e in o:
                        if isinstance(e, dict) and arg in e:
                            nxt.append(e[arg])
            elif kind == "index":
                if isinstance(o, list) and -len(o) <= arg < len(o):
                    nxt.append(o[arg])
            else:  # wild
                if isinstance(o, list):
                    nxt.extend(o)
                elif isinstance(o, dict):
                    nxt.extend(o.values())
        cur = nxt
        if not cur:
            return []
    return cur


def render_json_value(v) -> str:
    """Jackson-style rendering: bare scalars unquoted, containers as
    compact JSON."""
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return None
    if isinstance(v, (int, float)):
        return json.dumps(v)
    return json.dumps(v, separators=(",", ":"))


class _HostOnlyExpr(Expression):
    """An expression that always routes to the CPU bridge."""

    _reason = "host-bridge expression"

    def bind(self, schema):
        raise UnsupportedExpr(self._reason)


class GetJsonObject(Expression):
    """SCALAR paths (field/index steps) evaluate ON DEVICE via the byte-
    tape tokenizer (ops/json_tape.py, the analog of the reference's JNI
    JSONUtils.getJsonObject kernel); wildcard paths route to the CPU
    bridge. SRTPU_JSON_HOST=1 forces the host path (tests use it to
    cross-check both)."""

    host_dtype = dt.STRING

    def __init__(self, child: Expression, path: str):
        self.children = [_wrap(child)]
        self.path = path
        self.steps = parse_json_path(path)

    def bind(self, schema):
        from ..ops.json_tape import device_path_supported
        if os.environ.get("SRTPU_JSON_HOST") == "1" \
                or not device_path_supported(self.steps):
            raise UnsupportedExpr(
                "get_json_object wildcard path runs on the CPU bridge")
        b = GetJsonObject(self.children[0].bind(schema), self.path)
        if not isinstance(b.children[0].dtype, dt.StringType):
            raise UnsupportedExpr("get_json_object over non-string")
        b.dtype = dt.STRING
        return b

    def emit(self, ctx):
        from ..ops.json_tape import get_json_object_tape
        cv = self.children[0].emit(ctx)
        # the result is a slice of the input: its byte buffer bounds it
        return get_json_object_tape(cv, self.steps,
                                    out_data_capacity=cv.data.shape[0])

    @property
    def name(self):
        return f"get_json_object({self.children[0].name}, {self.path})"

    def __repr__(self):
        return f"get_json_object({self.children[0]!r}, {self.path!r})"


class FromJson(_HostOnlyExpr):
    _reason = "from_json runs on the CPU bridge"

    def __init__(self, child: Expression, schema: dt.DataType):
        if not isinstance(schema, (dt.StructType, dt.ArrayType,
                                   dt.MapType)):
            raise ValueError("from_json needs a struct/array/map dtype")
        self.children = [_wrap(child)]
        self.host_dtype = schema

    @property
    def name(self):
        return f"from_json({self.children[0].name})"

    def __repr__(self):
        return f"from_json({self.children[0]!r}, {self.host_dtype})"


class ToJson(_HostOnlyExpr):
    _reason = "to_json runs on the CPU bridge"
    host_dtype = dt.STRING

    def __init__(self, child: Expression):
        self.children = [_wrap(child)]

    @property
    def name(self):
        return f"to_json({self.children[0].name})"

    def __repr__(self):
        return f"to_json({self.children[0]!r})"


_URL_PARTS = ("HOST", "PATH", "QUERY", "REF", "PROTOCOL", "FILE",
              "AUTHORITY", "USERINFO")


class ParseUrl(_HostOnlyExpr):
    _reason = "parse_url runs on the CPU bridge"
    host_dtype = dt.STRING

    def __init__(self, child: Expression, part: str,
                 key: Optional[str] = None):
        if part not in _URL_PARTS:
            raise ValueError(f"parse_url part must be one of "
                             f"{_URL_PARTS}, got {part!r}")
        self.children = [_wrap(child)]
        self.part = part
        self.key = key

    @property
    def name(self):
        return f"parse_url({self.children[0].name}, {self.part})"

    def __repr__(self):
        return f"parse_url({self.children[0]!r}, {self.part!r})"
