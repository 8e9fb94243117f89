"""The python worker's side of `exec/python_exec.py`: the worker loop
and the picklable wrappers that group a pandas frame in the worker.

A spawned worker unpickles its entry point (`_worker_main`) and, with
the user's function, these wrappers by reference, so it imports this
module. The module imports only the standard library and pyarrow
(pandas inside the wrappers), and the package's `__init__` loads the
session lazily: a worker starts without torch and never touches CUDA.
The JAX package keeps these in its `exec/python_exec.py`; the port's
re-exports them there.
"""
from __future__ import annotations

import pickle

__all__ = ["_worker_main", "_GroupApply", "_AggApply", "_CoGroupApply"]


def _worker_main(conn):
    """Worker loop: (pickled fn) once, then per message an Arrow IPC
    stream -> fn(pandas DataFrame) -> Arrow IPC stream back. Protocol:
    ("fn", bytes) | ("batch", bytes) -> ("ok", bytes) | ("err", str)
    | ("stop",)."""
    import pyarrow as pa
    fn = None
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        kind = msg[0]
        if kind == "stop":
            return
        try:
            if kind == "fn":
                fn = pickle.loads(msg[1])
                conn.send(("ok", b""))
                continue
            with pa.ipc.open_stream(msg[1]) as rd:
                at = rd.read_all()
            out = fn(at.to_pandas())
            res = pa.Table.from_pandas(out, preserve_index=False)
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, res.schema) as w:
                w.write_table(res)
            conn.send(("ok", sink.getvalue().to_pybytes()))
        except BaseException as e:  # noqa: BLE001 — shipped to parent
            try:
                conn.send(("err", f"{type(e).__name__}: {e}"))
            except Exception:
                return


class _GroupApply:
    """Picklable worker-side wrapper: whole groups arrive inside one
    partition (repartitioned by key); the worker groups the pandas frame
    and applies the user fn per group (FlatMapGroupsInPandas semantics —
    reference: GpuFlatMapGroupsInPandasExec)."""

    def __init__(self, fn, keys, drop_keys: bool = False):
        self.fn = fn
        self.keys = list(keys)
        self.drop_keys = drop_keys

    def __call__(self, pdf):
        import pandas as pd
        outs = []
        for _k, g in pdf.groupby(self.keys, dropna=False, sort=False):
            if self.drop_keys:
                g = g.drop(columns=self.keys)
            out = self.fn(g)
            if out is not None and len(out):
                outs.append(out)
        if not outs:
            return pd.DataFrame()
        return pd.concat(outs, ignore_index=True)


class _AggApply:
    """Picklable worker-side wrapper for AggregateInPandas: one output
    row per group — key columns + one scalar per named aggregate
    (reference: GpuAggregateInPandasExec.scala:51)."""

    def __init__(self, aggs, keys):
        self.aggs = aggs       # {out_name: (fn, [col, ...])}
        self.keys = list(keys)

    def __call__(self, pdf):
        import pandas as pd
        rows = []
        for kv, g in pdf.groupby(self.keys, dropna=False, sort=False):
            if not isinstance(kv, tuple):
                kv = (kv,)
            row = dict(zip(self.keys, kv))
            for name, (fn, cols) in self.aggs.items():
                row[name] = fn(*[g[c] for c in cols])
            rows.append(row)
        if not rows:
            return pd.DataFrame()
        return pd.DataFrame(rows)


class _CoGroupApply:
    """Picklable worker-side wrapper for FlatMapCoGroupsInPandas: the
    two sides arrive concatenated with a __side marker; groups match on
    key EQUALITY across sides (missing side -> empty frame)."""

    def __init__(self, fn, lkeys, rkeys, lcols, rcols):
        self.fn = fn
        self.lkeys = list(lkeys)
        self.rkeys = list(rkeys)
        self.lcols = list(lcols)
        self.rcols = list(rcols)

    def __call__(self, pdf):
        import pandas as pd
        left = pdf[pdf["__side"] == 0][self.lcols]
        right = pdf[pdf["__side"] == 1][self.rcols]
        lg = {k: g for k, g in left.groupby(self.lkeys, dropna=False,
                                            sort=False)}
        rg = {k: g for k, g in right.groupby(self.rkeys, dropna=False,
                                             sort=False)}
        outs = []
        for k in list(lg.keys()) + [k for k in rg if k not in lg]:
            gl = lg.get(k, left.iloc[0:0])
            gr = rg.get(k, right.iloc[0:0])
            out = self.fn(gl, gr)
            if out is not None and len(out):
                outs.append(out)
        if not outs:
            return pd.DataFrame()
        return pd.concat(outs, ignore_index=True)
