"""The query scope: which query the current thread works for.

The part of the JAX package's `service/query_manager.py` (`:178-195`)
that the memory runtime and the witnesses need: the memory managers,
the resource ledger and the per-query attribution of
`memory/diagnostics.py` read `current_query_id()` to tag reservations
without threading a context through every call site.
`DataFrame._action` opens `_query_scope(qid)` on the calling thread
around its own steps and the caller around its execution of the plan,
and the pools that work for an action (the exchange's map pool, the
broadcast build pool, the async writer) carry it to their workers. No
scope stays open across a generator's `yield`: the consumer, and
whatever runs before the generator resumes, keep their own query id. The
query manager itself (admission, cancellation, deadlines, the
service-level retry) comes with ROADMAP A.15.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

__all__ = ["current_query_id", "_query_scope"]

_TLS = threading.local()


def current_query_id() -> Optional[str]:
    return getattr(_TLS, "query_id", None)


class _query_scope:
    """Tags the dynamic extent of a query's execution on this thread."""

    def __init__(self, query_id: Optional[str]):
        self.query_id = query_id

    def __enter__(self):
        self._prev = getattr(_TLS, "query_id", None)
        _TLS.query_id = self.query_id
        return self

    def __exit__(self, *exc):
        _TLS.query_id = self._prev
        return False

    @contextlib.contextmanager
    def suspended(self):
        """The scope closed for the block and opened again after it
        (on the thread that resumes): a generator yields inside it."""
        self.__exit__()
        try:
            yield
        finally:
            self.__enter__()
