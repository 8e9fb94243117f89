"""The port's resource ledger (`runtime/ledger.py`): balanced counters
when an action ends in every state, cross-thread release attribution,
the poison fill catching a seeded use-after-release, holder dumps on
budget exhaustion, and real queries run balanced with the ledger on (the
conftest's `SRTPU_LEDGER=1` turns the port's ledger on too). Each test
mirrors one of the JAX package's `tests/test_ledger.py`; the JAX
`QueryManager._finalize` check is `DataFrame._action`'s in the port
(ROADMAP C.44), so those tests drive an action."""
import threading

import numpy as np
import pyarrow as pa
import pytest

import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as F
from spark_rapids_tpu_torch import session as psession
from spark_rapids_tpu_torch.runtime import ledger
from spark_rapids_tpu_torch.service.query_manager import (_query_scope,
                                                          current_query_id)

STATES = ("FINISHED", "CANCELLED", "TIMED_OUT", "FAILED")


def test_witness_enabled_for_suite():
    # the conftest env gate armed the port's ledger at import
    assert ledger.enabled()
    assert ledger.ledger().report()["enabled"] is True


# ---------------------------------------------------------------------
# constructed ledgers (local Ledger instances: the process ledger must
# stay finding-free for the whole suite)
# ---------------------------------------------------------------------
def test_balanced_query_passes_every_terminal_state():
    lg = ledger.Ledger(raise_on_finding=True)
    for state in STATES:
        qid = f"q-{state}"
        with _query_scope(qid):
            lg.acquired("staging_lease", 4096, token=("t", qid),
                        tag="PinnedStagingPool.acquire")
            lg.acquired("permit", tag="TpuSemaphore.acquire")
            lg.released("permit")
            lg.released("staging_lease", token=("t", qid))
        lg.query_end(qid, state)   # must not raise
    assert lg.balanced_queries == 4 and lg.findings == []
    assert lg.report()["balanceOk"] is True


def test_leak_raises_with_holder_attribution():
    lg = ledger.Ledger(raise_on_finding=True)
    with _query_scope("q-leak"):
        lg.acquired("staging_lease", 8192, token="tok1",
                    tag="PinnedStagingPool.acquire")
    with pytest.raises(ledger.ResourceLeakError) as ei:
        lg.query_end("q-leak", "CANCELLED")
    msg = str(ei.value)
    assert "q-leak" in msg and "CANCELLED" in msg
    assert "staging_lease=+1" in msg
    assert "PinnedStagingPool.acquire" in msg   # the holder's site tag
    assert lg.imbalanced_queries == 1
    assert lg.findings[0]["kind"] == "query-imbalance"
    assert lg.findings[0]["counts"] == {"staging_lease": 1}


def test_leak_recorded_without_raise_when_configured():
    lg = ledger.Ledger(raise_on_finding=False)
    with _query_scope("q-soft"):
        lg.acquired("ride", tag="PermitRider.step")
    lg.query_end("q-soft", "TIMED_OUT")   # records, no raise
    assert lg.findings and lg.report()["balanceOk"] is False


def test_parkable_kinds_are_tracked_but_not_asserted():
    """Spill handles park in reusable exchange state past query end, and
    byte reservations follow them: tracked, never raised on."""
    lg = ledger.Ledger(raise_on_finding=True)
    with _query_scope("q-park"):
        lg.acquired("spill_handle", 1 << 20, token="h1",
                    tag="SpillStore.add_batch")
        lg.acquired("device_bytes", 1 << 20, tag="DeviceManager.reserve")
        lg.acquired("host_bytes", 1 << 10, tag="HostMemoryManager.reserve")
    lg.query_end("q-park", "FINISHED")    # must not raise
    assert lg.balanced_queries == 1
    assert lg.outstanding("spill_handle") == 1
    lg.released("spill_handle", token="h1")
    lg.released("device_bytes", 1 << 20)
    assert lg.outstanding("spill_handle") == 0
    assert lg.outstanding("device_bytes") == 0


def test_cross_thread_release_credits_acquiring_query():
    """A lease acquired on a worker inside the query scope and released
    by a thread with no query scope still balances the acquiring
    query's ledger (the holder registry pins the query id)."""
    lg = ledger.Ledger(raise_on_finding=True)

    def acquire_side():
        with _query_scope("q-xthread"):
            lg.acquired("staging_lease", 4096, token="xt1",
                        tag="PinnedStagingPool.acquire")

    t = threading.Thread(target=acquire_side, name="tpu-prefetch-0")
    t.start()
    t.join()
    assert lg.query_balance("q-xthread") == {"staging_lease": 1}
    lg.released("staging_lease", token="xt1")   # main thread, no scope
    assert lg.query_balance("q-xthread") == {}
    lg.query_end("q-xthread", "FINISHED")
    assert lg.balanced_queries == 1


def test_untracked_release_is_idempotent_safe():
    """A double close, and a release of what was acquired before the
    ledger came on, never drive the counters negative."""
    lg = ledger.Ledger()
    lg.acquired("spill_handle", 64, token="h")
    lg.released("spill_handle", token="h")
    lg.released("spill_handle", token="h")      # double close
    lg.released("spill_handle", token="ghost")  # never tracked
    d = lg.dump()["kinds"]["spill_handle"]
    assert d["outstanding"] == 0
    assert d["releases"] == 1 and d["untrackedReleases"] == 2


def test_dump_attributes_holders_by_thread_name():
    lg = ledger.Ledger()

    def holder():
        with _query_scope("q-dump"):
            lg.acquired("staging_lease", 2048, token="d1",
                        tag="PinnedStagingPool.acquire")

    t = threading.Thread(target=holder, name="tpu-test-holder")
    t.start()
    t.join()
    d = lg.dump()
    assert d["holders"][0]["thread"] == "tpu-test-holder"
    assert d["holders"][0]["query"] == "q-dump"
    text = ledger.format_dump(d)
    assert "thread=tpu-test-holder" in text
    assert "query=q-dump" in text
    assert "PinnedStagingPool.acquire" in text


def test_budget_exhaustion_carries_the_holders(monkeypatch):
    """A device reservation that cannot fit raises BudgetExceeded with
    the outstanding holders folded into its message."""
    import torch

    from spark_rapids_tpu_torch.memory.device import (BudgetExceeded,
                                                      DeviceManager)
    lg = ledger.Ledger()
    monkeypatch.setattr(ledger, "_LEDGER", lg)
    with _query_scope("q-full"):
        lg.acquired("staging_lease", 4096, token="k1",
                    tag="PinnedStagingPool.acquire")
        dm = DeviceManager(1000, device=torch.device("cpu"))
        dm.reserve(600)
        with pytest.raises(BudgetExceeded) as ei:
            dm.reserve(600)
    assert ei.value.ledger_dump is not None
    assert "resource ledger:" in str(ei.value)
    assert "device_bytes: outstanding=1 bytes=600" in str(ei.value)
    assert "PinnedStagingPool.acquire" in str(ei.value)
    # idempotent: a second attach must not stack another dump
    assert ledger.attach_dump(ei.value) is None
    dm.release(600)


# ---------------------------------------------------------------------
# poison mode: a seeded use-after-release reads deterministic garbage
# ---------------------------------------------------------------------
def test_poison_fill_catches_seeded_use_after_release():
    from spark_rapids_tpu_torch.memory.host import PinnedStagingPool
    lg = ledger.ledger()
    assert lg is not None
    was = lg.poison
    lg.poison = True
    try:
        pool = PinnedStagingPool(1 << 20)
        lease = pool.acquire(1024)
        stale = np.frombuffer(lease.array, np.uint8)  # aliasing view,
        # kept past release: the seeded bug shape
        lease.view()[:4] = b"\x01\x02\x03\x04"
        lease.release()
        # the recycled buffer reads 0xAB everywhere, not our payload
        assert stale[0] == ledger.POISON_BYTE
        assert bool((stale == ledger.POISON_BYTE).all())
        # and the next lease of the bucket starts poisoned
        again = pool.acquire(1024)
        assert again.array[0] == ledger.POISON_BYTE
        again.release()
    finally:
        lg.poison = was


def test_no_poison_by_default_for_suite():
    # the suite runs the ledger for accounting, poison off
    assert ledger.poison_enabled() is False


def test_poison_from_conf_on_a_live_ledger():
    lg = ledger.ledger()
    was = lg.poison
    try:
        pt.TpuSession({"spark.rapids.tpu.sql.debug.ledger.poison": True},
                      device="cpu")
        assert ledger.poison_enabled()
    finally:
        lg.poison = was


# ---------------------------------------------------------------------
# the action's end asserts the balance (JAX QueryManager._finalize)
# ---------------------------------------------------------------------
def _df():
    s = pt.TpuSession(device="cpu")
    return s.create_dataframe(
        pa.table({"v": pa.array(np.arange(512), pa.int64())}))


def _leak_in_collect(monkeypatch, fresh, fail=None):
    """collect_to_arrow, inside the action, takes a staging lease it
    never returns (and raises `fail` when given)."""
    orig = psession.collect_to_arrow

    def leaking(root, ctx):
        fresh.acquired("staging_lease", 4096, token=("leak", id(ctx)),
                       tag="PinnedStagingPool.acquire")
        if fail is not None:
            raise fail
        return orig(root, ctx)

    monkeypatch.setattr(psession, "collect_to_arrow", leaking)


def test_action_end_raises_leak_on_clean_query(monkeypatch):
    """An action that finishes with an unreleased query-scoped resource
    fails loudly when it ends, instead of silent pool starvation."""
    fresh = ledger.Ledger(raise_on_finding=True)
    monkeypatch.setattr(ledger, "_LEDGER", fresh)
    _leak_in_collect(monkeypatch, fresh)
    with pytest.raises(ledger.ResourceLeakError, match="staging_lease"):
        _df().to_arrow()
    assert fresh.findings[0]["state"] == "FINISHED"
    assert current_query_id() is None        # the scope closed


def test_action_end_never_masks_the_original_error(monkeypatch):
    """On a failed action the imbalance is recorded as a finding, and the
    original error stays the action's error."""
    fresh = ledger.Ledger(raise_on_finding=True)
    monkeypatch.setattr(ledger, "_LEDGER", fresh)
    _leak_in_collect(monkeypatch, fresh, fail=ValueError("user error"))
    with pytest.raises(ValueError, match="user error"):
        _df().to_arrow()
    assert fresh.findings[0]["state"] == "FAILED"
    assert fresh.findings[0]["counts"] == {"staging_lease": 1}


def test_terminal_states_all_checked(monkeypatch):
    """Finished and failed actions both pass through the balance check
    (balanced queries count up for each)."""
    fresh = ledger.Ledger(raise_on_finding=True)
    monkeypatch.setattr(ledger, "_LEDGER", fresh)
    df = _df()
    df.to_arrow()
    df.count()

    def failing(root, ctx):
        raise ValueError("failed in the action")

    monkeypatch.setattr(psession, "collect_to_arrow", failing)
    with pytest.raises(ValueError):
        df.to_arrow()
    assert fresh.balanced_queries == 3
    assert fresh.findings == []


def test_pool_workers_carry_the_query_scope(monkeypatch):
    """Permits and rides taken on the exchange's map workers, and the
    broadcast build's reservations, are the action's: every `permit` and
    `ride` acquisition names the action's query (a release on any thread
    credits it), and the query ends balanced."""
    fresh = ledger.Ledger(raise_on_finding=True)
    monkeypatch.setattr(ledger, "_LEDGER", fresh)
    seen = []
    orig = fresh.acquired

    def acquired(kind, nbytes=0, token=None, tag=None):
        seen.append((kind, current_query_id(),
                     threading.current_thread().name))
        return orig(kind, nbytes, token, tag)

    monkeypatch.setattr(fresh, "acquired", acquired)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 256,
                       "spark.rapids.tpu.sql.exec.exchange.mapThreads": 4,
                       "spark.rapids.tpu.sql.shuffle.partitions": 4},
                      device="cpu")
    rng = np.random.default_rng(3)
    at = pa.table({"k": pa.array(rng.integers(0, 9, 3000), pa.int64()),
                   "v": pa.array(rng.integers(0, 99, 3000), pa.int64())})
    small = pa.table({"k": pa.array(np.arange(9), pa.int64()),
                      "n": pa.array(np.arange(9) * 10, pa.int64())})
    df = s.create_dataframe(at)
    q = (df.repartition(5, "k").join(s.create_dataframe(small), on=["k"])
         .group_by("k").agg(F.sum("v").alias("sv"), F.max("n").alias("n")))
    out = q.to_arrow()
    assert out.num_rows == 9
    pooled = [r for r in seen if r[0] in ("permit", "ride")
              and r[2].startswith("tpu-exch-map")]
    assert pooled, seen
    qids = {r[1] for r in seen if r[0] in ("permit", "ride")}
    assert len(qids) == 1 and None not in qids
    assert fresh.balanced_queries == 1 and fresh.findings == []


def test_interleaved_partition_streams_keep_their_own_query_ids(
        monkeypatch):
    """Two result streams (a writer's source, `_iter_partition_tables`)
    advanced in turn on one thread, and a third abandoned and closed on
    another thread: each stream's acquisitions name its own query, no
    query id stays on a thread between the yields, and every query ends
    balanced."""
    fresh = ledger.Ledger(raise_on_finding=True)
    monkeypatch.setattr(ledger, "_LEDGER", fresh)
    seen = []
    current = [None]
    orig = fresh.acquired

    def acquired(kind, nbytes=0, token=None, tag=None):
        if kind == "permit":
            seen.append((current[0], current_query_id()))
        return orig(kind, nbytes, token, tag)

    monkeypatch.setattr(fresh, "acquired", acquired)
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 256,
                       "spark.rapids.tpu.sql.shuffle.partitions": 3},
                      device="cpu")
    rng = np.random.default_rng(5)
    at = pa.table({"k": pa.array(rng.integers(0, 9, 2000), pa.int64()),
                   "v": pa.array(rng.integers(0, 99, 2000), pa.int64())})
    streams = {name: s.create_dataframe(at).repartition(3, "k")
               ._iter_partition_tables() for name in "abc"}
    rows = {"a": 0, "b": 0}
    live = ["a", "b"]
    while live:
        for name in list(live):
            current[0] = name
            t = next(streams[name], None)
            current[0] = None
            assert current_query_id() is None
            if t is None:
                live.remove(name)
            else:
                rows[name] += t.num_rows
    assert rows == {"a": 2000, "b": 2000}
    current[0] = "c"
    assert next(streams["c"]).num_rows > 0
    current[0] = None
    closer = threading.Thread(target=streams["c"].close)
    closer.start()
    closer.join()
    assert current_query_id() is None
    by_stream = {}
    for name, qid in seen:
        by_stream.setdefault(name, set()).add(qid)
    assert set(by_stream) == {"a", "b", "c"}, seen
    assert all(len(q) == 1 and None not in q for q in by_stream.values())
    assert len(set.union(*by_stream.values())) == 3
    assert fresh.balanced_queries == 3 and fresh.findings == []


# ---------------------------------------------------------------------
# the payoff: real queries under the process ledger
# ---------------------------------------------------------------------
def test_real_query_runs_balanced():
    lg = ledger.ledger()
    before = lg.report()
    s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 256},
                      device="cpu")
    at = pa.table({
        "k": pa.array(np.arange(2000) % 9, type=pa.int64()),
        "v": pa.array(np.random.default_rng(3).normal(0, 1, 2000)),
    })
    out = (s.create_dataframe(at).group_by(F.col("k"))
           .agg(F.sum(F.col("v")).alias("sv")).to_arrow())
    assert out.num_rows == 9
    after = lg.report()
    assert after["balancedQueries"] > before["balancedQueries"]
    assert after["findings"] == before["findings"]
    # query-scoped kinds fully returned (parkable kinds may stay out)
    for kind in ledger.STRICT_KINDS:
        assert lg.outstanding(kind) == 0, kind


def test_ledger_metrics_surface_in_root_metrics():
    s = pt.TpuSession(device="cpu")
    at = pa.table({"v": pa.array(np.arange(512), type=pa.int64())})
    q = s.create_dataframe(at).agg(F.sum(F.col("v")).alias("s"))
    q.to_arrow()
    m = q.last_metrics()[q.last_plan()._op_id]
    assert m.get("ledgerBalanced") == 1
    assert "ledgerPeakLeases" in m
    text = q.explain("ANALYZE")
    assert "ledger[" in text and "balanced=yes" in text
