"""`TpuSession.set_conf` and `builder_get_or_create` in the port against
the JAX package's (`session.py:62-69`): the session made last is the one
the builder returns, a new one only when none was made, with the conf
given then and not later; a key set on a session reaches the actions
planned after it, on a DataFrame made before it too."""
import pyarrow as pa
import pytest

import spark_rapids_tpu as st
import spark_rapids_tpu.functions as JF
import spark_rapids_tpu_torch as pt
import spark_rapids_tpu_torch.functions as PF
from spark_rapids_tpu.expr.expressions import UnsupportedExpr as JUnsupported
from spark_rapids_tpu_torch.config import BATCH_SIZE_ROWS
from spark_rapids_tpu_torch.expr.expressions import (
    UnsupportedExpr as PUnsupported)

KEY = "spark.rapids.tpu.sql.batchSizeRows"


@pytest.fixture
def no_active(monkeypatch):
    monkeypatch.setattr(st.TpuSession, "_active", None)
    monkeypatch.setattr(pt.TpuSession, "_active", None)


def test_builder_makes_one_session_then_returns_the_last(no_active):
    made = {}
    for name, S, kw in (("jax", st.TpuSession, {}),
                        ("port", pt.TpuSession, {"device": "cpu"})):
        first = S.builder_get_or_create({KEY: 128}, **kw)
        again = S.builder_get_or_create({KEY: 999}, **kw)
        assert again is first, name
        newer = S({KEY: 7}, **kw)
        made[name] = (first, newer, S.builder_get_or_create(**kw))
    for name, (first, newer, got) in made.items():
        assert got is newer, name
    jf, pf = made["jax"][0], made["port"][0]
    from spark_rapids_tpu.config import BATCH_SIZE_ROWS as JBATCH
    assert jf.conf.get(JBATCH) == pf.conf.get(BATCH_SIZE_ROWS) == 128


def test_set_conf_reaches_later_actions(no_active):
    data = pa.table({"s": pa.array(["a%", "b", None])})
    for S, F, err, kw in ((st.TpuSession, JF, JUnsupported, {}),
                          (pt.TpuSession, PF, PUnsupported,
                           {"device": "cpu"})):
        s = S({}, **kw)
        df = s.create_dataframe(data).select(
            F.rlike(F.col("s"), r"a*?").alias("m"))
        assert df.to_arrow().column("m").to_pylist() == [True, True, None]
        s.set_conf("spark.rapids.tpu.sql.allowCpuFallback", False)
        with pytest.raises(err):
            df.to_arrow()
        s.set_conf("spark.rapids.tpu.sql.allowCpuFallback", True)
        assert df.to_arrow().num_rows == 3


def test_set_conf_keeps_other_keys():
    from spark_rapids_tpu import config as jconf
    from spark_rapids_tpu_torch import config as pconf
    for S, C, kw in ((st.TpuSession, jconf, {}),
                     (pt.TpuSession, pconf, {"device": "cpu"})):
        s = S({KEY: 64}, **kw)
        before = s.conf
        s.set_conf("spark.rapids.tpu.sql.join.bloomFilter.enabled", True)
        assert s.conf.get(C.JOIN_BLOOM_ENABLED) is True
        assert s.conf.get(C.BATCH_SIZE_ROWS) == 64
        assert before.get(C.JOIN_BLOOM_ENABLED) is False
