"""The PyTorch port stands alone: it never imports JAX or the JAX
package, and its entry point runs on CUDA unless asked for the CPU."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "spark_rapids_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_no_jax_import_in_port_or_chip_smoke():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "partition_kernel_ab.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def test_q6_in_a_fresh_process_loads_no_jax():
    code = r"""
import json, sys
import spark_rapids_tpu_torch as pt
from spark_rapids_tpu_torch.workloads import tpch
s = pt.TpuSession({"spark.rapids.tpu.sql.batchSizeRows": 4096},
                  device="cpu")
df = s.create_dataframe(tpch.gen_lineitem(0.002, seed=1))
rev = tpch.q6(df).to_arrow().column(0)[0].as_py()
part = df.select("l_shipdate").repartition(8, "l_shipdate").to_arrow()
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "spark_rapids_tpu"))
print(json.dumps({"rev": str(rev), "rows": part.num_rows, "mods": mods}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["mods"] == []
    assert out["rows"] == 12002
    assert out["rev"] not in ("None", "")


def test_session_defaults_to_cuda_and_raises_without_it():
    import spark_rapids_tpu_torch as pt
    if torch.cuda.is_available():
        assert pt.TpuSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.TpuSession()
    assert pt.TpuSession(device="cpu").device.type == "cpu"
