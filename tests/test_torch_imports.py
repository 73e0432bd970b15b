"""The port stands alone: neither opentenbase_tpu_torch nor chip_smoke.py
imports jax or the reference package, and the port never runs on the
CPU unless the caller asks for it."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "opentenbase_tpu_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _subdirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "opentenbase_tpu")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT)
)
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import opentenbase_tpu_torch\n"
        "from opentenbase_tpu_torch import carry, engine\n"
        "from opentenbase_tpu_torch.ops import (\n"
        "    agg, cuda_build, expr, filter, join, radix_probe, scan_agg)\n"
        "from opentenbase_tpu_torch.plan import batchplan\n"
        "from opentenbase_tpu_torch.executor import fused, fused_dag, local\n"
        "bad = [m for m in sys.modules if m == 'opentenbase_tpu'\n"
        "       or m.startswith('opentenbase_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cluster_without_cuda_raises(monkeypatch):
    from opentenbase_tpu_torch import Cluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Cluster()
    assert Cluster(device="cpu").device.type == "cpu"


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor CUDA gets no silent fallback."""
    from opentenbase_tpu_torch import types as t
    from opentenbase_tpu_torch.ops import scan_agg as sa
    from opentenbase_tpu_torch.plan import texpr as E

    spec = sa.compile_spec([], None, [E.Col(0, t.INT8)])
    meta = torch.device("meta")
    col = torch.empty((1, 16), dtype=torch.int64, device=meta)
    ts = torch.empty((1, 1), dtype=torch.int64, device=meta)
    nrows = torch.empty((1,), dtype=torch.int64, device=meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        sa.scan_agg([col], ts, ts, nrows, 0, spec)


def test_radix_probe_wrapper_refuses_other_devices():
    from opentenbase_tpu_torch.ops import radix_probe as rp

    meta = torch.device("meta")
    P, B = 4, 8
    tk = torch.empty(P * B + 1, dtype=torch.int64, device=meta)
    tv = torch.empty(P * B + 1, dtype=torch.bool, device=meta)
    ti = torch.empty(P * B + 1, dtype=torch.int32, device=meta)
    pk = torch.empty(16, dtype=torch.int64, device=meta)
    pr = torch.empty(16, dtype=torch.bool, device=meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        rp.radix_probe(tk, tv, ti, pk, pr, P, B)
