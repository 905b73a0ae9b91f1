"""The port stands alone: no JAX, nothing of the JAX package, no quiet CPU
fallback.

* every module of ``repro_torch`` imports, and a CPU predict runs, in a
  process where ``jax`` and ``repro`` cannot be imported;
* an AST scan of ``src/repro_torch/`` and ``chip_smoke.py`` finds no
  ``jax`` / ``repro`` import;
* an entry point called with no ``device`` raises when CUDA is missing;
* ``impl="cuda"`` on CPU tensors raises (the kernel has no CPU form);
* ``chip_smoke.py`` fails, printing no result, without a card or alone.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_imports_and_predicts_without_jax():
    script = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        import numpy as np
        from repro_torch.core.dsekl import DSEKLConfig
        from repro_torch.serving import DSEKLPredictionEngine
        rng = np.random.default_rng(0)
        x = rng.standard_normal((50, 4)).astype(np.float32)
        eng = DSEKLPredictionEngine(DSEKLConfig(), rng.standard_normal(50),
                                    x, device="cpu")
        eng.submit(x[:7])
        (f,) = eng.flush_async()
        assert f.shape == (7,) and bool(f.isfinite().all())
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m, v in sys.modules.items() if v is not None)
        assert "triton" not in sys.modules
        print("ISOLATED_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "ISOLATED_OK" in out.stdout


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_cuda_without_a_device(monkeypatch):
    from repro_torch.convert import state_from_jax
    from repro_torch.core.dsekl import DSEKLConfig, init_state
    from repro_torch.data import make_covertype_like
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.serving import DSEKLPredictionEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((4, 2), np.float32)
    arrays = {"alpha": np.zeros(4), "accum": np.ones(4), "step": 0,
              "epoch": 0}
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda:0"),
        lambda: init_state(4),
        lambda: make_covertype_like(8),
        lambda: DSEKLPredictionEngine(DSEKLConfig(), np.ones(4), x),
        lambda: state_from_jax(arrays),
        lambda: serve.serve_dsekl(serve.parser().parse_args(
            ["--dsekl", "--n-train", "8", "--queries", "4"])),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    assert init_state(4, device="cpu").alpha.device.type == "cpu"


def test_cuda_impl_on_cpu_tensors_raises(monkeypatch):
    from repro_torch.core.dsekl import DSEKLConfig, decision_function
    from repro_torch.kernels.dsekl import block, ops

    g = torch.Generator().manual_seed(0)
    x, z = torch.randn(5, 3, generator=g), torch.randn(9, 3, generator=g)
    a = torch.randn(9, generator=g)
    before = block.kernel_matvec_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.kernel_matvec(x, z, a, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.kernel_matvec_tiled(x, z, a, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        block.kernel_matvec_cuda(x, z, a)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        decision_function(DSEKLConfig(impl="cuda"), a, z, x)
    monkeypatch.setenv("REPRO_TORCH_IMPL", "cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ops.kernel_matvec(x, z, a)
    assert block.kernel_matvec_cuda.launches == before


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_card(alone, tmp_path):
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _run_smoke(cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
