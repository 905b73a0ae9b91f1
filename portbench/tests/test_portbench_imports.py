"""The benchmark loads neither JAX nor the JAX package ``repro`` (compared
by whole top-level name: ``repro_torch`` is the port), and its plain
reference and data generators import nothing of the port."""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from portbench.harness import guard, spec

SOURCES = sorted(p for p in spec.PORTBENCH.rglob("*.py"))
STANDALONE = sorted(p for d in ("reference", "data")
                    for p in (spec.PORTBENCH / d).glob("*.py"))


def imported_top_levels(path: pathlib.Path) -> set:
    """The top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= guard.top_level(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names |= guard.top_level([node.module])
    return names


def test_portbench_top_level_compares_whole_names():
    assert guard.top_level(["repro_torch.core.dsekl"]) == {"repro_torch"}
    assert guard.top_level(["repro.core"]) & guard.FORBIDDEN == {"repro"}
    assert guard.top_level(["jaxlib.xla_client"]) & guard.FORBIDDEN \
        == {"jaxlib"}
    assert not guard.top_level(["repro_torch", "jax_free"]) & guard.FORBIDDEN


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(spec.ROOT)) for p in SOURCES])
def test_portbench_module_imports_no_jax(path):
    assert not imported_top_levels(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", STANDALONE,
                         ids=[str(p.relative_to(spec.ROOT))
                              for p in STANDALONE])
def test_portbench_reference_imports_nothing_of_the_port(path):
    got = imported_top_levels(path)
    assert not got & (guard.FORBIDDEN | {"repro_torch", "portbench"})


def test_portbench_loading_every_piece_loads_no_jax():
    """In a fresh process: every module of the benchmark, every kind's
    program imports and the port's modules the kinds call; then nothing
    forbidden is in ``sys.modules``."""
    code = """
import sys
from portbench.harness import guard, spec
import portbench.run, portbench.calibrate
for p in sorted(spec.PORTBENCH.rglob("*.py")):
    if "tests" not in p.parts and p.name != "__init__.py":
        spec.load_module(p)
import repro_torch.core.solver, repro_torch.serving.dsekl_engine
import repro_torch.kernels.dsekl.block
print(sorted(guard.forbidden_loaded()))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(spec.ROOT / "src"), str(spec.ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=spec.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
