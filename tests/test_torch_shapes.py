"""The dry-run's cells: the port's ``configs/shapes.py`` (``SHAPES``,
``applicable``, ``rules_kind``) against the JAX package's for every arch
and shape, and ``launch/dryrun.py``'s sweep (``all_cells``), variants,
decode override and cell paths against JAX's dry-run module (read as
source: importing it would force 512 host devices on this process)."""
import ast
import dataclasses
import os

import pytest

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import shapes as jax_shapes
from repro_torch.configs import ARCHS, SHAPES, applicable, shapes
from repro_torch.launch import dryrun

JAX_DRYRUN = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                          "launch", "dryrun.py")


def _jax_dryrun_globals():
    """The literal assignments of JAX's dry-run module (its ``VARIANTS``
    and ``_KV_SEQ_OVER_MODEL``), evaluated without importing JAX."""
    with open(JAX_DRYRUN) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            name = getattr(node.targets[0], "id", None)
            if name in ("VARIANTS", "_KV_SEQ_OVER_MODEL", "DEFAULT_OUT"):
                out[name] = ast.literal_eval(node.value)
    return out


def test_shape_specs_equal_jax():
    assert list(SHAPES) == list(jax_shapes.SHAPES)
    for name, spec in SHAPES.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(
            jax_shapes.SHAPES[name])


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_applicable_and_rules_kind_equal_jax(arch):
    assert arch in ARCHS
    for shape in SHAPES:
        assert applicable(arch, shape) == jax_shapes.applicable(arch, shape)
        assert shapes.rules_kind(SHAPES[shape]) == jax_shapes.rules_kind(
            jax_shapes.SHAPES[shape])


def test_all_cells_equal_jax():
    """JAX's ``all_cells`` is a function of ``ARCHS``, ``SHAPES`` and
    ``applicable`` (the sweep's 35 cells a mesh): rebuilt from JAX's
    registry, it equals the port's list, in order."""
    want = [(a, s) for a in sorted(JAX_ARCHS) for s in jax_shapes.SHAPES
            if jax_shapes.applicable(a, s)[0]]
    want += [("dsekl", "dsekl_covtype"), ("dsekl", "dsekl_prod")]
    got = list(dryrun.all_cells())
    assert got == want
    assert len(got) == 35


def test_variants_and_override_equal_jax():
    g = _jax_dryrun_globals()
    assert dryrun._KV_SEQ_OVER_MODEL == g["_KV_SEQ_OVER_MODEL"]
    assert set(dryrun.VARIANTS) == set(g["VARIANTS"])
    for name, var in g["VARIANTS"].items():
        assert dryrun.VARIANTS[name] == var, name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_cell_paths_follow_jax(multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    assert dryrun.cell_path("o", "granite-20b", "train_4k", multi_pod) == \
        os.path.join("o", mesh, "granite-20b__train_4k.json")
    assert dryrun.cell_path("o", "a", "s", multi_pod, "wf8") == \
        os.path.join("o", mesh, "a__s__wf8.json")


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_cell_rules_take_the_decode_override(arch):
    """The decode override (``kv_seq`` over the model axis) applies to the
    listed archs at ``decode_32k`` alone; a variant's rules come last."""
    for shape in SHAPES:
        rules = dryrun.cell_rules(arch, shape)
        over = (shapes.rules_kind(SHAPES[shape]) == "decode"
                and arch in dryrun._KV_SEQ_OVER_MODEL)
        assert rules == ({"kv_seq": "model"} if over else {})
    assert dryrun.cell_rules(arch, "decode_32k", "no_zero")["embed"] is None
