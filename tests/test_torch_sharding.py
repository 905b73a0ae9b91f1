"""The port's sharding rules (``repro_torch/distributed/sharding.py``,
``repro_torch/nn/module.py``) against the JAX package's
(``repro/distributed/sharding.py``, ``repro/nn/module.py``), with no
ranks: the rules tables for every shape kind with and without the pod
axis; ``logical_to_pspec`` on ``tests/test_sharding_rules.py``'s property
cases; and for all ten configs at full width, every parameter's logical
names and its spec on the (16, 16) and (2, 16, 16) axis sizes, by the
port's unstacked names (JAX stacks the periods on a leading, never
sharded "stack" dim, which is dropped here).  Equality, not a tolerance."""
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as JAX_ARCHS, get_config as jax_get_config
from repro.distributed import sharding as jsh
from repro.models.model import LanguageModel as JaxLM
from repro.nn import module as jnnm
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import _flat
from repro_torch.distributed import sharding as tsh
from repro_torch.models.model import param_specs
from repro_torch.nn import module as tnnm

KINDS = ["train", "prefill", "decode", "long_decode", "replicated"]
POD = {"pod": 2, "data": 16, "model": 16}
ONE_POD = {"data": 16, "model": 16}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_make_rules_equal_jax(kind, multi_pod):
    assert tsh.LOGICAL_AXES == jsh.LOGICAL_AXES
    assert tsh.make_rules(kind, multi_pod) == jsh.make_rules(kind, multi_pod)


@settings(max_examples=80, deadline=None)
@given(
    names=st.lists(st.sampled_from(list(jsh.LOGICAL_AXES) + [None]),
                   min_size=1, max_size=5),
    dims=st.lists(st.integers(1, 4096), min_size=5, max_size=5),
    kind=st.sampled_from(KINDS[:4]),
    multi_pod=st.booleans(),
    with_shape=st.booleans(),
)
def test_logical_to_pspec_equals_jax(names, dims, kind, multi_pod,
                                     with_shape):
    rules = jsh.make_rules(kind, multi_pod)
    shape = tuple(dims[:len(names)]) if with_shape else None
    sizes = (POD if multi_pod else ONE_POD) if with_shape else None
    want = jnnm.logical_to_pspec(tuple(names), rules, shape, sizes)
    got = tnnm.logical_to_pspec(tuple(names), rules, shape, sizes)
    assert _axes(got) == _axes(want)


def _axes(spec):
    """A spec as a tuple of axis tuples (JAX's ``PartitionSpec`` may show
    a one-axis tuple entry as the bare name)."""
    return tuple(tsh.as_axes(e) for e in spec)


def _jax_unstacked(cfg, tree, stacked_leaf):
    """JAX's param-spec tree (or its pspec tree) keyed by the port's
    state-dict names, the stack dim dropped (``stacked_leaf(leaf)``)."""
    out = {}
    base = cfg.n_periods * cfg.period
    for name, leaf in _flat({k: v for k, v in tree.items()
                             if k not in ("stack", "encoder")}):
        out[name] = leaf
    for pos, sub in tree["stack"].get("scan", {}).items():
        i = int(pos[len("pos"):])
        for name, leaf in _flat(sub):
            for p in range(cfg.n_periods):
                out[f"layers.{p * cfg.period + i}.{name}"] = stacked_leaf(
                    leaf)
    for pos, sub in tree["stack"].get("rem", {}).items():
        i = int(pos[len("pos"):])
        for name, leaf in _flat(sub):
            out[f"layers.{base + i}.{name}"] = leaf
    enc = tree.get("encoder", {})
    for name, leaf in _flat(enc.get("scan", {})):
        for i in range(cfg.encoder_layers):
            out[f"encoder.layers.{i}.{name}"] = stacked_leaf(leaf)
    for name, leaf in _flat({"ln_f": enc["ln_f"]} if enc else {}):
        out[f"encoder.{name}"] = leaf
    return out


def _unstack_param(p):
    assert p.logical[0] == "stack"
    return jnnm.Param(p.shape[1:], p.logical[1:], init=p.init,
                      scale=p.scale)


def _unstack_pspec(ps):
    spec = tuple(ps)
    assert not spec or spec[0] is None
    spec = list(spec[1:])
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _jax_specs(name):
    jcfg = jax_get_config(name)
    return jcfg, JaxLM(jcfg).param_specs()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_param_has_jaxs_logical_names(name):
    assert set(ARCHS) == set(JAX_ARCHS)
    jcfg, jspecs = _jax_specs(name)
    want = _jax_unstacked(jcfg, jspecs, _unstack_param)
    got = dict(_flat(param_specs(get_config(name))))
    assert set(got) == set(want)
    for key, p in got.items():
        assert p.logical == want[key].logical, key
        assert p.shape == want[key].shape, key


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("sizes", [ONE_POD, POD], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_every_param_pspec_equals_jax(name, sizes, kind):
    jcfg, jspecs = _jax_specs(name)
    rules = jsh.make_rules(kind, multi_pod="pod" in sizes)
    want = _jax_unstacked(jcfg, jnnm.param_pspecs(jspecs, rules, sizes),
                          _unstack_pspec)
    got = dict(_flat(tnnm.param_pspecs(param_specs(get_config(name)),
                                       rules, sizes)))
    assert set(got) == set(want)
    for key in got:
        assert _axes(got[key]) == _axes(want[key]), key
