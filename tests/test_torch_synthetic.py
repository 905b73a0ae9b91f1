"""The port's synthetic generators (``data/synthetic.py``) against the JAX
package's: the draws differ (torch against threefry), so the shapes,
dtypes, class balance and label rules are held, and ``train_test_split``
on a permutation JAX drew equals JAX's split bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as tsyn

KEY = jax.random.PRNGKey(0)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_layout(got, want):
    for g, w in zip(got, want, strict=True):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32


@pytest.mark.parametrize("name,port,ref", [
    ("xor", lambda: tsyn.make_xor(2000, device="cpu"),
     lambda: jsyn.make_xor(KEY, 2000)),
    ("moons", lambda: tsyn.make_two_moons(2001, device="cpu"),
     lambda: jsyn.make_two_moons(KEY, 2001)),
    ("blobs", lambda: tsyn.make_gaussian_blobs(2000, 7, device="cpu"),
     lambda: jsyn.make_gaussian_blobs(KEY, 2000, 7)),
    ("nonlinear", lambda: tsyn.make_nonlinear(2000, 5, device="cpu"),
     lambda: jsyn.make_nonlinear(KEY, 2000, 5)),
    ("covertype", lambda: tsyn.make_covertype_like(4000, device="cpu"),
     lambda: jsyn.make_covertype_like(KEY, 4000)),
])
def test_generators_match_jax_layout_and_label_rules(name, port, ref):
    x, y = port()
    _same_layout((x, y), ref())
    x, y = _np(x), _np(y)
    assert set(np.unique(y)) <= {-1.0, 0.0, 1.0}
    pos = float((y > 0).mean())
    if name == "xor":                    # +1 at +-[1, 1], -1 at +-[1, -1]
        assert np.mean(np.sign(x[:, 0] * x[:, 1]) == y) > 0.99
        assert 0.45 < pos < 0.55
    elif name == "moons":                # two equal halves, shuffled
        assert pos == 0.5 and not np.all(y[:1000] == 1.0)
    elif name == "blobs":                # +-(sep / 2) e / sqrt(d)
        assert np.mean(np.sign(x.sum(1)) == y) > 0.8 and 0.45 < pos < 0.55
    elif name == "nonlinear":
        assert 0.3 < pos < 0.7
    else:                                # ~57 / 43
        assert 0.5 < pos < 0.7
        assert set(np.unique(x[:, 10:])) == {0.0, 1.0}


def test_benchmark_suite_matches_jax_layout():
    """The same Table-1 specs as JAX's, and each set of its (N, D) in
    float32 (JAX's suite makes each set at its spec's shape)."""
    assert tsyn._TABLE1_SPECS == jsyn._TABLE1_SPECS
    got = tsyn.make_benchmark_suite(seed=1, device="cpu")
    assert list(got) == list(jsyn._TABLE1_SPECS)
    for name, (n, d, _) in jsyn._TABLE1_SPECS.items():
        x, y = got[name]
        assert x.shape == (n, d) and y.shape == (n,)
        assert x.dtype == y.dtype == torch.float32
        assert set(np.unique(_np(y))) <= {-1.0, 0.0, 1.0}
        assert 0.3 < float((y > 0).float().mean()) < 0.7
    again = tsyn.make_benchmark_suite(seed=1, device="cpu")
    assert all(torch.equal(got[k][0], again[k][0]) for k in got)


@pytest.mark.parametrize("test_frac", [0.5, 0.3])
def test_train_test_split_on_jax_permutation_is_bit_identical(test_frac):
    x, y = jsyn.make_nonlinear(KEY, 101, 4)
    key = jax.random.PRNGKey(7)
    want = jsyn.train_test_split(key, x, y, test_frac)
    perm = np.asarray(jax.random.permutation(key, 101))
    got = tsyn.train_test_split(torch.from_numpy(np.array(x)),
                                torch.from_numpy(np.array(y)),
                                test_frac, perm=perm)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    drawn = tsyn.train_test_split(np.asarray(x), np.asarray(y), test_frac,
                                  seed=3)
    assert drawn[2].shape[0] == int(101 * test_frac)
    assert sorted(np.concatenate([drawn[1].numpy(), drawn[3].numpy()])) \
        == sorted(np.asarray(y))
    with pytest.raises(ValueError, match="perm must be"):
        tsyn.train_test_split(np.asarray(x), np.asarray(y), perm=perm[:5])
