"""The port's kernel readout (``repro_torch.core.readout``) against the JAX
package's (``repro/core/readout.py``), on the CPU, internlm2-20b reduced to
2 layers as ``tests/test_readout.py`` runs it:

* ``extract_features`` (64 sequences of 16 tokens from a 24-token
  alphabet, two batches of 32; population std) equals JAX's at rtol 1e-4,
  atol 1e-4 x max(1, |oracle|_inf) (``test_torch_lm.py``'s tolerance);
* ``KernelReadout.fit`` on JAX's Algorithm-2 plans (``parallel_epoch_plan``
  from JAX's key chain; square loss, 3 epochs, on JAX's features) gives
  JAX's alpha and truncated support set, and ``decision`` / ``predict``
  give JAX's, at the DSEKL float32 tolerance, rtol 2e-4, atol 1e-5 x
  max(1, |oracle|_inf);
* JAX's classification gate on the port alone (512 sequences, labels from
  a random hyperplane in feature space, 60 epochs on the port's own
  generator): held-out error <= 0.35, train error <= 0.05.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import readout as jreadout
from repro.core import sampler as jsampler
from repro.core.dsekl import DSEKLConfig as JaxDSEKLConfig
from repro.distributed.sharding import MeshCtx
from repro.models.model import LanguageModel as JaxLM
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.core.readout import KernelReadout, extract_features
from repro_torch.models.model import LanguageModel

ARCH, LAYERS, S, ALPHABET = "internlm2-20b", 2, 16, 24
HEAD = dict(n_grad=32, n_expand=32, lam=1e-5, lr0=1.0, schedule="adagrad",
            kernel_params=(("gamma", 0.05),))


def _close(got, want, rtol=1e-4, atol=1e-4):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _models():
    jcfg = jax_get_config(ARCH, reduced=True).replace(n_layers=LAYERS)
    cfg = get_config(ARCH, reduced=True).replace(n_layers=LAYERS)
    jmodel = JaxLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, params)), strict=True)
    return jmodel, params, cfg, model


def _tokens(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, ALPHABET, (n, S)).astype(np.int32)


def test_extract_features_matches_jax():
    jmodel, params, cfg, model = _models()
    tok = _tokens(64, 1)
    want = jreadout.extract_features(jmodel, MeshCtx.single_device(), params,
                                     jnp.asarray(tok))
    got = extract_features(model, torch.from_numpy(tok).long())
    assert got.shape == (64, cfg.d_model) and got.dtype == torch.float32
    _close(got, want)
    # Population std: every feature standardized to mean 0, std 1.
    np.testing.assert_allclose(got.std(0, correction=0).numpy(), 1.0,
                               rtol=1e-4)


def test_fit_on_jax_plans_and_decision_match_jax():
    rng = np.random.default_rng(2)
    n, d, n_epochs = 256, 64, 3
    feats = rng.standard_normal((n + 64, d)).astype(np.float32)
    y = np.sign(feats @ rng.standard_normal(d) + 1e-6).astype(np.float32)
    head = dict(HEAD, loss="square")
    key = jax.random.PRNGKey(2)
    jhead = jreadout.KernelReadout(JaxDSEKLConfig(**head))
    jhead.fit(jnp.asarray(feats[:n]), jnp.asarray(y[:n]), key,
              n_epochs=n_epochs)
    plans, k = [], key
    for _ in range(n_epochs):
        k, sub = jax.random.split(k)
        i, jk = jsampler.parallel_epoch_plan(sub, n, 32, 32, 1)
        plans.append((np.array(i), np.array(jk)))
    thead = KernelReadout(DSEKLConfig(**head))
    res = thead.fit(torch.from_numpy(feats[:n]), torch.from_numpy(y[:n]),
                    n_epochs=n_epochs, plans=plans)
    assert int(res.state.step) == n_epochs * (n // 32)
    assert thead.x_train.shape == tuple(jhead.x_train.shape)
    _close(thead.alpha, jhead.alpha, 2e-4, 1e-5)
    _close(thead.x_train, jhead.x_train, 2e-4, 1e-5)
    q = torch.from_numpy(feats[n:])
    _close(thead.decision(q), jhead.decision(jnp.asarray(feats[n:])),
           2e-4, 1e-5)
    np.testing.assert_array_equal(
        thead.predict(q).numpy(), np.asarray(jhead.predict(
            jnp.asarray(feats[n:]))))


def test_readout_classifies_sequences():
    """JAX's test_readout gate, on the port: the head fits a nonlinear
    function of frozen-feature space and generalizes to held-out
    sequences."""
    *_, cfg, model = _models()
    n = 512
    feats = extract_features(model, torch.from_numpy(_tokens(n, 3)).long())
    assert feats.shape == (n, cfg.d_model)
    w = torch.randn(cfg.d_model, generator=torch.Generator().manual_seed(9))
    y = torch.sign(feats @ w / cfg.d_model ** 0.5 + 1e-6)
    ntr = n // 2
    head = KernelReadout(DSEKLConfig(**HEAD))
    head.fit(feats[:ntr], y[:ntr], torch.Generator().manual_seed(2),
             n_epochs=60)
    err = float((head.predict(feats[ntr:]) != y[ntr:]).float().mean())
    tr_err = float((head.predict(feats[:ntr]) != y[:ntr]).float().mean())
    assert err <= 0.35, f"readout error too high: {err}"
    assert tr_err <= 0.05, f"readout failed to fit train set: {tr_err}"


def test_decision_before_fit_raises():
    with pytest.raises(RuntimeError, match="fit"):
        KernelReadout(DSEKLConfig()).decision(torch.zeros(2, 3))
