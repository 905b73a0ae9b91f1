"""The port's schedules and optimizers against the JAX package's
(``repro/optim``), on the same numpy inputs.

* every schedule's rate, as a float32, at steps 0..1,199: bit for bit for
  const, inv_t, linear and the warmup; the cosine schedule bit for bit at
  >= 97% of the steps and within two float32 ulps everywhere (XLA's
  float32 cosine is an approximation that is not correctly rounded; the
  port takes the float64 cosine rounded to float32: 63 of 5,000
  arguments differ by one ulp there, which the rate's last two products
  can carry to two);
* three updates of sgd, momentum, adagrad and adamw (cosine schedule with
  warmup, weight decay, gradient clipping on) on float32 and bfloat16
  parameters: parameters and moments within rtol 1e-6, atol 1e-7 x
  max(1, |oracle|_inf) in float32 and bit for bit in bfloat16;
  ``global_norm`` and ``clip_by_global_norm`` the same;
* the port's choices where ``torch.optim`` differs: AdaGrad's G starts at
  1 (``torch.optim.Adagrad``'s at 0), and AdamW adds ``wd * p`` inside
  the update, a step of ``lr (m_hat / (sqrt(v_hat) + eps) + wd p)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import global_norm as jax_global_norm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro_torch.optim import (clip_by_global_norm, global_norm,
                               make_optimizer, make_schedule)

STEPS = range(1200)
SCHEDULES = [("const", {}), ("inv_t", {}), ("linear", {"total_steps": 37}),
             ("linear", {"total_steps": 500, "min_ratio": 0.2}),
             ("const", {"warmup_steps": 13}), ("inv_t", {"warmup_steps": 7})]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedules_bit_for_bit(name, kw):
    js, ts = jax_make_schedule(name, 3e-3, **kw), make_schedule(name, 3e-3,
                                                                  **kw)
    want = np.asarray(js(jnp.arange(1200)), np.float32)
    got = np.array([ts(s).item() for s in STEPS], np.float32)
    np.testing.assert_array_equal(got, want)
    assert ts(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32


@pytest.mark.parametrize("total,warmup", [(7, 0), (100, 10), (1000, 100)])
def test_cosine_within_one_ulp(total, warmup):
    js = jax_make_schedule("cosine", 3e-3, warmup_steps=warmup,
                           total_steps=total)
    ts = make_schedule("cosine", 3e-3, warmup_steps=warmup,
                       total_steps=total)
    want = np.asarray(js(jnp.arange(1200)), np.float32)
    got = np.array([ts(s).item() for s in STEPS], np.float32)
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 2
    assert (ulps == 0).mean() >= 0.97


def _tree(rng, dtype):
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 2, 4)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


def _close(got, want, exact):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["sgd", "momentum", "adagrad", "adamw"])
def test_three_updates_match_jax(name, dtype):
    rng = np.random.default_rng(len(name))
    p0 = _tree(rng, dtype)
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p0.items()}
    kw = dict(weight_decay=0.1)
    jopt = jax_make_optimizer(name, jax_make_schedule(
        "cosine", 0.05, warmup_steps=2, total_steps=10), **kw)
    topt = make_optimizer(name, make_schedule(
        "cosine", 0.05, warmup_steps=2, total_steps=10), **kw)
    js, ts = jopt.init(jp), topt.init(tp)
    exact = dtype == "bfloat16"
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * 3
             for k, v in p0.items()}          # norm > 1: clipping bites
        jp, js = jopt.update({k: jnp.asarray(v, dtype) for k, v in
                              g.items()}, js, jp)
        tp, ts = topt.update({k: torch.from_numpy(v).to(tp[k].dtype)
                              for k, v in g.items()}, ts, tp)
        for k in p0:
            assert tp[k].dtype == getattr(torch, dtype)
            _close(tp[k], jp[k], exact)
    assert int(ts["count"]) == int(js["count"]) == 3
    for slot in set(js) - {"count"}:
        for k in p0:
            _close(ts[slot][k], js[slot][k], exact)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(3)
    tree = _tree(rng, "float32")
    want = jax_global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    _close(got, want, exact=False)
    for max_norm in (0.5, 1e6):
        wc = jax_clip({k: jnp.asarray(v) for k, v in tree.items()},
                      max_norm)
        gc = clip_by_global_norm({k: torch.from_numpy(v)
                                  for k, v in tree.items()}, max_norm)
        for k in tree:
            _close(gc[k], wc[k], exact=False)


def test_adagrad_starts_at_one_and_adamw_decays_inside():
    """AdaGrad's G starts at 1 (torch.optim.Adagrad's at 0: another
    step); AdamW's decay is inside its update."""
    p = {"w": torch.tensor([2.0, -1.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    ada = make_optimizer("adagrad", make_schedule("const", 0.1),
                         grad_clip=None)
    state = ada.init(p)
    assert torch.equal(state["g2"]["w"], torch.ones(2))
    new, _ = ada.update(g, state, p)
    want = p["w"] - 0.1 * g["w"] / torch.sqrt(1.0 + g["w"] ** 2 + 1e-8)
    torch.testing.assert_close(new["w"], want)
    tw = p["w"].clone().requires_grad_()
    topt = torch.optim.Adagrad([tw], lr=0.1)
    tw.grad = g["w"].clone()
    topt.step()
    assert not torch.allclose(tw.detach(), new["w"])

    adamw = make_optimizer("adamw", make_schedule("const", 0.1),
                           weight_decay=0.5, grad_clip=None)
    new, _ = adamw.update(g, adamw.init(p), p)
    # count 1: m_hat = g, v_hat = g^2, so the step is lr (sign(g) + wd p).
    want = p["w"] - 0.1 * (g["w"] / (g["w"].abs() + 1e-8) + 0.5 * p["w"])
    torch.testing.assert_close(new["w"], want)
