"""The port's fault-tolerant LM training loop (``repro_torch.train``):

* a run that fails at step 9 and restarts from its step-8 checkpoint
  (``run_with_restarts``) ends on the uninterrupted run's parameters and
  losses bit for bit, in float32 and in bfloat16 (the checkpoint stores
  bfloat16 as float32, exactly); the loss falls on the bigram task;
* ``run_with_restarts`` re-raises once its restarts are spent;
* a JAX LM checkpoint (``read_jax_checkpoint``, step 2 of 4), carried
  across by ``convert.lm_train_state_from_jax`` and resumed by the port's
  ``train_loop`` from freshly built state, lands on JAX's own step-4
  parameters and moments, with steps 2-3's losses equal to JAX's
  (rtol 1e-4, atol 1e-4 x max(1, |oracle|_inf), ``test_torch_lm.py``'s
  tolerance).
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxCkpt
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import BigramPipeline as JaxPipeline
from repro.distributed.sharding import MeshCtx
from repro.models.model import LanguageModel as JaxLM
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro.train import TrainLoopConfig as JaxLoopConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train import train_loop as jax_train_loop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import (lm_params_from_jax, lm_train_state_from_jax,
                                 nest, read_jax_checkpoint)
from repro_torch.data import BigramPipeline
from repro_torch.models.model import LanguageModel
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train import (SimulatedFailure, TrainLoopConfig,
                               make_train_step, run_with_restarts,
                               train_loop, trainable)


def _close(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _cfg(dtype="float32"):
    return get_config("granite-20b", reduced=True).replace(
        n_layers=2, param_dtype=dtype, compute_dtype=dtype)


def _loop(path, n_steps, fail_at=None, dtype="float32", seed=0):
    cfg = _cfg(dtype)
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    opt = make_optimizer("adamw", make_schedule("const", 1e-3))
    params = trainable(model)
    step = make_train_step(model, opt, loss_chunks=2)
    pipe = BigramPipeline(cfg.vocab_size, 4, 32, seed=3)
    ckpt = CheckpointManager(path, keep=3, async_save=False)
    return train_loop(step, params, opt.init(params), pipe, ckpt,
                      TrainLoopConfig(n_steps=n_steps, ckpt_every=4,
                                      log_every=100),
                      fail_at_step=fail_at, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fail_and_resume_bit_for_bit(dtype, tmp_path):
    n = 14
    clean = _loop(tmp_path / "clean", n, dtype=dtype)
    calls = {"n": 0}

    def make_loop():
        # The first attempt starts as the clean run and fails at step 9; a
        # restart builds fresh state from another init seed, so only the
        # checkpoint can bring it back.
        attempt = calls["n"]
        calls["n"] += 1
        return _loop(tmp_path / "faulty", n, dtype=dtype,
                     fail_at=9 if attempt == 0 else None, seed=attempt)

    faulty = run_with_restarts(make_loop, max_restarts=2)
    assert calls["n"] == 2
    assert [h["step"] for h in faulty["history"]] == list(range(8, n))
    for k, p in clean["params"].items():
        assert p.dtype == getattr(torch, dtype)
        assert torch.equal(p, faulty["params"][k]), k
    for slot in ("m", "v"):
        for k, t in clean["opt_state"][slot].items():
            assert torch.equal(t, faulty["opt_state"][slot][k])
    assert [h["loss"] for h in clean["history"][8:]] == \
        [h["loss"] for h in faulty["history"]]
    losses = [h["loss"] for h in clean["history"]]
    assert losses[-1] < losses[0]
    assert {"loss", "grad_norm", "step", "seconds"} <= set(
        clean["history"][0])


def test_run_with_restarts_gives_up(tmp_path):
    calls = {"n": 0}

    def make_loop():
        calls["n"] += 1
        return _loop(tmp_path, 4, fail_at=1)

    with pytest.raises(SimulatedFailure):
        run_with_restarts(make_loop, max_restarts=1)
    assert calls["n"] == 2


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    jcfg = jax_get_config("granite-20b", reduced=True).replace(n_layers=2)
    cfg = _cfg()
    jmodel = JaxLM(jcfg)
    ctx = MeshCtx.single_device()
    jopt = jax_make_optimizer("adamw", jax_make_schedule(
        "cosine", 3e-3, warmup_steps=1, total_steps=4))
    jstep = jax.jit(jax_make_train_step(jmodel, ctx, jopt, loss_chunks=2))
    params = jmodel.init(jax.random.PRNGKey(0))
    jdir = tmp_path / "jax"
    out = jax_train_loop(jstep, params, jopt.init(params),
                         JaxPipeline(cfg.vocab_size, 4, 32, seed=1),
                         JaxCkpt(str(jdir), keep=3, async_save=False),
                         JaxLoopConfig(n_steps=4, ckpt_every=2))

    step, flat, extra = read_jax_checkpoint(jdir, 2)
    tree = nest(flat)
    port_flat, port_extra = lm_train_state_from_jax(
        cfg, tree["params"], tree["opt"], extra)
    assert port_extra == {"pipeline": {"step": 2, "seed": 1},
                          "train_step": 2}
    pdir = tmp_path / "port"
    CheckpointManager(pdir, async_save=False).save(step, port_flat,
                                                   extra=port_extra)

    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(5))
    opt = make_optimizer("adamw", make_schedule(
        "cosine", 3e-3, warmup_steps=1, total_steps=4))
    tparams = trainable(model)
    res = train_loop(make_train_step(model, opt, loss_chunks=2), tparams,
                     opt.init(tparams), BigramPipeline(cfg.vocab_size, 4, 32,
                                                       seed=1),
                     CheckpointManager(pdir, async_save=False),
                     TrainLoopConfig(n_steps=4, ckpt_every=2), device="cpu")
    assert [h["step"] for h in res["history"]] == [2, 3]
    for got, want in zip(res["history"], out["history"][2:]):
        _close(got["loss"], want["loss"])
        _close(got["grad_norm"], want["grad_norm"])
    assert int(res["opt_state"]["count"]) == 4
    want = lm_params_from_jax(cfg, jax.tree.map(np.asarray, out["params"]))
    for k, p in res["params"].items():
        _close(p, want[k])
    for slot in ("m", "v"):
        wm = lm_params_from_jax(cfg, jax.tree.map(
            np.asarray, out["opt_state"][slot]))
        for k, t in res["opt_state"][slot].items():
            _close(t, wm[k])
