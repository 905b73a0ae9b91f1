"""The port's LM training path against the JAX package's, on the CPU at
the reduced configs (float32, one period plus the remainder), B 2, S 16.

* ``mha_full`` (sliding window, GQA, causal and not) and the chunked
  ``ssd`` (non-zero initial state, a chunk that does not divide S) equal
  JAX's; ``ssd``'s gradient is finite under a decay fast enough that the
  masked upper triangle's exp overflows without the clamp, and equals
  JAX's;
* ``load_balance_loss`` equals JAX's;
* ``loss`` and the whole gradient tree equal ``jax.value_and_grad`` of
  JAX's ``model.loss`` (JAX's grads carried across by
  ``lm_params_from_jax``) on eight archs with remat on (deepseek-v3's
  MLA; llama-3.2-vision's cross-attention over a numpy frontend, its
  gates drawn nonzero; whisper's encoder over numpy frames, its unused
  gates' gradient 0 on both sides), and on mamba2 and
  jamba with remat off (against the same JAX oracle, taken once an arch
  with JAX's default remat: the same function, and one JAX compile an
  arch); remat on and off give the same loss and gradients in the port,
  bit for bit;
* a step with ``microbatches=2`` equals one with ``microbatches=1``,
  also on whisper with its frames (the step slices ``batch["frontend"]``);
* a 5-step AdamW ``train_step`` trajectory at lr 3e-3 (losses, grad
  norms, parameters, moments) equals JAX's on mamba2 and granite;
* the loss, the gradients and the trajectory also in bfloat16
  (parameters and compute, as the full configs train on the card) on
  mamba2 and granite, against JAX's bfloat16 at the tolerance below.

Tolerance: ``test_torch_lm.py``'s, rtol 1e-4, atol 1e-4 x max(1,
|oracle|_inf), with one exception: gemma3's gradients.  Its reduced stack
is 8 layers deep and its embedding gradient reaches |g| 136 through the
first RMSNorm of 0.02-scale embeddings, so float32 rounding shows in a
few elements: 12 of its 361,536 gradient elements differ from JAX's by
more than the stated tolerance, the worst by 2.1e-4 x |oracle|_inf (the
same function summed in another order; a float64 evaluation of the
gradient sits as far from either).  There every element is held to atol
1e-3 x |oracle|_inf and at most 1e-4 of the elements (36) may exceed the
stated tolerance.

The bfloat16 tolerance: losses and grad norms rtol 5e-3; gradients and
parameters rtol 2e-2, atol 2e-2 x max(1, |oracle|_inf), ~2.5 x bfloat16's
epsilon (2^-7).  The two sides round the same function's intermediates
to bfloat16 at different points (XLA fuses elementwise chains in float32),
so they differ by bfloat16 rounding: JAX's own bfloat16 gradients differ
from its float32 ones on the same weights by up to 1.25e-2 x |g|_inf
here, and the port's bfloat16 gradients from JAX's by up to 1.27e-2.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import MeshCtx
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.model import LanguageModel as JaxLM
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro.train import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention, moe, ssm
from repro_torch.models.model import LanguageModel
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train import make_train_step, trainable

B, S = 2, 16
CTX = MeshCtx.single_device()


def _close(got, want, atol=1e-4):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol * scale)


def _close_bf16(got, want, scalar=False):
    """The bfloat16 tolerance (module docstring): a loss or grad norm to
    rtol 5e-3; a tensor to rtol 2e-2, atol 2e-2 x max(1, |oracle|_inf)."""
    got = got.detach().double().numpy()
    want = (want.double().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(want, np.float64))
    assert got.shape == want.shape
    if scalar:
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=0)
    else:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(jmodel, cfg, state_dict):
    """JAX's param tree holding the port's weights: each period's layers
    stacked under ``stack/scan/pos{i}`` (the inverse of
    ``lm_params_from_jax``; JAX's own init of the larger reduced configs
    takes seconds), in the config's parameter dtype."""
    base = cfg.n_periods * cfg.period
    # Copies: jnp.asarray may alias a numpy buffer, and the port updates
    # its parameters in place.
    sd = {k: v.float().numpy().copy() for k, v in state_dict.items()}

    def leaf(path, _):
        keys = [p.key for p in path]
        rest = ".".join(keys[3:])
        if keys[:2] == ["encoder", "scan"]:
            rest = ".".join(keys[2:])
            arr = np.stack([sd[f"encoder.layers.{i}.{rest}"]
                            for i in range(cfg.encoder_layers)])
        elif keys[:2] == ["stack", "scan"]:
            i = int(keys[2][3:])
            arr = np.stack([sd[f"layers.{p * cfg.period + i}.{rest}"]
                            for p in range(cfg.n_periods)])
        elif keys[:2] == ["stack", "rem"]:
            arr = sd[f"layers.{base + int(keys[2][3:])}.{rest}"]
        else:
            arr = sd[".".join(keys)]
        return jnp.asarray(arr).astype(cfg.param_dtype)

    return jax.tree_util.tree_map_with_path(leaf, jmodel.abstract())


def _models(name, seed=0, dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    cfg = get_config(name, reduced=True).replace(**kw)
    jmodel = JaxLM(jax_get_config(name, reduced=True).replace(**kw))
    model = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    # Cross-attention gates start at 0 (tanh(0) switches the layer off):
    # draw them nonzero so that the cross layers count.
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for key, p in model.named_parameters():
            if key.endswith(".gate"):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
    params = _jax_params(jmodel, cfg, model.state_dict())
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in
               lm_params_from_jax(cfg, _np_tree(params)).items())
    return jmodel, params, cfg, model


def _batch(cfg, seed=1, b=B):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    return tok, lab


def _frontend(cfg, seed=2, b=B):
    """A (b, n_frontend_tokens, d_model) float32 frontend, or None."""
    if not cfg.n_frontend_tokens:
        return None
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# --- the plain functions ----------------------------------------------------

@pytest.mark.parametrize("h,kv,window,causal,q_chunk", [
    (4, 2, jattn.GLOBAL_WINDOW, True, 512),
    (4, 2, 5, True, 8),                  # sliding window, two q chunks
    (4, 1, jattn.GLOBAL_WINDOW, False, 6),   # non-causal, chunk -> 4
    (4, 4, 3, False, 16),
])
def test_mha_full_matches_jax(h, kv, window, causal, q_chunk):
    rng = np.random.default_rng(h * 10 + kv + window % 97)
    q = rng.standard_normal((B, S, h, 8)).astype(np.float32)
    k = rng.standard_normal((B, S, kv, 8)).astype(np.float32)
    v = rng.standard_normal((B, S, kv, 8)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.mha_full(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(pos), jnp.asarray(pos), window=window,
                          causal=causal, q_chunk=q_chunk)
    got = attention.mha_full(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(pos), torch.from_numpy(pos),
                             window=window, causal=causal, q_chunk=q_chunk)
    assert attention._pick_q_chunk(S, q_chunk) == jattn._pick_q_chunk(
        S, q_chunk)
    _close(got, want)


def _ssd_inputs(s, nh, hd, g, n, dt_scale, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((B, s, nh, hd)).astype(f32)
    dt = (np.log1p(np.exp(rng.standard_normal((B, s, nh)))) * dt_scale
          ).astype(f32)
    a = -np.exp(rng.standard_normal(nh) * 0.5).astype(f32)
    bm = rng.standard_normal((B, s, g, n)).astype(f32)
    cm = rng.standard_normal((B, s, g, n)).astype(f32)
    st = rng.standard_normal((B, nh, hd, n)).astype(f32) * 0.5
    return x, dt, a, bm, cm, st


@pytest.mark.parametrize("s,chunk,g", [(16, 8, 1), (12, 8, 2), (16, 16, 2)])
def test_ssd_matches_jax(s, chunk, g):
    args = _ssd_inputs(s, 4, 8, g, 4, 1.0, seed=s + chunk + g)
    wy, wf = jssm.ssd(*(jnp.asarray(a) for a in args), chunk)
    gy, gf = ssm.ssd(*(torch.from_numpy(a) for a in args), chunk)
    _close(gy, wy)
    _close(gf, wf)


def test_ssd_gradient_finite_and_matches_jax():
    """dt x 40 makes exp(ldiff) overflow on the masked upper triangle: the
    clamp before the exp keeps the backward finite."""
    args = _ssd_inputs(16, 4, 8, 1, 4, 40.0, seed=3)
    w = np.random.default_rng(4).standard_normal((B, 16, 4, 8)).astype(
        np.float32)

    def jax_obj(x, dt, bm, cm):
        y, fin = jssm.ssd(x, dt, jnp.asarray(args[2]), bm, cm,
                          jnp.asarray(args[5]), 8)
        return jnp.sum(y * w) + jnp.sum(fin)

    jx = [jnp.asarray(args[i]) for i in (0, 1, 3, 4)]
    want = jax.jit(jax.grad(jax_obj, argnums=(0, 1, 2, 3)))(*jx)
    tx = [torch.from_numpy(args[i]).requires_grad_() for i in (0, 1, 3, 4)]
    y, fin = ssm.ssd(tx[0], tx[1], torch.from_numpy(args[2]), tx[2], tx[3],
                     torch.from_numpy(args[5]), 8)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(w))
                              + torch.sum(fin), tx)
    ldiff_max = float(np.max(np.abs(np.cumsum(
        args[1] * args[2][None, None], axis=1))))
    assert ldiff_max > 88.0            # exp overflows float32 past ~88.7
    for g, wg in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, wg)


def test_load_balance_loss_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=1)[:, :2].astype(np.int32)
    want = jmoe.load_balance_loss(jnp.asarray(probs), jnp.asarray(top), 8)
    got = moe.load_balance_loss(torch.from_numpy(probs),
                                torch.from_numpy(top), 8)
    _close(got, want)


# --- the loss and its gradients ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _oracle(name, dtype="float32"):
    """(port model, config, batch, frontend, JAX loss, JAX grads as port
    names)."""
    jmodel, params, cfg, model = _models(name, dtype=dtype)
    tok, lab = _batch(cfg)
    fe = _frontend(cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, l, f: jmodel.loss(p, CTX, t, l, frontend=f,
                                       loss_chunks=4)))
    jl, jg = fn(params, jnp.asarray(tok), jnp.asarray(lab),
                None if fe is None else jnp.asarray(fe))
    return (model, cfg, tok, lab, fe, jl,
            lm_params_from_jax(cfg, _np_tree(jg)))


def _port_value_and_grad(model, tok, lab, remat, fe=None):
    """Unused parameters (whisper's gates) get a zero gradient, as in
    ``train_step`` and in JAX."""
    params = trainable(model)
    loss = model.loss(torch.from_numpy(tok).long(),
                      torch.from_numpy(lab).long(), frontend=_t(fe),
                      loss_chunks=4, remat=remat)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True, materialize_grads=True)
    return loss, dict(zip(params, grads))


CASES = [("mamba2-780m", True, "float32"), ("granite-20b", True, "float32"),
         ("gemma3-27b", True, "float32"),
         ("jamba-v0.1-52b", True, "float32"),
         ("kimi-k2-1t-a32b", True, "float32"),
         ("deepseek-v3-671b", True, "float32"),
         ("llama-3.2-vision-11b", True, "float32"),
         ("whisper-tiny", True, "float32"),
         ("mamba2-780m", False, "float32"),
         ("jamba-v0.1-52b", False, "float32"),
         ("mamba2-780m", True, "bfloat16"), ("granite-20b", True, "bfloat16")]


@pytest.mark.parametrize("name,remat,dtype", CASES)
def test_loss_and_gradients_match_jax(name, remat, dtype):
    model, cfg, tok, lab, fe, jl, want = _oracle(name, dtype)
    loss, grads = _port_value_and_grad(model, tok, lab, remat, fe)
    assert set(want) == set(grads)
    if dtype == "bfloat16":
        _close_bf16(loss, jl, scalar=True)
        for k, g in grads.items():
            assert g.dtype == torch.bfloat16, k
            _close_bf16(g, want[k])
        return
    _close(loss, jl)
    if name != "gemma3-27b":
        for k, g in grads.items():
            _close(g, want[k])
    else:
        beyond = total = 0
        for k, g in grads.items():
            _close(g, want[k], atol=1e-3)
            got, w = g.double().numpy(), want[k].double().numpy()
            scale = max(1.0, float(np.abs(w).max()))
            beyond += int((np.abs(got - w)
                           > 1e-4 * np.abs(w) + 1e-4 * scale).sum())
            total += w.size
        assert beyond <= 1e-4 * total, (beyond, total)
    if cfg.has_moe:
        with torch.no_grad():
            _, aux = model.hidden_train(torch.from_numpy(tok).long(),
                                        with_aux=True)
        assert float(aux) > 0.0


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-v0.1-52b"])
def test_remat_on_and_off_agree(name):
    _, _, cfg, model = _models(name)
    tok, lab = _batch(cfg, seed=2)
    l1, g1 = _port_value_and_grad(model, tok, lab, True)
    l0, g0 = _port_value_and_grad(model, tok, lab, False)
    assert torch.equal(l1, l0)
    for k in g1:
        assert torch.equal(g1[k], g0[k]), k


def test_microbatches_two_equal_one():
    _microbatches_two_equal_one("granite-20b")


def test_microbatches_two_equal_one_with_a_frontend():
    _microbatches_two_equal_one("whisper-tiny")


def _microbatches_two_equal_one(name):
    _, _, cfg, model = _models(name)
    tok, lab = _batch(cfg, seed=6, b=4)
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(lab).long()}
    fe = _frontend(cfg, seed=7, b=4)
    if fe is not None:
        batch["frontend"] = torch.from_numpy(fe)
    out = {}
    init = {k: v.clone() for k, v in model.state_dict().items()}
    for mb in (1, 2):
        model.load_state_dict(init)
        opt = make_optimizer("sgd", make_schedule("const", 1e-2),
                             grad_clip=None)
        params = trainable(model)
        step = make_train_step(model, opt, loss_chunks=2, microbatches=mb)
        _, _, metrics = step(params, opt.init(params), batch)
        out[mb] = (metrics, {k: p.detach().clone()
                             for k, p in params.items()})
    _close(out[2][0]["loss"], out[1][0]["loss"].numpy())
    _close(out[2][0]["grad_norm"], out[1][0]["grad_norm"].numpy())
    for k, p in out[1][1].items():
        _close(out[2][1][k], p.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mamba2-780m", "granite-20b"])
def test_adamw_trajectory_matches_jax(name, dtype):
    jmodel, params, cfg, model = _models(name, dtype=dtype)
    kw = dict(warmup_steps=2, total_steps=5)
    jopt = jax_make_optimizer("adamw", jax_make_schedule("cosine", 3e-3,
                                                         **kw))
    opt = make_optimizer("adamw", make_schedule("cosine", 3e-3, **kw))
    jstep = jax.jit(jax_make_train_step(jmodel, CTX, jopt, loss_chunks=4))
    step = make_train_step(model, opt, loss_chunks=4)
    jstate, tparams = jopt.init(params), trainable(model)
    state = opt.init(tparams)
    if dtype == "float32":
        close, close_scalar = _close, _close
    else:
        close = _close_bf16
        close_scalar = functools.partial(_close_bf16, scalar=True)
    for i in range(5):
        tok, lab = _batch(cfg, seed=10 + i)
        params, jstate, jm = jstep(params, jstate,
                                   {"tokens": jnp.asarray(tok),
                                    "labels": jnp.asarray(lab)})
        tparams, state, m = step(tparams, state,
                                 {"tokens": torch.from_numpy(tok).long(),
                                  "labels": torch.from_numpy(lab).long()})
        close_scalar(m["loss"], jm["loss"])
        close_scalar(m["grad_norm"], jm["grad_norm"])
    assert int(state["count"]) == int(jstate["count"]) == 5
    want = lm_params_from_jax(cfg, _np_tree(params))
    for k, p in tparams.items():
        assert p.dtype == getattr(torch, dtype), k
        close(p, want[k])
    for moment in ("m", "v"):
        wm = lm_params_from_jax(cfg, _np_tree(jstate[moment]))
        for k, t in state[moment].items():
            close(t, wm[k])


def test_kernel_ops_refuse_a_gradient():
    """The flash and SSD ops' kernel path raises when asked for a
    gradient, rather than running its plain version; under no_grad, or on
    the ref backend, nothing is refused."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssd import ssd_chunked
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    kv = torch.randn(1, 8, 2, 16)
    x, dt, a, bm, cm = (torch.from_numpy(t) for t in
                        _ssd_inputs(8, 2, 8, 1, 4, 1.0, seed=0)[:5])
    x.requires_grad_()
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ssd_chunked(x, dt, a, bm, cm, chunk=8, impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kv, kv, impl="cuda")      # the kernel's own check
    out = flash_attention(q, kv, kv, impl="ref")
    assert out.requires_grad
    y, _ = ssd_chunked(x, dt, a, bm, cm, chunk=8, impl="ref")
    assert y.requires_grad


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True),
                                                   (16.0, False)])
def test_moe_gradient_with_drops_matches_jax(capacity_factor, drops):
    """Autograd through the dispatch (the gather, the router weights in
    the prob table, the scatter-add) and the aux loss, with and without
    capacity drops, against jax.grad of JAX's moe_forward."""
    from repro.nn import module as jax_nnm
    from repro_torch.nn.module import ParamTree
    cfg = get_config("kimi-k2-1t-a32b", reduced=True).replace(
        capacity_factor=capacity_factor)
    jcfg = jax_get_config("kimi-k2-1t-a32b", reduced=True).replace(
        capacity_factor=capacity_factor)
    params = jax_nnm.init_params(jmoe.moe_specs(jcfg), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)

    def jax_obj(p, xx):
        y, aux = jmoe.moe_forward(p, jcfg, CTX, xx, with_aux=True)
        return jnp.sum(y * w) + 3.0 * aux

    jgp, jgx = jax.jit(jax.grad(jax_obj, argnums=(0, 1)))(params,
                                                          jnp.asarray(x))
    tree = ParamTree(moe.moe_specs(cfg), dtype=torch.float32,
                     device=torch.device("cpu"))
    tree.load_state_dict(lm_params_from_jax(cfg, _np_tree(params)))
    tree.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_forward(tree, cfg, tx, with_aux=True)
    obj = torch.sum(y * torch.from_numpy(w)) + 3.0 * aux
    names = [n for n, _ in tree.named_parameters()]
    grads = torch.autograd.grad(obj, [tx] + [p for _, p in
                                             tree.named_parameters()])
    _close(grads[0], jgx)
    want = lm_params_from_jax(cfg, _np_tree(jgp))
    for n, g in zip(names, grads[1:]):
        _close(g, want[n])
    logits = x.reshape(-1, cfg.d_model) @ np.asarray(params["router"])
    top = np.argsort(-logits, axis=1)[:, :cfg.top_k]
    cap = int(np.ceil(60 * cfg.top_k * capacity_factor / cfg.n_experts))
    assert (np.bincount(top.ravel(), minlength=cfg.n_experts).max()
            > cap) == drops
