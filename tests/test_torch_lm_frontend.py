"""The port's MLA (deepseek-v3), cross-attention (llama-3.2-vision) and
whisper encoder-decoder against the JAX package's, on the CPU at the
reduced configs (float32); inputs drawn with numpy from a seed.

* ``mla_prefill`` (the cache padded, and sliced when S >= cache_len) and
  the absorbed ``mla_decode`` on JAX's own cache equal JAX's; in the port,
  ``mla_decode`` of token S after a prefill of S tokens equals the
  expanded ``mla_prefill`` of S + 1 tokens at token S;
* ``cross_forward`` (gated with a nonzero gate, and ungated; ``mha_full``
  and the flash op's plain version) and ``cross_kv`` equal JAX's;
* whisper's ``encode`` equals JAX's, on both attention paths;
* greedy ``generate`` equals JAX's token for token on whisper (with its
  frames) and deepseek-v3;
* llama-3.2-vision's cross layers count: its logits with the gates drawn
  nonzero differ from those with the gates at 0 by over 100x the
  tolerance;
* ``convert.lm_params_from_jax`` unstacks whisper's ``encoder/scan``
  into ``encoder.layers.{i}`` bit for bit.

Tolerance: ``test_torch_lm.py``'s, rtol 1e-4, atol 1e-4 x max(1,
|oracle|_inf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import MeshCtx
from repro.models import attention as jattn
from repro.models.model import LanguageModel as JaxLM
from repro.nn import module as jax_nnm
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import attention
from repro_torch.models.model import LanguageModel
from repro_torch.nn.module import ParamTree
from repro_torch.serving import ServingEngine

CTX = MeshCtx.single_device()
B = 2
TOL = 1e-4


def draw_gates(params, seed=11):
    """JAX's params with every cross-attention ``gate`` drawn from
    U(0.5, 1.5) (JAX inits it to 0: tanh(0) switches the layer off)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if path[-1].key != "gate":
            return a
        return jnp.asarray(rng.uniform(0.5, 1.5, a.shape), a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, params)


def frontend_of(cfg, seed, b=B):
    """A (b, n_frontend_tokens, d_model) float32 frontend, or None."""
    if not cfg.n_frontend_tokens:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model)
                               ).astype(np.float32)


def _close(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _tree(specs_fn, jspecs_fn, name, seed, gates=False):
    """(JAX params of ``jspecs_fn``, the port's ``ParamTree`` of
    ``specs_fn`` holding them, the port config, JAX config)."""
    jcfg = jax_get_config(name, reduced=True)
    cfg = get_config(name, reduced=True)
    params = jax_nnm.init_params(jspecs_fn(jcfg), jax.random.PRNGKey(seed))
    if gates:
        params = draw_gates(params, seed)
    tree = ParamTree(specs_fn(cfg), dtype=torch.float32,
                     device=torch.device("cpu"))
    tree.load_state_dict(lm_params_from_jax(cfg, jax.tree.map(np.asarray,
                                                              params)),
                         strict=True)
    return params, tree, cfg, jcfg


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# --- MLA ---------------------------------------------------------------------

@pytest.mark.parametrize("s,cache_len", [(12, 20), (20, 16)])
def test_mla_prefill_and_absorbed_decode_match_jax(s, cache_len):
    """The cache padded with position -1 (S < cache_len) and the last
    cache_len tokens (S >= cache_len); the decode step runs on JAX's own
    cache, converted."""
    params, tree, cfg, jcfg = _tree(attention.mla_specs, jattn.mla_specs,
                                    "deepseek-v3-671b", 3)
    x = _x((B, s + 1, cfg.d_model), s)
    pos = np.arange(s, dtype=np.int32)
    want, jcache = jattn.mla_prefill(params, jcfg, CTX, jnp.asarray(x[:, :s]),
                                     jnp.asarray(pos), cache_len=cache_len)
    got, cache = attention.mla_prefill(tree, cfg, torch.from_numpy(x[:, :s]),
                                       torch.from_numpy(pos),
                                       cache_len=cache_len)
    _close(got, want)
    for field in ("c_kv", "k_rope"):
        _close(getattr(cache, field), getattr(jcache, field))
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))

    want, jnew = jattn.mla_decode(params, jcfg, CTX, jnp.asarray(x[:, s:]),
                                  jcache, jnp.asarray(s, jnp.int32))
    theirs = attention.MLACache(*(torch.from_numpy(np.array(a))
                                  for a in jcache))
    got, new = attention.mla_decode(tree, cfg, torch.from_numpy(x[:, s:]),
                                    theirs, s)
    assert new is theirs                          # written in place
    _close(got, want)
    for field in ("c_kv", "k_rope"):
        _close(getattr(new, field), getattr(jnew, field))
    np.testing.assert_array_equal(new.pos.numpy(), np.asarray(jnew.pos))


def test_absorbed_decode_equals_the_expanded_prefill():
    """Token S by ``mla_decode`` after a prefill of S tokens, against
    token S of ``mla_prefill`` over S + 1 tokens: the same function,
    scored in c_kv space against per-head K/V."""
    _, tree, cfg, _ = _tree(attention.mla_specs, jattn.mla_specs,
                            "deepseek-v3-671b", 4)
    s = 15
    x = torch.from_numpy(_x((B, s + 1, cfg.d_model), 5))
    pos = torch.arange(s + 1, dtype=torch.int32)
    _, cache = attention.mla_prefill(tree, cfg, x[:, :s], pos[:s],
                                     cache_len=s + 1)
    got, _ = attention.mla_decode(tree, cfg, x[:, s:], cache, s)
    want, _ = attention.mla_prefill(tree, cfg, x, pos, cache_len=s + 1)
    _close(got[:, 0], want[:, s].numpy())


# --- cross-attention and the encoder ----------------------------------------

@pytest.mark.parametrize("gated,impl", [(True, None), (False, None),
                                        (True, "ref")])
def test_cross_forward_matches_jax(gated, impl):
    """JAX's ``mha_full`` with zero positions, against the port's (impl
    None) and the flash op's plain version (impl "ref", non-causal: the
    prefill's path); the gate drawn nonzero."""
    params, tree, cfg, jcfg = _tree(attention.cross_specs, jattn.cross_specs,
                                    "llama-3.2-vision-11b", 6, gates=True)
    assert abs(float(tree.gate)) > 0.4
    x = _x((B, 10, cfg.d_model), 7)
    fe = _x((B, cfg.n_frontend_tokens, cfg.d_model), 8)
    jkv = jattn.cross_kv(params, jcfg, jnp.asarray(fe))
    kv = attention.cross_kv(tree, cfg, torch.from_numpy(fe))
    _close(kv.k, jkv.k)
    _close(kv.v, jkv.v)
    want = jattn.cross_forward(params, jcfg, CTX, jnp.asarray(x), jkv,
                               gated=gated)
    got = attention.cross_forward(tree, cfg, torch.from_numpy(x), kv,
                                  gated=gated, impl=impl)
    _close(got, want)


@pytest.mark.parametrize("impl", [None, "ref"])
def test_encode_matches_jax(impl):
    """Whisper's non-causal encoder: through ``mha_full`` (training) and
    through the flash op's plain version (serving)."""
    name = "whisper-tiny"
    jmodel = JaxLM(jax_get_config(name, reduced=True))
    params = jmodel.init(jax.random.PRNGKey(1))
    cfg = get_config(name, reduced=True)
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, params)), strict=True)
    frames = frontend_of(cfg, 9)
    want = jmodel.encode(params, CTX, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames), impl)
    _close(got, want)


def test_convert_unstacks_the_encoder():
    cfg = get_config("whisper-tiny", reduced=True)
    params = JaxLM(jax_get_config("whisper-tiny", reduced=True)).init(
        jax.random.PRNGKey(2))
    sd = lm_params_from_jax(cfg, jax.tree.map(np.asarray, params))
    enc = jax.tree_util.tree_flatten_with_path(params["encoder"]["scan"])[0]
    assert len(enc) > 0
    for path, arr in enc:
        rest = ".".join(p.key for p in path)
        for i in range(cfg.encoder_layers):
            np.testing.assert_array_equal(
                sd[f"encoder.layers.{i}.{rest}"].numpy(), np.asarray(arr)[i])
    np.testing.assert_array_equal(sd["encoder.ln_f.scale"].numpy(),
                                  np.asarray(params["encoder"]["ln_f"]
                                             ["scale"]))
    assert not any(k.startswith("encoder.scan") for k in sd)
    assert set(sd) == set(LanguageModel(cfg, device="cpu").state_dict())


# --- whole models --------------------------------------------------------------

def _models(name):
    jmodel = JaxLM(jax_get_config(name, reduced=True))
    params = draw_gates(jmodel.init(jax.random.PRNGKey(0)))
    cfg = get_config(name, reduced=True)
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, params)), strict=True)
    return jmodel, params, cfg, model


@pytest.mark.parametrize("name", ["whisper-tiny", "deepseek-v3-671b"])
def test_greedy_generate_matches_jax(name):
    jmodel, params, cfg, model = _models(name)
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                            (B, 16)).astype(np.int32)
    fe = frontend_of(cfg, 3)
    want = JaxEngine(jmodel, CTX, 24).generate(
        params, jnp.asarray(tok), 6,
        frontend=None if fe is None else jnp.asarray(fe))
    got = ServingEngine(model, 24).generate(
        torch.from_numpy(tok).long(), 6,
        frontend=None if fe is None else torch.from_numpy(fe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_llama_vision_cross_layers_move_the_logits():
    """With the gates drawn nonzero the cross layers change the logits by
    over 100x the tolerance (at 0, JAX's init, they would not count)."""
    _, _, cfg, model = _models("llama-3.2-vision-11b")
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, 16))).long()
    fe = torch.from_numpy(frontend_of(cfg, 5))
    gated, _ = model.prefill(tok, 24, frontend=fe)
    gates = [blk.xattn.gate for blk in model.layers
             if blk.kind == "cross_attn"]
    assert gates and all(abs(float(g)) > 0.4 for g in gates)
    with torch.no_grad():
        for g in gates:
            g.zero_()
    off, _ = model.prefill(tok, 24, frontend=fe)
    scale = max(1.0, float(off.abs().max()))
    assert float((gated - off).abs().max()) > 100 * TOL * scale
