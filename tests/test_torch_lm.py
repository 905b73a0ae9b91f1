"""The port's LM serving path against the JAX package's, on the CPU at the
reduced configs (float32): MoE forward with and without capacity drops,
then, for each of the ten architectures, prefill logits, every layer's
decode cache (``KVCache``, ``MambaCache``, ``MLACache``, ``CrossCache`` and
whisper's ``{"self", "cross"}`` dict) and one decode step, with a frontend
(B, n_frontend_tokens, d_model) drawn with numpy where the config has one
and llama-3.2-vision's cross-attention gates drawn nonzero (JAX inits them
to 0, which switches those layers off); and jamba's greedy tokens.

The JAX params are carried across with ``convert.lm_params_from_jax``;
tokens and activations are made with numpy from a seed.  Tolerance: rtol
1e-4, atol 1e-4 x max(1, |oracle|_inf) on logits, caches and MoE outputs:
the same float32 function with products summed in another order (the JAX
suite's prefill/decode check, ``test_prefill_decode_consistency``, uses
2e-3).  The port's kernels run their plain versions here (CPU tensors).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import MeshCtx
from repro.models import moe as jax_moe
from repro.models.model import LanguageModel as JaxLM
from repro.nn import module as jax_nnm
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import moe
from repro_torch.models.attention import CrossCache, KVCache, MLACache
from repro_torch.models.model import LanguageModel
from repro_torch.nn.module import ParamTree
from repro_torch.serving import ServingEngine

ARCHS = ["mamba2-780m", "granite-20b", "starcoder2-15b", "internlm2-20b",
         "gemma3-27b", "jamba-v0.1-52b", "kimi-k2-1t-a32b",
         "deepseek-v3-671b", "llama-3.2-vision-11b", "whisper-tiny"]
B, S, CACHE = 2, 24, 40


def _close(got, want):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


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


def _models(name):
    jcfg = jax_get_config(name, reduced=True)
    cfg = get_config(name, reduced=True)
    jmodel = JaxLM(jcfg)
    params = draw_gates(jmodel.init(jax.random.PRNGKey(0)))
    model = LanguageModel(cfg, device="cpu")
    model.load_state_dict(lm_params_from_jax(cfg, _np_tree(params)),
                          strict=True)
    return jcfg, jmodel, params, cfg, model


def _tokens(cfg, seed, n=S + 1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


@pytest.mark.parametrize("capacity_factor,drops", [(1.25, True),
                                                   (16.0, False)])
@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "kimi-k2-1t-a32b"])
def test_moe_forward_matches_jax(name, capacity_factor, drops):
    jcfg = jax_get_config(name, reduced=True).replace(
        capacity_factor=capacity_factor)
    cfg = get_config(name, reduced=True).replace(
        capacity_factor=capacity_factor)
    specs = jax_moe.moe_specs(jcfg)
    params = jax_nnm.init_params(specs, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    want = jax_moe.moe_forward(params, jcfg, MeshCtx.single_device(),
                               jnp.asarray(x))
    tree = ParamTree(moe.moe_specs(cfg), dtype=torch.float32,
                     device=torch.device("cpu"))
    tree.load_state_dict(lm_params_from_jax(cfg, _np_tree(params)),
                         strict=True)
    got = moe.moe_forward(tree, cfg, torch.from_numpy(x))
    _close(got, want)
    # Whether tokens were dropped: an expert got more slots than capacity.
    logits = x.reshape(-1, cfg.d_model) @ np.asarray(params["router"])
    top = np.argsort(-logits, axis=1)[:, :cfg.top_k]
    cap = int(np.ceil(60 * cfg.top_k * capacity_factor / cfg.n_experts))
    assert (np.bincount(top.ravel(), minlength=cfg.n_experts).max()
            > cap) == drops


@pytest.mark.parametrize("n_tokens,k,e_loc,e_start,capacity,drops", [
    (40, 2, 8, 0, 5, True),      # experts past their capacity: dropped
    (40, 2, 8, 0, 80, False),    # room for every choice
    (33, 3, 4, 4, 7, True),      # local experts 4..7 of 12, over capacity
    (33, 3, 4, 4, 99, False),    # the other experts' choices left out
    (1, 1, 16, 0, 1, False),
])
def test_dispatch_tables_match_jax(n_tokens, k, e_loc, e_start, capacity,
                                   drops):
    """The (E_loc, C) token and prob tables, built with an int32 scan,
    equal JAX's on the same seeded expert ids and probs, drops included."""
    rng = np.random.default_rng(n_tokens * 7 + capacity)
    n_experts = e_start + e_loc + (4 if e_start else 0)
    ids = np.stack([rng.choice(n_experts, k, replace=False)
                    for _ in range(n_tokens)])
    probs = rng.random((n_tokens, k)).astype(np.float32)
    want = jax_moe._dispatch_tables(jnp.asarray(ids), jnp.asarray(probs),
                                    e_start, e_loc, capacity, n_tokens)
    got = moe._dispatch_tables(torch.from_numpy(ids), torch.from_numpy(probs),
                               e_start, e_loc, capacity, n_tokens)
    local = ids[(ids >= e_start) & (ids < e_start + e_loc)] - e_start
    per_expert = np.bincount(local, minlength=e_loc)
    assert (per_expert.max() > capacity) == drops
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def _jax_layer_cache(cfg, jcache, layer):
    p, i = divmod(layer, cfg.period)
    if p < cfg.n_periods:
        return jax.tree.map(lambda a: np.asarray(a)[p],
                            jcache["scan"][f"pos{i}"])
    return _np_tree(jcache["rem"][f"pos{i}"])


def _check_layer_cache(cfg, c, jc):
    if isinstance(c, dict):                      # whisper's attn_cross
        assert set(c) == set(jc) == {"self", "cross"}
        for key in c:
            _check_layer_cache(cfg, c[key], jc[key])
        return
    assert type(c).__name__ == type(jc).__name__
    for field in c._fields:
        got, want = getattr(c, field), getattr(jc, field)
        if field == "pos":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            _close(got, want)
    if isinstance(c, (KVCache, MLACache, CrossCache)):
        assert c[0].dtype == cfg.cdtype


def _check_cache(cfg, cache, jcache):
    assert len(cache) == cfg.n_layers
    for layer, c in enumerate(cache):
        _check_layer_cache(cfg, c, _jax_layer_cache(cfg, jcache, layer))


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_cache_and_decode_match_jax(name):
    jcfg, jmodel, params, cfg, model = _models(name)
    ctx = MeshCtx.single_device()
    tok = _tokens(cfg, 1)
    fe = frontend_of(cfg, 7)
    want, jcache = jmodel.prefill(
        params, ctx, jnp.asarray(tok[:, :S]), CACHE,
        frontend=None if fe is None else jnp.asarray(fe))
    got, cache = model.prefill(
        torch.from_numpy(tok[:, :S]).long(), CACHE,
        frontend=None if fe is None else torch.from_numpy(fe))
    _close(got, want)
    _check_cache(cfg, cache, jcache)

    want, jcache = jmodel.decode_step(params, ctx, jnp.asarray(tok[:, S]),
                                      jcache, jnp.asarray(S, jnp.int32))
    got, cache = model.decode_step(torch.from_numpy(tok[:, S]).long(), cache,
                                   S)
    _close(got, want)
    _check_cache(cfg, cache, jcache)


def test_jamba_greedy_generate_matches_jax():
    jcfg, jmodel, params, cfg, model = _models("jamba-v0.1-52b")
    tok = _tokens(cfg, 2, n=S)
    want = JaxEngine(jmodel, MeshCtx.single_device(), CACHE).generate(
        params, jnp.asarray(tok), 8)
    got = ServingEngine(model, CACHE).generate(torch.from_numpy(tok).long(),
                                               8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_temperature_sampling_draws_from_the_generator():
    *_, cfg, model = _models("jamba-v0.1-52b")
    tok = torch.from_numpy(_tokens(cfg, 5, n=8)).long()
    eng = ServingEngine(model, 16)
    draws = [eng.generate(tok, 4, temperature=1.0,
                          generator=torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert draws[0].shape == (B, 4)
    assert int(draws[0].min()) >= 0 and int(draws[0].max()) < cfg.vocab_size


@pytest.mark.parametrize("name", ARCHS)
def test_every_config_builds_with_jaxs_parameter_tree(name):
    """The state_dict's names and shapes are JAX's tree, unstacked."""
    cfg = get_config(name, reduced=True)
    model = LanguageModel(cfg, device="cpu")
    jmodel = JaxLM(jax_get_config(name, reduced=True))
    want = lm_params_from_jax(cfg, jax.tree.map(
        lambda a: np.zeros(a.shape, np.float32), jmodel.abstract()))
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(got[k].shape == want[k].shape for k in got)


@pytest.mark.parametrize("name", ["gemma3-27b", "jamba-v0.1-52b",
                                  "deepseek-v3-671b", "llama-3.2-vision-11b",
                                  "whisper-tiny"])
def test_init_cache_matches_jax(name):
    jcfg, jmodel, _, cfg, model = _models(name)
    _check_cache(cfg, model.init_cache(B, CACHE), jmodel.init_cache(B, CACHE))
