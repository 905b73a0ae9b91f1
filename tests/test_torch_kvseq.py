"""Decode caches sharded over ``kv_seq`` (``repro_torch/models/attention.py``
``CacheLayout``) against the JAX package's single-device decode.

One local world of 4 gloo ranks on the CPU (``launch.mesh.spawn_world``)
builds two meshes in turn, each under the rules that shard the cache's
slots: (4, 1) under the ``long_decode`` rules (``kv_seq`` over the data
axis, the batch whole on every rank) and (1, 4) under the ``decode`` rules
with the dry-run's override ``kv_seq`` over the model axis (the kv heads
then whole in the cache, the q heads split: each rank gathers q and keeps
its heads after the combine).  On each, four reduced configs in float32
on JAX's weights (``convert.lm_params_from_jax(..., ctx)``): granite (GQA,
one kv head), gemma3 (five local layers on a 16-slot ring and a global
one; also at 8 q and 4 kv heads, whose ``w_k`` the model axis splits
while the override's cache holds every kv head: the rank's K / V are
gathered over the axis) and deepseek-v3 (MLA's absorbed decode,
capacity factor 16: no token dropped).  Each prefills 21 tokens into a 32-slot cache, then decodes 6
steps teacher-forced with JAX's greedy tokens: the new tokens' slots move
from one rank's slice to the next (the global cache's 8-slot slices at
slot 24, the ring's 4-slot ones at slot 8).  Held to JAX's
``MeshCtx.single_device()`` decode at the LM tests' tolerance (rtol 1e-4,
atol 1e-4 x max(1, |oracle|_inf)), every rank's logits the same bits; and
every rank's cache leaves, after the prefill and from ``init_cache``, have
the local shapes of JAX's ``stack_cache_pspecs`` on that mesh.

The rank program (``kvseq_ranks``) lives here and imports no JAX: the
spawned ranks import this module, and JAX is imported by the test process
alone, inside the functions that use it.
"""
import numpy as np
import pytest
import torch

S, STEPS, CACHE = 21, 6, 32
ARCHS = [  # key, arch, config changes
    ("granite", "granite-20b", {}),
    ("gemma3", "gemma3-27b", {}),
    # 4 kv heads split over (1, 4)'s model axis in w_k, whole in the cache
    # under the override: the new token's K / V gathered over the axis.
    ("gemma3-kv4", "gemma3-27b", {"n_heads": 8, "n_kv_heads": 4}),
    ("deepseek", "deepseek-v3-671b", {"capacity_factor": 16.0}),
]
MESHES = [  # mesh shape, rules kind, rule overrides
    ((4, 1), "long_decode", {}),
    ((1, 4), "decode", {"kv_seq": "model"}),
]
BATCH = 2


def _cache_shapes(cache):
    """Per layer, each cache leaf's shape, by field."""
    out = []
    for c in cache:
        out.append({f: tuple(getattr(c, f).shape) for f in c._fields})
    return out


def kvseq_ranks(rank, cases):
    """Each case on each mesh: prefill logits and the decode steps' (B, V)
    logits, the cache's leaf shapes after the prefill and from
    ``init_cache``, and the layouts' slot ranges."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.distributed.sharding import MeshCtx
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import LanguageModel
    out = {}
    for shape, kind, over in MESHES:
        mesh = make_local_mesh(*shape, backend="gloo", device="cpu")
        ctx = MeshCtx.for_mesh(mesh, kind, over)
        for c in cases:
            cfg = get_config(c["name"], reduced=True).replace(**c["changes"])
            model = LanguageModel(cfg, device="cpu", ctx=ctx)
            model.load_state_dict(lm_params_from_jax(cfg, c["params"],
                                                     ctx=ctx), strict=True)
            tok = torch.from_numpy(c["tokens"]).long()
            lg, cache = model.prefill(tok[:, :S], CACHE)
            prefill_shapes = _cache_shapes(cache)
            layouts = [None if blk.layout is None else
                       (blk.layout.seq_axes, blk.layout.lo, blk.layout.hi)
                       for blk in model.layers]
            steps = [lg.numpy()]
            for t in range(S, S + STEPS):
                lg, cache = model.decode_step(tok[:, t], cache, t)
                steps.append(lg.numpy())
            out[(c["key"], shape)] = {
                "steps": steps, "prefill": prefill_shapes,
                "init": _cache_shapes(model.init_cache(BATCH, CACHE)),
                "layouts": layouts, "coord": mesh.coordinate}
    return out


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-4 * scale, err_msg=what)


def _jax_case(arch, changes, seed):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.distributed.sharding import MeshCtx
    from repro.models.model import LanguageModel as JaxLM
    cfg = jax_get_config(arch, reduced=True).replace(**changes)
    model = JaxLM(cfg)
    params = model.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, S)).astype(np.int32)
    ctx = MeshCtx.single_device()
    lg, cache = model.prefill(params, ctx, jnp.asarray(prompt), CACHE)
    steps, greedy = [np.asarray(lg)], []
    for t in range(S, S + STEPS):
        greedy.append(np.argmax(steps[-1], axis=-1).astype(np.int32))
        lg, cache = model.decode_step(params, ctx, jnp.asarray(greedy[-1]),
                                      cache, jnp.asarray(t, jnp.int32))
        steps.append(np.asarray(lg))
    tok = np.concatenate([prompt, np.stack(greedy, axis=1)], axis=1)
    return jax.tree.map(np.asarray, params), tok, steps


def _jax_local_cache_shapes(arch, changes, mesh_shape, kind, over):
    """Per layer, JAX's cache leaves' local shapes on the mesh: the
    ``init_cache`` shapes over ``stack_cache_pspecs`` (the stack dim of a
    scanned period dropped)."""
    import math
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.distributed.sharding import make_rules
    from repro.models import blocks
    from repro.models.model import LanguageModel as JaxLM
    cfg = jax_get_config(arch, reduced=True).replace(**changes)
    sizes = dict(zip(("data", "model"), mesh_shape))
    rules = make_rules(kind)
    rules.update(over)
    abs_cache = jax.eval_shape(lambda: JaxLM(cfg).init_cache(BATCH, CACHE))
    specs = blocks.stack_cache_pspecs(cfg, rules, BATCH, CACHE,
                                      cfg.n_frontend_tokens, sizes)

    def local(a, p):
        dims = []
        for i, n in enumerate(a.shape):
            e = p[i] if i < len(p) else None
            ax = () if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e))
            dims.append(n // math.prod(sizes[x] for x in ax))
        return tuple(dims)

    out = []
    for layer in range(cfg.n_layers):
        p, i = divmod(layer, cfg.period)
        stacked = p < cfg.n_periods
        part = "scan" if stacked else "rem"
        a_tree, s_tree = abs_cache[part][f"pos{i}"], specs[part][f"pos{i}"]
        leaves = {}
        for f in a_tree._fields:
            shape = local(getattr(a_tree, f), getattr(s_tree, f))
            leaves[f] = shape[1:] if stacked else shape
        out.append(leaves)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_world
    cases, oracles = [], {}
    for i, (key, arch, changes) in enumerate(ARCHS):
        params, tok, steps = _jax_case(arch, changes, seed=10 + i)
        oracles[key] = steps
        cases.append(dict(key=key, name=arch, params=params, tokens=tok,
                          changes=changes))
    res = spawn_world(kvseq_ranks, 4, (cases,),
                      workdir=str(tmp_path_factory.mktemp("kvseq")),
                      timeout_s=300.0)
    return oracles, res


RUNS = [(key, m) for key, _, _ in ARCHS for m in range(len(MESHES))]


@pytest.mark.distributed
@pytest.mark.parametrize("key,m", RUNS,
                         ids=[f"{k}-{MESHES[m][0][0]}x{MESHES[m][0][1]}"
                              for k, m in RUNS])
def test_sharded_decode_matches_jax(world, key, m):
    oracles, res = world
    shape = MESHES[m][0]
    want = oracles[key]
    for r in range(4):
        got = res[r][(key, shape)]["steps"]
        assert len(got) == 1 + STEPS
        for t, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{key} on {shape}, rank {r}, step {t}")
            np.testing.assert_array_equal(g, res[0][(key, shape)]["steps"][t])


@pytest.mark.distributed
@pytest.mark.parametrize("key,m", RUNS,
                         ids=[f"{k}-{MESHES[m][0][0]}x{MESHES[m][0][1]}"
                              for k, m in RUNS])
def test_cache_shapes_are_jax_local_shapes(world, key, m):
    _, res = world
    shape, kind, over = MESHES[m]
    arch, changes = [(a, c) for k, a, c in ARCHS if k == key][0]
    want = _jax_local_cache_shapes(arch, changes, shape, kind, over)
    for r in range(4):
        got = res[r][(key, shape)]
        assert got["prefill"] == want, f"rank {r}: prefill cache"
        assert got["init"] == want, f"rank {r}: init_cache"
        # The slots are split: each rank holds its quarter of every
        # attention cache, at its coordinate on the split axis.
        axis = 0 if shape == (4, 1) else 1
        idx = got["coord"][axis]
        for layout, leaves in zip(got["layouts"], want):
            assert layout is not None
            axes, lo, hi = layout
            n = hi - lo
            assert axes is not None and lo == idx * n
            assert leaves["pos"] == (n,)
