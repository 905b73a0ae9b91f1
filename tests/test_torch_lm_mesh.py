"""LM serving on the mesh: the port's sharded models
(``repro_torch/models`` under a ``MeshCtx``) against the JAX package's.

One local world of 4 gloo ranks on the CPU (``launch.mesh.spawn_world``,
rank program ``torch_mesh_ranks.lm_mesh_cases``) builds the (2, 2), (1, 4)
and (4, 1) meshes in turn.  On each, reduced gemma3 (GQA, a sliding
window), granite (one kv head: replicated, each rank taking its q-head
groups' kv head), mamba2 (vocab 511, which no model axis here divides:
replicated, as 50,280 is on 16) and jamba (GQA, mamba-2 and the MoE) run
in float32 on JAX's weights (``convert.lm_params_from_jax(..., ctx)``, the
rank's slices): prefill logits, then 4 greedy decode steps, each fed
JAX's greedy token (the port's argmax must equal it).  The batch is 4 (split over the data axis) and, for the
dense archs on (4, 1), 2 (whole on every rank).  On (2, 2) and (1, 4)
also deepseek-v3 (MLA and the MoE: q_lora split, c_kv whole, the
absorbed decode over the local heads), llama-3.2-vision (gated
cross-attention over a numpy frontend, its gates drawn nonzero: JAX
inits them to 0; one kv head, whole under split q heads) and whisper at
6 heads (as whisper-tiny's 6: whole on (1, 4), where only the MLP splits,
3 a rank on (2, 2)) with its encoder over numpy frames, each frontend
split over data with the batch.

JAX's sharding is transparent in value, so the dense paths are held to
JAX's ``MeshCtx.single_device()`` model.  The MoE's capacity is per data
shard, so jamba and deepseek-v3 run the whole model at capacity factor 16
(no token dropped on either side), and jamba's MoE layer is held, drops
included (capacity
factor 1.25), to JAX's own shard_map branch on a forced 4-device (2, 2)
mesh in a subprocess, with the batch whole on every rank (JAX's input)
and split over data.  Tolerance: ``test_torch_lm.py``'s, rtol 1e-4, atol
1e-4 x max(1, |oracle|_inf).  Also: every rank returns the same whole
logits bit for bit; a sharded init from a seed equals the slices of the
unsharded init from that seed bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import MeshCtx
from repro.models.model import LanguageModel as JaxLM
from repro_torch.launch.mesh import spawn_world

S, STEPS, CACHE = 24, 4, 40
SHAPES = [(2, 2), (1, 4), (4, 1)]
MESH_2 = [(2, 2), (1, 4)]
CASES = [  # key, arch, config changes, batch, mesh shapes
    ("gemma3", "gemma3-27b", {}, 4, SHAPES),
    ("gemma3-b2", "gemma3-27b", {}, 2, [(4, 1)]),
    ("granite", "granite-20b", {}, 4, SHAPES),
    ("granite-b2", "granite-20b", {}, 2, [(4, 1)]),
    ("mamba2", "mamba2-780m", {"vocab_size": 511}, 4, SHAPES),
    ("mamba2-b2", "mamba2-780m", {"vocab_size": 511}, 2, [(4, 1)]),
    ("jamba", "jamba-v0.1-52b", {"capacity_factor": 16.0}, 4, SHAPES),
    ("deepseek", "deepseek-v3-671b", {"capacity_factor": 16.0}, 4, MESH_2),
    ("llama-vision", "llama-3.2-vision-11b", {}, 4, MESH_2),
    ("whisper", "whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}, 4,
     MESH_2),
]
MOE_CF = 1.25

JAX_MOE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import get_config
    from repro.distributed.sharding import MeshCtx
    from repro.launch.mesh import make_local_mesh
    from repro.models import moe
    from repro.nn.module import init_params
    cfg = get_config("jamba-v0.1-52b", reduced=True).replace(
        capacity_factor=float(sys.argv[2]))
    params = init_params(moe.moe_specs(cfg), jax.random.PRNGKey(3))
    x = np.random.default_rng(4).standard_normal(
        (4, 6, cfg.d_model)).astype(np.float32)
    ctx = MeshCtx.for_mesh(make_local_mesh(2, 2), "decode")
    y = moe.moe_forward(params, cfg, ctx, jnp.asarray(x))
    one = moe.moe_forward(params, cfg, MeshCtx.single_device(),
                          jnp.asarray(x))
    np.savez(sys.argv[1], x=x, y=np.asarray(y), one=np.asarray(one),
             **{k: np.asarray(v) for k, v in params.items()})
    print("JAX_MOE_OK")
""")


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-4,
                               atol=1e-4 * scale, err_msg=what)


def _gates_drawn(params, seed):
    """JAX's tree with every cross-attention gate drawn nonzero (JAX
    inits them to 0, which switches the cross layers off)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if path[-1].key == "gate":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def _jax_case(arch, changes, batch, seed):
    cfg = jax_get_config(arch, reduced=True).replace(**changes)
    model = JaxLM(cfg)
    params = _gates_drawn(model.init(jax.random.PRNGKey(seed)), seed)
    rng = np.random.default_rng(seed + 1)
    prompt = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int32)
    fe = (rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model))
          .astype(np.float32) if cfg.n_frontend_tokens else None)
    ctx = MeshCtx.single_device()
    lg, cache = model.prefill(params, ctx, jnp.asarray(prompt), CACHE,
                              frontend=None if fe is None
                              else jnp.asarray(fe))
    steps, greedy = [np.asarray(lg)], []
    for t in range(S, S + STEPS):
        greedy.append(np.argmax(steps[-1], axis=-1).astype(np.int32))
        lg, cache = model.decode_step(params, ctx, jnp.asarray(greedy[-1]),
                                      cache, jnp.asarray(t, jnp.int32))
        steps.append(np.asarray(lg))
    tok = np.concatenate([prompt, np.stack(greedy, axis=1)], axis=1)
    return jax.tree.map(np.asarray, params), tok, fe, steps


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", "src"))
    env.pop("XLA_FLAGS", None)
    npz = str(tmp / "moe.npz")
    proc = subprocess.Popen([sys.executable, "-c", JAX_MOE, npz,
                             str(MOE_CF)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cases, oracles = [], {}
    for i, (key, arch, changes, batch, shapes) in enumerate(CASES):
        params, tok, fe, steps = _jax_case(arch, changes, batch, seed=i)
        oracles[key] = (steps, tok)
        cases.append(dict(key=key, name=arch, params=params, tokens=tok,
                          frontend=fe, prompt=S, cache=CACHE, shapes=shapes,
                          changes=changes))
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "JAX_MOE_OK" in out, err[-3000:]
    z = dict(np.load(npz))
    moe_case = {"cf": MOE_CF, "x": z["x"],
                "params": {k: z[k] for k in ("router", "w_gate", "w_up",
                                             "w_down")}}
    res = spawn_world(ranks.lm_mesh_cases, 4, (cases, moe_case),
                      workdir=str(tmp))
    return oracles, z, res


RUNS = [(c[0], shape) for c in CASES for shape in c[4]]


@pytest.mark.distributed
@pytest.mark.parametrize("key,shape", RUNS,
                         ids=[f"{k}-{d}x{m}" for k, (d, m) in RUNS])
def test_prefill_and_decode_match_jax(world, key, shape):
    oracles, _, res = world
    want, tok = oracles[key]
    for r in range(4):
        got = res[r]["lm"][(key, shape)]
        assert len(got) == 1 + STEPS
        for t, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{key} on {shape}, rank {r}, step {t}")
            # The whole logits on every rank, the same bits.
            np.testing.assert_array_equal(g, res[0]["lm"][(key, shape)][t])
            # The port's greedy token is JAX's, which the next step fed.
            if t < STEPS:
                np.testing.assert_array_equal(np.argmax(g, axis=-1),
                                              tok[:, S + t])


@pytest.mark.distributed
@pytest.mark.parametrize("arm", ["whole", "split"])
def test_moe_layer_matches_jax_shard_map(world, arm):
    """jamba's MoE layer on (2, 2) against JAX's expert-parallel branch on
    a (2, 2) mesh, drops included: the shard_map's output differs from the
    single-device one (capacity per data shard), and the port's follows
    the shard_map's."""
    _, z, res = world
    cfg = jax_get_config("jamba-v0.1-52b", reduced=True)
    want = z["y"]
    assert np.abs(want - z["one"]).max() > 1e-3, "no token dropped"
    # Drops: an expert past the capacity of a data shard's 12 tokens.
    x = z["x"].reshape(-1, cfg.d_model)
    top = np.argsort(-(x @ z["router"]), axis=1)[:, :cfg.top_k]
    cap = int(np.ceil(12 * cfg.top_k * MOE_CF / cfg.n_experts))
    assert max(np.bincount(top[h:h + 12].ravel(), minlength=cfg.n_experts)
               .max() for h in (0, 12)) > cap
    for r in range(4):
        m = res[r]["moe"]
        if arm == "whole":
            _close(m["whole"], want, f"rank {r}")
        else:
            lo = m["d"] * m["b_loc"]
            _close(m["split"], want[lo:lo + m["b_loc"]], f"rank {r}")


@pytest.mark.distributed
def test_sharded_init_equals_the_unsharded_slices(world):
    _, _, res = world
    for r in range(4):
        init = res[r]["init"]
        assert init and all(ok for ok, _, _ in init.values()), [
            k for k, (ok, _, _) in init.items() if not ok]
        # Something is sharded: the rank holds less than the whole.
        assert any(got != full for _, got, full in init.values())
        # conv_w holds the local x channels and every B / C channel.
        _, got, full = init["layers.0.mixer.conv_w"]
        assert got[1] == (full[1] - 32) // 2 + 32
