"""LM training on the mesh: the port's sharded training step
(``repro_torch/train/step.py`` over models under ``MeshCtx.for_mesh(mesh,
"train")``) against the JAX package's single device, on the CPU at the
reduced configs in float32, B 4, S 16.

One local world of 4 gloo ranks (``launch.mesh.spawn_world``, rank
program ``torch_mesh_ranks.lm_train_cases``) runs (2, 2) and (1, 4) in
turn under JAX's ``train`` rules (embed over data: ZeRO; heads, kv heads,
mlp, vocab, experts, q_lora and SSM heads over model; the experts' FFN
dim over data), each rank on its data shard of the batch.  For gemma3,
granite (one kv head), mamba2, jamba, deepseek-v3 (MLA), llama-3.2-vision
(gated cross-attention over a numpy frontend, its gates drawn nonzero)
and whisper (its encoder over numpy frames; 6 heads, as whisper-tiny's:
whole on (1, 4), 3 a rank on (2, 2)), from test_torch_lm_train's seeded
weights (jamba and deepseek-v3 at capacity factor 16: the MoE's capacity
is per data shard, so only a run that drops nothing is one device's):

* step 0's loss, every gradient (gathered whole from the shards) and the
  global gradient norm equal ``jax.value_and_grad`` of JAX's
  ``model.loss`` on one device and JAX's ``global_norm``;
* a parameter replicated over ranks has the same gradient, bit for bit,
  on every rank that holds it;
* 3 AdamW steps (cosine, warmup 2 of 5, lr 3e-3): the losses, the grad
  norms, and the parameters and both moments after them equal JAX's
  ``optimizer.update`` trajectory, the optimizer's count 3;
* with microbatches 2 one SGD step equals microbatches 1 on the mesh
  (granite and whisper with its frames);
* JAX's parameters and AdamW state after 2 steps, carried across to the
  ranks' slices (``convert.lm_params_from_jax`` / ``lm_opt_state_from_jax``
  with ``ctx``), take JAX's third step on (2, 2) (granite);
* jamba's MoE layer with capacity drops (factor 1.25) on (2, 2), the
  batch split over data: its output, the load-balance loss (over the
  global tokens) and the gradients of sum(y * w) + 3 aux with respect to
  x and every expert weight equal ``jax.grad`` through JAX's shard_map
  branch on a forced 4-device (2, 2) mesh in a subprocess (which drops
  other tokens than one device: the gradients differ from one
  device's).

Tolerance: ``test_torch_lm_train.py``'s, rtol 1e-4, atol 1e-4 x max(1,
|oracle|_inf), with its exception for gemma3's gradients (every element
at atol 1e-3 x |oracle|_inf, at most 1e-4 of the elements beyond the
stated tolerance).
"""
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import MeshCtx
from repro.models.model import LanguageModel as JaxLM
from repro.optim import global_norm as jax_global_norm
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import make_schedule as jax_make_schedule
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch.mesh import spawn_world
from test_torch_lm_train import _jax_params, _np_tree

B, S, STEPS, LR = 4, 16, 3, 3e-3
CTX = MeshCtx.single_device()
SHAPES = [(2, 2), (1, 4)]
CASES = [  # key, arch, config changes, microbatch check
    ("gemma3", "gemma3-27b", {}, False),
    ("granite", "granite-20b", {}, True),
    ("mamba2", "mamba2-780m", {}, False),
    ("jamba", "jamba-v0.1-52b", {"capacity_factor": 16.0}, False),
    ("deepseek", "deepseek-v3-671b", {"capacity_factor": 16.0}, False),
    ("llama-vision", "llama-3.2-vision-11b", {}, False),
    ("whisper", "whisper-tiny", {"n_heads": 6, "n_kv_heads": 6}, True),
]
RUNS = [(c[0], s) for c in CASES for s in SHAPES]
IDS = [f"{k}-{d}x{m}" for k, (d, m) in RUNS]
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
    params = init_params(moe.moe_specs(cfg), jax.random.PRNGKey(5))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 6, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((4, 6, cfg.d_model)).astype(np.float32)
    out = {}
    for tag, ctx in (("mesh", MeshCtx.for_mesh(make_local_mesh(2, 2),
                                               "train")),
                     ("one", MeshCtx.single_device())):
        def obj(p, xx):
            y, aux = moe.moe_forward(p, cfg, ctx, xx, with_aux=True)
            return jnp.sum(y * w) + 3.0 * aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        out[f"{tag}_y"] = np.asarray(y)
        out[f"{tag}_aux"] = np.asarray(aux)
        out[f"{tag}_gx"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{tag}_g_{k}"] = np.asarray(v)
    np.savez(sys.argv[1], x=x, w=w, **out,
             **{k: np.asarray(v) for k, v in params.items()})
    print("JAX_MOE_OK")
""")


def _close(got, want, atol=1e-4, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol * scale,
                               err_msg=what)


def _batches(cfg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32),
             "frontend": None}
        if cfg.n_frontend_tokens:
            b["frontend"] = rng.standard_normal(
                (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def _jax_run(arch, changes, batches, keep_at=None):
    """JAX on one device from the port's seeded weights: step 0's loss and
    gradients (port names), then STEPS AdamW steps' losses and grad norms
    and the parameters and moments after them; with ``keep_at``, JAX's
    parameter and optimizer trees (numpy) after that many steps."""
    case = {"name": arch, "changes": changes}
    ref = ranks._seeded_lm(case)
    cfg = ref.cfg
    jmodel = JaxLM(jax_get_config(arch, reduced=True).replace(**changes))
    params = _jax_params(jmodel, cfg, ref.state_dict())
    vg = jax.jit(jax.value_and_grad(
        lambda p, t, l, f: jmodel.loss(p, CTX, t, l, frontend=f,
                                       loss_chunks=4)))
    jopt = jax_make_optimizer("adamw", jax_make_schedule(
        "cosine", LR, warmup_steps=2, total_steps=5))
    upd = jax.jit(jopt.update)
    state = jopt.init(params)
    out = {"metrics": []}
    for i, b in enumerate(batches):
        if i == keep_at:
            out["kept"] = (_np_tree(params), _np_tree(state))
        fe = None if b["frontend"] is None else jnp.asarray(b["frontend"])
        loss, grads = vg(params, jnp.asarray(b["tokens"]),
                         jnp.asarray(b["labels"]), fe)
        if i == 0:
            out["loss0"] = float(loss)
            out["grads"] = {k: v.numpy() for k, v in lm_params_from_jax(
                cfg, _np_tree(grads)).items()}
        out["metrics"].append((float(loss), float(jax_global_norm(grads))))
        params, state = upd(grads, state, params)
    out["params"] = {k: v.numpy() for k, v in lm_params_from_jax(
        cfg, _np_tree(params)).items()}
    for mo in ("m", "v"):
        out[mo] = {k: v.numpy() for k, v in lm_params_from_jax(
            cfg, _np_tree(state[mo])).items()}
    out["count"] = int(state["count"])
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_train_mesh")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                      "src"))])
    env.pop("XLA_FLAGS", None)
    npz = str(tmp / "moe.npz")
    proc = subprocess.Popen([sys.executable, "-c", JAX_MOE, npz,
                             str(MOE_CF)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    cases, oracles = [], {}
    for i, (key, arch, changes, mb) in enumerate(CASES):
        cfg = ranks._seeded_lm({"name": arch, "changes": changes}).cfg
        batches = _batches(cfg, seed=10 + i)
        cases.append(dict(key=key, name=arch, changes=changes,
                          batches=batches, mb=mb))
    # The ranks train while JAX computes its references here.
    result = {}

    def run_world():
        try:
            result["res"] = spawn_world(ranks.lm_train_cases, 4,
                                        (cases, SHAPES, LR), timeout_s=600,
                                        workdir=str(tmp))
        except BaseException as e:          # re-raised below
            result["err"] = e

    thread = threading.Thread(target=run_world)
    thread.start()
    for (key, arch, changes, _), c in zip(CASES, cases):
        oracles[key] = _jax_run(arch, changes, c["batches"],
                                keep_at=STEPS - 1 if key == "granite"
                                else None)
    thread.join()
    if "err" in result:
        raise result["err"]
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "JAX_MOE_OK" in out, err[-3000:]
    z = dict(np.load(npz))
    moe_case = {"cf": MOE_CF, "x": z["x"], "w": z["w"],
                "params": {k: z[k] for k in ("router", "w_gate", "w_up",
                                             "w_down")}}
    moe_res = spawn_world(ranks.moe_train_case, 4, (moe_case,),
                          timeout_s=300, workdir=str(tmp))
    params, opt = oracles["granite"].pop("kept")
    granite = next(c for c in cases if c["key"] == "granite")
    carried = spawn_world(ranks.lm_jax_state_case, 4, (dict(
        granite, params=params, opt=opt, lr=LR,
        batch=granite["batches"][-1]), (2, 2)), timeout_s=300,
        workdir=str(tmp))
    oracles["granite"]["carried"] = carried
    return oracles, result["res"], z, moe_res


def _hold_grads(key, got, want):
    assert set(got) == set(want)
    if key != "gemma3":
        for k, g in got.items():
            _close(g, want[k], what=k)
        return
    beyond = total = 0
    for k, g in got.items():
        _close(g, want[k], atol=1e-3, what=k)
        w = np.asarray(want[k], np.float64)
        scale = max(1.0, float(np.abs(w).max()))
        beyond += int((np.abs(np.asarray(g, np.float64) - w)
                       > 1e-4 * np.abs(w) + 1e-4 * scale).sum())
        total += w.size
    assert beyond <= 1e-4 * total, (beyond, total)


@pytest.mark.distributed
@pytest.mark.parametrize("key,shape", RUNS, ids=IDS)
def test_loss_gradients_and_norm_match_jax(world, key, shape):
    oracles, res, _, _ = world
    want = oracles[key]
    got = res[0][(key, shape)]
    for r in range(4):
        mine = res[r][(key, shape)]
        # Every rank holds the step's loss and norm.
        assert mine["loss0"] == got["loss0"] and mine["gn0"] == got["gn0"]
    _close(got["loss0"], want["loss0"], what="loss")
    _close(got["gn0"], want["metrics"][0][1], what="grad norm")
    _hold_grads(key, got["grads"], want["grads"])


@pytest.mark.distributed
@pytest.mark.parametrize("key,shape", RUNS, ids=IDS)
def test_replicated_parameters_have_equal_gradients(world, key, shape):
    _, res, _, _ = world
    seen, split = {}, 0
    for r in range(4):
        for name, (index, crc) in res[r][(key, shape)]["local"].items():
            prev = seen.setdefault((name, index), crc)
            assert prev == crc, (name, index, r)
    names = {n for n, _ in seen}
    # Something is split: some parameter has more than one slice.
    split = sum(sum(1 for n, _ in seen if n == name) > 1 for name in names)
    assert split > 0


@pytest.mark.distributed
@pytest.mark.parametrize("key,shape", RUNS, ids=IDS)
def test_adamw_trajectory_matches_jax(world, key, shape):
    oracles, res, _, _ = world
    want = oracles[key]
    got = res[0][(key, shape)]
    assert got["count"] == want["count"] == STEPS
    for i, ((gl, gn), (wl, wn)) in enumerate(zip(got["metrics"],
                                                 want["metrics"])):
        _close(gl, wl, what=f"loss at step {i}")
        _close(gn, wn, what=f"grad norm at step {i}")
    for k, p in got["final"]["params"].items():
        _close(p, want["params"][k], what=k)
    for mo in ("m", "v"):
        for k, t in got["final"][mo].items():
            _close(t, want[mo][k], atol=1e-3 if key == "gemma3" else 1e-4,
                   what=f"{mo} {k}")


MB_RUNS = [(c[0], s) for c in CASES if c[3] for s in SHAPES]


@pytest.mark.distributed
@pytest.mark.parametrize("key,shape", MB_RUNS,
                         ids=[f"{k}-{d}x{m}" for k, (d, m) in MB_RUNS])
def test_microbatches_two_equal_one_on_the_mesh(world, key, shape):
    _, res, _, _ = world
    mb = res[0][(key, shape)]["mb"]
    _close(mb[2][0], mb[1][0], what="loss")
    _close(mb[2][1], mb[1][1], what="grad norm")
    for k, p in mb[1][2].items():
        _close(mb[2][2][k], p, what=k)


@pytest.mark.distributed
def test_moe_gradient_with_drops_matches_jax_shard_map(world):
    _, _, z, moe = world
    from repro_torch.configs import get_config
    cfg = get_config("jamba-v0.1-52b", reduced=True)
    # Drops: an expert past the capacity of a data shard's 12 tokens, and
    # the shard_map's function is not one device's.
    x = z["x"].reshape(-1, cfg.d_model)
    top = np.argsort(-(x @ z["router"]), axis=1)[:, :cfg.top_k]
    cap = int(np.ceil(12 * cfg.top_k * MOE_CF / cfg.n_experts))
    assert max(np.bincount(top[h:h + 12].ravel(), minlength=cfg.n_experts)
               .max() for h in (0, 12)) > cap
    assert np.abs(z["mesh_g_w_up"] - z["one_g_w_up"]).max() > 1e-3
    for r in range(4):
        m = moe[r]
        lo = m["d"] * m["b_loc"]
        _close(m["y"], z["mesh_y"][lo:lo + m["b_loc"]], what=f"y rank {r}")
        _close(m["aux"], z["mesh_aux"], what=f"aux rank {r}")
        _close(m["gx"], z["mesh_gx"][lo:lo + m["b_loc"]],
               what=f"dx rank {r}")
    for k, g in moe[0]["grads"].items():
        _close(g, z[f"mesh_g_{k}"], what=k)


@pytest.mark.distributed
def test_jax_adamw_state_continues_on_the_mesh(world):
    oracles, _, _, _ = world
    want = oracles["granite"]
    got = want["carried"]
    for r in range(4):
        assert got[r]["count"] == STEPS
        _close(got[r]["loss"], want["metrics"][-1][0], what="loss")
        _close(got[r]["grad_norm"], want["metrics"][-1][1], what="norm")
    for k, p in got[0]["final"]["params"].items():
        _close(p, want["params"][k], what=k)
    for mo in ("m", "v"):
        for k, t in got[0]["final"][mo].items():
            _close(t, want[mo][k], what=f"{mo} {k}")
