"""Rank programs of the port's mesh tests (tests/test_torch_mesh*.py).

Each function runs on one rank of a local gloo world that
``repro_torch.launch.mesh.spawn_world`` starts on the CPU, and returns
numpy values for the test process to hold against the JAX package.  This
module imports nothing of JAX: the ranks are fresh processes, and the
JAX references are computed in the test process.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch


def _mesh(shape):
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(*shape, backend="gloo", device="cpu")


def _cfg(kw):
    from repro_torch.core.dsekl import DSEKLConfig
    return DSEKLConfig(**kw)


def _pc(arrays):
    from repro_torch.core.dsekl import PrecondBlock
    if arrays is None:
        return None
    return PrecondBlock(*(torch.from_numpy(np.asarray(arrays[k])).clone()
                          for k in ("rows", "vectors", "damping",
                                    "indices")))


def step_cases(rank, shape, x_np, y_np, cases):
    """Run each case's steps on this rank: ``case = {"cfg": kw, "plans":
    [(idx_i, idx_j) a step], "pc": arrays or None}``.  Steps without a
    preconditioner run ``make_distributed_step`` on the device-resident
    shards; with one, ``make_distributed_block_step`` on the blocks
    ``gather_mesh_blocks_from`` reads from the per-shard sources.  Returns
    the coordinate and, per case, the alpha / accum shards and the step."""
    from repro_torch.core import distributed as D
    from repro_torch.data import HostSource
    mesh = _mesh(shape)
    n = x_np.shape[0]
    x, y = torch.from_numpy(x_np), torch.from_numpy(y_np)
    xg, yg, xe = D.shard_inputs(mesh, x, y)
    src = HostSource(x_np, y_np)
    dsrc, msrc = src.split(shape[0]), src.split(shape[1])
    out = []
    for case in cases:
        cfg, pc = _cfg(case["cfg"]), _pc(case.get("pc"))
        st = D.init_sharded_state(mesh, n)
        if pc is None:
            step = D.make_distributed_step(cfg, mesh, n)
            for plan in case["plans"]:
                st = step(xg, yg, xe, st, tuple(torch.from_numpy(p)
                                                for p in plan))
        else:
            step = D.make_distributed_block_step(cfg, mesh, n,
                                                 precondition=True)
            for idx_i, idx_j in case["plans"]:
                blocks = D.gather_mesh_blocks_from(idx_i, idx_j, dsrc, msrc,
                                                   mesh.coordinate)
                xi, yi, xj, ij = (torch.from_numpy(b) for b in blocks)
                st = step(xi, yi, xj, ij.to(torch.int64), st, pc)
        out.append({"alpha": st.alpha.numpy(), "accum": st.accum.numpy(),
                    "step": int(st.step),
                    "full": D.gather_model_shards(mesh, st.alpha).numpy()})
    return {"coord": mesh.coordinate, "cases": out}


def compressed_step(rank, shape, x_np, y_np, cfg_kw, plan, bits):
    """One step with and without ``compress_bits``, on the same block and
    a const rate: this rank's alpha shards, and the data axis's max |g|
    before the reduction (what the error bound is stated in)."""
    import torch.distributed as dist
    from repro_torch.core import distributed as D, dsekl, losses
    mesh = _mesh(shape)
    n = x_np.shape[0]
    cfg = _cfg(cfg_kw)
    x, y = torch.from_numpy(x_np), torch.from_numpy(y_np)
    xg, yg, xe = D.shard_inputs(mesh, x, y)
    idx_i, idx_j = (torch.from_numpy(p) for p in plan)
    d, m = mesh.coordinate
    xi, yi, xj = xg[idx_i[d]], yg[idx_i[d]], xe[idx_j[m]]
    st = D.init_sharded_state(mesh, n)
    st = st._replace(alpha=torch.from_numpy(
        np.random.default_rng(5).standard_normal(n).astype(np.float32)
        [m * (n // shape[1]):(m + 1) * (n // shape[1])]))
    aj = st.alpha[idx_j[m]]
    f = D._sum(dsekl._block_f(cfg, xi, xj, aj, n), mesh, "model")
    v = losses.get_loss(cfg.loss).grad_f(f, yi)
    g_loc = dsekl._block_grad(cfg.replace(lam=0.0), xi, xj, aj, v)
    gmax = g_loc.abs().max().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=mesh.group("data"))
    step = D.make_distributed_step(cfg, mesh, n)
    step_c = D.make_distributed_step(cfg.replace(compress_bits=bits), mesh, n)
    gen = torch.Generator().manual_seed(3)
    exact = step(xg, yg, xe, st, (idx_i, idx_j))
    comp = step_c(xg, yg, xe, st, (idx_i, idx_j), generator=gen)
    return {"coord": mesh.coordinate, "exact": exact.alpha.numpy(),
            "comp": comp.alpha.numpy(), "gmax": float(gmax[0])}


def fit_world(rank, shape, x_np, y_np, mmap_dir, ckpt_root, cfg_kw, jax_run,
              bcd_kw, bcd_shards_ref):
    """The fit on a mesh world: prefetch == sync over a HostSource and a
    memmap ManifestSource; resumed == uninterrupted; a JAX checkpoint
    (``jax_run``: its directory and the plans of the epochs) resumed; the
    BCD fit against the serial ``BCDPlan`` with ``bcd_shards`` = n_data
    (run on rank 0 in this process); EigenPro on the mesh.  Returns what
    the test checks, per rank."""
    import torch.distributed as dist
    from repro_torch.checkpoint import read_checkpoint
    from repro_torch.convert import mesh_state_from_jax
    from repro_torch.core import distributed as D, fit
    from repro_torch.data import HostSource, ManifestSource
    mesh = _mesh(shape)
    cfg = _cfg(cfg_kw)
    out = {"coord": mesh.coordinate}
    xv = torch.from_numpy(x_np[:32])
    yv = torch.from_numpy(y_np[:32])

    def run(src, seed=0, **kw):
        args = dict(execution="mesh", mesh=mesh, n_epochs=3, tol=0.0,
                    x_val=xv, y_val=yv, device="cpu")
        args.update(kw)
        return fit(cfg, src, None, torch.Generator().manual_seed(seed),
                   **args)

    host = HostSource(x_np, y_np)
    manifest = ManifestSource(mmap_dir)
    same = {}
    for name, src in (("host", host), ("manifest", manifest)):
        a = run(src)
        b = run(src, prefetch=False)
        same[f"{name} prefetch == sync"] = (
            torch.equal(a.state.alpha, b.state.alpha)
            and torch.equal(a.state.accum, b.state.accum))
        out[f"{name}_alpha"] = D.gather_model_shards(mesh,
                                                     a.state.alpha).numpy()
        out[f"{name}_steps"] = int(a.state.step)
        out[f"{name}_loader"] = a.loader
    full = run(host)
    ck = os.path.join(ckpt_root, "resume")
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
    dist.barrier()
    run(host, checkpoint_dir=ck, on_epoch=lambda e, st, rec: e == 1)
    resumed = run(host, checkpoint_dir=ck, resume=True)
    same["resumed == uninterrupted"] = (
        torch.equal(resumed.state.alpha, full.state.alpha)
        and torch.equal(resumed.state.accum, full.state.accum)
        and [h["delta_alpha"] for h in resumed.history]
        == [h["delta_alpha"] for h in full.history])
    if rank == 0:
        _, flat, _ = read_checkpoint(ck)
        out["ckpt_alpha"] = flat["alpha"]
    out["full_history"] = [h["delta_alpha"] for h in full.history]
    out["val_errors"] = [h.get("val_error") for h in full.history]
    # A JAX checkpoint (global state after epoch 1) resumed on this mesh.
    jdir, jplans = jax_run
    _, jflat, _ = read_checkpoint(jdir)
    placed = mesh_state_from_jax(jflat, mesh)
    shard = D.state_shard(mesh, torch.from_numpy(jflat["alpha"]))
    same["mesh_state_from_jax shard"] = torch.equal(placed.alpha, shard)
    jres = fit(cfg, host, None, None, execution="mesh", mesh=mesh,
               plans=[tuple(np.asarray(p) for p in pl) for pl in jplans],
               n_epochs=len(jplans), tol=0.0, checkpoint_dir=jdir,
               resume=True, device="cpu")
    out["jax_resumed_alpha"] = D.gather_model_shards(
        mesh, jres.state.alpha).numpy()
    out["jax_resumed_epochs"] = jres.epochs_run
    # BCD on the mesh against the serial plan with bcd_shards = n_data.
    bcfg = _cfg(bcd_kw)
    mesh_bcd = fit(bcfg, host, None, torch.Generator().manual_seed(4),
                   execution="bcd", mesh=mesh, n_epochs=3, tol=0.0,
                   x_val=xv, y_val=yv, device="cpu")
    out["bcd_alpha"] = D.gather_model_shards(mesh,
                                             mesh_bcd.state.alpha).numpy()
    out["bcd_history"] = mesh_bcd.history
    if rank == 0:
        serial = fit(bcfg.replace(bcd_shards=bcd_shards_ref), host, None,
                     torch.Generator().manual_seed(4), execution="bcd",
                     n_epochs=3, tol=0.0, x_val=xv, y_val=yv, device="cpu")
        out["bcd_serial_alpha"] = serial.state.alpha.numpy()
        out["bcd_serial_history"] = serial.history
    # EigenPro on the mesh: the block replicated from rank 0, a fit runs.
    pre = run(host, n_epochs=1, precondition=4)
    out["precond_finite"] = bool(torch.isfinite(pre.state.alpha).all())
    out["precond_indices"] = np.asarray(pre.precond.indices)
    out["same"] = same
    return out


def elastic_save(rank, shape, x_np, y_np, ckpt, cfg_kw, bcd_kw,
                 bcd_shards_ref):
    """On mesh A: a fit that checkpoints every epoch; and the mesh BCD fit
    against the serial one with ``bcd_shards`` = n_data (rank 0)."""
    from repro_torch.core import distributed as D, fit
    from repro_torch.data import HostSource
    mesh = _mesh(shape)
    host = HostSource(x_np, y_np)
    fit(_cfg(cfg_kw), host, None, torch.Generator().manual_seed(1),
        execution="mesh", mesh=mesh, n_epochs=2, tol=0.0,
        checkpoint_dir=ckpt, checkpoint_keep=5, device="cpu")
    bcfg = _cfg(bcd_kw)
    res = fit(bcfg, host, None, torch.Generator().manual_seed(4),
              execution="bcd", mesh=mesh, n_epochs=3, tol=0.0, device="cpu")
    out = {"bcd_alpha": D.gather_model_shards(mesh, res.state.alpha).numpy()}
    if rank == 0:
        ser = fit(bcfg.replace(bcd_shards=bcd_shards_ref), host, None,
                  torch.Generator().manual_seed(4), execution="bcd",
                  n_epochs=3, tol=0.0, device="cpu")
        out["bcd_serial_alpha"] = ser.state.alpha.numpy()
    return out


def elastic_resume(rank, shape, x_np, y_np, ckpt_dirs, cfg_kw):
    """On mesh B: each checkpoint directory (copies of one checkpoint)
    resumed for one more epoch; the full alphas."""
    from repro_torch.core import distributed as D, fit
    from repro_torch.data import HostSource
    mesh = _mesh(shape)
    host = HostSource(x_np, y_np)
    outs = []
    for ck in ckpt_dirs:
        res = fit(_cfg(cfg_kw), host, None, torch.Generator().manual_seed(1),
                  execution="mesh", mesh=mesh, n_epochs=2, tol=0.0,
                  checkpoint_dir=ck, resume=True, device="cpu")
        outs.append((D.gather_model_shards(mesh, res.state.alpha).numpy(),
                     int(res.state.step), res.epochs_run))
    return outs


# ---------------------------------------------------------------------------
# Serving on the mesh (tests/test_torch_collectives.py,
# test_torch_lm_mesh.py, test_torch_engine_mesh.py).
# ---------------------------------------------------------------------------

def _ctx(shape, kind="decode"):
    from repro_torch.distributed.sharding import MeshCtx
    return MeshCtx.for_mesh(_mesh(shape), kind)


def collective_cases(rank, x_np, w_np, ints_np):
    """Per mesh shape and axis: the ring matmuls on this rank's shards,
    the gathers by both methods (float32, bfloat16; dims 0 and 1), the
    psum-scatter of integer-valued floats, the ring shift by both methods,
    and a bfloat16 product split over the axis by ``psum_product`` and, for
    contrast, as bfloat16 partials psummed; then a (2, 2, 1) mesh named (pod, data, model), gathered over
    its (pod, data) group."""
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.mesh import _build
    from repro_torch.distributed.sharding import MeshCtx
    out = {}
    for shape, axis in (((2, 2), "model"), ((2, 2), "data"),
                        ((1, 4), "model"), ((4, 1), "data")):
        ctx = _ctx(shape)
        n, i = ctx.size(axis), ctx.index(axis)
        x, w = torch.from_numpy(x_np), torch.from_numpy(w_np)
        k_loc, m_loc = x.shape[1] // n, x.shape[0] // n
        ring = C.ring_psum_matmul(x[:, i * k_loc:(i + 1) * k_loc],
                                  w[i * k_loc:(i + 1) * k_loc], ctx, axis)
        agm = C.allgather_matmul_overlapped(x[i * m_loc:(i + 1) * m_loc], w,
                                            ctx, axis)
        mine = torch.from_numpy(ints_np[ctx.mesh.rank])
        gathers = {}
        for dt in (torch.float32, torch.bfloat16):
            for dim in (0, 1):
                got = [C.all_gather(mine.to(dt), ctx, axis, dim=dim,
                                    method=m).float().numpy()
                       for m in ("native", "slots")]
                gathers[f"{dt}-{dim}"] = got
        scat = C.psum_scatter(mine, ctx, axis, dim=1)
        whole = C.psum(mine.clone(), ctx, axis)
        shifts = [C.ring_shift(mine, ctx, axis, method=m).numpy()
                  for m in ("native", "slots")]
        xs = x[:, i * k_loc:(i + 1) * k_loc].bfloat16()
        ws = w[i * k_loc:(i + 1) * k_loc].bfloat16()
        product = C.psum_product(torch.matmul, xs, ws, ctx, axis)
        bf16_sum = C.psum(xs @ ws, ctx, axis)
        out[f"{shape}-{axis}"] = {
            "product": product.float().numpy(),
            "bf16_sum": bf16_sum.float().numpy(),
            "ring": ring.numpy(), "agm": agm.numpy(), "gathers": gathers,
            "scatter": scat.numpy(), "psum": whole.numpy(),
            "shifts": shifts, "index": i, "n": n,
            "coord": ctx.mesh.coordinate}
    pod = _build((2, 2, 1), ("pod", "data", "model"), "gloo", "cpu", 60.0)
    ctx = MeshCtx.for_mesh(pod, "decode")
    mine = torch.from_numpy(ints_np[pod.rank])
    out["pod"] = {"gather": C.all_gather(mine, ctx, ctx.data_axes,
                                         dim=0).numpy(),
                  "index": ctx.index(ctx.data_axes), "n": ctx.n_data,
                  "dp": ctx.data_axes,
                  "rules": dict(ctx.rules)}
    return out


def _lm(name, ctx, params=None, changes=None, seed=0):
    """The reduced config ``name`` with ``changes`` (ModelConfig fields) on
    ``ctx``: JAX's ``params`` loaded (this rank's slices), or a seeded
    init."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models.model import LanguageModel
    cfg = get_config(name, reduced=True).replace(**(changes or {}))
    model = LanguageModel(cfg, device="cpu", ctx=ctx)
    if params is None:
        return cfg, model.init(torch.Generator().manual_seed(seed))
    model.load_state_dict(lm_params_from_jax(cfg, params, ctx=ctx),
                          strict=True)
    return cfg, model


def lm_mesh_cases(rank, cases, moe_case):
    """Each case on each mesh shape: ``{"name", "params" (JAX's tree as
    numpy), "changes" (config fields), "tokens" (B, S + steps), "frontend"
    (or None), "cache"}``: prefill logits over the first S tokens, then
    one decode step per remaining token (teacher-forced).  Then the MoE
    layer against JAX's shard_map branch and a sharded init against the
    unsharded one's slices."""
    from repro_torch.models import moe
    from repro_torch.nn.module import ParamTree, take_local
    out = {"lm": {}}
    for shape in ((2, 2), (1, 4), (4, 1)):
        ctx = _ctx(shape)
        for c in cases:
            if shape not in c["shapes"]:
                continue
            cfg, model = _lm(c["name"], ctx, c["params"], c["changes"])
            tok = torch.from_numpy(c["tokens"]).long()
            fe = (None if c["frontend"] is None
                  else torch.from_numpy(c["frontend"]))
            s = c["prompt"]
            lg, cache = model.prefill(tok[:, :s], c["cache"], fe)
            steps = [lg.numpy()]
            for t in range(s, tok.shape[1]):
                lg, cache = model.decode_step(tok[:, t], cache, t)
                steps.append(lg.numpy())
            out["lm"][(c["key"], shape)] = steps
    # The MoE layer on (2, 2): the batch whole on every rank (JAX's input,
    # replicated) and split over data.
    ctx = _ctx((2, 2))
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    cfg = get_config("jamba-v0.1-52b", reduced=True).replace(
        capacity_factor=moe_case["cf"])
    tree = ParamTree(moe.moe_specs(cfg), dtype=torch.float32,
                     device=torch.device("cpu"), ctx=ctx)
    full = lm_params_from_jax(cfg, moe_case["params"])
    specs = moe.moe_specs(cfg)
    with torch.no_grad():
        for k, spec in specs.items():
            getattr(tree, k).copy_(take_local(full[k], spec, ctx))
        x = torch.from_numpy(moe_case["x"])
        whole = moe.moe_forward(tree.view(), cfg, x)
        b_loc = x.shape[0] // ctx.n_data
        d = ctx.index(ctx.data_axes)
        split = moe.moe_forward(tree.view(), cfg,
                                x[d * b_loc:(d + 1) * b_loc],
                                batch_split=True)
    out["moe"] = {"whole": whole.numpy(), "split": split.numpy(), "d": d,
                  "b_loc": b_loc}
    # A sharded init from a seed: the slices of the unsharded one's.
    _, sharded = _lm("jamba-v0.1-52b", ctx, seed=3)
    _, ref = _lm("jamba-v0.1-52b", None, seed=3)
    from repro_torch.models.model import param_specs
    from repro_torch.convert import _flat
    flat = dict(_flat(param_specs(sharded.cfg)))
    want = ref.state_dict()
    out["init"] = {k: (bool(torch.equal(v, take_local(want[k], flat[k],
                                                      ctx))),
                       tuple(v.shape), tuple(want[k].shape))
                   for k, v in sharded.state_dict().items()}
    return out


def engine_mesh_cases(rank, x_np, a_np, xq_np, a2_np, gamma, qb, svb):
    """The sharded engine on (4, 1) and (2, 2): predict, flush,
    flush_async, the cache's miss and hit paths, update_alpha on a
    keep-all engine; its stats."""
    from repro_torch.core.dsekl import DSEKLConfig
    from repro_torch.serving import DSEKLPredictionEngine, EngineConfig
    cfg = DSEKLConfig(kernel="rbf", kernel_params=(("gamma", gamma),),
                      impl="ref")
    out = {}
    for shape in ((4, 1), (2, 2)):
        mesh = _mesh(shape)
        xq = torch.from_numpy(xq_np)
        ec = EngineConfig(query_block=qb, sv_block=svb)
        eng = DSEKLPredictionEngine(cfg, a_np, x_np, engine_cfg=ec,
                                    mesh=mesh)
        res = {"stats": eng.stats(), "predict": eng.predict(xq).numpy()}
        eng.submit(xq[:9])
        eng.submit(xq[9:40])
        eng.submit(xq[40:])
        res["flush"] = [f.numpy() for f in eng.flush()]
        eng.submit(xq[:30])
        eng.submit(xq[30:])
        res["flush_async"] = [f.numpy() for f in eng.flush_async()]
        cached = DSEKLPredictionEngine(
            cfg, a_np, x_np, engine_cfg=EngineConfig(
                query_block=qb, sv_block=svb, cache_blocks=4,
                truncate_tol=-1.0), mesh=mesh)
        res["miss"] = cached.predict(xq).numpy()
        res["hit"] = cached.predict(xq).numpy()
        cached.update_alpha(a2_np)
        res["updated"] = cached.predict(xq).numpy()
        res["cache"] = {k: cached.cache_info()[k]
                        for k in ("hits", "misses", "size")}
        res["keep_all_stats"] = cached.stats()
        res["local_rows"] = int(eng._x_sv.shape[0])
        res["coord"] = mesh.coordinate
        out[shape] = res
    return out


# ---------------------------------------------------------------------------
# LM training on the mesh (tests/test_torch_collectives.py,
# test_torch_lm_train_mesh.py, test_torch_lm_ckpt_mesh.py).
# ---------------------------------------------------------------------------

def _crc(t) -> int:
    import zlib
    return zlib.crc32(t.detach().contiguous().numpy().tobytes())


def _whole_np(t, spec, ctx):
    """A host copy of the whole tensor of which ``t`` is this rank's
    slice (``gather_whole`` returns an unsplit slice itself)."""
    from repro_torch.nn.module import gather_whole
    return gather_whole(t, spec, ctx).numpy().copy()


def collective_grad_cases(rank, seed):
    """Each collective's autograd form in float64 inside a global scalar
    objective that every rank holds alike: the rank's gradient of its
    inputs by backward, and central differences of the objective taken by
    perturbing one input entry on one rank at a time (every rank runs
    every perturbed forward, in step).  Over the model axis the objective
    is replicated on every rank (each rank's gradient is the whole one);
    over the data axes it is the sum of the ranks' own objectives
    (``"sum"``: each rank's gradient is its share, summed over the axis
    for a replicated input)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    torch.manual_seed(seed)
    out = {}
    for shape, axis in (((1, 4), "model"), ((2, 2), "model"),
                        ((2, 2), "data"), ((4, 1), "data")):
        ctx = _ctx(shape, "train")
        n, i = ctx.size(axis), ctx.index(axis)
        g = torch.Generator().manual_seed(seed + 7)     # alike on all ranks
        shared = torch.randn(6, 4, generator=g, dtype=torch.float64)
        mine = torch.randn(6, 4, generator=torch.Generator().manual_seed(
            seed + 100 + ctx.mesh.rank), dtype=torch.float64)
        coef = torch.randn(6 * n, 4, generator=g, dtype=torch.float64)

        def total(v):                   # the objective summed over ranks
            v = v.detach().clone()
            dist.all_reduce(v, group=ctx.group(axis))
            return v

        objectives = {
            # partial products summed, replicated after: psum / identity
            "psum": (lambda a: torch.sum(torch.sin(
                C.psum(a * coef[:6], ctx, axis))), "whole", "mine"),
            # a replicated input entering split parts: to_split
            "to_split": (lambda a: torch.sum(torch.sin(C.psum(
                C.to_split(a, ctx, axis) * coef[6 * i:6 * i + 6], ctx,
                axis))), "whole", "shared"),
            # a norm over a split width: psum(grad="psum")
            "psum_psum": (lambda a: torch.sum(torch.cos(C.psum(
                a * torch.rsqrt(C.psum(torch.sum(a * a), ctx, axis,
                                       grad="psum")) * coef[:6], ctx,
                axis))), "whole", "mine"),
            # a gathered tensor used alike on every rank: slice backward
            "gather_slice": (lambda a: torch.sum(torch.tanh(C.all_gather(
                a, ctx, axis, dim=0, grad="slice") * coef)), "whole",
                "mine"),
            # a gathered tensor each rank uses as its own: scatter back
            "gather_scatter": (lambda a: torch.sum(torch.tanh(C.all_gather(
                a, ctx, axis, dim=0) * coef * (1 + i))), "sum", "mine"),
            # psum_scatter of each rank's own: gather back
            "psum_scatter": (lambda a: torch.sum(torch.sin(C.psum_scatter(
                torch.cat([a] * n) * coef, ctx, axis, dim=0) * (2 + i))),
                "sum", "mine"),
            # data-axis statistics: psum(grad="psum") of each rank's own
            "psum_sum": (lambda a: torch.sum(torch.sin(C.psum(
                torch.sum(a, dim=0), ctx, axis, grad="psum"))
                * (1 + i)), "sum", "mine"),
        }
        res = {}
        for name, (fn, kind, which) in objectives.items():
            base = shared if which == "shared" else mine
            x = base.clone().requires_grad_(True)
            (grad,) = torch.autograd.grad(fn(x), x)
            # A shared input is perturbed on every rank at once.
            owners = [None] if which == "shared" else range(n)
            numeric, analytic = [], []
            for owner in owners:
                for e in (0, 5, 17, 23):
                    vals = []
                    for sign in (1.0, -1.0):
                        xp = base.clone()
                        if owner is None or owner == i:
                            xp.view(-1)[e] += sign * 1e-6
                        with torch.no_grad():
                            v = fn(xp)
                        vals.append(float(total(v.reshape(1))[0])
                                    if kind == "sum" else float(v))
                    if owner is None or owner == i:
                        numeric.append((vals[0] - vals[1]) / 2e-6)
                        analytic.append(float(grad.reshape(-1)[e]))
            res[name] = (numeric, analytic)
        out[f"{shape}-{axis}"] = res
    return out


def _seeded_lm(case, ctx=None):
    """test_torch_lm_train's model: the reduced config with ``changes``,
    seeded init, cross-attention gates drawn from numpy; on ``ctx`` this
    rank's slices of it."""
    from repro_torch.configs import get_config
    from repro_torch.convert import _flat
    from repro_torch.models.model import LanguageModel, param_specs
    from repro_torch.nn.module import take_local
    kw = dict(param_dtype=case.get("dtype", "float32"),
              compute_dtype=case.get("dtype", "float32"))
    cfg = get_config(case["name"], reduced=True).replace(
        **case.get("changes", {}), **kw)
    ref = LanguageModel(cfg, device="cpu").init(
        torch.Generator().manual_seed(case.get("seed", 0)))
    rng = np.random.default_rng(case.get("seed", 0) + 100)
    with torch.no_grad():
        for key, p in ref.named_parameters():
            if key.endswith(".gate"):
                p.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, p.shape)))
    if ctx is None:
        return ref
    specs = dict(_flat(param_specs(cfg)))
    model = LanguageModel(cfg, device="cpu", ctx=ctx)
    model.load_state_dict({k: take_local(v, specs[k], ctx).contiguous()
                           for k, v in ref.state_dict().items()})
    return model


def _batch_t(b):
    out = {"tokens": torch.from_numpy(b["tokens"]).long(),
           "labels": torch.from_numpy(b["labels"]).long()}
    if b.get("frontend") is not None:
        out["frontend"] = torch.from_numpy(b["frontend"])
    return out


def lm_train_cases(rank, cases, shapes, lr):
    """Each case (``{"key", "name", "changes", "batches": [{"tokens",
    "labels", "frontend"}], "mb": bool}``) on each mesh shape under the
    ``train`` rules: step 0's loss, gradients (whole, gathered, on rank 0;
    each rank's local ones by crc and layout) and global norm; then as
    many AdamW steps as batches (cosine, warmup 2 of 5), their losses and
    grad norms, and the parameters and moments after them (whole, rank
    0); with ``mb``, one SGD step with microbatches 1 and 2."""
    from repro_torch.nn.module import local_index
    from repro_torch.optim import global_norm, make_optimizer, make_schedule
    from repro_torch.distributed import collectives as C
    from repro_torch.train import make_train_step, param_shards, trainable
    from repro_torch.train.step import finish_grads
    out = {}
    for shape in shapes:
        ctx = _ctx(tuple(shape), "train")
        for c in cases:
            model = _seeded_lm(c, ctx)
            init = {k: v.clone() for k, v in model.state_dict().items()}
            params = trainable(model)
            shards = param_shards(model)
            b0 = _batch_t(c["batches"][0])
            loss = model.loss(b0["tokens"], b0["labels"],
                              frontend=b0.get("frontend"), loss_chunks=4)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()), allow_unused=True,
                materialize_grads=True)))
            grads = finish_grads(grads, shards)
            loss = C.psum(loss.detach().clone(), ctx,
                          ctx.data_axes) / ctx.n_data
            res = {"loss0": float(loss),
                   "gn0": float(global_norm(grads, shards)),
                   "local": {k: (tuple(r[:2] for r in local_index(
                       shards.specs[k], ctx)), _crc(g))
                       for k, g in grads.items()}}
            whole = {k: _whole_np(g, shards.specs[k], ctx)
                     for k, g in grads.items()}
            if rank == 0:
                res["grads"] = whole
            opt = make_optimizer("adamw", make_schedule(
                "cosine", lr, warmup_steps=2, total_steps=5), shards=shards)
            state = opt.init(params)
            step = make_train_step(model, opt, loss_chunks=4)
            metrics = []
            for b in c["batches"]:
                params, state, m = step(params, state, _batch_t(b))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            res["metrics"] = metrics
            res["count"] = int(state["count"])
            final = {"params": {k: _whole_np(p, shards.specs[k], ctx)
                                for k, p in params.items()}}
            for mo in ("m", "v"):
                final[mo] = {k: _whole_np(t, shards.specs[k], ctx)
                             for k, t in state[mo].items()}
            if rank == 0:
                res["final"] = final
            if c.get("mb"):
                mbs = {}
                for n_mb in (1, 2):
                    model.load_state_dict(init)
                    sgd = make_optimizer("sgd", make_schedule("const", 1e-2),
                                         grad_clip=None, shards=shards)
                    params = trainable(model)
                    st = make_train_step(model, sgd, loss_chunks=2,
                                         microbatches=n_mb)
                    _, _, m = st(params, sgd.init(params), b0)
                    mbs[n_mb] = (float(m["loss"]), float(m["grad_norm"]),
                                 {k: _whole_np(p, shards.specs[k], ctx)
                                  for k, p in params.items()})
                if rank == 0:
                    res["mb"] = mbs
            out[(c["key"], tuple(shape))] = res
    return out


def lm_jax_state_case(rank, case, shape):
    """JAX's parameters and AdamW state after some steps carried across
    to this rank's slices (``convert.lm_params_from_jax`` and
    ``lm_opt_state_from_jax`` with ``ctx``), then one more step on the
    mesh: the parameters and moments after it (whole, rank 0), the
    count, the step's loss and grad norm."""
    from repro_torch.convert import lm_opt_state_from_jax, lm_params_from_jax
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train import make_train_step, param_shards, trainable
    ctx = _ctx(tuple(shape), "train")
    model = _seeded_lm(case, ctx)
    model.load_state_dict(lm_params_from_jax(model.cfg, case["params"],
                                             ctx=ctx))
    params = trainable(model)
    shards = param_shards(model)
    opt = make_optimizer("adamw", make_schedule(
        "cosine", case["lr"], warmup_steps=2, total_steps=5), shards=shards)
    state = lm_opt_state_from_jax(model.cfg, case["opt"], ctx=ctx)
    step = make_train_step(model, opt, loss_chunks=4)
    params, state, m = step(params, state, _batch_t(case["batch"]))
    out = {"count": int(state["count"]), "loss": float(m["loss"]),
           "grad_norm": float(m["grad_norm"])}
    final = {"params": {k: _whole_np(p, shards.specs[k], ctx)
                        for k, p in params.items()}}
    for mo in ("m", "v"):
        final[mo] = {k: _whole_np(t, shards.specs[k], ctx)
                     for k, t in state[mo].items()}
    if rank == 0:
        out["final"] = final
    return out


def moe_train_case(rank, case):
    """jamba's MoE layer on (2, 2) under the ``train`` rules, the batch
    split over data, capacity drops: the output, the aux loss, and the
    gradients of sum(y * w) + 3 aux with respect to x (this rank's shard)
    and the parameters (whole, gathered; rank 0)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.models import moe
    from repro_torch.nn.module import ParamTree, take_local
    from repro_torch.train.step import finish_grads
    from repro_torch.optim import Shards
    ctx = _ctx((2, 2), "train")
    cfg = get_config("jamba-v0.1-52b", reduced=True).replace(
        capacity_factor=case["cf"])
    specs = moe.moe_specs(cfg)
    tree = ParamTree(specs, dtype=torch.float32, device=torch.device("cpu"),
                     ctx=ctx)
    full = lm_params_from_jax(cfg, case["params"])
    with torch.no_grad():
        for k, spec in specs.items():
            getattr(tree, k).copy_(take_local(full[k], spec, ctx))
    tree.requires_grad_(True)
    b_loc = case["x"].shape[0] // ctx.n_data
    d = ctx.index(ctx.data_axes)
    x = torch.from_numpy(case["x"][d * b_loc:(d + 1) * b_loc]).clone()
    w = torch.from_numpy(case["w"][d * b_loc:(d + 1) * b_loc])
    x.requires_grad_(True)
    y, aux = moe.moe_forward(tree.view(), cfg, x, with_aux=True,
                             batch_split=True)
    # The shards' objectives sum to JAX's: the aux loss (global, alike on
    # every data shard) counts once over them.
    obj = torch.sum(y * w) + 3.0 * aux / ctx.n_data
    names = [n for n, _ in tree.named_parameters()]
    got = torch.autograd.grad(obj, [x] + [p for _, p in
                                          tree.named_parameters()])
    # finish_grads gives the shards' mean: times n_data, their sum.
    shards = Shards(ctx=ctx, specs=dict(specs))
    grads = dict(zip(names, got[1:]))
    grads = {k: g * ctx.n_data for k, g in
             finish_grads(grads, shards).items()}
    out = {"d": d, "b_loc": b_loc, "y": y.detach().numpy(),
           "aux": float(aux), "gx": got[0].numpy()}
    whole = {k: _whole_np(g, specs[k], ctx) for k, g in grads.items()}
    if rank == 0:
        out["grads"] = whole
    return out


def lm_ckpt_cases(rank, root, case, steps, half):
    """mamba2 training checkpoints across mesh shapes, through
    ``train_loop``: on (2, 2) an uninterrupted run of ``steps`` (dir
    ``u22``) and a run of ``half`` steps (``s22``); copies of ``s22``
    resumed to ``steps`` on (2, 2) (``r22``) and on (4, 1) (``r41``); the
    one-device checkpoint ``o1`` (written by the test) resumed on (2, 2)
    (``o22``).  The test reads the checkpoints."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import BigramPipeline
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train import (TrainLoopConfig, make_train_step,
                                   param_shards, train_loop, trainable)

    def run(shape, directory, n_steps, resume):
        ctx = _ctx(shape, "train")
        model = _seeded_lm(case, ctx)
        params = trainable(model)
        shards = param_shards(model)
        opt = make_optimizer("adamw", make_schedule(
            "cosine", 3e-3, warmup_steps=1, total_steps=steps),
            shards=shards)
        step = make_train_step(model, opt, loss_chunks=4)
        pipe = BigramPipeline(model.cfg.vocab_size, 4, 16, seed=1)
        res = train_loop(step, params, opt.init(params), pipe,
                         CheckpointManager(os.path.join(root, directory),
                                           keep=5),
                         TrainLoopConfig(n_steps=n_steps, ckpt_every=2),
                         resume=resume, device="cpu", shards=shards)
        return [h["loss"] for h in res["history"]]

    out = {"u22": run((2, 2), "u22", steps, False),
           "s22": run((2, 2), "s22", half, False)}
    if rank == 0:
        for name in ("r22", "r41"):
            shutil.copytree(os.path.join(root, "s22"),
                            os.path.join(root, name))
    dist.barrier()
    out["r22"] = run((2, 2), "r22", steps, True)
    out["r41"] = run((4, 1), "r41", steps, True)
    out["o22"] = run((2, 2), "o1", steps, True)
    return out
