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
