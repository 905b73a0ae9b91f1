#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main paths on the card — serving a DSEKL model
through ``repro_torch.launch.serve.serve_dsekl``, and training one through
``repro_torch.launch.train.train_dsekl`` then serving it — with every
kernel built from this checkout's sources and held against its plain
PyTorch version.  Phases (any failure exits non-zero and prints no
result):

  1. device  — name, compute capability, ``nvidia-smi`` name and power
               limit; requires sm_90.
  2. build   — nvcc builds every kernel source (build seconds, ptxas).
  3. parity  — each kernel vs its plain version on the card, 7 kernels x
               D in {3, 54, 784} at ragged I=1000, J=5003: matvec,
               vecmat, the dual pass, the train pass for the 4 losses at
               f_scale 1 and N/|J|, and ops.kernel_dual_pass's
               matvec-then-vecmat fallback under a forced small stash
               budget; each launch counter must go up by one per call.
  4. serve   — the serving path at the covertype scale: 559,890 x 54
               training rows, RBF, ~50% support, 16,384 queries in
               requests of 64, query_block 1024, through flush_async and
               flush; answers checked against the plain path; the
               kernel's launches must equal the serve calls.
  5. train   — the training path at full width: ``train_dsekl`` on the
               covertype protocol (559,890 x 54 training rows after the
               2,048-row hold-out, |I| = |J| = 1024, hinge, adagrad, 2
               epochs = 1,092 steps); train-pass launches must equal the
               steps, alpha be finite and the last validation error beat
               the all-zero model's; then the trained model is served
               through ``engine_from_fit`` and its error must equal the
               fit's, up to labels whose |f| is within tolerance of 0.
  6. train-cuda-vs-ref — 16 Alg.-1 steps on one shared plan at the main
               shape (square loss) with impl "cuda" and "ref": alpha and
               accum must agree.
  7. train-two-pass — a fit with fuse_dual_pass=False (N = 65,536, one
               epoch of 64 steps): vecmat launches must equal the steps.
  8. profile — torch.profiler over 32 steps of the training path: device
               time by kernel and the device's busy share.
  9. times   — each kernel at its main path's shape: its device time per
               call (torch.profiler, 2 x 25 calls), its bound, the plain
               version's and the fp32 cross-term GEMM yardstick's device
               time, and one call of kernel and plain by CUDA events (the
               host's enqueue included), in ms.

The kernel tolerance is the JAX suite's float32 one
(tests/test_dual_pass.py ``_tols``): rtol 2e-4, atol 1e-5 * max(1,
|oracle|_inf).  The 16-step cuda-vs-ref trajectory is held at rtol 1e-3,
atol 1e-4 * max(1, |oracle|_inf): sixteen steps of float32 sums taken in
another order, and duplicate J indices scattered by atomics on the card.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

DEVICE = "cuda"
RTOL, ATOL = 2e-4, 1e-5
PARITY_SHAPE = (1000, 5003)
PARITY_DIMS = (3, 54, 784)
PARITY_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 0.0), ("degree", 3))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
# The main path: the covertype protocol at full size (581,012 rows less
# 21,122 held out), RBF, 50% support, 16,384 queries in requests of 64.
SERVE_ARGS = ["--dsekl", "--data", "covertype", "--n-train", "559890",
              "--dim", "54", "--kernel", "rbf", "--support-frac", "0.5",
              "--queries", "16384", "--request", "64", "--query-block",
              "1024", "--max-queue", "64", "--seed", "0"]
# The training path: the covertype protocol (benchmarks/covertype_scale.py)
# at full size through the port's launcher, 2 epochs.
TRAIN_ARGS = ["--dsekl", "--data", "memory", "--n", "561938", "--dim", "54",
              "--n-grad", "1024", "--n-expand", "1024", "--kernel", "rbf",
              "--gamma", "1.0", "--epochs", "2", "--seed", "0"]
TRAIN_N = 561938 - 2048                      # rows left after the hold-out
TRAIN_STEPS = 2 * (TRAIN_N // 1024)          # 1,092
TWO_PASS_N = 65536                           # one epoch of 64 steps
TRAJ_RTOL, TRAJ_ATOL = 1e-3, 1e-4
LOSSES = ("hinge", "squared_hinge", "square", "logistic")
# fp32 outside the tensor cores and HBM bandwidth (NVIDIA data sheets).
PEAKS = [  # (name substring, fp32 FLOP/s, bytes/s)
    ("H100 PCIe", 51.2e12, 2.0e12),
    ("H100 NVL", 60.0e12, 3.9e12),
    ("H200", 67.0e12, 4.8e12),
    ("H100", 67.0e12, 3.35e12),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(got, want, rtol: float = RTOL, atol: float = ATOL) -> float:
    """Max abs error; raises unless got matches want at the tolerance."""
    import torch
    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    atol = atol * max(1.0, float(want.abs().max()) if want.numel() else 1.0)
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    check(not bool(bad.any()),
          f"{int(bad.sum())} of {got.numel()} values out of tolerance; max "
          f"abs err {float(err.max()):.3e} (atol {atol:.3e}, rtol {RTOL})")
    return float(err.max()) if err.numel() else 0.0


def peaks(device_name: str):
    """(fp32 FLOP/s, bytes/s) of the named card."""
    for key, flops, bw in PEAKS:
        if key in device_name:
            return flops, bw
    raise SmokeFailure(f"no data-sheet peaks for {device_name!r}")


def _device_rows(prof) -> list:
    """(self device us, name, count) of a profile's device-side events
    (kernels, copies, fills): an aten op's row would repeat the device
    time of the kernels it launched."""
    import torch
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if ev.device_type != torch.autograd.DeviceType.CPU and dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def device_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Device time of one call in ms: the profiler's kernel time over
    ``reps`` calls, divided by ``reps``.  Unlike CUDA events around a
    call, it leaves out the host's enqueue (argument checks, allocation,
    the launch itself), which at a few us of device work is most of the
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(r[0] for r in _device_rows(prof))
    check(total_us > 0, "torch.profiler recorded no device time")
    return total_us / 1e3 / reps


def time_ms(fn, reps: int = 25, warmup: int = 3) -> list:
    """``reps`` CUDA-event timings of one call, in ms: the host's enqueue
    included, since the events bracket it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi("name,power.limit")
    print(f"[device] {name} sm_{cap[0]}{cap[1]} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda}")
    print(smi)
    check(cap == (9, 0), f"needs sm_90 (Hopper), got sm_{cap[0]}{cap[1]}")
    return name, smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    records = _build.build_all()
    wall = time.perf_counter() - t0
    check(bool(records), "no kernel sources found")
    for rec in records.values():
        print(f"[build] {rec.name}: nvcc {rec.seconds:.1f}s -> "
              f"{os.path.relpath(rec.path, ROOT)}")
        for line in rec.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] all sources in {wall:.1f}s")
    return records


def _counted(fn, counter, what: str):
    """Call ``fn`` and check that ``counter.launches`` went up by one."""
    import torch
    before = counter.launches
    out = fn()
    torch.cuda.synchronize()
    check(counter.launches == before + 1,
          f"{what}: launch count did not go up by one")
    return out


def phase_parity():
    import numpy as np
    import torch
    from repro_torch.kernels.dsekl import block, ops
    n_i, n_j = PARITY_SHAPE
    worst = {}

    def held(name, got, want):
        # The error relative to the tolerance's scale, max(1, |want|_inf).
        err = compare(got, want) / max(1.0, float(want.abs().max()))
        worst[name] = max(worst.get(name, 0.0), err)

    for d in PARITY_DIMS:
        worst.clear()
        rng = np.random.default_rng(d)
        scale = 1.0 / np.sqrt(d)

        def dev(v):
            return torch.tensor(v, dtype=torch.float32, device=DEVICE)

        x = dev(rng.standard_normal((n_i, d)) * scale)
        z = dev(rng.standard_normal((n_j, d)) * scale)
        a = dev(rng.standard_normal(n_j))
        v = dev(rng.standard_normal(n_i))
        y = dev(np.where(rng.standard_normal(n_i) >= 0, 1.0, -1.0))
        y_reg = dev(rng.standard_normal(n_i))            # square loss
        for name, params in PARITY_CASES:
            kw = dict(kernel_name=name, params=dict(params))
            got = _counted(lambda: block.kernel_matvec_cuda(x, z, a, **kw),
                           block.kernel_matvec_cuda, name)
            want = block.kernel_matvec_plain(x, z, a, **kw)
            held("kernel_matvec", got, want)
            got = _counted(lambda: block.kernel_vecmat_cuda(x, z, v, **kw),
                           block.kernel_vecmat_cuda, name)
            held("kernel_vecmat", got, block.kernel_vecmat_plain(x, z, v,
                                                                 **kw))
            gf, gg = _counted(lambda: block.dual_pass_cuda(x, z, a, v, **kw),
                              block.dual_pass_cuda, name)
            wf, wg = block.dual_pass_plain(x, z, a, v, **kw)
            held("dual_pass", gf, wf)
            held("dual_pass", gg, wg)
            for loss in LOSSES:
                yl = y_reg if loss == "square" else y
                for f_scale in (1.0, TRAIN_N / n_j):
                    gf, gg = _counted(
                        lambda: block.train_pass_cuda(
                            x, z, a, yl, loss=loss, f_scale=f_scale, **kw),
                        block.train_pass_cuda, f"{name} {loss}")
                    wf, wg = block.train_pass_plain(
                        x, z, a, yl, loss=loss, f_scale=f_scale, **kw)
                    held("train_pass", gf, wf)
                    held("train_pass", gg, wg)
            # The over-budget fallback: matvec then vecmat, no stash.
            budget, block.STASH_BUDGET = block.STASH_BUDGET, 0
            try:
                counts = [c.launches for c in (
                    block.kernel_matvec_cuda, block.kernel_vecmat_cuda,
                    block.train_pass_cuda)]
                gf, gg = ops.kernel_dual_pass(
                    x, z, a, y, kernel_name=name, kernel_params=params,
                    loss="hinge", f_scale=TRAIN_N / n_j, impl="cuda")
                torch.cuda.synchronize()
                check([c.launches for c in (
                    block.kernel_matvec_cuda, block.kernel_vecmat_cuda,
                    block.train_pass_cuda)] == [counts[0] + 1, counts[1] + 1,
                                                counts[2]],
                      f"{name}: the fallback did not run matvec then vecmat")
            finally:
                block.STASH_BUDGET = budget
            wf, wg = block.train_pass_plain(x, z, a, y, loss="hinge",
                                            f_scale=TRAIN_N / n_j, **kw)
            held("fallback", gf, wf)
            held("fallback", gg, wg)
        print(f"[parity] D={d:<4d} 7 kernels, worst max abs err / max(1, "
              "|want|_inf): "
              + ", ".join(f"{k} {e:.3e}" for k, e in worst.items()))


def phase_serve():
    import torch
    from repro_torch.kernels.dsekl import block, ops
    from repro_torch.launch import serve
    block.kernel_matvec_cuda.launches = 0        # the main path starts here
    runs = {}
    for mode, extra in (("flush_async", []), ("flush", ["--sync"])):
        args = serve.parser().parse_args(
            SERVE_ARGS + ["--device", DEVICE] + extra)
        runs[mode] = serve.serve_dsekl(args)
    launches = block.kernel_matvec_cuda.launches  # ... and ends here
    serve_calls = 0
    for mode, res in runs.items():
        eng = res["engine"]
        serve_calls += eng.serve_calls
        f = torch.cat(res["outs"])
        check(f.shape == (res["queries"].shape[0],), f"{mode}: bad shape")
        check(bool(torch.isfinite(f).all()), f"{mode}: non-finite answers")
        xq = res["queries"][:1024].to(DEVICE)
        want = ops.kernel_matvec_tiled(
            xq, res["x_train"], res["alpha"], kernel_name="rbf",
            kernel_params=eng.cfg.kernel_params, z_block=4096, impl="ref")
        err = compare(f[:1024], want)
        st = eng.stats()
        print(f"[serve] {mode}: n_sv={st['n_sv']} padded={st['n_sv_padded']} "
              f"{res['queries_per_s']:.1f} queries/s, serve_calls="
              f"{eng.serve_calls}, first 1024 vs plain: max abs err "
              f"{err:.3e} (max|f| {float(want.abs().max()):.3e})")
    print(f"[serve] kernel_matvec launches={launches} serve_calls="
          f"{serve_calls}")
    check(launches > 0 and launches == serve_calls,
          f"launches {launches} != serve calls {serve_calls}")
    return runs["flush_async"], launches


def phase_train():
    """The training path at full width, then serving the trained model."""
    import torch
    from repro_torch.core.dsekl import decision_function, predict_labels
    from repro_torch.kernels.dsekl import block
    from repro_torch.launch import train
    from repro_torch.serving import engine_from_fit
    args = train.parser().parse_args(TRAIN_ARGS + ["--device", DEVICE])
    block.train_pass_cuda.launches = 0         # the training path starts
    block.kernel_matvec_cuda.launches = 0
    block.dual_pass_cuda.launches = 0
    out = train.train_dsekl(args)
    train_launches = block.train_pass_cuda.launches   # ... and ends here
    eval_launches = block.kernel_matvec_cuda.launches
    dual_launches = block.dual_pass_cuda.launches
    res, cfg = out["result"], out["cfg"]
    x, x_val, y_val = out["x"], out["x_val"], out["y_val"]
    check(tuple(x.shape) == (TRAIN_N, 54), f"training rows {tuple(x.shape)}")
    steps = res.epochs_run * max(x.shape[0] // cfg.n_grad, 1)
    print(f"[train] {res.epochs_run} epochs, {steps} steps: train_pass "
          f"launches={train_launches}, kernel_matvec launches (validation "
          f"evals)={eval_launches}, dual_pass launches={dual_launches}")
    check(train_launches == steps and steps == TRAIN_STEPS,
          f"train_pass launches {train_launches} != steps {steps}")
    check(eval_launches == 2, f"{eval_launches} eval matvec launches, "
          "expected one per epoch's eval")
    # A fit with a loss takes the fused train pass; the dual pass
    # (loss=None) is the op's own path, driven by the parity phase.
    check(dual_launches == 0, f"{dual_launches} dual_pass launches in a "
          "fit, expected the train pass alone")
    alpha = res.state.alpha
    check(bool(torch.isfinite(alpha).all()), "non-finite alpha")
    zero_err = float(torch.mean((y_val != 1.0).to(torch.float32)))
    last = res.history[-1]["val_error"]
    print(f"[train] val errors "
          f"{[round(h['val_error'], 6) for h in res.history]}, all-zero "
          f"model {zero_err:.6f}, n_sv {int((alpha.abs() > 1e-8).sum())}")
    check(last < zero_err, f"val error {last} does not beat the all-zero "
          f"model's {zero_err}")
    ep2 = res.history[-1]["seconds"]
    per = max(x.shape[0] // cfg.n_grad, 1)
    print(f"[train] epoch 2: {ep2 * 1e3:.3f} ms for {per} steps = "
          f"{ep2 / per * 1e3:.4f} ms/step, {per / ep2:.1f} steps/s (wall, "
          "eval excluded)")
    # Serve the trained model.
    eng = engine_from_fit(cfg, res, x, device=DEVICE)
    f_eng = eng.predict(x_val)
    f_fit = decision_function(cfg, alpha, x, x_val)
    err_eng = float(torch.mean((predict_labels(f_eng) != y_val).float()))
    atol = ATOL * max(1.0, float(f_fit.abs().max()))
    near0 = int((f_fit.abs() <= atol).sum())
    n_val = y_val.shape[0]
    print(f"[train] served by the engine (n_sv {eng.n_sv}): val error "
          f"{err_eng:.6f} vs the fit's {last:.6f}; {near0} labels with "
          f"|f| <= {atol:.1e}")
    check(abs(err_eng - last) * n_val <= near0 + 1e-6,
          "the engine's error differs from the fit's beyond near-zero f")
    return {"out": out, "launches": train_launches,
            "dual_launches": dual_launches, "ms_per_step": ep2 / per * 1e3,
            "steps_per_s": per / ep2}


def phase_train_cuda_vs_ref(out):
    """16 Alg.-1 steps on one plan, impl cuda vs ref (square loss)."""
    import torch
    from repro_torch.core import dsekl, sampler
    cfg = out["cfg"].replace(loss="square")
    x, y = out["x"], out["y"]
    n = x.shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    idx_i, idx_j = sampler.epoch_plan(gen, n, cfg.n_grad, cfg.n_expand, 16)
    states = {}
    for impl in ("cuda", "ref"):
        c = cfg.replace(impl=impl)
        st = dsekl.init_state(n, device=DEVICE)
        for t in range(16):
            st = dsekl.step_serial(c, st, x, y, idx_i[t], idx_j[t])
        torch.cuda.synchronize()
        states[impl] = st
    e_a = compare(states["cuda"].alpha, states["ref"].alpha, TRAJ_RTOL,
                  TRAJ_ATOL)
    e_g = compare(states["cuda"].accum, states["ref"].accum, TRAJ_RTOL,
                  TRAJ_ATOL)
    check(int(states["cuda"].step) == int(states["ref"].step) == 16,
          "step counters differ")
    print(f"[train-cuda-vs-ref] 16 steps, square loss: alpha max abs err "
          f"{e_a:.3e} (max|alpha| {float(states['ref'].alpha.abs().max()):.3e}"
          f"), accum max abs err {e_g:.3e}")


def phase_train_two_pass(cfg):
    """fuse_dual_pass=False: the path that launches the vecmat kernel."""
    import torch
    from repro_torch.core import fit
    from repro_torch.data import make_covertype_like
    from repro_torch.kernels.dsekl import block
    x, y = make_covertype_like(TWO_PASS_N, 54, seed=1, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    block.kernel_vecmat_cuda.launches = 0      # the two-pass path starts
    block.kernel_matvec_cuda.launches = 0
    res = fit(cfg.replace(fuse_dual_pass=False), x, y, gen, n_epochs=1,
              tol=0.0, device=DEVICE)
    vecmat = block.kernel_vecmat_cuda.launches  # ... and ends here
    matvec = block.kernel_matvec_cuda.launches
    check(bool(torch.isfinite(res.state.alpha).all()), "non-finite alpha")
    steps = TWO_PASS_N // 1024
    print(f"[train-two-pass] {TWO_PASS_N} x 54, 1 epoch of {steps} steps: "
          f"kernel_vecmat launches={vecmat}, kernel_matvec launches="
          f"{matvec}, {res.history[0]['seconds'] * 1e3:.3f} ms")
    check(vecmat == steps and matvec == steps,
          f"two-pass launches vecmat={vecmat} matvec={matvec}, expected "
          f"{steps}")
    return vecmat


def _step_inputs(out):
    """One step's blocks from the trained model: I = J = 1024 rows."""
    import torch
    x, y, alpha = out["x"], out["y"], out["result"].state.alpha
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    idx_i = torch.randint(0, x.shape[0], (1024,), generator=gen,
                          device=DEVICE)
    idx_j = torch.randint(0, x.shape[0], (1024,), generator=gen,
                          device=DEVICE)
    return (x[idx_i].contiguous(), x[idx_j].contiguous(),
            alpha[idx_j].contiguous(), y[idx_i].contiguous())


def phase_profile(out):
    """torch.profiler over 32 training steps: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dsekl, sampler
    cfg, x, y = out["cfg"], out["x"], out["y"]
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    idx_i, idx_j = sampler.epoch_plan(gen, x.shape[0], 1024, 1024, 32)
    st = out["result"].state
    for t in range(4):                                   # warm-up
        st = dsekl.step_serial(cfg, st, x, y, idx_i[t], idx_j[t])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(32):
            st = dsekl.step_serial(cfg, st, x, y, idx_i[t], idx_j[t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = _device_rows(prof)
    total = sum(r[0] for r in rows)
    check(total > 0, "torch.profiler recorded no device time")
    ours = sum(r[0] for r in rows if "(anonymous namespace)" in r[1])
    print(f"[profile] 32 steps: wall {wall * 1e3:.3f} ms (profiler on), "
          f"device busy {total / 1e3:.3f} ms = "
          f"{total / 1e3 / (wall * 1e3):.1%} of the wall; the train pass's "
          f"kernels {ours / 32:.1f} us a step of {total / 32:.1f}")
    for dev_us, key, count in rows[:12]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms {count:5d}x {key[:90]}")
    return total / 1e3 / 32


def _row(name, source, replaces, t, ops_count, bytes_count, device_name,
         err, t_gemm):
    """One row of the kernels line from ``_timed``'s readings ``t``.
    ``ms`` and ``plain_ms`` are device time per call; ``wall_ms`` and
    ``plain_wall_ms`` are one call by CUDA events, the host's enqueue
    included."""
    flop_peak, byte_peak = peaks(device_name)
    t_ops = ops_count / flop_peak * 1e3
    t_bytes = bytes_count / byte_peak * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "ms": statistics.mean(t["kernel"]),
        "plain_ms": statistics.mean(t["plain"]),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None, "gemm_ms": t_gemm,
        "wall_ms": statistics.median(t["kernel_wall"]),
        "plain_wall_ms": statistics.median(t["plain_wall"]),
    }


def _timed(kernel, plain) -> dict:
    """Device ms per call (``device_ms``, 25 calls a reading) in turns
    plain, kernel, kernel, plain; then 25 CUDA-event timings of one call
    of each."""
    t = {"plain": [device_ms(plain)], "kernel": [device_ms(kernel)]}
    t["kernel"].append(device_ms(kernel))
    t["plain"].append(device_ms(plain))
    t["kernel_wall"] = time_ms(kernel)
    t["plain_wall"] = time_ms(plain)
    return t


def _print_row(row, t, shape: str, n_ops: float, n_bytes: float,
               gemm: str) -> None:
    print(f"[times] {row['name']} {shape} (rbf): device {row['ms']:.4f} ms "
          f"a call ({t['kernel'][0]:.4f}, {t['kernel'][1]:.4f}); one call "
          f"by events {row['wall_ms']:.4f} ms (min {min(t['kernel_wall']):.4f},"
          f" max {max(t['kernel_wall']):.4f}); plain device "
          f"{row['plain_ms']:.4f} ms, by events {row['plain_wall_ms']:.4f} "
          f"ms; bound {row['bound_ms']:.6f} ms ({row['bound_by']}: "
          f"{n_ops:.3e} ops, {n_bytes:.3e} B); gemm yardstick {gemm} device "
          f"{row['gemm_ms']:.4f} ms")


def phase_train_times(out, device_name: str):
    """vecmat, dual pass and train pass at the training step's shape."""
    import torch
    from repro_torch.core.losses import get_loss
    from repro_torch.kernels.dsekl import block
    xi, xj, aj, yi = _step_inputs(out)
    n_i, d = xi.shape
    n_j = xj.shape[0]
    # The step's own v: the hinge gradient at its decision values.
    f, _ = block.train_pass_plain(xi, xj, aj, yi, loss="hinge")
    v = get_loss("hinge").grad_f(f, yi).contiguous()
    t_gemm = device_ms(lambda: torch.matmul(xi, xj.T))
    cross, norms, epi = 2 * n_i * n_j * d, 2 * d * (n_i + n_j), 8 * n_i * n_j
    src = "src/repro_torch/kernels/dsekl/csrc/"
    rows = []
    cases = [
        ("kernel_vecmat", src + "dsekl_matvec.cu",
         "src/repro/kernels/dsekl/block.py:280",
         lambda: block.kernel_vecmat_cuda(xi, xj, v),
         lambda: block.kernel_vecmat_plain(xi, xj, v),
         cross + norms + epi, 4 * (n_i * d + n_j * d + n_i + n_j)),
        ("dual_pass", src + "dsekl_train.cu",
         "src/repro/kernels/dsekl/block.py:330",
         lambda: block.dual_pass_cuda(xi, xj, aj, v),
         lambda: block.dual_pass_plain(xi, xj, aj, v),
         cross + norms + epi + 2 * n_i * n_j,
         4 * (n_i * d + n_j * d + n_j + n_i + n_i + n_j)),
        ("train_pass", src + "dsekl_train.cu",
         "src/repro/kernels/dsekl/block.py:432",
         lambda: block.train_pass_cuda(xi, xj, aj, yi, loss="hinge"),
         lambda: block.train_pass_plain(xi, xj, aj, yi, loss="hinge"),
         cross + norms + epi + 2 * n_i * n_j + 4 * n_i,
         4 * (n_i * d + n_j * d + n_j + n_i + n_i + n_j)),
    ]
    for name, source, replaces, kernel, plain, n_ops, n_bytes in cases:
        got, want = kernel(), plain()
        if isinstance(got, tuple):
            err = max(compare(got[0], want[0]), compare(got[1], want[1]))
        else:
            err = compare(got, want)
        t = _timed(kernel, plain)
        row = _row(name, source, replaces, t, n_ops, n_bytes, device_name,
                   err, t_gemm)
        rows.append(row)
        _print_row(row, t, f"I={n_i} J={n_j} D={d}", n_ops, n_bytes,
                   "torch.matmul(xi, xj.T)")
    return rows


def phase_times(res, device_name: str):
    import torch
    from repro_torch.core.dsekl import truncate
    from repro_torch.kernels.dsekl import block, ops
    eng = res["engine"]
    a_sv, x_sv = truncate(res["alpha"], res["x_train"])
    x_sv = ops.pad_rows_to_block(x_sv, eng.sv_block).contiguous()
    a_sv = ops.pad_rows_to_block(a_sv, eng.sv_block).contiguous()
    check(x_sv.shape[0] == eng.n_sv_padded, "support geometry mismatch")
    xq = res["queries"][:eng.engine_cfg.query_block].to(DEVICE).contiguous()
    params = dict(eng.cfg.kernel_params)
    n_i, d = xq.shape
    n_j = x_sv.shape[0]

    def kernel():
        return block.kernel_matvec_cuda(xq, x_sv, a_sv, kernel_name="rbf",
                                        params=params)

    def plain():
        return block.kernel_matvec_plain(xq, x_sv, a_sv, kernel_name="rbf",
                                         params=params)

    def gemm():
        return torch.matmul(xq, x_sv.T)

    torch.backends.cuda.matmul.allow_tf32 = False
    err = compare(kernel(), plain())
    t = _timed(kernel, plain)
    t_gemm = device_ms(gemm)
    # Work of this call: the cross term, the row norms, and the RBF
    # epilogue per (i, j): |x|^2+|z|^2-2xz, clamp, scale, exp, *a, +.
    ops_count = 2 * n_i * n_j * d + 2 * d * (n_i + n_j) + 8 * n_i * n_j
    bytes_count = 4 * (n_i * d + n_j * d + n_j + n_i)
    row = _row("kernel_matvec",
               "src/repro_torch/kernels/dsekl/csrc/dsekl_matvec.cu",
               "src/repro/kernels/dsekl/block.py:252", t, ops_count,
               bytes_count, device_name, err, t_gemm)
    _print_row(row, t, f"I={n_i} J={n_j} D={d}", ops_count, bytes_count,
               "torch.matmul(xq, x_sv.T)")
    print("[times] clocks.sm,power.draw,power.limit,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return row


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name, smi = phase_device()
    phase_build()
    phase_parity()
    res, launches = phase_serve()
    trained = phase_train()
    phase_train_cuda_vs_ref(trained["out"])
    vecmat_launches = phase_train_two_pass(trained["out"]["cfg"])
    step_device_ms = phase_profile(trained["out"])
    rows = [phase_times(res, name)] + phase_train_times(trained["out"],
                                                         name)
    launches = {"kernel_matvec": launches, "kernel_vecmat": vecmat_launches,
                "dual_pass": trained["dual_launches"],
                "train_pass": trained["launches"]}
    for row in rows:
        row["launches"] = launches[row["name"]]
    train = next(r for r in rows if r["name"] == "train_pass")
    step_ms = trained["ms_per_step"]
    print(f"[train] {trained['steps_per_s']:.1f} steps/s, {step_ms:.4f} "
          f"ms/step (epoch 2 wall); the train pass's kernels take "
          f"{train['ms']:.4f} ms of device time = {train['ms'] / step_ms:.1%}"
          f" of the step, one call of its wrapper {train['wall_ms']:.4f} ms "
          f"by events = {train['wall_ms'] / step_ms:.1%}; device busy "
          f"{step_device_ms:.4f} ms/step (profiler)")
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # report the failed phase, exit non-zero
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
