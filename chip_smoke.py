#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main paths on the card — serving a DSEKL model
through ``repro_torch.launch.serve.serve_dsekl``, training one through
``repro_torch.launch.train.train_dsekl`` then serving it, and serving the
jamba-v0.1-52b language model at full width through
``repro_torch.launch.serve.serve_lm`` — with every kernel built from this
checkout's sources and held against its plain PyTorch version.  Phases
(any failure exits non-zero and prints no result):

  1. device  — name, compute capability, ``nvidia-smi`` name and power
               limit; requires sm_90.
  2. build   — nvcc builds every kernel source (build seconds, ptxas);
               the three tensor-core libraries' ptxas registers, shared
               memory, spills and warnings, and their SASS counts by
               cuobjdump: HGMMA (wgmma) and, for flash and the SSD scan,
               UTMALDG (TMA) must be > 0; the sm90 matvec must spill
               nothing.
  3. parity  — each DSEKL kernel vs its plain version on the card, 7
               kernels x D in {3, 54, 784} at ragged I=1000, J=5003:
               matvec, vecmat, the dual pass, the train pass for the 4
               losses at f_scale 1 and N/|J|, and ops.kernel_dual_pass's
               matvec-then-vecmat fallback under a forced small stash
               budget; each launch counter must go up by one per call,
               and the matvec and vecmat on their route
               (``block.select_matvec_route``: sm90 for the six
               cross-term kinds at D <= 64, fp32 for the rest).  The
               dual and train passes on both train routes
               (``block.select_train_route``: J = 5003 on the fp32 one,
               the ragged J = 1000 on the sm90 one), and the indexed
               train pass (rows read by index from the 5003, duplicates
               among them, lam 1e-4) against its plain version and,
               bit for bit, against the same kernel on the rows gathered
               beforehand.
  4. lm-parity — flash attention (causal and not, window 64 and 0, GQA
               32/8 and 4/1, D 64 and 128, ragged S, S != T, and lengths at
               the 128-row tiles' edges: 127, 128, 129, 255, 257) in
               float32 through the fp32 route and in bfloat16 through the
               sm90 route (and bf16 at D 48 through the fp32 route), twice
               each with the same bits, and the SSD scan (n 16 and 128, hd
               64, chunk 256 and 128, ragged S) in float32 through the fp32
               route and in bfloat16 through the sm90 route (lengths at the
               chunk's edges, g 2, a fast decay; twice each with the same
               bits) vs their plain versions; counters +1 per call, on the
               expected route.
  5. serve   — the DSEKL serving path at the covertype scale: 559,890 x
               54 training rows, RBF, ~50% support, 16,384 queries in
               requests of 64, query_block 1024, through flush_async and
               flush; answers checked against the plain path; the
               kernel's launches must equal the serve calls, all on the
               sm90 route.
  6. train   — the training path at full width: ``train_dsekl`` on the
               covertype protocol (559,890 x 54 training rows after the
               2,048-row hold-out, |I| = |J| = 1024, hinge, adagrad, 2
               epochs = 1,092 steps); the indexed train pass's launches
               must equal the steps, all on the sm90 route (no launch of
               the contiguous train pass), two more steps under a
               TorchFunctionMode must index none of x, y and alpha in
               Python, alpha be finite and the last validation error beat
               the all-zero model's; then the trained model is served
               through ``engine_from_fit`` and its error must equal the
               fit's, up to labels whose |f| is within tolerance of 0.
  7. train-cuda-vs-ref — 16 Alg.-1 steps on one shared plan at the main
               shape (square loss) with impl "cuda" and "ref": alpha and
               accum must agree.
  8. train-two-pass — a fit with fuse_dual_pass=False (N = 65,536, one
               epoch of 64 steps): vecmat launches must equal the steps,
               on the sm90 route (and the validation evals of phase 6).
  9. profile — torch.profiler over 32 steps of the training path: device
               time by kernel, device kernels launched a step and the
               device's busy share.
 10. times   — each DSEKL kernel at its main path's shape (and the RBF
               delegation of row 5): its device time per call
               (``device_ms``: CUDA events around 25 calls enqueued
               behind a spin kernel, two readings), its bound (the matvec
               and vecmat on the sm90 route: products at the TF32 tensor
               peak, the rest at fp32), the plain version's and the fp32
               cross-term GEMM yardstick's device time, and one call of
               kernel and plain by CUDA events (the host's enqueue
               included), in ms; for row 1 also the TF32 cross-term GEMM
               (a second yardstick, not the same function) and the fp32
               route at the same shape, on a line of its own; rows 3 and 4
               on the sm90 train route (row 4 as the step calls it: rows
               by index, lam), the contiguous sm90 train pass, and both on
               the fp32 route at the same shape, each on a line of its
               own.  Every route of every kernel is a row of the
               kernels line (``kernel_route``).
 11. serve-jamba — the LM main path: jamba-v0.1-52b at full width cut to
               one period of 8 layers (7 mamba + 1 attention, 4 MoE FFNs),
               bf16, random weights from a seed, 4 random prompts of 2,048
               tokens, 32 greedy tokens each (cache 2,080); the flash and
               SSD counters must read 1 and 7 per prefill (none in
               decode), every flash and SSD launch on the sm90 route;
               prefill and
               decode times on the host clock; the
               timed prefill's flash and SSD launches, their inputs and
               outputs kept at the model's call sites, are each held
               against the plain version on those activations; then the
               same model's prefill logits with impl "ref" must match
               within 2e-2 x max|ref|, and the greedy-token agreement is
               printed; then torch.profiler over one prefill and 8
               decode steps: device time by kernel (the SSD scan and the
               MoE dispatch's scan among them).
 12. lm-times — flash attention and the SSD scan (both on the sm90 route)
               at their served shapes: device time, one call by events, the
               plain version's device time, the bound (products at the bf16
               tensor-core peak, the rest at fp32), and for flash SDPA's
               device time on the same bf16 values in the same call (a
               yardstick the port never calls); then each kernel's fp32
               route at the same shape in float32 against its plain
               version, on a line of its own.

The DSEKL kernel tolerance is the JAX suite's float32 one
(tests/test_dual_pass.py ``_tols``): rtol 2e-4, atol 1e-5 * max(1,
|oracle|_inf), on both matvec routes (the sm90 one splits its TF32
products three ways to keep float32's function).  The 16-step
cuda-vs-ref trajectory is held at rtol 1e-3, atol 1e-4 * max(1,
|oracle|_inf): sixteen steps of float32 sums taken in
another order, and duplicate J indices scattered by atomics on the card.
Flash attention and the SSD scan in float32 are held at the JAX suite's
tolerances (tests/test_kernels_models.py): flash 2e-6, SSD 1e-4, each atol
times max(1, |oracle|_inf) as above.  Given bfloat16 inputs, which the
kernels convert at load, each is held against its plain version on the
same values in float32: the bfloat16 output at rtol 8e-3 (one rounding)
with atol 1e-5 (flash) or 1e-4 (SSD) times max(1, |oracle|_inf), the
SSD's float32 final state at its float32 tolerance.  The sm90 flash and
SSD kernels are held to that same check: each splits its float32 factors
into bf16 terms (flash's P into two; the SSD's P into three, its state and
B o w into two) so that its products keep float32's function.
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
SM90_PARITY_J = 1000                     # the ragged J of the sm90 train route
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
# fp32 outside the tensor cores, dense TF32 and bf16 on the tensor cores
# and HBM bandwidth (NVIDIA data sheets; TF32 is half the bf16 rate).
PEAKS = [  # (name substring, fp32, tf32 tensor, bf16 tensor FLOP/s, bytes/s)
    ("H100 PCIe", 51.2e12, 378e12, 756e12, 2.0e12),
    ("H100 NVL", 60.0e12, 417.5e12, 835e12, 3.9e12),
    ("H200", 67.0e12, 494.5e12, 989e12, 4.8e12),
    ("H100", 67.0e12, 494.5e12, 989e12, 3.35e12),
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
          f"abs err {float(err.max()):.3e} (atol {atol:.3e}, rtol {rtol})")
    return float(err.max()) if err.numel() else 0.0


def peaks(device_name: str) -> dict:
    """The named card's peaks: FLOP/s "fp32", "tf32" and "bf16" (tensor
    cores, dense), and "bytes"/s."""
    for key, *rates in PEAKS:
        if key in device_name:
            return dict(zip(("fp32", "tf32", "bf16", "bytes"), rates))
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


# GPU clock cycles per ms of ``torch.cuda._sleep``'s spin (measured once),
# and the readings of ``device_ms``: kept, taken again behind a longer
# spin, and kept though the host paced them.
SPIN = {"cycles_per_ms": None}
READINGS = {"kept": 0, "retaken": 0, "host_paced": 0}


def _spin(ms: float) -> None:
    """Keep the current stream busy for about ``ms`` ms (a spin kernel)."""
    import torch
    if SPIN["cycles_per_ms"] is None:
        torch.cuda._sleep(1_000_000)                     # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        SPIN["cycles_per_ms"] = 20_000_000 / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * SPIN["cycles_per_ms"]))


def device_ms(fn, reps: int = 25, warmup: int = 3, readings: int = 2,
              max_spin_ms: float = 1000.0) -> float:
    """Device time of one call in ms: the mean of ``readings`` readings,
    each CUDA events around ``reps`` calls enqueued back to back behind a
    spin kernel, over ``reps``.  The spin lasts twice the host's enqueue
    of ``reps`` calls (timed in the warm-up), so the host has enqueued
    every call before the device reaches the first: a reading leaves out
    the enqueue (argument checks, allocation, the launch itself), which
    at a few us of device work is most of a call, and keeps the device's
    own gaps between kernels.  A reading whose start event the device
    passed before the host had enqueued every call is taken again behind
    a spin twice as long; past ``max_spin_ms`` it is kept and counted as
    paced by the host (a function of many small launches that fill the
    launch queue).  No event can be lost: torch.profiler, which timed
    these rows before, dropped kernel events from its readings on the
    card."""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / max(warmup, 1) * reps
    torch.cuda.synchronize()
    spin_ms = min(max(2.0 * host_ms, 1.0), max_spin_ms)
    kept = []
    while len(kept) < readings:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        _spin(spin_ms)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        overtaken = start.query()
        end.synchronize()
        if overtaken and spin_ms < max_spin_ms:
            spin_ms = min(2.0 * spin_ms, max_spin_ms)
            READINGS["retaken"] += 1
            continue
        if overtaken:
            READINGS["host_paced"] += 1
            print(f"[device_ms] {fn.__qualname__}: the device reached the "
                  f"calls before the host had enqueued them, behind a "
                  f"{spin_ms:.0f} ms spin; the reading is paced by the host")
        kept.append(start.elapsed_time(end) / reps)
    READINGS["kept"] += readings
    return statistics.mean(kept)


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
    _inspect_sm90(records["flash_attn_sm90"], "flash sm90",
                  ("HGMMA", "UTMALDG", "UTMASTG"))
    _inspect_sm90(records["ssd_sm90"], "ssd sm90", ("HGMMA", "UTMALDG"))
    _inspect_sm90(records["dsekl_matvec_sm90"], "matvec sm90", ("HGMMA",))
    _check_no_spills(records["dsekl_matvec_sm90"], "matvec sm90")
    return records


def _check_no_spills(rec, what: str) -> None:
    """ptxas must report 0 bytes spilled for every kernel of ``rec``."""
    spills = [ln.strip() for ln in rec.log.splitlines()
              if "spill" in ln and not (" 0 bytes spill stores" in ln
                                        and " 0 bytes spill loads" in ln)]
    check(not spills, f"{what}: ptxas spilled registers: {spills[:3]}")
    print(f"[build] {what}: 0 bytes spilled in every kernel")


def _inspect_sm90(rec, what: str, required) -> None:
    """A tensor-core library: ptxas's registers, shared memory, spills and
    warnings for each kernel, and the SASS instructions that prove the
    tensor-core (and TMA) path (cuobjdump, where the toolkit has it): each
    of ``required`` must be > 0."""
    from repro_torch.kernels import _build
    for line in rec.log.splitlines():
        if any(w in line for w in ("registers", "spill", "smem", "warning",
                                   "C75", "setmaxnreg")):
            print(f"[build] {what} {line.strip()[:200]}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        print(f"[build] {what}: no cuobjdump at {cuobjdump}; SASS not "
              "counted")
        return
    sass = subprocess.run([cuobjdump, "-sass", str(rec.path)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout.splitlines()
    counts = {op: sum(op in line for line in sass)
              for op in ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP", "MUFU.EX2")}
    print(f"[build] {what} SASS (every instantiation): " + ", ".join(
        f"{op} {n}" for op, n in counts.items()))
    check(all(counts[op] for op in required),
          f"the {what} library lacks {required}: {counts}")


def _routed(fn, counter, route: str, what: str):
    """Call ``fn`` and check that ``counter`` counted one launch, on
    ``route``."""
    before = dict(counter.launches_by_route)
    out = _counted(fn, counter, what)
    before[route] += 1
    check(counter.launches_by_route == before,
          f"{what}: not launched on the {route} route")
    return out


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
        routes_before = dict(block.kernel_matvec_cuda.launches_by_route)
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
        # The indexed train pass: labels for the 5003 rows, and I and J
        # drawn with replacement (duplicates among them).
        y_n = dev(np.where(rng.standard_normal(n_j) >= 0, 1.0, -1.0))
        idx_i = torch.tensor(rng.integers(0, n_j, n_i), device=DEVICE)
        idx_j = torch.tensor(rng.integers(0, n_j, SM90_PARITY_J),
                             device=DEVICE)
        for name, params in PARITY_CASES:
            kw = dict(kernel_name=name, params=dict(params))
            # The matvec and vecmat: on the tensor-core route for the six
            # cross-term kinds at D <= 64, else on the fp32 one.
            route = block.select_matvec_route(name, d)
            check(route == ("sm90" if name != "laplacian"
                            and d <= block.SM90_MAX_D else "fp32"),
                  f"{name} D={d}: route {route}")
            wrappers = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
            by_route = [dict(f.launches_by_route) for f in wrappers]
            got = _counted(lambda: block.kernel_matvec_cuda(x, z, a, **kw),
                           block.kernel_matvec_cuda, name)
            want = block.kernel_matvec_plain(x, z, a, **kw)
            held(f"kernel_matvec {route}", got, want)
            got = _counted(lambda: block.kernel_vecmat_cuda(x, z, v, **kw),
                           block.kernel_vecmat_cuda, name)
            held(f"kernel_vecmat {route}", got,
                 block.kernel_vecmat_plain(x, z, v, **kw))
            for f, before in zip(wrappers, by_route):
                before[route] += 1
                check(f.launches_by_route == before,
                      f"{name} D={d}: not launched on the {route} route")
            # The dual and train passes on both train routes: the fp32
            # one at J = 5003, the sm90 one at the ragged J = 1000.
            for zz, aa in ((z, a), (z[:SM90_PARITY_J], a[:SM90_PARITY_J])):
                troute = block.select_train_route(n_i, zz.shape[0], d, name)
                check(troute == ("sm90" if zz.shape[0] <= block.SM90_TRAIN_MAX_J
                                 else "fp32"),
                      f"{name} D={d} J={zz.shape[0]}: train route {troute}")
                gf, gg = _routed(
                    lambda: block.dual_pass_cuda(x, zz, aa, v, **kw),
                    block.dual_pass_cuda, troute, name)
                wf, wg = block.dual_pass_plain(x, zz, aa, v, **kw)
                held(f"dual_pass {troute}", gf, wf)
                held(f"dual_pass {troute}", gg, wg)
                for loss in LOSSES:
                    yl = y_reg if loss == "square" else y
                    for f_scale in (1.0, TRAIN_N / zz.shape[0]):
                        gf, gg = _routed(
                            lambda: block.train_pass_cuda(
                                x, zz, aa, yl, loss=loss, f_scale=f_scale,
                                **kw),
                            block.train_pass_cuda, troute, f"{name} {loss}")
                        wf, wg = block.train_pass_plain(
                            x, zz, aa, yl, loss=loss, f_scale=f_scale, **kw)
                        held(f"train_pass {troute}", gf, wf)
                        held(f"train_pass {troute}", gg, wg)
            # The indexed train pass: rows of the J = 5003 block read by
            # index, as the step reads them from the training rows.
            ikw = dict(kw, loss="hinge", f_scale=TRAIN_N / SM90_PARITY_J,
                       lam=1e-4)
            gf, gg = _routed(
                lambda: block.train_pass_indexed_cuda(z, y_n, a, idx_i,
                                                      idx_j, **ikw),
                block.train_pass_indexed_cuda, "sm90", name)
            wf, wg = block.train_pass_indexed_plain(z, y_n, a, idx_i, idx_j,
                                                    **ikw)
            held("train_pass indexed", gf, wf)
            held("train_pass indexed", gg, wg)
            bf, bg = block.train_pass_cuda(
                z[idx_i], z[idx_j], a[idx_j], y_n[idx_i], loss="hinge",
                f_scale=TRAIN_N / SM90_PARITY_J, **kw)
            check(torch.equal(gf, bf)
                  and torch.equal(gg, bg + 1e-4 * a[idx_j]),
                  f"{name} D={d}: the indexed train pass differs from the "
                  "gathered one")
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
        routes = {r: n - routes_before[r] for r, n in
                  block.kernel_matvec_cuda.launches_by_route.items()}
        print(f"[parity] D={d:<4d} 7 kernels, matvec launches by route "
              f"{routes}, worst max abs err / max(1, |want|_inf): "
              + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
              + "; the indexed train pass equals the gathered one bit for "
              "bit")


def phase_serve():
    import torch
    from repro_torch.kernels.dsekl import block, ops
    from repro_torch.launch import serve
    block.kernel_matvec_cuda.launches = 0        # the main path starts here
    block.kernel_matvec_cuda.launches_by_route = dict.fromkeys(
        block.MATVEC_ROUTES, 0)
    runs = {}
    for mode, extra in (("flush_async", []), ("flush", ["--sync"])):
        args = serve.parser().parse_args(
            SERVE_ARGS + ["--device", DEVICE] + extra)
        runs[mode] = serve.serve_dsekl(args)
    launches = block.kernel_matvec_cuda.launches  # ... and ends here
    by_route = dict(block.kernel_matvec_cuda.launches_by_route)
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
    print(f"[serve] kernel_matvec launches={launches} (by route "
          f"{by_route}) serve_calls={serve_calls}")
    check(launches > 0 and launches == serve_calls,
          f"launches {launches} != serve calls {serve_calls}")
    check(by_route["sm90"] == launches,
          f"the serve launches did not all take the sm90 route: {by_route}")
    return runs["flush_async"], launches


def phase_train():
    """The training path at full width, then serving the trained model."""
    import torch
    from repro_torch.core.dsekl import decision_function, predict_labels
    from repro_torch.kernels.dsekl import block
    from repro_torch.launch import train
    from repro_torch.serving import engine_from_fit
    args = train.parser().parse_args(TRAIN_ARGS + ["--device", DEVICE])
    indexed = block.train_pass_indexed_cuda
    for f in (indexed, block.train_pass_cuda, block.dual_pass_cuda):
        f.launches = 0                         # the training path starts
        f.launches_by_route = dict.fromkeys(block.TRAIN_ROUTES, 0)
    block.kernel_matvec_cuda.launches = 0
    block.kernel_matvec_cuda.launches_by_route = dict.fromkeys(
        block.MATVEC_ROUTES, 0)
    out = train.train_dsekl(args)
    train_launches = indexed.launches                 # ... and ends here
    train_routes = dict(indexed.launches_by_route)
    contiguous_launches = block.train_pass_cuda.launches
    eval_launches = block.kernel_matvec_cuda.launches
    eval_routes = dict(block.kernel_matvec_cuda.launches_by_route)
    dual_launches = block.dual_pass_cuda.launches
    res, cfg = out["result"], out["cfg"]
    x, x_val, y_val = out["x"], out["x_val"], out["y_val"]
    check(tuple(x.shape) == (TRAIN_N, 54), f"training rows {tuple(x.shape)}")
    steps = res.epochs_run * max(x.shape[0] // cfg.n_grad, 1)
    print(f"[train] {res.epochs_run} epochs, {steps} steps: indexed "
          f"train_pass launches={train_launches} (by route {train_routes}),"
          f" contiguous train_pass launches={contiguous_launches}, "
          f"kernel_matvec launches (validation evals)={eval_launches} (by "
          f"route {eval_routes}), dual_pass launches={dual_launches}")
    check(train_launches == steps and steps == TRAIN_STEPS,
          f"train_pass launches {train_launches} != steps {steps}")
    check(train_routes == {"sm90": steps, "fp32": 0},
          f"the train-pass launches did not all take the sm90 route: "
          f"{train_routes}")
    check(contiguous_launches == 0, f"{contiguous_launches} launches of the "
          "contiguous train pass in a fit: the step gathered its rows")
    check(eval_launches == 2 and eval_routes["sm90"] == 2,
          f"{eval_launches} eval matvec launches ({eval_routes}), expected "
          "one per epoch's eval, on the sm90 route")
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
    _check_no_python_gathers(out)
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


# The torch functions that gather rows by index.
GATHERS = ("__getitem__", "index_select", "take", "gather", "index")


def _check_no_python_gathers(out) -> None:
    """Two more Alg.-1 steps of the trained fit under a TorchFunctionMode
    that records every gather, by the tensor it reads: none may read x,
    y or alpha (the kernel reads their rows by index); the scatter's read
    of the adagrad accumulator is counted."""
    import torch
    from torch.overrides import TorchFunctionMode
    from repro_torch.core import dsekl, sampler
    cfg, x, y = out["cfg"], out["x"], out["y"]
    st = out["result"].state
    watched = {x.data_ptr(): "x", y.data_ptr(): "y",
               st.alpha.data_ptr(): "alpha"}
    seen = []

    class Gathers(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if (name in GATHERS and args
                    and isinstance(args[0], torch.Tensor)):
                seen.append(watched.get(args[0].data_ptr(),
                                        f"{tuple(args[0].shape)}"))
            return func(*args, **(kwargs or {}))

    gen = torch.Generator(device=DEVICE).manual_seed(5)
    idx_i, idx_j = sampler.epoch_plan(gen, x.shape[0], cfg.n_grad,
                                      cfg.n_expand, 2)
    idx_i, idx_j = list(idx_i), list(idx_j)       # rows taken outside
    before = _indexed_launches()
    with Gathers():
        for t in range(2):
            st = dsekl.step_serial(cfg, st, x, y, idx_i[t], idx_j[t])
            watched[st.alpha.data_ptr()] = "alpha"
    torch.cuda.synchronize()
    block_launches = _indexed_launches() - before
    bad = [n for n in seen if n in ("x", "y", "alpha")]
    print(f"[train] 2 steps under a gather watch: {block_launches} indexed "
          f"train-pass launches; gathers in Python {seen} (none of x, y, "
          "alpha)")
    check(not bad and block_launches == 2,
          f"the step gathered {bad} in Python, or launched the indexed "
          f"train pass {block_launches} times for 2 steps")


def _indexed_launches() -> int:
    from repro_torch.kernels.dsekl import block
    return block.train_pass_indexed_cuda.launches_by_route["sm90"]


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
    for f in (block.kernel_vecmat_cuda, block.kernel_matvec_cuda):
        f.launches = 0                         # the two-pass path starts
        f.launches_by_route = dict.fromkeys(block.MATVEC_ROUTES, 0)
    res = fit(cfg.replace(fuse_dual_pass=False), x, y, gen, n_epochs=1,
              tol=0.0, device=DEVICE)
    vecmat = block.kernel_vecmat_cuda.launches  # ... and ends here
    matvec = block.kernel_matvec_cuda.launches
    routes = {"vecmat": dict(block.kernel_vecmat_cuda.launches_by_route),
              "matvec": dict(block.kernel_matvec_cuda.launches_by_route)}
    check(bool(torch.isfinite(res.state.alpha).all()), "non-finite alpha")
    steps = TWO_PASS_N // 1024
    print(f"[train-two-pass] {TWO_PASS_N} x 54, 1 epoch of {steps} steps: "
          f"kernel_vecmat launches={vecmat}, kernel_matvec launches="
          f"{matvec} (by route {routes}), "
          f"{res.history[0]['seconds'] * 1e3:.3f} ms")
    check(vecmat == steps and matvec == steps,
          f"two-pass launches vecmat={vecmat} matvec={matvec}, expected "
          f"{steps}")
    check(all(r["sm90"] == steps for r in routes.values()),
          f"two-pass launches off the sm90 route: {routes}")
    return vecmat


def _step_inputs(out):
    """One step's operands from the trained model: the training rows x, y
    and alpha, I = J = 1024 indices into them drawn with replacement, and
    the rows they pick, gathered."""
    import torch
    x, y, alpha = out["x"], out["y"], out["result"].state.alpha
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    idx_i = torch.randint(0, x.shape[0], (1024,), generator=gen,
                          device=DEVICE)
    idx_j = torch.randint(0, x.shape[0], (1024,), generator=gen,
                          device=DEVICE)
    return {"x": x, "y": y, "alpha": alpha, "idx_i": idx_i, "idx_j": idx_j,
            "xi": x[idx_i].contiguous(), "xj": x[idx_j].contiguous(),
            "aj": alpha[idx_j].contiguous(), "yi": y[idx_i].contiguous()}


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
    per_step = sum(r[2] for r in rows) / 32
    print(f"[profile] 32 steps: wall {wall * 1e3:.3f} ms (profiler on), "
          f"device busy {total / 1e3:.3f} ms = "
          f"{total / 1e3 / (wall * 1e3):.1%} of the wall; the train pass's "
          f"kernels {ours / 32:.1f} us a step of {total / 32:.1f}; "
          f"{per_step:.2f} device kernels (and copies, fills) a step")
    for dev_us, key, count in rows[:16]:
        print(f"[profile]   {dev_us / 1e3:9.3f} ms {count:5d}x {key[:90]}")
    return {"busy_ms": total / 1e3 / 32, "kernels": per_step,
            "busy_share": total / 1e3 / (wall * 1e3)}


def _row(name, source, replaces, t, ops_count, bytes_count, device_name,
         err, t_gemm=None, library=None, tensor_ops=0, tensor="bf16"):
    """One row of the kernels line from ``_timed``'s readings ``t``.
    ``ms`` and ``plain_ms`` are device time per call; ``wall_ms`` and
    ``plain_wall_ms`` are one call by CUDA events, the host's enqueue
    included; ``library_ms`` is one PyTorch call of the same function, where
    there is one, and ``gemm_ms`` the DSEKL kernels' cross-term GEMM.
    ``ops_count`` runs at the fp32 peak; ``tensor_ops``, the products the
    kernel runs on the tensor cores, at the ``tensor`` ("bf16" or "tf32")
    tensor peak, and the two times add up."""
    peak = peaks(device_name)
    t_ops = (ops_count / peak["fp32"] + tensor_ops / peak[tensor]) * 1e3
    t_bytes = bytes_count / peak["bytes"] * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": None, "max_abs_err": err,
        "ms": statistics.mean(t["kernel"]),
        "plain_ms": statistics.mean(t["plain"]),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library, "gemm_ms": t_gemm,
        "wall_ms": statistics.median(t["kernel_wall"]),
        "plain_wall_ms": statistics.median(t["plain_wall"]),
    }


def _route_row(name, source, replaces, ms, plain_ms, ops_ms, bytes_ms,
               err, library=None) -> dict:
    """A row of the kernels line for a kernel's fp32 route, timed at its
    sm90 route's shape (``ms``, ``plain_ms``: device ms a call; ``ops_ms``,
    ``bytes_ms``: the two halves of the bound)."""
    return {"name": name, "route": "cuda", "kernel_route": "fp32",
            "source": source, "replaces": replaces, "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library}


def _timed(kernel, plain) -> dict:
    """Device ms per call (``device_ms``: the mean of two readings of 25
    calls) in turns plain, kernel, kernel, plain; then 25 CUDA-event
    timings of one call of each."""
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
    """The vecmat, the dual pass and the train pass at the training step's
    shape: rows 3 and 4 on the sm90 train route (row 4 as the step calls
    it, rows by index with lam), the contiguous sm90 train pass on a line
    of its own, and both passes on the fp32 route as rows of their own."""
    import torch
    from repro_torch.core.losses import LOSS_CODES, get_loss
    from repro_torch.kernels.dsekl import block
    st = _step_inputs(out)
    xi, xj, aj, yi = st["xi"], st["xj"], st["aj"], st["yi"]
    n_i, d = xi.shape
    n_j = xj.shape[0]
    lam = out["cfg"].lam
    # The step's own v: the hinge gradient at its decision values.
    f, _ = block.train_pass_plain(xi, xj, aj, yi, loss="hinge")
    v = get_loss("hinge").grad_f(f, yi).contiguous()
    t_gemm = device_ms(lambda: torch.matmul(xi, xj.T))
    cross, norms, epi = 2 * n_i * n_j * d, 2 * d * (n_i + n_j), 8 * n_i * n_j
    src = "src/repro_torch/kernels/dsekl/csrc/"
    route = block.select_matvec_route("rbf", d)
    check(route == "sm90", f"the step's vecmat takes the {route} route")
    troute = block.select_train_route(n_i, n_j, d, "rbf")
    check(troute == "sm90", f"the step's train pass takes the {troute} "
          "route")
    kind, p = block.KINDS["rbf"], block.tile_params("rbf", None)
    row_blocks = -(-n_i // block.SM90_TRAIN_ROWS)
    clusters = block._train_sm90_lib().dsekl_train_sm90_active_clusters(
        kind, n_j)
    print(f"[times] train_pass sm90 route: {row_blocks} row blocks of "
          f"{block.SM90_TRAIN_ROWS} (clusters of {-(-n_j // 128)} CTAs); "
          f"the card holds {clusters} such clusters at once")

    def fp32_route(vy, code):
        return lambda: block._launch_train_fp32(
            "fp32 route", xi, xj, aj, vy, code, kind, p, 1.0)

    dual_ops = cross + norms + epi + 2 * n_i * n_j
    train_ops = dual_ops + 4 * n_i
    vec_bytes = 4 * (n_i * d + n_j * d + n_j + n_i + n_i + n_j)
    rows = []
    # (name, kernel route, source, replaces, kernel, plain, fp32 ops, TF32
    # tensor-core products, bytes): the vecmat runs its products on the
    # tensor cores; the indexed train pass also reads its indices and
    # adds lam * a_j.
    cases = [
        ("kernel_vecmat", "sm90", src + "dsekl_matvec_sm90.cu",
         "src/repro/kernels/dsekl/block.py:280",
         lambda: block.kernel_vecmat_cuda(xi, xj, v),
         lambda: block.kernel_vecmat_plain(xi, xj, v),
         norms + epi, cross, 4 * (n_i * d + n_j * d + n_i + n_j)),
        ("dual_pass", "sm90", src + "dsekl_train_sm90.cu",
         "src/repro/kernels/dsekl/block.py:330",
         lambda: block.dual_pass_cuda(xi, xj, aj, v),
         lambda: block.dual_pass_plain(xi, xj, aj, v),
         dual_ops, 0, vec_bytes),
        ("train_pass", "sm90", src + "dsekl_train_sm90.cu",
         "src/repro/kernels/dsekl/block.py:432",
         lambda: block.train_pass_indexed_cuda(
             st["x"], st["y"], st["alpha"], st["idx_i"], st["idx_j"],
             loss="hinge", lam=lam),
         lambda: block.train_pass_indexed_plain(
             st["x"], st["y"], st["alpha"], st["idx_i"], st["idx_j"],
             loss="hinge", lam=lam),
         train_ops + 2 * n_j, 0, vec_bytes + 8 * (n_i + n_j)),
        ("dual_pass_fp32", "fp32", src + "dsekl_train.cu",
         "src/repro/kernels/dsekl/block.py:330",
         fp32_route(v, -1), lambda: block.dual_pass_plain(xi, xj, aj, v),
         dual_ops, 0, vec_bytes),
        ("train_pass_fp32", "fp32", src + "dsekl_train.cu",
         "src/repro/kernels/dsekl/block.py:432",
         fp32_route(yi, LOSS_CODES["hinge"]),
         lambda: block.train_pass_plain(xi, xj, aj, yi, loss="hinge"),
         train_ops, 0, vec_bytes),
    ]
    for (name, kroute, source, replaces, kernel, plain, n_ops, n_tensor,
         n_bytes) in cases:
        got, want = kernel(), plain()
        if isinstance(got, tuple):
            err = max(compare(got[0], want[0]), compare(got[1], want[1]))
        else:
            err = compare(got, want)
        t = _timed(kernel, plain)
        row = _row(name, source, replaces, t, n_ops, n_bytes, device_name,
                   err, t_gemm, tensor_ops=n_tensor, tensor="tf32")
        row["kernel_route"] = kroute
        rows.append(row)
        _print_row(row, t, f"I={n_i} J={n_j} D={d}", n_ops + n_tensor,
                   n_bytes, f"torch.matmul(xi, xj.T); {kroute} route,")
    # The sm90 train pass on the same rows gathered beforehand, as
    # train_pass_cuda takes them: the price of reading by index.
    contiguous = [device_ms(lambda: block.train_pass_cuda(xi, xj, aj, yi,
                                                          loss="hinge"))
                  for _ in range(2)]
    train = next(r for r in rows if r["name"] == "train_pass")
    print(f"[times] train_pass sm90 route on the rows gathered beforehand "
          f"(train_pass_cuda, contiguous): device "
          f"{statistics.mean(contiguous):.4f} ms ({contiguous[0]:.4f}, "
          f"{contiguous[1]:.4f}) against {train['ms']:.4f} ms by index; "
          f"the fp32 route (csrc/dsekl_train.cu) at the same shape "
          f"{rows[-1]['ms']:.4f} ms = "
          f"{rows[-1]['ms'] / train['ms']:.2f}x the sm90 kernel")
    return rows


def _serve_inputs(res):
    """One serve call's operands: a query block and the padded support."""
    from repro_torch.core.dsekl import truncate
    from repro_torch.kernels.dsekl import ops
    eng = res["engine"]
    a_sv, x_sv = truncate(res["alpha"], res["x_train"])
    x_sv = ops.pad_rows_to_block(x_sv, eng.sv_block).contiguous()
    a_sv = ops.pad_rows_to_block(a_sv, eng.sv_block).contiguous()
    check(x_sv.shape[0] == eng.n_sv_padded, "support geometry mismatch")
    xq = res["queries"][:eng.engine_cfg.query_block].to(DEVICE).contiguous()
    return xq, x_sv, a_sv, dict(eng.cfg.kernel_params)


def _matvec_work(n_i: int, n_j: int, d: int):
    """(products, other operations, bytes) of one RBF matvec: the cross
    term's products; the row norms and the epilogue per (i, j):
    |x|^2+|z|^2-2xz, clamp, scale, exp, *a, +."""
    return (2 * n_i * n_j * d, 2 * d * (n_i + n_j) + 8 * n_i * n_j,
            4 * (n_i * d + n_j * d + n_j + n_i))


def phase_times(res, device_name: str):
    """Row 1 at the serve call's shape on the sm90 route (its bound: the
    products at the TF32 tensor peak, the rest at fp32), the fp32 and TF32
    cross-term GEMMs as yardsticks, then the fp32 route at the same shape
    on a line of its own."""
    import torch
    from repro_torch.kernels.dsekl import block
    xq, x_sv, a_sv, params = _serve_inputs(res)
    n_i, d = xq.shape
    n_j = x_sv.shape[0]
    check(block.select_matvec_route("rbf", d) == "sm90",
          "the serve shape does not take the sm90 route")

    def kernel():
        return block.kernel_matvec_cuda(xq, x_sv, a_sv, kernel_name="rbf",
                                        params=params)

    def plain():
        return block.kernel_matvec_plain(xq, x_sv, a_sv, kernel_name="rbf",
                                         params=params)

    def gemm():
        return torch.matmul(xq, x_sv.T)

    torch.backends.cuda.matmul.allow_tf32 = False
    before = block.kernel_matvec_cuda.launches_by_route["sm90"]
    got = kernel()
    check(block.kernel_matvec_cuda.launches_by_route["sm90"] == before + 1,
          "the serve shape's launch missed the sm90 route")
    want = plain()
    err = compare(got, want)
    t = _timed(kernel, plain)
    t_gemm = device_ms(gemm)
    torch.backends.cuda.matmul.allow_tf32 = True      # the TF32 yardstick
    try:
        t_gemm_tf32 = statistics.mean([device_ms(gemm), device_ms(gemm)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    products, ops_count, bytes_count = _matvec_work(n_i, n_j, d)
    row = _row("kernel_matvec",
               "src/repro_torch/kernels/dsekl/csrc/dsekl_matvec_sm90.cu",
               "src/repro/kernels/dsekl/block.py:252", t, ops_count,
               bytes_count, device_name, err, t_gemm, tensor_ops=products,
               tensor="tf32")
    row["matvec_route"] = "sm90"
    row["gemm_tf32_ms"] = t_gemm_tf32
    _print_row(row, t, f"I={n_i} J={n_j} D={d}", products + ops_count,
               bytes_count, "torch.matmul(xq, x_sv.T), fp32,")
    print(f"[times] kernel_matvec sm90 route: "
          f"{row['bound_ms'] / row['ms']:.1%} of its bound ({products:.3e} TF32 tensor-core products + "
          f"{ops_count:.3e} fp32 ops; the split's 3x products not counted); "
          f"the TF32 GEMM yardstick (torch.matmul, allow_tf32, one product "
          f"and the (I, J) output written) device {t_gemm_tf32:.4f} ms; the "
          f"kernel {row['ms'] / t_gemm:.3f}x the fp32 GEMM, "
          f"{row['ms'] / t_gemm_tf32:.3f}x the TF32 one")
    # The fp32 route at the same shape, against the same plain answer.
    lib32 = block._lib("fp32")
    kind, p = block.KINDS["rbf"], block.tile_params("rbf", params)

    def kernel32():
        return block.launch_matvec(lib32, "fp32", xq, x_sv, a_sv, kind, p)

    err32 = compare(kernel32(), want)
    t32 = [device_ms(kernel32), device_ms(kernel32)]
    peak = peaks(device_name)
    bound32 = max((products + ops_count) / peak["fp32"],
                  bytes_count / peak["bytes"]) * 1e3
    print(f"[times] kernel_matvec fp32 route, the same shape "
          f"(csrc/dsekl_matvec.cu): device {statistics.mean(t32):.4f} ms "
          f"({t32[0]:.4f}, {t32[1]:.4f}); bound {bound32:.4f} ms (all "
          f"{products + ops_count:.3e} operations at the fp32 peak) = "
          f"{bound32 / statistics.mean(t32):.1%}; vs plain: max abs err "
          f"{err32:.3e}; sm90 is {statistics.mean(t32) / row['ms']:.2f}x "
          "faster")
    row["fp32_route_ms"] = statistics.mean(t32)
    row["kernel_route"] = "sm90"
    row32 = _route_row(
        "kernel_matvec_fp32", "src/repro_torch/kernels/dsekl/csrc/"
        "dsekl_matvec.cu", "src/repro/kernels/dsekl/block.py:252",
        statistics.mean(t32), row["plain_ms"],
        (products + ops_count) / peak["fp32"] * 1e3,
        bytes_count / peak["bytes"] * 1e3, err32)
    print("[times] clocks.sm,power.draw,power.limit,temperature.gpu: "
          + nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu"))
    return [row, row32]


def phase_rbf_times(res, device_name: str):
    """Row 5: ``rbf_block.rbf_matvec``, the RBF delegation, at the serving
    shape.  It launches the matvec kernel (counted there) and has no
    caller on any main path, so its ``launches`` are 0."""
    import torch
    from repro_torch.kernels.dsekl import block, rbf_block
    xq, x_sv, a_sv, params = _serve_inputs(res)
    gamma = params["gamma"]

    def kernel():
        return rbf_block.rbf_matvec(xq, x_sv, a_sv, gamma=gamma)

    def plain():
        return block.kernel_matvec_plain(xq, x_sv, a_sv, kernel_name="rbf",
                                         params=params)

    err = compare(kernel(), plain())
    t = _timed(kernel, plain)
    route = block.select_matvec_route("rbf", xq.shape[1])
    products, ops_count, bytes_count = _matvec_work(
        xq.shape[0], x_sv.shape[0], xq.shape[1])
    row = _row("rbf_matvec",
               "src/repro_torch/kernels/dsekl/rbf_block.py",
               "src/repro/kernels/dsekl/rbf_block.py:26", t, ops_count,
               bytes_count, device_name, err,
               device_ms(lambda: torch.matmul(xq, x_sv.T)),
               tensor_ops=products, tensor="tf32")
    row["matvec_route"] = row["kernel_route"] = route
    _print_row(row, t, f"I={xq.shape[0]} J={x_sv.shape[0]} D={xq.shape[1]}",
               products + ops_count, bytes_count,
               f"torch.matmul(xq, x_sv.T) ({route} route)")
    return row


# ---------------------------------------------------------------------------
# The LM serving slice: flash attention and the SSD scan.
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (b, s, t, h, kv, d, causal, window)
    (2, 256, 256, 32, 8, 128, True, 1 << 30),    # jamba's GQA 32/8, D 128
    (2, 256, 256, 4, 1, 64, False, 1 << 30),     # 4/1, non-causal, D 64
    (1, 256, 256, 8, 2, 64, True, 64),           # sliding window 64
    (2, 200, 200, 32, 8, 128, True, 1 << 30),    # ragged S
    (1, 200, 333, 4, 1, 64, False, 64),          # ragged S != T
    (1, 130, 130, 4, 2, 128, True, 0),           # window 0: mean(v)
]
# Lengths at the edges of the sm90 kernel's 128-row tiles: causal S = T at
# jamba's GQA 32/8, D 128, and non-causal S != T at 4/1, D 64.
FLASH_EDGE_CASES = [c for n in (127, 128, 129, 255, 257) for c in (
    (1, n, n, 32, 8, 128, True, 1 << 30), (1, n, n + 3, 4, 1, 64, False,
                                           1 << 30))]
# bf16 at a head dim the sm90 kernel does not take: the fp32 route.
FLASH_FP32_BF16_CASE = (1, 130, 130, 4, 2, 48, False, 0)
FLASH_TOL = 2e-6                    # float32, tests/test_kernels_models.py
# bfloat16 inputs are converted to float32 at load, so a kernel given them
# is held against its plain version on the same values in float32: the
# output differs by one bfloat16 rounding (rtol 8e-3) and float32
# summation order (flash: atol 1e-5 x max(1, |want|_inf), five times its
# float32 tolerance; SSD: its own SSD_ATOL).
BF16_RTOL, FLASH_BF16_ATOL = 8e-3, 1e-5
SSD_CASES = [
    # (b, s, nh, hd, g, n, chunk)
    (2, 512, 16, 64, 1, 16, 256),                # jamba's n, chunk 256
    (1, 600, 8, 64, 1, 128, 128),                # mamba2's n, ragged S
    (2, 300, 8, 64, 2, 16, 256),                 # one partial chunk, g 2
    (1, 1000, 4, 64, 1, 128, 256),               # ragged last chunk
]
# bf16 cases of the SSD's sm90 route: lengths at the chunk's edges, g 2,
# and a fast decay (dt x 10: exp(cum) underflows within a chunk).
SSD_SM90_CASES = [
    # (b, s, nh, hd, g, n, chunk, dt_scale)
    (2, 255, 16, 64, 1, 16, 256, 1.0),
    (2, 257, 16, 64, 1, 16, 256, 1.0),
    (1, 1000, 8, 64, 2, 16, 128, 1.0),
    (1, 600, 8, 64, 1, 128, 128, 1.0),
    (1, 1000, 4, 64, 1, 128, 256, 1.0),
    (1, 520, 8, 64, 1, 16, 256, 10.0),
]
SSD_RTOL, SSD_ATOL = 1e-4, 1e-4                  # x max(1, |want|_inf)
# The main path: jamba-v0.1-52b at full width, cut to one period of 8
# layers (7 mamba, 1 attention; 4 MoE and 4 dense FFNs), bf16, 4 prompts of
# 2,048 tokens, 32 greedy tokens each.
JAMBA = dict(batch=4, prompt_len=2048, new_tokens=32, cache_len=2080,
             seed=0)
JAMBA_LAYERS = 8
LOGITS_TOL = 2e-2                                # x max|ref|, bf16 model
# The kernels' shapes on the main path: the attention layer's prefill
# (B, S, H, Kv, D) and a mamba layer's scan (B, S, nh, hd, g, n, chunk).
FLASH_SERVED = (4, 2048, 32, 8, 128)
SSD_SERVED = (4, 2048, 128, 64, 1, 16, 256)


def _rand(shape, gen, device, dtype):
    import torch
    return torch.randn(shape, generator=gen).to(device=device, dtype=dtype)


def _flash_inputs(case, dtype, seed=0):
    import torch
    b, s, t, h, kv, d = case[:6]
    gen = torch.Generator().manual_seed(seed + s + t + h + d)
    return [_rand(sh, gen, DEVICE, dtype)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


def _ssd_inputs(case, dtype, seed=0, dt_scale=1.0):
    import torch
    b, s, nh, hd, g, n = case[:6]
    gen = torch.Generator().manual_seed(seed + sum(case))
    x = _rand((b, s, nh, hd), gen, DEVICE, dtype)
    dt = (torch.nn.functional.softplus(torch.randn((b, s, nh), generator=gen))
          * dt_scale).to(DEVICE, dtype)
    a = -torch.exp(torch.randn((nh,), generator=gen) * 0.5).to(DEVICE)
    bm = _rand((b, s, g, n), gen, DEVICE, dtype)
    cm = _rand((b, s, g, n), gen, DEVICE, dtype)
    return x, dt, a, bm, cm


def phase_lm_parity():
    """Flash attention and the SSD scan vs their plain versions."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_chunked
    worst = {}
    runs = [(dtype, case) for dtype in (torch.float32, torch.bfloat16)
            for case in FLASH_CASES + FLASH_EDGE_CASES]
    runs.append((torch.bfloat16, FLASH_FP32_BF16_CASE))
    for dtype, case in runs:
        q, k, v = _flash_inputs(case, dtype)
        kw = dict(causal=case[6], window=case[7])
        route = fk.select_route(dtype, case[5], case[3], case[4])
        check(route == ("sm90" if dtype == torch.bfloat16 and case[5] in
                        (64, 128) else "fp32"), f"flash {case}: route {route}")
        by_route = dict(fk.flash_attention_cuda.launches_by_route)
        got = _counted(lambda: fk.flash_attention_cuda(q, k, v, **kw),
                       fk.flash_attention_cuda, f"flash {case}")
        by_route[route] += 1
        check(fk.flash_attention_cuda.launches_by_route == by_route,
              f"flash {case}: not launched on the {route} route")
        check(got.dtype == dtype, f"flash output is {got.dtype}")
        again = fk.flash_attention_cuda(q, k, v, **kw)
        check(torch.equal(again, got), f"flash {case}: two runs differ")
        want = flash_attention(q.float(), k.float(), v.float(),
                               impl="ref", **kw)
        rtol, atol = ((BF16_RTOL, FLASH_BF16_ATOL) if dtype == torch.bfloat16
                      else (FLASH_TOL, FLASH_TOL))
        err = compare(got.float(), want, rtol, atol)
        key = f"flash {str(dtype)[6:]} {route}"
        worst[key] = max(worst.get(key, 0.0), err)
    ssd_runs = ([(torch.float32, case + (1.0,)) for case in SSD_CASES]
                + [(torch.bfloat16, case) for case in SSD_SM90_CASES])
    for dtype, case in ssd_runs:
        x, dt, a, bm, cm = _ssd_inputs(case[:7], dtype,
                                       dt_scale=case[7])
        chunk = case[6]
        route = sk.select_route(dtype, case[3], case[5], chunk)
        check(route == ("sm90" if dtype == torch.bfloat16 else "fp32"),
              f"ssd {case} {dtype}: route {route}")
        by_route = dict(sk.ssd_cuda.launches_by_route)
        got = _counted(lambda: sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk),
                       sk.ssd_cuda, f"ssd {case}")
        by_route[route] += 1
        check(sk.ssd_cuda.launches_by_route == by_route,
              f"ssd {case}: not launched on the {route} route")
        again = sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk)
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"ssd {case}: two runs differ")
        want = ssd_chunked(x.float(), dt.float(), a, bm.float(), cm.float(),
                           chunk=chunk, impl="ref")
        key = f"ssd {str(dtype)[6:]} {route}"
        for g, w, rtol in zip(got, want, (
                BF16_RTOL if dtype == torch.bfloat16 else SSD_RTOL,
                SSD_RTOL)):
            err = compare(g.float(), w, rtol, SSD_ATOL)
            worst[key] = max(worst.get(key, 0.0),
                             err / max(1.0, float(w.abs().max())))
    print(f"[lm-parity] {len(FLASH_CASES) + len(FLASH_EDGE_CASES)} flash "
          f"cases x 2 dtypes + 1 bf16 case at D 48, {len(SSD_CASES)} ssd "
          f"cases in float32 + {len(SSD_SM90_CASES)} in bfloat16; routes by "
          f"launches flash {fk.flash_attention_cuda.launches_by_route}, ssd "
          f"{sk.ssd_cuda.launches_by_route}; worst max abs err: "
          + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + " (ssd: / max(1, |want|_inf); bf16 y at rtol "
          f"{BF16_RTOL}, the final state at {SSD_RTOL})")


def _greedy(engine, tokens, n_new):
    """(prefill logits, greedy tokens (B, n_new)) with the engine's model
    as it is set up (impl)."""
    import torch
    logits, cache = engine.prefill(tokens)
    out = [torch.argmax(logits, dim=-1)]
    for i in range(n_new - 1):
        step, cache = engine.decode_step(out[-1], cache,
                                         tokens.shape[1] + i)
        out.append(torch.argmax(step, dim=-1))
    return logits, torch.stack(out, dim=1)


def _recorder(module, name: str, store: list, per_prefill: int):
    """Wrap the op ``module.name`` at a model's call site so that each call
    keeps its arguments and output in ``store``, which holds one prefill's
    ``per_prefill`` calls (the last); returns the undo."""
    op = getattr(module, name)

    def recorded(*args, **kw):
        out = op(*args, **kw)
        if len(store) == per_prefill:
            store.clear()
        store.append((args, kw, out))
        return out

    setattr(module, name, recorded)
    return lambda: setattr(module, name, op)


def _held_bytes(calls) -> int:
    """Device bytes that the recorded calls keep alive (storages, once)."""
    import torch
    seen = {}
    for args, _, out in calls:
        outs = out if isinstance(out, tuple) else (out,)
        for t in (*args, *outs):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _hold_main_path(flash_calls, ssd_calls) -> None:
    """Each recorded launch of the main path against its plain version on
    the activations it was given, in float32: bfloat16 outputs at
    BF16_RTOL with atol FLASH_BF16_ATOL (flash) or SSD_ATOL (SSD), float32
    ones and the SSD's final state at the float32 tolerances."""
    import torch
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.ssd import ssd_chunked
    worst = {"flash": 0.0, "ssd y": 0.0, "ssd final": 0.0}
    bf16 = torch.bfloat16
    for args, kw, out in flash_calls:
        q, k, v = (t.float() for t in args)
        want = flash_attention(q, k, v, causal=kw["causal"],
                               window=kw["window"], impl="ref")
        rtol, atol = ((BF16_RTOL, FLASH_BF16_ATOL) if out.dtype == bf16
                      else (FLASH_TOL, FLASH_TOL))
        worst["flash"] = max(worst["flash"],
                             compare(out.float(), want, rtol, atol))
        del q, k, v, want
    for args, kw, (y, final) in ssd_calls:
        x, dt, a, bm, cm = (t.float() for t in args)
        wy, wf = ssd_chunked(x, dt, a, bm, cm, chunk=kw["chunk"],
                             impl="ref")
        rtol = BF16_RTOL if y.dtype == bf16 else SSD_RTOL
        worst["ssd y"] = max(worst["ssd y"],
                             compare(y.float(), wy, rtol, SSD_ATOL))
        worst["ssd final"] = max(worst["ssd final"],
                                 compare(final, wf, SSD_RTOL, SSD_ATOL))
        del x, dt, a, bm, cm, wy, wf
    print(f"[serve-jamba] the timed prefill's {len(flash_calls)} flash and "
          f"{len(ssd_calls)} ssd launches vs their plain versions on the "
          "activations they were given (float32): max abs err "
          + ", ".join(f"{k} {e:.3e}" for k, e in worst.items())
          + f" (bf16 outputs at rtol {BF16_RTOL}, atol x max(1, |want|)"
          f" flash {FLASH_BF16_ATOL}, ssd {SSD_ATOL}; final state "
          f"{SSD_RTOL} / {SSD_ATOL})")


def phase_serve_jamba():
    """The main path: serve_lm on jamba-v0.1-52b at full width."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.launch import serve
    from repro_torch.models import attention, moe, ssm
    cfg = get_config("jamba-v0.1-52b").replace(n_layers=JAMBA_LAYERS)
    n_attn = cfg.layer_pattern.count("attn")
    n_mamba = cfg.layer_pattern.count("mamba")
    # The kernels' inputs and outputs at the model's call sites, kept for
    # the last (timed) prefill: each launch is held against its plain
    # version on the activations it was given.
    flash_calls, ssd_calls = [], []
    undo = [_recorder(attention, "flash_attention", flash_calls, n_attn),
            _recorder(ssm, "ssd_chunked", ssd_calls, n_mamba)]
    fk.flash_attention_cuda.launches = 0          # the main path starts here
    fk.flash_attention_cuda.launches_by_route = dict.fromkeys(fk.ROUTES, 0)
    sk.ssd_cuda.launches = 0
    sk.ssd_cuda.launches_by_route = dict.fromkeys(sk.ROUTES, 0)
    try:
        res = serve.serve_lm(cfg, device=DEVICE, **JAMBA)
    finally:
        for fn in undo:
            fn()
    flash_n = fk.flash_attention_cuda.launches    # ... and ends here
    flash_routes = dict(fk.flash_attention_cuda.launches_by_route)
    ssd_n = sk.ssd_cuda.launches
    ssd_routes = dict(sk.ssd_cuda.launches_by_route)
    model, engine = res["model"], res["engine"]
    out, logits = res["out"], res["logits"]
    n_params = sum(p.numel() for p in model.parameters())
    held = _held_bytes(flash_calls + ssd_calls)
    print(f"[serve-jamba] {cfg.name}: {cfg.n_layers} layers "
          f"({n_mamba} mamba, {n_attn} attn), d_model {cfg.d_model}, "
          f"{n_params:,} parameters in {cfg.param_dtype}; init "
          f"{res['init_s']:.2f}s; peak {res['peak_bytes'] / 2**30:.2f} GiB "
          f"(timed prefill + decode), of which up to {held / 2**30:.2f} GiB"
          " are the kernels' inputs and outputs kept for the check")
    print(f"[serve-jamba] {res['prefills']} prefills (1 warm-up): "
          f"flash launches={flash_n} (by route {flash_routes}), ssd "
          f"launches={ssd_n} (by route {ssd_routes})")
    check(flash_routes["sm90"] == flash_n and flash_n > 0,
          f"the prefill's flash launches did not all take the sm90 route: "
          f"{flash_routes}")
    check(ssd_routes["sm90"] == ssd_n and ssd_n > 0,
          f"the prefill's ssd launches did not all take the sm90 route: "
          f"{ssd_routes}")
    check(flash_n == n_attn * res["prefills"] and
          ssd_n == n_mamba * res["prefills"],
          f"launches flash {flash_n} ssd {ssd_n}, expected {n_attn} and "
          f"{n_mamba} per prefill, none in decode")
    check(len(flash_calls) == n_attn and len(ssd_calls) == n_mamba,
          f"recorded {len(flash_calls)} flash and {len(ssd_calls)} ssd "
          "calls in the last prefill")
    check(tuple(out.shape) == (JAMBA["batch"], JAMBA["new_tokens"]),
          f"generated {tuple(out.shape)}")
    check(bool(torch.isfinite(logits.float()).all()), "non-finite logits")
    check(int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size,
          "token ids out of range")
    print(f"[serve-jamba] prefill {res['prefill_s'] * 1e3:.3f} ms = "
          f"{res['prefill_tokens_per_s']:.1f} tokens/s; decode "
          f"{res['decode_ms_per_step']:.4f} ms/step = "
          f"{res['decode_tokens_per_s']:.2f} tokens/s (host clock, each "
          "ending in a device synchronisation; warm-up excluded)")
    _hold_main_path(flash_calls, ssd_calls)
    del flash_calls, ssd_calls
    # A second gate: the same model's prefill with the plain versions.  Both
    # runs record each MoE layer's top-k expert sets, to count the tokens
    # routed elsewhere (a near-tie in the router flips on a rounding
    # difference, and the token's FFN output changes wholesale).
    routes = []
    moe_forward = moe.moe_forward

    def recording(p, c, x):
        logits = x.reshape(-1, x.shape[-1]).float() @ p.router.float()
        routes.append(torch.topk(logits, c.top_k, dim=-1)[1].sort(-1)[0])
        return moe_forward(p, c, x)

    moe.moe_forward = recording
    try:
        again, _ = engine.prefill(res["tokens"])
        n_moe = len(routes)
        t0 = time.perf_counter()
        model.impl = "ref"
        ref_logits, ref_out = _greedy(engine, res["tokens"],
                                      JAMBA["new_tokens"])
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
    finally:
        moe.moe_forward = moe_forward
        model.impl = "auto"
    rerouted = [int((c != r).any(-1).sum())
                for c, r in zip(routes[:n_moe], routes[n_moe:2 * n_moe])]
    scale = float(ref_logits.float().abs().max())
    err = float((logits.float() - ref_logits.float()).abs().max())
    agree = float((out == ref_out).float().mean())
    first = float((out[:, 0] == ref_out[:, 0]).float().mean())
    print(f"[serve-jamba] cuda vs ref prefill logits: max abs err {err:.4e} "
          f"(tolerance {LOGITS_TOL} x max|ref| = {LOGITS_TOL * scale:.4e}); "
          f"greedy tokens agree {agree:.1%} (first token {first:.0%}); "
          f"tokens routed to another expert set, per MoE layer, of "
          f"{out.shape[0] * res['tokens'].shape[1]}: {rerouted}; a second "
          f"cuda prefill differs by {float((again - logits).abs().max()):.1e};"
          f" ref generate {ref_s:.2f}s")
    check(err <= LOGITS_TOL * scale, "cuda and ref prefill logits differ")
    _profile_jamba(engine, res["tokens"])
    return {"flash": flash_n, "ssd": ssd_n, "res": res}


def _profile_jamba(engine, tokens, steps: int = 8):
    """torch.profiler over one prefill, then over ``steps`` decode steps:
    wall, device busy, and device time by kernel (the ten largest and the
    port's own)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    s = tokens.shape[1]
    for what in ("prefill", "decode"):
        logits, cache = engine.prefill(tokens)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                engine.prefill(tokens)
            else:
                for i in range(steps):
                    step, cache = engine.decode_step(tok, cache, s + i)
                    tok = torch.argmax(step, dim=-1)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = _device_rows(prof)
        total = sum(r[0] for r in rows) / 1e3
        per = 1 if what == "prefill" else steps
        print(f"[profile-jamba] {what} ({per} call{'s' * (per > 1)}): wall "
              f"{wall:.3f} ms (profiler on), device busy {total:.3f} ms = "
              f"{total / wall:.1%} of the wall; {len(rows)} kernel names")
        # The ten largest, and wherever they rank those in a top-level
        # anonymous namespace (the port's kernels and a few of PyTorch's)
        # and the scans (the MoE dispatch's cumsum).
        for rank, (dev_us, key, count) in enumerate(rows):
            if rank < 10 or key.startswith(("void (anonymous namespace)::",
                                            "(anonymous namespace)::")) or (
                    "scan" in key.lower()):
                print(f"[profile-jamba]   {dev_us / 1e3 / per:9.3f} ms/call "
                      f"{count // per:5d}x {key[:90]}")


def _pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the flash mask keeps."""
    total = 0
    for q in range(s):
        lo = max(0, q - window + 1)
        hi = min(q, t - 1) if causal else t - 1
        total += max(0, hi - lo + 1)
    return total


def _ssd_ops(s: int, chunk: int, n: int, hd: int):
    """(tensor-core products, fp32 operations) of the chunked scan for one
    (b, h).  Products: per chunk of L the intra pairs j <= i (the C.B dot
    and the score times the x dt row), per position the inter product
    C.state and its absorption into the state.  fp32: per pair the decay
    (subtract, exp, multiply), per position x dt, the sum of intra and
    inter and the cumsum, per chunk the state's decay."""
    tensor = fp32 = 0
    for c0 in range(0, s, chunk):
        ln = min(chunk, s - c0)
        pairs = ln * (ln + 1) // 2
        tensor += pairs * (2 * n + 2 * hd) + ln * 4 * n * hd
        fp32 += pairs * 3 + ln * (2 * hd + 4) + n * hd
    return tensor, fp32


def phase_lm_times(device_name: str):
    """Flash and SSD at the served shapes: device time per call
    (``device_ms``), one call by CUDA events, the plain version's device
    time, the bound, and (flash) SDPA on the same bf16 values; then each
    kernel's fp32 route at the same shape in float32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_chunked
    rows = []
    # Flash at the served shape, causal, bf16: the sm90 route.
    b, s, h, kv, d = FLASH_SERVED
    q, k, v = _flash_inputs((b, s, s, h, kv, d), torch.bfloat16, seed=11)
    check(fk.select_route(q.dtype, d, h, kv) == "sm90",
          "the served shape does not take the sm90 route")

    def kernel():
        return fk.flash_attention_cuda(q, k, v, causal=True)

    def plain():
        return flash_attention(q, k, v, causal=True, impl="ref")

    sm90_before = fk.flash_attention_cuda.launches_by_route["sm90"]
    got = kernel()
    check(fk.flash_attention_cuda.launches_by_route["sm90"] ==
          sm90_before + 1, "the served shape's launch missed the sm90 route")
    err = compare(got.float(), flash_attention(
        q.float(), k.float(), v.float(), causal=True, impl="ref"),
        BF16_RTOL, FLASH_BF16_ATOL)
    t = {"plain": [device_ms(plain, reps=5)], "kernel": [device_ms(kernel)]}
    t["kernel"].append(device_ms(kernel))
    t["plain"].append(device_ms(plain, reps=5))
    t["kernel_wall"], t["plain_wall"] = time_ms(kernel), time_ms(plain, 5)
    # SDPA on the same values, kv heads expanded beforehand, (B, H, S, D).
    qt = q.transpose(1, 2).contiguous()
    kt = torch.repeat_interleave(k, h // kv, dim=2).transpose(1, 2).contiguous()
    vt = torch.repeat_interleave(v, h // kv, dim=2).transpose(1, 2).contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_err = float((library().transpose(1, 2).float() - got.float())
                    .abs().max())
    lib_ms = statistics.mean([device_ms(library), device_ms(library)])
    # Per kept (query, key) pair: QK^T and PV, 4D products of bf16 values
    # on the tensor cores; scale, max-subtract and exp, 3 in fp32.
    pairs = _pairs(s, s, True, 1 << 30) * b * h
    n_tensor, n_ops = pairs * 4 * d, pairs * 3
    n_bytes = 2 * (2 * b * s * h * d + 2 * b * s * kv * d)
    rows.append(_row(
        "flash_attention", "src/repro_torch/kernels/flash_attn/csrc/"
        "flash_attn_sm90.cu", "src/repro/kernels/flash_attn/kernel.py:72",
        t, n_ops, n_bytes, device_name, err, library=lib_ms,
        tensor_ops=n_tensor))
    row = rows[-1]
    print(f"[times] flash_attention sm90 route, B={b} H={h} Kv={kv} S=T={s} "
          f"D={d} causal bf16: device {row['ms']:.4f} ms "
          f"({t['kernel'][0]:.4f}, {t['kernel'][1]:.4f}) = "
          f"{row['bound_ms'] / row['ms']:.1%} of the bound; by events "
          f"{row['wall_ms']:.4f} ms; plain device {row['plain_ms']:.4f} ms; "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{n_tensor:.3e} bf16 tensor ops + {n_ops:.3e} fp32 ops, "
          f"{n_bytes:.3e} B; the P split's extra 2D products a pair not "
          f"counted); SDPA device {lib_ms:.4f} ms = "
          f"{row['bound_ms'] / lib_ms:.1%} of the bound, the kernel "
          f"{row['ms'] / lib_ms:.2f}x SDPA (max abs diff to the kernel "
          f"{lib_err:.3e}); vs plain on float32 values: max abs err "
          f"{err:.3e}")
    del qt, kt, vt, got
    # The fp32 route at the same shape in float32, at the float32
    # tolerance, against its plain version.
    q32, k32, v32 = (x.float() for x in (q, k, v))
    del q, k, v

    def kernel32():
        return fk.flash_attention_cuda(q32, k32, v32, causal=True)

    def plain32():
        return flash_attention(q32, k32, v32, causal=True, impl="ref")

    fp32_before = fk.flash_attention_cuda.launches_by_route["fp32"]
    err32 = compare(kernel32(), plain32(), FLASH_TOL, FLASH_TOL)
    check(fk.flash_attention_cuda.launches_by_route["fp32"] ==
          fp32_before + 1, "the float32 launch missed the fp32 route")
    t32 = [device_ms(kernel32), device_ms(kernel32)]
    p32 = [device_ms(plain32, reps=5), device_ms(plain32, reps=5)]
    peak = peaks(device_name)
    bound32 = max((n_tensor + n_ops) / peak["fp32"],
                  2 * n_bytes / peak["bytes"])
    print(f"[times] flash_attention fp32 route, the same shape in float32 "
          f"(csrc/flash_attn.cu): device {statistics.mean(t32):.4f} ms "
          f"({t32[0]:.4f}, {t32[1]:.4f}); plain device "
          f"{statistics.mean(p32):.4f} ms; bound {bound32 * 1e3:.4f} ms (all "
          f"{n_tensor + n_ops:.3e} operations at the fp32 peak); vs plain: "
          f"max abs err {err32:.3e} (tolerance {FLASH_TOL})")
    rows[-1]["kernel_route"] = "sm90"
    rows.append(_route_row(
        "flash_attention_fp32", "src/repro_torch/kernels/flash_attn/csrc/"
        "flash_attn.cu", "src/repro/kernels/flash_attn/kernel.py:72",
        statistics.mean(t32), statistics.mean(p32),
        (n_tensor + n_ops) / peak["fp32"] * 1e3,
        2 * n_bytes / peak["bytes"] * 1e3, err32))
    del q32, k32, v32
    # SSD at the served shape (B x nh = 512 (b, h) blocks), bf16: the sm90
    # route.
    case = SSD_SERVED
    args = _ssd_inputs(case, torch.bfloat16, seed=12)
    check(sk.select_route(torch.bfloat16, case[3], case[5], case[6]) ==
          "sm90", "the served SSD shape does not take the sm90 route")

    def skernel():
        return sk.ssd_cuda(*args, chunk=case[6])

    def splain():
        return ssd_chunked(*args, chunk=case[6], impl="ref")

    sm90_before = sk.ssd_cuda.launches_by_route["sm90"]
    gy, gf = skernel()
    check(sk.ssd_cuda.launches_by_route["sm90"] == sm90_before + 1,
          "the served SSD launch missed the sm90 route")
    wy, wf = ssd_chunked(*(a.float() for a in args), chunk=case[6],
                         impl="ref")
    err = max(compare(gy.float(), wy, BF16_RTOL, SSD_ATOL),
              compare(gf, wf, SSD_RTOL, SSD_ATOL))
    # The plain version is a loop of ~20,000 launches: one call a reading,
    # paced by the host (``device_ms`` says so).
    t = {"plain": [device_ms(splain, reps=1, warmup=1)],
         "kernel": [device_ms(skernel)]}
    t["kernel"].append(device_ms(skernel))
    t["plain"].append(device_ms(splain, reps=1, warmup=1))
    t["kernel_wall"] = time_ms(skernel)
    t["plain_wall"] = time_ms(splain, reps=2, warmup=0)
    b, s, nh, hd, g, n, chunk = case
    n_tensor, n_ops = (b * nh * x for x in _ssd_ops(s, chunk, n, hd))
    n_bytes = (2 * (2 * b * s * nh * hd + b * s * nh + 2 * b * s * g * n)
               + 4 * nh + 4 * b * nh * hd * n)
    rows.append(_row(
        "ssd", "src/repro_torch/kernels/ssd/csrc/ssd_sm90.cu",
        "src/repro/kernels/ssd/kernel.py:74", t, n_ops, n_bytes,
        device_name, err, tensor_ops=n_tensor))
    row = rows[-1]
    print(f"[times] ssd sm90 route, B*nh={b * nh} S={s} hd={hd} n={n} "
          f"chunk={chunk} bf16: device {row['ms']:.4f} ms "
          f"({t['kernel'][0]:.4f}, {t['kernel'][1]:.4f}) = "
          f"{row['bound_ms'] / row['ms']:.1%} of the bound; by events "
          f"{row['wall_ms']:.4f} ms; plain device {row['plain_ms']:.4f} ms "
          f"(the sequential recurrence); bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {n_tensor:.3e} bf16 tensor ops + "
          f"{n_ops:.3e} fp32 ops, {n_bytes:.3e} B; the splits' extra "
          f"products not counted); no single PyTorch call computes it; vs "
          f"plain on float32 values: max abs err {err:.3e}")
    # The fp32 route at the same shape in float32, at the float32
    # tolerance, against its plain version.
    args32 = [t.float() for t in args]
    del args, gy, gf

    def skernel32():
        return sk.ssd_cuda(*args32, chunk=chunk)

    def splain32():
        return ssd_chunked(*args32, chunk=chunk, impl="ref")

    fp32_before = sk.ssd_cuda.launches_by_route["fp32"]
    gy, gf = skernel32()
    check(sk.ssd_cuda.launches_by_route["fp32"] == fp32_before + 1,
          "the float32 SSD launch missed the fp32 route")
    err32 = max(compare(gy, wy, SSD_RTOL, SSD_ATOL),
                compare(gf, wf, SSD_RTOL, SSD_ATOL))
    t32 = [device_ms(skernel32), device_ms(skernel32)]
    p32 = device_ms(splain32, reps=1, warmup=1, readings=1)
    peak = peaks(device_name)
    bytes32 = 2 * n_bytes - 4 * nh - 4 * b * nh * hd * n
    bound32 = max((n_tensor + n_ops) / peak["fp32"], bytes32 / peak["bytes"])
    print(f"[times] ssd fp32 route, the same shape in float32 "
          f"(csrc/ssd.cu): device {statistics.mean(t32):.4f} ms "
          f"({t32[0]:.4f}, {t32[1]:.4f}) = "
          f"{bound32 * 1e3 / statistics.mean(t32):.1%} of its bound; plain "
          f"device {p32:.4f} ms (one reading); bound {bound32 * 1e3:.4f} ms "
          f"(all {n_tensor + n_ops:.3e} operations at the fp32 peak, "
          f"{bytes32:.3e} B); vs plain: max abs err {err32:.3e} (tolerance "
          f"{SSD_RTOL} / {SSD_ATOL} x max(1, |want|_inf))")
    next(r for r in rows if r["name"] == "ssd")["kernel_route"] = "sm90"
    rows.append(_route_row(
        "ssd_fp32", "src/repro_torch/kernels/ssd/csrc/ssd.cu",
        "src/repro/kernels/ssd/kernel.py:74", statistics.mean(t32), p32,
        (n_tensor + n_ops) / peak["fp32"] * 1e3,
        bytes32 / peak["bytes"] * 1e3, err32))
    return rows


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

    def elapsed(what: str) -> None:
        print(f"[elapsed] {what}: {time.perf_counter() - t0:.1f}s")

    name, smi = phase_device()
    phase_build()
    elapsed("build")
    phase_parity()
    phase_lm_parity()
    elapsed("parity, lm-parity")
    res, launches = phase_serve()
    trained = phase_train()
    phase_train_cuda_vs_ref(trained["out"])
    vecmat_launches = phase_train_two_pass(trained["out"]["cfg"])
    step_profile = phase_profile(trained["out"])
    elapsed("serve, train, train-cuda-vs-ref, train-two-pass, profile")
    rows = phase_times(res, name) + [phase_rbf_times(res, name)]
    rows += phase_train_times(trained["out"], name)
    del res, trained["out"]
    elapsed("times")
    jamba = phase_serve_jamba()
    del jamba["res"]
    elapsed("serve-jamba")
    rows += phase_lm_times(name)
    elapsed("lm-times")
    # Launches on the main paths; every fp32 route has none there.
    launches = {"kernel_matvec": launches, "rbf_matvec": 0,
                "kernel_vecmat": vecmat_launches,
                "dual_pass": trained["dual_launches"],
                "train_pass": trained["launches"],
                "flash_attention": jamba["flash"], "ssd": jamba["ssd"]}
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
        check(row["name"] in launches or row["kernel_route"] == "fp32",
              f"no main-path launch count for {row['name']}")
    train = next(r for r in rows if r["name"] == "train_pass")
    step_ms = trained["ms_per_step"]
    print(f"[train] {trained['steps_per_s']:.1f} steps/s, {step_ms:.4f} "
          f"ms/step (epoch 2 wall); the train pass's kernels take "
          f"{train['ms']:.4f} ms of device time = {train['ms'] / step_ms:.1%}"
          f" of the step, one call of its wrapper {train['wall_ms']:.4f} ms "
          f"by events = {train['wall_ms'] / step_ms:.1%}; device busy "
          f"{step_profile['busy_ms']:.4f} ms/step (profiler; "
          f"{step_profile['busy_share']:.1%} of the profiled wall), "
          f"{step_profile['kernels']:.2f} device kernels a step")
    print(f"[device_ms] {READINGS['kept']} readings kept, "
          f"{READINGS['retaken']} taken again behind a longer spin, "
          f"{READINGS['host_paced']} paced by the host")
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
