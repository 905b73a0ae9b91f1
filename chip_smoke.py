#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port's main path — serving a trained DSEKL model through
``repro_torch.launch.serve.serve_dsekl`` — on the card, with every kernel
built from this checkout's sources and held against its plain PyTorch
version.  Phases (any failure exits non-zero and prints no result):

  1. device  — name, compute capability, ``nvidia-smi`` name and power
               limit; requires sm_90.
  2. build   — nvcc builds every kernel source (build seconds, ptxas).
  3. parity  — each kernel vs its plain version on the card, 7 kernels x
               D in {3, 54, 784} at ragged I=1000, J=5003.
  4. serve   — the main path at the covertype scale: 559,890 x 54
               training rows, RBF, ~50% support, 16,384 queries in
               requests of 64, query_block 1024, through flush_async and
               flush; answers checked against the plain path; the
               kernel's launches must equal the serve calls.
  5. times   — at the main path's shape: kernel, bound, plain version and
               the fp32 cross-term GEMM yardstick, in ms.

The tolerance is the JAX suite's float32 one (tests/test_dual_pass.py
``_tols``): rtol 2e-4, atol 1e-5 * max(1, |oracle|_inf).  It imports
nothing of JAX and nothing of the JAX package.
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


def compare(got, want) -> float:
    """Max abs error; raises unless got matches want at the tolerance."""
    import torch
    got, want = got.double(), want.double()
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    atol = ATOL * max(1.0, float(want.abs().max()) if want.numel() else 1.0)
    err = (got - want).abs()
    bad = err > atol + RTOL * want.abs()
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


def time_ms(fn, reps: int = 25, warmup: int = 3) -> list:
    """``reps`` CUDA-event timings of one call, in ms."""
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


def phase_parity():
    import numpy as np
    import torch
    from repro_torch.kernels.dsekl import block
    n_i, n_j = PARITY_SHAPE
    worst = 0.0
    for d in PARITY_DIMS:
        rng = np.random.default_rng(d)
        scale = 1.0 / np.sqrt(d)
        x = torch.tensor(rng.standard_normal((n_i, d)) * scale,
                         dtype=torch.float32, device=DEVICE)
        z = torch.tensor(rng.standard_normal((n_j, d)) * scale,
                         dtype=torch.float32, device=DEVICE)
        a = torch.tensor(rng.standard_normal(n_j), dtype=torch.float32,
                         device=DEVICE)
        for name, params in PARITY_CASES:
            before = block.kernel_matvec_cuda.launches
            got = block.kernel_matvec_cuda(x, z, a, kernel_name=name,
                                           params=dict(params))
            torch.cuda.synchronize()
            check(block.kernel_matvec_cuda.launches == before + 1,
                  f"{name}: launch count did not go up by one")
            want = block.kernel_matvec_plain(x, z, a, kernel_name=name,
                                             params=dict(params))
            err = compare(got, want)
            worst = max(worst, err)
            print(f"[parity] D={d:<4d} {name:<10s} max|f|="
                  f"{float(want.abs().max()):.3e} max abs err {err:.3e}")
    return worst


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
    # In turns (plain, kernel, kernel, plain), 2 x 25 runs each.
    t_plain = time_ms(plain)
    t_kernel = time_ms(kernel)
    t_kernel += time_ms(kernel)
    t_plain += time_ms(plain)
    t_gemm = statistics.median(time_ms(gemm))
    flop_peak, byte_peak = peaks(device_name)
    # Work of this call: the cross term, the row norms, and the RBF
    # epilogue per (i, j): |x|^2+|z|^2-2xz, clamp, scale, exp, *a, +.
    ops_count = 2 * n_i * n_j * d + 2 * d * (n_i + n_j) + 8 * n_i * n_j
    bytes_count = 4 * (n_i * d + n_j * d + n_j + n_i)
    t_ops = ops_count / flop_peak * 1e3
    t_bytes = bytes_count / byte_peak * 1e3
    row = {
        "name": "kernel_matvec", "route": "cuda",
        "source": "src/repro_torch/kernels/dsekl/csrc/dsekl_matvec.cu",
        "replaces": "src/repro/kernels/dsekl/block.py:252",
        "launches": None, "max_abs_err": err,
        "ms": statistics.median(t_kernel),
        "plain_ms": statistics.median(t_plain),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }
    print(f"[times] shape I={n_i} J={n_j} D={d} (rbf), median of "
          f"{len(t_kernel)}: kernel {row['ms']:.4f} ms (min "
          f"{min(t_kernel):.4f}, max {max(t_kernel):.4f}), plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {ops_count:.3e} ops, {bytes_count:.3e} B), "
          f"gemm yardstick torch.matmul(xq, x_sv.T) {t_gemm:.4f} ms")
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
    row = phase_times(res, name)
    row["launches"] = launches
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [row]}))
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
