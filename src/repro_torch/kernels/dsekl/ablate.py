"""What holds the sm90 DSEKL kernels back: variants of
``csrc/dsekl_matvec_sm90.cu`` and of ``csrc/dsekl_train_sm90.cu``, each
with one part cut or changed, timed on the card.

    PYTHONPATH=src python -m repro_torch.kernels.dsekl.ablate [--kernel
        matvec|train|all]

Each variant is the kernel's source with text substitutions, built with
``_build.NVCC_FLAGS`` into ``build/repro_torch/ablate/`` and timed with
CUDA events around a run of calls enqueued behind a spin kernel after a
warm-up, in turns (the variants in order, then in reverse), averaged.
Every variant, the kernel as built included, compiles only the
instantiation its shape runs, so that the builds take seconds.  A variant
computes another function; only the kernel as built is held to the plain
version (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  A variant's
time less the kernel's is what the changed part costs on the card.  Every
variant still stores what its work produced, so that the compiler keeps
the work.

The matvec (``--kernel matvec``), at the serving shape (I = 1024 queries,
J = 282,624 support rows, D = 54, RBF with gamma 1, covertype-like rows
from a seed; the (RBF, 7 k-steps) instantiation): the fold's tile
function replaced by acc * a_j; one TF32 product (x_hi z_hi) in place of
three; the RBF by ``expf`` in place of ``exp2f``; the producer's split
left out; and the producer alone (no products, no fold).

The train pass (``--kernel train``), at the training step's shape (I = J
= 1024 rows drawn with replacement from 559,890 covertype-like rows, D =
54, RBF with gamma 1, hinge, lam 1e-4; the RBF instantiation):
the loads and the cross term alone (each thread stores the sum of its
accumulators: no epilogue, no f, no g); the loads alone (the product loop
cut to one add a feature); no DSMEM exchange (each CTA takes its own row
partials for f: no cluster barrier); no g reduction (the row blocks'
partials stored, not summed); the launch and the index loads alone; and
the kernel as built on rows gathered beforehand (null indices: contiguous
rows).  Then the training step end to end (``dsekl.step_serial``, 546
steps of covertype-train's epoch: the same plan, adagrad, lam 1e-4, host
clock ending in a sync) with the train pass on each route, in turns
fp32, sm90, sm90, fp32, twice: the fp32 route (``SM90_TRAIN_MAX_J`` set
to 0) gathers x, y and alpha in Python and launches the three passes of
``csrc/dsekl_train.cu``, as the step did before the sm90 route.

Needs a card; prints the card's name and power limit and one JSON line a
kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dsekl import block

SOURCE = _build.KERNELS_DIR / "dsekl" / "csrc" / "dsekl_matvec_sm90.cu"
OUT_DIR = _build.BUILD_DIR / "ablate"
SHAPE = (1024, 282_624, 54)               # I, J, D: covertype-serve's call
SMALL = "      wgmma_tf32(acc, xl[kk], desc + kstep(kk), kk > 0);"
LARGE = "      wgmma_tf32(acc, xh[kk], desc + kstep(kk), 1);"
KV = ("        float kv =\n"
      "            k_value<KIND>(acc[4 * i + 2 * j + c], xn[j], znj, p, "
      "rbf_scale);\n")
ADD = "        rowacc[j] = fmaf(kv, aj, rowacc[j]);\n"
MASKED = "        if (MASK) kv = 8 * i + c < lim ? kv : 0.0f;\n"
SPLIT = ("      split_tile<PANELS>(smem + Z_OFF + s * STAGE_BYTES, slot,\n"
         "                         chunk_off(z + static_cast<size_t>(g0) * D),"
         "\n                         min(BN, J - g0), D, pw, lane);\n")
# Every variant: only the (RBF, 7 k-steps) kernel is instantiated.
ONLY_SERVED = [
    ("if constexpr (K != LAPLACIAN) {", "if constexpr (K == RBF) {"),
    ("        case 4: err = f(matvec_sm90<K, 4>); break;\n", ""),
    ("        default: err = f(matvec_sm90<K, 8>); break;\n",
     "        default: break;\n"),
]
# name -> (what it changes, substitutions (old, new), each found once)
VARIANTS: Dict[str, Tuple[str, List[Tuple[str, str]]]] = {
    "kernel": ("the kernel as built", []),
    "acc_times_a": ("the fold adds acc * a_j: no tile function",
                    [(KV, "        float kv = acc[4 * i + 2 * j + c];\n")]),
    "one_product": ("x_hi z_hi alone: one TF32 product, not three",
                    [(SMALL, LARGE.replace("1);", "kk > 0);")),
                     (LARGE, "      ;")]),
    "expf": ("the RBF by expf(-gamma d2) (tile_value's) for exp2f",
             [("return exp2f(rbf_scale * d2);",
               "return expf(-p.gamma * d2);")]),
    "no_split": ("the producer copies but does not split: the stages keep "
                 "stale values", [(SPLIT, "")]),
    "producer_only": ("no products and no fold: the producer's copy and "
                      "split alone",
                      [(SMALL, "      ;"), (LARGE, "      ;"), (KV, ""),
                       (MASKED, ""), (ADD, "")]),
}


# The train pass: csrc/dsekl_train_sm90.cu at the training step's shape.
TRAIN_SOURCE = _build.KERNELS_DIR / "dsekl" / "csrc" / "dsekl_train_sm90.cu"
TRAIN_N = 559_890                          # covertype-train's rows
TRAIN_SHAPE = (1024, 1024, 54)             # I, J, D: the step's block
SECTION = {n: f"  // -- {n}." for n in range(1, 8)}
# Every train variant: only the RBF kernel is instantiated.
TRAIN_ONLY_STEP = [
    ("""  const bool known = with_kind(kind, [&](auto k) {
    err = cudaLaunchKernelEx(&launch.cfg,
                             tsm90::train_sm90<decltype(k)::value>, args);
  });
""", """  const bool known = kind == RBF;
  if (known) err = cudaLaunchKernelEx(&launch.cfg, tsm90::train_sm90<RBF>,
                                      args);
"""),
    ("""  with_kind(kind, [&](auto k) {
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, tsm90::train_sm90<decltype(k)::value>, &launch.cfg);
    if (err != cudaSuccess) n = -static_cast<int>(err);
  });
""", """  if (kind == RBF) {
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &n, tsm90::train_sm90<RBF>, &launch.cfg);
    if (err != cudaSuccess) n = -static_cast<int>(err);
  }
"""),
]
# Sections 3-7 (K, f, v, g) cut: each thread stores its accumulators' sum
# into the variant's own scratch.
STORE_ACC = """  {
    float s = 0.0f;
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) s += acc[t][m][n];
    args.g_parts[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)
                 * NT + tid] = s;
  }
}
"""
# Sections 2-7 cut: each thread stores the y and a values it loaded.
INDICES_ONLY = """  args.g_parts[(static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x)
               * NT + tid] = vy_r + a_r;
}
"""
PRODUCTS = """#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            if constexpr (KIND == LAPLACIAN)
              acc[t][m][n] += fabsf(xr[m] - zr[n]);
            else
              acc[t][m][n] = fmaf(xr[m], zr[n], acc[t][m][n]);
          }
"""
EXCHANGE = """  cluster.sync();
  if (tid < ROWS) {
    float part[MAX_CLUSTER];                   // all C reads in flight
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      part[q] = q < n_rank ? cluster.map_shared_rank(&fpart[0], q)[tid]
                           : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < n_rank) s += part[q];
"""
G_SUM = SECTION[6]
# name -> (what it changes, substitutions (old, new) each found once, or
# (section a, section b, new) to replace from section a's line up to the
# kernel's end or to section b's line)
TRAIN_VARIANTS: Dict[str, Tuple[str, list]] = {
    "kernel": ("the kernel as built, rows read by index", []),
    "contiguous": ("the kernel as built on rows gathered beforehand (null "
                   "indices); the gathers not timed", []),
    "indices_only": ("the launch and the index loads alone: sections 2-7 "
                     "cut, each thread stores the y and a it read",
                     [(2, None, INDICES_ONLY)]),
    "cross_term": ("the loads and the cross term alone: sections 3-7 (K, f, "
                   "v, g) cut, each thread stores its accumulators' sum",
                   [(3, None, STORE_ACC)]),
    "loads_only": ("the loads alone: as cross_term, the product loop cut to "
                   "one add a feature",
                   [(3, None, STORE_ACC),
                    (PRODUCTS, "        acc[t][0][0] += xr[0] + zr[0];\n")]),
    "no_exchange": ("no DSMEM exchange: f from the CTA's own row partials, "
                    "no cluster barrier",
                    [(EXCHANGE, "  __syncthreads();\n  if (tid < ROWS) {\n"
                      "    float s = fpart[tid];\n"),
                     ("  cluster_arrive();\n", ""),
                     ("  cluster_wait();\n}\n", "}\n")]),
    "no_g_reduction": ("no g reduction: the row blocks' g partials stored, "
                       "not summed (no fence, counter or last-CTA sum)",
                       [(6, 7, "  if (jv) args.g_parts[static_cast<size_t>"
                               "(blockIdx.y) * J + j] = gsum;\n")]),
}


def _substitute(src: str, subs, what: str, where: str) -> str:
    for sub in subs:
        if isinstance(sub[0], int):
            start, stop, new = sub
            a = src.index(SECTION[start])
            b = (src.index(SECTION[stop]) if stop is not None
                 else src.index("\n}\n", a) + 3)
            src = src[:a] + new + src[b:]
            continue
        old, new = sub
        if src.count(old) != 1:
            raise ValueError(f"variant {what}: {old!r} found "
                             f"{src.count(old)} times in {where}")
        src = src.replace(old, new)
    return src


def variant_source(name: str, kernel: str = "matvec") -> str:
    """The ``kernel``'s source with variant ``name``'s substitutions."""
    if kernel == "train":
        return _substitute(TRAIN_SOURCE.read_text(),
                           TRAIN_ONLY_STEP + TRAIN_VARIANTS[name][1], name,
                           TRAIN_SOURCE.name)
    return _substitute(SOURCE.read_text(), ONLY_SERVED + VARIANTS[name][1],
                       name, SOURCE.name)


def build(names, kernel: str = "matvec") -> Dict[str, ctypes.CDLL]:
    """Build the ``kernel``'s variants in parallel (one nvcc each); raise
    on a failure.  A variant's source sits beside the kernel's header, in
    the build directory, with an include path to ``csrc``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stem = (TRAIN_SOURCE if kernel == "train" else SOURCE).stem
    procs = {}
    for name in names:
        src = OUT_DIR / f"{stem}_{name}.cu"
        src.write_text(variant_source(name, kernel))
        lib = OUT_DIR / f"lib{stem}_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(SOURCE.parent),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "C75" in ln or "registers" in ln
                 or ("spill" in ln and " 0 bytes spill" not in ln)]
        print(f"[ablate] built {stem} {name}"
              + (f": {notes}" if notes else ""))
        lib = ctypes.CDLL(str(lib))
        libs[name] = (block.typed_train_sm90_lib(lib) if kernel == "train"
                      else block.typed_matvec_lib(lib, "sm90"))
    return libs


def events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms a call: CUDA events around ``reps`` calls, enqueued behind
    a spin kernel of ~20 ms so that the host's enqueue is not in the
    reading."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _report(what: str, shape, times: Dict[str, List[float]], variants,
            smi: str) -> None:
    base = statistics.mean(times["kernel"])
    rows = []
    print(f"[ablate] {what}; {smi}")
    for name, (desc, _) in variants.items():
        ms = statistics.mean(times[name])
        rows.append({"variant": name, "what": desc, "ms": ms,
                     "readings": times[name]})
        print(f"[ablate] {name:14s} {ms:.5f} ms ({ms - base:+.5f}): {desc}")
    print(json.dumps({"device": smi, "kernel": what, "shape": shape,
                      "variants": rows}))


def ablate_matvec(smi: str) -> None:
    from repro_torch.data import make_covertype_like
    libs = build(VARIANTS)
    n_i, n_j, d = SHAPE
    z, _ = make_covertype_like(n_j, d, seed=0, device="cuda")
    x, _ = make_covertype_like(n_i, d, seed=1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    a = torch.randn(n_j, generator=gen, device="cuda")
    kind = block.KINDS["rbf"]
    params = block.tile_params("rbf", {"gamma": 1.0})
    times: Dict[str, List[float]] = {n: [] for n in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            times[name].append(events_ms(
                lambda: block.launch_matvec(libs[name], "sm90", x, z, a,
                                            kind, params)))
    _report(f"matvec sm90, I={n_i} J={n_j} D={d} rbf gamma 1, float32",
            SHAPE, times, VARIANTS, smi)


def ablate_train(smi: str) -> None:
    from repro_torch.core.losses import LOSS_CODES
    from repro_torch.data import make_covertype_like
    names = [n for n in TRAIN_VARIANTS if n != "contiguous"]
    libs = build(names, "train")
    libs["contiguous"] = libs["kernel"]
    n_i, n_j, d = TRAIN_SHAPE
    x, y = make_covertype_like(TRAIN_N, d, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    alpha = 0.01 * torch.randn(TRAIN_N, generator=gen, device="cuda")
    idx_i = torch.randint(0, TRAIN_N, (n_i,), generator=gen, device="cuda")
    idx_j = torch.randint(0, TRAIN_N, (n_j,), generator=gen, device="cuda")
    xi, yi = x[idx_i].contiguous(), y[idx_i].contiguous()
    xj, aj = x[idx_j].contiguous(), alpha[idx_j].contiguous()
    kind = block.KINDS["rbf"]
    params = block.tile_params("rbf", {"gamma": 1.0})
    # Room for every variant: the cross-term ones store a float a thread.
    g_parts = torch.empty((-(-n_i // 64) * 8 * 320,), device="cuda")
    counters = torch.zeros((8,), dtype=torch.int32, device="cuda")

    def call(name):
        lib = libs[name]
        if name == "contiguous":
            args = (xi, None, xj, None, aj, yi)
        else:
            args = (x, idx_i, x, idx_j, alpha, y)
        return block.launch_train_sm90(
            lib, *args, n_i, n_j, kind, params, LOSS_CODES["hinge"], 1.0,
            1e-4, scratch=(g_parts, counters))

    times: Dict[str, List[float]] = {n: [] for n in TRAIN_VARIANTS}
    for order in (list(TRAIN_VARIANTS), list(TRAIN_VARIANTS)[::-1]):
        for name in order:
            times[name].append(events_ms(lambda: call(name), reps=200))
    if counters.any():
        raise RuntimeError("a variant left its arrival counters non-zero")
    _report(f"train sm90, I={n_i} J={n_j} D={d} rows by index from "
            f"N={TRAIN_N}, rbf gamma 1, hinge, float32", TRAIN_SHAPE, times,
            TRAIN_VARIANTS, smi)
    step_ab(x, y, gen, smi)


def step_ab(x, y, gen, smi: str, steps: int = 546) -> None:
    """ms a training step with the train pass on each route, in turns."""
    from repro_torch.core import dsekl, sampler
    cfg = dsekl.DSEKLConfig(n_grad=TRAIN_SHAPE[0], n_expand=TRAIN_SHAPE[1],
                            kernel="rbf", kernel_params=(("gamma", 1.0),),
                            lam=1e-4, schedule="adagrad")
    idx_i, idx_j = sampler.epoch_plan(gen, x.shape[0], cfg.n_grad,
                                      cfg.n_expand, steps)
    max_j = block.SM90_TRAIN_MAX_J

    def epoch(route: str) -> float:
        block.SM90_TRAIN_MAX_J = max_j if route == "sm90" else 0
        try:
            st = dsekl.init_state(x.shape[0], device="cuda")
            before = dict(block.train_pass_indexed_cuda.launches_by_route)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(steps):
                st = dsekl.step_serial(cfg, st, x, y, idx_i[t], idx_j[t])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
        finally:
            block.SM90_TRAIN_MAX_J = max_j
        if (block.train_pass_indexed_cuda.launches_by_route[route]
                - before[route]) != steps:
            raise RuntimeError(f"the {route} epoch missed its route")
        return ms

    epoch("fp32")
    epoch("sm90")                                        # warm-ups
    readings: Dict[str, List[float]] = {"fp32": [], "sm90": []}
    for route in ("fp32", "sm90", "sm90", "fp32") * 2:
        readings[route].append(epoch(route))
    print(f"[ablate] step, {steps} steps of I=J={TRAIN_SHAPE[0]} from "
          f"N={x.shape[0]}; {smi}")
    for route, ms in readings.items():
        print(f"[ablate] step {route}: median {statistics.median(ms):.4f} "
              f"ms a step ({1e3 / statistics.median(ms):.1f} steps/s); "
              f"readings {[round(v, 4) for v in ms]}")
    print(json.dumps({"device": smi, "kernel": "train step",
                      "steps": steps, "ms_a_step": readings}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("matvec", "train", "all"),
                    default="all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 2
    smi = _smi()
    if args.kernel in ("matvec", "all"):
        ablate_matvec(smi)
    if args.kernel in ("train", "all"):
        ablate_train(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
