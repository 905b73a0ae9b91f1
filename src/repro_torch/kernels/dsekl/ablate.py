"""What holds the sm90 matvec kernel back: variants of
``csrc/dsekl_matvec_sm90.cu``, each with one part cut or changed, timed on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.dsekl.ablate

Each variant is the kernel's source with text substitutions, built with
``_build.NVCC_FLAGS`` into ``build/repro_torch/ablate/`` and timed at the
serving shape (I = 1024 queries, J = 282,624 support rows, D = 54, RBF
with gamma 1, covertype-like rows from a seed): CUDA events around 20
calls enqueued behind a spin kernel after a warm-up, in turns (the
variants in order, then in reverse), averaged.  Every variant, the kernel
as built included, compiles only the instantiation that shape runs (RBF,
7 k-steps), so that the builds take seconds.  A variant computes another
function; only the kernel as built is held to the plain version
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).  A variant's time less
the kernel's is what the changed part costs on the card.  The variants:
the fold's tile function replaced by acc * a_j; one TF32 product (x_hi
z_hi) in place of three; the RBF by ``expf`` in place of ``exp2f``; the
producer's split left out; and the producer alone (no products, no
fold).  Needs a card; prints the
card's name and power limit and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
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


def variant_source(name: str) -> str:
    """The kernel's source with ``name``'s substitutions."""
    src = SOURCE.read_text()
    for old, new in ONLY_SERVED + VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found "
                             f"{src.count(old)} times in {SOURCE.name}")
        src = src.replace(old, new)
    return src


def build(names) -> Dict[str, ctypes.CDLL]:
    """Build the variants in parallel (one nvcc each); raise on a failure.
    A variant's source sits beside the kernel's header, in the build
    directory, with an include path to ``csrc``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT_DIR / f"dsekl_matvec_sm90_{name}.cu"
        src.write_text(variant_source(name))
        lib = OUT_DIR / f"libdsekl_matvec_sm90_{name}.so"
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
                 if "C75" in ln
                 or ("spill" in ln and " 0 bytes spill" not in ln)]
        print(f"[ablate] built {name}" + (f": {notes}" if notes else ""))
        libs[name] = block.typed_matvec_lib(ctypes.CDLL(str(lib)), "sm90")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data import make_covertype_like
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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
    base = statistics.mean(times["kernel"])
    rows = []
    print(f"[ablate] I={n_i} J={n_j} D={d} rbf gamma 1, float32; {smi}")
    for name, (what, _) in VARIANTS.items():
        ms = statistics.mean(times[name])
        rows.append({"variant": name, "what": what, "ms": ms,
                     "readings": times[name]})
        print(f"[ablate] {name:12s} {ms:.4f} ms ({ms - base:+.4f}): {what}")
    print(json.dumps({"device": smi, "shape": SHAPE, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
