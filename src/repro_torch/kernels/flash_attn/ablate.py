"""What holds the sm90 flash kernel back: variants of
``csrc/flash_attn_sm90.cu``, each with one part cut or cheapened, timed on
the card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attn.ablate

Each variant is the kernel's source with a text substitution, built with
``_build.NVCC_FLAGS`` into ``build/repro_torch/ablate/`` and timed at the
served shape (B 4, H 32, Kv 8, S = T = 2048, D 128, bf16 inputs from a
seed), causal and not: CUDA events around 20 calls enqueued behind a spin
kernel after a warm-up, in turns (the variants in order, then in
reverse), averaged.  A variant
computes another function; only the kernel as built is held to the plain
version (``chip_smoke.py``, ``tests/test_torch_cuda.py``).  A variant's
time less the kernel's is what the cut part costs on the card.  Needs a
card; prints the card's name and power limit and one JSON line.
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
from repro_torch.kernels.flash_attn import kernel

SOURCE = _build.KERNELS_DIR / "flash_attn" / "csrc" / "flash_attn_sm90.cu"
OUT_DIR = _build.BUILD_DIR / "ablate"
SHAPE = (4, 2048, 32, 8, 128)            # B, S = T, H, Kv, D: jamba's prefill
P_LO = "    wgmma_pv<D>(o, lo[kk], dv + ((kk * 16 * ROW_BYTES) >> 4));\n"
EXP = "s[e] = expf(s[e] - m[j]);"
# softmax_tile after the scale and mask: the row max, alpha, p and l.
SOFTMAX = ("  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};\n",
           "  for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + rs[j];\n")
# name -> (what it changes, substitutions: (old, new) replaces old, found
# once; (start, end, new) replaces start up to end, each found once)
VARIANTS: Dict[str, Tuple[str, List[tuple]]] = {
    "kernel": ("the kernel as built", []),
    "fast_exp": ("p by __expf (ex2.approx) instead of expf",
                 [(EXP, "s[e] = __expf(s[e] - m[j]);")]),
    "no_exp": ("p = s - m: no exponential", [(EXP, "s[e] = s[e] - m[j];")]),
    "no_p_lo": ("P_lo V left out: P rounded to bf16", [(P_LO, "")]),
    "no_softmax": ("p = scaled, masked s: no max, exponential or sum",
                   [(*SOFTMAX, "  alpha[0] = alpha[1] = 1.f;\n"
                                 "  const float rs[2] = {0.f, 0.f};\n"
                                 "#pragma unroll\n")]),
}


def variant_source(name: str) -> str:
    """The kernel's source with ``name``'s substitutions."""
    src = SOURCE.read_text()
    for *cut, new in VARIANTS[name][1]:
        for text in cut:
            if src.count(text) != 1:
                raise ValueError(f"variant {name}: {text!r} found "
                                 f"{src.count(text)} times in {SOURCE.name}")
        start = src.index(cut[0])
        end = src.index(cut[-1]) + (len(cut[-1]) if len(cut) == 1 else 0)
        src = src[:start] + new + src[end:]
    return src


def build(names) -> Dict[str, ctypes.CDLL]:
    """Build the variants in parallel (one nvcc each); raise on a failure."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT_DIR / f"flash_attn_sm90_{name}.cu"
        src.write_text(variant_source(name))
        lib = OUT_DIR / f"libflash_attn_sm90_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        notes = [ln.strip() for ln in log.splitlines()
                 if "C75" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
        print(f"[ablate] built {name}" + (f": {notes}" if notes else ""))
        libs[name] = kernel.typed(ctypes.CDLL(str(lib)), "sm90")
    return libs


def events_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms a call: CUDA events around ``reps`` calls, enqueued behind
    a spin kernel of ~20 ms so that the host's enqueue (tensor maps,
    ctypes) is not in the reading."""
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build(VARIANTS)
    b, s, h, kv, d = SHAPE
    gen = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(sh, generator=gen).to("cuda", torch.bfloat16)
               for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    out = torch.empty_like(q)
    times: Dict[str, Dict[bool, List[float]]] = {
        n: {True: [], False: []} for n in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            for causal in (True, False):
                times[name][causal].append(events_ms(
                    lambda: kernel.launch(libs[name], "sm90", q, k, v, out,
                                          causal=causal, window=1 << 30)))
    rows = []
    base = {c: statistics.mean(times["kernel"][c]) for c in (True, False)}
    print(f"[ablate] B={b} S=T={s} H={h} Kv={kv} D={d} bf16; {smi}")
    for name, (what, _) in VARIANTS.items():
        ms = {c: statistics.mean(times[name][c]) for c in (True, False)}
        rows.append({"variant": name, "what": what, "causal_ms": ms[True],
                     "noncausal_ms": ms[False]})
        print(f"[ablate] {name:9s} causal {ms[True]:.4f} ms "
              f"({ms[True] - base[True]:+.4f}), non-causal {ms[False]:.4f} ms "
              f"({ms[False] - base[False]:+.4f}): {what}")
    print(json.dumps({"device": smi, "shape": SHAPE, "variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
