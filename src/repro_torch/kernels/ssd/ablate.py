"""What holds the sm90 SSD kernel back: variants of ``csrc/ssd_sm90.cu``,
each with one part cut or cheapened, timed on the card.

    PYTHONPATH=src python -m repro_torch.kernels.ssd.ablate

Each variant is the kernel's source with a text substitution, built with
``_build.NVCC_FLAGS`` into ``build/repro_torch/ablate/`` and timed at the
served shape (jamba's scan: B 4, S 2048, nh 128, hd 64, g 1, n 16, chunk
256, bf16 inputs from a seed): CUDA events around 20 calls enqueued behind
a spin kernel after a warm-up, in turns (the variants in order, then in
reverse), averaged.  A variant computes another function; only the kernel
as built is held to the plain version (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  A variant's time less the kernel's is what
the cut part costs on the card.  Beside each time: the share of y's bf16
outputs that round differently from the plain version's float32 y on the
same values (the fp32 route, ``ssd.cu``, on a line of its own for
comparison): what a cheaper product costs in numerics.  Needs a card;
prints the card's name and power limit and one JSON line.
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
from repro_torch.kernels.ssd import kernel, ssd_chunked

SOURCE = _build.KERNELS_DIR / "ssd" / "csrc" / "ssd_sm90.cu"
OUT_DIR = _build.BUILD_DIR / "ablate"
SHAPE = (4, 2048, 128, 64, 1, 16, 256)   # B, S, nh, hd, g, n, chunk: jamba
# the products of a P term, one into each of the two accumulators
P_LO = [("      wgmma_rs_n64(y, p[2][kk], b);\n", ""),
        ("      wgmma_rs_n64(y2, p[2][kk], b);\n", "")]
P_MID = [("      wgmma_rs_n64(y2, p[1][kk], b);\n", ""),
         ("      wgmma_rs_n64(y, p[1][kk], b);\n", "")]
EXP = "float decay_exp(float x) { return expf(x); }"
INTER = "      issue_inter<NP>(acc, c_rows, tile, L.p_bytes);\n"
STATE = "    for (int jb = 0; jb < n_blocks; ++jb) {\n"
CHUNK = "    const int len = min(Q, S - c0);\n    const int s = c % stages;\n"
# name -> (what it changes, substitutions: (old, new) replaces old, found
# once)
VARIANTS: Dict[str, Tuple[str, List[tuple]]] = {
    "kernel": ("the kernel as built", []),
    "no_p_lo": ("P_lo x left out: P in two bf16 terms", P_LO),
    "p_one_term": ("P_mid x and P_lo x left out: P in one bf16 term",
                   P_LO + P_MID),
    "fast_exp": ("P's exp by __expf (ex2.approx) instead of expf",
                 [(EXP, "float decay_exp(float x) { return __expf(x); }")]),
    "no_inter": ("the inter term (C . state) cut",
                 [(INTER, "      for (int e = 0; e < 32; ++e) acc[e] = 0.f;\n")]),
    "no_state": ("the state update (W, x^T W) cut",
                 [(STATE, "    for (int jb = 0; jb < 0; ++jb) {\n")]),
    "loads_only": ("the threads only load each chunk and wait for it",
                   [(CHUNK, CHUNK + "    if (tid == 0 && c + stages - 1 < "
                     "n_chunks) load_chunk(c + stages - 1);\n"
                     "    mbar_wait(bar_full + 8 * s, (c / stages) & 1);\n"
                     "    named_sync(BAR_WG, THREADS);\n    continue;\n")]),
}


def variant_source(name: str) -> str:
    """The kernel's source with ``name``'s substitutions."""
    src = SOURCE.read_text()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found "
                             f"{src.count(old)} times in {SOURCE.name}")
        src = src.replace(old, new)
    return src


def build(names) -> Dict[str, ctypes.CDLL]:
    """Build the variants in parallel (one nvcc each); raise on a failure."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT_DIR / f"ssd_sm90_{name}.cu"
        src.write_text(variant_source(name))
        lib = OUT_DIR / f"libssd_sm90_{name}.so"
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
    b, s, nh, hd, g, n, chunk = SHAPE
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((b, s, nh, hd), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=gen))
    a = -torch.exp(torch.randn((nh,), generator=gen) * 0.5)
    bm = torch.randn((b, s, g, n), generator=gen)
    cm = torch.randn((b, s, g, n), generator=gen)
    x, dt, bm, cm = (t.to("cuda", torch.bfloat16) for t in (x, dt, bm, cm))
    a = a.to("cuda")
    y = torch.empty_like(x)
    final = torch.empty((b, nh, hd, n), device="cuda")
    want = ssd_chunked(x.float(), dt.float(), a, bm.float(), cm.float(),
                       chunk=chunk, impl="ref")[0].to(torch.bfloat16)

    def flips(lib, route: str) -> float:
        """The share of y's bf16 outputs unlike the plain version's."""
        kernel.launch(lib, route, x, dt, a, bm, cm, y, final, chunk=chunk)
        return float((y != want).float().mean())

    times: Dict[str, List[float]] = {name: [] for name in libs}
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            times[name].append(events_ms(
                lambda: kernel.launch(libs[name], "sm90", x, dt, a, bm, cm, y,
                                      final, chunk=chunk)))
    rows = []
    base = statistics.mean(times["kernel"])
    print(f"[ablate] B={b} S={s} nh={nh} hd={hd} g={g} n={n} chunk={chunk} "
          f"bf16; {smi}")
    for name, (what, _) in VARIANTS.items():
        ms = statistics.mean(times[name])
        share = flips(libs[name], "sm90")
        rows.append({"variant": name, "what": what, "ms": ms, "flips": share})
        print(f"[ablate] {name:10s} {ms:.4f} ms ({ms - base:+.4f}), y unlike "
              f"the plain version's in {share:.4%}: {what}")
    fp32_share = flips(kernel._lib("fp32"), "fp32")
    print(f"[ablate] the fp32 route (ssd.cu) on the same values: y unlike the "
          f"plain version's in {fp32_share:.4%}")
    print(json.dumps({"device": smi, "shape": SHAPE, "variants": rows,
                      "fp32_route_flips": fp32_share}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
