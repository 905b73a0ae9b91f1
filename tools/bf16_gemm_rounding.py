"""How far a card's bf16 GEMMs sit from their float32 accumulator rounded
once, and how a product whose contraction is split four ways compares
when its partials are summed in float32 (``collectives.psum_product``)
or rounded to bf16 first.  Runs on a CUDA card:

    python tools/bf16_gemm_rounding.py

Shapes: jamba-v0.1-52b's layer-0 products at 4 x 2,048 tokens (the MLP's
w_down and w_gate, a (1, 4) rank's w_gate slice, mamba's w_out) and a
decode step's w_down.  For each result: the share of outputs that
differ from the exact product rounded once to bf16 (float64 reference),
the largest difference over |exact|_inf, and the share that differ from
the plain bf16 GEMM.  TF32 is off; the bf16 GEMM is run with
``allow_bf16_reduced_precision_reduction`` on and off.
"""
from __future__ import annotations

import torch

SHAPES = (("w_down K=14336", 8192, 14336, 4096),
          ("w_gate K=4096", 8192, 4096, 14336),
          ("w_gate/4 K=4096", 8192, 4096, 3584),
          ("w_out K=8192", 8192, 8192, 4096),
          ("decode w_down K=14336", 4, 14336, 4096))
SPLIT = 4


def case(name: str, m: int, k: int, n: int, gen: torch.Generator) -> None:
    x = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
    w = (torch.randn(k, n, device="cuda", generator=gen)
         / k ** 0.5).bfloat16()
    once = (x.double() @ w.double()).to(torch.bfloat16)
    out = {}
    matmul = torch.backends.cuda.matmul
    for red in (True, False):
        matmul.allow_bf16_reduced_precision_reduction = red
        out[f"bf16 gemm red={red}"] = x @ w
    matmul.allow_bf16_reduced_precision_reduction = True
    out["fp32 gemm"] = (x.float() @ w.float()).bfloat16()
    ks = k // SPLIT
    parts = [(x[:, i * ks:(i + 1) * ks], w[i * ks:(i + 1) * ks])
             for i in range(SPLIT)]
    out[f"fp32 partials x{SPLIT}"] = sum(
        a.float() @ b.float() for a, b in parts).bfloat16()
    out[f"bf16 partials x{SPLIT}"] = sum(a @ b for a, b in parts)
    gemm = out["bf16 gemm red=True"]
    for key, t in out.items():
        diff = (t.double() - once.double()).abs()
        print(f"{name} {key}: differs from round-once in "
              f"{float((t != once).float().mean()):.4%}, max rel "
              f"{float(diff.max() / once.double().abs().max()):.3e}; vs the "
              f"bf16 gemm {float((t != gemm).float().mean()):.4%}")


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.__version__, torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES:
        case(*shape, gen)


if __name__ == "__main__":
    main()
