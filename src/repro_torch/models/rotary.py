"""Rotary position embeddings, rotate-half (port of
``repro/models/rotary.py``)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> Tensor:
    """Inverse frequencies, (head_dim // 2,) f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10_000.0
               ) -> Tensor:
    """x (..., S, H, Dh), positions (..., S) int -> same shape/dtype as x;
    computed in f32."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                       # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * inv          # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
