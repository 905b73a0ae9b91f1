"""Plain-torch oracle for the flash-attention kernel (port of
``repro/kernels/flash_attn/ref.py``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import full_fp32_matmul

Tensor = torch.Tensor

NEG_INF = -1e30


def ref_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: int = 1 << 30) -> Tensor:
    """q (B,S,H,D), k/v (B,T,H,D) -> (B,S,H,D).  Same-head attention
    (GQA grouping is handled by the ops wrapper via head repetition).

    Scores are float32 with masked entries at -1e30, as in the JAX oracle,
    so a row with no valid key gets the mean of v over all T keys."""
    s, t, d = q.shape[1], k.shape[1], q.shape[-1]
    with full_fp32_matmul():
        scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float())
    scores = scores * (1.0 / math.sqrt(d))
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    valid = (qpos - kpos) < window
    if causal:
        valid &= kpos <= qpos
    scores = torch.where(valid[None, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    with full_fp32_matmul():
        out = torch.einsum("bhst,bthd->bshd", p, v.float())
    return out.to(q.dtype)
