"""The flash-attention op: (B,S,H,D) GQA layout -> the hand-written kernel
or the plain version (port of ``repro/kernels/flash_attn/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_backward, resolve_backend
from repro_torch.kernels.flash_attn import kernel as _k
from repro_torch.kernels.flash_attn import ref as _ref

Tensor = torch.Tensor


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: int = 1 << 30, impl: str = "auto") -> Tensor:
    """q (B,S,H,D); k/v (B,T,Kv,D) with H % Kv == 0 -> (B,S,H,D) in q's
    dtype.  ``impl``: ``auto | ref | cuda`` (``repro_torch.kernels``).

    The ref path repeats the kv heads, as the JAX wrapper does; the kernel
    reads kv head ``h // (H // Kv)`` in place and takes q, k, v of one
    dtype, float32 or bfloat16.  The kernel path raises when grad mode
    is on and an input requires grad: no kernel has a backward."""
    h, kv = q.shape[2], k.shape[2]
    if resolve_backend(impl, q.device) == "ref":
        if kv != h:
            k = torch.repeat_interleave(k, h // kv, dim=2)
            v = torch.repeat_interleave(v, h // kv, dim=2)
        return _ref.ref_attention(q, k, v, causal=causal, window=window)
    refuse_backward("flash_attention", q, k, v)
    return _k.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
