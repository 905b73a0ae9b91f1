"""The SSD op: model layout -> the hand-written kernel or the plain
version (port of ``repro/kernels/ssd/ops.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import refuse_backward, resolve_backend
from repro_torch.kernels.ssd import kernel as _k
from repro_torch.kernels.ssd import ref as _ref

Tensor = torch.Tensor


def ssd_chunked(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor,
                cmat: Tensor, *, chunk: int = 128, impl: str = "auto"
                ) -> Tuple[Tensor, Tensor]:
    """Model layout: x (B,S,nh,hd); dt (B,S,nh); a (nh,); bmat/cmat
    (B,S,g,n).  Returns (y (B,S,nh,hd), final (B,nh,hd,n)), from a zero
    state.  ``impl``: ``auto | ref | cuda`` (``repro_torch.kernels``).

    As in JAX, the ref path returns the recurrence's float32 y and the
    kernel path y in x's dtype.  The kernel takes x, dt, bmat, cmat of one
    dtype, float32 or bfloat16, and a float32 a.  The kernel path raises
    when grad mode is on and an input requires grad: no kernel has a
    backward."""
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if resolve_backend(impl, x.device) == "ref":
        hpg = nh // g
        return _ref.ref_ssd(
            x, dt, a, torch.repeat_interleave(bmat, hpg, dim=2),
            torch.repeat_interleave(cmat, hpg, dim=2),
            torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device))
    refuse_backward("ssd_chunked", x, dt, a, bmat, cmat)
    return _k.ssd_cuda(x.contiguous(), dt.contiguous(), a.contiguous(),
                       bmat.contiguous(), cmat.contiguous(), chunk=chunk)
