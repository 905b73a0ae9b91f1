"""Plain-torch oracle for the SSD kernel: the naive sequential recurrence
(port of ``repro/kernels/ssd/ref.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import full_fp32_matmul

Tensor = torch.Tensor


def ref_ssd(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
            state0: Tensor) -> Tuple[Tensor, Tensor]:
    """x (B,S,nh,hd); dt (B,S,nh); a (nh,); bmat/cmat (B,S,nh,n) (heads
    already expanded); state0 (B,nh,hd,n).  Returns (y (B,S,nh,hd),
    final (B,nh,hd,n)), both float32.

    Every input is converted to float32 first, as the kernels (the TPU's
    and the port's) convert at load.  The JAX oracle forms x * dt and the
    B (x dt) update in the input dtype; for float32 inputs the two are the
    same function, for bfloat16 ones this is the function the kernels
    compute.  Products in full float32; the caller's TF32 setting is
    restored."""
    x, dt, a, bmat, cmat = (t.float() for t in (x, dt, a, bmat, cmat))
    state = state0.float()
    ys = []
    with full_fp32_matmul():
        for t in range(x.shape[1]):
            xt, dtt, bt, ct = x[:, t], dt[:, t], bmat[:, t], cmat[:, t]
            da = torch.exp(dtt * a[None])                    # (B,nh)
            upd = torch.einsum("bhn,bhp->bhpn", bt, xt * dtt[..., None])
            state = state * da[..., None, None] + upd
            ys.append(torch.einsum("bhpn,bhn->bhp", state, ct))
    y = (torch.stack(ys, dim=1) if ys else
         x.new_zeros(x.shape, dtype=torch.float32))
    return y, state
