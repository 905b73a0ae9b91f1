"""Compressed cross-rank gradient reduction (port of
``repro/distributed/compression.py``).

``compressed_all_reduce`` is an int8 (or int4-range) quantized
``all_reduce``: a scalar MAX ``all_reduce`` agrees on a shared scale, the
values are rounded stochastically to integers, summed as int32 and
dequantized.  The payload's volume drops 4x (float32 to int8 range,
carried in int32).  The distributed DSEKL step applies it to the
dual-coefficient gradient's reduction over the data axis
(``core/distributed.py``, ``DSEKLConfig.compress_bits``).  Stochastic
rounding keeps the quantized gradient unbiased: E[q] = x / scale.

The uniforms are an argument of ``quantize_stochastic`` (the JAX function
takes a key): ``compressed_all_reduce`` draws them from the caller's
``torch.Generator``, on x's device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import collectives

Tensor = torch.Tensor


def quantize_stochastic(x: Tensor, scale: Tensor, u: Tensor,
                        max_q: int) -> Tensor:
    """Unbiased stochastic rounding of x / scale to int32 in [-max_q,
    max_q]: up where the uniform ``u`` (x's shape) is below the
    fractional part."""
    y = x.to(torch.float32) / scale
    lo = torch.floor(y)
    q = lo + (u < (y - lo)).to(torch.float32)
    return torch.clamp(q, -max_q, max_q).to(torch.int32)


def compressed_all_reduce(x: Tensor, group, generator: torch.Generator,
                          bits: int = 8) -> Tensor:
    """The sum of x over ``group`` with an int-quantized payload (JAX's
    ``compressed_psum``).  The scale is the group's max |x| (one scalar
    MAX reduction), so the int32 sum over N ranks cannot overflow for N <
    2^(31 - bits).  Returns a new float32 tensor; x is left as it is."""
    max_q = 2 ** (bits - 1) - 1
    gmax = torch.max(torch.abs(x)).to(torch.float32).reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    collectives.note("pmax:all_reduce", gmax)
    scale = torch.clamp_min(gmax[0], 1e-12) / max_q
    u = torch.rand(x.shape, generator=generator, device=x.device)
    q = quantize_stochastic(x, scale, u, max_q)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    collectives.note("psum:all_reduce", q)
    return q.to(torch.float32) * scale


def compression_error_bound(x_absmax: float, bits: int, n_devices: int
                            ) -> float:
    """Worst-case per-element dequantization error of the summed result."""
    max_q = 2 ** (bits - 1) - 1
    return n_devices * x_absmax / max_q
