"""The SSD chunked scan on Hopper: the CUDA wrapper of ``csrc/ssd.cu``
(replaces ``ssd_pallas`` of ``repro/kernels/ssd/kernel.py``).

``ssd_cuda`` takes the model layout as it is — x (B,S,nh,hd), dt
(B,S,nh), B/C (B,S,g,n) — and the kernel reads group ``h // (nh // g)``
for head ``h``: no head repeat and none of the JAX wrapper's
(B*nh, S, k) transposes.  CUDA tensors only: there is no CPU form (the
plain version is ``ref.ref_ssd``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 4096


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd")
    fn = lib.ssd_fwd
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [i] * 8 + [vp]
        fn.restype = ctypes.c_int
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
           chunk: int) -> None:
    fn = "ssd_cuda"
    named = (("x", x), ("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}; "
                             "the CUDA kernel takes CUDA tensors only")
        if t.device != x.device:
            raise ValueError(f"{fn}: arguments on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    if (x.dtype not in DTYPE_CODES or dt.dtype != x.dtype
            or bmat.dtype != x.dtype or cmat.dtype != x.dtype):
        raise TypeError(f"{fn}: x, dt, bmat, cmat must share one dtype of "
                        f"{sorted(map(str, DTYPE_CODES))}; got {x.dtype}, "
                        f"{dt.dtype}, {bmat.dtype}, {cmat.dtype}")
    if a.dtype != torch.float32:
        raise TypeError(f"{fn}: a is {a.dtype}, expected torch.float32")
    shapes = ", ".join(f"{n} {tuple(t.shape)}" for n, t in named)
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bmat.dim() != 4:
        raise ValueError(f"{fn}: expected x (B,S,nh,hd), dt (B,S,nh), a "
                         f"(nh,), bmat/cmat (B,S,g,n); got {shapes}")
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    if (tuple(dt.shape) != (b, s, nh) or tuple(a.shape) != (nh,)
            or bmat.shape[:2] != x.shape[:2] or cmat.shape != bmat.shape
            or g == 0 or nh % g):
        raise ValueError(f"{fn}: shape mismatch {shapes}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= n <= MAX_STATE):
        raise ValueError(f"{fn}: head dim {hd} / state {n} outside "
                         f"1..{MAX_HEAD_DIM} / 1..{MAX_STATE}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{fn}: chunk {chunk} outside 1..{MAX_CHUNK}")
    if b * nh >= 2 ** 31:
        raise ValueError(f"{fn}: B * nh = {b * nh} blocks is too many")


def ssd_cuda(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
             *, chunk: int = 128) -> Tuple[Tensor, Tensor]:
    """The chunked scan from a zero state by the hand-written kernel.

    x (B,S,nh,hd), dt (B,S,nh), bmat/cmat (B,S,g,n): contiguous CUDA
    tensors of one dtype, float32 or bfloat16; a (nh,) float32.  hd <= 64,
    n <= 128; the last chunk may be partial.  Returns (y (B,S,nh,hd) in
    x's dtype, final (B,nh,hd,n) float32).  Launches on the current stream
    without synchronising and raises if the launch is refused."""
    _check(x, dt, a, bmat, cmat, chunk)
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    y = torch.empty_like(x)
    final = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
    if b * nh * s == 0:
        return y, final
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_fwd(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), final.data_ptr(),
            DTYPE_CODES[x.dtype], b, s, nh, hd, g, n, int(chunk), stream)
    if err != 0:
        raise RuntimeError("ssd_cuda: launch failed: "
                           + lib.ssd_error_string(err).decode())
    ssd_cuda.launches += 1
    return y, final


ssd_cuda.launches = 0
