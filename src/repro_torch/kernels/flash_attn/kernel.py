"""The flash-attention forward on Hopper: the CUDA wrapper of
``csrc/flash_attn.cu`` (replaces ``flash_attention_pallas`` of
``repro/kernels/flash_attn/kernel.py``).

``flash_attention_cuda`` takes the model's GQA layout as it is — q
(B, S, H, D), k/v (B, T, Kv, D) — and the kernel reads kv head
``h // (H // Kv)`` for query head ``h``, so neither the heads nor the
(B*H, S, D) transposes of the JAX wrapper are materialized.  CUDA tensors
only: there is no CPU form (the plain version is ``ref.ref_attention``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn")
    fn = lib.flash_attn_fwd
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                       ctypes.c_longlong, ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [i]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    fn = "flash_attention_cuda"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}; "
                             "the CUDA kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"{fn}: arguments on different devices")
        if t.dtype not in DTYPE_CODES or t.dtype != q.dtype:
            raise TypeError(f"{fn}: q, k, v must share one dtype of "
                            f"{sorted(map(str, DTYPE_CODES))}; got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
        if t.dim() != 4:
            raise ValueError(f"{fn}: {name} must be 4-D; got {tuple(t.shape)}")
    b, s, h, d = q.shape
    t_, kv = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or kv == 0 or h % kv):
        raise ValueError(f"{fn}: expected q (B,S,H,D), k/v (B,T,Kv,D) with "
                         f"H % Kv == 0; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if -(-s // 64) >= 65536 or b * h >= 2 ** 31 or max(
            q.numel(), k.numel()) >= 2 ** 62:
        raise ValueError(f"{fn}: shape {tuple(q.shape)} is too large")


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int = 1 << 30
                         ) -> Tensor:
    """q (B,S,H,D); k/v (B,T,Kv,D) with H % Kv == 0 -> (B,S,H,D) in q's
    dtype, by the hand-written kernel.  q, k, v: contiguous CUDA tensors
    of one dtype, float32 or bfloat16; D <= 128.  Launches on the current
    stream without synchronising and raises if the launch is refused."""
    _check(q, k, v)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b * h * s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention_cuda: no keys (T = 0)")
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, s, t, h, kv, d, int(bool(causal)),
            int(window), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError("flash_attention_cuda: launch failed: "
                           + lib.flash_attn_error_string(err).decode())
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
