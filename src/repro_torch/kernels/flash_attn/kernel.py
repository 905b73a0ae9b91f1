"""The flash-attention forward on Hopper: the CUDA wrapper of two
hand-written kernels that replace ``flash_attention_pallas`` of
``repro/kernels/flash_attn/kernel.py``.

Two routes, chosen by shape (``select_route``), never as a fallback:

- ``"sm90"`` — ``csrc/flash_attn_sm90.cu``: bfloat16 q, k, v with head dim
  64 or 128 (every config's attention), TMA-fed ``wgmma`` on the bf16
  tensor cores, P split into two bf16 terms so that P @ V keeps float32's
  function;
- ``"fp32"`` — ``csrc/flash_attn.cu``: float32 inputs, and bfloat16 with
  any other head dim up to 128, on the fp32 CUDA cores.

``flash_attention_cuda`` takes the model's GQA layout as it is — q
(B, S, H, D), k/v (B, T, Kv, D) — and both kernels read kv head
``h // (H // Kv)`` for query head ``h``, so neither the heads nor the
(B*H, S, D) transposes of the JAX wrapper are materialized.  CUDA tensors
only: there is no CPU form (the plain version is ``ref.ref_attention``).
It calls the op ``torch.ops.repro_torch.flash_attention``
(``kernels/library.py``), whose CUDA body is ``_body``; on meta tensors
the op gives the output's shape and dtype.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, library

Tensor = torch.Tensor

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
ROUTES = ("sm90", "fp32")
LIBS = {"sm90": "flash_attn_sm90", "fp32": "flash_attn"}   # csrc/<name>.cu
SM90_HEAD_DIMS = (64, 128)
SM90_ALIGN = 16                 # bytes: TMA's base-address alignment


def select_route(dtype: torch.dtype, head_dim: int, n_heads: int,
                 n_kv_heads: int) -> str:
    """The kernel that serves q, k, v of ``dtype`` with ``head_dim``,
    ``n_heads`` query and ``n_kv_heads`` kv heads: ``"sm90"`` for bfloat16
    with head dim 64 or 128, else ``"fp32"``.  The head counts choose
    nothing (both kernels read kv head ``h // (H // Kv)``); they must
    divide."""
    if n_kv_heads < 1 or n_heads < 1 or n_heads % n_kv_heads:
        raise ValueError(f"select_route: {n_heads} query heads do not split "
                         f"over {n_kv_heads} kv heads")
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return "sm90"
    return "fp32"


def _lib(route: str) -> ctypes.CDLL:
    """The loaded library of ``route`` with its C functions typed."""
    return typed(_build.load(LIBS[route]), route)


def typed(lib: ctypes.CDLL, route: str) -> ctypes.CDLL:
    """``lib``, a library built from ``route``'s source, with its C
    functions' argument types set."""
    name = LIBS[route]
    fn = getattr(lib, f"{name}_fwd")
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        # (dtype for fp32,) B, S, T, H, Kv, D, causal; window, scale, stream
        ints = [i] * (8 if route == "fp32" else 7)
        fn.argtypes = [vp, vp, vp, vp, *ints, ctypes.c_longlong,
                       ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor, on_card: bool = True) -> None:
    fn = "flash_attention_cuda"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if on_card and not t.is_cuda:
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


def _check_sm90(q: Tensor, k: Tensor, v: Tensor) -> None:
    """TMA reads and writes whole 16-byte units: every row stride (a
    multiple of D, checked contiguous above) and base address must be
    16-byte aligned.  The kernel's positions are 32-bit: S + T < 2**30."""
    if q.shape[1] + k.shape[1] >= 2 ** 30:
        raise ValueError(f"flash_attention_cuda: S + T = "
                         f"{q.shape[1] + k.shape[1]} is too large")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % SM90_ALIGN:
            raise ValueError(f"flash_attention_cuda: {name} is not "
                             f"{SM90_ALIGN}-byte aligned (the sm90 route "
                             "reads it by TMA)")


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *,
                         causal: bool = True, window: int = 1 << 30
                         ) -> Tensor:
    """q (B,S,H,D); k/v (B,T,Kv,D) with H % Kv == 0 -> (B,S,H,D) in q's
    dtype, by the hand-written kernel of ``select_route``: bfloat16 with
    D in {64, 128} on the ``sm90`` tensor-core kernel (16-byte aligned
    tensors), anything else on the ``fp32`` one.  q, k, v: contiguous CUDA
    tensors of one dtype, float32 or bfloat16; D <= 128.  Launches on the
    current stream without synchronising and raises if the launch is
    refused.  ``.launches`` counts every launch, ``.launches_by_route``
    each route's.  Through the op ``repro_torch::flash_attention``."""
    return OP(q, k, v, bool(causal), int(window))


flash_attention_cuda.launches = 0
flash_attention_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


def _body(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int
          ) -> Tensor:
    """The op's CUDA body: checks, route, launch, counters."""
    _check(q, k, v)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    route = select_route(q.dtype, d, h, kv)
    if route == "sm90":
        _check_sm90(q, k, v)
    out = torch.empty_like(q)
    if b * h * s == 0:
        return out
    if t == 0:
        raise ValueError("flash_attention_cuda: no keys (T = 0)")
    launch(_lib(route), route, q, k, v, out, causal=causal, window=window)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.launches_by_route[route] += 1
    return out


def _meta(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int
          ) -> Tensor:
    _check(q, k, v, on_card=False)
    return torch.empty_like(q)


def _flops(q_shape, k_shape, v_shape, causal, window, out_shape=None,
           **kwargs) -> int:
    """The plain version's count: two dense products, 2 B H S T D each
    (the masked scores are computed too)."""
    b, s, h, d = q_shape
    return 4 * b * h * s * k_shape[1] * d


def _route(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int
           ) -> str:
    return select_route(q.dtype, q.shape[3], q.shape[2], k.shape[2])


OP = library.define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window)"
    " -> Tensor", _body, _meta, _flops, _route)


def launch(lib: ctypes.CDLL, route: str, q: Tensor, k: Tensor, v: Tensor,
           out: Tensor, *, causal: bool, window: int) -> None:
    """Launch ``route``'s kernel from ``lib`` (see ``typed``) on checked
    tensors, writing ``out``; raise if the launch is refused.  Counts
    nothing: ``flash_attention_cuda`` does."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    name = LIBS[route]
    dims = (b, s, t, h, kv, d)
    if route == "fp32":
        dims = (DTYPE_CODES[q.dtype], *dims)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"{name}_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *dims,
            int(bool(causal)), int(window), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda ({route}): launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())
