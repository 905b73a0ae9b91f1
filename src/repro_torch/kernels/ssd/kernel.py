"""The SSD chunked scan on Hopper: the CUDA wrapper of two hand-written
kernels that replace ``ssd_pallas`` of ``repro/kernels/ssd/kernel.py``.

Two routes, chosen by shape (``select_route``), never as a fallback:

- ``"sm90"`` — ``csrc/ssd_sm90.cu``: bfloat16 x, dt, B, C with head dim
  64, n a multiple of 16 up to 128 and a chunk that is a multiple of 64 up
  to 256 (jamba's and mamba2-780m's scans), TMA-fed ``wgmma`` on the bf16
  tensor cores, every float32 factor split into bf16 terms (P into three,
  the state and B o w into two) so that the products keep float32's
  function;
- ``"fp32"`` — ``csrc/ssd.cu``: float32 inputs, and bfloat16 at any other
  shape (hd <= 64, n <= 128, any chunk), on the fp32 CUDA cores.

``ssd_cuda`` takes the model layout as it is — x (B,S,nh,hd), dt
(B,S,nh), B/C (B,S,g,n) — and both kernels read group ``h // (nh // g)``
for head ``h``: no head repeat and none of the JAX wrapper's
(B*nh, S, k) transposes.  CUDA tensors only: there is no CPU form (the
plain version is ``ref.ref_ssd``).  It calls the op
``torch.ops.repro_torch.ssd`` (``kernels/library.py``), whose CUDA body
is ``_body``; on meta tensors the op gives the outputs' shapes and
dtypes.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, library

Tensor = torch.Tensor

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 4096
ROUTES = ("sm90", "fp32")
LIBS = {"sm90": "ssd_sm90", "fp32": "ssd"}        # csrc/<name>.cu
SM90_HEAD_DIM = 64
SM90_CHUNKS = (64, 128, 192, 256)
SM90_ALIGN = 16                 # bytes: TMA's base-address alignment


def select_route(dtype: torch.dtype, head_dim: int, state: int,
                 chunk: int) -> str:
    """The kernel that scans x, dt, B, C of ``dtype`` with ``head_dim``,
    ``state`` (n) and ``chunk``: ``"sm90"`` for bfloat16 with head dim 64,
    n a multiple of 16 in 16..128 and a chunk in ``SM90_CHUNKS``, else
    ``"fp32"``."""
    if (dtype == torch.bfloat16 and head_dim == SM90_HEAD_DIM
            and state % 16 == 0 and 16 <= state <= MAX_STATE
            and chunk in SM90_CHUNKS):
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
        # 7 pointers, (dtype for fp32,) B, S, nh, hd, g, n, chunk, stream
        fn.argtypes = [vp] * 7 + [i] * (8 if route == "fp32" else 7) + [vp]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
    return lib


def _check(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
           chunk: int, on_card: bool = True) -> None:
    fn = "ssd_cuda"
    named = (("x", x), ("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat))
    for name, t in named:
        if on_card and not t.is_cuda:
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


def _check_sm90(x: Tensor, bmat: Tensor, cmat: Tensor) -> None:
    """TMA reads whole 16-byte units: x, B and C (row strides 128 and 2n
    bytes, checked contiguous above) must start 16-byte aligned."""
    for name, t in (("x", x), ("bmat", bmat), ("cmat", cmat)):
        if t.data_ptr() % SM90_ALIGN:
            raise ValueError(f"ssd_cuda: {name} is not {SM90_ALIGN}-byte "
                             "aligned (the sm90 route reads it by TMA)")


def ssd_cuda(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
             *, chunk: int = 128) -> Tuple[Tensor, Tensor]:
    """The chunked scan from a zero state by the hand-written kernel of
    ``select_route``: bfloat16 with hd 64, n in 16..128 (a multiple of 16)
    and chunk 64..256 (a multiple of 64) on the ``sm90`` tensor-core kernel
    (16-byte aligned x, B, C), anything else on the ``fp32`` one.

    x (B,S,nh,hd), dt (B,S,nh), bmat/cmat (B,S,g,n): contiguous CUDA
    tensors of one dtype, float32 or bfloat16; a (nh,) float32.  hd <= 64,
    n <= 128; the last chunk may be partial.  Returns (y (B,S,nh,hd) in
    x's dtype, final (B,nh,hd,n) float32).  Launches on the current stream
    without synchronising and raises if the launch is refused.
    ``.launches`` counts every launch, ``.launches_by_route`` each
    route's.  Through the op ``repro_torch::ssd``."""
    y, final = OP(x, dt, a, bmat, cmat, int(chunk))
    return y, final


ssd_cuda.launches = 0
ssd_cuda.launches_by_route = dict.fromkeys(ROUTES, 0)


def _body(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
          chunk: int) -> Tuple[Tensor, Tensor]:
    """The op's CUDA body: checks, route, launch, counters."""
    _check(x, dt, a, bmat, cmat, chunk)
    b, s, nh, hd = x.shape
    n = bmat.shape[3]
    route = select_route(x.dtype, hd, n, chunk)
    if route == "sm90":
        _check_sm90(x, bmat, cmat)
    y = torch.empty_like(x)
    final = torch.zeros((b, nh, hd, n), dtype=torch.float32, device=x.device)
    if b * nh * s == 0:
        return y, final
    launch(_lib(route), route, x, dt, a, bmat, cmat, y, final, chunk=chunk)
    ssd_cuda.launches += 1
    ssd_cuda.launches_by_route[route] += 1
    return y, final


def _meta(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
          chunk: int) -> Tuple[Tensor, Tensor]:
    _check(x, dt, a, bmat, cmat, chunk, on_card=False)
    b, _, nh, hd = x.shape
    return torch.empty_like(x), x.new_empty((b, nh, hd, bmat.shape[3]),
                                            dtype=torch.float32)


def _flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk,
           out_shape=None, **kwargs) -> int:
    """The plain version's count: per step the state's read by C, 2 B nh
    hd n (its update is an outer product, no matmul to
    ``FlopCounterMode``)."""
    b, s, nh, hd = x_shape
    return 2 * b * s * nh * hd * b_shape[3]


def _route(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
           chunk: int) -> str:
    return select_route(x.dtype, x.shape[3], bmat.shape[3], chunk)


OP = library.define(
    "ssd(Tensor x, Tensor dt, Tensor a, Tensor bmat, Tensor cmat, "
    "int chunk) -> (Tensor, Tensor)", _body, _meta, _flops, _route)


def launch(lib: ctypes.CDLL, route: str, x: Tensor, dt: Tensor, a: Tensor,
           bmat: Tensor, cmat: Tensor, y: Tensor, final: Tensor, *,
           chunk: int) -> None:
    """Launch ``route``'s kernel from ``lib`` (see ``typed``) on checked
    tensors, writing ``y`` and ``final``; raise if the launch is refused.
    Counts nothing: ``ssd_cuda`` does."""
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    name = LIBS[route]
    dims = (b, s, nh, hd, g, n, int(chunk))
    if route == "fp32":
        dims = (DTYPE_CODES[x.dtype], *dims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, f"{name}_fwd")(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), y.data_ptr(), final.data_ptr(), *dims, stream)
    if err != 0:
        raise RuntimeError(f"ssd_cuda ({route}): launch failed: "
                           + getattr(lib, f"{name}_error_string")(err).decode())
