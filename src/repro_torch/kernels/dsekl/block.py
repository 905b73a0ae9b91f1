"""The serving kernel f = K(x, z) @ a: its Hopper kernel and its plain
version (port of ``repro/kernels/dsekl/block.py``'s tile evaluators and
``kernel_matvec_pallas``).

* ``TILE_FNS`` / ``make_tile_fn`` — plain-torch (bi, bj) tile evaluators for
  the seven registry kernels, step for step as the Pallas tiles compute
  them (``|x|^2 + |z|^2 - 2 x.z`` clamped at 0 from the row norms; a
  per-feature loop for the Laplacian's L1 distance).
* ``kernel_matvec_plain`` — the plain version: the tile evaluator over
  ``block``-row tiles of z, contracted with a.  The CPU tests use it, and
  the chip smoke holds the kernel against it on the card.
* ``kernel_matvec_cuda`` — the wrapper of the hand-written kernel
  ``csrc/dsekl_matvec.cu``.  It takes CUDA tensors only and launches the
  kernel or raises; ``kernel_matvec_cuda.launches`` counts its launches.

The TPU module's ``mxu_dtype`` (bf16 cross-term) is not carried over: the
serving path never asks for it.  Nor are ``choose_blocks`` /
``choose_predict_blocks``: their VMEM budget means nothing here, and the
kernel picks its own tiles.
"""
from __future__ import annotations

import ctypes
import functools
import inspect
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.kernels_fn import SQRT3, SQRT5, integer_pow
from repro_torch.kernels import _build

Tensor = torch.Tensor

# Support rows per plain-version tile: bounds its (I, block) intermediate.
PLAIN_BLOCK = 8192


# ---------------------------------------------------------------------------
# Per-kernel tile evaluators: f32 (bi, D) / (bj, D) -> f32 (bi, bj).
# ---------------------------------------------------------------------------

def _cross_term(xi: Tensor, xj: Tensor) -> Tensor:
    return xi @ xj.T


def _sq_dists_tile(xi: Tensor, xj: Tensor) -> Tensor:
    xy = _cross_term(xi, xj)
    xx = torch.sum(xi * xi, dim=1, keepdim=True)        # (bi, 1)
    zz = torch.sum(xj * xj, dim=1, keepdim=True).T      # (1, bj)
    return torch.clamp_min(xx + zz - 2.0 * xy, 0.0)


def _l1_dists_tile(xi: Tensor, xj: Tensor) -> Tensor:
    """sum_d |xi_d - xj_d| as a loop over features: O(bi * bj) memory,
    no (bi, bj, D) broadcast (as the Pallas tile's fori_loop)."""
    acc = torch.zeros((xi.shape[0], xj.shape[0]), dtype=torch.float32,
                      device=xi.device)
    for k in range(xi.shape[1]):
        acc = acc + torch.abs(xi[:, k:k + 1] - xj[:, k:k + 1].T)
    return acc


def _tile_rbf(xi, xj, *, gamma: float = 1.0):
    return torch.exp(-gamma * _sq_dists_tile(xi, xj))


def _tile_laplacian(xi, xj, *, gamma: float = 1.0):
    return torch.exp(-gamma * _l1_dists_tile(xi, xj))


def _tile_linear(xi, xj):
    return _cross_term(xi, xj)


def _tile_polynomial(xi, xj, *, gamma: float = 1.0, coef0: float = 1.0,
                     degree: int = 3):
    return integer_pow(gamma * _cross_term(xi, xj) + coef0, degree)


def _tile_sigmoid(xi, xj, *, gamma: float = 1.0, coef0: float = 0.0):
    return torch.tanh(gamma * _cross_term(xi, xj) + coef0)


def _tile_matern32(xi, xj, *, length_scale: float = 1.0):
    d = torch.sqrt(_sq_dists_tile(xi, xj) + 1e-12) / length_scale
    z = SQRT3 * d
    return (1.0 + z) * torch.exp(-z)


def _tile_matern52(xi, xj, *, length_scale: float = 1.0):
    d = torch.sqrt(_sq_dists_tile(xi, xj) + 1e-12) / length_scale
    z = SQRT5 * d
    return (1.0 + z + z * z / 3.0) * torch.exp(-z)


TILE_FNS: Dict[str, Callable[..., Tensor]] = {
    "rbf": _tile_rbf,
    "laplacian": _tile_laplacian,
    "linear": _tile_linear,
    "polynomial": _tile_polynomial,
    "sigmoid": _tile_sigmoid,
    "matern32": _tile_matern32,
    "matern52": _tile_matern52,
}

# Template index of each kernel in csrc/dsekl_matvec.cu (enum Kind).
KINDS: Dict[str, int] = {name: i for i, name in enumerate(TILE_FNS)}


def tile_params(kernel_name: str, params: Optional[Dict[str, Any]]
                ) -> Dict[str, Any]:
    """The tile function's hyperparameters with its defaults filled in;
    raises for an unknown kernel or parameter name."""
    if kernel_name not in TILE_FNS:
        raise ValueError(f"no tile for kernel {kernel_name!r}; "
                         f"available: {sorted(TILE_FNS)}")
    sig = inspect.signature(TILE_FNS[kernel_name])
    full = {k: p.default for k, p in sig.parameters.items()
            if p.kind is inspect.Parameter.KEYWORD_ONLY}
    unknown = set(params or {}) - set(full)
    if unknown:
        raise TypeError(f"kernel {kernel_name!r} takes no parameter(s) "
                        f"{sorted(unknown)}; it takes {sorted(full)}")
    full.update(params or {})
    return full


def make_tile_fn(kernel_name: str, params: Optional[Dict[str, Any]]
                 ) -> Callable[[Tensor, Tensor], Tensor]:
    """Bind a registry kernel to a (xi_f32, xj_f32) -> (bi, bj) tile fn."""
    return functools.partial(TILE_FNS[kernel_name],
                             **tile_params(kernel_name, params))


def _pad_rows(x: Tensor, block: int) -> Tensor:
    """Zero-pad axis 0 up to the next multiple of ``block``."""
    pad = (-x.shape[0]) % block
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return x


def _f32_col(x: Tensor, block: int) -> Tensor:
    """(n,) vector -> zero-padded f32 (n_pad, 1) column."""
    return _pad_rows(x.to(torch.float32)[:, None], block)


def full_fp32_matmul() -> None:
    """Plain versions on the card run their products in full float32
    (PyTorch's default, set explicitly): TF32 keeps ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# f = K(x, z) @ a: plain version and CUDA kernel.
# ---------------------------------------------------------------------------

def kernel_matvec_plain(x: Tensor, z: Tensor, a: Tensor, *,
                        kernel_name: str = "rbf",
                        params: Optional[Dict[str, Any]] = None,
                        block: int = PLAIN_BLOCK) -> Tensor:
    """f = K(x, z) @ a with the tile evaluator over ``block``-row tiles of
    z.  x (I, D), z (J, D), a (J,) -> (I,) float32."""
    if x.is_cuda:
        full_fp32_matmul()
    tile_fn = make_tile_fn(kernel_name, params)
    x = x.to(torch.float32)
    f = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for start in range(0, z.shape[0], block):
        zt = z[start:start + block].to(torch.float32)
        at = a[start:start + block].to(torch.float32)
        f = f + tile_fn(x, zt) @ at
    return f


def _lib() -> ctypes.CDLL:
    lib = _build.load("dsekl_matvec")
    fn = lib.dsekl_kernel_matvec
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, f, f, f, i, i, f,
                       i, i, vp]
        fn.restype = ctypes.c_int
        lib.dsekl_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.dsekl_blocks_per_sm.restype = ctypes.c_int
        lib.dsekl_error_string.argtypes = [ctypes.c_int]
        lib.dsekl_error_string.restype = ctypes.c_char_p
    return lib


def split_support(n_rows: int, n_cols: int, resident_blocks: int,
                  block: int = 64) -> Tuple[int, int]:
    """(n_split, tiles_per_split): cut the ceil(n_cols / block) support
    tiles into contiguous ranges so that the (row tiles x n_split) grid
    fills at most one wave of ``resident_blocks`` (a 1024-query batch alone
    gives only 16 row tiles for 132 SMs; a partial second wave would leave
    most SMs idle while it runs)."""
    row_tiles = -(-n_rows // block)
    col_tiles = -(-n_cols // block)
    if col_tiles == 0:
        return 1, 0
    want = max(1, resident_blocks // row_tiles)
    per = -(-col_tiles // min(want, col_tiles))
    return -(-col_tiles // per), per


@functools.lru_cache(maxsize=None)
def _resident_blocks(kind: int, device_index: int) -> int:
    """Tile-kernel blocks resident on the whole card at once."""
    n_sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    with torch.cuda.device(device_index):
        per_sm = _lib().dsekl_blocks_per_sm(kind)
    if per_sm <= 0:
        raise RuntimeError(f"dsekl_blocks_per_sm({kind}) failed: {per_sm}")
    return per_sm * n_sms


def _check_cuda_args(x: Tensor, z: Tensor, a: Tensor) -> None:
    for name, t in (("x", x), ("z", z), ("a", a)):
        if not t.is_cuda:
            raise ValueError(f"kernel_matvec_cuda: {name} is on {t.device}; "
                             "the CUDA kernel takes CUDA tensors only")
        if t.device != x.device:
            raise ValueError("kernel_matvec_cuda: x, z, a on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"kernel_matvec_cuda: {name} is {t.dtype}, "
                            "expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"kernel_matvec_cuda: {name} is not contiguous")
    if x.dim() != 2 or z.dim() != 2 or a.dim() != 1:
        raise ValueError("kernel_matvec_cuda: expected x (I, D), z (J, D), "
                         f"a (J,); got {tuple(x.shape)}, {tuple(z.shape)}, "
                         f"{tuple(a.shape)}")
    if x.shape[1] != z.shape[1] or a.shape[0] != z.shape[0]:
        raise ValueError("kernel_matvec_cuda: shape mismatch x "
                         f"{tuple(x.shape)}, z {tuple(z.shape)}, a "
                         f"{tuple(a.shape)}")
    if x.shape[1] == 0:
        raise ValueError("kernel_matvec_cuda: D must be positive")
    if max(x.numel(), z.numel()) >= 2 ** 31:
        raise ValueError("kernel_matvec_cuda: more than 2**31 elements")


def kernel_matvec_cuda(x: Tensor, z: Tensor, a: Tensor, *,
                       kernel_name: str = "rbf",
                       params: Optional[Dict[str, Any]] = None) -> Tensor:
    """f = K(x, z) @ a by the hand-written Hopper kernel.

    x (I, D), z (J, D), a (J,): contiguous float32 CUDA tensors on one
    device.  Launches on the current stream without synchronising and
    raises if the launch is refused.  There is no CPU form."""
    kind = KINDS.get(kernel_name)
    if kind is None:
        raise ValueError(f"no CUDA kernel for {kernel_name!r}; "
                         f"available: {sorted(KINDS)}")
    p = tile_params(kernel_name, params)
    _check_cuda_args(x, z, a)
    n_i, d = x.shape
    n_j = z.shape[0]
    out = torch.empty((n_i,), dtype=torch.float32, device=x.device)
    if n_i == 0:
        return out
    n_split, per = split_support(
        n_i, n_j, _resident_blocks(kind, x.device.index
                                   if x.device.index is not None
                                   else torch.cuda.current_device()))
    scratch = torch.empty((n_split * n_i + n_i + n_j,), dtype=torch.float32,
                          device=x.device)
    degree = float(p.get("degree", 0))
    int_degree = degree.is_integer()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dsekl_kernel_matvec(
            x.data_ptr(), z.data_ptr(), a.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), n_i, n_j, d, kind,
            float(p.get("gamma", 1.0)), float(p.get("coef0", 0.0)), degree,
            int(int_degree), int(degree) if int_degree else 0,
            float(p.get("length_scale", 1.0)), n_split, per, stream)
    if err != 0:
        raise RuntimeError("dsekl_kernel_matvec launch failed: "
                           + lib.dsekl_error_string(err).decode())
    kernel_matvec_cuda.launches += 1
    return out


kernel_matvec_cuda.launches = 0
