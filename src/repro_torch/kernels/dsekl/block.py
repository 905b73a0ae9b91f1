"""The DSEKL kernel ops on Hopper and their plain versions (port of
``repro/kernels/dsekl/block.py``'s tile evaluators and its four Pallas
kernels).

* ``TILE_FNS`` / ``make_tile_fn`` — plain-torch (bi, bj) tile evaluators for
  the seven registry kernels, step for step as the Pallas tiles compute
  them (``|x|^2 + |z|^2 - 2 x.z`` clamped at 0 from the row norms; a
  per-feature loop for the Laplacian's L1 distance).
* Plain versions, each a tile evaluator over row blocks, each K tile
  evaluated once: ``kernel_matvec_plain`` (f = K @ a),
  ``kernel_vecmat_plain`` (g = K^T @ v), ``dual_pass_plain`` (both, v
  given) and ``train_pass_plain`` (f = s K @ a, v = loss_grad(f, y),
  g = K^T v).  The CPU tests use them, and the chip smoke holds the
  kernels against them on the card.
* CUDA wrappers, each with its own ``.launches`` counter, CUDA tensors
  only (a launch or a raise, no CPU form):
  ``kernel_matvec_cuda`` (replaces ``kernel_matvec_pallas``) and
  ``kernel_vecmat_cuda`` (the same kernels with the operands swapped,
  replaces ``kernel_vecmat_pallas``), the ops ``repro_torch::
  kernel_matvec`` / ``kernel_vecmat`` (``kernels/library.py``: CUDA
  bodies ``_matvec_body`` / ``_vecmat_body``, meta implementations for a
  trace), on three routes chosen by shape (``select_matvec_route``), each
  counted in ``.launches_by_route``:
  ``"sm90"`` (``csrc/dsekl_matvec_sm90.cu``: the six cross-term kinds
  with D <= ``SM90_MAX_D``, the cross term on the TF32 tensor cores split
  three ways, the query rows in registers), ``"sm90_wide"``
  (``csrc/dsekl_matvec_sm90_wide.cu``: the same kinds at wider D, the same
  split in a loop over D) and ``"fp32"`` (``csrc/dsekl_matvec.cu``: the
  Laplacian, fp32 CUDA cores);
  ``dual_pass_cuda``, ``train_pass_cuda`` and ``train_pass_indexed_cuda``
  (replace ``dual_pass_pallas`` and ``train_pass_pallas``) on two routes
  chosen by shape
  (``select_train_route``), each counted in ``.launches_by_route``:
  ``"sm90"`` (``csrc/dsekl_train_sm90.cu``: |J| <= ``SM90_TRAIN_MAX_J``,
  one cluster launch that keeps K on chip, in registers up to 1,024
  columns and in shared memory past them, and, in the indexed form, reads
  the rows of x, y and alpha by index) and ``"fp32"``
  (``csrc/dsekl_train.cu``: wider J, three passes through an (I, J)
  float32 K stash of at most ``STASH_BUDGET`` bytes).
  ``train_pass_indexed_plain`` is the indexed form's plain version.

The TPU module's ``mxu_dtype`` (bf16 cross-term) is not carried over: no
op asks for it.  Nor are ``choose_blocks`` / ``choose_predict_blocks`` /
``train_pass_blocks``: their VMEM budget means nothing here, and the
kernels pick their own tiles (``STASH_BUDGET`` takes the place of the
train pass's budget).
"""
from __future__ import annotations

import ctypes
import functools
import inspect
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import losses as losses_lib
from repro_torch.core.kernels_fn import SQRT3, SQRT5, integer_pow
from repro_torch.kernels import _build, full_fp32_matmul, library

Tensor = torch.Tensor

# Rows per plain-version tile: bounds its (block, n) intermediate.
PLAIN_BLOCK = 8192
# Bytes of the (I, J) float32 K stash that the fp32 train route may use.
# 32 MiB keeps the stash inside the H100's 50 MB L2; above it, on that
# route, ops.kernel_dual_pass falls back to matvec then vecmat (K evaluated
# twice), as the JAX op does when train_pass_blocks returns None.
STASH_BUDGET = 32 << 20


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


@functools.lru_cache(maxsize=None)
def _param_defaults(kernel_name: str) -> Tuple[Tuple[str, Any], ...]:
    """The tile function's keyword parameters and their defaults (read once:
    inspecting a signature costs more than a kernel launch's host work)."""
    sig = inspect.signature(TILE_FNS[kernel_name])
    return tuple((k, p.default) for k, p in sig.parameters.items()
                 if p.kind is inspect.Parameter.KEYWORD_ONLY)


def tile_params(kernel_name: str, params: Optional[Dict[str, Any]]
                ) -> Dict[str, Any]:
    """The tile function's hyperparameters with its defaults filled in;
    raises for an unknown kernel or parameter name."""
    if kernel_name not in TILE_FNS:
        raise ValueError(f"no tile for kernel {kernel_name!r}; "
                         f"available: {sorted(TILE_FNS)}")
    full = dict(_param_defaults(kernel_name))
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


# ---------------------------------------------------------------------------
# Plain versions: tile evaluators over row blocks, each K tile once.
# ---------------------------------------------------------------------------

def kernel_matvec_plain(x: Tensor, z: Tensor, a: Tensor, *,
                        kernel_name: str = "rbf",
                        params: Optional[Dict[str, Any]] = None,
                        block: int = PLAIN_BLOCK) -> Tensor:
    """f = K(x, z) @ a with the tile evaluator over ``block``-row tiles of
    z.  x (I, D), z (J, D), a (J,) -> (I,) float32.  Products in full
    float32; the caller's TF32 setting is restored."""
    tile_fn = make_tile_fn(kernel_name, params)
    x = x.to(torch.float32)
    f = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    with full_fp32_matmul():
        for start in range(0, z.shape[0], block):
            zt = z[start:start + block].to(torch.float32)
            at = a[start:start + block].to(torch.float32)
            f = f + tile_fn(x, zt) @ at
    return f


def kernel_vecmat_plain(x: Tensor, z: Tensor, v: Tensor, *,
                        kernel_name: str = "rbf",
                        params: Optional[Dict[str, Any]] = None,
                        block: int = PLAIN_BLOCK) -> Tensor:
    """g = K(x, z)^T @ v with the tile evaluator over ``block``-row tiles
    of x.  x (I, D), z (J, D), v (I,) -> (J,) float32.  Products in full
    float32; the caller's TF32 setting is restored."""
    tile_fn = make_tile_fn(kernel_name, params)
    z = z.to(torch.float32)
    g = torch.zeros((z.shape[0],), dtype=torch.float32, device=z.device)
    with full_fp32_matmul():
        for start in range(0, x.shape[0], block):
            xt = x[start:start + block].to(torch.float32)
            vt = v[start:start + block].to(torch.float32)
            g = g + tile_fn(xt, z).T @ vt
    return g


def _row_block_pass(x: Tensor, z: Tensor, a: Tensor,
                    v_of: Callable[[Tensor, int, int], Tensor], *,
                    kernel_name: str, params: Optional[Dict[str, Any]],
                    f_scale: float, block: int) -> Tuple[Tensor, Tensor]:
    """Per ``block``-row tile of x: K_b evaluated once, f_b = f_scale *
    K_b @ a, v_b = v_of(f_b, start, stop), g += K_b^T v_b.  Products in
    full float32; the caller's TF32 setting is restored."""
    tile_fn = make_tile_fn(kernel_name, params)
    z = z.to(torch.float32)
    a = a.to(torch.float32)
    g = torch.zeros((z.shape[0],), dtype=torch.float32, device=z.device)
    fs = []
    with full_fp32_matmul():
        for start in range(0, x.shape[0], block):
            stop = min(start + block, x.shape[0])
            kb = tile_fn(x[start:stop].to(torch.float32), z)
            fb = f_scale * (kb @ a)
            g = g + kb.T @ v_of(fb, start, stop)
            fs.append(fb)
    f = (torch.cat(fs) if fs else
         torch.zeros((0,), dtype=torch.float32, device=x.device))
    return f, g


def dual_pass_plain(x: Tensor, z: Tensor, a: Tensor, v: Tensor, *,
                    kernel_name: str = "rbf",
                    params: Optional[Dict[str, Any]] = None,
                    f_scale: float = 1.0, block: int = PLAIN_BLOCK
                    ) -> Tuple[Tensor, Tensor]:
    """(f, g) = (f_scale * K @ a, K^T @ v), each K tile evaluated once."""
    v = v.to(torch.float32)
    return _row_block_pass(x, z, a, lambda fb, s, e: v[s:e],
                           kernel_name=kernel_name, params=params,
                           f_scale=f_scale, block=block)


def train_pass_plain(x: Tensor, z: Tensor, a: Tensor, y: Tensor, *,
                     loss: str = "hinge", kernel_name: str = "rbf",
                     params: Optional[Dict[str, Any]] = None,
                     f_scale: float = 1.0, block: int = PLAIN_BLOCK
                     ) -> Tuple[Tensor, Tensor]:
    """(f, g) with f = f_scale * K @ a, v = loss_grad(f, y), g = K^T @ v,
    each K tile evaluated once."""
    grad = losses_lib.get_loss(loss).grad_f
    y = y.to(torch.float32)
    return _row_block_pass(x, z, a, lambda fb, s, e: grad(fb, y[s:e]),
                           kernel_name=kernel_name, params=params,
                           f_scale=f_scale, block=block)


def train_pass_indexed_plain(x: Tensor, y: Tensor, alpha: Tensor,
                             idx_i: Tensor, idx_j: Tensor, *,
                             loss: str = "hinge", kernel_name: str = "rbf",
                             params: Optional[Dict[str, Any]] = None,
                             f_scale: float = 1.0, lam: float = 0.0,
                             block: int = PLAIN_BLOCK
                             ) -> Tuple[Tensor, Tensor]:
    """``train_pass_plain`` on the rows that ``idx_i`` and ``idx_j`` pick:
    x (N, D), y (N,), alpha (N,); g + lam * alpha[idx_j]."""
    aj = alpha[idx_j].to(torch.float32)
    f, g = train_pass_plain(x[idx_i], x[idx_j], aj, y[idx_i], loss=loss,
                            kernel_name=kernel_name, params=params,
                            f_scale=f_scale, block=block)
    return f, (g + lam * aj if lam else g)


# ---------------------------------------------------------------------------
# CUDA kernels: libraries, argument checks, wrappers.
# ---------------------------------------------------------------------------

# The matvec's routes (select_matvec_route) and their sources, csrc/<name>.cu.
MATVEC_ROUTES = ("sm90", "sm90_wide", "fp32")
MATVEC_LIBS = {"sm90": "dsekl_matvec_sm90",
               "sm90_wide": "dsekl_matvec_sm90_wide", "fp32": "dsekl_matvec"}


class _MatvecEntries(NamedTuple):
    """A matvec library's C entry points.  Every route's launch takes the
    same arguments; blocks an SM takes the kind, and D where
    ``per_sm_takes_d``; ``scratch_floats``, where the library has one,
    sizes the launch's scratch from (I, J, D, n_split), which is otherwise
    n_split I + I + J floats."""
    launch: str
    blocks_per_sm: str
    error_string: str
    per_sm_takes_d: bool
    scratch_floats: Optional[str] = None


_MATVEC_ENTRIES = {
    "sm90": _MatvecEntries("dsekl_matvec_sm90",
                           "dsekl_matvec_sm90_blocks_per_sm",
                           "dsekl_matvec_sm90_error_string", True),
    "sm90_wide": _MatvecEntries("dsekl_matvec_sm90_wide",
                                "dsekl_matvec_sm90_wide_blocks_per_sm",
                                "dsekl_matvec_sm90_wide_error_string", False,
                                "dsekl_matvec_sm90_wide_scratch_floats"),
    "fp32": _MatvecEntries("dsekl_kernel_matvec", "dsekl_blocks_per_sm",
                           "dsekl_error_string", False)}
# Support (and query) rows a tile of each route's kernel.
MATVEC_TILE = {"sm90": 128, "sm90_wide": 128, "fp32": 64}
# The kinds whose tile is a function of the cross term x.z: the sm90
# kernels run their products on the tensor cores.  The Laplacian's L1 sum
# has no product.
CROSS_TERM_KINDS = ("rbf", "linear", "polynomial", "sigmoid", "matern32",
                    "matern52")
# The widest D of the sm90 kernel: two 128-byte panels of 32 floats, which
# its three-stage ring of split support tiles fits in shared memory.  Wider
# D takes the sm90_wide kernel, which loops over D.
SM90_MAX_D = 64


def select_matvec_route(kernel_name: str, d: int) -> str:
    """The kernel that computes ``K(x, z) @ a`` for ``kernel_name`` at
    width ``d``: for the six cross-term kinds ``"sm90"`` with 1 <= d <=
    ``SM90_MAX_D`` and ``"sm90_wide"`` past it; ``"fp32"`` for the
    Laplacian.  Chosen by shape, never as a fallback; raises for an
    unknown kernel."""
    if kernel_name not in KINDS:
        raise ValueError(f"select_matvec_route: no CUDA kernel for "
                         f"{kernel_name!r}; available: {sorted(KINDS)}")
    if kernel_name not in CROSS_TERM_KINDS or d < 1:
        return "fp32"
    return "sm90" if d <= SM90_MAX_D else "sm90_wide"


def _lib(route: str) -> ctypes.CDLL:
    """The loaded library of the matvec ``route`` with its C functions
    typed."""
    return typed_matvec_lib(_build.load(MATVEC_LIBS[route]), route)


def typed_matvec_lib(lib: ctypes.CDLL, route: str) -> ctypes.CDLL:
    """``lib``, a library built from ``route``'s source, with its C
    functions' argument types set (``_MATVEC_ENTRIES``)."""
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    e = _MATVEC_ENTRIES[route]
    fn, per_sm, err = (getattr(lib, name) for name in e[:3])
    if fn.argtypes is None:
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, f, f, f, i, i, f,
                       i, i, vp]
        fn.restype = ctypes.c_int
        per_sm.argtypes = [i, i] if e.per_sm_takes_d else [i]
        per_sm.restype = ctypes.c_int
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        if e.scratch_floats:
            sizer = getattr(lib, e.scratch_floats)
            sizer.argtypes = [i, i, i, i]
            sizer.restype = ctypes.c_longlong
    return lib


def _train_lib() -> ctypes.CDLL:
    lib = _build.load("dsekl_train")
    fn = lib.dsekl_train_pass
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, f, f, f, i,
                       i, f, i, f, vp]
        fn.restype = ctypes.c_int
        lib.dsekl_train_scratch_floats.argtypes = [i, i]
        lib.dsekl_train_scratch_floats.restype = ctypes.c_longlong
        lib.dsekl_train_error_string.argtypes = [i]
        lib.dsekl_train_error_string.restype = ctypes.c_char_p
    return lib


# The train pass's routes (select_train_route) and their sources.
TRAIN_ROUTES = ("sm90", "fp32")
TRAIN_LIBS = {"sm90": "dsekl_train_sm90", "fp32": "dsekl_train"}
# The widest J of the sm90 train kernel: a cluster of 8 CTAs (the portable
# size) holds an 80-row K block, each CTA up to eight 64-column tiles.  Up
# to 1,024 columns (two tiles a CTA: Algorithm 1's step) K stays in
# registers; past them (Algorithm 2's J union of 4 x 1,024) each CTA
# computes two tiles at a time and keeps K in 160 KB of shared memory.
SM90_TRAIN_MAX_J = 4096
# Rows of I a cluster covers, and the most rows the kernel takes: 65,535
# row blocks (gridDim.y).
SM90_TRAIN_ROWS = 80
SM90_TRAIN_MAX_I = 65535 * SM90_TRAIN_ROWS


def select_train_route(n_i: int, n_j: int, d: int, kernel_name: str) -> str:
    """The kernel that computes the train (and dual) pass on an (n_i, n_j)
    block of width ``d``: ``"sm90"`` for 1 <= n_j <= ``SM90_TRAIN_MAX_J``
    and n_i <= ``SM90_TRAIN_MAX_I`` (every kind, any D: K is held on chip),
    else ``"fp32"`` (the K stash, within ``STASH_BUDGET``).  Chosen by
    shape, never as a fallback; raises for an unknown kernel or d < 1."""
    if kernel_name not in KINDS:
        raise ValueError(f"select_train_route: no CUDA kernel for "
                         f"{kernel_name!r}; available: {sorted(KINDS)}")
    if d < 1:
        raise ValueError(f"select_train_route: D must be positive, got {d}")
    if 1 <= n_j <= SM90_TRAIN_MAX_J and n_i <= SM90_TRAIN_MAX_I:
        return "sm90"
    return "fp32"


def typed_train_sm90_lib(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a library built from ``csrc/dsekl_train_sm90.cu`` (or a
    variant of it), with its C functions' argument types set."""
    fn = lib.dsekl_train_sm90
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, i, vp, vp, i, vp, vp, vp, vp, vp, vp, i, i, i,
                       i, f, f, f, i, i, f, i, f, f, vp]
        fn.restype = ctypes.c_int
        lib.dsekl_train_sm90_scratch_floats.argtypes = [i, i]
        lib.dsekl_train_sm90_scratch_floats.restype = ctypes.c_longlong
        for name in ("dsekl_train_sm90_counters", "dsekl_train_sm90_max_j"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        for name in ("dsekl_train_sm90_active_clusters",
                     "dsekl_train_sm90_smem_bytes"):
            getattr(lib, name).restype = ctypes.c_int
        lib.dsekl_train_sm90_active_clusters.argtypes = [i, i]
        lib.dsekl_train_sm90_smem_bytes.argtypes = [i]
        lib.dsekl_train_sm90_error_string.argtypes = [i]
        lib.dsekl_train_sm90_error_string.restype = ctypes.c_char_p
    return lib


def _train_sm90_lib() -> ctypes.CDLL:
    return typed_train_sm90_lib(_build.load("dsekl_train_sm90"))


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
def _resident_blocks(route: str, kind: int, d: int, device_index: int) -> int:
    """Blocks of the ``route`` kernel for ``kind`` (and, where its
    library takes it, width ``d``) resident on the whole card at once."""
    n_sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    e = _MATVEC_ENTRIES[route]
    with torch.cuda.device(device_index):
        per_sm_fn = getattr(_lib(route), e.blocks_per_sm)
        per_sm = per_sm_fn(kind, d) if e.per_sm_takes_d else per_sm_fn(kind)
    if per_sm <= 0:
        raise RuntimeError(f"blocks per SM of the {route} matvec kernel "
                           f"(kind {kind}, D {d}) failed: {per_sm}")
    return per_sm * n_sms


def _kind(fn: str, kernel_name: str) -> int:
    kind = KINDS.get(kernel_name)
    if kind is None:
        raise ValueError(f"{fn}: no CUDA kernel for {kernel_name!r}; "
                         f"available: {sorted(KINDS)}")
    return kind


def _check_cuda_args(fn: str, x: Tensor, z: Tensor, on_card: bool = True,
                     **vecs: Tuple[Tensor, str]) -> None:
    """x (I, D), z (J, D) and each named vector, whose length must be I
    (``"I"``) or J (``"J"``): contiguous float32 CUDA tensors on one
    device, D > 0, fewer than 2**31 elements each."""
    named = [("x", x), ("z", z)] + [(k, t) for k, (t, _) in vecs.items()]
    for name, t in named:
        if on_card and not t.is_cuda:
            raise ValueError(f"{fn}: {name} is on {t.device}; "
                             "the CUDA kernel takes CUDA tensors only")
        if t.device != x.device:
            raise ValueError(f"{fn}: arguments on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} is {t.dtype}, "
                            "expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")
    def shapes():
        return ", ".join(f"{n} {tuple(t.shape)}" for n, t in named)

    if (x.dim() != 2 or z.dim() != 2
            or any(t.dim() != 1 for t, _ in vecs.values())):
        raise ValueError(f"{fn}: expected x (I, D), z (J, D) and vectors; "
                         f"got {shapes()}")
    lengths = {"I": x.shape[0], "J": z.shape[0]}
    if x.shape[1] != z.shape[1] or any(
            t.shape[0] != lengths[axis] for t, axis in vecs.values()):
        raise ValueError(f"{fn}: shape mismatch {shapes()}")
    if x.shape[1] == 0:
        raise ValueError(f"{fn}: D must be positive")
    if max(x.numel(), z.numel()) >= 2 ** 31:
        raise ValueError(f"{fn}: more than 2**31 elements")


def _kernel_scalars(p: Dict[str, Any]) -> Tuple:
    """(gamma, coef0, degree, int_degree, degree_i, length_scale) as the C
    entry points take them."""
    degree = float(p.get("degree", 0))
    int_degree = degree.is_integer()
    return (float(p.get("gamma", 1.0)), float(p.get("coef0", 0.0)), degree,
            int(int_degree), int(degree) if int_degree else 0,
            float(p.get("length_scale", 1.0)))


def launch_matvec(lib: ctypes.CDLL, route: str, x: Tensor, z: Tensor,
                  a: Tensor, kind: int, p: Dict[str, Any],
                  fn: str = "launch_matvec") -> Tensor:
    """K(x, z) @ a by ``route``'s kernel from ``lib`` (see
    ``typed_matvec_lib``) on checked tensors; no launch when x has no
    rows.  Raises if the launch is refused.  Counts nothing: the wrappers
    do."""
    n_i, d = x.shape
    n_j = z.shape[0]
    out = torch.empty((n_i,), dtype=torch.float32, device=x.device)
    if n_i == 0:
        return out
    dev = (x.device.index if x.device.index is not None
           else torch.cuda.current_device())
    n_split, per = split_support(n_i, n_j,
                                 _resident_blocks(route, kind, d, dev),
                                 MATVEC_TILE[route])
    e = _MATVEC_ENTRIES[route]
    n_scratch = (getattr(lib, e.scratch_floats)(n_i, n_j, d, n_split)
                 if e.scratch_floats else n_split * n_i + n_i + n_j)
    scratch = torch.empty((n_scratch,), dtype=torch.float32,
                          device=x.device)
    entry, err_string = getattr(lib, e.launch), getattr(lib, e.error_string)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), z.data_ptr(), a.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), n_i, n_j, d, kind,
                    *_kernel_scalars(p), n_split, per, stream)
    if err != 0:
        raise RuntimeError(f"{fn} ({route}): matvec launch failed: "
                           + err_string(err).decode())
    return out


def _op_scalars(fn: str, kernel_name: str,
                params: Optional[Dict[str, Any]]) -> Tuple[float, ...]:
    """The kernel's hyperparameters, checked and with their defaults, as
    the ops take them: (gamma, coef0, degree, length_scale)."""
    _kind(fn, kernel_name)
    p = tile_params(kernel_name, params)
    return tuple(float(p.get(k, d)) for k, d in _OP_PARAMS)


_OP_PARAMS = (("gamma", 1.0), ("coef0", 0.0), ("degree", 0.0),
              ("length_scale", 1.0))


def kernel_matvec_cuda(x: Tensor, z: Tensor, a: Tensor, *,
                       kernel_name: str = "rbf",
                       params: Optional[Dict[str, Any]] = None) -> Tensor:
    """f = K(x, z) @ a by the hand-written Hopper kernel of
    ``select_matvec_route``: the six cross-term kinds on the tensor cores,
    by the ``sm90`` kernel with D <= ``SM90_MAX_D`` and the ``sm90_wide``
    one past it, the Laplacian on the ``fp32`` one.

    x (I, D), z (J, D), a (J,): contiguous float32 CUDA tensors on one
    device.  Launches on the current stream without synchronising and
    raises if the build or the launch fails.  ``.launches`` counts every
    launch, ``.launches_by_route`` each route's.  There is no CPU form.
    Through the op ``repro_torch::kernel_matvec``."""
    return MATVEC_OP(x, z, a, kernel_name,
                     *_op_scalars("kernel_matvec_cuda", kernel_name, params))


kernel_matvec_cuda.launches = 0
kernel_matvec_cuda.launches_by_route = dict.fromkeys(MATVEC_ROUTES, 0)


def _op_params(gamma: float, coef0: float, degree: float,
               length_scale: float) -> Dict[str, Any]:
    return dict(gamma=gamma, coef0=coef0, degree=degree,
                length_scale=length_scale)


def _matvec_body(x: Tensor, z: Tensor, a: Tensor, kernel_name: str,
                 gamma: float, coef0: float, degree: float,
                 length_scale: float) -> Tensor:
    """``repro_torch::kernel_matvec``'s CUDA body."""
    fn = "kernel_matvec_cuda"
    kind = _kind(fn, kernel_name)
    p = _op_params(gamma, coef0, degree, length_scale)
    _check_cuda_args(fn, x, z, a=(a, "J"))
    route = select_matvec_route(kernel_name, x.shape[1])
    out = launch_matvec(_lib(route), route, x, z, a, kind, p, fn)
    kernel_matvec_cuda.launches += bool(x.shape[0])
    kernel_matvec_cuda.launches_by_route[route] += bool(x.shape[0])
    return out


def kernel_vecmat_cuda(x: Tensor, z: Tensor, v: Tensor, *,
                       kernel_name: str = "rbf",
                       params: Optional[Dict[str, Any]] = None) -> Tensor:
    """g = K(x, z)^T @ v by the matvec kernels with the operands swapped,
    on the route ``select_matvec_route`` gives (K(x, z)^T v == K(z, x) v
    bit for bit: every registry kernel is symmetric, and both kernels
    compute K(z, x) v as the matvec call would).  Counted in its own
    ``launches`` and ``launches_by_route``.

    x (I, D), z (J, D), v (I,): contiguous float32 CUDA tensors on one
    device.  There is no CPU form.  Through the op
    ``repro_torch::kernel_vecmat``."""
    return VECMAT_OP(x, z, v, kernel_name,
                     *_op_scalars("kernel_vecmat_cuda", kernel_name, params))


kernel_vecmat_cuda.launches = 0
kernel_vecmat_cuda.launches_by_route = dict.fromkeys(MATVEC_ROUTES, 0)


def _vecmat_body(x: Tensor, z: Tensor, v: Tensor, kernel_name: str,
                 gamma: float, coef0: float, degree: float,
                 length_scale: float) -> Tensor:
    """``repro_torch::kernel_vecmat``'s CUDA body."""
    fn = "kernel_vecmat_cuda"
    kind = _kind(fn, kernel_name)
    p = _op_params(gamma, coef0, degree, length_scale)
    _check_cuda_args(fn, x, z, v=(v, "I"))
    route = select_matvec_route(kernel_name, x.shape[1])
    out = launch_matvec(_lib(route), route, z, x, v, kind, p, fn)
    kernel_vecmat_cuda.launches += bool(z.shape[0])
    kernel_vecmat_cuda.launches_by_route[route] += bool(z.shape[0])
    return out


def _matvec_meta(x: Tensor, z: Tensor, a: Tensor, kernel_name: str,
                 *params: float) -> Tensor:
    _check_cuda_args("kernel_matvec_cuda", x, z, on_card=False, a=(a, "J"))
    return x.new_empty((x.shape[0],), dtype=torch.float32)


def _vecmat_meta(x: Tensor, z: Tensor, v: Tensor, kernel_name: str,
                 *params: float) -> Tensor:
    _check_cuda_args("kernel_vecmat_cuda", x, z, on_card=False, v=(v, "I"))
    return z.new_empty((z.shape[0],), dtype=torch.float32)


def _matvec_flops(x_shape, z_shape, a_shape, kernel_name, *params,
                  out_shape=None, **kwargs) -> int:
    """The plain version's count: the cross term x z^T (2 I J D) of every
    kind but the Laplacian, whose L1 distance no product computes (the
    matrix-vector product itself is no matmul to ``FlopCounterMode``)."""
    if kernel_name == "laplacian":
        return 0
    return 2 * x_shape[0] * z_shape[0] * x_shape[1]


def _matvec_route(x: Tensor, z: Tensor, a: Tensor, kernel_name: str,
                  *params: float) -> str:
    return select_matvec_route(kernel_name, x.shape[1])


_SCHEMA = ("(Tensor x, Tensor z, Tensor {v}, str kernel_name, float gamma, "
           "float coef0, float degree, float length_scale) -> Tensor")
MATVEC_OP = library.define("kernel_matvec" + _SCHEMA.format(v="a"),
                           _matvec_body, _matvec_meta, _matvec_flops,
                           _matvec_route)
VECMAT_OP = library.define("kernel_vecmat" + _SCHEMA.format(v="v"),
                           _vecmat_body, _vecmat_meta, _matvec_flops,
                           _matvec_route)


def fits_stash(n_i: int, n_j: int) -> bool:
    """Whether the (n_i, n_j) K stash fits ``STASH_BUDGET``."""
    return 4 * n_i * n_j <= STASH_BUDGET


def _check_indices(fn: str, x: Tensor, **idx: Tensor) -> None:
    """Each named index vector: a contiguous int64 CUDA tensor of one
    dimension on x's device, fewer than 2**31 long.  Its values are the
    kernel's to check (it traps on one outside [0, N))."""
    for name, t in idx.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}; the CUDA kernel "
                             "takes CUDA tensors only, on x's device")
        if t.dtype != torch.int64:
            raise TypeError(f"{fn}: {name} is {t.dtype}, expected "
                            "torch.int64")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous vector, got "
                             f"shape {tuple(t.shape)}")
        if t.shape[0] >= 2 ** 31:
            raise ValueError(f"{fn}: {name} has 2**31 or more entries")


# Per (device, stream): the sm90 train kernel's g_parts scratch and its
# arrival counters.  The counters are zeroed once, here, and every launch
# leaves them zero; the scratch grows when a larger block needs more.
_SM90_SCRATCH: Dict[Tuple[int, int], Dict[str, Tensor]] = {}


def _sm90_scratch(lib: ctypes.CDLL, stream: torch.cuda.Stream,
                  device: torch.device, n_i: int, n_j: int
                  ) -> Tuple[Tensor, Tensor]:
    key = (stream.device_index, stream.cuda_stream)
    cached = _SM90_SCRATCH.get(key)
    if cached is None:
        cached = _SM90_SCRATCH[key] = {
            "counters": torch.zeros((lib.dsekl_train_sm90_counters(),),
                                    dtype=torch.int32, device=device),
            "g_parts": torch.empty((0,), dtype=torch.float32, device=device)}
    need = lib.dsekl_train_sm90_scratch_floats(n_i, n_j)
    if cached["g_parts"].numel() < need:
        cached["g_parts"] = torch.empty((need,), dtype=torch.float32,
                                        device=device)
    return cached["g_parts"], cached["counters"]


def launch_train_sm90(lib: ctypes.CDLL, x: Tensor, idx_i: Optional[Tensor],
                      z: Tensor, idx_j: Optional[Tensor], a: Tensor,
                      vy: Tensor, n_i: int, n_j: int, kind: int,
                      p: Dict[str, Any], loss_code: int, f_scale: float,
                      lam: float = 0.0, fn: str = "launch_train_sm90",
                      scratch: Optional[Tuple[Tensor, Tensor]] = None
                      ) -> Tuple[Tensor, Tensor]:
    """(f (n_i,), g (n_j,)) by the sm90 train kernel from ``lib`` (see
    ``typed_train_sm90_lib``) on checked tensors, n_i >= 1: the rows of I
    are x[idx_i] (x itself when idx_i is None), those of J z[idx_j], a and
    vy indexed as them.  ``scratch`` (g_parts, zeroed counters) defaults
    to the cached one of the current stream.  Raises if the launch is
    refused.  Counts nothing: the wrappers do."""
    f = torch.empty((n_i,), dtype=torch.float32, device=x.device)
    g = torch.empty((n_j,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device)
        g_parts, counters = (scratch if scratch is not None else
                             _sm90_scratch(lib, stream, x.device, n_i, n_j))
        err = lib.dsekl_train_sm90(
            x.data_ptr(), None if idx_i is None else idx_i.data_ptr(),
            x.shape[0], z.data_ptr(),
            None if idx_j is None else idx_j.data_ptr(), z.shape[0],
            a.data_ptr(), vy.data_ptr(), f.data_ptr(), g.data_ptr(),
            g_parts.data_ptr(), counters.data_ptr(), n_i, n_j, x.shape[1],
            kind, *_kernel_scalars(p), loss_code, float(f_scale), float(lam),
            stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn} (sm90): dsekl_train_sm90 launch failed: "
                           + lib.dsekl_train_sm90_error_string(err).decode())
    return f, g


def _launch_train_fp32(fn: str, x: Tensor, z: Tensor, a: Tensor, vy: Tensor,
                       loss_code: int, kind: int, p: Dict[str, Any],
                       f_scale: float) -> Tuple[Tensor, Tensor]:
    """(f, g) by dsekl_train.cu on checked tensors, x with rows."""
    n_i, d = x.shape
    n_j = z.shape[0]
    if not fits_stash(n_i, n_j):
        raise ValueError(
            f"{fn}: the ({n_i}, {n_j}) K stash of the fp32 route is over "
            f"STASH_BUDGET ({STASH_BUDGET} bytes); ops.kernel_dual_pass "
            "falls back to matvec then vecmat there")
    lib = _train_lib()
    f = torch.empty((n_i,), dtype=torch.float32, device=x.device)
    g = torch.empty((n_j,), dtype=torch.float32, device=x.device)
    scratch = torch.empty((lib.dsekl_train_scratch_floats(n_i, n_j),),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.dsekl_train_pass(
            x.data_ptr(), z.data_ptr(), a.data_ptr(), vy.data_ptr(),
            f.data_ptr(), g.data_ptr(), scratch.data_ptr(), n_i, n_j, d,
            kind, *_kernel_scalars(p), loss_code, float(f_scale), stream)
    if err != 0:
        raise RuntimeError(f"{fn} (fp32): dsekl_train_pass launch failed: "
                           + lib.dsekl_train_error_string(err).decode())
    return f, g


def _launch_train(fn: str, x: Tensor, z: Tensor, a: Tensor, vy: Tensor,
                  loss_code: int, kernel_name: str,
                  params: Optional[Dict[str, Any]], f_scale: float
                  ) -> Tuple[Tensor, Tensor, Optional[str]]:
    """(f, g, route) on contiguous rows by the kernel of
    ``select_train_route``; no launch (f empty, g zero, route None) when x
    has no rows."""
    kind = _kind(fn, kernel_name)
    p = tile_params(kernel_name, params)
    _check_cuda_args(fn, x, z, a=(a, "J"), vy=(vy, "I"))
    n_i, d = x.shape
    n_j = z.shape[0]
    if n_i == 0:
        return (torch.empty((0,), dtype=torch.float32, device=x.device),
                torch.zeros((n_j,), dtype=torch.float32, device=x.device),
                None)
    route = select_train_route(n_i, n_j, d, kernel_name)
    if route == "sm90":
        f, g = launch_train_sm90(_train_sm90_lib(), x, None, z, None, a, vy,
                                 n_i, n_j, kind, p, loss_code, f_scale, fn=fn)
    else:
        f, g = _launch_train_fp32(fn, x, z, a, vy, loss_code, kind, p,
                                  f_scale)
    return f, g, route


def _count(wrapper, route: Optional[str]) -> None:
    """One launch of ``wrapper`` on ``route`` (None: no launch)."""
    if route is not None:
        wrapper.launches += 1
        wrapper.launches_by_route[route] += 1


def dual_pass_cuda(x: Tensor, z: Tensor, a: Tensor, v: Tensor, *,
                   kernel_name: str = "rbf",
                   params: Optional[Dict[str, Any]] = None,
                   f_scale: float = 1.0) -> Tuple[Tensor, Tensor]:
    """(f, g) = (f_scale * K @ a, K^T @ v) by the hand-written Hopper
    kernel of ``select_train_route``, each K value evaluated once.

    x (I, D), z (J, D), a (J,), v (I,): contiguous float32 CUDA tensors on
    one device; on the fp32 route the (I, J) stash within
    ``STASH_BUDGET``.  ``.launches`` counts every launch,
    ``.launches_by_route`` each route's.  There is no CPU form."""
    f, g, route = _launch_train("dual_pass_cuda", x, z, a, v, -1,
                                kernel_name, params, f_scale)
    _count(dual_pass_cuda, route)
    return f, g


dual_pass_cuda.launches = 0
dual_pass_cuda.launches_by_route = dict.fromkeys(TRAIN_ROUTES, 0)


def _loss_code(fn: str, loss: str) -> int:
    if loss not in losses_lib.LOSS_CODES:
        raise ValueError(f"{fn}: unknown loss {loss!r}; "
                         f"available: {sorted(losses_lib.LOSS_CODES)}")
    return losses_lib.LOSS_CODES[loss]


def train_pass_cuda(x: Tensor, z: Tensor, a: Tensor, y: Tensor, *,
                    loss: str = "hinge", kernel_name: str = "rbf",
                    params: Optional[Dict[str, Any]] = None,
                    f_scale: float = 1.0) -> Tuple[Tensor, Tensor]:
    """(f, g) with f = f_scale * K @ a, v = loss_grad(f, y), g = K^T @ v by
    the hand-written Hopper kernel of ``select_train_route``, each K value
    evaluated once, the loss gradient fused.

    x (I, D), z (J, D), a (J,), y (I,): contiguous float32 CUDA tensors on
    one device; on the fp32 route the (I, J) stash within
    ``STASH_BUDGET``.  ``.launches`` counts every launch,
    ``.launches_by_route`` each route's.  There is no CPU form."""
    code = _loss_code("train_pass_cuda", loss)
    f, g, route = _launch_train("train_pass_cuda", x, z, a, y, code,
                                kernel_name, params, f_scale)
    _count(train_pass_cuda, route)
    return f, g


train_pass_cuda.launches = 0
train_pass_cuda.launches_by_route = dict.fromkeys(TRAIN_ROUTES, 0)


def train_pass_indexed_cuda(x: Tensor, y: Tensor, alpha: Tensor,
                            idx_i: Tensor, idx_j: Tensor, *,
                            loss: str = "hinge", kernel_name: str = "rbf",
                            params: Optional[Dict[str, Any]] = None,
                            f_scale: float = 1.0, lam: float = 0.0
                            ) -> Tuple[Tensor, Tensor]:
    """The train pass on the rows that ``idx_i`` and ``idx_j`` pick:
    f = f_scale * K(x[idx_i], x[idx_j]) @ alpha[idx_j], v = loss_grad(f,
    y[idx_i]), g = K^T @ v + lam * alpha[idx_j], position by position
    (a duplicate index of J gets its own g entry).

    x (N, D), y (N,), alpha (N,): contiguous float32 CUDA tensors on one
    device; idx_i (I,), idx_j (J,): contiguous int64 on the same device,
    each in [0, N) (the kernel traps on one outside).  On the ``"sm90"``
    route (``select_train_route``: J <= ``SM90_TRAIN_MAX_J``, Algorithm
    1's step and Algorithm 2's 4,096-column J union) the kernel reads the
    rows by index and adds lam: no gather precedes it.  On the ``"fp32"``
    route (wider J) the rows are gathered, then ``csrc/dsekl_train.cu``
    runs (the stash within ``STASH_BUDGET``) and lam is added in torch.
    ``.launches`` counts every launch, ``.launches_by_route`` each
    route's.  There is no CPU form."""
    fn = "train_pass_indexed_cuda"
    code = _loss_code(fn, loss)
    kind = _kind(fn, kernel_name)
    p = tile_params(kernel_name, params)
    _check_cuda_args(fn, x, x, y=(y, "I"), alpha=(alpha, "I"))
    _check_indices(fn, x, idx_i=idx_i, idx_j=idx_j)
    n_i, n_j = idx_i.shape[0], idx_j.shape[0]
    if n_i == 0:
        aj = alpha[idx_j]
        return (torch.empty((0,), dtype=torch.float32, device=x.device),
                lam * aj if lam else torch.zeros_like(aj))
    route = select_train_route(n_i, n_j, x.shape[1], kernel_name)
    if route == "sm90":
        f, g = launch_train_sm90(_train_sm90_lib(), x, idx_i, x, idx_j,
                                 alpha, y, n_i, n_j, kind, p, code, f_scale,
                                 lam, fn=fn)
    else:
        aj = alpha[idx_j]
        f, g = _launch_train_fp32(fn, x[idx_i], x[idx_j], aj, y[idx_i], code,
                                  kind, p, f_scale)
        if lam:
            g = g + lam * aj
    _count(train_pass_indexed_cuda, route)
    return f, g


train_pass_indexed_cuda.launches = 0
train_pass_indexed_cuda.launches_by_route = dict.fromkeys(TRAIN_ROUTES, 0)
