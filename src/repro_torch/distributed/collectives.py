"""Collectives over the mesh axes of a ``MeshCtx`` (port of
``repro/distributed/collectives.py`` and of the ``jax.lax`` collectives
the JAX model code calls inside ``shard_map`` or lets GSPMD insert).

Every function takes the tensor, the ``MeshCtx`` and the mesh axes (a name
or a tuple: over ``("pod", "data")`` one group spans both).  On one rank
along the axes, or with no mesh, each returns its input.

JAX -> ``torch.distributed``:

  * ``psum``          -> ``all_reduce(SUM)`` on the axes' group, in place
    (``psum_product``: a contraction-split product's partials in float32);
  * ``all_gather(tiled=True)`` -> by backend and device:
      - ``nccl``: ``all_gather_into_tensor``;
      - ``gloo`` on the CPU: ``all_gather``;
      - ``gloo`` on a CUDA tensor: the slot stack, an ``all_reduce`` of a
        zero-filled (n, ...) stack in which each rank writes its own slot
        (exact: x + 0 = x), gloo's only gather for a CUDA tensor;
  * ``psum_scatter(tiled=True)`` -> ``reduce_scatter_tensor`` on nccl;
    else ``all_reduce(SUM)`` and this rank's slice;
  * ``ppermute`` (a ring shift) -> ``batch_isend_irecv`` where the backend
    can send the tensor (nccl; gloo on the CPU), else the slot stack and
    the sender's slot.

The choice is a function of the backend and the tensor's device alone,
never a fallback after a failure, and each call is counted in ``COUNTS``
under ``"<op>:<method>"``.  A slot-stack gather moves n times the bytes
of a native one.

``allgather_matmul_overlapped`` and ``ring_psum_matmul`` are the JAX
module's ring schedules of a row-sharded and a contraction-sharded
matmul: n ring steps, each a matmul and a shift.  Here the shift waits
for its peers (no overlap is claimed); the results equal the gathered
products (``tests/test_torch_collectives.py``).
"""
from __future__ import annotations

import collections
from typing import Counter

import torch
import torch.distributed as dist

Tensor = torch.Tensor

COUNTS: Counter = collections.Counter()


def _size(ctx, axes) -> int:
    if ctx is None or ctx.mesh is None:
        return 1
    return ctx.size(axes)


def gather_method(t: Tensor, ctx) -> str:
    """"native" or "slots" for a gather of ``t`` on ``ctx``'s backend."""
    if ctx.mesh.backend == "nccl" or t.device.type == "cpu":
        return "native"
    return "slots"


def psum(x: Tensor, ctx, axes) -> Tensor:
    """``x`` summed over ``axes`` (in place when ``x`` is contiguous)."""
    if _size(ctx, axes) == 1:
        return x
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=ctx.group(axes))
    COUNTS["psum:all_reduce"] += 1
    return x


def psum_product(op, x: Tensor, w: Tensor, ctx, axes) -> Tensor:
    """``op(x, w)``, a product whose contraction is split over ``axes``
    (this rank holds matching slices of x and w).  On the mesh the partial
    product is taken on float32 copies, summed over the axes in float32
    and rounded once to x's dtype, as one device's bf16 GEMM rounds its
    float32 accumulator once; bf16 partials would each be rounded first,
    and they cancel where the activations are large (PERF.md, PR 26).
    The products of bf16 operands are exact in TF32 too, so the process's
    ``allow_tf32`` sets only the speed.  Off the mesh, ``op(x, w)``."""
    if _size(ctx, axes) == 1:
        return op(x, w)
    part = op(x.to(torch.float32), w.to(torch.float32))
    return psum(part, ctx, axes).to(x.dtype)


def _slots(x: Tensor, ctx, axes) -> Tensor:
    """(n,) + x.shape: slot i holds the x of the rank at coordinate i on
    ``axes``, on every rank of the group."""
    out = x.new_zeros((ctx.size(axes),) + tuple(x.shape))
    out[ctx.index(axes)] = x
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group(axes))
    return out


def all_gather(x: Tensor, ctx, axes, dim: int = 0,
               method: str = "") -> Tensor:
    """Tiled all-gather: the ranks' ``x`` concatenated along ``dim`` in
    coordinate order.  ``method`` forces "native" or "slots" (tests)."""
    n = _size(ctx, axes)
    if n == 1:
        return x
    method = method or gather_method(x, ctx)
    COUNTS[f"all_gather:{method}"] += 1
    if method == "slots":
        return torch.cat(_slots(x, ctx, axes).unbind(0), dim=dim)
    group = ctx.group(axes)
    if ctx.mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def psum_scatter(x: Tensor, ctx, axes, dim: int = 0) -> Tensor:
    """Tiled ``psum_scatter``: ``x`` summed over ``axes``, then this rank's
    1/n of ``dim``."""
    n = _size(ctx, axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not divide over {n} ranks")
    if ctx.mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=ctx.group(axes))
        COUNTS["psum_scatter:reduce_scatter"] += 1
        return out.movedim(0, dim)
    total = psum(x.clone(), ctx, axes)
    COUNTS["psum_scatter:all_reduce"] += 1
    step = x.shape[dim] // n
    return total.narrow(dim, ctx.index(axes) * step, step).contiguous()


def ring_shift(x: Tensor, ctx, axis: str, method: str = "") -> Tensor:
    """``ppermute`` over the ring j -> j + 1 on ``axis``: the ``x`` of the
    rank one coordinate below this one."""
    n = _size(ctx, axis)
    if n == 1:
        return x
    me = ctx.index(axis)
    method = method or gather_method(x, ctx)
    COUNTS[f"ring_shift:{method}"] += 1
    if method == "slots":
        return _slots(x, ctx, axis)[(me - 1) % n].clone()
    group = ctx.group(axis)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(),
                      dist.get_global_rank(group, (me + 1) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def allgather_matmul_overlapped(x: Tensor, w: Tensor, ctx,
                                axis: str) -> Tensor:
    """x (m_loc, k) is this rank's row shard of the (n m_loc, k)
    activation, w (k, n_out) replicated over ``axis``: the whole (n m_loc,
    n_out) product, block by block as the shards ride the ring."""
    n = _size(ctx, axis)
    me = ctx.index(axis) if n > 1 else 0
    m_loc = x.shape[0]
    out = x.new_zeros((n * m_loc, w.shape[-1]))
    held = x
    for i in range(n):
        src = (me - i) % n          # after i shifts we hold shard me - i
        out[src * m_loc:(src + 1) * m_loc] = held @ w
        if i + 1 < n:
            held = ring_shift(held, ctx, axis)
    return out


def ring_psum_matmul(x: Tensor, w: Tensor, ctx, axis: str) -> Tensor:
    """x (m, k_loc) and w (k_loc, n_out) are matching shards of a
    contraction dim sharded over ``axis``: the whole (m, n_out) sum on
    every rank, the float32 partial riding the ring and taking the local
    partial at each hop."""
    n = _size(ctx, axis)
    partial = (x @ w).to(torch.float32)
    acc = partial
    for _ in range(n - 1):
        acc = ring_shift(acc, ctx, axis) + partial
    return acc.to(x.dtype)
