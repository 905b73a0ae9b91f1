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
under ``"<op>:<method>"``, with the bytes of its result in ``BYTES``
under the same key (JAX's dry-run convention, ``parse_collectives``:
an all-reduce's tensor, an all-gather's output, a reduce-scatter's
output, what a ring shift sends).  A call built from another collective
is counted once, under its own key (the slot stack under its gather or
shift, the all-reduce form of ``psum_scatter`` under
``"psum_scatter:all_reduce"``).  A slot-stack gather moves n times the
bytes of a native one.

Autograd (training on the mesh).  Where a tensor that needs a gradient
meets a collective, the collective runs as a ``torch.autograd.Function``
whose backward is another collective (counted likewise); elsewhere
(serving, ``no_grad``) it runs as before.  The conventions, per axis:

  * over the MODEL axis a replicated tensor carries the whole gradient on
    every rank (tensor parallelism's): ``psum`` of partial products
    (``psum_product``) is an all-reduce forward and the identity
    backward; ``to_split`` marks a replicated tensor entering this rank's
    split part of a layer (a column-split product's input, or a
    replicated weight used beside split ones), the identity forward and
    an all-reduce backward; ``all_gather(..., grad="slice")`` (the MoE's
    router) gives each rank its slice of the gradient back;
    ``psum(..., grad="psum")``, a sum that the split parts use again (a
    norm's sum of squares over a split width), reduces both ways;
  * over the DATA axes each rank's gradient is its own batch shard's
    share, the step's gradient their sum (then divided by the shards,
    ``train/step.py``): ``all_gather`` (ZeRO's gathers of "embed" dims,
    the MoE's expert batches) is reduced and scattered backward,
    ``psum_scatter`` gathered backward, ``psum(..., grad="psum")`` (the
    MoE's load-balance statistics) summed backward.

The backward sums of bfloat16 or float16 gradients run in float32 and
are rounded once.

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
BYTES: Counter = collections.Counter()


def nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def note(key: str, result: Tensor) -> None:
    """Count one collective under ``key`` and the bytes of ``result``."""
    COUNTS[key] += 1
    BYTES[key] += nbytes(result)


def _size(ctx, axes) -> int:
    if ctx is None or ctx.mesh is None:
        return 1
    return ctx.size(axes)


def gather_method(t: Tensor, ctx) -> str:
    """"native" or "slots" for a gather of ``t`` on ``ctx``'s backend."""
    if ctx.mesh.backend == "nccl" or t.device.type == "cpu":
        return "native"
    return "slots"


def _differentiable(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _all_reduce(x: Tensor, ctx, axes, op=dist.ReduceOp.SUM) -> Tensor:
    """``x`` (contiguous) reduced over ``axes`` in place."""
    dist.all_reduce(x, op=op, group=ctx.group(axes))
    note("psum:all_reduce" if op == dist.ReduceOp.SUM
         else "pmax:all_reduce", x)
    return x


def _wide(g: Tensor) -> Tensor:
    """``g`` as the dtype its sum over ranks is taken in (float32 for the
    16-bit floats)."""
    return g.float() if g.dtype in (torch.bfloat16, torch.float16) else g


def _summed(g: Tensor, ctx, axes) -> Tensor:
    """A gradient summed over ``axes`` (a new tensor, in g's dtype)."""
    return _all_reduce(_wide(g).contiguous().clone(), ctx, axes).to(g.dtype)


class _Psum(torch.autograd.Function):
    """All-reduce forward; the identity, or with ``grad="psum"`` another
    all-reduce, backward."""

    @staticmethod
    def forward(fn, x, ctx, axes, grad):
        fn.mesh_ctx, fn.axes, fn.grad = ctx, axes, grad
        return _all_reduce(x.contiguous().clone(), ctx, axes)

    @staticmethod
    def backward(fn, g):
        if fn.grad == "psum":
            g = _summed(g, fn.mesh_ctx, fn.axes)
        return g, None, None, None


class _ToSplit(torch.autograd.Function):
    """The identity forward; an all-reduce backward."""

    @staticmethod
    def forward(fn, x, ctx, axes):
        fn.mesh_ctx, fn.axes = ctx, axes
        return x.view_as(x)

    @staticmethod
    def backward(fn, g):
        return _summed(g, fn.mesh_ctx, fn.axes), None, None


def psum(x: Tensor, ctx, axes, grad: str = "identity") -> Tensor:
    """``x`` summed over ``axes`` (in place when ``x`` is contiguous and
    needs no gradient).  Backward (module docstring): ``grad="identity"``
    where the sum is replicated from here on (partial products over the
    model axis), ``"psum"`` where each rank's share of it is summed again
    (a sum the split parts reuse; the data axes)."""
    if _size(ctx, axes) == 1:
        return x
    if grad not in ("identity", "psum"):
        raise ValueError(f"psum: grad {grad!r}")
    if _differentiable(x):
        return _Psum.apply(x, ctx, axes, grad)
    return _all_reduce(x.contiguous(), ctx, axes)


def to_split(x: Tensor, ctx, axes) -> Tensor:
    """``x``, replicated over ``axes``, entering this rank's split part of
    a layer: the identity forward, its gradient summed over ``axes``
    backward (each rank's part adds its share).  ``axes`` None, one rank,
    or no gradient: ``x``."""
    if axes is None or _size(ctx, axes) == 1 or not _differentiable(x):
        return x
    return _ToSplit.apply(x, ctx, axes)


def pmax(x: Tensor, ctx, axes) -> Tensor:
    """The elementwise max over ``axes`` (no gradient: a shift)."""
    if _size(ctx, axes) == 1:
        return x
    return _all_reduce(x.detach().contiguous().clone(), ctx, axes,
                       op=dist.ReduceOp.MAX)


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
               method: str = "", grad: str = "scatter") -> Tensor:
    """Tiled all-gather: the ranks' ``x`` concatenated along ``dim`` in
    coordinate order.  ``method`` forces "native" or "slots" (tests).
    Backward: ``grad="scatter"`` sums the ranks' gradients and gives each
    its slice (``psum_scatter``: each rank's use of the gathered tensor is
    its own share), ``"slice"`` takes this rank's slice of its own
    gradient (the gathered tensor's use is replicated)."""
    n = _size(ctx, axes)
    if n == 1:
        return x
    if grad not in ("scatter", "slice"):
        raise ValueError(f"all_gather: grad {grad!r}")
    if _differentiable(x):
        return _AllGather.apply(x, ctx, axes, dim, method, grad)
    return _gather(x, ctx, axes, dim, method)


def _gather(x: Tensor, ctx, axes, dim: int, method: str) -> Tensor:
    n = _size(ctx, axes)
    method = method or gather_method(x, ctx)
    key = f"all_gather:{method}"
    if method == "slots":
        stack = _slots(x, ctx, axes)
        note(key, stack)
        return torch.cat(stack.unbind(0), dim=dim)
    group = ctx.group(axes)
    if ctx.mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        note(key, out)
        return out.movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    out = torch.cat(parts, dim=dim)
    note(key, out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fn, x, ctx, axes, dim, method, grad):
        fn.args = (ctx, axes, dim, grad, x.shape[dim])
        return _gather(x, ctx, axes, dim, method)

    @staticmethod
    def backward(fn, g):
        ctx, axes, dim, grad, n_loc = fn.args
        if grad == "slice":
            out = g.narrow(dim, ctx.index(axes) * n_loc, n_loc)
        else:
            out = _scatter(_wide(g), ctx, axes, dim).to(g.dtype)
        return out, None, None, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(fn, x, ctx, axes, dim):
        fn.args = (ctx, axes, dim)
        return _scatter(x, ctx, axes, dim)

    @staticmethod
    def backward(fn, g):
        ctx, axes, dim = fn.args
        return _gather(g, ctx, axes, dim, ""), None, None, None


def psum_scatter(x: Tensor, ctx, axes, dim: int = 0) -> Tensor:
    """Tiled ``psum_scatter``: ``x`` summed over ``axes``, then this rank's
    1/n of ``dim``.  Backward: the slices' gradients gathered."""
    if _size(ctx, axes) == 1:
        return x
    if _differentiable(x):
        return _PsumScatter.apply(x, ctx, axes, dim)
    return _scatter(x, ctx, axes, dim)


def _scatter(x: Tensor, ctx, axes, dim: int) -> Tensor:
    n = _size(ctx, axes)
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not divide over {n} ranks")
    if ctx.mesh.backend == "nccl":
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, group=ctx.group(axes))
        note("psum_scatter:reduce_scatter", out)
        return out.movedim(0, dim)
    total = x.contiguous().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group(axes))
    step = x.shape[dim] // n
    out = total.narrow(dim, ctx.index(axes) * step, step).contiguous()
    note("psum_scatter:all_reduce", out)
    return out


def ring_shift(x: Tensor, ctx, axis: str, method: str = "") -> Tensor:
    """``ppermute`` over the ring j -> j + 1 on ``axis``: the ``x`` of the
    rank one coordinate below this one."""
    n = _size(ctx, axis)
    if n == 1:
        return x
    me = ctx.index(axis)
    method = method or gather_method(x, ctx)
    note(f"ring_shift:{method}", x)
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
