"""Parameters declared as spec trees with logical sharding axes, held in
``nn.Module``s (port of ``repro/nn/module.py``).

Model code declares its parameters as nested dicts of ``Param`` specs, in
the JAX package's own shapes (``w_q`` stays (d, h, hd)) and with its
logical axis names ("embed", "heads", "vocab", ...), so carrying weights
across is a re-keying with no transposes.  A rules table
(``distributed/sharding.py``) maps the logical axes to mesh axes:
``logical_to_pspec`` / ``param_pspecs`` give JAX's ``PartitionSpec``s, as
tuples.

``ParamTree`` turns a spec dict into a module: a ``Param`` becomes an
``nn.Parameter`` (created without gradients, for serving;
``train.trainable`` turns them on), a dict a child ``ParamTree``.  Given a
``MeshCtx`` it allocates each parameter's LOCAL slice, the rank's part of
the spec's layout (``local_index``); without one, the whole parameter.
``init_params`` fills every parameter with its spec's initializer, drawn
from a ``torch.Generator`` in the module's order: a sharded parameter is
drawn whole into a temporary, its slice kept and the rest freed, one
parameter at a time, so a sharded model equals the slices of the
unsharded one from the same seed and the whole model never exists on a
rank.

Dims named "embed" are sharded for storage alone (ZeRO: the rules put
weights' embed dim on the data axes): ``ParamTree.view()`` gathers them
just before use and drops them after; in training the gather's backward
sums the ranks' gradients onto each rank's own slice
(``collectives.all_gather``).  Every other sharded dim is used sharded by
the layer that owns it, with an explicit collective.  ``gather_whole``
puts a slice's parameter back together (checkpoints).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
Specs = Dict[str, Any]

# Logical dims sharded for storage only: gathered before use.
STORAGE_AXES = ("embed",)


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | embed | fan_in
    dtype: Optional[torch.dtype] = None  # None -> the model's param dtype
    scale: float = 1.0
    # One logical axis name per dim (JAX's), None for an unnamed dim.
    logical: Optional[Tuple[Optional[str], ...]] = None
    # The last ``tail`` entries of the last dim are held whole on every
    # rank; the mesh shards the entries before them (mamba's conv over x,
    # then B and C).
    tail: int = 0

    def __post_init__(self):
        if self.logical is not None:
            assert len(self.shape) == len(self.logical), (self.shape,
                                                          self.logical)

    @property
    def names(self) -> Tuple[Optional[str], ...]:
        return self.logical or (None,) * len(self.shape)


def logical_to_pspec(logical: Tuple[Optional[str], ...],
                     rules: Dict[str, Any],
                     shape: Optional[Tuple[int, ...]] = None,
                     axis_sizes: Optional[Dict[str, int]] = None
                     ) -> Tuple[Any, ...]:
    """Map logical axis names to mesh axes (JAX's function; a tuple for
    its ``PartitionSpec``, trailing ``None``s trimmed).

    * never reuses a mesh axis within one spec (the first dim wins),
    * with ``shape`` and ``axis_sizes``: drops an assignment whose dim does
      not divide by the mesh axes' product (granite's one kv head,
      mamba2's 50,280 vocab on 16), which is then replicated."""
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        assign = None
        if name is not None and name in rules:
            cand = rules[name]
            if cand is not None:
                cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
                divisible = True
                if shape is not None and axis_sizes is not None:
                    total = 1
                    for c in cand_t:
                        total *= axis_sizes.get(c, 1)
                    divisible = shape[i] % total == 0
                if divisible and not any(c in used for c in cand_t):
                    assign = cand if isinstance(cand, str) else cand_t
                    used.update(cand_t)
        out.append(assign)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def param_pspecs(specs: Specs, rules: Dict[str, Any],
                 axis_sizes: Optional[Dict[str, int]] = None) -> Specs:
    """The spec of every ``Param`` of a (nested) spec dict, JAX's rule on
    the parameter's shape."""
    out: Dict[str, Any] = {}
    for name, p in specs.items():
        if isinstance(p, Param):
            out[name] = logical_to_pspec(p.names, rules, p.shape, axis_sizes)
        else:
            out[name] = param_pspecs(p, rules, axis_sizes)
    return out


# ---------------------------------------------------------------------------
# A rank's slice of a parameter.
# ---------------------------------------------------------------------------

def _sharded(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


def layout(p: Param, ctx) -> Tuple[Any, ...]:
    """The spec that lays out this rank's slice of ``p``: JAX's rule on
    ``p``'s shape, the last dim ruled on its sharded part when it has a
    whole tail."""
    if not _sharded(ctx):
        return ()
    shape = list(p.shape)
    if p.tail:
        shape[-1] -= p.tail
    return ctx.pspec(*p.names, shape=tuple(shape))


def local_index(p: Param, ctx) -> Tuple[Any, ...]:
    """Per dim, this rank's entries of ``p``: a ``(start, stop)`` range,
    or for a last dim with a whole tail, a ``(start, stop, tail)``
    triple (the range of the sharded part, then the tail)."""
    if not _sharded(ctx):
        return tuple((0, n) for n in p.shape)
    shape = list(p.shape)
    if p.tail:
        shape[-1] -= p.tail
    ranges = list(ctx.local_slice(tuple(shape), layout(p, ctx)))
    if p.tail:
        ranges[-1] = ranges[-1] + (p.tail,)
    return tuple(ranges)


def local_shape(p: Param, ctx) -> Tuple[int, ...]:
    return tuple((r[1] - r[0]) + (r[2] if len(r) == 3 else 0)
                 for r in local_index(p, ctx))


def take_local(full: Tensor, p: Param, ctx) -> Tensor:
    """This rank's slice of the whole parameter ``full``."""
    out = full
    for dim, r in enumerate(local_index(p, ctx)):
        part = out.narrow(dim, r[0], r[1] - r[0])
        if len(r) == 3:
            part = torch.cat([part, out.narrow(dim, out.shape[dim] - r[2],
                                               r[2])], dim=dim)
        out = part
    return out


def _storage_dims(p: Param, ctx):
    """(dim, mesh axes) of the dims of ``p`` sharded for storage alone."""
    spec = layout(p, ctx)
    out = []
    for dim, name in enumerate(p.names):
        entry = spec[dim] if dim < len(spec) else None
        if name in STORAGE_AXES and entry is not None and ctx.size(entry) > 1:
            out.append((dim, entry))
    return out


def gather_storage(t: Tensor, p: Param, ctx) -> Tensor:
    """``t`` (this rank's slice of ``p``) with its storage-sharded dims
    gathered whole."""
    from repro_torch.distributed import collectives
    for dim, axes in _storage_dims(p, ctx):
        t = collectives.all_gather(t, ctx, axes, dim=dim)
    return t


def gather_whole(t: Tensor, p: Param, ctx) -> Tensor:
    """The whole parameter ``p`` from every rank's slice ``t`` (each rank
    calls it): every split dim gathered over its axes, a whole tail put
    back after the gathered part.  No gradient."""
    from repro_torch.distributed import collectives
    if not _sharded(ctx):
        return t
    spec = layout(p, ctx)
    t = t.detach()
    last = len(p.shape) - 1
    for dim, entry in enumerate(spec):
        if entry is None or ctx.size(entry) == 1:
            continue
        if dim == last and p.tail:
            part = t.narrow(dim, 0, t.shape[dim] - p.tail)
            tail = t.narrow(dim, t.shape[dim] - p.tail, p.tail)
            t = torch.cat([collectives.all_gather(part, ctx, entry, dim=dim),
                           tail], dim=dim)
        else:
            t = collectives.all_gather(t, ctx, entry, dim=dim)
    return t


def split_entries(p: Param, ctx) -> Tuple[Any, ...]:
    """The layout entries (a mesh axis, or a tuple of axes as the data
    axes of a multi-pod mesh) that split some dim of ``p`` over more than
    one rank, in dim order."""
    if not _sharded(ctx):
        return ()
    return tuple(e for e in layout(p, ctx)
                 if e is not None and ctx.size(e) > 1)


def norm_parts(t: Tensor, p: Param, ctx):
    """``t`` (this rank's slice of ``p``) as (entries, part) pairs: each
    part and the layout entries that split it, so that summing a part's
    squares over its entries counts each of ``p``'s entries once (a whole
    tail is split by the entries of the other dims alone)."""
    entries = split_entries(p, ctx)
    if not p.tail or not entries:
        return [(entries, t)]
    spec = layout(p, ctx)
    last = len(p.shape) - 1
    own = spec[last] if last < len(spec) else None
    if own is None or ctx.size(own) == 1:
        return [(entries, t)]
    n = t.shape[last] - p.tail
    return [(entries, t.narrow(last, 0, n)),
            (tuple(e for e in entries if e != own),
             t.narrow(last, n, p.tail))]


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------

class ParamView:
    """A ``ParamTree``'s tensors as the forward uses them: each dim sharded
    for storage gathered, every other dim as the rank holds it, and each
    floating tensor cast to the tree's ``read_dtype`` when it has one."""

    def __init__(self, tree: "ParamTree"):
        self.specs, self.ctx = tree.specs, tree.ctx
        for name, spec in tree.specs.items():
            t = getattr(tree, name)
            if tree.read_dtype is not None and t.is_floating_point():
                t = t.to(tree.read_dtype)
            setattr(self, name, gather_storage(t, spec, tree.ctx))
        for name, child in tree.named_children():
            if isinstance(child, ParamTree):
                setattr(self, name, child.view())


class ParamTree(nn.Module):
    """A spec dict as a module: ``Param`` -> parameter (this rank's slice
    under ``ctx``), dict -> child."""

    def __init__(self, specs: Specs, *, dtype: torch.dtype,
                 device: torch.device, ctx=None):
        super().__init__()
        self.specs: Dict[str, Param] = {}
        self.ctx = ctx
        self.read_dtype: Optional[torch.dtype] = None
        self._gathers = False
        for name, spec in specs.items():
            if isinstance(spec, Param):
                self.specs[name] = spec
                self.register_parameter(name, nn.Parameter(
                    torch.empty(local_shape(spec, ctx),
                                dtype=spec.dtype or dtype, device=device),
                    requires_grad=False))
                self._gathers |= bool(_sharded(ctx)
                                      and _storage_dims(spec, ctx))
            elif isinstance(spec, dict):
                child = ParamTree(spec, dtype=dtype, device=device, ctx=ctx)
                self.add_module(name, child)
                self._gathers |= child._gathers
            else:
                raise TypeError(f"unexpected spec {type(spec)} at {name!r}")

    def view(self):
        """The tree as the forward reads it: itself when no dim below it
        is sharded for storage and nothing is cast on read, else a
        ``ParamView`` of gathered (and cast) tensors, dropped when the
        caller lets it go."""
        cast = self.read_dtype is not None
        return ParamView(self) if self._gathers or cast else self


def cast_on_read(module: nn.Module, dtype: torch.dtype) -> None:
    """Every ``ParamTree`` under ``module`` casts its floating parameters
    to ``dtype`` when read (``view``): weights stored narrower than they
    are computed in (JAX's ``cast_floating`` on a step's parameters, the
    dry-run's float8 weights)."""
    for tree in module.modules():
        if isinstance(tree, ParamTree):
            tree.read_dtype = dtype


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every ``ParamTree`` parameter under ``module`` in the
    order of its ``state_dict``, on the parameters' own device.  A sharded
    parameter is drawn whole and its slice kept, so the draws (and the
    values) are the unsharded model's."""
    for tree in module.modules():
        if isinstance(tree, ParamTree):
            for name, spec in tree.specs.items():
                param = getattr(tree, name)
                if tuple(param.shape) == tuple(spec.shape) or \
                        spec.init in ("zeros", "ones"):
                    _initializer(spec, param, generator)
                    continue
                full = torch.empty(spec.shape, dtype=param.dtype,
                                   device=param.device)
                _initializer(spec, full, generator)
                param.copy_(take_local(full, spec, tree.ctx))
                del full


def _initializer(p: Param, out: Tensor, generator: torch.Generator) -> None:
    """Fill ``out`` in place as ``repro/nn/module.py::_initializer`` draws
    it: a standard normal times the init's std (the draws themselves come
    from torch's generator, not JAX's threefry)."""
    if p.init == "zeros":
        out.zero_()
    elif p.init == "ones":
        out.fill_(1.0)
    elif p.init == "embed":
        out.normal_(0.0, p.scale, generator=generator)
    elif p.init == "fan_in":
        fan_in = p.shape[0] if len(p.shape) >= 1 else 1
        out.normal_(0.0, p.scale / math.sqrt(max(fan_in, 1)),
                    generator=generator)
    elif p.init == "normal":
        out.normal_(0.0, 0.02 * p.scale, generator=generator)
    else:
        raise ValueError(f"unknown init {p.init!r}")


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def held(p, name: str, dim: int) -> Tuple[int, int]:
    """The ``[start, stop)`` of dim ``dim`` of parameter ``name`` that ``p``
    (a ``ParamTree`` or its view) holds on this rank (a dim sharded for
    storage is whole in a view)."""
    return tuple(local_index(p.specs[name], p.ctx)[dim][:2])


def split(p, name: str, dim: int) -> bool:
    """Whether dim ``dim`` of parameter ``name`` is split over ranks."""
    spec = p.specs[name]
    lo, hi = held(p, name, dim)
    whole = spec.shape[dim] - (spec.tail if dim == len(spec.shape) - 1
                               else 0)
    return hi - lo < whole


def axes(p, name: str, dim: int):
    """The mesh axes that split dim ``dim`` of parameter ``name`` on this
    mesh, or ``None``."""
    spec = layout(p.specs[name], p.ctx)
    entry = spec[dim] if dim < len(spec) else None
    return entry if entry is not None and p.ctx.size(entry) > 1 else None
