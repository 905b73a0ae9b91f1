"""Parameters declared as spec trees, held in ``nn.Module``s (port of
``repro/nn/module.py`` without its logical sharding axes: the port runs on
one device).

Model code declares its parameters as nested dicts of ``Param`` specs, in
the JAX package's own shapes (``w_q`` stays (d, h, hd)), so carrying
weights across is a re-keying with no transposes.  ``ParamTree`` turns a
spec dict into a module: a ``Param`` becomes an ``nn.Parameter`` (created
without gradients, for serving; ``train.trainable`` turns them on), a
dict a child ``ParamTree``.  ``init_params``
fills every parameter of a module with its spec's initializer, drawn from
a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

Tensor = torch.Tensor
Specs = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Param:
    shape: Tuple[int, ...]
    init: str = "normal"                 # normal | zeros | ones | embed | fan_in
    dtype: Optional[torch.dtype] = None  # None -> the model's param dtype
    scale: float = 1.0


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


class ParamTree(nn.Module):
    """A spec dict as a module: ``Param`` -> parameter, dict -> child."""

    def __init__(self, specs: Specs, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.specs: Dict[str, Param] = {}
        for name, spec in specs.items():
            if isinstance(spec, Param):
                self.specs[name] = spec
                self.register_parameter(name, nn.Parameter(
                    torch.empty(spec.shape, dtype=spec.dtype or dtype,
                                device=device), requires_grad=False))
            elif isinstance(spec, dict):
                self.add_module(name, ParamTree(spec, dtype=dtype,
                                                device=device))
            else:
                raise TypeError(f"unexpected spec {type(spec)} at {name!r}")


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Initialize every ``ParamTree`` parameter under ``module`` in the
    order of its ``state_dict``, on the parameters' own device."""
    for tree in module.modules():
        if isinstance(tree, ParamTree):
            for name, spec in tree.specs.items():
                _initializer(spec, getattr(tree, name), generator)


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
