"""The hand-written kernels as ``torch.library`` ops, so that a trace sees
them (the production dry-run, ``launch/dryrun.py``).

Each kernel's CUDA entry (``flash_attention_cuda``, ``ssd_cuda``,
``kernel_matvec_cuda``, ``kernel_vecmat_cuda``) calls its op of the
``repro_torch`` namespace, defined here with the low-level
``torch.library.Library`` API (``define`` + ``impl``: about a
microsecond and a half of dispatch a call on a CPU, where
``torch.library.custom_op`` costs some twelve):

  * ``"CUDA"``: the kernel module's body, today's: its checks (the
    alignment checks on ``data_ptr`` among them), the route from its pure
    route table, the launch and the launch counters;
  * ``"CPU"``: the same body, which refuses a CPU tensor with the
    module's own message (the kernels take CUDA tensors only);
  * ``"Meta"``: the output shapes and dtypes, no launch (a fake or meta
    tensor never reaches a ``data_ptr``);
  * a FLOP formula (``torch.utils.flop_counter``) equal to the count
    ``FlopCounterMode`` gives the op's plain version.

``ROUTE`` maps each op to the route its CUDA body would take for the
given arguments (the module's route table), so a trace can count
launches by op and route as the card's ``launches_by_route`` does.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")
ROUTE: Dict[str, Callable[..., str]] = {}


def define(schema: str, body: Callable, meta: Callable, flops: Callable,
           route: Callable[..., str]) -> Callable:
    """Define op ``schema`` (``"name(args) -> outputs"``) with ``body`` on
    CUDA and CPU tensors, ``meta`` on meta ones, the FLOP formula
    ``flops(*shapes, out_shape=...)`` and the route of a call
    ``route(*args)``; returns the op."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, body, "CUDA")
    LIB.impl(name, body, "CPU")
    LIB.impl(name, meta, "Meta")
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(op)(flops)
    ROUTE[name] = route
    return op
