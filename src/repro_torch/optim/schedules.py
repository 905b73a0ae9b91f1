"""Learning-rate schedules, pure functions of the step counter (port of
``repro/optim/schedules.py``).

The arithmetic is float32 on 0-d CPU tensors, op for op as ``jnp`` does
it with weakly typed Python constants, so the rates equal JAX's (the
cosine is taken in float64 and rounded, as JAX's float32 cosine reads).  Division
goes through ``torch.div`` on two tensors: ``float / tensor`` in torch is
a reciprocal times the float, which rounds differently.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Tensor = torch.Tensor
NAMES = ("const", "inv_t", "linear", "cosine")


def _f32(v) -> Tensor:
    return torch.tensor(v, dtype=torch.float32)


def make_schedule(name: str, base_lr: float, *, warmup_steps: int = 0,
                  total_steps: int = 0, min_ratio: float = 0.1
                  ) -> Callable[[Union[int, Tensor]], Tensor]:
    """name: const | inv_t (paper Alg. 1) | linear | cosine.  The schedule
    maps a step (an int or an integer tensor) to a 0-d float32 tensor on
    the CPU."""
    if name not in NAMES:
        raise ValueError(f"unknown schedule {name!r}")
    lr0 = _f32(base_lr)

    def sched(step) -> Tensor:
        t = torch.as_tensor(step).detach().to("cpu", torch.float32)
        if name == "const":
            lr = lr0
        elif name == "inv_t":
            lr = torch.div(lr0, torch.clamp(t, min=1.0))
        elif name == "linear":
            frac = 1.0 - torch.div(t, _f32(max(total_steps, 1)))
            lr = lr0 * torch.clamp(frac, min_ratio, 1.0)
        else:
            frac = torch.clamp(torch.div(t, _f32(max(total_steps, 1))),
                               0.0, 1.0)
            # jnp.cos of a float32 rounds as the float64 cosine rounded to
            # float32 does; torch.cos in float32 is off by an ulp at times.
            cos = torch.cos((math.pi * frac).double()).float()
            cos = 0.5 * (1.0 + cos)
            lr = lr0 * (min_ratio + (1.0 - min_ratio) * cos)
        if warmup_steps > 0:
            lr = lr * torch.clamp(torch.div(t, _f32(warmup_steps)), max=1.0)
        return lr

    return sched
