"""Kernel ops of the port: each TPU kernel of ``repro.kernels`` becomes a
hand-written Hopper kernel (sources under ``<op>/csrc/``, built by
``_build.py``) beside a plain-torch version of the same function.

``impl`` selects the backend of every op:
  * ``"ref"``  — the plain-torch version, on whatever device the tensors
                 are on;
  * ``"cuda"`` — the hand-written kernel; CUDA tensors only, it raises for
                 CPU tensors;
  * ``"auto"`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.

``"auto"`` honours the ``REPRO_TORCH_IMPL`` env override (``REPRO_IMPL``
belongs to the JAX package's CI legs).  There is no silent fallback.
"""
from __future__ import annotations

import contextlib
import os

import torch

IMPLS = ("auto", "ref", "cuda")
ENV_IMPL = "REPRO_TORCH_IMPL"


def resolve_backend(impl: str, device: torch.device) -> str:
    """Resolve ``impl`` to the backend that will run for tensors on
    ``device``: ``"ref"`` or ``"cuda"``."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} is not one of {IMPLS}")
    if impl == "auto":
        impl = os.environ.get(ENV_IMPL, "auto") or "auto"
        if impl not in IMPLS:
            raise ValueError(f"{ENV_IMPL}={impl!r} is not one of {IMPLS}")
    if impl == "auto":
        impl = "cuda" if torch.device(device).type == "cuda" else "ref"
    return impl


@contextlib.contextmanager
def full_fp32_matmul():
    """float32 products in full float32 (no TF32) inside the block, on any
    device: TF32 keeps ~3 decimal digits.  The process's
    ``torch.backends.cuda.matmul.allow_tf32`` is restored on the way out."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
