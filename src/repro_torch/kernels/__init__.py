"""Kernel ops of the port: each TPU kernel of ``repro.kernels`` becomes a
hand-written Hopper kernel (sources under ``<op>/csrc/``, built by
``_build.py``) beside a plain-torch version of the same function.

``impl`` selects the backend of every op:
  * ``"ref"``  — the plain-torch version, on whatever device the tensors
                 are on;
  * ``"cuda"`` — the hand-written kernel; CUDA tensors only, it raises for
                 CPU tensors; on ``meta`` tensors (the production dry-run,
                 ``launch/dryrun.py``) the kernel ops of ``library.py``
                 give their outputs' shapes, the card's routes traced;
  * ``"auto"`` — ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.

``"auto"`` honours the ``REPRO_TORCH_IMPL`` env override (``REPRO_IMPL``
belongs to the JAX package's CI legs).  There is no silent fallback: a
kernel path asked for a gradient raises (``refuse_backward``).
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


def refuse_backward(op: str, *inputs: torch.Tensor) -> None:
    """Raise when the kernel path of ``op`` is asked for a gradient: grad
    mode is on and an input requires grad.  No hand-written kernel has a
    backward (nor has any TPU kernel), and the op never swaps in its plain
    version to get one: train through the model's plain functions
    (``LanguageModel.loss``) or run the kernel under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{op}: the hand-written kernel has no backward kernel, and the "
            "op does not fall back to its plain version for one; train "
            "through the model's plain differentiable path "
            "(LanguageModel.loss) or call it under torch.no_grad()")


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
