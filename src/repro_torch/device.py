"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and a missing card raises instead of quietly
carrying on on the CPU.  ``"meta"`` is the production dry-run's target
(``launch/dryrun.py``): shapes and dtypes without storage, never a
default; there a module's ``impl="cuda"`` means "the card's routes,
traced" (the kernel ops' meta implementations).
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if a CUDA device is asked for (or
    defaulted to) and ``torch.cuda.is_available()`` is False.  ``meta``
    is taken when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu' ('meta' for a dry-run)")
    return dev
