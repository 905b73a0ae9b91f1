"""What the benchmark may not load: JAX and the JAX package ``repro``,
compared by whole top-level name (``repro_torch`` is not ``repro``)."""
from __future__ import annotations

import sys
from typing import Iterable, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def top_level(names: Iterable[str]) -> Set[str]:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded() -> Set[str]:
    """The forbidden top-level names that ``sys.modules`` holds now."""
    return top_level(list(sys.modules)) & FORBIDDEN
