"""The assigned input shapes and their applicability rules (port of
``repro/configs/shapes.py``): the production dry-run's cells
(``launch/dryrun.py``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | long_decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "long_decode", 524_288, 1),
}

# long_500k needs a sub-quadratic path: SSM (mamba2), hybrid (jamba), or
# mostly-local attention (gemma3: 5/6 of layers use a 1024 ring cache).
# Pure full-attention archs skip it.
_LONG_OK = ("mamba2-780m", "jamba-v0.1-52b", "gemma3-27b")


def applicable(arch_name: str, shape_name: str) -> Tuple[bool, str]:
    if shape_name == "long_500k" and arch_name not in _LONG_OK:
        return False, "full-attention arch: no sub-quadratic path at 500k"
    return True, ""


def rules_kind(shape: ShapeSpec) -> str:
    return {"train": "train", "prefill": "prefill", "decode": "decode",
            "long_decode": "long_decode"}[shape.kind]
