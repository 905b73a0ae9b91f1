"""Logical-axis sharding rules and the mesh context (port of
``repro/distributed/sharding.py``).

Model code names *logical* axes ("embed", "heads", "experts", ...) on
every ``Param``; the rules tables here map them onto the mesh axes

    single pod : (data=16, model=16)
    multi-pod  : (pod=2, data=16, model=16)

per shape kind (training / prefill / decode / long-context decode), as the
JAX package's do, entry for entry.  The JAX package places arrays by
those names and lets GSPMD insert the collectives; the port is explicit
tensor parallelism over ``torch.distributed``: each rank holds the slice
of every parameter that the rules' ``PartitionSpec`` gives its mesh
coordinate (``MeshCtx.local_slice``), and the forward calls a collective
(``distributed/collectives.py``) wherever a contraction runs over a
sharded dimension.  So the port's shards are JAX's, dimension by
dimension.

``MeshCtx`` travels through the model stack.  With ``mesh=None``
(``single_device()``) every slice is whole and every collective a no-op.
Over ``("pod", "data")`` the context uses one process group spanning both
axes, made when the context is built (every rank builds it, in step).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.nn.module import logical_to_pspec

LOGICAL_AXES = (
    "batch", "seq", "embed", "heads", "kv_heads", "head_dim", "mlp", "vocab",
    "experts", "expert_mlp", "kv_seq", "kv_lora", "q_lora", "ssm_heads",
    "ssm_state", "frontend_seq", "stack", "conv", "moe_tokens",
)

Axes = Tuple[str, ...]


def make_rules(shape_kind: str, multi_pod: bool = False) -> Dict[str, Any]:
    """Rules table for one shape kind (JAX's, entry for entry).

    shape_kind: "train" | "prefill" | "decode" | "long_decode" | "replicated"
    """
    dp: Tuple[str, ...] = ("pod", "data") if multi_pod else ("data",)
    base: Dict[str, Any] = {
        "batch": dp,
        "seq": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": dp,      # expert FFN dim sharded over data axes
        "kv_seq": None,
        "kv_lora": None,
        "q_lora": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "frontend_seq": None,
        "stack": None,         # JAX's scan-stacked layer dim: never sharded
        "conv": None,
        "moe_tokens": dp,
    }
    if shape_kind == "train":
        # FSDP/ZeRO: weights' embed dim additionally sharded over data axes.
        base["embed"] = dp
    elif shape_kind == "decode":
        # Batch over data; weights stay ZeRO-sharded, gathered per use.
        base["kv_seq"] = None
        base["embed"] = dp
    elif shape_kind == "long_decode":
        # batch=1: nothing to shard over data except the KV sequence.
        base["batch"] = None
        base["moe_tokens"] = None
        base["kv_seq"] = dp
        base["embed"] = dp
    elif shape_kind == "prefill":
        base["embed"] = dp
    elif shape_kind == "replicated":
        return {k: None for k in base}
    return base


def as_axes(entry) -> Axes:
    """A spec entry (``None``, an axis name or a tuple of them) as a
    tuple of axis names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    """The rules and this rank's mesh (a ``launch.mesh.LocalMesh``, or
    ``None`` on one device)."""
    mesh: Any
    rules: Mapping[str, Any]
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # Process groups over several mesh axes, by axes (every rank builds
    # them together in ``for_mesh``).
    groups: Mapping[Axes, Any] = dataclasses.field(default_factory=dict)

    @staticmethod
    def single_device() -> "MeshCtx":
        return MeshCtx(mesh=None, rules={})

    @staticmethod
    def for_mesh(mesh, shape_kind: str,
                 overrides: Optional[Mapping[str, Any]] = None
                 ) -> "MeshCtx":
        """The context of ``mesh`` under ``shape_kind``'s rules, with
        ``overrides`` (logical name -> entry) on top.  A group is built
        for each entry of several axes (every rank, in step)."""
        multi_pod = "pod" in mesh.axis_names
        dp = ("pod", "data") if multi_pod else ("data",)
        rules = make_rules(shape_kind, multi_pod)
        rules.update(overrides or {})
        groups = {}
        static = getattr(mesh, "device_mesh", True) is None  # no world
        for entry in [dp] + sorted({as_axes(e) for e in rules.values()
                                    if len(as_axes(e)) > 1}):
            if len(entry) > 1 and entry not in groups and not static:
                groups[entry] = mesh.group_over(entry)
        return MeshCtx(mesh=mesh, rules=rules, data_axes=dp,
                       model_axis="model", groups=groups)

    # --- sizes and coordinates ------------------------------------------

    @property
    def axis_sizes(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return dict(zip(self.mesh.axis_names, self.mesh.shape))

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (a name or a tuple)."""
        sizes = self.axis_sizes
        return math.prod(sizes.get(a, 1) for a in as_axes(axes))

    def index(self, axes) -> int:
        """This rank's coordinate along ``axes``, the first axis major
        (how a dim sharded over ``("pod", "data")`` is laid out)."""
        if self.mesh is None:
            return 0
        idx = 0
        for a in as_axes(axes):
            idx = idx * self.mesh.size(a) + self.mesh.index(a)
        return idx

    def group(self, axes):
        """The process group of the ranks that differ from this one only
        on ``axes``."""
        axes = as_axes(axes)
        if len(axes) == 1:
            return self.mesh.group(axes[0])
        return self.groups[axes]

    @property
    def n_model(self) -> int:
        return self.size(self.model_axis)

    @property
    def n_data(self) -> int:
        return self.size(self.data_axes)

    @property
    def batch_axes(self) -> Axes:
        """The mesh axes the "batch" rule splits a batch over."""
        return as_axes(dict(self.rules).get("batch"))

    @property
    def n_batch(self) -> int:
        return self.size(self.batch_axes)

    @property
    def sharded(self) -> bool:
        """Whether the mesh has more than one rank."""
        return self.n_model * self.n_data > 1

    def axis_rule(self, name: str):
        return dict(self.rules).get(name)

    # --- specs and slices -----------------------------------------------

    def pspec(self, *names, shape: Optional[Tuple[int, ...]] = None
              ) -> Tuple[Any, ...]:
        """The spec of logical ``names``: a mesh-axis entry (or ``None``)
        a dim, trailing ``None``s trimmed, as JAX's ``PartitionSpec``."""
        return logical_to_pspec(tuple(names), dict(self.rules), shape,
                                self.axis_sizes if shape is not None
                                else None)

    def local_slice(self, shape: Tuple[int, ...], spec: Tuple[Any, ...]
                    ) -> Tuple[Tuple[int, int], ...]:
        """This rank's ``[start, stop)`` in each dim of an array of
        ``shape`` laid out by ``spec``."""
        out = []
        for i, n in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            parts = self.size(entry) if entry is not None else 1
            if n % parts:
                raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                                 f"over {as_axes(entry)} ({parts})")
            step = n // parts
            lo = self.index(entry) * step if entry is not None else 0
            out.append((lo, lo + step))
        return tuple(out)
