"""Carry a model trained by the JAX package across to the port.

* ``config_from_jax(fields)`` — a ``DSEKLConfig`` from the JAX config's
  fields (``dataclasses.asdict(jax_cfg)`` or a JSON round trip of it).  The
  JAX backends ``"pallas"`` / ``"pallas_interpret"`` map to ``"auto"``.
* ``state_from_jax(arrays, device)`` — a ``DSEKLState`` from numpy arrays
  under the keys ``alpha``, ``accum``, ``step``, ``epoch``: a JAX
  ``DSEKLState`` via ``np.asarray`` of its fields, or a checkpoint's flat
  dict.
* ``mesh_state_from_jax(arrays, mesh)`` — this rank's shards of a JAX
  ``ShardedDSEKLState`` (its global alpha, accum and step as numpy, or a
  checkpoint's flat dict with an ``epoch``): the alpha / accum rows of the
  rank's model shard and the step, on the rank's device.
* ``preconditioner_from_jax(pre_or_extra)`` — the port's
  ``EigenProPreconditioner`` from a JAX ``EigenProPreconditioner`` or from
  its ``to_extra()`` dict, as a JAX checkpoint stores it under
  ``extra["precond"]``: the same arrays, bit for bit.
* ``rks_from_jax(model, device)`` / ``emp_fix_from_jax(model, device)`` /
  ``kpca_state_from_jax(state, device)`` — the port's ``RKSModel``,
  ``EmpFixModel`` and ``KPCAState`` from the JAX ones (any object with
  their fields, ``np.asarray``-able): the same features, landmarks and
  subspace, bit for bit.
* ``online_state_from_jax(tree, extra)`` — the flat arrays and ``extra``
  of a port ``OnlineService`` checkpoint (its resume closure) from a JAX
  online checkpoint's: alpha, accum, step, epoch and the frozen snapshot's
  rows bit for bit, the snapshot's high-water mark, the version and the
  publish log.  The JAX key is dropped: the generator (or ``plan_fn``) is
  the caller's.  Save the pair with ``CheckpointManager`` and resume the
  service from it.
* ``read_jax_checkpoint(directory, step=None)`` — reads the JAX checkpoint
  layout ``step_<N>/arrays.npz`` + ``manifest.json`` with numpy alone.  A
  step is valid only if both files exist and the npz's crc32 matches the
  manifest; with ``step=None`` the newest valid step is read and corrupt
  ones are skipped.
* ``lm_params_from_jax(cfg, params)`` — the ``state_dict`` of the port's
  ``LanguageModel`` from the JAX LM's param tree (nested dicts of arrays,
  ``np.asarray``-able): parameters keep their shapes, and the period stack
  ``stack/scan/pos{i}`` (leading axis = period index ``p``) is unstacked
  into ``layers.{p * period + i}``, the remainder ``stack/rem/pos{i}``
  following as ``layers.{n_periods * period + i}``; whisper's encoder
  stack ``encoder/scan`` (leading axis = encoder layer) likewise into
  ``encoder.layers.{i}``, beside ``encoder.ln_f``.  bfloat16 arrays
  (``ml_dtypes``) become bfloat16 tensors.  With ``ctx`` (a
  ``MeshCtx``) each tensor is this rank's slice, cut by the same layout
  as ``LanguageModel(cfg, ctx=ctx)`` allocates (``nn.module.take_local``).
  That covers every leaf of every config (MLA's, cross-attention's and
  whisper's encoder stack included): each is cut by its ``Param`` spec.
* ``lm_opt_state_from_jax(cfg, opt_state, ctx=None)`` — the port's
  optimizer state (``{"count", "m", "v"}`` / ``"g2"``, the moments keyed
  as the ``state_dict``) from JAX's, unstacked as the parameters are and,
  with ``ctx``, this rank's slices of the moments: a JAX AdamW trajectory
  continues in the port, on one device or a mesh.
* ``lm_train_state_from_jax(cfg, params, opt_state, extra)`` — the flat
  arrays and ``extra`` of a port LM training checkpoint (``train_loop``
  resumes from it) from a JAX one: the parameters and the optimizer's
  moments unstacked as ``lm_params_from_jax`` unstacks the parameters,
  ``count``, and ``extra``'s pipeline state and step.  ``nest(flat)``
  turns ``read_jax_checkpoint``'s flat ``a/b/c`` keys back into the
  trees: ``tree = nest(flat)``, then ``tree["params"]`` and
  ``tree["opt"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.manager import read_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.baselines import EmpFixModel, RKSModel
from repro_torch.core.dsekl import DSEKLConfig, DSEKLState
from repro_torch.core.kpca import KPCAState
from repro_torch.core.precond import EigenProPreconditioner
from repro_torch.device import DeviceLike, resolve_device

_IMPL_MAP = {"pallas": "auto", "pallas_interpret": "auto"}


def config_from_jax(fields: Mapping[str, Any]) -> DSEKLConfig:
    """Map the JAX ``DSEKLConfig``'s fields 1:1; raises ``TypeError`` on a
    field the port does not know."""
    known = {f.name for f in dataclasses.fields(DSEKLConfig)}
    unknown = set(fields) - known
    if unknown:
        raise TypeError(f"unknown DSEKLConfig field(s): {sorted(unknown)}")
    kw = dict(fields)
    if "kernel_params" in kw:
        kw["kernel_params"] = tuple((str(k), v) for k, v in kw["kernel_params"])
    if "impl" in kw:
        kw["impl"] = _IMPL_MAP.get(kw["impl"], kw["impl"])
    return DSEKLConfig(**kw)


def _f32(arr, dev: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=torch.float32, device=dev)


def _i32(arr, dev: torch.device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(arr)), dtype=torch.int32, device=dev)


def state_from_jax(arrays: Mapping[str, Any],
                   device: DeviceLike = None) -> DSEKLState:
    dev = resolve_device(device)
    return DSEKLState(alpha=_f32(arrays["alpha"], dev),
                      accum=_f32(arrays["accum"], dev),
                      step=_i32(arrays["step"], dev),
                      epoch=_i32(arrays["epoch"], dev))


def mesh_state_from_jax(arrays: Mapping[str, Any], mesh) -> DSEKLState:
    """This rank's ``DSEKLState`` shards of JAX's global mesh state
    (``epoch`` 0 when the arrays carry none): a model shard of alpha and
    accum, on ``mesh.device``."""
    from repro_torch.core.distributed import state_shard
    dev = mesh.device
    epoch = arrays["epoch"] if "epoch" in arrays else 0
    return DSEKLState(
        alpha=state_shard(mesh, _f32(arrays["alpha"], dev)).clone(),
        accum=state_shard(mesh, _f32(arrays["accum"], dev)).clone(),
        step=_i32(arrays["step"], dev), epoch=_i32(epoch, dev))


def preconditioner_from_jax(pre_or_extra) -> EigenProPreconditioner:
    """A JAX ``EigenProPreconditioner`` (any object with its fields) or its
    ``to_extra()`` dict -> the port's, with the same dtypes and bits."""
    if isinstance(pre_or_extra, Mapping):
        return EigenProPreconditioner.from_extra(pre_or_extra)
    p = pre_or_extra
    return EigenProPreconditioner(
        indices=np.asarray(p.indices, np.int64),
        rows=np.asarray(p.rows, np.float32),
        vectors=np.asarray(p.vectors, np.float32),
        damping=np.asarray(p.damping, np.float32),
        eigenvalues=np.asarray(p.eigenvalues, np.float64),
        n=int(p.n), damping_power=float(p.damping_power),
        safety=float(p.safety))


def rks_from_jax(model, device: DeviceLike = None) -> RKSModel:
    """A JAX ``RKSModel`` -> the port's, on ``device``."""
    dev = resolve_device(device)
    return RKSModel(w_feat=_f32(model.w_feat, dev),
                    b_feat=_f32(model.b_feat, dev),
                    weights=_f32(model.weights, dev),
                    step=_i32(model.step, dev))


def emp_fix_from_jax(model, device: DeviceLike = None) -> EmpFixModel:
    """A JAX ``EmpFixModel`` -> the port's, on ``device``."""
    dev = resolve_device(device)
    return EmpFixModel(landmarks=_f32(model.landmarks, dev),
                       alpha=_f32(model.alpha, dev),
                       step=_i32(model.step, dev))


def kpca_state_from_jax(state, device: DeviceLike = None) -> KPCAState:
    """A JAX ``KPCAState`` -> the port's, on ``device``."""
    dev = resolve_device(device)
    return KPCAState(v=_f32(state.v, dev), step=_i32(state.step, dev))


_ONLINE_LEAVES = {"alpha": np.float32, "accum": np.float32,
                  "step": np.int32, "epoch": np.int32,
                  "snap_x": np.float32, "snap_y": np.float32}


def online_state_from_jax(tree: Mapping[str, Any], extra: Mapping[str, Any]
                          ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(flat, extra)`` of the port's online checkpoint from a JAX one
    (``tree``: the flat arrays, ``np.asarray``-able; ``extra``: its
    ``epoch``, ``version``, ``snapshot_hw`` and ``publish_log``).  The
    arrays keep their bits; ``gen_state`` is empty, so a resumed service
    keeps the generator it was given."""
    flat = {k: np.array(np.asarray(tree[k]), dtype=dt, copy=True)
            for k, dt in _ONLINE_LEAVES.items()}
    flat["gen_state"] = np.zeros((0,), np.uint8)
    out = {"epoch": int(extra["epoch"]), "version": int(extra["version"]),
           "snapshot_hw": int(extra["snapshot_hw"]),
           "publish_log": [dict(r) for r in extra["publish_log"]]}
    return flat, out


def read_jax_checkpoint(directory, step: Optional[int] = None
                        ) -> Tuple[int, Dict[str, np.ndarray], Dict]:
    """Returns ``(step, flat arrays, extra)`` of the newest valid step (or
    of ``step``, which must be valid).  The port's checkpoints share the
    layout, so this is ``checkpoint.read_checkpoint``."""
    return read_checkpoint(directory, step)


def _flat(tree: Mapping[str, Any], prefix: str = ""
          ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flat(val, name + ".")
        else:
            yield name, val


def lm_params_from_jax(cfg: ModelConfig, params: Mapping[str, Any],
                       ctx=None) -> Dict[str, torch.Tensor]:
    """The port's ``LanguageModel`` state_dict (CPU tensors, the arrays'
    own dtypes) from the JAX ``LanguageModel`` param tree; with ``ctx``,
    this rank's slices."""
    out: Dict[str, torch.Tensor] = {}

    def put(name, arr):
        arr = np.array(arr)
        if arr.dtype.name == "bfloat16":     # ml_dtypes: no numpy kind
            out[name] = torch.from_numpy(arr.astype(np.float32)).to(
                torch.bfloat16)
        else:
            out[name] = torch.from_numpy(arr)

    def unstack(sub, prefix, stride=1, offset=0):
        """A stacked subtree: entry p along the leading axis goes to
        ``{prefix}.{p * stride + offset}``."""
        for name, arr in _flat(sub):
            arr = np.asarray(arr)
            for p in range(arr.shape[0]):
                put(f"{prefix}.{p * stride + offset}.{name}", arr[p])

    encoder = dict(params.get("encoder", {}))
    if "scan" in encoder:
        unstack(encoder.pop("scan"), "encoder.layers")
    rest = {k: v for k, v in params.items() if k not in ("stack", "encoder")}
    if encoder:
        rest["encoder"] = encoder
    for name, arr in _flat(rest):
        put(name, arr)
    stack = params.get("stack", {})
    base = cfg.n_periods * cfg.period
    for pos, sub in stack.get("scan", {}).items():
        i = int(pos[len("pos"):])
        unstack(sub, "layers", cfg.period, i)
    for pos, sub in stack.get("rem", {}).items():
        i = int(pos[len("pos"):])
        for name, arr in _flat(sub):
            put(f"layers.{base + i}.{name}", arr)
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.models.model import param_specs
        from repro_torch.nn.module import take_local
        specs = dict(_flat(param_specs(cfg)))
        out = {k: take_local(v, specs[k], ctx).contiguous()
               for k, v in out.items()}
    return out


def lm_opt_state_from_jax(cfg: ModelConfig, opt_state: Mapping[str, Any],
                          ctx=None) -> Dict[str, Any]:
    """The port's optimizer state from JAX's (``count`` and the moment
    trees, CPU tensors in the moments' own dtypes); with ``ctx`` this
    rank's slices of the moments."""
    out: Dict[str, Any] = {}
    for key, val in opt_state.items():
        if key == "count":
            out["count"] = torch.tensor(int(np.asarray(val)),
                                        dtype=torch.int32)
        else:
            out[key] = lm_params_from_jax(cfg, val, ctx=ctx)
    return out


def nest(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """Nested dicts from ``a/b/c`` flat keys (a checkpoint's arrays)."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split(sep)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


def lm_train_state_from_jax(cfg: ModelConfig, params: Mapping[str, Any],
                            opt_state: Mapping[str, Any],
                            extra: Mapping[str, Any]
                            ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``(flat, extra)`` of the port's LM training checkpoint from a JAX
    one: ``params`` and ``opt_state`` the JAX trees (``{"count", "m",
    "v"}`` / ``"g2"``), ``extra`` its ``pipeline`` and ``train_step``.
    Save the pair with ``CheckpointManager.save(step, ...)``-compatible
    keys (``params/<name>``, ``opt/count``, ``opt/<moment>/<name>``) and
    ``train_loop`` resumes from it."""
    flat: Dict[str, np.ndarray] = {}

    def put(prefix, tree):
        for name, t in lm_params_from_jax(cfg, tree).items():
            if t.dtype == torch.bfloat16:
                t = t.float()
            flat[f"{prefix}/{name}"] = t.numpy()

    put("params", params)
    for key, val in opt_state.items():
        if key == "count":
            flat["opt/count"] = np.array(np.asarray(val), dtype=np.int32)
        else:
            put(f"opt/{key}", val)
    out = {"pipeline": {k: int(v) for k, v in extra["pipeline"].items()},
           "train_step": int(extra["train_step"])}
    return flat, out
