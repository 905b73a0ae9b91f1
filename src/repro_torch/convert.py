"""Carry a model trained by the JAX package across to the port.

* ``config_from_jax(fields)`` — a ``DSEKLConfig`` from the JAX config's
  fields (``dataclasses.asdict(jax_cfg)`` or a JSON round trip of it).  The
  JAX backends ``"pallas"`` / ``"pallas_interpret"`` map to ``"auto"``.
* ``state_from_jax(arrays, device)`` — a ``DSEKLState`` from numpy arrays
  under the keys ``alpha``, ``accum``, ``step``, ``epoch``: a JAX
  ``DSEKLState`` via ``np.asarray`` of its fields, or a checkpoint's flat
  dict.
* ``read_jax_checkpoint(directory, step=None)`` — reads the JAX checkpoint
  layout ``step_<N>/arrays.npz`` + ``manifest.json`` with numpy alone.  A
  step is valid only if both files exist and the npz's crc32 matches the
  manifest; with ``step=None`` the newest valid step is read and corrupt
  ones are skipped.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.dsekl import DSEKLConfig, DSEKLState
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


def state_from_jax(arrays: Mapping[str, Any],
                   device: DeviceLike = None) -> DSEKLState:
    dev = resolve_device(device)

    def vec(key):
        return torch.tensor(np.asarray(arrays[key]), dtype=torch.float32,
                            device=dev)

    def scalar(key):
        return torch.tensor(int(np.asarray(arrays[key])), dtype=torch.int32,
                            device=dev)

    return DSEKLState(alpha=vec("alpha"), accum=vec("accum"),
                      step=scalar("step"), epoch=scalar("epoch"))


def _step_dir(directory: pathlib.Path, step: int) -> pathlib.Path:
    return directory / f"step_{step:010d}"


def _steps(directory: pathlib.Path):
    out = []
    for p in directory.iterdir():
        name = p.name
        if name.startswith("step_") and name[5:].isdigit():
            out.append(int(name[5:]))
    return sorted(out)


def _manifest_if_valid(d: pathlib.Path) -> Optional[Dict[str, Any]]:
    man_p, npz_p = d / "manifest.json", d / "arrays.npz"
    if not (man_p.is_file() and npz_p.is_file()):
        return None
    try:
        man = json.loads(man_p.read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or man.get("crc32") != zlib.crc32(
            npz_p.read_bytes()):
        return None
    return man


def read_jax_checkpoint(directory, step: Optional[int] = None
                        ) -> Tuple[int, Dict[str, np.ndarray], Dict]:
    """Returns ``(step, flat arrays, extra)`` of the newest valid step (or
    of ``step``, which must be valid)."""
    directory = pathlib.Path(directory)
    if step is None:
        for s in reversed(_steps(directory)):
            man = _manifest_if_valid(_step_dir(directory, s))
            if man is not None:
                step = s
                break
        else:
            raise FileNotFoundError(f"no valid checkpoint in {directory}")
    else:
        man = _manifest_if_valid(_step_dir(directory, step))
        if man is None:
            raise ValueError(f"checkpoint step {step} is corrupt/missing")
    npz = _step_dir(directory, step) / "arrays.npz"
    with np.load(npz, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return step, flat, man.get("extra", {})
