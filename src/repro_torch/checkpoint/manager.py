"""Atomic, checksummed, keep-k checkpoints in the JAX package's layout
(port of ``repro/checkpoint/manager.py``).

Layout per step: ``<dir>/step_<N:010d>/arrays.npz`` + ``manifest.json``.

* ``arrays.npz`` and the manifest are written into ``step_<N>.tmp`` and
  the directory is published with ``os.replace`` (atomic on POSIX);
* ``manifest.json`` carries the step, the flat key list with shapes and
  dtypes, a crc32 of the npz bytes and JSON ``extra`` state;
* a step is valid iff both files exist and the crc matches, so a crash
  mid-write never leaves a "latest" step that loads corrupt data: the
  readers walk back to the newest valid step.

A tree is a mapping ``{name: array}``, nested mappings flattening to
``a/b/c`` keys as JAX's ``flatten_tree`` names them (tensors are copied
to host numpy on the calling thread; bfloat16 is stored as float32, which
holds it exactly, as JAX stores it).  ``unflatten_into`` rebuilds a
template tree from the flat arrays, each leaf in the template's dtype and
on its device.  The JAX package's ``CheckpointManager`` reads what this
one writes, and the other way round
(``repro_torch.convert.read_jax_checkpoint`` is ``read_checkpoint``).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch


SEP = "/"


def flatten(tree: Mapping[str, Any], prefix: str = ""
            ) -> Dict[str, np.ndarray]:
    """Host numpy copies of a tree's leaves, nested keys joined by
    ``SEP``; bfloat16 tensors become float32 (exact)."""
    flat = {}
    for key, leaf in tree.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            flat.update(flatten(leaf, name + SEP))
            continue
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach()
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()
            flat[name] = leaf.to("cpu", copy=True).numpy()
        else:
            flat[name] = np.array(leaf, copy=True)
    return flat


def unflatten_into(template: Mapping[str, Any],
                   flat: Mapping[str, np.ndarray], prefix: str = ""
                   ) -> Dict[str, Any]:
    """A tree shaped like ``template`` (nested mappings of tensors) from
    ``flat``'s arrays, each leaf cast to the template leaf's dtype and
    placed on its device (port of JAX's ``unflatten_into``)."""
    out: Dict[str, Any] = {}
    for key, leaf in template.items():
        name = f"{prefix}{key}"
        if isinstance(leaf, Mapping):
            out[key] = unflatten_into(leaf, flat, name + SEP)
            continue
        if name not in flat:
            raise KeyError(f"checkpoint missing key {name}")
        arr = np.asarray(flat[name])
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {name}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        out[key] = torch.as_tensor(arr).to(device=leaf.device,
                                           dtype=leaf.dtype, copy=True)
    return out


def _crc32(path: pathlib.Path) -> int:
    """zlib's crc32 of a file, read in 64 MiB pieces."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            piece = f.read(64 << 20)
            if not piece:
                return crc
            crc = zlib.crc32(piece, crc)


def _step_dir(directory: pathlib.Path, step: int) -> pathlib.Path:
    return directory / f"step_{step:010d}"


def all_steps(directory) -> List[int]:
    """Every ``step_<N>`` directory's N, ascending (valid or not)."""
    out = []
    for p in pathlib.Path(directory).iterdir():
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
        crc = _crc32(npz_p)
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or man.get("crc32") != crc:
        return None
    return man


def _latest_valid(directory: pathlib.Path
                  ) -> Tuple[Optional[int], Optional[Dict[str, Any]]]:
    """(step, manifest) of the newest valid step, or (None, None); each
    step's npz is checksummed once."""
    for step in reversed(all_steps(directory)):
        man = _manifest_if_valid(_step_dir(directory, step))
        if man is not None:
            return step, man
    return None, None


def latest_valid_step(directory) -> Optional[int]:
    return _latest_valid(pathlib.Path(directory))[0]


def read_checkpoint(directory, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, np.ndarray], Dict]:
    """``(step, flat arrays, extra)`` of the newest valid step, or of
    ``step``, which must be valid.  numpy alone: no pickles are loaded."""
    directory = pathlib.Path(directory)
    if step is None:
        step, man = _latest_valid(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {directory}")
    else:
        man = _manifest_if_valid(_step_dir(directory, step))
        if man is None:
            raise ValueError(f"checkpoint step {step} is corrupt/missing")
    with np.load(_step_dir(directory, step) / "arrays.npz",
                 allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return step, flat, man.get("extra", {})


class CheckpointManager:
    """Writes and reads one checkpoint directory; saves are asynchronous
    by default, one outstanding at a time (``wait`` joins it)."""

    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.directory.mkdir(parents=True, exist_ok=True)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def latest_valid_step(self) -> Optional[int]:
        self.wait()
        return latest_valid_step(self.directory)

    def wait(self) -> None:
        """Join the outstanding save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def save(self, step: int, tree: Mapping[str, Any],
             extra: Optional[Dict] = None) -> None:
        """Atomic (and by default asynchronous) write of ``tree``."""
        flat = flatten(tree)               # host copy on this thread
        # Freeze extra now: the writer serializes later, and a caller's
        # mutable value (the fit's live history) may have grown by then.
        extra = json.loads(json.dumps(extra or {}))
        self.wait()

        def write():
            d = _step_dir(self.directory, step)
            tmp = d.with_name(d.name + ".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            npz = tmp / "arrays.npz"
            np.savez(npz, **flat)
            manifest = {
                "step": step, "crc32": _crc32(npz),
                "extra": extra,
                "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                         for k, v in flat.items()},
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if d.exists():
                shutil.rmtree(d)
            os.replace(tmp, d)             # atomic publish
            self._gc()

        if not self.async_save:
            write()
            return

        def run():
            try:
                write()
            except BaseException as e:     # reported by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = self.all_steps()
        if self.keep and len(steps) <= self.keep:
            return          # nothing to delete, valid or not: skip the crcs
        valid = [s for s in steps
                 if _manifest_if_valid(_step_dir(self.directory, s))]
        for s in valid[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, np.ndarray], Dict]:
        """``(step, flat arrays, extra)``: the newest valid step when
        ``step`` is None, skipping corrupt ones."""
        self.wait()
        return read_checkpoint(self.directory, step)
