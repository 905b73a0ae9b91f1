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

A tree is a flat ``{name: array}`` mapping (tensors are copied to host
numpy on the calling thread).  The JAX package's ``CheckpointManager``
reads what this one writes, and the other way round
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


def flatten(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Host numpy copies of a flat tree's leaves."""
    flat = {}
    for key, leaf in tree.items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        flat[str(key)] = np.array(leaf, copy=True)
    return flat


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
        crc = zlib.crc32(npz_p.read_bytes())
    except (OSError, ValueError):
        return None
    if not isinstance(man, dict) or man.get("crc32") != crc:
        return None
    return man


def latest_valid_step(directory) -> Optional[int]:
    directory = pathlib.Path(directory)
    for step in reversed(all_steps(directory)):
        if _manifest_if_valid(_step_dir(directory, step)) is not None:
            return step
    return None


def read_checkpoint(directory, step: Optional[int] = None
                    ) -> Tuple[int, Dict[str, np.ndarray], Dict]:
    """``(step, flat arrays, extra)`` of the newest valid step, or of
    ``step``, which must be valid.  numpy alone: no pickles are loaded."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_valid_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint in {directory}")
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
                "step": step, "crc32": zlib.crc32(npz.read_bytes()),
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
        valid = [s for s in self.all_steps()
                 if _manifest_if_valid(_step_dir(self.directory, s))]
        for s in valid[:-self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def restore(self, step: Optional[int] = None
                ) -> Tuple[int, Dict[str, np.ndarray], Dict]:
        """``(step, flat arrays, extra)``: the newest valid step when
        ``step`` is None, skipping corrupt ones."""
        self.wait()
        return read_checkpoint(self.directory, step)
