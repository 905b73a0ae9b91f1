"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` under ``repro_torch/kernels`` is compiled at first use
by ``nvcc`` into its own shared library with a plain C interface (no
PyTorch headers, so a build takes seconds, not minutes) and loaded with
``ctypes``.  All sources build in parallel: one ``nvcc`` per source, all
started together.  Libraries land in ``<checkout>/build/repro_torch/``
under a name that hashes the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.

No ``--use_fast_math``: it changes ``expf``/``tanhf``/``sqrtf`` and
division enough to break the float32 parity tolerance.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildRecord:
    name: str
    path: pathlib.Path
    seconds: float          # nvcc wall time; 0.0 when the library was cached
    log: str                # nvcc/ptxas output (registers, spills)


_lock = threading.Lock()
_records: Dict[str, BuildRecord] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, pathlib.Path]:
    """Kernel sources by name (file stem)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu"))}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(src.parent.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, BuildRecord]:
    """Compile every kernel source that has no current library, all in
    parallel; raise with nvcc's output if any compile fails."""
    with _lock:
        todo = {}
        for name, src in sources().items():
            if name in _records:
                continue
            out = _lib_path(src)
            if out.is_file():
                log = out.with_suffix(".log")
                _records[name] = BuildRecord(
                    name, out, 0.0, log.read_text() if log.is_file() else "")
            else:
                todo[name] = (src, out)
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            exe = nvcc()
            procs = {}
            try:
                for name, (src, out) in todo.items():
                    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                    cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                    procs[name] = (subprocess.Popen(
                        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True), tmp, time.perf_counter())
                for name, (proc, tmp, t0) in procs.items():
                    log, _ = proc.communicate()
                    seconds = time.perf_counter() - t0
                    src, out = todo[name]
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed ({proc.returncode}) on {src}:\n{log}")
                    out.with_suffix(".log").write_text(log)
                    os.replace(tmp, out)
                    _records[name] = BuildRecord(name, out, seconds, log)
            finally:
                for proc, tmp, _ in procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                    if tmp.exists():
                        tmp.unlink()
        return dict(_records)


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first
    use)."""
    lib = _libs.get(name)
    if lib is None:
        records = build_all()
        if name not in records:
            raise KeyError(f"no kernel source {name!r}; have {sorted(records)}")
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(str(records[name].path)))
    return lib
