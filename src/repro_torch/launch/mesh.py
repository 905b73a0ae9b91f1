"""Meshes over a ``torch.distributed`` world (port of
``repro/launch/mesh.py``).

The JAX package runs one controller over the devices of a ``jax`` mesh;
the port runs one PROCESS per mesh coordinate, SPMD: ``make_local_mesh``
lays a 2-D ``DeviceMesh`` named ``("data", "model")`` over an
initialised world of ``data * model`` ranks, and every rank learns its
coordinate (d, m), its two axis groups and its device from it.

Backends are chosen by the caller and never switched behind its back:

  * ``nccl`` — one rank per card; refused, with this module's own message
    and before NCCL itself fails, when the ranks on this host outnumber
    its cards or the device is the CPU;
  * ``gloo`` — the CPU (the tests), and several ranks sharing one card
    (gloo stages a CUDA ``all_reduce`` / ``broadcast`` through the host).

The world comes from ``torch.distributed.run``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) when it sets
one, is used as it stands when the caller initialised it, and otherwise
(``data * model == 1`` only) is a world of one that this module starts
and ``LocalMesh.close()`` tears down again, so a fit in the calling
process leaves no default group behind.  ``spawn_world`` runs a function
on a local world of N processes (``init_method=file://``, a wall-clock
limit, every rank's traceback reported): how the tests drive a mesh on
the CPU.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import queue as queue_lib
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

MESH_AXES = ("data", "model")
BACKENDS = ("nccl", "gloo")
# Seconds a collective may wait for its peers before the group raises.
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass
class LocalMesh:
    """This rank's view of a mesh: the ``DeviceMesh``, the rank's device
    and backend, and whether this module started the world (then
    ``close()`` destroys it).  The mesh's shape, axis names and this
    rank's coordinate are read from the ``DeviceMesh`` once, when the
    mesh is made, and kept as Python ints: nothing reads the mesh's
    tensor afterwards (under a fake-tensor trace it could not be read).
    ``static`` makes a mesh with no world: shapes and coordinates only
    (layouts and byte counts), no groups."""
    device_mesh: Any
    device: torch.device
    backend: str
    owns_world: bool = False
    dims: Tuple[int, ...] = ()
    names: Tuple[str, ...] = ()
    coord: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.device_mesh is not None and not self.dims:
            dm = self.device_mesh
            self.dims = tuple(int(n) for n in dm.mesh.shape)
            self.names = tuple(dm.mesh_dim_names)
            self.coord = tuple(int(c) for c in dm.get_coordinate())

    @staticmethod
    def static(shape: Sequence[int], names: Sequence[str],
               coord: Optional[Sequence[int]] = None,
               device="meta", backend: str = "nccl") -> "LocalMesh":
        return LocalMesh(None, torch.device(device), backend,
                         dims=tuple(shape), names=tuple(names),
                         coord=tuple(coord or (0,) * len(shape)))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.names

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dims

    def size(self, axis: str) -> int:
        return self.dims[self.names.index(axis)]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (JAX's ``axis_index``)."""
        return self.coord[self.names.index(axis)]

    @property
    def coordinate(self) -> Tuple[int, ...]:
        return self.coord

    def group(self, axis: str):
        """The process group of the ranks that differ from this one only
        on ``axis``."""
        if self.device_mesh is None:
            raise RuntimeError("a static mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def group_over(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        on ``axes`` (several axes: one group spanning them all, made here
        by ``new_group``, which every rank of the world must call in
        step)."""
        axes = tuple(axes)
        if len(axes) == 1:
            return self.group(axes[0])
        names = self.axis_names
        ranks = torch.arange(math.prod(self.dims)).reshape(self.dims)
        keep = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in keep]
        rows = ranks.permute(*rest, *keep).reshape(
            -1, math.prod(self.size(a) for a in axes))
        mine = None
        for row in rows.tolist():
            g = dist.new_group(row)
            if self.rank in row:
                mine = g
        return mine

    @property
    def rank(self) -> int:
        if self.device_mesh is None:
            return sum(c * math.prod(self.dims[i + 1:])
                       for i, c in enumerate(self.coord))
        return dist.get_rank()

    def close(self) -> None:
        """Destroy the world if this module started it (idempotent)."""
        if self.owns_world and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_world = False


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def world_size() -> int:
    """The world's size: the initialised group's, else
    ``torch.distributed.run``'s ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return _env_int("WORLD_SIZE", 1)


def pick_backend(backend: Optional[str], device) -> str:
    """``backend`` when given, else nccl for a CUDA device and gloo for
    the CPU (the launchers' ``--dist-backend`` default)."""
    return backend or ("nccl" if torch.device(device).type == "cuda"
                       else "gloo")


def check_backend(backend: str, device, world_size: int,
                  local_world_size: Optional[int] = None) -> None:
    """Refuse a backend that cannot serve this world: ``nccl`` on the CPU,
    or ``nccl`` with more ranks on this host than cards (NCCL cannot put
    two ranks on one device; use ``gloo`` there)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend != "nccl":
        return
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("backend 'nccl' runs on CUDA devices only; the "
                         "CPU takes backend 'gloo'")
    on_host = local_world_size if local_world_size else world_size
    cards = torch.cuda.device_count()
    if on_host > cards:
        raise ValueError(
            f"backend 'nccl' with {on_host} ranks on a host of {cards} "
            f"card(s): NCCL cannot run two ranks on one device; pass "
            "backend 'gloo' to share a card between ranks")


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: ``cuda:(local_rank % device_count)`` or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or "
                         "'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_world(backend: str, device, *, timeout_s: float = DEFAULT_TIMEOUT_S
               ) -> bool:
    """Start the default group from ``torch.distributed.run``'s
    environment, or a world of one when there is none; False when a world
    is already up (it is left as it is)."""
    if dist.is_initialized():
        return False
    world = _env_int("WORLD_SIZE", 1)
    check_backend(backend, device, world, _env_int("LOCAL_WORLD_SIZE", 0))
    kw = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if backend == "nccl":               # NCCL binds the rank to its card
        kw["device_id"] = rank_device(device, _env_int("LOCAL_RANK", 0))
    if "MASTER_ADDR" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        if world != 1:
            raise RuntimeError(
                f"WORLD_SIZE={world} but no MASTER_ADDR / RANK: launch the "
                "ranks with python -m torch.distributed.run")
        fd, path = tempfile.mkstemp(prefix="repro_torch_world_")
        os.close(fd)
        os.unlink(path)
        dist.init_process_group(backend, init_method=f"file://{path}",
                                rank=0, world_size=1, **kw)
    return True


def _build(shape: Sequence[int], names: Sequence[str], backend: str,
           device, timeout_s: float) -> LocalMesh:
    n = math.prod(shape)
    owns = init_world(backend, device, timeout_s=timeout_s)
    try:
        have = dist.get_backend()
        if have != backend:
            raise ValueError(f"the world runs backend {have!r}, but "
                             f"{backend!r} was asked for; the mesh does not "
                             "switch backends")
        world = dist.get_world_size()
        if world != n:
            raise ValueError(f"a {tuple(shape)} mesh needs a world of {n} "
                             f"ranks; this one has {world}")
        check_backend(backend, device, world,
                      _env_int("LOCAL_WORLD_SIZE", 0))
        dev = rank_device(device, _env_int("LOCAL_RANK", dist.get_rank()))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        from torch.distributed.device_mesh import DeviceMesh
        # The DeviceMesh's type picks its groups' backend: "cpu" keeps
        # gloo (which also reduces CUDA tensors), "cuda" NCCL.
        dm = DeviceMesh("cuda" if backend == "nccl" else "cpu",
                        torch.arange(n).reshape(tuple(shape)),
                        mesh_dim_names=tuple(names))
    except BaseException:
        if owns:
            dist.destroy_process_group()
        raise
    return LocalMesh(dm, dev, backend, owns)


def make_local_mesh(data: int = 1, model: int = 1, *, backend: str = "gloo",
                    device="cpu", timeout_s: float = DEFAULT_TIMEOUT_S
                    ) -> LocalMesh:
    """A ``(data, model)`` mesh named ``("data", "model")`` over the world
    of ``data * model`` ranks (see the module docstring for where the
    world comes from); this rank's device is ``cuda:(local_rank %
    device_count)`` or ``cpu``."""
    return _build((data, model), MESH_AXES, backend, device, timeout_s)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The JAX package's production mesh: (16, 16) ``data, model`` on one
    pod, (2, 16, 16) ``pod, data, model`` across two."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), MESH_AXES


def make_fake_mesh(shape: Sequence[int], names: Sequence[str], *,
                   rank: int = 0) -> LocalMesh:
    """A mesh of ``shape`` over a world of ``prod(shape)`` ranks of the
    ``"fake"`` backend (``torch.testing``'s ``FakeStore``: every
    collective returns at once and moves nothing), this process being
    ``rank``: the dry-run's counterpart of JAX's
    ``--xla_force_host_platform_device_count``.  Tensors live on the
    ``meta`` device.  The mesh says backend ``"nccl"``, so the collectives
    take the branches the cards would take.  This call starts the world
    (there must be none) and ``close()`` destroys it."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("make_fake_mesh: a process group is already up; "
                           "a fake world needs a process of its own")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        dm = DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                        mesh_dim_names=tuple(names))
    except BaseException:
        dist.destroy_process_group()
        raise
    return LocalMesh(dm, torch.device("meta"), "nccl", owns_world=True)


def make_production_mesh(multi_pod: bool = False, *, backend: str = "nccl",
                         device="cuda",
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> LocalMesh:
    """The JAX package's production shapes (``production_shape``) over the
    world.  Raises, naming the world size it needs, when the world is
    smaller."""
    shape, names = production_shape(multi_pod)
    need = math.prod(shape)
    have = world_size()
    if have < need:
        raise ValueError(f"the production mesh {shape} ({', '.join(names)}) "
                         f"needs a world of {need} ranks; this one has "
                         f"{have}")
    return _build(shape, names, backend, device, timeout_s)


# ---------------------------------------------------------------------------
# A local world of N processes.
# ---------------------------------------------------------------------------

def _rank_main(fn: Callable, rank: int, world: int, init_file: str,
               backend: str, timeout_s: float, args: tuple, out) -> None:
    try:
        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


def spawn_world(fn: Callable, world_size: int, args: tuple = (), *,
                backend: str = "gloo", timeout_s: float = 120.0,
                workdir: Optional[str] = None) -> Dict[int, Any]:
    """Run ``fn(rank, *args)`` in each of ``world_size`` fresh processes
    joined in one default group (``init_method=file://`` under
    ``workdir``, one torch thread each); returns ``{rank: result}``.
    ``fn`` must be importable by name, and its result picklable.  A rank's
    exception is raised here with its traceback; past ``timeout_s``
    seconds every process still alive is killed and ``TimeoutError``
    raised, so a dead peer cannot hang the caller."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    workdir = workdir or tempfile.mkdtemp(prefix="repro_torch_world_")
    init_file = os.path.join(workdir, f"init_{os.getpid()}_{time.time_ns()}")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, init_file, backend,
                               timeout_s, args, out), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors = []
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) + len(errors) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"a world of {world_size} ranks did not finish within "
                    f"{timeout_s} s; {sorted(results)} reported")
            try:
                rank, ok, value = out.get(timeout=min(left, 1.0))
            except queue_lib.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results]
                if dead and not errors:
                    # A rank that died without reporting (a signal): the
                    # others would wait on it until their timeout.
                    raise RuntimeError(f"rank(s) {dead} exited with codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                continue
            if ok:
                results[rank] = value
            else:
                errors.append((rank, value))
                break
        if errors:
            rank, tb = errors[0]
            raise RuntimeError(f"rank {rank} of {world_size} failed:\n{tb}")
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors else 0.5)
            if p.is_alive():
                p.kill()
                p.join()
    return results
