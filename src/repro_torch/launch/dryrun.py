"""Production-mesh dry-run (port of ``repro/launch/dryrun.py``): every
(arch x shape) cell and the two DSEKL cells traced on the production
meshes, one rank's view of them, and the roofline's inputs read from the
trace.

JAX lowers and compiles each cell for 256 or 512 forced host devices and
reads XLA's cost, memory and HLO analyses.  The port is SPMD by hand, so
its counterpart runs one rank's step: a world of 256 or 512 ranks of
``torch.distributed``'s ``"fake"`` backend (``launch.mesh.
make_fake_mesh``: every collective returns at once), the model built on
the ``meta`` device (shapes and dtypes, no storage) with ``impl="cuda"``,
where the kernels are ``torch.library`` ops whose meta implementations
give their outputs (``kernels/library.py``), and the step run eagerly
under two dispatch modes: ``FlopCounterMode`` and ``_Trace`` (bytes,
kernel calls, live storage).  Rank 0 is traced; every rank's shards have
one shape.  Run one cell a process:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b \\
        --shape train_4k [--multi-pod] [--variant no_zero] [--out DIR]

or the whole sweep (one subprocess a cell, both meshes, resumable):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--jobs 4]

A record keeps JAX's keys, with the port's meaning:

  * ``cost_analysis.flops``: ``FlopCounterMode``'s count over the whole
    step (forward, backward and optimizer in training), every layer
    counted (the eager trace runs them all: JAX's two unrolled probes and
    their extrapolation have no counterpart; ``method`` says
    ``"direct (eager trace)"``); the kernel ops count by their FLOP
    formulas, which equal their plain versions' counts.
  * ``cost_analysis.bytes_accessed``: the sum over every traced op
    (views, allocations and collectives excepted) of its inputs' and
    outputs' bytes: an eager, UNFUSED count, above what a fused program
    moves.  No transcendental count.
  * ``collectives``: by XLA's op names, the count and the bytes of each
    collective's result (``distributed/collectives.py``'s ``BYTES``: an
    all-reduce's tensor, an all-gather's and a reduce-scatter's output,
    what a collective permute sends), and ``total_bytes``.
  * ``memory_analysis`` (a rank's bytes): ``argument_size_in_bytes``
    (parameters, optimizer state, the rank's shard of the batch, the
    cache, the decode position; ``argument_breakdown`` splits it),
    ``output_size_in_bytes`` (every tensor the step returns, aliased ones
    included), ``temp_size_in_bytes`` (the peak of live storage the step
    made, tracked over the trace: its outputs while alive included, the
    arguments not), ``alias_size_in_bytes`` (the outputs that are the
    donated arguments, ``_donate_args``, updated in place).  No
    ``generated_code_size_in_bytes``: an eager program generates no code
    of its own (the hand-written kernels are built once, apart).
  * ``kernels``: the kernel ops the step calls, by op and route (the
    route the card would take, from each kernel's route table).

The DSEKL cells run ``core/distributed.py::make_distributed_step`` on a
(16, 16) or (32, 16) ``data x model`` mesh (JAX folds the pod axis into
data likewise) with a plan of the right shape: the port's step takes the
mesh's sampled indices (``idx_i (n_data, n_grad)``, ``idx_j (n_model,
n_expand)``, int64) where JAX's takes a PRNG key, and its arguments
count them.  Two mamba-2 layouts are the port's own: its conv weights
hold B and C's channels whole on every rank (JAX splits every conv
channel over the model axis), and its decode cache's conv window holds
the rank's heads' channels (JAX's spec replicates the window over the
model axis).  Elsewhere a rank's arguments are JAX's byte for byte
(``tests/test_torch_dryrun.py``).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, applicable, get_config
from repro_torch.configs.shapes import rules_kind
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import MeshCtx
from repro_torch.kernels import library
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import LanguageModel
from repro_torch.nn.module import cast_on_read

Tensor = torch.Tensor

DEFAULT_OUT = "experiments/dryrun_torch"

# Archs whose decode KV cache cannot shard kv_heads 16-way: shard the cache
# sequence over the model axis instead (distributed flash-decode: the
# softmax's reductions over the sharded slots become all-reduces).
_KV_SEQ_OVER_MODEL = {
    "granite-20b", "starcoder2-15b", "internlm2-20b", "whisper-tiny",
    "kimi-k2-1t-a32b", "deepseek-v3-671b", "llama-3.2-vision-11b",
    "jamba-v0.1-52b",
}

# XLA's collective op names, as JAX's records key them.
XLA_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
           "collective-permute")
_XLA_OP = {"psum": "all-reduce", "pmax": "all-reduce",
           "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
           "ring_shift": "collective-permute"}

_NO_TP = {"mlp": None, "ssm_heads": None, "heads": None, "kv_heads": None,
          "vocab": None, "q_lora": None}
_DP256 = dict(_NO_TP, batch=("data", "model"),
              moe_tokens=("data", "model"), embed=("data", "model"))

# Named deltas on top of a cell (JAX's, entry for entry): rules: sharding
# rule overrides; cfg: ModelConfig overrides; step: train-step keywords.
VARIANTS: Dict[str, Dict[str, Any]] = {
    # decode: weights TP-sharded only (no ZeRO gather a step)
    "no_zero": {"rules": {"embed": None}},
    # train: no activation rematerialization
    "no_remat": {"step": {"remat": False}},
    # train: 4 microbatches of gradient accumulation
    "micro4": {"step": {"microbatches": 4}},
    # MoE: capacity factor 1.0
    "cap1": {"cfg": {"capacity_factor": 1.0}},
    # coarser loss chunking
    "loss32": {"step": {"loss_chunks": 32}},
    # decode long-context: the KV cache's slots over the model axis too
    "kvseq_model": {"rules": {"kv_seq": "model"}},
    # serving: float8 weights, cast to the compute dtype on read
    "wf8": {"rules": {"embed": None}, "weights_f8": True},
    # small models: no tensor parallelism (data parallel + ZeRO)
    "no_tp": {"rules": dict(_NO_TP)},
    # ... and the model axis given to the batch (256-way data parallel)
    "dp256": {"rules": dict(_DP256)},
    # dp256 and a halved SSD chunk
    "dp256_c128": {"rules": dict(_DP256), "cfg": {"ssm_chunk": 128}},
}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _nbytes(t: Tensor) -> int:
    return t.numel() * t.element_size()


def tree_bytes(tree) -> int:
    """The bytes of the distinct storages of the tensors in ``tree``."""
    seen: Dict[int, int] = {}
    for t in tree_leaves(tree):
        if isinstance(t, Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def _shard_bytes(ctx: Optional[MeshCtx], names: Sequence[Optional[str]],
                 shape: Tuple[int, ...], dtype: torch.dtype) -> int:
    """A rank's bytes of an array of ``shape`` laid out by logical
    ``names`` (JAX's ``in_shardings`` for an input the port's model is
    given whole and slices itself)."""
    n = math.prod(shape)
    if ctx is not None and ctx.mesh is not None:
        spec = ctx.pspec(*names, shape=tuple(shape))
        n = math.prod(hi - lo for lo, hi in ctx.local_slice(tuple(shape),
                                                              spec))
    return n * torch.empty((), dtype=dtype, device="meta").element_size()


@dataclasses.dataclass
class Cell:
    """A step and its arguments: ``fn(*args)`` runs it; ``arg_bytes`` is
    the rank's argument bytes by kind; ``donate`` the donated argument
    positions; ``meta`` the record's header; ``model`` the LM cell's
    model (its weights are left undrawn: ``model.init`` draws them)."""
    fn: Callable
    args: tuple
    arg_bytes: Dict[str, int]
    donate: Tuple[int, ...]
    meta: Dict[str, Any]
    ctx: Optional[MeshCtx] = None
    model: Optional[LanguageModel] = None


def _donate_args(shape_name: str) -> Tuple[int, ...]:
    """The arguments a cell's step updates in place (JAX donates them)."""
    if shape_name == "train_4k":
        return (0, 1)
    if shape_name in ("decode_32k", "long_500k"):
        return (2,)
    return ()


def cell_rules(arch: str, shape_name: str,
               variant: Optional[str] = None) -> Dict[str, Any]:
    """The rule overrides of a cell: the decode override for the archs of
    ``_KV_SEQ_OVER_MODEL``, then the variant's."""
    out: Dict[str, Any] = {}
    if rules_kind(SHAPES[shape_name]) == "decode" and \
            arch in _KV_SEQ_OVER_MODEL:
        out["kv_seq"] = "model"
    out.update(VARIANTS.get(variant or "", {}).get("rules", {}))
    return out


def build_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool = False,
               n_layers: Optional[int] = None, variant: Optional[str] = None,
               batch: Optional[int] = None, seq_len: Optional[int] = None,
               device="meta") -> Cell:
    """One LM cell on ``mesh`` (a ``LocalMesh`` of a fake world, a static
    one, or None for one device): the model on ``device`` with the
    kernels' backend ``"cuda"`` (on ``meta``: the card's routes, traced),
    its arguments and its step.  ``n_layers``, ``batch`` and ``seq_len``
    cut the cell."""
    from repro_torch.optim import make_optimizer, make_schedule
    from repro_torch.train import make_train_step, param_shards, trainable
    cfg = get_config(arch)
    var = VARIANTS.get(variant or "", {})
    if var.get("cfg"):
        cfg = cfg.replace(**var["cfg"])
    step_kw = dict(var.get("step", {}))
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    shape = SHAPES[shape_name]
    kind = rules_kind(shape)
    ctx = (None if mesh is None else MeshCtx.for_mesh(
        mesh, kind, cell_rules(arch, shape_name, variant)))
    f8 = bool(var.get("weights_f8"))
    model = LanguageModel(cfg, device=device, impl="cuda", ctx=ctx,
                          param_dtype=torch.float8_e4m3fn if f8 else None)
    if f8:
        cast_on_read(model, cfg.cdtype)
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len if seq_len is None else seq_len
    dev = model.device
    meta = {"arch": arch, "shape": shape_name,
            "mesh": mesh_name(multi_pod) if mesh is not None else "1",
            "params": cfg.param_count_estimate(),
            "active_params": cfg.active_param_count_estimate(),
            "variant": variant}
    frontend, fe_bytes = None, 0
    if cfg.n_frontend_tokens:
        fshape = (b, cfg.n_frontend_tokens, cfg.d_model)
        frontend = torch.zeros(fshape, dtype=torch.bfloat16, device=dev)
        fe_bytes = _shard_bytes(ctx, ("batch", "frontend_seq", None),
                                fshape, torch.bfloat16)

    def int_batch(*shape_):
        return torch.zeros(shape_, dtype=torch.int32, device=dev)

    if kind == "train":
        params = trainable(model)
        opt = make_optimizer(
            "adamw", make_schedule("cosine", 3e-4, warmup_steps=100,
                                   total_steps=10_000),
            moment_dtype=torch.bfloat16,
            shards=param_shards(model) if model.sharded else None)
        step = make_train_step(
            model, opt, loss_chunks=step_kw.pop("loss_chunks", 16),
            remat=step_kw.pop("remat", True), **step_kw)
        opt_state = opt.init(params)
        data = {"tokens": int_batch(b, s), "labels": int_batch(b, s)}
        if frontend is not None:
            data["frontend"] = frontend
        meta["tokens"] = b * s
        return Cell(step, (params, opt_state, data), {
            "params": tree_bytes(params), "optimizer": tree_bytes(opt_state),
            "batch": 2 * _shard_bytes(ctx, ("batch", "seq"), (b, s),
                                      torch.int32) + fe_bytes},
            _donate_args(shape_name), meta, ctx, model)

    params = dict(model.named_parameters())
    if kind == "prefill":
        def prefill(params, tokens, frontend=None):
            return model.prefill(tokens, s, frontend)

        args = (params, int_batch(b, s)) + (
            (frontend,) if frontend is not None else ())
        meta["tokens"] = b * s
        return Cell(prefill, args, {
            "params": tree_bytes(params),
            "batch": _shard_bytes(ctx, ("batch", "seq"), (b, s),
                                  torch.int32) + fe_bytes},
            _donate_args(shape_name), meta, ctx, model)

    # decode / long_decode: one new token against a seq_len cache.
    cache = model.init_cache(b, s)
    pos = torch.tensor(s, dtype=torch.int32)      # read on the host

    def decode(params, token, cache, pos):
        return model.decode_step(token, cache, int(pos))

    meta["tokens"] = b
    return Cell(decode, (params, int_batch(b), cache, pos), {
        "params": tree_bytes(params),
        "batch": _shard_bytes(ctx, ("batch",), (b,), torch.int32),
        "cache": tree_bytes(cache), "pos": _nbytes(pos)},
        _donate_args(shape_name), meta, ctx, model)


def dsekl_mesh_shape(multi_pod: bool) -> Tuple[int, int]:
    """The DSEKL step's (data, model) mesh: the pod axis folded into data."""
    return (32 if multi_pod else 16, 16)


def build_dsekl_cell(shape_name: str, mesh, *, multi_pod: bool = False,
                     device="meta", n: Optional[int] = None,
                     d: Optional[int] = None,
                     per_rank: Optional[int] = None) -> Cell:
    """The paper's technique on the production mesh: the distributed
    DSEKL step (2-D redundant sharding, ``core/distributed.py``) on
    ``mesh``, a (data, model) mesh (``dsekl_mesh_shape``).

    dsekl_prod: N = 2^27 synthetic points, D = 128, I = J = 8,192 a rank.
    dsekl_covtype: the paper's covertype setting (N = 581,012 cut to a
    multiple of the ranks, D = 54, I = J = 10,000 over the data shards).
    ``n``, ``d`` and ``per_rank`` change the problem (a card's run)."""
    from repro_torch.core import distributed as dsekl_dist
    from repro_torch.core.dsekl import DSEKLConfig
    n_data, n_model = mesh.size("data"), mesh.size("model")
    if shape_name == "dsekl_prod":
        n0, d0, per = 1 << 27, 128, 8192
        lam = 1e-6
    elif shape_name == "dsekl_covtype":
        n0 = 581_012 // (n_data * n_model) * (n_data * n_model)
        d0, per, lam = 54, max(10_000 // n_data, 64), 1.0 / 581_012
    else:
        raise ValueError(f"unknown DSEKL cell {shape_name!r}")
    n, d = n or n0, d or d0
    per = per_rank or per
    cfg = DSEKLConfig(n_grad=per, n_expand=per, schedule="adagrad", lam=lam,
                      impl="cuda")
    step = dsekl_dist.make_distributed_step(cfg, mesh, n)
    f32 = torch.float32
    x_grad = torch.zeros((n // n_data, d), dtype=f32, device=device)
    y_grad = torch.zeros((n // n_data,), dtype=f32, device=device)
    x_exp = torch.zeros((n // n_model, d), dtype=f32, device=device)
    state = dsekl_dist.ShardedDSEKLState(
        alpha=torch.zeros((n // n_model,), dtype=f32, device=device),
        accum=torch.ones((n // n_model,), dtype=f32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device))
    plan = (torch.zeros((n_data, per), dtype=torch.int64, device=device),
            torch.zeros((n_model, per), dtype=torch.int64, device=device))
    n_chips = n_data * n_model
    meta = {"arch": "dsekl", "shape": shape_name,
            "mesh": mesh_name(multi_pod), "params": n, "active_params": n,
            "tokens": per * n_data, "variant": None,
            # Irreducible DSEKL work: every rank evaluates its own (I x J)
            # kernel block at ~(2D + 4) flops an entry.
            "model_flops_explicit": n_chips * per * per * (2 * d + 4)}
    return Cell(step, (x_grad, y_grad, x_exp, state, plan), {
        "data": tree_bytes((x_grad, y_grad, x_exp)),
        "state": tree_bytes(state), "plan": tree_bytes(plan)},
        (3,), meta)


# ---------------------------------------------------------------------------
# The trace.
# ---------------------------------------------------------------------------

class _Trace(TorchDispatchMode):
    """Counts, over every op that runs under it: the kernel ops by op and
    route, the bytes of each op's inputs and outputs (views, allocations
    and collectives excepted), and the live bytes of the storages the ops
    make (freed when their last tensor dies), with their peak.  Storages
    in ``known`` (the arguments) are not counted."""

    def __init__(self, known: Sequence[Tensor] = ()):
        super().__init__()
        self.kernels: collections.Counter = collections.Counter()
        self.bytes_accessed = 0
        self.live = self.peak = 0
        self._known = {id(t.untyped_storage()) for t in known}
        self._sizes: Dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == library.NAMESPACE:
            name = func._opname
            route = library.ROUTE[name](*args, **kwargs)
            self.kernels[f"{name}:{route}"] += 1
        name = func._opname
        if not (func.is_view or ns == "c10d" or name.startswith(
                ("empty", "new_empty"))):
            self.bytes_accessed += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, Tensor))
        for t in tree_leaves(out):
            if isinstance(t, Tensor):
                self._track(t)
        return out

    def _track(self, t: Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)


def _collective_record(counts: Dict[str, int], nbytes: Dict[str, int]
                       ) -> Dict[str, Any]:
    out: Dict[str, Any] = {op: {"count": 0, "bytes": 0} for op in XLA_OPS}
    for key, c in counts.items():
        op = _XLA_OP[key.split(":")[0]]
        out[op]["count"] += c
        out[op]["bytes"] += nbytes.get(key, 0)
    out["total_bytes"] = sum(out[op]["bytes"] for op in XLA_OPS)
    return out


def trace_cell(cell: Cell) -> Dict[str, Any]:
    """Run ``cell``'s step once under the trace; the record's analyses."""
    known = [t for t in tree_leaves(cell.args) if isinstance(t, Tensor)]
    donated = {id(t.untyped_storage())
               for i in cell.donate for t in tree_leaves(cell.args[i])
               if isinstance(t, Tensor)}
    c0, b0 = dict(collectives.COUNTS), dict(collectives.BYTES)
    trace = _Trace(known)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, trace:
        out = cell.fn(*cell.args)
    seconds = time.perf_counter() - t0
    counts = {k: v - c0.get(k, 0) for k, v in collectives.COUNTS.items()
              if v - c0.get(k, 0)}
    nbytes = {k: v - b0.get(k, 0) for k, v in collectives.BYTES.items()
              if v - b0.get(k, 0)}
    outs = {}
    for t in tree_leaves(out):
        if isinstance(t, Tensor):
            st = t.untyped_storage()
            outs[id(st)] = st.nbytes()
    kernels: Dict[str, Dict[str, int]] = {}
    for key, c in sorted(trace.kernels.items()):
        op, route = key.split(":")
        kernels.setdefault(op, {})[route] = c
    coll = _collective_record(counts, nbytes)
    rec = {
        "seconds_trace": seconds,
        "cost_analysis": {"flops": float(flops.get_total_flops()),
                          "bytes_accessed": float(trace.bytes_accessed)},
        "memory_analysis": {
            "argument_size_in_bytes": sum(cell.arg_bytes.values()),
            "output_size_in_bytes": sum(outs.values()),
            "temp_size_in_bytes": trace.peak,
            "alias_size_in_bytes": sum(v for k, v in outs.items()
                                       if k in donated)},
        "argument_breakdown": dict(cell.arg_bytes),
        "collectives": coll,
        "collective_calls": dict(sorted(counts.items())),
        "kernels": kernels,
    }
    rec["roofline_inputs"] = {
        "flops": rec["cost_analysis"]["flops"],
        "bytes_accessed": rec["cost_analysis"]["bytes_accessed"],
        "collective_bytes": coll["total_bytes"],
        "collectives_by_op": {op: coll[op]["bytes"] for op in XLA_OPS},
        "method": "direct (eager trace)",
    }
    return rec


@contextlib.contextmanager
def fake_world(shape: Sequence[int], names: Sequence[str]):
    """A ``launch.mesh.make_fake_mesh`` for the block, destroyed after."""
    mesh = mesh_lib.make_fake_mesh(shape, names)
    try:
        yield mesh
    finally:
        mesh.close()


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             variant: Optional[str] = None,
             n_layers: Optional[int] = None) -> Dict[str, Any]:
    """Dry-run one cell on a fake world of the production shape (started
    and destroyed here, in this process)."""
    t0 = time.perf_counter()
    if arch == "dsekl":
        with fake_world(dsekl_mesh_shape(multi_pod),
                        mesh_lib.MESH_AXES) as mesh:
            cell = build_dsekl_cell(shape_name, mesh, multi_pod=multi_pod)
            rec = dict(cell.meta)
            rec.update(trace_cell(cell))
    else:
        with fake_world(*mesh_lib.production_shape(multi_pod)) as mesh:
            cell = build_cell(arch, shape_name, mesh, multi_pod=multi_pod,
                              n_layers=n_layers, variant=variant)
            rec = dict(cell.meta)
            if n_layers is not None:
                rec["n_layers"] = n_layers
            rec["rules"] = dict(cell.ctx.rules)
            with torch.no_grad() if SHAPES[shape_name].kind != "train" \
                    else contextlib.nullcontext():
                rec.update(trace_cell(cell))
    mem = rec["memory_analysis"]
    rec["per_rank_bytes"] = (mem["argument_size_in_bytes"]
                             + mem["temp_size_in_bytes"])
    rec["seconds"] = time.perf_counter() - t0
    rec["ok"] = True
    return rec


def cell_path(out_dir: str, arch: str, shape: str, multi_pod: bool,
              variant: Optional[str] = None) -> str:
    suffix = f"__{variant}" if variant else ""
    return os.path.join(out_dir, mesh_name(multi_pod),
                        f"{arch}__{shape}{suffix}.json")


def all_cells():
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            ok, _ = applicable(arch, shape)
            if ok:
                yield arch, shape
    # The paper's technique on the same meshes.
    yield "dsekl", "dsekl_covtype"
    yield "dsekl", "dsekl_prod"


def _cell_cmd(arch: str, shape: str, multi_pod: bool, out: str,
              n_layers: Optional[int] = None) -> list:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", out]
    if multi_pod:
        cmd.append("--multi-pod")
    if n_layers is not None:
        cmd += ["--n-layers", str(n_layers)]
    return cmd


def sweep(out: str, *, force: bool = False, jobs: int = 1,
          timeout: int = 3600) -> list:
    """Every cell on both meshes, one subprocess a cell, ``jobs`` at a
    time; a cell whose record says ok is skipped unless ``force``.
    Returns the failures."""
    todo = []
    for multi_pod in (False, True):
        for arch, shape in all_cells():
            path = cell_path(out, arch, shape, multi_pod)
            if os.path.exists(path) and not force:
                with open(path) as f:
                    if json.load(f).get("ok"):
                        continue
            todo.append((arch, shape, multi_pod))

    def one(cell):
        arch, shape, multi_pod = cell
        print(f"[dryrun] {arch} x {shape} x {mesh_name(multi_pod)}",
              flush=True)
        try:
            r = subprocess.run(_cell_cmd(arch, shape, multi_pod, out),
                               timeout=timeout)
            return None if r.returncode == 0 else cell
        except subprocess.TimeoutExpired:
            return cell

    with concurrent.futures.ThreadPoolExecutor(max(1, jobs)) as pool:
        return [c for c in pool.map(one, todo) if c is not None]


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="named variant: " + ",".join(VARIANTS))
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model's depth (an LM cell)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells run at once")
    ap.add_argument("--timeout", type=int, default=3600)
    args = ap.parse_args(argv)

    if args.all:
        t0 = time.perf_counter()
        failures = sweep(args.out, force=args.force, jobs=args.jobs,
                         timeout=args.timeout)
        print(f"[dryrun] sweep done in {time.perf_counter() - t0:.1f} s; "
              f"{len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    if not args.arch or not args.shape:
        ap.error("--arch and --shape, or --all")
    path = cell_path(args.out, args.arch, args.shape, args.multi_pod,
                     args.variant)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        rec = run_cell(args.arch, args.shape, args.multi_pod,
                       variant=args.variant, n_layers=args.n_layers)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": mesh_name(args.multi_pod), "variant": args.variant,
               "ok": False, "error": traceback.format_exc()}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    if rec.get("ok"):
        print(f"[dryrun] OK {args.arch} x {args.shape} x "
              f"{rec['mesh']}: flops={rec['cost_analysis']['flops']:.3e} "
              f"coll={rec['collectives']['total_bytes']:.3e}B "
              f"per-rank={rec['per_rank_bytes'] / 2 ** 30:.3f}GiB "
              f"trace={rec['seconds_trace']:.1f}s")
        print(json.dumps(rec["memory_analysis"]))
    else:
        print(rec["error"][-2000:], file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
