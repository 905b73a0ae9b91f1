"""Training on the card (port of ``repro/launch/train.py``): a language
model, or (``--dsekl``) the DSEKL kernel machine, in memory or out of core
from a memmap, Algorithm 1 or 2.

LM training (``train_lm``) runs the JAX launcher's recipe on one device:
AdamW over a cosine schedule with ``max(steps // 10, 1)`` warmup steps,
``loss_chunks=4``, the bigram token pipeline with seed 1, the
fault-tolerant loop with checkpoints every ``--ckpt-every`` steps into
``--ckpt-dir`` (``--resume`` continues from its newest valid step), at the
reduced config, or ``--full`` at the config's published widths when
parameters, gradients and float32 moments fit the device:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-20b \
        --steps 100 [--batch 8 --seq 128 --lr 3e-3] [--full] \
        [--ckpt-dir DIR --ckpt-every 25 [--resume]] [--device cpu]

On a mesh (one process a mesh coordinate, the world from
``torch.distributed.run``): ``--data-par`` x ``--model-par`` trains the
config sharded under JAX's ``train`` rules (ZeRO over data, tensor and
expert parallel over model; ``train/step.py``), each rank on its data
shard of the batch (``--full`` with them: the published widths on that
mesh); ``--full`` alone in a world of more than one rank builds the
production mesh, (16, 16) or with ``--multi-pod`` (2, 16, 16), and
raises in a smaller world, naming the world size it needs.  In a world of
one, ``--full`` trains on the one device when parameters, gradients and
float32 moments fit it, and otherwise exits naming the production mesh.
Rank 0 alone prints and writes the checkpoint, in the single-device
format (``train/loop.py``); ``--dist-backend`` is nccl (one rank a card;
the default on cuda) or gloo (the CPU, and ranks sharing a card):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-20b --data-par 2 --model-par 2 \
        [--dist-backend gloo] [--device cpu]

The configs with a frontend (llama-3.2-vision, whisper) are refused: the
launcher, like JAX's, builds no frontend for them to attend over
(``train_step`` takes one in ``batch["frontend"]`` from a caller that has
one, on one device or a mesh).

DSEKL:

Trains the kernel machine with the JAX launcher's configuration (hinge
loss, adagrad, lam = 1e-4) and hold-out (the last ``max(min(2048,
n // 8), 1)`` rows).  ``--data memory`` keeps the covertype stand-in on
the device; ``--data mmap`` writes a synthetic float32 dataset to
``--mmap-dir`` and trains out of core through the hosted data plane: the
rows stay on disk, a prefetch thread stages each step's sampled blocks
(``--no-prefetch`` gathers inline), and only O(n_grad + n_workers *
n_expand) rows a step and the O(N) dual vector reach the device.
``--precondition-k K`` trains with EigenPro (DESIGN.md §10): a rank-K
correction estimated once from a Nystrom subsample of the training data.
``--execution bcd`` runs block coordinate descent rounds instead
(DESIGN.md §14; square loss, exact |J| x |J| block solves, ``--epochs``
rounds of ``--bcd-block`` coordinates streamed in ``--bcd-row-block``-row
tiles), in memory or from the memmap:

    PYTHONPATH=src python -m repro_torch.launch.train --dsekl \
        --n 100000 --dim 54 --epochs 3 [--device cpu] \
        [--data mmap [--mmap-dir DIR] [--no-prefetch]] \
        [--algorithm parallel --workers 4] [--precondition-k 64] \
        [--execution bcd [--bcd-block J] [--bcd-row-block R]] \
        [--checkpoint-dir DIR [--resume]]

``--execution mesh`` trains on a ``--data-par`` x ``--model-par`` mesh of
``torch.distributed`` ranks, one process a coordinate (``core/
distributed.py``), and ``--execution bcd`` with ``--data-par`` x
``--model-par`` > 1 runs the BCD rounds on it.  The world, the rank and the
local rank come from ``torch.distributed.run``'s environment; the train
rows are trimmed to a multiple of lcm(data-par, model-par); rank 0 alone
writes the memmap, prints and checkpoints, and a checkpoint resumes on
another mesh shape that keeps the trimmed row count.  ``--dist-backend``
is nccl (one rank a card) or gloo (the CPU, or ranks sharing one card):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --dsekl \
        --execution mesh --data-par 2 --model-par 2 \
        [--dist-backend gloo] [--data mmap] [--device cpu]

``--precondition-k`` with ``--execution bcd`` is refused: EigenPro
preconditions the stochastic step only.
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile
import time
from typing import Any, Dict

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import DSEKLConfig, fit
from repro_torch.data import BigramPipeline, HostSource, \
    make_memmap_dataset, open_memmap_dataset, split_holdout
from repro_torch.data.synthetic import make_covertype_like
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import LanguageModel
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train import (TrainLoopConfig, make_train_step,
                               param_shards, trainable, train_loop)


def _device_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def lm_state_bytes(cfg, moment_bytes: int = 4) -> int:
    """Bytes of parameters, gradients and AdamW's two moments."""
    p_bytes = torch.finfo(cfg.pdtype).bits // 8
    return cfg.param_count_estimate() * (2 * p_bytes + 2 * moment_bytes)


def lm_ctx(args):
    """The LM run's mesh context under the ``train`` rules, or None (one
    device): ``--data-par`` x ``--model-par`` when more than one (at the
    reduced or, with ``--full``, the published widths), else the
    production mesh for ``--full`` in a world of more than one rank
    (raising in a smaller world)."""
    from repro_torch.distributed.sharding import MeshCtx
    backend = mesh_lib.pick_backend(args.dist_backend,
                                    resolve_device(args.device))
    if args.data_par * args.model_par > 1:
        return MeshCtx.for_mesh(mesh_lib.make_local_mesh(
            args.data_par, args.model_par, backend=backend,
            device=args.device), "train")
    if args.full and mesh_lib.world_size() > 1:
        return MeshCtx.for_mesh(mesh_lib.make_production_mesh(
            args.multi_pod, backend=backend, device=args.device), "train")
    return None


def train_lm(args, ctx=None) -> Dict[str, Any]:
    """Train an LM with the JAX launcher's recipe (module docstring), on
    one device or, with ``ctx`` (``lm_ctx(args)``), SPMD on its mesh.
    Returns the loop's ``history`` (a record a step), the model, its
    config, the optimizer state, the step function, the pipeline (at the
    loop's end), the parameter count (every rank's slices: the model's),
    the checkpoint directory and, on a card, the peak device memory."""
    mesh = ctx.mesh if ctx is not None else None
    device = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = LanguageModel(cfg, device=device, ctx=ctx).init(gen)
    params = trainable(model)
    shards = param_shards(model)
    n_params = sum(math.prod(shards.specs[k].shape) for k in params)
    where = (f" mesh {ctx.n_data} x {ctx.n_model} ({mesh.backend}), "
             f"batch {args.batch} over the data axes" if mesh is not None
             else "")
    _say(mesh, f"[launch] arch={cfg.name} device={device}{where} params="
         f"{n_params / 1e6:.1f}M ({cfg.param_dtype})")
    opt = make_optimizer("adamw", make_schedule(
        "cosine", args.lr, warmup_steps=max(args.steps // 10, 1),
        total_steps=args.steps), shards=shards)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, loss_chunks=4)
    pipe = BigramPipeline(cfg.vocab_size, args.batch, args.seq, seed=1)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_launch_ckpt")
    ckpt = CheckpointManager(ckpt_dir, keep=3)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = train_loop(step_fn, params, opt_state, pipe, ckpt,
                     TrainLoopConfig(n_steps=args.steps,
                                     ckpt_every=args.ckpt_every,
                                     log_every=10),
                     resume=args.resume, device=device, verbose=True,
                     shards=shards)
    losses = [h["loss"] for h in out["history"]]
    if losses:
        _say(mesh, f"[launch] done: loss {losses[0]:.4f} -> "
             f"{losses[-1]:.4f}")
    return {"history": out["history"], "model": model, "cfg": cfg,
            "opt_state": out["opt_state"], "step": step_fn, "pipeline": pipe,
            "n_params": n_params, "ckpt_dir": ckpt_dir, "ctx": ctx,
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None)}


def _mesh_of(args):
    """The run's mesh (None off the mesh): ``--execution mesh``, or
    ``--execution bcd`` over more than one rank."""
    if args.execution == "mesh" or (
            args.execution == "bcd" and args.data_par * args.model_par > 1):
        return mesh_lib.make_local_mesh(
            args.data_par, args.model_par, backend=mesh_lib.pick_backend(
                args.dist_backend, resolve_device(args.device)),
            device=args.device)
    return None


def train_dsekl(args) -> Dict[str, Any]:
    """Train in memory (``--data memory``) or out of core (``--data
    mmap``), on one device or a mesh; returns the fit result, the config,
    the training data (``x`` and ``y`` on the device, or the memmap
    ``source``; on a mesh the trimmed ``source``), the held-out rows on
    the device, the mesh (None off it) and the wall time."""
    mesh = _mesh_of(args)
    try:
        return _train_dsekl(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _say(mesh, *parts) -> None:
    """Print on rank 0 alone (everywhere off the mesh)."""
    if mesh is None or mesh.rank == 0:
        print(*parts)


def _train_dsekl(args, mesh) -> Dict[str, Any]:
    device = resolve_device(args.device) if mesh is None else mesh.device
    cfg = DSEKLConfig(n_grad=args.n_grad, n_expand=args.n_expand,
                      kernel=args.kernel,
                      kernel_params=(("gamma", args.gamma),),
                      lam=1e-4, schedule="adagrad", n_workers=args.workers,
                      impl="auto", precondition_k=args.precondition_k,
                      bcd_block=args.bcd_block,
                      bcd_row_block=args.bcd_row_block)
    if args.execution == "bcd":
        # BCD solves the regularized least-squares system exactly: it has
        # no hinge variant (core/bcd.py; DESIGN.md §14).
        cfg = cfg.replace(loss="square")
        _say(mesh, f"[train-dsekl] block coordinate descent: |J|="
             f"{args.bcd_block or args.n_expand} per round")
    # A hosted, BCD or mesh fit gathers its plans on the host: draw them
    # there, so no epoch plan takes room on the card (every rank of a mesh
    # draws the same plan from the same seed).
    hosted = (args.data == "mmap" or args.execution in ("hosted", "bcd")
              or mesh is not None)
    gen = torch.Generator(device="cpu" if hosted else device)
    gen.manual_seed(args.seed)
    if args.precondition_k:
        _say(mesh, f"[train-dsekl] EigenPro preconditioning: "
             f"top-{args.precondition_k} Nystrom eigensystem")
    ckpt_kw = dict(checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                   checkpoint_every=args.ckpt_every_epochs)
    if args.checkpoint_dir:
        _say(mesh, f"[train-dsekl] checkpoints -> {args.checkpoint_dir} "
             f"(every {args.ckpt_every_epochs} epoch(s)"
             + (", resuming from newest valid" if args.resume else "")
             + ")")
    out: Dict[str, Any] = {"cfg": cfg, "mesh": mesh}
    # The mesh split needs the train rows divisible by both axes.
    shards = (math.lcm(args.data_par, args.model_par) if mesh is not None
              else 1)
    if args.data == "mmap":
        mmap_dir = args.mmap_dir or os.path.join(tempfile.gettempdir(),
                                                 "repro_torch_dsekl_mmap")
        if mesh is None or mesh.rank == 0:
            src = make_memmap_dataset(mmap_dir, args.n, args.dim,
                                      seed=args.seed)
        if mesh is not None:
            import torch.distributed as dist
            dist.barrier()                  # rank 0's dataset is written
            src = open_memmap_dataset(mmap_dir, args.n, args.dim)
        train_src, x_val, y_val = split_holdout(src)
        # Trim the train VIEW's tail (the hold-out came off the end).
        train_src = train_src.local(0, train_src.n - train_src.n % shards)
        # split_holdout copies the held-out rows out of the mapping.
        x_val = torch.from_numpy(x_val).to(device)
        y_val = torch.from_numpy(y_val).to(device)
        if args.execution == "bcd":                # a row tile and x_J
            rows = ((cfg.bcd_row_block or cfg.n_grad)
                    + (cfg.bcd_block or cfg.n_expand))
        else:
            rows = cfg.n_grad + cfg.n_workers * cfg.n_expand
        _say(mesh, f"[train-dsekl] mmap dataset: {args.n} x {args.dim} = "
             f"{src.nbytes / 2**20:.1f} MiB on disk at {mmap_dir}; the "
             f"device sees {4 * rows * args.dim / 2**10:.0f} KiB of rows a "
             f"step + {8 * train_src.n / 2**20:.1f} MiB of state")
        data = (train_src, None)
        out.update(source=train_src, dataset=src)
    else:
        x, y = make_covertype_like(args.n, args.dim, seed=args.seed,
                                   device=device)
        n_val = max(min(2048, args.n // 8), 1)  # never 0: x[:-0] is empty
        x_val, y_val = x[-n_val:], y[-n_val:]
        n_tr = (args.n - n_val) - (args.n - n_val) % shards
        x, y = x[:n_tr].contiguous(), y[:n_tr].contiguous()
        if mesh is not None:
            # Each rank gathers its blocks on the host from its shards.
            src = HostSource(x.cpu().numpy(), y.cpu().numpy())
            data = (src, None)
            out.update(source=src)
        else:
            data = (x, y)
            out.update(x=x, y=y)
    t0 = time.perf_counter()
    res = fit(cfg, *data, gen,
              execution=None if args.execution == "auto" else args.execution,
              algorithm=args.algorithm, n_epochs=args.epochs, tol=0.0,
              x_val=x_val, y_val=y_val, prefetch=not args.no_prefetch,
              verbose=True, device=device, mesh=mesh, **ckpt_kw)
    dt = time.perf_counter() - t0
    if mesh is not None:
        where = (f"mesh data {mesh.size('data')} x model "
                 f"{mesh.size('model')}, {mesh.backend}, rank device "
                 f"{mesh.device}")
    if res.loader is not None:
        ld = res.loader
        hidden = 1.0 - ld["wait_s"] / ld["gather_s"] if ld["gather_s"] else 0.0
        kind = ("bcd rounds" if args.execution == "bcd"
                else "mesh" if args.execution == "mesh"
                else f"hosted, {args.algorithm}")
        if mesh is not None:
            kind += f"; {where}"
        _say(mesh, f"[train-dsekl] {res.epochs_run} epochs in {dt:.2f}s "
             f"({kind}, "
             f"{'sync' if args.no_prefetch else 'prefetch'}; host gather "
             f"{ld['gather_s']:.3f}s, consumer wait {ld['wait_s']:.3f}s, "
             f"hidden {hidden:.1%})")
    else:
        _say(mesh, f"[train-dsekl] {res.epochs_run} epochs in {dt:.2f}s "
             f"(device-resident on {device}, {args.algorithm})")
    errs = [h["val_error"] for h in res.history if "val_error" in h]
    nsv = int((res.state.alpha != 0).sum())
    if mesh is not None:                    # over the whole model
        from repro_torch.core.distributed import gather_model_shards
        nsv = int((gather_model_shards(mesh, res.state.alpha) != 0).sum())
    if errs:
        _say(mesh, f"[train-dsekl] val error {errs[0]:.4f} -> "
             f"{errs[-1]:.4f}; {nsv} support vectors")
    out.update(result=res, x_val=x_val, y_val=y_val, seconds=dt)
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    # LM training
    ap.add_argument("--arch", default="granite-20b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="the config's published widths (default: the "
                         "reduced config); on the production mesh in a "
                         "world of more than one rank")
    ap.add_argument("--ckpt-dir", default=None,
                    help="LM checkpoints (default: a directory under the "
                         "temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--data-par", type=int, default=1,
                    help="the mesh's data axis (under "
                         "torch.distributed.run; --dsekl with --execution "
                         "mesh or bcd)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="the mesh's model axis (as --data-par)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --full (LM): the (2, 16, 16) production "
                         "mesh")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the mesh's torch.distributed backend: nccl (the "
                         "default on cuda; one rank a card) or gloo (the "
                         "default on cpu); gloo is needed only because "
                         "NCCL cannot put two ranks on one card")
    # DSEKL kernel training
    ap.add_argument("--dsekl", action="store_true",
                    help="train the DSEKL kernel machine instead of an LM")
    ap.add_argument("--data", choices=("memory", "mmap"), default="memory",
                    help="device-resident arrays, or a float32 memmap on "
                         "disk trained out of core")
    ap.add_argument("--mmap-dir", default=None,
                    help="where --data mmap writes its dataset (default: "
                         "a directory under the temporary directory)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="--data mmap: gather each step's rows inline (the "
                         "A/B baseline of the prefetch thread)")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=54)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--n-grad", type=int, default=256)
    ap.add_argument("--n-expand", type=int, default=256)
    ap.add_argument("--kernel", default="rbf")
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--algorithm", choices=("serial", "parallel"),
                    default="serial",
                    help="Algorithm 1 (serial) or 2 (parallel)")
    ap.add_argument("--workers", type=int, default=1,
                    help="Algorithm 2's K: expansion batches a step")
    ap.add_argument("--execution",
                    choices=("auto", "serial", "parallel", "hosted", "mesh",
                             "bcd"),
                    default="auto",
                    help="training execution backend; mesh trains on a "
                         "--data-par x --model-par mesh of ranks; bcd runs "
                         "exact block coordinate descent rounds (square "
                         "loss; on the mesh when --data-par x --model-par "
                         "> 1)")
    ap.add_argument("--bcd-block", type=int, default=0,
                    help="BCD coordinate-block size |J| per round "
                         "(0 = n_expand)")
    ap.add_argument("--bcd-row-block", type=int, default=0,
                    help="BCD streamed row-tile size (0 = n_grad)")
    ap.add_argument("--precondition-k", type=int, default=0,
                    help="EigenPro preconditioning rank: damp the top-k "
                         "eigendirections estimated from a Nystrom "
                         "subsample (core/precond.py; 0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot (state, generator state, epoch, history) "
                         "here every --ckpt-every-epochs epochs")
    ap.add_argument("--ckpt-every-epochs", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid checkpoint in "
                         "--checkpoint-dir (--dsekl) or --ckpt-dir (LM); a "
                         "fresh start if there is none")
    return ap


def lm_refusal(args) -> str:
    """Why the LM path cannot run ``args`` on one device, or ''."""
    if args.arch not in ARCHS:
        return f"unknown arch {args.arch!r}; available: {sorted(ARCHS)}"
    cfg = get_config(args.arch, reduced=not args.full)
    if cfg.n_frontend_tokens:
        return (f"{cfg.name}: its cross-attention needs a frontend "
                f"({cfg.n_frontend_tokens} embeddings a sequence), and the "
                "LM training launcher builds none, as JAX's does not: pass "
                "one in batch['frontend'] to train.make_train_step")
    if args.multi_pod and not args.full:
        return "--multi-pod names the production mesh: give it with --full"
    if args.full and mesh_lib.world_size() == 1:
        device = resolve_device(args.device)
        need, have = lm_state_bytes(cfg), _device_bytes(device)
        if need > have:
            shape = (2, 16, 16) if args.multi_pod else (16, 16)
            return (f"--full {cfg.name}: {need / 1e9:.1f} GB of "
                    f"{cfg.param_dtype} parameters and gradients and float32 "
                    f"AdamW moments do not fit the {have / 1e9:.1f} GB of "
                    f"{device}; train it on the production mesh {shape}: a "
                    f"world of {math.prod(shape)} ranks under "
                    "torch.distributed.run")
    return ""


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.execution == "bcd" and args.precondition_k > 0:
        ap.error("--precondition-k with --execution bcd: BCD solves each "
                 "block exactly — EigenPro preconditioning applies to the "
                 "stochastic step only")
    if args.dsekl and args.multi_pod:
        ap.error("--multi-pod: the DSEKL mesh is --data-par x --model-par")
    if args.dsekl and args.data_par * args.model_par > 1 and \
            args.execution not in ("mesh", "bcd"):
        ap.error("--data-par / --model-par > 1 train on the mesh: pass "
                 "--execution mesh or --execution bcd")
    if args.dist_backend == "nccl":
        try:                    # before NCCL itself fails, in our words
            mesh_lib.check_backend(
                "nccl", resolve_device(args.device),
                int(os.environ.get("WORLD_SIZE", "1")),
                int(os.environ.get("LOCAL_WORLD_SIZE", "0")))
        except (ValueError, RuntimeError) as e:
            ap.error(str(e))
    if not args.dsekl:
        refusal = lm_refusal(args)
        if refusal:
            ap.error(refusal)
        ctx = lm_ctx(args)
        try:
            train_lm(args, ctx)
        finally:
            if ctx is not None:
                ctx.mesh.close()
        return
    train_dsekl(args)


if __name__ == "__main__":
    main()
