"""DSEKL training on the card (port of the ``--dsekl --data memory`` mode
of ``repro/launch/train.py``, serial algorithm).

Trains the kernel machine on the covertype stand-in held on the device,
with the JAX launcher's configuration (hinge loss, adagrad, lam = 1e-4)
and hold-out (the last ``max(min(2048, n // 8), 1)`` rows):

    PYTHONPATH=src python -m repro_torch.launch.train --dsekl \\
        --n 100000 --dim 54 --epochs 3 [--device cpu] \\
        [--checkpoint-dir DIR [--resume]]

Modes the port does not have yet exit with an error that names them:
``--data mmap``, ``--algorithm parallel``, ``--execution`` other than
``auto`` / ``serial``, ``--precondition-k``, and the LM path.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch.core import DSEKLConfig, fit
from repro_torch.data.synthetic import make_covertype_like
from repro_torch.device import resolve_device


def train_dsekl(args) -> Dict[str, Any]:
    """Train on the device-resident covertype stand-in; returns the fit
    result, the config, the training and held-out data and the wall
    time."""
    device = resolve_device(args.device)
    cfg = DSEKLConfig(n_grad=args.n_grad, n_expand=args.n_expand,
                      kernel=args.kernel,
                      kernel_params=(("gamma", args.gamma),),
                      lam=1e-4, schedule="adagrad", impl="auto")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.checkpoint_dir:
        print(f"[train-dsekl] checkpoints -> {args.checkpoint_dir} "
              f"(every {args.ckpt_every_epochs} epoch(s)"
              + (", resuming from newest valid" if args.resume else "")
              + ")")
    x, y = make_covertype_like(args.n, args.dim, seed=args.seed,
                               device=device)
    n_val = max(min(2048, args.n // 8), 1)  # never 0: x[:-0] is empty
    x_val, y_val = x[-n_val:], y[-n_val:]
    x, y = x[:-n_val].contiguous(), y[:-n_val].contiguous()
    t0 = time.perf_counter()
    res = fit(cfg, x, y, gen, n_epochs=args.epochs, tol=0.0, x_val=x_val,
              y_val=y_val, verbose=True, checkpoint_dir=args.checkpoint_dir,
              checkpoint_every=args.ckpt_every_epochs, resume=args.resume,
              device=device)
    dt = time.perf_counter() - t0
    print(f"[train-dsekl] {res.epochs_run} epochs in {dt:.2f}s "
          f"(device-resident on {device})")
    errs = [h["val_error"] for h in res.history if "val_error" in h]
    nsv = int((res.state.alpha != 0).sum())
    if errs:
        print(f"[train-dsekl] val error {errs[0]:.4f} -> {errs[-1]:.4f}; "
              f"{nsv} support vectors")
    return {"result": res, "cfg": cfg, "x": x, "y": y, "x_val": x_val,
            "y_val": y_val, "seconds": dt}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dsekl", action="store_true",
                    help="train the DSEKL kernel machine (the only mode "
                         "ported so far)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--data", choices=("memory", "mmap"), default="memory",
                    help="device-resident arrays (mmap is not ported yet)")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=54)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--n-grad", type=int, default=256)
    ap.add_argument("--n-expand", type=int, default=256)
    ap.add_argument("--kernel", default="rbf")
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--algorithm", choices=("serial", "parallel"),
                    default="serial")
    ap.add_argument("--execution",
                    choices=("auto", "serial", "parallel", "hosted", "mesh",
                             "bcd"),
                    default="auto",
                    help="training execution backend; only auto/serial are "
                         "ported")
    ap.add_argument("--precondition-k", type=int, default=0,
                    help="EigenPro rank (not ported yet; must be 0)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot (state, generator state, epoch, history) "
                         "here every --ckpt-every-epochs epochs")
    ap.add_argument("--ckpt-every-epochs", type=int, default=1)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest valid checkpoint in "
                         "--checkpoint-dir (fresh start if empty)")
    return ap


def unported_modes(args) -> list:
    """The requested modes the port does not have yet."""
    out = []
    if not args.dsekl:
        out.append("the LM path (pass --dsekl)")
    if args.data != "memory":
        out.append(f"--data {args.data}")
    if args.algorithm != "serial":
        out.append(f"--algorithm {args.algorithm}")
    if args.execution not in ("auto", "serial"):
        out.append(f"--execution {args.execution}")
    if args.precondition_k:
        out.append("--precondition-k")
    return out


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    missing = unported_modes(args)
    if missing:
        ap.error("not ported to repro_torch yet: " + ", ".join(missing)
                 + " (ROADMAP.md section 1)")
    train_dsekl(args)


if __name__ == "__main__":
    main()
