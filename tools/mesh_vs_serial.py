"""Does the DSEKL mesh fit trail the serial fit on the same recipe, in the
JAX package as in the port?  A CPU check at a reduced covertype size.

    PYTHONPATH=src python tools/mesh_vs_serial.py [--n 32768] [--epochs 4]

One dataset feeds both packages, 2,048 rows held out: the port's
``make_covertype_like`` (``--family covertype``: covertype-train's data
on the card) or ``make_memmap_dataset``'s family (``--family memmap``:
what the launcher's ``--data mmap`` writes, all-continuous N(0, 1)
features; the card's mesh protocol's data).  The recipe is the covertype protocol's (RBF gamma
1.0, hinge, adagrad, lam 1e-4, lr0 1.0) at ``--block`` rows a shard, in
three arms each: serial at ``block`` (I = J = block), serial at
``2 * block`` (the mesh step's I and J), and a (2, 2) mesh at ``block`` a
shard (data x model: I = J = 2 * block a step, half the serial steps an
epoch).  The JAX package runs in a subprocess on 4 forced host devices;
the port's mesh on a local world of 4 gloo ranks.  Each package samples
its own plans from ``--seed``; the validation error after every epoch is
printed by arm, as one JSON line a package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUN = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.core.dsekl import DSEKLConfig
from repro.core.solver import fit
from repro.launch.mesh import make_local_mesh
z = np.load(sys.argv[1])
block, epochs, seed = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
out = {}
for arm, b, mesh in (("serial", block, None), ("serial_x2", 2 * block, None),
                     ("mesh_2x2", block, make_local_mesh(2, 2))):
    cfg = DSEKLConfig(n_grad=b, n_expand=b, kernel="rbf",
                      kernel_params=(("gamma", 1.0),), loss="hinge",
                      lam=1e-4, schedule="adagrad", impl="ref")
    res = fit(cfg, z["xtr"], z["ytr"], jax.random.PRNGKey(seed),
              execution="mesh" if mesh is not None else None, mesh=mesh,
              n_epochs=epochs, tol=0.0, x_val=z["xva"], y_val=z["yva"])
    out[arm] = [float(h["val_error"]) for h in res.history]
print("JAX" + json.dumps(out))
"""


def _cfg(block: int):
    from repro_torch.core.dsekl import DSEKLConfig
    return DSEKLConfig(n_grad=block, n_expand=block, kernel="rbf",
                       kernel_params=(("gamma", 1.0),), loss="hinge",
                       lam=1e-4, schedule="adagrad", impl="ref")


def _val(res):
    return [float(h["val_error"]) for h in res.history]


def port_mesh_rank(rank, npz, block, epochs, seed):
    """The port's (2, 2) mesh fit on one rank of a local world."""
    import torch
    from repro_torch.core import fit
    from repro_torch.launch.mesh import make_local_mesh
    z = np.load(npz)
    mesh = make_local_mesh(2, 2, backend="gloo", device="cpu")
    res = fit(_cfg(block), torch.from_numpy(z["xtr"]),
              torch.from_numpy(z["ytr"]), torch.Generator().manual_seed(seed),
              execution="mesh", mesh=mesh, n_epochs=epochs, tol=0.0,
              x_val=torch.from_numpy(z["xva"]),
              y_val=torch.from_numpy(z["yva"]), device="cpu")
    return _val(res)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--family", choices=("covertype", "memmap"),
                    default="covertype")
    ap.add_argument("--workdir", default="")
    args = ap.parse_args(argv)
    import tempfile

    import torch
    from repro_torch.core import fit
    from repro_torch.data import make_covertype_like, make_memmap_dataset
    from repro_torch.launch.mesh import spawn_world
    work = args.workdir or tempfile.mkdtemp(prefix="mesh_vs_serial_")
    if args.family == "covertype":
        x, y = make_covertype_like(args.n + 2048, 54, seed=args.seed,
                                   device="cpu")
    else:
        src = make_memmap_dataset(os.path.join(work, "mmap"), args.n + 2048,
                                  54, seed=args.seed)
        xa, ya = src.gather(np.arange(src.n))
        x, y = torch.from_numpy(np.array(xa)), torch.from_numpy(np.array(ya))
    npz = os.path.join(work, "data.npz")
    np.savez(npz, xtr=x[:args.n].numpy(), ytr=y[:args.n].numpy(),
             xva=x[args.n:].numpy(), yva=y[args.n:].numpy())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_RUN, npz, str(args.block),
         str(args.epochs), str(args.seed)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    port = {}
    for arm, b in (("serial", args.block), ("serial_x2", 2 * args.block)):
        res = fit(_cfg(b), x[:args.n], y[:args.n],
                  torch.Generator().manual_seed(args.seed),
                  n_epochs=args.epochs, tol=0.0, x_val=x[args.n:],
                  y_val=y[args.n:], device="cpu")
        port[arm] = _val(res)
    port["mesh_2x2"] = spawn_world(
        port_mesh_rank, 4, (npz, args.block, args.epochs, args.seed),
        workdir=work, timeout_s=1800.0)[0]
    out, err = jax_proc.communicate(timeout=3600)
    if jax_proc.returncode:
        raise RuntimeError(err[-3000:])
    jax_out = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("JAX"))[3:])
    print(json.dumps({"package": "jax", "val_error": jax_out,
                      "n": args.n, "block": args.block,
                      "family": args.family}))
    print(json.dumps({"package": "port", "val_error": port}))


if __name__ == "__main__":
    main()
