"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 portbench/run.py --workload covertype-rbf.serve --seed 7 \\
        --seconds 10 --trace 0

Set-up (data and model from ``--seed``, every shape warmed), a measured
window of ``--seconds``, with ``--trace 1`` a traced span after it, then
the check against the plain reference.  The last line of standard output
is the result's JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Exits non-zero, with no result, without a CUDA card, when a name does
not resolve, or when JAX or the JAX package was loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import guard, spec  # noqa: E402


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        print(f"[portbench] {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[portbench] {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    from portbench.harness import runner
    # One intra-op thread: the host's part of a serve round is many small
    # tensor copies, which a pool of threads on the shared cores only
    # makes slower and less steady.
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)
    print(f"[portbench] {cell.name} seed {args.seed} on {card}; "
          f"nvidia-smi name, power.limit: {_power_limit()}", flush=True)
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     device=device, card=card, t_start=T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"[portbench] forbidden modules loaded: {sorted(loaded)}; "
              "no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"[portbench] check {name} {c['value']!r} limit "
              f"{c['limit']!r} {verdict}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
