"""The readings a cell's limits are set from, in one process on the card:

    python3 portbench/calibrate.py --workload covertype-rbf.train \\
        --seeds 11,12,13 --control-seeds 21,22,23 \\
        --fault half_batch --fault-seeds 31,32,33 --seconds 2

For each seed: set-up, a short window at the cell's own load and sizes,
then every number the cell's check computes (``readings``), as one JSON
line.  ``--seeds`` are the program's runs; ``--control-seeds`` put the
control (the reference in TF32) in the program's place; ``--fault``
plants a fault of ``harness/faults.py`` under the timed path.  The last
line is each number's largest program reading, its smallest control
reading and its smallest fault reading.  Not a run of the benchmark: it
prints no result line."""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import faults, spec  # noqa: E402


def reading(cell: spec.Cell, seed: int, seconds: float, *, device,
            card: str, arm: str = "program", fault: Optional[str] = None,
            shrink: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """One seed's readings: ``arm`` is ``program``, ``control`` or
    ``fault`` (with ``fault`` planted)."""
    import torch
    from portbench.harness import runner, work
    kind = cell.kind()
    ctx = runner.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                         device=device, peaks=work.peaks_for(card),
                         shrink=shrink)
    plant = (faults.planted(fault) if arm == "fault"
             else contextlib.nullcontext())
    with plant:
        st = kind.setup(ctx)
        kind.window(ctx, st)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out = kind.readings(ctx, st, tf32_control=arm == "control")
    out.update(seed=seed, arm=arm if arm != "fault" else f"fault:{fault}")
    return out


def summary(rows: List[dict]) -> dict:
    """Per number: the program's largest reading and the smallest of each
    other arm."""
    out: Dict[str, dict] = {}
    for r in rows:
        for k, v in r.items():
            if k in ("seed", "arm", "seconds"):
                continue
            slot = out.setdefault(k, {})
            if r["arm"] == "program":
                slot["program_max"] = max(slot.get("program_max", v), v)
            else:
                key = r["arm"] + "_min"
                slot[key] = min(slot.get(key, v), v)
    return out


def _seeds(text: str) -> List[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = torch.cuda.get_device_name(device)
    plan = [("program", s) for s in _seeds(args.seeds)]
    plan += [("control", s) for s in _seeds(args.control_seeds)]
    plan += [("fault", s) for s in _seeds(args.fault_seeds)]
    rows = []
    for arm, seed in plan:
        t0 = time.perf_counter()
        r = reading(cell, seed, args.seconds, device=device, card=card,
                    arm=arm, fault=args.fault)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
        rows.append(r)
    print(json.dumps({"workload": cell.name, "card": card,
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
