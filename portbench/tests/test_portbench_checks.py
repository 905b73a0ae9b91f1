"""Whole runs of each cell on the CPU at small sizes (the harness's look
for a card skipped): the result line's keys, ``correct`` true on the
program, false with each fault planted under the timed path and with the
control (the reference in TF32) in the program's place; and the command
line, which refuses to run without a card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import calibrate, run
from portbench.harness import faults, runner, spec, work

CARD = "NVIDIA H100 80GB HBM3"
SEED = 3_000_000_019
SMALL = {
    "serve_closed": {"rows": 6144, "train_rows": 4096, "clients": 8,
                     "cycle_rounds": 8, "query_block": 256,
                     "sv_block": 1024, "warmup_rounds": 1,
                     "check_rows": 512, "trace_rounds": 2},
    "fit_serial": {"rows": 66048, "train_rows": 65536, "n_grad": 1024,
                   "n_expand": 1024, "val_rows": 512, "trace_epochs": 1},
}
# At D 784 the CPU takes fewer rows: the serve cell 2,048 training rows,
# the train cell 16 steps of 256 x 256 (64 of 1,024 x 1,024 at D 54: the
# TF32 control's gaps grow with the steps and the block, and these are
# where they pass the limits set at the cells' own sizes).
WIDE = {"serve_closed": {"rows": 3072, "train_rows": 2048},
        "fit_serial": {"rows": 4608, "train_rows": 4096, "n_grad": 256,
                       "n_expand": 256}}
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
FAULTS_OF = {"serve_closed": ("half_support", "answer_altered"),
             "fit_serial": ("state_unchanged", "half_batch")}


def _small(cell: spec.Cell) -> dict:
    shrink = dict(SMALL[cell.traffic["kind"]])
    if cell.config["dim"] > 64:
        shrink.update(WIDE[cell.traffic["kind"]])
    return shrink


def _run(name: str, trace: bool = False) -> dict:
    cell = spec.load_cell(name)
    return runner.run(cell, SEED, 0.2, trace, device=torch.device("cpu"),
                      card=CARD, t_start=time.perf_counter(),
                      shrink=_small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_cell_runs_correct_with_the_contract_keys(cell):
    out = _run(cell)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    own, _ = spec.metrics_of(spec.benchmark(), cell)
    assert set(out["metrics"]) == {m.name for m in own}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert set(out["checks"]) == set(spec.load_cell(cell).limits)
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["covertype-rbf.serve",
                                  "covertype-rbf.train"])
def test_portbench_traced_run_adds_breakdown_and_device_times(cell):
    out = _run(cell, trace=True)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["correct"] is True
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
    # No card here: no device event, so the kernels' readers stay silent.
    assert not any(k.endswith("_roofline") for k in out["metrics"])
    _, layer = spec.metrics_of(spec.benchmark(), cell)
    assert set(out["metrics"]) <= {m.name for m in layer}


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS
    for f in FAULTS_OF[spec.load_cell(c).traffic["kind"]]])
def test_portbench_planted_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        out = _run(cell)
    assert out["correct"] is False, out["checks"]


def _setup_calls(cell: spec.Cell, monkeypatch) -> int:
    """The calls of the faulted function before the window: a fit's
    set-up epochs' steps, or the serve calls of the engine's set-up and
    warm-up rounds, counted."""
    small = _small(cell)
    if cell.traffic["kind"] == "fit_serial":
        steps = small["train_rows"] // small["n_grad"]
        return int(cell.traffic["setup_epochs"]) * steps
    from repro_torch.kernels.dsekl import ops
    orig, calls = ops.kernel_matvec_tiled, [0]

    def counted(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    with monkeypatch.context() as m:
        m.setattr(ops, "kernel_matvec_tiled", counted)
        ctx = runner.Context(cell=cell, seed=SEED, seconds=0.2, trace=False,
                             device=torch.device("cpu"),
                             peaks=work.peaks_for(CARD), shrink=small)
        cell.kind().setup(ctx)
    assert calls[0] > 0
    return calls[0]


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS
    for f in FAULTS_OF[spec.load_cell(c).traffic["kind"]]])
def test_portbench_fault_starting_in_the_window_is_not_correct(
        cell, fault, monkeypatch):
    """A fault that leaves set-up whole and breaks only the window's steps
    (a step captured or cached after warm-up) still fails the check."""
    c = spec.load_cell(cell)
    with faults.planted(fault, after=_setup_calls(c, monkeypatch)):
        out = _run(cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_tf32_control_fails_a_limit(cell):
    c = spec.load_cell(cell)
    r = calibrate.reading(c, SEED, 0.2, device=torch.device("cpu"),
                          card=CARD, arm="control", shrink=_small(c))
    assert any(r[k] > limit for k, limit in c.limits.items()), r


def test_portbench_command_without_a_card_prints_no_result(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_portbench_command_refuses_forbidden_modules(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: CARD)
    monkeypatch.setattr(runner, "run", lambda *a, **k: {"checks": {}})
    monkeypatch.setattr(run.guard, "forbidden_loaded", lambda: {"jax"})
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and "{" not in out.out
    assert "jax" in out.err


def test_portbench_command_needs_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_portbench_tf32_control_fails_at_the_cells_size(cell, card):
    c = spec.load_cell(cell)
    r = calibrate.reading(c, SEED, 1.0, device=card,
                          card=torch.cuda.get_device_name(card),
                          arm="control")
    assert any(r[k] > limit for k, limit in c.limits.items()), r
