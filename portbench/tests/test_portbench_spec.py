"""``BENCHMARK.json`` and the files it names: every name resolves to its
own file, the entries keep the benchmark's rules, and the work count, the
trace's reading and the roofline match hand-worked numbers."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import roofline, spec, trace, work

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_portbench_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1].startswith("portbench/")
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])


def test_portbench_metrics_keep_the_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e[
        "setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        for cell in m["workloads"]:     # the cell reports what it moves
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for cell in CELLS:
        own, layer = spec.metrics_of(BENCH, cell)
        assert "setup_s" in {m.name for m in own} and len(own) >= 2
        assert layer


def test_portbench_run_seconds_fit_the_full_check():
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", CELLS)
def test_portbench_cell_pieces_are_found_by_name(cell):
    c = spec.load_cell(cell)
    kind = c.kind()
    for fn in ("setup", "window", "readings", "check"):
        assert callable(getattr(kind, fn))
    assert callable(c.reference().decision)
    assert callable(c.data().make)
    assert c.limits
    for m in c.per_layer:
        assert callable(spec.reader(m.name).read)


def test_portbench_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")
    with pytest.raises(spec.SpecError):
        spec.reader("no_such_metric")


def test_portbench_per_layer_metric_needs_its_workloads():
    bench = json.loads(json.dumps(BENCH))
    del bench["per_layer"][0]["workloads"]
    with pytest.raises(spec.SpecError):
        spec.metrics_of(bench, CELLS[0])


@pytest.mark.parametrize("card", ["NVIDIA H100 PCIe", "NVIDIA H100 NVL",
                                  "NVIDIA H200", "NVIDIA A100-SXM4-80GB"])
def test_portbench_peaks_only_for_the_h100_sxm(card):
    with pytest.raises(ValueError):
        work.peaks_for(card)


def test_portbench_work_count_matches_hand_worked_shapes():
    products = 2 * 1024 * 279_945 * 54
    assert products / 494.5e12 == pytest.approx(62.6e-6, rel=1e-3)
    w = work.matvec(1024, 279_945, 54)
    assert w.flops == products + 2 * 1024 * 279_945
    assert w.bytes == 4 * (1024 * 54 + 279_945 * 54 + 279_945 + 1024)
    h100 = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert h100.tf32_flops == 494.5e12 and h100.hbm_bytes == 3.35e12
    assert w.bound_s(h100) == w.flops / 494.5e12        # compute-bound
    t = work.train_step(4096, 4096, 54)
    assert t.flops == 2 * 4096 * 4096 * 54 + 4 * 4096 * 4096
    assert t.bound_s(h100) == pytest.approx(3.8e-6, rel=0.01)
    assert work.train_step(4096, 4096, 784).bound_s(h100) == \
        pytest.approx(53.3e-6, rel=0.01)
    assert work.matvec(4, 10, 1).bound_s(h100) == \
        work.matvec(4, 10, 1).bytes / 3.35e12            # bytes-bound
    with pytest.raises(ValueError):
        work.peaks_for("NVIDIA A100")


def _event(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1, "args": args}


def _trace_file(tmp_path):
    """A span of 100 us: two matvec launches (a norms kernel and the
    matvec kernel each) inside the op, a copy, and a kernel outside."""
    ev = [_event(trace.SPAN, "user_annotation", 1000, 100),
          _event("repro_torch::kernel_matvec", "cpu_op", 1001, 4),
          _event("cudaLaunchKernel", "cuda_runtime", 1002, 1, correlation=1),
          _event("cudaLaunchKernel", "cuda_runtime", 1003, 1, correlation=2),
          _event("repro_torch::kernel_matvec", "cpu_op", 1040, 4),
          _event("cudaLaunchKernel", "cuda_runtime", 1041, 1, correlation=3),
          _event("aten::cat", "cpu_op", 1070, 20),
          _event("cudaLaunchKernel", "cuda_runtime", 1071, 1, correlation=4),
          _event("row_norms", "kernel", 1010, 5, correlation=1),
          _event("matvec_sm90<0, 7>", "kernel", 1015, 20, correlation=2),
          _event("matvec_sm90<0, 7>", "kernel", 1045, 20, correlation=3),
          _event("Memcpy HtoD", "gpu_memcpy", 1060, 5),
          _event("CatArrayBatchedCopy", "kernel", 1090, 30, correlation=4),
          _event("outside", "kernel", 900, 10, correlation=9)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_portbench_trace_reads_span_busy_and_gaps(tmp_path):
    s = trace.read(_trace_file(tmp_path))
    assert s.window_s == pytest.approx(100e-6)
    # busy: [1010, 1035] + [1045, 1065] + [1090, 1100] (clipped)
    assert s.busy_s == pytest.approx(55e-6)
    assert len(s.kernels()) == 4
    under = s.kernels_under("repro_torch::kernel_matvec")
    assert sorted(e.correlation for e in under) == [1, 2, 3]
    gaps = dict(s.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(45e-6)
    assert gaps["aten::cat"] == pytest.approx(25e-6)    # 1065 -> 1090
    ops = dict(s.device_ops())
    assert ops["matvec_sm90<0, 7>"] == pytest.approx(40e-6)


def test_portbench_roofline_share_by_hand(tmp_path):
    s = trace.read(_trace_file(tmp_path))
    h100 = work.peaks_for("NVIDIA H100 80GB HBM3")
    launches = [work.matvec(1024, 100_000, 54)] * 2
    bound = sum(w.bound_s(h100) for w in launches)
    got = roofline.share(s, "matvec", launches, h100)
    assert got == pytest.approx(100 * bound / 45e-6)
    assert roofline.share(s, "train_pass", [work.train_step(8, 8, 2)],
                          h100) is None
