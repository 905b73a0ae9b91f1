"""``harness/spans.py`` and the five readers of the program's spans on
hand-made chrome traces: the spans found by prefix, their durations, the
device's idle time put inside them by each gap's middle, every reader's
number worked out by hand, and the idle readers silent without device
events while the host readers still read."""
from __future__ import annotations

import json
import types

import pytest

from portbench.harness import spans, spec, trace

ENGINE = "repro_torch.engine."
FIT = "repro_torch.fit."


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": 1, "args": {}}


def _summary(tmp_path, events, device=True):
    ev = [e for e in events if device or e["cat"] not in trace.DEVICE_CATS]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(path)


def _serve_events():
    """A round of 100 us: two submits, one flush with its stage, serve and
    handoff; three kernels.  Busy [1018, 1030] + [1045, 1050] + [1055,
    1058]; gaps [1000, 1018] (middle in a submit), [1030, 1045] (in the
    flush), [1050, 1055] (in the flush and the handoff), [1058, 1100] (in
    no span)."""
    ua = "user_annotation"
    return [_event(trace.SPAN, ua, 1000, 100),
            _event(ENGINE + "submit", ua, 1001, 5),
            _event(ENGINE + "submit", ua, 1007, 3),
            _event(ENGINE + "flush", ua, 1010, 50),
            _event(ENGINE + "merge", ua, 1010, 1),
            _event(ENGINE + "stage", ua, 1011, 4),
            _event(ENGINE + "serve", ua, 1015, 5),
            _event("repro_torch::kernel_matvec", "cpu_op", 1016, 3),
            _event(ENGINE + "handoff", ua, 1040, 20),
            _event("matvec", "kernel", 1018, 12),
            _event("matvec", "kernel", 1045, 5),
            _event("Memcpy DtoH", "gpu_memcpy", 1055, 3)]


def _train_events():
    """Two hundred us: an epoch of three steps, then an eval.  Busy [10,
    40] + [60, 70] + [80, 130] + [160, 170] + [185, 187]; gaps [0, 10] (in
    step 1), [40, 60] (in the epoch alone), [70, 80] (in step 3), [130,
    160] (in the epoch alone), [170, 185] (in the eval), [187, 200] (in no
    span)."""
    ua = "user_annotation"
    return [_event(trace.SPAN, ua, 0, 200),
            _event(FIT + "epoch", ua, 0, 150),
            _event(FIT + "step", ua, 2, 43),
            _event(FIT + "train_pass", ua, 3, 10),
            _event(FIT + "step", ua, 52, 20),
            _event(FIT + "step", ua, 74, 61),
            _event(FIT + "eval", ua, 150, 40),
            _event("train_sm90_wide", "kernel", 10, 30),
            _event("train_sm90_wide", "kernel", 60, 10),
            _event("train_sm90_wide", "kernel", 80, 50),
            _event("matvec", "kernel", 160, 10),
            _event("Memcpy DtoH", "gpu_memcpy", 185, 2)]


def test_portbench_spans_found_by_prefix_with_their_durations(tmp_path):
    s = _summary(tmp_path, _serve_events())
    names = [e.name for e in spans.program_spans(s)]
    assert len(names) == 7 and trace.SPAN not in names
    assert "repro_torch::kernel_matvec" not in names       # a cpu_op
    # Two submits, the stage and the serve start with ".s".
    assert len(spans.program_spans(s, ENGINE + "s")) == 4
    assert sorted(spans.durations(s, ENGINE + "submit")) == [3, 5]
    assert spans.durations(s, ENGINE + "flush") == [50]
    assert spans.durations(s, FIT + "step") == []
    assert spans.median_us(s, ENGINE + "submit") == 4.0
    assert spans.median_us(s, FIT + "step") is None


def test_portbench_idle_in_spans_by_each_gaps_middle(tmp_path):
    s = _summary(tmp_path, _serve_events())
    assert s.busy_s == pytest.approx(20e-6)
    assert spans.idle_in(s, ENGINE) == pytest.approx(38e-6)   # 18 + 15 + 5
    assert spans.idle_in(s, ENGINE + "submit") == pytest.approx(18e-6)
    assert spans.idle_in(s, ENGINE + "handoff") == pytest.approx(5e-6)
    assert spans.idle_in(s, ENGINE + "stage") == 0.0
    assert spans.idle_per_span(s, ENGINE, ENGINE + "flush") == \
        pytest.approx(38e-6)
    # The trace's own breakdown now names the gaps by the spans.
    gaps = dict(s.idle_gaps())
    assert gaps[ENGINE + "submit"] == pytest.approx(18e-6)
    assert gaps[ENGINE + "handoff"] == pytest.approx(5e-6)
    assert gaps["python"] == pytest.approx(42e-6)
    t = _summary(tmp_path, _train_events())
    assert t.busy_s == pytest.approx(102e-6)
    assert spans.idle_in(t, FIT + "step") == pytest.approx(20e-6)
    assert spans.idle_in(t, FIT + "epoch") == pytest.approx(70e-6)
    assert spans.idle_in(t, FIT + "eval") == pytest.approx(15e-6)
    assert spans.idle_in(t, FIT) == pytest.approx(85e-6)


def _ctx(summary):
    return types.SimpleNamespace(
        window=types.SimpleNamespace(trace=summary))


def _read(metric, summary):
    return spec.reader(metric).read(_ctx(summary))


def test_portbench_span_readers_by_hand(tmp_path):
    s = _summary(tmp_path, _serve_events())
    assert _read("submit_host_us", s) == pytest.approx(4.0)
    assert _read("engine_idle_ms", s) == pytest.approx(0.038)
    t = _summary(tmp_path, _train_events())
    assert _read("step_host_us", t) == pytest.approx(43.0)
    assert _read("step_idle_us", t) == pytest.approx(20.0 / 3)
    assert _read("eval_idle_ms", t) == pytest.approx(0.015)


@pytest.mark.parametrize("metric,events,host", [
    ("submit_host_us", _serve_events, 4.0),
    ("engine_idle_ms", _serve_events, None),
    ("step_host_us", _train_events, 43.0),
    ("step_idle_us", _train_events, None),
    ("eval_idle_ms", _train_events, None)])
def test_portbench_span_readers_without_device_events(metric, events, host,
                                                      tmp_path):
    s = _summary(tmp_path, events(), device=False)
    assert not s.device
    assert _read(metric, s) == host
    assert _read(metric, None) is None          # an untraced run
    ua = [e for e in events() if e["cat"] != "user_annotation"
          or not e["name"].startswith("repro_torch.")]
    assert _read(metric, _summary(tmp_path, ua)) is None   # no span
