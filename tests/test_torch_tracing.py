"""The port's spans (``repro_torch.tracing``): with no profiler on
``span`` is the shared null context and enters no ``record_function``;
under ``torch.profiler`` a CPU engine's submits and flush and a CPU
``fit``'s epochs, steps and evals appear in the exported trace, counted
and nested as the code runs them, and the numbers are those of a run
without the profiler."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import solver
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.serving import DSEKLPredictionEngine, EngineConfig

ENGINE = "repro_torch.engine."
FIT = "repro_torch.fit."


def _spans(prof, tmp_path) -> dict:
    """The exported trace's ``repro_torch.*`` user annotations by name:
    ``{name: [(ts, end), ...]}`` in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("repro_torch."):
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b in outer)


def test_span_without_a_profiler_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler on")

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        refuse)
    assert not torch.autograd._profiler_enabled()
    first = tracing.span("repro_torch.engine.submit")
    assert first is tracing.span("repro_torch.fit.step")
    with first:
        pass
    eng, queries = _engine()
    for q in queries:
        eng.submit(q)
    eng.flush_async()
    _fit()


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]):
        s = tracing.span("repro_torch.fit.step")
    assert isinstance(s, torch.profiler.record_function)


def _engine():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((40, 3)).astype(np.float32)
    alpha = rng.standard_normal(40).astype(np.float32)
    eng = DSEKLPredictionEngine(
        DSEKLConfig(kernel="rbf", kernel_params=(("gamma", 0.5),),
                    impl="ref"),
        alpha, x, engine_cfg=EngineConfig(query_block=8, sv_block=16),
        device="cpu")
    queries = [rng.standard_normal((n, 3)).astype(np.float32)
               for n in (3, 9, 6)]
    return eng, queries


def test_engine_spans_count_and_nest_under_the_profiler(tmp_path):
    plain, queries = _engine()
    for q in queries:
        plain.submit(q)
    want = [f.numpy() for f in plain.flush_async()]
    eng, _ = _engine()
    calls = eng.serve_calls
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q in queries:
            eng.submit(q)
        got = [f.numpy() for f in eng.flush_async()]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    spans = _spans(prof, tmp_path)
    assert len(spans[ENGINE + "submit"]) == 3
    assert len(spans[ENGINE + "flush"]) == 1
    assert len(spans[ENGINE + "serve"]) == eng.serve_calls - calls == 3
    flush = spans[ENGINE + "flush"]
    for name in ("merge", "stage", "serve", "handoff"):
        assert spans[ENGINE + name]
        assert all(_inside(s, flush) for s in spans[ENGINE + name]), name
    assert not any(_inside(s, flush) for s in spans[ENGINE + "submit"])


def _fit(**kw):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 3)).astype(np.float32)
    y = np.where(x[:, 0] > 0, 1.0, -1.0).astype(np.float32)
    cfg = DSEKLConfig(n_grad=16, n_expand=16, kernel="rbf",
                      kernel_params=(("gamma", 0.5),), impl="ref")
    res = solver.fit(cfg, x, y, torch.Generator().manual_seed(2),
                     n_epochs=2, tol=0.0, x_val=x[:24], y_val=y[:24],
                     device="cpu", **kw)
    return res


def test_fit_spans_count_and_nest_under_the_profiler(tmp_path):
    plain = _fit()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = _fit()
    torch.testing.assert_close(res.state.alpha, plain.state.alpha,
                               rtol=0, atol=0)
    assert [h["val_error"] for h in res.history] == \
        [h["val_error"] for h in plain.history]
    spans = _spans(prof, tmp_path)
    epochs, steps = spans[FIT + "epoch"], spans[FIT + "step"]
    assert len(epochs) == 2
    assert len(steps) == 2 * (64 // 16)
    assert all(_inside(s, epochs) for s in steps)
    for name in ("train_pass", "update"):
        assert len(spans[FIT + name]) == len(steps)
        assert all(_inside(s, steps) for s in spans[FIT + name])
    evals = spans[FIT + "eval"]
    assert len(evals) == 2
    assert not any(_inside(s, epochs) for s in evals)
    for name in ("plan", "delta", "on_epoch"):
        assert spans[FIT + name], name


@pytest.mark.parametrize("backend", ["parallel", "hosted"])
def test_fit_steps_are_spanned_on_the_other_backends(backend, tmp_path):
    kw = ({"algorithm": "parallel"} if backend == "parallel"
          else {"execution": "hosted", "prefetch": False})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _fit(**kw)
    spans = _spans(prof, tmp_path)
    assert len(spans[FIT + "epoch"]) == 2
    assert len(spans[FIT + "step"]) == 2 * (64 // 16)
    assert all(_inside(s, spans[FIT + "epoch"])
               for s in spans[FIT + "step"])
