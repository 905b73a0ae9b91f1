"""Training by ``repro_torch.core.solver.fit``: Algorithm 1 in memory on
the configuration's training rows, ``n_grad`` x ``n_expand`` blocks,
``max(N // n_grad, 1)`` steps an epoch, a validation eval of
``val_rows`` held-out rows after every epoch, and ``tol`` 0, so that it
never stops of itself.

One ``fit`` call, from the seed, carries the whole run: its first
``setup_epochs`` epochs are set-up (every kernel built and every shape
warmed); the window starts at that epoch's boundary and closes at the
first boundary ``--seconds`` later; with ``--trace 1`` the fit goes on
for ``trace_epochs`` traced epochs.  ``fit``'s ``on_epoch`` hook marks the
boundaries and keeps a copy of the state at each, so that the check
holds two epochs against the reference: the first (the start, from
alpha 0) and the window's last, from the program's own state at its
start, each on its plan drawn again from the fit's seed."""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench.harness import work
from portbench.harness.runner import Check, Context, Window


class _State:
    pass


def setup(ctx: Context) -> _State:
    from repro_torch.core.dsekl import DSEKLConfig
    ref = ctx.cell.reference()
    conf, dev = ctx.cell.config, ctx.device
    n_train, n_val = ctx.size("train_rows"), ctx.size("val_rows")
    x, y = ctx.cell.data().make(ctx.size("rows"), ctx.size("dim"),
                                seed=ctx.sub_seed(1), device=dev)
    st = _State()
    st.x, st.y = x[:n_train].contiguous(), y[:n_train].contiguous()
    st.x_val, st.y_val = x[-n_val:].contiguous(), y[-n_val:].contiguous()
    del x, y
    st.gamma = ref.scale_gamma(st.x)
    st.n_grad, st.n_expand = ctx.size("n_grad"), ctx.size("n_expand")
    st.cfg = DSEKLConfig(n_grad=st.n_grad, n_expand=st.n_expand,
                         kernel=conf["kernel"],
                         kernel_params=(("gamma", st.gamma),),
                         loss=conf["loss"], lam=float(conf["lam"]),
                         lr0=float(conf["lr0"]), schedule=conf["schedule"])
    st.steps = max(n_train // st.n_grad, 1)
    st.fit_seed = ctx.sub_seed(4)
    return st


def _keep(state, rec) -> tuple:
    """A copy of the state at an epoch boundary (a later step may work in
    place) and the epoch's validation error."""
    return state.alpha.clone(), state.accum.clone(), rec["val_error"]


def window(ctx: Context, st: _State) -> Window:
    """Runs the fit: set-up epochs, the window, the traced epochs."""
    from repro_torch.core import solver
    setup_epochs = ctx.size("setup_epochs")
    mark: Dict[str, float] = {}
    kept: Dict[str, tuple] = {}

    def on_epoch(epoch, state, rec):
        now = time.perf_counter()
        if "e1" not in mark:
            prev, kept["last"] = kept.get("last"), _keep(state, rec)
            if epoch == 1:
                kept["first"] = kept["last"]
        if epoch == setup_epochs:
            mark.update(t0=now, e0=epoch)
        elif "e0" in mark and "e1" not in mark:
            if now - mark["t0"] >= ctx.seconds:
                mark.update(t1=now, e1=epoch)
                kept["window_start"] = prev
                if not ctx.trace:
                    return True
                ctx.tracer.start()
        elif "e1" in mark and epoch - mark["e1"] >= ctx.size("trace_epochs"):
            mark.update(summary=ctx.tracer.stop(), e2=epoch)
            return True
        return False

    gen = torch.Generator(device=ctx.device).manual_seed(st.fit_seed)
    res = solver.fit(st.cfg, st.x, st.y, gen, n_epochs=1 << 40,
                     tol=float(ctx.cell.traffic["tol"]), x_val=st.x_val,
                     y_val=st.y_val, on_epoch=on_epoch, device=ctx.device)
    st.final_alpha_finite = bool(torch.isfinite(res.state.alpha).all())
    del res
    st.first, st.window_epoch = kept["first"], int(mark["e1"])
    st.window_start, st.window_end = kept["window_start"], kept["last"]
    steps = int(mark["e1"] - mark["e0"]) * st.steps
    seconds = mark["t1"] - mark["t0"]
    step_work = work.train_step(st.n_grad, st.n_expand, st.x.shape[1])
    win = Window(
        started=mark["t0"], seconds=seconds, attempted=steps,
        failed=0 if st.final_alpha_finite else steps,
        end_to_end={"train_rows_per_s": steps * st.n_grad / seconds},
        counts={"steps": steps, "rows": steps * st.n_grad,
                "model_flops": steps * step_work.flops})
    if ctx.trace:
        span_steps = int(mark["e2"] - mark["e1"]) * st.steps
        win.span = {"steps": span_steps,
                    "train_work": [step_work] * span_steps}
        win.trace = mark["summary"]
    return win


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _gap(got: float, want: float) -> float:
    """The gap of two norms over the reference's; where the reference's is
    0 (every increment rounded away), 0 if the program's is too."""
    if want == 0.0:
        return 0.0 if got == 0.0 else math.inf
    return abs(got - want) / want


def _median_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The median, over the coordinates the reference changed, of each
    coordinate's change's distance from the reference's over the
    reference's: a flip of one row's hinge subgradient moves the few
    coordinates it touches and leaves the median where it was."""
    got, want = got.double(), want.double()
    moved = want != 0
    return float(torch.median((got[moved] - want[moved]).abs()
                              / want[moved].abs()))


def _grad_norm(accum: torch.Tensor, before) -> float:
    """The norm of the gradients AdaGrad's accumulator took in between."""
    return math.sqrt(float((accum.double() - before).sum()))


def readings(ctx: Context, st: _State, *,
             tf32_control: bool = False) -> Dict[str, float]:
    """Two epochs of the program against the reference's on the same plans,
    drawn again from the fit's seed.  The start: epoch 1 from alpha 0, the
    norm of the gradients its accumulator took (``start_grad_gap``) and of
    alpha's change (``start_change_gap``).  The window's last epoch, from
    the program's own state at its start: the same two
    (``window_grad_gap``, ``window_change_gap``), and that epoch's
    validation errors against the reference's f there, in rows beyond
    those within ``val_band`` x max|f| of 0 (``window_val_rows_gap``).
    Each gap of norms is over the reference's norm.  Alpha's change is
    also compared coordinate by coordinate, as the median relative
    distance (``start_change_median``, ``window_change_median``).
    ``window_change_diff`` (the difference of the two alphas over the
    reference's change) is read beside them.  ``tf32_control``: the reference in TF32 stands in the
    program's place, on the same plans and from the same states."""
    ref = ctx.cell.reference()
    conf, dev = ctx.cell.config, ctx.device
    n, n_val = st.x.shape[0], st.y_val.shape[0]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    e1 = st.window_epoch
    plans = ref.draw_plans(st.fit_seed, dev, n, st.n_grad, st.n_expand,
                           st.steps, [1, e1])
    kw = dict(lam=float(conf["lam"]), lr0=float(conf["lr0"]))
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    one = torch.ones((n,), dtype=torch.float32, device=dev)
    a0, c0, _ = st.window_start
    args = (st.x, st.y, st.gamma)
    want_1 = ref.fit_epoch(*args, plans[0], zero, one, **kw)
    want_w = ref.fit_epoch(*args, plans[-1], a0, c0, **kw)
    x_sv, a_sv = ref.support(want_w.alpha, st.x)
    f = ref.decision(st.x_val, x_sv, a_sv, st.gamma)
    want_rows = float((torch.where(f >= 0, 1.0, -1.0) != st.y_val).sum())
    band = float((f.abs() <= float(ctx.cell.traffic["val_band"])
                  * f.abs().max()).sum())
    if tf32_control:
        c_1 = ref.fit_epoch(*args, plans[0], zero, one, tf32=True, **kw)
        c_w = ref.fit_epoch(*args, plans[-1], a0, c0, tf32=True, **kw)
        got_1, got_w = (c_1.alpha, c_1.accum), (c_w.alpha, c_w.accum)
        x_sv, a_sv = ref.support(c_w.alpha, st.x)
        f_c = ref.decision(st.x_val, x_sv, a_sv, st.gamma, tf32=True)
        got_rows = float((torch.where(f_c >= 0, 1.0, -1.0)
                          != st.y_val).sum())
    else:
        got_1, got_w = st.first[:2], st.window_end[:2]
        got_rows = st.window_end[2] * n_val
    c0d = c0.double()
    change_r = _norm(want_w.alpha - a0)
    return {
        "start_grad_gap": _gap(_grad_norm(got_1[1], 1.0),
                               _grad_norm(want_1.accum, 1.0)),
        "start_change_gap": _gap(_norm(got_1[0]), _norm(want_1.alpha)),
        "window_grad_gap": _gap(_grad_norm(got_w[1], c0d),
                                _grad_norm(want_w.accum, c0d)),
        "window_change_gap": _gap(_norm(got_w[0] - a0), change_r),
        "window_val_rows_gap": max(abs(got_rows - want_rows) - band, 0.0),
        "start_change_median": _median_rel(got_1[0], want_1.alpha),
        "window_change_median": _median_rel(got_w[0] - a0,
                                            want_w.alpha - a0),
        "window_change_diff": _norm(got_w[0] - want_w.alpha) / change_r,
        "window_epoch": float(e1)}


def check(ctx: Context, st: _State, win: Window) -> List[Check]:
    r = readings(ctx, st)
    return [Check(k, r[k], float(v)) for k, v in ctx.cell.limits.items()]
