"""Closed-loop serving through ``DSEKLPredictionEngine.submit`` and
``flush_async``: ``clients`` clients each send a request and wait for its
answer; a round submits every client's pending request, flushes once and
brings the answers to the host, so each client's next request follows
its answer.

The served model is made from the seed: the configuration's training
rows, and alpha drawn normal with a ``support_fraction`` of its entries
kept (a trained DSEKL model is sparse).  Request sizes are one fixed
multiset, log-uniform over [``min_rows``, ``max_rows``] by quantiles,
dealt into ``cycle_rounds`` rounds the same way for every seed, so that
every seed serves the same rows and tiles a flush.  Each cycle serves
those rounds once, in an order drawn afresh from the seed's generator,
the clients of each round in a fresh order too; each request is a
contiguous run of the query pool (the rows after the training rows) at
an offset drawn afresh.  No round, and no padded query tile, repeats
within a run.

Latency runs from a request's submission to its answer being on the host.
Every answer of the window is kept (a view of its round's host array);
after the window, every answer to one of ``check_rows`` pool rows
drawn from the seed is held against the plain reference's f there."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import work
from portbench.harness.runner import Check, Context, Window


class _State:
    pass


def _rounds(ctx: Context, pool_rows: int) -> np.ndarray:
    """The request sizes of the ``cycle_rounds`` rounds, (rounds,
    clients): the log-uniform multiset dealt alike for every seed."""
    tr = ctx.cell.traffic
    clients, rounds = ctx.size("clients"), ctx.size("cycle_rounds")
    lo, hi = int(tr["min_rows"]), min(int(tr["max_rows"]), pool_rows)
    count = clients * rounds
    q = (np.arange(count) + 0.5) / count
    sizes = np.clip(np.floor(np.exp(np.log(hi + 1.0) * q)), lo, hi)
    sizes = np.random.default_rng(0).permutation(sizes.astype(np.int64))
    return sizes.reshape(rounds, clients)


def _next_cycle(st: "_State") -> None:
    """One cycle's rounds from the seed's generator: the rounds in a fresh
    order, each round's clients in a fresh order, fresh offsets."""
    rng, rounds = st.rng, st.rounds
    sizes = rng.permuted(rounds[rng.permutation(rounds.shape[0])], axis=1)
    st.cycle_sizes = sizes
    st.cycle_offsets = rng.integers(0, st.pool.shape[0] - sizes + 1)
    st.cycle_at = 0


def setup(ctx: Context) -> _State:
    from repro_torch.core.dsekl import DSEKLConfig
    from repro_torch.serving.dsekl_engine import (DSEKLPredictionEngine,
                                                  EngineConfig)
    ref = ctx.cell.reference()
    conf, dev = ctx.cell.config, ctx.device
    n_train = ctx.size("train_rows")
    x, _ = ctx.cell.data().make(ctx.size("rows"), ctx.size("dim"),
                                seed=ctx.sub_seed(1), device=dev)
    st = _State()
    st.x_train = x[:n_train].contiguous()
    st.pool = x[n_train:].contiguous()
    del x
    st.gamma = ref.scale_gamma(st.x_train)
    g = torch.Generator(device=dev).manual_seed(ctx.sub_seed(2))
    alpha = torch.randn((n_train,), generator=g, device=dev)
    keep = torch.rand((n_train,), generator=g, device=dev) \
        < float(conf["support_fraction"])
    st.alpha = alpha * keep
    cfg = DSEKLConfig(kernel=conf["kernel"],
                      kernel_params=(("gamma", st.gamma),))
    st.engine = DSEKLPredictionEngine(
        cfg, st.alpha, st.x_train,
        engine_cfg=EngineConfig(query_block=ctx.size("query_block"),
                                sv_block=ctx.size("sv_block"),
                                max_queue=ctx.size("clients")),
        device=dev)
    st.n_sv = st.engine.n_sv
    st.pool_host = np.ascontiguousarray(st.pool.cpu().numpy())
    st.rounds = _rounds(ctx, st.pool.shape[0])
    st.rng = np.random.default_rng(ctx.sub_seed(3))
    st.clients = ctx.size("clients")
    _next_cycle(st)
    st.engine.warm()
    for _ in range(ctx.size("warmup_rounds")):
        _round(st)
    _sync(ctx)
    return st


def _sync(ctx: Context) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def _round(st: _State):
    """One round: every client submits, one flush, answers to the host.
    Returns (the requests' sizes, their offsets, answers, latencies s,
    flush s, failed)."""
    if st.cycle_at == st.rounds.shape[0]:
        _next_cycle(st)
    sizes = st.cycle_sizes[st.cycle_at]
    offsets = st.cycle_offsets[st.cycle_at]
    st.cycle_at += 1
    sub = np.empty(st.clients)
    eng, pool = st.engine, st.pool_host
    for c in range(st.clients):
        o, n = offsets[c], sizes[c]
        sub[c] = time.perf_counter()
        eng.submit(pool[o:o + n])
    t0 = time.perf_counter()
    outs = eng.flush_async()
    t1 = time.perf_counter()
    answers = torch.cat(outs).cpu().numpy()
    done = time.perf_counter()
    failed = 0
    if len(outs) != st.clients:
        failed = st.clients
    else:
        failed = sum(int(o.shape[0] != n) for o, n in zip(outs, sizes))
        failed += int(not np.isfinite(answers).all())
    return sizes, offsets, answers, done - sub, t1 - t0, failed


def window(ctx: Context, st: _State) -> Window:
    lat: List[np.ndarray] = []
    flush: List[float] = []
    kept: List[tuple] = []
    rows = failed = rounds = 0
    started = time.perf_counter()
    while True:
        sizes, offsets, answers, l, f, bad = _round(st)
        lat.append(l)
        flush.append(f)
        rows += answers.shape[0]
        failed += bad
        kept.append((sizes, offsets, answers))
        rounds += 1
        now = time.perf_counter()
        if now - started >= ctx.seconds:
            break
    seconds = now - started
    lat_ms = np.concatenate(lat) * 1e3
    d = st.pool.shape[1]
    win = Window(
        started=started, seconds=seconds, attempted=rounds * st.clients,
        failed=failed,
        end_to_end={"serve_qps": rows / seconds,
                    "serve_p95_ms": float(np.percentile(lat_ms, 95))},
        counts={"rows": rows, "rounds": rounds,
                "flush_ms": np.asarray(flush) * 1e3,
                "model_flops": rows * work.matvec(1, st.n_sv, d).flops})
    st.kept = kept
    if ctx.trace:
        win.span, win.trace = _traced_span(ctx, st)
    return win


def _traced_span(ctx: Context, st: _State):
    qb, d = ctx.size("query_block"), st.pool.shape[1]
    launch_work: List[work.Work] = []
    ctx.tracer.start()
    for _ in range(ctx.size("trace_rounds")):
        answers = _round(st)[2]
        n = answers.shape[0]
        launch_work += [work.matvec(min(qb, n - lo), st.n_sv, d)
                        for lo in range(0, n, qb)]
    return {"matvec_work": launch_work}, ctx.tracer.stop()


def readings(ctx: Context, st: _State, *,
             tf32_control: bool = False) -> Dict[str, float]:
    """Frees the engine, then holds every kept answer to one of the checked
    pool rows against the reference's f there: the widest gap over the
    reference's largest |f| on those rows.  ``tf32_control``: the
    control's answers (the reference in TF32) stand in the program's
    place."""
    del st.engine
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = ctx.cell.reference()
    n_pool = st.pool.shape[0]
    rng = np.random.default_rng(ctx.sub_seed(5))
    rows = np.sort(rng.choice(n_pool, size=min(ctx.size("check_rows"),
                                               n_pool), replace=False))
    q = st.pool[torch.from_numpy(rows).to(ctx.device)]
    x_sv, a_sv = ref.support(st.alpha, st.x_train)
    f_ref = ref.decision(q, x_sv, a_sv, st.gamma).double().cpu().numpy()
    scale = max(float(np.abs(f_ref).max()), 1e-30)
    if tf32_control:
        got = ref.decision(q, x_sv, a_sv, st.gamma,
                           tf32=True).double().cpu().numpy()
        return {"answer_gap": float(np.abs(got - f_ref).max()) / scale,
                "answers_checked": float(rows.size)}
    gap, checked = 0.0, 0
    for sizes, offsets, answers in st.kept:
        row = np.repeat(offsets - np.cumsum(sizes) + sizes, sizes) \
            + np.arange(answers.shape[0])
        at = np.searchsorted(rows, row)
        hit = (at < rows.size) & (rows[np.minimum(at, rows.size - 1)] == row)
        if hit.any():
            diff = np.abs(answers[hit].astype(np.float64) - f_ref[at[hit]])
            gap = max(gap, float(diff.max()))
            checked += int(hit.sum())
    return {"answer_gap": gap / scale, "answers_checked": float(checked)}


def check(ctx: Context, st: _State, win: Window) -> List[Check]:
    r = readings(ctx, st)
    return [Check(k, r[k], float(v)) for k, v in ctx.cell.limits.items()]
