"""Serving on the card (port of ``repro/launch/serve.py``): the LM path
and the ``--dsekl`` mode.

LM serving: batched prefill + greedy decode of random prompts through a
randomly initialized model (``--seed``), reduced widths by default and the
config's full widths with ``--full``.  The prefill runs the flash-attention
and SSD kernels on a card:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --batch 4 --prompt-len 32 --new-tokens 16 \\
        [--full] [--device cpu]

Where the config has a frontend (llama-3.2-vision's image embeddings,
whisper's audio frames), a random one of shape (B, ``n_frontend_tokens``,
d_model) is drawn from the same generator, as the JAX launcher draws one.
``serve_lm`` takes any config, as ``chip_smoke.py`` calls it with
depth-cut ones.

On a mesh (one process a mesh coordinate, the world from
``torch.distributed.run``): ``--data-par`` x ``--model-par`` serves the
reduced config sharded under JAX's ``decode`` rules
(``MeshCtx.for_mesh(make_local_mesh(dp, mp), "decode")``); ``--full`` in
a world of more than one rank builds the production mesh, (16, 16) or
with ``--multi-pod`` (2, 16, 16), and raises in a smaller world, naming
the world size it needs.  In a world of one, ``--full`` serves on the one
device when the parameters fit it and otherwise exits naming the
production mesh and its world size.  Every config serves on a mesh: GQA,
mamba-2, the MLP and the MoE, MLA (deepseek-v3, kimi-k2), gated
cross-attention over the frontend (llama-3.2-vision) and whisper's
encoder and decoder, each rank on its data shard of the batch and the
frontend.  Rank 0 alone prints; ``--dist-backend`` is nccl (one rank a
card; the default on cuda) or gloo (the CPU, and ranks sharing a card):

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --data-par 2 --model-par 2 \
        --dist-backend gloo [--device cpu]

DSEKL kernel-prediction serving builds a trained DSEKL model from
``--seed`` (random sparse alpha over synthetic training rows), compacts it
into the prediction engine, and pushes a micro-batched query stream
through the front door: the async double-buffered ``flush_async`` by
default, the blocking ``flush`` with ``--sync``, through the kernel-map
tile cache with ``--cache-blocks N``:

    PYTHONPATH=src python -m repro_torch.launch.serve --dsekl \\
        --data covertype --n-train 559890 --dim 54 --queries 16384 \\
        --request 64 --query-block 1024 [--sync] [--device cpu]

``--data covertype`` draws the training rows and the queries from the
covertype stand-in (the queries are held-out rows); ``--data normal``
draws both from N(0, 1), as the JAX launcher does.  With ``--data-par``
x ``--model-par`` > 1 (under ``torch.distributed.run``) the engine's
support set is sharded over the mesh's data axis; ``--tenants`` and
``--online`` refuse a mesh, as JAX's never pass one.

``--tenants`` puts the multi-tenant front door (``serving/tenancy.py``;
DESIGN.md §12) in front of the same engine: per-tenant submit queues
drained by deficit round-robin, over-budget submits shed with typed
responses, per-tenant cache quotas.  The spec is
``name[:weight[:max_tickets[:cache_quota]]],...`` (or a bare integer for N
equal tenants); ``--qos off`` swaps the scheduler for the global-FIFO
baseline (no shedding, no cache attribution), so that the two can be
compared on identical traffic:

    PYTHONPATH=src python -m repro_torch.launch.serve --dsekl \
        --tenants "gold:2,standard:1,batch:1:4:0" --qos on \
        --queries 4096 --request 64 --cache-blocks 8 [--device cpu]

``--online`` serves while a background thread keeps training
(``serving/online.py``; DESIGN.md §11): an ``OnlineService`` trains over
snapshots of an appendable ``RingSource`` fed by a deterministic event
stream, publishing a model version at every epoch boundary while the
foreground loop keeps pushing queries; flush latency (p50 / p99) and
publish staleness are reported at the end.  ``--checkpoint-dir`` /
``--resume`` make the service kill-and-resume safe:

    PYTHONPATH=src python -m repro_torch.launch.serve --dsekl --online \
        --capacity 4096 --n-prefill 1024 --events-per-epoch 128 \
        --epochs 8 [--checkpoint-dir DIR [--resume]] [--device cpu]

Each DSEKL mode returns its numbers as a dict (``serve_dsekl``,
``serve_tenants``, ``serve_online``).
"""
from __future__ import annotations

import argparse
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.data.source import RingSource
from repro_torch.data.synthetic import make_covertype_like
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import MeshCtx
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model import LanguageModel
from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                 OnlineService, QoSConfig, ServingEngine,
                                 ShedResponse, TenantConfig, TenantFrontDoor)


def build_model(args, device: torch.device):
    """(x_train, alpha, queries): training rows and a sparse trained alpha
    on ``device``; the query stream on the host, as requests arrive."""
    g = torch.Generator(device=device).manual_seed(args.seed)
    if args.data == "covertype":
        x, _ = make_covertype_like(args.n_train + args.queries, args.dim,
                                   seed=args.seed, device=device)
        x_train, queries = x[:args.n_train], x[args.n_train:]
    else:
        x_train = torch.randn((args.n_train, args.dim), generator=g,
                              device=device)
        queries = torch.randn((args.queries, args.dim), generator=g,
                              device=device)
    # DSEKL only ever updates sampled J coordinates, so a trained alpha is
    # sparse — keep that shape here.
    alpha = torch.randn((args.n_train,), generator=g, device=device)
    alpha = alpha * (torch.rand((args.n_train,), generator=g, device=device)
                     < args.support_frac)
    return x_train.contiguous(), alpha, queries.cpu()


def _backend(args) -> str:
    return mesh_lib.pick_backend(args.dist_backend,
                                 resolve_device(args.device))


def _say(mesh, *parts) -> None:
    """Print on rank 0 alone (everywhere off the mesh)."""
    if mesh is None or mesh.rank == 0:
        print(*parts)


def serve_dsekl(args) -> Dict[str, Any]:
    """Serve kernel predictions for ``args.queries`` queries in requests of
    ``args.request``; returns the engine, the model (``x_train``,
    ``alpha``), the queries, the per-request results (on the device), the
    stream's wall time and the mesh (None off it).  With ``--data-par`` x
    ``--model-par`` > 1 every rank builds the same model and the engine
    holds its data shard of the support set; a world the mesh started is
    torn down on return."""
    mesh = None
    if args.data_par * args.model_par > 1:
        mesh = mesh_lib.make_local_mesh(args.data_par, args.model_par,
                                        backend=_backend(args),
                                        device=args.device)
    try:
        return _serve_dsekl(args, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _serve_dsekl(args, mesh) -> Dict[str, Any]:
    device = mesh.device if mesh is not None else resolve_device(args.device)
    x_train, alpha, queries = build_model(args, device)
    cfg = DSEKLConfig(kernel=args.kernel, impl="auto")
    engine = DSEKLPredictionEngine(
        cfg, alpha, x_train,
        engine_cfg=EngineConfig(query_block=args.query_block,
                                sv_block=args.sv_block,
                                max_queue=args.max_queue,
                                cache_blocks=args.cache_blocks),
        device=device, mesh=mesh)
    st = engine.stats()
    mode = "sync" if args.sync else "async"
    where = (f"mesh data {args.data_par} x model {args.model_par}, "
             f"{mesh.backend}, " if mesh is not None else "")
    _say(mesh, f"[serve-dsekl] device={device} {where}n_train={st['n_train']} "
         f"n_sv={st['n_sv']} (padded {st['n_sv_padded']}, {st['n_shards']} "
         f"shard(s) x {st['sv_rows_per_shard']} rows) "
         f"kernel={st['kernel']} query_block={st['query_block']} "
         f"mode={mode} cache_blocks={args.cache_blocks}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Warm the path being measured — the kernel build and first launch,
    # and for flush_async its pinned staging buffers — then stream.
    flush = engine.flush if args.sync else engine.flush_async
    engine.submit(queries[: args.query_block])
    flush()
    sync()
    t0 = time.perf_counter()
    outs = []
    for start in range(0, args.queries, args.request):
        engine.submit(queries[start:start + args.request])
        if engine.queued == args.max_queue:
            outs.extend(flush())
    outs.extend(flush())
    sync()
    dt = time.perf_counter() - t0
    done = sum(int(o.shape[0]) for o in outs)
    _say(mesh, f"[serve-dsekl] {done} queries in {len(outs)} requests: "
         f"{dt:.3f}s = {done / dt:,.0f} queries/s "
         f"({engine.serve_calls} serve calls)")
    if args.cache_blocks:
        ci = engine.cache_info()
        _say(mesh, f"[serve-dsekl] cache: {ci['hits']} hits / "
             f"{ci['misses']} misses / {ci['evictions']} evictions "
             f"({ci['size']}/{ci['capacity']} tiles resident)")
    return {"engine": engine, "x_train": x_train, "alpha": alpha,
            "queries": queries, "outs": outs, "seconds": dt,
            "queries_per_s": done / dt, "mesh": mesh}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _percentile_ms(lat_s: List[float], q: float) -> float:
    return float(np.percentile(lat_s, q) * 1e3) if lat_s else 0.0


def parse_tenants(spec: str) -> Dict[str, TenantConfig]:
    """The ``--tenants`` spec as ``{name: TenantConfig}``.

    A bare integer means that many equal tenants (``t0..tN-1``); otherwise
    a comma list of ``name[:weight[:max_tickets[:cache_quota]]]``, e.g.
    ``gold:2,standard:1,batch:1:4:0`` gives ``gold`` double credit and
    caps ``batch`` at 4 outstanding tickets with cache admission denied
    (quota 0)."""
    if spec.strip().isdigit():
        return {f"t{i}": TenantConfig() for i in range(int(spec))}
    tenants = {}
    for part in spec.split(","):
        fields = part.strip().split(":")
        if not fields[0]:
            raise ValueError(f"empty tenant name in --tenants spec {spec!r}")
        tenants[fields[0]] = TenantConfig(
            weight=float(fields[1]) if len(fields) > 1 else 1.0,
            max_tickets=int(fields[2]) if len(fields) > 2 else 64,
            cache_quota=int(fields[3]) if len(fields) > 3 else None)
    return tenants


def drive_front_door(fd: TenantFrontDoor, rounds) -> Dict[str, Any]:
    """Each round submits its ``(tenant, batch)`` pairs in order, then runs
    one ``pump()``; after the last round, pumps until nothing is queued.  A
    ticket's latency runs from its submit to the end of the pump that
    served it.  Returns the latencies (s) by tenant, each pump's responses
    in order, what each ticket sent and the sheds."""
    lat: Dict[str, List[float]] = {n: [] for n in fd.stats()["tenants"]}
    t_sub: Dict[int, float] = {}
    sent: Dict[int, tuple] = {}
    sheds: List[ShedResponse] = []
    pumps: List[list] = []

    def pump() -> bool:
        got = fd.pump()
        now = time.perf_counter()
        for resp in got:
            lat[resp.tenant].append(now - t_sub[resp.ticket])
        if got:
            pumps.append(got)
        return bool(got)

    for submits in rounds:
        for name, q in submits:
            now = time.perf_counter()
            r = fd.submit(name, q)
            if isinstance(r, ShedResponse):
                sheds.append(r)
            else:
                t_sub[r], sent[r] = now, (name, q)
        pump()
    while pump():
        pass
    return {"latencies_s": lat, "pumps": pumps, "sent": sent,
            "sheds": sheds}


def serve_tenants(args) -> Dict[str, Any]:
    """Multi-tenant DSEKL serving: ``serve_dsekl``'s engine (the same
    ``build_model``) behind a ``TenantFrontDoor``.  Each round every tenant
    submits one request-sized batch from its own N(0, 1) stream
    (``default_rng((seed, i))``) and one ``pump()`` serves a drain; a
    ticket's latency runs from its submit to the end of the pump that
    served it (``drive_front_door``).  Returns the front door, the engine,
    the model, the per-tenant latencies (s), the responses, what each
    ticket sent, the sheds, the wall time and the front door's stats."""
    device = resolve_device(args.device)
    tenants = parse_tenants(args.tenants)
    x_train, alpha, _ = build_model(args, device)
    engine = DSEKLPredictionEngine(
        DSEKLConfig(kernel=args.kernel, impl="auto"), alpha, x_train,
        engine_cfg=EngineConfig(query_block=args.query_block,
                                sv_block=args.sv_block,
                                max_queue=args.max_queue,
                                cache_blocks=args.cache_blocks),
        device=device)
    qos_on = args.qos == "on"
    fd = TenantFrontDoor(engine, tenants, qos=QoSConfig(enabled=qos_on))
    print(f"[serve-tenants] device={device} {len(tenants)} tenant(s) "
          f"({', '.join(tenants)}) qos={args.qos} "
          f"query_block={args.query_block} cache_blocks={args.cache_blocks}")

    rounds = max(1, args.queries // (args.request * len(tenants)))
    rngs = {n: np.random.default_rng((args.seed, i))
            for i, n in enumerate(tenants)}

    def schedule():
        for _ in range(rounds):
            yield [(name, rng.standard_normal((args.request, args.dim))
                    .astype(np.float32)) for name, rng in rngs.items()]

    t0 = time.perf_counter()
    run = drive_front_door(fd, schedule())
    wall = time.perf_counter() - t0
    lat = run["latencies_s"]

    st = fd.stats()
    total_rows = sum(t["served_rows"] for t in st["tenants"].values())
    print(f"[serve-tenants] {total_rows} queries in {wall:.3f}s = "
          f"{total_rows / wall:,.0f} queries/s over {st['pumps']} pumps")
    print(f"{'tenant':<12} {'weight':>6} {'served':>8} {'p50ms':>8} "
          f"{'p99ms':>8} {'shed%':>6}")
    for name, ts in st["tenants"].items():
        print(f"{name:<12} {ts['weight']:>6.1f} {ts['served_rows']:>8} "
              f"{_percentile_ms(lat[name], 50):>8.2f} "
              f"{_percentile_ms(lat[name], 99):>8.2f} "
              f"{100 * ts['shed_rate']:>6.1f}")
    if args.cache_blocks and qos_on:
        for name, oc in fd.cache_info()["owners"].items():
            print(f"[serve-tenants] cache[{name}]: {oc['hits']} hits / "
                  f"{oc['misses']} misses / {oc['bypasses']} bypasses "
                  f"({oc['resident']} resident, quota={oc['quota']})")
    print(f"TENANTS_DONE served={total_rows} pumps={st['pumps']}")
    return {"front_door": fd, "engine": engine, "x_train": x_train,
            "alpha": alpha, "tenants": tenants, "latencies_s": lat,
            "responses": [r for got in run["pumps"] for r in got],
            "sent": run["sent"], "sheds": run["sheds"], "seconds": wall,
            "stats": st}


def make_event_stream(seed: int, d: int):
    """A deterministic labeled-event stream: ``chunk(epoch, m)`` returns
    the same rows for the same ``(seed, epoch)`` forever (numpy's
    ``default_rng((seed, epoch + 1))``, the JAX launcher's stream bit for
    bit), which makes a resumed service replayable.  Labels are the
    memmap-dataset family's learnable nonlinear score."""
    w = np.random.default_rng(seed).standard_normal(d).astype(np.float32)

    def chunk(epoch: int, m: int):
        r = np.random.default_rng((seed, epoch + 1))  # epoch -1 = prefill
        x = r.standard_normal((m, d)).astype(np.float32)
        score = (np.tanh(x @ w / np.sqrt(d)) + 0.5 * np.sin(2.0 * x[:, 0])
                 + 0.18)
        return x, np.where(score >= 0.0, 1.0, -1.0).astype(np.float32)

    return chunk


# Folded into the query streams' seeds: (seed, tag, client).
_QUERY_TAG = 0x7175


def serve_online(args, *, clients: int = 1,
                 record_models: bool = False) -> Dict[str, Any]:
    """Continuous learning under live traffic: one ``OnlineService`` (a
    background fit thread and the live engine) driven to ``--epochs``,
    while ``clients`` threads (the foreground loop: one) submit
    ``--request``-row batches and flush, each flush timed on the host
    clock.  Returns the service, the per-flush latencies (s) while
    training, the responses, what each ticket sent, each client's batches
    in order, the ring, the event stream and the service's stats."""
    device = resolve_device(args.device)
    d = args.dim
    chunk = make_event_stream(args.seed, d)
    ring = RingSource(args.capacity, d)
    ring.append(*chunk(-1, args.n_prefill))

    replay_to = 0
    if args.resume and args.checkpoint_dir:
        from repro_torch.checkpoint import CheckpointManager
        man = CheckpointManager(args.checkpoint_dir)
        step = man.latest_valid_step()
        if step is not None:
            _, _, extra = man.restore(step)
            replay_to = int(extra["epoch"])
    # Replay the stream up to the restored epoch: the ring ends where the
    # interrupted run's ring was at its checkpoint.
    for e in range(replay_to):
        ring.append(*chunk(e, args.events_per_epoch))

    def feed(svc, epoch):
        svc.append(*chunk(epoch, args.events_per_epoch))

    cfg = DSEKLConfig(n_grad=args.n_grad, n_expand=args.n_expand,
                      kernel=args.kernel, impl="auto")
    svc = OnlineService(
        cfg, ring, generator=torch.Generator().manual_seed(args.seed),
        engine_cfg=EngineConfig(query_block=args.query_block,
                                sv_block=args.sv_block),
        publish_every=args.publish_every,
        rebuild_drift=args.rebuild_drift,
        max_epochs=args.epochs,
        checkpoint_dir=args.checkpoint_dir or None,
        resume=args.resume, record_models=record_models,
        train_nice=args.train_nice or None,
        ingest_hook=feed, device=device)
    print(f"[serve-online] device={device} n0={ring.n} "
          f"capacity={args.capacity} events/epoch={args.events_per_epoch} "
          f"epochs={args.epochs} resume@{svc.epoch} version={svc.version}")

    lock = threading.Lock()
    lat: List[float] = []
    responses = []
    sent: Dict[int, np.ndarray] = {}
    batches: List[List[np.ndarray]] = [[] for _ in range(clients)]

    def client(c: int) -> None:
        rng = np.random.default_rng((args.seed, _QUERY_TAG, c))
        while svc.running:
            q = rng.standard_normal((args.request, d)).astype(np.float32)
            t = svc.submit(q)
            t0 = time.perf_counter()
            outs = svc.flush()
            dt = time.perf_counter() - t0
            with lock:
                sent[t] = q
                batches[c].append(q)
                lat.append(dt)
                responses.extend(outs)

    svc.start()
    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(1, clients)]
    for th in threads:
        th.start()
    client(0)
    for th in threads:
        th.join()
    svc.join()
    if svc.error is not None:
        raise svc.error
    q = np.random.default_rng((args.seed, _QUERY_TAG, clients)) \
        .standard_normal((args.request, d)).astype(np.float32)
    sent[svc.submit(q)] = q
    responses.extend(svc.flush())
    st = svc.stats()
    served = sum(int(r.f.shape[0]) for r in responses)
    print(f"[serve-online] served {served} queries in {len(lat)} flushes "
          f"({clients} client(s)): p50={_percentile_ms(lat, 50):.2f}ms "
          f"p99={_percentile_ms(lat, 99):.2f}ms")
    print(f"[serve-online] publishes={st['publishes']} "
          f"rebuilds={st['rebuilds']} staleness mean="
          f"{st['staleness_mean']:.1f} max={st['staleness_max']} "
          f"events-behind")
    print(f"ONLINE_DONE epochs={svc.epoch} version={svc.version} "
          f"publishes={st['publishes']}")
    return {"service": svc, "latencies_s": lat, "responses": responses,
            "sent": sent, "client_batches": batches, "ring": ring,
            "events": chunk, "stats": st}


def serve_lm(cfg: ModelConfig, batch: int, prompt_len: int, new_tokens: int,
             cache_len: int, device: DeviceLike = None, seed: int = 0,
             ctx: Optional[MeshCtx] = None) -> Dict[str, Any]:
    """Greedy generation of ``new_tokens`` for ``batch`` random prompts of
    ``prompt_len`` tokens (and, where the config has one, a random
    frontend (batch, ``n_frontend_tokens``, d_model)) through a model
    initialized from ``seed``.

    One prefill and one decode step run first as a warm-up (kernel builds,
    allocator); then the prefill and the ``new_tokens - 1`` decode steps
    are timed on the host clock, each ending in a device synchronisation.
    Returns the model, the engine, the prompts, the frontend (or None),
    the generated tokens (B, new_tokens), the timed prefill's logits, the
    number of prefills run (2), the timings and, on a card, the peak
    device memory.  With ``ctx`` a mesh, every rank draws the same prompts
    and its slices of the same weights and returns the whole logits and
    tokens; rank 0 alone prints."""
    mesh = ctx.mesh if ctx is not None else None
    device = mesh.device if mesh is not None else resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=device, ctx=ctx).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    frontend = None
    if cfg.n_frontend_tokens:
        frontend = torch.randn((batch, cfg.n_frontend_tokens, cfg.d_model),
                               generator=gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, cache_len)

    logits, cache = engine.prefill(tokens, frontend)         # warm-up
    engine.decode_step(torch.argmax(logits, dim=-1), cache, prompt_len)
    _sync(device)
    del cache
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    logits, cache = engine.prefill(tokens, frontend)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [torch.argmax(logits, dim=-1)]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        step_logits, cache = engine.decode_step(out[-1], cache,
                                                prompt_len + i)
        out.append(torch.argmax(step_logits, dim=-1))
    _sync(device)
    decode_s = time.perf_counter() - t0
    steps = max(new_tokens - 1, 0)
    res = {
        "model": model, "engine": engine, "tokens": tokens,
        "frontend": frontend, "out": torch.stack(out, dim=1),
        "logits": logits, "prefills": 2,
        "init_s": init_s, "prefill_s": prefill_s, "decode_s": decode_s,
        "prefill_tokens_per_s": batch * prompt_len / prefill_s,
        "decode_ms_per_step": decode_s / steps * 1e3 if steps else 0.0,
        "decode_tokens_per_s": batch * steps / decode_s if steps else 0.0,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }
    where = (f" mesh {ctx.n_data} x {ctx.n_model} ({mesh.backend})"
             if mesh is not None else "")
    _say(mesh, f"[serve] arch={cfg.name} layers={cfg.n_layers} "
         f"device={device}{where} batch={batch} prompt={prompt_len} "
         f"generated {new_tokens} tokens/seq; init {init_s:.2f}s")
    _say(mesh, f"[serve] prefill {prefill_s * 1e3:.3f} ms = "
         f"{res['prefill_tokens_per_s']:,.0f} tokens/s; decode "
         f"{res['decode_ms_per_step']:.3f} ms/step = "
         f"{res['decode_tokens_per_s']:,.1f} tokens/s")
    _say(mesh, f"[serve] seq0: {res['out'][0].tolist()}")
    return res


def _device_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def lm_main(ap: argparse.ArgumentParser, args) -> Dict[str, Any]:
    if args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r}; available: {sorted(ARCHS)}")
    if args.multi_pod and not args.full:
        ap.error("--multi-pod names the production mesh: give it with "
                 "--full")
    cfg = get_config(args.arch, reduced=not args.full)
    ctx = None
    if args.full and mesh_lib.world_size() > 1:
        # The production mesh, as JAX's launcher; raises in a smaller
        # world, naming the world size it needs.
        ctx = MeshCtx.for_mesh(mesh_lib.make_production_mesh(
            args.multi_pod, backend=_backend(args), device=args.device),
            "decode")
    elif args.data_par * args.model_par > 1:
        ctx = MeshCtx.for_mesh(mesh_lib.make_local_mesh(
            args.data_par, args.model_par, backend=_backend(args),
            device=args.device), "decode")
    device = resolve_device(args.device)
    if args.full and ctx is None:
        need = cfg.param_count_estimate() * torch.finfo(cfg.pdtype).bits // 8
        have = _device_bytes(device)
        if need > have:
            shape = (2, 16, 16) if args.multi_pod else (16, 16)
            ap.error(f"--full {cfg.name}: {need / 1e9:.1f} GB of "
                     f"{cfg.param_dtype} parameters do not fit the "
                     f"{have / 1e9:.1f} GB of {device}; serve it on the "
                     f"production mesh {shape}: a world of "
                     f"{math.prod(shape)} ranks under "
                     "torch.distributed.run")
    try:
        return serve_lm(cfg, args.batch, args.prompt_len, args.new_tokens,
                        args.cache_len, device, args.seed, ctx=ctx)
    finally:
        if ctx is not None:
            ctx.mesh.close()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dsekl", action="store_true",
                    help="serve DSEKL kernel predictions instead of an LM")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    # LM serving
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--full", action="store_true",
                    help="the config's full widths (default: reduced); on "
                         "the production mesh in a world of more than one "
                         "rank")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --full: the (2, 16, 16) production mesh")
    ap.add_argument("--data-par", type=int, default=1,
                    help="the mesh's data axis (under "
                         "torch.distributed.run)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="the mesh's model axis (as --data-par)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the mesh's torch.distributed backend: nccl (the "
                         "default on cuda; one rank a card) or gloo (the "
                         "default on cpu, and ranks sharing a card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--data", choices=["normal", "covertype"],
                    default="normal")
    ap.add_argument("--n-train", type=int, default=65_536)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--kernel", default="rbf")
    ap.add_argument("--queries", type=int, default=4096)
    ap.add_argument("--request", type=int, default=64,
                    help="queries per submitted request batch")
    ap.add_argument("--query-block", type=int, default=1024)
    ap.add_argument("--sv-block", type=int, default=4096)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--support-frac", type=float, default=0.5)
    ap.add_argument("--sync", action="store_true",
                    help="blocking flush() instead of the default async "
                         "double-buffered pipeline")
    ap.add_argument("--cache-blocks", type=int, default=0,
                    help="LRU kernel-map tile cache capacity (0 = off)")
    # Multi-tenant front door (DESIGN.md §12)
    ap.add_argument("--tenants", default="",
                    help="serve through the multi-tenant front door: "
                         "'name[:weight[:max_tickets[:cache_quota]]],...' "
                         "or a bare integer for N equal tenants")
    ap.add_argument("--qos", choices=["on", "off"], default="on",
                    help="'on' = weighted DRR + shedding + cache quotas; "
                         "'off' = global-FIFO baseline (A/B arm)")
    # Online train-to-serve mode (DESIGN.md §11)
    ap.add_argument("--online", action="store_true",
                    help="serve while a background thread keeps training "
                         "over an appendable RingSource")
    ap.add_argument("--capacity", type=int, default=4096,
                    help="ring-buffer capacity (resident event window)")
    ap.add_argument("--n-prefill", type=int, default=1024,
                    help="labeled events preloaded before serving starts")
    ap.add_argument("--events-per-epoch", type=int, default=128,
                    help="labeled events ingested at each epoch boundary")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--n-grad", type=int, default=64)
    ap.add_argument("--n-expand", type=int, default=64)
    ap.add_argument("--publish-every", type=int, default=1)
    ap.add_argument("--rebuild-drift", type=float, default=0.5,
                    help="rebuild the serving engine when events-behind "
                         "exceeds this fraction of the training window")
    ap.add_argument("--train-nice", type=int, default=0,
                    help="run the fit thread this many nice levels below "
                         "the serving threads (Linux; 0 = same priority)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="checkpoint the service (kill-and-resume safe)")
    ap.add_argument("--resume", action="store_true")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.tenants and args.online:
        ap.error("--tenants fronts the one-shot engine mode; for a "
                 "front door over a live OnlineService build a "
                 "TenantFrontDoor(service, ...) directly "
                 "(docs/OPERATIONS.md)")
    if (args.tenants or args.online) and (
            args.data_par * args.model_par > 1 or args.multi_pod):
        ap.error("--tenants and --online serve one device: they take no "
                 "mesh (--data-par / --model-par / --multi-pod), as the "
                 "JAX package's never pass one")
    if args.dsekl and args.tenants:
        serve_tenants(args)
    elif args.dsekl and args.online:
        serve_online(args)
    elif args.dsekl:
        serve_dsekl(args)
    else:
        lm_main(ap, args)


if __name__ == "__main__":
    main()
