"""DSEKL kernel-prediction serving on the card (port of the ``--dsekl``
mode of ``repro/launch/serve.py``).

Builds a trained DSEKL model from ``--seed`` (random sparse alpha over
synthetic training rows), compacts it into the prediction engine, and
pushes a micro-batched query stream through the front door: the async
double-buffered ``flush_async`` by default, the blocking ``flush`` with
``--sync``, through the kernel-map tile cache with ``--cache-blocks N``:

    PYTHONPATH=src python -m repro_torch.launch.serve --dsekl \\
        --data covertype --n-train 559890 --dim 54 --queries 16384 \\
        --request 64 --query-block 1024 [--sync] [--device cpu]

``--data covertype`` draws the training rows and the queries from the
covertype stand-in (the queries are held-out rows); ``--data normal``
draws both from N(0, 1), as the JAX launcher does.  The LM path,
``--tenants`` and ``--online`` are not ported yet.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.data.synthetic import make_covertype_like
from repro_torch.device import resolve_device
from repro_torch.serving import DSEKLPredictionEngine, EngineConfig


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


def serve_dsekl(args) -> Dict[str, Any]:
    """Serve kernel predictions for ``args.queries`` queries in requests of
    ``args.request``; returns the engine, the model (``x_train``,
    ``alpha``), the queries, the per-request results (on the device) and
    the stream's wall time."""
    device = resolve_device(args.device)
    x_train, alpha, queries = build_model(args, device)
    cfg = DSEKLConfig(kernel=args.kernel, impl="auto")
    engine = DSEKLPredictionEngine(
        cfg, alpha, x_train,
        engine_cfg=EngineConfig(query_block=args.query_block,
                                sv_block=args.sv_block,
                                max_queue=args.max_queue,
                                cache_blocks=args.cache_blocks),
        device=device)
    st = engine.stats()
    mode = "sync" if args.sync else "async"
    print(f"[serve-dsekl] device={device} n_train={st['n_train']} "
          f"n_sv={st['n_sv']} (padded {st['n_sv_padded']}) "
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
    print(f"[serve-dsekl] {done} queries in {len(outs)} requests: "
          f"{dt:.3f}s = {done / dt:,.0f} queries/s "
          f"({engine.serve_calls} serve calls)")
    if args.cache_blocks:
        ci = engine.cache_info()
        print(f"[serve-dsekl] cache: {ci['hits']} hits / "
              f"{ci['misses']} misses / {ci['evictions']} evictions "
              f"({ci['size']}/{ci['capacity']} tiles resident)")
    return {"engine": engine, "x_train": x_train, "alpha": alpha,
            "queries": queries, "outs": outs, "seconds": dt,
            "queries_per_s": done / dt}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dsekl", action="store_true",
                    help="serve DSEKL kernel predictions (the only mode "
                         "ported so far)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
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
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if not args.dsekl:
        ap.error("only --dsekl serving is ported; the LM path is not")
    serve_dsekl(args)


if __name__ == "__main__":
    main()
