"""Serving on the card (port of ``repro/launch/serve.py``): the LM path
and the ``--dsekl`` mode.

LM serving: batched prefill + greedy decode of random prompts through a
randomly initialized model (``--seed``), reduced widths by default and the
config's full widths with ``--full``.  The prefill runs the flash-attention
and SSD kernels on a card:

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-v0.1-52b --batch 4 --prompt-len 32 --new-tokens 16 \\
        [--full] [--device cpu]

``--full`` on a config whose parameters do not fit the device exits with
an error naming the sharded path it needs (ROADMAP.md section 1, items 6
and 10); ``serve_lm`` takes any config, as ``chip_smoke.py`` calls it with
a depth-cut one.  MLA (deepseek-v3) and cross-attention
(llama-3.2-vision, whisper) exit with an error naming their ROADMAP item.

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
draws both from N(0, 1), as the JAX launcher does.  ``--tenants`` and
``--online`` are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Any, Dict

import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.data.synthetic import make_covertype_like
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import check_supported
from repro_torch.models.model import LanguageModel
from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                 ServingEngine)


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_lm(cfg: ModelConfig, batch: int, prompt_len: int, new_tokens: int,
             cache_len: int, device: DeviceLike = None, seed: int = 0
             ) -> Dict[str, Any]:
    """Greedy generation of ``new_tokens`` for ``batch`` random prompts of
    ``prompt_len`` tokens through a model initialized from ``seed``.

    One prefill and one decode step run first as a warm-up (kernel builds,
    allocator); then the prefill and the ``new_tokens - 1`` decode steps
    are timed on the host clock, each ending in a device synchronisation.
    Returns the model, the engine, the prompts, the generated tokens
    (B, new_tokens), the timed prefill's logits, the number of prefills
    run (2), the timings and, on a card, the peak device memory."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    model = LanguageModel(cfg, device=device).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    engine = ServingEngine(model, cache_len)

    logits, cache = engine.prefill(tokens)                   # warm-up
    engine.decode_step(torch.argmax(logits, dim=-1), cache, prompt_len)
    _sync(device)
    del cache
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    logits, cache = engine.prefill(tokens)
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
        "out": torch.stack(out, dim=1), "logits": logits, "prefills": 2,
        "init_s": init_s, "prefill_s": prefill_s, "decode_s": decode_s,
        "prefill_tokens_per_s": batch * prompt_len / prefill_s,
        "decode_ms_per_step": decode_s / steps * 1e3 if steps else 0.0,
        "decode_tokens_per_s": batch * steps / decode_s if steps else 0.0,
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }
    print(f"[serve] arch={cfg.name} layers={cfg.n_layers} device={device} "
          f"batch={batch} prompt={prompt_len} generated {new_tokens} "
          f"tokens/seq; init {init_s:.2f}s")
    print(f"[serve] prefill {prefill_s * 1e3:.3f} ms = "
          f"{res['prefill_tokens_per_s']:,.0f} tokens/s; decode "
          f"{res['decode_ms_per_step']:.3f} ms/step = "
          f"{res['decode_tokens_per_s']:,.1f} tokens/s")
    print(f"[serve] seq0: {res['out'][0].tolist()}")
    return res


def _device_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def lm_main(ap: argparse.ArgumentParser, args) -> Dict[str, Any]:
    if args.arch not in ARCHS:
        ap.error(f"unknown arch {args.arch!r}; available: {sorted(ARCHS)}")
    cfg = get_config(args.arch, reduced=not args.full)
    try:
        check_supported(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    device = resolve_device(args.device)
    if args.full:
        need = cfg.param_count_estimate() * torch.finfo(cfg.pdtype).bits // 8
        have = _device_bytes(device)
        if need > have:
            ap.error(f"--full {cfg.name}: {need / 1e9:.1f} GB of "
                     f"{cfg.param_dtype} parameters do not fit the "
                     f"{have / 1e9:.1f} GB of {device}; the full model needs "
                     "the sharded mesh path, which is not ported yet "
                     "(ROADMAP.md section 1, items 6 and 10)")
    return serve_lm(cfg, args.batch, args.prompt_len, args.new_tokens,
                    args.cache_len, device, args.seed)


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
                    help="the config's full widths (default: reduced)")
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
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.dsekl:
        serve_dsekl(args)
    else:
        lm_main(ap, args)


if __name__ == "__main__":
    main()
