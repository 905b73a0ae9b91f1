"""The port's serve launcher end to end on the CPU.

The LM path at the reduced configs: ``python -m repro_torch.launch.serve
--arch ... --device cpu`` prefills, decodes and prints its timing lines;
``serve_lm``'s greedy tokens are the engine's ``generate`` (for
llama-3.2-vision and whisper over the frontend it draws, for deepseek-v3
through MLA); a ``--full`` model larger than the device exits with an
error naming the production mesh it needs, and one that fits is served.
On the mesh: ``--dsekl --data-par 2`` and the LM's ``--model-par 2`` run
under ``torch.distributed.run`` on two gloo ranks (rank 0 alone prints;
the LM's greedy tokens are the single-device launcher's); ``--full`` in a
world smaller than the production mesh raises, naming the world size it
needs; ``--tenants`` and ``--online`` refuse a mesh.

The DSEKL ``--online`` and ``--tenants`` modes at small sizes: the event
stream and the tenant spec equal the JAX launcher's; each mode runs and
returns its numbers (every ticket answered once, online responses
bit-identical to their version's oracle, quota 0 leaves no resident
tile); the launcher's front-door loop (``drive_front_door``) on a
caller's schedule answers every admitted ticket once and sheds the rest;
a service resumed by ``--resume`` ends at the uninterrupted run's
checkpoint, bit for bit; ``--tenants`` with ``--online`` is refused in
JAX's words; without ``--device cpu`` both need a card."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_lm_serve_cli_runs_end_to_end():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "jamba-v0.1-52b", "--device", "cpu", "--batch", "2",
         "--prompt-len", "20", "--new-tokens", "5", "--cache-len", "32"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(line.startswith("[serve] arch=jamba-v0.1-52b layers=8")
               for line in lines)
    assert any(line.startswith("[serve] prefill") and "tokens/s" in line
               for line in lines)
    seq0 = [line for line in lines if line.startswith("[serve] seq0:")]
    assert len(seq0) == 1 and seq0[0].count(",") == 4


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "gemma3-27b",
                                  "mamba2-780m", "kimi-k2-1t-a32b"])
def test_serve_lm_tokens_are_the_engines_greedy_tokens(name):
    cfg = get_config(name, reduced=True)
    res = serve.serve_lm(cfg, batch=2, prompt_len=20, new_tokens=4,
                         cache_len=24, device="cpu", seed=3)
    assert res["out"].shape == (2, 4) and res["prefills"] == 2
    assert res["tokens"].shape == (2, 20)
    assert bool(torch.isfinite(res["logits"]).all())
    want = res["engine"].generate(res["tokens"], 4)
    assert torch.equal(res["out"], want)
    assert res["peak_bytes"] is None


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-tiny",
                                  "deepseek-v3-671b"])
def test_serve_lm_serves_mla_and_frontend_archs(name):
    """A frontend (B, n_frontend_tokens, d_model) is drawn where the
    config has one (as JAX's launcher draws one), none for deepseek-v3;
    the greedy tokens are the engine's over it."""
    cfg = get_config(name, reduced=True)
    res = serve.serve_lm(cfg, batch=2, prompt_len=12, new_tokens=3,
                         cache_len=16, device="cpu", seed=4)
    fe = res["frontend"]
    if cfg.n_frontend_tokens:
        assert fe.shape == (2, cfg.n_frontend_tokens, cfg.d_model)
    else:
        assert fe is None
    assert bool(torch.isfinite(res["logits"]).all())
    want = res["engine"].generate(res["tokens"], 3, frontend=fe)
    assert torch.equal(res["out"], want)


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_full_frontend_archs_fit_one_card_and_are_served(name, monkeypatch):
    """At their published widths llama-3.2-vision (~21 GB of bf16) and
    whisper fit an 80-GB card: the launcher serves them (serve_lm stubbed
    here), at the full config."""
    seen = {}
    monkeypatch.setattr(serve, "_device_bytes", lambda device: 80 * 10 ** 9)
    monkeypatch.setattr(serve, "serve_lm",
                        lambda cfg, *a, **kw: seen.setdefault("cfg", cfg))
    serve.main(["--arch", name, "--full", "--device", "cpu"])
    assert seen["cfg"] == get_config(name)


def test_full_deepseek_exits_naming_the_mesh(monkeypatch, capsys):
    monkeypatch.setattr(serve, "_device_bytes", lambda device: 80 * 10 ** 9)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "deepseek-v3-671b", "--full", "--device",
                    "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "production mesh (16, 16)" in err and "256 ranks" in err


def test_full_model_larger_than_the_device_exits(monkeypatch, capsys):
    monkeypatch.setattr(serve, "_device_bytes", lambda device: 80 * 10 ** 9)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "jamba-v0.1-52b", "--full", "--device", "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "102.9 GB" in err and "production mesh" in err


def test_serve_lm_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_lm(get_config("jamba-v0.1-52b", reduced=True), 1, 8, 2,
                       16)


# ---------------------------------------------------------------------------
# The DSEKL --online and --tenants modes (CPU, small sizes).
# ---------------------------------------------------------------------------

ONLINE = ["--dsekl", "--online", "--device", "cpu", "--dim", "6",
          "--capacity", "384", "--n-prefill", "192",
          "--events-per-epoch", "64", "--n-grad", "32", "--n-expand", "32",
          "--request", "16", "--query-block", "64", "--sv-block", "128",
          "--rebuild-drift", "0.3"]
TENANTS = ["--dsekl", "--tenants", "gold:2,standard:1,batch:1:4:0",
           "--cache-blocks", "8", "--device", "cpu", "--n-train", "512",
           "--dim", "6", "--queries", "1536", "--request", "16",
           "--query-block", "64", "--sv-block", "128"]


def test_event_stream_equals_jax_launchers():
    from repro.launch import serve as jserve
    got, want = serve.make_event_stream(3, 6), jserve.make_event_stream(3, 6)
    for epoch in (-1, 0, 5):
        for g, w in zip(got(epoch, 50), want(epoch, 50), strict=True):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_parse_tenants_equals_jax_launchers():
    from repro.launch import serve as jserve
    for spec in ("3", "gold:2,standard:1,batch:1:4:0", "a,b:0.5:7"):
        got, want = serve.parse_tenants(spec), jserve.parse_tenants(spec)
        assert list(got) == list(want)
        for name in want:
            assert dataclasses.asdict(got[name]) == \
                dataclasses.asdict(want[name])
    with pytest.raises(ValueError, match="empty tenant name"):
        serve.parse_tenants("a,:2")


def test_online_cli_runs_and_returns_its_numbers(capsys):
    serve.main(ONLINE + ["--epochs", "4"])
    out = capsys.readouterr().out
    assert "ONLINE_DONE epochs=4" in out and "p99=" in out
    args = serve.parser().parse_args(ONLINE + ["--epochs", "3"])
    res = serve.serve_online(args, clients=3, record_models=True)
    svc, st = res["service"], res["stats"]
    assert svc.epoch == 3 and st["rebuilds"] >= 1 and not svc.running
    tickets = [r.ticket for r in res["responses"]]
    assert len(tickets) == len(set(tickets)) and set(tickets) == \
        set(res["sent"])
    assert sum(len(b) for b in res["client_batches"]) == \
        len(res["latencies_s"])
    for r in res["responses"][:20]:
        alpha, snap = svc.published(r.version)
        from repro_torch.serving import DSEKLPredictionEngine
        oracle = DSEKLPredictionEngine(
            svc.cfg, alpha, snap.gather_x(slice(None)),
            engine_cfg=svc.engine_cfg, device="cpu")
        assert torch.equal(r.f, oracle.predict(res["sent"][r.ticket]))


def test_online_cli_resume_equals_uninterrupted(tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    full, cut = str(tmp_path / "full"), str(tmp_path / "cut")
    serve.main(ONLINE + ["--epochs", "4", "--checkpoint-dir", full])
    serve.main(ONLINE + ["--epochs", "2", "--checkpoint-dir", cut])
    serve.main(ONLINE + ["--epochs", "4", "--checkpoint-dir", cut,
                         "--resume"])
    _, a, ea = CheckpointManager(full).restore()
    _, b, eb = CheckpointManager(cut).restore()
    assert ea == eb and ea["epoch"] == 4
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("qos", ["on", "off"])
def test_tenants_cli_runs_and_returns_its_numbers(qos, capsys):
    serve.main(TENANTS + ["--qos", qos])
    assert "TENANTS_DONE served=" in capsys.readouterr().out
    res = serve.serve_tenants(serve.parser().parse_args(
        TENANTS + ["--qos", qos]))
    st = res["stats"]
    assert set(st["tenants"]) == {"gold", "standard", "batch"}
    assert st["qos"]["enabled"] == (qos == "on")
    assert len(res["responses"]) == len(res["sent"])
    served = sum(t["served_rows"] for t in st["tenants"].values())
    assert served == sum(b.shape[0] for _, b in res["sent"].values())
    owners = res["engine"].cache_info()["owners"]
    if qos == "on":
        assert owners["batch"]["resident"] == 0 and \
            owners["batch"]["bypasses"] > 0
    else:
        assert "batch" not in owners


def test_drive_front_door_answers_every_admitted_ticket_once():
    """The launcher's loop on a schedule of its caller's: each round's
    submits, one pump, then a drain; the over-budget tail of a burst is
    shed at submit, typed, and never served."""
    from repro_torch.core.dsekl import DSEKLConfig
    from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                     QoSConfig, ShedResponse, TenantConfig,
                                     TenantFrontDoor)
    rng = np.random.default_rng(5)
    engine = DSEKLPredictionEngine(
        DSEKLConfig(kernel="rbf"), rng.standard_normal(64),
        rng.standard_normal((64, 6)).astype(np.float32),
        engine_cfg=EngineConfig(query_block=16, sv_block=32), device="cpu")
    fd = TenantFrontDoor(engine, {"a": TenantConfig(weight=2.0),
                                  "b": TenantConfig(max_tickets=2)},
                         qos=QoSConfig())
    q = [rng.standard_normal((8, 6)).astype(np.float32) for _ in range(9)]
    rounds = [[("a", q[0]), ("b", q[1]), ("b", q[2]), ("b", q[3])],
              [], [("a", q[4]), ("b", q[5])], [("a", q[6]), ("a", q[7])]]
    run = serve.drive_front_door(fd, rounds)
    tickets = [r.ticket for got in run["pumps"] for r in got]
    assert sorted(tickets) == sorted(run["sent"]) and \
        len(set(tickets)) == len(tickets)
    assert [s.tenant for s in run["sheds"]] == ["b"]
    assert all(isinstance(s, ShedResponse) for s in run["sheds"])
    assert all(run["pumps"]) and fd.pending == 0
    for name in ("a", "b"):
        got = [r for p in run["pumps"] for r in p if r.tenant == name]
        assert len(run["latencies_s"][name]) == len(got)
        for r in got:
            assert torch.equal(r.f, engine.predict(run["sent"][r.ticket][1]))


def test_tenants_with_online_is_refused(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--dsekl", "--online", "--tenants", "2", "--device",
                    "cpu"])
    assert exc.value.code != 0
    assert "--tenants fronts the one-shot engine mode" in \
        capsys.readouterr().err


@pytest.mark.parametrize("mode", [["--online"], ["--tenants", "2"]])
def test_online_and_tenants_need_a_card_by_default(monkeypatch, mode):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--dsekl", "--dim", "6", "--n-train", "256",
                    "--capacity", "64", "--n-prefill", "32"] + mode)


# ---------------------------------------------------------------------------
# Serving on the mesh: the launcher under torch.distributed.run.
# ---------------------------------------------------------------------------

def _torchrun(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--dist-backend", "gloo", *args],
        env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.distributed
def test_dsekl_serves_sharded_under_torchrun():
    """``--dsekl --data-par 2``: the support set over two ranks; rank 0
    alone prints."""
    out = _torchrun(["--dsekl", "--data-par", "2", "--n-train", "2048",
                     "--dim", "8", "--queries", "512", "--request", "64",
                     "--query-block", "128"])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("[serve-dsekl]")]
    assert len(lines) == 2, lines
    assert "mesh data 2 x model 1, gloo" in lines[0]
    assert "2 shard(s) x 512 rows" in lines[0]
    assert lines[1].startswith("[serve-dsekl] 512 queries in 8 requests")


@pytest.mark.distributed
def test_lm_serves_sharded_under_torchrun():
    """The LM with ``--model-par 2``: rank 0 alone prints, and its greedy
    tokens are the single-device launcher's on the same seed."""
    out = _torchrun(["--arch", "jamba-v0.1-52b", "--model-par", "2",
                     "--batch", "2", "--prompt-len", "16", "--new-tokens",
                     "4", "--cache-len", "32"])
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    head = [ln for ln in lines if ln.startswith("[serve] arch=")]
    assert len(head) == 1 and "mesh 1 x 2 (gloo)" in head[0]
    seq0 = [ln for ln in lines if ln.startswith("[serve] seq0:")]
    one = serve.serve_lm(get_config("jamba-v0.1-52b", reduced=True), 2, 16,
                         4, 32, "cpu", 0)
    assert seq0 == [f"[serve] seq0: {one['out'][0].tolist()}"]


@pytest.mark.parametrize("extra,need", [([], 256), (["--multi-pod"], 512)])
def test_full_in_a_small_world_raises_naming_its_size(monkeypatch, extra,
                                                      need):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=f"needs a world of {need} ranks"):
        serve.main(["--arch", "jamba-v0.1-52b", "--full", "--device",
                    "cpu"] + extra)


@pytest.mark.parametrize("mode", [["--tenants", "2"], ["--online"]])
def test_tenants_and_online_refuse_a_mesh(mode, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--dsekl", "--device", "cpu", "--data-par", "2"] + mode)
    assert exc.value.code != 0
    assert "take no mesh" in capsys.readouterr().err
