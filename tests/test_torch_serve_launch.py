"""The port's LM serve launcher end to end on the CPU at the reduced
configs: ``python -m repro_torch.launch.serve --arch ... --device cpu``
prefills, decodes and prints its timing lines; ``serve_lm``'s greedy
tokens are the engine's ``generate``; unported architectures and a
``--full`` model larger than the device exit with an error naming what
is missing."""
import os
import pathlib
import subprocess
import sys

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


@pytest.mark.parametrize("name,named", [
    ("deepseek-v3-671b", "MLA"),
    ("llama-3.2-vision-11b", "cross-attention"),
    ("whisper-tiny", "cross-attention"),
])
def test_unported_archs_exit_naming_them(name, named, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", name, "--device", "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert named in err and "ROADMAP" in err


def test_full_model_larger_than_the_device_exits(monkeypatch, capsys):
    monkeypatch.setattr(serve, "_device_bytes", lambda device: 80 * 10 ** 9)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "jamba-v0.1-52b", "--full", "--device", "cpu"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "102.9 GB" in err and "sharded mesh path" in err


def test_serve_lm_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.serve_lm(get_config("jamba-v0.1-52b", reduced=True), 1, 8, 2,
                       16)
