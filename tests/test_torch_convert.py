"""A model trained by the JAX package, carried across with
``repro_torch.convert``, serves the same answers in the port.

A short JAX ``fit`` on a small XOR set checkpoints through
``CheckpointManager``; the port reads the checkpoint with numpy alone
(``read_jax_checkpoint``), rebuilds the state (``state_from_jax``) and the
config (``config_from_jax``), and its engine must answer as the JAX engine
does (float32 tolerance: rtol 2e-4, atol 1e-5 x max(1, |oracle|_inf)).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dsekl import DSEKLConfig as JConfig
from repro.core.solver import fit
from repro.data import make_xor
from repro.serving import DSEKLPredictionEngine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.convert import (config_from_jax, read_jax_checkpoint,
                                 state_from_jax)
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.serving import (DSEKLPredictionEngine, EngineConfig,
                                 engine_from_fit)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ck = tmp_path_factory.mktemp("jax_ckpt")
    x, y = make_xor(jax.random.PRNGKey(0), 192)
    cfg = JConfig(n_grad=32, n_expand=32, kernel="rbf",
                  kernel_params=(("gamma", 1.0),), impl="ref")
    res = fit(cfg, x, y, jax.random.PRNGKey(1), n_epochs=3, tol=0.0,
              checkpoint_dir=str(ck))
    xq, _ = make_xor(jax.random.PRNGKey(2), 70)
    return cfg, res, np.asarray(x), np.asarray(xq), ck


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * scale)


def _jax_answers(cfg, alpha, x, xq, ec):
    return np.asarray(JEngine(cfg, alpha, jnp.asarray(x),
                              engine_cfg=JEngineConfig(**ec)).predict(
                                  jnp.asarray(xq)))


def test_config_from_jax_maps_every_field():
    jcfg = JConfig(kernel="matern52", kernel_params=(("length_scale", 0.5),),
                   impl="pallas", lam=0.25, schedule="adagrad",
                   bcd_block=16)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    assert isinstance(cfg, DSEKLConfig) and cfg.impl == "auto"
    assert ({f.name for f in dataclasses.fields(DSEKLConfig)}
            == {f.name for f in dataclasses.fields(JConfig)})
    for f in dataclasses.fields(JConfig):
        if f.name != "impl":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert config_from_jax({"impl": "pallas_interpret"}).impl == "auto"
    assert config_from_jax({"impl": "ref"}).impl == "ref"
    # A JSON round trip turns the kernel_params tuples into lists.
    rt = config_from_jax(json.loads(json.dumps(dataclasses.asdict(jcfg))))
    assert rt == cfg and hash(rt) == hash(cfg)
    with pytest.raises(TypeError):
        config_from_jax({"no_such_field": 1})


def test_fit_result_state_serves_like_jax(trained):
    cfg, res, x, xq, _ = trained
    state = state_from_jax({k: np.asarray(v) for k, v in
                            res.state._asdict().items()}, device="cpu")
    assert state.alpha.dtype == torch.float32 and state.step.dtype == torch.int32
    np.testing.assert_array_equal(state.alpha.numpy(),
                                  np.asarray(res.state.alpha))
    assert int(state.step) == int(res.state.step)
    ec = dict(query_block=32, sv_block=64)
    tcfg = config_from_jax(dataclasses.asdict(cfg))
    eng = DSEKLPredictionEngine(tcfg, state.alpha, x,
                                engine_cfg=EngineConfig(**ec), device="cpu")
    _close(eng.predict(xq), _jax_answers(cfg, res.state.alpha, x, xq, ec))
    # engine_from_fit takes the JAX FitResult itself, too.
    eng2 = engine_from_fit(tcfg, res, x, engine_cfg=EngineConfig(**ec),
                           device="cpu")
    np.testing.assert_array_equal(eng2.predict(xq).numpy(),
                                  eng.predict(xq).numpy())


def test_checkpoint_serves_like_jax(trained):
    cfg, res, x, xq, ck = trained
    step, arrays, extra = read_jax_checkpoint(ck)
    assert step == 3 and extra["epoch"] == 3
    np.testing.assert_array_equal(arrays["alpha"], np.asarray(res.state.alpha))
    state = state_from_jax(arrays, device="cpu")
    assert int(state.epoch) == int(res.state.epoch)
    ec = dict(query_block=32, sv_block=64)
    eng = DSEKLPredictionEngine(config_from_jax(dataclasses.asdict(cfg)),
                                state.alpha, x, engine_cfg=EngineConfig(**ec),
                                device="cpu")
    _close(eng.predict(xq), _jax_answers(cfg, res.state.alpha, x, xq, ec))
    step2, arrays2, _ = read_jax_checkpoint(ck, step=2)
    assert step2 == 2
    assert not np.array_equal(arrays2["alpha"], arrays["alpha"])


def test_corrupt_step_is_skipped(trained, tmp_path):
    _, _, _, _, ck = trained
    steps = sorted(p for p in os.listdir(ck) if p.startswith("step_"))
    assert len(steps) == 3                       # keep=3 of the 3 epochs
    for name in steps:
        (tmp_path / name).mkdir()
        for f in ("arrays.npz", "manifest.json"):
            (tmp_path / name / f).write_bytes((ck / name / f).read_bytes())
    newest = tmp_path / steps[-1] / "arrays.npz"
    raw = bytearray(newest.read_bytes())
    raw[len(raw) // 2] ^= 0xFF                   # crc no longer matches
    newest.write_bytes(bytes(raw))
    step, arrays, _ = read_jax_checkpoint(tmp_path)
    assert step == int(steps[-2].split("_")[1])
    with pytest.raises(ValueError):
        read_jax_checkpoint(tmp_path, step=int(steps[-1].split("_")[1]))
    (tmp_path / steps[-2] / "manifest.json").unlink()   # missing manifest
    step, _, _ = read_jax_checkpoint(tmp_path)
    assert step == int(steps[0].split("_")[1])
    with pytest.raises(FileNotFoundError):
        read_jax_checkpoint(tmp_path / steps[0])
