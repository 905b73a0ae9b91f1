"""The port's checkpoints: bitwise resume, the JAX layout both ways, and
crash safety.

* A fit interrupted after 2 epochs and resumed to 4 equals the
  uninterrupted 4-epoch fit bit for bit on the CPU (alpha, accum, step,
  epoch, history less wall times), because the snapshot stores the
  generator state that draws the next epoch's plan; a converged run
  resumed stays where it stopped.
* A checkpoint the port writes reads back through the JAX package's
  ``CheckpointManager.restore`` and through ``convert.read_jax_checkpoint``;
  one the JAX package writes reads back through the port's manager.
* A corrupt newest step is skipped: resume continues from the newest
  valid one and still ends bit-identical.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import read_jax_checkpoint
from repro_torch.core import DSEKLConfig, fit

CFG = DSEKLConfig(n_grad=8, n_expand=8, kernel="rbf",
                  kernel_params=(("gamma", 0.5),), loss="square",
                  schedule="adagrad", lam=1e-3)


def _data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + 16, 4)).astype(np.float32)
    y = np.where(x[:, 0] * x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


def _fit(n_epochs, ckpt=None, resume=False, tol=0.0, seed=11, **kw):
    x, y, xv, yv = _data()
    return fit(CFG, x, y, torch.Generator().manual_seed(seed),
               n_epochs=n_epochs, tol=tol, x_val=xv, y_val=yv,
               checkpoint_dir=None if ckpt is None else str(ckpt),
               resume=resume, device="cpu", **kw)


def _strip(history):
    return [{k: v for k, v in h.items() if k != "seconds"} for h in history]


def _assert_bitwise(a, b):
    for name in ("alpha", "accum", "step", "epoch"):
        assert torch.equal(getattr(a.state, name), getattr(b.state, name)), name
    assert _strip(a.history) == _strip(b.history)
    assert a.converged == b.converged and a.epochs_run == b.epochs_run


def test_resumed_fit_equals_uninterrupted_bitwise(tmp_path):
    full = _fit(4)
    _fit(2, tmp_path)
    # The fresh generator's seed is irrelevant: its state is restored.
    resumed = _fit(4, tmp_path, resume=True, seed=999)
    _assert_bitwise(resumed, full)
    assert CheckpointManager(tmp_path).all_steps() == [2, 3, 4]


def test_resume_of_a_converged_run_stays_stopped(tmp_path):
    done = _fit(5, tmp_path, tol=1e9)
    assert done.converged and done.epochs_run == 1
    again = _fit(5, tmp_path, resume=True, tol=1e9)
    _assert_bitwise(again, done)


def test_port_checkpoint_reads_back_through_jax(tmp_path):
    res = _fit(2, tmp_path)
    step, flat, extra = JManager(str(tmp_path)).restore()
    assert step == 2
    np.testing.assert_array_equal(flat["alpha"], res.state.alpha.numpy())
    np.testing.assert_array_equal(flat["accum"], res.state.accum.numpy())
    assert int(flat["step"]) == int(res.state.step)
    assert int(flat["epoch"]) == 2
    assert flat["gen_state"].dtype == np.uint8 and flat["gen_state"].size
    assert extra["epoch"] == 2 and not extra["converged"]
    assert _strip(extra["history"]) == _strip(res.history)
    s2, flat2, extra2 = read_jax_checkpoint(tmp_path)
    assert s2 == step and extra2 == extra
    for k in flat:
        np.testing.assert_array_equal(flat2[k], flat[k])


def test_jax_checkpoint_reads_back_through_the_port(tmp_path):
    tree = {"alpha": jnp.arange(5.0), "accum": jnp.ones(5), "step": 3,
            "epoch": 1, "key": np.arange(2, dtype=np.uint32)}
    jm = JManager(str(tmp_path), async_save=False)
    jm.save(1, tree, extra={"epoch": 1})
    step, flat, extra = CheckpointManager(tmp_path).restore()
    assert step == 1 and extra == {"epoch": 1}
    np.testing.assert_array_equal(flat["alpha"], np.arange(5.0))
    np.testing.assert_array_equal(flat["key"], np.arange(2))


def test_corrupt_newest_step_is_skipped(tmp_path):
    full = _fit(4)
    _fit(3, tmp_path)
    npz = tmp_path / "step_0000000003" / "arrays.npz"
    data = bytearray(npz.read_bytes())
    data[len(data) // 2] ^= 0xFF
    npz.write_bytes(bytes(data))
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_valid_step() == 2
    with pytest.raises(ValueError, match="corrupt"):
        mgr.restore(3)
    resumed = _fit(4, tmp_path, resume=True)
    _assert_bitwise(resumed, full)


def test_manager_layout_keep_and_manifest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=True)
    for s in range(1, 5):
        mgr.save(s, {"alpha": torch.full((3,), float(s)),
                     "gen_state": np.zeros(4, np.uint8)}, extra={"s": s})
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    man = json.loads((tmp_path / "step_0000000004" / "manifest.json")
                     .read_text())
    assert man["keys"]["alpha"] == {"shape": [3], "dtype": "float32"}
    assert man["extra"] == {"s": 4}
    assert not list(tmp_path.glob("*.tmp"))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()
