"""The mesh fit of the port (``trainer.MeshPlan``, mesh ``BCDPlan``,
``MeshPrefetcher`` / ``SyncMeshGather``, checkpoints, the launcher) on
local gloo worlds on the CPU, against the JAX package where it has a
counterpart that runs in one process.

* The data plane: each rank's ``MeshPrefetcher`` blocks == its
  ``SyncMeshGather`` blocks == its slices of JAX's
  ``gather_mesh_blocks_from`` on JAX's plans, bit for bit; JAX's
  refusals of a segment that is not a mesh plan or changed its shard
  counts are kept.
* The fit on a (2, 2) world over a ``HostSource`` and a memmap
  ``ManifestSource``: prefetch == sync and resumed == uninterrupted, bit
  for bit; a JAX checkpoint (JAX's simulate_step loop after one epoch, in
  its layout) resumed through ``fit`` on JAX's plans == JAX's next epoch
  at the float32 tolerance (rtol 2e-4, atol 1e-5 x max(1, |ref|_inf),
  its atol 100x below the median |ref|); ``mesh_state_from_jax`` places
  the same shards.
* BCD on a (2, 2) and a (4, 1) world == the serial ``BCDPlan`` with
  ``bcd_shards = n_data``, bit for bit (no parity with JAX's mesh BCD is
  claimed: its own check fails).
* The elastic rescale (``tests/test_trainer_matrix.py``'s contract): a
  (4, 1) checkpoint resumed twice on (2, 1) lands on the same bits.
* The launcher under ``torch.distributed.run`` with 4 gloo ranks: the
  mesh and mesh BCD over ``--data mmap``; nccl refused where ranks would
  share a device.  A fit's world of one is torn down.
"""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import distributed as jdist
from repro.core import dsekl as jd
from repro.core import sampler as jsampler
from repro.data import source as jsource
from repro_torch.core import trainer as ttrainer
from repro_torch.core.dsekl import DSEKLConfig
from repro_torch.core.solver import fit
from repro_torch.data import (HostSource, MeshPrefetcher, SyncMeshGather,
                              make_memmap_dataset)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.launch.mesh import spawn_world

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, D, NG, NE = 256, 8, 16, 16
RTOL, ATOL = 2e-4, 1e-5
CFG = dict(n_grad=NG, n_expand=NE, kernel="rbf",
           kernel_params=(("gamma", 0.5),), lam=1e-3, loss="square",
           schedule="adagrad", impl="ref")
BCD = dict(n_grad=16, n_expand=32, kernel="rbf",
           kernel_params=(("gamma", 0.5),), lam=1e-3, loss="square",
           bcd_block=32, bcd_row_block=16)


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] >= 0, 1.0,
                 -1.0).astype(np.float32)
    return x, y


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nz = want != 0
    np.testing.assert_array_equal(got[~nz], 0.0, err_msg=what)
    atol = ATOL * max(1.0, np.abs(want).max())
    assert atol * 100 < np.median(np.abs(want[nz])), what
    np.testing.assert_allclose(got[nz], want[nz], rtol=RTOL, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# The data plane (one process: each coordinate's loader in turn).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)])
def test_mesh_loaders_equal_jax_gather_slices(shape):
    x, y = _data()
    rows_d = (N // shape[0],) * shape[0]
    rows_m = (N // shape[1],) * shape[1]
    plans = [jsampler.mesh_epoch_plan(jax.random.PRNGKey(e), NG, NE, rows_d,
                                      rows_m, 3) for e in range(2)]
    jsrc = jsource.HostSource(x, y)
    jd_src, jm_src = jsrc.split(shape[0]), jsrc.split(shape[1])
    src = HostSource(x, y)
    ds, ms = src.split(shape[0]), src.split(shape[1])
    for d in range(shape[0]):
        for m in range(shape[1]):
            pre = MeshPrefetcher(ds, ms, *plans[0], coord=(d, m),
                                 device="cpu")
            syn = SyncMeshGather(ds, ms, *plans[0], coord=(d, m),
                                 device="cpu")
            pre.extend(*plans[1])               # across the epoch edge
            syn.extend(*plans[1])
            try:
                for pi, pj in plans:
                    for t in range(pi.shape[0]):
                        want = jdist.gather_mesh_blocks_from(
                            pi[t], pj[t], jd_src, jm_src)
                        want = (want[0][d * NG:(d + 1) * NG],
                                want[1][d * NG:(d + 1) * NG],
                                want[2][m * NE:(m + 1) * NE],
                                want[3][m * NE:(m + 1) * NE])
                        got_p, got_s = pre.get(), syn.get()
                        assert got_p[3].dtype == torch.int64
                        for gp, gs, w in zip(got_p, got_s, want):
                            np.testing.assert_array_equal(gp.numpy(), w)
                            np.testing.assert_array_equal(gs.numpy(), w)
                assert pre.stats()["steps"] == syn.stats()["steps"] == 6
            finally:
                pre.close()


def test_mesh_loaders_keep_jax_refusals():
    x, y = _data()
    src = HostSource(x, y)
    ds = src.split(2)
    pi, pj = jsampler.mesh_epoch_plan(jax.random.PRNGKey(0), NG, NE,
                                      (128, 128), (128, 128), 2)
    flat = np.asarray(pi)[:, 0]
    bad3 = jsampler.mesh_epoch_plan(jax.random.PRNGKey(0), NG, NE,
                                    (64,) * 4, (128, 128), 2)
    jsg = jsource.SyncMeshGather(jsource.HostSource(x, y).split(2),
                                 jsource.HostSource(x, y).split(2), (),
                                 pi, pj)
    with pytest.raises(ValueError) as jerr:
        jsg.extend(*bad3)
    for cls in (MeshPrefetcher, SyncMeshGather):
        with pytest.raises(ValueError, match=r"mesh plan segments are "
                           r"\(steps, shards, width\)"):
            cls(ds, ds, flat, flat, coord=(0, 0), device="cpu")
        loader = cls(ds, ds, pi, pj, coord=(1, 0), device="cpu")
        try:
            with pytest.raises(ValueError) as err:
                loader.extend(*bad3)
            assert str(err.value).startswith(str(jerr.value))
            assert "re-split the sources" in str(err.value)
        finally:
            loader.close()


# ---------------------------------------------------------------------------
# The fit on a (2, 2) world.
# ---------------------------------------------------------------------------

def _jax_checkpoint(tmp_path, x, y, shape):
    """JAX's mesh fit of one epoch, as its simulate_step loop over the
    epoch plan's step keys, saved in JAX's layout; and the plans and the
    reference after one more epoch."""
    cfg = jd.DSEKLConfig(**CFG)
    steps = max(N // (NG * shape[0]), 1)
    rows_d = (N // shape[0],) * shape[0]
    rows_m = (N // shape[1],) * shape[1]
    ekeys = [jax.random.PRNGKey(40 + e) for e in range(2)]
    a, g = jnp.zeros(N), jnp.ones(N)
    t = jnp.zeros((), jnp.int32)
    after = []
    for ek in ekeys:
        for k in jax.random.split(ek, steps):
            a, g, t = jdist.simulate_step(cfg, *shape, x, y, a, g, t, k)
        after.append((np.asarray(a), np.asarray(g), int(t)))
    plans = [tuple(np.asarray(p) for p in jsampler.mesh_epoch_plan(
        ek, NG, NE, rows_d, rows_m, steps)) for ek in ekeys]
    ck = tmp_path / "jax_ckpt"
    man = JCheckpointManager(str(ck), async_save=False)
    a1, g1, t1 = after[0]
    man.save(1, {"alpha": a1, "accum": g1, "step": np.int32(t1),
                 "epoch": np.int32(1), "key": np.asarray(ekeys[1])},
             extra={"epoch": 1, "converged": False,
                    "history": [{"epoch": 1, "delta_alpha":
                                 float(np.linalg.norm(a1))}]})
    return str(ck), plans, after[1]


@pytest.mark.distributed
def test_fit_on_a_2x2_world(tmp_path):
    x, y = _data()
    mm = tmp_path / "mmap"
    make_memmap_dataset(str(mm), N, D, seed=3)
    jdir, jplans, (ja2, _, jt2) = _jax_checkpoint(tmp_path, x, y, (2, 2))
    out = spawn_world(ranks.fit_world, 4,
                      ((2, 2), x, y, str(mm), str(tmp_path), CFG,
                       (jdir, jplans), BCD, 2),
                      workdir=str(tmp_path))
    lead = next(r for r in out.values() if r["coord"] == (0, 0))
    steps = N // (NG * 2)
    for r in out.values():
        assert all(r["same"].values()), r["same"]
        for k in ("host_alpha", "manifest_alpha", "bcd_alpha",
                  "jax_resumed_alpha"):
            np.testing.assert_array_equal(r[k], lead[k])
        assert r["host_steps"] == r["manifest_steps"] == 3 * steps
        assert r["host_loader"]["steps"] == 3 * steps
        assert r["full_history"] == lead["full_history"]
        assert r["precond_finite"]
        np.testing.assert_array_equal(r["precond_indices"],
                                      lead["precond_indices"])
    # Rank 0's checkpoint holds the full alpha of the uninterrupted fit's
    # epoch 1 ... and a resumed fit replays the rest (same["resumed"]).
    assert lead["ckpt_alpha"].shape == (N,)
    assert all(e is not None and 0.0 <= e <= 1.0
               for e in lead["val_errors"])
    # JAX's checkpoint resumed on JAX's plans == JAX's next epoch.
    # History holds JAX's epoch 1 and the resumed epoch 2.
    assert lead["jax_resumed_epochs"] == 2
    _close(lead["jax_resumed_alpha"], ja2, "JAX checkpoint resumed")
    # BCD on the mesh == serial with bcd_shards = n_data, bit for bit.
    np.testing.assert_array_equal(lead["bcd_alpha"],
                                  lead["bcd_serial_alpha"])
    assert ([h["delta_alpha"] for h in lead["bcd_history"]]
            == [h["delta_alpha"] for h in lead["bcd_serial_history"]])
    assert ([h["val_error"] for h in lead["bcd_history"]]
            == [h["val_error"] for h in lead["bcd_serial_history"]])


@pytest.mark.distributed
def test_elastic_rescale_4x1_to_2x1(tmp_path):
    """A (4, 1) checkpoint at epoch 1, resumed twice on (2, 1): the same
    bits both times (mesh sampling depends on the mesh's shape, so this is
    the contract, as in JAX).  The (4, 1) world also runs BCD against the
    serial plan with bcd_shards = 4."""
    x, y = _data()
    ck = tmp_path / "ckpt"
    save = spawn_world(ranks.elastic_save, 4,
                       ((4, 1), x, y, str(ck), CFG, BCD, 4),
                       workdir=str(tmp_path))
    np.testing.assert_array_equal(save[0]["bcd_alpha"],
                                  save[0]["bcd_serial_alpha"])
    for r in save.values():
        np.testing.assert_array_equal(r["bcd_alpha"], save[0]["bcd_alpha"])
    dirs = []
    for i in range(2):
        d = tmp_path / f"resume{i}"
        d.mkdir()
        shutil.copytree(ck / "step_0000000001", d / "step_0000000001")
        dirs.append(str(d))
    out = spawn_world(ranks.elastic_resume, 2,
                      ((2, 1), x, y, dirs, CFG), workdir=str(tmp_path))
    steps_a, steps_b = N // (NG * 4), N // (NG * 2)
    for r in out.values():
        (a0, s0, e0), (a1, s1, e1) = r
        np.testing.assert_array_equal(a0, a1)
        np.testing.assert_array_equal(a0, out[0][0][0])
        assert s0 == s1 == steps_a + steps_b and e0 == e1 == 2
        assert np.isfinite(a0).all() and (a0 != 0).any()


# ---------------------------------------------------------------------------
# The world of one, refusals.
# ---------------------------------------------------------------------------

def test_world_of_one_is_torn_down():
    x, y = _data()
    cfg = DSEKLConfig(**CFG)
    res = fit(cfg, x, y, torch.Generator().manual_seed(0), execution="mesh",
              n_epochs=2, device="cpu", x_val=x[:32], y_val=y[:32])
    assert not dist.is_initialized()
    assert int(res.state.step) == 2 * (N // NG)
    assert res.state.alpha.shape == (N,)
    # The same plans as a serial fit: a (1, 1) mesh step is Algorithm 1.
    gen = torch.Generator().manual_seed(0)
    ser = fit(cfg, x, y, plans=[tuple(p[:, 0] for p in
                                      ttrainer.sampler.mesh_epoch_plan(
                                          gen, NG, NE, (N,), (N,), N // NG))
                                for _ in range(2)],
              n_epochs=2, device="cpu")
    np.testing.assert_allclose(res.state.alpha.numpy(),
                               ser.state.alpha.numpy(), rtol=RTOL,
                               atol=ATOL * max(1.0, float(
                                   ser.state.alpha.abs().max())))
    # A fit that fails inside the plan leaves no world either.
    with pytest.raises(ValueError, match="mesh epoch plan"):
        fit(cfg, x, y, plans=[(np.zeros((1, 1, NG), np.int64),) * 2],
            execution="mesh", n_epochs=1, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs a DataSource"):
        ttrainer.make_plan("mesh", cfg, x=torch.from_numpy(x),
                           y=torch.from_numpy(y), device=torch.device("cpu"))
    assert not dist.is_initialized()


def test_mesh_refusals(tmp_path):
    with pytest.raises(ValueError, match="needs a world of 4 ranks"):
        tmesh.make_local_mesh(2, 2, backend="gloo", device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="NCCL cannot run two ranks"):
        tmesh.check_backend("nccl", "cuda", 4, 4)
    with pytest.raises(ValueError, match="CUDA devices only"):
        tmesh.make_local_mesh(1, 1, backend="nccl", device="cpu")
    for multi, need in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs a world of {need}"):
            tmesh.make_production_mesh(multi_pod=multi)
    with pytest.raises(SystemExit):
        train.main(["--dsekl", "--device", "cpu", "--execution", "mesh",
                    "--dist-backend", "nccl", "--n", "512"])
    # A mesh resume refuses another N, in JAX's words.
    mesh = tmesh.make_local_mesh(1, 1, backend="gloo", device="cpu")
    try:
        x, y = _data()
        plan = ttrainer.MeshPlan(DSEKLConfig(**CFG), HostSource(x, y), mesh)
        with pytest.raises(ValueError, match="an elastic rescale must keep "
                                             "the \\(trimmed\\) row count"):
            plan.place_state({"alpha": np.zeros(N - 2, np.float32),
                              "accum": np.ones(N - 2, np.float32),
                              "step": 0, "epoch": 0})
        plan.close()
    finally:
        mesh.close()
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# The launcher under torch.distributed.run.
# ---------------------------------------------------------------------------

LAUNCH = ["--dsekl", "--device", "cpu", "--n", "4096", "--epochs", "2",
          "--n-grad", "64", "--n-expand", "64", "--data", "mmap",
          "--data-par", "2", "--model-par", "2", "--dist-backend", "gloo"]


@pytest.mark.distributed
@pytest.mark.parametrize("execution", ["mesh", "bcd"])
def test_launcher_under_torchrun(execution, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         *LAUNCH, "--execution", execution, "--mmap-dir",
         str(tmp_path / "mm"), "--checkpoint-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    # Rank 0 alone prints.
    assert sum(ln.startswith("[dsekl] epoch") and "val_err=" in ln
               for ln in lines) == 2
    done = [ln for ln in lines if ln.startswith("[train-dsekl] 2 epochs")]
    assert len(done) == 1 and "mesh data 2 x model 2, gloo" in done[0]
    assert sum(ln.startswith("[train-dsekl] val error") for ln in lines) == 1
    errs = [float(ln.split("val_err=")[1]) for ln in lines
            if "val_err=" in ln]
    assert all(0.0 <= e < 0.5 for e in errs), errs
    assert (tmp_path / "mm" / "manifest.json").is_file()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_0000000001", "step_0000000002"]
