"""The DSEKL mesh step of the port (``repro_torch/core/distributed.py`` on
``torch.distributed``) against the JAX package's
(``repro/core/distributed.py``), on the same numpy inputs and JAX's plans.

The JAX side runs single-device (``simulate_step``, ``mesh_step_plan``,
the quantiser): it needs no forced host devices.  The port's mesh runs as
a local world of 4 gloo ranks on the CPU (``launch.mesh.spawn_world``;
the rank programs are in ``torch_mesh_ranks.py``), one world per mesh
shape, each running every case.

Tolerance: the JAX suite's float32 one, rtol 2e-4, atol 1e-5 x max(1,
|ref|_inf), on the entries the reference touched (the others must be
exactly zero), and every gate checks its atol sits 100x below the median
|ref| it compares.  The port's mesh step against the port's
``simulate_step`` is held to the same tolerance (the reductions sum in
another order); the replicas of one alpha shard across the data axis
are bit-identical.  The quantiser equals JAX's bit for bit on JAX's
uniforms; a compressed step stays within ``compression_error_bound``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro.core import distributed as jdist
from repro.core import dsekl as jd
from repro.core import sampler as jsampler
from repro.distributed import compression as jcomp
from repro_torch.core import distributed as tdist
from repro_torch.core import sampler as tsampler
from repro_torch.core.dsekl import DSEKLConfig, PrecondBlock
from repro_torch.distributed import compression as tcomp
from repro_torch.launch.mesh import spawn_world

N, D, NG, NE = 256, 8, 16, 16
RTOL, ATOL = 2e-4, 1e-5
STEPS = 3
SHAPES = [(2, 2), (4, 1), (1, 4)]
BASE = dict(n_grad=NG, n_expand=NE, kernel="rbf",
            kernel_params=(("gamma", 0.5),), lam=1e-3, impl="ref")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    y = np.where(np.sin(2 * x[:, 0]) + x[:, 1] * x[:, 2] >= 0, 1.0,
                 -1.0).astype(np.float32)
    return x, y


def _close(got, want, what=""):
    """The float32 gate on the entries ``want`` touched; the untouched ones
    exactly zero; the atol 100x below the median |want| it compares."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nz = want != 0
    assert nz.any(), what
    np.testing.assert_array_equal(got[~nz], 0.0, err_msg=what)
    atol = ATOL * max(1.0, np.abs(want).max())
    assert atol * 100 < np.median(np.abs(want[nz])), what
    np.testing.assert_allclose(got[nz], want[nz], rtol=RTOL, atol=atol,
                               err_msg=what)


def _jplans(shape, steps=STEPS, seed=7):
    """JAX's per-step keys and the plans ``mesh_step_plan`` draws from
    them: index for index what ``simulate_step`` samples."""
    keys = jax.random.split(jax.random.PRNGKey(seed), steps)
    rows_d = (N // shape[0],) * shape[0]
    rows_m = (N // shape[1],) * shape[1]
    plans = [tuple(np.array(p) for p in jsampler.mesh_step_plan(
        k, NG, NE, rows_d, rows_m)) for k in keys]
    return keys, plans


def _jax_run(kw, shape, x, y, keys, pc=None):
    cfg = jd.DSEKLConfig(**kw)
    a, g = jnp.zeros(N), jnp.ones(N)
    t = jnp.zeros((), jnp.int32)
    for k in keys:
        a, g, t = jdist.simulate_step(cfg, *shape, x, y, a, g, t, k, pc)
    return np.asarray(a), np.asarray(g), int(t)


def _port_run(kw, shape, x, y, plans, pc=None):
    cfg = DSEKLConfig(**kw)
    a, g = torch.zeros(N), torch.ones(N)
    t = torch.zeros((), dtype=torch.int32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for idx_i, idx_j in plans:
        a, g, t = tdist.simulate_step(cfg, *shape, xt, yt, a, g, t,
                                      torch.from_numpy(idx_i),
                                      torch.from_numpy(idx_j), pc)
    return a.numpy(), g.numpy(), int(t)


# The step's cases: (config, steps).  Square and logistic under adagrad
# and inv_t, unbiased scaling on and off, on each branch; hinge for one
# step (its subgradient flips on ulp-level differences).
BRANCHES = {"fused": {}, "two-pass": {"fuse_dual_pass": False},
            "streamed": {"stream_row_block": 8}}
CASES = [(dict(BASE, loss=loss, schedule=sched, unbiased_scaling=unb, **br),
          STEPS, f"{name} {loss} {sched} unbiased={unb}")
         for name, br in BRANCHES.items()
         for loss, sched in (("square", "adagrad"), ("logistic", "inv_t"))
         for unb in (False, True)]
CASES += [(dict(BASE, loss="hinge", schedule="adagrad", **br), 1,
           f"{name} hinge")
          for name, br in BRANCHES.items()]


def _precond_arrays(m=12, k=3, seed=2):
    """A replicated EigenPro block whose indices span every model shard:
    each shard must scatter its own entries and drop the others'."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(N, size=m, replace=False).astype(np.int64)
    q, _ = np.linalg.qr(rng.standard_normal((m, k)))
    return {"rows": rng.standard_normal((m, D)).astype(np.float32),
            "vectors": q.astype(np.float32),
            "damping": rng.uniform(0.01, 0.05, k).astype(np.float32),
            "indices": idx}


# ---------------------------------------------------------------------------
# Plans, quantiser and simulate_step: no world needed.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_plans_have_jax_shapes_and_local_ranges(shape):
    rows_d = (N // shape[0],) * shape[0]
    rows_m = (N // shape[1],) * shape[1]
    ji, jj = jsampler.mesh_step_plan(jax.random.PRNGKey(0), NG, NE, rows_d,
                                     rows_m)
    ti, tj = tsampler.mesh_step_plan(torch.Generator().manual_seed(0), NG,
                                     NE, rows_d, rows_m)
    assert tuple(ti.shape) == ji.shape and tuple(tj.shape) == jj.shape
    assert ti.dtype == torch.int64
    for idx, rows in ((ti, rows_d), (tj, rows_m)):
        assert int(idx.min()) >= 0 and int(idx.max()) < rows[0]
    jei, jej = jsampler.mesh_epoch_plan(jax.random.PRNGKey(0), NG, NE,
                                        rows_d, rows_m, 5)
    tei, tej = tsampler.mesh_epoch_plan(torch.Generator().manual_seed(0),
                                        NG, NE, rows_d, rows_m, 5)
    assert tuple(tei.shape) == jei.shape == (5, shape[0], NG)
    assert tuple(tej.shape) == jej.shape == (5, shape[1], NE)
    # The same generator state draws the same plan on every rank.
    again = tsampler.mesh_epoch_plan(torch.Generator().manual_seed(0), NG,
                                     NE, rows_d, rows_m, 5)
    assert torch.equal(again[0], tei) and torch.equal(again[1], tej)


@pytest.mark.parametrize("n_local,batch", [(64, 16), (64, 20), (10, 16)])
def test_sharded_batches_match_jax_layout(n_local, batch):
    """``max(n_local // batch, 1)`` batches of ``batch`` local indices,
    without replacement; a shard smaller than a batch wraps its
    permutation (JAX's ``batch > n_local`` case)."""
    jb = np.asarray(jsampler.sharded_batches(jax.random.PRNGKey(1), n_local,
                                             batch, 1, 4))
    tb = tsampler.sharded_batches(torch.Generator().manual_seed(1), n_local,
                                  batch).numpy()
    assert tb.shape == jb.shape
    assert tb.min() >= 0 and tb.max() < n_local
    flat = tb.reshape(-1)
    if batch <= n_local:
        assert len(set(flat.tolist())) == flat.size
    else:
        assert set(flat.tolist()) == set(range(n_local))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_matches_jax_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal(1000) * 3).astype(np.float32)
    max_q = 2 ** (bits - 1) - 1
    scale = np.float32(np.maximum(np.abs(x).max(), 1e-12) / max_q)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jcomp.quantize_stochastic(jnp.asarray(x),
                                                jnp.asarray(scale), key,
                                                max_q))
    u = torch.from_numpy(np.array(jax.random.uniform(key, x.shape)))
    got = tcomp.quantize_stochastic(torch.from_numpy(x),
                                    torch.tensor(scale), u, max_q).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (tcomp.compression_error_bound(2.5, bits, 4)
            == jcomp.compression_error_bound(2.5, bits, 4))


# simulate_step has one form: the branches are the mesh step's.
SIM_CASES = [c for c in CASES if c[2].startswith("fused")]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", SIM_CASES, ids=[c[2] for c in SIM_CASES])
def test_simulate_step_matches_jax(shape, case):
    kw, steps, what = case
    x, y = _data()
    keys, plans = _jplans(shape, steps)
    ja, jg, jt = _jax_run(kw, shape, x, y, keys)
    ta, tg, tt = _port_run(kw, shape, x, y, plans)
    assert tt == jt == steps
    _close(ta, ja, what)
    np.testing.assert_allclose(tg, jg, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(jg).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_simulate_step_with_precond_matches_jax(shape):
    x, y = _data()
    arrays = _precond_arrays()
    kw = dict(BASE, loss="square", schedule="inv_t")
    keys, plans = _jplans(shape)
    jpc = jd.PrecondBlock(*(jnp.asarray(arrays[k]) for k in
                            ("rows", "vectors", "damping")),
                          jnp.asarray(arrays["indices"], jnp.int32))
    tpc = PrecondBlock(*(torch.from_numpy(arrays[k]) for k in
                         ("rows", "vectors", "damping", "indices")))
    ja, _, _ = _jax_run(kw, shape, x, y, keys, jpc)
    plain, _, _ = _jax_run(kw, shape, x, y, keys)
    ta, _, _ = _port_run(kw, shape, x, y, plans, tpc)
    _close(ta, ja, "precond")
    # The correction moved alpha beyond the float32 tolerance.
    assert np.abs(ja - plain).max() > 100 * ATOL


# ---------------------------------------------------------------------------
# The mesh: one world a shape.
# ---------------------------------------------------------------------------

@pytest.mark.distributed
@pytest.mark.parametrize("shape", SHAPES, ids=["2x2", "4x1", "1x4"])
def test_mesh_step_matches_simulate_and_jax(shape, tmp_path):
    """Every branch (fused, two-pass, streamed) and case on the mesh ==
    the port's simulate_step == JAX's simulate_step, on JAX's plans; on
    the (2, 2) mesh also EigenPro (``_local_block_step_precond``, its
    block's indices in both model shards) and the compressed step."""
    x, y = _data()
    keys, plans = _jplans(shape)
    cases = [{"cfg": kw, "plans": plans[:steps]} for kw, steps, _ in CASES]
    arrays = _precond_arrays()
    pc_kw = dict(BASE, loss="square", schedule="adagrad")
    if shape == (2, 2):
        cases.append({"cfg": pc_kw, "plans": plans, "pc": arrays})
    out = spawn_world(ranks.step_cases, 4, (shape, x, y, cases),
                      workdir=str(tmp_path))
    by_coord = {r["coord"]: r for r in out.values()}
    rows_m = N // shape[1]
    for c, case in enumerate(cases):
        kw, steps = case["cfg"], len(case["plans"])
        what = CASES[c][2] if c < len(CASES) else "precond"
        jpc = tpc = None
        if "pc" in case:
            jpc = jd.PrecondBlock(*(jnp.asarray(arrays[k]) for k in
                                    ("rows", "vectors", "damping")),
                                  jnp.asarray(arrays["indices"], jnp.int32))
            tpc = PrecondBlock(*(torch.from_numpy(arrays[k]) for k in
                                 ("rows", "vectors", "damping", "indices")))
        ja, jg, _ = _jax_run(kw, shape, x, y, keys[:steps], jpc)
        ta, tg, _ = _port_run(kw, shape, x, y, plans[:steps], tpc)
        full = np.zeros(N, np.float32)
        acc = np.zeros(N, np.float32)
        for (d, m), r in by_coord.items():
            res = r["cases"][c]
            assert res["step"] == steps
            sl = slice(m * rows_m, (m + 1) * rows_m)
            if d == 0:
                full[sl], acc[sl] = res["alpha"], res["accum"]
            # Replicas over data are bit-identical; the gather is exact.
            np.testing.assert_array_equal(
                res["alpha"], by_coord[(0, m)]["cases"][c]["alpha"])
            np.testing.assert_array_equal(res["full"],
                                          by_coord[(0, 0)]["cases"][c]["full"])
        np.testing.assert_array_equal(by_coord[(0, 0)]["cases"][c]["full"],
                                      full)
        _close(full, ta, f"{what}: mesh vs port simulate")
        _close(full, ja, f"{what}: mesh vs JAX simulate")
        np.testing.assert_allclose(acc, jg, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(jg).max()))
        if "pc" in case:
            # Entries of the block outside a shard were dropped there, and
            # its own landed: the correction's rows moved off the plain run.
            plain, _, _ = _jax_run(kw, shape, x, y, keys[:steps])
            moved = np.abs(full - plain)[arrays["indices"]]
            assert (moved > 100 * ATOL).sum() >= len(arrays["indices"]) // 2
            assert {int(i) // rows_m for i in arrays["indices"]} == {0, 1}


@pytest.mark.distributed
@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_step_within_error_bound(bits, tmp_path):
    """One compressed mesh step (const rate) against the exact one on the
    same block: |alpha_c - alpha| <= lr0 x compression_error_bound(max
    |g| before the reduction, bits, n_data) x the most copies of one index
    in the shard's J (drawn with replacement), and not equal to it."""
    x, y = _data()
    shape = (2, 2)
    _, plans = _jplans(shape, 1)
    kw = dict(BASE, loss="square", schedule="const", lr0=0.5)
    out = spawn_world(ranks.compressed_step, 4,
                      (shape, x, y, kw, plans[0], bits),
                      workdir=str(tmp_path))
    for r in out.values():
        mult = np.bincount(plans[0][1][r["coord"][1]]).max()
        bound = mult * kw["lr0"] * tcomp.compression_error_bound(
            r["gmax"], bits, shape[0])
        err = np.abs(r["comp"] - r["exact"]).max()
        assert 0 < err <= bound * (1 + 1e-5) + 1e-7, (err, bound)
