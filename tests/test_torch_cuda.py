"""The port's hand-written CUDA kernels on the card (marker ``cuda``;
every test skips where ``torch.cuda.is_available()`` is False).  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain version (``block.*_plain``) at the
JAX suite's float32 tolerance: rtol 2e-4, atol 1e-5 x max(1,
|oracle|_inf).  A short fit on the card is held against the same fit with
``impl="ref"`` on the same plans at rtol 1e-3, atol 1e-4 x max(1,
|oracle|_inf): two epochs of float32 sums in another order, and
duplicate J indices scattered by atomics on the card.  Flash attention
and the SSD scan are held against their plain versions at the JAX
suite's float32 tolerances (``tests/test_kernels_models.py``): flash
2e-6, SSD rtol 1e-4 and atol 1e-4 x max(1, |oracle|_inf).  Given
bfloat16 inputs they are held against the plain version on the same
values in float32 at rtol 8e-3, one bfloat16 rounding of the output.
bf16 flash with head dim 64 or 128 runs on the sm90 tensor-core route,
every other flash call on the fp32 route (``kernel.select_route``).  The
matvec and vecmat of the six cross-term kinds with D <= 64 run on the sm90
TF32 tensor-core route (the cross term split three ways), the Laplacian
and wider D on the fp32 route (``block.select_matvec_route``), held to
the same float32 tolerance.
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.core import fit, sampler
from repro_torch.core.dsekl import DSEKLConfig, decision_function
from repro_torch.kernels.dsekl import block, ops
from repro_torch.serving import DSEKLPredictionEngine, EngineConfig

pytestmark = pytest.mark.cuda

KERNEL_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 1.0), ("degree", 2))),
    ("polynomial", (("gamma", 0.5), ("coef0", 0.0), ("degree", 3))),
    ("polynomial", (("gamma", 0.1), ("coef0", 2.0), ("degree", 2.5))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
IDS = [f"{k}-{i}" for i, (k, _) in enumerate(KERNEL_CASES)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _data(shape, device, seed=0):
    i, j, d = shape
    rng = np.random.default_rng(seed + 1000 * i + j)
    scale = 1.0 / np.sqrt(d)
    return [torch.tensor(v, dtype=torch.float32, device=device) for v in (
        rng.standard_normal((i, d)) * scale,
        rng.standard_normal((j, d)) * scale, rng.standard_normal(j))]


def _close(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("shape", [(1, 1, 1), (8, 8, 2), (1000, 5003, 54),
                                   (130, 700, 784), (65, 64, 33)])
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_kernel_matches_plain(cuda, kernel, params, shape):
    x, z, a = _data(shape, cuda)
    before = block.kernel_matvec_cuda.launches
    got = block.kernel_matvec_cuda(x, z, a, kernel_name=kernel,
                                   params=dict(params))
    torch.cuda.synchronize()
    assert block.kernel_matvec_cuda.launches == before + 1
    want = block.kernel_matvec_plain(x, z, a, kernel_name=kernel,
                                     params=dict(params))
    _close(got, want)


def test_kernel_is_bit_stable(cuda):
    """Partials are summed in a fixed order (no float atomics)."""
    x, z, a = _data((1024, 40000, 54), cuda)
    first = block.kernel_matvec_cuda(x, z, a)
    for _ in range(3):
        assert torch.equal(block.kernel_matvec_cuda(x, z, a), first)


def test_wrapper_rejects_bad_arguments(cuda):
    x, z, a = _data((16, 32, 4), cuda)
    before = block.kernel_matvec_cuda.launches
    with pytest.raises(TypeError):
        block.kernel_matvec_cuda(x.double(), z, a)
    with pytest.raises(ValueError):
        block.kernel_matvec_cuda(x.T, z, a)                 # not contiguous
    with pytest.raises(ValueError):
        block.kernel_matvec_cuda(x, z[:, :3].contiguous(), a)
    with pytest.raises(ValueError):
        block.kernel_matvec_cuda(x, z, a, kernel_name="cosine")
    assert block.kernel_matvec_cuda.launches == before
    assert block.kernel_matvec_cuda(x[:0], z, a).shape == (0,)


def test_ops_and_decision_function_launch_on_cuda(cuda):
    x, z, a = _data((37, 300, 5), cuda)
    want = ops.kernel_matvec(x, z, a, impl="ref")
    before = block.kernel_matvec_cuda.launches
    _close(ops.kernel_matvec(x, z, a), want)
    _close(ops.kernel_matvec_tiled(x, z, a, z_block=64), want)
    _close(decision_function(DSEKLConfig(), a, z, x, chunk=64), want)
    assert block.kernel_matvec_cuda.launches == before + 3


def test_engine_on_cuda_matches_ref_engine(cuda):
    x, z, a = _data((53, 147, 6), cuda)
    a = a * (a > -0.3)
    ec = EngineConfig(query_block=16, sv_block=32, max_queue=2)
    eng = DSEKLPredictionEngine(DSEKLConfig(), a, z, engine_cfg=ec,
                                device=cuda)
    ref = DSEKLPredictionEngine(DSEKLConfig(impl="ref"), a.cpu(), z.cpu(),
                                engine_cfg=ec, device="cpu")
    before = block.kernel_matvec_cuda.launches
    _close(eng.predict(x), ref.predict(x.cpu()))
    batches = [x[:7].cpu().numpy(), x[7:26].cpu().numpy(),
               x[26:27].cpu().numpy(), x[27:].cpu().numpy()]
    for b in batches:
        eng.submit(b)
        ref.submit(b)
    for o, r in zip(eng.flush_async(), ref.flush()):
        assert o.device.type == "cuda"
        _close(o, r)
    assert block.kernel_matvec_cuda.launches - before == eng.serve_calls


LOSSES = ("hinge", "squared_hinge", "square", "logistic")
TRAIN_SHAPES = [(1, 1, 1), (65, 64, 33), (1000, 5003, 54), (130, 700, 784),
                (1024, 1024, 54)]


def _train_data(shape, device, seed=0):
    x, z, a = _data(shape, device, seed)
    rng = np.random.default_rng(seed + 7)
    v = torch.tensor(rng.standard_normal(shape[0]), dtype=torch.float32,
                     device=device)
    y = torch.where(v >= 0, 1.0, -1.0)
    return x, z, a, v, y


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_vecmat_and_dual_pass_match_plain(cuda, kernel, params, shape):
    x, z, a, v, _ = _train_data(shape, cuda)
    kw = dict(kernel_name=kernel, params=dict(params))
    before = block.kernel_vecmat_cuda.launches
    _close(block.kernel_vecmat_cuda(x, z, v, **kw),
           block.kernel_vecmat_plain(x, z, v, **kw))
    assert block.kernel_vecmat_cuda.launches == before + 1
    before = block.dual_pass_cuda.launches
    got = block.dual_pass_cuda(x, z, a, v, f_scale=1.5, **kw)
    assert block.dual_pass_cuda.launches == before + 1
    for g, w in zip(got, block.dual_pass_plain(x, z, a, v, f_scale=1.5,
                                               **kw)):
        _close(g, w)


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_train_pass_matches_plain(cuda, kernel, params, loss, shape):
    x, z, a, v, y = _train_data(shape, cuda, seed=1)
    vy = v if loss == "square" else y
    kw = dict(kernel_name=kernel, params=dict(params), loss=loss,
              f_scale=2.0)
    before = block.train_pass_cuda.launches
    got = block.train_pass_cuda(x, z, a, vy, **kw)
    torch.cuda.synchronize()
    assert block.train_pass_cuda.launches == before + 1
    for g, w in zip(got, block.train_pass_plain(x, z, a, vy, **kw)):
        _close(g, w)


# The sm90 matvec route: I below one 128-row tile, ragged last support
# tiles (J % 128 in 1, 1, 11, 0, 1), D at 1, 3, 20, 33, 54 and the limit.
SM90_SHAPES = [(1, 1, 1), (8, 8, 3), (1000, 5003, 54), (65, 129, 64),
               (1024, 17664, 54), (37, 1000, 20), (130, 257, 33)]
SM90_IDS = [i for i, (k, _) in enumerate(KERNEL_CASES) if k != "laplacian"]


@pytest.mark.parametrize("shape", SM90_SHAPES, ids=str)
@pytest.mark.parametrize("case", SM90_IDS,
                         ids=[IDS[i] for i in SM90_IDS])
def test_matvec_sm90_route_matches_plain(cuda, case, shape):
    """The six cross-term kinds at D <= 64 launch the tensor-core kernel,
    matvec and vecmat alike, and meet the float32 tolerance."""
    kernel, params = KERNEL_CASES[case]
    kw = dict(kernel_name=kernel, params=dict(params))
    assert block.select_matvec_route(kernel, shape[2]) == "sm90"
    x, z, a = _data(shape, cuda)
    v = torch.tensor(np.random.default_rng(5).standard_normal(shape[0]),
                     dtype=torch.float32, device=cuda)
    fns = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
    before = [dict(f.launches_by_route) for f in fns]
    got = block.kernel_matvec_cuda(x, z, a, **kw)
    got_t = block.kernel_vecmat_cuda(x, z, v, **kw)
    torch.cuda.synchronize()
    for f, b in zip(fns, before):
        assert f.launches_by_route == {"sm90": b["sm90"] + 1,
                                       "fp32": b["fp32"]}
    _close(got, block.kernel_matvec_plain(x, z, a, **kw))
    _close(got_t, block.kernel_vecmat_plain(x, z, v, **kw))


def test_matvec_sm90_route_on_covertype_like_data(cuda):
    """RBF with gamma 1 on covertype-like rows (|x|^2 ~ 16.6), queries near
    support rows: one TF32 product would miss the tolerance here."""
    from repro_torch.data import make_covertype_like
    z, _ = make_covertype_like(20000, 54, seed=3, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = z[torch.randint(0, 20000, (1024,), generator=g, device=cuda)].clone()
    x[:, :10] += 0.3 * torch.randn((1024, 10), generator=g, device=cuda)
    a = torch.randn(20000, generator=g, device=cuda)
    kw = dict(kernel_name="rbf", params={"gamma": 1.0})
    before = block.kernel_matvec_cuda.launches_by_route["sm90"]
    got = block.kernel_matvec_cuda(x, z, a, **kw)
    assert block.kernel_matvec_cuda.launches_by_route["sm90"] == before + 1
    _close(got, block.kernel_matvec_plain(x, z, a, **kw))


@pytest.mark.parametrize("kernel,d", [("laplacian", 54), ("laplacian", 3),
                                      ("rbf", 65), ("polynomial", 784)])
def test_matvec_fp32_route_takes_the_rest(cuda, kernel, d):
    x, z, a = _data((100, 300, d), cuda)
    assert block.select_matvec_route(kernel, d) == "fp32"
    before = dict(block.kernel_matvec_cuda.launches_by_route)
    got = block.kernel_matvec_cuda(x, z, a, kernel_name=kernel)
    torch.cuda.synchronize()
    assert block.kernel_matvec_cuda.launches_by_route == {
        "sm90": before["sm90"], "fp32": before["fp32"] + 1}
    _close(got, block.kernel_matvec_plain(x, z, a, kernel_name=kernel))


def test_matvec_sm90_library_agrees_on_its_limit(cuda):
    lib = block._lib("sm90")
    lib.dsekl_matvec_sm90_max_d.restype = ctypes.c_int
    assert lib.dsekl_matvec_sm90_max_d() == block.SM90_MAX_D


def test_train_and_dual_pass_are_bit_stable(cuda):
    """Every sum in a fixed order, no float atomics in the kernels."""
    x, z, a, v, y = _train_data((1024, 3000, 54), cuda, seed=2)
    first = block.train_pass_cuda(x, z, a, y)
    dual = block.dual_pass_cuda(x, z, a, v)
    for _ in range(3):
        again = block.train_pass_cuda(x, z, a, y)
        assert all(torch.equal(p, q) for p, q in zip(again, first))
        again = block.dual_pass_cuda(x, z, a, v)
        assert all(torch.equal(p, q) for p, q in zip(again, dual))


def test_vecmat_is_the_transposed_matvec_bit_for_bit(cuda):
    x, z, _, v, _ = _train_data((300, 500, 20), cuda, seed=3)
    for kernel, params in KERNEL_CASES:
        kw = dict(kernel_name=kernel, params=dict(params))
        assert torch.equal(block.kernel_vecmat_cuda(x, z, v, **kw),
                           block.kernel_matvec_cuda(z, x, v, **kw))


def test_train_wrappers_reject_bad_arguments(cuda, monkeypatch):
    x, z, a, v, y = _train_data((16, 32, 4), cuda)
    # The stash budget binds the fp32 route: J wider than the sm90 one.
    wide = _train_data((16, block.SM90_TRAIN_MAX_J + 1, 4), cuda)
    counters = (block.kernel_vecmat_cuda, block.dual_pass_cuda,
                block.train_pass_cuda)
    before = [c.launches for c in counters]
    with pytest.raises(TypeError):
        block.train_pass_cuda(x, z, a.double(), y)
    with pytest.raises(ValueError):
        block.dual_pass_cuda(x.T, z, a, v)                   # not contiguous
    with pytest.raises(ValueError):
        block.train_pass_cuda(x, z, a[:5].contiguous(), y)   # a is not (J,)
    with pytest.raises(ValueError):
        block.kernel_vecmat_cuda(x, z, a)                    # v is not (I,)
    with pytest.raises(ValueError):
        block.train_pass_cuda(x, z, a, y, kernel_name="cosine")
    with pytest.raises(ValueError, match="unknown loss"):
        block.train_pass_cuda(x, z, a, y, loss="huber")
    monkeypatch.setattr(block, "STASH_BUDGET", 0)
    with pytest.raises(ValueError, match="STASH_BUDGET"):
        block.train_pass_cuda(wide[0], wide[1], wide[2], wide[4])
    assert [c.launches for c in counters] == before
    f, g = block.train_pass_cuda(x[:0], z, a, y[:0])
    assert f.shape == (0,) and g.shape == (32,) and not g.any()


def test_ops_launch_on_cuda_and_fall_back_over_budget(cuda, monkeypatch):
    # J wider than the sm90 train route: the fp32 route, whose stash the
    # budget bounds.
    x, z, a, v, y = _train_data((37, block.SM90_TRAIN_MAX_J + 252, 5), cuda,
                                seed=4)
    kw = dict(loss="hinge", f_scale=3.0)
    want = ops.kernel_dual_pass(x, z, a, y, impl="ref", **kw)
    counts = [c.launches for c in (block.train_pass_cuda,
                                   block.kernel_matvec_cuda,
                                   block.kernel_vecmat_cuda)]
    for g, w in zip(ops.kernel_dual_pass(x, z, a, y, **kw), want):
        _close(g, w)
    monkeypatch.setattr(block, "STASH_BUDGET", 0)
    for g, w in zip(ops.kernel_dual_pass(x, z, a, y, **kw), want):
        _close(g, w)
    torch.cuda.synchronize()
    assert [c.launches for c in (block.train_pass_cuda,
                                 block.kernel_matvec_cuda,
                                 block.kernel_vecmat_cuda)] == [
        counts[0] + 1, counts[1] + 1, counts[2] + 1]
    _close(ops.kernel_vecmat(x, z, v), ops.kernel_vecmat(x, z, v, impl="ref"))


def test_short_fit_on_the_card_matches_ref(cuda):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4096, 6)).astype(np.float32)
    y = np.where(x[:, 0] * x[:, 1] > 0, 1.0, -1.0).astype(np.float32)
    cfg = DSEKLConfig(n_grad=256, n_expand=256, loss="square",
                      schedule="adagrad", lam=1e-4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    plans = [sampler.epoch_plan(gen, 4096, 256, 256, 16) for _ in range(2)]
    before = block.train_pass_indexed_cuda.launches_by_route["sm90"]
    card = fit(cfg, x, y, plans=plans, n_epochs=2, tol=0.0, x_val=x[:512],
               y_val=y[:512], device=cuda)
    assert (block.train_pass_indexed_cuda.launches_by_route["sm90"]
            == before + 32)
    ref = fit(cfg.replace(impl="ref"), x, y, plans=plans, n_epochs=2,
              tol=0.0, device=cuda)
    want = ref.state.alpha.double().cpu().numpy()
    np.testing.assert_allclose(card.state.alpha.double().cpu().numpy(), want,
                               rtol=1e-3,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    assert int(card.state.step) == 32
    assert all(0.0 <= h["val_error"] <= 1.0 for h in card.history)


# The sm90 train route (csrc/dsekl_train_sm90.cu): one cluster launch,
# rows read by index.  Shapes: one row block and one tile, ragged tiles
# past one 80-row block, the main path's step and its ragged neighbour,
# D 784 at the widest J, and many row blocks over a narrow J.
SM90_TRAIN_SHAPES = [(1, 1, 1), (81, 129, 54), (1000, 1000, 54),
                     (1024, 1024, 54), (130, 1024, 784), (3000, 700, 3)]


@pytest.mark.parametrize("shape", SM90_TRAIN_SHAPES, ids=str)
@pytest.mark.parametrize("loss", (None,) + LOSSES, ids=str)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_train_sm90_route_matches_plain(cuda, kernel, params, loss, shape):
    """The train pass (each loss) and the dual pass (loss None) on the sm90
    route, against their plain versions at the float32 tolerance."""
    assert block.select_train_route(shape[0], shape[1], shape[2],
                                     kernel) == "sm90"
    x, z, a, v, y = _train_data(shape, cuda, seed=11)
    kw = dict(kernel_name=kernel, params=dict(params), f_scale=1.7)
    wrapper = block.dual_pass_cuda if loss is None else block.train_pass_cuda
    before = dict(wrapper.launches_by_route)
    if loss is None:
        got = block.dual_pass_cuda(x, z, a, v, **kw)
        want = block.dual_pass_plain(x, z, a, v, **kw)
    else:
        vy = v if loss == "square" else y
        got = block.train_pass_cuda(x, z, a, vy, loss=loss, **kw)
        want = block.train_pass_plain(x, z, a, vy, loss=loss, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches_by_route == {"sm90": before["sm90"] + 1,
                                         "fp32": before["fp32"]}
    for g, w in zip(got, want):
        _close(g, w)


def _indexed_data(n, shape, device, seed=0):
    """x (n, D), y, alpha (n,) and (I,), (J,) int64 indices with
    duplicates (drawn with replacement from a quarter of the rows)."""
    i, j, d = shape
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((n, d)) / np.sqrt(d),
                     dtype=torch.float32, device=device)
    y = torch.tensor(np.where(rng.standard_normal(n) >= 0, 1.0, -1.0),
                     dtype=torch.float32, device=device)
    alpha = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                         device=device)
    idx_i = torch.tensor(rng.integers(0, n // 4, i), device=device)
    idx_j = torch.tensor(rng.integers(0, n // 4, j), device=device)
    return x, y, alpha, idx_i, idx_j


@pytest.mark.parametrize("shape", [(1024, 1024, 54), (1000, 1000, 54),
                                   (80, 1024, 7)], ids=str)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_train_pass_indexed_equals_gathered_bitwise(cuda, kernel, params,
                                                    shape):
    """Rows read by index give the bits of the same kernel on the rows
    gathered beforehand (duplicate J positions each their own g); with lam
    the ridge term is added as torch adds it; and both meet the plain
    version at the float32 tolerance."""
    x, y, alpha, idx_i, idx_j = _indexed_data(6000, shape, cuda)
    kw = dict(kernel_name=kernel, params=dict(params), loss="logistic",
              f_scale=1.3)
    before = dict(block.train_pass_indexed_cuda.launches_by_route)
    f, g = block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j, **kw)
    wf, wg = block.train_pass_cuda(x[idx_i], x[idx_j], alpha[idx_j],
                                   y[idx_i], **kw)
    assert torch.equal(f, wf) and torch.equal(g, wg)
    lam = 1e-3
    f2, g2 = block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j,
                                           lam=lam, **kw)
    assert torch.equal(f2, f) and torch.equal(g2, g + lam * alpha[idx_j])
    torch.cuda.synchronize()
    assert block.train_pass_indexed_cuda.launches_by_route == {
        "sm90": before["sm90"] + 2, "fp32": before["fp32"]}
    pf, pg = block.train_pass_indexed_plain(x, y, alpha, idx_i, idx_j,
                                            lam=lam, **kw)
    _close(f2, pf)
    _close(g2, pg)


def test_train_sm90_is_bit_stable_over_64_calls(cuda):
    """Thirteen row blocks meet through the arrival counters: 64 calls in
    a row give the same bits, so every launch leaves the counters at 0."""
    x, y, alpha, idx_i, idx_j = _indexed_data(50000, (1024, 1024, 54), cuda,
                                              seed=3)
    first = block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j,
                                          lam=1e-4)
    v = torch.randn(1024, device=cuda)
    xi, xj, aj = x[idx_i], x[idx_j], alpha[idx_j]
    dual = block.dual_pass_cuda(xi, xj, aj, v)
    for _ in range(64):
        again = block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j,
                                              lam=1e-4)
        assert all(torch.equal(p, q) for p, q in zip(again, first))
        again = block.dual_pass_cuda(xi, xj, aj, v)
        assert all(torch.equal(p, q) for p, q in zip(again, dual))
    counters = block._SM90_SCRATCH[(torch.cuda.current_device(),
                                    torch.cuda.current_stream().cuda_stream)]
    assert not counters["counters"].any()


def test_train_routes_count_each_launch(cuda):
    """Each wrapper counts one launch a call on the route its shape takes:
    sm90 up to SM90_TRAIN_MAX_J, fp32 past it."""
    for shape, route in [((1000, 1000, 54), "sm90"),
                         ((1000, 5003, 54), "fp32")]:
        x, z, a, v, y = _train_data(shape, cuda, seed=5)
        assert block.select_train_route(*shape, "rbf") == route
        idx_i = torch.arange(shape[0], device=cuda)
        idx_j = torch.arange(shape[1], device=cuda) % shape[0]
        calls = [(block.train_pass_cuda, lambda: block.train_pass_cuda(
                     x, z, a, y)),
                 (block.dual_pass_cuda, lambda: block.dual_pass_cuda(
                     x, z, a, v)),
                 (block.train_pass_indexed_cuda,
                  lambda: block.train_pass_indexed_cuda(x, y, a[:shape[0]],
                                                        idx_i, idx_j))]
        for wrapper, call in calls:
            before = dict(wrapper.launches_by_route)
            n = wrapper.launches
            call()
            torch.cuda.synchronize()
            before[route] += 1
            assert wrapper.launches_by_route == before
            assert wrapper.launches == n + 1


def test_train_sm90_library_agrees_on_its_limits(cuda):
    lib = block._train_sm90_lib()
    lib.dsekl_train_sm90_rows.restype = ctypes.c_int
    assert lib.dsekl_train_sm90_max_j() == block.SM90_TRAIN_MAX_J
    assert lib.dsekl_train_sm90_rows() == block.SM90_TRAIN_ROWS
    assert lib.dsekl_train_sm90_active_clusters(0, 1024) >= 1


def test_train_pass_indexed_rejects_bad_indices(cuda):
    x, y, alpha, idx_i, idx_j = _indexed_data(100, (16, 32, 4), cuda)
    before = block.train_pass_indexed_cuda.launches
    with pytest.raises(TypeError):
        block.train_pass_indexed_cuda(x, y, alpha, idx_i.int(), idx_j)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        block.train_pass_indexed_cuda(x, y, alpha, idx_i.cpu(), idx_j)
    with pytest.raises(ValueError, match="contiguous vector"):
        block.train_pass_indexed_cuda(x, y, alpha, idx_i[None], idx_j)
    with pytest.raises(ValueError):
        block.train_pass_indexed_cuda(x, y[:5].contiguous(), alpha, idx_i,
                                      idx_j)
    assert block.train_pass_indexed_cuda.launches == before


def test_train_pass_indexed_traps_on_an_index_out_of_range(cuda):
    """An index outside [0, N) stops the kernel (a trap, as x[idx] fails on
    the card) and never reads past x; the context is lost, so the call
    runs in a process of its own."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = (
        "import torch\n"
        "from repro_torch.kernels.dsekl import block\n"
        "x = torch.randn(100, 4, device='cuda')\n"
        "y = torch.ones(100, device='cuda')\n"
        "i = torch.arange(16, device='cuda')\n"
        "j = torch.arange(32, device='cuda'); j[7] = 100\n"
        "block.train_pass_indexed_cuda(x, y, y, i, j)\n"
        "torch.cuda.synchronize()\n"
        "print('NO TRAP')\n")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and "NO TRAP" not in out.stdout, out.stdout


# ---------------------------------------------------------------------------
# Flash attention and the SSD scan (the LM prefill's kernels).
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (b, s, t, h, kv, d, causal, window)
    (2, 128, 128, 4, 2, 64, True, 1 << 30),
    (1, 256, 256, 2, 2, 32, True, 64),
    (2, 128, 256, 4, 1, 64, False, 1 << 30),
    (1, 128, 128, 2, 2, 128, True, 1 << 30),
    (1, 200, 200, 32, 8, 128, True, 1 << 30),    # ragged, jamba's GQA 32/8
    (2, 200, 333, 4, 1, 64, False, 64),           # ragged S != T
    (1, 130, 130, 4, 4, 16, True, 0),             # no valid key: mean(v)
    (1, 130, 130, 4, 2, 48, False, 0),
    (1, 24, 24, 4, 1, 16, True, 16),
]


def _flash_data(case, device, dtype, seed=0):
    b, s, t, h, kv, d = case[:6]
    g = torch.Generator(device="cpu").manual_seed(seed + s + t + h + d)
    return [torch.randn(sh, generator=g).to(device=device, dtype=dtype)
            for sh in ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-6, 2e-6),
                                             (torch.bfloat16, 8e-3, 1e-5)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_attention_matches_plain(cuda, case, dtype, rtol, atol):
    """float32: the JAX suite's 2e-6.  bfloat16 inputs are converted to
    float32 at load, so the kernel is held against the plain version on
    the same values in float32: one bfloat16 rounding of the output (rtol
    8e-3) and float32 summation order (atol 1e-5 x max(1, |oracle|_inf))."""
    from repro_torch.kernels.flash_attn import flash_attention, kernel
    causal, window = case[6], case[7]
    q, k, v = _flash_data(case, cuda, dtype)
    before = kernel.flash_attention_cuda.launches
    got = kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kernel.flash_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention(q.float(), k.float(), v.float(), causal=causal,
                           window=window, impl="ref").cpu().numpy()
    scale = max(1.0, float(np.abs(want).max())) if dtype == torch.bfloat16 \
        else 1.0
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=rtol,
                               atol=atol * scale)


# bf16 cases of the sm90 route (D 64 and 128): GQA 32/8 and 4/1, causal
# and not, window 64 and 0 (the mean-of-v rows), ragged S, S != T, and
# lengths at the edges of the kernel's 128-row tiles.
SM90_CASES = [
    # (b, s, t, h, kv, d, causal, window)
    (2, 256, 256, 32, 8, 128, True, 1 << 30),
    (2, 256, 256, 4, 1, 64, False, 1 << 30),
    (1, 256, 256, 8, 2, 64, True, 64),
    (1, 300, 300, 4, 1, 128, False, 64),
    (1, 130, 130, 4, 2, 128, True, 0),           # no valid key: mean(v)
    (1, 130, 130, 4, 1, 64, False, 0),
    (2, 200, 200, 32, 8, 128, True, 1 << 30),    # ragged S
    (2, 200, 333, 4, 1, 64, False, 1 << 30),     # S != T
    (1, 333, 200, 4, 1, 128, True, 1 << 30),     # S > T
] + [c for n in (127, 128, 129, 255, 257) for c in (
    (1, n, n, 32, 8, 128, True, 1 << 30),
    (1, n, n + 3, 4, 1, 64, False, 1 << 30))]


@pytest.mark.parametrize("case", SM90_CASES, ids=str)
def test_flash_sm90_route_matches_plain(cuda, case):
    """The tensor-core kernel on bf16 inputs, held against the plain
    version on the same values in float32 at the bf16 tolerance above
    (rtol 8e-3, atol 1e-5 x max(1, |oracle|_inf)); launched on the sm90
    route, and bit-stable over two runs."""
    from repro_torch.kernels.flash_attn import flash_attention, kernel
    causal, window = case[6], case[7]
    q, k, v = _flash_data(case, cuda, torch.bfloat16)
    assert kernel.select_route(q.dtype, case[5], case[3], case[4]) == "sm90"
    before = dict(kernel.flash_attention_cuda.launches_by_route)
    got = kernel.flash_attention_cuda(q, k, v, causal=causal, window=window)
    again = kernel.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window)
    torch.cuda.synchronize()
    after = kernel.flash_attention_cuda.launches_by_route
    assert after["sm90"] == before["sm90"] + 2
    assert after["fp32"] == before["fp32"]
    assert torch.equal(got, again)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention(q.float(), k.float(), v.float(), causal=causal,
                           window=window, impl="ref").cpu().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().cpu().numpy(), want, rtol=8e-3,
                               atol=1e-5 * scale)


def test_flash_sm90_wrapper_refuses_and_routes_by_shape(cuda):
    """Misaligned or strided bf16 input raises without a launch; a bf16
    head dim other than 64 or 128 goes to the fp32 route."""
    from repro_torch.kernels.flash_attn import kernel
    fn = kernel.flash_attention_cuda
    q, k, v = _flash_data((1, 128, 128, 4, 2, 64), cuda, torch.bfloat16)
    before = fn.launches
    flat = torch.zeros(q.numel() + 8, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:1 + q.numel()].view(q.shape)      # 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fn(shifted, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q, k[:, ::2], v[:, ::2])
    assert fn.launches == before
    q, k, v = _flash_data((1, 130, 130, 4, 2, 48), cuda, torch.bfloat16)
    by_route = dict(fn.launches_by_route)
    fn(q, k, v, causal=False, window=0)
    torch.cuda.synchronize()
    assert fn.launches_by_route["fp32"] == by_route["fp32"] + 1
    assert fn.launches_by_route["sm90"] == by_route["sm90"]


def test_flash_wrapper_rejects_bad_arguments(cuda):
    from repro_torch.kernels.flash_attn import kernel
    q, k, v = _flash_data(FLASH_CASES[0], cuda, torch.float32)
    before = kernel.flash_attention_cuda.launches
    with pytest.raises(TypeError):
        kernel.flash_attention_cuda(q.double(), k, v)
    with pytest.raises(ValueError):
        kernel.flash_attention_cuda(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        kernel.flash_attention_cuda(q[:, :, :3].contiguous(), k, v)  # 3 % 2
    with pytest.raises(ValueError):
        big = torch.zeros((1, 8, 2, 160), device=cuda)
        kernel.flash_attention_cuda(big, big, big)
    assert kernel.flash_attention_cuda.launches == before


SSD_CASES = [
    # (b, s, nh, hd, g, n, chunk)
    (2, 64, 4, 16, 2, 8, 16),
    (1, 128, 2, 32, 1, 16, 32),
    (2, 512, 8, 64, 1, 16, 256),       # jamba's hd / n
    (1, 300, 4, 64, 1, 128, 128),      # mamba2's n, a ragged last chunk
    (2, 200, 4, 64, 2, 16, 256),       # one partial chunk
    (1, 1000, 2, 64, 1, 128, 256),
]


def _ssd_data(case, device, seed=0):
    b, s, nh, hd, g, n = case[:6]
    gen = torch.Generator(device="cpu").manual_seed(seed + sum(case))
    x = torch.randn((b, s, nh, hd), generator=gen)
    dt = torch.nn.functional.softplus(torch.randn((b, s, nh), generator=gen))
    a = -torch.exp(torch.randn((nh,), generator=gen) * 0.5)
    bmat = torch.randn((b, s, g, n), generator=gen)
    cmat = torch.randn((b, s, g, n), generator=gen)
    return [t.to(device) for t in (x, dt, a, bmat, cmat)]


def _ssd_close(got, want):
    """The JAX suite's tolerance, rtol 1e-4 and atol 1e-4, with atol taken
    relative to max(1, |want|_inf): y grows with n and S (|y| ~ 100 at
    n = 128, S = 1000), and the chunked sums then differ from the
    sequential ones by ~1e-6 of that scale, 2e-4 in absolute terms."""
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_matches_plain(cuda, case):
    from repro_torch.kernels.ssd import kernel, ssd_chunked
    args = _ssd_data(case, cuda)
    before = kernel.ssd_cuda.launches
    y, final = kernel.ssd_cuda(*args, chunk=case[6])
    torch.cuda.synchronize()
    assert kernel.ssd_cuda.launches == before + 1
    wy, wf = ssd_chunked(*args, chunk=case[6], impl="ref")
    _ssd_close(y, wy)
    _ssd_close(final, wf)


def test_ssd_bfloat16_matches_plain_on_the_same_values(cuda):
    """bfloat16 inputs are converted to float32 at load, so the kernel is
    held against the plain version on the same values in float32; y comes
    back in bfloat16 (one rounding: rtol 8e-3)."""
    from repro_torch.kernels.ssd import kernel, ssd_chunked
    x, dt, a, bm, cm = _ssd_data((2, 300, 8, 64, 1, 16, 256), cuda)
    x, dt, bm, cm = (t.to(torch.bfloat16) for t in (x, dt, bm, cm))
    y, final = kernel.ssd_cuda(x, dt, a, bm, cm, chunk=256)
    assert y.dtype == torch.bfloat16
    wy, wf = ssd_chunked(x.float(), dt.float(), a, bm.float(), cm.float(),
                         impl="ref")
    np.testing.assert_allclose(y.float().cpu().numpy(), wy.cpu().numpy(),
                               rtol=8e-3, atol=1e-3)
    _ssd_close(final, wf)


# bf16 cases of the sm90 route (hd 64, n a multiple of 16 up to 128, chunk
# 64..256): lengths at the chunk's edges and one no chunk divides, chunk
# 128 and 256 (and 192, 64), g 1, 2 and 4, n 16, 48, 64 and 128, S under
# one chunk, and a fast decay (dt x 10: exp(cum) underflows within a
# chunk).
SSD_SM90_CASES = [
    # (b, s, nh, hd, g, n, chunk, dt_scale)
    (2, 255, 8, 64, 1, 16, 256, 1.0),
    (2, 256, 8, 64, 1, 16, 256, 1.0),
    (2, 257, 8, 64, 1, 16, 256, 1.0),
    (1, 1000, 4, 64, 1, 16, 256, 1.0),
    (1, 1000, 4, 64, 1, 128, 256, 1.0),
    (1, 255, 4, 64, 1, 128, 128, 1.0),
    (1, 257, 4, 64, 1, 128, 128, 1.0),
    (2, 600, 8, 64, 2, 16, 128, 1.0),
    (1, 600, 8, 64, 4, 64, 192, 1.0),
    (1, 300, 4, 64, 1, 48, 64, 1.0),
    (1, 100, 4, 64, 1, 16, 256, 1.0),
    (1, 520, 4, 64, 1, 16, 256, 10.0),
    (1, 520, 4, 64, 1, 128, 256, 10.0),
    (4, 2048, 16, 64, 1, 16, 256, 1.0),          # jamba's served S
]


@pytest.mark.parametrize("case", SSD_SM90_CASES, ids=str)
def test_ssd_sm90_route_matches_plain(cuda, case):
    """The tensor-core kernel on bf16 inputs, held against the plain
    version on the same values in float32: y at rtol 8e-3, atol 1e-4 x
    max(1, |oracle|_inf) (one bf16 rounding), the float32 final state at
    the float32 tolerance; launched on the sm90 route, and bit-stable over
    two runs."""
    from repro_torch.kernels.ssd import kernel, ssd_chunked
    b, s, nh, hd, g, n, chunk, dt_scale = case
    x, dt, a, bm, cm = _ssd_data(case[:7], cuda)
    x, dt, bm, cm = (t.to(torch.bfloat16) for t in (x, dt * dt_scale, bm, cm))
    assert kernel.select_route(x.dtype, hd, n, chunk) == "sm90"
    before = dict(kernel.ssd_cuda.launches_by_route)
    y, final = kernel.ssd_cuda(x, dt, a, bm, cm, chunk=chunk)
    y2, final2 = kernel.ssd_cuda(x, dt, a, bm, cm, chunk=chunk)
    torch.cuda.synchronize()
    after = kernel.ssd_cuda.launches_by_route
    assert after["sm90"] == before["sm90"] + 2
    assert after["fp32"] == before["fp32"]
    assert torch.equal(y, y2) and torch.equal(final, final2)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    wy, wf = ssd_chunked(x.float(), dt.float(), a, bm.float(), cm.float(),
                         chunk=chunk, impl="ref")
    want = wy.cpu().numpy()
    np.testing.assert_allclose(y.float().cpu().numpy(), want, rtol=8e-3,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))
    _ssd_close(final, wf)


def test_ssd_sm90_wrapper_refuses_and_routes_by_shape(cuda):
    """Misaligned bf16 input raises without a launch; bf16 at a shape the
    sm90 kernel does not take goes to the fp32 route."""
    from repro_torch.kernels.ssd import kernel
    fn = kernel.ssd_cuda
    x, dt, a, bm, cm = (t.to(torch.bfloat16) if t.dim() > 1 else t
                        for t in _ssd_data((1, 128, 4, 64, 1, 16, 128), cuda))
    before = fn.launches
    flat = torch.zeros(x.numel() + 8, device=cuda, dtype=torch.bfloat16)
    shifted = flat[1:1 + x.numel()].view(x.shape)       # 2 bytes off
    with pytest.raises(ValueError, match="aligned"):
        fn(shifted, dt, a, bm, cm, chunk=128)
    assert fn.launches == before
    for chunk, case in ((100, (1, 128, 4, 64, 1, 16, 100)),
                        (128, (1, 128, 4, 32, 1, 16, 128)),
                        (128, (1, 128, 4, 64, 1, 8, 128))):
        x, dt, a, bm, cm = (t.to(torch.bfloat16) if t.dim() > 1 else t
                            for t in _ssd_data(case, cuda))
        by_route = dict(fn.launches_by_route)
        fn(x, dt, a, bm, cm, chunk=chunk)
        torch.cuda.synchronize()
        assert fn.launches_by_route["fp32"] == by_route["fp32"] + 1
        assert fn.launches_by_route["sm90"] == by_route["sm90"]


@pytest.mark.parametrize("flag", [True, False])
def test_ref_calls_on_the_card_restore_the_tf32_setting(cuda, flag):
    """A plain (``impl="ref"``) DSEKL or SSD call on CUDA tensors leaves
    the process's TF32 setting as it found it."""
    from repro_torch.kernels.ssd import ssd_chunked
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = flag
    try:
        x, z, a = _data((64, 100, 5), cuda)
        ops.kernel_matvec(x, z, a, impl="ref")
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        block.kernel_matvec_plain(x, z, a)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
        ssd_chunked(*_ssd_data(SSD_CASES[0], cuda), chunk=16, impl="ref")
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_ssd_wrapper_rejects_bad_arguments(cuda):
    from repro_torch.kernels.ssd import kernel
    x, dt, a, bm, cm = _ssd_data(SSD_CASES[0], cuda)
    before = kernel.ssd_cuda.launches
    with pytest.raises(TypeError):
        kernel.ssd_cuda(x.double(), dt, a, bm, cm)
    with pytest.raises(ValueError):
        kernel.ssd_cuda(x, dt, a, bm[:, :, :1].contiguous(),
                        cm[:, :, :1].contiguous(), chunk=0)
    with pytest.raises(ValueError):
        kernel.ssd_cuda(x, dt, a, bm[:, :, :, :3], cm)     # not contiguous
    assert kernel.ssd_cuda.launches == before
