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
matvec and vecmat of the six cross-term kinds run on the TF32 tensor
cores (the cross term split three ways): with D <= 64 on the sm90 route,
at wider D on the sm90_wide route (a loop over D); the Laplacian on the
fp32 route (``block.select_matvec_route``), held to the same float32
tolerance.  The train pass's sm90 route keeps K in
registers up to J = 1,024 and in shared memory past it (the wide
variant, up to 4,096), and the fp32 route takes wider J; Algorithm 2's
step at the protocol's shape (J union 4,096) takes the wide variant,
and past 4,096 the fp32 route, each held to the same tolerance; the
hosted prefetcher's pinned, copy-streamed blocks must equal
``SyncGather``'s exactly under a delayed consumer, and a hosted
Algorithm-2 fit must equal the in-memory one bit for bit.  A publish from
a second thread on a stream of its own must never reach a sweep torn, and
a flush must not wait for work queued on that stream; the online service
on the card answers every ticket once, bit-identical to its version's
oracle, on the sm90 routes.  deepseek-v3's absorbed MLA decode equals its
expanded prefill at full attention widths (float32 at 1e-4, bfloat16 at
3e-2 x |expanded|_inf).
"""
import ctypes
import threading
import time

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
        assert f.launches_by_route == dict(b, sm90=b["sm90"] + 1)
    _close(got, block.kernel_matvec_plain(x, z, a, **kw))
    _close(got_t, block.kernel_vecmat_plain(x, z, v, **kw))


# The sm90_wide route: I below, at and past one 128-row query tile, ragged
# (I % 128 in 1, 37, 104, 1, 44, 0 and J % 128 in 1, 1, 11, 75, 104, 0), D
# past the sm90 route's limit with a ragged last slab (65; 784 = 24.5
# slabs) and whole slabs (1,536, lm-readout's).
WIDE_SHAPES = [(1, 1, 65), (37, 129, 65), (1000, 5003, 784),
               (257, 331, 784), (300, 1000, 1536), (1024, 2048, 1536)]


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=str)
@pytest.mark.parametrize("case", SM90_IDS,
                         ids=[IDS[i] for i in SM90_IDS])
def test_matvec_sm90_wide_route_matches_plain(cuda, case, shape):
    """The D-looped tensor-core kernel for the six cross-term kinds at D >
    64, matvec and vecmat (operands swapped), meets the float32 tolerance;
    the wrappers launch it once a call on that route."""
    kernel, params = KERNEL_CASES[case]
    kw = dict(kernel_name=kernel, params=dict(params))
    x, z, a = _data(shape, cuda)
    v = torch.tensor(np.random.default_rng(6).standard_normal(shape[0]),
                     dtype=torch.float32, device=cuda)
    assert block.select_matvec_route(kernel, shape[2]) == "sm90_wide"
    fns = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
    before = [(f.launches, dict(f.launches_by_route)) for f in fns]
    got = block.kernel_matvec_cuda(x, z, a, **kw)
    got_t = block.kernel_vecmat_cuda(x, z, v, **kw)
    torch.cuda.synchronize()
    for f, (n, b) in zip(fns, before):
        assert f.launches == n + 1
        assert f.launches_by_route == dict(b, sm90_wide=b["sm90_wide"] + 1)
    _close(got, block.kernel_matvec_plain(x, z, a, **kw))
    _close(got_t, block.kernel_vecmat_plain(x, z, v, **kw))


def test_matvec_sm90_wide_route_on_mnist_like_data(cuda):
    """RBF at MNIST's width and gamma rule (values in [0, 1], ~19%
    non-zero, gamma 1 / (D var)), queries near support rows: the serving
    cell's numbers."""
    g = torch.Generator(device=cuda).manual_seed(7)
    z = torch.rand((20000, 784), generator=g, device=cuda)
    z = z * (torch.rand((20000, 784), generator=g, device=cuda) < 0.19)
    x = z[torch.randint(0, 20000, (1024,), generator=g, device=cuda)].clone()
    x += 0.05 * torch.rand((1024, 784), generator=g, device=cuda)
    a = torch.randn(20000, generator=g, device=cuda)
    kw = dict(kernel_name="rbf",
              params={"gamma": 1.0 / (784 * float(z.var()))})
    before = block.kernel_matvec_cuda.launches_by_route["sm90_wide"]
    got = block.kernel_matvec_cuda(x, z, a, **kw)
    assert (block.kernel_matvec_cuda.launches_by_route["sm90_wide"]
            == before + 1)
    _close(got, block.kernel_matvec_plain(x, z, a, **kw))


def test_matvec_sm90_wide_route_is_bit_stable(cuda):
    """Partials in a fixed order, no float atomics: two launches, and the
    vecmat against the matvec on the swapped operands, bit for bit."""
    x, z, a = _data((1024, 9000, 784), cuda)
    v = torch.tensor(np.random.default_rng(8).standard_normal(1024),
                     dtype=torch.float32, device=cuda)
    first = block.kernel_matvec_cuda(x, z, a)
    assert torch.equal(block.kernel_matvec_cuda(x, z, a), first)
    assert torch.equal(block.kernel_vecmat_cuda(x, z, v),
                       block.kernel_matvec_cuda(z, x, v))


def test_matvec_sm90_wide_refuses_what_it_cannot_launch(cuda):
    """The Laplacian (no product) and a support split that does not cover
    J are refused by the library with an error, and raise through
    launch_matvec; nothing is counted."""
    lib = block._lib("sm90_wide")
    x, z, a = _data((64, 300, 784), cuda)
    out = torch.empty(64, device=cuda)
    scratch = torch.empty(
        (lib.dsekl_matvec_sm90_wide_scratch_floats(64, 300, 784, 1),),
        device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), z.data_ptr(), a.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 64, 300, 784)
    scalars = (1.0, 0.0, 0.0, 1, 0, 1.0)
    err = lib.dsekl_matvec_sm90_wide(*args, block.KINDS["laplacian"],
                                     *scalars, 1, 3, stream)
    assert err != 0
    assert b"Laplacian" in lib.dsekl_matvec_sm90_wide_error_string(err)
    assert lib.dsekl_matvec_sm90_wide(*args, block.KINDS["rbf"], *scalars,
                                      1, 2, stream) == -1   # 256 rows < J
    assert lib.dsekl_matvec_sm90_wide_blocks_per_sm(
        block.KINDS["laplacian"]) == -1
    fns = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
    before = [(f.launches, dict(f.launches_by_route)) for f in fns]
    with pytest.raises(RuntimeError):
        block.launch_matvec(lib, "sm90_wide", x, z, a,
                            block.KINDS["laplacian"], {})
    assert [(f.launches, f.launches_by_route) for f in fns] == before
    assert lib.dsekl_matvec_sm90_wide_blocks_per_sm(block.KINDS["rbf"]) == 1


def test_matvec_sm90_wide_scratch_is_bounded_at_many_queries(cuda):
    """The vecmat over a support set of 200,000 rows at D 784 (the
    kernel's query side, operands swapped) splits 16,384 rows at a time:
    the scratch's split copy does not grow with the row count, the call
    allocates no more than its scratch and output, and the chunked result
    meets the float32 tolerance, its rows past the first chunk bit for bit
    those of a call on them alone."""
    lib = block._lib("sm90_wide")
    n_big, n_small, d = 200000, 256, 784
    split = 2 * 16384 * 800                     # 128 tiles x 25 slabs x 2
    for n in (n_big, 10 ** 7):
        assert lib.dsekl_matvec_sm90_wide_scratch_floats(
            n, n_small, d, 1) == split + 2 * n + n_small
    assert lib.dsekl_matvec_sm90_wide_scratch_floats(
        1024, 32768, d, 16) == 2 * 1024 * 800 + 17 * 1024 + 32768
    g = torch.Generator(device=cuda).manual_seed(9)
    sv = torch.rand((n_big, d), generator=g, device=cuda)
    q = sv[:n_small] + 0.02 * torch.rand((n_small, d), generator=g,
                                         device=cuda)
    v = torch.randn(n_small, generator=g, device=cuda)
    kw = dict(kernel_name="rbf", params={"gamma": 1.0 / d})
    block.kernel_vecmat_cuda(q, sv[:1000], v, **kw)   # built, resident
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = block.kernel_vecmat_cuda(q, sv, v, **kw)
    torch.cuda.synchronize()
    n_split, _ = block.split_support(
        n_big, n_small, block._resident_blocks(
            "sm90_wide", block.KINDS["rbf"], d, torch.cuda.current_device()),
        block.MATVEC_TILE["sm90_wide"])
    scratch = lib.dsekl_matvec_sm90_wide_scratch_floats(n_big, n_small, d,
                                                        n_split)
    assert scratch < split + 8 * n_big
    assert torch.cuda.max_memory_allocated() - base <= \
        4 * (scratch + n_big) + (4 << 20)
    _close(got, block.kernel_vecmat_plain(q, sv, v, **kw))
    tail = sv[16384:].contiguous()
    assert torch.equal(got[16384:],
                       block.kernel_vecmat_cuda(q, tail, v, **kw))


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
                                      ("laplacian", 65),
                                      ("laplacian", 784), ("rbf", 65),
                                      ("polynomial", 784)])
def test_matvec_fp32_route_takes_the_rest(cuda, kernel, d):
    """The Laplacian takes the fp32 route at every D; the cross-term kinds
    at D > 64, small calls too, take sm90_wide."""
    route = "fp32" if kernel == "laplacian" else "sm90_wide"
    x, z, a = _data((100, 300, d), cuda)
    assert block.select_matvec_route(kernel, d) == route
    before = dict(block.kernel_matvec_cuda.launches_by_route)
    got = block.kernel_matvec_cuda(x, z, a, kernel_name=kernel)
    torch.cuda.synchronize()
    assert block.kernel_matvec_cuda.launches_by_route == dict(
        before, **{route: before[route] + 1})
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
    _train_sm90_matches_plain(cuda, kernel, params, loss, shape)


def _train_sm90_matches_plain(cuda, kernel, params, loss, shape):
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


# The sm90 route's wide variant (train_sm90_wide, K in shared memory):
# J just past the narrow kernel's 1,024 (most CTAs' slices short, the last
# ones empty), 2,048, the ragged 3,000 and the widest 4,096, each with one
# row block and with several (the last CTA to arrive sums g).
SM90_WIDE_SHAPES = [(80, 1025, 54), (1000, 1025, 3), (1, 2048, 54),
                    (1000, 2048, 54), (81, 3000, 20), (1024, 3000, 54),
                    (80, 4096, 54), (1024, 4096, 54), (130, 4096, 784)]


@pytest.mark.parametrize("shape", SM90_WIDE_SHAPES, ids=str)
@pytest.mark.parametrize("loss", (None,) + LOSSES, ids=str)
@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_train_sm90_wide_matches_plain(cuda, kernel, params, loss, shape):
    """The wide variant: the train pass (each loss) and the dual pass (loss
    None) on the sm90 route past J = 1,024, against their plain versions
    at the float32 tolerance."""
    _train_sm90_matches_plain(cuda, kernel, params, loss, shape)


def test_train_sm90_wide_is_bit_stable_and_indexed_equals_gathered(cuda):
    """At Algorithm 2's step (I = 1,024, J union 4,096): 16 calls in a row
    give the same bits (the arrival counters left at 0), the indexed form
    gives the bits of the contiguous one on the rows gathered beforehand,
    lam is added as torch adds it, and the dual pass is bit-stable too."""
    x, y, alpha, _, _ = _indexed_data(50000, (1, 1, 54), cuda, seed=4)
    perm = torch.randperm(50000, device=cuda)
    idx_i, idx_j = perm[:1024].contiguous(), perm[1024:5120].contiguous()
    lam = 1e-4
    first = block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j, lam=lam)
    xi, xj, aj, yi = x[idx_i], x[idx_j], alpha[idx_j], y[idx_i]
    f, g = block.train_pass_cuda(xi, xj, aj, yi)
    assert torch.equal(first[0], f) and torch.equal(first[1], g + lam * aj)
    v = torch.randn(1024, device=cuda)
    dual = block.dual_pass_cuda(xi, xj, aj, v)
    for _ in range(16):
        again = block.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j,
                                              lam=lam)
        assert all(torch.equal(p, q) for p, q in zip(again, first))
        again = block.dual_pass_cuda(xi, xj, aj, v)
        assert all(torch.equal(p, q) for p, q in zip(again, dual))
    counters = block._SM90_SCRATCH[(torch.cuda.current_device(),
                                    torch.cuda.current_stream().cuda_stream)]
    assert not counters["counters"].any()
    pf, pg = block.train_pass_indexed_plain(x, y, alpha, idx_i, idx_j,
                                            lam=lam)
    _close(first[0], pf)
    _close(first[1], pg)


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
                                   (80, 1024, 7), (1024, 4096, 54),
                                   (1000, 3000, 54), (80, 1025, 7)],
                         ids=str)
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
    sm90 up to SM90_TRAIN_MAX_J (both variants), fp32 past it."""
    for shape, route in [((1000, 1000, 54), "sm90"),
                         ((1000, 3000, 54), "sm90"),
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
    # The wide variant: its dynamic shared memory, and Algorithm 2's 13 row
    # blocks at I = 1,024 in one wave.
    lib.dsekl_train_sm90_smem_bytes.restype = ctypes.c_int
    assert lib.dsekl_train_sm90_smem_bytes(1024) == 0
    assert 48 * 1024 < lib.dsekl_train_sm90_smem_bytes(1025) <= 232448
    assert lib.dsekl_train_sm90_active_clusters(0, 4096) >= 13


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


def _traps_on_an_index_out_of_range(n_j):
    """Runs the indexed train pass over ``n_j`` columns, one index of J
    past x, in a process of its own; asserts the kernel trapped."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = (
        "import torch\n"
        "from repro_torch.kernels.dsekl import block\n"
        f"x = torch.randn({n_j + 100}, 4, device='cuda')\n"
        f"y = torch.ones({n_j + 100}, device='cuda')\n"
        "i = torch.arange(16, device='cuda')\n"
        f"j = torch.arange({n_j}, device='cuda'); j[7] = {n_j + 100}\n"
        "block.train_pass_indexed_cuda(x, y, y, i, j)\n"
        "torch.cuda.synchronize()\n"
        "print('NO TRAP')\n")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode != 0 and "NO TRAP" not in out.stdout, out.stdout


def test_train_pass_indexed_traps_on_an_index_out_of_range(cuda):
    """An index outside [0, N) stops the kernel (a trap, as x[idx] fails on
    the card) and never reads past x; the context is lost, so the call
    runs in a process of its own."""
    _traps_on_an_index_out_of_range(32)


def test_train_pass_indexed_wide_traps_on_an_index_out_of_range(cuda):
    """The same on the wide variant (J = 2,000, K in shared memory)."""
    assert block.select_train_route(16, 2000, 4, "rbf") == "sm90"
    _traps_on_an_index_out_of_range(2000)


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
    # The main paths' non-causal shapes, cut in batch: llama-3.2-vision's
    # cross layers (S 2,048 against 1,601 patch embeddings, GQA 32/8) and
    # whisper's encoder (1,500 frames, 6 heads of 64).
    (1, 2048, 1601, 32, 8, 128, False, 1 << 30),
    (1, 1500, 1500, 6, 6, 64, False, 1 << 30),
    # The same paths' local shapes on a mesh, cut in batch:
    # llama-3.2-vision's cross layers on (1, 4) (8 / 2 heads a rank) and
    # whisper on (2, 2) (3 heads a rank: its encoder, decoder
    # self-attention and cross-attention).
    (1, 2048, 1601, 8, 2, 128, False, 1 << 30),
    (1, 1500, 1500, 3, 3, 64, False, 1 << 30),
    (1, 448, 448, 3, 3, 64, True, 1 << 30),
    (1, 448, 1500, 3, 3, 64, False, 1 << 30),
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


# ---------------------------------------------------------------------------
# Algorithm 2 and the hosted data plane on the card.
# ---------------------------------------------------------------------------

def _host_rows(n, d=54, seed=0):
    from repro_torch.data import HostSource
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = np.where(x[:, 0] + x[:, 1] * x[:, 2] > 0, 1.0, -1.0).astype(np.float32)
    return x, y, HostSource(x, y)


def test_prefetcher_copy_stream_under_a_delayed_consumer(cuda):
    """Pinned staging and the prefetcher's own copy stream: with a spin
    queued on the consumer's stream before each step, so that its reads
    lag far behind the host, the blocks it reads over 64 steps equal
    SyncGather's.  A block whose memory the allocator handed to a later
    step's copy too early would show here as rows of another step."""
    from repro_torch.data import BlockPrefetcher, SyncGather
    x, y, src = _host_rows(20000)
    rng = np.random.default_rng(1)
    plan_i = np.stack([rng.permutation(20000)[:1024] for _ in range(64)])
    plan_j = np.stack([rng.permutation(20000)[:4096] for _ in range(64)])
    kept = [torch.empty((64,) + shape, dtype=torch.float32, device=cuda)
            for shape in ((1024, 54), (1024,), (4096, 54))]
    with BlockPrefetcher(src, plan_i, plan_j, device=cuda) as loader:
        assert all(t.is_pinned() for t in loader._bufs.pinned)
        for t in range(64):
            torch.cuda._sleep(3_000_000)          # ~2 ms on the stream
            blocks = loader.get()
            assert all(b.is_cuda for b in blocks)
            for k, b in zip(kept, blocks):
                k[t].copy_(b)                     # queued behind the spin
            del blocks
        torch.cuda.synchronize()
    sync = SyncGather(src, plan_i, plan_j, device=cuda)
    for t in range(64):
        for k, b in zip(kept, sync.get()):
            assert torch.equal(k[t], b)


def _parallel_step_matches_plain(cuda, workers, route):
    """One Alg.-2 step of ``workers`` x 1,024 columns at I = 1,024: one
    launch of the indexed train pass on ``route``, f and g against the
    plain version, and the step's state against the ref step's."""
    from repro_torch.core import dsekl
    x, y, _ = _host_rows(20000, seed=2)
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    rng = np.random.default_rng(3)
    alpha = torch.tensor(rng.standard_normal(20000) * 0.1,
                         dtype=torch.float32, device=cuda)
    perm = torch.from_numpy(rng.permutation(20000)).to(cuda)
    n_j = workers * 1024
    idx_i = perm[:1024]
    idx_jk = perm[1024:1024 + n_j].reshape(workers, 1024)
    flat_j = idx_jk.reshape(-1).contiguous()
    assert block.select_train_route(1024, n_j, 54, "rbf") == route
    before = dict(block.train_pass_indexed_cuda.launches_by_route)
    f, g = ops.kernel_train_pass_indexed(x, y, alpha, idx_i, flat_j,
                                         loss="hinge", lam=1e-4, impl="cuda")
    before[route] += 1
    assert block.train_pass_indexed_cuda.launches_by_route == before
    wf, wg = block.train_pass_indexed_plain(x, y, alpha, idx_i, flat_j,
                                            loss="hinge", lam=1e-4)
    _close(f, wf)
    _close(g, wg)
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, n_workers=workers,
                      loss="square", schedule="adagrad", lam=1e-4)
    st = dsekl.init_state(20000, device=cuda)._replace(alpha=alpha)
    card = dsekl._parallel_inner(cfg, st, x, y, idx_i, idx_jk)
    ref = dsekl._parallel_inner(cfg.replace(impl="ref"), st, x, y, idx_i,
                                idx_jk)
    _close(card.alpha, ref.alpha)
    _close(card.accum, ref.accum)


def test_parallel_step_on_the_sm90_route_matches_plain(cuda):
    """The paper's protocol (4 workers: J union 4,096): the wide variant of
    the sm90 train kernel."""
    _parallel_step_matches_plain(cuda, 4, "sm90")


def test_parallel_step_on_the_fp32_route_matches_plain(cuda):
    """A J union past the sm90 route's 4,096 (5 workers: 5,120):
    ``csrc/dsekl_train.cu`` on the rows the indexed wrapper gathers."""
    _parallel_step_matches_plain(cuda, 5, "fp32")


def test_hosted_parallel_fit_is_bit_identical_to_in_memory(cuda):
    """Algorithm 2's worker batches are disjoint within a step, so the
    scatter meets no duplicate index, and the sm90 train kernel's wide
    variant sums in a fixed order whether it reads the rows by index (in
    memory, lam added in the kernel) or as staged blocks (hosted, lam
    added by torch, rounded alike): a hosted fit from pinned,
    copy-streamed blocks equals the in-memory fit bit for bit."""
    x, y, src = _host_rows(16384, seed=4)
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, n_workers=4, loss="hinge",
                      schedule="adagrad", lam=1e-4)
    gen = torch.Generator().manual_seed(5)
    plans = [sampler.parallel_epoch_plan(gen, 16384, 1024, 1024, 4)
             for _ in range(2)]
    before = block.train_pass_cuda.launches_by_route["sm90"]
    before_mem = block.train_pass_indexed_cuda.launches_by_route["sm90"]
    kw = dict(plans=plans, algorithm="parallel", n_epochs=2, tol=0.0,
              device=cuda)
    mem = fit(cfg, x, y, **kw)
    host = fit(cfg, src, None, **kw)
    sync = fit(cfg, src, None, prefetch=False, **kw)
    assert block.train_pass_cuda.launches_by_route["sm90"] == before + 64
    assert (block.train_pass_indexed_cuda.launches_by_route["sm90"]
            == before_mem + 32)
    for other in (host, sync):
        assert torch.equal(mem.state.alpha, other.state.alpha)
        assert torch.equal(mem.state.accum, other.state.accum)
    assert host.loader["steps"] == 32 and host.loader["gather_s"] > 0


# EigenPro (core/precond.py, the correction in core/dsekl.py): each
# preconditioned step adds one vecmat K(X_I, X_P)^T v over the m subsample
# rows, on the matvec's sm90 route at D 54.

def _precond_block(cuda, x, m, k=16, seed=6):
    from repro_torch.core import precond
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, loss="hinge", lam=1e-4)
    pre = precond.estimate_preconditioner(
        cfg, x, torch.Generator().manual_seed(seed), k=k, m=m, device=cuda)
    return pre, pre.block(cuda)


def _close_biting(got, want, where=None):
    """``_close`` at atol 1e-5 x max|want| (no floor at 1), after checking
    that the values it holds (``want[where]``) are not near zero: their
    median is above 100x that atol, so a zero or sign-flipped answer
    fails."""
    atol = 1e-5 * float(want.abs().max())
    held = want if where is None else want[where]
    assert float(held.abs().median()) > 100 * atol
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=2e-4,
                               atol=atol)


@pytest.mark.parametrize("n_i,m", [(1024, 512), (1000, 500)])
def test_precond_correction_on_the_card_matches_ref(cuda, n_i, m):
    """The correction on rows of unit norm on average, where K is far
    from I (on the raw rows K is ~I, the spectrum flat and the correction
    near zero)."""
    from repro_torch.core import dsekl
    x, _, _ = _host_rows(20000, seed=7)
    x = torch.from_numpy(x / np.float32(np.sqrt(54))).to(cuda)
    _, pc = _precond_block(cuda, x, m)
    rng = np.random.default_rng(8)
    xi = x[torch.from_numpy(rng.integers(0, 20000, n_i)).to(cuda)]
    v = torch.tensor(rng.standard_normal(n_i), dtype=torch.float32,
                     device=cuda)
    cfg = DSEKLConfig(n_grad=n_i, n_expand=1024)
    assert block.select_matvec_route("rbf", 54) == "sm90"
    before = dict(block.kernel_vecmat_cuda.launches_by_route)
    got = dsekl.precond_correction(cfg, xi, v, pc, 1024)
    before["sm90"] += 1
    assert block.kernel_vecmat_cuda.launches_by_route == before
    want = dsekl.precond_correction(cfg.replace(impl="ref"), xi, v, pc, 1024)
    _close_biting(got, want)


@pytest.mark.parametrize("algorithm", ["serial", "parallel"])
def test_preconditioned_step_on_the_card_matches_ref(cuda, algorithm):
    """One preconditioned step: one indexed train pass and one vecmat,
    both on the sm90 route, and the state of the ref step; the
    correction's own share of alpha (the step less the plain step) held
    to the ref step's share on the subsample rows."""
    from repro_torch.core import dsekl
    x, y, _ = _host_rows(20000, seed=9)
    # Rows of unit norm on average: K is far from I, so the correction
    # moves alpha in one step (on the raw rows K is ~I and it does not).
    x = torch.from_numpy(x / np.float32(np.sqrt(54))).to(cuda)
    y = torch.from_numpy(y).to(cuda)
    _, pc = _precond_block(cuda, x, 512)
    rng = np.random.default_rng(10)
    alpha = torch.tensor(rng.standard_normal(20000) * 0.1,
                         dtype=torch.float32, device=cuda)
    perm = torch.from_numpy(rng.permutation(20000)).to(cuda)
    workers = 4 if algorithm == "parallel" else 1
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, n_workers=workers,
                      loss="square", schedule="adagrad", lam=1e-4)
    st = dsekl.init_state(20000, device=cuda)._replace(alpha=alpha)
    idx_i = perm[:1024]
    if algorithm == "serial":
        idx_j = perm[1024:2048]
        step = dsekl.step_serial
    else:
        idx_j = perm[1024:1024 + 4096].reshape(4, 1024)
        step = dsekl._parallel_inner
    counters = (block.train_pass_indexed_cuda, block.kernel_vecmat_cuda)
    before = [dict(c.launches_by_route) for c in counters]
    card = step(cfg, st, x, y, idx_i, idx_j, pc)
    for b in before:
        b["sm90"] += 1
    assert [c.launches_by_route for c in counters] == before
    ref = step(cfg.replace(impl="ref"), st, x, y, idx_i, idx_j, pc)
    _close(card.alpha, ref.alpha)
    _close(card.accum, ref.accum)
    plain = step(cfg, st, x, y, idx_i, idx_j)
    plain_ref = step(cfg.replace(impl="ref"), st, x, y, idx_i, idx_j)
    _close_biting(card.alpha - plain.alpha, ref.alpha - plain_ref.alpha,
                  pc.indices)


def test_preconditioned_hosted_parallel_fit_is_bit_identical(cuda):
    """The estimate from a host source equals the estimate from the same
    rows on the card, bit for bit; a preconditioned hosted Algorithm-2 fit
    equals the in-memory one bit for bit (the subsample indices are
    distinct, so the correction's scatter meets no duplicate either)."""
    from repro_torch.core import precond
    x, y, src = _host_rows(16384, seed=11)
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, n_workers=4, loss="hinge",
                      schedule="adagrad", lam=1e-4)
    pres = [precond.estimate_preconditioner(
        cfg, data, torch.Generator().manual_seed(3), k=16, m=512,
        device=cuda) for data in (src, torch.from_numpy(x).to(cuda))]
    for f in ("indices", "rows", "vectors", "damping", "eigenvalues"):
        np.testing.assert_array_equal(getattr(pres[0], f),
                                      getattr(pres[1], f))
    gen = torch.Generator().manual_seed(5)
    plans = [sampler.parallel_epoch_plan(gen, 16384, 1024, 1024, 4)
             for _ in range(2)]
    before = block.kernel_vecmat_cuda.launches_by_route["sm90"]
    kw = dict(plans=plans, algorithm="parallel", n_epochs=2, tol=0.0,
              device=cuda, precondition=pres[0])
    mem = fit(cfg, x, y, **kw)
    host = fit(cfg, src, None, **kw)
    assert block.kernel_vecmat_cuda.launches_by_route["sm90"] == before + 64
    assert torch.equal(mem.state.alpha, host.state.alpha)
    assert torch.equal(mem.state.accum, host.state.accum)


# BCD (core/bcd.py, trainer.BCDPlan): the rounds run no hand kernel (tile
# GEMMs and the Cholesky are cuBLAS / cuSOLVER, as JAX computes them
# outside Pallas); the validation eval runs the matvec.

def test_bcd_fit_on_the_card_matches_ref(cuda):
    """impl "cuda" and "ref" give the same alpha bit for bit (only the
    eval differs: one sm90 matvec a round against the plain version);
    hosted, prefetched or inline, equals in memory bit for bit."""
    x, y, src = _host_rows(8192, seed=12)
    x = x / np.float32(np.sqrt(54))
    src = type(src)(x, y)
    xv = torch.from_numpy(x[:512]).to(cuda)
    yv = torch.from_numpy(y[:512]).to(cuda)
    cfg = DSEKLConfig(n_grad=1024, n_expand=256, loss="square", lam=1e-4,
                      kernel_params=(("gamma", 1.0),))
    gen = torch.Generator().manual_seed(13)
    plans = [np.asarray(torch.randperm(8192, generator=gen)[:256])
             for _ in range(3)]
    kw = dict(plans=plans, execution="bcd", n_epochs=3, tol=0.0, x_val=xv,
              y_val=yv, device=cuda)
    before = dict(block.kernel_matvec_cuda.launches_by_route)
    card = fit(cfg, x, y, **kw)
    before["sm90"] += 3 * 2                      # two 4,096-row chunks
    assert block.kernel_matvec_cuda.launches_by_route == before
    ref = fit(cfg.replace(impl="ref"), x, y, **kw)
    assert block.kernel_matvec_cuda.launches_by_route == before
    assert torch.equal(card.state.alpha, ref.state.alpha)
    for a, b in zip(card.history, ref.history):
        assert a["delta_alpha"] == b["delta_alpha"]
        assert abs(a["val_error"] - b["val_error"]) <= 1.0 / 512
    for prefetch in (True, False):
        host = fit(cfg, src, None, prefetch=prefetch, **kw)
        assert torch.equal(card.state.alpha, host.state.alpha)
    assert 0 < int((card.state.alpha != 0).sum()) <= 3 * 256


def test_emp_fix_step_on_the_card_matches_ref(cuda):
    """16 EmpFix steps: one sm90 matvec and one sm90 vecmat a step, alpha
    held to the ref steps' at the float32 tolerance with no floor."""
    from repro_torch.core import baselines
    x, y, _ = _host_rows(20000, seed=14)
    x = torch.from_numpy(x / np.float32(np.sqrt(54))).to(cuda)
    y = torch.from_numpy(y).to(cuda)
    rng = np.random.default_rng(15)
    land = torch.from_numpy(rng.choice(20000, 1024, replace=False))
    # lr0 below 2 / |K_IL|^2 (~1e-4 here: K's entries ~0.13 on these rows).
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024, loss="square", lam=1e-4,
                      lr0=1e-4)
    card = baselines.emp_fix_init(None, x, 1024, indices=land)
    ref = card
    plans = [torch.from_numpy(rng.integers(0, 20000, 1024)).to(cuda)
             for _ in range(16)]
    counters = (block.kernel_matvec_cuda, block.kernel_vecmat_cuda)
    before = [dict(c.launches_by_route) for c in counters]
    for idx in plans:
        card = baselines.emp_fix_step(cfg, card, x, y, idx)
    for b in before:
        b["sm90"] += 16
    assert [c.launches_by_route for c in counters] == before
    for idx in plans:
        ref = baselines.emp_fix_step(cfg.replace(impl="ref"), ref, x, y, idx)
    assert bool(torch.isfinite(ref.alpha).all())
    _close_biting(card.alpha, ref.alpha)


# ---------------------------------------------------------------------------
# Publishing from a second thread on a stream of its own (online serving).
# ---------------------------------------------------------------------------

def _cycles_per_ms():
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def _publish_engine(cuda, n=8192, d=54):
    rng = np.random.default_rng(16)
    x = rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    a0 = rng.standard_normal(n).astype(np.float32)
    ec = EngineConfig(query_block=1024, truncate_tol=-1.0)
    eng = DSEKLPredictionEngine(DSEKLConfig(), a0, x, engine_cfg=ec,
                                device=cuda)
    q = rng.standard_normal((300, d)).astype(np.float32) / np.sqrt(d)

    def oracle(alpha):
        return DSEKLPredictionEngine(DSEKLConfig(), alpha, x, engine_cfg=ec,
                                     device=cuda).predict(q)

    return eng, a0, q, oracle


def test_flush_does_not_wait_for_the_publishers_stream(cuda):
    """Work another thread queued on its own stream (here a 400-ms spin)
    does not delay a flush on the serving stream."""
    eng, a0, q, oracle = _publish_engine(cuda)
    want = oracle(a0)
    eng.submit(q)
    eng.flush_async()                                  # warm
    per_ms = _cycles_per_ms()
    side = torch.cuda.Stream(cuda)
    queued = threading.Event()

    def fit_thread():
        with torch.cuda.stream(side):
            torch.cuda._sleep(int(400 * per_ms))
        queued.set()

    th = threading.Thread(target=fit_thread)
    th.start()
    queued.wait()
    eng.submit(q)
    t0 = time.perf_counter()
    ((f, v),) = eng.flush_async_tagged()
    dt = time.perf_counter() - t0
    assert not side.query(), "the spin ended before the flush returned"
    th.join()
    side.synchronize()
    assert dt < 0.1, f"the flush took {dt:.3f}s behind the side stream"
    assert v == 0 and torch.equal(f, want)


def test_publish_on_a_side_stream_is_never_torn(cuda):
    """``update_alpha`` from another thread, its copy queued on that
    thread's stream behind a 200-ms spin: a sweep that captures the new
    version serves the new alpha whole (the serving stream waits on the
    publish's event), never the buffer before the copy landed; the sweep
    before it serves the old one."""
    eng, a0, q, oracle = _publish_engine(cuda)
    a1 = (a0 * -2.0 + 0.5).astype(np.float32)
    want0, want1 = oracle(a0), oracle(a1)
    per_ms = _cycles_per_ms()
    side = torch.cuda.Stream(cuda)
    a1_dev = torch.from_numpy(a1).to(cuda)
    for trial in range(3):
        eng.update_alpha(a0, version=2 * trial)
        torch.cuda.synchronize()
        eng.submit(q)
        ((f, v),) = eng.flush_async_tagged()
        assert v == 2 * trial and torch.equal(f, want0)
        published = threading.Event()

        def fit_thread():
            with torch.cuda.stream(side):
                torch.cuda._sleep(int(200 * per_ms))
                # The new alpha is computed on the side stream after the
                # spin: ready on the device only ~200 ms from now.
                new = a1_dev * 1.0
                eng.update_alpha(new, version=2 * trial + 1)
            published.set()

        th = threading.Thread(target=fit_thread)
        th.start()
        published.wait()
        eng.submit(q)
        ((f, v),) = eng.flush_async_tagged()
        th.join()
        assert v == 2 * trial + 1
        assert torch.equal(f, want1), "a sweep served a torn alpha"
    side.synchronize()


def test_online_service_soak_on_the_card(cuda):
    """The service on the card: the fit thread on its own stream, three
    writers flushing; every ticket answered once, each response
    bit-identical to a fresh engine on its version's recorded model, every
    matvec and train-pass launch on the sm90 route."""
    from repro_torch.data import RingSource
    from repro_torch.serving import OnlineService
    d = 54

    def events(seed, m):
        r = np.random.default_rng(seed)
        x = r.standard_normal((m, d)).astype(np.float32) / np.sqrt(d)
        return x, np.where(x[:, 0] + x[:, 1] > 0, 1.0, -1.0).astype(
            np.float32)

    ring = RingSource(16384, d)
    ring.append(*events(0, 8192))
    cfg = DSEKLConfig(n_grad=1024, n_expand=1024)
    counters = (block.kernel_matvec_cuda, block.train_pass_cuda,
                block.train_pass_indexed_cuda)
    before = [dict(c.launches_by_route) for c in counters]
    svc = OnlineService(
        cfg, ring, generator=torch.Generator().manual_seed(0),
        engine_cfg=EngineConfig(query_block=1024),
        rebuild_drift=0.1, max_epochs=6, record_models=True,
        ingest_hook=lambda s, e: s.append(*events((1, e), 2048)),
        device=cuda)
    svc.start()
    sent, responses, lock = {}, [], threading.Lock()

    def writer(w):
        r = np.random.default_rng((w, 5))
        it = 0
        while svc.running or it < 10:
            b = r.standard_normal((64, d)).astype(np.float32)
            t = svc.submit(b)
            with lock:
                sent[t] = b
            out = svc.flush()
            with lock:
                responses.extend(out)
            it += 1

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    svc.join(timeout=300)
    assert svc.error is None, svc.error
    responses.extend(svc.flush())
    after = [dict(c.launches_by_route) for c in counters]
    tickets = [r.ticket for r in responses]
    assert len(tickets) == len(set(tickets)) and set(tickets) == set(sent)
    assert svc.rebuilds >= 1 and svc.epoch == 6
    for b, a in zip(before, after):
        assert a["fp32"] == b["fp32"]
    assert after[0]["sm90"] > before[0]["sm90"]
    assert after[1]["sm90"] - before[1]["sm90"] == sum(
        max(e["n"] // cfg.n_grad, 1) for e in svc.publish_log
        if e["kind"] == "swap")
    oracles = {}
    for r in responses:
        if r.version not in oracles:
            alpha, snap = svc.published(r.version)
            oracles[r.version] = DSEKLPredictionEngine(
                cfg, alpha, snap.gather_x(slice(None)),
                engine_cfg=svc.engine_cfg, device=cuda)
        assert torch.equal(r.f, oracles[r.version].predict(sent[r.ticket]))
    assert len(oracles) > 1


# --- LM training on the card ------------------------------------------------

def test_training_ssd_matches_the_sm90_kernel_at_mamba2s_shape(cuda):
    """``models/ssm.ssd``, the differentiable chunked scan LM training
    runs, in float32 against the sm90 SSD kernel on the same bf16 values
    at mamba2-780m's shape (48 heads, hd 64, n 128, g 1, chunk 256, S
    1,024: four chunks): y at one bf16 rounding (rtol 8e-3, atol 1e-4 x
    max(1, |want|_inf)), the final state at the SSD tolerance."""
    from repro_torch.kernels.ssd import kernel
    from repro_torch.models import ssm
    x, dt, a, bm, cm = _ssd_data((2, 1024, 48, 64, 1, 128, 256), cuda)
    x, dt, bm, cm = (t.to(torch.bfloat16) for t in (x, dt, bm, cm))
    assert kernel.select_route(torch.bfloat16, 64, 128, 256) == "sm90"
    before = kernel.ssd_cuda.launches_by_route["sm90"]
    y, final = kernel.ssd_cuda(x, dt, a, bm, cm, chunk=256)
    torch.cuda.synchronize()
    assert kernel.ssd_cuda.launches_by_route["sm90"] == before + 1
    state0 = torch.zeros((2, 48, 64, 128), device=cuda)
    wy, wf = ssm.ssd(x.float(), dt.float(), a, bm.float(), cm.float(),
                     state0, 256)
    scale = max(1.0, float(wy.abs().max()))
    np.testing.assert_allclose(y.float().cpu().numpy(), wy.cpu().numpy(),
                               rtol=8e-3, atol=1e-4 * scale)
    _ssd_close(final, wf)


def test_kernel_ops_refuse_a_gradient_on_the_card(cuda):
    """On the card the flash and SSD ops raise for inputs that need a
    gradient (no kernel has a backward; no fallback to the plain
    version), launch nothing, and run under no_grad."""
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.ssd import kernel as sk
    from repro_torch.kernels.ssd import ssd_chunked
    q = torch.randn(1, 128, 4, 64, device=cuda, dtype=torch.bfloat16)
    k = torch.randn(1, 128, 4, 64, device=cuda, dtype=torch.bfloat16)
    x, dt, a, bm, cm = _ssd_data((1, 256, 4, 64, 1, 16, 256), cuda)
    flash_before, ssd_before = (fk.flash_attention_cuda.launches,
                                sk.ssd_cuda.launches)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_attention(q.requires_grad_(), k, k)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        ssd_chunked(x.requires_grad_(), dt, a, bm, cm, chunk=256)
    assert fk.flash_attention_cuda.launches == flash_before
    assert sk.ssd_cuda.launches == ssd_before
    with torch.no_grad():
        flash_attention(q, k, k)
        ssd_chunked(x, dt, a, bm, cm, chunk=256)
    assert fk.flash_attention_cuda.launches == flash_before + 1
    assert sk.ssd_cuda.launches == ssd_before + 1


def test_lm_launcher_refuses_a_model_larger_than_the_card(cuda, capsys):
    """``--full granite-20b``: its bf16 parameters and gradients and f32
    AdamW moments (~240 GB) do not fit the card; the launcher exits and
    names the production mesh to train it on (the LM trains on a mesh)."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "granite-20b", "--full", "--steps", "1"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "--full granite-20b" in err and "production mesh (16, 16)" in err


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_mla_absorbed_decode_matches_the_expanded_prefill(cuda, dtype, tol):
    """deepseek-v3's attention at its full widths (d_model 7,168, 128
    heads, q_lora 1,536, kv_lora 512, qk 128 + 64, v 128), one layer of
    random weights: ``mla_decode`` of token S after ``mla_prefill`` of S
    tokens against token S of ``mla_prefill`` over S + 1 tokens, at tol x
    |expanded|_inf: float32 sums in another order (1e-4); bfloat16 rounds
    another set of intermediates in each form, ~1e-2 of the output's
    scale (3e-2; ``chip_smoke.py``'s MLA_BF16_TOL gives the count).  Token
    S - 1's output must lie over 10x the limit away."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.nn.module import ParamTree, init_params
    name = str(dtype)[len("torch."):]
    cfg = get_config("deepseek-v3-671b").replace(param_dtype=name,
                                                 compute_dtype=name)
    p = ParamTree(attention.mla_specs(cfg), dtype=dtype, device=cuda)
    init_params(p, torch.Generator(device=cuda).manual_seed(0))
    b, s = 2, 255
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((b, s + 1, cfg.d_model), generator=gen, device=cuda
                    ).to(dtype)
    pos = torch.arange(s + 1, dtype=torch.int32, device=cuda)
    with torch.no_grad():
        _, cache = attention.mla_prefill(p, cfg, x[:, :s], pos[:s],
                                         cache_len=s + 1)
        got, _ = attention.mla_decode(p, cfg, x[:, s:], cache, s)
        want, _ = attention.mla_prefill(p, cfg, x, pos, cache_len=s + 1)
    got, want, prev = (got[:, 0].float().cpu().numpy(),
                       want[:, s].float().cpu().numpy(),
                       want[:, s - 1].float().cpu().numpy())
    limit = tol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=limit)
    assert float(np.abs(prev - want).max()) > 10 * limit
