"""The port's hand-written CUDA kernel on the card (marker ``cuda``; every
test skips where ``torch.cuda.is_available()`` is False).  This file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernel is held against its plain version (``kernel_matvec_plain``) at
the JAX suite's float32 tolerance: rtol 2e-4, atol 1e-5 x max(1,
|oracle|_inf).
"""
import numpy as np
import pytest
import torch

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
