"""The benchmark's frozen data generators: the covertype copy draws the
port's ``make_covertype_like`` rows, and the MNIST stand-in has MNIST's
shape, range and sparsity; both are fixed by the seed.  One test runs a
serve cell on the card at a small size (marker ``cuda``)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from portbench.harness import runner, spec, work

DATA = spec.PORTBENCH / "data"


def test_portbench_covertype_copy_equals_the_ports_generator():
    from repro_torch.data.synthetic import make_covertype_like
    make = spec.load_module(DATA / "covertype_like.py").make
    x, y = make(4096, 54, seed=2_718_281_828, device="cpu")
    x_p, y_p = make_covertype_like(4096, 54, seed=2_718_281_828,
                                   device="cpu")
    assert torch.equal(x, x_p) and torch.equal(y, y_p)


def test_portbench_mnist_stand_in_has_mnist_shape():
    make = spec.load_module(DATA / "mnist_like.py").make
    x, y = make(5000, 784, seed=4_294_967_311, device="cpu")
    assert x.shape == (5000, 784) and x.dtype == torch.float32
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert 0.17 < float((x != 0).float().mean()) < 0.21
    assert set(y.unique().tolist()) == {-1.0, 1.0}
    assert 0.4 < float((y > 0).float().mean()) < 0.6
    x2, y2 = make(5000, 784, seed=4_294_967_311, device="cpu")
    assert torch.equal(x, x2) and torch.equal(y, y2)
    x3, _ = make(5000, 784, seed=4_294_967_312, device="cpu")
    assert not torch.equal(x, x3)


def test_portbench_serve_rounds_never_repeat_and_keep_their_sizes():
    """Two cycles of the serve traffic: every round is one of the fixed
    compositions of request sizes, each served once a cycle, and no
    round's requests (sizes and offsets) come twice."""
    cell = spec.load_cell("covertype-rbf.serve")
    kind = cell.kind()
    ctx = runner.Context(cell=cell, seed=2_147_483_659, seconds=0.1,
                         trace=False, device=torch.device("cpu"),
                         peaks=work.peaks_for("NVIDIA H100 80GB HBM3"))
    st = type("St", (), {})()
    st.pool = torch.zeros((21_122, 1))
    st.rounds = kind._rounds(ctx, st.pool.shape[0])
    st.rng = np.random.default_rng(ctx.sub_seed(3))
    n_rounds = st.rounds.shape[0]
    comps = sorted(tuple(sorted(r)) for r in st.rounds.tolist())
    seen = set()
    for _ in range(2):
        kind._next_cycle(st)
        assert sorted(tuple(sorted(r)) for r in
                      st.cycle_sizes.tolist()) == comps
        for sizes, offsets in zip(st.cycle_sizes, st.cycle_offsets):
            assert (offsets + sizes <= st.pool.shape[0]).all()
            seen.add((tuple(sizes), tuple(offsets)))
    assert len(seen) == 2 * n_rounds


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_portbench_serve_cell_on_the_card(card):
    cell = spec.load_cell("mnist-rbf.serve")
    out = runner.run(cell, 77, 0.5, True, device=card,
                     card=torch.cuda.get_device_name(card),
                     t_start=time.perf_counter(),
                     shrink={"rows": 12000, "train_rows": 8192,
                             "warmup_rounds": 2, "trace_rounds": 4})
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
    assert 0 < out["metrics"]["matvec_roofline"]["value"] <= 100
