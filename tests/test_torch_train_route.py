"""The train pass's route table and its indexed form, on the CPU.

* ``block.select_train_route`` over the main path's shape, ragged I and J,
  D 3 / 54 / 784 and the seven kinds: ``"sm90"`` (one cluster launch that
  keeps K on chip, ``csrc/dsekl_train_sm90.cu``) up to
  ``SM90_TRAIN_MAX_J`` columns, ``"fp32"`` (the K stash of
  ``csrc/dsekl_train.cu``) past it;
* ``block.train_pass_indexed_plain`` and ``ops.kernel_train_pass_indexed``
  (``impl="ref"``) against the JAX package's ``kernel_dual_pass`` with
  ``impl="pallas_interpret"`` (``train_pass_pallas`` run on the CPU) on
  the same gathered rows: duplicate J indices, I not a multiple of 64 and
  J not a multiple of 128, the four losses, f_scale 1 and N/|J|;
* the op's CUDA path with counting stand-ins for the CUDA wrappers: the
  indexed wrapper on both routes, and matvec then vecmat above the stash
  budget on the fp32 route;
* ``step_serial`` resolved to ``"cuda"`` (stand-ins again): one indexed op
  a step, no gather of x, y or alpha in Python, and the state of the ref
  step.

Tolerance: the JAX suite's float32 one (``tests/test_dual_pass.py::_tols``):
rtol 2e-4, atol 1e-5 x max(1, |oracle|_inf).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels.dsekl import ops as jops
from repro_torch.core import dsekl as tdsekl
from repro_torch.kernels.dsekl import block as tblock
from repro_torch.kernels.dsekl import ops as tops

KINDS = ["rbf", "laplacian", "linear", "polynomial", "sigmoid", "matern32",
         "matern52"]
LOSSES = ["hinge", "squared_hinge", "square", "logistic"]
N, D = 300, 5
SHAPE = (83, 133)            # I past one 80-row block, J past one 128 slice


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * scale)


def _problem(seed=0, loss="hinge", shape=SHAPE, n=N, d=D):
    """x (n, d), y, alpha (n,) and indices with duplicates in J."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(f32)
    if loss == "square":
        y = rng.standard_normal(n).astype(f32)
    else:
        y = np.where(rng.standard_normal(n) >= 0, 1.0, -1.0).astype(f32)
    alpha = rng.standard_normal(n).astype(f32)
    idx_i = rng.integers(0, n, shape[0])
    idx_j = rng.integers(0, n, shape[1])
    idx_j[5:9] = idx_j[0]                    # the same row at 5 positions
    return x, y, alpha, idx_i, idx_j


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("d", [3, 54, 784])
@pytest.mark.parametrize("kernel", KINDS)
def test_select_train_route(kernel, d):
    route = tblock.select_train_route
    assert route(1024, 1024, d, kernel) == "sm90"          # the main step
    for n_i, n_j in [(1000, 1000), (1, 1), (37, 61), (81, 1024),
                     (tblock.SM90_TRAIN_MAX_I, 1024)]:
        assert route(n_i, n_j, d, kernel) == "sm90", (n_i, n_j)
    for n_i, n_j in [(1000, 1025), (1000, 5003), (1000, 0),
                     (tblock.SM90_TRAIN_MAX_I + 1, 1024)]:
        assert route(n_i, n_j, d, kernel) == "fp32", (n_i, n_j)
    assert tblock.SM90_TRAIN_MAX_J == 1024


def test_select_train_route_refuses_unknown_kernels_and_widths():
    with pytest.raises(ValueError, match="no CUDA kernel"):
        tblock.select_train_route(1024, 1024, 54, "cosine")
    with pytest.raises(ValueError, match="D must be positive"):
        tblock.select_train_route(1024, 1024, 0, "rbf")


@pytest.mark.parametrize("unbiased", [False, True], ids=["f1", "fN_over_J"])
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kernel,params", [
    ("rbf", (("gamma", 0.7),)),
    ("matern32", (("length_scale", 1.3),)),
], ids=["rbf", "matern32"])
def test_indexed_forms_match_jax_pallas_interpret(kernel, params, loss,
                                                  unbiased):
    """The indexed plain version and the indexed ref op, against JAX's
    train pass kernel (interpret mode) on the rows gathered with numpy."""
    x, y, alpha, idx_i, idx_j = _problem(seed=len(loss), loss=loss)
    f_scale = N / len(idx_j) if unbiased else 1.0
    lam = 1e-3
    jf, jg = jops.kernel_dual_pass(
        jnp.asarray(x[idx_i]), jnp.asarray(x[idx_j]),
        jnp.asarray(alpha[idx_j]), jnp.asarray(y[idx_i]),
        kernel_name=kernel, kernel_params=params, loss=loss, f_scale=f_scale,
        impl="pallas_interpret")
    want_g = np.asarray(jg) + np.float32(lam) * alpha[idx_j]
    tx, ty, ta, ti, tj = _t(x, y, alpha, idx_i, idx_j)
    f, g = tblock.train_pass_indexed_plain(
        tx, ty, ta, ti, tj, loss=loss, kernel_name=kernel,
        params=dict(params), f_scale=f_scale, lam=lam, block=32)
    _close(f, jf)
    _close(g, want_g)
    f, g = tops.kernel_train_pass_indexed(
        tx, ty, ta, ti, tj, kernel_name=kernel, kernel_params=params,
        loss=loss, f_scale=f_scale, lam=lam, impl="ref")
    _close(f, jf)
    _close(g, want_g)


@pytest.mark.parametrize("kernel", KINDS)
def test_indexed_plain_equals_the_gathered_plain(kernel):
    """Position by position: a duplicate J index gets its own g entry,
    exactly as the plain version on the gathered rows gives it."""
    x, y, alpha, idx_i, idx_j = _problem(seed=3)
    tx, ty, ta, ti, tj = _t(x, y, alpha, idx_i, idx_j)
    f, g = tblock.train_pass_indexed_plain(tx, ty, ta, ti, tj,
                                           kernel_name=kernel, block=16)
    wf, wg = tblock.train_pass_plain(tx[ti], tx[tj], ta[tj], ty[ti],
                                     kernel_name=kernel, block=16)
    assert torch.equal(f, wf) and torch.equal(g, wg)
    assert g.shape == (len(idx_j),)


def _counting(plain):
    def f(*args, **kw):
        f.launches += 1
        with torch._C.DisableTorchFunction():
            return plain(*args, **kw)
    f.launches = 0
    return f


def _stand_ins(monkeypatch):
    """Counting stand-ins for the CUDA wrappers, running the plain
    versions, so the CUDA paths run here on the CPU."""
    stand_ins = {n: _counting(getattr(tblock, p)) for n, p in [
        ("kernel_matvec_cuda", "kernel_matvec_plain"),
        ("kernel_vecmat_cuda", "kernel_vecmat_plain"),
        ("dual_pass_cuda", "dual_pass_plain"),
        ("train_pass_cuda", "train_pass_plain"),
        ("train_pass_indexed_cuda", "train_pass_indexed_plain")]}
    for name, fn in stand_ins.items():
        monkeypatch.setattr(tblock, name, fn)
    return stand_ins


@pytest.mark.parametrize("n_j,budget,launched", [
    (133, None, {"train_pass_indexed_cuda"}),                  # sm90
    (2100, None, {"train_pass_indexed_cuda"}),                 # fp32
    (2100, 0, {"kernel_matvec_cuda", "kernel_vecmat_cuda"}),   # over budget
], ids=["sm90", "fp32", "fp32-over-budget"])
def test_indexed_op_cuda_path(monkeypatch, n_j, budget, launched):
    stand_ins = _stand_ins(monkeypatch)
    if budget is not None:
        monkeypatch.setattr(tblock, "STASH_BUDGET", budget)
    x, y, alpha, idx_i, idx_j = _problem(seed=4, shape=(83, n_j), n=3000)
    kw = dict(kernel_name="rbf", kernel_params=(("gamma", 0.9),),
              loss="squared_hinge", f_scale=2.0, lam=1e-2)
    args = _t(x, y, alpha, idx_i, idx_j)
    want = tops.kernel_train_pass_indexed(*args, impl="ref", **kw)
    got = tops.kernel_train_pass_indexed(*args, impl="cuda", **kw)
    assert {n for n, f in stand_ins.items() if f.launches} == launched
    assert all(f.launches <= 1 for f in stand_ins.values())
    for g, w in zip(got, want):
        _close(g, w)


class _GatherWatch(TorchFunctionMode):
    """Records every gather (indexing, index_select, take, gather) by the
    tensor it reads."""

    def __init__(self, watched):
        super().__init__()
        self.watched = watched
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") in (
                "__getitem__", "index_select", "take", "gather")
                and args and isinstance(args[0], torch.Tensor)):
            self.seen.append(next((n for n, t in self.watched.items()
                                   if t() is args[0]), "other"))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("loss,schedule,unbiased", [
    ("hinge", "adagrad", False), ("square", "inv_t", True),
    ("logistic", "const", False)])
def test_step_serial_on_cuda_reads_rows_by_index(monkeypatch, loss, schedule,
                                                 unbiased):
    """``step_serial`` on the CUDA backend hands the indices to the
    indexed op, once a step; it gathers none of x, y and alpha in Python,
    and leaves alpha and accum as the ref steps do."""
    stand_ins = _stand_ins(monkeypatch)
    op_calls = []
    real_op = tops.kernel_train_pass_indexed

    def op(*args, **kw):
        op_calls.append(kw["impl"])
        return real_op(*args, **kw)

    monkeypatch.setattr(tops, "kernel_train_pass_indexed", op)
    x, y, alpha, _, _ = _problem(seed=5, loss=loss)
    rng = np.random.default_rng(6)
    plan = [(torch.from_numpy(rng.integers(0, N, 83)),
             torch.from_numpy(rng.integers(0, N, 133))) for _ in range(3)]
    cfg = tdsekl.DSEKLConfig(n_grad=83, n_expand=133, loss=loss,
                             schedule=schedule, lam=1e-3,
                             unbiased_scaling=unbiased,
                             kernel_params=(("gamma", 0.8),))
    tx, ty = _t(x, y)
    states = {}
    for impl in ("cuda", "ref"):
        st = tdsekl.init_state(N, device="cpu")
        st = st._replace(alpha=torch.from_numpy(alpha.copy()))
        current = {"x": lambda: tx, "y": lambda: ty}
        watch = _GatherWatch(current)
        with watch:
            for idx_i, idx_j in plan:
                current["alpha"] = lambda a=st.alpha: a
                st = tdsekl.step_serial(cfg.replace(impl=impl), st, tx, ty,
                                        idx_i, idx_j)
        states[impl] = (st, watch.seen)
    st, seen = states["cuda"]
    assert op_calls == ["cuda"] * 3
    assert stand_ins["train_pass_indexed_cuda"].launches == 3
    assert sum(f.launches for f in stand_ins.values()) == 3
    assert not {"x", "y", "alpha"} & set(seen), seen
    assert {"x", "y", "alpha"} <= set(states["ref"][1])   # the ref gathers
    ref = states["ref"][0]
    _close(st.alpha, ref.alpha)
    _close(st.accum, ref.accum)
    assert int(st.step) == int(ref.step) == 3


def test_indexed_wrapper_refuses_cpu_tensors():
    x, y, alpha, idx_i, idx_j = _t(*_problem())
    before = dict(tblock.train_pass_indexed_cuda.launches_by_route)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tblock.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.kernel_train_pass_indexed(x, y, alpha, idx_i, idx_j,
                                       impl="cuda")
    with pytest.raises(ValueError, match="unknown loss"):
        tblock.train_pass_indexed_cuda(x, y, alpha, idx_i, idx_j,
                                       loss="huber")
    assert tblock.train_pass_indexed_cuda.launches_by_route == before
