"""The port's training ops vs the JAX package's, on the same numpy inputs.

* ``ref_kernel_{vecmat,dual_pass,train_pass}`` vs the JAX oracles, for the
  seven registry kernels;
* ``ops.kernel_vecmat`` / ``ops.kernel_dual_pass`` (``loss=None`` and each
  loss, ``f_scale != 1``) vs JAX ``impl="ref"``, and for a few cases vs
  JAX ``impl="pallas_interpret"`` (the TPU kernels run on the CPU);
* the plain versions beside the CUDA kernels (``block.*_plain``) vs the
  port's oracles, multi-block and ragged;
* ``ops.kernel_dual_pass``'s matvec-then-vecmat fallback above the stash
  budget, with counting stand-ins for the CUDA wrappers;
* ``dsekl.streaming_train_pass`` vs JAX's;
* ``rbf_block``'s delegations vs JAX's ``rbf_*_pallas`` in interpret mode.

Tolerance: the JAX suite's float32 one (``tests/test_dual_pass.py::_tols``):
rtol 2e-4, atol 1e-5 x max(1, |oracle|_inf).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsekl as jdsekl
from repro.core import kernels_fn as jkf
from repro.core import losses as jl
from repro.kernels.dsekl import ops as jops
from repro.kernels.dsekl import rbf_block as jrbf
from repro.kernels.dsekl import ref as jref
from repro_torch.core import dsekl as tdsekl
from repro_torch.core import kernels_fn as tkf
from repro_torch.core import losses as tl
from repro_torch.kernels.dsekl import block as tblock
from repro_torch.kernels.dsekl import ops as tops
from repro_torch.kernels.dsekl import rbf_block as trbf
from repro_torch.kernels.dsekl import ref as tref

KERNEL_CASES = [
    ("rbf", (("gamma", 0.7),)),
    ("laplacian", (("gamma", 0.3),)),
    ("linear", ()),
    ("polynomial", (("gamma", 0.5), ("coef0", 1.0), ("degree", 2))),
    ("sigmoid", (("gamma", 0.5), ("coef0", 0.1))),
    ("matern32", (("length_scale", 1.3),)),
    ("matern52", (("length_scale", 0.8),)),
]
IDS = [k for k, _ in KERNEL_CASES]
LOSSES = [None, "hinge", "squared_hinge", "square", "logistic"]
SHAPE = (37, 61, 5)          # ragged: no multiple of any tile size


def _data(shape=SHAPE, seed=0, loss="hinge"):
    i, j, d = shape
    rng = np.random.default_rng(seed + 1000 * i + j)
    f32 = np.float32
    x = rng.standard_normal((i, d)).astype(f32)
    z = rng.standard_normal((j, d)).astype(f32)
    a = rng.standard_normal(j).astype(f32)
    v = rng.standard_normal(i).astype(f32)
    if loss is None or loss == "square":
        vy = v
    else:
        vy = np.where(rng.standard_normal(i) >= 0, 1.0, -1.0).astype(f32)
    return x, z, a, vy


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_ref_oracles_match_jax(kernel, params):
    x, z, a, y = _data()
    v = _data(loss=None)[3]
    jk = jkf.get_kernel(kernel, **dict(params))
    tk = tkf.get_kernel(kernel, **dict(params))
    _close(tref.ref_kernel_vecmat(tk, *_t(x, z, v)),
           jref.ref_kernel_vecmat(jk, *_j(x, z, v)))
    for got, want in zip(tref.ref_kernel_dual_pass(tk, *_t(x, z, a, v)),
                         jref.ref_kernel_dual_pass(jk, *_j(x, z, a, v))):
        _close(got, want)
    for got, want in zip(
            tref.ref_kernel_train_pass(tk, *_t(x, z, a, y),
                                       tl.get_loss("hinge").grad_f,
                                       f_scale=1.5),
            jref.ref_kernel_train_pass(jk, *_j(x, z, a, y),
                                       jl.get_loss("hinge").grad_f,
                                       f_scale=1.5)):
        _close(got, want)


@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_kernel_vecmat_matches_jax_ref(kernel, params):
    x, z, _, v = _data(loss=None, seed=1)
    want = jops.kernel_vecmat(*_j(x, z, v), kernel_name=kernel,
                              kernel_params=params, impl="ref")
    got = tops.kernel_vecmat(*_t(x, z, v), kernel_name=kernel,
                             kernel_params=params, impl="auto")
    _close(got, want)


@pytest.mark.parametrize("loss", LOSSES, ids=str)
@pytest.mark.parametrize("kernel,params", [KERNEL_CASES[0], KERNEL_CASES[1],
                                           KERNEL_CASES[3], KERNEL_CASES[6]],
                         ids=["rbf", "laplacian", "polynomial", "matern52"])
def test_kernel_dual_pass_matches_jax_ref(kernel, params, loss):
    """Both flavours, f_scale != 1: after the product without a loss,
    before the loss gradient with one."""
    x, z, a, vy = _data(loss=loss, seed=2)
    kw = dict(kernel_name=kernel, kernel_params=params, loss=loss,
              f_scale=1.7)
    want = jops.kernel_dual_pass(*_j(x, z, a, vy), impl="ref", **kw)
    got = tops.kernel_dual_pass(*_t(x, z, a, vy), impl="ref", **kw)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("kernel,params,loss", [
    ("rbf", (("gamma", 0.7),), None),
    ("rbf", (("gamma", 0.7),), "hinge"),
    ("matern32", (("length_scale", 1.3),), "logistic"),
    ("linear", (), "square"),
], ids=["rbf-dual", "rbf-hinge", "matern32-logistic", "linear-square"])
def test_ops_match_jax_pallas_interpret(kernel, params, loss):
    """The TPU kernels themselves (interpret mode) against the port."""
    x, z, a, vy = _data(loss=loss, seed=3)
    kw = dict(kernel_name=kernel, kernel_params=params)
    want = jops.kernel_dual_pass(*_j(x, z, a, vy), loss=loss, f_scale=2.5,
                                 impl="pallas_interpret", **kw)
    got = tops.kernel_dual_pass(*_t(x, z, a, vy), loss=loss, f_scale=2.5,
                                **kw)
    for g, w in zip(got, want):
        _close(g, w)
    v = _data(loss=None, seed=3)[3]
    _close(tops.kernel_vecmat(*_t(x, z, v), **kw),
           jops.kernel_vecmat(*_j(x, z, v), impl="pallas_interpret", **kw))


@pytest.mark.parametrize("kernel,params", KERNEL_CASES, ids=IDS)
def test_plain_versions_match_port_ref(kernel, params):
    """The plain versions beside the CUDA kernels, over 16-row blocks (so
    ragged and multi-block), against the port's oracle ops."""
    x, z, a, y = _data(seed=4)
    v = _data(loss=None, seed=4)[3]
    tx, tz, ta, tv, ty = _t(x, z, a, v, y)
    p = dict(params)
    kw = dict(kernel_name=kernel, kernel_params=params, impl="ref")
    _close(tblock.kernel_vecmat_plain(tx, tz, tv, kernel_name=kernel,
                                      params=p, block=16),
           tops.kernel_vecmat(tx, tz, tv, **kw))
    got = tblock.dual_pass_plain(tx, tz, ta, tv, kernel_name=kernel,
                                 params=p, f_scale=0.7, block=16)
    for g, w in zip(got, tops.kernel_dual_pass(tx, tz, ta, tv, f_scale=0.7,
                                               **kw)):
        _close(g, w)
    for loss in LOSSES[1:]:
        got = tblock.train_pass_plain(tx, tz, ta, ty, loss=loss,
                                      kernel_name=kernel, params=p,
                                      f_scale=1.3, block=16)
        want = tops.kernel_dual_pass(tx, tz, ta, ty, loss=loss, f_scale=1.3,
                                     **kw)
        for g, w in zip(got, want):
            _close(g, w)


def _counting(plain):
    def f(*args, **kw):
        f.launches += 1
        return plain(*args, **kw)
    f.launches = 0
    return f


@pytest.mark.parametrize("loss", [None, "hinge", "square"], ids=str)
def test_dual_pass_falls_back_above_the_stash_budget(monkeypatch, loss):
    """Over ``STASH_BUDGET`` the CUDA path runs matvec, the loss gradient
    on f_scale * f, then vecmat (K twice), and never the stash kernels:
    a block on the fp32 train route, J wider than the sm90 route takes
    (below it the sm90 kernel keeps K on chip and needs no stash).  The
    CUDA wrappers are replaced by counting stand-ins that run the plain
    versions, so the branch runs here on the CPU."""
    stand_ins = {n: _counting(getattr(tblock, p)) for n, p in [
        ("kernel_matvec_cuda", "kernel_matvec_plain"),
        ("kernel_vecmat_cuda", "kernel_vecmat_plain"),
        ("dual_pass_cuda", "dual_pass_plain"),
        ("train_pass_cuda", "train_pass_plain")]}
    for name, fn in stand_ins.items():
        monkeypatch.setattr(tblock, name, fn)
    shape = (37, tblock.SM90_TRAIN_MAX_J + 61, 5)
    assert tblock.select_train_route(*shape, "rbf") == "fp32"
    x, z, a, vy = _data(shape=shape, loss=loss, seed=5)
    kw = dict(kernel_name="rbf", kernel_params=(("gamma", 1.0),), loss=loss,
              f_scale=1.5)
    want = jops.kernel_dual_pass(*_j(x, z, a, vy), impl="ref", **kw)
    got = tops.kernel_dual_pass(*_t(x, z, a, vy), impl="cuda", **kw)
    stash = "dual_pass_cuda" if loss is None else "train_pass_cuda"
    assert {n: f.launches for n, f in stand_ins.items()} == {
        n: int(n == stash) for n in stand_ins}
    for g, w in zip(got, want):
        _close(g, w)
    monkeypatch.setattr(tblock, "STASH_BUDGET", 0)
    assert not tblock.fits_stash(1, 1)
    got = tops.kernel_dual_pass(*_t(x, z, a, vy), impl="cuda", **kw)
    assert {n: f.launches for n, f in stand_ins.items()} == {
        n: int(n == stash) + int(n in ("kernel_matvec_cuda",
                                       "kernel_vecmat_cuda"))
        for n in stand_ins}
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("loss,unbiased", [("square", False),
                                           ("hinge", True),
                                           ("logistic", False)])
def test_streaming_train_pass_matches_jax(loss, unbiased):
    x, z, a, y = _data(loss=loss, seed=6)
    kw = dict(kernel="matern52", kernel_params=(("length_scale", 0.8),),
              loss=loss, unbiased_scaling=unbiased)
    jf, jg = jdsekl.streaming_train_pass(
        jdsekl.DSEKLConfig(impl="ref", **kw), *_j(x, y, z, a), 500,
        row_block=8)
    tf, tg = tdsekl.streaming_train_pass(
        tdsekl.DSEKLConfig(impl="ref", **kw), *_t(x, y, z, a), 500,
        row_block=8)
    _close(tf, jf)
    _close(tg, jg)


def test_rbf_block_delegations_match_jax_interpret():
    x, z, a, v = _data(shape=(20, 70, 4), loss=None, seed=7)
    _close(trbf.rbf_matvec(*_t(x, z, a), gamma=0.6),
           jrbf.rbf_matvec_pallas(*_j(x, z, a), gamma=0.6, block_i=8,
                                  block_j=128, interpret=True))
    _close(trbf.rbf_vecmat(*_t(x, z, v), gamma=0.6),
           jrbf.rbf_vecmat_pallas(*_j(x, z, v), gamma=0.6, block_i=8,
                                  block_j=128, interpret=True))


def test_cuda_wrappers_refuse_cpu_tensors():
    x, z, a, y = _t(*_data())
    before = [f.launches for f in (tblock.kernel_vecmat_cuda,
                                   tblock.dual_pass_cuda,
                                   tblock.train_pass_cuda)]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tblock.kernel_vecmat_cuda(x, z, y)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tblock.dual_pass_cuda(x, z, a, y)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tblock.train_pass_cuda(x, z, a, y)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tops.kernel_dual_pass(x, z, a, y, loss="hinge", impl="cuda")
    with pytest.raises(ValueError, match="unknown loss"):
        tblock.train_pass_cuda(x, z, a, y, loss="huber")
    assert [f.launches for f in (tblock.kernel_vecmat_cuda,
                                 tblock.dual_pass_cuda,
                                 tblock.train_pass_cuda)] == before
