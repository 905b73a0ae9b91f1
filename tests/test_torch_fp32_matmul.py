"""The plain versions of the DSEKL and SSD kernels run their products in
full float32 and leave the process's TF32 setting as they found it, on
the CPU.

Each plain version turns ``torch.backends.cuda.matmul.allow_tf32`` off
around its products (TF32 keeps ~3 decimal digits) and restores the
caller's value on the way out, whatever the device, so a CPU run shows
both: every product records the flag it ran under, and the flag after the
call is the one before it, for both starting values.
"""
import pytest
import torch

from repro_torch.kernels.dsekl import block, ops
from repro_torch.kernels.ssd import ref as ssd_ref


@pytest.fixture(params=[True, False], ids=["tf32_on", "tf32_off"])
def flags(request, monkeypatch):
    """The flag at every matmul and einsum of the call, with the process's
    flag set to the parameter first; checks it is restored afterwards."""
    seen = []
    matmul, einsum = torch.Tensor.__matmul__, torch.einsum

    def rec_matmul(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args, **kw)

    def rec_einsum(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args, **kw)

    monkeypatch.setattr(torch.Tensor, "__matmul__", rec_matmul)
    monkeypatch.setattr(torch, "einsum", rec_einsum)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = request.param
    try:
        yield seen
        assert torch.backends.cuda.matmul.allow_tf32 is request.param
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _xza(i=40, j=70, d=5):
    g = torch.Generator().manual_seed(i + j + d)
    return (torch.randn((i, d), generator=g), torch.randn((j, d), generator=g),
            torch.randn((j,), generator=g), torch.randn((i,), generator=g))


def _check(seen, out):
    assert seen and not any(seen)
    assert bool(torch.isfinite(out).all())


def test_plain_matvec_restores_the_tf32_setting(flags):
    x, z, a, _ = _xza()
    _check(flags, block.kernel_matvec_plain(x, z, a, kernel_name="rbf",
                                            params={"gamma": 0.5}, block=32))


def test_plain_vecmat_restores_the_tf32_setting(flags):
    x, z, _, v = _xza()
    _check(flags, block.kernel_vecmat_plain(x, z, v, kernel_name="linear",
                                            block=16))


def test_plain_dual_pass_restores_the_tf32_setting(flags):
    x, z, a, v = _xza()
    f, g = block.dual_pass_plain(x, z, a, v, kernel_name="polynomial",
                                 params={"gamma": 0.5, "coef0": 1.0,
                                         "degree": 2}, block=16)
    _check(flags, torch.cat([f, g]))


@pytest.mark.parametrize("op", ["matvec", "vecmat", "dual_pass", "tiled",
                                "block"])
def test_ref_ops_restore_the_tf32_setting(flags, op):
    """``impl="ref"``: the products run after the registry kernel is looked
    up, inside the same setting."""
    x, z, a, v = _xza()
    kw = dict(kernel_name="rbf", kernel_params=(("gamma", 0.5),))
    if op == "matvec":
        out = ops.kernel_matvec(x, z, a, impl="ref", **kw)
    elif op == "vecmat":
        out = ops.kernel_vecmat(x, z, v, impl="ref", **kw)
    elif op == "dual_pass":
        out = torch.cat(ops.kernel_dual_pass(x, z, a, v, loss="hinge",
                                             impl="ref", **kw))
    elif op == "tiled":
        out = ops.kernel_matvec_tiled(x, z, a, z_block=32, impl="ref", **kw)
    else:
        out = ops.kernel_block(x, z, **kw)
    _check(flags, out)


def test_plain_ssd_restores_the_tf32_setting(flags):
    g = torch.Generator().manual_seed(5)
    b, s, nh, hd, n = 1, 6, 2, 4, 3
    y, final = ssd_ref.ref_ssd(
        torch.randn((b, s, nh, hd), generator=g),
        torch.rand((b, s, nh), generator=g), -torch.rand((nh,), generator=g),
        torch.randn((b, s, nh, n), generator=g),
        torch.randn((b, s, nh, n), generator=g), torch.zeros((b, nh, hd, n)))
    assert len(flags) == 2 * s
    _check(flags, torch.cat([y.flatten(), final.flatten()]))
