"""The flash-attention wrapper's route choice and refusals, and the plain
version's float32 matmul setting, on the CPU.

``kernel.select_route`` is a pure function of (dtype, head dim, query
heads, kv heads): bfloat16 with head dim 64 or 128 goes to the sm90
tensor-core kernel, everything else to the fp32-core kernel.  The wrapper
takes CUDA tensors only and refuses CPU ones before it counts a launch.
The sm90 kernel's numerics, emulated in plain torch, show why it splits P
into two bf16 terms.  The kernels themselves run in
``tests/test_torch_cuda.py`` on the card.
"""
import pytest
import torch

from repro_torch.kernels.flash_attn import flash_attention, kernel
from repro_torch.kernels.flash_attn import ref as flash_ref

ROUTE_CASES = [
    # (dtype, d, h, kv, route)
    (torch.bfloat16, 128, 32, 8, "sm90"),        # jamba, every 128 config
    (torch.bfloat16, 128, 4, 1, "sm90"),
    (torch.bfloat16, 128, 8, 8, "sm90"),         # no GQA
    (torch.bfloat16, 64, 4, 1, "sm90"),          # whisper's 64
    (torch.bfloat16, 64, 20, 20, "sm90"),
    (torch.bfloat16, 16, 4, 4, "fp32"),
    (torch.bfloat16, 32, 2, 2, "fp32"),
    (torch.bfloat16, 48, 4, 2, "fp32"),
    (torch.bfloat16, 96, 4, 2, "fp32"),
    (torch.bfloat16, 127, 4, 2, "fp32"),
    (torch.float32, 128, 32, 8, "fp32"),
    (torch.float32, 64, 4, 1, "fp32"),
    (torch.float32, 16, 4, 4, "fp32"),
    (torch.float16, 128, 32, 8, "fp32"),         # the wrapper refuses it
]


@pytest.mark.parametrize("dtype,d,h,kv,route", ROUTE_CASES,
                         ids=[f"{str(c[0])[6:]}-d{c[1]}-h{c[2]}-kv{c[3]}"
                              for c in ROUTE_CASES])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, d, h, kv, route):
    assert kernel.select_route(dtype, d, h, kv) == route
    assert route in kernel.ROUTES


@pytest.mark.parametrize("h,kv", [(32, 5), (4, 0), (3, 4)])
def test_route_refuses_heads_that_do_not_split(h, kv):
    with pytest.raises(ValueError, match="do not split"):
        kernel.select_route(torch.bfloat16, 128, h, kv)


def _qkv(dtype, d, b=1, s=16, h=4, kv=2):
    g = torch.Generator().manual_seed(d)
    return [torch.randn(sh, generator=g).to(dtype)
            for sh in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.bfloat16, 64),
                                     (torch.bfloat16, 48),
                                     (torch.float32, 128)])
def test_wrapper_refuses_cpu_tensors_without_counting(dtype, d):
    """Both routes take CUDA tensors only: a CPU tensor raises before any
    launch is counted, on the wrapper and through ``impl="cuda"``."""
    fn = kernel.flash_attention_cuda
    q, k, v = _qkv(dtype, d)
    before = (fn.launches, dict(fn.launches_by_route))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fn(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention(q, k, v, impl="cuda")
    assert (fn.launches, fn.launches_by_route) == before


def test_route_counters_cover_every_route():
    assert set(kernel.flash_attention_cuda.launches_by_route) == set(
        kernel.ROUTES)


@pytest.mark.parametrize("flag", [True, False])
def test_plain_version_restores_the_tf32_setting(flag, monkeypatch):
    """The plain version runs its einsums with TF32 off and leaves the
    process's ``allow_tf32`` as it found it."""
    seen = []
    einsum = torch.einsum

    def recording(*args, **kw):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args, **kw)

    monkeypatch.setattr(torch, "einsum", recording)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = flag
    try:
        q, k, v = _qkv(torch.float32, 32, h=2, kv=2)
        out = flash_ref.ref_attention(q, k, v, causal=True)
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [False, False]
    assert out.shape == q.shape and bool(torch.isfinite(out).all())


def _kernel_numerics(q, k, v, split: bool):
    """The sm90 kernel's arithmetic in plain torch, causal, one tile: f32
    scores and p, P either split (P_hi + P_lo, two bf16 terms) or rounded
    to bf16, P @ V and l in f32, the output rounded to bf16."""
    d = q.shape[-1]
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / d ** 0.5
    qpos = torch.arange(q.shape[1])[:, None]
    kpos = torch.arange(k.shape[1])[None, :]
    s = torch.where(kpos <= qpos, s, torch.tensor(flash_ref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    hi = p.to(torch.bfloat16).float()
    pv = hi + (p - hi).to(torch.bfloat16).float() if split else hi
    o = torch.einsum("bhst,bthd->bhsd", pv, v.float()) / p.sum(-1,
                                                                keepdim=True)
    return o.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("split", [True, False], ids=["p_split", "p_bf16"])
@pytest.mark.parametrize("s,h,d", [(256, 4, 64), (512, 4, 128)])
def test_p_split_keeps_the_float32_function(s, h, d, split):
    """Why the sm90 kernel splits P: held to the card's bf16 check (the
    plain version on the same values in float32, rtol 8e-3, atol 1e-5 x
    max(1, |want|_inf)), the split passes everywhere and P rounded to bf16
    fails on the causal rows whose output is near 0."""
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn((1, s, h, d), generator=g).to(torch.bfloat16)
               for _ in range(3))
    want = flash_ref.ref_attention(q.float(), k.float(), v.float(),
                                   causal=True)
    got = _kernel_numerics(q, k, v, split).float()
    atol = 1e-5 * max(1.0, float(want.abs().max()))
    bad = int(((got - want).abs() > atol + 8e-3 * want.abs()).sum())
    if split:
        assert bad == 0
    else:
        assert bad > want.numel() // 100
