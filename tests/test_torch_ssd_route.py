"""The SSD wrapper's route choice and refusals, and the sm90 kernel's
numerics emulated in plain torch, on the CPU.

``kernel.select_route`` is a pure function of (dtype, head dim, state n,
chunk): bfloat16 with head dim 64, n a multiple of 16 up to 128 and a chunk
of 64, 128, 192 or 256 goes to the sm90 tensor-core kernel, everything
else to the fp32-core kernel.  The wrapper takes CUDA tensors only and
refuses CPU ones before it counts a launch.

The emulation repeats the sm90 kernel's chunked form with its splits: S =
C B^T exact, P = S o exp(cum_i - cum_j) o dt_j in three bf16 terms that
sum to it exactly (each takes the next 8 bits), the state in two bf16
terms (hi = bf16(v), lo = bf16(v - hi)) for the inter product, W = B o w
(w_j = exp(suffix sum of dt a) dt_j) in two for the state update, y
rounded to bf16.  Held against the plain version on the same
values in float32 at the card's checks (y: rtol 8e-3, atol 1e-4 x max(1,
|want|_inf); the final state: rtol 1e-4, atol 1e-4 x max(1,
|want|_inf)), it passes, and it fails with any one of the splits left
out: that is why the kernel splits each.  P in two terms passes the check
but rounds ten times as many bf16 outputs of y differently from float32;
in three terms y rounds as the float32 chunked form does.  The emulation
is also held to the JAX kernel (``ssd_pallas``, interpret mode) on a small
case, so the chunked form the kernel follows is the TPU kernel's.  The
kernel itself runs in ``tests/test_torch_cuda.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels.ssd import kernel, ssd_chunked
from repro_torch.kernels.ssd import ref as ssd_ref

BF16 = torch.bfloat16

ROUTE_CASES = [
    # (dtype, hd, n, chunk, route)
    (BF16, 64, 16, 256, "sm90"),             # jamba
    (BF16, 64, 128, 256, "sm90"),            # mamba2-780m
    (BF16, 64, 16, 128, "sm90"),
    (BF16, 64, 128, 128, "sm90"),
    (BF16, 64, 48, 64, "sm90"),
    (BF16, 64, 112, 192, "sm90"),
    (BF16, 64, 8, 256, "fp32"),              # n not a multiple of 16
    (BF16, 64, 24, 256, "fp32"),
    (BF16, 64, 144, 256, "fp32"),            # n over 128
    (BF16, 32, 16, 256, "fp32"),             # hd not 64
    (BF16, 16, 16, 256, "fp32"),
    (BF16, 64, 16, 32, "fp32"),              # chunk not 64..256 by 64
    (BF16, 64, 16, 100, "fp32"),
    (BF16, 64, 16, 512, "fp32"),
    (torch.float32, 64, 16, 256, "fp32"),
    (torch.float32, 64, 128, 128, "fp32"),
    (torch.float16, 64, 16, 256, "fp32"),    # the wrapper refuses it
]


@pytest.mark.parametrize("dtype,hd,n,chunk,route", ROUTE_CASES,
                         ids=[f"{str(c[0])[6:]}-hd{c[1]}-n{c[2]}-q{c[3]}"
                              for c in ROUTE_CASES])
def test_route_is_a_function_of_dtype_and_shape(dtype, hd, n, chunk, route):
    assert kernel.select_route(dtype, hd, n, chunk) == route
    assert route in kernel.ROUTES


def _args(dtype, hd=64, n=16, b=1, s=8, nh=2, g=1):
    gen = torch.Generator().manual_seed(hd + n)
    return (torch.randn((b, s, nh, hd), generator=gen).to(dtype),
            torch.rand((b, s, nh), generator=gen).to(dtype),
            -torch.rand((nh,), generator=gen),
            torch.randn((b, s, g, n), generator=gen).to(dtype),
            torch.randn((b, s, g, n), generator=gen).to(dtype))


@pytest.mark.parametrize("dtype,hd,n", [(BF16, 64, 16), (BF16, 64, 128),
                                        (BF16, 32, 16),
                                        (torch.float32, 64, 16)])
def test_wrapper_refuses_cpu_tensors_without_counting(dtype, hd, n):
    """Both routes take CUDA tensors only: a CPU tensor raises before any
    launch is counted, on the wrapper and through ``impl="cuda"``."""
    fn = kernel.ssd_cuda
    args = _args(dtype, hd, n)
    before = (fn.launches, dict(fn.launches_by_route))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fn(*args, chunk=256)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ssd_chunked(*args, chunk=256, impl="cuda")
    assert (fn.launches, fn.launches_by_route) == before


def test_route_counters_cover_every_route():
    assert set(kernel.ssd_cuda.launches_by_route) == set(kernel.ROUTES)
    assert set(kernel.LIBS) == set(kernel.ROUTES)


# ---------------------------------------------------------------------------
# The sm90 kernel's arithmetic in plain torch.
# ---------------------------------------------------------------------------

def _split(v, terms: int, truncate: bool = False):
    """v as the kernel feeds it to bf16 products: the sum of ``terms`` bf16
    terms, each the bf16 rounding (or, ``truncate``, the top 16 bits) of
    what the ones before leave (0 terms: v itself, the float32 chunked
    form)."""
    if not terms:
        return v
    out, rest = torch.zeros_like(v), v
    for _ in range(terms):
        term = ((rest.view(torch.int32) & -65536).view(torch.float32)
                if truncate else rest.to(BF16).float())
        out, rest = out + term, rest - term
    return out


def _sm90_numerics(x, dt, a, bm, cm, chunk, p_terms=3, w_terms=2,
                   state_terms=2):
    """The sm90 kernel's chunked form on float32 values of bf16 inputs: x
    (B,S,nh,hd), dt (B,S,nh), a (nh,), bm/cm (B,S,nh,n) (heads expanded),
    P, W and the state in ``*_terms`` bf16 terms.  Returns (y in bf16,
    final (B,nh,hd,n) float32)."""
    b, s, nh, hd = x.shape
    n = bm.shape[-1]
    y = torch.zeros((b, nh, s, hd))
    state = torch.zeros((b, nh, hd, n))
    tril = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    zero = torch.zeros(())
    for c0 in range(0, s, chunk):
        ln = min(chunk, s - c0)

        def tile(t):            # (B, nh, chunk, ...), zero past the chunk
            t = t[:, c0:c0 + ln].transpose(1, 2)
            pad = torch.zeros(t.shape[:2] + (chunk - ln,) + t.shape[3:])
            return torch.cat([t, pad], dim=2)

        xc, dc, bc, cc = tile(x), tile(dt), tile(bm), tile(cm)
        da = dc * a[None, :, None]
        cum = torch.cumsum(da, dim=-1)
        suffix = torch.flip(torch.cumsum(torch.flip(da, [-1]), -1), [-1]) - da
        scores = cc @ bc.transpose(-1, -2)                   # exact
        decay = torch.exp(torch.where(tril, cum[..., :, None]
                                      - cum[..., None, :], zero))
        p = torch.where(tril, scores * (decay * dc[..., None, :]), zero)
        inter = cc @ _split(state, state_terms).transpose(-1, -2)
        yc = (inter * torch.exp(cum)[..., None]
              + _split(p, p_terms, truncate=True) @ xc)
        y[:, :, c0:c0 + ln] = yc[:, :, :ln]
        w = bc * (torch.exp(suffix) * dc)[..., None]
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + xc.transpose(-1, -2) @ _split(w, w_terms))
    return y.transpose(1, 2).to(BF16), state


def _jamba_like(b, s, nh, n, seed, dt_scale=1.0):
    """bf16-valued float32 inputs as a mamba layer gives them: softplus dt
    (times ``dt_scale``: a fast decay whose exp underflows), a =
    -exp(0.5 randn)."""
    rng = np.random.default_rng(seed)
    as_bf16 = lambda v: torch.from_numpy(v.astype(np.float32)).to(BF16).float()
    x = as_bf16(rng.standard_normal((b, s, nh, 64)))
    dt = as_bf16(np.log1p(np.exp(rng.standard_normal((b, s, nh)))) * dt_scale)
    a = torch.from_numpy((-np.exp(0.5 * rng.standard_normal(nh)))
                         .astype(np.float32))
    bm = as_bf16(rng.standard_normal((b, s, nh, n)))
    cm = as_bf16(rng.standard_normal((b, s, nh, n)))
    return x, dt, a, bm, cm


def _prefill_like(b, s, nh, n, seed):
    """bf16-valued inputs with the statistics of the jamba prefill's scans
    as a card run read them: a = -1 (a_log initialised to 0), dt over
    [0.005, 5], |x| up to ~10, |B| and |C| up to ~6."""
    rng = np.random.default_rng(seed)
    as_bf16 = lambda v: torch.from_numpy(v.astype(np.float32)).to(BF16).float()
    x = as_bf16(3 * rng.standard_normal((b, s, nh, 64)))
    dt = as_bf16(np.log1p(np.exp(2 * rng.standard_normal((b, s, nh)) - 1)))
    bm = as_bf16(2 * rng.standard_normal((b, s, nh, n)))
    cm = as_bf16(2 * rng.standard_normal((b, s, nh, n)))
    return x, dt, -torch.ones(nh), bm, cm


def _misses(got, want, rtol, atol):
    """Entries of got outside want's tolerance: atol x max(1, |want|_inf)."""
    got, want = got.double(), want.double()
    atol = atol * max(1.0, float(want.abs().max()))
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


EMULATION_CASES = [
    # (b, s, nh, n, chunk, dt_scale): S with a partial last chunk
    (1, 600, 4, 16, 256, 1.0),         # jamba's n and chunk
    (1, 300, 4, 128, 128, 1.0),        # mamba2's n, chunk 128
    (1, 520, 2, 16, 256, 10.0),        # fast decay
    (1, 520, 2, 128, 256, 10.0),
]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=str)
def test_sm90_numerics_meet_the_card_checks(case):
    b, s, nh, n, chunk, dt_scale = case
    x, dt, a, bm, cm = _jamba_like(b, s, nh, n, seed=s + n, dt_scale=dt_scale)
    want_y, want_f = ssd_ref.ref_ssd(x, dt, a, bm, cm,
                                     torch.zeros((b, nh, 64, n)))
    y, final = _sm90_numerics(x, dt, a, bm, cm, chunk)
    assert y.dtype == BF16 and bool(torch.isfinite(y.float()).all())
    assert _misses(y.float(), want_y, 8e-3, 1e-4) == 0
    assert _misses(final, want_f, 1e-4, 1e-4) == 0


@pytest.mark.parametrize("dropped,case,out", [
    ("p", (1, 600, 4, 16, 256, 1.0), "y"),
    ("w", (1, 600, 4, 16, 256, 1.0), "final"),
    ("state", (1, 300, 4, 128, 128, 1.0), "y"),
], ids=["p_one_term", "w_one_term", "state_one_term"])
def test_each_split_is_needed(dropped, case, out):
    """One bf16 term in place of a split misses the card's check: P and
    the state on y, W on the final state."""
    b, s, nh, n, chunk, dt_scale = case
    x, dt, a, bm, cm = _jamba_like(b, s, nh, n, seed=s + n, dt_scale=dt_scale)
    want_y, want_f = ssd_ref.ref_ssd(x, dt, a, bm, cm,
                                     torch.zeros((b, nh, 64, n)))
    y, final = _sm90_numerics(x, dt, a, bm, cm, chunk,
                              p_terms=1 if dropped == "p" else 3,
                              w_terms=1 if dropped == "w" else 2,
                              state_terms=1 if dropped == "state" else 2)
    if out == "y":
        assert _misses(y.float(), want_y, 8e-3, 1e-4) > 0
    else:
        assert _misses(final, want_f, 1e-4, 1e-4) > 0


def test_p_in_three_terms_rounds_y_as_float32_does():
    """The share of bf16 outputs of y that round differently from the
    plain version's float32 y, on inputs like the jamba prefill's: P in
    three terms is within 1.5x of the float32 chunked form's; in two terms
    it is over 5x (on the card, ``repro_torch.kernels.ssd.ablate`` prints
    the share for the kernel and for P in two terms)."""
    b, s, nh, n, chunk = 1, 1024, 4, 16, 256
    x, dt, a, bm, cm = _prefill_like(b, s, nh, n, seed=9)
    want = ssd_ref.ref_ssd(x, dt, a, bm, cm,
                           torch.zeros((b, nh, 64, n)))[0].to(BF16)
    flips = {}
    for p_terms in (0, 2, 3):
        y, _ = _sm90_numerics(x, dt, a, bm, cm, chunk, p_terms=p_terms,
                              w_terms=0 if p_terms == 0 else 2,
                              state_terms=0 if p_terms == 0 else 2)
        flips[p_terms] = int((y != want).sum())
    assert flips[0] > 0
    assert flips[3] <= 1.5 * flips[0]
    assert flips[2] > 5 * flips[0]


def test_sm90_numerics_follow_the_jax_kernel():
    """The emulated chunked form against ``ssd_pallas`` in interpret mode
    (the TPU kernel, float32, on the same values), at the card's checks."""
    b, s, nh, n, chunk = 1, 256, 2, 16, 128
    x, dt, a, bm, cm = _jamba_like(b, s, nh, n, seed=3)
    y, final = _sm90_numerics(x, dt, a, bm, cm, chunk)
    flat = lambda t: jnp.asarray(t.transpose(1, 2).reshape(b * nh, s, -1)
                                 .numpy())
    jy, jf = ssd_pallas(flat(x), flat(dt[..., None]), flat(bm), flat(cm),
                        jnp.asarray(np.repeat(a.numpy(), b)[:, None]),
                        chunk=chunk, interpret=True)
    want_y = torch.from_numpy(np.array(jy)).reshape(b, nh, s, 64) \
        .transpose(1, 2)
    want_f = torch.from_numpy(np.array(jf)).reshape(b, nh, n, 64) \
        .transpose(-1, -2)
    assert _misses(y.float(), want_y, 8e-3, 1e-4) == 0
    assert _misses(final, want_f, 1e-4, 1e-4) == 0
