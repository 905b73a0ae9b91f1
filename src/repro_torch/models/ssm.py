"""Mamba-2 (SSD) block (port of ``repro/models/ssm.py``).

The full-sequence block runs its chunked scan through the SSD op
(``kernels/ssd``) where JAX runs ``models/ssm.ssd``, its XLA form of the
same chunked scan; the training block, ``mamba_train``, runs ``ssd``, the
port of that chunked form, through autograd (no kernel has a backward).
Decode is the plain one-token recurrence, in torch.

Layout: x (B, S, D); inner width di = expand * D; heads nh = di / hd;
state n = ssm_state; groups g (B/C shared across nh/g heads).  The conv
frontend is a causal depthwise conv of width w over the (x, B, C)
channels.

On a mesh (``ParamTree`` under a ``MeshCtx``) the block runs on this
rank's SSM heads (the rules split "mlp" and "ssm_heads" over the model
axis): ``w_z``, ``w_x``, ``w_dt``, ``a_log``, ``dt_bias``, ``d_skip`` and
``norm`` hold the local heads, ``w_bc`` is whole, and ``conv_w`` /
``conv_b`` hold the x channels of the local heads followed by the whole
B / C channels (``Param.tail``).  The gated norm's mean of squares runs
over the whole inner width (the local sums summed over the model axis),
``w_out``'s partial products are summed over it in float32
(``collectives.psum_product``), and the decode state is (B, nh_loc, hd,
n).  In training the block's input enters the split projections through
``collectives.to_split``, as do the whole ``w_bc`` and the conv's B / C
tail (replicated weights used on the local heads), and the norm's sum
of squares is summed over the axis in the backward too.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.kernels.ssd import ssd_chunked
from repro_torch.nn.module import Param, ParamTree, axes, held, split

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    n = cfg.ssm_state
    g = cfg.ssm_ngroups
    conv_ch = di + 2 * g * n
    return di, nh, n, g, conv_ch


def mamba_specs(cfg: ModelConfig) -> Dict[str, Param]:
    """The in-projection split per role (z / x / BC / dt), as in JAX."""
    d = cfg.d_model
    di, nh, n, g, conv_ch = _dims(cfg)
    return {
        "w_z": Param((d, di), init="fan_in", logical=("embed", "mlp")),
        "w_x": Param((d, di), init="fan_in", logical=("embed", "mlp")),
        "w_bc": Param((d, 2 * g * n), init="fan_in", logical=("embed", None)),
        "w_dt": Param((d, nh), init="fan_in", logical=("embed", "ssm_heads")),
        "conv_w": Param((cfg.ssm_conv_width, conv_ch), init="fan_in",
                        scale=1.0, logical=("conv", "mlp"), tail=2 * g * n),
        "conv_b": Param((conv_ch,), init="zeros", logical=("mlp",),
                        tail=2 * g * n),
        "a_log": Param((nh,), init="zeros", logical=("ssm_heads",)),
        "dt_bias": Param((nh,), init="zeros", logical=("ssm_heads",)),
        "d_skip": Param((nh,), init="ones", logical=("ssm_heads",)),
        "norm": Param((di,), init="ones", logical=("mlp",)),
        "w_out": Param((di, d), init="fan_in", logical=("mlp", "embed")),
    }


def local_heads(p: ParamTree, cfg: ModelConfig) -> Tuple[int, int]:
    """The ``[start, stop)`` of the SSM heads this rank runs; raises when
    the rules split the inner width and the heads unalike."""
    if split(p, "w_x", 1) != split(p, "w_dt", 1):
        raise ValueError(
            f"{cfg.name}: the model axis splits the inner width "
            f"{cfg.d_inner} and the {cfg.ssm_heads} SSM heads unalike")
    return held(p, "w_dt", 1)


def _local_groups(p: ParamTree, cfg: ModelConfig) -> Tuple[int, int]:
    """The ``[start, stop)`` of the B / C groups of this rank's heads."""
    lo, hi = local_heads(p, cfg)
    hpg = cfg.ssm_heads // cfg.ssm_ngroups
    glo, ghi = lo // hpg, -(-hi // hpg)
    if ghi - glo > 1 and (lo % hpg or (hi - lo) % hpg):
        raise ValueError(f"{cfg.name}: SSM heads [{lo}, {hi}) straddle "
                         f"groups of {hpg}")
    return glo, ghi


class MambaCache(NamedTuple):
    conv: Tensor    # (B, w-1, conv_ch) most recent inputs to the conv
    state: Tensor   # (B, nh, hd, n) recurrent SSD state, f32


def init_mamba_cache(cfg: ModelConfig, batch: int, device: torch.device,
                     dtype=None, n_heads: Optional[int] = None
                     ) -> MambaCache:
    """An empty cache for ``n_heads`` SSM heads (default: all of them)."""
    di, nh, n, g, conv_ch = _dims(cfg)
    if n_heads is not None:
        nh = n_heads
        conv_ch = nh * cfg.ssm_head_dim + 2 * g * n
    dtype = dtype or cfg.cdtype
    return MambaCache(
        conv=torch.zeros((batch, cfg.ssm_conv_width - 1, conv_ch),
                         dtype=dtype, device=device),
        state=torch.zeros((batch, nh, cfg.ssm_head_dim, n),
                          dtype=torch.float32, device=device),
    )


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv along seq.  xbc (B,S,C), w (W,C)."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def ssd(x: Tensor, dt: Tensor, a: Tensor, bmat: Tensor, cmat: Tensor,
        init_state: Tensor, chunk: int) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan, differentiable (port of JAX's ``models/ssm.ssd``).

    x (B,S,nh,hd): pre-scaled inputs; dt (B,S,nh): softplus'd step sizes;
    a (nh,): negative decay rates; bmat/cmat (B,S,g,n); init_state
    (B,nh,hd,n).  Within a chunk the recurrence is its (Q, Q) masked dual
    form; between chunks a loop carries the (n, hd) state in float32.
    Returns (y (B,S,nh,hd) in x's dtype, final_state (B,nh,hd,n) f32).
    Products JAX takes with ``preferred_element_type=float32`` are taken
    on float32 casts."""
    b, s, nh, hd = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hpg = nh // g
    q = min(chunk, s)
    while s % q:
        q //= 2
    q = max(q, 1)
    nc = s // q

    da = dt * a[None, None, :]                                 # (B,S,nh) <= 0
    xdt = x * dt[..., None]                                    # (B,S,nh,hd)

    def ck(t):
        return t.reshape((b, nc, q) + tuple(t.shape[2:]))

    cum = torch.cumsum(ck(da), dim=2)                          # (B,nc,Q,nh)
    xdtc = ck(xdt)                                             # (B,nc,Q,nh,hd)
    bh = torch.repeat_interleave(ck(bmat), hpg, dim=3)         # (B,nc,Q,nh,n)
    chh = torch.repeat_interleave(ck(cmat), hpg, dim=3)

    # Intra-chunk (dual / attention-like form).
    cum_t = cum.transpose(2, 3)                                # (B,nc,nh,Q)
    ldiff = cum_t[..., :, None] - cum_t[..., None, :]          # (B,nc,nh,Q,Q)
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    # Clamp BEFORE the exp: exp(ldiff) overflows on the masked (upper
    # triangle) entries and a mask after it gives 0 * inf = NaN in the
    # backward.  exp(-1e30) is exactly 0, with a 0 gradient.
    lmask = torch.exp(torch.where(tril, ldiff, -1e30))
    scores = torch.einsum("bcqhn,bckhn->bchqk", chh.float(), bh.float())
    y_intra = torch.einsum("bchqk,bckhp->bcqhp",
                           (scores * lmask).to(x.dtype), xdtc)

    # Chunk summaries for the inter-chunk recurrence.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # (B,nc,Q,nh)
    s_chunk = torch.einsum("bckhn,bckhp->bchnp",
                           bh * decay_to_end[..., None].to(bh.dtype), xdtc)
    t_chunk = torch.exp(cum[:, :, -1, :])                      # (B,nc,nh)
    c_in = chh * torch.exp(cum)[..., None].to(chh.dtype)       # (B,nc,Q,nh,n)

    state = init_state.transpose(2, 3).float()                 # (B,nh,n,hd)
    ys = []
    for i in range(nc):
        # y from the state BEFORE absorbing this chunk.
        ys.append(torch.einsum("bqhn,bhnp->bqhp", c_in[:, i],
                               state.to(c_in.dtype)))
        state = (state * t_chunk[:, i, :, None, None]
                 + s_chunk[:, i].float())
    y = (y_intra + torch.stack(ys, dim=1)).reshape(b, s, nh, hd)
    return y, state.transpose(2, 3)                            # (B,nh,hd,n)


def _gated_norm(y: Tensor, z: Tensor, scale: Tensor, eps: float,
                ctx=None, over=None) -> Tensor:
    """The gated RMSNorm over the inner width; with ``over`` (the model
    axes splitting it) the local sums of squares are summed over them
    first."""
    h = y * F.silu(z)
    hf = h.to(torch.float32)
    if over is None:
        var = torch.mean(hf * hf, dim=-1, keepdim=True)
    else:
        var = collectives.psum(torch.sum(hf * hf, dim=-1, keepdim=True),
                               ctx, over, grad="psum") / (
            hf.shape[-1] * ctx.size(over))
    return (hf * torch.rsqrt(var + eps) * scale.to(torch.float32)
            ).to(y.dtype)


def _dt_a(p: ParamTree, dt_raw: Tensor) -> Tuple[Tensor, Tensor]:
    dt = F.softplus(dt_raw.to(torch.float32) + p.dt_bias.to(torch.float32))
    return dt, -torch.exp(p.a_log.to(torch.float32))


def _mixer_in(p: ParamTree, cfg: ModelConfig, x: Tensor):
    """The in-projections and the causal conv of x (B,S,D): (z, x_raw,
    bc_raw, the scan's inputs (x_ssm, dt, a, bmat, cmat))."""
    b, s, d = x.shape
    n, g, hd = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_head_dim
    lo, hi = local_heads(p, cfg)
    glo, ghi = _local_groups(p, cfg)
    di = (hi - lo) * hd                                  # local inner width
    over = axes(p, "w_x", 1)

    def whole(t):        # a replicated weight used on the local heads
        return collectives.to_split(t, p.ctx, over)

    x = whole(x)
    z = x @ p.w_z                                        # (B,S,di)
    x_raw = x @ p.w_x                                    # (B,S,di)
    bc_raw = x @ whole(p.w_bc)                           # (B,S,2gn)
    dt_raw = x @ p.w_dt                                  # (B,S,nh)
    x_conv = _causal_conv(x_raw, p.conv_w[:, :di], p.conv_b[:di])
    bc_conv = _causal_conv(bc_raw, whole(p.conv_w[:, di:]),
                           whole(p.conv_b[di:]))
    x_ssm = x_conv.reshape(b, s, hi - lo, hd)
    bmat = bc_conv[..., :g * n].reshape(b, s, g, n)[:, :, glo:ghi]
    cmat = bc_conv[..., g * n:].reshape(b, s, g, n)[:, :, glo:ghi]
    dt, a = _dt_a(p, dt_raw)
    # dt goes into the scan in x's dtype, as JAX's mamba_forward casts it:
    # in bf16 that rounding is part of the function.
    return z, x_raw, bc_raw, (x_ssm, dt.to(x.dtype), a, bmat, cmat)


def _mixer_out(p: ParamTree, cfg: ModelConfig, y: Tensor, x_ssm: Tensor,
               z: Tensor) -> Tensor:
    """The skip, the gated norm and the out-projection of the scan's y."""
    b, s = y.shape[:2]
    y = y + p.d_skip.to(y.dtype)[None, None, :, None] * x_ssm
    y = _gated_norm(y.reshape(b, s, z.shape[-1]), z, p.norm, cfg.norm_eps,
                    p.ctx, axes(p, "norm", 0))
    return collectives.psum_product(torch.matmul, y, p.w_out, p.ctx,
                                    axes(p, "w_out", 0))


def mamba_train(p: ParamTree, cfg: ModelConfig, x: Tensor) -> Tensor:
    """Full-sequence mamba-2 block for training, no cache: x (B,S,D) ->
    y (B,S,D), the scan through ``ssd`` (differentiable)."""
    z, _, _, scan_in = _mixer_in(p, cfg, x)
    b, s, nh, hd = scan_in[0].shape
    state0 = x.new_zeros((b, nh, hd, cfg.ssm_state), dtype=torch.float32)
    y, _ = ssd(*scan_in, state0, cfg.ssm_chunk)
    return _mixer_out(p, cfg, y, scan_in[0], z)


def mamba_forward(p: ParamTree, cfg: ModelConfig, x: Tensor,
                  impl: str = "auto") -> Tuple[Tensor, MambaCache]:
    """Full-sequence mamba-2 block.  x (B,S,D) -> (y (B,S,D), cache), the
    scan through the SSD op on backend ``impl``."""
    b, s, d = x.shape
    z, x_raw, bc_raw, scan_in = _mixer_in(p, cfg, x)
    conv_ch = x_raw.shape[-1] + bc_raw.shape[-1]
    y, final_state = ssd_chunked(*scan_in, chunk=cfg.ssm_chunk, impl=impl)
    out = _mixer_out(p, cfg, y.to(x.dtype), scan_in[0], z)

    xbc_raw = torch.cat([x_raw, bc_raw], dim=-1)         # cache layout
    keep = cfg.ssm_conv_width - 1
    conv_tail = torch.cat(
        [xbc_raw.new_zeros((b, max(keep - s, 0), conv_ch)),
         xbc_raw[:, max(s - keep, 0):, :]], dim=1)
    return out, MambaCache(conv=conv_tail.to(cfg.cdtype), state=final_state)


def mamba_decode(p: ParamTree, cfg: ModelConfig, x: Tensor,
                 cache: MambaCache) -> Tuple[Tensor, MambaCache]:
    """One-token recurrence.  x (B,1,D)."""
    b = x.shape[0]
    n, g, hd = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_head_dim
    lo, hi = local_heads(p, cfg)
    glo, ghi = _local_groups(p, cfg)
    nh, di = hi - lo, (hi - lo) * hd                     # local heads, width

    x0 = x[:, 0]
    z = x0 @ p.w_z                                       # (B, di)
    xbc_raw = torch.cat([x0 @ p.w_x, x0 @ p.w_bc], dim=-1)   # (B, conv_ch)
    dt_raw = x0 @ p.w_dt
    window = torch.cat([cache.conv.to(xbc_raw.dtype), xbc_raw[:, None, :]],
                       dim=1)                            # (B,W,C)
    conv_out = torch.einsum("bwc,wc->bc", window, p.conv_w)
    xbc = F.silu(conv_out + p.conv_b[None])
    x_ssm = xbc[:, :di].reshape(b, nh, hd)
    hpg = nh // (ghi - glo)
    bh = torch.repeat_interleave(
        xbc[:, di:di + g * n].reshape(b, g, n)[:, glo:ghi], hpg,
        dim=1)                                           # (B,nh,n)
    chh = torch.repeat_interleave(
        xbc[:, di + g * n:].reshape(b, g, n)[:, glo:ghi], hpg, dim=1)

    dt, a = _dt_a(p, dt_raw)
    da = torch.exp(dt * a[None])                         # (B,nh)
    xdt = (x_ssm * dt[..., None].to(x_ssm.dtype)).to(torch.float32)
    upd = torch.einsum("bhn,bhp->bhpn", bh.to(torch.float32), xdt)
    state = cache.state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, chh.to(torch.float32))
    y = y.to(x.dtype)
    y = y + p.d_skip.to(y.dtype)[None, :, None] * x_ssm
    y = _gated_norm(y.reshape(b, di), z, p.norm, cfg.norm_eps, p.ctx,
                    axes(p, "norm", 0))
    out = collectives.psum_product(torch.matmul, y, p.w_out, p.ctx,
                                   axes(p, "w_out", 0))[:, None, :]

    new_conv = torch.cat([cache.conv[:, 1:, :],
                          xbc_raw[:, None, :].to(cache.conv.dtype)], dim=1)
    return out, MambaCache(conv=new_conv, state=state)
