"""Mamba2 (SSD, state-space duality) sequence mixer (the port of
:mod:`repro.models.ssm`).

Prefill runs the chunked SSD form: a Python loop over chunks of
``ssm_chunk`` positions carries the float32 SSM state from chunk to
chunk, and inside a chunk the output is a masked quadratic form over
the chunk. Decode is the O(1) recurrent step. One B/C group is shared
across heads. The reference's four-operand einsums are written as
explicit products, so no ``[B, H, Q, Q, P]`` intermediate is formed.

State carried for serving: ``conv`` ``[B, W-1, conv_dim]`` and ``ssd``
``[B, H, P, N]``, both float32 whatever dtype the rest of the cache
has.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._xla_math import cumsum_f32, exp_xla_f32, sum_rows_f32

from .config import ModelConfig
from .layers import _silu, dense, dense_f32, param, softplus


class SSM(torch.nn.Module):
    """``in_proj`` ``[D, 2 Di + 2 N + H]``, ``conv_w`` ``[W, conv_dim]``,
    ``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``norm_scale`` and
    ``out_proj`` ``[Di, D]``, float32. The deterministic leaves take the
    reference's values: ``A_log = log(linspace(1, 16, H))``, ``D`` and
    ``norm_scale`` ones, ``dt_bias`` and ``conv_b`` zeros."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * n
        self.in_proj = param((d, 2 * di + 2 * n + h), d ** -0.5, generator,
                             device)
        self.conv_w = param((cfg.ssm_conv, conv_dim), 0.5, generator, device)
        self.conv_b = _fixed(np.zeros(conv_dim), device)
        self.A_log = _fixed(np.log(np.linspace(1.0, 16.0, h,
                                               dtype=np.float32)), device)
        self.D = _fixed(np.ones(h), device)
        self.dt_bias = _fixed(np.zeros(h), device)
        self.norm_scale = _fixed(np.ones(di), device)
        self.out_proj = param((di, d), di ** -0.5, generator, device)


def _fixed(values, device) -> torch.nn.Parameter:
    t = torch.from_numpy(np.asarray(values, np.float32)).to(device)
    return torch.nn.Parameter(t, requires_grad=False)


def init_ssm(cfg: ModelConfig, generator=None, device=None) -> SSM:
    return SSM(cfg, generator, device)


def _decay_rates(A_log):
    """``A = -exp(A_log)`` in ``A_log``'s dtype, as ``jnp.exp`` keeps it:
    XLA:CPU's float32 ``exp``, rounded once to a bfloat16 ``A_log``'s
    dtype (parameters cast to bfloat16, the dry-run's ``--bf16-params``);
    the float32 path is unchanged. The products with the float32 ``dt``
    then promote to float32 in both packages."""
    return -exp_xla_f32(A_log).to(A_log.dtype)


def _split_proj(cfg: ModelConfig, zxbcdt):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(zxbcdt, [di, di, n, n, h], dim=-1)


def _gated_norm(scale, y, z, eps):
    yf = y.float() * _silu(z.float())
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _causal_conv(w, b, x):
    """Depthwise causal conv, x: [B, S, C], w: [W, C] (float32 taps
    summed in order)."""
    width, s = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, width - 1, 0))
    out = 0
    for i in range(width):
        out = out + xp[:, i:i + s, :] * w[i]
    return _silu(out + b).to(x.dtype)


def _segsum(x):
    """segsum[..., i, j] = sum_{k in (j, i]} x[..., k] below and on the
    diagonal, -inf above it (``exp`` gives 0 there: the cumulative sums
    are finite, so no ``inf - inf`` arises)."""
    q = x.shape[-1]
    cs = cumsum_f32(x, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, diff, -torch.inf)


def _chunk_step(state, xck, Bk, Ck, dtk, dAk):
    """One chunk: xck [b, q, h, p], Bk / Ck [b, q, n], dtk / dAk [b, q,
    h], state [b, h, p, n] -> (new state, y [b, q, h, p])."""
    # intra-chunk: the masked quadratic form
    L = exp_xla_f32(_segsum(dAk.transpose(1, 2)))                  # [b,h,q,q]
    scores = Ck @ Bk.transpose(1, 2)                             # [b,q,q]
    M = scores[:, None] * L * dtk.permute(0, 2, 1)[:, :, None, :]
    y_intra = M @ xck.permute(0, 2, 1, 3)                        # [b,h,q,p]
    # the carried state's contribution
    cum = cumsum_f32(dAk, 1)                                     # [b,q,h]
    y_inter = (Ck[:, None] @ state.transpose(2, 3)) \
        * exp_xla_f32(cum).permute(0, 2, 1)[..., None]             # [b,h,q,p]
    # the chunk's new state. The decay's sums and exps take XLA:CPU's
    # order and bits (:mod:`repro_torch._xla_math`): exp(total - cum)
    # cancels two sums of up to a few hundred, where one float32 ulp is
    # a 1e-5 move of the state
    b, q, h = dAk.shape
    total = sum_rows_f32(dAk.transpose(1, 2).reshape(b * h, q)).view(b, h)
    w = dtk * exp_xla_f32(total[:, None] - cum)                    # [b,q,h]
    s_new = (xck * w[..., None]).permute(0, 2, 3, 1) @ Bk[:, None]  # [b,h,p,n]
    state = state * exp_xla_f32(total)[..., None, None] + s_new
    return state, (y_intra + y_inter).permute(0, 2, 1, 3)


def ssd_chunks(xh, B, C, dt, dA, q: int):
    """The chunk loop: xh [b, s, h, p], B / C [b, s, n], dt / dA [b, s,
    h] float32, s a multiple of ``q`` -> (y [b, s, h, p], final state [b,
    h, p, n]), the state carried from a zero start."""
    b, s, h, hp = xh.shape
    state = torch.zeros(b, h, hp, B.shape[-1], dtype=torch.float32,
                        device=xh.device)
    ys = []
    for c in range(0, s, q):
        state, yc = _chunk_step(state, xh[:, c:c + q], B[:, c:c + q],
                                C[:, c:c + q], dt[:, c:c + q], dA[:, c:c + q])
        ys.append(yc)
    return torch.cat(ys, 1), state


def ssm_train(p: SSM, cfg: ModelConfig, x, return_state: bool = False):
    """Chunked SSD over a prompt. x: [B, S, D] -> [B, S, D] (and the
    final state when ``return_state``, which seeds decoding)."""
    b, s_real, _ = x.shape
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s_real)
    # pad to a chunk multiple; padded positions get dt = 0, which makes
    # them exact no-ops on the SSM state (decay exp(0) = 1, no input)
    s = -(-s_real // q) * q
    if s != s_real:
        x = torch.nn.functional.pad(x, (0, 0, 0, s - s_real))

    proj = dense_f32(p.in_proj, x)
    z, xs, B, C, dt = _split_proj(cfg, proj)
    xBC_raw = torch.cat([xs, B, C], -1)
    xBC = _causal_conv(p.conv_w, p.conv_b, xBC_raw)
    xs, B, C = torch.split(xBC, [di, n, n], dim=-1)

    dt = softplus(dt.float() + p.dt_bias)                          # [B,S,H]
    if s != s_real:
        valid = (torch.arange(s, device=x.device) < s_real)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    A = _decay_rates(p.A_log)
    xh = xs.reshape(b, s, h, hp).float()
    dA = dt * A

    y, state = ssd_chunks(xh, B.float(), C.float(), dt, dA, q)
    y = y + p.D[:, None] * xh
    y = _gated_norm(p.norm_scale, y.reshape(b, s, di), z, cfg.norm_eps)
    out = dense(p.out_proj, y).to(x.dtype)[:, :s_real]
    if not return_state:
        return out
    w = cfg.ssm_conv
    tail = xBC_raw[:, :s_real][:, -(w - 1):].float()
    if s_real < w - 1:
        tail = torch.nn.functional.pad(tail, (0, 0, w - 1 - s_real, 0))
    return out, {"conv": tail, "ssd": state}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device=None):
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_dim, dtype=dtype,
                            device=device),
        "ssd": torch.zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state, dtype=dtype, device=device),
    }


def ssm_decode(p: SSM, cfg: ModelConfig, x, cache):
    """One-token recurrent step. x: [B, 1, D]; returns (out [B, 1, D],
    new cache entry)."""
    b = x.shape[0]
    di, n, h, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    proj = dense_f32(p.in_proj, x)
    z, xs, B, C, dt = _split_proj(cfg, proj)
    xBC_new = torch.cat([xs, B, C], -1)                      # [B,1,conv_dim]
    window = torch.cat([cache["conv"], xBC_new.to(cache["conv"].dtype)], 1)
    conv_out = 0
    for i in range(window.shape[1]):
        conv_out = conv_out + window[:, i] * p.conv_w[i]
    xBC = _silu(conv_out + p.conv_b)                         # [B,conv_dim]
    xs, B, C = torch.split(xBC, [di, n, n], dim=-1)

    dt = softplus(dt[:, 0].float() + p.dt_bias)              # [B,H]
    dA = exp_xla_f32(dt * _decay_rates(p.A_log))
    xh = xs.reshape(b, h, hp).float()
    ssd = cache["ssd"] * dA[..., None, None] + \
        (dt[..., None] * xh)[..., None] * B.float()[:, None, None, :]
    y = (ssd @ C.float()[:, None, :, None])[..., 0] + p.D[:, None] * xh
    y = _gated_norm(p.norm_scale, y.reshape(b, 1, di), z, cfg.norm_eps)
    out = dense(p.out_proj, y).to(x.dtype)
    return out, {"conv": window[:, 1:], "ssd": ssd.to(cache["ssd"].dtype)}
