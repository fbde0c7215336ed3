"""GQA attention: the training and prefill (causal), encoder
(bidirectional), cross and decode paths (the port of
:mod:`repro.models.attention`).

Training, prefill, the encoder and cross attention run
:func:`blocked_attention`, an online softmax over KV chunks that never
forms the ``[S, S]`` score matrix. The reference computes it as a
``lax.scan`` and names the Pallas ``flash_attention`` kernel as its
computation on the accelerator; here it is that kernel on the card
(``kernels/flash_attention``; GQA-native, so the causal path passes KV
un-expanded, while the encoder and cross paths pass it expanded, as the
reference does) and its plain version, tiled by ``chunk``, on the CPU,
through the autograd Function ``FlashAttention``: a backward runs the
``flash_attention_bwd`` kernel on the card and the plain backward on
the CPU (the reference differentiates its scan).

Decode attends one query position against the KV cache in plain
PyTorch (the reference has no kernel there); for sliding-window configs
only the last ``window`` positions are attended. Cross decode attends
the static encoder memory, also in plain PyTorch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import ops as flash

from .config import ModelConfig
from .layers import apply_rope, dense, head_rmsnorm, param, weak

NEG_INF = -1e30


class Attention(torch.nn.Module):
    """``wq`` / ``wk`` / ``wv`` / ``wo``, each ``[d_in, d_out]`` float32,
    and the qk-norm scales ``q_norm`` / ``k_norm`` ``[head_dim]``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = param((d, h * dh), d ** -0.5, generator, device)
        self.wk = param((d, hk * dh), d ** -0.5, generator, device)
        self.wv = param((d, hk * dh), d ** -0.5, generator, device)
        self.wo = param((h * dh, d), (h * dh) ** -0.5, generator, device)
        if cfg.qk_norm:
            self.q_norm = param((dh,), None, generator, device)
            self.k_norm = param((dh,), None, generator, device)


def init_attention(cfg: ModelConfig, generator=None, device=None,
                   cross: bool = False):
    """Self or cross attention: the same parameters (``cross`` names the
    use, as in the reference)."""
    return Attention(cfg, generator, device)


def _project_q(params: Attention, cfg: ModelConfig, x, positions,
               rope: bool = True):
    b, s, _ = x.shape
    q = dense(params.wq, x).reshape(b, s, cfg.num_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = head_rmsnorm(params.q_norm, q, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(params: Attention, cfg: ModelConfig, x, positions,
                rope: bool = True):
    b, s, _ = x.shape
    k = dense(params.wk, x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = dense(params.wv, x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = head_rmsnorm(params.k_norm, k, cfg.norm_eps)
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _expand_kv(x, groups: int):
    """[B,S,Hkv,Dh] -> [B,S,Hkv*groups,Dh] (GQA head replication)."""
    b, s, hk, dh = x.shape
    return x[:, :, :, None, :].expand(b, s, hk, groups, dh).reshape(
        b, s, hk * groups, dh)


# ---------------------------------------------------------------------------
# blocked causal attention (prefill)
# ---------------------------------------------------------------------------

def blocked_attention(q, k, v, *, causal: bool, window: int = 0,
                      chunk: int = 1024, q_offset: int = 0):
    """Online-softmax attention over KV chunks.

    q: [B,Sq,H,Dh], k/v: [B,Skv,Hkv,Dh] with H a multiple of Hkv (GQA;
    the reference takes KV already expanded, Hkv = H, which this
    accepts too). window > 0 restricts attention to the trailing
    ``window`` positions; q_offset is the absolute position of q[0]
    relative to k[0]. The flash kernel on the card, its plain version
    with ``chunk``-wide KV tiles (the reference scan's order) on the
    CPU. Returns [B,Sq,H,Dh] in q's dtype.
    """
    sq, skv = q.shape[1], k.shape[1]
    chunk = min(chunk, skv)
    assert skv % chunk == 0, (skv, chunk)
    return flash.attention(q, k, v, causal=causal, window=window, tq=sq,
                           tk=chunk, q_offset=q_offset)


def attention_train(params: Attention, cfg: ModelConfig, x, positions,
                    chunk: int = 1024):
    """Full causal self-attention for prefill. Returns (out, k, v) so
    callers can populate a KV cache."""
    q = _project_q(params, cfg, x, positions)
    k, v = _project_kv(params, cfg, x, positions)
    out = blocked_attention(q, k, v, causal=True, window=cfg.sliding_window,
                            chunk=min(chunk, x.shape[1]))
    b, s, _, _ = out.shape
    out = dense(params.wo, out.reshape(b, s, -1))
    return out, k, v


def attention_encoder(params: Attention, cfg: ModelConfig, x, positions):
    """Bidirectional (encoder) self-attention."""
    q = _project_q(params, cfg, x, positions)
    k, v = _project_kv(params, cfg, x, positions)
    groups = cfg.num_heads // cfg.num_kv_heads
    out = blocked_attention(q, _expand_kv(k, groups), _expand_kv(v, groups),
                            causal=False, chunk=min(1024, x.shape[1]))
    b, s, _, _ = out.shape
    return dense(params.wo, out.reshape(b, s, -1))


def attention_cross(params: Attention, cfg: ModelConfig, x, memory_kv,
                    positions):
    """Cross-attention of the decoder's prompt against the precomputed
    encoder memory ``(k, v)`` ``[B, S_enc, Hkv, Dh]`` (no RoPE on q;
    Sq and S_enc differ)."""
    k, v = memory_kv
    q = _project_q(params, cfg, x, positions, rope=False)
    groups = cfg.num_heads // cfg.num_kv_heads
    out = blocked_attention(q, _expand_kv(k, groups), _expand_kv(v, groups),
                            causal=False, chunk=min(1024, k.shape[1]))
    b, s, _, _ = out.shape
    return dense(params.wo, out.reshape(b, s, -1))


# ---------------------------------------------------------------------------
# decode (one token against a KV cache)
# ---------------------------------------------------------------------------

def attention_decode(params: Attention, cfg: ModelConfig, x, cache_k,
                     cache_v, pos: int):
    """x: [B,1,D]; cache_k/v: [B,Skv,Hkv,Dh].

    Returns (out [B,1,D], cache_k, cache_v). The new token's K/V is
    written at ``pos % Skv``, in place (the reference returns updated
    copies; writing in place saves copying the whole cache every
    token). For sliding-window configs the cache is a ring of window
    size; K/V carry absolute RoPE, so slot order does not matter.

    Scores and the weighted sum are float32 products of the bfloat16
    operands the reference feeds its MXU dots (q·scale rounded to the
    cache dtype; p rounded to it before ``p @ V``): each cache layer is
    read through a float32 copy, since a bfloat16 product would round
    the scores themselves.
    """
    b = x.shape[0]
    skv = cache_k.shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(params, cfg, x, positions)              # [B,1,H,Dh]
    k_new, v_new = _project_kv(params, cfg, x, positions)  # [B,1,Hkv,Dh]
    write_idx = pos % skv
    cache_k[:, write_idx] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, write_idx] = v_new[:, 0].to(cache_v.dtype)

    groups = cfg.num_heads // cfg.num_kv_heads
    qh = q[:, 0].reshape(b, cfg.num_kv_heads, groups, cfg.head_dim)
    qs = (qh * weak(cfg.head_dim ** -0.5, qh.dtype)).to(cache_k.dtype)
    s = torch.einsum("bhgd,bshd->bhgs", qs.float(), cache_k.float())
    k_pos = torch.arange(skv, device=x.device)
    # slots beyond the number of tokens written so far are invalid; a
    # full ring (pos + 1 >= skv) is entirely valid and entirely in-window
    valid = k_pos < min(pos + 1, skv)
    if cfg.sliding_window and skv > cfg.sliding_window:
        valid &= k_pos > pos - cfg.sliding_window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(cache_v.dtype).float(),
                       cache_v.float())
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return dense(params.wo, out), cache_k, cache_v


def attention_cross_decode(params: Attention, cfg: ModelConfig, x,
                           memory_kv, pos: int):
    """Decode-time cross attention against the static encoder memory.
    Unlike :func:`attention_decode`, q·scale and the softmax weights stay
    float32 (the reference rounds neither to bf16 here)."""
    k, v = memory_kv
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(params, cfg, x, positions, rope=False)
    groups = cfg.num_heads // cfg.num_kv_heads
    qh = q[:, 0].reshape(b, cfg.num_kv_heads, groups, cfg.head_dim)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.float() * cfg.head_dim ** -0.5,
                     k.float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    out = out.reshape(b, 1, cfg.num_heads * cfg.head_dim).to(x.dtype)
    return dense(params.wo, out)
