"""Mixture-of-Experts FFN with gather-based capacity dispatch (the port
of :mod:`repro.models.moe`).

No ``[T, E, C]`` one-hot dispatch tensor is built. The (token, choice)
pairs are sorted by expert id (a stable sort); a pair's slot is its rank
among its expert's pairs, and pairs at a slot past the capacity are
dropped (their gate mass falls to the shared experts and the residual).
Dispatch gathers ``x`` into an ``[E, C, D]`` buffer, the experts run as
batched products, and the combine adds each token's kept pairs back.

Numerics follow the reference bit for bit where it fixes them: the
router's softmax uses XLA:CPU's float32 ``exp`` and sums
(:mod:`repro_torch._xla_math`), and its gradient is
``jax.nn.softmax``'s own rule, ``y * (g - sum(y * g))`` (no gradient
flows through the max it subtracts); top-k takes the lower expert id
first on ties (the first k of a stable descending sort, as
``lax.top_k``); the combine adds a token's k contributions in bfloat16,
one rounding per add, in the order of the stable expert sort, as the
reference's scatter-add does. The combine gathers through the inverse
permutation instead of scattering, so it uses no atomics and gives the
same bits on every run. Returns the Switch-style load-balancing loss
beside the output.

Gradients are the reference's: the gate values' gradient flows through
the sort's values to the chosen probabilities (``lax.top_k``'s), the
expert ids and the load-balancing density carry none (the reference's
``one_hot`` of integer ids), and the dispatch and combine gathers
differentiate to scatter-adds.
"""
from __future__ import annotations

import torch

from repro_torch._xla_math import exp_xla_f32, sum_rows_f32

from .config import ModelConfig
from .layers import activation, init_mlp, matmul_bf16, mlp, param


class MoE(torch.nn.Module):
    """``router`` ``[D, E]``; ``w_up`` / ``w_gate`` ``[E, D, F]`` and
    ``w_down`` ``[E, F, D]`` (``w_gate`` for SwiGLU only), float32; the
    ``shared`` experts as one MLP of width ``F * num_shared``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        e, d = cfg.moe_num_experts, cfg.d_model
        ff = cfg.moe_d_ff or cfg.d_ff
        self.router = param((d, e), d ** -0.5, generator, device)
        self.w_up = param((e, d, ff), d ** -0.5, generator, device)
        self.w_down = param((e, ff, d), ff ** -0.5, generator, device)
        if cfg.mlp_act == "swiglu":
            self.w_gate = param((e, d, ff), d ** -0.5, generator, device)
        if cfg.moe_num_shared:
            self.shared = init_mlp(d, ff * cfg.moe_num_shared, cfg.mlp_act,
                                   generator, device)


def init_moe(cfg: ModelConfig, generator=None, device=None) -> MoE:
    return MoE(cfg, generator, device)


def _expert_ffn(p: MoE, xe, act: str):
    """xe: [E, C, D] -> [E, C, D], each expert's MLP as one batched
    product per weight (bfloat16 operands, float32 accumulation, a
    bfloat16 result, as the reference's einsums)."""
    up = matmul_bf16(xe, p.w_up)
    if act == "swiglu":
        up = activation("swiglu")(matmul_bf16(xe, p.w_gate)) * up
    else:
        up = activation(act)(up)
    return matmul_bf16(up, p.w_down)


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert holds for ``t`` tokens: GShard-style for large
    ``t`` (the float floor division of the reference kept), and room for
    every token up to 256, so that decode and short prompts drop
    nothing."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    return int(max((t * k * cfg.moe_capacity_factor) // e, min(t, 256), 1))


class _Softmax(torch.autograd.Function):
    """The router's softmax over the last axis of ``[T, E]`` float32
    logits (XLA:CPU's ``exp`` and sums), with the gradient of
    ``jax.nn.softmax``'s custom JVP: ``t - y * sum(t)``, ``t = y * g``."""

    @staticmethod
    def forward(ctx, logits):
        z = exp_xla_f32(logits - logits.amax(-1, keepdim=True))
        probs = z / sum_rows_f32(z)[:, None]
        ctx.save_for_backward(probs)
        return probs

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        t = y * g
        return t - y * sum_rows_f32(t)[:, None]


def route(p: MoE, cfg: ModelConfig, xf):
    """Router of ``xf`` [T, D]: (probs [T, E] float32, gate values [T, k]
    normalised to sum 1, expert ids [T, k] int64)."""
    k = cfg.moe_top_k
    probs = _Softmax.apply(xf.float() @ p.router.float())
    # lax.top_k: the k largest, the lower index first on ties
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(sum_rows_f32(gate)[:, None], min=1e-9)
    return probs, gate, idx


def _expert_counts(ids, e: int):
    """int64 ``[e]``: how many of ``ids`` name each expert (a
    ``bincount`` of fixed length, so its shape does not depend on the
    data and the ``meta`` device can trace it)."""
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


def dispatch(cfg: ModelConfig, idx, cap: int):
    """The (token, choice) pairs sorted by expert: ``order`` (pair ids
    in stable expert order), ``e_sorted``, ``tok_sorted``, each pair's
    ``slot`` among its expert's pairs and ``keep = slot < cap``; and
    ``disp`` [E, C], the token in each expert slot (``T``, a zero row,
    where none). Pairs past the capacity write nowhere, as the
    reference's ``mode="drop"`` scatter."""
    t, k = idx.shape
    e = cfg.moe_num_experts
    e_flat = idx.reshape(-1)
    tok_flat = torch.arange(t, device=idx.device).repeat_interleave(k)
    order = torch.sort(e_flat, stable=True).indices
    e_sorted, tok_sorted = e_flat[order], tok_flat[order]
    counts = _expert_counts(e_flat, e)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(t * k, device=idx.device) - starts[e_sorted]
    keep = slot < cap
    # one spare column takes the dropped pairs' writes and is cut off
    disp = torch.full((e, cap + 1), t, dtype=torch.int64, device=idx.device)
    disp[e_sorted, torch.clamp(slot, max=cap)] = tok_sorted
    return order, e_sorted, tok_sorted, slot, keep, disp[:, :cap]


def combine(cfg: ModelConfig, ye, gate, order, e_sorted, slot, keep):
    """[T, D]: each token's kept pairs, ``ye[e, slot] * gate``, added in
    bf16 in the stable expert order (the reference's scatter-add order),
    gathered through the inverse permutation: no atomics."""
    t, k = gate.shape
    cap = ye.shape[1]
    val = ye[e_sorted, torch.clamp(slot, max=cap - 1)]
    val = torch.where(keep[:, None], val, val.new_zeros(()))
    contrib = val * gate.reshape(-1)[order].to(val.dtype)[:, None]
    where = torch.empty_like(order)
    where[order] = torch.arange(t * k, device=order.device)
    where = torch.sort(where.view(t, k), dim=1).values         # [T, k]
    out = torch.zeros(t, ye.shape[2], dtype=val.dtype, device=ye.device)
    for j in range(k):
        out = out + contrib[where[:, j]]
    return out


def moe_mlp(p: MoE, cfg: ModelConfig, x):
    """x: [B, S, D] -> (y [B, S, D] in x's dtype, aux_loss 0-d float32)."""
    b, s, d = x.shape
    e = cfg.moe_num_experts
    t = b * s
    xf = x.reshape(t, d)
    probs, gate, idx = route(p, cfg, xf)

    # Switch-style load-balance aux loss
    density = _expert_counts(idx[:, 0], e).float() / t
    aux_loss = (density * probs.mean(0)).sum() * e

    order, e_sorted, _, slot, keep, disp = dispatch(cfg, idx, capacity(cfg, t))
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    ye = _expert_ffn(p, xpad[disp], cfg.mlp_act)              # [E, C, D]
    out = combine(cfg, ye, gate, order, e_sorted, slot, keep)
    if cfg.moe_num_shared:
        out = out + mlp(p.shared, xf, cfg.mlp_act)
    return out.reshape(b, s, d).to(x.dtype), aux_loss
