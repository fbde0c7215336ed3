"""Pre-norm residual blocks and superlayers, prefill and decode (the
port of :mod:`repro.models.blocks`, attention blocks only).

A *superlayer* is one period of the config's layer pattern; for the
dense family that is a single attention block (``block0``). The
reference stacks every superlayer's parameters on a leading axis and
scans them; here each superlayer is an ``nn.ModuleDict`` of blocks and
the model loops over them.
"""
from __future__ import annotations

import torch

from . import attention as attn
from .config import BlockSpec, ModelConfig
from .layers import init_mlp, mlp, param, rmsnorm

# where the block kinds the port does not run yet are queued
_QUEUED = ("MoE, SSM and hybrid blocks are not ported yet (ROADMAP "
           "Queue 1 item 10)")


class Block(torch.nn.Module):
    """``norm1`` + attention ``mixer``; ``norm2`` + dense ``ffn``."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, generator=None,
                 device=None):
        super().__init__()
        if spec.kind != "attn" or spec.moe or not spec.has_mlp:
            raise NotImplementedError(f"{spec}: {_QUEUED}")
        self.norm1 = param((cfg.d_model,), None, generator, device)
        self.mixer = attn.init_attention(cfg, generator, device)
        self.norm2 = param((cfg.d_model,), None, generator, device)
        self.ffn = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_act, generator,
                            device)


def init_block(cfg: ModelConfig, spec: BlockSpec, generator=None,
               device=None) -> Block:
    return Block(cfg, spec, generator, device)


def _ffn_apply(p: Block, cfg: ModelConfig, x):
    h = rmsnorm(p.norm2, x, cfg.norm_eps)
    return x + mlp(p.ffn, h, cfg.mlp_act), 0.0


def block_train(p: Block, cfg: ModelConfig, spec: BlockSpec, x, positions,
                collect_cache: bool):
    """Causal block over the whole prompt. Returns (x, aux_loss,
    cache_entry_or_None)."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    y, k, v = attn.attention_train(p.mixer, cfg, h, positions)
    cache = {"k": k, "v": v} if collect_cache else None
    x, aux = _ffn_apply(p, cfg, x + y)
    return x, aux, cache


def block_decode(p: Block, cfg: ModelConfig, spec: BlockSpec, x, cache, pos):
    """Returns (x, cache_entry); the entry's K/V are updated in place."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    y, k, v = attn.attention_decode(p.mixer, cfg, h, cache["k"], cache["v"],
                                    pos)
    x, _ = _ffn_apply(p, cfg, x + y)
    return x, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# superlayers (one pattern period)
# ---------------------------------------------------------------------------

def init_superlayer(cfg: ModelConfig, generator=None, device=None):
    return torch.nn.ModuleDict({
        f"block{i}": init_block(cfg, spec, generator, device)
        for i, spec in enumerate(cfg.layer_pattern())})


def superlayer_train(params, cfg: ModelConfig, x, positions,
                     collect_cache: bool = False):
    aux_total = 0.0
    caches = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        x, aux, cache = block_train(params[f"block{i}"], cfg, spec, x,
                                    positions, collect_cache)
        aux_total = aux_total + aux
        if collect_cache and cache is not None:
            caches[f"block{i}"] = cache
    return x, aux_total, caches


def superlayer_decode(params, cfg: ModelConfig, x, cache, pos):
    new_cache = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        x, new_cache[f"block{i}"] = block_decode(
            params[f"block{i}"], cfg, spec, x, cache[f"block{i}"], pos)
    return x, new_cache


def init_superlayer_cache(cfg: ModelConfig, batch: int, cache_len: int,
                          dtype=torch.bfloat16, device=None):
    """Zero cache for one superlayer."""
    out = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        if spec.kind != "attn":
            raise NotImplementedError(f"{spec}: {_QUEUED}")
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        out[f"block{i}"] = {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    return out
