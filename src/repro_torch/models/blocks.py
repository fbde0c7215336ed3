"""Pre-norm residual blocks and superlayers, over a whole sequence
(training and prefill, under autograd when the parameters need
gradients) and one token at a time (decode); the port of
:mod:`repro.models.blocks`.

A *superlayer* is one period of the config's layer pattern: a single
attention block for the dense and MoE families, one SSM block for the
SSM family, and for the hybrid seven SSM blocks and one attention block
with MoE on every second. The reference stacks every superlayer's
parameters on a leading axis and scans them; here each superlayer is an
``nn.ModuleDict`` of blocks and the model loops over them.
"""
from __future__ import annotations

import torch

from . import attention as attn
from . import moe as moe_lib
from . import ssm as ssm_lib
from .config import BlockSpec, ModelConfig
from .layers import init_mlp, mlp, param, rmsnorm


class Block(torch.nn.Module):
    """``norm1`` + ``mixer`` (attention or SSM); with ``cross``,
    ``norm_x`` + ``cross`` attention (the enc-dec decoder); where the
    spec has an FFN, ``norm2`` + ``ffn`` (a dense MLP or a MoE)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec, generator=None,
                 device=None, cross: bool = False):
        super().__init__()
        self.norm1 = param((cfg.d_model,), None, generator, device)
        if spec.kind == "attn":
            self.mixer = attn.init_attention(cfg, generator, device)
        else:
            self.mixer = ssm_lib.init_ssm(cfg, generator, device)
        if cross:
            self.norm_x = param((cfg.d_model,), None, generator, device)
            self.cross = attn.init_attention(cfg, generator, device,
                                             cross=True)
        if spec.has_mlp:
            self.norm2 = param((cfg.d_model,), None, generator, device)
            if spec.moe:
                self.ffn = moe_lib.init_moe(cfg, generator, device)
            else:
                self.ffn = init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                    generator, device)


def init_block(cfg: ModelConfig, spec: BlockSpec, generator=None,
               device=None, cross: bool = False) -> Block:
    return Block(cfg, spec, generator, device, cross)


def _ffn_apply(p: Block, cfg: ModelConfig, spec: BlockSpec, x):
    if not spec.has_mlp:
        return x, 0.0
    h = rmsnorm(p.norm2, x, cfg.norm_eps)
    if spec.moe:
        y, aux = moe_lib.moe_mlp(p.ffn, cfg, h)
    else:
        y, aux = mlp(p.ffn, h, cfg.mlp_act), 0.0
    return x + y, aux


def block_train(p: Block, cfg: ModelConfig, spec: BlockSpec, x, positions,
                collect_cache: bool, memory_kv=None, causal: bool = True):
    """The block over a whole prompt (``causal=False``: the encoder).
    Returns (x, aux_loss, cache_entry_or_None)."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    cache = None
    if spec.kind == "attn":
        if causal:
            y, k, v = attn.attention_train(p.mixer, cfg, h, positions)
            if collect_cache:
                cache = {"k": k, "v": v}
        else:
            y = attn.attention_encoder(p.mixer, cfg, h, positions)
    elif collect_cache:
        y, cache = ssm_lib.ssm_train(p.mixer, cfg, h, return_state=True)
    else:
        y = ssm_lib.ssm_train(p.mixer, cfg, h)
    x = x + y
    if memory_kv is not None:
        hx = rmsnorm(p.norm_x, x, cfg.norm_eps)
        x = x + attn.attention_cross(p.cross, cfg, hx, memory_kv, positions)
    x, aux = _ffn_apply(p, cfg, spec, x)
    return x, aux, cache


def block_decode(p: Block, cfg: ModelConfig, spec: BlockSpec, x, cache, pos,
                 memory_kv=None):
    """Returns (x, cache_entry): an attention entry's K/V updated in
    place, an SSM entry's state as new tensors."""
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if spec.kind == "attn":
        y, k, v = attn.attention_decode(p.mixer, cfg, h, cache["k"],
                                        cache["v"], pos)
        new_cache = {"k": k, "v": v}
    else:
        y, new_cache = ssm_lib.ssm_decode(p.mixer, cfg, h, cache)
    x = x + y
    if memory_kv is not None:
        hx = rmsnorm(p.norm_x, x, cfg.norm_eps)
        x = x + attn.attention_cross_decode(p.cross, cfg, hx, memory_kv, pos)
    x, _ = _ffn_apply(p, cfg, spec, x)
    return x, new_cache


# ---------------------------------------------------------------------------
# superlayers (one pattern period)
# ---------------------------------------------------------------------------

def init_superlayer(cfg: ModelConfig, generator=None, device=None,
                    cross: bool = False):
    return torch.nn.ModuleDict({
        f"block{i}": init_block(cfg, spec, generator, device, cross)
        for i, spec in enumerate(cfg.layer_pattern())})


def superlayer_train(params, cfg: ModelConfig, x, positions,
                     collect_cache: bool = False, memory_kv=None,
                     causal: bool = True):
    aux_total = 0.0
    caches = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        x, aux, cache = block_train(params[f"block{i}"], cfg, spec, x,
                                    positions, collect_cache,
                                    memory_kv=memory_kv, causal=causal)
        aux_total = aux_total + aux
        if collect_cache and cache is not None:
            caches[f"block{i}"] = cache
    return x, aux_total, caches


def superlayer_decode(params, cfg: ModelConfig, x, cache, pos,
                      memory_kv=None):
    new_cache = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        x, new_cache[f"block{i}"] = block_decode(
            params[f"block{i}"], cfg, spec, x, cache[f"block{i}"], pos,
            memory_kv=memory_kv)
    return x, new_cache


def init_superlayer_cache(cfg: ModelConfig, batch: int, cache_len: int,
                          dtype=torch.bfloat16, device=None):
    """Zero cache for one superlayer: K/V in ``dtype`` for attention
    blocks, the SSM state in float32 (as the reference) for SSM
    blocks."""
    out = {}
    for i, spec in enumerate(cfg.layer_pattern()):
        if spec.kind == "attn":
            shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
            out[f"block{i}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
        else:
            out[f"block{i}"] = ssm_lib.init_ssm_cache(cfg, batch,
                                                      device=device)
    return out
