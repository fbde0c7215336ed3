"""The models for serving: prefill, then one token at a time (the port
of :mod:`repro.models.model`): the causal LM of every decoder family
(dense, MoE, SSM, hybrid, VLM) and the encoder-decoder.

  * :func:`init_params`     — the model (an ``nn.Module``) with weights
    drawn from a ``torch.Generator`` on the given device.
  * :func:`params_from_jax` — the model from the JAX package's parameter
    pytree (as numpy arrays), so both packages compute from one weight
    set.
  * :func:`prefill`         — run the prompt; returns (last-position
    logits, cache).
  * :func:`decode_step`     — one token against the cache.
  * :func:`init_cache`      — a zero cache.

Batch dicts:
  LM:      ``{"tokens": [B, S] int}``
  VLM:     ``{"tokens": [B, S_text], "patches": [B, P, D]}`` (the patch
           embeddings go first; positions run over P + S_text)
  enc-dec: ``{"frames": [B, S_enc, D], "dec_tokens": [B, S_dec]}``

The cache mirrors the reference's pytree: ``{"layers": {"block<i>":
entry}}`` with each entry stacked over the R superlayers, an attention
entry ``{"k", "v": [R, B, L, Hkv, Dh]}`` in bfloat16 and an SSM entry
``{"conv": [R, B, W-1, C], "ssd": [R, B, H, P, N]}`` in float32; the
deepseek dense first layer's ``"prefix"`` entry ``{"k", "v": [B, L,
Hkv, Dh]}``; and for enc-dec ``"memory_kv"``, the encoder memory's
cross K and V ``[R, B, S_enc, Hkv, Dh]`` each. Prefill fills it layer
by layer and decode updates it in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import resolve_device

from . import blocks
from .attention import _project_kv
from .config import BlockSpec, ModelConfig
from .layers import dense, embed, init_mlp, param, rmsnorm, unembed

_ATTN = BlockSpec(kind="attn")


class Encoder(torch.nn.Module):
    """The enc-dec encoder: ``layers`` (bidirectional attention blocks)
    and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            blocks.init_block(cfg, _ATTN, generator, device)
            for _ in range(cfg.encoder_layers))
        self.final_norm = param((cfg.d_model,), None, generator, device)


class Model(torch.nn.Module):
    """``embed`` / ``unembed`` tables ``[V, D]``, ``final_norm``, the
    superlayers ``layers[r]["block<i>"]`` (with cross attention for
    enc-dec); where the config has them, the dense first block
    ``prefix`` (deepseek), the ``encoder`` and the modality
    ``frontend`` ``[D, D]`` (vision and audio stubs). Parameters are
    float32 and need no gradient (inference only)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        # d^-0.5 keeps unembed logits O(1) at init
        self.embed = param((cfg.vocab_size, d), d ** -0.5, generator, device)
        self.unembed = param((cfg.vocab_size, d), d ** -0.5, generator,
                             device)
        self.final_norm = param((d,), None, generator, device)
        self.layers = torch.nn.ModuleList(
            blocks.init_superlayer(cfg, generator, device,
                                   cross=cfg.is_encdec)
            for _ in range(cfg.num_superlayers))
        if cfg.first_dense_ff:
            self.prefix = blocks.init_block(cfg, _ATTN, generator, device)
            # the wide dense FFN of deepseek's first layer
            self.prefix.ffn = init_mlp(d, cfg.first_dense_ff, cfg.mlp_act,
                                       generator, device)
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, generator, device)
        if cfg.frontend in ("vision", "audio"):
            self.frontend = param((d, d), d ** -0.5, generator, device)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Model:
    """The model with truncated-normal weights from ``generator``, which
    must live on ``device`` (``torch.Generator(device=...)``)."""
    return Model(cfg, generator, resolve_device(device))


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> Model:
    """The model holding the JAX package's parameters. ``tree`` is its
    pytree (``repro.models.model.init_params``) with numpy leaves. A
    module index in a parameter's name (``layers.3``, ``encoder.layers.3``)
    selects the row of the reference's stacked ``[R, ...]`` leaf; a
    leaf is a ``{"w"}``, ``{"scale"}`` or ``{"table"}`` dict, or an array
    itself (the MoE expert weights, the SSM's ``conv_w``, ``A_log``, ...).
    Dense weights keep their ``[d_in, d_out]`` layout."""
    model = Model(cfg, None, resolve_device(device))
    for name, p in model.named_parameters():
        node, rows = tree, []
        for k in name.split("."):
            if k.isdigit():
                rows.append(int(k))
            else:
                node = node[k]
        if isinstance(node, dict):
            (node,) = node.values()
        a = np.asarray(node, np.float32)
        for r in rows:
            a = a[r]
        p.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model


# ---------------------------------------------------------------------------
# inputs and the encoder
# ---------------------------------------------------------------------------

def _embed_inputs(params: Model, cfg: ModelConfig, batch):
    """Token (and modality) embedding and positions (the loss mask and
    labels come with training)."""
    tokens = batch["dec_tokens"] if cfg.is_encdec else batch["tokens"]
    x = embed(params.embed, tokens)
    if cfg.frontend == "vision" and "patches" in batch:
        pe = dense(params.frontend, batch["patches"].to(x.dtype))
        x = torch.cat([pe.to(x.dtype), x], 1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions


def _encode(params: Model, cfg: ModelConfig, frames):
    """Encoder stack over (stub) frame embeddings [B, S_enc, D]."""
    x = dense(params.frontend, frames) if hasattr(params, "frontend") \
        else frames
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for layer in params.encoder.layers:
        x, _, _ = blocks.block_train(layer, cfg, _ATTN, x, positions,
                                     collect_cache=False, causal=False)
    return rmsnorm(params.encoder.final_norm, x, cfg.norm_eps)


def _prepare_memory(params: Model, cfg: ModelConfig, memory):
    """Each superlayer's cross K and V of the encoder memory, projected
    once: ``(k, v)``, each ``[R, B, S_enc, Hkv, Dh]``."""
    pos = torch.arange(memory.shape[1], device=memory.device)[None, :]
    kv = [_project_kv(layer["block0"].cross, cfg, memory, pos, rope=False)
          for layer in params.layers]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None, enc_len: int = 0):
    """Zero cache: each superlayer's entries stacked on a leading axis
    (K/V in ``dtype``, SSM state float32), the prefix's entry, and the
    enc-dec memory of ``enc_len`` positions."""
    one = blocks.init_superlayer_cache(cfg, batch, cache_len, dtype, device)
    reps = cfg.num_superlayers
    cache = {"layers": {name: {kv: a.new_zeros((reps,) + a.shape)
                               for kv, a in entry.items()}
                        for name, entry in one.items()}}
    if cfg.first_dense_ff:
        cache["prefix"] = blocks.init_superlayer_cache(
            cfg, batch, cache_len, dtype, device)["block0"]
    if cfg.is_encdec:
        shape = (reps, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        cache["memory_kv"] = tuple(torch.zeros(shape, dtype=dtype,
                                               device=device)
                                   for _ in range(2))
    return cache


def _scan_train(params: Model, cfg: ModelConfig, x, positions,
                cache=None, cache_len: int = 0, memory_kv=None):
    """The superlayers in order over the whole prompt; with ``cache``,
    superlayer r's entries (K/V fitted to ``cache_len``) are written
    into slot r as it goes (the stacked pytree the reference's scan
    returns, without holding every layer's unpadded copy)."""
    for r, layer in enumerate(params.layers):
        mem = None if memory_kv is None else (memory_kv[0][r],
                                              memory_kv[1][r])
        x, _, caches = blocks.superlayer_train(
            layer, cfg, x, positions, collect_cache=cache is not None,
            memory_kv=mem)
        for name, entry in caches.items():
            for kv, a in _pad_kv(entry, cache_len).items():
                cache["layers"][name][kv][r].copy_(a)
    return x


def prefill(params: Model, cfg: ModelConfig, batch,
            cache_len: int | None = None):
    """Run the full prompt; returns (last-position logits [B, 1, V]
    float32, cache)."""
    x, positions = _embed_inputs(params, cfg, batch)
    cache_len = cache_len or x.shape[1]
    cache = init_cache(cfg, x.shape[0], cache_len, device=x.device)
    memory_kv = None
    if cfg.is_encdec:
        memory = _encode(params, cfg, batch["frames"].to(x.dtype))
        memory_kv = cache["memory_kv"] = _prepare_memory(params, cfg, memory)
    if cfg.first_dense_ff:
        x, _, pcache = blocks.block_train(params.prefix, cfg, _ATTN, x,
                                          positions, collect_cache=True)
        cache["prefix"] = _pad_kv(pcache, cache_len)
    x = _scan_train(params, cfg, x, positions, cache, cache_len, memory_kv)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.unembed, x[:, -1:]), cache


def _fit_kv_seq(a, cache_len: int, axis: int):
    """Pad K/V to cache_len, or — for sliding-window ring caches shorter
    than the prompt — keep the trailing window, rolled so each position
    p sits at slot p % cache_len (future ring writes then overwrite the
    oldest entry; stored K carries absolute RoPE so slot order is free).
    """
    s = a.shape[axis]
    pad = cache_len - s
    if pad >= 0:
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    tail = a.narrow(axis, s - cache_len, cache_len)
    return torch.roll(tail, shifts=s % cache_len, dims=axis)


def _pad_kv(entry, cache_len: int):
    return {name: (_fit_kv_seq(a, cache_len, axis=1)
                   if name in ("k", "v") else a)
            for name, a in entry.items()}


def decode_step(params: Model, cfg: ModelConfig, tokens, cache, pos: int):
    """tokens: [B, 1] int; pos: the next position (a Python int).

    Returns (logits [B, 1, V] float32, cache), the cache updated in
    place."""
    x = embed(params.embed, tokens)
    memory_kv = cache.get("memory_kv")
    if cfg.first_dense_ff:
        x, _ = blocks.block_decode(params.prefix, cfg, _ATTN, x,
                                   cache["prefix"], pos)
    for r, layer in enumerate(params.layers):
        entry = {name: {kv: a[r] for kv, a in e.items()}
                 for name, e in cache["layers"].items()}
        mem = None if memory_kv is None else (memory_kv[0][r],
                                              memory_kv[1][r])
        x, new = blocks.superlayer_decode(layer, cfg, x, entry, pos,
                                          memory_kv=mem)
        for name, e in new.items():
            for kv, a in e.items():
                if a is not entry[name][kv]:        # SSM state: new tensors
                    cache["layers"][name][kv][r].copy_(a)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.unembed, x), cache
