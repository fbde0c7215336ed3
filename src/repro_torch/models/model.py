"""The dense causal LM for serving: prefill, then one token at a time
(the port of :mod:`repro.models.model`, dense family).

  * :func:`init_params`     — the model (an ``nn.Module``) with weights
    drawn from a ``torch.Generator`` on the given device.
  * :func:`params_from_jax` — the model from the JAX package's parameter
    pytree (as numpy arrays), so both packages compute from one weight
    set.
  * :func:`prefill`         — run the prompt; returns (last-position
    logits, cache).
  * :func:`decode_step`     — one token against the cache.
  * :func:`init_cache`      — a zero cache.

Batch dict: ``{"tokens": [B, S] int}``. The cache mirrors the
reference's pytree: ``{"layers": {"block0": {"k": [R, B, L, Hkv, Dh],
"v": ...}}}`` in bfloat16, R superlayers; prefill fills it layer by
layer and decode updates it in place.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import resolve_device

from . import blocks
from .config import ModelConfig
from .layers import embed, param, rmsnorm, unembed


class Model(torch.nn.Module):
    """``embed`` / ``unembed`` tables ``[V, D]``, ``final_norm``, and the
    superlayers ``layers[r]["block<i>"]``. Parameters are float32 and
    need no gradient (inference only)."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                "(ROADMAP Queue 1 item 10); the port serves dense models")
        d = cfg.d_model
        # d^-0.5 keeps unembed logits O(1) at init
        self.embed = param((cfg.vocab_size, d), d ** -0.5, generator, device)
        self.unembed = param((cfg.vocab_size, d), d ** -0.5, generator,
                             device)
        self.final_norm = param((d,), None, generator, device)
        self.layers = torch.nn.ModuleList(
            blocks.init_superlayer(cfg, generator, device)
            for _ in range(cfg.num_superlayers))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Model:
    """The model with truncated-normal weights from ``generator``, which
    must live on ``device`` (``torch.Generator(device=...)``)."""
    return Model(cfg, generator, resolve_device(device))


def params_from_jax(tree, cfg: ModelConfig, device="cuda") -> Model:
    """The model holding the JAX package's parameters. ``tree`` is its
    pytree (``repro.models.model.init_params``) with numpy leaves; each
    stacked ``[R, ...]`` superlayer leaf is unstacked into the modules
    of superlayer ``r``. Dense weights keep their ``[d_in, d_out]``
    layout."""
    model = Model(cfg, None, resolve_device(device))
    for name, p in model.named_parameters():
        keys, r = name.split("."), None
        if keys[0] == "layers":
            r, keys = int(keys[1]), ["layers"] + keys[2:]
        node = tree
        for k in keys:
            node = node[k]
        (leaf,) = node.values()            # {"w"}, {"scale"} or {"table"}
        a = np.asarray(leaf, np.float32)
        p.copy_(torch.from_numpy(a if r is None else a[r]))
    return model


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def _embed_inputs(params: Model, cfg: ModelConfig, batch):
    """Token embedding and positions (the text-only branch; the loss
    mask and labels come with training)."""
    tokens = batch["tokens"]
    x = embed(params.embed, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device=None):
    """Zero cache: each superlayer's entries stacked on a leading axis."""
    one = blocks.init_superlayer_cache(cfg, batch, cache_len, dtype, device)
    reps = cfg.num_superlayers
    return {"layers": {name: {kv: a.new_zeros((reps,) + a.shape)
                              for kv, a in entry.items()}
                       for name, entry in one.items()}}


def _scan_train(params: Model, cfg: ModelConfig, x, positions,
                cache=None, cache_len: int = 0):
    """The superlayers in order over the whole prompt; with ``cache``,
    superlayer r's K/V are fitted to ``cache_len`` and written into
    slot r as it goes (the stacked pytree the reference's scan
    returns, without holding every layer's unpadded copy)."""
    for r, layer in enumerate(params.layers):
        x, _, caches = blocks.superlayer_train(
            layer, cfg, x, positions, collect_cache=cache is not None)
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
    x = _scan_train(params, cfg, x, positions, cache, cache_len)
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
    for r, layer in enumerate(params.layers):
        entry = {name: {kv: a[r] for kv, a in e.items()}
                 for name, e in cache["layers"].items()}
        x, _ = blocks.superlayer_decode(layer, cfg, x, entry, pos)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    return unembed(params.unembed, x), cache
