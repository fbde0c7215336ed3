"""The models (the port of :mod:`repro.models.model`): the causal LM of
every decoder family (dense, MoE, SSM, hybrid, VLM) and the
encoder-decoder, for serving (prefill, then one token at a time) and
for training.

  * :func:`init_params`     — the model (an ``nn.Module``) with weights
    drawn from a ``torch.Generator`` on the given device.
  * :func:`params_from_jax` — the model from the JAX package's parameter
    pytree (as numpy arrays), so both packages compute from one weight
    set; :func:`params_to_numpy` is its inverse; :func:`cast_params`
    casts its float32 parameters to bfloat16 (serving with bf16 weights).
  * :func:`forward_train`   — the loss over a batch (the superlayers
    checkpointed, the cross-entropy in checkpointed token chunks), for
    ``backward()``.
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
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import resolve_device

from . import blocks
from . import moe as moe_lib
from . import ssm as ssm_lib
from .attention import _project_kv
from .config import BlockSpec, ModelConfig
from .layers import dense, embed, init_mlp, param, rmsnorm, unembed
from .sharding_hooks import constrain

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
    float32 and need no gradient until the model is switched to training
    (``requires_grad_(True)``)."""

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


@torch.no_grad()
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


@torch.no_grad()
def cast_params(model: torch.nn.Module):
    """``model`` with every float32 parameter cast to bfloat16 in place
    (the reference dry-run's ``--bf16-params`` rule: float32 leaves only;
    no buffer changes). Returns the model."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return model


def params_to_numpy(model: Model, named=None) -> dict:
    """The reference's parameter pytree (float32 numpy leaves) from the
    model: the inverse of :func:`params_from_jax`. Each superlayer's
    (and the encoder's) rows are stacked on a leading ``[R, ...]`` axis
    and each leaf sits in its ``{"w"}``, ``{"scale"}`` or ``{"table"}``
    dict, named by the module as the reference names it
    (:func:`reference_tree`). ``named`` maps parameter names to tensors
    in place of ``model``'s own (gradients, optimizer moments), giving
    their tree."""
    named = dict(model.named_parameters()) if named is None else named

    def value(names):
        a = [named[n].detach().float().cpu().numpy() for n in names]
        return np.stack(a) if _stacked(names[0]) else a[0]
    return reference_tree(model, value)


def param_shapes(model: Model, dtype=None) -> dict:
    """The reference's parameter pytree as tensors on the ``meta`` device
    (the shapes and dtypes of ``jax.eval_shape`` of its
    ``init_params``; ``dtype`` in place of the parameters' own): no data
    is read, so it works on a model built on ``meta``."""
    params = dict(model.named_parameters())

    def value(names):
        p = params[names[0]]
        rows = (len(names),) if _stacked(names[0]) else ()
        return torch.empty(rows + tuple(p.shape), dtype=dtype or p.dtype,
                           device="meta")
    return reference_tree(model, value)


def _stacked(name: str) -> bool:
    """Whether a parameter is one row of a stacked ``[R, ...]`` leaf (a
    module index in its name)."""
    return any(k.isdigit() for k in name.split("."))


def reference_tree(model: Model, value) -> dict:
    """The reference's parameter pytree over ``model``: one leaf a
    reference path, ``value(names)`` of the parameter names that stack
    into it (one a superlayer or encoder layer in row order; one name
    for an unstacked leaf), placed in its ``{"w"}``, ``{"scale"}`` or
    ``{"table"}`` dict or bare as the reference holds it
    (:func:`_leaf`). The path drops the module indices
    (``layers.3.block0.mixer.wq`` -> ``layers/block0/mixer/wq/w``)."""
    stacks: dict = {}
    for name, _ in model.named_parameters():
        keys = name.split(".")
        path = tuple(k for k in keys if not k.isdigit())
        rows = tuple(int(k) for k in keys if k.isdigit())
        owner = model.get_submodule(".".join(keys[:-1]))
        stacks.setdefault(path, (owner, {}))[1][rows] = name
    tree: dict = {}
    for path, (owner, by_rows) in stacks.items():
        a = value([by_rows[r] for r in sorted(by_rows)])
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _leaf(owner, path[-1], a)
    return tree


def _leaf(owner: torch.nn.Module, attr: str, a: np.ndarray):
    """A parameter as the reference holds it: the embedding tables under
    ``"table"``, the MoE experts' and the SSM's own arrays bare, norms'
    scales under ``"scale"``, dense weights under ``"w"``."""
    if isinstance(owner, Model) and attr in ("embed", "unembed"):
        return {"table": a}
    if (isinstance(owner, moe_lib.MoE) and attr != "router") or (
            isinstance(owner, ssm_lib.SSM)
            and attr not in ("in_proj", "out_proj")):
        return a
    return {"scale": a} if "norm" in attr else {"w": a}


# ---------------------------------------------------------------------------
# inputs and the encoder
# ---------------------------------------------------------------------------

def _embed_inputs(params: Model, cfg: ModelConfig, batch):
    """Token (and modality) embedding and positions (the loss mask and
    labels: :func:`_loss_targets`)."""
    tokens = batch["dec_tokens"] if cfg.is_encdec else batch["tokens"]
    x = embed(params.embed, tokens)
    if cfg.frontend == "vision" and "patches" in batch:
        pe = dense(params.frontend, batch["patches"].to(x.dtype))
        x = torch.cat([pe.to(x.dtype), x], 1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions


def _loss_targets(cfg: ModelConfig, batch, seq: int):
    """``(mask, labels)`` ``[B, seq]`` of the reference's
    ``_embed_inputs``: each position's next token, none after the last
    position nor at the vision patches' positions."""
    tokens = batch["dec_tokens"] if cfg.is_encdec else batch["tokens"]
    b = tokens.shape[0]
    full = torch.cat([tokens.new_zeros(b, seq - tokens.shape[1]), tokens], 1)
    labels = torch.cat([full[:, 1:], full.new_zeros(b, 1)], 1)
    mask = torch.ones(b, seq, dtype=torch.bool, device=tokens.device)
    mask[:, :seq - tokens.shape[1]] = False
    mask[:, -1] = False
    return mask, labels


def _encoder_layer(layer, cfg: ModelConfig, x, positions):
    x, _, _ = blocks.block_train(layer, cfg, _ATTN, x, positions,
                                 collect_cache=False, causal=False)
    return x


def _encode(params: Model, cfg: ModelConfig, frames):
    """Encoder stack over (stub) frame embeddings [B, S_enc, D]. Under
    autograd each layer is checkpointed (the reference's
    ``jax.checkpoint`` of its scan body): only its input is kept."""
    x = dense(params.frontend, frames) if hasattr(params, "frontend") \
        else frames
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    remat = torch.is_grad_enabled()
    for layer in params.encoder.layers:
        if remat:
            x = checkpoint(_encoder_layer, layer, cfg, x, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _encoder_layer(layer, cfg, x, positions)
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


def _superlayer(layer, cfg: ModelConfig, x, positions, mem):
    x, aux, _ = blocks.superlayer_train(layer, cfg, x, positions,
                                        memory_kv=mem)
    return x, aux


def _scan_train(params: Model, cfg: ModelConfig, x, positions,
                cache=None, cache_len: int = 0, memory_kv=None):
    """The superlayers in order over the whole prompt; returns ``(x,
    aux)``. With ``cache``, superlayer r's entries (K/V fitted to
    ``cache_len``) are written into slot r as it goes (the stacked
    pytree the reference's scan returns, without holding every layer's
    unpadded copy). Under autograd without a cache, each superlayer is
    checkpointed (the reference's ``jax.checkpoint`` of its scan body):
    only its input is kept, and the backward runs its forward again."""
    aux = 0.0
    remat = cache is None and torch.is_grad_enabled()
    for r, layer in enumerate(params.layers):
        mem = None if memory_kv is None else (memory_kv[0][r],
                                              memory_kv[1][r])
        if remat:
            # nothing in a superlayer draws random numbers
            x, a = checkpoint(_superlayer, layer, cfg, x, positions, mem,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a, caches = blocks.superlayer_train(
                layer, cfg, x, positions, collect_cache=cache is not None,
                memory_kv=mem)
            for name, entry in caches.items():
                for kv, e in _pad_kv(entry, cache_len).items():
                    cache["layers"][name][kv][r].copy_(e)
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------

def _ce_chunk(table, xc, lc, mc):
    """Summed float32 NLL of one token chunk: its logits live only here."""
    logits = constrain(unembed(table, xc), "logits")
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, lc[:, None])[:, 0]
    return torch.sum((logz - gold) * mc)


def _chunked_ce(params: Model, cfg: ModelConfig, x, labels, mask,
                chunk_tokens: int = 16_384):
    """Cross-entropy without materialising the full ``[T, V]`` logits:
    the token chunks in order, each chunk's NLL summed in float32 and
    added to the total in the reference scan's order. Under autograd
    each chunk is checkpointed, so only one chunk's logits are live in
    the backward too."""
    b, s, d = x.shape
    t = b * s
    xf, lf, mf = x.reshape(t, d), labels.reshape(t), mask.reshape(t)
    chunk = min(chunk_tokens, t)
    pad = (-t) % chunk
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad, d)])
        lf = torch.cat([lf, lf.new_zeros(pad)])
        mf = torch.cat([mf, mf.new_zeros(pad)])
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = torch.is_grad_enabled()
    for c0 in range(0, t + pad, chunk):
        part = (xf[c0:c0 + chunk], lf[c0:c0 + chunk], mf[c0:c0 + chunk])
        if remat:
            total = total + checkpoint(_ce_chunk, params.unembed, *part,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            total = total + _ce_chunk(params.unembed, *part)
    return total


def forward_train(params: Model, cfg: ModelConfig, batch,
                  aux_weight: float = 0.01, loss_chunk: int = 16_384):
    """Returns ``(loss + aux_weight * aux, {"loss", "aux", "tokens"})``,
    float32 scalars on the model's device; ``backward()`` on the first
    gives every parameter's gradient. ``batch`` holds tensors on the
    model's device."""
    x, positions = _embed_inputs(params, cfg, batch)
    mask, labels = _loss_targets(cfg, batch, x.shape[1])
    memory_kv = None
    if cfg.is_encdec:
        memory = _encode(params, cfg, batch["frames"].to(x.dtype))
        memory_kv = _prepare_memory(params, cfg, memory)
    if cfg.first_dense_ff:
        x, _, _ = blocks.block_train(params.prefix, cfg, _ATTN, x, positions,
                                     collect_cache=False)
    x, aux = _scan_train(params, cfg, x, positions, memory_kv=memory_kv)
    x = rmsnorm(params.final_norm, x, cfg.norm_eps)
    x = constrain(x, "pre_logits")
    nll_sum = _chunked_ce(params, cfg, x, labels, mask, loss_chunk)
    denom = torch.clamp(mask.sum(), min=1)
    loss = nll_sum / denom
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux,
                                     "tokens": denom.to(torch.float32)}


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
    x, _ = _scan_train(params, cfg, x, positions, cache, cache_len,
                       memory_kv)
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
