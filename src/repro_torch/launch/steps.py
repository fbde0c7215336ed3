"""Step functions (the port of :mod:`repro.launch.steps`): the train
step, and the prefill and decode steps (greedy next tokens by
``argmax``), and their abstract inputs.

``input_specs(cfg, shape)`` gives every input of the step that the
shape's kind implies as tensors on the ``meta`` device: the model
(:func:`abstract_params`), its AdamW moments, the batch, or the decode
cache, tokens and position. Nothing is allocated, so the dry-run
(:mod:`repro_torch.launch.dryrun`) runs the step on them at any size.
:func:`reference_specs` lays them out as the reference's trees (the
parameters and moments stacked ``[R, ...]`` under its paths), which is
what the sharding rules read.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import upload
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim import OptConfig, apply_updates, init_opt_state

ENC_DECODE_LEN = 4_096   # encoder memory length used for decode shapes
META = torch.device("meta")


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig | None = None,
                    grad_dtype: str | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the model's loss and its ``backward()``, then one AdamW
    step, which updates the model's parameters and the moments in place
    (:func:`repro_torch.optim.apply_updates`). ``params`` is the model
    (switched to ``requires_grad_(True)``); ``opt_state`` comes from
    ``init_opt_state(dict(params.named_parameters()), opt_cfg)``; the
    batch's arrays (numpy or tensors) go to the model's device.
    ``grad_dtype="bfloat16"`` casts gradients before the optimizer — the
    cross-replica all-reduce then moves half the bytes (§Perf lever).
    Every family trains: MoE routing and the SSM's scans hold the
    reference's bits through ``_xla_math``, whose functions carry JAX's
    backward rules (:mod:`repro_torch._xla_math`)."""
    opt_cfg = opt_cfg or OptConfig()
    cast = getattr(torch, grad_dtype) if grad_dtype else None

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        dev = next(iter(named.values())).device
        batch = {k: v.to(dev) if isinstance(v, torch.Tensor)
                 else upload(v, dev) for k, v in batch.items()}
        for p in named.values():
            p.grad = None
        loss, metrics = M.forward_train(params, cfg, batch)
        loss.backward()
        grads = {n: p.grad for n, p in named.items()}
        if cast is not None:
            grads = {n: g.to(cast) for n, g in grads.items()}
        _, opt_state, stats = apply_updates(named, grads, opt_state,
                                            opt_cfg)
        for p in named.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, **stats)

    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        logits, cache = M.prefill(params, cfg, batch, cache_len=cache_len)
        next_tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tokens, cache

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, cache, tokens, pos):
        logits, cache = M.decode_step(params, cfg, tokens, cache, pos)
        next_tokens = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tokens[:, None], cache

    return serve_step


def cache_len_for(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype``: a tensor on ``meta``."""
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig) -> M.Model:
    """The model on ``meta``: every parameter's shape and dtype, no
    data."""
    return M.Model(cfg, None, META)


def abstract_opt_state(cfg: ModelConfig, params: M.Model,
                       opt_cfg: OptConfig | None = None) -> dict:
    """``init_opt_state`` of ``params`` (on ``meta``): the moments in
    ``opt_cfg``'s dtype, keyed by parameter name, and the step."""
    return init_opt_state(dict(params.named_parameters()),
                          opt_cfg or OptConfig())


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Training/prefill batch stand-ins for this (arch, shape)."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return {"frames": _sds((b, s, cfg.d_model), torch.float32),
                "dec_tokens": _sds((b, s), torch.int32)}
    if cfg.frontend == "vision":
        p = cfg.frontend_tokens
        return {"tokens": _sds((b, s - p), torch.int32),
                "patches": _sds((b, p, cfg.d_model), torch.float32)}
    return {"tokens": _sds((b, s), torch.int32)}


def decode_specs(cfg: ModelConfig, shape: ShapeSpec):
    """(cache, tokens, pos) stand-ins for the decode step."""
    b = shape.global_batch
    clen = cache_len_for(cfg, shape)
    enc_len = ENC_DECODE_LEN if cfg.is_encdec else 0
    cache = M.init_cache(cfg, b, clen, device=META, enc_len=enc_len)
    return cache, _sds((b, 1), torch.int32), _sds((), torch.int32)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                opt_cfg: OptConfig | None = None,
                bf16_params: bool = False) -> dict[str, Any]:
    """All abstract inputs for the step this shape runs; ``bf16_params``
    casts the model's float32 parameters to bfloat16
    (:func:`repro_torch.models.model.cast_params`; the moments keep
    ``opt_cfg``'s dtype)."""
    params = abstract_params(cfg)
    if bf16_params:
        M.cast_params(params)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": abstract_opt_state(cfg, params, opt_cfg),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, shape)}
    if shape.kind == "decode":
        cache, tokens, pos = decode_specs(cfg, shape)
        return {"params": params, "cache": cache, "tokens": tokens,
                "pos": pos}
    raise ValueError(shape.kind)


def reference_specs(specs: dict[str, Any]) -> dict[str, Any]:
    """:func:`input_specs` as the reference's trees: the parameters and
    the moments stacked ``[R, ...]`` under its paths
    (:func:`repro_torch.models.model.param_shapes`); the batch, cache,
    tokens and position as they are."""
    out = dict(specs)
    model = specs["params"]
    out["params"] = M.param_shapes(model)
    if "opt_state" in specs:
        opt = specs["opt_state"]
        dt = next(iter(opt["m"].values())).dtype
        moments = M.param_shapes(model, dtype=dt)
        out["opt_state"] = {"m": moments, "v": M.param_shapes(model, dt),
                            "step": _sds((), opt["step"].dtype)}
    return out
