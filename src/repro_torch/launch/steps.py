"""Step functions (the port of :mod:`repro.launch.steps`): the train
step, and the prefill and decode steps (greedy next tokens by
``argmax``).

The reference's abstract input specs (``input_specs``,
``abstract_params``, ...) are its dry-run machinery and wait with
``dryrun.py`` (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import upload
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.optim import OptConfig, apply_updates


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
