"""Serving step functions (the port of :mod:`repro.launch.steps`'s
prefill and decode steps): greedy next tokens by ``argmax``.

The train step and the abstract input specs of the reference are its
dry-run machinery and come with training.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeSpec


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
