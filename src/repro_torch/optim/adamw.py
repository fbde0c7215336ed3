"""AdamW with warmup+cosine schedule and global-norm clipping (the port
of :mod:`repro.optim.adamw`).

``params`` and gradients are ``{name: tensor}`` dicts keyed by
``named_parameters()``; ``opt_state`` is ``{"m": {...}, "v": {...},
"step": int32 scalar tensor}`` with the moments in ``moment_dtype``
(bf16 moments are one of the memory levers for the large configs). The
arithmetic is the reference's, in float32, operation for operation.
Unlike the reference, which returns new arrays, :func:`apply_updates`
writes the new parameters and moments into the given tensors (the
model's own parameters, so nothing is copied back): a caller that keeps
an earlier state copies it first.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"     # "float32" | "bfloat16"


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32 on its
    device: linear warmup, then cosine decay to ``min_lr_ratio``."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    dt = _dtype(cfg.moment_dtype)
    device = next(iter(params.values())).device
    return {
        "m": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=dt, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every tensor of ``tree``
    (a dict or a sequence), summed leaf by leaf in order."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """``({name: g * scale}, norm)``, scale = min(1, max_norm / norm);
    the scaled gradients are float32 (the reference's ``g * scale``
    promotes a bf16 ``g`` to the float32 scale's dtype)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return {n: g.float() * scale for n, g in grads.items()}, norm


@torch.no_grad()
def apply_updates(params: dict, grads: dict, opt_state: dict,
                  cfg: OptConfig):
    """One AdamW step, in place. Returns ``(params, opt_state, stats)``:
    the same parameter and moment tensors, updated; a new ``step``;
    ``stats`` ``{"grad_norm", "lr"}`` (float32 scalars on the device).
    Raises if a parameter has no gradient."""
    missing = [n for n in params if grads.get(n) is None]
    if missing:
        raise ValueError(f"parameters without a gradient: {missing}")
    step = opt_state["step"] + 1
    gnorm = global_norm([grads[n] for n in params])
    scale = _clip_scale(gnorm, cfg.grad_clip)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for n, p in params.items():
        m, v = opt_state["m"][n], opt_state["v"][n]
        gf = grads[n].float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
        delta = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}
