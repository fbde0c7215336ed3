"""Gradient compression for the data-parallel all-reduce (the port of
:mod:`repro.optim.compress`): int8 row-wise quantization with error
feedback. Gradients are quantized to int8 (per-row absmax scale), and
the quantization residual is carried in an error buffer and added to
the next step's gradient, which keeps convergence unbiased in
expectation (the EF-SGD argument). ``torch.round`` rounds half to even,
as ``jnp.round`` does, so both packages give the same bits.

The reference's ``compressed_psum`` (the int8 all-reduce over a data
axis) waits for the model meshes (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Row-wise (leading-axis) absmax int8 quantization: ``(q, scale)``,
    ``q`` int8 of ``x``'s shape, ``scale`` float32 ``[rows, 1]``."""
    xf = x.float()
    flat = xf.reshape(x.shape[0] if x.dim() > 1 else 1, -1)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = q.reshape(shape[0] if len(shape) > 1 else 1, -1)
    return (flat.float() * scale).reshape(shape)


def ef_compress_update(grads: dict, error_buf: dict):
    """Error feedback: ``({name: quantized-dequantized g}, {name: new
    error})``, the first in each gradient's dtype, the second float32."""
    out, err = {}, {}
    for n, g in grads.items():
        corrected = g.float() + error_buf[n]
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale, corrected.shape)
        out[n], err[n] = deq.to(g.dtype), corrected - deq
    return out, err


def init_error_buf(grads: dict) -> dict:
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}
