"""Gradient compression for the data-parallel all-reduce (the port of
:mod:`repro.optim.compress`): int8 row-wise quantization with error
feedback. Gradients are quantized to int8 (per-row absmax scale), and
the quantization residual is carried in an error buffer and added to
the next step's gradient, which keeps convergence unbiased in
expectation (the EF-SGD argument). ``torch.round`` rounds half to even,
as ``jnp.round`` does, so both packages give the same bits.

:func:`compressed_psum` is the int8 all-reduce over the data axes of a
:class:`~repro_torch.launch.mesh.ModelMesh` whose devices may repeat (a
mesh of replicas on one card). NCCL refuses two ranks on one card, so
the reduction is no collective: each replica's codes and scales are
copied to its group's first device and summed there in mesh order, the
order of XLA:CPU's ``psum`` (the int32 sum is exact either way), and the
result is copied back to every replica's device.
"""
from __future__ import annotations

import itertools
import math

import torch


def _scalar(c: float, device) -> torch.Tensor:
    """``c`` as a 0-d float32 tensor on ``device``: a divisor that CUDA
    divides by, where a Python number would be turned into a multiply by
    its rounded reciprocal (one bit off the CPU's division)."""
    return torch.full((), c, dtype=torch.float32, device=device)


def quantize_int8(x: torch.Tensor):
    """Row-wise (leading-axis) absmax int8 quantization: ``(q, scale)``,
    ``q`` int8 of ``x``'s shape, ``scale`` float32 ``[rows, 1]``."""
    xf = x.float()
    flat = xf.reshape(x.shape[0] if x.dim() > 1 else 1, -1)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) \
        / _scalar(127.0, flat.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape):
    flat = q.reshape(shape[0] if len(shape) > 1 else 1, -1)
    return (flat.float() * scale).reshape(shape)


def compressed_psum(grads: list, mesh, axis_names=("data",)) -> list:
    """All-reduce gradients with int8 compression: the port of
    ``repro.optim.compress.compressed_psum``.

    ``grads`` holds one ``{name: tensor}`` dict per device of ``mesh``,
    in mesh order (row-major over ``mesh.axis_names``), each on its
    device. Every tensor is quantized by :func:`quantize_int8`; within
    each group of devices that differ only along ``axis_names``, the
    int32 codes and the float32 scales are summed, and every member gets
    ``total * (scale_sum / n / n)`` (``n`` the group's size: the mean of
    the dequantized replicas under one shared mean scale) in the
    gradient's dtype on its own device. Returns the dicts in the same
    order."""
    shape = mesh.shape
    if len(grads) != mesh.size:
        raise ValueError(f"{len(grads)} gradient dicts for a mesh of "
                         f"{mesh.size} devices")
    for a in axis_names:
        if a not in shape:
            raise ValueError(f"axis {a!r} is not one of {mesh.axis_names}")
    n = math.prod(shape[a] for a in axis_names)
    # each device's coordinates; a group shares those off axis_names
    coords = itertools.product(*(range(shape[a]) for a in mesh.axis_names))
    keep = [i for i, a in enumerate(mesh.axis_names) if a not in axis_names]
    groups: dict = {}
    for r, c in enumerate(coords):
        groups.setdefault(tuple(c[i] for i in keep), []).append(r)
    out = [dict() for _ in grads]
    for members in groups.values():
        for name, x in grads[members[0]].items():
            home, total, scale_sum = x.device, None, None
            for r in members:
                q, scale = quantize_int8(grads[r][name])
                q, scale = q.to(home, torch.int32), scale.to(home)
                total = q if total is None else total + q
                scale_sum = scale if scale_sum is None else scale_sum + scale
            rows = x.shape[0] if x.dim() > 1 else 1
            nn = _scalar(n, home)
            res = (total.float().reshape(rows, -1) * (scale_sum / nn / nn)
                   ).reshape(x.shape).to(x.dtype)
            for r in members:
                out[r][name] = res.to(grads[r][name].device, copy=True)
    return out


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
