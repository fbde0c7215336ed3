"""Primitive layers: plain functions on tensors (the port of
:mod:`repro.models.layers`).

Numerics follow the JAX package: parameters are float32; ``dense`` runs
in bfloat16 with a float32 accumulation and one rounding to bfloat16;
norms, RoPE and logits are float32. Elementwise work on bfloat16 tensors
rounds after every operation, as XLA does, and a Python constant takes
the tensor's dtype first (JAX's weak typing: ``x * 0.5`` with ``x``
bfloat16 multiplies by ``bfloat16(0.5)``), see :func:`weak`.

float32 products (``unembed``, the decode scores) rely on PyTorch's
defaults on the card: ``torch.backends.cuda.matmul.allow_tf32`` is
False, so they run in full float32, never in TF32. Nothing here changes
a process-wide switch.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def weak(c: float, dtype: torch.dtype) -> float:
    """The Python constant ``c`` as JAX applies it to a ``dtype`` array:
    rounded to ``dtype`` first (a weakly typed scalar)."""
    return float(torch.tensor(c, dtype=dtype))


def truncated_normal(shape, scale: float, generator: torch.Generator,
                     device) -> torch.Tensor:
    """float32 ``scale * N(0, 1)`` truncated to [-2, 2], drawn on
    ``device`` from ``generator`` (which lives on that device)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(scale)


def param(shape, scale: float | None, generator, device) -> torch.nn.Parameter:
    """A float32 parameter: truncated normal times ``scale``, ones when
    ``scale`` is None (a norm's scale), uninitialised when ``generator``
    is None (weights loaded afterwards). It needs no gradient, as for
    serving; training switches the model with ``requires_grad_(True)``
    (:func:`repro_torch.launch.steps.make_train_step`)."""
    if scale is None:
        t = torch.ones(shape, dtype=torch.float32, device=device)
    elif generator is None:
        t = torch.empty(shape, dtype=torch.float32, device=device)
    else:
        t = truncated_normal(shape, scale, generator, device)
    return torch.nn.Parameter(t, requires_grad=False)


# -- norms -------------------------------------------------------------------

def rmsnorm(scale, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale).to(x.dtype)


def head_rmsnorm(scale, x, eps: float = 1e-5):
    """qk-norm (per-head RMS norm over head_dim), qwen3-style."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# -- dense -------------------------------------------------------------------

def matmul_bf16(a, b):
    """``a @ b`` (batched as ``torch.matmul``): bfloat16 operands, float32
    accumulation, a bfloat16 result. On the CPU a float32 product of the
    bfloat16-rounded operands (what XLA:CPU computes); on the card a
    bfloat16 cuBLAS product, whose reduction order (and, by PyTorch's
    default, reduced-precision split-K reductions) may differ from the
    CPU's by float32 rounding."""
    ab, bb = a.to(COMPUTE_DTYPE), b.to(COMPUTE_DTYPE)
    if a.device.type == "cpu":
        return (ab.float() @ bb.float()).to(COMPUTE_DTYPE)
    return ab @ bb


def dense(w, x):
    """``x @ w`` for ``w`` ``[d_in, d_out]`` (:func:`matmul_bf16`)."""
    return matmul_bf16(x, w)


def dense_f32(w, x):
    """``x @ w`` with bfloat16 operands and the float32 accumulation kept
    (the reference's einsum with ``preferred_element_type=float32`` and
    no cast after it): a float32 product of the bfloat16-rounded
    operands on both devices."""
    return x.to(COMPUTE_DTYPE).float() @ w.to(COMPUTE_DTYPE).float()


# -- embeddings --------------------------------------------------------------

def embed(table, ids):
    """Rows of the float32 table as bfloat16. Ids are in range on every
    path (JAX's ``take`` would clamp an id outside; indexing raises)."""
    return table[ids].to(COMPUTE_DTYPE)


def unembed(table, x):
    """float32 logits ``x @ table.T``."""
    return x.float() @ table.float().T


# -- rotary position embeddings ---------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None):
    """``theta ** (-2i / head_dim)`` in float32, computed on ``device``
    (no host copy, so a decode step never waits for one). The power is
    taken in float64 and rounded once, which gives XLA:CPU's float32
    values (a float32 ``pow`` is off by an ulp on some exponents), and
    the same values on the card."""
    e = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=device) / head_dim
    return torch.pow(float(np.float32(theta)), e.double()).float()


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [Dh/2]
    angles = positions[..., None].float() * freqs               # [..., S, Dh/2]
    angles = angles[..., None, :]                               # [..., S, 1, Dh/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- activations --------------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``, with no threshold (``F.softplus`` returns x
    above 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x):
    # jax.nn.silu: x * (1 / (1 + exp(-x))), each step in x's dtype
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _relu2(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    # jax.nn.gelu's default tanh approximation, step by step in x's dtype
    # (F.gelu(approximate="tanh") would round once, not per step)
    c = weak(math.sqrt(2 / math.pi), x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + weak(0.044715, x.dtype)
                                       * (x * x * x))))
    return x * cdf


def activation(name: str):
    if name == "swiglu":  # handled by the caller (gated)
        return _silu
    if name == "relu2":
        return _relu2
    if name == "gelu":
        return _gelu_tanh
    raise ValueError(name)


# -- MLPs ---------------------------------------------------------------------

class MLP(torch.nn.Module):
    """``w_up`` / ``w_down`` (and ``w_gate`` for SwiGLU), each ``[d_in,
    d_out]`` float32."""

    def __init__(self, d: int, ff: int, act: str, generator=None,
                 device=None):
        super().__init__()
        self.w_up = param((d, ff), d ** -0.5, generator, device)
        self.w_down = param((ff, d), ff ** -0.5, generator, device)
        if act == "swiglu":
            self.w_gate = param((d, ff), d ** -0.5, generator, device)


def init_mlp(d: int, ff: int, act: str, generator=None, device=None) -> MLP:
    return MLP(d, ff, act, generator, device)


def mlp(params: MLP, x, act: str):
    h = dense(params.w_up, x)
    if act == "swiglu":
        h = _silu(dense(params.w_gate, x)) * h
    else:
        h = activation(act)(h)
    return dense(params.w_down, h)
