"""float32 arithmetic that reproduces XLA:CPU bit for bit.

The JAX package runs its popularity path on XLA:CPU, whose float32
``exp`` and denormal handling differ from PyTorch's on both the CPU and
CUDA:

* ``exp``: XLA emits a Cephes-style polynomial (clamp, range reduction
  by ``n = floor(x*log2(e) + 0.5)``, a degree-6 Horner polynomial, and a
  ``2**n`` built from exponent bits). ``torch.exp`` rounds differently
  in the last bit on a few percent of inputs. :func:`exp_xla_f32`
  evaluates XLA's scheme step by step; each fused multiply-add is
  computed in float64 (the float32 product is exact there) and rounded
  once to float32, which is what the hardware FMA gives.
* subnormals: XLA:CPU flushes subnormal results to zero; PyTorch keeps
  them. :func:`ftz` flushes explicitly. A thread-wide
  ``torch.set_flush_denormal`` would leak into unrelated numpy code and
  does nothing on CUDA.
* sums: XLA:CPU rewrites a float32 reduction over more than 32 elements
  into windows of 32 (the input zero-padded, the lower half of the pad
  in front), each summed in order, then reduces the window sums the
  same way. :func:`sum_f32` (and :func:`sum_rows_f32`, row by row)
  follows that tree; ``torch.sum`` does not.
* cumulative sums: XLA:CPU rewrites ``jnp.cumsum`` over more than 16
  elements into a two-level scan (blocks of 16, each a running sum from
  its start; the block totals scanned the same way, recursively; each
  block's prefix then added). :func:`cumsum_f32` follows it;
  ``torch.cumsum`` accumulates in float64 on the CPU and in a parallel
  scan on CUDA.

All are plain tensor code and give the same bits on the CPU and on
CUDA.

Gradients: where an input requires one (and grad mode is on),
:func:`exp_xla_f32`, :func:`sum_f32`, :func:`sum_rows_f32` and
:func:`cumsum_f32` run as ``torch.autograd.Function`` classes whose
forward is the same code under ``no_grad`` (the same bits, and no
graph of its float64 steps or per-element adds) and whose backward is
JAX's rule: ``exp`` the upstream gradient times the saved output
(``jnp.exp``'s JVP: past the clamp the clamped output, and 0 wherever
the output flushed to 0, as at ``-inf``; a subnormal product flushed
too); a sum the gradient broadcast; a cumulative sum the reverse
cumulative sum of the gradient (summed as :func:`cumsum_f32` sums).
Without a gradient they are plain calls (the cache path's host cost
unchanged).

On the ``meta`` device (shapes without data: the dry-run,
:mod:`repro_torch.launch.dryrun`) the four take ``torch.exp``,
``torch.sum`` and ``torch.cumsum``: with no values there are no bits to
keep, the shapes, dtypes and FLOP counts are the same, and the traced
step skips thousands of element-wise ops a chunk of the SSM loop.
"""
from __future__ import annotations

import numpy as np
import torch

FLT_MIN = float(np.finfo(np.float32).tiny)   # smallest normal float32

_LOG2EF = 1.44269504088896341
_C1 = -0.693359375
_C2 = 2.12194440e-4
_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
      4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to (signed) zero, as XLA:CPU does."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def f32(c: float) -> float:
    """A Python float holding the float32 rounding of ``c``."""
    return float(np.float32(c))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 fused multiply-add: exact product in float64, one
    rounding to float32 at the end."""
    b = b.double() if isinstance(b, torch.Tensor) else f32(b)
    c = c.double() if isinstance(c, torch.Tensor) else f32(c)
    return (a.double() * b + c).float()


def _differentiable(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


class _Exp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _exp(x)
        ctx.save_for_backward(out)
        ctx.dtype = x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return ftz(g * out).to(ctx.dtype)


def exp_xla_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` bit-identical to XLA:CPU's, subnormals flushed;
    differentiable as ``jnp.exp``."""
    if x.device.type == "meta":
        return torch.exp(x.float())
    return _Exp.apply(x) if _differentiable(x) else _exp(x)


def _exp(x: torch.Tensor) -> torch.Tensor:
    x = x.float().clamp(f32(-88.8), f32(88.8))
    n = torch.floor(_fma(x, _LOG2EF, 0.5)).clamp(-127.0, 127.0)
    a = _fma(n, _C1, x)
    a = _fma(n, _C2, a)
    z = _fma(a, _P[0], _P[1])
    for p in _P[2:]:
        z = _fma(z, a, p)
    z = _fma(z, a * a, a) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return ftz(z * pow2)


_WINDOW = 32     # XLA:CPU's reduction window (tree reduction rewriter)


class _Sum(torch.autograd.Function):
    """A float32 reduction ``fn`` of ``x`` whose gradient is the upstream
    gradient broadcast back to ``x``'s shape."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.shape, ctx.dtype = x.shape, x.dtype
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        g = g.reshape(g.shape + (1,) * (len(ctx.shape) - g.dim()))
        return g.expand(ctx.shape).to(ctx.dtype), None


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The 0-d float32 sum of a 1-D tensor, bit-identical to XLA:CPU's
    ``jnp.sum``: in order up to 32 elements; above that, windows of 32
    over the input padded by ``p = -n % 32`` zeros (``p // 2`` in
    front), each window in order, and the window sums reduced again."""
    if x.device.type == "meta":
        return x.float().sum()
    return _Sum.apply(x, _sum) if _differentiable(x) else _sum(x)


def _sum(x: torch.Tensor) -> torch.Tensor:
    x = x.float().reshape(-1)
    while x.numel() > _WINDOW:
        p = -x.numel() % _WINDOW
        x = torch.nn.functional.pad(x, (p // 2, p - p // 2))
        x = _in_order(x.view(-1, _WINDOW))
    return _in_order(x.view(1, -1))[0]


def sum_rows_f32(x: torch.Tensor) -> torch.Tensor:
    """:func:`sum_f32` of each row of a 2-D float32 tensor (``jnp.sum(x,
    axis=-1)`` on XLA:CPU): ``[T, N]`` -> ``[T]``."""
    if x.device.type == "meta":
        return x.float().sum(-1)
    return _Sum.apply(x, _sum_rows) if _differentiable(x) else _sum_rows(x)


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    while x.shape[1] > _WINDOW:
        p = -x.shape[1] % _WINDOW
        x = torch.nn.functional.pad(x, (p // 2, p - p // 2))
        t = x.shape[0]
        x = _in_order(x.reshape(-1, _WINDOW)).view(t, -1)
    return _in_order(x)


_SCAN_BASE = 16   # XLA's reduce-window rewriter's base length


class _Cumsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.dtype = dim, x.dtype
        return _cumsum(x, dim)

    @staticmethod
    def backward(ctx, g):
        rev = _cumsum(g.flip(ctx.dim), ctx.dim).flip(ctx.dim)
        return rev.to(ctx.dtype), None


def cumsum_f32(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """float32 cumulative sum along ``dim``, bit-identical to XLA:CPU's
    ``jnp.cumsum``."""
    if x.device.type == "meta":
        return torch.cumsum(x.float(), dim)
    return _Cumsum.apply(x, dim) if _differentiable(x) else _cumsum(x, dim)


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    x = x.float().movedim(dim, -1)
    return _block_scan(x).movedim(-1, dim)


def _block_scan(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        return _running(x)
    p = -n % _SCAN_BASE
    blocks = torch.nn.functional.pad(x, (0, p)).unflatten(
        -1, (-1, _SCAN_BASE))
    inner = _running(blocks)                          # [..., nb, 16]
    totals = _block_scan(inner[..., -1])              # [..., nb]
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (inner + before[..., None]).flatten(-2)[..., :n]


def _running(x: torch.Tensor) -> torch.Tensor:
    """Running sums along the last dimension, one float32 add a step."""
    out = [x[..., 0]]
    for j in range(1, x.shape[-1]):
        out.append(out[-1] + x[..., j])
    return torch.stack(out, -1)


def _in_order(rows: torch.Tensor) -> torch.Tensor:
    """Each row of a 2-D float32 tensor summed left to right from 0."""
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
    return acc
