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
  same way. :func:`sum_f32` follows that tree; ``torch.sum`` does not.

All are plain tensor code and give the same bits on the CPU and on
CUDA.
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


def exp_xla_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` bit-identical to XLA:CPU's, subnormals flushed."""
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


def sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The 0-d float32 sum of a 1-D tensor, bit-identical to XLA:CPU's
    ``jnp.sum``: in order up to 32 elements; above that, windows of 32
    over the input padded by ``p = -n % 32`` zeros (``p // 2`` in
    front), each window in order, and the window sums reduced again."""
    x = x.float().reshape(-1)
    while x.numel() > _WINDOW:
        p = -x.numel() % _WINDOW
        x = torch.nn.functional.pad(x, (p // 2, p - p // 2))
        x = _in_order(x.view(-1, _WINDOW))
    return _in_order(x.view(1, -1))[0]


def _in_order(rows: torch.Tensor) -> torch.Tensor:
    """Each row of a 2-D float32 tensor summed left to right from 0."""
    acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=rows.device)
    for j in range(rows.shape[1]):
        acc = acc + rows[:, j]
    return acc
