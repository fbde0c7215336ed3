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

Both functions are plain tensor code and give the same bits on the CPU
and on CUDA.
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
