"""Fault tolerance & elasticity runtime (the port of
:mod:`repro.runtime.fault`).

* :class:`StragglerMonitor` — EMA/variance step-time tracker; flags steps
  whose duration z-score exceeds a threshold. On a real fleet the flag
  feeds the scheduler (re-dispatch the slow host's shard / swap in a hot
  spare); here it drives logging and the retry policy, and its decisions
  are unit-tested.
* :func:`run_with_recovery` — wraps a step thunk with bounded retries;
  on failure restores from the last committed checkpoint and replays
  (the data pipeline is pure-functional in step, so replay is exact).
* :func:`remesh` — elastic scaling: place a host state (numpy leaves)
  on the given device or devices (used with ``checkpoint.restore`` when
  the hardware changes between runs).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch._tree import named_leaves, unflatten


@dataclasses.dataclass
class StragglerMonitor:
    alpha: float = 0.1
    z_threshold: float = 3.0
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            # prime the EMA
            self.mean = dt if self.n == 1 else (
                self.mean + (dt - self.mean) / self.n)
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        z = (dt - self.mean) / max(np.sqrt(self.var), 1e-9)
        is_straggler = z > self.z_threshold
        if is_straggler:
            self.flagged.append((step, dt, z))
        else:
            # only track healthy steps so stragglers don't poison the EMA
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = ((1 - self.alpha) * self.var
                        + self.alpha * (dt - self.mean) ** 2)
        return is_straggler


class StepFailure(RuntimeError):
    pass


def run_with_recovery(step_fn: Callable, state, batch, *, max_retries: int = 2,
                      restore_fn: Callable | None = None):
    """Execute one training step with bounded retry + restore.

    ``restore_fn()`` must return a state equivalent to the last committed
    checkpoint. Deterministic data (batch is replayed as-is) keeps the
    result bit-identical to a failure-free run."""
    attempt = 0
    while True:
        try:
            return step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 — any device/step failure
            attempt += 1
            if attempt > max_retries:
                raise StepFailure(
                    f"step failed {attempt} times: {e}") from e
            if restore_fn is not None:
                state = restore_fn()


def remesh(host_state, devices):
    """Place a host (numpy) state on ``devices``: one device for every
    leaf, or a structure like ``host_state`` holding a device a leaf."""
    leaves = named_leaves(host_state)
    if isinstance(devices, (str, torch.device)):
        devs = [devices] * len(leaves)
    else:
        devs = [d for _, d in named_leaves(devices)]
    return unflatten(host_state, [torch.as_tensor(np.asarray(a)).to(d)
                                  for (_, a), d in zip(leaves, devs)])
