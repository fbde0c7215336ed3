"""Vectorised IO-classification rule engine (Open-CAS io_class model).

The PyTorch counterpart of :mod:`repro.classify.rules`. A
:class:`ClassRule` is a *conjunction* of per-request conditions over the
four request fields the datapath exposes:

==============  ============================================================
``size``        request size in blocks — half-open ``(lo, hi)`` interval
``lba``         block address — half-open ``(lo, hi)`` interval
``run_len``     sequential run length in blocks *including this request*
                (a request continues a run iff its address equals the
                previous request's ``addr + size``) — half-open interval
``direction``   ``"read"`` / ``"write"`` / ``None`` (either)
==============  ============================================================

An :class:`IOClass` owns a tuple of rules — a *disjunction*: the class
matches when any of its rules matches. ``classes[0]`` is the default
class every unmatched request falls back to. When several classes match,
the first matching rule in ``(class order, rule order)`` wins.

:func:`compile_rules` flattens the rule set to a :class:`RulePlan` of
``[G]`` numpy arrays (one row per conjunction group);
:func:`classify_block` classifies a ``[V, N]`` block with one ``[V, G,
N]`` match matrix in plain torch on the tensors' device (it runs once a
resize window, outside every kernel); :func:`classify_ref` is the scalar
per-request oracle.

Sequential-run state crosses window boundaries through a per-VM carry
``(prev_end, run_len)``; ``prev_end = -1`` is the no-run sentinel (safe
because addresses are non-negative, so ``addr + size >= 1``). All run
arithmetic is int32, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

INT_MAX = np.int32(2**31 - 1)


@dataclasses.dataclass(frozen=True)
class ClassRule:
    """Conjunction of vectorised conditions; ``None`` = unconstrained.

    ``size``/``lba``/``run_len`` are half-open ``(lo, hi)`` intervals
    where either end may be ``None`` (open). ``direction`` restricts the
    request type. An all-``None`` rule matches everything.
    """
    size: tuple | None = None      # (lo, hi) request size in blocks
    lba: tuple | None = None       # (lo, hi) block address range
    run_len: tuple | None = None   # (lo, hi) sequential run length, blocks
    direction: str | None = None   # "read" | "write" | None

    def __post_init__(self):
        if self.direction not in (None, "read", "write"):
            raise ValueError(f"direction must be 'read', 'write' or None, "
                             f"got {self.direction!r}")
        for name in ("size", "lba", "run_len"):
            iv = getattr(self, name)
            if iv is None:
                continue
            lo, hi = iv
            if lo is not None and hi is not None and not lo < hi:
                raise ValueError(f"{name} interval {iv} is empty")


@dataclasses.dataclass(frozen=True)
class IOClass:
    """One IO class: a disjunction of rules plus its cache treatment.

    ``policy`` (a :class:`repro_torch.core.policies.Policy`) overrides the
    VM's write policy for this class on the single-level chassis
    (``None`` = inherit). ``ways_frac`` reserves an exclusive fraction of
    the VM's active ways for the class (``None`` = share the common
    pool). ``weight`` scales the class's contribution to POD sizing (0
    excludes it). ``bypass`` routes the class straight to disk — never
    cached, never sized, never maintained.
    """
    name: str
    rules: tuple = ()              # tuple[ClassRule, ...] (OR-ed)
    policy: object | None = None   # repro_torch.core.policies.Policy | None
    ways_frac: float | None = None
    weight: float = 1.0
    bypass: bool = False

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        if self.ways_frac is not None and not 0.0 <= self.ways_frac <= 1.0:
            raise ValueError(f"ways_frac must be in [0, 1], "
                             f"got {self.ways_frac}")
        if self.weight < 0:
            raise ValueError(f"weight must be >= 0, got {self.weight}")
        if self.bypass and self.ways_frac is not None:
            raise ValueError("a bypass class cannot reserve ways")


class RulePlan(NamedTuple):
    """Compiled rule set: one row per conjunction group, ``[G]`` each."""
    group_class: np.ndarray  # int32 — owning class id
    size_lo: np.ndarray      # int32 half-open bounds (INT_MAX-open)
    size_hi: np.ndarray
    lba_lo: np.ndarray
    lba_hi: np.ndarray
    run_lo: np.ndarray
    run_hi: np.ndarray
    dir_read: np.ndarray     # bool — rule matches reads
    dir_write: np.ndarray    # bool — rule matches writes


def compile_rules(classes: Sequence[IOClass]) -> RulePlan:
    """Flatten ``classes`` into a :class:`RulePlan`.

    Group order is (class order, rule order), so the first matching group
    is the highest-priority matching rule. A rule set with no rules at
    all compiles to one never-matching group so the plan arrays are
    never empty.
    """
    rows = []
    for ci, cls in enumerate(classes):
        for rule in cls.rules:
            lo = lambda iv: 0 if iv is None or iv[0] is None else int(iv[0])
            hi = lambda iv: (int(INT_MAX) if iv is None or iv[1] is None
                             else int(iv[1]))
            rows.append((ci, lo(rule.size), hi(rule.size),
                         lo(rule.lba), hi(rule.lba),
                         lo(rule.run_len), hi(rule.run_len),
                         rule.direction != "write",
                         rule.direction != "read"))
    if not rows:
        rows.append((0, 0, 0, 0, 0, 0, 0, False, False))
    cols = list(zip(*rows))
    return RulePlan(
        group_class=np.asarray(cols[0], np.int32),
        size_lo=np.asarray(cols[1], np.int32),
        size_hi=np.asarray(cols[2], np.int32),
        lba_lo=np.asarray(cols[3], np.int32),
        lba_hi=np.asarray(cols[4], np.int32),
        run_lo=np.asarray(cols[5], np.int32),
        run_hi=np.asarray(cols[6], np.int32),
        dir_read=np.asarray(cols[7], bool),
        dir_write=np.asarray(cols[8], bool),
    )


# ---------------------------------------------------------------------------
# vectorised engine
# ---------------------------------------------------------------------------

def _as(x, dtype, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(
            x, np.int32 if dtype == torch.int32 else bool))
    return x.to(device=device, dtype=dtype)


def _run_lengths(addr, size, n_valid, carry_end, carry_len):
    """Sequential run lengths (in blocks) of every VM's ``[N]`` row.

    A request continues the current run iff ``addr == prev_addr +
    prev_size``. Run starts come from a cummax of the run-start index
    (else the carried run): ``run_len[i] = csum[i] - csum_excl[last
    start]`` for in-window runs and ``csum[i] + carry_len`` for the
    carried one. Returns ``(run [V, N], carry_end' [V], carry_len'
    [V])``."""
    n = addr.shape[1]
    idx = torch.arange(n, dtype=torch.int32, device=addr.device)[None, :]
    valid = idx < n_valid[:, None]
    size = torch.where(valid, size, 0)
    end = addr + size                               # run-continuation key
    prev_end = torch.cat([carry_end[:, None], end[:, :-1]], dim=1)
    new_run = valid & (addr != prev_end)
    csum = torch.cumsum(size, dim=1, dtype=torch.int32)
    csum_excl = csum - size
    start = torch.where(new_run, idx, -1)
    last_start = torch.cummax(start, dim=1).values
    base = torch.where(last_start >= 0,
                       csum_excl.gather(1, last_start.clamp(min=0).long()),
                       -carry_len[:, None])
    run = torch.where(valid, csum - base, 0).to(torch.int32)
    last = (n_valid - 1).clamp(min=0).long()[:, None]
    has = n_valid > 0
    return (run,
            torch.where(has, end.gather(1, last)[:, 0], carry_end),
            torch.where(has, run.gather(1, last)[:, 0], carry_len))


def classify_block(addr, is_write, size, n_valid, carry_end, carry_len,
                   plan: RulePlan, device=None):
    """Classify a ``[V, N]`` block on ``device`` (default: ``addr``'s
    device if it is a tensor, else the CPU).

    ``addr``/``is_write``/``size`` are ``[V, N]`` (numpy or tensors;
    positions >= ``n_valid[v]`` are padding, classified 0), carries are
    ``[V]``. Returns ``(cls [V, N] int32, carry_end' [V], carry_len'
    [V])`` as int32 tensors on ``device``.
    """
    if device is None:
        device = addr.device if isinstance(addr, torch.Tensor) else "cpu"
    addr = _as(addr, torch.int32, device)
    size = _as(size, torch.int32, device)
    is_write = _as(is_write, torch.bool, device)
    n_valid = _as(n_valid, torch.int32, device)
    carry_end = _as(carry_end, torch.int32, device)
    carry_len = _as(carry_len, torch.int32, device)
    if addr.shape[1] == 0:      # empty window: carries unchanged
        return torch.zeros(addr.shape, dtype=torch.int32, device=device), \
            carry_end, carry_len
    run, ce, cl = _run_lengths(addr, size, n_valid, carry_end, carry_len)
    # [V, G, N] match matrix; the first matching group wins
    g = lambda x: torch.from_numpy(np.asarray(x)).to(device)[None, :, None]
    a, sz, rl = addr[:, None, :], size[:, None, :], run[:, None, :]
    m = ((sz >= g(plan.size_lo)) & (sz < g(plan.size_hi))
         & (a >= g(plan.lba_lo)) & (a < g(plan.lba_hi))
         & (rl >= g(plan.run_lo)) & (rl < g(plan.run_hi))
         & torch.where(is_write[:, None, :], g(plan.dir_write),
                       g(plan.dir_read)))
    matched = m.any(dim=1)
    first = m.to(torch.uint8).argmax(dim=1)
    group_class = torch.from_numpy(plan.group_class).to(device)
    cls = torch.where(matched, group_class[first], 0)
    valid = torch.arange(addr.shape[1], device=device)[None, :] \
        < n_valid[:, None]
    return torch.where(valid, cls, 0).to(torch.int32), ce, cl


# ---------------------------------------------------------------------------
# scalar reference oracle
# ---------------------------------------------------------------------------

def classify_ref(addr, is_write, size, plan: RulePlan,
                 carry_end: int = -1, carry_len: int = 0):
    """Per-request Python evaluator — the oracle :func:`classify_block`
    must match bit for bit. Returns ``(cls [N] int32, carry_end',
    carry_len')``."""
    addr = np.asarray(addr, np.int64)
    is_write = np.asarray(is_write, bool)
    size = np.asarray(size, np.int64)
    n = len(addr)
    g_cnt = len(plan.group_class)
    cls = np.zeros(n, np.int32)
    end, run = int(carry_end), int(carry_len)
    for i in range(n):
        a, s, w = int(addr[i]), int(size[i]), bool(is_write[i])
        run = run + s if a == end else s
        end = a + s
        for g in range(g_cnt):
            if not (plan.dir_write[g] if w else plan.dir_read[g]):
                continue
            if not plan.size_lo[g] <= s < plan.size_hi[g]:
                continue
            if not plan.lba_lo[g] <= a < plan.lba_hi[g]:
                continue
            if not plan.run_lo[g] <= run < plan.run_hi[g]:
                continue
            cls[i] = plan.group_class[g]
            break
    return cls, end, run
