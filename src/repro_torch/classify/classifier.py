"""IO-class assignment and the class-to-sub-partition mapping the
controllers consume.

The PyTorch counterpart of :mod:`repro.classify.classifier`.
:class:`Classifier` wraps an ordered :class:`~repro_torch.classify.rules
.IOClass` list into everything the datapath needs:

* :meth:`Classifier.classify_subs` — a class id for every request of a
  window's per-VM sub-traces, by one :func:`classify_block` on the
  controller's device and one copy of the ids to the host, threading the
  per-VM sequential-run carry across windows;
* :meth:`Classifier.way_bounds` — classes with an explicit ``ways_frac``
  get exclusive way slices carved from the top of the VM's active ways
  (in class order), everything else shares the remaining common pool.
  Lookups stay global — classes partition *insertion*, not residency;
* :attr:`Classifier.bypass` / :attr:`Classifier.weights` — the ``[C]``
  bypass mask of the classified datapaths and the ``[C]`` POD-sizing
  weights.

With the single default class (:func:`match_all`) every request is class
0, the common pool is the whole allocation and nothing bypasses — the
controllers give stats identical to ``classifier=None``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import resolve_device, upload

from .rules import (ClassRule, IOClass, RulePlan, classify_block,
                    classify_ref, compile_rules)


class Classifier:
    """Ordered IO classes compiled to one vectorised rule plan.

    ``classes[0]`` is the default class (unmatched requests land there);
    later classes take priority in order. The exclusive ``ways_frac``
    reservations may sum to at most 1.
    """

    def __init__(self, classes: Sequence[IOClass]):
        classes = tuple(classes)
        if not classes:
            raise ValueError("need at least one (default) class")
        if classes[0].bypass:
            raise ValueError("the default class cannot bypass the cache")
        fracs = [c.ways_frac for c in classes if c.ways_frac is not None]
        if sum(fracs) > 1.0 + 1e-9:
            raise ValueError(f"exclusive ways_frac reservations sum to "
                             f"{sum(fracs)} > 1")
        self.classes = classes
        self.plan: RulePlan = compile_rules(classes)
        self.bypass = np.asarray([c.bypass for c in classes], bool)
        # a bypass class never caches, so it must not drive sizing either
        self.weights = np.asarray(
            [0.0 if c.bypass else c.weight for c in classes], np.float64)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def init_carry(self, num_vms: int):
        """Fresh per-VM sequential-run carry: ``(prev_end, run_len)``."""
        return (np.full(num_vms, -1, np.int32),
                np.zeros(num_vms, np.int32))

    # -- request -> class --------------------------------------------------
    def classify_subs(self, subs, carry_end, carry_len, device="cuda"):
        """Classify a window's per-VM sub-traces with one
        :func:`classify_block` on ``device`` and one copy to the host.

        ``subs`` is the window's ``list[Trace]`` (ragged); returns
        (``list[np.ndarray int32]`` class ids per VM, new carries as
        numpy int32 ``[V]``).
        """
        dev = resolve_device(device)
        v = len(subs)
        lens = np.asarray([len(s) for s in subs], np.int32)
        n = int(lens.max()) if v else 0
        amat = np.zeros((v, n), np.int32)
        wmat = np.zeros((v, n), bool)
        smat = np.zeros((v, n), np.int32)
        for i, sub in enumerate(subs):
            k = lens[i]
            amat[i, :k] = np.asarray(sub.addr, np.int32)
            wmat[i, :k] = np.asarray(sub.is_write)
            smat[i, :k] = sub.sizes()
        cls, ce, cl = classify_block(
            upload(amat, dev), upload(wmat, dev), upload(smat, dev),
            upload(lens, dev), upload(np.asarray(carry_end, np.int32), dev),
            upload(np.asarray(carry_len, np.int32), dev), self.plan, dev)
        host = torch.cat([cls, ce[:, None], cl[:, None]], dim=1).cpu().numpy()
        return ([host[i, :lens[i]] for i in range(v)],
                host[:, n].copy(), host[:, n + 1].copy())

    def classify_trace_ref(self, trace, carry_end: int = -1,
                           carry_len: int = 0):
        """Scalar oracle over one sub-trace (see :func:`classify_ref`)."""
        return classify_ref(np.asarray(trace.addr), np.asarray(trace.is_write),
                            trace.sizes(), self.plan, carry_end, carry_len)

    # -- class -> sub-partition --------------------------------------------
    def way_bounds(self, ways):
        """Per-(VM, class) insertion way ranges ``(lo, hi)``, ``[V, C]``.

        Explicit-``ways_frac`` classes get exclusive ``floor(frac * ways)``
        slices stacked from the top of the VM's active ways (class order);
        all other classes share the remaining common pool ``[0, cursor)``.
        Bypass classes get the empty range.
        """
        w = np.atleast_1d(np.asarray(ways, np.int32))
        v, c = len(w), self.num_classes
        lo = np.zeros((v, c), np.int32)
        hi = np.zeros((v, c), np.int32)
        cursor = w.copy()
        for ci, cls in enumerate(self.classes):
            if cls.ways_frac is not None:
                width = np.floor(cls.ways_frac * w).astype(np.int32)
                hi[:, ci] = cursor
                lo[:, ci] = cursor - width
                cursor = cursor - width
        for ci, cls in enumerate(self.classes):
            if cls.bypass:
                lo[:, ci] = hi[:, ci] = 0
            elif cls.ways_frac is None:
                lo[:, ci] = 0
                hi[:, ci] = cursor
        return lo, hi

    def vm_policies(self, policies) -> list:
        """``[V][C]`` write policies: class override or the VM's policy."""
        return [[c.policy if c.policy is not None else p
                 for c in self.classes] for p in policies]


# -- convenience constructors ------------------------------------------------

def match_all(name: str = "default", **attrs) -> Classifier:
    """Single default class — behaves identically to no classifier."""
    return Classifier([IOClass(name, **attrs)])


def seq_cutoff(threshold_blocks: int,
               extra: Sequence[IOClass] = ()) -> Classifier:
    """Default class + a sequential-cutoff bypass class (big-scan
    protection): requests whose sequential run reaches
    ``threshold_blocks`` go straight to disk instead of flushing the
    cache's working set — Open-CAS's ``seq_cutoff``, expressed as an
    ordinary run-length rule."""
    cutoff = IOClass("seq_bypass",
                     rules=(ClassRule(run_len=(threshold_blocks, None)),),
                     bypass=True)
    return Classifier([IOClass("default"), *extra, cutoff])
