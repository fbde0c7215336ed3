"""Pluggable internal placement constraints (the port of
:mod:`repro.models.sharding_hooks`).

Model code calls ``constrain(x, "site-name")`` at the reference's
collective-critical activations (here ``"logits"`` and
``"pre_logits"``). By default this is the identity; a launch layer that
places activations across devices registers, per site, a function that
takes the tensor and returns it placed. On one card nothing registers,
so every site is the identity.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

_local = threading.local()


def _registry() -> dict:
    if not hasattr(_local, "specs"):
        _local.specs = {}
    return _local.specs


@contextlib.contextmanager
def sharding_site_specs(specs: dict[str, Callable]):
    """Register ``{site-name: placement function}`` for the enclosed
    calls."""
    old = dict(_registry())
    _registry().update(specs)
    try:
        yield
    finally:
        _local.specs = old


def constrain(x, site: str):
    place = _registry().get(site)
    return x if place is None else place(x)
