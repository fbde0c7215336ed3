"""Trace generators, the on-disk trace store and the controllers'
window source.

The names below are those of :mod:`repro.traces`. Each is imported from
its module on first use, so importing the package builds no kernel.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "generators": ("SCAN_HEAVY_MIX", "SPECS", "WorkloadSpec", "generate",
                   "generate_to_store", "make", "make_store", "names",
                   "SESSION_NEW", "SESSION_ACTIVATE", "SESSION_APPEND",
                   "SESSION_END", "SessionSpec", "SessionTrace",
                   "generate_sessions"),
    "store": ("TraceStore", "parse_blktrace", "parse_msr_csv"),
    "stream": ("StreamingTraceSource", "StreamWindow", "window_source"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [name for names in _EXPORTS.values() for name in names]


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
