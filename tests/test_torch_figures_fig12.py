"""Figs. 12/13 through the port == through the JAX package, at 3 VMs x
1,500 requests, resize 500, promotion 250: ETICA-Full, ETICA-NPE and
ECI-Cache. Per-VM stats and allocation histories exact, the means,
contended latencies, hit ratios and the summary ratios equal as floats,
the printed rows equal (``test_torch_figures.py`` has the JAX side).
The streamed form (every controller on one ``make_store`` store of
shards of 4,096) gives the same values."""
from __future__ import annotations

import functools

from test_torch_figures import figures, jax_fig12, strip_seconds


@functools.lru_cache(maxsize=None)
def _want():
    return jax_fig12(**figures().SMOKE["fig12"])


def test_fig12_port_equals_jax():
    f = figures()
    got = strip_seconds(f.fig12("cpu", **f.SMOKE["fig12"]))
    want = _want()
    for name in f.FIG12_CONTROLLERS:
        assert got["runs"][name] == want["runs"][name], name
        assert got["means"][name] == want["means"][name], name
    assert got["summary"] == want["summary"]
    assert got["rows"] == want["rows"]
    assert got == want


def test_fig12_streamed_port_equals_jax():
    f = figures()
    got = strip_seconds(f.fig12("cpu", streamed=True, **f.SMOKE["fig12"]))
    assert got == _want()
