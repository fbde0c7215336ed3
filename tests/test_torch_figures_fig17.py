"""Fig. 17 through the port == through the JAX package at the JAX
script's ``--smoke`` sizes (3 VMs x 1,500 requests, promotion intervals
100 and 500): the journal's summary scalars, the normalised latency and
SSD writes, every ``format_report`` line and the printed rows. Both
sides assert the spill round trip and the journal-to-Stats sums
(``test_torch_figures.py`` has the JAX side). The streamed form (every
run on one ``make_store`` store of shards of 4,096) gives the same
values."""
from __future__ import annotations

import functools

from test_torch_figures import figures, jax_fig17, strip_seconds


@functools.lru_cache(maxsize=None)
def _want():
    return jax_fig17(**figures().SMOKE["fig17"])


def test_fig17_port_equals_jax(tmp_path):
    f = figures()
    journal = tmp_path / "last.jsonl"
    got = strip_seconds(f.fig17("cpu", journal=journal, **f.SMOKE["fig17"]))
    want = _want()
    for run in got["runs"].values():
        run.pop("stats")
    assert got == want
    # --journal keeps the last swept run's spill, which renders the same
    from repro_torch.runtime.telemetry import format_report, load_journal
    assert format_report(load_journal(journal)) == \
        want["runs"][f.SMOKE["fig17"]["intervals"][-1]]["report"]


def test_fig17_streamed_port_equals_jax():
    f = figures()
    got = strip_seconds(f.fig17("cpu", streamed=True, **f.SMOKE["fig17"]))
    for run in got["runs"].values():
        run.pop("stats")
    assert got == _want()
