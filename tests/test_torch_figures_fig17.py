"""Fig. 17 through the port == through the JAX package at the JAX
script's ``--smoke`` sizes (3 VMs x 1,500 requests, promotion intervals
100 and 500): the journal's summary scalars, the normalised latency and
SSD writes, every ``format_report`` line and the printed rows. Both
sides assert the spill round trip and the journal-to-Stats sums
(``test_torch_figures.py`` has the JAX side)."""
from __future__ import annotations

from test_torch_figures import figures, jax_fig17, strip_seconds


def test_fig17_port_equals_jax(tmp_path):
    f = figures()
    journal = tmp_path / "last.jsonl"
    got = strip_seconds(f.fig17("cpu", journal=journal, **f.SMOKE["fig17"]))
    want = jax_fig17(**f.SMOKE["fig17"])
    for run in got["runs"].values():
        run.pop("stats")
    assert got == want
    # --journal keeps the last swept run's spill, which renders the same
    from repro_torch.runtime.telemetry import format_report, load_journal
    assert format_report(load_journal(journal)) == \
        want["runs"][f.SMOKE["fig17"]["intervals"][-1]]["report"]
