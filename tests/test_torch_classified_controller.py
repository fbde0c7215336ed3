"""Port parity: both controllers with an IO classifier vs the JAX package.

``EticaCache`` with ``seq_cutoff(48)`` and with a four-class classifier
(an exclusive write slice under a WT override, a half-weight address
range, a sequential bypass) in the fused, staged and sequential modes,
with and without the cleaner; the chassis (Centaur and ECI-Cache),
batched and sequential — per-VM stats dicts, allocation histories,
interval logs, per-class counts, the journal's per-class columns and the
final states equal to the reference's, on a scan-heavy mix where the
cutoff trips. Also: a match-all classifier equals ``classifier=None``;
a ``TraceStore`` input equals the in-memory one; ``load_state`` carries
a JAX mid-run state with its classifier carry; the properties of
``tests/test_classify.py`` (bypass never allocates, way partitioning,
policy overrides) on the port; ``hit_counts_at_sizes_weighted`` against
the reference's with non-dyadic weights; and classifiers that are not
the port's raising ``TypeError``.

Run as a script, it prints the JAX package's per-VM stats and per-class
counts of ``benchmarks/classification_bench.py``'s protocol (4 VMs x
8,000 requests of ``SCAN_HEAVY_MIX``), the constants ``chip_smoke.py``
phase 14 holds the card to::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_classified_controller.py
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import repro.classify as JC  # noqa: E402
from repro.core import EticaCache as JCache  # noqa: E402
from repro.core import Geometry as JGeometry  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402

from repro_torch.core.controller import EticaCache  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from classified_parity import (MIX, _assert_same, _chassis,  # noqa: E402
                               _etica_cfgs, _mixes, _states)

BENCH_REQS = 8000          # benchmarks/classification_bench.py REQS

@pytest.mark.parametrize("quota", [0, 3])
@pytest.mark.parametrize("mode", [dict(), dict(fused_maintenance=False),
                                  dict(batched=False)],
                         ids=["fused", "staged", "sequential"])
@pytest.mark.parametrize("clf", ["seq_cutoff", "four_class"])
def test_etica_classified_equals_jax(clf, mode, quota):
    jtrace, ttrace = _mixes()
    jcfg, tcfg = _etica_cfgs(clf, clean_quota=quota, **mode)
    jc = JCache(jcfg, len(MIX))
    tc = EticaCache(tcfg, len(MIX), device="cpu")
    _assert_same(jc, jc.run(jtrace), tc, tc.run(ttrace))
    assert sum(d["bypassed"] for d in tc.stats) > 0


def test_trace_store_input_equals_in_memory(tmp_path):
    from repro_torch.traces import TraceStore
    _, ttrace = _mixes()
    store = TraceStore.from_trace(tmp_path / "mix", ttrace, shard_size=700)
    for build in (
            lambda: EticaCache(_etica_cfgs("seq_cutoff")[1], len(MIX),
                               device="cpu"),
            lambda: _chassis("torch", "make_eci_cache", "four_class")):
        mem, st = build(), build()
        rm, rs = mem.run(ttrace), st.run(TraceStore.open(tmp_path / "mix"))
        for a, b in zip(rm, rs):
            assert a.stats == b.stats
            assert np.array_equal(a.alloc_history, b.alloc_history)
        assert np.array_equal(mem.cls_hits, st.cls_hits)
        assert np.array_equal(mem._cls_end, st._cls_end)
    del store


def test_load_state_carries_a_jax_classified_run():
    """The first resize window in JAX, its state (the classifier's run
    carry and per-class counts included) carried over, the rest in both
    controllers side by side."""
    jtrace, ttrace = _mixes()
    jcfg, tcfg = _etica_cfgs("seq_cutoff")
    jc = JCache(jcfg, len(MIX))
    jc.run(jtrace[:2000])
    tc = EticaCache(tcfg, len(MIX), device="cpu")
    tc.load_state(
        dram=[np.asarray(x) for x in jc.dram],
        ssd=[np.asarray(x) for x in jc.ssd],
        pop_table=[np.asarray(x) for x in jc.pop_table],
        ways_dram=jc.ways_dram, ways_ssd=jc.ways_ssd, t=jc.t,
        stats=jc.stats, cls_carry=(jc._cls_end, jc._cls_len),
        cls_hits=jc.cls_hits, cls_miss=jc.cls_miss)
    jc.logs_dram.clear()
    jc.logs_ssd.clear()
    jres, tres = jc.run(jtrace[2000:]), tc.run(ttrace[2000:])
    for a, b in zip(jres, tres):
        assert a.stats == b.stats
    assert np.array_equal(jc.cls_hits, tc.cls_hits)
    assert np.array_equal(jc._cls_len, tc._cls_len)
    for a, b in zip(_states(jc), _states(tc)):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    # the chassis
    jch = _chassis("jax", "make_eci_cache", "four_class")
    tch = _chassis("torch", "make_eci_cache", "four_class")
    jch.run(jtrace[:2000])
    tch.load_state(caches=[np.asarray(x) for x in jch.caches],
                   ways=jch.ways, t=jch.t, stats=jch.stats,
                   cls_carry=(jch._cls_end, jch._cls_len),
                   cls_hits=jch.cls_hits, cls_miss=jch.cls_miss)
    for a, b in zip(jch.run(jtrace[2000:]), tch.run(ttrace[2000:])):
        assert a.stats == b.stats
    assert np.array_equal(jch.cls_miss, tch.cls_miss)


# ---------------------------------------------------------------------------
# the JAX package's values of benchmarks/classification_bench.py
# ---------------------------------------------------------------------------

def jax_class_bench(reqs=BENCH_REQS) -> dict:
    """``benchmarks/classification_bench.py``'s runs on the JAX package:
    Centaur (capacity 800, ``sim_chunk`` 500) and ETICA (DRAM 400 / SSD
    800, resize 2,000, promotion 500), 16 x 32, unclassified and with
    ``seq_cutoff(48)``: per-VM stats and per-class counts."""
    jtrace, _ = _mixes(reqs)
    out = {}
    for name, build in (
            ("chassis", lambda c: jbase.make_centaur(
                800, len(MIX), geometry=JGeometry(16, 32),
                resize_interval=2000, sim_chunk=500, classifier=c)),
            ("etica", lambda c: JCache(dataclasses.replace(
                _etica_cfgs("match_all")[0], classifier=c), len(MIX)))):
        for clf in (None, "seq_cutoff"):
            cache = build(None if clf is None else JC.seq_cutoff(48))
            res = cache.run(jtrace)
            key = f"{name}/{clf or 'none'}"
            out[key] = {"stats": [r.stats for r in res]}
            if clf:
                out[key]["cls_hits"] = cache.cls_hits.tolist()
                out[key]["cls_miss"] = cache.cls_miss.tolist()
    return out


if __name__ == "__main__":
    print(json.dumps(jax_class_bench(), indent=1))
