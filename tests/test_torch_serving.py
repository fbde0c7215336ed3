"""Port parity: the two-tier KV serving managers vs ``repro.kvcache``.

On the churn traces of ``tests/test_serving_batched.py`` (its ``CFG``,
seeds 0-2) the port's batched manager and its host-dict oracle must
equal the JAX package's batched manager and its ``batched=False``
oracle exactly: Stats, slot placements, free-list order, quotas, used
counts, tier-2 keys, the dirty map, the device table's host mirror
(float32 bit for bit) and every telemetry journal row. Also
``GlobalLRUManager``. The cleaner's cases and ``load_state`` are in
``test_torch_serving_cleaner.py``.
"""
import dataclasses

import pytest

from repro.kvcache import GlobalLRUManager as JLRU
from repro.kvcache import TwoTierConfig as JConfig

from repro_torch.kvcache import (GlobalLRUManager, TwoTierConfig,
                                 TwoTierKVManager)
from serving_parity import (CFG, churn_trace, compare_managers, replay,
                            snapshot)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_managers_match_jax(seed):
    """Both port controllers against both JAX controllers."""
    compare_managers(churn_trace(seed), quota=0)


def test_global_lru_matches_jax():
    trace = churn_trace(11, n=1200, num_tenants=2, target_live=32)
    jm = replay(JLRU(JConfig(**CFG), 2), trace)
    tm = replay(GlobalLRUManager(TwoTierConfig(**CFG), 2, device="cpu"),
                trace)
    assert snapshot(tm) == snapshot(jm)
    assert tm.stats.dma_write_bytes > tm.stats.appends * tm.cfg.page_bytes


def test_bounded_rings_and_config_bytes():
    tcfg = TwoTierConfig(**CFG)
    mgr = replay(TwoTierKVManager(tcfg, 3, device="cpu"),
                 churn_trace(5))
    assert mgr._ring.sid.size == tcfg.resize_interval
    assert mgr._trings.sid.shape == (3, tcfg.resize_interval)
    for dtype in ("float32", "bfloat16"):
        assert (dataclasses.replace(tcfg, dtype=dtype).page_bytes
                == JConfig(**(CFG | dict(dtype=dtype))).page_bytes)
