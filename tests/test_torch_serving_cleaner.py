"""Port parity: the serving managers with the background cleaner, and a
manager state carried over from a JAX run.

The cleaner's cases of ``test_torch_serving.py``'s comparison
(``clean_quota=2`` on the churn traces of seeds 0-2: both port
controllers against both JAX controllers, exactly), and ``load_state``:
JAX runs the first half of a trace, the port takes its state (batched
with the cleaner, the host-dict oracle, and a materialized pool) and
runs the rest, and everything equals JAX's whole run.
"""
import numpy as np
import pytest

from repro.kvcache import TwoTierConfig as JConfig
from repro.kvcache import TwoTierKVManager as JManager

from repro_torch.kvcache import TwoTierConfig, TwoTierKVManager
from serving_parity import (CFG, churn_trace, compare_managers, replay,
                            snapshot)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_managers_with_cleaner_match_jax(seed):
    compare_managers(churn_trace(seed), quota=2)


def _jax_state(jm):
    state = dict(
        free=jm.free, slot_owner=jm.slot_owner, sessions=jm.sessions,
        host=jm.host,
        ring=(jm._ring.sid, jm._ring.tenant, jm._ring.write, jm._ring.n),
        tenant_quota=jm.tenant_quota, tenant_used=jm.tenant_used,
        stats=jm.stats, dirty=jm._dirty, append_seq=jm._append_seq,
        since_maint=jm._since_maint, since_resize=jm._since_resize)
    if jm.batched:
        tr = jm._trings
        state.update(tenant_rings=(tr.sid, tr.write, tr.seq, tr.count),
                     table=(np.asarray(jm._table.addr),
                            np.asarray(jm._table.val)))
    else:
        state.update(trackers=[(t._addr, t._val) for t in jm.trackers])
    if jm.cfg.materialize:
        state.update(k_pool=np.asarray(jm.k_pool),
                     v_pool=np.asarray(jm.v_pool))
    return state


@pytest.mark.parametrize("batched,quota,materialize", [
    (True, 2, False), (False, 0, False), (True, 0, True)])
def test_load_state_continues_a_jax_run(batched, quota, materialize):
    trace = churn_trace(3, n=1000)
    kw = dict(CFG, clean_quota=quota, materialize=materialize)
    jm = replay(JManager(JConfig(**kw), 3, batched=batched), trace, hi=500)
    tm = TwoTierKVManager(TwoTierConfig(**kw), 3, batched=batched,
                          device="cpu")
    tm.load_state(**_jax_state(jm))
    replay(jm, trace, lo=500)
    replay(tm, trace, lo=500)
    assert snapshot(tm) == snapshot(jm)
    if batched:
        assert np.array_equal(tm._table.val.numpy().view(np.int32),
                              np.asarray(jm._table.val).view(np.int32))
    if materialize:
        assert np.array_equal(tm.k_pool.numpy(), np.asarray(jm.k_pool))
        assert np.array_equal(tm.v_pool.numpy(), np.asarray(jm.v_pool))
