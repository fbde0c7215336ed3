"""Port parity: VM-axis sharding, the counterpart of tests/test_sharding.py.

The port's mesh is an ordered tuple of devices, one a shard, and a device
may repeat, so these tests run real 1-, 2- and 4-way splits on the CPU
(``VMMesh((torch.device("cpu"),) * d)``). Covered:

  * every sharded dispatch (both datapaths, both resizes, fused
    maintenance with the cleaner, POD / TRD distances, the sizing
    metrics) is bit-identical to the JAX package's single-device batched
    function on the same seeded inputs;
  * per-VM work is shard-local: perturbing one shard's inputs leaves
    every other shard's outputs unchanged (the JAX test's HLO
    no-collective assertion has no counterpart here);
  * ``aggregate_stats_sharded``, the one cross-shard reduction, equals
    the JAX package's ``psum(jnp.sum(x, 0))`` bit for bit, float32
    ``latency_sum`` included — at 4 shards against the reference run
    under ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in a
    subprocess;
  * both controllers with a ragged VM count (padded with dead VMs to a
    multiple of the mesh size) equal the JAX package's unsharded runs,
    and streamed per-shard blocks carry ``-1`` dead rows while the
    maintenance sees the real VMs only;
  * the mesh helpers and the controllers' configurations raise the
    reference's ``ValueError``\\ s.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry, interleave as jinterleave
from repro.core import make_centaur as jcentaur, make_eci_cache as jeci
from repro.core import popularity as jpop
from repro.core import reuse as jreuse
from repro.core import simulator as jsim
from repro.core.policies import Policy as JPolicy
from repro.core.trace import split_by_vm as jsplit
from repro.kernels.maintenance import ops as jmaint
from repro.kernels.reuse_distance import ops as jkernel_ops
from repro.launch.mesh import make_vm_mesh as jmake_vm_mesh
from repro.traces import make as jmake
from repro.traces.stream import StreamWindow as JStreamWindow

from repro_torch.core import (EticaCache, EticaConfig, Geometry, Policy,
                              Stats, gather_rows, interleave, shard_rows,
                              split_by_vm)
from repro_torch.core import baselines as tbase
from repro_torch.core import popularity as tpop
from repro_torch.core import reuse as treuse
from repro_torch.core import simulator as tsim
from repro_torch.core.controller import (PartitionedSingleLevelCache,
                                         SingleLevelConfig)
from repro_torch.kernels.maintenance import ops as tmaint
from repro_torch.launch import (VMMesh, device_row_blocks, make_vm_mesh,
                                require_vm_divisible)
from repro_torch.traces import StreamingTraceSource, StreamWindow
from repro_torch.traces.generators import make

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SHARDS = (1, 2, 4)
V = 8                                  # divisible by every shard count
S, W = 4, 4                            # small geometry, all sets exercised


def _mesh(d: int) -> VMMesh:
    return VMMesh((CPU,) * d)


def _requests(seed, n=96, pad_frac=0.15, addr_space=24):
    rng = np.random.default_rng(seed)
    addr = rng.integers(0, addr_space, (V, n)).astype(np.int32)
    addr[rng.random((V, n)) < pad_frac] = -1     # no-op pads mid-stream
    return addr, rng.random((V, n)) < 0.4


def _ragged(seed, num=V, hi=160, addr_space=50):
    rng = np.random.default_rng(seed)
    addrs = [rng.integers(0, addr_space, size=int(rng.integers(0, hi)))
             .astype(np.int32) for _ in range(num)]
    addrs[1] = np.empty(0, np.int32)             # an idle VM
    return addrs, [rng.random(a.shape[0]) < 0.4 for a in addrs]


def _leaves(x):
    if isinstance(x, tuple):
        return [leaf for f in x for leaf in _leaves(f)]
    return [x]


def _assert_equal(jout, tout, msg=""):
    """A JAX output tree against a port one (sharded entries gathered),
    leaf by leaf, float32 bit for bit."""
    tout = tuple(gather_rows(x) if isinstance(x, list) else x for x in tout)
    jl, tl = _leaves(tuple(jout)), _leaves(tout)
    assert len(jl) == len(tl), msg
    for i, (a, b) in enumerate(zip(jl, tl)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (msg, i)
        a = np.ascontiguousarray(np.broadcast_to(a, b.shape))
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (msg, i)


def _warm_states(mode="full"):
    """DRAM and SSD states after one unsharded block (numpy leaves)."""
    addr, is_write = _requests(4)
    out = jsim.simulate_two_level_batch(
        addr, is_write, jsim.make_cache_batch(V, S, W),
        jsim.make_cache_batch(V, S, W), np.full(V, 2, np.int32),
        np.full(V, 3, np.int32), mode=mode)
    return [tuple(np.asarray(x) for x in st) for st in out[:2]]


def _jstate(st):
    return jsim.CacheState(*(jnp.asarray(x) for x in st))


def _tstate(st):
    return tsim.CacheState(*(torch.from_numpy(x.copy()) for x in st))


# ---------------------------------------------------------------------------
# datapath and resize dispatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", SHARDS)
def test_two_level_sharded_matches_jax(d):
    addr, is_write = _requests(seed=1)
    rng = np.random.default_rng(11)
    wd = rng.integers(0, W + 1, V).astype(np.int32)
    ws = rng.integers(0, W + 1, V).astype(np.int32)
    t0 = rng.integers(0, 9, V).astype(np.int32)
    dram, ssd = _warm_states()
    for mode in ("full", "npe"):
        ref = jsim.simulate_two_level_batch(addr, is_write, _jstate(dram),
                                            _jstate(ssd), wd, ws, mode=mode,
                                            t0=t0)
        got = tsim.simulate_two_level_sharded(
            addr, is_write, _tstate(dram), _tstate(ssd), wd, ws, _mesh(d),
            mode=mode, t0=torch.from_numpy(t0))
        assert all(len(x) == d for x in got)
        _assert_equal(ref, got, f"two-level {mode}")


@pytest.mark.parametrize("d", SHARDS)
def test_single_level_sharded_matches_jax(d):
    addr, is_write = _requests(seed=2)
    rng = np.random.default_rng(12)
    ways = rng.integers(0, W + 1, V).astype(np.int32)
    t0 = rng.integers(0, 9, V).astype(np.int32)
    names = list(Policy.__members__)
    picks = [names[v % len(names)] for v in range(V)]
    _, ssd = _warm_states()
    ref = jsim.simulate_single_level_batch(
        addr, is_write, _jstate(ssd), ways,
        jsim.policy_flags([JPolicy[p] for p in picks]), t0=t0)
    got = tsim.simulate_single_level_sharded(
        addr, is_write, _tstate(ssd), ways,
        tsim.policy_flags([Policy[p] for p in picks], "cpu"), _mesh(d),
        t0=t0)
    _assert_equal(ref, got, "single-level heterogeneous policies")


@pytest.mark.parametrize("d", SHARDS)
def test_resize_sharded_matches_jax(d):
    dram, ssd = _warm_states()
    rng = np.random.default_rng(14)
    wd, ws, nd, ns = (rng.integers(0, W + 1, V).astype(np.int32)
                      for _ in range(4))
    _assert_equal(
        jsim.resize_levels(_jstate(dram), _jstate(ssd), wd, nd, ws, ns),
        tsim.resize_levels_sharded(_tstate(dram), _tstate(ssd), wd, nd, ws,
                                   ns, _mesh(d)), "resize_levels")
    _assert_equal(jsim.resize_batch(_jstate(ssd), ws, ns),
                  tsim.resize_batch_sharded(_tstate(ssd), ws, ns, _mesh(d)),
                  "resize_batch")


# ---------------------------------------------------------------------------
# the stats aggregation: the one reduction across shards
# ---------------------------------------------------------------------------

AGG_V = 160                             # 40 rows a shard at 4 shards


def _agg_stats() -> dict:
    """Seeded per-VM stats (numpy), large enough that a shard's float32
    sum leaves XLA:CPU's in-order window of 32."""
    rng = np.random.default_rng(5)
    return {f: (rng.random(AGG_V).astype(np.float32) * 0.37
                if f == "latency_sum"
                else rng.integers(0, 5000, AGG_V).astype(np.int32))
            for f in Stats._fields}


def _port_total(d):
    stats = Stats(*(torch.from_numpy(x) for x in _agg_stats().values()))
    return tsim.aggregate_stats_sharded(shard_rows(stats, _mesh(d)),
                                        _mesh(d))


def test_aggregate_stats_one_shard_matches_jax():
    """One shard: the port's total equals the JAX aggregate on this
    process's one CPU device, ``latency_sum`` bit for bit."""
    ref = jsim.aggregate_stats_sharded(
        jsim.Stats(*_agg_stats().values()), jmake_vm_mesh(1))
    got = _port_total(1)
    for name, a, b in zip(Stats._fields, ref, got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes(), name


def test_aggregate_stats_four_shards_match_jax_psum(tmp_path):
    """Four shards: the reference's psum over four forced CPU devices
    (a subprocess, so the placeholder devices exist before jax starts)
    equals the port's four-shard total, each leaf bit for bit."""
    inp, out = tmp_path / "stats.npz", tmp_path / "agg.npz"
    np.savez(inp, *_agg_stats().values())
    code = textwrap.dedent(f"""
        import numpy as np
        from repro.core import simulator as sim
        from repro.launch.mesh import make_vm_mesh
        leaves = np.load({str(inp)!r})
        stats = sim.Stats(*[leaves[f"arr_{{i}}"] for i in range(13)])
        total = sim.aggregate_stats_sharded(stats, make_vm_mesh(4))
        np.savez({str(out)!r}, *[np.asarray(x) for x in total])
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    ref = np.load(out)
    got = _port_total(4)
    for i, name in enumerate(Stats._fields):
        assert ref[f"arr_{i}"].tobytes() == got[i].numpy().tobytes(), name
    # the four-way total is not the in-order sum: the order is checked
    seq = np.float32(0)
    for x in _agg_stats()["latency_sum"]:
        seq = np.float32(seq + x)
    assert ref["arr_8"] != seq


# ---------------------------------------------------------------------------
# fused maintenance
# ---------------------------------------------------------------------------

def _maintenance_inputs(seed):
    _, ssd = _warm_states("npe")       # write misses leave dirty blocks
    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(0, 48)) for _ in range(V)]
    lens[0] = 0                        # an idle VM rides along untouched
    lens[3] = max(lens[3], 1)
    addrs = [rng.integers(0, 24, n).astype(np.int32) for n in lens]
    writes = [rng.random(n) < 0.4 for n in lens]
    amat, wmat = jreuse._pad_rows(addrs, writes, list(range(V)), lens)
    ways = np.full(V, 3, np.int32)
    t = rng.integers(1, 9, V).astype(np.int32)
    return ssd, amat, wmat, np.asarray(lens, np.int32), ways, t


@pytest.mark.parametrize("d", SHARDS)
def test_maintenance_sharded_matches_jax(d):
    ssd, amat, wmat, lens, ways, t = _maintenance_inputs(16)
    kw = dict(evict_frac=0.25, decay=0.5, clean_quota=2)
    r = jreuse._decompose_vmapped(amat, wmat, policy=JPolicy.WB,
                                  sizing_reads_only=False, chunk=256)
    ref = jmaint.maintenance_interval(
        _jstate(ssd), jpop.table_init(V, 64), r.dist, r.served, amat, lens,
        ways, t, interpret=True, **kw)
    dist, served, _ = treuse.decompose(torch.from_numpy(amat),
                                       torch.from_numpy(wmat), Policy.WB,
                                       sizing_reads_only=False)
    got = tmaint.maintenance_interval(
        _tstate(ssd), tpop.table_init(V, 64, device="cpu"), dist, served,
        torch.from_numpy(amat), torch.from_numpy(lens),
        torch.from_numpy(ways), torch.from_numpy(t), mesh=_mesh(d), **kw)
    assert sum(np.asarray(ref[7])) > 0          # the cleaner flushed
    _assert_equal(ref, got, "fused maintenance")


def _bump_first_shard(x, per):
    """Shard 0's real addresses moved, its pads (``-1``, fresh cold
    writes at ``2**30`` and up) kept."""
    y = x.copy()
    real = (y[:per] >= 0) & (y[:per] < 2**30)
    y[:per] = np.where(real, (y[:per] + 5) % 24, y[:per])
    return y


def test_sharded_dispatches_are_shard_local():
    """Perturb shard 0's inputs: shards 1 to 3 of every output stay as
    they were (each shard's work reads its own rows only)."""
    mesh, per = _mesh(4), V // 4
    addr, is_write = _requests(seed=3)
    ssd0, amat, wmat, lens, ways, t = _maintenance_inputs(17)
    dram, ssd = _warm_states()
    flags = tsim.policy_flags([Policy.WB] * V, "cpu")
    runs = []
    for a, am in ((addr, amat), (_bump_first_shard(addr, per),
                                 _bump_first_shard(amat, per))):
        two = tsim.simulate_two_level_sharded(a, is_write, _tstate(dram),
                                              _tstate(ssd), ways, ways, mesh)
        one = tsim.simulate_single_level_sharded(a, is_write, _tstate(ssd),
                                                 ways, flags, mesh)
        dist, served, _ = treuse.decompose(
            torch.from_numpy(am), torch.from_numpy(wmat), Policy.WB,
            sizing_reads_only=False)
        maint = tmaint.maintenance_interval(
            _tstate(ssd0), tpop.table_init(V, 64, device="cpu"), dist,
            served, torch.from_numpy(am), torch.from_numpy(lens),
            torch.from_numpy(ways), torch.from_numpy(t), evict_frac=0.25,
            decay=0.5, clean_quota=2, mesh=mesh)
        runs.append([*two, *one, *maint])
    changed = []
    for x, y in zip(*runs):
        for i in range(4):
            same = all(torch.equal(p, q)
                       for p, q in zip(_leaves(x[i]), _leaves(y[i])))
            assert same or i == 0
            changed.append(not same)
    assert any(changed)                 # shard 0 did see the change


# ---------------------------------------------------------------------------
# sizing and POD / TRD distances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", SHARDS)
def test_sizing_sharded_matches_jax_and_kernel_route(d):
    addrs, writes = _ragged(seed=7)
    grid = np.array([1, 4, 16, 64], np.int32)
    for kind in treuse.SIZING_KINDS:
        ref = jreuse.sizing_metrics_batch(addrs, writes, kind, grid)
        got = treuse.sizing_metrics_batch(addrs, writes, kind, grid,
                                          mesh=_mesh(d))
        for x, y in zip(ref, got):
            assert np.array_equal(x, y), kind
    for kind in ("urd", "wss"):        # the JAX kernel-backed twin
        ref = jkernel_ops.sizing_metrics_batch(addrs, writes, kind, grid)
        got = treuse.sizing_metrics_batch(addrs, writes, kind, grid,
                                          mesh=_mesh(d))
        for x, y in zip(ref, got):
            assert np.array_equal(x, y), f"kernel {kind}"


@pytest.mark.parametrize("d", SHARDS)
def test_pod_and_trd_distances_sharded_match_jax(d):
    addrs, writes = _ragged(seed=8)
    cases = [(jreuse.pod_distances_batch(addrs, writes, jp),
              treuse.pod_distances_batch(addrs, writes, tp, mesh=_mesh(d)))
             for jp, tp in ((JPolicy.WB, Policy.WB), (JPolicy.RO, Policy.RO),
                            (JPolicy.WBWO, Policy.WBWO))]
    cases.append((jreuse.trd_distances_batch(addrs, writes),
                  treuse.trd_distances_batch(addrs, writes, mesh=_mesh(d))))
    for ref, got in cases:
        for x, y in zip(ref, got):
            assert (x is None) == (y is None)
            if x is not None:
                for f in ("dist", "served", "touch"):
                    assert np.array_equal(np.asarray(getattr(x, f)),
                                          np.asarray(getattr(y, f))), f


def test_device_row_blocks_and_shard_rows():
    mesh = VMMesh((CPU,) * 4)
    blocks = device_row_blocks(V, mesh)
    assert [b[1] for b in blocks] == [slice(2 * i, 2 * i + 2)
                                      for i in range(4)]
    assert [b[0] for b in blocks] == list(mesh.devices)
    state = tsim.make_cache_batch(V, S, W, "cpu")
    shards = shard_rows(state, mesh)
    assert len(shards) == 4 and shards[0].tags.shape == (2, S, W)
    base = state.tags.untyped_storage().data_ptr()
    assert all(s.tags.untyped_storage().data_ptr() != base for s in shards)
    for a, b in zip(gather_rows(shards), state):
        assert torch.equal(a, b)
    assert mesh.axis_names == ("vm",) and mesh.size == 4


# ---------------------------------------------------------------------------
# controllers: sharded run == the JAX package's unsharded run, ragged V
# ---------------------------------------------------------------------------

RAGGED_V = 5                           # 6 rows at 2 shards, 8 at 4
NAMES = ["hm_1", "usr_0", "web_3", "proj_0", "src2_0"]
REQS = 600
ETICA_KW = dict(dram_capacity=60, ssd_capacity=120, resize_interval=1500,
                promo_interval=500, mode="full", clean_quota=2)


def _traces():
    args = [(n, REQS, i, i * 10_000_000) for i, n in enumerate(NAMES)]
    return (jinterleave([jmake(n, r, seed=s, addr_offset=o, scale=0.25)
                         for n, r, s, o in args], seed=0),
            interleave([make(n, r, seed=s, addr_offset=o, scale=0.25)
                        for n, r, s, o in args], seed=0))


@functools.lru_cache(maxsize=None)
def _jax_etica():
    jcfg = JConfig(geometry_dram=JGeometry(8, 16), geometry_ssd=JGeometry(
        8, 16), **ETICA_KW)
    cache = JCache(jcfg, RAGGED_V)
    res = cache.run(_traces()[0])
    return res, cache.logs_ssd, [np.asarray(x) for x in cache.ssd]


def _assert_results(ref, got):
    assert len(ref) == len(got)
    for v, (a, b) in enumerate(zip(ref, got)):
        assert a.stats == b.stats, v
        assert np.array_equal(a.alloc_history, b.alloc_history), v


@pytest.mark.parametrize("d", (2, 4))
def test_etica_controller_sharded_ragged_v(d):
    ref, logs, ssd = _jax_etica()
    cfg = EticaConfig(geometry_dram=Geometry(8, 16),
                      geometry_ssd=Geometry(8, 16), mesh=_mesh(d),
                      **ETICA_KW)
    cache = EticaCache(cfg, RAGGED_V, device="cpu")
    assert cache._rows % d == 0 and cache._rows > RAGGED_V
    _assert_results(ref, cache.run(_traces()[1]))
    assert sum(r.stats["flushes"] for r in ref) > 0
    for a, b in zip(logs, cache.logs_ssd):
        assert np.array_equal(a.demands, b.demands)
        assert np.array_equal(a.alloc, b.alloc)
    whole = gather_rows(cache.ssd)
    for a, b in zip(ssd, whole):
        assert np.array_equal(a, b[:RAGGED_V].numpy())
    assert (whole.tags[RAGGED_V:] == -1).all()      # dead rows stay empty
    for v in (0, RAGGED_V - 1):
        for a, b in zip(cache.vm_ssd(v), whole):
            assert torch.equal(a, b[v])


@pytest.mark.parametrize("factory", ["eci", "centaur"])
def test_single_level_controller_sharded_ragged_v(factory):
    jtrace, ttrace = _traces()
    jf, tf = {"eci": (jeci, tbase.make_eci_cache),
              "centaur": (jcentaur, tbase.make_centaur)}[factory]
    jc = jf(120, RAGGED_V, geometry=JGeometry(8, 16), resize_interval=1500)
    ref = jc.run(jtrace)
    c = tf(120, RAGGED_V, geometry=Geometry(8, 16), resize_interval=1500,
           device="cpu")
    sharded = PartitionedSingleLevelCache(
        dataclasses.replace(c.cfg, mesh=_mesh(4)), RAGGED_V, c.metric,
        c.policy_fn, device="cpu")
    _assert_results(ref, sharded.run(ttrace))
    for a, b in zip(jc.logs, sharded.logs):
        assert np.array_equal(a.demands, b.demands) and a.policies == \
            b.policies


def test_load_state_pads_and_shards():
    """A sharded controller continued from an unsharded one's state gives
    the unsharded run's results."""
    _, ttrace = _traces()
    cfg = EticaConfig(geometry_dram=Geometry(8, 16),
                      geometry_ssd=Geometry(8, 16), **ETICA_KW)
    first = EticaCache(cfg, RAGGED_V, device="cpu")
    first.run(ttrace[:1500])
    state = dict(dram=[x.numpy() for x in first.dram],
                 ssd=[x.numpy() for x in first.ssd],
                 pop_table=[x.numpy() for x in first.pop_table],
                 ways_dram=first.ways_dram, ways_ssd=first.ways_ssd,
                 t=first.t.numpy().copy(),
                 stats=[dict(x) for x in first.stats])
    ref = first.run(ttrace[1500:])
    sharded = EticaCache(dataclasses.replace(cfg, mesh=_mesh(4)), RAGGED_V,
                         device="cpu")
    sharded.load_state(**state)
    _assert_results(ref, sharded.run(ttrace[1500:]))


# ---------------------------------------------------------------------------
# streamed per-shard feeding
# ---------------------------------------------------------------------------

def test_stream_blocks_sharded_placement_and_values():
    jtrace, ttrace = _traces()
    jsubs = jsplit(jtrace[:900], 3)
    subs = split_by_vm(ttrace[:900], 3)
    mesh = _mesh(4)
    ref = list(JStreamWindow(0, jsubs, chunk=64, prefetch_depth=0,
                             pad_vms=1).blocks())
    got = list(StreamWindow(0, subs, chunk=64, prefetch_depth=2,
                            pad_vms=1, sharding=mesh).blocks())
    assert len(got) == len(ref) > 0
    for (a, w, lens, kth), (ra, rw, rkth) in zip(got, ref):
        assert len(a) == len(w) == len(lens) == 4
        assert all(x.shape == (1, 64) and x.device == CPU for x in a)
        assert np.array_equal(gather_rows(a).numpy(), np.asarray(ra))
        assert np.array_equal(gather_rows(w).numpy(), np.asarray(rw))
        assert (gather_rows(a)[3:] == -1).all()      # the dead-VM row
        assert gather_rows(lens).tolist() == [
            0 if c is None else len(c) for c in kth] + [0]
        assert len(kth) == len(rkth) == 3            # real VMs only


def test_streaming_source_sharded_depths_bit_identical():
    _, ttrace = _traces()
    outs = []
    for depth in (0, 1, 3):
        src = StreamingTraceSource(ttrace, num_vms=5, window=1000, chunk=128,
                                   prefetch_depth=depth, pad_vms=3,
                                   sharding=_mesh(4))
        outs.append([(gather_rows(a), gather_rows(w))
                     for win in src.windows() for a, w, _, _ in win.blocks()])
    for blocks in outs[1:]:
        assert len(blocks) == len(outs[0])
        for (a, w), (ra, rw) in zip(blocks, outs[0]):
            assert torch.equal(a, ra) and torch.equal(w, rw)


# ---------------------------------------------------------------------------
# descriptive errors
# ---------------------------------------------------------------------------

def test_mesh_helper_errors():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="devices"):
        make_vm_mesh(have + 1)          # never a CPU fallback
    if not have:
        with pytest.raises(ValueError, match="devices"):
            make_vm_mesh()
    with pytest.raises(ValueError, match="divisible"):
        require_vm_divisible(5, _mesh(4))
    with pytest.raises(ValueError, match="divisible"):
        device_row_blocks(5, _mesh(2))
    with pytest.raises(ValueError, match="device"):
        VMMesh(())
    with pytest.raises(ValueError, match="CUDA or all"):
        VMMesh((CPU, torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="entries"):
        tsim.resize_batch_sharded([tsim.make_cache_batch(2, S, W, "cpu")],
                                  0, 0, _mesh(2))


def test_controller_mesh_config_errors():
    mesh = _mesh(2)
    cfg = EticaConfig(dram_capacity=60, ssd_capacity=120, mesh=mesh)
    with pytest.raises(ValueError, match="batched"):
        EticaCache(dataclasses.replace(cfg, batched=False), 2, device="cpu")
    with pytest.raises(ValueError, match="fused_maintenance"):
        EticaCache(dataclasses.replace(cfg, fused_maintenance=False), 2,
                   device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        EticaCache(dataclasses.replace(cfg, classifier=object()), 2,
                   device="cpu")
    with pytest.raises(TypeError, match="VMMesh"):
        EticaCache(dataclasses.replace(cfg, mesh=jmake_vm_mesh(1)), 2,
                   device="cpu")
    with pytest.raises(ValueError, match="controller's device"):
        EticaCache(dataclasses.replace(
            cfg, mesh=VMMesh((torch.device("cuda", 0),) * 2)), 2,
            device="cpu")
    metric = tbase.urd_metric(Geometry())
    with pytest.raises(ValueError, match="batched"):
        PartitionedSingleLevelCache(
            SingleLevelConfig(capacity=60, mesh=mesh, batched=False), 2,
            metric, tbase.eci_policy(), device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        PartitionedSingleLevelCache(
            SingleLevelConfig(capacity=60, mesh=mesh, classifier=object()),
            2, metric, tbase.eci_policy(), device="cpu")
