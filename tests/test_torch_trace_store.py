"""Port parity: the on-disk trace store and streamed ingestion.

``repro_torch.traces.store`` and the store half of
``repro_torch.traces.stream`` against ``repro.traces`` on the CPU, as
``tests/test_trace_store.py`` holds the reference:

  * exact ``Trace`` -> ``TraceStore`` -> ``Trace`` round trips (shard
    boundaries, append resume, vm-less stores, the mode guards and
    unflushed reads);
  * the MSR-Cambridge CSV and blktrace parsers equal to the JAX
    package's on the same text, the int32 range refusal included, and
    the CLI's ``import`` and ``info`` lines equal to
    ``python -m repro.traces.store``'s;
  * store files byte-identical between the two packages, each opening
    the other's store;
  * the shard-level demux equal to ``split_by_vm`` (VM ids past
    ``num_vms`` dropped) and the ``[V, chunk]`` blocks to ``pad_batch``;
  * ``EticaCache.run(store)`` and ECI-Cache's equal to the JAX
    package's ``run(store)`` and to the port's in-memory run, in every
    prefetch setting and both datapath modes.

Every test runs with warnings as errors: a read-only memory map that
reached ``torch.from_numpy`` or ``torch.as_tensor`` would warn.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro.core import EticaCache as JCache, EticaConfig as JConfig
from repro.core import Geometry as JGeometry
from repro.core import make_eci_cache as jmake_eci_cache
from repro.core.trace import Trace as JTrace
from repro.traces import StreamingTraceSource as JSource
from repro.traces import TraceStore as JStore
from repro.traces import make_store as jmake_store
from repro.traces import parse_blktrace as jparse_blktrace
from repro.traces import parse_msr_csv as jparse_msr_csv
from repro.traces.store import main as jstore_cli

from repro_torch.core import (EticaCache, EticaConfig, Geometry, Policy,
                              Stats, Trace, interleave, make_cache,
                              make_eci_cache, pad_batch,
                              simulate_single_level, split_by_vm)
from repro_torch.traces import (SPECS, StreamingTraceSource, TraceStore,
                                generate, generate_to_store, make,
                                make_store, names, parse_blktrace,
                                parse_msr_csv, window_source)
from repro_torch.traces.store import main as store_cli

pytestmark = pytest.mark.filterwarnings("error")

GEO = Geometry(num_sets=8, max_ways=16)
WORKLOADS = ("hm_1", "usr_0", "web_3")


def _mixed_trace(num_vms=3, reqs=2000, workloads=WORKLOADS):
    return interleave(
        [make(n, reqs, seed=i, addr_offset=i * 10_000_000, scale=0.25)
         for i, n in enumerate(workloads[:num_vms])], seed=0)


def _assert_trace_equal(a, b):
    assert np.array_equal(np.asarray(a.addr), np.asarray(b.addr))
    assert np.array_equal(np.asarray(a.is_write), np.asarray(b.is_write))
    for ch in ("vm", "size"):
        x, y = getattr(a, ch), getattr(b, ch)
        if x is None or y is None:
            assert x is None and y is None, ch
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), ch


def _jtrace(t: Trace) -> JTrace:
    return JTrace(np.array(t.addr), np.array(t.is_write),
                  None if t.vm is None else np.array(t.vm),
                  None if t.size is None else np.array(t.size))


# ---------------------------------------------------------------------------
# store round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard_size", [64, 700, 10_000])
def test_store_roundtrip_exact(tmp_path, shard_size):
    trace = _mixed_trace(reqs=600)
    store = TraceStore.from_trace(tmp_path / "s", trace,
                                  shard_size=shard_size)
    assert len(store) == len(trace)
    _assert_trace_equal(store.to_trace(), trace)
    ro = TraceStore.open(tmp_path / "s")
    assert len(ro) == len(trace)
    assert ro.num_vms == 3 and ro.has_vm and not ro.has_size
    assert ro.num_shards == -(-len(trace) // shard_size)
    assert ro.shard_size == shard_size
    _assert_trace_equal(ro.to_trace(), trace)
    sh = ro.shard(0)
    assert not sh.addr.flags.writeable          # a read-only mapping
    for i, win in enumerate(ro.iter_windows(257)):
        _assert_trace_equal(win, trace[i * 257: (i + 1) * 257])
    _assert_trace_equal(ro.read(5, 10 ** 9), trace[5:])  # clipped tail
    assert len(ro.read(len(trace), len(trace) + 9)) == 0


def test_store_append_resume_and_vmless(tmp_path):
    t = _mixed_trace(reqs=400)
    a, b = t[:123], t[123:]
    with TraceStore.create(tmp_path / "s", shard_size=100) as store:
        store.append(a)
    with TraceStore.open(tmp_path / "s", mode="a") as store:
        store.append(b)
    resumed = TraceStore.open(tmp_path / "s")
    _assert_trace_equal(resumed.to_trace(), t)
    assert [len(s) for s in resumed.iter_shards()] == \
        [min(100, len(t) - i) for i in range(0, len(t), 100)]

    plain = Trace(np.asarray(t.addr), np.asarray(t.is_write))
    store = TraceStore.from_trace(tmp_path / "p", plain, shard_size=64)
    assert not store.has_vm and store.num_vms is None
    _assert_trace_equal(store.to_trace(), plain)
    with pytest.raises(ValueError, match="vm-tagged"):
        with TraceStore.open(tmp_path / "p", mode="a") as w:
            w.append(t)          # mixing vm-tagged into a vm-less store


def test_store_create_and_mode_guards(tmp_path):
    TraceStore.from_trace(tmp_path / "s", _mixed_trace(reqs=50))
    with pytest.raises(FileExistsError):
        TraceStore.create(tmp_path / "s")
    with pytest.raises(ValueError, match="positive"):
        TraceStore.create(tmp_path / "z", shard_size=0)
    ro = TraceStore.open(tmp_path / "s")
    with pytest.raises(PermissionError):
        ro.append(_mixed_trace(reqs=10))


def test_unflushed_reads_rejected(tmp_path):
    t = _mixed_trace(reqs=50)
    store = TraceStore.create(tmp_path / "s", shard_size=1000)
    store.append(t)
    assert len(store) == len(t)      # logical length counts the buffer
    with pytest.raises(RuntimeError, match="unflushed"):
        store.to_trace()
    with pytest.raises(RuntimeError, match="unflushed"):
        store.read(0, 10)
    store.flush()
    _assert_trace_equal(store.to_trace(), t)
    store.close()


# ---------------------------------------------------------------------------
# external-format parsers and the CLI
# ---------------------------------------------------------------------------

MSR_FIXTURE = """\
Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime
128166372003061629,hm,0,Read,8192,4096,151
128166372016382155,hm,0,Write,12288,8192,512
128166372033741215,prxy,1,Read,0,4096,426
128166372033744415,hm,0,Read,8192,512,90
not,a,real,line
"""

BLKTRACE_FIXTURE = """\
  8,16   1        1     0.000000000  1234  Q   R 8 + 8 [fio]
  8,16   1        2     0.000104000  1234  D   R 8 + 8 [fio]
  8,32   0        3     0.000221000  1235  Q  WS 16 + 16 [fio]
  8,16   1        4     0.000300000  1234  C   R 8 + 8 [0]
  8,16   1        5     0.000412000  1234  Q   W 24 + 8 [fio]
CPU0 (fio): reads queued: 1
"""


def _msr_text(n=900, seed=3) -> str:
    """MSR rows of random hosts, disks, types, offsets and sizes (some
    spanning several blocks, some sub-block), a header and junk lines."""
    rng = np.random.default_rng(seed)
    lines = ["Timestamp,Hostname,DiskNumber,Type,Offset,Size,ResponseTime"]
    for i in range(n):
        host = ("hm", "prxy", "src2")[rng.integers(3)]
        typ = ("Read", "Write", "r", "W", "Flush")[rng.integers(5)]
        off = int(rng.integers(0, 1 << 30))
        size = int(rng.choice([512, 4096, 8192, 65536, 0]))
        lines.append(f"{i},{host},{rng.integers(2)},{typ},{off},{size},7")
        if i % 97 == 0:
            lines.append("garbage")
    return "\n".join(lines) + "\n"


def _blktrace_text(n=900, seed=4) -> str:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        dev = ("8,16", "8,32", "259,0")[rng.integers(3)]
        act = "QDCQQ"[rng.integers(5)]
        rwbs = ("R", "W", "WS", "RA", "N", "FWS")[rng.integers(6)]
        lines.append(f"  {dev}   1   {i}   {i * 1e-4:.9f}  1234  {act}  "
                     f"{rwbs} {rng.integers(0, 1 << 24)} + "
                     f"{rng.integers(1, 129)} [fio]")
    lines.append("CPU0 (fio): reads queued: 1")
    return "\n".join(lines) + "\n"


def test_parse_fixtures():
    t = Trace.concat(list(parse_msr_csv(MSR_FIXTURE.splitlines(),
                                        block_size=4096)))
    assert np.asarray(t.addr).tolist() == [2, 3, 4, 0, 2]
    assert np.asarray(t.is_write).tolist() == [False, True, True, False,
                                               False]
    assert np.asarray(t.vm).tolist() == [0, 0, 0, 1, 0]
    t = Trace.concat(list(parse_blktrace(BLKTRACE_FIXTURE.splitlines(),
                                         block_size=4096)))
    assert np.asarray(t.addr).tolist() == [1, 2, 3, 3]
    assert np.asarray(t.is_write).tolist() == [False, True, True, True]
    assert np.asarray(t.vm).tolist() == [0, 1, 1, 0]


@pytest.mark.parametrize("fmt", ["msr", "blktrace"])
@pytest.mark.parametrize("block_size,chunk", [(4096, 1 << 16), (512, 64)])
def test_parsers_equal_jax(fmt, block_size, chunk):
    """The same text through both packages' parsers: the same chunks
    (the chunk cut included) and the same requests."""
    text = _msr_text() if fmt == "msr" else _blktrace_text()
    port, ref = ((parse_msr_csv, jparse_msr_csv) if fmt == "msr"
                 else (parse_blktrace, jparse_blktrace))
    got = list(port(text.splitlines(), block_size=block_size, chunk=chunk))
    want = list(ref(text.splitlines(), block_size=block_size, chunk=chunk))
    assert len(got) == len(want) and len(got) >= 1
    assert (len(got) > 1) == (chunk == 64)
    for a, b in zip(got, want):
        assert isinstance(a, Trace)
        assert a.addr.dtype == np.int32 and a.vm.dtype == np.int32
        _assert_trace_equal(a, b)


@pytest.mark.parametrize("line", [f"1,h,0,Read,{(2**31) * 4096},4096,1",
                                  "1,h,0,Read,-8192,4096,1"])
def test_parser_int32_overflow_rejected(line):
    """Offsets past 2^31 blocks (or negative) fail loudly, with the
    reference's message, instead of wrapping into the datapath's
    negative-address no-op convention."""
    with pytest.raises(ValueError, match="int32") as got:
        list(parse_msr_csv([line]))
    with pytest.raises(ValueError, match="int32") as want:
        list(jparse_msr_csv([line]))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fmt", ["msr", "blktrace"])
def test_store_cli_equals_jax(tmp_path, monkeypatch, capsys, fmt):
    """``import`` then ``info`` through each package's CLI, from
    directories laid out alike: the same printed lines and the same
    store files."""
    text = MSR_FIXTURE + _msr_text(300) if fmt == "msr" else \
        BLKTRACE_FIXTURE + _blktrace_text(300)
    outs = {}
    for name, cli in (("port", store_cli), ("jax", jstore_cli)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        Path("trace.txt").write_text(text)
        assert cli(["import", "--format", fmt, "trace.txt", "s",
                    "--shard-size", "128", "--block-size", "2048"]) == 0
        assert cli(["info", "s"]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert "imported" in outs["port"] and "shards of 128" in outs["port"]
    _assert_same_files(tmp_path / "port" / "s", tmp_path / "jax" / "s")


# ---------------------------------------------------------------------------
# the on-disk format: the two packages write the same bytes
# ---------------------------------------------------------------------------

def _assert_same_files(a: Path, b: Path):
    files = sorted(p.name for p in a.iterdir())
    assert files == sorted(p.name for p in b.iterdir())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def _sized_trace():
    t = _mixed_trace(reqs=300)
    rng = np.random.default_rng(5)
    return dataclasses.replace(
        t, size=rng.integers(1, 9, len(t)).astype(np.int32))


def _write_both(kind: str, root: Path):
    """The same store written by each package; returns the trace."""
    p, j = root / "port", root / "jax"
    if kind == "make_store":
        make_store(p, list(WORKLOADS), 500, scale=0.25, shard_size=300)
        jmake_store(j, list(WORKLOADS), 500, scale=0.25, shard_size=300)
        return None
    if kind == "generate_to_store":
        spec = SPECS["usr_0"]
        generate_to_store(p, spec, 900, seed=2, shard_size=256)
        from repro.traces import generate_to_store as jgenerate_to_store
        jgenerate_to_store(j, spec, 900, seed=2, shard_size=256)
        return generate(spec, 900, seed=2)
    t = _sized_trace() if kind == "sized" else _mixed_trace(reqs=250)
    if kind == "resumed":
        for path, store_cls, tr in ((p, TraceStore, t),
                                    (j, JStore, _jtrace(t))):
            with store_cls.create(path, shard_size=200) as s:
                s.append(tr[:333])
            with store_cls.open(path, mode="a") as s:
                s.append(tr[333:500])
                s.append(tr[500:])
        return t
    TraceStore.from_trace(p, t, shard_size=200)
    JStore.from_trace(j, _jtrace(t), shard_size=200)
    return t


@pytest.mark.parametrize("kind", ["make_store", "generate_to_store", "sized",
                                  "resumed"])
def test_store_files_byte_identical_and_cross_open(tmp_path, kind):
    t = _write_both(kind, tmp_path)
    _assert_same_files(tmp_path / "port", tmp_path / "jax")
    for path in (tmp_path / "port", tmp_path / "jax"):
        mine, theirs = TraceStore.open(path), JStore.open(path)
        assert (len(mine), mine.num_shards, mine.num_vms, mine.has_size) == \
            (len(theirs), theirs.num_shards, theirs.num_vms,
             theirs.has_size)
        _assert_trace_equal(mine.to_trace(), theirs.to_trace())
        if t is not None:
            _assert_trace_equal(mine.to_trace(), t)


def test_make_store_equals_in_memory_mix(tmp_path):
    """make_store == the benchmarks' in-memory recipe (per-VM seeds,
    address stride, interleave seed)."""
    store = make_store(tmp_path / "s", list(WORKLOADS), reqs_per_vm=700,
                       scale=0.25, interleave_seed=0, shard_size=500)
    _assert_trace_equal(TraceStore.open(tmp_path / "s").to_trace(),
                        _mixed_trace(reqs=700))
    assert len(store) == 2100 and store.num_shards == 5
    assert names() == list(SPECS)


# ---------------------------------------------------------------------------
# streaming demux and blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_split_by_vm_matches_for_vm(seed):
    rng = np.random.default_rng(seed)
    n, v = 500, 5
    t = Trace(rng.integers(0, 64, n).astype(np.int32), rng.random(n) < 0.4,
              rng.integers(0, v, n).astype(np.int32))
    for vm_id, sub in enumerate(split_by_vm(t, v)):
        _assert_trace_equal(sub, t.for_vm(vm_id))
    plain = Trace(np.asarray(t.addr), np.asarray(t.is_write))
    assert all(s is plain for s in split_by_vm(plain, 3))


@pytest.mark.parametrize("num_vms", [4, 3])
def test_streaming_demux_matches_split_across_shards(tmp_path, num_vms):
    """Shard-level demux + window binary search == per-window split and
    == the JAX package's stream, with windows straddling shards, VMs
    absent from whole windows, a size channel, and (``num_vms`` 3) VM
    ids past the controller's count dropped."""
    rng = np.random.default_rng(7)
    n = 1000
    vm = rng.integers(0, 4, n).astype(np.int32)
    vm[100:400] = 2          # VMs 0, 1, 3 absent for a long stretch
    t = Trace(rng.integers(0, 64, n).astype(np.int32), rng.random(n) < 0.3,
              vm, rng.integers(1, 5, n).astype(np.int32))
    TraceStore.from_trace(tmp_path / "s", t, shard_size=333)
    src = StreamingTraceSource(TraceStore.open(tmp_path / "s"),
                               num_vms=num_vms, window=170, chunk=50)
    ref = JSource(JStore.open(tmp_path / "s"), num_vms=num_vms, window=170,
                  chunk=50)
    wins, jwins = list(src.windows()), list(ref.windows())
    assert len(wins) == len(jwins) == len(list(t.intervals(170)))
    for win, jwin, rw in zip(wins, jwins, t.intervals(170)):
        subs = split_by_vm(rw, num_vms)
        assert len(win.subs) == num_vms
        for a, b, c in zip(win.subs, subs, jwin.subs):
            _assert_trace_equal(a, b)
            _assert_trace_equal(a, c)
            assert a.addr.flags.writeable    # copied out of the mapping


def test_vmless_store_windows(tmp_path):
    """A store without a vm channel: every VM sees the whole window."""
    t = _mixed_trace(reqs=200)
    plain = Trace(np.asarray(t.addr), np.asarray(t.is_write))
    TraceStore.from_trace(tmp_path / "s", plain, shard_size=128)
    src = window_source(TraceStore.open(tmp_path / "s"), 2, 250, 100)
    for win, rw in zip(src.windows(), plain.intervals(250)):
        assert len(win.subs) == 2 and win.subs[0] is win.subs[1]
        _assert_trace_equal(win.subs[0], rw)


@pytest.mark.parametrize("prefetch,depth", [(True, 2), (True, 1),
                                            (True, 0), (False, 2)])
def test_stream_blocks_padding_ragged_and_empty_vms(tmp_path, prefetch,
                                                    depth):
    """[V, chunk] blocks match pad_batch on the reference chunk lists —
    an all-empty VM (all-pad rows) and ragged tails included — at every
    prefetch setting."""
    t = _mixed_trace(reqs=300)           # 900 requests, 3 VMs
    TraceStore.from_trace(tmp_path / "s", t, shard_size=256)
    src = StreamingTraceSource(TraceStore.open(tmp_path / "s"), num_vms=4,
                               window=400, chunk=150, prefetch=prefetch,
                               prefetch_depth=depth)
    assert src.depth == (depth if prefetch else 0)
    for win, rw in zip(src.windows(), t.intervals(400)):
        assert win.prefetch_depth == src.depth
        lists = [list(s.intervals(150)) for s in split_by_vm(rw, 4)]
        got = list(win.blocks())
        assert len(got) == max(map(len, lists), default=0)
        for k, (a, w, lens, kth) in enumerate(got):
            ref_kth = [c[k] if k < len(c) else None for c in lists]
            ra, rw_ = pad_batch(ref_kth, 150)
            assert a.shape == (4, 150) and str(a.device) == "cpu"
            assert np.array_equal(a.numpy(), ra)
            assert np.array_equal(w.numpy(), rw_)
            assert lens.tolist() == [0 if c is None else len(c)
                                     for c in ref_kth]
            for ck, rk in zip(kth, ref_kth):
                if rk is None or len(rk) == 0:
                    assert ck is None or len(ck) == 0
                else:
                    _assert_trace_equal(ck, rk)


def test_window_source_type_errors_and_reparameterization(tmp_path):
    with pytest.raises(TypeError, match="expected Trace, TraceStore"):
        window_source(object(), 2, 100, 10)
    jt = JTrace(np.arange(4, dtype=np.int32), np.zeros(4, bool))
    with pytest.raises(TypeError, match="got Trace"):
        window_source(jt, 2, 100, 10)          # the JAX package's Trace
    JStore.from_trace(tmp_path / "j", jt)
    with pytest.raises(TypeError, match="got TraceStore"):
        window_source(JStore.open(tmp_path / "j"), 2, 100, 10)
    pre = StreamingTraceSource(Trace(np.arange(4, dtype=np.int32),
                                     np.zeros(4, bool)),
                               num_vms=1, window=2, chunk=1, prefetch=True)
    assert pre.device is None
    src = window_source(pre, 3, 100, 10, prefetch=False, prefetch_depth=3,
                        device="cpu")
    assert (src.num_vms, src.window, src.chunk, src.prefetch,
            src.prefetch_depth, src.device, src.depth) == \
        (3, 100, 10, False, 3, "cpu", 0)
    assert src.source is pre.source and pre.num_vms == 1


def test_store_shards_through_the_simulator(tmp_path):
    """fig3's streamed form: a store's read-only shards straight into
    ``simulate_single_level``, chunk after chunk (the simulator copies a
    read-only array once). Equal to the JAX package's loop over the
    same shards; the counts and the final state also equal one call on
    the whole trace (``latency_sum`` is summed in float32 a chunk at a
    time, as the reference sums it)."""
    from repro.core import Policy as JPolicy, Stats as JStats
    from repro.core import make_cache as jmake_cache
    from repro.core import simulate_single_level as jsimulate
    t = make("varmail", 3000, seed=0, scale=0.25)
    TraceStore.from_trace(tmp_path / "s", t, shard_size=1000)

    def loop(chunks, sim, stats, state, policy):
        t0 = 0
        for chunk in chunks:
            state, st, t0 = sim(np.asarray(chunk.addr),
                                np.asarray(chunk.is_write), state,
                                GEO.max_ways, policy, t0=t0)
            stats = stats.merge(st)
        return ({k: float(x) for k, x in zip(Stats._fields, stats)},
                int(t0), [np.asarray(s).tolist() for s in state])
    got = loop(TraceStore.open(tmp_path / "s").iter_shards(),
               simulate_single_level, Stats.zero(),
               make_cache(GEO.num_sets, GEO.max_ways, "cpu"), Policy.WBWO)
    want = loop(JStore.open(tmp_path / "s").iter_shards(), jsimulate,
                JStats.zero(), jmake_cache(8, 16), JPolicy.WBWO)
    whole = loop([t], simulate_single_level, Stats.zero(),
                 make_cache(GEO.num_sets, GEO.max_ways, "cpu"), Policy.WBWO)
    assert got == want
    assert got[1:] == whole[1:]
    assert {k: v for k, v in got[0].items() if k != "latency_sum"} == \
        {k: v for k, v in whole[0].items() if k != "latency_sum"}


# ---------------------------------------------------------------------------
# controllers: port run(store) == JAX run(store) == port in-memory run
# ---------------------------------------------------------------------------

REQS = 1200


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """The 3-VM mix of 3,600 requests as two stores for the whole module:
    ``etica`` in shards of 1,024 (windows of 1,500 span two or three),
    ``eci`` in shards of 900; ``refs`` caches each reference run."""
    root = tmp_path_factory.mktemp("stores")
    trace = _mixed_trace(reqs=REQS)
    TraceStore.from_trace(root / "etica", trace, shard_size=1024)
    TraceStore.from_trace(root / "eci", trace, shard_size=900)
    return dict(root=root, trace=trace, refs={})


def _cached(stores, key, fn):
    if key not in stores["refs"]:
        stores["refs"][key] = fn()
    return stores["refs"][key]


def _etica_cfg(**kw):
    return EticaConfig(dram_capacity=60, ssd_capacity=120,
                       geometry_dram=GEO, geometry_ssd=GEO,
                       resize_interval=1500, promo_interval=500, **kw)


def _jax_etica(stores, clean_quota: int):
    geo = JGeometry(num_sets=8, max_ways=16)
    cfg = JConfig(dram_capacity=60, ssd_capacity=120, geometry_dram=geo,
                  geometry_ssd=geo, resize_interval=1500, promo_interval=500,
                  clean_quota=clean_quota)
    return _cached(stores, ("jax", clean_quota), lambda: JCache(cfg, 3).run(
        JStore.open(stores["root"] / "etica")))


def _port_in_memory(stores, clean_quota: int):
    return _cached(stores, ("port", clean_quota), lambda: EticaCache(
        _etica_cfg(clean_quota=clean_quota), 3, device="cpu").run(
            stores["trace"]))


def _assert_results(got, want):
    assert len(got) == len(want)
    for v, (a, b) in enumerate(zip(got, want)):
        assert a.stats == b.stats, v
        assert np.array_equal(a.alloc_history, b.alloc_history), v


@pytest.mark.parametrize("mode", [
    dict(), dict(prefetch=False), dict(prefetch_depth=0),
    dict(prefetch_depth=1), dict(prefetch_depth=3), dict(batched=False),
    dict(clean_quota=2), "prebuilt"],
    ids=["fused", "no_prefetch", "depth0", "depth1", "depth3", "sequential",
         "cleaner", "prebuilt"])
def test_etica_store_equals_jax_and_in_memory(stores, mode):
    path = stores["root"] / "etica"
    if mode == "prebuilt":        # re-parameterised to the controller's
        src = StreamingTraceSource(TraceStore.open(path), num_vms=7,
                                   window=99, chunk=33, prefetch=False)
        mode, trace = {}, src
    else:
        trace = TraceStore.open(path)
    quota = mode.get("clean_quota", 0)
    got = EticaCache(_etica_cfg(**mode), 3, device="cpu").run(trace)
    _assert_results(got, _jax_etica(stores, quota))
    _assert_results(got, _port_in_memory(stores, quota))
    if quota:
        assert sum(r.stats["flushes"] for r in got) > 0


@pytest.mark.parametrize("batched", [True, False])
def test_eci_store_equals_jax_and_in_memory(stores, batched):
    path = stores["root"] / "eci"

    def build(pkg=make_eci_cache, **kw):
        return pkg(120, 3, geometry=kw.pop("geometry", GEO),
                   resize_interval=1500, sim_chunk=500, **kw)
    got_cache = build(batched=batched, prefetch=batched, device="cpu")
    got = got_cache.run(TraceStore.open(path))
    want = build(jmake_eci_cache, geometry=JGeometry(8, 16),
                 batched=batched).run(JStore.open(path))
    mem = build(device="cpu").run(stores["trace"])
    _assert_results(got, want)
    _assert_results(got, mem)
    assert {p for log in got_cache.logs for p in log.policies} <= \
        {"RO", "WB"}
