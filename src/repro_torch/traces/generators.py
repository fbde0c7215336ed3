"""Synthetic workload generators modeled on the paper's trace suite.

The paper evaluates with MSR Cambridge traces (SNIA IOTTA) and
FIO/Filebench workloads. Those traces are not redistributable inside this
container, so each family is modeled as a parameterized generator that
reproduces the *characteristics the paper relies on*: read/write mix,
locality (zipf re-reference), sequentiality, working-set size, and
RAW-vs-RAR structure. Every generator is deterministic given a seed and
gives the same requests as ``repro.traces.generators`` (numpy only).

Families (paper §5.1 and Table 2):

====================  =========================================================
hm_1                  hardware monitoring — random reads, high locality
mds_0 / mds_1         media server — sequential (streaming) reads, low locality
src2_0 / src1_2       source control — small writes with heavy RAW re-reads
stg_1                 web staging — write-intensive random
ts_0                  terminal server — RAW/RARAW-heavy mixed
wdev_0                test web server — writes followed by repeated reads (RAW)
web_3                 web/SQL server — read-intensive, mostly cold reads
rsrch_0               research projects — write-heavy with moderate RAW
usr_0                 user home dirs — write-dominated, popular written blocks
proj_0                project dirs — mixed, moderate locality
fio_randrw            FIO RandRW 70% read zipf(1.1) (motivational Fig. 3a)
web_server            Filebench Web Server — random cold reads (Fig. 3b)
video_server          Filebench Video Server — pure sequential reads (Fig. 3c)
varmail               Filebench Varmail — 50/50 random read/write (Fig. 3d)
====================  =========================================================

:func:`generate_sessions` is the serving workload's session
arrival/churn stream (the two-tier KV manager's trace); it draws from the
generator in the reference's order, so a seed gives the same events.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.trace import Trace


@dataclasses.dataclass
class WorkloadSpec:
    """Knobs shared by all generators."""
    read_ratio: float = 0.7         # fraction of reads
    working_set: int = 4096         # distinct blocks
    zipf_a: float = 1.1             # skew of the re-reference distribution
    sequential: float = 0.0         # fraction of sequential runs
    raw_fraction: float = 0.0       # fraction of reads directed at
                                    # recently-written blocks (RAW structure)
    cold_fraction: float = 0.0      # fraction of reads to never-reused blocks
    write_burst: float = 0.0        # fraction of writes redirected to
                                    # one-shot addresses (scans/installs/log
                                    # writes — the pollution that penalizes
                                    # push-mode caches, paper §4.2)
    run_length: int = 64            # blocks per sequential run
    seq_interleaved: bool = False   # emit the sequential part as contiguous
                                    # runs spliced into the random stream
                                    # (adjacency survives, so run-length
                                    # rules / seq-cutoff can see the scans;
                                    # plain `sequential` permutes arrivals)
    big_fraction: float = 0.0       # fraction of requests issued at
                                    # big_size blocks (mixed-block-size
                                    # workloads -> Trace.size channel)
    big_size: int = 8               # blocks per "big" request


def _zipf_ranks(rng: np.random.Generator, n: int, size: int, a: float):
    """Zipf-distributed ranks in [0, size) (bounded, vectorized)."""
    ranks = np.arange(1, size + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    return rng.choice(size, size=n, p=p)


def generate(spec: WorkloadSpec, n: int, seed: int = 0,
             addr_offset: int = 0) -> Trace:
    if spec.seq_interleaved and spec.sequential > 0:
        return _generate_seq_interleaved(spec, n, seed, addr_offset)
    rng = np.random.default_rng(seed)
    addr = np.zeros(n, np.int64)
    is_write = rng.random(n) >= spec.read_ratio

    # permute the working set so zipf-hot blocks are scattered over sets
    perm = rng.permutation(spec.working_set)

    n_seq = int(n * spec.sequential)
    n_rand = n - n_seq

    # random (zipf) part
    hot = perm[_zipf_ranks(rng, n_rand, spec.working_set, spec.zipf_a)]
    addr[:n_rand] = hot

    # sequential runs (streaming) — walk fresh address space
    if n_seq:
        base = spec.working_set
        runs = np.maximum(spec.run_length, 1)
        steps = np.arange(n_seq)
        addr[n_rand:] = base + steps  # one long scan
        is_write[n_rand:] = rng.random(n_seq) >= spec.read_ratio

    # interleave sequential into random positions to avoid phase artifacts
    order = rng.permutation(n)
    addr = addr[order]
    is_write = is_write[order]

    # cold reads: redirect a fraction of reads to one-shot addresses
    if spec.cold_fraction > 0:
        reads = np.nonzero(~is_write)[0]
        k = int(len(reads) * spec.cold_fraction)
        if k:
            pick = rng.choice(reads, size=k, replace=False)
            addr[pick] = spec.working_set + n + np.arange(k)

    # write bursts: one-shot writes with no future references (pollution)
    if spec.write_burst > 0:
        writes = np.nonzero(is_write)[0]
        k = int(len(writes) * spec.write_burst)
        if k:
            pick = rng.choice(writes, size=k, replace=False)
            addr[pick] = spec.working_set + 2 * n + np.arange(k)

    # RAW structure: redirect a fraction of reads to the most recent writes
    if spec.raw_fraction > 0:
        write_pos = np.nonzero(is_write)[0]
        reads = np.nonzero(~is_write)[0]
        k = int(len(reads) * spec.raw_fraction)
        if k and write_pos.size:
            pick = rng.choice(reads, size=k, replace=False)
            for i in pick:
                prev_w = write_pos[write_pos < i]
                if prev_w.size:
                    # read one of the last few written blocks (RAW / RARAW)
                    j = prev_w[-1 - rng.integers(0, min(8, prev_w.size))]
                    addr[i] = addr[j]

    return Trace(addr=(addr + addr_offset).astype(np.int32),
                 is_write=is_write,
                 size=_draw_sizes(spec, n, rng))


def _draw_sizes(spec: WorkloadSpec, n: int,
                rng: np.random.Generator) -> np.ndarray | None:
    """Mixed-block-size channel: ``big_fraction`` of requests at
    ``big_size`` blocks, the rest at 1. ``None`` (no size channel, the
    all-ones convention) when the spec is single-size — existing
    workloads are byte-identical to before."""
    if spec.big_fraction <= 0 or n == 0:
        return None
    size = np.ones(n, np.int32)
    k = int(n * spec.big_fraction)
    if k:
        size[rng.choice(n, size=k, replace=False)] = spec.big_size
    return size


def _generate_seq_interleaved(spec: WorkloadSpec, n: int, seed: int,
                              addr_offset: int) -> Trace:
    """Contiguous sequential runs spliced into the random stream.

    The base generator permutes arrival order, which destroys the
    address adjacency run-length rules key on; here the random part is
    generated as usual (``sequential=0``) and whole runs of
    ``run_length`` contiguous blocks — one direction per run, fresh
    address space, gaps between runs so they never merge — are inserted
    at sorted random cut points, preserving both streams' internal
    order."""
    run_len = max(spec.run_length, 1)
    num_runs = int(n * spec.sequential) // run_len
    n_seq = num_runs * run_len
    n_rand = n - n_seq
    base = dataclasses.replace(spec, sequential=0.0, seq_interleaved=False)
    rnd = generate(base, n_rand, seed=seed, addr_offset=0)
    rng = np.random.default_rng(seed + 1)   # splice stream, decoupled
                                            # from the random part's seed
    scan_base = spec.working_set + 4 * n    # clear of cold/burst ranges
    out_a = [np.asarray(rnd.addr, np.int64)]
    out_w = [np.asarray(rnd.is_write)]
    out_s = [rnd.sizes().astype(np.int32)]
    if num_runs:
        cuts = np.sort(rng.integers(0, n_rand + 1, num_runs))
        run_write = rng.random(num_runs) >= spec.read_ratio
        out_a, out_w, out_s = [], [], []
        prev = 0
        for r in range(num_runs):
            c = int(cuts[r])
            out_a.append(np.asarray(rnd.addr[prev:c], np.int64))
            out_w.append(np.asarray(rnd.is_write[prev:c]))
            out_s.append(rnd.sizes()[prev:c].astype(np.int32))
            start = scan_base + r * (run_len + 64)   # gap: runs never chain
            out_a.append(np.arange(start, start + run_len, dtype=np.int64))
            out_w.append(np.full(run_len, run_write[r]))
            out_s.append(np.ones(run_len, np.int32))
            prev = c
        out_a.append(np.asarray(rnd.addr[prev:], np.int64))
        out_w.append(np.asarray(rnd.is_write[prev:]))
        out_s.append(rnd.sizes()[prev:].astype(np.int32))
    addr = np.concatenate(out_a)
    is_write = np.concatenate(out_w)
    size = np.concatenate(out_s) if rnd.size is not None else None
    return Trace(addr=(addr + addr_offset).astype(np.int32),
                 is_write=is_write, size=size)


# -- named families ---------------------------------------------------------

SPECS: dict[str, WorkloadSpec] = {
    "hm_1": WorkloadSpec(read_ratio=0.95, working_set=2048, zipf_a=1.4,
                         cold_fraction=0.02),
    "mds_0": WorkloadSpec(read_ratio=0.9, working_set=512, sequential=0.9,
                          zipf_a=1.05),
    "mds_1": WorkloadSpec(read_ratio=0.98, working_set=256, sequential=0.97,
                          zipf_a=1.01, cold_fraction=0.5),
    "src2_0": WorkloadSpec(read_ratio=0.4, working_set=1024, zipf_a=1.55,
                           raw_fraction=0.7),
    "src1_2": WorkloadSpec(read_ratio=0.45, working_set=1536, zipf_a=1.15,
                           raw_fraction=0.5),
    "stg_1": WorkloadSpec(read_ratio=0.25, working_set=4096, zipf_a=1.35,
                          write_burst=0.15),
    "ts_0": WorkloadSpec(read_ratio=0.55, working_set=1024, zipf_a=1.6,
                         raw_fraction=0.8),
    "wdev_0": WorkloadSpec(read_ratio=0.5, working_set=768, zipf_a=1.7,
                           raw_fraction=0.85),
    "web_3": WorkloadSpec(read_ratio=0.97, working_set=8192, zipf_a=1.02,
                          cold_fraction=0.6),
    "rsrch_0": WorkloadSpec(read_ratio=0.3, working_set=2048, zipf_a=1.5,
                            raw_fraction=0.3),
    "usr_0": WorkloadSpec(read_ratio=0.2, working_set=1536, zipf_a=1.7,
                          raw_fraction=0.6),
    "proj_0": WorkloadSpec(read_ratio=0.6, working_set=3072, zipf_a=1.15,
                           raw_fraction=0.2, cold_fraction=0.1),
    # motivational (Fig. 3) workloads
    "fio_randrw": WorkloadSpec(read_ratio=0.7, working_set=8192, zipf_a=1.1,
                               raw_fraction=0.5),
    "web_server": WorkloadSpec(read_ratio=0.9, working_set=16384, zipf_a=1.01,
                               cold_fraction=0.7),
    "video_server": WorkloadSpec(read_ratio=1.0, working_set=64,
                                 sequential=1.0, cold_fraction=0.0),
    "varmail": WorkloadSpec(read_ratio=0.5, working_set=4096, zipf_a=1.1,
                            raw_fraction=0.25),
    # scan-heavy / mixed-block families (classification workloads): the
    # sequential part is emitted as contiguous runs (seq_interleaved) so
    # run-length rules and the sequential-cutoff bypass can see the scans
    "scan_mix": WorkloadSpec(read_ratio=0.85, working_set=1024, zipf_a=1.4,
                             sequential=0.6, run_length=96,
                             seq_interleaved=True),
    "backup_scan": WorkloadSpec(read_ratio=0.15, working_set=1024,
                                zipf_a=1.3, sequential=0.7, run_length=128,
                                seq_interleaved=True),
    "mixed_block": WorkloadSpec(read_ratio=0.7, working_set=2048, zipf_a=1.3,
                                sequential=0.3, run_length=64,
                                seq_interleaved=True, big_fraction=0.25,
                                big_size=8),
}

def make(name: str, n: int, seed: int = 0, addr_offset: int = 0,
         scale: float = 1.0) -> Trace:
    """Instantiate a named workload; ``scale`` shrinks the working set for
    CPU-friendly benchmark sizes while preserving the mix."""
    spec = SPECS[name]
    if scale != 1.0:
        spec = dataclasses.replace(
            spec, working_set=max(int(spec.working_set * scale), 16))
    return generate(spec, n, seed=seed, addr_offset=addr_offset)




# -- serving session churn --------------------------------------------------

# event kinds of a SessionTrace (the serving analog of a block trace)
SESSION_NEW = 0        # session arrives (sid, tenant)
SESSION_ACTIVATE = 1   # session scheduled into a decode batch (KV read)
SESSION_APPEND = 2     # session generates one KV page (WBWO write)
SESSION_END = 3        # session leaves for good (frees tier-2 state)


@dataclasses.dataclass
class SessionTrace:
    """Arrival/churn event stream driving the two-tier KV serving stack.

    Parallel arrays, one entry per event: ``kind`` (the ``SESSION_*``
    constants), ``sid`` (session id, unique per NEW), ``tenant`` (valid
    on NEW, ``-1`` elsewhere)."""
    kind: np.ndarray     # int8  [N]
    sid: np.ndarray      # int32 [N]
    tenant: np.ndarray   # int8  [N]

    def __len__(self) -> int:
        return int(self.kind.size)

    @property
    def num_sessions(self) -> int:
        return int((self.kind == SESSION_NEW).sum())

    @property
    def max_live(self) -> int:
        delta = np.where(self.kind == SESSION_NEW, 1,
                         np.where(self.kind == SESSION_END, -1, 0))
        return int(np.cumsum(delta).max(initial=0))


@dataclasses.dataclass
class SessionSpec:
    """Knobs of the serving churn generator.

    Models the characteristics the ETICA policy keys on, translated to
    serving: zipf re-reference (a few hot sessions absorb most
    activations), recency bias (new sessions are hotter), bursty
    scheduling (a scheduled session tends to stay in the batch for a few
    consecutive rounds), bounded lifetimes (sessions retire after a
    bounded number of touches, so the population churns instead of
    growing without bound)."""
    num_tenants: int = 4
    target_live: int = 1024     # concurrent-session level after ramp-up
    zipf_a: float = 1.2         # skew of activation popularity over live
                                # sessions (rank 0 = most recent arrival)
    p_new: float = 0.05         # arrival probability per event once ramped
    p_append: float = 0.35      # chance a touch generates a page (vs pure
                                # activation) while below max_pages
    max_pages: int = 8          # per-session KV budget (pages)
    lifetime: int = 40          # touches before a session must retire
    p_end: float = 0.02         # early-retire chance per touch once the
                                # session has written >= 2 pages
    burst_len: float = 4.0      # mean consecutive touches to one session
                                # (geometric) — bursty batch residency
    tenant_weights: tuple | None = None   # arrival mix (default uniform)


def generate_sessions(spec: SessionSpec, n: int, seed: int = 0) -> SessionTrace:
    """Deterministic session arrival/churn stream of ``n`` events.

    O(1) per event: popularity is a precomputed zipf CDF over recency
    ranks, sampled by ``searchsorted`` and folded onto however many
    sessions are currently live."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, max(spec.target_live, 1) + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-spec.zipf_a))
    cdf /= cdf[-1]
    tw = None
    if spec.tenant_weights is not None:
        tw = np.asarray(spec.tenant_weights, np.float64)
        tw = tw / tw.sum()

    kind = np.empty(n, np.int8)
    sid_col = np.empty(n, np.int32)
    ten_col = np.full(n, -1, np.int8)

    live: list[int] = []          # newest last
    pages: dict[int, int] = {}
    touches: dict[int, int] = {}
    next_sid = 0
    burst_sid, burst_left = -1, 0
    # pre-draw the cheap scalars in one block each
    u_new = rng.random(n)
    u_rank = rng.random(n)
    u_act = rng.random(n)
    u_end = rng.random(n)
    mean_burst = max(spec.burst_len, 1.0)

    i = 0
    while i < n:
        ramping = len(live) < spec.target_live // 2
        p_new = max(spec.p_new, 0.0) + (0.5 if ramping else 0.0)
        if not live or (len(live) < spec.target_live and u_new[i] < p_new):
            sid = next_sid
            next_sid += 1
            live.append(sid)
            pages[sid] = 0
            touches[sid] = 0
            t = (int(rng.choice(spec.num_tenants, p=tw)) if tw is not None
                 else int(rng.integers(spec.num_tenants)))
            kind[i] = SESSION_NEW
            sid_col[i] = sid
            ten_col[i] = t
            burst_sid = sid
            burst_left = max(int(rng.geometric(1.0 / mean_burst)), 1)
            i += 1
            continue
        if burst_left > 0 and burst_sid in pages:
            sid = burst_sid
            burst_left -= 1
        else:
            r = int(np.searchsorted(cdf, u_rank[i]))
            sid = live[-1 - (r % len(live))]     # rank 0 = newest arrival
            burst_sid = sid
            burst_left = max(int(rng.geometric(1.0 / mean_burst)) - 1, 0)
        touches[sid] += 1
        if pages[sid] == 0 or (pages[sid] < spec.max_pages
                               and u_act[i] < spec.p_append):
            kind[i] = SESSION_APPEND
            pages[sid] += 1
        else:
            kind[i] = SESSION_ACTIVATE
        sid_col[i] = sid
        retire = (touches[sid] >= spec.lifetime
                  or (pages[sid] >= 2 and u_end[i] < spec.p_end))
        i += 1
        if retire and len(live) > 1 and i < n:
            kind[i] = SESSION_END
            sid_col[i] = sid
            live.remove(sid)
            del pages[sid], touches[sid]
            burst_left = 0
            i += 1
    return SessionTrace(kind=kind, sid=sid_col, tenant=ten_col)
