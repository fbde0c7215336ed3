"""Churn-driven serving with the ETICA two-tier KV manager.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --events 2000 --tenants 4 --live 256 [--manager lru] [--device cpu]

The PyTorch counterpart of :mod:`repro.launch.serve`. A session
arrival/churn stream (:func:`repro_torch.traces.generators
.generate_sessions`) drives the manager's whole lifecycle — arrivals,
activations (tier-1 residency via the POD/popularity controller), KV
page appends (WBWO commits) and retirements — and every
``--decode-every``-th activation runs one paged decode-attention step
(the ``paged_decode_attention`` kernel on the card) against the pool.
Prints hit ratio, DMA traffic and modelled latency, the serving analogs
of the paper's hit ratio, SSD writes and latency.

Managers: ``etica`` (batched controller), ``etica-seq`` (the host-dict
sequential oracle: same decisions, slower), ``lru`` (global LRU with
write-back). ``--metrics-port N`` serves live ``/metrics`` and
``/healthz`` (0 picks a free port); ``--journal PATH`` spills one JSONL
row per maintenance interval; ``--spans`` times the maintenance and
sizing dispatches (each span then waits for its work).

The KV geometry of ``--arch`` is its reduced configuration's
(:mod:`repro_torch.configs`). For the decoder-only families with
attention (dense, MoE, hybrid) the page bank holds real KV pages: one
prefill of the reduced model (random weights from ``--seed``) fills it
from the first attention layer's cache, the flash attention kernel on
the card. Enc-dec and vision take gaussian pages, as in the reference;
the manager only moves bytes, so the statistics do not depend on the
contents. An attention-free model (SSM) has no KV to page: its bank
fails as the reference's does. Runs on the card unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import resolve_device, upload
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kvcache import GlobalLRUManager, TwoTierConfig, TwoTierKVManager
from repro_torch.models import model as M
from repro_torch.traces.generators import (SESSION_ACTIVATE, SESSION_APPEND,
                                           SESSION_END, SESSION_NEW,
                                           SessionSpec, generate_sessions)

def kv_geometry(cfg) -> tuple[int, int]:
    """(num_kv_heads, head_dim) of the pool for a model configuration,
    floored at 1 and 8 as the reference does."""
    return max(cfg.num_kv_heads, 1), max(cfg.head_dim, 8)


def gaussian_pages(kv_cfg: TwoTierConfig, bank: int, seed: int,
                   pin: bool = False):
    """``(k_bank, v_bank)``: ``bank`` gaussian pages ``[bank, 1, PS, Hkv,
    D]`` float32 on the host (one array for both, as the reference's
    gaussian branch), pinned when ``pin``."""
    rng = np.random.default_rng(seed)
    pages = torch.from_numpy(rng.normal(size=(
        bank, 1, kv_cfg.page_size, kv_cfg.num_kv_heads,
        kv_cfg.head_dim)).astype(np.float32))
    if pin:
        pages = pages.pin_memory()
    return pages, pages


def kv_page_bank(cfg, kv_cfg: TwoTierConfig, bank: int, seed: int, *,
                 params=None, device=None, pin: bool = False):
    """A bank of real KV pages ``[bank, 1, PS, Hkv, D]`` float32 on the
    host: prefill the model ``cfg`` once over ``bank`` pages' worth of
    uniform token ids (from ``seed + 1``) and slice its first attention
    layer's cache into pages. The first attention layer is the
    reference's: the first ``k`` / ``v`` entry of ``cache["layers"]`` in
    its tree order (block names sorted), superlayer 0 (jamba's
    ``block7``; for deepseek the first MoE layer, not the ``prefix``).
    The model is ``params`` (a :class:`repro_torch.models.model.Model`),
    which runs where its weights lie, or else the one drawn from
    ``seed`` on the CPU and moved to ``device`` (default ``"cuda"``);
    give one or the other. Enc-dec and vision configs take
    :func:`gaussian_pages`, as the reference does; an attention-free
    model raises the reference's ``AssertionError("no attention
    cache")``."""
    if params is not None and device is not None:
        raise ValueError("give params or device, not both: the prefill "
                         "runs where the params lie")
    if cfg.is_encdec or cfg.frontend == "vision":
        return gaussian_pages(kv_cfg, bank, seed, pin)
    ps = kv_cfg.page_size
    if params is None:
        params = M.init_params(cfg, torch.Generator().manual_seed(seed),
                               device="cpu").to(resolve_device(
                                   device or "cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (1, bank * ps),
                           generator=torch.Generator().manual_seed(seed + 1))
    _, cache = M.prefill(params, cfg,
                         {"tokens": tokens.to(params.embed.device)},
                         cache_len=bank * ps)
    first = next((cache["layers"][name] for name in sorted(cache["layers"])
                  if "k" in cache["layers"][name]), None)
    if first is None:
        raise AssertionError("no attention cache")
    k, v = (first[n][0, 0].float().cpu() for n in ("k", "v"))  # [S, Hkv, D]
    if (k.shape[1], k.shape[2]) != (kv_cfg.num_kv_heads, kv_cfg.head_dim):
        raise ValueError("kv geometry mismatch between model and pool")
    k_bank, v_bank = (a.reshape(bank, 1, ps, *a.shape[1:]) for a in (k, v))
    if pin:
        k_bank, v_bank = k_bank.pin_memory(), v_bank.pin_memory()
    return k_bank, v_bank


def run_events(mgr, trace, k_bank, v_bank, *, decode_every: int = 0,
               seed: int = 0):
    """Replay a SessionTrace through a manager; every ``decode_every``-th
    activation runs one paged decode-attention step (q ``[1, Hkv, D]``,
    one query head per KV head) over the pool's first layer."""
    rng = np.random.default_rng(seed)
    bank = k_bank.shape[0]
    n_act = 0
    for i in range(len(trace)):
        kind, sid = int(trace.kind[i]), int(trace.sid[i])
        if kind == SESSION_NEW:
            mgr.new_session(sid, int(trace.tenant[i]))
        elif kind == SESSION_APPEND:
            j = sid % bank
            mgr.append_page(sid, k_bank[j], v_bank[j])
        elif kind == SESSION_ACTIVATE:
            pt = mgr.activate(sid)
            n_act += 1
            if decode_every and n_act % decode_every == 0:
                h, d = mgr.cfg.num_kv_heads, mgr.cfg.head_dim
                q = upload(rng.normal(size=(1, h, d)).astype(np.float32),
                           mgr.device)
                meta = upload(np.append(pt, mgr.sessions[sid].length)
                              .astype(np.int32), mgr.device)
                out = decode_attention(q, (mgr.k_pool[0], mgr.v_pool[0]),
                                       meta[None, :-1], meta[-1:])
                assert bool(torch.isfinite(out).all())
            mgr.deactivate(sid)
        elif kind == SESSION_END:
            mgr.end_session(sid)
    return mgr.stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.ARCH_IDS)
    ap.add_argument("--events", type=int, default=2000)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--live", type=int, default=256,
                    help="target concurrent sessions")
    ap.add_argument("--hbm-pages", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-pages", type=int, default=6,
                    help="per-session KV budget (pages)")
    ap.add_argument("--manager", choices=["etica", "etica-seq", "lru"],
                    default="etica")
    ap.add_argument("--decode-every", type=int, default=8,
                    help="paged-attention decode each Nth activation "
                         "(0 = controller only)")
    ap.add_argument("--no-materialize", action="store_true",
                    help="skip device page pools (implies no decode) — "
                         "controller-scale runs")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live /metrics + /healthz on this port "
                         "(0 = ephemeral; off when omitted)")
    ap.add_argument("--journal", default=None,
                    help="spill the per-interval telemetry journal to "
                         "this JSONL path")
    ap.add_argument("--spans", action="store_true",
                    help="time the dispatches into the "
                         "etica_serving_dispatch_seconds histogram (each "
                         "span waits for its work)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    hkv, head_dim = kv_geometry(cfg)
    recorder = None
    if args.metrics_port is not None or args.journal or args.spans:
        from repro_torch.runtime.telemetry import TelemetryRecorder
        recorder = TelemetryRecorder(spill=args.journal,
                                     span_timing=args.spans)
    kv_cfg = TwoTierConfig(
        page_size=args.page_size, hbm_pages=args.hbm_pages,
        num_kv_heads=hkv, head_dim=head_dim, num_layers=1, dtype="float32",
        materialize=not args.no_materialize, telemetry=recorder)
    if args.manager == "lru":
        mgr = GlobalLRUManager(kv_cfg, args.tenants, device=dev)
    else:
        mgr = TwoTierKVManager(kv_cfg, args.tenants,
                               batched=args.manager == "etica", device=dev)

    server = None
    if args.metrics_port is not None:
        from repro_torch.runtime import metrics as metrics_mod
        from repro_torch.runtime.http import MetricsServer

        def _collect():
            out = []
            if isinstance(mgr, TwoTierKVManager):
                out += metrics_mod.collect_serving(mgr)
                out += metrics_mod.collect_telemetry(
                    mgr.telemetry, prefix="etica_serving", label="tenant")
            return out

        server = MetricsServer(_collect, port=args.metrics_port)
        host, port = server.start()
        print(f"metrics: http://{host}:{port}/metrics")

    spec = SessionSpec(num_tenants=args.tenants, target_live=args.live,
                       max_pages=args.max_pages)
    trace = generate_sessions(spec, args.events, seed=args.seed)
    k_bank, v_bank = kv_page_bank(cfg, kv_cfg, bank=8, seed=args.seed,
                                  device=dev, pin=dev.type == "cuda")

    t0 = time.time()
    decode_every = 0 if args.no_materialize else args.decode_every
    stats = run_events(mgr, trace, k_bank, v_bank,
                       decode_every=decode_every, seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    s = stats.as_dict()
    print(f"manager={args.manager} events={args.events} "
          f"sessions={trace.num_sessions} max_live={trace.max_live} "
          f"device={dev} wall={wall:.1f}s")
    for k, v in s.items():
        print(f"  {k:18s} {v:,.3f}" if isinstance(v, float) else
              f"  {k:18s} {v:,}")
    if recorder is not None and recorder.journal.total:
        last = recorder.journal.last_row()
        flagged = [str(t) for t, f in enumerate(last["overloaded"]) if f]
        print(f"  telemetry: {recorder.journal.total} interval rows"
              + (f", journal -> {args.journal}" if args.journal else "")
              + (f", overloaded tenants: {','.join(flagged)}"
                 if flagged else ""))
    if recorder is not None:
        recorder.journal.close()
    if server is not None:
        # interactive runs keep the endpoint alive for a final scrape;
        # programmatic callers (argv passed in) get it shut down
        if argv is None:
            print(f"scrape still live at {server.url} (ctrl-c to exit)")
            try:
                import signal
                signal.pause()
            except (KeyboardInterrupt, AttributeError):
                pass
        server.stop()
    return s


if __name__ == "__main__":
    main()
