"""Aggregate the dry-run's JSON records into the roofline tables (the
port of :mod:`repro.launch.roofline`)::

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--dir build/dryrun] [--mesh 16x16] [--tag baseline] [--md] \\
        [--both-meshes]

Per (arch x shape): the three roofline terms (seconds a device, against
the H100 SXM datasheet rates of :data:`repro_torch.launch.dryrun.HW`),
the dominant term, MODEL_FLOPS / counted FLOPs, the roofline fraction
and a one-line note on what would move the dominant term.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import HW


def load(dir_: str, mesh: str, tag: str) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dir_,
                                              f"*__{mesh}__{tag}.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def advice(rec: dict) -> str:
    """One sentence: what would move the dominant term down."""
    b = rec.get("bottleneck")
    coll = rec.get("collectives", {})
    if rec.get("status") != "ok":
        return rec.get("reason", "")
    if b == "memory":
        if rec["kind"] == "decode":
            return ("KV reads dominate: shrink cache dtype/window or batch "
                    "more queries per KV pass")
        return ("activation traffic dominates: fuse the element-wise passes "
                "(the eager step writes every intermediate) / stronger remat")
    if b == "collective":
        top = max(coll, key=coll.get) if coll else "?"
        if top == "all-to-all":
            return ("MoE dispatch all-to-all: cut capacity factor or shard "
                    "tokens with experts")
        if top == "all-gather":
            return ("FSDP weight gathers: overlap with compute or widen "
                    "model axis")
        return "gradient all-reduce: reduce-scatter + bf16/int8 compression"
    return "compute-bound: good — push tensor-core utilization"


def fraction(rec: dict) -> float:
    """Roofline fraction = useful-compute time / dominant-term time."""
    t_useful = rec["model_flops"] / (rec["chips"] * HW["peak_flops_bf16"])
    t_dom = max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"])
    return t_useful / t_dom if t_dom else 0.0


def table(recs: list[dict], md: bool = True) -> str:
    hdr = ["arch", "shape", "status", "t_compute", "t_memory", "t_coll",
           "bottleneck", "MF/FLOPs", "roofline_frac", "note"]
    lines = []
    if md:
        lines.append("| " + " | ".join(hdr) + " |")
        lines.append("|" + "---|" * len(hdr))
    for r in recs:
        if r.get("status") == "skip":
            row = [r["arch"], r["shape"], "SKIP", "-", "-", "-", "-", "-",
                   "-", r.get("reason", "")[:60]]
        else:
            row = [r["arch"], r["shape"], "ok",
                   f"{r['t_compute_s']:.3g}", f"{r['t_memory_s']:.3g}",
                   f"{r['t_collective_s']:.3g}", r["bottleneck"],
                   f"{r['useful_flops_ratio']:.2f}",
                   f"{fraction(r):.3f}", advice(r)]
        lines.append(("| " + " | ".join(row) + " |") if md
                     else ",".join(row))
    return "\n".join(lines)


def mesh_pairs_table(dir_: str, tag: str) -> str:
    """One markdown row per (arch, shape) with both meshes' numbers as
    ``16x16 / 2x16x16``: FLOPs, state GB a device, the three terms in
    ms a device and the bottleneck."""
    pods = {r["arch"] + " " + r["shape"]: r
            for r in load(dir_, "2x16x16", tag)}
    lines = ["| arch | shape | FLOPs | state GB a device | compute ms | "
             "memory ms | collective ms | bottleneck |",
             "|---|---|---|---|---|---|---|---|"]

    def pair(a, b, fmt):
        return f"{fmt(a)} / {fmt(b)}"
    for r in load(dir_, "16x16", tag):
        m = pods.get(r["arch"] + " " + r["shape"], {})
        if r.get("status") != "ok" or m.get("status") != "ok":
            continue
        ms = lambda x: f"{x * 1e3:.4g}"
        lines.append("| " + " | ".join([
            r["arch"], r["shape"], pair(r["flops"], m["flops"],
                                        lambda x: f"{x:.4g}"),
            pair(r["state_bytes_per_device"], m["state_bytes_per_device"],
                 lambda x: f"{x / 1e9:.4g}"),
            pair(r["t_compute_s"], m["t_compute_s"], ms),
            pair(r["t_memory_s"], m["t_memory_s"], ms),
            pair(r["t_collective_s"], m["t_collective_s"], ms),
            pair(r["bottleneck"], m["bottleneck"], str)]) + " |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--md", action="store_true", default=True)
    ap.add_argument("--both-meshes", action="store_true",
                    help="one row per cell, 16x16 / 2x16x16 side by side")
    args = ap.parse_args(argv)
    if args.both_meshes:
        print(mesh_pairs_table(args.dir, args.tag))
        return
    recs = load(args.dir, args.mesh, args.tag)
    print(table(recs, md=args.md))
    ok = [r for r in recs if r.get("status") == "ok"]
    if ok:
        worst = min(ok, key=fraction)
        coll = max(ok, key=lambda r: r["t_collective_s"]
                   / max(r["t_compute_s"] + r["t_memory_s"], 1e-12))
        print(f"\nworst roofline fraction: {worst['arch']} {worst['shape']} "
              f"({fraction(worst):.4f})")
        print(f"most collective-bound:  {coll['arch']} {coll['shape']} "
              f"(t_coll {coll['t_collective_s']:.3g}s)")


if __name__ == "__main__":
    main()
