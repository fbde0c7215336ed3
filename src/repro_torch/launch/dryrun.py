"""Dry-run of the distribution plan on Hopper: every (arch x shape x mesh)
cell's step on the ``meta`` device, set against an H100 roofline (the
port of :mod:`repro.launch.dryrun`).

The reference lowers and compiles each cell's step for 256 or 512
placeholder XLA devices. A PyTorch program has no compiler to ask and
one card cannot hold those meshes, so a cell here:

  1. takes the production mesh's axes without devices
     (:func:`repro_torch.launch.mesh.abstract_production_mesh`);
  2. builds the step the shape's kind implies on its abstract inputs
     (:func:`repro_torch.launch.steps.input_specs`: the model, moments,
     batch or cache on ``meta``) and runs it there, under
     ``torch.utils.flop_counter.FlopCounterMode`` (the attention
     kernels' FLOPs come from their wrappers' ``meta`` routes; the
     backward and the checkpointed superlayers' recompute are counted)
     and a counter of the bytes each op reads and writes (views
     excluded: the eager program's memory traffic, an upper bound of a
     fused one). Success shows the step runs at that size;
  3. computes per-device state bytes from the sharding rules
     (:mod:`repro_torch.launch.sharding`) by the reference's
     ``_sharded_bytes`` rule, and the collective bytes a device moves,
     analytically from the same specs: the gradient all-reduce over the
     data axes, FSDP's weight gathers and gradient reduce-scatters,
     ZeRO-1's reduce-scatter to the moment shards and gather of the
     updated parameters, the tensor-parallel all-reduce after each
     row-parallel product (``wo``, ``w_down``, ``out_proj``) and the
     expert-parallel all-to-all of MoE dispatch and combine (the
     embeddings' and the loss's small reductions are not counted);
  4. divides the step's FLOPs and bytes over the devices that share
     the work (the batch's shards times the ``'model'`` axis: a batch
     too small to split is computed by every data replica) and sets
     them against :data:`HW`, the H100 SXM's datasheet rates: compute,
     memory and collective time a device and the bottleneck;
  5. writes one JSON record (the reference's keys where they mean the
     same, ``device: "H100 SXM (datasheet)"``).

Both meshes of an (arch, shape) share one trace in a process: the
step's global FLOPs and bytes do not depend on the mesh.

``--profile`` runs the cell's step on the card at a cut that fits it
(``--layers``, ``--batch``, ``--seq``; listed in the record's
``reduced``) and records its measured device time by kernel group
(:mod:`repro_torch.launch.trace_analysis`) beside the roofline terms of
the same cut on one device. The reference's ``--sites`` (explicit
activation shardings) and ``--census`` (an HLO byte census) are
XLA-only and have no counterpart here.

``--bf16-params`` is the reference's serving lever: every float32
parameter becomes bfloat16 before anything is counted (the moments,
batch and cache keep their dtypes), so the state bytes, the
weight-moving collectives, the ``meta`` trace's bytes and the roofline
follow from the cast model, and the record carries ``"bf16_params":
true``. With ``--profile`` the cut's model on the card is cast the same
way.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k [--multi-pod] [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list   # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape train_4k --profile --layers 8 --batch 2 --seq 2048
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b \\
      --shape prefill_32k --bf16-params [--profile --batch 1]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback

# H100 SXM5 80 GB, NVIDIA datasheet figures (per device)
HW = {
    "peak_flops_bf16": 989e12,   # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,           # HBM3 bytes/s
    "nvlink_bw": 450e9,          # NVLink 4, bytes/s in one direction
}
DEVICE = "H100 SXM (datasheet)"

_TRACES: dict = {}


def _bytes_of(t) -> int:
    """Bytes a tensor's elements occupy (a broadcast dimension counts
    once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size()


def _byte_mode():
    """A dispatch mode that sums the bytes every op reads and writes
    (tensor operands and results; view ops, which move nothing, and
    allocations, which read nothing, excluded)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class ByteCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            rets = func._schema.returns
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in rets)
            if not view and not func._schema.name.startswith(
                    ("aten::empty", "aten::new_empty")):
                self.total += sum(_bytes_of(t) for t in tree_leaves(
                    (args, kwargs, out)) if isinstance(t, torch.Tensor))
            return out
    return ByteCounter()


def _run_step(cfg, shape, specs, grad_dtype):
    from repro_torch.launch import steps as ST
    if shape.kind == "train":
        ST.make_train_step(cfg, grad_dtype=grad_dtype)(
            specs["params"], specs["opt_state"], specs["batch"])
    elif shape.kind == "prefill":
        ST.make_prefill_step(cfg, ST.cache_len_for(cfg, shape))(
            specs["params"], specs["batch"])
    else:           # decode at a full cache: the last slot's position
        ST.make_decode_step(cfg)(specs["params"], specs["cache"],
                                 specs["tokens"],
                                 ST.cache_len_for(cfg, shape) - 1)


def trace_step(cfg, shape, grad_dtype: str | None = None,
               bf16_params: bool = False) -> dict:
    """The step of ``(cfg, shape)`` run once on ``meta``: ``{"specs",
    "flops", "flop_counts", "bytes", "trace_s"}`` (global counts),
    cached for the process; ``bf16_params`` runs it on the model with
    its float32 parameters cast to bfloat16."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import steps as ST
    key = (cfg, shape, grad_dtype, bf16_params)
    if key not in _TRACES:
        t0 = time.time()
        specs = ST.input_specs(cfg, shape, bf16_params=bf16_params)
        flops = FlopCounterMode(display=False)
        nbytes = _byte_mode()
        with flops, nbytes:
            _run_step(cfg, shape, specs, grad_dtype)
        counts = {str(op): int(n) for op, n in
                  flops.get_flop_counts().get("Global", {}).items()}
        _TRACES[key] = dict(specs=ST.reference_specs(specs),
                            flops=float(flops.get_total_flops()),
                            flop_counts=counts, bytes=float(nbytes.total),
                            trace_s=time.time() - t0)
    return _TRACES[key]


def _sharded_bytes(tree, spec_of, mesh) -> int:
    """Per-device bytes of ``tree``'s leaves, each divided by the shards
    of its spec (``spec_of(path, leaf)``), as the reference counts."""
    from repro_torch._tree import named_leaves
    from repro_torch.launch.sharding import shards
    return sum(t.numel() * t.element_size() // shards(spec_of(p, t), mesh)
               for p, t in named_leaves(tree))


def state_bytes(cfg, shape, mesh, specs) -> int:
    """Per-device bytes of the step's state, the reference dry-run's
    sum: the parameters, and the AdamW moments (ZeRO-1 specs) for
    training or the cache for decode. ``specs``: the reference-layout
    trees (:func:`repro_torch.launch.steps.reference_specs`)."""
    from repro_torch.launch import sharding as SH
    fsdp = SH.should_fsdp(cfg, mesh)
    total = _sharded_bytes(specs["params"], lambda p, t: SH.param_spec(
        p, t.shape, cfg, mesh, fsdp), mesh)
    if shape.kind == "train":
        for k in ("m", "v"):
            total += _sharded_bytes(specs["opt_state"][k], lambda p, t:
                                    SH.param_spec(p, t.shape, cfg, mesh,
                                                  True), mesh)
    elif shape.kind == "decode":
        total += _sharded_bytes(specs["cache"], lambda p, t:
                                SH.cache_leaf_spec(p, t.shape, mesh), mesh)
    return int(total)


def _axes(spec) -> set:
    out = set()
    for s in spec:
        if s is not None:
            out.update(s if isinstance(s, tuple) else (s,))
    return out


def collective_bytes(cfg, shape, mesh, specs, fsdp: bool,
                     grad_dtype: str | None = None) -> dict[str, float]:
    """Bytes one device sends in each kind of collective during one step,
    from the specs (ring algorithms: an all-reduce of ``x`` bytes over
    ``n`` devices moves ``2 (n - 1) / n x``, a reduce-scatter or an
    all-gather ``(n - 1) / n`` of the unsharded size)."""
    import torch
    from repro_torch._tree import named_leaves
    from repro_torch.launch.mesh import axis_size, dp_axes
    from repro_torch.launch.sharding import batch_sharding, param_spec, \
        shards
    train = shape.kind == "train"
    n_dp = math.prod(axis_size(mesh, a) for a in dp_axes(mesh))
    d, m = axis_size(mesh, "data"), axis_size(mesh, "model")
    out = {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0}
    g_item = torch.empty((), dtype=getattr(torch, grad_dtype)).element_size() \
        if grad_dtype else None
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    tok_dev = tokens / shards(batch_sharding((shape.global_batch,), mesh),
                              mesh)
    passes = 3 if train else 1        # forward, recompute, backward
    for path, leaf in named_leaves(specs["params"]):
        spec = param_spec(path, leaf.shape, cfg, mesh, fsdp)
        elems = leaf.numel() / shards(spec, mesh)
        pbytes = elems * leaf.element_size()
        gbytes = elems * (g_item or leaf.element_size())
        names = path.split("/")
        reps = leaf.shape[0] if "layers" in names else 1
        if "data" in _axes(spec):               # FSDP
            out["all-gather"] += (2 if train else 1) * (d - 1) * pbytes
            if train:
                out["reduce-scatter"] += (d - 1) * gbytes
                o = n_dp // d
                out["all-reduce"] += 2 * (o - 1) / o * gbytes
        elif train:
            mspec = param_spec(path, leaf.shape, cfg, mesh, True)
            k = shards(mspec, mesh) // shards(spec, mesh)
            if k > 1:                           # ZeRO-1 moments
                out["reduce-scatter"] += (k - 1) / k * gbytes
                out["all-gather"] += (k - 1) / k * pbytes
                o = n_dp // k
                out["all-reduce"] += 2 * (o - 1) / o * gbytes / k
            else:
                out["all-reduce"] += 2 * (n_dp - 1) / n_dp * gbytes
        site = names[-2] if names[-1] == "w" else names[-1]
        off = 1 if "layers" in names else 0
        if m > 1 and site in ("wo", "w_down", "out_proj") \
                and len(spec) > off and spec[off] == "model" \
                and leaf.dim() - off == 2:
            # row-parallel product: its [tokens, d_out] bf16 partial sums
            act = tok_dev * leaf.shape[-1] * 2
            out["all-reduce"] += reps * passes * 2 * (m - 1) / m * act
        if m > 1 and names[-1] == "w_down" and leaf.dim() - off == 3 \
                and spec[off] == "model":
            # expert parallel: each token's top-k rows out and back
            act = tok_dev * cfg.moe_top_k * cfg.d_model * 2
            out["all-to-all"] += reps * passes * 2 * (m - 1) / m * act
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None,
             grad_dtype: str | None = None,
             bf16_params: bool = False) -> dict:
    from repro_torch import configs
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import abstract_production_mesh
    from repro_torch.models.config import SHAPES, shape_applicable

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    mesh = abstract_production_mesh(multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "2x16x16" if multi_pod else "16x16",
                 "chips": mesh.size, "kind": shape.kind, "device": DEVICE}
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec
    if grad_dtype:
        rec["grad_dtype"] = grad_dtype
    if bf16_params:
        # serving lever: weights pre-cast to bf16 at load time
        rec["bf16_params"] = True
    tr = trace_step(cfg, shape, grad_dtype if shape.kind == "train"
                    else None, bf16_params)
    specs = tr["specs"]
    fsdp = SH.should_fsdp(cfg, mesh)
    rec["fsdp"] = fsdp
    rec["trace_s"] = round(tr["trace_s"], 2)

    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    rec["model_flops"] = cfg.model_flops(tokens,
                                         decode=shape.kind != "train")
    rec["state_bytes_per_device"] = state_bytes(cfg, shape, mesh, specs)

    coll = collective_bytes(cfg, shape, mesh, specs, fsdp, grad_dtype)
    rec["collectives"] = {k: v for k, v in coll.items() if v}
    rec["collective_bytes_per_device"] = sum(coll.values())
    rec["collective_bytes"] = rec["collective_bytes_per_device"] * mesh.size
    # the devices that share the step's work: batch shards x 'model'
    split = SH.shards(SH.batch_sharding((shape.global_batch,), mesh),
                      mesh) * mesh.shape["model"]
    rec["step_flops"] = tr["flops"]
    rec["flop_counts"] = tr["flop_counts"]
    rec["flops_per_device"] = tr["flops"] / split
    rec["flops"] = rec["flops_per_device"] * mesh.size
    rec["bytes_per_device"] = tr["bytes"] / split
    rec["bytes"] = rec["bytes_per_device"] * mesh.size
    rec.update(roofline(rec["flops_per_device"], rec["bytes_per_device"],
                        rec["collective_bytes_per_device"]))
    rec["useful_flops_ratio"] = (rec["model_flops"] / rec["flops"]
                                 if rec["flops"] else 0.0)
    rec["status"] = "ok"
    return rec


def roofline(flops: float, nbytes: float, coll_bytes: float) -> dict:
    """The three times of one device against :data:`HW`, and the
    largest."""
    t = {"t_compute_s": flops / HW["peak_flops_bf16"],
         "t_memory_s": nbytes / HW["hbm_bw"],
         "t_collective_s": coll_bytes / HW["nvlink_bw"]}
    names = {"t_compute_s": "compute", "t_memory_s": "memory",
             "t_collective_s": "collective"}
    return dict(t, bottleneck=names[max(t, key=t.get)])


def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def profile_cell(arch: str, shape_name: str, cut: dict,
                 overrides: dict | None = None, device="cuda",
                 steps: int = 3, bf16_params: bool = False) -> dict:
    """The cell's step on ``device`` at ``cut`` (``num_layers``,
    ``global_batch``, ``seq_len``; weights from a seeded generator, cast
    to bfloat16 with ``bf16_params``): host-clock ms of ``steps`` steps
    after a first and the kernels they launched, device ms by kernel
    group of one profiled step, and the roofline terms of the same cut
    on one device from its ``meta`` trace."""
    import torch
    from repro_torch import configs, kernels
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import resolve_device
    from repro_torch.launch import steps as ST
    from repro_torch.launch import trace_analysis
    from repro_torch.models import model as M
    from repro_torch.models.config import SHAPES
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if "num_layers" in cut:
        cfg = dataclasses.replace(cfg, num_layers=cut["num_layers"])
    shape = dataclasses.replace(
        shape, global_batch=cut.get("global_batch", shape.global_batch),
        seq_len=cut.get("seq_len", shape.seq_len))
    tr = trace_step(cfg, shape, bf16_params=bf16_params)
    rec = {"reduced": dict(cut), "kind": shape.kind,
           "step_flops": tr["flops"], "step_bytes": tr["bytes"],
           "roofline_one_device": roofline(tr["flops"], tr["bytes"], 0.0)}
    dev = resolve_device(device)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    if bf16_params:
        M.cast_params(model)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_cfg = OptConfig(lr=3e-4, warmup_steps=1, total_steps=steps + 2)
        opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in
                 TokenPipeline(cfg, b, s, seed=0).batch_at(0).items()}
        train_step = ST.make_train_step(cfg, opt_cfg)

        def fn():
            return train_step(model, opt, batch)
    elif shape.kind == "prefill":
        specs = ST.batch_specs(cfg, shape)
        gen = torch.Generator().manual_seed(0)
        batch = {k: (torch.randint(0, cfg.vocab_size, v.shape,
                                   generator=gen, dtype=torch.int32)
                     if v.dtype == torch.int32 else
                     torch.randn(v.shape, generator=gen)).to(dev)
                 for k, v in specs.items()}
        prefill = ST.make_prefill_step(cfg, ST.cache_len_for(cfg, shape))

        def fn():
            with torch.no_grad():
                return prefill(model, batch)
    else:
        clen = ST.cache_len_for(cfg, shape)
        cache = M.init_cache(cfg, b, clen, device=dev,
                             enc_len=ST.ENC_DECODE_LEN if cfg.is_encdec
                             else 0)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        decode = ST.make_decode_step(cfg)

        def fn():
            with torch.no_grad():
                return decode(model, cache, tokens, clen - 1)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fn()
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    sync()
    rec["step_ms"] = (time.perf_counter() - t0) / steps * 1e3
    rec["steps"] = steps
    rec["launches"] = {k: n for k, n in kernels.launch_counts().items()
                       if n}
    if dev.type == "cuda":
        dev_ms, events, groups = trace_analysis.grouped_profile(fn,
                                                                warm=False)
        rec.update(device_ms=dev_ms, device_events=events,
                   device_ms_by_group=groups,
                   peak_bytes=torch.cuda.max_memory_allocated(dev),
                   card=card_name_and_limit())
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=False)
    ap.add_argument("--shape", required=False)
    ap.add_argument("--cells", default="",
                    help="comma list of arch:shape cells run in this "
                         "process (in place of --arch and --shape; prints "
                         "a JSON list of the records)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both production meshes from one trace (prints "
                         "a JSON list of the records)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--list", action="store_true",
                    help="print all cells (arch shape) and exit")
    ap.add_argument("--override", default="",
                    help="comma list k=v ModelConfig overrides")
    ap.add_argument("--grad-dtype", default="",
                    help="cast grads before optimizer (e.g. bfloat16)")
    ap.add_argument("--bf16-params", action="store_true",
                    help="serve with bf16 weights (perf lever)")
    ap.add_argument("--profile", action="store_true",
                    help="also run the step on the card at the cut below")
    ap.add_argument("--layers", type=int, default=0,
                    help="--profile: layers of the cut (0: all)")
    ap.add_argument("--batch", type=int, default=0,
                    help="--profile: global batch of the cut (0: all)")
    ap.add_argument("--seq", type=int, default=0,
                    help="--profile: sequence length of the cut (0: all)")
    ap.add_argument("--device", default="cuda",
                    help="--profile: the device the cut runs on")
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.models.config import SHAPES

    if args.list:
        for a in configs.ARCH_IDS:
            for s in SHAPES:
                print(a, s)
        return 0

    overrides = {}
    for kv in filter(None, args.override.split(",")):
        k, v = kv.split("=")
        overrides[k] = type(getattr(configs.get(args.arch), k))(eval(v))

    pods = (False, True) if args.both_meshes else (args.multi_pod,)
    cells = ([tuple(c.split(":")) for c in args.cells.split(",")]
             if args.cells else [(args.arch, args.shape)])
    recs = [run_cell(arch, shape, pod, overrides,
                     grad_dtype=args.grad_dtype or None,
                     bf16_params=args.bf16_params)
            for arch, shape in cells for pod in pods]
    if args.profile and recs[0]["status"] == "ok":
        cut = {k: v for k, v in (("num_layers", args.layers),
                                 ("global_batch", args.batch),
                                 ("seq_len", args.seq)) if v}
        prof = profile_cell(args.arch, args.shape, cut, overrides,
                            device=args.device,
                            bf16_params=args.bf16_params)
        for rec in recs:
            rec["profile"] = prof
    os.makedirs(args.out, exist_ok=True)
    for rec in recs:
        name = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
                f"{args.tag}.json")
        path = os.path.join(args.out, name)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print("wrote", path, file=sys.stderr)
    print(json.dumps(recs if len(recs) > 1 else recs[0], indent=1))
    return 0 if all(r["status"] in ("ok", "skip") for r in recs) else 1

if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
