"""End-to-end training entry point (the port of :mod:`repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        [--inject-failure-at 20] [--device cpu]

Wires together the model, AdamW, the deterministic data pipeline, async
atomic checkpointing, straggler monitoring and bounded-retry recovery
with exact replay. Runs on the card unless ``--device cpu``: every
layer's attention goes through the ``flash_attention`` kernel forward
and the ``flash_attention_bwd`` kernel backward. Every config trains
(``--arch`` of any family, reduced or ``--full``); the pipeline gives
each family its batch (tokens; the VLM's patches; the enc-dec's frames
and decoder tokens).

The optimizer updates the live tensors in place, so the committed state
that recovery goes back to is a host copy, and restoring it copies it
back into the live tensors (a failed step may have left them half
updated).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch._tree import named_leaves
from repro_torch.checkpoint.store import AsyncCheckpointer, latest_step, \
    restore
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.fault import StragglerMonitor, run_with_recovery


@torch.no_grad()
def copy_into(state, values) -> None:
    """Copy ``values`` (a host or device state of the same structure)
    into the tensors of ``state``."""
    for (_, dst), (_, src) in zip(named_leaves(state), named_leaves(values)):
        dst.copy_(torch.as_tensor(src))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get(args.arch))
    opt_cfg = OptConfig(lr=args.lr, total_steps=args.steps,
                        warmup_steps=max(args.steps // 10, 1))
    mesh = make_host_mesh(device=dev)
    print(f"arch={cfg.name} mesh={dict(mesh.shape)} "
          f"params~{cfg.param_counts()[0]/1e6:.1f}M")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = M.init_params(cfg, gen, dev)
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params, opt_cfg)
    start_step = 0

    ckpt = AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and latest_step(args.ckpt_dir) is not None:
        saved, start_step, _ = restore(args.ckpt_dir, (params, opt_state))
        copy_into((params, opt_state), saved)
        print(f"restored from step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed)
    monitor = StragglerMonitor()

    def snapshot(state):
        # a host copy: the optimizer updates the live tensors in place
        return [leaf.detach().to("cpu", copy=True)
                for _, leaf in named_leaves(state)]

    def restore_committed():
        copy_into((params, opt_state), committed)
        return model, opt_state

    committed = snapshot((params, opt_state))
    failed_once = False
    losses = []

    for step in range(start_step, args.steps):
        batch = pipe.batch_at(step)
        t0 = time.time()

        def thunk(state, b):
            nonlocal failed_once
            if step == args.inject_failure_at and not failed_once:
                failed_once = True
                raise RuntimeError("injected device failure")
            p, o = state
            return step_fn(p, o, b)

        model, opt_state, metrics = run_with_recovery(
            thunk, (model, opt_state), batch,
            restore_fn=restore_committed)
        loss = float(metrics["loss"])       # waits for the step
        dt = time.time() - t0
        straggler = monitor.observe(step, dt)
        losses.append(loss)
        if step % args.log_every == 0 or straggler:
            flag = " STRAGGLER" if straggler else ""
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"{dt*1e3:7.1f}ms{flag}")
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
            committed = snapshot((params, opt_state))
    if ckpt:
        ckpt.wait()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"stragglers flagged: {len(monitor.flagged)}")
    assert np.isfinite(losses[-1])
    return losses


if __name__ == "__main__":
    main()
