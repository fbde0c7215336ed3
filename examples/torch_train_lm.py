#!/usr/bin/env python3
"""End-to-end training on the PyTorch port: a ~100M-parameter
qwen3-family model for a few hundred steps with checkpointing, failure
injection and recovery.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
        [--ckpt-dir DIR] [--device cpu]

The twin of ``examples/train_lm.py``: the same config and flags, through
``repro_torch.launch.train.main`` (the pipeline, the train step with
``flash_attention`` forward and ``flash_attention_bwd`` backward on the
card, AdamW, async atomic checkpoints every 100 steps, a failure
injected halfway and bounded-retry recovery). Runs on the card unless
``--device cpu``.

The pipeline draws fresh uniform tokens every step, so the loss can fall
from about 10.8 (random logits) to ln 32,768 = 10.397 and no lower.

Recovery goes back to the last checkpoint, not to the step before the
failure: with the failure at 150 and checkpoints every 100, the run
retries step 150 from step 100's state, and steps 100-149's updates are
lost. A checkpoint directory that already holds ``step_<steps>`` makes
``main`` restore it and run no step, which fails: a second run needs
the old directory removed or another ``--ckpt-dir``.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro_torch import configs  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402

BATCH, SEQ = 4, 256
CKPT_EVERY = 100


def qwen3_100m():
    """The ~100M-parameter qwen3-family config of ``examples/train_lm.py``
    (8 layers, 768 wide, 12 query / 4 KV heads of 64, d_ff 2,304, a
    32,768-word vocabulary)."""
    import repro_torch.configs.qwen3_4b as q
    return dataclasses.replace(
        q.CONFIG, name="qwen3-100m", num_layers=8, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2304,
        vocab_size=32768)


def run(cfg, steps: int, ckpt_dir: str, device: str = "cuda") -> list:
    """Train ``cfg`` (``configs.get_reduced`` answers its name for the
    run and is restored afterwards) for ``steps`` steps at B 4 x 256 with
    the example's checkpoints and injected failure; returns the
    losses."""
    get_orig = configs.get_reduced
    configs.get_reduced = lambda a: cfg if a == cfg.name else get_orig(a)
    try:
        return train_main([
            "--arch", cfg.name, "--steps", str(steps),
            "--batch", str(BATCH), "--seq", str(SEQ),
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(CKPT_EVERY),
            "--inject-failure-at", str(steps // 2),
            "--log-every", "20", "--device", device])
    finally:
        configs.get_reduced = get_orig


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default="/tmp/etica_torch_train_lm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = qwen3_100m()
    total, _ = cfg.param_counts()
    print(f"training {cfg.name}: {total/1e6:.0f}M params")
    losses = run(cfg, args.steps, args.ckpt_dir, args.device)
    assert losses[-1] < losses[0], "loss did not improve"
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} "
          f"steps")
    return losses


if __name__ == "__main__":
    main()
