"""The port's twins of the last two reference examples on the CPU:
``examples/torch_train_lm.py`` (``examples/train_lm.py``: a ~100M qwen3
config, checkpoints, an injected failure) and
``examples/torch_serve_two_tier.py`` (``examples/serve_two_tier.py``:
ETICA's two-tier KV manager against global LRU).

The 100M config equals the reference's field by field; its first three
training losses, cut to 2 layers at full width, are within 2e-2 of the
reference's ``make_train_step`` (the model's bar,
``tests/test_torch_train_model.py``); recovery goes back to the last
committed state in both packages, bit for bit against a step from the
checkpoint on disk; serving's statistics equal the reference's.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as J
from repro.checkpoint.store import restore as jrestore
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model as JM

from repro_torch import configs
from repro_torch.checkpoint.store import all_steps, restore
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state

from train_parity import LOSS_REL, NO_EXCESS

ROOT = Path(__file__).resolve().parents[1]
EXAMPLE_OPT = dict(lr=3e-4, total_steps=300, warmup_steps=30)


def example(name: str):
    """``examples/<name>.py`` as a module."""
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def reference_100m():
    """``examples/train_lm.py``'s config, rebuilt from the reference's
    qwen3-4b config as that example builds it."""
    import repro.configs.qwen3_4b as q
    return dataclasses.replace(
        q.CONFIG, name="qwen3-100m", num_layers=8, d_model=768,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2304,
        vocab_size=32768)


def test_config_equals_reference():
    cfg, ref = example("torch_train_lm").qwen3_100m(), reference_100m()
    got, want = dataclasses.asdict(cfg), dataclasses.asdict(ref)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert cfg.param_counts() == ref.param_counts()
    assert round(cfg.param_counts()[0] / 1e6, 1) == 105.4


def test_first_losses_match_reference():
    """The 100M config cut to 2 layers, at full width and vocabulary,
    from the reference's weights, with the example's optimizer settings:
    3 steps of B 2 x 64 within 2e-2 of the reference's losses."""
    jcfg = dataclasses.replace(reference_100m(), num_layers=2)
    cfg = dataclasses.replace(example("torch_train_lm").qwen3_100m(),
                              num_layers=2)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    jopt = J.init_opt_state(jp, J.OptConfig(**EXAMPLE_OPT))
    batches = [JPipeline(jcfg, 2, 64).batch_at(s) for s in range(3)]
    jstep = jax.jit(j_make_train_step(jcfg, J.OptConfig(**EXAMPLE_OPT)))
    jstep = jstep.lower(jp, jopt, batches[0]).compile(
        compiler_options=NO_EXCESS)
    model = M.params_from_jax(tree, cfg, device="cpu")
    opt_cfg = OptConfig(**EXAMPLE_OPT)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    pipe = TokenPipeline(cfg, 2, 64)
    for s, batch in enumerate(batches):
        np.testing.assert_array_equal(pipe.batch_at(s)["tokens"],
                                      batch["tokens"])
        jp, jopt, jm = jstep(jp, jopt, batch)
        model, opt, tm = step(model, opt, batch)
        err = abs(float(tm["loss"]) - float(jm["loss"])) / float(jm["loss"])
        print(f"step {s}: loss {float(tm['loss']):.6f} vs "
              f"{float(jm['loss']):.6f} ({err:.2e})")
        assert err <= LOSS_REL


def test_run_rolls_back_to_the_initial_state(tmp_path):
    """``run`` of the 2-layer cut for 4 steps: the failure at step 2 comes
    before any commit, so step 2 runs from the initial state, bit for
    bit; the registry is restored afterwards."""
    mod = example("torch_train_lm")
    get_orig = configs.get_reduced
    cfg = dataclasses.replace(mod.qwen3_100m(), num_layers=2)
    losses = mod.run(cfg, 4, str(tmp_path / "ckpt"), "cpu")
    assert configs.get_reduced is get_orig
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert all_steps(str(tmp_path / "ckpt")) == []
    model = M.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    opt_cfg = OptConfig(lr=3e-4, total_steps=4, warmup_steps=1)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    batch = TokenPipeline(cfg, mod.BATCH, mod.SEQ).batch_at(2)
    _, _, metrics = make_train_step(cfg, opt_cfg)(model, opt, batch)
    assert losses[2] == float(metrics["loss"])


ROLLBACK_ARGV = ["--steps", "6", "--batch", "2", "--seq", "32",
                 "--log-every", "1"]
ROLLBACK_OPT = dict(lr=3e-4, total_steps=6, warmup_steps=1)


def torch_step_from_disk(d, step, at):
    cfg = configs.get_reduced("qwen3-4b")
    model = M.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    params = dict(model.named_parameters())
    opt_cfg = OptConfig(**ROLLBACK_OPT)
    opt = init_opt_state(params, opt_cfg)
    saved, got, _ = restore(d, (params, opt), step=step)
    assert got == step
    train.copy_into((params, opt), saved)
    batch = TokenPipeline(cfg, 2, 32).batch_at(at)
    _, _, metrics = make_train_step(cfg, opt_cfg)(model, opt, batch)
    return float(metrics["loss"])


def jax_step_from_disk(d, step, at):
    cfg = jconfigs.get_reduced("qwen3-4b")
    opt_cfg = J.OptConfig(**ROLLBACK_OPT)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    like = (params, J.init_opt_state(params, opt_cfg))
    (p, o), got, _ = jrestore(d, like, step=step)
    assert got == step
    step_fn = jax.jit(j_make_train_step(cfg, opt_cfg),
                      donate_argnums=(0, 1))
    _, _, metrics = step_fn(p, o, JPipeline(cfg, 2, 32).batch_at(at))
    return float(metrics["loss"])


@pytest.mark.parametrize("package", ["torch", "jax"])
def test_rollback_to_last_commit(package, tmp_path):
    """Reduced qwen3, 6 steps, a checkpoint every 2, a failure at step 3:
    the steps before the failure are the failure-free run's, and step 3
    is one step on ``batch_at(3)`` from ``step_2`` restored from disk
    (step 2's update is lost), bit for bit, in each package through its
    own ``restore``."""
    if package == "torch":
        main, argv, from_disk = train.main, ["--device", "cpu"], \
            torch_step_from_disk
    else:
        main, argv, from_disk = jtrain.main, [], jax_step_from_disk
    d = str(tmp_path / "ckpt")
    clean = main(ROLLBACK_ARGV + argv)
    failed = main(ROLLBACK_ARGV + argv + [
        "--ckpt-dir", d, "--ckpt-every", "2", "--inject-failure-at", "3"])
    assert failed[:3] == clean[:3]
    assert failed[3] != clean[3]
    assert failed[3] == from_disk(d, 2, 3)


def test_serving_equals_reference(capsys):
    """Both managers' statistics and the host-DMA write reduction equal
    the reference's ``serve.main`` on the example's argv."""
    mod = example("torch_serve_two_tier")
    etica, lru, reduction = mod.main(["--device", "cpu"])
    want = [jserve.main(["--manager", m, *mod.COMMON])
            for m in ("etica", "lru")]
    assert [etica, lru] == want
    assert reduction == 1 - want[0]["dma_write_bytes"] / max(
        want[1]["dma_write_bytes"], 1)
    assert f"{reduction:.1%}" == "49.0%"
    assert "host-DMA write reduction: 49.0%" in capsys.readouterr().out


def test_examples_import_no_jax():
    """Loading both examples loads no ``jax*`` and no ``repro.*``
    module."""
    code = textwrap.dedent(f"""
        import importlib.util, sys
        for name in ("torch_train_lm", "torch_serve_two_tier"):
            spec = importlib.util.spec_from_file_location(
                name, {str(ROOT / "examples")!r} + f"/{{name}}.py")
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def loss_curves(layers: int, steps: int, batch: int = 4, seq: int = 256):
    """The example's config cut to ``layers`` layers, at full width and
    vocabulary, trained ``steps`` steps of B ``batch`` x ``seq`` with the
    example's optimizer schedule (warmup ``steps // 10``, no failure) by
    both packages from the reference's weights: ``(reference losses,
    port losses)``."""
    jcfg = dataclasses.replace(reference_100m(), num_layers=layers)
    cfg = dataclasses.replace(example("torch_train_lm").qwen3_100m(),
                              num_layers=layers)
    opt_kw = dict(lr=3e-4, total_steps=steps,
                  warmup_steps=max(steps // 10, 1))
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    jopt = J.init_opt_state(jp, J.OptConfig(**opt_kw))
    jstep = jax.jit(j_make_train_step(jcfg, J.OptConfig(**opt_kw)),
                    donate_argnums=(0, 1))
    model = M.params_from_jax(tree, cfg, device="cpu")
    opt_cfg = OptConfig(**opt_kw)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    pipe = JPipeline(jcfg, batch, seq)
    ref, port = [], []
    for s in range(steps):
        batch_s = pipe.batch_at(s)
        jp, jopt, jm = jstep(jp, jopt, batch_s)
        model, opt, tm = step(model, opt, batch_s)
        ref.append(float(jm["loss"]))
        port.append(float(tm["loss"]))
        if s % 20 == 0 or s == steps - 1:
            print(f"step {s}: reference {ref[-1]:.6f} port {port[-1]:.6f}",
                  flush=True)
    return ref, port


if __name__ == "__main__":
    # the loss curves of both packages over the example's schedule at a
    # cut depth, and the drop chip_smoke.py phase 19 (b) reads:
    #     PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_examples.py \
    #         [LAYERS [STEPS]]
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 300
    for name, losses in zip(("reference", "port"),
                            loss_curves(layers, steps)):
        first, last = np.mean(losses[:5]), np.mean(losses[-20:])
        print(f"{name}: {layers} layers, {steps} steps: first 5 mean "
              f"{first:.6f}, last 20 mean {last:.6f}, drop {first - last:.6f}"
              f", lowest from step 30 {min(losses[30:]):.6f}, last "
              f"{losses[-1]:.6f}")
