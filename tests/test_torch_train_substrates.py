"""The port's training substrates on the CPU: the checkpoint store, the
fault runtime, the host mesh and the sharding hooks (the cases of
``tests/test_substrates.py``), the train step against the reference's,
and ``python -m repro_torch.launch.train`` end to end.

A 3-step ``make_train_step`` run from the JAX weights and the same
pipeline batches matches ``repro.launch.steps.make_train_step``'s losses
within 2e-2 (the model's bar, ``tests/test_torch_train_model.py``; the
reference compiled with excess precision off, as there).
"""
import dataclasses
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
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import model as JM

from repro_torch import configs
from repro_torch.checkpoint.store import (AsyncCheckpointer, all_steps,
                                          latest_step, restore, save)
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.models.sharding_hooks import constrain, sharding_site_specs
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.fault import (StepFailure, StragglerMonitor, remesh,
                                       run_with_recovery)

ROOT = Path(__file__).resolve().parents[1]
LOSS_REL = 2e-2


class TestCheckpoint:
    def _state(self):
        return {"p": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "opt": {"m": torch.ones(4, dtype=torch.bfloat16),
                        "step": torch.tensor(7, dtype=torch.int32)},
                "host": np.arange(3, dtype=np.int64)}

    def test_roundtrip(self, tmp_path):
        d = str(tmp_path)
        save(d, 3, self._state(), extra={"arch": "x"})
        out, step, extra = restore(d, self._state())
        assert step == 3 and extra == {"arch": "x"}
        want = self._state()
        for a, b in ((out["p"], want["p"]), (out["opt"]["m"], want["opt"]["m"]),
                     (out["opt"]["step"], want["opt"]["step"])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        np.testing.assert_array_equal(out["host"], want["host"])

    def test_layout(self, tmp_path):
        """The reference's files; the manifest names each leaf."""
        import json
        d = str(tmp_path)
        path = save(d, 2, self._state())
        assert sorted(os.listdir(path)) == sorted(
            ["manifest.json"] + [f"arr_{i}.npy" for i in range(4)])
        with open(os.path.join(path, "manifest.json")) as f:
            man = json.load(f)
        assert man["names"] == ["host", "opt/m", "opt/step", "p"]
        assert man["dtypes"][1] == "bfloat16" and man["num_leaves"] == 4

    def test_retention_and_latest(self, tmp_path):
        d = str(tmp_path)
        for s in (1, 2, 3, 4, 5):
            save(d, s, self._state(), keep=2)
        assert sorted(all_steps(d)) == [4, 5]
        assert latest_step(d) == 5

    def test_tmp_dirs_never_restored(self, tmp_path):
        d = str(tmp_path)
        save(d, 1, self._state())
        os.makedirs(os.path.join(d, "step_9.tmp"))  # simulated crash
        assert latest_step(d) == 1

    def test_async(self, tmp_path):
        d = str(tmp_path)
        ck = AsyncCheckpointer(d)
        ck.save(11, self._state())
        ck.wait()
        assert latest_step(d) == 11

    def test_async_saves_the_state_as_it_was(self, tmp_path):
        """The port updates tensors in place: the checkpointer copies to
        the host before it returns, so a later update is not saved."""
        d = str(tmp_path)
        state = self._state()
        ck = AsyncCheckpointer(d)
        ck.save(1, state)
        state["p"].add_(100.0)
        ck.wait()
        out, _, _ = restore(d, self._state())
        assert torch.equal(out["p"], self._state()["p"])

    def test_restore_onto_a_device_and_structure_check(self, tmp_path):
        d = str(tmp_path)
        save(d, 1, self._state())
        out, _, _ = restore(d, self._state(), device="cpu")
        assert out["p"].device.type == "cpu"
        with pytest.raises(AssertionError):
            restore(d, {"p": torch.zeros(1)})


class TestFaultRuntime:
    def test_straggler_flags_outlier(self):
        m = StragglerMonitor(warmup=3)
        for i in range(10):
            m.observe(i, 0.1)
        assert not m.flagged
        assert m.observe(10, 1.0)
        assert m.flagged[0][0] == 10

    def test_recovery_retries_and_restores(self):
        calls = {"n": 0}

        def step(state, batch):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("boom")
            return state + batch
        out = run_with_recovery(step, 10, 5, restore_fn=lambda: 100)
        assert out == 105 and calls["n"] == 2

    def test_recovery_gives_up(self):
        def step(state, batch):
            raise RuntimeError("always")
        with pytest.raises(StepFailure):
            run_with_recovery(step, 0, 0, max_retries=2,
                              restore_fn=lambda: 0)

    def test_remesh_roundtrip(self):
        state = {"w": np.arange(8, dtype=np.float32), "s": np.int32(3)}
        out = remesh(state, "cpu")
        assert isinstance(out["w"], torch.Tensor)
        np.testing.assert_array_equal(out["w"].numpy(), state["w"])
        out = remesh(state, {"w": torch.device("cpu"), "s": "cpu"})
        assert int(out["s"]) == 3


def test_host_mesh_and_axes():
    mesh = MESH.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert MESH.dp_axes(mesh) == ("data",)
    assert MESH.axis_size(mesh, "model") == 1
    assert MESH.axis_size(mesh, "pod") == 1
    with pytest.raises(ValueError):
        MESH.make_host_mesh(model=2, device="cpu")


def test_sharding_hooks():
    x = torch.ones(2)
    assert constrain(x, "logits") is x
    with sharding_site_specs({"logits": lambda t: t * 2}):
        assert torch.equal(constrain(x, "logits"), x * 2)
        assert constrain(x, "pre_logits") is x
    assert constrain(x, "logits") is x


def test_train_steps_match_jax():
    """Three steps of ``make_train_step`` from the JAX weights on the
    reference pipeline's batches: the losses, gradient norms and final
    parameters against ``repro.launch.steps.make_train_step``."""
    arch = "qwen3-4b"
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    opt_kw = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jp)
    jopt = J.init_opt_state(jp, J.OptConfig(**opt_kw))
    jstep = jax.jit(j_make_train_step(jcfg, J.OptConfig(**opt_kw)))
    pipe = JPipeline(jcfg, 2, 64, seed=5)
    batches = [pipe.batch_at(s) for s in range(3)]
    jstep = jstep.lower(jp, jopt, batches[0]).compile(
        compiler_options={"xla_allow_excess_precision": False})
    model = M.params_from_jax(tree, cfg, device="cpu")
    opt_cfg = OptConfig(**opt_kw)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    tpipe = TokenPipeline(cfg, 2, 64, seed=5)
    for s, batch in enumerate(batches):
        np.testing.assert_array_equal(tpipe.batch_at(s)["tokens"],
                                      batch["tokens"])
        jp, jopt, jm = jstep(jp, jopt, batch)
        model, opt, tm = step(model, opt, batch)
        loss_err = abs(float(tm["loss"]) - float(jm["loss"])) / float(
            jm["loss"])
        norm_err = abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
            / float(jm["grad_norm"])
        print(f"step {s}: loss {float(tm['loss']):.6f} vs "
              f"{float(jm['loss']):.6f} ({loss_err:.2e}), grad norm "
              f"{norm_err:.2e}")
        assert loss_err <= LOSS_REL and norm_err <= LOSS_REL
        assert int(opt["step"]) == int(jopt["step"]) == s + 1
    got = M.params_to_numpy(model)
    errs = jax.tree_util.tree_map(
        lambda g, w: float(np.linalg.norm(g - np.asarray(w))
                           / np.linalg.norm(np.asarray(w))), got, jp)
    assert max(jax.tree_util.tree_leaves(errs)) <= LOSS_REL


def test_bf16_gradients_step():
    """``grad_dtype="bfloat16"``: the optimizer takes bf16 gradients."""
    cfg = configs.get_reduced("llama3-405b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = OptConfig(warmup_steps=1, total_steps=2)
    opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg, grad_dtype="bfloat16")
    batch = TokenPipeline(cfg, 2, 32).batch_at(0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model, opt, metrics = step(model, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(before[n], p)
               for n, p in model.named_parameters())
    assert all(p.grad is None for p in model.parameters())


def _main(*argv):
    return train.main(["--device", "cpu", "--batch", "2", "--seq", "32",
                       "--log-every", "1", *argv])


def test_train_main_recovers_and_resumes(tmp_path, capsys):
    """A failure injected at step 2 with a checkpoint every step replays
    the step from the committed host copy: the failure-free run's losses,
    bit for bit. A run that finds a checkpoint resumes from it."""
    clean = _main("--steps", "6")
    d = str(tmp_path / "ckpt")
    failed = _main("--steps", "6", "--ckpt-dir", d, "--ckpt-every", "1",
                   "--inject-failure-at", "2")
    assert failed == clean
    assert sorted(all_steps(d)) == [4, 5, 6]
    for s in (5, 6):
        os.rename(os.path.join(d, f"step_{s}"), os.path.join(d, f"x_{s}"))
    resumed = _main("--steps", "6", "--ckpt-dir", d)
    assert resumed == clean[4:]
    out = capsys.readouterr().out
    assert "restored from step 4" in out and "final loss" in out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_main_every_config(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch>`` (reduced, the
    default) takes two steps of every config on the CPU: the family's
    pipeline batch, finite losses."""
    losses = _main("--arch", arch, "--steps", "2")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert f"arch={configs.get_reduced(arch).name}" in capsys.readouterr().out


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_pipeline_matches_batch_specs(arch):
    """Each family's pipeline batch has the shapes and dtypes of the
    reference's ``launch.steps.batch_specs`` (tokens; the VLM's text
    tokens after its patches; the enc-dec's frames and decoder
    tokens)."""
    from repro.launch.steps import batch_specs
    from repro.models.config import ShapeSpec
    shape = ShapeSpec("train", 48, 2, "train")
    want = batch_specs(jconfigs.get_reduced(arch), shape)
    got = TokenPipeline(configs.get_reduced(arch), 2, 48).batch_at(0)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k].shape == spec.shape and got[k].dtype == spec.dtype, k


def test_training_imports_no_jax():
    """``repro_torch.launch.train`` and the modules it brings (optim,
    checkpoint, data, runtime.fault) run a training, and a step of each
    family beyond the dense one (MoE, SSM, hybrid, VLM, audio enc-dec),
    without loading ``jax`` or the JAX package."""
    code = textwrap.dedent("""
        import sys, tempfile
        import repro_torch.checkpoint.store
        import repro_torch.data.pipeline
        import repro_torch.optim
        import repro_torch.runtime.fault
        from repro_torch.launch import train
        with tempfile.TemporaryDirectory() as d:
            train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--ckpt-dir", d, "--ckpt-every", "1"])
        for arch in ("deepseek-moe-16b", "mamba2-370m", "jamba-v0.1-52b",
                     "internvl2-26b", "seamless-m4t-large-v2"):
            train.main(["--arch", arch, "--device", "cpu", "--steps", "1",
                        "--batch", "2", "--seq", "32"])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "repro" or m.startswith("repro."))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout


def test_reduced_dense_configs_train():
    """Every dense reduced config takes a step with a finite loss and a
    gradient for every parameter (the step raises otherwise)."""
    for arch in ("llama3-405b", "phi4-mini-3.8b", "nemotron-4-15b"):
        cfg = dataclasses.replace(configs.get_reduced(arch), num_layers=1)
        model = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        opt_cfg = OptConfig(warmup_steps=1, total_steps=1)
        opt = init_opt_state(dict(model.named_parameters()), opt_cfg)
        _, _, metrics = make_train_step(cfg, opt_cfg)(
            model, opt, TokenPipeline(cfg, 2, 16).batch_at(0))
        assert np.isfinite(float(metrics["loss"]))
