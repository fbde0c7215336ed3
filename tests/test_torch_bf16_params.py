"""The dry-run's bf16-weights lever (``--bf16-params``) against the JAX
package's (``repro.launch.dryrun.run_cell(..., bf16_params=True)``),
and ``roofline --md``:

  (1) per-device state bytes with the lever, every applicable (arch,
      shape) cell on both production meshes == the reference rule
      (``_sharded_bytes``) over the reference's specs with every float32
      parameter leaf cast to bfloat16 (the moments, batch and cache
      keep their dtypes), the shardings taken from the cast specs, as
      the reference's ``run_cell`` takes them;
  (2) on reduced qwen3 and reduced deepseek: a bf16 record's
      ``step_flops`` == the float32 record's; its eager bytes are
      lower (no ``dense`` rounds a float32 weight to bfloat16 any more;
      at a tiny batch a training step's are higher instead, AdamW
      reading the bf16 parameters as float32 and writing them back); the
      weight-moving collectives (FSDP and ZeRO-1 gathers, gradient
      reduce-scatters) exactly half, the gradient all-reduce that of
      float32 parameters with ``grad_dtype="bfloat16"``, the activation
      terms unchanged (also on full deepseek, which FSDP shards);
  (3) ``trace_step``'s cache keeps the two traces apart in one process;
  (4) the CLI in a subprocess: the record and its file under ``--tag``;
  (5) ``roofline --md`` is accepted;
  (6) the changed modules, in a fresh process, load no ``jax`` and no
      ``repro`` module.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models.config import SHAPES as JSHAPES, shape_applicable

from repro_torch import configs
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.models.config import SHAPES
from test_torch_dryrun import _reference_sharded_bytes

ROOT = Path(__file__).resolve().parent.parent


def _reference_bf16_state_bytes(arch, shape_name, multi_pod) -> int:
    """The reference dry-run's ``state_bytes_per_device`` with
    ``bf16_params``: its specs with the float32 parameter leaves cast to
    bfloat16 (``repro/launch/dryrun.py``'s cast), then its sum."""
    sharded = _reference_sharded_bytes()
    cfg, shape = jconfigs.get(arch), JSHAPES[shape_name]
    mesh = (jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
            if multi_pod else
            jax.sharding.AbstractMesh((16, 16), ("data", "model")))
    specs = JST.input_specs(cfg, shape)
    specs["params"] = jax.tree_util.tree_map(
        lambda s: (jax.ShapeDtypeStruct(s.shape, jnp.bfloat16)
                   if s.dtype == jnp.float32 else s), specs["params"])
    psh = JSH.param_shardings(cfg, specs["params"], mesh)
    total = sharded(specs["params"], psh)
    if shape.kind == "train":
        osh = JSH.opt_shardings(cfg, specs["params"], mesh)
        total += sharded(specs["opt_state"]["m"], osh["m"])
        total += sharded(specs["opt_state"]["v"], osh["v"])
    elif shape.kind == "decode":
        total += sharded(specs["cache"],
                         JSH.cache_shardings(specs["cache"], mesh))
    return total


def _specs(cfg, shape, bf16):
    return ST.reference_specs(ST.input_specs(cfg, shape, bf16_params=bf16))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_bf16_state_bytes_match_reference(arch):
    n = 0
    for name in JSHAPES:
        if not shape_applicable(jconfigs.get(arch), JSHAPES[name])[0]:
            continue
        cfg, shape = configs.get(arch), SHAPES[name]
        for multi_pod in (False, True):
            mesh = abstract_production_mesh(multi_pod)
            got = dryrun.state_bytes(cfg, shape, mesh,
                                     _specs(cfg, shape, True))
            assert got == _reference_bf16_state_bytes(arch, name,
                                                      multi_pod), (
                arch, name, multi_pod)
            assert got < dryrun.state_bytes(cfg, shape, mesh,
                                            _specs(cfg, shape, False))
            n += 1
    assert n >= 6


def _halved(bf, f32, kinds):
    for k in kinds:
        assert bf[k] == pytest.approx(f32[k] / 2, rel=1e-12), k


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_bf16_records_on_reduced_configs(arch, monkeypatch):
    """``run_cell`` on the reduced config at the three kinds' production
    shapes (16x16): the record, its FLOPs, bytes and collectives."""
    monkeypatch.setattr(configs, "get", configs.get_reduced)
    for name in ("prefill_32k", "decode_32k", "train_4k"):
        f32 = dryrun.run_cell(arch, name, False)
        bf = dryrun.run_cell(arch, name, False, bf16_params=True)
        assert bf["status"] == "ok" and bf["bf16_params"] is True
        assert "bf16_params" not in f32
        assert bf["step_flops"] == f32["step_flops"] > 0
        assert bf["flop_counts"] == f32["flop_counts"]
        assert bf["bytes"] < f32["bytes"]
        assert bf["state_bytes_per_device"] < f32["state_bytes_per_device"]
        cb, cf = bf["collectives"], f32["collectives"]
        if SHAPES[name].kind == "train":
            _halved(cb, cf, ("all-gather", "reduce-scatter"))
            g16 = dryrun.run_cell(arch, name, False, grad_dtype="bfloat16")
            assert cb["all-reduce"] == g16["collectives"]["all-reduce"]
            assert cf["all-reduce"] / 2 < cb["all-reduce"] < cf["all-reduce"]
        else:
            assert cb == cf      # no FSDP: only the activations' all-reduce
        assert bf["t_memory_s"] == pytest.approx(
            bf["bytes_per_device"] / dryrun.HW["hbm_bw"])


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k", "train_4k"])
def test_bf16_collectives_under_fsdp(name):
    """Full deepseek-moe-16b, which FSDP shards on 16x16: its weight
    gathers halve, the expert all-to-all and the row-parallel
    all-reduce do not."""
    cfg, shape = configs.get("deepseek-moe-16b"), SHAPES[name]
    mesh = abstract_production_mesh(False)
    fsdp = SH.should_fsdp(cfg, mesh)
    assert fsdp
    cf = dryrun.collective_bytes(cfg, shape, mesh, _specs(cfg, shape, False),
                                 fsdp)
    cb = dryrun.collective_bytes(cfg, shape, mesh, _specs(cfg, shape, True),
                                 fsdp)
    assert cf["all-gather"] > 0
    if shape.kind == "train":
        _halved(cb, cf, ("all-gather", "reduce-scatter"))
        cg = dryrun.collective_bytes(cfg, shape, mesh,
                                     _specs(cfg, shape, False), fsdp,
                                     "bfloat16")
        assert cb["all-reduce"] == cg["all-reduce"]
    else:
        _halved(cb, cf, ("all-gather",))
        assert cb["all-reduce"] == cf["all-reduce"]
    assert cb["all-to-all"] == cf["all-to-all"] > 0


def test_trace_cache_keeps_the_lever_apart():
    cfg = configs.get_reduced("qwen3-4b")
    shape = SHAPES["decode_32k"]
    f32 = dryrun.trace_step(cfg, shape)
    bf = dryrun.trace_step(cfg, shape, bf16_params=True)
    assert bf is not f32
    assert dryrun.trace_step(cfg, shape) is f32
    assert dryrun.trace_step(cfg, shape, bf16_params=True) is bf
    dtypes = lambda tr: {t.dtype for t in jax.tree_util.tree_leaves(
        tr["specs"]["params"])}
    assert dtypes(f32) == {torch.float32}
    assert dtypes(bf) == {torch.bfloat16}
    assert bf["flops"] == f32["flops"] and bf["bytes"] < f32["bytes"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    return env


def test_bf16_params_cli(tmp_path):
    """``python -m repro_torch.launch.dryrun ... --bf16-params --tag
    bf16``: the record, its file, the reference rule's state bytes."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-4b", "--shape", "decode_32k", "--bf16-params", "--tag",
         "bf16", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, env=_env(), cwd=ROOT)
    assert r.returncode == 0, (r.stderr or "")[-2000:]
    rec = json.loads(r.stdout)
    assert rec["status"] == "ok" and rec["bf16_params"] is True
    assert rec["state_bytes_per_device"] == _reference_bf16_state_bytes(
        "qwen3-4b", "decode_32k", False)
    saved = tmp_path / "qwen3-4b__decode_32k__16x16__bf16.json"
    assert json.loads(saved.read_text()) == rec


def test_roofline_md_flag(tmp_path, capsys):
    rec = dict(arch="a", shape="s", status="ok", kind="decode", chips=256,
               model_flops=1e12, collectives={}, useful_flops_ratio=0.5,
               bf16_params=True, **dryrun.roofline(2e12, 1e9, 0.0))
    (tmp_path / "a__s__16x16__bf16.json").write_text(json.dumps(rec))
    roofline.main(["--dir", str(tmp_path), "--tag", "bf16", "--md"])
    out = capsys.readouterr().out
    assert out.startswith("| arch | shape | status |")
    assert "| a | s | ok |" in out


def test_changed_modules_import_neither_jax_nor_the_reference(tmp_path):
    code = textwrap.dedent(f"""
        import sys
        import torch
        from repro_torch import configs
        from repro_torch.launch import dryrun, roofline, steps
        from repro_torch.models import model as M, ssm
        cfg = configs.get_reduced("mamba2-370m")
        m = M.cast_params(M.init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu"))
        a = ssm._decay_rates(m.layers[0]["block0"].mixer.A_log)
        assert a.dtype == torch.bfloat16
        rec = dryrun.run_cell("qwen3-4b", "decode_32k", True,
                              bf16_params=True)
        assert rec["status"] == "ok" and rec["bf16_params"], rec
        roofline.main(["--dir", {str(tmp_path)!r}, "--md"])
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "repro" or n.startswith("repro."))
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "LOADED []" in out.stdout
