"""Port parity: the dry-run tools (``repro_torch.launch.dryrun``,
``roofline``, ``sweep``, ``trace_analysis``) against the JAX package's.

  * per-device state bytes of every applicable (arch, shape) cell on both
    production meshes == the reference dry-run's ``_sharded_bytes`` over
    its own specs;
  * the ``meta`` FLOP count of a reduced qwen3 and a reduced deepseek
    train step (B 2 x 64) within 10% of ``hlo_analysis.analyze``'s dot
    FLOPs of the reference step compiled on one CPU device (the port
    counts the attention kernels' kept pairs and their five backward
    products, the reference its full-square scan; the ratio is in
    PERF.md);
  * the roofline constants are the H100's; the profiler's kernel groups.

The command-line tools in processes of their own:
tests/test_torch_dryrun_cli.py.
"""
import os

import jax
import pytest

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.launch.hlo_analysis import analyze
from repro.models.config import SHAPES as JSHAPES, ShapeSpec as JShape
from repro.models.config import shape_applicable

from repro_torch import configs
from repro_torch.launch import dryrun, roofline, trace_analysis
from repro_torch.models.config import ShapeSpec


def _reference_sharded_bytes():
    """``repro.launch.dryrun._sharded_bytes``; importing that module
    appends a 512-device flag to ``XLA_FLAGS``, which is put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _sharded_bytes
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _sharded_bytes


def _reference_state_bytes(arch, shape_name, multi_pod) -> int:
    """The reference dry-run's ``state_bytes_per_device`` rule over its
    specs, on ``AbstractMesh``es of the production shapes."""
    sharded = _reference_sharded_bytes()
    cfg, shape = jconfigs.get(arch), JSHAPES[shape_name]
    mesh = (jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
            if multi_pod else
            jax.sharding.AbstractMesh((16, 16), ("data", "model")))
    specs = JST.input_specs(cfg, shape)
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


def _state_bytes(arch, shape_name, multi_pod) -> int:
    """The port's per-device state bytes (``dryrun.state_bytes``, as
    ``run_cell`` counts them) from the step's ``meta`` inputs."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import abstract_production_mesh
    from repro_torch.models.config import SHAPES
    cfg, shape = configs.get(arch), SHAPES[shape_name]
    specs = ST.reference_specs(ST.input_specs(cfg, shape))
    return dryrun.state_bytes(cfg, shape, abstract_production_mesh(multi_pod),
                              specs)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_state_bytes_match_reference(arch):
    n = 0
    for shape in JSHAPES:
        if not shape_applicable(jconfigs.get(arch), JSHAPES[shape])[0]:
            continue
        for multi_pod in (False, True):
            want = _reference_state_bytes(arch, shape, multi_pod)
            assert _state_bytes(arch, shape, multi_pod) == want, (
                arch, shape, multi_pod)
            n += 1
    assert n >= 6


@pytest.mark.parametrize("arch", ["qwen3-4b", "deepseek-moe-16b"])
def test_meta_flops_against_reference_hlo(arch):
    b, s = 2, 64
    jcfg = jconfigs.get_reduced(arch)
    specs = JST.input_specs(jcfg, JShape("t", s, b, "train"))
    compiled = jax.jit(JST.make_train_step(jcfg)).lower(
        specs["params"], specs["opt_state"], specs["batch"]).compile()
    ref = analyze(compiled.as_text())["dot_flops"]
    got = dryrun.trace_step(configs.get_reduced(arch),
                            ShapeSpec("t", s, b, "train"))
    ratio = got["flops"] / ref
    print(f"{arch}: port {got['flops']:.6g} / reference {ref:.6g} = "
          f"{ratio:.4f}; by op {got['flop_counts']}")
    assert abs(ratio - 1) < 0.10
    assert any("flash_attention_bwd" in k for k in got["flop_counts"])


def test_roofline_constants_and_fraction():
    assert dryrun.HW == {"peak_flops_bf16": 989e12, "hbm_bw": 3.35e12,
                         "nvlink_bw": 450e9}
    t = dryrun.roofline(989e12, 3.35e12 / 2, 0.0)
    assert t["t_compute_s"] == 1.0 and t["bottleneck"] == "compute"
    rec = dict(arch="a", shape="s", status="ok", kind="train", chips=2,
               model_flops=989e12, collectives={"all-gather": 1.0},
               useful_flops_ratio=0.5, **t)
    assert roofline.fraction(rec) == pytest.approx(0.5)
    assert "compute-bound" in roofline.advice(rec)
    assert "| a | s | ok |" in roofline.table([rec])


def test_kernel_groups():
    g = trace_analysis.kernel_group
    assert g("void (anonymous namespace)::kv_pass<128>(Params)") \
        == "flash_attention_bwd"
    assert g("void flash_sm90_kernel<64>(...)").startswith("flash_attention")
    assert g("paged_decode_kernel(float const*)") == "paged_decode_attention"
    assert g("sm90_xmma_gemm_bf16bf16_bf16f32") == trace_analysis.CUBLAS
    assert g("nvjet_hsh_128x256") == trace_analysis.CUBLAS
    assert g("Memcpy DtoD (Device -> Device)") == trace_analysis.COPIES
    assert g("void at::native::vectorized_elementwise_kernel<4>") \
        == trace_analysis.ELEMENTWISE
