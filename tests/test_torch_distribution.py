"""Port parity: the distribution plan — the model meshes
(``repro_torch.launch.mesh``), the sharding rules
(``repro_torch.launch.sharding``) and the abstract step inputs
(``repro_torch.launch.steps``) — against the JAX package
(``compressed_psum``: tests/test_torch_compress_psum.py).

  * for every config at 16 x 16 and 2 x 16 x 16, each parameter leaf's
    spec (with and without FSDP) == the reference's ``PartitionSpec``
    over ``jax.sharding.AbstractMesh``, and each ``decode_32k`` cache
    leaf's; ``should_fsdp`` as the reference;
  * ``input_specs`` of every applicable (arch, shape) cell, laid out as
    the reference's trees, == the reference's ``ShapeDtypeStruct``\\ s
    leaf for leaf; ``make_production_mesh`` raises on one device.
"""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as JSH
from repro.launch import steps as JST
from repro.models.config import SHAPES as JSHAPES, shape_applicable

from repro_torch import configs
from repro_torch._tree import named_leaves
from repro_torch.launch import mesh as MESH
from repro_torch.launch import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models.config import SHAPES

CPU = torch.device("cpu")
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _jmesh(name):
    shape, names = MESHES[name]
    return jax.sharding.AbstractMesh(shape, names)


def _tmesh(name):
    return MESH.AbstractMesh(*MESHES[name])


def _ref_leaves(tree) -> dict:
    """``{port path: leaf}`` of a reference pytree (dict keys and tuple
    indices joined by ``/``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


def _ref_specs(tree, spec_of) -> dict:
    """``{port path: spec tuple}`` of ``spec_of(jax path, leaf)`` over a
    reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = tuple(spec_of(path, leaf))
    return out


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_model_mesh_any_axes():
    two = MESH.make_host_mesh(device="cpu")
    assert two.shape == {"data": 1, "model": 1} and two.size == 1
    three = MESH.ModelMesh((((CPU,) * 2,) * 3,) * 2, ("pod", "data", "model"))
    assert three.shape == {"pod": 2, "data": 3, "model": 2}
    assert three.size == 12
    assert MESH.dp_axes(three) == ("pod", "data")
    assert MESH.axis_size(three, "pod") == 2
    assert MESH.axis_size(two, "pod") == 1
    with pytest.raises(ValueError):
        MESH.ModelMesh(((CPU, CPU), (CPU,)), ("data", "model"))
    ab = MESH.abstract_production_mesh(multi_pod=True)
    assert ab.shape == {"pod": 2, "data": 16, "model": 16} and ab.size == 512
    assert MESH.dp_axes(ab) == ("pod", "data")
    assert MESH.abstract_production_mesh().shape == {"data": 16,
                                                     "model": 16}


def test_make_production_mesh_raises_without_devices():
    """As the reference with too few devices (one CPU device here; no
    card has 256)."""
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="need"):
            MESH.make_production_mesh(multi_pod=multi_pod, device="cpu")
        with pytest.raises(ValueError, match="need"):
            MESH.make_production_mesh(multi_pod=multi_pod)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_match_jax(arch):
    jcfg, cfg = jconfigs.get(arch), configs.get(arch)
    ref = JST.abstract_params(jcfg)
    got = ST.reference_specs({"params": ST.abstract_params(cfg)})["params"]
    n_sharded = 0
    for mname in MESHES:
        jm, tm = _jmesh(mname), _tmesh(mname)
        assert SH.should_fsdp(cfg, tm) == JSH.should_fsdp(jcfg, jm)
        for fsdp in (False, True):
            want = _ref_specs(ref, lambda p, leaf: JSH.param_spec(
                p, leaf, jcfg, jm, fsdp))
            have = {p: SH.param_spec(p, t.shape, cfg, tm, fsdp)
                    for p, t in named_leaves(got)}
            assert have == want, (arch, mname, fsdp)
            n_sharded += sum(s is not None for v in have.values() for s in v)
        # the trees of specs, by the reference's default FSDP choice
        tree = SH.param_shardings(cfg, got, tm)
        fs = SH.should_fsdp(cfg, tm)
        for p, t in named_leaves(got):
            node = tree
            for k in p.split("/"):
                node = node[k]
            assert node == SH.param_spec(p, t.shape, cfg, tm, fs)
        opt = SH.opt_shardings(cfg, got, tm)
        assert opt["step"] == () and opt["m"] is opt["v"]
    assert n_sharded > 0


@pytest.mark.parametrize("arch", ["llama3-405b", "mixtral-8x22b"])
def test_fsdp_on_for_big_models(arch):
    for mname in MESHES:
        assert SH.should_fsdp(configs.get(arch), _tmesh(mname))


def test_fsdp_off_for_small_models():
    for arch in ("qwen3-4b", "mamba2-370m"):
        assert not SH.should_fsdp(configs.get(arch), _tmesh("pod"))


@pytest.mark.parametrize("mname", list(MESHES))
def test_decode_cache_specs_match_jax(mname):
    jm, tm = _jmesh(mname), _tmesh(mname)
    for arch in jconfigs.ARCH_IDS:
        cache, _, _ = JST.decode_specs(jconfigs.get(arch),
                                       JSHAPES["decode_32k"])
        tcache, tokens, _ = ST.decode_specs(configs.get(arch),
                                            SHAPES["decode_32k"])
        want = _ref_specs(cache, lambda p, leaf: JSH.cache_leaf_spec(
            p, leaf, jm))
        have = {p: SH.cache_leaf_spec(p, t.shape, tm)
                for p, t in named_leaves(tcache)}
        assert have == want, arch
        assert SH.batch_sharding(tokens.shape, tm) == tuple(
            JSH.batch_sharding(tuple(tokens.shape), jm).spec)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every applicable cell: the same leaves, shapes and dtypes under
    the same paths; all on ``meta``; the skips as the reference's."""
    n = 0
    for shape in JSHAPES:
        ok, _ = shape_applicable(jconfigs.get(arch), JSHAPES[shape])
        if not ok:
            continue
        want = _ref_leaves(JST.input_specs(jconfigs.get(arch),
                                           JSHAPES[shape]))
        specs = ST.input_specs(configs.get(arch), SHAPES[shape])
        have = dict(named_leaves(ST.reference_specs(specs)))
        assert have.keys() == want.keys(), (arch, shape)
        for k, t in have.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, shape, k)
            assert str(t.dtype).removeprefix("torch.") == str(
                want[k].dtype), (arch, shape, k)
        n += 1
    assert n >= 3
    assert ST.ENC_DECODE_LEN == JST.ENC_DECODE_LEN


def test_abstract_params_is_the_model_on_meta():
    cfg = configs.get("llama3-405b")
    model = ST.abstract_params(cfg)
    assert all(p.device.type == "meta" for p in model.parameters())
    total = sum(p.numel() for p in model.parameters())
    ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        JST.abstract_params(jconfigs.get("llama3-405b"))))
    assert total == ref
    opt = ST.abstract_opt_state(cfg, model)
    assert opt["step"].dtype == torch.int32
    assert all(m.device.type == "meta" and m.dtype == torch.float32
               for m in opt["m"].values())
