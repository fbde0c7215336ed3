"""Port parity: ``compressed_psum`` (``repro_torch.optim.compress``), the
int8 all-reduce over a mesh's data axes, == the reference's bit for bit
at data-axis sizes 1, 2 and 4, with a distinct gradient on every
replica: the reference over four forced CPU devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``), its input
assembled from per-device buffers; the port over a mesh that repeats the
CPU device. One leaf's scales sum differently in another order, so the
float32 order is pinned too.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as MESH
from repro_torch.optim import compressed_psum, quantize_int8

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
GRAD_SHAPES = {"a": (6, 10), "b": (5,), "c": (3, 4, 7), "bf16_d": (8, 16),
               "order": (1, 4)}
# replica r's absmax in "order": its scales 2^-24, 2^-24, 1, 2^-24 sum to
# 1 + 2^-22 in mesh order and to 1 + 2^-23 pairwise
ORDER_ABSMAX = (127 * 2.0 ** -24, 127 * 2.0 ** -24, 127.0, 127 * 2.0 ** -24)


def _replica_grads(seed=0) -> dict:
    """Four replicas' distinct gradients, rows of different scales."""
    rng = np.random.default_rng(seed)
    out = {}
    for n, s in GRAD_SHAPES.items():
        for r in range(4):
            scale = rng.uniform(0.1, 10, size=s[:1] + (1,) * (len(s) - 1))
            out[f"{n}__{r}"] = (rng.standard_normal(s) * scale
                                ).astype(np.float32)
    for r, a in enumerate(ORDER_ABSMAX):
        out[f"order__{r}"] = np.float32([[a, -a / 2, a / 3, 0.0]])
    return out


def _dtype(name):
    return torch.bfloat16 if name.startswith("bf16") else torch.float32


def test_compressed_psum_matches_jax_at_1_2_4_replicas(tmp_path):
    data = _replica_grads()
    inp, out = tmp_path / "grads.npz", tmp_path / "psum.npz"
    np.savez(inp, **data)
    code = textwrap.dedent(f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        from repro.optim.compress import compressed_psum
        z = np.load({str(inp)!r})
        names = {sorted(GRAD_SHAPES)!r}
        res = {{}}
        for d in (1, 2, 4):
            mesh = jax.make_mesh((d, 4 // d), ("data", "model"))
            devs = list(mesh.devices.flat)
            tree = {{}}
            for n in names:
                dt = jnp.bfloat16 if n.startswith("bf16") else jnp.float32
                bufs = [jax.device_put(jnp.asarray(z[f"{{n}}__{{r}}"], dt), dv)
                        for r, dv in enumerate(devs)]
                tree[n] = jax.make_array_from_single_device_arrays(
                    bufs[0].shape, NamedSharding(mesh, P()), bufs)
            got = compressed_psum(tree, mesh, ("data",))
            for n in names:
                by_dev = {{s.device: np.asarray(s.data.astype(jnp.float32))
                          for s in got[n].addressable_shards}}
                for r, dv in enumerate(devs):
                    res[f"{{d}}__{{n}}__{{r}}"] = by_dev[dv]
        np.savez({str(out)!r}, **res)
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    ref = np.load(out)
    for d in (1, 2, 4):
        mesh = MESH.ModelMesh(tuple((CPU,) * (4 // d) for _ in range(d)),
                              ("data", "model"))
        grads = [{n: torch.from_numpy(data[f"{n}__{r}"]).to(_dtype(n))
                  for n in GRAD_SHAPES} for r in range(4)]
        got = compressed_psum(grads, mesh, ("data",))
        for n in GRAD_SHAPES:
            for r in range(4):
                assert got[r][n].dtype == _dtype(n)
                assert got[r][n].shape == GRAD_SHAPES[n]
                g = got[r][n].float().numpy()
                assert g.tobytes() == ref[f"{d}__{n}__{r}"].tobytes(), \
                    (d, n, r)
    # the scale sum's order shows: "order" sums differently pairwise
    scales = [quantize_int8(torch.from_numpy(data[f"order__{r}"]))[1]
              for r in range(4)]
    seq = ((scales[0] + scales[1]) + scales[2]) + scales[3]
    pair = (scales[0] + scales[1]) + (scales[2] + scales[3])
    assert float(seq) == 1 + 2.0 ** -22 and float(pair) == 1 + 2.0 ** -23


def test_compressed_psum_groups_and_placement():
    """Replicas of one model column are summed together; each result is
    its own tensor on its replica's device; the mesh is checked."""
    mesh = MESH.ModelMesh(((CPU, CPU), (CPU, CPU)), ("data", "model"))
    rng = np.random.default_rng(1)
    grads = [{"w": torch.from_numpy(rng.standard_normal((4, 3))
                                    .astype(np.float32))} for _ in range(4)]
    out = compressed_psum(grads, mesh)
    assert torch.equal(out[0]["w"], out[2]["w"])
    assert torch.equal(out[1]["w"], out[3]["w"])
    assert not torch.equal(out[0]["w"], out[1]["w"])
    assert out[0]["w"].data_ptr() != out[2]["w"].data_ptr()
    q = [quantize_int8(g["w"]) for g in grads]
    want = ((q[0][0].int() + q[2][0].int()).float()
            * ((q[0][1] + q[2][1]) / 2 / 2))
    assert torch.equal(out[0]["w"], want)
    with pytest.raises(ValueError):
        compressed_psum(grads[:3], mesh)
    with pytest.raises(ValueError):
        compressed_psum(grads, mesh, ("pod",))
