"""Where the port's model departs from the JAX reference at depth, on
the CPU: qwen3-4b's reduced width at its full depth of 36 layers, the
JAX package's weights in both packages, B 1, 96 prompt tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/torch_depth_parity.py
    XLA_FLAGS=--xla_allow_excess_precision=false PYTHONPATH=src \
        JAX_PLATFORMS=cpu python examples/torch_depth_parity.py

It prints, as relative logit errors (max |a - b| / max |b|):

* prefill logits, port against JAX;
* two decode steps from the JAX prefill's cache, port against the
  jitted JAX ``decode_step``, and against the same step run op by op
  (``jax.disable_jit``), where each op rounds its result as written;
* the jitted reference against its own op-by-op run;
* decode against a fresh prefill of the longer prompt, in each package
  (``tests/test_torch_models.py::test_decode_gap_at_depth``).

XLA fuses the jitted step's elementwise chains and, under its default
``xla_allow_excess_precision``, skips bf16 roundings inside them; the
second command turns that off.
"""
import dataclasses
import sys

sys.path.insert(0, "src")

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import model as JM

from repro_torch import configs
from repro_torch.models import model as M

P = 96


def rel(a, b) -> float:
    """Relative error of the last position's logits (float32 arrays)."""
    a, b = a[:, -1], b[:, -1]
    return float(np.abs(a - b).max() / np.abs(b).max())


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == np.float32 or a.dtype.kind == "i":
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def to_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x).astype(jnp.float32))


def main():
    jcfg = dataclasses.replace(jconfigs.get_reduced("qwen3-4b"),
                               num_layers=36)
    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              num_layers=36)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    model = M.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), jp), cfg, device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (1, P + 2)).astype(np.int32)

    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :P])},
                        cache_len=P + 2)
    tl, _ = M.prefill(model, cfg, {"tokens": to_torch(toks[:, :P])},
                      cache_len=P + 2)
    print(f"prefill logits, port vs JAX: {rel(to_np(tl), to_np(jl)):.4e}")

    tc = jax.tree_util.tree_map(to_torch, jc)
    ec = jc
    for i in range(2):
        nxt = toks[:, P + i:P + i + 1]
        with jax.disable_jit():
            el, ec = JM.decode_step(jp, jcfg, jnp.asarray(nxt), ec, P + i)
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jc, P + i)
        tl, tc = M.decode_step(model, cfg, to_torch(nxt), tc, P + i)
        tl, jl, el = to_np(tl), to_np(jl), to_np(el)
        print(f"decode step {i} from the JAX cache: port vs jitted JAX "
              f"{rel(tl, jl):.4e}, port vs JAX op by op {rel(tl, el):.4e}, "
              f"jitted vs op-by-op JAX {rel(jl, el):.4e}")

    for name, (pre, step, args, mk) in {
            "JAX": (JM.prefill, JM.decode_step, (jp, jcfg), jnp.asarray),
            "port": (M.prefill, M.decode_step, (model, cfg), to_torch)
    }.items():
        _, cache = pre(*args, {"tokens": mk(toks[:, :P])}, cache_len=P + 2)
        gaps = []
        for i in range(2):
            ld, cache = step(*args, mk(toks[:, P + i:P + i + 1]), cache,
                             P + i)
            lf, _ = pre(*args, {"tokens": mk(toks[:, :P + i + 1])})
            gaps.append(rel(to_np(ld), to_np(lf)))
        print(f"decode vs re-prefill, {name}: "
              f"{', '.join(f'{g:.4e}' for g in gaps)}")


if __name__ == "__main__":
    main()
