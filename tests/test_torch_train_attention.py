"""Port parity: the flash attention backward, on the CPU.

``flash_attention_bwd_plain`` (the plain version the card kernel is held
to) against ``torch.autograd`` through ``flash_attention_plain`` and
against ``jax.grad`` of the reference's ``blocked_attention``
(``src/repro/models/attention.py:75``, which takes KV expanded, so its
dk and dv are summed over each KV head's query heads). Inputs are made
with numpy and handed to both packages.

Tolerance: float32, each gradient within 1e-5 of its largest magnitude
(the float32 sums run in other orders: a full-row softmax here, KV
chunks in the reference scan and in autograd through the plain
forward). bf16 inputs: the plain backward's outputs keep q, k and v's
dtype and layout.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA

from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention as A

REL = 1e-5

# B, H, Hkv, Sq, Skv, D and the mask; GQA 4:2 throughout but one case
CASES = [
    ((2, 4, 2, 64, 64, 16), dict(causal=True)),
    ((1, 4, 2, 64, 64, 16), dict(causal=True, window=8)),
    ((1, 4, 2, 32, 96, 16), dict(causal=False)),
    ((1, 4, 4, 48, 48, 8), dict(causal=True)),
    ((1, 4, 2, 16, 48, 8), dict(causal=True, window=6, q_offset=32)),
]
IDS = ["causal", "window", "noncausal", "mha", "offset"]


def _inputs(shape, seed=0, dtype=torch.float32):
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d),
                      (b, sq, h, d))]
    return arrs, [torch.from_numpy(a).to(dtype) for a in arrs]


def _rel(got, want):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("shape,kw", CASES, ids=IDS)
def test_plain_bwd_equals_autograd(shape, kw):
    _, (q, k, v, do) = _inputs(shape)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    out = ops.flash_attention_plain(*leaves, tk=16, **kw)
    want = torch.autograd.grad(out, leaves, dot)
    got = ops.flash_attention_bwd_plain(qt, kt, vt, out.detach(), dot, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= REL


@pytest.mark.parametrize("shape,kw", CASES, ids=IDS)
def test_plain_bwd_equals_jax_grad(shape, kw):
    b, h, hkv, sq, skv, d = shape
    g = h // hkv
    (qa, ka, va, doa), (q, k, v, do) = _inputs(shape, seed=1)

    def ref(q, k, v):
        out = JA.blocked_attention(q, JA._expand_kv(k, g), JA._expand_kv(v, g),
                                   chunk=16, **kw)
        return jnp.sum(out * doa), out
    (_, out), grads = jax.value_and_grad(ref, argnums=(0, 1, 2),
                                         has_aux=True)(qa, ka, va)
    got = ops.flash_attention_bwd_plain(
        *(x.transpose(1, 2) for x in (q, k, v)),
        torch.from_numpy(np.array(out)).transpose(1, 2),
        do.transpose(1, 2), **kw)
    errs = [_rel(gt.transpose(1, 2), np.asarray(w))
            for gt, w in zip(got, grads)]
    print(f"dq, dk, dv vs jax.grad: {errs}")
    assert max(errs) <= REL


def test_model_layout_strides_and_dtypes():
    """bf16 model-layout views in, gradients out in the same layout and
    dtype (the kernel takes strides; so must the plain version)."""
    _, (q, k, v, do) = _inputs((1, 4, 2, 32, 32, 16), dtype=torch.bfloat16)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out = ops.flash_attention_plain(qt, kt, vt, causal=True)
    for g, x in zip(ops.flash_attention_bwd_plain(qt, kt, vt, out, dot),
                    (qt, kt, vt)):
        assert g.dtype == torch.bfloat16 and g.stride() == x.stride()


def test_dispatch_takes_plain_version_on_cpu():
    _, (q, k, v, do) = _inputs((1, 4, 2, 32, 32, 16))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out = ops.flash_attention_plain(qt, kt, vt, causal=False)
    a = ops.flash_attention_bwd(qt, kt, vt, out, dot, causal=False)
    b = ops.flash_attention_bwd_plain(qt, kt, vt, out, dot, causal=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        ops.flash_attention_bwd(qt, kt, vt, out[:, :, :16], dot[:, :, :16])


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_function_is_on_the_graph():
    """``attention`` (what ``blocked_attention`` calls) goes through the
    autograd Function on the CPU too, and its backward is the plain
    backward."""
    _, (q, k, v, do) = _inputs((1, 4, 2, 32, 32, 16))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = A.blocked_attention(*leaves, causal=True, chunk=16)
    assert "FlashAttentionBackward" in _graph_names(out)
    out.backward(do)
    want = ops.flash_attention_bwd_plain(
        *(x.transpose(1, 2) for x in (q, k, v)),
        out.detach().transpose(1, 2), do.transpose(1, 2))
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w.transpose(1, 2))


def test_encoder_path_grads_sum_over_expanded_heads():
    """The encoder path expands KV before the kernel: autograd sums the
    expanded heads' gradients back onto each KV head."""
    _, (q, k, v, do) = _inputs((1, 4, 2, 32, 32, 16))
    leaves = [x.clone().requires_grad_() for x in (k, v)]
    out = A.blocked_attention(q, A._expand_kv(leaves[0], 2),
                              A._expand_kv(leaves[1], 2), causal=False)
    out.backward(do)
    _, dk, dv = ops.flash_attention_bwd_plain(
        *(x.transpose(1, 2) for x in (q, k, v)),
        out.detach().transpose(1, 2), do.transpose(1, 2), causal=False)
    assert _rel(leaves[0].grad, dk.transpose(1, 2).numpy()) <= REL
    assert _rel(leaves[1].grad, dv.transpose(1, 2).numpy()) <= REL
