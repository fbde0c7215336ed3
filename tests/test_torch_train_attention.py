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
    backward given the forward's row statistics."""
    _, (q, k, v, do) = _inputs((1, 4, 2, 32, 32, 16))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = A.blocked_attention(*leaves, causal=True, chunk=16)
    assert "FlashAttentionBackward" in _graph_names(out)
    out.backward(do)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    _, stats = ops.flash_attention_plain(qt, kt, vt, causal=True, tk=16,
                                         return_stats=True)
    want = ops.flash_attention_bwd_plain(
        qt, kt, vt, out.detach().transpose(1, 2), do.transpose(1, 2),
        stats=stats)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w.transpose(1, 2))


# the statistics' cases: CASES and a window past every key of some rows
# (rows 37..47, at positions 53..63, keep none of the 48 keys)
STATS_CASES = CASES + [
    ((1, 4, 2, 48, 48, 16), dict(causal=True, window=6, q_offset=16))]
STATS_IDS = IDS + ["no_key_rows"]
NO_KEY_ROWS = {"no_key_rows": 11}


@pytest.mark.parametrize("shape,kw", STATS_CASES, ids=STATS_IDS)
def test_plain_stats_are_the_softmax_rows(request, shape, kw):
    """``flash_attention_plain(return_stats=True)``: the same output, and
    m, l in the base-2 domain: m the row max of the masked scores times
    log2(e) (-1e30 for a row with no key), l the sum of 2^(x - m)."""
    b, h, hkv, sq, skv, d = shape
    _, (q, k, v, _) = _inputs(shape, seed=2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out, stats = ops.flash_attention_plain(qt, kt, vt, tk=16,
                                           return_stats=True, **kw)
    assert torch.equal(out, ops.flash_attention_plain(qt, kt, vt, tk=16,
                                                      **kw))
    assert stats.shape == (2, b, h, sq) and stats.dtype == torch.float32
    s = (qt.double() * d ** -0.5) @ kt.double().repeat_interleave(
        h // hkv, 1).transpose(-1, -2)
    keep = ops._mask(sq, skv, causal=kw.get("causal", True),
                     window=kw.get("window", 0),
                     q_offset=kw.get("q_offset", 0))
    x = torch.where(keep, s * ops.LOG2E, ops.NEG_INF)
    m = x.amax(-1)
    l = torch.exp2(x - m[..., None]).sum(-1)
    none = ~keep.any(-1)
    assert torch.equal(stats[0][..., none],
                       torch.full_like(stats[0][..., none], ops.NEG_INF))
    assert _rel(stats[0][..., ~none], m[..., ~none].numpy()) <= REL
    assert _rel(stats[1], l.numpy()) <= REL
    case = request.node.callspec.id
    assert int(none.sum()) == NO_KEY_ROWS.get(case, 0)
    assert (stats[1][..., none] == skv).all()     # 2^0 for every key


@pytest.mark.parametrize("shape,kw", STATS_CASES, ids=STATS_IDS)
def test_plain_bwd_given_stats(shape, kw):
    """The plain backward given the forward's statistics equals the one
    that recomputes the softmax, and ``jax.grad`` of the reference's
    ``blocked_attention`` (rows that keep no key included)."""
    b, h, hkv, sq, skv, d = shape
    g = h // hkv
    (qa, ka, va, doa), (q, k, v, do) = _inputs(shape, seed=3)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, stats = ops.flash_attention_plain(qt, kt, vt, tk=16,
                                           return_stats=True, **kw)
    got = ops.flash_attention_bwd(qt, kt, vt, out, dot, stats=stats, **kw)
    want = ops.flash_attention_bwd_plain(qt, kt, vt, out, dot, **kw)
    assert max(_rel(x, y.numpy()) for x, y in zip(got, want)) <= REL

    def ref(q, k, v):
        o = JA.blocked_attention(q, JA._expand_kv(k, g), JA._expand_kv(v, g),
                                 chunk=16, **kw)
        return jnp.sum(o * doa)
    grads = jax.grad(ref, argnums=(0, 1, 2))(qa, ka, va)
    errs = [_rel(x.transpose(1, 2), np.asarray(w))
            for x, w in zip(got, grads)]
    print(f"dq, dk, dv given stats vs jax.grad: {errs}")
    assert max(errs) <= REL


@pytest.mark.parametrize("needs", [True, False], ids=["grad", "no_grad"])
def test_function_saves_stats_only_for_grads(needs):
    """``FlashAttention`` asks the forward for row statistics only when
    an input needs a gradient, and saves them beside q, k, v and out."""
    _, (q, k, v, _) = _inputs((1, 4, 2, 32, 32, 16))
    args = [x.transpose(1, 2).clone().requires_grad_(needs)
            for x in (q, k, v)]
    out = ops.FlashAttention.apply(*args, True, 0, 32, 16, 0)
    if not needs:
        assert out.grad_fn is None
        return
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    want = ops.flash_attention_plain(*args, causal=True, tk=16,
                                     return_stats=True)[1]
    assert torch.equal(saved[4], want)


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


def _emulate_bwd_wgmma(q, k, v, out, do, stats, *, causal=True, window=0,
                       q_offset=0):
    """The ``wgmma`` backward's arithmetic in plain torch: float32 scores
    of the bf16 operands times scale·log2(e), P = 2^(x - m) / l from the
    forward's statistics, dS = P (dP - delta) in float32, then P and dS
    rounded once to bf16 as the A operands of dV, dK and dQ (float32
    sums); D^-½ on the float32 dK and dQ before one bf16 rounding."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    f = [x.float() for x in (q, k, v, out, do)]
    qf, dof, of = (x.reshape(b, hkv, g, sq, d) for x in (f[0], f[4], f[3]))
    kf, vf = f[1][:, :, None], f[2][:, :, None]
    keep = ops._mask(sq, skv, causal=causal, window=window, q_offset=q_offset)
    x = torch.where(keep, (qf @ kf.transpose(-1, -2)) * (d ** -0.5 * ops.LOG2E),
                    ops.NEG_INF)
    m, l = stats.reshape(2, b, hkv, g, sq, 1)
    p = torch.exp2(x - m) * (1.0 / torch.clamp(l, min=1e-30))
    delta = (dof * of).sum(-1, keepdim=True)
    ds = torch.where(keep, p * (dof @ vf.transpose(-1, -2) - delta), 0.0)
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dq = (ds16 @ kf) * d ** -0.5
    dk = (ds16.transpose(-1, -2) @ qf).sum(2) * d ** -0.5
    dv = (p16.transpose(-1, -2) @ dof).sum(2)
    return (dq.reshape(b, h, sq, d).bfloat16(), dk.bfloat16(), dv.bfloat16())


@pytest.mark.parametrize("shape,kw", STATS_CASES, ids=STATS_IDS)
def test_wgmma_bwd_numerics_hold_the_bar(shape, kw):
    """The ``wgmma`` backward's design on the CPU, bf16 inputs: every
    gradient within 2e-2 of its scale of the plain version (the card
    bar, phase 17 (a)), rows that keep no key included."""
    _, (q, k, v, do) = _inputs(shape, seed=4, dtype=torch.bfloat16)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, stats = ops.flash_attention_plain(qt, kt, vt, tk=16,
                                           return_stats=True, **kw)
    got = _emulate_bwd_wgmma(qt, kt, vt, out, dot, stats, **kw)
    want = ops.flash_attention_bwd_plain(qt, kt, vt, out, dot, **kw)
    errs = [_rel(x, y.float().numpy()) for x, y in zip(got, want)]
    print(f"emulated wgmma backward vs plain, dq, dk, dv: {errs}")
    assert max(errs) <= 2e-2
