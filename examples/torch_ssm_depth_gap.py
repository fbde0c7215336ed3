"""Decode against a fresh prefill for the SSM family at depth, on the
CPU: mamba2 at its full depth of 48 layers with a reduced width (d_model
128, state 64, 8 heads of 32, chunk 128), the JAX package's weights in
both packages, B 1, 150 prompt tokens.

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/torch_ssm_depth_gap.py

At this depth the reference is chaotic: one bf16 ulp on one embedded
element moves its last logits by percents of their scale. The script
prints those moves, then, layer by layer on the prefill's own hidden
states, how far each layer's decode step lies from the chunked
prefill's row for the same token (bf16 ulps of the row's scale), in
both packages, and the whole model's decode-vs-prefill gap in each.
XLA:CPU's dot gives a row the same bits at M 1 as at M 151, so the
reference's whole-model gap is near 0; the port's need not be (its CPU
gemv and gemm, like cuBLAS's kernels on the card, may sum in other
float32 orders, and the model amplifies one flipped rounding). It fails
unless every layer lies within one ulp in both packages and the port's
gap stays under twice the reference's largest one-ulp move
(``chip_smoke.py`` phase 16 holds mamba2-370m at full width the same
way). About 2 minutes on 8 CPU cores.
"""
import sys

sys.path.insert(0, "src")
sys.path.insert(0, "tests")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import layers as JL
from repro.models import model as JM
from repro.models import ssm as JS

from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from test_torch_models import _f32, _pair, _t

P = 150


def one_ulp_moves(jcfg, jp, toks):
    pos = jnp.arange(P + 1)[None]

    @jax.jit
    def last_logits(x):
        h, _, _ = JM._scan_train(jp, jcfg, x, pos)
        h = JL.rmsnorm(jp["final_norm"], h, jcfg.norm_eps)
        return JL.unembed(jp["unembed"], h[:, -1:])
    x = JL.embed(jp["embed"], jnp.asarray(toks[:, :P + 1]))
    base = np.asarray(last_logits(x))
    moves = []
    for i, j in ((0, 0), (P // 2, 5), (P, 3)):
        v = x[0, i, j]
        bumped = x.at[0, i, j].set(jnp.nextafter(v, jnp.asarray(10, v.dtype)))
        moves.append(float(np.abs(np.asarray(last_logits(bumped)) - base).max()
                           / np.abs(base).max()))
    return x, moves


def layer_ulps(rows):
    worst = 0.0
    for a, b in rows:
        a, b = _f32(a), _f32(b)
        ulp = np.exp2(np.floor(np.log2(np.abs(a).max())) - 7)
        worst = max(worst, float(np.abs(a - b).max() / ulp))
    return worst


def layer_rows(jcfg, jp, cfg, model, x):
    train = jax.jit(JS.ssm_train, static_argnums=(1, 3))
    step = jax.jit(JS.ssm_decode, static_argnums=(1,))
    norm = jax.jit(JL.rmsnorm, static_argnums=(2,))
    jrows, trows = [], []
    jh, th = x, _t(np.array(x.astype(jnp.float32)))
    for r in range(cfg.num_layers):
        jb = jax.tree_util.tree_map(lambda a: a[r], jp["layers"]["block0"])
        tb = model.layers[r]["block0"]
        jn = norm(jb["norm1"], jh, jcfg.norm_eps)
        jy = train(jb["mixer"], jcfg, jn, False)
        _, jst = train(jb["mixer"], jcfg, jn[:, :P], True)
        jrows.append((jy[:, P:], step(jb["mixer"], jcfg, jn[:, P:], jst)[0]))
        tn = L.rmsnorm(tb.norm1, th, cfg.norm_eps)
        ty = S.ssm_train(tb.mixer, cfg, tn)
        _, tst = S.ssm_train(tb.mixer, cfg, tn[:, :P], return_state=True)
        trows.append((ty[:, P:], S.ssm_decode(tb.mixer, cfg, tn[:, P:],
                                              tst)[0]))
        jh, th = jh + jy, th + ty
    return layer_ulps(jrows), layer_ulps(trows)


def whole_gap(prefill, decode, args, to, toks):
    _, cache = prefill(*args, {"tokens": to(toks[:, :P])}, P + 2)
    ld, _ = decode(*args, to(toks[:, P:P + 1]), cache, P)
    lf, _ = prefill(*args, {"tokens": to(toks[:, :P + 1])}, None)
    ld, lf = _f32(ld)[:, -1], _f32(lf)[:, -1]
    return float(np.abs(ld - lf).max() / np.abs(lf).max())


def main():
    jcfg, jp, cfg, model = _pair("mamba2-370m", num_layers=48, d_model=128,
                                 ssm_state=64, ssm_head_dim=32,
                                 ssm_chunk=128)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (1, P + 2)).astype(np.int32)
    x, moves = one_ulp_moves(jcfg, jp, toks)
    j_ulps, t_ulps = layer_rows(jcfg, jp, cfg, model, x)
    jpre = jax.jit(JM.prefill, static_argnums=(1, 3))
    jdec = jax.jit(JM.decode_step, static_argnums=(1,))
    jgap = whole_gap(jpre, jdec, (jp, jcfg), jnp.asarray, toks)
    tgap = whole_gap(M.prefill, M.decode_step, (model, cfg), _t, toks)
    print(f"mamba2, 48 layers of width 128, B 1, {P} + 1 tokens: the "
          f"reference's one-ulp moves {', '.join(f'{m:.4e}' for m in moves)}")
    print(f"decode vs prefill, layer by layer: at most {j_ulps:.3f} "
          f"(reference) and {t_ulps:.3f} (port) bf16 ulp of the row's scale")
    print(f"decode vs prefill, whole model: {jgap:.4e} (reference), "
          f"{tgap:.4e} (port)")
    if j_ulps > 1 or t_ulps > 1 or tgap >= 2 * max(moves):
        raise SystemExit("decode departs from prefill beyond the bars")


if __name__ == "__main__":
    main()
