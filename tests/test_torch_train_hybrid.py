"""Port parity: hybrid training (jamba reduced: seven SSM blocks and one
attention block, MoE on every second) against ``jax.value_and_grad`` of
the reference on the CPU (``tests/train_parity.py``).

Bars: the loss within 2e-2, every parameter with a gradient, the
expert choices of both runs equal (0 flips at this seed), and each
leaf's relative L2 error within 2e-2 — but for the SSM mixers' leaves,
which sit at the reference's own rounding noise there: a quarter-ulp
change of the unembedding table (2^-9 of each entry, random signs;
the forward pass and its routing unchanged up to the logits) moves the
reference's own gradients by up to about 2e-2 (1.96e-2 on
``block0.mixer.dt_bias`` at this seed), because the SSM layers amplify
rounding with depth (mamba2 reduced at 2, 4 and 8 layers: 2.8e-3,
7.1e-3, 1.8e-2 from the reference), and a single ``ssm_train`` layer
matches ``jax.grad`` within 2e-5 (``tests/test_torch_train_ssm.py``).
Those leaves are held to twice the reference's largest such move, and
the ones past 2e-2 are printed (``-rP``; ROADMAP Queue 3).
"""
import jax
import numpy as np

from train_parity import GRAD_REL, compare, family_batch, pair

ARCH = "jamba-v0.1-52b"


def _reference_move(run, jp, batch, jgrads) -> float:
    """The largest relative change of any gradient leaf of the reference
    when its unembedding table moves by 2^-9 of each entry."""
    table = np.asarray(jp["unembed"]["table"])
    signs = np.random.default_rng(5).choice([-1.0, 1.0], table.shape)
    moved = dict(jp, unembed={"table": (table + signs * np.abs(table)
                                        * 2.0 ** -9).astype(np.float32)})
    _, grads = run(moved, batch)
    return max(float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                     / np.linalg.norm(np.asarray(b)))
               for a, b in zip(jax.tree_util.tree_leaves(grads),
                               jax.tree_util.tree_leaves(jgrads)))


def test_loss_grads_and_routing_match_jax():
    _, jp, cfg, _ = pair(ARCH)
    batch = family_batch(cfg)
    errs, summary, run, jgrads = compare(ARCH, batch=batch, routes=True)
    ssm = [k for k in errs if "['mixer']" in k and any(
        f"['block{i}']" in k for i, b in enumerate(cfg.layer_pattern())
        if b.kind == "ssm")]
    rest = {k: e for k, e in errs.items() if k not in ssm}
    assert max(rest.values()) <= GRAD_REL, rest
    move = _reference_move(run, jp, batch, jgrads)
    over = {k: round(errs[k], 5) for k in ssm if errs[k] > GRAD_REL}
    print(f"{summary}; outside the SSM mixers {max(rest.values()):.2e}; "
          f"the reference's own quarter-ulp move {move:.2e}; SSM leaves "
          f"past {GRAD_REL}: {over}")
    assert max(errs[k] for k in ssm) <= max(GRAD_REL, 2 * move), errs
