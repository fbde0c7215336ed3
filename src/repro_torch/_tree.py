"""Nested containers of tensors and arrays (the train state): flatten to
named leaves in the JAX package's pytree order and rebuild.

A container is a dict (keys in sorted order, as ``jax.tree_util``
orders them), a list or a tuple; ``None`` holds no leaf; anything else
(a tensor, an array, a number) is a leaf. A leaf's name is its path,
the keys and indices joined by ``/``.
"""
from __future__ import annotations


def named_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in named_leaves(t, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [(prefix.rstrip("/"), tree)]


def unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves`` (an iterable)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return None if t is None else next(it)
    return build(like)

