"""Shared kernel helpers: tiling math and shard_map vma propagation."""

from __future__ import annotations

import jax


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def match_vma(init, *like):
    """Promote ``init``'s (pytree) varying-manual-axes to the union of the
    ``like`` values' so loop carries type-check under
    ``jax.shard_map(check_vma=True)``.

    A ``fori_loop``/``while_loop`` carry initialized from ``jnp.zeros`` is
    unvarying, while the body output (derived from sharded inputs) varies
    over the mesh axes — shard_map's vma checker rejects the carry type
    mismatch at trace time. ``pcast(..., to='varying')`` is metadata-only
    (no collective) and a no-op when the needed set is empty, so calling
    this outside shard_map costs nothing."""
    target: frozenset = frozenset()
    for x in like:
        for leaf in jax.tree.leaves(x):
            v = getattr(jax.typeof(leaf), "vma", None)
            if v:
                target |= frozenset(v)

    def fix(leaf):
        have = getattr(jax.typeof(leaf), "vma", None) or frozenset()
        need = target - frozenset(have)
        if need:
            leaf = jax.lax.pcast(leaf, tuple(sorted(need)), to="varying")
        return leaf

    return jax.tree.map(fix, init)
