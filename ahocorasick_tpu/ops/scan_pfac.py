"""Failureless parallel trie scan (PFAC), engine v1.

The reference's hot loop (``AhoCorasickSet.java:204-226``) is a sequential
char-at-a-time walk whose fail links exist *only* so a single-threaded
scanner never has to restart.  Here the design is inverted: every text
position is an independent lane that walks the pure trie (no fail links)
until it dies, all lanes in parallel.  Every keyword occurrence
starting at position ``i`` lies on the trie path spelled by ``text[i:]``, so
the union of all lane emissions is exactly the all-matches output of the
sequential automaton — with zero cross-lane dependencies, which is what lets
the scan shard freely across lanes, cores, and chips.

Emissions are encoded as per-position *depth bitplanes*: bit ``k`` of plane
word ``p`` at position ``i`` means a keyword of length ``32*p + k + 1``
matches at ``i``.  This keeps the device side fixed-shape and dense; host
code (``ops/emit.py``) turns planes into ``(start, end, value)`` triples.

Inputs are alphabet classes (``charmap[text]``), padded on the right with
``PAD_CLASS`` (class 0 — by construction no trie edge carries it, so padding
kills every lane without emitting).  Loops are rolled (``lax.fori_loop``) so
compile time does not scale with keyword length.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

PAD_CLASS = 0


def pad_classes(cls, max_depth: int, bucket: int = 1):
    """Right-pad class array so every lane can read ``max_depth`` chars.

    ``bucket`` additionally rounds the lane count up (reducing distinct
    compiled shapes); padded lanes die on PAD_CLASS and emit nothing.
    """
    import numpy as np

    cls = np.asarray(cls)
    n = len(cls)
    n_pad = -(-max(n, 1) // bucket) * bucket
    return np.pad(cls, (0, n_pad - n + max_depth), constant_values=PAD_CLASS)


@functools.partial(jax.jit, static_argnames=("max_depth", "num_planes"))
def pfac_bitplanes(
    trie_next: jax.Array,  # int32[S+1, A]
    is_match: jax.Array,  # bool[S+1] own-match flag
    cls_padded: jax.Array,  # int32[N + max_depth]
    max_depth: int,
    num_planes: int,
) -> jax.Array:
    """Returns uint32[num_planes, N] match bitplanes."""
    n = cls_padded.shape[0] - max_depth
    # Depth 0 transition from the root is a plain row gather.
    states0 = trie_next[0][cls_padded[:n]]
    planes0 = jnp.zeros((num_planes, n), dtype=jnp.uint32)
    planes0 = planes0.at[0].add(is_match[states0].astype(jnp.uint32))

    def body(k, carry):
        states, planes = carry
        chars = lax.dynamic_slice(cls_padded, (k,), (n,))
        states = trie_next[states, chars]
        bit = is_match[states].astype(jnp.uint32) << jnp.uint32(k % 32)
        planes = lax.dynamic_update_index_in_dim(
            planes, lax.dynamic_index_in_dim(planes, k // 32, 0, keepdims=False) | bit, k // 32, 0
        )
        return states, planes

    _, planes = lax.fori_loop(1, max_depth, body, (states0, planes0))
    return planes

