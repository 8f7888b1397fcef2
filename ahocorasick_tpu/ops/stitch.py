"""Chunk stitching via state-map composition (``associative_scan``).

The reference's stream mode proves that automaton state across a buffer
boundary is a single node pointer (``AhoCorasickMap.java:208-275``).  The
parallel generalization: split the text into C chunks, compute for every chunk
the *state map* sigma_c : S -> S ("if I enter this chunk in state s, I leave
in sigma_c[s]") by scanning all S lanes at once, then compose the maps with
``jax.lax.associative_scan`` — function composition over a finite domain is
associative — to recover each chunk's true entry state in O(log C) depth.
A second pass re-scans chunks from their entry states to materialize exact
arrival states, bit-identical to the sequential scan.

Cost: the map pass does S lanes of work per character, so this engine suits
small automata (S up to a few hundred) or validation; the PFAC engine
(``scan_pfac.py``) is the production path for all-matches kinds, and batch
parallelism covers large-S sequential semantics.

Works for *any* total transition function, including the shortest matcher's
restart-at-root semantics once baked into an effective table (see
``_DeviceTables.dfa_next_shortest``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


@jax.jit
def chunk_state_maps(dfa_next: jax.Array, cls_chunks: jax.Array) -> jax.Array:
    """sigma maps for each chunk: (C, K) classes -> (C, S) exit states."""
    S = dfa_next.shape[0]
    C = cls_chunks.shape[0]
    v0 = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (C, S))

    def step(v, c):
        # v: (C, S) current states per entry-state lane; c: (C,) this char.
        return dfa_next[v, c[:, None]], None

    sigma, _ = lax.scan(step, v0, cls_chunks.T)
    return sigma


@jax.jit
def entry_states(sigma: jax.Array, s0: jax.Array = 0) -> jax.Array:
    """Entry state of each chunk given per-chunk maps, via associative scan.

    ``s0``: the automaton state entering chunk 0 (root by default; a carried
    stream-cursor state when stitching mid-stream buffers).
    """

    def compose(a, b):
        # (sigma_a then sigma_b)[s] = sigma_b[sigma_a[s]], batched over chunks.
        return jnp.take_along_axis(b, a, axis=-1)

    cum = lax.associative_scan(compose, sigma, axis=0)
    C = sigma.shape[0]
    s0 = jnp.asarray(s0, dtype=sigma.dtype)
    # Chunk 0 enters at s0; chunk c>0 at (sigma_0 ∘ .. ∘ sigma_{c-1})[s0].
    prev = cum[: C - 1, s0]
    return jnp.concatenate([s0[None], prev])


@jax.jit
def stitched_states(dfa_next: jax.Array, cls_chunks: jax.Array, entry: jax.Array) -> jax.Array:
    """Re-scan each chunk from its true entry state: (C, K) arrival states."""

    def step(s, c):
        s2 = dfa_next[s, c]
        return s2, s2

    def one(chunk, s0):
        _, states = lax.scan(step, s0, chunk)
        return states

    return jax.vmap(one)(cls_chunks, entry.astype(jnp.int32))


def stitched_scan(dfa_next: jax.Array, cls_chunks: jax.Array, s0=0) -> jax.Array:
    """Full pipeline: chunked classes (C, K) -> exact arrival states (C, K)."""
    if cls_chunks.shape[0] == 0:
        # Zero chunks: entry_states' concatenate would yield a length-1
        # batch and break the vmap below; nothing to scan.
        return jnp.zeros_like(cls_chunks, dtype=jnp.int32)
    sigma = chunk_state_maps(dfa_next, cls_chunks)
    entry = entry_states(sigma, s0)
    return stitched_states(dfa_next, cls_chunks, entry)
