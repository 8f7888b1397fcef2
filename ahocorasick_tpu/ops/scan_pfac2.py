"""PFAC v2: the gather-minimized failureless scan.

The v1 engine (``scan_pfac.py``) spends 2 gathers per lane per depth step
(trie transition + is_match lookup).  Gathers are the whole cost of the
walk, so v2 halves-then-thirds the gather count:

* **Match-contiguous renumbering** — device-side state ids are permuted so
  root is 0 and all own-match states form the tail range
  ``[match_threshold, S)``.  ``is_match[s]`` becomes ``s >= threshold``: a
  compare, not a gather.  (Host tables keep canonical ids; the
  permutation is a device-layout concern, see ``models/matchers.py``.)
* **Prefix-k jump table** — the first ``k`` depth steps from the root are
  precomputed for every k-gram of alphabet classes: ``prefix[(c0*A+c1)...]``
  packs the arrival state with the depth-1..k match bits in the top bits of
  a uint32.  One gather into an ``A^k``-entry table (small for compact
  alphabets) replaces ``2k`` table gathers.  ``k`` adapts to the
  alphabet so the table stays small.

Work per lane for max depth d: ``1 + max(d - k, 0)`` gathers (v1: ``2d``).

Exactness: identical bitplane output to v1 (conformance-tested); padding
uses ``PAD_CLASS`` exactly as v1 (pad class has no trie edge, so prefix
entries through it land at DEAD and carry no match bits).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ahocorasick_tpu.core.compiler import CompiledMatcher

PAD_CLASS = 0

_STATE_BITS = 28
_STATE_MASK = (1 << _STATE_BITS) - 1  # low bits: ranked state id
_MAX_PREFIX_ENTRIES = 1 << 20


class RankedTables(NamedTuple):
    """Device layout for the v2 engine (host-side numpy; upload once)."""

    trie_next: np.ndarray  # uint32[S+1, A] ranked ids (row order ranked too)
    prefix: np.ndarray  # uint32[A^k] packed (state | match bits << _STATE_BITS)
    prefix_k: int
    match_threshold: int  # ranked id of the first own-match state
    num_states: int  # S+1 rows
    dead_state: int  # ranked id of the absorbing DEAD state


def rank_states(m: CompiledMatcher) -> np.ndarray:
    """Permutation old_id -> ranked_id: root 0, non-match (incl. DEAD) next,
    own-match states contiguous at the top."""
    S = m.num_states
    is_match = m.own_len[: S + 1] > 0  # includes DEAD row (False)
    ranked = np.empty(S + 1, dtype=np.int64)
    ids = np.arange(S + 1)
    nonmatch = ids[~is_match]
    match = ids[is_match]
    # root is state 0 and never a match (empty keywords are skipped).
    order = np.concatenate([nonmatch, match])  # root stays first
    ranked[order] = np.arange(S + 1)
    assert ranked[0] == 0
    return ranked


def build_ranked(m: CompiledMatcher, max_entries: int = _MAX_PREFIX_ENTRIES) -> RankedTables:
    S, A = m.num_states, m.num_classes
    ranked = rank_states(m)
    threshold = int(S + 1 - int((m.own_len[: S + 1] > 0).sum()))

    # Row-permuted, value-mapped transition table.
    inv = np.empty(S + 1, dtype=np.int64)
    inv[ranked] = np.arange(S + 1)
    trie_ranked = ranked[m.trie_next[inv]].astype(np.uint32)

    # Prefix-k jump table over alphabet k-grams (walked on the trie).
    k = 1
    while k < 3 and (A ** (k + 1)) <= max_entries and k + 1 <= max(m.max_depth, 1):
        k += 1
    states = trie_ranked[0]  # depth-1 states for each class, shape (A,)
    packed = states | (states >= threshold).astype(np.uint32) << np.uint32(_STATE_BITS)
    for depth in range(2, k + 1):
        nxt = trie_ranked[packed & _STATE_MASK]  # (A^(depth-1), A)
        bits = (packed >> np.uint32(_STATE_BITS)) << np.uint32(1)  # shift history
        packed = (
            nxt
            | (bits[:, None] << np.uint32(_STATE_BITS))
            | (nxt >= threshold).astype(np.uint32) << np.uint32(_STATE_BITS)
        ).reshape(-1)
    # Bit layout after k steps: bit (_STATE_BITS + j) == match at depth k - j.
    return RankedTables(
        trie_next=trie_ranked,
        prefix=packed.astype(np.uint32),
        prefix_k=k,
        match_threshold=threshold,
        num_states=S + 1,
        dead_state=int(ranked[S]),
    )


from ahocorasick_tpu.ops.scan_pfac import pad_classes  # noqa: E402,F401 — ONE padding contract


def _gram_index(cls_padded: jax.Array, n: int, k: int, A: int) -> jax.Array:
    idx = cls_padded[:n]
    for j in range(1, k):
        idx = idx * A + lax.dynamic_slice(cls_padded, (j,), (n,))
    return idx


@functools.partial(
    jax.jit, static_argnames=("max_depth", "num_planes", "prefix_k", "num_classes")
)
def pfac2_bitplanes(
    trie_next: jax.Array,  # uint32[S+1, A] ranked
    prefix: jax.Array,  # uint32[A^k]
    threshold: jax.Array,  # uint32 scalar
    cls_padded: jax.Array,  # int32[N + max_depth]
    max_depth: int,
    num_planes: int,
    prefix_k: int,
    num_classes: int,
) -> jax.Array:
    """uint32[num_planes, N] match bitplanes, identical to v1's output."""
    # Guard: k-gram entries index the A^prefix_k table; a max_depth
    # below prefix_k would read the WRONG gram's entry and silently
    # drop every match (production depth bucketing satisfies this).
    assert max_depth >= prefix_k, (max_depth, prefix_k)
    n = cls_padded.shape[0] - max_depth
    k = min(prefix_k, max_depth)
    packed = prefix[_gram_index(cls_padded, n, k, num_classes)]
    states = packed & jnp.uint32(_STATE_MASK)
    hist = packed >> jnp.uint32(_STATE_BITS)  # bit j == match at depth k-j

    planes0 = jnp.zeros((num_planes, n), dtype=jnp.uint32)
    # Scatter history bits into plane 0 (depths 1..k all live in plane 0:
    # prefix_k <= 3 << 32).
    for depth in range(1, k + 1):
        bit = (hist >> jnp.uint32(k - depth)) & jnp.uint32(1)
        planes0 = planes0.at[0].add(bit << jnp.uint32(depth - 1))

    def body(kk, carry):
        st, planes = carry
        chars = lax.dynamic_slice(cls_padded, (kk,), (n,))
        st = trie_next[st, chars]
        bit = (st >= threshold).astype(jnp.uint32) << jnp.uint32(kk % 32)
        planes = lax.dynamic_update_index_in_dim(
            planes,
            lax.dynamic_index_in_dim(planes, kk // 32, 0, keepdims=False) | bit,
            kk // 32,
            0,
        )
        return st, planes

    if max_depth > k:
        _, planes = lax.fori_loop(k, max_depth, body, (states, planes0))
    else:
        planes = planes0
    return planes


@functools.partial(jax.jit, static_argnames=("max_depth", "prefix_k", "num_classes"))
def pfac2_count(
    trie_next: jax.Array,
    prefix: jax.Array,
    threshold: jax.Array,
    cls_padded: jax.Array,
    max_depth: int,
    prefix_k: int,
    num_classes: int,
) -> jax.Array:
    """Total match count (empty-listener analog): scalar int64-safe int32."""
    # Guard: k-gram entries index the A^prefix_k table; a max_depth
    # below prefix_k would read the WRONG gram's entry and silently
    # drop every match (production depth bucketing satisfies this).
    assert max_depth >= prefix_k, (max_depth, prefix_k)
    n = cls_padded.shape[0] - max_depth
    k = min(prefix_k, max_depth)
    packed = prefix[_gram_index(cls_padded, n, k, num_classes)]
    states = packed & jnp.uint32(_STATE_MASK)
    hist = packed >> jnp.uint32(_STATE_BITS)
    # popcount of k history bits per lane.
    total = jnp.sum(
        sum(((hist >> jnp.uint32(j)) & jnp.uint32(1)) for j in range(k)).astype(jnp.int32)
    )

    def body(kk, carry):
        st, tot = carry
        chars = lax.dynamic_slice(cls_padded, (kk,), (n,))
        st = trie_next[st, chars]
        return st, tot + jnp.sum((st >= threshold).astype(jnp.int32))

    if max_depth > k:
        _, total = lax.fori_loop(k, max_depth, body, (states, total))
    return total
