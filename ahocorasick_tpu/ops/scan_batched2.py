"""Stride-2 batched DFA scan — one gather per TWO characters (engine v4b).

A (S·A², 2)-shaped table delivers a two-character transition plus both
positions' emit masks in a single row gather:

    row[(s·A + c0)·A + c1] = [ state2 | emit_mask(state2) << state_bits,
                               emit_mask(state1) ]

where state1 = delta(s, c0), state2 = delta(state1, c1).  Everything else
mirrors ``scan_batched.py`` (same d-synchronizing halo, END-indexed planes),
with windows aligned to even offsets so pairs are well-formed.

Memory: S·A²·8 bytes — gated by ``fits()`` (e.g. a 50k-state/27-class
dictionary costs 292 MB; million-state dictionaries fall back to stride-1).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ahocorasick_tpu.core.compiler import CompiledMatcher
from ahocorasick_tpu.ops.scan_batched import PAD_CLASS, build_packed

_MAX_BYTES = 2 << 30


class Packed2Dfa(NamedTuple):
    table: np.ndarray  # uint32[S*A*A, 2]
    state_bits: int
    halo: int  # even, >= d
    num_classes: int


def fits(m: CompiledMatcher, max_bytes: int = _MAX_BYTES) -> bool:
    # Quotient rows for row-compressed matchers — the packed table's real
    # shape (scan_batched.effective_rows), like every sibling engine.
    from ahocorasick_tpu.ops.scan_batched import effective_rows

    S, A = effective_rows(m), m.num_classes
    d = max(m.max_depth, 1)
    state_bits = max(int(S - 1).bit_length(), 1)
    return state_bits + d <= 32 and S * A * A * 8 <= max_bytes


def build_packed2(m: CompiledMatcher) -> Packed2Dfa:
    pd = build_packed(m)
    assert pd.emit_mask is None, "stride-2 requires the packed-inline layout"
    S, A = pd.table.shape  # quotient rows for row-compressed matchers
    sb = pd.state_bits
    smask = np.uint32((1 << sb) - 1)
    p1 = pd.table  # uint32[S, A]: state1 | emit(state1) << sb
    state1 = p1 & smask  # (S, A)
    # Row for (s, c0): p1[state1[s, c0], :] gives state2|emit2 for every c1.
    v0 = p1[state1]  # (S, A, A) uint32: state2 | emit2 << sb
    v1 = np.broadcast_to((p1 >> np.uint32(sb))[:, :, None], v0.shape)  # emit1
    table = np.stack([v0, v1], axis=-1).reshape(S * A * A, 2)
    halo = pd.halo + (pd.halo % 2)
    return Packed2Dfa(np.ascontiguousarray(table), sb, halo, A)


def chunk_classes2(cls: np.ndarray, chunk: int, halo: int) -> np.ndarray:
    """(B, halo + chunk) windows with even chunk/halo (pairs well-formed).

    Same layout as ``scan_batched.chunk_classes`` (ONE window contract for
    every engine — ops/dispatch.py); this wrapper only asserts evenness."""
    assert chunk % 2 == 0 and halo % 2 == 0
    from ahocorasick_tpu.ops.scan_batched import chunk_classes

    return chunk_classes(cls, chunk, halo)


def _pair_indices(windows: jax.Array, A: int) -> jax.Array:
    B, W = windows.shape
    w2 = windows.reshape(B, W // 2, 2)
    return w2[:, :, 0] * A + w2[:, :, 1]  # (B, W/2)



@functools.partial(
    jax.jit, static_argnames=("halo", "state_bits", "num_classes", "num_planes")
)
def batched2_emit_planes(
    table: jax.Array,
    windows: jax.Array,
    halo: int,
    state_bits: int,
    num_classes: int,
    num_planes: int,
) -> jax.Array:
    """END-indexed emit planes uint32[num_planes, B*C] (text order)."""
    cc = _pair_indices(windows, num_classes)
    hp = halo // 2
    state_mask = jnp.uint32((1 << state_bits) - 1)
    AA = jnp.uint32(num_classes * num_classes)

    def warm(s, c):
        v = table[s * AA + c.astype(jnp.uint32)]
        return v[:, 0] & state_mask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, cc[:, :hp].T)

    def step(s, c):
        v = table[s * AA + c.astype(jnp.uint32)]
        return v[:, 0] & state_mask, (v[:, 1], v[:, 0] >> jnp.uint32(state_bits))

    _, (m1, m2) = lax.scan(step, s_h, cc[:, hp:].T)  # each (P, B)
    B = windows.shape[0]
    # Interleave: position 2t gets m1[t], 2t+1 gets m2[t].
    inter = jnp.stack([m1.T, m2.T], axis=-1).reshape(B, -1)  # (B, C)
    masks = inter.reshape(-1)
    planes = jnp.zeros((num_planes, masks.shape[0]), dtype=jnp.uint32)
    planes = planes.at[0].set(masks)
    return planes
