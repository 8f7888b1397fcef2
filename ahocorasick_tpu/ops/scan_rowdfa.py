"""Row-gather DFA scans — whole-row gathers + fused column select (v6/v7).

Two engines share this file:

v7 ``rowdfa1`` — stride 1: gather ``row = table[s]`` (the v4 packed table,
rows padded to x8 / columns to a power of two), select column ``c`` with a
fused one-hot reduce.  One row gather per character.

v6 ``rowdfa2`` — stride 2: rows indexed by ``(s, c0)``:

    row[(s, c0)] = [ state2 | emit2 << state_bits  for every c1 ] ++ [ emit1 ]

where state1 = delta(s, c0), state2 = delta(state1, c1); the fixed last
column carries emit1 = emit_mask(state1) — a pure function of the row
index — so ONE gather yields both positions' emit masks and the next
state.  Two characters per row gather, but the table is S·A·(A+1)·4
bytes.

``pick_engine`` chooses among these and the batched element-gather scan
(``scan_batched``) by per-character cost measured on the card.  Semantics
are identical to ``scan_batched`` (same d-synchronizing halo warmup,
END-indexed emit bitplanes; reference hot loop
``AhoCorasickSet.java:204-226``, suffix-chain emits ``:522-535``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ahocorasick_tpu.core.compiler import CompiledMatcher
from ahocorasick_tpu.ops.scan_batched import PAD_CLASS, build_packed, effective_rows

# Stride-2 table budget: the largest stride-2 table measured on the card,
# 156 MB (10k keywords), scanned at the small-table rate (0.081 vs 0.078
# ns/char at 2 MB; H100 80GB HBM3, 400 W power limit).  Larger tables were
# not measured.
_MAX_BYTES = 160 << 20
# The fused column select does A_pad one-hot ops per character per lane.
# On the card rowdfa2 beat batched at 27 classes (0.076 vs 0.119 ns/char)
# and lost from 63 classes up (0.113 vs 0.110 at 63, 0.184 vs 0.160 at
# 511; H100 80GB HBM3, 700 W power limit); 28-62 classes not measured.
_MAX_SELECT_CLASSES = 32


class RowDfa(NamedTuple):
    table: np.ndarray  # uint32[S*A, A+1]: cols 0..A-1 packed next, col A emit1
    state_bits: int
    halo: int  # even, >= d
    num_classes: int


class RowDfa1(NamedTuple):
    table: np.ndarray  # uint32[S_pad, A_pad]: next | emit << state_bits
    state_bits: int
    halo: int
    num_classes: int


def fits(m: CompiledMatcher, max_bytes: int | None = None) -> bool:
    """Stride-2 row table fits the budget."""
    if max_bytes is None:
        max_bytes = _MAX_BYTES
    S, A = effective_rows(m), m.num_classes
    d = max(m.max_depth, 1)
    state_bits = max(int(S - 1).bit_length(), 1)
    return (
        state_bits + d <= 32
        and A <= _MAX_SELECT_CLASSES
        and S * A * (A + 1) * 4 <= max_bytes
    )


def fits1(m: CompiledMatcher) -> bool:
    """Stride-1 row engine applies: packed-inline layout and an alphabet
    the one-hot select admits (no size budget: the card showed no cliff,
    0.146 -> 0.148 ns/char from an 87 KB to a 59 MB table)."""
    S, A = effective_rows(m), m.num_classes
    d = max(m.max_depth, 1)
    state_bits = max(int(S - 1).bit_length(), 1)
    Ap = max(8, 1 << (A - 1).bit_length())
    return state_bits + d <= 32 and Ap <= _MAX_SELECT_CLASSES


def build_rowdfa1(m: CompiledMatcher) -> RowDfa1:
    """The v4 packed table with minimal padding (rows to x8, cols to pow2)."""
    pd = build_packed(m)
    assert pd.emit_mask is None, "row engine requires the packed-inline layout"
    S, A = pd.table.shape  # quotient rows for row-compressed matchers
    Ap = max(8, 1 << (A - 1).bit_length())
    Sp = -(-S // 8) * 8
    table = np.zeros((Sp, Ap), dtype=np.uint32)
    table[:S, :A] = pd.table
    return RowDfa1(table, pd.state_bits, pd.halo, A)


def build_rowdfa(m: CompiledMatcher) -> RowDfa:
    pd = build_packed(m)
    assert pd.emit_mask is None, "row engine requires the packed-inline layout"
    S, A = pd.table.shape  # quotient rows for row-compressed matchers
    sb = pd.state_bits
    smask = np.uint32((1 << sb) - 1)
    p1 = pd.table  # uint32[S, A] = state1 | emit(state1) << sb
    state1 = (p1 & smask).reshape(S * A)  # row index (s, c0) -> state1
    body = p1[state1]  # (S*A, A): state2 | emit2 << sb for every c1
    emit1 = (p1 >> np.uint32(sb)).reshape(S * A, 1)  # emit(state1)
    table = np.concatenate([body, emit1], axis=1)
    halo = pd.halo + (pd.halo % 2)
    return RowDfa(np.ascontiguousarray(table), sb, halo, A)


def chunk_classes2(cls: np.ndarray, chunk: int, halo: int) -> np.ndarray:
    """(B, halo + chunk) windows, even chunk/halo (pairs well-formed).

    Delegates to ``scan_batched.chunk_classes`` — ONE window contract for
    every engine (ops/dispatch.py module doc)."""
    assert chunk % 2 == 0 and halo % 2 == 0
    from ahocorasick_tpu.ops.scan_batched import chunk_classes

    return chunk_classes(cls, chunk, halo)


def _select_col(rows: jax.Array, c1: jax.Array, A: int) -> jax.Array:
    """Per-lane column select rows[i, c1[i]] as a fusable one-hot reduce."""
    iota = lax.broadcasted_iota(jnp.int32, (1, A), 1)
    oh = iota == c1[:, None]
    return jnp.sum(jnp.where(oh, rows[:, :A], jnp.uint32(0)), axis=1)


# Per-character kernel cost (ns) by engine, measured on the card with data
# on the device (``bench.ac_kernel_rate``, ``tools/engine_costs.py``) at the
# headline shape: 10k keywords, 32 Mi units; H100 80GB HBM3, 400 W power
# limit (a 700 W card read 0.119 / 0.134 / 0.076).  Every engine steps one
# character (rowdfa2: two) per ``lax.scan`` iteration, so the per-step
# loop, not the table bytes, sets the cost.
_NS_BATCHED = 0.129  # one element gather per character
_NS_ROWDFA1 = 0.142  # one row gather + one-hot select
_NS_ROWDFA2 = 0.081  # one row gather per TWO characters


def pick_engine(m: CompiledMatcher) -> str:
    """Cheapest applicable device engine by the per-character cost table."""
    cands = [("batched", _NS_BATCHED)]
    if fits1(m):
        cands.append(("rowdfa1", _NS_ROWDFA1))
    if fits(m):
        cands.append(("rowdfa2", _NS_ROWDFA2))
    return min(cands, key=lambda kv: kv[1])[0]


@functools.partial(jax.jit, static_argnames=("halo", "state_bits", "num_classes"))
def rowdfa1_count(
    table: jax.Array,  # uint32[S_pad, A_pad] packed next | emit << state_bits
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    state_bits: int,
    num_classes: int,
) -> jax.Array:
    """Stride-1 row-gather count: one whole-row gather per character."""
    A = num_classes
    state_mask = jnp.uint32((1 << state_bits) - 1)

    def warm(s, c):
        v = _select_col(table[s], c, A)
        return v & state_mask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(carry, c):
        s, pop = carry
        v = _select_col(table[s], c, A)
        dp = lax.population_count(v >> jnp.uint32(state_bits))
        return (v & state_mask, pop + dp.astype(jnp.int32)), None

    pop0 = (windows[:, 0] * 0).astype(jnp.int32)
    (_, pop), _ = lax.scan(step, (s_h, pop0), windows[:, halo:].T)
    return jnp.sum(pop)


@functools.partial(jax.jit, static_argnames=("halo", "state_bits", "num_classes"))
def rowdfa1_emit_planes(
    table: jax.Array,  # uint32[S_pad, A_pad]
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    state_bits: int,
    num_classes: int,
) -> jax.Array:
    """END-indexed emit planes uint32[1, B*C] via stride-1 row gathers.

    Packed-inline layout guarantees the emit mask fits one plane
    (state_bits + max_depth <= 32, see ``build_packed``)."""
    A = num_classes
    B, W = windows.shape
    state_mask = jnp.uint32((1 << state_bits) - 1)

    def warm(s, c):
        v = _select_col(table[s], c, A)
        return v & state_mask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(s, c):
        v = _select_col(table[s], c, A)
        return v & state_mask, v >> jnp.uint32(state_bits)

    _, masks = lax.scan(step, s_h, windows[:, halo:].T)  # (C, B)
    return masks.T.reshape(1, -1)


@functools.partial(jax.jit, static_argnames=("halo", "state_bits", "num_classes"))
def rowdfa_count(
    table: jax.Array,  # uint32[S*A, A+1]
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    state_bits: int,
    num_classes: int,
) -> jax.Array:
    A = num_classes
    B, W = windows.shape
    w2 = windows.reshape(B, W // 2, 2)
    hp = halo // 2
    state_mask = jnp.uint32((1 << state_bits) - 1)
    Au = jnp.uint32(A)

    def warm(s, c01):
        rows = table[s * Au + c01[:, 0].astype(jnp.uint32)]
        v = _select_col(rows, c01[:, 1], A)
        return v & state_mask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, w2[:, :hp].transpose(1, 0, 2))

    def step(carry, c01):
        s, pop = carry
        rows = table[s * Au + c01[:, 0].astype(jnp.uint32)]
        v = _select_col(rows, c01[:, 1], A)
        dp = lax.population_count(v >> jnp.uint32(state_bits))
        dp = dp + lax.population_count(rows[:, A])
        return (v & state_mask, pop + dp.astype(jnp.int32)), None

    pop0 = (windows[:, 0] * 0).astype(jnp.int32)
    (_, pop), _ = lax.scan(step, (s_h, pop0), w2[:, hp:].transpose(1, 0, 2))
    return jnp.sum(pop)


@functools.partial(
    jax.jit, static_argnames=("halo", "state_bits", "num_classes", "num_planes")
)
def rowdfa_emit_planes(
    table: jax.Array,
    windows: jax.Array,
    halo: int,
    state_bits: int,
    num_classes: int,
    num_planes: int,
) -> jax.Array:
    """END-indexed emit planes uint32[num_planes, B*C] in text order.

    Plane bit L-1 at flat position j: a keyword of length L ends at j
    (inclusive; reference end = j+1).  num_planes is 1 while
    state_bits + max_depth <= 32 (the fits() gate).
    """
    A = num_classes
    B, W = windows.shape
    w2 = windows.reshape(B, W // 2, 2)
    hp = halo // 2
    state_mask = jnp.uint32((1 << state_bits) - 1)
    Au = jnp.uint32(A)

    def warm(s, c01):
        rows = table[s * Au + c01[:, 0].astype(jnp.uint32)]
        v = _select_col(rows, c01[:, 1], A)
        return v & state_mask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, w2[:, :hp].transpose(1, 0, 2))

    def step(s, c01):
        rows = table[s * Au + c01[:, 0].astype(jnp.uint32)]
        v = _select_col(rows, c01[:, 1], A)
        return v & state_mask, (rows[:, A], v >> jnp.uint32(state_bits))

    _, (m1, m2) = lax.scan(step, s_h, w2[:, hp:].transpose(1, 0, 2))
    # m1[t] is the emit mask for position 2t, m2[t] for 2t+1 (within chunk).
    inter = jnp.stack([m1.T, m2.T], axis=-1).reshape(B, -1)  # (B, C)
    masks = inter.reshape(-1)
    planes = jnp.zeros((num_planes, masks.shape[0]), dtype=jnp.uint32)
    planes = planes.at[0].set(masks)
    return planes
