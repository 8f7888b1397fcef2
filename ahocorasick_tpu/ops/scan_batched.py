"""Batched-halo DFA scan — one gather per character (engine v4).

Scan cost is counted in table gathers per character.  The PFAC engines
spend one gather per character *per depth*; this engine spends ONE per
character total:

* The goto-closure DFA state after any position is the longest suffix of
  the input that is a trie prefix — a function of at most the last
  ``max_depth - 1`` characters.  The automaton is therefore
  (d-1)-synchronizing: starting a chunk from the root and consuming a
  ``d-1``-character halo converges to the exact sequential state.  Chunks
  then scan *in parallel lanes* with a sequential ``lax.scan`` over chunk
  positions — B independent gathers per step saturate the gather unit.
  (The reference proves the same invariant differently: stream mode carries
  one node across buffer refills, ``AhoCorasickMap.java:208-275``.)

* Emit information rides along for free: table values pack
  ``next_state | emit_mask << state_bits``, where bit ``L-1`` of
  ``emit_mask`` means "a keyword of length L ends here" (the state's full
  suffix-chain emit set, ``AhoCorasickSet.java:522-535``).  The scan output
  is END-indexed bitplanes; extraction mirrors the PFAC path.

Applies to the AC and LONGEST kinds (whose candidate sets are
position-local).  The SHORTEST kind's restart semantics destroy
synchronization (state depends on global match history), so it keeps the
sigma-stitched path.

When the packed layout doesn't fit (state_bits + max_depth > 32, i.e.
million-keyword dictionaries with long keywords), a second per-character
emit gather is used instead — still 2 gathers/char vs the PFAC d+.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ahocorasick_tpu.core.compiler import CompiledMatcher, RowTable

PAD_CLASS = 0


class PackedDfa(NamedTuple):
    table: np.ndarray  # uint32[S_eff, A]: next | emit_mask << state_bits (packed mode)
    emit_mask: Optional[np.ndarray]  # uint32[S, P] emit planes when split, else None
    state_bits: int  # 32 when not packed inline
    halo: int  # d - 1


def effective_rows(m: CompiledMatcher) -> int:
    """Scan-state count of the packed device automaton.

    Row-compressed matchers scan the *quotient* DFA over distinct
    goto-closure rows (see ``build_packed``), so their device state count is
    the number of distinct rows, not trie states."""
    if m.is_row_compressed and isinstance(m.dfa_next, RowTable):
        return m.dfa_next.rows.shape[0]
    return m.num_states


def inline_packable(m: CompiledMatcher) -> bool:
    """Packed-inline layout applies: scan-state bits + emit bits fit 32."""
    d = max(m.max_depth, 1)
    s_eff = effective_rows(m)
    return max(int(s_eff - 1).bit_length(), 1) + d <= 32


def quotient_packable(m: CompiledMatcher) -> bool:
    """A row-compressed matcher has a device layout: its quotient DFA packs
    inline (wide-alphabet dictionaries have few distinct rows, so this holds
    except for pathological row-count x keyword-length combinations)."""
    return (
        m.is_row_compressed
        and isinstance(m.dfa_next, RowTable)
        and inline_packable(m)
    )


def _state_emit_planes(m: CompiledMatcher) -> np.ndarray:
    """Per-state emit planes uint32[S, P]: bit L-1 (plane (L-1)//32) set iff
    a keyword of length L ends at this state (own + suffix chain,
    ``AhoCorasickSet.java:522-535``) — vectorized for million-state dicts."""
    S = m.num_states
    d = max(m.max_depth, 1)
    P = (d + 31) // 32
    planes = np.zeros((S, P), dtype=np.uint32)
    if m.emit_count is not None:
        counts = m.emit_count[:S].astype(np.int64)
        pos = np.nonzero(counts)[0]
        if len(pos):
            reps = counts[pos]
            total = int(reps.sum())
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(reps) - reps, reps
            )
            eidx = np.repeat(m.emit_start[pos].astype(np.int64), reps) + offs
            st_rep = np.repeat(pos, reps)
            bit = m.emit_len[eidx].astype(np.int64) - 1
            np.bitwise_or.at(
                planes, (st_rep, bit >> 5), np.uint32(1) << (bit & 31).astype(np.uint32)
            )
    return planes


def build_packed(m: CompiledMatcher) -> PackedDfa:
    """Packed scan table.  Dense matchers: ``next | emit << state_bits`` over
    trie states.  Row-compressed matchers: the same layout over the QUOTIENT
    DFA whose states are the distinct goto-closure rows — the row-dedup map
    ``row_id`` is a DFA homomorphism (states sharing a row share all
    transition targets), and the emit mask of the concrete target
    ``rows[r, c]`` is a pure function of ``(r, c)``, so the quotient scan
    emits exactly the sequential automaton's END-indexed masks.  This is what
    lets testFullNode-scale dictionaries (64Ki single-char keywords,
    ``SetTest.java:73-79``) scan on device from a few-KB table."""
    d = max(m.max_depth, 1)
    # Halo is d, not d-1: the deepest state (a complete longest keyword) has
    # depth d, so convergence needs d characters of history.
    halo = d
    planes = _state_emit_planes(m)

    if m.is_row_compressed:
        rt = m.dfa_next
        if not isinstance(rt, RowTable):
            raise ValueError(f"kind {m.kind!r} has no goto-closure table")
        R = rt.rows.shape[0]
        rid_bits = max(int(R - 1).bit_length(), 1)
        if rid_bits + d > 32:
            raise ValueError(
                "row-compressed dictionary has no packed device layout "
                f"({R} rows, max depth {d})"
            )
        # Compiler invariant: the root's row is row 0 (engines start at 0).
        assert int(rt.row_id[0]) == 0
        packed = rt.row_id[rt.rows].astype(np.uint32) | (
            planes[:, 0][rt.rows] << np.uint32(rid_bits)
        )
        return PackedDfa(packed, None, rid_bits, halo)

    S = m.num_states
    state_bits = max(int(S - 1).bit_length(), 1)
    if state_bits + d <= 32:
        packed = m.dfa_next.astype(np.uint32) | (
            planes[:, 0][m.dfa_next] << np.uint32(state_bits)
        )
        return PackedDfa(packed, None, state_bits, halo)
    return PackedDfa(m.dfa_next.astype(np.uint32), planes, 32, halo)


def count_packable(m: CompiledMatcher) -> bool:
    """Count-packed layout applies: state bits + emit-COUNT bits fit 32.

    Huge dictionaries with long keywords overflow the packed-inline layout
    (state_bits + max_depth > 32) and pay two gathers per character on the
    split path.  Counting does not need the per-length emit mask — only how
    many keywords end at each position — and the per-state emit count is
    tiny (suffix-chain length), so ``next | count << state_bits`` restores
    the one-gather-per-character envelope for count-style scans.  The 1M-
    keyword BASELINE config (4.37M states = 23 bits, counts <= 5) is the
    motivating case.
    """
    if m.is_row_compressed or m.emit_count is None or m.dfa_next is None:
        return False
    state_bits = max(int(m.num_states - 1).bit_length(), 1)
    cap = 32 - state_bits
    if cap <= 0:
        return False
    return int(m.emit_count[: m.num_states].max(initial=0)) < (1 << cap)


def build_count_packed(m: CompiledMatcher):
    """uint32[S*A] flat: ``next | emit_count(next) << state_bits``."""
    assert count_packable(m)
    S, A = m.num_states, m.num_classes
    state_bits = max(int(S - 1).bit_length(), 1)
    counts = m.emit_count[:S].astype(np.uint32)
    packed = m.dfa_next.astype(np.uint32) | (
        counts[m.dfa_next] << np.uint32(state_bits)
    )
    return packed.reshape(S * A), state_bits, max(m.max_depth, 1)


@functools.partial(jax.jit, static_argnames=("halo", "state_bits", "num_classes"))
def packedcount_count(
    table_flat: jax.Array,  # uint32[S*A]: next | emit_count << state_bits
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    state_bits: int,
    num_classes: int,
) -> jax.Array:
    """One flat gather per character; the emit count rides the packed entry."""
    A = jnp.uint32(num_classes)
    smask = jnp.uint32((1 << state_bits) - 1)
    sb = jnp.uint32(state_bits)

    def warm(s, c):
        return table_flat[s * A + c.astype(jnp.uint32)] & smask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(carry, c):
        s, pop = carry
        v = table_flat[s * A + c.astype(jnp.uint32)]
        # Per-LANE accumulate; one cross-lane reduction at the end (a
        # per-step scalar sum is a B->1 tree reduce every character).
        return (v & smask, pop + (v >> sb).astype(jnp.int32)), None

    pop0 = (windows[:, 0] * 0).astype(jnp.int32)
    (_, pop), _ = lax.scan(step, (s_h, pop0), windows[:, halo:].T)
    return jnp.sum(pop)


def hotstate_layout(m: CompiledMatcher) -> bool:
    """Huge-dictionary extraction layout: packed-inline overflows
    (state_bits + max_depth > 32) but ``next | emit_count << state_bits``
    fits.  The scan then spends ONE gather per character (vs the split
    path's 1 + P) and outputs the packed (state, count) word at positions
    where any keyword ends; emit masks are recovered host-side from the
    state id (``hotstate_sparse``).  The 1M-keyword BASELINE config
    (4.37M states, depth 12) is the motivating case."""
    return (
        m.dfa_next is not None
        and not m.is_row_compressed
        and not inline_packable(m)
        and count_packable(m)
    )


@functools.partial(jax.jit, static_argnames=("halo", "state_bits", "num_classes"))
def packedcount_hotstate_plane(
    table_flat: jax.Array,  # uint32[S*A]: next | emit_count << state_bits
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    state_bits: int,
    num_classes: int,
) -> jax.Array:
    """uint32[1, B*C]: the packed table word at each position whose arrival
    state ends >=1 keyword, 0 elsewhere.  One flat gather per character;
    rides the same sparse-compaction download as the emit-plane engines."""
    A = jnp.uint32(num_classes)
    smask = jnp.uint32((1 << state_bits) - 1)
    sb = jnp.uint32(state_bits)

    def warm(s, c):
        return table_flat[s * A + c.astype(jnp.uint32)] & smask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(s, c):
        v = table_flat[s * A + c.astype(jnp.uint32)]
        return v & smask, jnp.where((v >> sb) != 0, v, jnp.uint32(0))

    _, vs = lax.scan(step, s_h, windows[:, halo:].T)  # (C, B)
    return vs.T.reshape(1, -1)


import weakref as _weakref
from collections import OrderedDict as _OrderedDict

_HOST_EMIT_PLANES: "_OrderedDict[int, tuple]" = _OrderedDict()


def host_emit_planes(m: CompiledMatcher) -> np.ndarray:
    """Cached host copy of the per-state emit planes (LRU of 4 matchers).

    Entries hold a WEAK reference to the matcher: huge-dictionary planes
    are hundreds of MB, and a strong ref would pin the matcher's full
    tables after callers drop it; the entry self-evicts when the matcher
    is collected."""
    key = id(m)
    ent = _HOST_EMIT_PLANES.get(key)
    if ent is not None and ent[0]() is m:
        _HOST_EMIT_PLANES.move_to_end(key)
        return ent[1]
    planes = _state_emit_planes(m)

    def _evict(_ref, _key=key):
        _HOST_EMIT_PLANES.pop(_key, None)

    _HOST_EMIT_PLANES[key] = (_weakref.ref(m, _evict), planes)
    if len(_HOST_EMIT_PLANES) > 4:
        _HOST_EMIT_PLANES.popitem(last=False)
    return planes


def hotstate_sparse(m: CompiledMatcher, bits, n: int):
    """Hotstate plane -> ``(idx, masks[P])`` — the same contract as
    ``planes_to_sparse`` on the emit-plane engines, so every downstream
    consumer (sparse extraction, fused native extract+resolve) is shared.
    """
    S = m.num_states
    sb = max(int(S - 1).bit_length(), 1)
    smask = np.uint32((1 << sb) - 1)
    planes_tab = host_emit_planes(m)
    sp = planes_to_sparse(bits, n)
    if sp is not None:
        idx, packed = sp
        states = (packed[:, 0] & smask).astype(np.int64)
        return idx, planes_tab[states]
    v = np.asarray(bits)[0, :n]
    idx = np.nonzero(v)[0].astype(np.int64)
    states = (v[idx] & smask).astype(np.int64)
    return idx, planes_tab[states]


def class_dtype(num_classes: int):
    """Narrowest dtype holding class ids in [0, num_classes): uint8 / uint16.

    Classes are ALWAYS < 65536 (charmap is BMP-unit indexed), so windows
    never need int32; uploading narrow classes and widening on device cuts
    the host->device transfer (the dominant end-to-end term on
    directly-attached hardware) 4x for every baseline dictionary
    (num_classes < 256 in all of them) — the reference's zero-copy hot
    loop ethos (README.md:20,27) applied to the PCIe link."""
    return np.uint8 if num_classes <= 256 else np.uint16


def chunk_classes(
    cls: np.ndarray, chunk: int, halo: int, num_classes: Optional[int] = None
) -> np.ndarray:
    """(B, halo + chunk) windows: chunk i covers [i*chunk, (i+1)*chunk) with a
    left halo (PAD_CLASS beyond the text; PAD resets lanes toward the root,
    which is harmless — the halo re-synchronizes them).

    ``num_classes`` selects the narrow upload dtype (``class_dtype``);
    None keeps int32 (engines widen lazily in their index arithmetic, so
    both layouts scan identically)."""
    n = len(cls)
    B = -(-max(n, 1) // chunk)
    p = np.pad(cls, (halo, B * chunk - n), constant_values=PAD_CLASS)
    # left halo of chunk i = p[i*chunk : i*chunk + halo]; body follows it.
    idx = (np.arange(B) * chunk)[:, None] + np.arange(halo + chunk)[None, :]
    dt = np.int32 if num_classes is None else class_dtype(num_classes)
    return p[idx].astype(dt)


@functools.partial(jax.jit, static_argnames=("halo", "state_bits", "num_planes"))
def batched_emit_planes(
    table: jax.Array,  # uint32[S, A] packed
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    state_bits: int,
    num_planes: int,
) -> jax.Array:
    """END-indexed emit bitplanes uint32[num_planes, B*C]: plane bit ``L-1``
    (within the plane stack) at flat position j means a keyword of length L
    ends at text position j (inclusive end j+1)."""
    B = windows.shape[0]
    C = windows.shape[1] - halo
    state_mask = jnp.uint32((1 << state_bits) - 1)
    # Flat 1D indexing ``table[s * A + c]``; the reshape is free (row-major).
    A = jnp.uint32(table.shape[1])
    tf = table.reshape(-1)

    def warm(s, c):
        return tf[s * A + c.astype(jnp.uint32)] & state_mask, None

    # Derive the root-state carry from the input so its sharding varyingness
    # matches inside shard_map bodies (plain zeros are 'replicated' there).
    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(s, c):
        v = tf[s * A + c.astype(jnp.uint32)]
        return v & state_mask, v >> jnp.uint32(state_bits)

    _, masks = lax.scan(step, s_h, windows[:, halo:].T)  # (C, B) emit masks
    masks = masks.T.reshape(-1)  # (B*C,) flat text order

    planes = jnp.zeros((num_planes, B * C), dtype=jnp.uint32)
    for p in range(num_planes):
        planes = planes.at[p].set((masks >> jnp.uint32(32 * p)) & jnp.uint32(0xFFFFFFFF))
    return planes


@functools.partial(jax.jit, static_argnames=("halo", "state_bits"))
def batched_count(
    table: jax.Array,
    windows: jax.Array,
    halo: int,
    state_bits: int,
) -> jax.Array:
    """Total match count: popcount of emit masks over all positions."""
    B = windows.shape[0]
    state_mask = jnp.uint32((1 << state_bits) - 1)
    A = jnp.uint32(table.shape[1])  # flat indexing: see batched_emit_planes
    tf = table.reshape(-1)

    def warm(s, c):
        return tf[s * A + c.astype(jnp.uint32)] & state_mask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(carry, c):
        s, pop = carry
        v = tf[s * A + c.astype(jnp.uint32)]
        dp = jax.lax.population_count(v >> jnp.uint32(state_bits))
        return (v & state_mask, pop + dp.astype(jnp.int32)), None

    pop0 = (windows[:, 0] * 0).astype(jnp.int32)
    (_, pop), _ = lax.scan(step, (s_h, pop0), windows[:, halo:].T)
    return jnp.sum(pop)


@functools.partial(jax.jit, static_argnames=("halo", "num_classes", "num_planes"))
def split_emit_planes(
    dfa_flat: jax.Array,  # int32[S*A] next-state table, flat s*A + c
    emit_tab: jax.Array,  # uint32[S, P] per-state emit planes
    windows: jax.Array,  # int32[B, halo + C]
    halo: int,
    num_classes: int,
    num_planes: int,
) -> jax.Array:
    """END-indexed emit planes for dictionaries whose packed layout overflows
    (state_bits + max_depth > 32): 1 + P element gathers per character.
    Reference analog: the same ``output()`` semantics, just a wider emit set
    (``AhoCorasickSet.java:522-535``)."""
    B = windows.shape[0]
    C = windows.shape[1] - halo
    # uint32 flat indices like every sibling engine: the split path serves
    # multi-million-state dictionaries where S*A exceeds int32 (a uint32-
    # overflowing table would need >16 GB and cannot exist on this part).
    A = jnp.uint32(num_classes)
    P = jnp.uint32(emit_tab.shape[1])
    ef = emit_tab.reshape(-1)  # flat: see batched_emit_planes

    def warm(s, c):
        return dfa_flat[s * A + c.astype(jnp.uint32)], None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(s, c):
        s2 = dfa_flat[s * A + c.astype(jnp.uint32)]
        if num_planes == 1:
            em = ef[s2 * P][:, None]
        else:
            em = jnp.stack(
                [ef[s2 * P + jnp.uint32(p)] for p in range(num_planes)], axis=1
            )  # (B, P)
        return s2, em

    _, masks = lax.scan(step, s_h, windows[:, halo:].T)  # (C, B, P)
    flat = masks.transpose(2, 1, 0).reshape(num_planes, B * C)
    return flat


@functools.partial(jax.jit, static_argnames=("halo", "num_classes", "num_planes"))
def split_count(
    dfa_flat: jax.Array,
    emit_tab: jax.Array,
    windows: jax.Array,
    halo: int,
    num_classes: int,
    num_planes: int,
) -> jax.Array:
    A = jnp.uint32(num_classes)  # uint32: see split_emit_planes
    P = jnp.uint32(emit_tab.shape[1])
    ef = emit_tab.reshape(-1)  # flat: see batched_emit_planes

    def warm(s, c):
        return dfa_flat[s * A + c.astype(jnp.uint32)], None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    def step(carry, c):
        s, pop = carry
        s2 = dfa_flat[s * A + c.astype(jnp.uint32)]
        for p in range(num_planes):
            pop = pop + lax.population_count(ef[s2 * P + jnp.uint32(p)]).astype(jnp.int32)
        return (s2, pop), None

    pop0 = (windows[:, 0] * 0).astype(jnp.int32)
    (_, pop), _ = lax.scan(step, (s_h, pop0), windows[:, halo:].T)
    return jnp.sum(pop)


_SPARSE_MIN_UNITS = 1 << 16
# Device-side compaction pays for itself by shrinking the device->host
# link traffic; on the CPU backend the "download" is a no-op view and the
# compaction program itself dominates (measured ~0.7 s per 1 Mi-unit feed),
# so dense extraction wins there.  Tests flip this to pin sparse-path
# conformance on the CPU suite.
_SPARSE_ON_CPU = False


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_planes(bits: jax.Array, cap: int):
    """Device-side hot-position compaction of END-indexed emit planes.

    Returns ``(count, idx[cap], masks[cap, P])``: ascending positions with
    any emit bit, padded with N past ``count``.  Downloading (idx, masks)
    for the hot positions replaces the dense 4·P bytes/position plane
    download — on match-sparse text (the normal case: a few % of positions
    end a keyword) this shrinks device->host traffic by an order of
    magnitude; that transfer is a large part of end-to-end extraction.
    """
    N = bits.shape[1]
    any_ = (bits != 0).any(axis=0)
    cnt = jnp.sum(any_.astype(jnp.int32))
    idx = jnp.nonzero(any_, size=cap, fill_value=N)[0]
    safe = jnp.minimum(idx, N - 1)
    masks = bits[:, safe].T
    masks = jnp.where((idx < N)[:, None], masks, jnp.uint32(0))
    return cnt, idx, masks


def planes_to_sparse(bits, n: int):
    """Device END-planes -> host ``(idx, masks)`` for hot positions only, or
    None when a dense download is the better deal (small inputs, numpy
    input, or adversarial match density where most positions are hot)."""
    if not isinstance(bits, jax.Array) or n < _SPARSE_MIN_UNITS:
        return None
    if not _SPARSE_ON_CPU and jax.default_backend() == "cpu":
        return None
    N = int(bits.shape[1])
    cap = max(1024, 1 << max(n // 16, 1).bit_length())
    while True:
        cap_eff = min(cap, N)
        cnt, idx, masks = _compact_planes(bits, cap=cap_eff)
        cnt = int(cnt)  # syncs the scalar only; idx/masks stay on device
        if cnt > n // 4:
            return None  # dense download is cheaper
        if cnt <= cap_eff:
            # Slice on device before downloading: only ~cnt hot entries cross
            # the link, not the cap-sized buffers.  Rounding the slice up to
            # a power of two keeps the set of distinct slice shapes (= XLA
            # programs) logarithmic.
            k = min(cap_eff, 1 << max(cnt - 1, 0).bit_length())
            idx = np.asarray(idx[:k])[:cnt].astype(np.int64)
            masks = np.asarray(masks[:k])[:cnt]
            keep = idx < n  # padded window lanes trail the text
            return idx[keep], masks[keep]
        cap = 1 << (cnt - 1).bit_length()


def sparse_planes_to_matches(idx: np.ndarray, masks: np.ndarray, max_depth: int):
    """(hot positions, hot-major masks) -> (starts, lens), unsorted segments
    in the same per-length grouping as ``end_planes_to_matches``."""
    if not len(idx):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    planes = masks.shape[1]
    starts_l, seg_lens, seg_counts = [], [], []
    for p in range(planes):
        w = masks[:, p]
        if not w.any():
            continue
        for b in range(32):
            L = 32 * p + b + 1
            if L > max_depth:
                break
            rows = np.nonzero(w & np.uint32(1 << b))[0]
            if len(rows):
                starts_l.append(idx[rows] + 1 - L)
                seg_lens.append(L)
                seg_counts.append(len(rows))
    if not starts_l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    lens = np.repeat(np.asarray(seg_lens, dtype=np.int64), seg_counts)
    return np.concatenate(starts_l), lens


def end_planes_to_matches(bits: np.ndarray, n: int, max_depth: int):
    """END-indexed planes -> (starts, lens): bit L-1 at position j = match of
    length L ending at j+1 (start j+1-L).

    One masked ``nonzero`` pass per possible keyword length over the hot
    positions only (adversarial inputs make most positions hot with several
    bits each; materializing the expanded bool matrix is ~10x slower)."""
    bits = np.asarray(bits)[:, :n]
    planes = bits.shape[0]
    hot = np.nonzero(bits.any(axis=0))[0]
    if not len(hot):
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    starts_l, seg_lens, seg_counts = [], [], []
    for p in range(planes):
        w = bits[p, hot]
        if not w.any():
            continue
        for b in range(32):
            L = 32 * p + b + 1
            if L > max_depth:
                break
            rows = np.nonzero(w & np.uint32(1 << b))[0]
            if len(rows):
                starts_l.append(hot[rows].astype(np.int64) + 1 - L)
                seg_lens.append(L)
                seg_counts.append(len(rows))
    if not starts_l:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    lens = np.repeat(np.asarray(seg_lens, dtype=np.int64), seg_counts)
    return np.concatenate(starts_l), lens


def ac_matches_batched(m: CompiledMatcher, cls: np.ndarray, bits,
                       layout: str = "planes"):
    """(starts, ends, vals) in reference emission order from end-planes.

    ``bits`` may be the device array straight from an engine (preferred —
    hot positions are compacted on device and only they are downloaded) or
    a host numpy array (dense path).  ``layout`` says how to decode ``bits``:
    ``"planes"`` = END-indexed emit planes, ``"hotstate"`` = the packed
    (state, count) plane of ``packedcount_hotstate_plane`` (pass the
    producing ``EnginePlan.which``-derived value; see ``ops.dispatch``).

    Extraction streams through the native C extractor (mode="all") when
    available — it walks the bit words end-ascending / longest-first, so
    the output is ALREADY in the reference emission order and the numpy
    unpack + 16M-entry lexsort disappear from the match-dense path."""
    from ahocorasick_tpu.ops import emit as emit_mod

    try:
        from ahocorasick_tpu.native import lib as native_lib

        native_ok = native_lib.available()
    except Exception:
        native_ok = False

    if layout == "hotstate":
        idx, masks = hotstate_sparse(m, bits, len(cls))
        if native_ok:
            starts, ends = native_lib.extract_resolve_sparse(
                idx, masks, len(cls), m.max_depth, "all")
            return starts, ends, _ac_vals(m, cls, starts, ends)
        starts, lens = sparse_planes_to_matches(idx, masks, m.max_depth)
    elif (sp := planes_to_sparse(bits, len(cls))) is not None:
        if native_ok:
            starts, ends = native_lib.extract_resolve_sparse(
                sp[0], sp[1], len(cls), m.max_depth, "all")
            return starts, ends, _ac_vals(m, cls, starts, ends)
        starts, lens = sparse_planes_to_matches(sp[0], sp[1], m.max_depth)
    else:
        if native_ok:
            starts, ends = native_lib.extract_resolve(
                np.asarray(bits), len(cls), m.max_depth, "all")
            return starts, ends, _ac_vals(m, cls, starts, ends)
        starts, lens = end_planes_to_matches(np.asarray(bits), len(cls), m.max_depth)
    starts, ends, _ = emit_mod.sort_by_end_start(starts, lens)
    lens = ends - starts
    return starts, ends, _ac_vals(m, cls, starts, ends)


def _ac_vals(m: CompiledMatcher, cls: np.ndarray, starts, ends):
    from ahocorasick_tpu.ops import emit as emit_mod

    if m.values is not None:
        return emit_mod.walk_values(m, cls, starts, ends - starts)
    return np.full(len(starts), -1, dtype=np.int64)
