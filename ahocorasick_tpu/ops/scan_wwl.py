"""Whole-word-longest parallel walk engine.

``WholeWordLongestMatchSet.match`` (reference :47-178) restarts its trie walk
at a position that depends on where the *previous* walk died — an inherently
sequential chain.  The parallel decomposition: compute, for **every** lane in
parallel, the full outcome of "a walk starting here": the die position, and
the single match that walk would emit (own match or carried fail match per
the reference's rules).  The sequential chain then reduces to following a
precomputed ``next_start`` pointer array on the host (``resolve/wholeword.py``)
— one gather per executed walk instead of one per character.

Walk outcome rules (mirroring the reference loop exactly):

* the walk dies at the first char with no trie transition (state DEAD);
* die char non-word: emit own match if any, else the carried fail match;
* die char word: emit only the carried fail match (the word is unfinished);
* end of input: own-else-fail — falls out automatically because the pad
  class is a non-word dead end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from ahocorasick_tpu.utils.lanes import LANE_BUCKET, bucket_depth  # noqa: F401


def compact_lanes(compiled, cls: np.ndarray, text_start: bool = True):
    """Compact walk-lane inputs for the whole-word-longest engine:
    ``(cls_p, starts, lanes, ws, d)`` — the ONE production configuration
    (padding, bucketing, lane rule) shared by the matcher device path,
    ``bench.wwl_kernel_rate``, and the streaming cursor.

    ``text_start``: ``cls[0]`` is the TRUE beginning of the text.  Then
    index 0 is always a lane (the reference's initial walk starts at 0
    whatever its wordness), and a word char at 0 is a genuine word start.
    Streaming cursors pass False for mid-stream buffers: local index 0's
    predecessor lives outside the buffer, so it must NOT be treated as a
    word start (every live walk starts at/after local 1 — the carried
    tail is one unit longer than any walk span)."""
    from ahocorasick_tpu.ops import scan_pfac

    d = bucket_depth(compiled.max_depth)
    cls_p = scan_pfac.pad_classes(cls, d + 1, bucket=LANE_BUCKET)
    is_word = np.asarray(compiled.class_is_word)[cls]
    if len(is_word):
        prev = np.concatenate([[not text_start], is_word[:-1]])
        ws = np.nonzero(is_word & ~prev)[0].astype(np.int64)
    else:
        ws = np.zeros(0, dtype=np.int64)
    lanes = ws
    if text_start and (len(ws) == 0 or ws[0] != 0) and len(cls):
        lanes = np.concatenate([np.zeros(1, dtype=np.int64), ws])
    # Quarter-octave lane bucketing: pow2 rounding wastes up to ~50% of the
    # compaction gathers on padded lanes; {1, 1.25, 1.5, 1.75} x 2^k keeps
    # the distinct compiled shapes bounded (4 per octave) at <=20% waste.
    Wp = 256
    while Wp < max(len(lanes), 1):
        Wp *= 2
    if Wp > 256:
        for frac in (5, 6, 7):
            if Wp // 8 * frac >= len(lanes):
                Wp = Wp // 8 * frac
                break
    starts = np.full(Wp, len(cls), dtype=np.int32)
    starts[: len(lanes)] = lanes
    return cls_p, starts, lanes, ws, d


@functools.partial(jax.jit, static_argnames=("max_depth",))
def wwl_walks(
    trie_next: jax.Array,  # int32[S+1, A]
    own_len: jax.Array,  # int32[S+1]
    own_val: jax.Array,  # int32[S+1]
    fail_len: jax.Array,  # int32[S+1]
    fail_off: jax.Array,  # int32[S+1]
    fail_val: jax.Array,  # int32[S+1]
    class_is_word: jax.Array,  # bool[A]
    cls_padded: jax.Array,  # int32[N + max_depth + 1], pad = non-word class 0
    max_depth: int,
):
    """Per-lane walk outcomes.

    Returns ``(die_pos, has_match, m_start, m_end, m_val)`` — all int32[N]
    (``has_match`` bool), where ``die_pos`` is the absolute index of the char
    that killed the walk starting at lane ``i``.
    """
    n = cls_padded.shape[0] - max_depth - 1
    dead = jnp.int32(trie_next.shape[0] - 1)

    # Every walk dies within max_depth+1 steps: a live state at step k sits at
    # trie depth k, and the trie has no nodes deeper than max_depth.
    def body(k, carry):
        states, k_die, s_last = carry
        chars = lax.dynamic_slice(cls_padded, (k,), (n,))
        nxt = trie_next[states, chars]
        newly = (k_die < 0) & (nxt == dead)
        k_die = jnp.where(newly, k, k_die)
        s_last = jnp.where(newly, states, s_last)
        return nxt, k_die, s_last

    # Derive carries from the input so their sharding varyingness matches
    # inside shard_map bodies (plain zeros are 'replicated' there).
    z = (lax.dynamic_slice(cls_padded, (0,), (n,)) * 0).astype(jnp.int32)
    init = (z, z - 1, z)
    _, k_die, s_last = lax.fori_loop(0, max_depth + 1, body, init)

    lane = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    die_pos = lane + k_die
    return _walk_outcomes(own_len, own_val, fail_len, fail_off, fail_val,
                          class_is_word, cls_padded, die_pos, s_last)


def _walk_outcomes(own_len, own_val, fail_len, fail_off, fail_val,
                   class_is_word, cls_padded, die_pos, s_last):
    die_cls = cls_padded[die_pos]
    die_word = class_is_word[die_cls]

    own = own_len[s_last]
    fl = fail_len[s_last]
    has_own = (own > 0) & ~die_word
    has_fail = (fl > 0) & (die_word | (own == 0))
    end = jnp.where(has_own, die_pos, die_pos - fail_off[s_last])
    length = jnp.where(has_own, own, fl)
    val = jnp.where(has_own, own_val[s_last], fail_val[s_last])
    has = has_own | has_fail
    return die_pos, has, end - length, end, val


@functools.partial(jax.jit, static_argnames=("max_depth",))
def wwl_walks_at(
    trie_next: jax.Array,  # int32[S+1, A]
    own_len: jax.Array,
    own_val: jax.Array,
    fail_len: jax.Array,
    fail_off: jax.Array,
    fail_val: jax.Array,
    class_is_word: jax.Array,  # bool[A]
    cls_padded: jax.Array,  # int32[>= max_start + max_depth + 1]
    starts: jax.Array,  # int32[W] walk start positions (padded lanes OK)
    max_depth: int,
):
    """Walk outcomes for the given START POSITIONS only.

    The restart chain consumes walks only at position 0 and word starts
    (``resolve/wholeword.follow_chain`` hops die -> first word start after
    it), so computing every lane wastes ~(1/word-start-density)x work.
    This variant pays one char gather + one (flat) trie gather per
    (start, step) — a win while word starts are sparse; the full
    ``wwl_walks`` keeps its free contiguous per-step slices for dense
    inputs.  Padded start slots should point at the PAD region (class 0,
    non-word): their walks die at step 0 with no match.
    """
    A = jnp.int32(trie_next.shape[1])
    tf = trie_next.reshape(-1)
    dead = jnp.int32(trie_next.shape[0] - 1)

    def body(k, carry):
        states, k_die, s_last = carry
        chars = cls_padded[starts + k]
        nxt = tf[states * A + chars]
        newly = (k_die < 0) & (nxt == dead)
        k_die = jnp.where(newly, k, k_die)
        s_last = jnp.where(newly, states, s_last)
        return nxt, k_die, s_last

    z = (starts * 0).astype(jnp.int32)
    _, k_die, s_last = lax.fori_loop(0, max_depth + 1, body, (z, z - 1, z))
    die_pos = starts + k_die
    return _walk_outcomes(own_len, own_val, fail_len, fail_off, fail_val,
                          class_is_word, cls_padded, die_pos, s_last)


# ---------------------------------------------------------------------------
# Scan-based walk engine (v2): one DFA row-gather per character.
#
# The walk engines above pay ~2 element gathers per (start, depth-step).
# When every keyword is word-uniform (all word chars, or — the Java trim
# quirk — all separators; keywords MIXING the two like "New York" fall
# back to the walk engines), every walk outcome is decided by ONE batched
# goto-closure DFA scan over the text:
#
# * Die position.  Let ``depth[i]`` be the trie depth of the DFA arrival
#   state after consuming char i (= length of the longest suffix of
#   text[0..i] that is a trie prefix).  A walk starting at word start ``w``
#   is alive after char ``w+k`` iff text[w..w+k] is a trie prefix.  Because
#   every trie path is word-UNIFORM (a pure-word prefix contains no
#   separator; an all-separator prefix contains no word char) no trie
#   prefix can span the boundary (w-1: non-word, w: word char), so
#   the longest trie-prefix suffix at ``w+k`` starts at or after ``w`` —
#   alive  <=>  depth[w+k] == k+1,  dead  <=>  depth[w+k] <= k.
#   The die step is therefore ``k_die(w) = min{k >= 0 : depth[w+k] <= k}``,
#   computable for EVERY position at once from d+1 shifted slices of the
#   depth plane — no per-start gathers.
# * Last state.  While alive, the DFA arrival state IS the trie walk node
#   (the longest trie-prefix suffix is text[w..i] itself), so
#   ``s_last = state[w + k_die - 1]`` (root when k_die == 0) and the
#   own/fail outcome tables apply unchanged (_walk_outcomes rules;
#   WholeWordLongestMatchSet.java:65-94).
#
# The scan gathers pack (next_id, depth(next), is_word(class)) into one
# uint32 entry, so the whole engine costs the AC engines' one row gather
# per character plus O(word-starts) compaction gathers.
# ---------------------------------------------------------------------------


class WwlScan(NamedTuple):
    """Device tables for the scan-based whole-word-longest engine."""

    table: np.ndarray  # uint32 packed: id | depth << id_bits | word << (id_bits + depth_bits) [| cross << (id_bits + depth_bits + 1)]; [Sp, Ap] row layout or flat [S_eff * A]
    rows_flat: Optional[np.ndarray]  # int32[R * A] concrete targets (quotient only)
    outrows: np.ndarray  # int32[Sp2, 8]: own_len, own_val, fail_len, fail_off, fail_val
    id_bits: int
    depth_bits: int
    halo: int
    num_classes: int
    row_layout: bool
    quotient: bool
    has_cross: bool = False  # mixed dictionaries: crossing-edge bit packed


def word_uniform_trie(m) -> bool:
    """Every trie path (keyword) is uniformly word chars or uniformly
    non-word chars.

    ``WholeWordLongestMatchSet`` only trims keyword ends, so two impure
    shapes exist: trimmed keywords with INTERIOR separators ("New York"),
    and the Java ``WordCharacters.trim`` quirk that keeps ALL-separator
    keywords unchanged (utils/chartables.trim_word docstring).  The depth
    argument above only needs that no trie-prefix can span a word-run
    boundary — all-separator keywords (no word char) satisfy that just like
    pure-word ones, so only mixed paths disqualify.  Check: each state's
    incoming-edge wordness (states have one parent) must match all its
    outgoing edges; the root is neutral."""
    from ahocorasick_tpu.core.compiler import RowTable

    if m.class_is_word is None:
        return False
    word = np.asarray(m.class_is_word, dtype=bool)
    if word.all() or not word.any():
        return True
    dead = m.num_states
    t = m.trie_next
    if isinstance(t, RowTable):
        rows, row_id = t.rows, t.row_id
    else:
        rows, row_id = t, None
    live = rows != dead
    has_w_row = (live & word[None, :]).any(axis=1)
    has_n_row = (live & ~word[None, :]).any(axis=1)
    # States reached via a word / non-word edge (disjoint: one parent each).
    col_w = np.zeros(m.num_states + 1, dtype=bool)
    col_n = np.zeros(m.num_states + 1, dtype=bool)
    tw = rows[:, word]
    col_w[tw[tw != dead]] = True
    tn = rows[:, ~word]
    col_n[tn[tn != dead]] = True
    if row_id is not None:
        has_w = has_w_row[row_id]
        has_n = has_n_row[row_id]
    else:
        has_w, has_n = has_w_row, has_n_row
    has_w = has_w[: m.num_states + 1]
    has_n = has_n[: m.num_states + 1]
    return not bool(((col_w & has_n) | (col_n & has_w)).any())


def scan_applicable(m) -> bool:
    """The scan-based engine applies: goto-closure DFA present (round-4+
    compiles; older artifacts fall back), word-uniform trie, packable."""
    from ahocorasick_tpu.core.compiler import RowTable, WHOLE_WORD_LONGEST

    if m.kind != WHOLE_WORD_LONGEST or m.dfa_next is None:
        return False
    if m.class_is_word is None or bool(m.class_is_word[0]):
        return False  # engines pad with class 0 = non-word (compiler invariant)
    d = max(m.max_depth, 1)
    depth_bits = max(d.bit_length(), 1)
    if isinstance(m.dfa_next, RowTable):
        R = m.dfa_next.rows.shape[0]
        id_bits = max(int(R - 1).bit_length(), 1)
    else:
        id_bits = max(int(m.num_states - 1).bit_length(), 1)
    if id_bits + depth_bits + 1 > 32:
        return False
    return word_uniform_trie(m)


def mixed_scan_applicable(m) -> bool:
    """The scan engine applies via the TRUNCATED-closure build: whole-word-
    longest dictionaries that ``scan_applicable`` rejects — separator-
    spanning keywords like "New York" (no compiled goto closure), or old
    word-uniform artifacts saved without one — get the closure of the
    word-uniform SUB-trie built engine-side (``build_wwl_scan_mixed``) with
    crossing edges marked, and walks that leave the uniform region re-run
    on the sparse host walker (``host_walks_at``).  Packability bound is
    re-verified after the build (the quotient row count can only shrink)."""
    from ahocorasick_tpu.core.compiler import WHOLE_WORD_LONGEST

    if m.kind != WHOLE_WORD_LONGEST or m.class_is_word is None:
        return False
    if bool(m.class_is_word[0]):
        return False  # engines pad with class 0 = non-word
    if scan_applicable(m):
        return False  # the pure scan engine already covers it
    d = max(m.max_depth, 1)
    depth_bits = max(d.bit_length(), 1)
    id_bits = max(int(m.num_states - 1).bit_length(), 1)
    return id_bits + depth_bits + 2 <= 32


def _trie_edges(m):
    """(parents, classes, children) of every trie edge, from the compiled
    goto table (dense or RowTable), vectorized."""
    from ahocorasick_tpu.core.compiler import RowTable

    S = m.num_states
    dead = S
    t = m.trie_next
    if isinstance(t, RowTable):
        trows, trid = t.rows, t.row_id[:S]
        live = trows != dead
        cnt_r = live.sum(axis=1)
        r_nz_r, r_nz_c = np.nonzero(live)
        r_nz_t = trows[r_nz_r, r_nz_c]
        row_start = np.concatenate([[0], np.cumsum(cnt_r)])
        cnts = cnt_r[trid]
        ps = np.repeat(np.arange(S, dtype=np.int64), cnts)
        total = int(cnts.sum())
        offs = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(cnts) - cnts, cnts)
        flat = row_start[trid[ps]] + offs
        cs = r_nz_c[flat]
        ch = r_nz_t[flat].astype(np.int64)
    else:
        ps, cs = np.nonzero(t[:S] != dead)
        ch = t[ps, cs].astype(np.int64)
    return ps, cs, ch


def _edges_by_level(depth, ch):
    """``(order, ed_sorted)``: edge indices stably sorted by child depth +
    the sorted depths — the ONE level-bucketing shared by the uniform pass
    and the closure builders (iterate with ``_level_slice``)."""
    edge_depth = np.asarray(depth)[ch]  # = depth[parent] + 1
    order = np.argsort(edge_depth, kind="stable")
    return order, edge_depth[order]


def _level_slice(order, ed_sorted, level):
    a = np.searchsorted(ed_sorted, level, "left")
    b = np.searchsorted(ed_sorted, level, "right")
    return order[a:b]


def _uniform_states(m, ps, cs, ch, level_order=None):
    """bool[S]: the state's root path is word-uniform (root: True), plus the
    path wordness of each state (undefined for non-uniform)."""
    S = m.num_states
    word = np.asarray(m.class_is_word, dtype=bool)
    depth = np.asarray(m.depth[:S])
    uniform = np.zeros(S, dtype=bool)
    uniform[0] = True
    word_of = np.zeros(S, dtype=bool)
    order, ed_sorted = (level_order if level_order is not None
                        else _edges_by_level(depth, ch))
    max_d = int(depth.max()) if S > 1 else 0
    for level in range(1, max_d + 1):
        sel = _level_slice(order, ed_sorted, level)
        if not len(sel):
            continue
        p, c, n = ps[sel], cs[sel], ch[sel]
        w = word[c]
        if level == 1:
            uniform[n] = True
        else:
            uniform[n] = uniform[p] & (word_of[p] == w)
        word_of[n] = w
    return uniform, word_of


def _truncated_closure_dense(m):
    """Dense goto-closure of the word-uniform sub-trie with crossing marks:
    ``(dfa int32[S, A], cross bool[S, A], uniform bool[S])``.

    Same semantics as ``_truncated_closure`` (conformance-tested equal) but
    built level-synchronously with vectorized numpy row copies — a dense
    output needs no row dedup, so the per-node consing loop (the only
    Python-speed pass left on the mixed-WWL path; ~minutes at 4M states)
    reduces to three scatters/gathers per trie level.  Per level L (edges
    whose child sits at depth L, parents complete at depth L-1):

    1. overlay the parents' own edges onto their inherited rows
       (``dfa[p, c] = child`` for uniform children, ``cross[p, c]`` for
       crossing ones) — this COMPLETES every depth-(L-1) row before anything
       at depth L reads it;
    2. ``fail[n] = dfa[fail[p], c]`` (fail targets sit at depth <= L-1,
       complete by induction);
    3. ``dfa[n] = dfa[fail[n]]`` (inherit; own edges arrive at step 1 of
       level L+1).  Crossing marks never inherit (own-edge property).
    """
    S, A = m.num_states, m.num_classes
    depth = np.asarray(m.depth[:S])
    ps, cs, ch = _trie_edges(m)
    lvl = _edges_by_level(depth, ch)
    uniform, _ = _uniform_states(m, ps, cs, ch, lvl)

    dfa = np.zeros((S, A), dtype=np.int32)
    cross = np.zeros((S, A), dtype=bool)
    fail = np.zeros(S, dtype=np.int64)

    # Edges from uniform parents only; crossing = child non-uniform.
    # Filtering the precomputed level order preserves sortedness — no
    # second argsort over the edge set.
    order, ed_sorted = lvl
    keepo = uniform[ps][order]
    order, ed_sorted = order[keepo], ed_sorted[keepo]
    is_cross = ~uniform[ch]
    max_d = int(ed_sorted[-1]) if len(ed_sorted) else 0

    for level in range(1, max_d + 1):
        sel = _level_slice(order, ed_sorted, level)
        if not len(sel):
            continue
        p, c, n = ps[sel], cs[sel], ch[sel]
        cx = is_cross[sel]
        dfa[p[~cx], c[~cx]] = n[~cx]  # step 1: complete depth-(L-1) rows
        cross[p[cx], c[cx]] = True
        pu, cu, nu = p[~cx], c[~cx], n[~cx]
        if len(nu):
            if level == 1:
                fail[nu] = 0
            else:
                fail[nu] = dfa[fail[pu], cu]  # step 2
            dfa[nu] = dfa[fail[nu]]  # step 3
    return dfa, cross, uniform


def _truncated_closure(m):
    """Goto-closure DFA of the word-uniform sub-trie, with crossing-edge
    marks, hash-consed like the compiler's closure pass
    (``core/compiler._finalize``).

    The sub-trie keeps exactly the states whose root path is word-uniform;
    edges from a uniform state to a non-uniform child ("crossing" edges —
    the first wordness change inside a separator-spanning keyword) are
    removed from the transition function but MARKED per (state, class).  A
    walk whose truncated-trie die char hits a marked column continues in
    the full trie; the engine re-runs exactly those walks on the sparse
    host walker.  Crossing marks are a property of the state's OWN trie
    edges (consulted only when the pre-die arrival state IS the trie node),
    so they do NOT inherit down fail links — but they are part of the row
    cons key, since states sharing a closure row may cross differently.

    Returns ``(rows int32[R, A] concrete targets, cross bool[R, A],
    row_id int32[S], uniform bool[S])``; root's row is row 0.
    """
    S, A = m.num_states, m.num_classes
    depth = np.asarray(m.depth[:S])
    ps, cs, ch = _trie_edges(m)
    uniform, _ = _uniform_states(m, ps, cs, ch)

    ov: list = [None] * S  # uniform-child overrides {class: child}
    cx: list = [None] * S  # crossing columns [class, ...]
    parent = np.zeros(S, dtype=np.int64)
    pcls = np.zeros(S, dtype=np.int64)
    parent[ch] = ps
    pcls[ch] = cs
    for p, c, n in zip(ps.tolist(), cs.tolist(), ch.tolist()):
        if not uniform[p]:
            continue
        if uniform[n]:
            d_ = ov[p]
            if d_ is None:
                d_ = ov[p] = {}
            d_[c] = n
        else:
            l_ = cx[p]
            if l_ is None:
                l_ = cx[p] = []
            l_.append(c)

    rows = np.zeros((min(max(S, 2), 1024), A), dtype=np.int32)
    crows = np.zeros_like(rows, dtype=bool)
    row_id = np.zeros(S, dtype=np.int32)
    for c, n in (ov[0] or {}).items():
        rows[0, c] = n
    for c in cx[0] or ():
        crows[0, c] = True  # unreachable in practice: root children uniform
    n_rows = 1
    row_of_key: dict = {}
    fail = np.zeros(S, dtype=np.int32)

    uni = np.nonzero(uniform)[0]
    uni = uni[np.argsort(depth[uni], kind="stable")]
    for s in uni.tolist():
        if s == 0:
            continue
        if depth[s] == 1:
            f = 0
        else:
            f = int(rows[row_id[fail[parent[s]]], pcls[s]])
        fail[s] = f
        key = (int(row_id[f]), tuple(sorted((ov[s] or {}).items())),
               tuple(sorted(cx[s] or ())))
        rid = row_of_key.get(key)
        if rid is None:
            if n_rows == len(rows):
                rows = np.concatenate([rows, np.zeros_like(rows)])
                crows = np.concatenate([crows, np.zeros_like(crows)])
            row = rows[key[0]].copy()
            if ov[s]:
                row[list(ov[s].keys())] = list(ov[s].values())
            rows[n_rows] = row
            if cx[s]:
                crows[n_rows, cx[s]] = True
            rid = row_of_key[key] = n_rows
            n_rows += 1
        row_id[s] = rid
    return rows[:n_rows].copy(), crows[:n_rows].copy(), row_id, uniform


def host_walks_at(m, cls_p: np.ndarray, starts: np.ndarray, d: int):
    """Full-trie walk outcomes for the given starts (vectorized host numpy).

    The sparse continuation engine for separator-spanning dictionaries:
    walks whose truncated-trie die char hits a crossing edge re-run here
    over the FULL trie (dense or RowTable ``[s, c]`` indexing), one fancy
    gather per (start, step).  Same contract and rules as ``wwl_walks_at``
    (``WholeWordLongestMatchSet.java:65-94``); ``cls_p`` must extend at
    least ``d + 1`` units past every start (pad class 0 = non-word).
    """
    S = m.num_states
    t = m.trie_next
    word = np.asarray(m.class_is_word, dtype=bool)
    starts = np.asarray(starts, dtype=np.int64)
    W = len(starts)
    states = np.zeros(W, dtype=np.int64)
    k_die = np.full(W, -1, dtype=np.int32)
    s_last = np.zeros(W, dtype=np.int64)
    dwv = np.zeros(W, dtype=bool)
    for k in range(d + 1):
        chars = cls_p[starts + k]
        nxt = np.asarray(t[states, chars], dtype=np.int64)
        newly = (k_die < 0) & (nxt == S)
        if newly.any():
            k_die[newly] = k
            s_last[newly] = states[newly]
            dwv[newly] = word[chars[newly]]
        states = nxt
    assert (k_die >= 0).all()  # every walk dies within d+1 steps
    own = m.own_len[s_last]
    ownv = m.own_val[s_last]
    fl = m.fail_len[s_last]
    fo = m.fail_off[s_last]
    fv = m.fail_val[s_last]
    die_pos = (starts + k_die).astype(np.int32)
    has_own = (own > 0) & ~dwv
    has_fail = (fl > 0) & (dwv | (own == 0))
    end = np.where(has_own, die_pos, die_pos - fo)
    length = np.where(has_own, own, fl)
    val = np.where(has_own, ownv, fv)
    return (die_pos, has_own | has_fail, (end - length).astype(np.int32),
            end.astype(np.int32), val.astype(np.int32))


# Row layout: (Sp, Ap) rows read by a row gather + one-hot select, for
# alphabets up to _ROW_MAX_CLASSES; the flat layout otherwise.  No size
# budget: the card showed no cliff (fused kernel 1.78-1.79 GB/s with a
# 1.5 MB row table, 1.84-1.85 GB/s with 59 MB; H100 80GB HBM3, 700 W power
# limit).  The flat layout read 2-4% faster at both sizes (two turns each;
# not acted on here).
_ROW_MAX_CLASSES = 512


def build_wwl_scan(m) -> WwlScan:
    """Host-side packed tables for ``wwl_scan_walks``."""
    from ahocorasick_tpu.core.compiler import RowTable

    assert scan_applicable(m)
    S = m.num_states
    A = m.num_classes
    d = max(m.max_depth, 1)
    depth_bits = max(d.bit_length(), 1)
    depth = np.asarray(m.depth[: S], dtype=np.uint32)
    word = np.asarray(m.class_is_word, dtype=np.uint32)

    if isinstance(m.dfa_next, RowTable):
        rt = m.dfa_next
        R = rt.rows.shape[0]
        id_bits = max(int(R - 1).bit_length(), 1)
        assert int(rt.row_id[0]) == 0  # compiler invariant: root row is 0
        packed = rt.row_id[rt.rows].astype(np.uint32)
        packed |= depth[rt.rows] << np.uint32(id_bits)
        packed |= (word << np.uint32(id_bits + depth_bits))[None, :]
        rows_flat = np.ascontiguousarray(rt.rows.reshape(-1).astype(np.int32))
        quotient = True
    else:
        id_bits = max(int(S - 1).bit_length(), 1)
        nxt = m.dfa_next
        packed = nxt.astype(np.uint32)
        packed |= depth[nxt] << np.uint32(id_bits)
        packed |= (word << np.uint32(id_bits + depth_bits))[None, :]
        rows_flat = None
        quotient = False

    return _pack_wwl_scan(m, packed, rows_flat, id_bits, depth_bits, d, A,
                          quotient, has_cross=False)


def _pack_wwl_scan(m, packed, rows_flat, id_bits, depth_bits, d, A,
                   quotient, has_cross):
    """Shared layout tail: pad to the row layout (or flatten) + outrows."""
    S = m.num_states
    Ap = max(8, 1 << (A - 1).bit_length())
    Sr = packed.shape[0]
    Sp = -(-Sr // 8) * 8
    row_layout = Ap <= _ROW_MAX_CLASSES
    if row_layout:
        t = np.zeros((Sp, Ap), dtype=np.uint32)
        t[:Sr, :A] = packed
        table = t
    else:
        table = np.ascontiguousarray(packed.reshape(-1))

    Sp2 = 8
    while Sp2 < S + 1:
        Sp2 *= 2
    outrows = np.zeros((Sp2, 8), dtype=np.int32)
    outrows[: S + 1, 0] = m.own_len
    outrows[: S + 1, 1] = m.own_val
    outrows[: S + 1, 2] = m.fail_len
    outrows[: S + 1, 3] = m.fail_off
    outrows[: S + 1, 4] = m.fail_val
    return WwlScan(table, rows_flat, outrows, id_bits, depth_bits, d, A,
                   row_layout, quotient, has_cross)


def build_wwl_scan_mixed(m) -> WwlScan:
    """Packed scan tables for separator-spanning (or closure-less)
    dictionaries, from the engine-built truncated closure
    (``_truncated_closure``); packs the crossing bit above the word bit so
    the die sweep flags walks needing the full-trie continuation."""
    assert mixed_scan_applicable(m)
    S = m.num_states
    A = m.num_classes
    d = max(m.max_depth, 1)
    depth_bits = max(d.bit_length(), 1)
    depth = np.asarray(m.depth[: S], dtype=np.uint32)
    word = np.asarray(m.class_is_word, dtype=np.uint32)

    if m.is_row_compressed:
        rows, cross, row_id, _uniform = _truncated_closure(m)
        R = rows.shape[0]
        id_bits = max(int(R - 1).bit_length(), 1)
        if id_bits + depth_bits + 2 > 32:
            raise ValueError(
                "truncated quotient closure does not pack "
                f"({R} rows, max depth {d})")
        packed = row_id[rows].astype(np.uint32)
        packed |= depth[rows] << np.uint32(id_bits)
        packed |= (word << np.uint32(id_bits + depth_bits))[None, :]
        packed |= cross.astype(np.uint32) << np.uint32(
            id_bits + depth_bits + 1)
        rows_flat = np.ascontiguousarray(rows.reshape(-1).astype(np.int32))
        quotient = True
    else:
        # Dense: the vectorized level-synchronous build (no consing).
        nxt, cross_d, _uniform = _truncated_closure_dense(m)
        id_bits = max(int(S - 1).bit_length(), 1)
        packed = nxt.astype(np.uint32)
        packed |= depth[nxt] << np.uint32(id_bits)
        packed |= (word << np.uint32(id_bits + depth_bits))[None, :]
        packed |= cross_d.astype(np.uint32) << np.uint32(
            id_bits + depth_bits + 1)
        rows_flat = None
        quotient = False
    return _pack_wwl_scan(m, packed, rows_flat, id_bits, depth_bits, d, A,
                          quotient, has_cross=True)


@functools.partial(jax.jit, static_argnames=(
    "halo", "id_bits", "depth_bits", "num_classes", "d", "row_layout",
    "quotient", "cross"))
def wwl_scan_walks(
    table: jax.Array,
    rows_flat: Optional[jax.Array],
    outrows: jax.Array,
    windows: jax.Array,  # int32[B, halo + C] (scan_batched.chunk_classes)
    starts: jax.Array,  # int32[W] walk starts (padded slots -> pad region)
    *,
    halo: int,
    id_bits: int,
    depth_bits: int,
    num_classes: int,
    d: int,  # walk-step count - 1 (>= compiled max_depth)
    row_layout: bool,
    quotient: bool,
    cross: bool = False,
):
    """Walk outcomes for the given start positions via ONE batched DFA scan.

    Same contract as ``wwl_walks_at``: returns ``(die_pos, has, m_start,
    m_end, m_val)``, each ``int32[W]`` (``has`` bool).  With ``cross``
    (truncated-closure tables, ``build_wwl_scan_mixed``) a sixth ``cont``
    bool[W] flags walks whose die char hit a crossing edge — their real
    outcome needs the full-trie continuation (``host_walks_at``); the other
    five outputs are exact wherever ``cont`` is False.
    """
    k_die, dw, prev, cx = _wwl_core(
        table, rows_flat, windows, halo, id_bits, depth_bits, num_classes,
        d, row_layout, quotient, cross=cross)

    # Compact to the requested starts.  Pack (k_die, die_word[, cross]
    # [, prev]) into one plane when the bits fit so padded-lane gathers
    # stay cheap, and fetch it with 16-wide ROW gathers + a fused one-hot
    # column select (``_plane_take``).
    idmask = jnp.uint32((1 << id_bits) - 1)
    kd_bits = max(int(d).bit_length(), 1)
    nflag = 2 if cross else 1  # die-word [+ cross] bits above kd
    meta = k_die.astype(jnp.uint32) | (dw << jnp.uint32(kd_bits))
    if cross:
        meta = meta | (cx << jnp.uint32(kd_bits + 1))
    if not quotient and kd_bits + nflag + id_bits <= 32:
        meta = meta | (prev.astype(jnp.uint32) << jnp.uint32(kd_bits + nflag))
        mg = _plane_take(meta, starts)
        s_last = ((mg >> jnp.uint32(kd_bits + nflag)) & idmask).astype(
            jnp.int32)
    else:
        mg = _plane_take(meta, starts)
        pg = _plane_take(prev, starts)
        s_last = rows_flat[pg] if quotient else pg
    kd = (mg & jnp.uint32((1 << kd_bits) - 1)).astype(jnp.int32)
    dws = ((mg >> jnp.uint32(kd_bits)) & 1).astype(bool)
    outs = _wwl_outcomes(outrows, s_last, kd, dws, starts)
    if cross:
        cont = ((mg >> jnp.uint32(kd_bits + 1)) & 1).astype(bool)
        return outs + (cont,)
    return outs


def _wwl_core(table, rows_flat, windows, halo, id_bits, depth_bits,
              num_classes, d, row_layout, quotient, cross=False):
    """Scan + die sweep: per-position ``(k_die, die_word, prev, cx)`` planes
    of length ``L = B*C - (d+1)`` in flat text order.  ``prev`` is the
    pre-die state (dense) or the flat table-entry index that produced it
    (quotient); ``cx`` (None unless ``cross``) is the crossing bit of the
    die-step entry — the walk continues past the truncated trie there.
    """
    from ahocorasick_tpu.ops.scan_rowdfa import _select_col

    B = windows.shape[0]
    C = windows.shape[1] - halo
    A = num_classes
    idmask = jnp.uint32((1 << id_bits) - 1)
    dmask = jnp.uint32((1 << depth_bits) - 1)

    if row_layout:
        def gather(s, c):
            return _select_col(table[s], c, A)
    else:
        tf = table.reshape(-1)

        def gather(s, c):
            return tf[s * jnp.uint32(A) + c.astype(jnp.uint32)]

    def warm(s, c):
        return gather(s, c) & idmask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    if quotient:
        def step(s, c):
            v = gather(s, c)
            f = s * jnp.uint32(A) + c.astype(jnp.uint32)
            return v & idmask, (v, f)

        _, (vs, fs) = lax.scan(step, s_h, windows[:, halo:].T)  # (C, B)
        fflat = fs.T.reshape(-1).astype(jnp.int32)
    else:
        def step(s, c):
            v = gather(s, c)
            return v & idmask, v

        _, vs = lax.scan(step, s_h, windows[:, halo:].T)
        fflat = None
    vflat = vs.T.reshape(-1)  # (B*C,) flat text order
    L = B * C - (d + 1)
    depth_p = ((vflat >> jnp.uint32(id_bits)) & dmask).astype(jnp.int32)
    word_p = (vflat >> jnp.uint32(id_bits + depth_bits)) & jnp.uint32(1)
    cross_p = ((vflat >> jnp.uint32(id_bits + depth_bits + 1)) & jnp.uint32(1)
               if cross else None)

    # k_die / die-char wordness / pre-die state for EVERY position, from
    # shifted slices of the scan planes — all elementwise, zero gathers.
    # Statically unrolled (d is small) so XLA sees pure static slices and
    # fuses the whole sweep.
    z = jnp.zeros((L,), dtype=jnp.int32)
    k_die, dw, prev = z - 1, z.astype(jnp.uint32), z
    cx = z.astype(jnp.uint32) if cross else None
    for k in range(d + 1):
        dk = lax.slice(depth_p, (k,), (k + L,))
        wk = lax.slice(word_p, (k,), (k + L,))
        kp = max(k - 1, 0)
        if quotient:
            pk = lax.slice(fflat, (kp,), (kp + L,))
        else:
            pk = (lax.slice(vflat, (kp,), (kp + L,)) & idmask).astype(jnp.int32)
        newly = (k_die < 0) & (dk <= k)
        if cross:
            # k == 0 cannot cross: root children are always word-uniform
            # (trim strips leading separators), and the k == 0 die entry is
            # gathered from the PREDECESSOR's context, not the root.
            ck = lax.slice(cross_p, (k,), (k + L,))
            cx = jnp.where(newly & (k > 0), ck, cx)
        k_die = jnp.where(newly, k, k_die)
        dw = jnp.where(newly, wk, dw)
        prev = jnp.where(newly, pk, prev)
    return k_die, dw, prev, cx


def chunk_classes_overlap(cls: np.ndarray, chunk: int, halo: int,
                          right: int, num_classes: Optional[int] = None):
    """(B, halo + chunk + right) windows: ``chunk_classes`` plus a RIGHT
    overlap of ``right`` units read from the next chunk (PAD_CLASS past the
    text) — the fused-carry kernel finishes every body walk in-window."""
    from ahocorasick_tpu.ops.scan_batched import PAD_CLASS, class_dtype

    n = len(cls)
    B = -(-max(n, 1) // chunk)
    p = np.pad(cls, (halo, B * chunk - n + right), constant_values=PAD_CLASS)
    idx = (np.arange(B) * chunk)[:, None] + np.arange(
        halo + chunk + right)[None, :]
    dt = np.int32 if num_classes is None else class_dtype(num_classes)
    return p[idx].astype(dt)


def fused_applicable(sc: WwlScan, d: int) -> bool:
    """The fused-carry kernel applies: dense ids (the quotient ring would
    need the flat entry index, id_bits + log2(A) bits) and the ring record
    ``died | k | word [| cross] | prev`` fits one uint32."""
    kd_bits = max(int(d).bit_length(), 1)
    nflag = 2 if sc.has_cross else 1
    return not sc.quotient and 1 + kd_bits + nflag + sc.id_bits <= 32


# Engine default for the fused-carry variant, set by the measured A/B on
# the card (``tools/engine_costs.py``, BASELINE #4 widths, 4 Mi units,
# turns sweep/fused/fused/sweep; H100 80GB HBM3, 400 W power limit):
# fused 1.80 / 1.77 GB/s vs sweep 1.39 / 1.30 GB/s.  The sweep remains for
# the dictionaries ``fused_applicable`` rejects.
FUSED_DEFAULT = True


@functools.partial(jax.jit, static_argnames=(
    "halo", "id_bits", "depth_bits", "num_classes", "d", "row_layout",
    "cross"))
def wwl_scan_walks_fused(
    table: jax.Array,
    outrows: jax.Array,
    windows: jax.Array,  # int32[B, halo + C + d + 1] (chunk_classes_overlap)
    starts: jax.Array,  # int32[W] walk starts (padded slots -> pad region)
    *,
    halo: int,
    id_bits: int,
    depth_bits: int,
    num_classes: int,
    d: int,
    row_layout: bool,
    cross: bool = False,
):
    """``wwl_scan_walks`` with the die sweep fused INTO the scan carry.

    The sweep variant materializes the full packed plane to HBM and re-reads
    it d+1 times (shifted slices); here a (B, d+1) uint32 ring rides the
    ``lax.scan`` carry — slot ``t mod (d+1)`` tracks the walk started at
    body step ``t``; at each step every live slot tests ``depth <= age`` and
    the age-d slot (complete by the depth bound) emits its packed record.
    HBM traffic drops to the row gather + ONE meta word per character; the
    extra (d+1)-step window overlap costs ~(d+1)/C.  Same contract/results
    as ``wwl_scan_walks`` (conformance-tested); dense (non-quotient) only —
    see ``fused_applicable``.
    """
    from ahocorasick_tpu.ops.scan_rowdfa import _select_col

    B = windows.shape[0]
    C = windows.shape[1] - halo - (d + 1)
    A = num_classes
    idmask = jnp.uint32((1 << id_bits) - 1)
    dmask = jnp.uint32((1 << depth_bits) - 1)
    kd_bits = max(int(d).bit_length(), 1)
    nflag = 2 if cross else 1

    if row_layout:
        def gather(s, c):
            return _select_col(table[s], c, A)
    else:
        tf = table.reshape(-1)

        def gather(s, c):
            return tf[s * jnp.uint32(A) + c.astype(jnp.uint32)]

    def warm(s, c):
        return gather(s, c) & idmask, None

    s0 = (windows[:, 0] * 0).astype(jnp.uint32)
    s_h, _ = lax.scan(warm, s0, windows[:, :halo].T)

    slots = lax.broadcasted_iota(jnp.int32, (1, d + 1), 1)
    ring0 = jnp.ones((B, d + 1), dtype=jnp.uint32)  # died, k=0: pre-body junk

    def step(carry, xs):
        s_pre, ring = carry
        c, t = xs
        v = gather(s_pre, c)
        s2 = v & idmask
        depth = ((v >> jnp.uint32(id_bits)) & dmask).astype(jnp.int32)
        word = v >> jnp.uint32(id_bits + depth_bits) & jnp.uint32(1)
        j = jnp.mod(t - slots, d + 1)  # (1, d+1) slot ages
        ring = jnp.where(j == 0, jnp.uint32(0), ring)  # fresh walk starts
        died = (ring & 1).astype(bool)
        newly = (~died) & (depth[:, None] <= j)
        rec = (jnp.uint32(1)
               | (j.astype(jnp.uint32) << jnp.uint32(1))
               | (word[:, None] << jnp.uint32(1 + kd_bits)))
        if cross:
            cx = (v >> jnp.uint32(id_bits + depth_bits + 1)) & jnp.uint32(1)
            # age 0 cannot cross (the die entry is the predecessor's, and
            # root children are uniform) — mask like the sweep engine.
            rec = rec | (jnp.where(j > 0, cx[:, None], jnp.uint32(0))
                         << jnp.uint32(2 + kd_bits))
        rec = rec | (s_pre[:, None] << jnp.uint32(1 + kd_bits + nflag))
        ring = jnp.where(newly, rec, ring)
        # The age-d slot is complete (every walk dies within d+1 steps).
        emit = jnp.sum(jnp.where(j == d, ring, jnp.uint32(0)), axis=1)
        return (s2, ring), emit >> jnp.uint32(1)

    xs = (windows[:, halo:].T, jnp.arange(C + d + 1, dtype=jnp.int32))
    _, metas = lax.scan(step, (s_h, ring0), xs)  # (C + d + 1, B)
    # Walk at body step t0 emits at step t0 + d; flat text order.
    meta = lax.slice(metas, (d, 0), (d + C, B)).T.reshape(-1)

    mg = _plane_take(meta, starts)
    kd = (mg & jnp.uint32((1 << kd_bits) - 1)).astype(jnp.int32)
    dws = ((mg >> jnp.uint32(kd_bits)) & 1).astype(bool)
    s_last = ((mg >> jnp.uint32(kd_bits + nflag)) & idmask).astype(jnp.int32)
    outs = _wwl_outcomes(outrows, s_last, kd, dws, starts)
    if cross:
        cont = ((mg >> jnp.uint32(kd_bits + 1)) & 1).astype(bool)
        return outs + (cont,)
    return outs


def chain_lanes(ws: np.ndarray, n: int) -> np.ndarray:
    """The positions the restart chain can consume: position 0 (the
    reference's initial walk, whatever its wordness) plus every word start
    (``resolve/wholeword.follow_chain``; same rule as ``compact_lanes``)."""
    if n and (len(ws) == 0 or ws[0] != 0):
        return np.concatenate([np.zeros(1, dtype=np.int64), ws])
    return ws


def apply_crossing_fixes(m, cls_p: np.ndarray, d: int, arrays, idx,
                         starts) -> None:
    """Overwrite walk outcomes at the flagged slots with full-trie host
    walks: ``arrays`` = the mutable (die, has, ms, me, mv) quintet,
    ``idx`` = the slots to overwrite, ``starts`` = the corresponding walk
    start positions (equal to ``idx`` for position-indexed arrays, or
    ``lanes[idx]`` for compact per-lane arrays).  The ONE continuation
    contract shared by the matcher path, the streaming cursor, and the
    sharded/TP scanners."""
    if not len(idx):
        return
    fix = host_walks_at(m, cls_p, starts, d)
    for arr, f in zip(arrays, fix):
        arr[idx] = f


def scan_walks_auto(sc: WwlScan, cls_p: np.ndarray, starts, d: int,
                    cross: bool):
    """Run the production scan-walk engine for the given starts: the
    fused-carry kernel when applicable (``FUSED_DEFAULT`` — set by the
    measured A/B on the card), else the sweep kernel.  One chooser shared by the
    matcher device path, the streaming cursor and the bench harness so the
    engine pick cannot drift between them."""
    import jax.numpy as jnp

    from ahocorasick_tpu.ops import scan_batched

    if FUSED_DEFAULT and fused_applicable(sc, d):
        windows = chunk_classes_overlap(cls_p, 512, d, d + 1, sc.num_classes)
        return wwl_scan_walks_fused(
            sc.table, sc.outrows, jnp.asarray(windows), jnp.asarray(starts),
            halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
            num_classes=sc.num_classes, d=d, row_layout=sc.row_layout,
            cross=cross)
    windows = scan_batched.chunk_classes(cls_p, 512, d, sc.num_classes)
    return wwl_scan_walks(
        sc.table, sc.rows_flat, sc.outrows, jnp.asarray(windows),
        jnp.asarray(starts),
        halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
        num_classes=sc.num_classes, d=d, row_layout=sc.row_layout,
        quotient=sc.quotient, cross=cross)


def _plane_take(plane, idx):
    """Gather plane[idx] via 16-wide (64 B) row gathers + a fused one-hot
    select (its cost against an element gather is not measured on the
    card)."""
    Lp = -(-plane.shape[0] // 16) * 16
    p16 = jnp.concatenate(
        [plane, jnp.zeros((Lp - plane.shape[0],), plane.dtype)]
    ).reshape(-1, 16)
    rows = p16[idx >> 4]
    oh = lax.broadcasted_iota(jnp.int32, (1, 16), 1) == (idx & 15)[:, None]
    return jnp.sum(jnp.where(oh, rows, jnp.zeros((), plane.dtype)), axis=1)


def _wwl_outcomes(outrows, s_last, kd, dws, pos):
    """Reference walk-outcome rules over (pre-die state, die wordness)
    (WholeWordLongestMatchSet.java:65-94; same math as _walk_outcomes)."""
    s_last = jnp.where(kd > 0, s_last, 0)
    orow = outrows[s_last]  # (W, 8) row gather
    own, ownv = orow[:, 0], orow[:, 1]
    fl, fo, fv = orow[:, 2], orow[:, 3], orow[:, 4]
    die_pos = pos + kd
    has_own = (own > 0) & ~dws
    has_fail = (fl > 0) & (dws | (own == 0))
    end = jnp.where(has_own, die_pos, die_pos - fo)
    length = jnp.where(has_own, own, fl)
    val = jnp.where(has_own, ownv, fv)
    has = has_own | has_fail
    return die_pos, has, end - length, end, val


def host_walks_from_raw(sc: WwlScan, raw: np.ndarray, cls_p: np.ndarray,
                        n: int):
    """Per-position walk outcomes from a RAW packed scan plane (host numpy).

    ``raw``: uint32[>= n + d + 1] packed ``(id, depth, word)`` words in flat
    text order — the state-sharded (TP-analog) scan's "raw" mode output,
    where the per-character row gathers ran table-sharded over the mesh and
    only the tiny elementwise die sweep remains.  ``cls_p``: the class array
    the plane was scanned over (length >= n + d + 1, padded with the
    non-word class 0).  Returns the ``wwl_walks`` contract
    ``(die_pos, has, m_start, m_end, m_val)`` for every position < ``n``;
    output-identical to ``wwl_scan_walks_all`` (conformance-tested).
    Reference semantics: ``WholeWordLongestMatchSet.java:65-94``.
    """
    d = sc.halo
    idmask = np.uint32((1 << sc.id_bits) - 1)
    dmask = np.uint32((1 << sc.depth_bits) - 1)
    raw = np.asarray(raw, dtype=np.uint32)[: n + d + 1]
    depth_p = ((raw >> np.uint32(sc.id_bits)) & dmask).astype(np.int32)
    word_p = ((raw >> np.uint32(sc.id_bits + sc.depth_bits)) & np.uint32(1)
              ).astype(bool)
    cross_p = (((raw >> np.uint32(sc.id_bits + sc.depth_bits + 1))
                & np.uint32(1)).astype(bool) if sc.has_cross else None)
    ids = (raw & idmask).astype(np.int64)

    # Die sweep: k_die(w) = min{k >= 0 : depth[w+k] <= k} — d+1 shifted
    # slices of the depth plane, exactly the device sweep in ``_wwl_core``.
    k_die = np.full(n, -1, dtype=np.int32)
    dw = np.zeros(n, dtype=bool)
    cont = np.zeros(n, dtype=bool) if sc.has_cross else None
    for k in range(d + 1):
        newly = (k_die < 0) & (depth_p[k : k + n] <= k)
        if newly.any():
            k_die[newly] = k
            dw[newly] = word_p[k : k + n][newly]
            if sc.has_cross and k > 0:  # k == 0 cannot cross (root children)
                cont[newly] = cross_p[k : k + n][newly]
    # Every walk dies within d+1 steps (depth <= d always).
    assert (k_die >= 0).all()

    # Pre-die state: the DFA arrival state one step before the die char
    # (root when k_die == 0).  Quotient planes carry ROW ids; the concrete
    # state is rows_flat[row_{i-1} * A + c_i] (ids[-1] = entry row 0: the
    # plane starts at a halo-warmed text position whose predecessor state
    # in PAD/left-halo context is the root row by the d-synchronization).
    w = np.arange(n, dtype=np.int64)
    i_pre = np.maximum(w + k_die - 1, 0)
    if sc.quotient:
        A = sc.num_classes
        ids_ext = np.concatenate([np.zeros(1, dtype=np.int64), ids])
        rows_flat = np.asarray(sc.rows_flat, dtype=np.int64)
        s_pre = rows_flat[ids_ext[i_pre] * A + cls_p[i_pre].astype(np.int64)]
    else:
        s_pre = ids[i_pre]
    s_last = np.where(k_die > 0, s_pre, 0)

    orow = np.asarray(sc.outrows)[s_last]  # (n, 8)
    own, ownv = orow[:, 0], orow[:, 1]
    fl, fo, fv = orow[:, 2], orow[:, 3], orow[:, 4]
    die_pos = (w + k_die).astype(np.int32)
    has_own = (own > 0) & ~dw
    has_fail = (fl > 0) & (dw | (own == 0))
    end = np.where(has_own, die_pos, die_pos - fo)
    length = np.where(has_own, own, fl)
    val = np.where(has_own, ownv, fv)
    has = has_own | has_fail
    outs = (die_pos, has, (end - length).astype(np.int32),
            end.astype(np.int32), val.astype(np.int32))
    if sc.has_cross:
        return outs + (cont,)
    return outs


@functools.partial(jax.jit, static_argnames=(
    "halo", "id_bits", "depth_bits", "num_classes", "d", "row_layout",
    "quotient", "n_keep", "cross"))
def wwl_scan_walks_all(
    table: jax.Array,
    rows_flat: Optional[jax.Array],
    outrows: jax.Array,
    windows: jax.Array,  # int32[B, halo + C]
    *,
    halo: int,
    id_bits: int,
    depth_bits: int,
    num_classes: int,
    d: int,
    row_layout: bool,
    quotient: bool,
    n_keep: int,  # leading positions to report (flat text order)
    cross: bool = False,
):
    """Walk outcomes for EVERY position (``wwl_walks`` contract): returns
    ``(die_pos, has, m_start, m_end, m_val)``, each length ``n_keep``
    (+ a ``cont`` plane with ``cross`` — see ``wwl_scan_walks``).

    The sharded scanner uses this variant — per-position outputs avoid the
    ragged per-shard word-start plumbing; the extra cost over the compacted
    form is one outcome row-gather per position instead of per start."""
    k_die, dw, prev, cx = _wwl_core(
        table, rows_flat, windows, halo, id_bits, depth_bits, num_classes,
        d, row_layout, quotient, cross=cross)
    kd = lax.slice(k_die, (0,), (n_keep,))
    dws = (lax.slice(dw, (0,), (n_keep,)) & 1).astype(bool)
    pg = lax.slice(prev, (0,), (n_keep,))
    s_last = rows_flat[pg] if quotient else pg
    pos = lax.broadcasted_iota(jnp.int32, (n_keep, 1), 0).squeeze(-1)
    outs = _wwl_outcomes(outrows, s_last, kd, dws, pos)
    if cross:
        cont = (lax.slice(cx, (0,), (n_keep,)) & 1).astype(bool)
        return outs + (cont,)
    return outs
