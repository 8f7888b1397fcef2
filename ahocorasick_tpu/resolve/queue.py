"""Leftmost-longest overlap resolution — exact ``SetMatchQueue`` semantics.

The reference buffers candidate matches in a pending queue and resolves
overlaps with three rules (``SetMatchQueue.java:59-94`` /
``MapMatchQueue.java:75-132``), assuming candidates arrive with
non-descending end index:

1. a candidate that starts at/after the end of every overlapping queued
   match is appended (dropping any queued matches contained in it),
2. a candidate with the same start as a queued match but longer replaces it
   (and drops the queue tail),
3. an overlapping candidate with a later start is rejected (leftmost wins),
4. a candidate starting before every queued match displaces the whole queue.

Why flush timing is irrelevant (and hence why a batch two-pass resolver is
exactly equivalent to the reference's incremental flush-on-fail-transition):
the reference only flushes entries with ``end <= idx - level(current)``
(``LongestMatchSet.java:227``), and every future candidate ends after ``idx``
with length at most ``level`` at its own end, so every future candidate
*starts* at or after ``idx - level`` — it can never overlap (and therefore
never displace) a flushed entry.  Flushing everything once at the end
produces the identical output sequence, including under early-stop
listeners, because deliveries always happen in queue (start-ascending)
order.  This lets the device pipeline gather all candidates in parallel first
and resolve afterwards.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

Match = Tuple[int, int, int]


class MatchQueue:
    """Host-side resolver reproducing ``SetMatchQueue.push`` exactly."""

    def __init__(self) -> None:
        self._starts: List[int] = []
        self._ends: List[int] = []
        self._vals: List[int] = []

    def push(self, start: int, end: int, value_id: int = -1) -> bool:
        starts, ends, vals = self._starts, self._ends, self._vals
        if starts:
            for slot in range(len(starts) - 1, -1, -1):
                if start >= starts[slot]:
                    if start >= ends[slot]:
                        # Non-overlapping: append after `slot`, truncating any
                        # later-start matches now contained in the new one.
                        del starts[slot + 1 :], ends[slot + 1 :], vals[slot + 1 :]
                        starts.append(start)
                        ends.append(end)
                        vals.append(value_id)
                        return True
                    if start == starts[slot] and ends[slot] < end:
                        # Same start, longer: replace and truncate the tail.
                        del starts[slot + 1 :], ends[slot + 1 :], vals[slot + 1 :]
                        starts[slot] = start
                        ends[slot] = end
                        vals[slot] = value_id
                        return True
                    return False  # overlapping later start: leftmost wins
            # Starts before everything queued: displace the whole queue.
            self._starts = [start]
            self._ends = [end]
            self._vals = [value_id]
            return True
        starts.append(start)
        ends.append(end)
        vals.append(value_id)
        return True

    def drain(self) -> List[Match]:
        out = list(zip(self._starts, self._ends, self._vals))
        self._starts, self._ends, self._vals = [], [], []
        return out

    def flush(self, purge_to: int) -> List[Match]:
        """Remove and return queued matches with ``end <= purge_to``.

        The reference's ``matchAndClear(..., purgeToIndex)`` semantics
        (``SetMatchQueue.java:19-42``): queued matches are non-overlapping
        and start/end ascending, so this is a prefix split.
        """
        k = 0
        ends = self._ends
        while k < len(ends) and ends[k] <= purge_to:
            k += 1
        out = list(zip(self._starts[:k], self._ends[:k], self._vals[:k]))
        del self._starts[:k], self._ends[:k], self._vals[:k]
        return out


def resolve_longest(
    starts: np.ndarray, ends: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve a full candidate array to leftmost-longest non-overlapping.

    Candidates must be sorted by ``(end asc, start asc)``.  Dispatches to
    the native C resolver when available (identical algorithm; adversarial
    inputs produce millions of candidates and the Python loop below — kept
    as the parity oracle — is ~100x slower there).
    """
    try:
        from ahocorasick_tpu.native import lib as native_lib

        native_ok = native_lib.available()
    except Exception:  # import/build failure only: fall back quietly
        native_ok = False
    if native_ok:
        # OUTSIDE the try: a real native-call failure must surface, not
        # silently degrade to the ~100x slower Python loop.
        return native_lib.resolve_longest(starts, ends, vals)
    return resolve_longest_py(starts, ends, vals)


def resolve_shortest(
    starts: np.ndarray, ends: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Resolve a full AC candidate array to the reference's leftmost-SHORTEST
    non-overlapping output (``ShortestMatchSet.java:182-260``).

    Candidates must be sorted by ``(end asc, start asc)`` — the order
    ``ops.emit.sort_by_end_start`` produces — and cover ALL keyword
    occurrences.  Equivalence with the reference's lagged restart loop:
    after a restart at cursor ``p``, the automaton walk detects a match at
    the minimal end ``e`` having any occurrence with start >= p, and reports
    the LONGEST such occurrence (the walk state is the longest suffix of
    ``[p, e)`` that is a keyword prefix; its own/inherited match is the
    longest complete-keyword suffix).  In (end asc, start asc) order, the
    first candidate with ``start >= p`` is exactly that pick: minimal end
    first, and at that end ascending start ranks longest first.  Restart
    then sets ``p = e`` (the reference resumes at ``root.getTransition`` of
    the char at ``e``).  Occurrences of keywords the reference prunes out of
    its automaton (a prefix node carries an own/inherited match,
    ``ShortestMatchSet.java:95-110``) can never be selected: the pruning
    witness is itself a candidate ending strictly earlier with start >= the
    pruned occurrence's start, so it always preempts.  Insert-time skipped
    keywords (exact duplicates / match-prefixed) must be excluded BEFORE the
    scan for map values to come out right — see
    ``core.compiler.shortest_survivors``.
    """
    try:
        from ahocorasick_tpu.native import lib as native_lib

        native_ok = native_lib.available()
    except Exception:  # import/build failure only: fall back quietly
        native_ok = False
    if native_ok:
        # OUTSIDE the try: a real native-call failure must surface, not
        # silently degrade to the ~100x slower Python loop.
        return native_lib.resolve_shortest(starts, ends, vals)
    return resolve_shortest_py(starts, ends, vals)


def resolve_shortest_py(
    starts: np.ndarray, ends: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-Python min-end greedy pass; parity oracle for the native one."""
    n = len(starts)
    out_s = np.empty(n, dtype=np.int64)
    out_e = np.empty(n, dtype=np.int64)
    out_v = np.empty(n, dtype=np.int64)
    k = 0
    p = 0  # restart cursor: matches may not start before it
    for i in range(n):
        s = int(starts[i])
        if s >= p:
            out_s[k] = s
            out_e[k] = p = int(ends[i])
            out_v[k] = int(vals[i])
            k += 1
    return out_s[:k], out_e[:k], out_v[:k]


def resolve_longest_py(
    starts: np.ndarray, ends: np.ndarray, vals: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pure-Python stack pass; the accepted set equals running
    ``MatchQueue.push`` over every candidate (see module docstring for the
    equivalence argument).  Parity oracle for the native resolver.
    """
    n = len(starts)
    out_s = np.empty(n, dtype=np.int64)
    out_e = np.empty(n, dtype=np.int64)
    out_v = np.empty(n, dtype=np.int64)
    top = -1
    for i in range(n):
        s, e, v = int(starts[i]), int(ends[i]), int(vals[i])
        # Find the last queued slot whose start is <= s; slots above it are
        # only dropped if the candidate is accepted (SetMatchQueue.java:63-88).
        j = top
        while j >= 0 and out_s[j] > s:
            j -= 1
        if j < 0:
            top = 0  # new leftmost: displace the whole queue
        elif s >= out_e[j]:
            top = j + 1  # non-overlapping: append, dropping contained tail
        elif s == out_s[j] and e > out_e[j]:
            top = j  # same start, longer: replace (and drop tail)
        else:
            continue  # overlapping later start: leftmost wins
        out_s[top] = s
        out_e[top] = e
        out_v[top] = v
    return out_s[: top + 1], out_e[: top + 1], out_v[: top + 1]
