"""Public matcher classes — the reference API surface, JAX engines inside.

Maps the reference's eight matchers (``StringSet``/``StringMap`` families)
onto five compiled kinds with set/map façades:

=====================================  =================================
Reference class                        Here
=====================================  =================================
``AhoCorasickSet``                     ``AhoCorasickSet``
``AhoCorasickMap<T>``                  ``AhoCorasickMap``
``LongestMatchSet`` / ``Map``          ``LongestMatchSet`` / ``Map``
``ShortestMatchSet`` / ``Map``         ``ShortestMatchSet`` / ``Map``
``WholeWordMatchSet`` / ``Map``        ``WholeWordMatchSet`` / ``Map``
``WholeWordLongestMatchSet`` / ``Map`` ``WholeWordLongestMatchSet``/``Map``
=====================================  =================================

Match-reporting conventions are the reference's exactly: ``end`` is one past
the last matched UTF-16 unit; a listener returning ``False`` stops the run;
matches are delivered in the sequential automaton's emission order.  With no
listener, ``match`` returns the full list of ``(start, end)`` tuples (sets)
or ``(start, end, value)`` (maps).

Engines: ``"device"`` runs the parallel JAX engines (PFAC failureless scan /
DFA lax.scan / whole-word walks); ``"gold"`` runs the sequential host model;
``"auto"`` picks by input size.  All engines are conformance-tested to be
bit-identical.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import (
    AC,
    LONGEST,
    SHORTEST,
    WHOLE_WORD,
    WHOLE_WORD_LONGEST,
    CompiledMatcher,
    compile_matcher,
)
from ahocorasick_tpu.resolve.queue import resolve_longest, resolve_shortest
from ahocorasick_tpu.resolve.wholeword import follow_chain
from ahocorasick_tpu.utils import chartables


def _device_capable(compiled: CompiledMatcher, kind: str) -> bool:
    """Does this compiled matcher have a device scan path?

    Dense matchers: always (packed or split layout).  Row-compressed
    (wide-alphabet) matchers: only the kinds whose device path is the packed
    batched/row scan over the quotient DFA (``ops/scan_batched``);
    WHOLE_WORD_LONGEST rides the scan-based walk engine over the quotient
    DFA when the trie is word-uniform (``ops/scan_wwl.scan_applicable``),
    else the (vectorized) host path.  SHORTEST scans as an AC automaton over
    the insert-surviving keywords plus a host resolve
    (``ShortestMatchSet._ac``) — its capability is the internal AC
    automaton's, which this predicate cannot see; ``_pick_engine`` and the
    sharded scanner consult that matcher directly, so SHORTEST answers True
    here (there is always at least the exact host-cursor path behind it).
    """
    if not compiled.is_row_compressed:
        return True
    from ahocorasick_tpu.ops import scan_batched

    if kind == SHORTEST:
        return True  # delegated: internal AC matcher or host cursor
    if kind == WHOLE_WORD_LONGEST:
        # Row-compressed WWL rides the scan-based walk engine: quotient DFA
        # + depth plane when the trie is word-uniform, or the truncated-
        # closure variant + sparse host continuations for separator-
        # spanning dictionaries (round 5; previously host-only).
        from ahocorasick_tpu.ops import scan_wwl

        return (scan_wwl.scan_applicable(compiled)
                or scan_wwl.mixed_scan_applicable(compiled))
    return kind in (AC, LONGEST, WHOLE_WORD) and scan_batched.quotient_packable(
        compiled
    )


_AUTO_DEVICE_MIN_UNITS = 1 << 14  # generic fallback (see _auto_min_units)


def _auto_min_units(compiled: CompiledMatcher) -> int:
    """Engine-aware auto threshold: input size above which the device path
    beats the host gold loop.

    The break-even is ``overhead / (gold_ns - engine_ns)`` per char; the
    gold loop costs ~1 us/char, far above any device engine, so the real
    differentiator is the first-call overhead (table build, upload,
    compile): small tables get 4Ki units, mid-size packed tables 16Ki, and
    huge split/hotstate tables, whose upload grows with table bytes, 64Ki.
    These thresholds were not measured on the card.
    """
    from ahocorasick_tpu.ops import scan_batched

    if compiled.dfa_next is None:
        return _AUTO_DEVICE_MIN_UNITS
    rows = scan_batched.effective_rows(compiled)
    table_bytes = rows * compiled.num_classes * 4
    if table_bytes > (48 << 20):
        return 1 << 16
    if table_bytes <= (16 << 20) and scan_batched.inline_packable(compiled):
        return 1 << 12
    return _AUTO_DEVICE_MIN_UNITS
# Lane counts are rounded up to this bucket so repeated calls with different
# text lengths reuse compiled executables (padded lanes die without emitting).
from ahocorasick_tpu.utils.lanes import LANE_BUCKET as _LANE_BUCKET
from ahocorasick_tpu.utils.lanes import bucket_depth as _bucket_depth


def _bucket_up(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class _DeviceTables:
    """Lazy per-matcher cache of device-resident (jnp) table arrays.

    State and class counts are rounded up to power-of-two buckets so
    different dictionaries of similar size share compiled executables.  The
    DEAD state is re-anchored to the last padded row (kernels identify it as
    ``shape[0] - 1``); padded rows/classes are unreachable.
    """

    def __init__(self, m: CompiledMatcher):
        self._m = m
        self._cache = {}
        self._sp = _bucket_up(m.num_states + 1)  # padded S+1 (dead = _sp - 1)
        self._ap = _bucket_up(m.num_classes)

    def _pad_states(self, arr: np.ndarray, fill) -> np.ndarray:
        out = np.full(self._sp, fill, dtype=arr.dtype)
        out[: len(arr)] = arr
        return out

    def _build(self, name: str) -> np.ndarray:
        m = self._m
        if name == "trie_next":
            dead = self._sp - 1
            t = np.full((self._sp, self._ap), dead, dtype=np.int32)
            t[: m.num_states + 1, : m.num_classes] = np.where(
                m.trie_next == m.num_states, dead, m.trie_next
            )
            return t
        if name == "dfa_next":
            t = np.zeros((self._sp, self._ap), dtype=np.int32)
            t[: m.num_states, : m.num_classes] = m.dfa_next
            return t
        if name == "dfa_next_shortest":
            # Consumer: the sigma-stitch shortest path (ops/stitch.py,
            # tests/test_stitch.py); production shortest scans bake the
            # restart in-kernel (ops/scan_dfa.shortest_states) instead.
            # The shortest matcher's restart-at-root baked into the table:
            # delta''[s, c] = delta[root, c] for match states (which makes the
            # lagged loop a *pure* DFA, chunk-stitchable like any other).
            eff = m.dfa_next.copy()
            eff[m.match_len[: m.num_states] > 0] = m.dfa_next[0]
            t = np.zeros((self._sp, self._ap), dtype=np.int32)
            t[: m.num_states, : m.num_classes] = eff
            return t
        if name == "is_match":
            return self._pad_states(m.own_len, 0) > 0
        if name == "class_is_word":
            out = np.zeros(self._ap, dtype=bool)
            out[: m.num_classes] = m.class_is_word
            return out
        arr = getattr(m, name)
        if arr is None:
            raise AttributeError(name)
        fill = -1 if name.endswith("_val") else 0
        return self._pad_states(arr, fill)

    def __getattr__(self, name):
        cache = self.__dict__["_cache"]
        if name not in cache:
            import jax.numpy as jnp

            cache[name] = jnp.asarray(self._build(name))
        return cache[name]

    @property
    def ranked(self):
        """Ranked tables for the gather-minimized PFAC v2 engine (lazy)."""
        cache = self.__dict__["_cache"]
        if "ranked" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_pfac2

            rt = scan_pfac2.build_ranked(self._m)
            trie = np.full((self._sp, self._ap), rt.dead_state, dtype=np.uint32)
            trie[: rt.num_states, : self._m.num_classes] = rt.trie_next
            cache["ranked"] = rt._replace(trie_next=jnp.asarray(trie),
                                          prefix=jnp.asarray(rt.prefix))
        return cache["ranked"]

    @property
    def packed2_dfa(self):
        """Stride-2 packed DFA for the v4b engine (lazy; see scan_batched2)."""
        cache = self.__dict__["_cache"]
        if "packed2_dfa" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_batched2

            p2 = scan_batched2.build_packed2(self._m)
            cache["packed2_dfa"] = p2._replace(table=jnp.asarray(p2.table))
        return cache["packed2_dfa"]

    @property
    def row_dfa(self):
        """Stride-2 row-gather DFA for the v6 engine (lazy; scan_rowdfa)."""
        cache = self.__dict__["_cache"]
        if "row_dfa" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_rowdfa

            rd = scan_rowdfa.build_rowdfa(self._m)
            cache["row_dfa"] = rd._replace(table=jnp.asarray(rd.table))
        return cache["row_dfa"]

    @property
    def row_dfa1(self):
        """Stride-1 row-gather DFA for the v7 engine (lazy; scan_rowdfa)."""
        cache = self.__dict__["_cache"]
        if "row_dfa1" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_rowdfa

            rd = scan_rowdfa.build_rowdfa1(self._m)
            cache["row_dfa1"] = rd._replace(table=jnp.asarray(rd.table))
        return cache["row_dfa1"]

    @property
    def wwl_scan(self):
        """Packed scan tables for the scan-based whole-word-longest engine
        (lazy; ``ops/scan_wwl.build_wwl_scan``)."""
        cache = self.__dict__["_cache"]
        if "wwl_scan" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_wwl

            sc = scan_wwl.build_wwl_scan(self._m)
            cache["wwl_scan_host"] = sc
            cache["wwl_scan"] = sc._replace(
                table=jnp.asarray(sc.table),
                rows_flat=None if sc.rows_flat is None
                else jnp.asarray(sc.rows_flat),
                outrows=jnp.asarray(sc.outrows),
            )
        return cache["wwl_scan"]

    @property
    def wwl_scan_host(self):
        """Host (numpy) copy of ``wwl_scan`` — the state-sharded TP scanner
        pads/re-shards the raw table itself (``TableShardedScanner``)."""
        self.wwl_scan  # ensure built
        return self.__dict__["_cache"]["wwl_scan_host"]

    @property
    def wwl_scan_mixed(self):
        """Truncated-closure scan tables for separator-spanning WWL
        dictionaries (lazy; ``ops/scan_wwl.build_wwl_scan_mixed``).  The
        host copy stays cached too (``wwl_scan_mixed_host``): the
        state-sharded TP scanner pads/re-shards the raw table itself, so
        one truncated-closure build serves both paths."""
        cache = self.__dict__["_cache"]
        if "wwl_scan_mixed" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_wwl

            sc = scan_wwl.build_wwl_scan_mixed(self._m)
            cache["wwl_scan_mixed_host"] = sc
            cache["wwl_scan_mixed"] = sc._replace(
                table=jnp.asarray(sc.table),
                rows_flat=None if sc.rows_flat is None
                else jnp.asarray(sc.rows_flat),
                outrows=jnp.asarray(sc.outrows),
            )
        return cache["wwl_scan_mixed"]

    @property
    def wwl_scan_mixed_host(self):
        self.wwl_scan_mixed  # ensure built
        return self.__dict__["_cache"]["wwl_scan_mixed_host"]

    @property
    def split_dfa(self):
        """Flat next-state + per-state emit planes for the split-gather path
        (big dictionaries where the packed layout overflows; lazy)."""
        cache = self.__dict__["_cache"]
        if "split_dfa" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_batched

            pd = scan_batched.build_packed(self._m)
            assert pd.emit_mask is not None
            # uint32: the split kernels index s*A+c in uint32 (huge dicts).
            flat = pd.table.astype(np.uint32).reshape(-1)
            cache["split_dfa"] = (
                jnp.asarray(flat),
                jnp.asarray(pd.emit_mask),
                pd.halo,
            )
        return cache["split_dfa"]

    @property
    def count_packed_dfa(self):
        """Flat ``next | emit_count << state_bits`` table for count-style
        scans of huge dictionaries (one gather per character where the split
        path pays two; ``scan_batched.count_packable``; lazy)."""
        cache = self.__dict__["_cache"]
        if "count_packed_dfa" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_batched

            flat, state_bits, halo = scan_batched.build_count_packed(self._m)
            cache["count_packed_dfa"] = (jnp.asarray(flat), state_bits, halo)
        return cache["count_packed_dfa"]

    @property
    def packed_dfa(self):
        """Packed goto-closure DFA for the batched-halo v4 engine (lazy)."""
        cache = self.__dict__["_cache"]
        if "packed_dfa" not in cache:
            import jax.numpy as jnp

            from ahocorasick_tpu.ops import scan_batched

            pd = scan_batched.build_packed(self._m)
            ap = self._ap
            # Quotient rows for row-compressed matchers (scan_batched doc).
            table = np.zeros((pd.table.shape[0], ap), dtype=np.uint32)
            table[:, : self._m.num_classes] = pd.table
            # Padded class columns behave like class 0 (non-keyword char).
            table[:, self._m.num_classes :] = pd.table[:, :1]
            cache["packed_dfa"] = pd._replace(table=jnp.asarray(table))
        return cache["packed_dfa"]

    def device_bytes(self) -> int:
        """Total bytes of device-resident table arrays built so far — the
        matcher's HBM table footprint after warmup.  The host compiled-form
        size is ``CompiledMatcher.memory_bytes`` (the analog of the
        reference README's memory column, README.md:135,148-150); the
        device number is smaller because engines upload one packed layout,
        not the whole compiled form."""
        cache = self.__dict__["_cache"]
        if not cache:
            return 0  # nothing built — and never import jax just to say so
        import jax

        seen: set = set()
        total = 0
        # tree_leaves descends tuples/NamedTuples/lists/dicts alike; the
        # isinstance filter drops host-side numpy copies (e.g.
        # wwl_scan_host) and scalar metadata.
        for leaf in jax.tree_util.tree_leaves(list(cache.values())):
            if isinstance(leaf, jax.Array) and id(leaf) not in seen:
                seen.add(id(leaf))
                total += leaf.nbytes
        return total


class _Matcher:
    kind: str = ""
    is_map: bool = False

    def __init__(
        self,
        keywords: Iterable[str],
        case_sensitive: bool = True,
        *,
        values: Optional[Iterable] = None,
        word_chars: Optional[np.ndarray] = None,
        engine: str = "auto",
        thresholder=None,
    ) -> None:
        # ``thresholder`` governs the dense-vs-row-compressed table layout —
        # the framework's analog of the reference's RangeNode/HashmapNode
        # node-storage policy (threshold/Thresholder.java:3-5).  See
        # utils/thresholds.py for the SPI mapping; None = default budget.
        if engine not in ("auto", "device", "gold"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self.compiled = compile_matcher(
            keywords,
            self.kind,
            case_sensitive,
            values=values if self.is_map else None,
            word_chars=word_chars,
            thresholder=thresholder,
        )
        if engine == "device" and not _device_capable(self.compiled, self.kind):
            raise ValueError(
                "dictionary is too wide for this kind's device path "
                f"(kind {self.kind!r}, {self.compiled.num_states} states x "
                f"{self.compiled.num_classes} classes); use engine='auto' "
                "or 'gold' (row-compressed host tables)"
            )
        self.dev = _DeviceTables(self.compiled)

    # ------------------------------------------------------------------ #

    def _classes(self, text: str) -> np.ndarray:
        units = chartables.to_utf16_units(text)
        return self.compiled.charmap[units]

    def _pick_engine(self, n_units: int) -> str:
        if self.compiled.is_row_compressed and not _device_capable(
            self.compiled, self.kind
        ):
            return "gold"  # no quotient device layout for this kind
        if self.engine != "auto":
            return self.engine
        thr = self.__dict__.get("_auto_min")
        if thr is None:
            thr = self.__dict__["_auto_min"] = _auto_min_units(self.compiled)
        return "device" if n_units >= thr else "gold"

    def match_triples(self, text: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """All matches as (starts, ends, value_ids) numpy arrays, in the
        reference's emission order."""
        return self._match_triples_impl(text, self._classes(text))

    def _match_triples_impl(self, text: str, cls: np.ndarray):
        from ahocorasick_tpu.utils.stats import ScanStats, timed

        engine = self._pick_engine(len(cls))
        self.last_stats = ScanStats(units=len(cls), engine=engine, kind=self.kind)
        if len(cls) == 0:
            # Every kind matches nothing in an empty text; returning here
            # keeps the device engines (and their table builds/compiles)
            # untouched by empty feeds — notably the pfac2 ranked-table
            # build, which would densify row-compressed tries.
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        with timed(self.last_stats):
            if engine == "gold":
                if self.compiled.is_row_compressed and self.kind in (
                    "ac", "longest", "shortest",
                ):
                    # Row-compressed dictionaries skip the per-char Python
                    # gold loop: one vectorized cursor feed (jitted two-level
                    # gather scan + numpy emit expansion) is exact for any
                    # text (core/stream.py) and much faster on match-sparse
                    # inputs (the scan is jit-compiled; only emission work
                    # remains in Python/numpy).
                    from ahocorasick_tpu.core.stream import make_cursor

                    trip = make_cursor(self.compiled).feed(cls, is_final=True)
                else:
                    trip = gold.gold_match(self.compiled, text)
                if not trip:
                    z = np.zeros(0, dtype=np.int64)
                    out = z, z, z.copy()
                else:
                    a = np.asarray(trip, dtype=np.int64)
                    out = a[:, 0], a[:, 1], a[:, 2]
            else:
                out = self._device_triples(cls)
        self.last_stats.matches = int(len(out[0]))
        return out

    def _device_triples(self, cls: np.ndarray):
        raise NotImplementedError

    def count(self, text: str) -> int:
        starts, _, _ = self.match_triples(text)
        return int(len(starts))

    def device_table_bytes(self) -> int:
        """HBM bytes of the engine tables uploaded so far (0 before the
        first device scan; grows as lazy layouts build).  Shortest matchers
        include their internal candidate automaton (``_ac``)."""
        total = self.dev.device_bytes()
        inner = self.__dict__.get("_ac_cache")  # built lazily; 0 until then
        if inner is not None:
            total += inner.device_table_bytes()
        return total

    def host_table_bytes(self) -> int:
        """Host bytes of the compiled form(s) actually resident — the
        reference README's memory column analog (README.md:135,148-150).
        Shortest matchers add their internal candidate automaton's compiled
        form (once built), keeping this symmetric with
        ``device_table_bytes``; plain ``compiled.memory_bytes()`` reports
        only the outer automaton."""
        total = self.compiled.memory_bytes()
        inner = self.__dict__.get("_ac_cache")
        if inner is not None:
            total += inner.host_table_bytes()
        return total

    def _deliver(self, text: str, listener, starts, ends, vals):
        # tolist() up front: C-speed conversion to plain ints beats a
        # per-match int(numpy_scalar) in the delivery loop ~3x at tens of
        # millions of matches (the loop itself is the reference's one-call-
        # per-match listener contract, AhoCorasickSet.java:223-225).
        values = self.compiled.values
        sl = np.asarray(starts).tolist()
        el = np.asarray(ends).tolist()
        if self.is_map:
            vl = np.asarray(vals).tolist()
            for s, e, v in zip(sl, el, vl):
                if listener(text, s, e, values[v]) is False:
                    return
        else:
            for s, e in zip(sl, el):
                if listener(text, s, e) is False:
                    return

    # Listener-mode scans of haystacks longer than this are chunked through
    # the stream cursor so a False return stops the scan after the current
    # chunk — the reference breaks its scan loop on False
    # (AhoCorasickSet.java:223-225); chunk-at-a-time is the device analog of
    # that work saving.  Chunks grow geometrically from _LISTENER_CHUNK_MIN
    # so a listener that stops on the first match scans KiBs, not MiBs,
    # while full scans amortize to the big chunk within 3 dispatches.
    _LISTENER_CHUNK = 1 << 20
    _LISTENER_CHUNK_MIN = 1 << 14

    def match(self, haystack: str, listener: Optional[Callable] = None):
        """Reference ``match``: deliver to a listener, or return the list."""
        if listener is not None:
            if self._listener_chunkable(haystack):
                return self._match_chunked(haystack, listener)
            starts, ends, vals = self.match_triples(haystack)
            self._deliver(haystack, listener, starts, ends, vals)
            return None
        starts, ends, vals = self.match_triples(haystack)
        sl = np.asarray(starts).tolist()
        el = np.asarray(ends).tolist()
        if self.is_map:
            values = self.compiled.values
            vl = np.asarray(vals).tolist()
            return [(s, e, values[v]) for s, e, v in zip(sl, el, vl)]
        return list(zip(sl, el))

    def _listener_chunkable(self, haystack: str) -> bool:
        # Every kind's stream cursor now rides the device engines (DFA
        # kinds: tail-carried batched scans; whole-word kinds: candidates/
        # compact-walk engines), so chunked delivery costs nothing and a
        # False listener saves the unscanned suffix for all of them.
        # Row-compressed shapes without a device path pick "gold" here and
        # keep the full-scan path.  The gate is in UTF-16 UNITS: astral
        # code points count twice, so texts near the threshold measure
        # their exact unit length (the encode is amortized by the scan).
        n = len(haystack)
        if 2 * n <= self._LISTENER_CHUNK:
            return False  # cannot reach the gate even if all astral
        if n <= self._LISTENER_CHUNK:
            n = len(chartables.to_utf16_units(haystack))
        return n > self._LISTENER_CHUNK and self._pick_engine(n) == "device"

    def _match_chunked(self, haystack: str, listener) -> None:
        """Chunk-at-a-time listener delivery; stops reading on False.

        Delivery order is identical to the full-scan path: each kind's
        stream cursor finalizes matches in the batch emission order, and
        chunk outputs are consecutive (conformance: tests/test_stream.py).
        """
        from ahocorasick_tpu.utils.stats import ScanStats, timed

        scanner = self._stream_scanner(self._LISTENER_CHUNK)
        values = self.compiled.values
        n = len(haystack)
        self.last_stats = ScanStats(units=0, engine="device", kind=self.kind)
        delivered = 0
        with timed(self.last_stats):
            i = 0
            chunk = min(self._LISTENER_CHUNK_MIN, self._LISTENER_CHUNK)
            while i < n:
                piece = haystack[i : i + chunk]
                i += len(piece)
                chunk = min(chunk * 4, self._LISTENER_CHUNK)
                starts, ends, vals = scanner.feed_arrays(
                    piece, is_final=i >= n)
                # Cursor offsets are UTF-16 units (ScanStats contract);
                # code-point slicing only drives the chunk loop.
                self.last_stats.units = scanner.cursor.off
                # tolist + hoisted map branch: see _deliver.
                sl = np.asarray(starts).tolist()
                el = np.asarray(ends).tolist()
                if self.is_map:
                    vl = np.asarray(vals).tolist()
                    for s, e, v in zip(sl, el, vl):
                        delivered += 1
                        if listener(haystack, s, e, values[v]) is False:
                            self.last_stats.matches = delivered
                            return None
                else:
                    for s, e in zip(sl, el):
                        delivered += 1
                        if listener(haystack, s, e) is False:
                            self.last_stats.matches = delivered
                            return None
        self.last_stats.matches = delivered
        return None

    # ------------------------------ streaming ------------------------------ #

    def match_stream(self, source, listener: Optional[Callable] = None, *, chunk_units=None):
        """Scan an unbounded stream (file-like ``read(n)`` or str iterable).

        Output equals String-mode ``match`` with global UTF-16 offsets, for
        any chunking (see ``core/stream.py``).  With a listener
        (``(start, end[, value]) -> bool``), matches are delivered as they
        finalize and a ``False`` return stops reading; otherwise the full
        list is returned.
        """
        scanner = self._stream_scanner(chunk_units)
        values = self.compiled.values
        if listener is None:
            if self.is_map:
                return [(s, e, values[v]) for s, e, v in scanner.scan(source)]
            return [(s, e) for s, e, _ in scanner.scan(source)]
        for s, e, v in scanner.scan(source):
            res = listener(s, e, values[v]) if self.is_map else listener(s, e)
            if res is False:
                break
        return None

    def stream(self, chunk_units=None):
        """A push-mode scanner: ``feed(text, is_final)`` returns finalized
        global matches — ``(start, end)`` for sets, ``(start, end, value)``
        for maps; ``state_dict()``/``load_state_dict()`` persist the cursor
        across processes (resumable scans)."""
        return _MatcherStream(self._stream_scanner(chunk_units), self.is_map)

    def _stream_scanner(self, chunk_units):
        """Streaming scanner wired to this matcher's device tables, so large
        feeds ride the same parallel engines as batch mode (exactness:
        ``core/stream._CandidateSource``)."""
        from ahocorasick_tpu.core.stream import StreamScanner

        return StreamScanner(self.compiled, chunk_units, dev=self.dev,
                             engine=self.engine, ac=self._stream_ac())

    def _stream_ac(self):
        return None

    # ----------------------------- persistence ----------------------------- #

    def save(self, path) -> None:
        """Persist the compiled automaton (see ``core/artifact.py``)."""
        from ahocorasick_tpu.core import artifact

        artifact.save(self.compiled, path)

    @classmethod
    def from_compiled(cls, compiled: CompiledMatcher, engine: str = "auto"):
        """Wrap an existing/loaded ``CompiledMatcher`` without recompiling."""
        if engine not in ("auto", "device", "gold"):
            raise ValueError(f"unknown engine {engine!r}")
        if compiled.kind != cls.kind or (compiled.values is not None) != cls.is_map:
            raise ValueError(
                f"artifact is kind={compiled.kind!r} "
                f"{'map' if compiled.values is not None else 'set'}; "
                f"expected {cls.kind!r} {'map' if cls.is_map else 'set'}"
            )
        if engine == "device" and not _device_capable(compiled, cls.kind):
            raise ValueError(
                "row-compressed artifact has no device path for this kind; "
                "use engine='auto' or 'gold'"
            )
        if engine == "device" and cls.kind == SHORTEST and compiled.is_row_compressed:
            # _device_capable answers True for SHORTEST by delegating to the
            # internal AC automaton — which an artifact cannot rebuild (no
            # keyword source), so only the host cursor path remains.
            raise ValueError(
                "row-compressed shortest artifact has no device path (no "
                "keyword source for the internal AC automaton); use "
                "engine='auto' or 'gold'"
            )
        self = cls.__new__(cls)
        self.engine = engine
        self.compiled = compiled
        self.dev = _DeviceTables(compiled)
        return self

    def match_readable(self, source, listener: Callable, *, chunk_units=None):
        """Reference ``StringMap.match(Readable, ReadableMatchListener)``:
        the listener receives values only (``StringMap.java:6``,
        ``ReadableMatchListener.java:4-9``); ``False`` stops the run."""
        if not self.is_map:
            raise TypeError("match_readable is a map-matcher API (values-only)")
        scanner = self._stream_scanner(chunk_units)
        values = self.compiled.values
        for _, _, v in scanner.scan(source):
            if listener(values[v]) is False:
                break
        return None


# --------------------------------------------------------------------------- #
# Device engine mixins per kind
# --------------------------------------------------------------------------- #


# v4 chunk length: B = N/C lanes scan C sequential steps; small C maximizes
# gather-lane parallelism, the (d-1)-halo warmup is the only overhead.
_BATCH_CHUNK = 512


def _wwl_compact_lanes(compiled: CompiledMatcher, cls: np.ndarray):
    """Back-compat alias: the one implementation lives in
    ``ops.scan_wwl.compact_lanes`` (shared with the bench harness and the
    streaming cursor)."""
    from ahocorasick_tpu.ops import scan_wwl

    return scan_wwl.compact_lanes(compiled, cls, text_start=True)


class _PfacEngine(_Matcher):
    """All-candidates parallel scan; AC emits directly, Longest resolves.

    Default device path is the engine ``ops/dispatch`` picks (row-gather /
    batched-halo DFA scan, one table lookup per character);
    the PFAC v2 walk engine remains available via
    ``device_engine="pfac2"`` for cross-checking.
    """

    device_engine = "rowdfa"

    def _candidates(self, cls: np.ndarray):
        planes = self._end_planes(cls)
        if planes is None:
            return self._candidates_pfac2(cls)
        bits, layout = planes
        from ahocorasick_tpu.ops import scan_batched

        return scan_batched.ac_matches_batched(self.compiled, cls, bits,
                                               layout=layout)

    def _end_planes(self, cls: np.ndarray):
        """``(bits, layout)`` from the picked engine
        (``ops.dispatch.planes_plan``): END-indexed emit planes
        ``uint32[P, >=len(cls)]`` with layout "planes", or the packed
        (state, count) plane with layout "hotstate" (huge dictionaries).
        None when the configured engine is not plane-producing (the pfac2
        cross-check walk emits START-indexed planes)."""
        if self.device_engine == "pfac2" or len(cls) == 0:
            return None
        if self.device_engine == "batched2":
            return self._planes_batched2(cls)
        return self._planes_auto(cls)

    def _planes_auto(self, cls: np.ndarray, force_batched: bool = None):
        import jax.numpy as jnp

        from ahocorasick_tpu.ops import dispatch, scan_batched

        if force_batched is None:
            force_batched = self.device_engine != "rowdfa"
        plan = dispatch.planes_plan(self.compiled, self.dev,
                                    "batched" if force_batched else None)
        windows = scan_batched.chunk_classes(
            cls, _BATCH_CHUNK, plan.halo, self.compiled.num_classes)
        bits = plan.fn(plan.tables, jnp.asarray(windows))
        return bits, ("hotstate" if plan.which == "hotstate" else "planes")

    def _planes_batched2(self, cls: np.ndarray):
        import jax.numpy as jnp

        from ahocorasick_tpu.ops import scan_batched2

        m = self.compiled
        if not scan_batched2.fits(m):
            # Doesn't-fit fallback rides the picked fastest engine, not the
            # forced batched path (the knob only forces batched2 itself).
            return self._planes_auto(cls, force_batched=False)
        p2 = self.dev.packed2_dfa
        d = max(m.max_depth, 1)
        windows = scan_batched2.chunk_classes2(cls, _BATCH_CHUNK, p2.halo)
        bits = scan_batched2.batched2_emit_planes(
            p2.table, jnp.asarray(windows), p2.halo, p2.state_bits,
            p2.num_classes, (d + 31) // 32,
        )
        return bits, "planes"

    def _candidates_pfac2(self, cls: np.ndarray):
        import jax.numpy as jnp

        from ahocorasick_tpu.ops import emit, scan_pfac2

        m = self.compiled
        rt = self.dev.ranked
        d = _bucket_depth(m.max_depth)
        planes = (d + 31) // 32
        cls_p = scan_pfac2.pad_classes(cls, d, bucket=_LANE_BUCKET)
        bits = scan_pfac2.pfac2_bitplanes(
            rt.trie_next,
            rt.prefix,
            jnp.uint32(rt.match_threshold),
            jnp.asarray(cls_p.astype(np.int32)),
            d,
            planes,
            rt.prefix_k,
            m.num_classes,
        )
        return emit.ac_matches(m, cls, np.asarray(bits))


class AhoCorasickSet(_PfacEngine):
    """All occurrences of all keywords, overlapping (reference ``AhoCorasickSet``)."""

    kind = AC

    def _device_triples(self, cls):
        return self._candidates(cls)

    def count(self, text: str) -> int:
        """Total match count (the reference's empty-listener benchmark).

        AC semantics need no resolution, so the device path runs the picked
        engine's fused COUNT kernel — popcount-summed on device, one scalar
        downloaded, no extraction — instead of materializing every triple.
        The other kinds keep counting via resolved triples.
        """
        from ahocorasick_tpu.utils.stats import ScanStats, timed

        cls = self._classes(text)
        engine = self._pick_engine(len(cls))
        if engine != "device" or self.device_engine not in ("rowdfa", "batched"):
            # Fallback shares the already-computed classes (no re-encode).
            return int(len(self._match_triples_impl(text, cls)[0]))
        self.last_stats = ScanStats(units=len(cls), engine=engine, kind=self.kind)
        with timed(self.last_stats):
            n = int(self._device_count(cls))
        self.last_stats.matches = n
        return n

    def _device_count(self, cls: np.ndarray):
        import jax.numpy as jnp

        from ahocorasick_tpu.ops import dispatch, scan_batched

        plan = dispatch.count_plan(
            self.compiled, self.dev,
            "batched" if self.device_engine == "batched" else None)
        windows = scan_batched.chunk_classes(
            cls, _BATCH_CHUNK, plan.halo, self.compiled.num_classes)
        return plan.fn(plan.tables, jnp.asarray(windows))


class AhoCorasickMap(AhoCorasickSet):
    kind = AC
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class LongestMatchSet(_PfacEngine):
    """Leftmost-longest non-overlapping (reference ``LongestMatchSet``)."""

    kind = LONGEST

    def _device_triples(self, cls):
        planes = self._end_planes(cls)
        if planes is None:
            return resolve_longest(*self._candidates(cls))
        from ahocorasick_tpu.ops import emit

        bits, layout = planes
        return emit.resolve_end_planes(self.compiled, cls, bits, "longest",
                                       layout=layout)


class LongestMatchMap(LongestMatchSet):
    kind = LONGEST
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class ShortestMatchSet(_Matcher):
    """Leftmost-shortest non-overlapping (reference ``ShortestMatchSet``).

    Device path: the reference's lagged restart loop
    (``ShortestMatchSet.java:182-260``) destroys d-synchronization (the
    state depends on where earlier matches ended, not just the last d
    characters), so it cannot ride the parallel halo-warmup engines
    directly.  Instead we scan a plain AC automaton over the
    insert-surviving keywords with the SAME fast engines every other kind
    uses (``pick_engine``: rowdfa / batched), then run the exact
    min-end greedy resolve (``resolve.queue.resolve_shortest`` — the
    equivalence argument lives on that docstring).  ``save`` bundles the
    internal AC automaton into the one npz artifact and ``load_matcher``
    restores it, so loaded artifacts keep this path for any save target
    (fspath or file-like); without the bundle, ``from_compiled`` falls back
    to the sequential restart-baked device scan (dense) or the host cursor.
    """

    kind = SHORTEST

    def __init__(self, keywords, case_sensitive: bool = True, **kw):
        keywords = list(keywords)
        if kw.get("values") is not None:
            kw["values"] = list(kw["values"])
        super().__init__(keywords, case_sensitive, **kw)
        self._src = (keywords, kw.get("values"), case_sensitive,
                     kw.get("thresholder"))
        self._ac_cache = None
        if self.engine == "device" and not _device_capable(self._ac.compiled, AC):
            raise ValueError(
                "dictionary is too wide for the shortest device path "
                "(the internal AC automaton has no packable quotient); "
                "use engine='auto' or 'gold'"
            )

    @property
    def _ac(self):
        """Internal AC matcher over the insert-surviving keywords (lazy);
        None for ``from_compiled`` artifacts without an AC sidecar."""
        if getattr(self, "_ac_cache", None) is not None:
            return self._ac_cache  # keyword-built earlier, or sidecar-loaded
        src = getattr(self, "_src", None)
        if src is None:
            return None
        if self._ac_cache is None:
            from ahocorasick_tpu.core.compiler import shortest_survivors

            kws, vals, case_sensitive, thresholder = src
            skws, svals = shortest_survivors(kws, case_sensitive, vals)
            if self.is_map:
                self._ac_cache = AhoCorasickMap(
                    skws, svals, case_sensitive, thresholder=thresholder
                )
            else:
                self._ac_cache = AhoCorasickSet(
                    skws, case_sensitive, thresholder=thresholder
                )
            # The two compiles see the same char set in the same first-
            # occurrence order (insert-skipped keywords never add new chars:
            # the skip trigger is an existing keyword path), so the charmaps
            # normally coincide and shortest-classes feed the AC engines
            # directly.  Guard with a class remap if they ever diverge.
            self._cls_map = _build_cls_map(self.compiled,
                                           self._ac_cache.compiled)
        return self._ac_cache

    def _ac_classes(self, cls: np.ndarray) -> np.ndarray:
        """Shortest-charmap classes -> internal-AC-charmap classes."""
        return cls if self._cls_map is None else self._cls_map[cls]

    # -------- artifact persistence (internal AC rides as a sidecar) ------- #

    def save(self, path) -> None:
        """Persist the compiled automaton AND the internal AC automaton in
        ONE npz, so ``load_matcher`` restores the full device path from any
        target — fspath, bytes path, or file-like (BytesIO) alike
        (candidates-then-resolve needs the survivors' AC; without it a
        loaded shortest matcher only has the sequential scan).  The
        survivors-AC is re-derivable compile state that must survive
        persistence (``ShortestMatchSet.java:23-42``)."""
        from ahocorasick_tpu.core import artifact

        ac = self._ac
        artifact.save(self.compiled, path,
                      ac=ac.compiled if ac is not None else None)

    @classmethod
    def from_compiled(cls, compiled, engine: str = "auto", ac_compiled=None):
        """``ac_compiled``: the sidecar internal-AC automaton (same save);
        restores the fast candidates-then-resolve device path."""
        if ac_compiled is None:
            return super().from_compiled(compiled, engine=engine)
        self = _Matcher.from_compiled.__func__(cls, compiled, "auto")
        self._src = None
        ac_cls = AhoCorasickMap if cls.is_map else AhoCorasickSet
        self._ac_cache = ac_cls.from_compiled(ac_compiled)
        self._cls_map = _build_cls_map(compiled, ac_compiled)
        if engine == "device" and not _device_capable(ac_compiled, AC):
            raise ValueError(
                "sidecar AC automaton has no device path; use engine='auto'"
            )
        self.engine = engine
        return self

    def _stream_ac(self):
        """Streaming candidate source: a SUPPLIER of the internal AC
        automaton + class remap, resolved lazily by the cursor only when a
        feed crosses the device threshold — small streams never pay the
        second compile (mirrors ``_pick_engine``'s small-input guard).
        None for gold matchers; the supplier itself returns None for
        ``from_compiled`` artifacts without an AC sidecar (the cursor then
        keeps the sequential restart-baked scan)."""
        if self.engine == "gold":
            return None

        def supplier():
            ac = self._ac
            if ac is None:
                return None
            return (ac.compiled, ac.dev, self._cls_map)

        return supplier

    def _pick_engine(self, n_units: int) -> str:
        if self.engine == "gold":
            return "gold"  # never build the internal AC for gold matchers
        if self.engine == "auto" and n_units < _AUTO_DEVICE_MIN_UNITS:
            return "gold"  # small input: skip the second compile too
        ac = self._ac
        if ac is None:
            if self.compiled.is_row_compressed:
                return "gold"  # artifact without dense tables: host path
            return super()._pick_engine(n_units)
        if not _device_capable(ac.compiled, AC):
            return "gold"
        return "device"

    def _device_triples(self, cls):
        ac = self._ac
        if ac is not None:
            cls = self._ac_classes(cls)
            planes = ac._end_planes(cls)
            if planes is None:
                return resolve_shortest(*ac._candidates(cls))
            from ahocorasick_tpu.ops import emit

            bits, layout = planes
            return emit.resolve_end_planes(ac.compiled, cls, bits, "shortest",
                                           layout=layout)

        # from_compiled fallback: sequential scan of the restart-baked DFA.
        import jax.numpy as jnp

        from ahocorasick_tpu.ops import emit, scan_dfa, scan_pfac

        n = len(cls)
        cls_p = scan_pfac.pad_classes(cls, 0, bucket=_LANE_BUCKET)
        states = scan_dfa.shortest_states(
            self.dev.dfa_next, self.dev.match_len, jnp.asarray(cls_p.astype(np.int32))
        )
        return emit.states_to_shortest_matches(self.compiled, np.asarray(states)[:n])


class ShortestMatchMap(ShortestMatchSet):
    kind = SHORTEST
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class WholeWordMatchSet(_PfacEngine):
    """Whole-word-only matches (reference ``WholeWordMatchSet``).

    Device path: pure-word-char keywords match a whole word iff they occur
    as an AC substring with non-word (or text-edge) characters on both
    sides, so the batched AC engine runs first and a vectorized boundary
    filter keeps the whole-word subset — exactly the reference semantics
    (``WholeWordMatchSet.java:47-132``: one candidate per maximal word run).
    """

    kind = WHOLE_WORD

    def __init__(self, keywords, case_sensitive=True, *, word_chars=None, toggle_flags=None, **kw):
        word_chars = _resolve_word_chars(word_chars, toggle_flags)
        super().__init__(keywords, case_sensitive, word_chars=word_chars, **kw)

    def _device_triples(self, cls):
        from ahocorasick_tpu.resolve.wholeword import boundary_filter

        return boundary_filter(self.compiled.class_is_word, cls,
                               *self._candidates(cls))


class WholeWordMatchMap(WholeWordMatchSet):
    kind = WHOLE_WORD
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class WholeWordLongestMatchSet(_Matcher):
    """Whole-word matches that may span separators (reference
    ``WholeWordLongestMatchSet``)."""

    kind = WHOLE_WORD_LONGEST

    def __init__(self, keywords, case_sensitive=True, *, word_chars=None, toggle_flags=None, **kw):
        word_chars = _resolve_word_chars(word_chars, toggle_flags)
        super().__init__(keywords, case_sensitive, word_chars=word_chars, **kw)

    # Word-start density below which the compacted walk engine wins: it
    # pays 2 gathers per (start, step) where the full engine pays 1 table
    # gather + a free contiguous slice per (lane, step) over ALL lanes.
    _WWL_COMPACT_DENSITY = 0.35

    def _device_triples(self, cls):
        import jax.numpy as jnp

        from ahocorasick_tpu.ops import scan_batched, scan_wwl

        m = self.compiled
        cls_p, starts, lanes, ws, d = _wwl_compact_lanes(m, cls)
        n = len(cls)
        if scan_wwl.scan_applicable(m):
            # Scan-based engine: ONE batched DFA gather per character decides
            # every walk (die position from the arrival-state depth plane) —
            # the fast path for pure-word-char dictionaries, including
            # row-compressed (quotient) ones.  The chooser picks the fused-
            # carry kernel when applicable (``scan_wwl.FUSED_DEFAULT``).
            sc = self.dev.wwl_scan
            die_c, has_c, ms_c, me_c, mv_c = scan_wwl.scan_walks_auto(
                sc, cls_p, starts, d, cross=False)
            return self._chain_from_lanes(
                die_c, has_c, ms_c, me_c, mv_c, lanes, ws, n)
        if scan_wwl.mixed_scan_applicable(m):
            # Separator-spanning dictionaries ("New York"): scan the
            # truncated word-uniform sub-trie closure (same one-gather-per-
            # char engine), then re-run only the walks whose die char hit a
            # crossing edge on the sparse host walker — typically a handful
            # per Mi (occurrences of a mixed keyword's uniform prefix).
            # Covers row-compressed mixed dictionaries too (previously
            # host-only; WholeWordLongestMatchSet.java:47-178).
            sc = self.dev.wwl_scan_mixed
            outs = scan_wwl.scan_walks_auto(sc, cls_p, starts, d, cross=True)
            arrays = tuple(np.array(np.asarray(x)) for x in outs[:5])
            cont_idx = np.nonzero(np.asarray(outs[5])[: len(lanes)])[0]
            scan_wwl.apply_crossing_fixes(m, cls_p, d, arrays, cont_idx,
                                          lanes[cont_idx])
            return self._chain_from_lanes(*arrays, lanes, ws, n)
        tables = (
            self.dev.trie_next, self.dev.own_len, self.dev.own_val,
            self.dev.fail_len, self.dev.fail_off, self.dev.fail_val,
            self.dev.class_is_word,
        )
        if n and len(lanes) <= self._WWL_COMPACT_DENSITY * n:
            # The restart chain only consumes walks at position 0 and word
            # starts (resolve/wholeword.follow_chain), so walk just those
            # lanes; padded slots point at the PAD region (die immediately,
            # no match).  Scatter outcomes back to position-indexed arrays
            # for the (native) chain follower.
            die_c, has_c, ms_c, me_c, mv_c = scan_wwl.wwl_walks_at(
                *tables, jnp.asarray(cls_p), jnp.asarray(starts), d)
            return self._chain_from_lanes(
                die_c, has_c, ms_c, me_c, mv_c, lanes, ws, n)
        die, has, ms, me, mv = (np.asarray(a) for a in scan_wwl.wwl_walks(
            *tables, jnp.asarray(cls_p), d))
        return self._chain(die, has, ms, me, mv, ws, n)

    @staticmethod
    def _chain_from_lanes(die_c, has_c, ms_c, me_c, mv_c, lanes, ws, n):
        """Scatter compact per-lane walk outcomes back to position-indexed
        arrays for the (native) chain follower."""
        W = len(lanes)
        die = np.zeros(n, dtype=np.int32)
        has = np.zeros(n, dtype=bool)
        ms = np.zeros(n, dtype=np.int32)
        me = np.zeros(n, dtype=np.int32)
        mv = np.zeros(n, dtype=np.int32)
        die[lanes] = np.asarray(die_c)[:W]
        has[lanes] = np.asarray(has_c)[:W]
        ms[lanes] = np.asarray(ms_c)[:W]
        me[lanes] = np.asarray(me_c)[:W]
        mv[lanes] = np.asarray(mv_c)[:W]
        return WholeWordLongestMatchSet._chain(die, has, ms, me, mv, ws, n)

    @staticmethod
    def _chain(die, has, ms, me, mv, ws, n):
        trip = follow_chain(
            np.asarray(die), np.asarray(has), np.asarray(ms), np.asarray(me),
            np.asarray(mv), ws, n,
        )
        if not trip:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z.copy()
        a = np.asarray(trip, dtype=np.int64)
        return a[:, 0], a[:, 1], a[:, 2]


class WholeWordLongestMatchMap(WholeWordLongestMatchSet):
    kind = WHOLE_WORD_LONGEST
    is_map = True

    def __init__(self, keywords, values, case_sensitive=True, **kw):
        super().__init__(keywords, case_sensitive, values=values, **kw)


class _MatcherStream:
    """Push-mode façade translating value ids to user values (maps)."""

    def __init__(self, scanner, is_map: bool):
        self._scanner = scanner
        self._is_map = is_map
        self._values = scanner.m.values

    def feed(self, text: str, is_final: bool):
        trips = self._scanner.feed(text, is_final)
        if self._is_map:
            return [(s, e, self._values[v]) for s, e, v in trips]
        return [(s, e) for s, e, _ in trips]

    def state_dict(self) -> dict:
        return self._scanner.state_dict()

    def load_state_dict(self, d: dict) -> None:
        self._scanner.load_state_dict(d)


_CLASS_BY_KIND = {}


def load_matcher(path, allow_pickle: bool = False, engine: str = "auto"):
    """Load a saved matcher artifact, returning the right matcher class.

    Shortest artifacts saved by ``ShortestMatchSet.save`` bundle the
    internal AC automaton inside the one npz (round-4 format); when present
    it is restored too, reviving the fast candidates-then-resolve device
    path.  Pre-round-4 saves used a ``<path>.ac`` sidecar file, still read
    for fspath targets."""
    import os as _os

    from ahocorasick_tpu.core import artifact

    compiled, ac_compiled = artifact.load_with_ac(path, allow_pickle=allow_pickle)
    cls = _CLASS_BY_KIND[(compiled.kind, compiled.values is not None)]
    if compiled.kind == SHORTEST:
        if ac_compiled is None and (
            isinstance(path, (str, bytes)) or hasattr(path, "__fspath__")
        ):
            # Legacy sidecar (os.fsdecode: bytes paths must not mangle).
            sidecar = _os.fsdecode(_os.fspath(path)) + ".ac"
            if _os.path.exists(sidecar):
                ac_compiled = artifact.load(sidecar, allow_pickle=allow_pickle)
        if ac_compiled is not None:
            return cls.from_compiled(compiled, engine=engine,
                                     ac_compiled=ac_compiled)
    return cls.from_compiled(compiled, engine=engine)


def _register_classes():
    for cls in (
        AhoCorasickSet, AhoCorasickMap, LongestMatchSet, LongestMatchMap,
        ShortestMatchSet, ShortestMatchMap, WholeWordMatchSet,
        WholeWordMatchMap, WholeWordLongestMatchSet, WholeWordLongestMatchMap,
    ):
        _CLASS_BY_KIND[(cls.kind, cls.is_map)] = cls


def _build_cls_map(mc: CompiledMatcher, ac: CompiledMatcher):
    """Outer-charmap class -> internal-AC class remap (None when the
    charmaps coincide — the normal case; see ShortestMatchSet._ac)."""
    if np.array_equal(mc.charmap, ac.charmap):
        return None
    M = np.zeros(mc.num_classes, dtype=np.int32)
    M[mc.charmap] = ac.charmap
    return M


def _resolve_word_chars(word_chars, toggle_flags):
    """Reference constructor overloads (WholeWordMatchSet.java:16-45)."""
    if word_chars is None:
        return None  # compiler installs the default table
    if isinstance(word_chars, np.ndarray) and word_chars.dtype == bool:
        return word_chars
    if toggle_flags is not None:
        return chartables.word_chars_with_toggles(word_chars, toggle_flags)
    return chartables.word_chars_from_list(word_chars)

_register_classes()
