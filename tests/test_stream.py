"""Streaming conformance: stream output == String-mode output, any chunking.

Models the reference's ``MapTest`` stream/String cross-check
(``MapTest.java:178-188``) but strengthens it per SURVEY.md §4: tiny buffer
sizes exercise chunk boundaries (the reference never did — its haystacks fit
one 4096-char buffer), positions are compared (not just counts), and the
``ShortestMatchMap`` boundary double-report quirk is pinned to the *fixed*
behavior (String mode is the spec).
"""

import io

import numpy as np
import pytest

from ahocorasick_tpu.models.matchers import (
    AhoCorasickMap,
    AhoCorasickSet,
    LongestMatchSet,
    ShortestMatchMap,
    ShortestMatchSet,
    WholeWordLongestMatchSet,
    WholeWordMatchSet,
)

SET_CLASSES = [
    AhoCorasickSet,
    LongestMatchSet,
    ShortestMatchSet,
    WholeWordMatchSet,
    WholeWordLongestMatchSet,
]

KEYWORDS = {
    AhoCorasickSet: ["he", "she", "his", "hers", "ab", "abab", "x"],
    LongestMatchSet: ["he", "she", "hers", "herself", "ab", "abab", "aba"],
    ShortestMatchSet: ["she", "he", "hers", "abab", "x"],
    WholeWordMatchSet: ["he", "she", "hers", "abab", "stand"],
    WholeWordLongestMatchSet: ["as", "as if", "as if by", "he", "she said", "stand up"],
}

TEXT = (
    "she said he stands as if by magic ababab x hers herself stand up "
    "as ifx as   if he she said stand up now abab she"
) * 3


def _word_soup(rng, n_words):
    alpha = "abchers xyif"
    out = []
    for _ in range(n_words):
        L = int(rng.integers(1, 9))
        out.append("".join(rng.choice(list(alpha), size=L)))
    return " ".join(out)


@pytest.mark.parametrize("cls_idx", range(len(SET_CLASSES)))
@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 16, 4096])
def test_stream_equals_string(cls_idx, chunk):
    cls = SET_CLASSES[cls_idx]
    m = cls(KEYWORDS[cls], engine="gold")
    expected = m.match(TEXT)
    got = m.match_stream(io.StringIO(TEXT), chunk_units=chunk)
    assert got == expected


@pytest.mark.parametrize("cls_idx", range(len(SET_CLASSES)))
def test_stream_fuzz_random_chunking(cls_idx):
    cls = SET_CLASSES[cls_idx]
    rng = np.random.default_rng(1234 + cls_idx)
    for trial in range(20):
        kws = KEYWORDS[cls]
        text = _word_soup(rng, int(rng.integers(5, 80)))
        m = cls(kws, engine="gold")
        expected = m.match(text)
        # Random irregular chunking via an iterable source.
        pieces = []
        i = 0
        while i < len(text):
            k = int(rng.integers(1, 12))
            pieces.append(text[i : i + k])
            i += k
        got = m.match_stream(pieces)
        assert got == expected, (trial, text)


def test_stream_empty():
    m = AhoCorasickSet(["a"], engine="gold")
    assert m.match_stream(io.StringIO("")) == []


def test_stream_listener_early_stop():
    m = AhoCorasickSet(["a"], engine="gold")
    seen = []

    def listener(s, e):
        seen.append((s, e))
        return len(seen) < 2

    m.match_stream(io.StringIO("aaaa"), listener, chunk_units=1)
    assert seen == [(0, 1), (1, 2)]


def test_match_readable_values_only():
    m = AhoCorasickMap(["he", "she"], ["H", "S"], engine="gold")
    got = []
    m.match_readable(io.StringIO("she heh"), lambda v: got.append(v))
    assert got == ["S", "H", "H"]


def test_match_readable_rejected_on_sets():
    m = AhoCorasickSet(["he"], engine="gold")
    with pytest.raises(TypeError):
        m.match_readable(io.StringIO("he"), lambda v: True)


def test_shortest_boundary_single_report():
    """The reference stream mode double-reports a match pending exactly at a
    buffer boundary (ShortestMatchMap.java:241-249,280-288); we report once,
    matching String mode (documented divergence, SURVEY.md §4)."""
    m = ShortestMatchMap(["ab"], [1], engine="gold")
    text = "ab" * 8
    expected = m.match(text)
    for chunk in (1, 2, 3):
        assert m.match_stream(io.StringIO(text), chunk_units=chunk) == expected


def test_stream_long_keyword_spanning_many_chunks():
    kw = "a" * 50
    m = LongestMatchSet([kw, "aa"], engine="gold")
    text = "b" + "a" * 120 + "b" + "a" * 3
    expected = m.match(text)
    got = m.match_stream(io.StringIO(text), chunk_units=7)
    assert got == expected


# --------------------------------------------------------------------------- #
# Device-engine streams: large feeds ride the batched/rowdfa engines
# with tail-halo warmup (core/stream._CandidateSource).  engine="device"
# forces the device path at ANY feed size, so tiny chunk sizes exercise the
# tail-exactness argument cheaply on the CPU mesh.
# --------------------------------------------------------------------------- #

DEVICE_STREAM_CLASSES = [AhoCorasickSet, AhoCorasickMap, LongestMatchSet,
                         ShortestMatchSet, ShortestMatchMap]


def _mk(cls, kws, engine):
    if cls.is_map:
        return cls(kws, list(range(len(kws))), engine=engine)
    return cls(kws, engine=engine)


@pytest.mark.parametrize("cls_idx", range(len(DEVICE_STREAM_CLASSES)))
@pytest.mark.parametrize("chunk", [3, 16, 600, 4096])
def test_device_stream_equals_string(cls_idx, chunk):
    cls = DEVICE_STREAM_CLASSES[cls_idx]
    kws = KEYWORDS[cls if not cls.is_map else cls.__mro__[1]]
    m = _mk(cls, kws, "device")
    gold = _mk(cls, kws, "gold")
    expected = gold.match(TEXT)
    got = m.match_stream(io.StringIO(TEXT), chunk_units=chunk)
    assert got == expected


@pytest.mark.parametrize("cls_idx", range(len(DEVICE_STREAM_CLASSES)))
def test_device_stream_fuzz_random_chunking(cls_idx):
    cls = DEVICE_STREAM_CLASSES[cls_idx]
    kws = KEYWORDS[cls if not cls.is_map else cls.__mro__[1]]
    rng = np.random.default_rng(99 + cls_idx)
    m = _mk(cls, kws, "device")
    gold = _mk(cls, kws, "gold")
    for trial in range(8):
        text = _word_soup(rng, int(rng.integers(40, 200)))
        expected = gold.match(text)
        pieces = []
        i = 0
        while i < len(text):
            k = int(rng.integers(1, 700))
            pieces.append(text[i : i + k])
            i += k
        got = m.match_stream(pieces)
        assert got == expected, (trial, text[:80])


def test_device_stream_resume_mid_stream():
    """state_dict/load_state_dict round-trips across device-engine cursors."""
    kws = KEYWORDS[ShortestMatchSet]
    for cls in (AhoCorasickSet, LongestMatchSet, ShortestMatchSet):
        m = _mk(cls, kws, "device")
        text = TEXT + " " + TEXT
        cut = len(text) // 2
        expected = m.match_stream(io.StringIO(text), chunk_units=97)
        s1 = m.stream(chunk_units=97)
        got = s1.feed(text[:cut], is_final=False)
        import json

        state = json.loads(json.dumps(s1.state_dict()))
        s2 = m.stream()
        s2.load_state_dict(state)
        got += s2.feed(text[cut:], is_final=True)
        assert got == expected, cls.__name__


def test_legacy_state_dict_resumes_exactly():
    """Pre-round-3 resume points ({\"state\", \"off\"}) still load: the
    cursor runs the state-carry scan until the tail is determined, then
    converges to the engine path — output identical either way."""
    from ahocorasick_tpu.core import gold

    text = TEXT + " " + TEXT
    cut = 40
    for cls in (AhoCorasickSet, LongestMatchSet):
        kws = KEYWORDS[cls]
        m = cls(kws, engine="device")
        expected = m.match_stream(io.StringIO(text), chunk_units=13)

        s1 = m.stream()
        got = s1.feed(text[:cut], is_final=False)
        # Forge the legacy format from the true DFA state at the cut.
        comp = m.compiled
        state = 0
        for u in m._classes(text[:cut]):
            state = int(comp.dfa_next[state, u])
        legacy = {"state": state, "off": cut}
        if cls is LongestMatchSet:
            legacy["queue"] = s1.state_dict()["queue"]
        s2 = m.stream()
        s2.load_state_dict(legacy)
        for i in range(cut, len(text), 13):
            got += s2.feed(text[i : i + 13], is_final=i + 13 >= len(text))
        assert got == expected, cls.__name__


def test_shortest_small_stream_skips_second_compile():
    m = ShortestMatchSet(["she", "he", "hers"])
    assert m._ac_cache is None
    got = m.match_stream(io.StringIO("ushers and he"), chunk_units=4)
    assert m._ac_cache is None  # small feeds never resolve the supplier
    gold_m = ShortestMatchSet(["she", "he", "hers"], engine="gold")
    assert got == gold_m.match("ushers and he")


def test_shortest_seq_to_candidates_upgrade_mid_stream():
    """A stream whose later feeds cross the device threshold upgrades the
    cursor exactly (p + tail carry across the mode switch)."""
    import numpy as np

    rng = np.random.default_rng(3)
    kws = KEYWORDS[ShortestMatchSet]
    m = ShortestMatchSet(kws, engine="auto")
    text_small = _word_soup(rng, 30)
    text_big = _word_soup(rng, 12000)
    text = text_small + " " + text_big
    gold_m = ShortestMatchSet(kws, engine="gold")
    expected = gold_m.match(text)
    s = m.stream()
    got = s.feed(text_small + " ", is_final=False)
    assert m._ac_cache is None  # still SEQ mode
    got += s.feed(text_big, is_final=True)
    from ahocorasick_tpu.core.stream import _STREAM_DEVICE_MIN

    if len(text_big) >= _STREAM_DEVICE_MIN:
        assert m._ac_cache is not None  # upgraded
    assert got == expected


def test_device_stream_hotstate_long_keywords():
    """Streams over a huge-dict-layout matcher (packed-inline overflow)
    ride the hotstate plane engine per feed; conformance vs gold."""
    from ahocorasick_tpu.ops import scan_batched

    kws = ["a" * i for i in range(1, 70)] + ["ab", "ba"]
    m = AhoCorasickSet(kws, engine="device")
    assert scan_batched.hotstate_layout(m.compiled)
    gold = AhoCorasickSet(kws, engine="gold")
    rng = np.random.default_rng(11)
    text = "".join(rng.choice(list("aab"), size=5000))
    expected = gold.match(text)
    for chunk in (64, 700, 4096):
        got = m.match_stream(io.StringIO(text), chunk_units=chunk)
        assert got == expected, chunk


def test_stream_non_bmp_surrogate_pairs():
    """Astral keywords match per UTF-16 unit (Java String model) through
    streams at any chunking — including cuts INSIDE a surrogate pair's
    unit stream (feeds are strs, so cuts land between code points, but
    positions count units)."""
    kw = "a😀b"  # 4 UTF-16 units
    m = AhoCorasickSet([kw, "😀"], engine="device")
    text = "x😀 a😀b yes a😀bz"
    expected = m.match(text)
    assert expected  # sanity: units-based positions exist
    for chunk in (1, 2, 3, 5):
        got = m.match_stream(io.StringIO(text), chunk_units=chunk)
        assert got == expected, chunk


def test_wwl_separator_keyword_matches_at_stream_start():
    """A keyword of pure non-word chars (survives trim unchanged, the Java
    quirk) must match at position 0 through streams: the reference's
    INITIAL walk starts at 0 regardless of wordness; only restarts skip to
    word starts (WholeWordLongestMatchSet.java:91-99).  Found by
    tools/soak.py."""
    m = WholeWordLongestMatchSet([" ", "-"], engine="gold")
    assert m.match(" ") == [(0, 1)]
    for chunk in (1, 2, 4):
        assert m.match_stream(io.StringIO(" "), chunk_units=chunk) == [(0, 1)]
    m2 = WholeWordLongestMatchSet(["- a", "a"], engine="gold")
    t = "- a - a-"
    want = m2.match(t)
    for chunk in (1, 2, 3, 7):
        assert m2.match_stream(io.StringIO(t), chunk_units=chunk) == want


@pytest.mark.parametrize("chunk", [3, 16, 600, 4096])
def test_device_stream_whole_word(chunk):
    """Plain whole-word streams ride the batch engines (AC candidates +
    boundary filter with end-of-feed holdback) — conformance vs gold."""
    from ahocorasick_tpu.models.matchers import WholeWordMatchMap

    kws = KEYWORDS[WholeWordMatchSet]
    m = WholeWordMatchSet(kws, engine="device")
    gold = WholeWordMatchSet(kws, engine="gold")
    expected = gold.match(TEXT)
    assert m.match_stream(io.StringIO(TEXT), chunk_units=chunk) == expected
    mm = WholeWordMatchMap(kws, list(range(len(kws))), engine="device")
    got = mm.match_stream(io.StringIO(TEXT), chunk_units=chunk)
    assert [(s, e) for s, e, _ in got] == expected


def test_whole_word_stream_boundary_holdback_and_resume():
    """A match ending exactly at a feed boundary is held until its right
    boundary is known, and survives a state_dict round-trip."""
    import json

    m = WholeWordMatchSet(["he", "hers"], engine="device")
    s1 = m.stream()
    assert s1.feed("x he", is_final=False) == []  # 'he' pending (right edge)
    d = json.loads(json.dumps(s1.state_dict()))
    s2 = m.stream()
    s2.load_state_dict(d)
    assert s2.feed(" x", is_final=True) == [(2, 4)]
    s3 = m.stream()
    s3.load_state_dict(d)
    assert s3.feed("rs x", is_final=True) == [(2, 6)]  # it was "hers"
    s4 = m.stream()
    s4.load_state_dict(d)
    assert s4.feed("", is_final=True) == [(2, 4)]  # text ends: boundary ok


def test_whole_word_stream_fuzz_vs_gold():
    rng = np.random.default_rng(31)
    kws = ["he", "she", "hers", "abab", "stand", "x"]
    m = WholeWordMatchSet(kws, engine="device")
    gold = WholeWordMatchSet(kws, engine="gold")
    for trial in range(10):
        text = _word_soup(rng, int(rng.integers(30, 250)))
        expected = gold.match(text)
        pieces = []
        i = 0
        while i < len(text):
            k = int(rng.integers(1, 500))
            pieces.append(text[i : i + k])
            i += k
        assert m.match_stream(pieces) == expected, trial


@pytest.mark.parametrize("chunk", [3, 16, 600, 4096])
def test_device_stream_whole_word_longest(chunk):
    """WWL streams ride the device compact-walk engine with the host
    restart chain; undecided walks at feed edges replay exactly."""
    kws = KEYWORDS[WholeWordLongestMatchSet]
    m = WholeWordLongestMatchSet(kws, engine="device")
    gold = WholeWordLongestMatchSet(kws, engine="gold")
    from ahocorasick_tpu.core.stream import _WwlCursor

    assert isinstance(m._stream_scanner(None).cursor, _WwlCursor)
    expected = gold.match(TEXT)
    assert m.match_stream(io.StringIO(TEXT), chunk_units=chunk) == expected


def test_device_stream_wwl_fuzz_and_separators():
    rng = np.random.default_rng(61)
    kws = KEYWORDS[WholeWordLongestMatchSet] + ["- x", " "]
    m = WholeWordLongestMatchSet(kws, engine="device")
    gold = WholeWordLongestMatchSet(kws, engine="gold")
    for trial in range(8):
        text = _word_soup(rng, int(rng.integers(20, 200)))
        expected = gold.match(text)
        pieces = []
        i = 0
        while i < len(text):
            k = int(rng.integers(1, 300))
            pieces.append(text[i : i + k])
            i += k
        assert m.match_stream(pieces) == expected, trial
    # Separator-leading keywords at stream start (initial-walk rule).
    m2 = WholeWordLongestMatchSet([" ", "-"], engine="device")
    g2 = WholeWordLongestMatchSet([" ", "-"], engine="gold")
    for chunk in (1, 3):
        assert (m2.match_stream(io.StringIO(" -x "), chunk_units=chunk)
                == g2.match(" -x "))


def test_device_stream_wwl_resume():
    import json

    kws = KEYWORDS[WholeWordLongestMatchSet]
    m = WholeWordLongestMatchSet(kws, engine="device")
    text = TEXT + " " + TEXT
    cut = len(text) // 3
    expected = m.match_stream(io.StringIO(text), chunk_units=89)
    s1 = m.stream(chunk_units=89)
    got = s1.feed(text[:cut], is_final=False)
    d = json.loads(json.dumps(s1.state_dict()))
    s2 = m.stream()
    s2.load_state_dict(d)
    got += s2.feed(text[cut:], is_final=True)
    assert got == expected


def test_cross_cursor_resume_formats():
    """Whole-word resume points cross-load between the device cursors and
    the host tail-replay cursor (both directions), including a pending
    boundary match."""
    import json

    from ahocorasick_tpu.core.stream import StreamScanner

    for cls in (WholeWordMatchSet, WholeWordLongestMatchSet):
        kws = KEYWORDS[cls]
        m = cls(kws, engine="device")  # device cursors
        text = TEXT
        cut = 37
        expected = [(s_, e_) for s_, e_ in m.match_stream(
            io.StringIO(text), chunk_units=53)]

        def pairs(trips):
            return [(a, b) for a, b, _ in trips]

        s1 = StreamScanner(m.compiled, dev=m.dev, engine="device")
        got = pairs(s1.feed(text[:cut], is_final=False))
        d = json.loads(json.dumps(s1.state_dict()))
        # Load into the HOST cursor (dev=None -> _WordCursor).
        host = StreamScanner(m.compiled)
        host.load_state_dict(d)
        got_host = got + pairs(host.feed(text[cut:], is_final=True))
        assert got_host == expected, (cls.__name__, "device->host")
        # And host dict into the device cursor.
        h1 = StreamScanner(m.compiled)
        got2 = pairs(h1.feed(text[:cut], is_final=False))
        d2 = json.loads(json.dumps(h1.state_dict()))
        s2 = StreamScanner(m.compiled, dev=m.dev, engine="device")
        s2.load_state_dict(d2)
        got2 += pairs(s2.feed(text[cut:], is_final=True))
        assert got2 == expected, (cls.__name__, "host->device")


def test_wwl_stream_midbuffer_index_zero_not_word_start():
    """Soak-found: a mid-stream buffer whose first tail unit is a word char
    must NOT treat local index 0 as a word start (its predecessor lives
    outside the buffer) — the device cursor previously walked it and
    emitted a phantom mid-word match."""
    m = WholeWordLongestMatchSet(["中"], engine="device")
    g = WholeWordLongestMatchSet(["中"], engine="gold")
    text = " a 中  中中中 中中 "
    want = g.match(text)
    for chunk in (1, 2, 3, 5):
        assert m.match_stream(io.StringIO(text), chunk_units=chunk) == want


def test_shortest_legacy_resume_not_laundered_by_resave():
    """A pre-round-3 {state, off} resume point has no trusted restart
    cursor p; re-saving the cursor before any match finalizes must NOT
    launder p=0 into a trusted value (which would un-pin the SEQ mode and
    let the CAND upgrade emit overlapping matches).  p reappears in
    state_dict only after a real accepted end refreshes it."""
    from ahocorasick_tpu.models.matchers import ShortestMatchSet

    m = ShortestMatchSet(["abcd", "bc"])
    s1 = m.stream()
    s1.load_state_dict({"state": 0, "off": 100})
    d1 = s1.state_dict()
    assert "p" not in d1  # unknown cursor stays unknown
    # Feeding a match-free chunk still must not invent p.
    s1.feed("xxxx", is_final=False)
    assert "p" not in s1.state_dict()
    # After a real match finalizes, p is trusted again.
    trips = s1.feed("xabcdx", is_final=False)
    assert trips
    d2 = s1.state_dict()
    assert "p" in d2 and d2["p"] == trips[-1][1]


def test_seqscan_jit_cached_across_cursor_instances():
    """The sequential lax.scan runner is cached by table identity: fresh
    cursors per call (row-compressed gold path, sharded shortest fallback)
    must not re-trace/re-compile per call (review finding, round 4)."""
    from ahocorasick_tpu.core import stream as stream_mod
    from ahocorasick_tpu.models.matchers import AhoCorasickSet

    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    m = AhoCorasickSet(["ab", "bc"], thresholder=_NeverDense())
    assert m.compiled.is_row_compressed
    m.match_triples("abcabc")
    run1 = stream_mod._seqscan_jit(m.compiled.dfa_next)
    m.match_triples("bcbcbc")
    run2 = stream_mod._seqscan_jit(m.compiled.dfa_next)
    assert run1 is run2


def test_restart_table_memoized_across_cursors():
    """The shortest restart-baked table is memoized per matcher: a fresh
    table per cursor would defeat the sequential-scan jit cache at every
    fresh-cursor call site (row-compressed shortest match_triples builds a
    cursor per call — review finding r5)."""
    from ahocorasick_tpu.core.stream import _ShortestCursor
    from ahocorasick_tpu.models.matchers import ShortestMatchSet

    m = ShortestMatchSet(["she", "he"], engine="gold").compiled
    t1 = _ShortestCursor._restart_table(m)
    t2 = _ShortestCursor._restart_table(m)
    assert t1 is t2
