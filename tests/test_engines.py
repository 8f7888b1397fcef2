"""Device engines vs gold model: bit-identical triples on the full battery."""

import random

import numpy as np
import pytest

import ahocorasick_tpu as act
from ahocorasick_tpu.core import gold


def random_strings(rng, count, min_len=1, max_len=8, alphabet="abcdef ghij"):
    return [
        "".join(rng.choice(alphabet) for _ in range(rng.randint(min_len, max_len)))
        for _ in range(count)
    ]


SET_CLASSES = [
    act.AhoCorasickSet,
    act.LongestMatchSet,
    act.ShortestMatchSet,
    act.WholeWordMatchSet,
    act.WholeWordLongestMatchSet,
]

MAP_CLASSES = [
    act.AhoCorasickMap,
    act.LongestMatchMap,
    act.ShortestMatchMap,
    act.WholeWordMatchMap,
    act.WholeWordLongestMatchMap,
]


def make_set(cls, keywords, case_sensitive, engine):
    return cls(keywords, case_sensitive, engine=engine)


def triples(matcher, text):
    s, e, v = matcher.match_triples(text)
    return list(zip(s.tolist(), e.tolist(), v.tolist()))


def gold_triples(matcher, text):
    return [(int(a), int(b), int(c)) for a, b, c in gold.gold_match(matcher.compiled, text)]


CASES = [
    (["a", "ab", "abc", "bc", "c"], "abcabc xabcx ccc"),
    (["he", "she", "his", "hers"], "ushers and his and hers"),
    (["aaaa", "aaa", "aa", "a"], "aaaaaaaaaa"),
    (["in", "inn", "nk"], "the innkeeper went in"),
    (["foo"], ""),
    (["go", "going", "gone"], "go going gone goner"),
]


@pytest.mark.parametrize("cs", [True, False])
@pytest.mark.parametrize("cls_idx", range(len(SET_CLASSES)))
@pytest.mark.parametrize("keywords,text", CASES)
def test_set_device_matches_gold(cls_idx, keywords, text, cs):
    cls = SET_CLASSES[cls_idx]
    if cls is act.WholeWordMatchSet:
        keywords = [k.replace(" ", "x") for k in keywords]
    m = make_set(cls, keywords, cs, "device")
    assert triples(m, text) == gold_triples(m, text)


@pytest.mark.parametrize("cls_idx", range(len(SET_CLASSES)))
def test_set_device_matches_gold_fuzz(cls_idx):
    cls = SET_CLASSES[cls_idx]
    rng = random.Random(42 + cls_idx)
    for trial in range(15):
        alphabet = rng.choice(["ab", "abc ", "abcdef -_."])
        kws = random_strings(rng, rng.randint(1, 60), 1, 6, alphabet)
        if cls is act.WholeWordMatchSet:
            kws = [k.replace(" ", "y").replace(".", "z") for k in kws]
        text = "".join(random_strings(rng, 80, 1, 6, alphabet))
        m = make_set(cls, kws, trial % 2 == 0, "device")
        assert triples(m, text) == gold_triples(m, text), (kws, text)


def test_long_keywords_multi_plane():
    # >32-length keywords exercise multiple bitplanes.
    kws = ["a" * n for n in range(1, 101)]
    text = "a" * 230 + "b" + "a" * 50
    m = act.AhoCorasickSet(kws, True, engine="device")
    assert triples(m, text) == gold_triples(m, text)


@pytest.mark.parametrize("cls_idx", range(len(MAP_CLASSES)))
def test_map_values(cls_idx):
    cls = MAP_CLASSES[cls_idx]
    kws = ["he", "she", "hers", "ab", "abc"]
    vals = [f"v{i}" for i in range(len(kws))]
    m = cls(kws, vals, True, engine="device")
    out = m.match("ushers ab abc")
    gold_out = gold.gold_match(m.compiled, "ushers ab abc")
    expect = [(s, e, m.compiled.values[v]) for s, e, v in gold_out]
    assert out == expect


def test_listener_early_stop():
    m = act.AhoCorasickSet(["a"], True, engine="gold")
    seen = []

    def listener(hay, s, e):
        seen.append((s, e))
        return len(seen) < 2

    m.match("aaaa", listener)
    assert seen == [(0, 1), (1, 2)]


def test_map_listener_gets_values():
    m = act.AhoCorasickMap(["ab"], [123], True, engine="gold")
    got = []
    m.match("xabx", lambda hay, s, e, v: got.append((s, e, v)))
    assert got == [(1, 3, 123)]


def test_set_returns_pairs():
    m = act.AhoCorasickSet(["ab"], True)
    assert m.match("xabx") == [(1, 3)]


def test_whole_word_custom_chars_device():
    wc = act.chartables.word_chars_with_toggles(["-"], [False])
    m = act.WholeWordMatchSet(["go"], True, word_chars=wc, engine="device")
    # '-' is no longer a word char, so "go-x" contains whole word "go".
    assert m.match("go-x go") == [(0, 2), (5, 7)]


def test_count_matches_len():
    m = act.LongestMatchSet(["ab", "abc"], True, engine="device")
    assert m.count("abcab") == 2


def test_ac_count_fused_device_kernel():
    """AhoCorasick count() rides the fused device count kernel (no triple
    extraction) and agrees with the gold loop across engine tiers."""
    import numpy as np

    from ahocorasick_tpu.core import gold
    from ahocorasick_tpu.models.matchers import AhoCorasickMap, AhoCorasickSet

    rng = np.random.default_rng(99)
    big_enough = "".join(rng.choice(list("hers abx"), size=1 << 15))
    cases = [
        ["he", "she", "hers"],                                # rowdfa2 tier
        ["a" * 35, "ab", "ba"],                               # count-packed tier
        list({"".join(rng.choice(list("abcdefgh"),
                                 size=int(rng.integers(3, 9))))
              for _ in range(900)}),                          # row tier
    ]
    for kws in cases:
        m = AhoCorasickSet(kws)
        got = m.count(big_enough)
        assert m.last_stats.engine == "device"
        assert got == len(gold.gold_match(m.compiled, big_enough))
    # map variant shares the path
    mm = AhoCorasickMap(["he", "she"], [1, 2])
    assert mm.count(big_enough) == AhoCorasickSet(["he", "she"],
                                                  engine="gold").count(big_enough)


def test_wwl_compact_and_full_walk_paths_agree():
    """The compacted word-start walk engine and the all-lanes engine are
    both exact; force each via the density threshold and compare to gold
    (resolve/wholeword.follow_chain consumes only word-start walks)."""
    rng = random.Random(9)
    kws = ["as", "as if", "he", "she said", "stand up", "go"]
    texts = [
        "as if by magic she said stand up as ifx go going",  # sparse starts
        "a" * 200,  # one word run
        "go go go go go " * 30,
        "  as   if  ",
    ]
    for text in texts:
        m = act.WholeWordLongestMatchSet(kws, engine="device")
        want = gold_triples(m, text)
        m._WWL_COMPACT_DENSITY = 1.1  # force compact branch
        assert triples(m, text) == want, ("compact", text[:20])
        m2 = act.WholeWordLongestMatchSet(kws, engine="device")
        m2._WWL_COMPACT_DENSITY = -1.0  # force full branch
        assert triples(m2, text) == want, ("full", text[:20])


def test_empty_text_device_engine_no_table_builds():
    """Empty input returns empty triples WITHOUT touching the device
    engines (review finding: the pfac2 fallback would densify a
    row-compressed trie on an empty feed)."""
    from ahocorasick_tpu.models.matchers import AhoCorasickSet

    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    m = AhoCorasickSet(["ab", "bc"], thresholder=_NeverDense(), engine="device")
    assert m.compiled.is_row_compressed
    s, e, v = m.match_triples("")
    assert len(s) == len(e) == len(v) == 0
    assert m.dev._cache == {}  # no device tables were built
    assert m.match("") == []


def test_from_compiled_rejects_unknown_engine():
    from ahocorasick_tpu.models.matchers import AhoCorasickSet

    m = AhoCorasickSet(["ab"])
    import pytest as _pytest

    with _pytest.raises(ValueError):
        AhoCorasickSet.from_compiled(m.compiled, engine="glod")


def test_device_table_bytes_reporting():
    """``device_table_bytes`` reports the lazily-built HBM table footprint:
    0 before any device scan, positive after, never larger than the host
    compiled form for a single packed layout, and the shortest kinds
    include their internal candidate automaton (the reference README's
    memory column analog, README.md:135,148-150)."""
    m = act.AhoCorasickSet(["he", "she", "hers"], engine="device")
    assert m.device_table_bytes() == 0
    m.count("ushers and she")
    b = m.device_table_bytes()
    assert b > 0
    m.count("ushers and she")  # warm rerun builds nothing new
    assert m.device_table_bytes() == b

    s = act.ShortestMatchSet(["he", "she", "hers"], engine="device")
    s.count("ushers and she")
    # The shortest matcher's own dev cache stays empty (its scan rides the
    # internal AC), so a positive total proves the _ac contribution counts.
    assert s.device_table_bytes() > 0
    # host_table_bytes is symmetric: it adds the internal AC's compiled
    # form, so it exceeds the outer compiled form alone.
    assert s.host_table_bytes() > s.compiled.memory_bytes()

    g = act.AhoCorasickSet(["he", "she"], engine="gold")
    g.count("ushers")
    assert g.device_table_bytes() == 0  # gold path uploads nothing
    assert g.host_table_bytes() == g.compiled.memory_bytes()
