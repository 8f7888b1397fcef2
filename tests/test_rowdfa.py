"""Row-gather stride-2 DFA engine (v6) conformance: exact vs gold."""

import numpy as np
import pytest

import jax.numpy as jnp

from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models.matchers import (
    AhoCorasickSet,
    LongestMatchMap,
    WholeWordMatchSet,
    _DeviceTables,
)
from ahocorasick_tpu.ops import scan_batched, scan_rowdfa


def rowdfa_triples(keywords, text, chunk, case_sensitive=True, kind="ac"):
    m = compile_matcher(keywords, kind, case_sensitive)
    dev = _DeviceTables(m)
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    assert scan_rowdfa.fits(m)
    rd = dev.row_dfa
    windows = scan_rowdfa.chunk_classes2(cls, chunk, rd.halo)
    bits = scan_rowdfa.rowdfa_emit_planes(
        rd.table, jnp.asarray(windows), rd.halo, rd.state_bits, rd.num_classes, 1
    )
    return scan_batched.ac_matches_batched(m, cls, np.asarray(bits)), m


@pytest.mark.parametrize("chunk", [2, 8, 64, 512])
def test_exact_vs_gold(chunk):
    from ahocorasick_tpu.core import gold

    keywords = ["he", "she", "his", "hers", "ushers"]
    text = "ushers said heshe hishers " * 5
    (s, e, v), m = rowdfa_triples(keywords, text, chunk)
    expected = gold.gold_match(m, text)
    assert list(zip(s.tolist(), e.tolist())) == [(a, b) for a, b, _ in expected]


@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_odd_text_lengths(tail):
    """Odd-length texts exercise the padded final pair."""
    from ahocorasick_tpu.core import gold

    keywords = ["ab", "ba", "aab", "b"]
    text = ("abba" * 40)[: 157 + tail]
    (s, e, _), m = rowdfa_triples(keywords, text, 64)
    expected = gold.gold_match(m, text)
    assert list(zip(s.tolist(), e.tolist())) == [(a, b) for a, b, _ in expected]


def test_boundary_full_length_keyword():
    kw = "abcdefgh"  # d = 8
    text = "x" * 504 + kw
    (s, e, _), _ = rowdfa_triples([kw], text, 512)
    assert list(zip(s.tolist(), e.tolist())) == [(504, 512)]
    text2 = "x" * (512 - 8) + kw + "y" * 100
    (s2, e2, _), _ = rowdfa_triples([kw], text2, 512)
    assert list(zip(s2.tolist(), e2.tolist())) == [(504, 512)]


def test_odd_depth_halo_rounding():
    kw = "abcdefg"  # d = 7 -> halo rounds up to 8
    (s, e, _), _ = rowdfa_triples([kw], "x" * 509 + kw + "z" * 30, 512)
    assert list(zip(s.tolist(), e.tolist())) == [(509, 516)]


def test_count_kernel():
    keywords = ["ab", "b", "aab"]
    rng = np.random.default_rng(5)
    text = "".join(rng.choice(list("ab "), size=3001))
    m = compile_matcher(keywords, "ac", True)
    dev = _DeviceTables(m)
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    rd = dev.row_dfa
    windows = scan_rowdfa.chunk_classes2(cls, 128, rd.halo)
    total = int(scan_rowdfa.rowdfa_count(
        rd.table, jnp.asarray(windows), rd.halo, rd.state_bits, rd.num_classes))
    from ahocorasick_tpu.core import gold

    assert total == len(gold.gold_match(m, text))


def test_default_engine_is_rowdfa_and_matches_gold_fuzz():
    rng = np.random.default_rng(9)
    for trial in range(10):
        kws = ["".join(rng.choice(list("abcd"), size=int(rng.integers(1, 7))))
               for _ in range(int(rng.integers(1, 25)))]
        text = "".join(rng.choice(list("abcd "), size=int(rng.integers(0, 600))))
        dev_m = AhoCorasickSet(kws, engine="device")
        assert dev_m.device_engine == "rowdfa"
        gold_m = AhoCorasickSet(kws, engine="gold")
        assert dev_m.match(text) == gold_m.match(text), (trial, kws)


def test_longest_map_through_engine():
    m = LongestMatchMap(["he", "hers", "herself"], [1, 2, 3], engine="device")
    g = LongestMatchMap(["he", "hers", "herself"], [1, 2, 3], engine="gold")
    text = "xx herself hers he " * 30
    assert m.match(text) == g.match(text)


def test_whole_word_through_engine():
    kws = ["ab", "abc", "b"]
    dev = WholeWordMatchSet(kws, engine="device")
    gld = WholeWordMatchSet(kws, engine="gold")
    text = "ab abc xb ab. b-abc ab"
    assert dev.match(text) == gld.match(text)


def test_fits_gate_fallback():
    m = compile_matcher(["ab"], "ac", True)
    assert scan_rowdfa.fits(m)
    assert not scan_rowdfa.fits(m, max_bytes=10)
    # facade falls back to the stride-1 batched engine when gated
    acs = AhoCorasickSet(["ab", "ba"], engine="device")
    import ahocorasick_tpu.ops.scan_rowdfa as mod
    orig = mod._MAX_BYTES
    try:
        mod._MAX_BYTES = 10

        def tiny_fits(mm, max_bytes=10):
            return False

        orig_fits = mod.fits
        mod.fits = tiny_fits
        assert acs.match("abba") == [(0, 2), (2, 4)]
        mod.fits = orig_fits
    finally:
        mod._MAX_BYTES = orig


def rowdfa1_triples(keywords, text, chunk, case_sensitive=True, kind="ac"):
    m = compile_matcher(keywords, kind, case_sensitive)
    dev = _DeviceTables(m)
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    assert scan_rowdfa.fits1(m)
    rd = dev.row_dfa1
    windows = scan_batched.chunk_classes(cls, chunk, rd.halo)
    bits = scan_rowdfa.rowdfa1_emit_planes(
        rd.table, jnp.asarray(windows), rd.halo, rd.state_bits, rd.num_classes
    )
    return scan_batched.ac_matches_batched(m, cls, np.asarray(bits)), m


@pytest.mark.parametrize("chunk", [2, 8, 64, 512])
def test_rowdfa1_exact_vs_gold(chunk):
    from ahocorasick_tpu.core import gold

    keywords = ["he", "she", "his", "hers", "ushers"]
    text = "ushers said heshe hishers " * 5
    (s, e, v), m = rowdfa1_triples(keywords, text, chunk)
    expected = gold.gold_match(m, text)
    assert list(zip(s.tolist(), e.tolist())) == [(a, b) for a, b, _ in expected]


def test_rowdfa1_fuzz_vs_gold():
    from ahocorasick_tpu.core import gold

    rng = np.random.default_rng(17)
    for trial in range(8):
        kws = list({
            "".join(rng.choice(list("abc"), size=int(rng.integers(1, 9))))
            for _ in range(int(rng.integers(1, 40)))
        })
        text = "".join(rng.choice(list("abc "), size=int(rng.integers(1, 900))))
        (s, e, _), m = rowdfa1_triples(kws, text, 64)
        expected = gold.gold_match(m, text)
        assert list(zip(s.tolist(), e.tolist())) == \
            [(a, b) for a, b, _ in expected], (trial, kws)


def test_pick_engine_tiers(monkeypatch):
    import ahocorasick_tpu.ops.scan_rowdfa as mod

    # tiny dict: the stride-2 row engine (cheapest on the card)
    m = compile_matcher(["ab", "ba"], "ac", True)
    assert mod.pick_engine(m) == "rowdfa2"
    assert mod.fits1(m)
    # past the stride-2 budget: batched (rowdfa1 costs more per character)
    monkeypatch.setattr(mod, "_MAX_BYTES", 10)
    assert mod.pick_engine(m) == "batched"
    # and a wide alphabet admits neither row engine
    monkeypatch.setattr(mod, "_MAX_SELECT_CLASSES", 4)
    assert not mod.fits1(m)
    assert mod.pick_engine(m) == "batched"


def test_rowdfa1_through_facade_mid_dictionary(monkeypatch):
    """The stride-1 row engine (no longer the pick for any dictionary)
    still matches gold exactly inside the public facade when forced."""
    rng = np.random.default_rng(23)
    kws = list({
        "".join(rng.choice(list("abcdefghij"), size=int(rng.integers(3, 10))))
        for _ in range(800)
    })
    m = compile_matcher(kws, "ac", True)
    assert scan_rowdfa.fits1(m)
    monkeypatch.setattr(scan_rowdfa, "pick_engine", lambda m: "rowdfa1")
    dev_m = AhoCorasickSet(kws, engine="device")
    gold_m = AhoCorasickSet(kws, engine="gold")
    text = " ".join(rng.choice(kws, size=200)) + " qqq " + "".join(
        rng.choice(list("abcdefghij "), size=2000))
    assert dev_m.match(text) == gold_m.match(text)
    assert dev_m.count(text) == len(gold_m.match(text))


def test_rowdfa1_count_kernel():
    keywords = ["ab", "b", "aab"]
    rng = np.random.default_rng(5)
    text = "".join(rng.choice(list("ab "), size=3001))
    m = compile_matcher(keywords, "ac", True)
    dev = _DeviceTables(m)
    cls = m.charmap[np.frombuffer(text.encode("utf-16-le"), dtype=np.uint16)]
    rd = dev.row_dfa1
    windows = scan_batched.chunk_classes(cls, 128, rd.halo)
    total = int(scan_rowdfa.rowdfa1_count(
        rd.table, jnp.asarray(windows), rd.halo, rd.state_bits, rd.num_classes))
    from ahocorasick_tpu.core import gold

    assert total == len(gold.gold_match(m, text))


def test_empty_and_tiny_text():
    m = AhoCorasickSet(["ab"], engine="device")
    assert m.match("") == []
    assert m.match("a") == []
    assert m.match("ab") == [(0, 2)]
