"""Scan-based whole-word-longest engine (ops/scan_wwl.wwl_scan_walks).

Conformance of the one-gather-per-character WWL walk engine against the
gold loop (``WholeWordLongestMatchSet.java:47-178`` semantics), across
dense / row-compressed (quotient) layouts, the row/flat table layouts, the
Java trim-quirk all-separator keywords, and applicability gating for
mixed-wordness keywords.
"""

import random

import numpy as np
import pytest

from ahocorasick_tpu.core import gold
from ahocorasick_tpu.models.matchers import (
    WholeWordLongestMatchMap,
    WholeWordLongestMatchSet,
)
from ahocorasick_tpu.ops import scan_wwl
from ahocorasick_tpu.utils import chartables


def _collect(m, text):
    out = []
    m.match(text, lambda t, s, e, *v: (out.append((s, e)), True)[1])
    return out


def _gold_pairs(m, text):
    return [(a, b) for a, b, _ in gold.gold_whole_word_longest(m.compiled, text)]


def test_applicability_gates():
    pure = WholeWordLongestMatchSet(["abc", "de"])
    assert scan_wwl.scan_applicable(pure.compiled)
    # Java WordCharacters.trim quirk: all-separator keywords survive and are
    # word-uniform, so the scan engine still applies.
    quirk = WholeWordLongestMatchSet([" ", "!!", "abc"])
    assert scan_wwl.scan_applicable(quirk.compiled)
    # Keywords mixing word and separator chars break the depth argument.
    mixed = WholeWordLongestMatchSet(["new york", "boston"])
    assert not scan_wwl.scan_applicable(mixed.compiled)
    # Other kinds never apply.
    from ahocorasick_tpu.models.matchers import AhoCorasickSet

    assert not scan_wwl.scan_applicable(AhoCorasickSet(["abc"]).compiled)
    # Pre-round-4 artifacts carry no goto-closure DFA: falls back.
    import dataclasses

    legacy = dataclasses.replace(pure.compiled, dfa_next=None, fail=None)
    assert not scan_wwl.scan_applicable(legacy)


def test_scan_engine_dense_fuzz():
    for trial in range(150):
        rng = random.Random(trial)
        kws = list({
            "".join(rng.choice("abcehlprsx") for _ in range(rng.randint(1, 6)))
            for _ in range(rng.randint(1, 12))
        })
        m = WholeWordLongestMatchSet(kws, engine="device")
        assert scan_wwl.scan_applicable(m.compiled)
        t = "".join(rng.choice("abche lprs,;x") for _ in range(rng.randint(0, 200)))
        assert _collect(m, t) == _gold_pairs(m, t), (trial, kws, t)


def test_scan_engine_separator_quirk_fuzz():
    pool = ["a", "b", "ab", "ba", "aab", " ", ",,", "!", "!!", "bab", "aa"]
    for trial in range(150):
        rng = random.Random(1000 + trial)
        kws = list({rng.choice(pool) for _ in range(rng.randint(1, 8))})
        m = WholeWordLongestMatchSet(kws, engine="device")
        assert scan_wwl.scan_applicable(m.compiled)
        t = "".join(rng.choice("ab ,!") for _ in range(rng.randint(0, 120)))
        assert _collect(m, t) == _gold_pairs(m, t), (trial, kws, t)


def test_scan_engine_quotient_fullnode():
    # Wide-alphabet row-compressed WWL: the quotient DFA path (the round-3
    # gap — row-compressed WWL had no device path at all).
    kws = [chr(c) for c in range(32, 0xD800)]
    m = WholeWordLongestMatchSet(kws, engine="device")
    assert m.compiled.is_row_compressed
    assert scan_wwl.scan_applicable(m.compiled)
    sc = scan_wwl.build_wwl_scan(m.compiled)
    assert sc.quotient and not sc.row_layout  # flat-gather quotient layout
    rng = np.random.default_rng(7)
    t = "".join(chr(int(x)) for x in rng.integers(32, 0xD800, size=20000))
    s, e, v = m._device_triples(m._classes(t))
    assert list(zip(s.tolist(), e.tolist())) == _gold_pairs(m, t)


def test_scan_engine_quotient_multichar():
    # Row-compressed with multi-char keywords (forced via the Thresholder
    # SPI, the reference's node-storage policy hook).
    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    kws = [chr(c) + chr(c + 1) for c in range(0x3000, 0xA000, 3)]
    m = WholeWordLongestMatchSet(kws, thresholder=_NeverDense())
    assert m.compiled.is_row_compressed
    assert scan_wwl.scan_applicable(m.compiled)
    rng = np.random.default_rng(11)
    t = "".join(chr(int(x)) for x in rng.integers(0x3000, 0xA000, size=8000))
    s, e, v = m._device_triples(m._classes(t))
    assert list(zip(s.tolist(), e.tolist())) == _gold_pairs(m, t)


def test_scan_engine_flat_layout(monkeypatch):
    # Force the flat-gather (non-row) table layout on a dense dictionary.
    monkeypatch.setattr(scan_wwl, "_ROW_MAX_CLASSES", 0)
    rng = random.Random(5)
    kws = list({
        "".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 7)))
        for _ in range(200)
    })
    m = WholeWordLongestMatchSet(kws, engine="device")
    sc = scan_wwl.build_wwl_scan(m.compiled)
    assert not sc.row_layout
    # bypass the matcher's cached dev tables so the patched layout is used
    m.dev._cache.pop("wwl_scan", None)
    t = "".join(rng.choice("abcdefgh ,.") for _ in range(3000))
    assert _collect(m, t) == _gold_pairs(m, t)


def test_scan_engine_map_values_and_folding():
    m = WholeWordLongestMatchMap(
        ["Hello", "WORLD", "hell"], ["a", "b", "c"],
        case_sensitive=False, engine="device",
    )
    assert scan_wwl.scan_applicable(m.compiled)
    txt = "hello world HELL hello;hell"
    got = []
    m.match(txt, lambda t, s, e, v: (got.append((s, e, v)), True)[1])
    exp = [
        (a, b, m.compiled.values[c])
        for a, b, c in gold.gold_whole_word_longest(m.compiled, txt)
    ]
    assert got == exp


def test_scan_engine_custom_word_chars():
    wc = chartables.default_word_chars().copy()
    wc[ord("'")] = True
    m = WholeWordLongestMatchSet(
        ["can't", "naive", "übermäßig"], word_chars=wc, engine="device")
    assert scan_wwl.scan_applicable(m.compiled)
    txt = " can't naive übermäßig can'tx naive's"
    assert _collect(m, txt) == _gold_pairs(m, txt)


def test_word_uniform_trie_cases():
    assert scan_wwl.word_uniform_trie(
        WholeWordLongestMatchSet(["ab", "cd", " ", "!!"]).compiled)
    assert not scan_wwl.word_uniform_trie(
        WholeWordLongestMatchSet(["a b"]).compiled)
    # Mixed all-separator-then-word interior shape: "!a" trims to "a" (pure);
    # "a!a" keeps an interior separator (impure).
    assert scan_wwl.word_uniform_trie(
        WholeWordLongestMatchSet(["!a"]).compiled)
    assert not scan_wwl.word_uniform_trie(
        WholeWordLongestMatchSet(["a!a"]).compiled)


def test_scan_engine_non_bmp_units():
    """Non-BMP chars are matched per UTF-16 unit (Java parity): the scan
    engine's depth plane counts units, and surrogate wordness follows the
    word table exactly like the gold walk."""
    kws = ["\U0001F600ab", "ab", "\U0001D400"]  # emoji+letters, math bold A
    m = WholeWordLongestMatchSet(kws)
    for t in ["\U0001F600ab ab \U0001D400", "x\U0001F600ab", "\U0001D400\U0001D400",
              " \U0001F600ab!"]:
        got = _collect(m, t)
        assert got == _gold_pairs(m, t), t


# --------------------------------------------------------------------------- #
# Round 5: separator-spanning (mixed-wordness) dictionaries on the scan
# engine — truncated word-uniform-subtrie closure + crossing bit + sparse
# full-trie continuations (scan_wwl.build_wwl_scan_mixed / host_walks_at).
# --------------------------------------------------------------------------- #


def test_mixed_applicability_gates():
    mixed = WholeWordLongestMatchSet(["new york", "boston"])
    assert not scan_wwl.scan_applicable(mixed.compiled)
    assert scan_wwl.mixed_scan_applicable(mixed.compiled)
    # Uniform dictionaries ride the pure engine, not the truncated build.
    pure = WholeWordLongestMatchSet(["abc", "de"])
    assert not scan_wwl.mixed_scan_applicable(pure.compiled)
    # A closure-less artifact of a UNIFORM dictionary is recoverable via the
    # truncated build (it reconstructs the full closure, no crossings).
    import dataclasses

    legacy = dataclasses.replace(pure.compiled, dfa_next=None, fail=None)
    assert scan_wwl.mixed_scan_applicable(legacy)
    sc = scan_wwl.build_wwl_scan_mixed(legacy)
    assert sc.has_cross


def test_mixed_scan_engine_fuzz():
    """Dense mixed dictionaries vs gold: crossing continuations, trim
    interactions, keywords sharing uniform prefixes with pure keywords."""
    pool = ["new york", "new", "york", "n y", "a b", "ab", "b", "yo",
            "new yorker", "a", "aa b", " ", "!!"]
    for trial in range(120):
        rng = random.Random(9000 + trial)
        kws = list({rng.choice(pool) for _ in range(rng.randint(1, 8))})
        m = WholeWordLongestMatchSet(kws, engine="device")
        if not scan_wwl.scan_applicable(m.compiled):
            assert scan_wwl.mixed_scan_applicable(m.compiled)
        t = "".join(rng.choice(["new", "york", " ", "a", "b", "!", "y", "n "])
                    for _ in range(rng.randint(0, 300)))
        assert _collect(m, t) == _gold_pairs(m, t), (trial, kws, t)


def test_mixed_scan_engine_map_values():
    m = WholeWordLongestMatchMap(["new york", "new", "a b"], [10, 20, 30],
                                 case_sensitive=False, engine="device")
    assert scan_wwl.mixed_scan_applicable(m.compiled)
    t = "New York beats new, then a b."
    got = m.match(t)
    want = gold.gold_whole_word_longest(m.compiled, t)
    assert got == [(s, e, [10, 20, 30][v]) for s, e, v in want]
    assert (t[got[0][0]:got[0][1]]) == "New York"


def test_mixed_scan_engine_quotient():
    """Row-compressed mixed dictionaries previously had NO device engine at
    all (models/matchers.py r4: host path); the truncated quotient closure
    now scans them (WholeWordLongestMatchSet.java:47-178 at any width)."""

    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    kws = [chr(c) for c in range(97, 123)] + ["a b", "new york", "ab"]
    m = WholeWordLongestMatchSet(kws, thresholder=_NeverDense(),
                                 engine="device")
    assert m.compiled.is_row_compressed
    assert scan_wwl.mixed_scan_applicable(m.compiled)
    for trial in range(25):
        rng = random.Random(700 + trial)
        t = "".join(rng.choice(["new", " york", " ", "a", "b", "!"])
                    for _ in range(rng.randint(0, 400)))
        assert _collect(m, t) == _gold_pairs(m, t), (trial, t)


def test_mixed_scan_stream_chunked():
    """Streaming cursor rides the mixed scan engine: random chunkings equal
    the batch output at global offsets (stream carry invariant)."""
    from ahocorasick_tpu.core.stream import make_cursor

    m = WholeWordLongestMatchSet(
        ["new york", "new", "york", "a b", "ab"], case_sensitive=False,
        engine="device")
    for trial in range(20):
        rng = random.Random(4400 + trial)
        t = "".join(rng.choice(["new", "york", " ", "a", "b ", "!x"])
                    for _ in range(rng.randint(0, 400)))
        want = _gold_pairs(m, t)
        cur = make_cursor(m.compiled, dev=m.dev, engine="device")
        got = []
        i = 0
        while i < len(t):
            j = min(len(t), i + rng.randint(1, 120))
            got += cur.feed(m._classes(t[i:j]), is_final=(j == len(t)))
            i = j
        if len(t) == 0:
            got += cur.feed(m._classes(""), is_final=True)
        assert [(a, b) for a, b, _ in got] == want, (trial, t)


def test_host_walks_at_matches_walk_engine():
    """The sparse host continuation walker equals the device walk engine
    (full trie) on arbitrary starts."""
    import jax.numpy as jnp

    m = WholeWordLongestMatchSet(["new york", "new", "a b", "ab"],
                                 engine="device")
    rng = random.Random(3)
    t = "".join(rng.choice(["new", " york", "a", " b", "!"])
                for _ in range(300))
    cls = m._classes(t)
    cls_p, starts, lanes, ws, d = scan_wwl.compact_lanes(m.compiled, cls)
    dev = m.dev
    die, has, ms, me, mv = (np.asarray(x) for x in scan_wwl.wwl_walks_at(
        dev.trie_next, dev.own_len, dev.own_val, dev.fail_len, dev.fail_off,
        dev.fail_val, dev.class_is_word, jnp.asarray(cls_p),
        jnp.asarray(starts), d))
    W = len(lanes)
    hdie, hhas, hms, hme, hmv = scan_wwl.host_walks_at(m.compiled, cls_p,
                                                       lanes, d)
    np.testing.assert_array_equal(die[:W], hdie)
    np.testing.assert_array_equal(has[:W], hhas)
    np.testing.assert_array_equal(me[:W][hhas], hme[hhas])
    np.testing.assert_array_equal(ms[:W][hhas], hms[hhas])
    np.testing.assert_array_equal(mv[:W][hhas], hmv[hhas])


def test_fused_kernel_equals_sweep():
    """The fused die-sweep-in-carry kernel (``scan_wwl.FUSED_DEFAULT``
    chooses between it and the sweep; PERF.md) must stay output-identical
    to the sweep kernel, pure and mixed."""
    import jax.numpy as jnp

    from ahocorasick_tpu.ops import scan_batched

    cases = [
        (["a" * i for i in range(1, 30)] + ["abc", "bca"], "abc !", False),
        (["new york", "new", "york", "a b", "ab"], None, True),
    ]
    for kws, alpha, mixed in cases:
        m = WholeWordLongestMatchSet(kws, engine="device")
        if mixed:
            sc = scan_wwl.build_wwl_scan_mixed(m.compiled)
        else:
            sc = scan_wwl.build_wwl_scan(m.compiled)
        rng = random.Random(8)
        if alpha is None:
            t = "".join(rng.choice(["new", "york", " ", "a", "b", "!"])
                        for _ in range(2000))
        else:
            t = "".join(rng.choice(alpha) for _ in range(4000))
        cls = m._classes(t)
        cls_p, starts, lanes, ws, d = scan_wwl.compact_lanes(m.compiled, cls)
        assert scan_wwl.fused_applicable(sc, d)
        w1 = scan_batched.chunk_classes(cls_p, 512, d, sc.num_classes)
        o1 = scan_wwl.wwl_scan_walks(
            sc.table, sc.rows_flat, sc.outrows, jnp.asarray(w1),
            jnp.asarray(starts), halo=d, id_bits=sc.id_bits,
            depth_bits=sc.depth_bits, num_classes=sc.num_classes, d=d,
            row_layout=sc.row_layout, quotient=sc.quotient, cross=mixed)
        w2 = scan_wwl.chunk_classes_overlap(cls_p, 512, d, d + 1,
                                            sc.num_classes)
        o2 = scan_wwl.wwl_scan_walks_fused(
            sc.table, sc.outrows, jnp.asarray(w2), jnp.asarray(starts),
            halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
            num_classes=sc.num_classes, d=d, row_layout=sc.row_layout,
            cross=mixed)
        W = len(lanes)
        for a, b in zip(o1, o2):
            np.testing.assert_array_equal(np.asarray(a)[:W],
                                          np.asarray(b)[:W])


def test_truncated_closure_dense_equals_consing():
    """The vectorized dense truncated-closure build (production for dense
    mixed dictionaries) equals the hash-consing builder (the oracle, kept
    for the quotient path) at every uniform state."""
    pool = ["new york", "new", "york", "n y", "a b", "ab", "b", "yo", "a",
            "aa bb", "bb", " ", "!!", "x y z", "x"]
    for trial in range(40):
        rng = random.Random(41000 + trial)
        kws = list({rng.choice(pool) for _ in range(rng.randint(1, 9))})
        m = WholeWordLongestMatchSet(kws)
        if not scan_wwl.mixed_scan_applicable(m.compiled):
            continue
        rows, cross, row_id, uni1 = scan_wwl._truncated_closure(m.compiled)
        dfa2, cross2, uni2 = scan_wwl._truncated_closure_dense(m.compiled)
        np.testing.assert_array_equal(uni1, uni2)
        u = np.nonzero(uni1)[0]
        np.testing.assert_array_equal(rows[row_id][u], dfa2[u],
                                      err_msg=str((trial, kws)))
        np.testing.assert_array_equal(cross[row_id][u], cross2[u],
                                      err_msg=str((trial, kws)))
