"""Full-alphabet / wide-alphabet dictionaries (reference testFullNode).

The reference's ``SetTest.testFullNode`` (SetTest.java:73-79) builds a
matcher over every single-char keyword — 64Ki keywords — exercising dense
full-range RangeNodes.  Here the same dictionary would need two 16 GB dense
S x A tables; the compiler's hash-consed ``RowTable`` representation keeps
it at a few MB (the automaton has only a handful of distinct transition
rows), and device matching runs on the packed QUOTIENT DFA over those rows
(``ops/scan_batched.build_packed``).
"""

import numpy as np
import pytest

from ahocorasick_tpu import (
    AhoCorasickMap,
    AhoCorasickSet,
    LongestMatchSet,
    ShortestMatchSet,
    load_matcher,
)
from ahocorasick_tpu.core.compiler import RowTable, compile_matcher

# Every BMP unit except surrogates (Python str cannot carry lone surrogates).
FULL_KWS = [chr(c) for c in range(0, 0xD800)] + [chr(c) for c in range(0xE000, 0x10000)]


def _text(n=3000):
    return "".join(chr((i * 2654435761) % 53000 + 32) for i in range(n))


@pytest.fixture(scope="module")
def full_set():
    return AhoCorasickSet(FULL_KWS)


def test_full_node_compiles_compact(full_set):
    c = full_set.compiled
    assert c.num_states == len(FULL_KWS) + 1
    assert c.num_classes == len(FULL_KWS) + 1
    assert c.is_row_compressed
    assert isinstance(c.dfa_next, RowTable)
    # Two distinct goto-closure rows: the root's, shared by every depth-1
    # state (no own edges, fail = root).
    assert len(c.dfa_next.rows) <= 2
    assert c.memory_bytes() < 32 << 20  # vs ~32 GB dense

def test_full_node_matches_every_position(full_set):
    text = _text()
    res = full_set.match(text)
    assert res == [(i, i + 1) for i in range(len(text))]


def test_full_node_map_values():
    m = AhoCorasickMap(FULL_KWS, [ord(k) for k in FULL_KWS])
    text = _text(500)
    assert m.match(text) == [(i, i + 1, ord(ch)) for i, ch in enumerate(text)]


def test_full_node_longest_kind():
    # Wide alphabet + multi-char keywords through the leftmost-longest kind.
    kws = FULL_KWS[:40000] + ["ab", "abc"]
    m = LongestMatchSet(kws)
    assert m.compiled.is_row_compressed
    out = m.match("abcab" + chr(1000))
    assert out == [(0, 3), (3, 5), (5, 6)]


def test_row_compressed_match_equals_gold_loop():
    # The facade routes row-compressed matchers through the vectorized
    # cursor; pin it against the per-char gold loop on overlapping emits.
    from ahocorasick_tpu.core import gold

    kws = FULL_KWS[:45000] + ["ab", "abc", "bc", chr(40000) + "a"]
    m = AhoCorasickSet(kws)
    assert m.compiled.is_row_compressed
    text = "abcabc" + chr(40000) + "abc" + chr(50000)
    got = m.match_triples(text)
    want = gold.gold_match(m.compiled, text)
    assert list(zip(*[a.tolist() for a in got])) == [tuple(t) for t in want]


def test_full_node_streaming(full_set):
    text = _text(400)
    got = []
    full_set.match_stream(iter([text[:123], text[123:]]),
                          lambda s, e: got.append((s, e)))
    assert got == full_set.match(text)


def test_full_node_artifact_roundtrip(tmp_path, full_set):
    p = tmp_path / "full.npz"
    full_set.save(p)
    m2 = load_matcher(p)
    assert m2.compiled.is_row_compressed
    text = _text(300)
    assert m2.match(text) == full_set.match(text)


def test_full_node_quotient_packed_layout(full_set):
    # The 64Ki-single-char automaton quotients to <= 2 scan states; the
    # packed device table is a couple of rows, not 16 GB.
    from ahocorasick_tpu.ops import scan_batched

    m = full_set.compiled
    assert scan_batched.quotient_packable(m)
    pd = scan_batched.build_packed(m)
    assert pd.emit_mask is None
    assert pd.table.shape[0] <= 2
    assert pd.table.nbytes < 1 << 20


def test_full_node_device_engine(full_set):
    # Device engine on the quotient table (batched element-gather engine,
    # pinned through the cross-check knob).
    m = AhoCorasickSet(FULL_KWS, engine="device")
    m.device_engine = "batched"
    text = _text(1200)
    assert m.match(text) == full_set.match(text)
    assert m.last_stats.engine == "device"


def test_full_node_device_engine_map_values():
    m = AhoCorasickMap(FULL_KWS, [ord(k) for k in FULL_KWS], engine="device")
    m.device_engine = "batched"
    text = _text(400)
    assert m.match(text) == [(i, i + 1, ord(ch)) for i, ch in enumerate(text)]


def test_row_compressed_shortest_device_engine(monkeypatch):
    # SHORTEST rides the candidates-then-resolve path: its internal AC
    # automaton over the (here: single-char) survivors has a packable
    # quotient DFA, so even the full-alphabet extreme scans on device.
    # (Pinned to the XLA batched engine, the quotient's pick.)
    from ahocorasick_tpu.ops import scan_rowdfa

    monkeypatch.setattr(scan_rowdfa, "pick_engine",
                    lambda m: "batched")
    m = ShortestMatchSet(FULL_KWS, engine="device")
    text = _text(800)
    got = m.match(text)
    assert m.last_stats.engine == "device"
    gold = ShortestMatchSet(FULL_KWS, engine="gold").match(text)
    assert got == gold
    # Single-char keywords: every unit is its own non-overlapping match.
    assert len(got) == len(text)


def test_quotient_device_fuzz_vs_gold(monkeypatch):
    # Force row compression on small dictionaries and pin every quotient
    # device engine pick against the gold loop.
    from ahocorasick_tpu.core import compiler as comp

    monkeypatch.setattr(comp, "_DENSE_LIMIT", 4)
    rng = np.random.default_rng(20260819)
    alpha = list("abcde")
    for trial in range(6):
        kws = list(
            {
                "".join(rng.choice(alpha, size=int(rng.integers(1, 6))))
                for _ in range(int(rng.integers(3, 30)))
            }
        )
        text = "".join(rng.choice(alpha + ["x", " "], size=300))
        dev = AhoCorasickSet(kws, engine="device")
        assert dev.compiled.is_row_compressed
        gold_m = AhoCorasickSet(kws, engine="gold")
        assert dev.match(text) == gold_m.match(text), trial
        ldev = LongestMatchSet(kws, engine="device")
        lgold = LongestMatchSet(kws, engine="gold")
        assert ldev.match(text) == lgold.match(text), trial


def test_small_dicts_stay_dense():
    c = compile_matcher(["he", "she", "hers"], "ac", True)
    assert not c.is_row_compressed
    assert isinstance(c.dfa_next, np.ndarray)


def test_row_table_indexing_patterns():
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = RowTable(rows, np.array([0, 2, 2, 1], dtype=np.int32))
    assert t.shape == (4, 4)
    assert t[1, 3] == rows[2, 3]  # scalar (s, c)
    np.testing.assert_array_equal(t[3], rows[1])  # row fetch
    np.testing.assert_array_equal(  # fancy (s_arr, c_arr)
        t[np.array([0, 1, 3]), np.array([1, 2, 0])], [1, 10, 4]
    )
    np.testing.assert_array_equal(t.materialize(), rows[[0, 2, 2, 1]])


def test_sharded_scanner_full_node(full_set):
    # Sharded device path over the quotient table: 8-device CPU mesh.
    from ahocorasick_tpu.parallel.sharding import ShardedScanner, data_mesh

    sc = ShardedScanner(full_set, data_mesh())
    text = _text(900)
    got = list(zip(*[a.tolist() for a in sc.match_triples(text)]))
    assert [(s, e) for s, e, _ in got] == full_set.match(text)
    assert sc.count(text) == len(text)


def test_sharded_shortest_row_compressed(monkeypatch):
    # Sigma-stitched shortest arrival states via the two-level row-table
    # step (dense S x A never materialized).
    from ahocorasick_tpu.core import compiler as comp
    from ahocorasick_tpu.parallel.sharding import ShardedScanner, data_mesh

    monkeypatch.setattr(comp, "_DENSE_LIMIT", 4)
    rng = np.random.default_rng(42)
    kws = ["ab", "bca", "a", "cc", "ded"]
    text = "".join(rng.choice(list("abcde "), size=2000))
    m = ShortestMatchSet(kws)
    assert m.compiled.is_row_compressed
    sc = ShardedScanner(m, data_mesh())
    want = ShortestMatchSet(kws, engine="gold").match(text)
    got = list(zip(*[a.tolist() for a in sc.match_triples(text)]))
    assert [(s, e) for s, e, _ in got] == want
    assert sc.count(text) == len(want)


def test_sharded_counter_row_compressed(monkeypatch):
    from ahocorasick_tpu.core import compiler as comp
    from ahocorasick_tpu.ops import scan_rowdfa
    from ahocorasick_tpu.parallel import sharding

    monkeypatch.setattr(comp, "_DENSE_LIMIT", 4)
    # Pin the engine: the batched element-gather scan of the quotient.
    monkeypatch.setattr(scan_rowdfa, "pick_engine",
                    lambda m: "batched")
    rng = np.random.default_rng(43)
    kws = ["ab", "bca", "a", "cc"]
    text = "".join(rng.choice(list("abcde "), size=4000))
    m = AhoCorasickSet(kws)
    assert m.compiled.is_row_compressed
    prepare, count, engine = sharding.make_sharded_counter(m, sharding.data_mesh())
    assert engine == "batched"
    want = len(AhoCorasickSet(kws, engine="gold").match(text))
    assert int(count(prepare(m._classes(text)))) == want


def test_sharded_whole_word_row_compressed(monkeypatch):
    # Row-compressed whole-word: quotient AC candidates + boundary filter.
    from ahocorasick_tpu import WholeWordMatchSet
    from ahocorasick_tpu.core import compiler as comp
    from ahocorasick_tpu.parallel.sharding import ShardedScanner, data_mesh

    monkeypatch.setattr(comp, "_DENSE_LIMIT", 4)
    kws = ["ab", "cd", "abab"]
    m = WholeWordMatchSet(kws)
    assert m.compiled.is_row_compressed
    sc = ShardedScanner(m, data_mesh())
    text = "ab cd abab xab ab9 cd " * 30
    want = WholeWordMatchSet(kws, engine="gold").match(text)
    got = list(zip(*[a.tolist() for a in sc.match_triples(text)]))
    assert [(s, e) for s, e, _ in got] == want
    assert sc.count(text) == len(want)


def test_sharded_whole_word_boundary_filter():
    from ahocorasick_tpu import WholeWordMatchSet
    from ahocorasick_tpu.parallel.sharding import ShardedScanner, data_mesh

    kws = ["ab", "cd", "abab"]
    m = WholeWordMatchSet(kws)
    sc = ShardedScanner(m, data_mesh())
    text = "ab cd abab xab ab9 cd"
    want = WholeWordMatchSet(kws, engine="gold").match(text)
    got = list(zip(*[a.tolist() for a in sc.match_triples(text)]))
    assert [(s, e) for s, e, _ in got] == want
    assert sc.count(text) == len(want)


def test_sharded_whole_word_longest_matches_gold():
    # Right-halo sharded wwl walks + host chain follow == sequential gold,
    # including keywords with interior non-word chars and carried fail
    # matches ("as" inside a failing "as i-x" walk).
    from ahocorasick_tpu import WholeWordLongestMatchSet
    from ahocorasick_tpu.parallel.sharding import ShardedScanner, data_mesh

    kws = ["as", "as i-x", "i-x", "cd ef", "cd"]
    rng = np.random.default_rng(44)
    words = ["as", "i-x", "cd", "ef", "zz", "as i-x", "cd ef", "q"]
    text = " ".join(rng.choice(words, size=400))
    m = WholeWordLongestMatchSet(kws)
    sc = ShardedScanner(m, data_mesh())
    want = WholeWordLongestMatchSet(kws, engine="gold").match(text)
    got = list(zip(*[a.tolist() for a in sc.match_triples(text)]))
    assert [(s, e) for s, e, _ in got] == want
    assert sc.count(text) == len(want)


def test_batched2_on_quotient_table(monkeypatch):
    """The stride-2 cross-check engine sizes itself off the packed
    (quotient) table like every sibling — a row-compressed matcher whose
    tiny quotient passes the fits gate must scan exactly (found by
    review: build_packed2 previously reshaped with trie-state counts)."""
    from ahocorasick_tpu.core import compiler as comp
    from ahocorasick_tpu.ops import scan_batched2

    monkeypatch.setattr(comp, "_DENSE_LIMIT", 4)
    kws = ["ab", "bca", "a", "cc"]
    m = AhoCorasickSet(kws, engine="device")
    assert m.compiled.is_row_compressed
    assert scan_batched2.fits(m.compiled)
    m.device_engine = "batched2"
    rng = np.random.default_rng(5)
    text = "".join(rng.choice(list("abc "), size=3000))
    gold_m = AhoCorasickSet(kws, engine="gold")
    assert m.match(text) == gold_m.match(text)


def test_count_force_batched_knob(monkeypatch):
    """device_engine='batched' must force the batched COUNT kernel too
    (the knob previously only governed the planes path)."""
    from ahocorasick_tpu.ops import dispatch

    m = AhoCorasickSet(["he", "she", "hers"], engine="device")
    picked = dispatch.count_plan(m.compiled, m.dev)
    forced = dispatch.count_plan(m.compiled, m.dev, "batched")
    assert picked.which != "batched" and forced.which == "batched"
    text = "ushers she he " * 500
    m.device_engine = "batched"
    assert m.count(text) == len(AhoCorasickSet(["he", "she", "hers"], engine="gold").match(text))
