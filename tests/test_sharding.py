"""Sharded scanning on the simulated 8-device CPU mesh: exact vs single-device."""

import random

import numpy as np
import pytest

import ahocorasick_tpu as act
from ahocorasick_tpu.core import gold
from ahocorasick_tpu.parallel.sharding import ShardedScanner, data_mesh


def test_mesh_has_8_devices():
    import jax

    assert len(jax.devices()) == 8


def _random_text(rng, n, alphabet="abcdef "):
    return "".join(rng.choice(alphabet) for _ in range(n))


def test_sharded_count_matches_gold():
    rng = random.Random(21)
    kws = ["ab", "abc", "fed", "caf", "e"]
    text = _random_text(rng, 5000)
    m = act.AhoCorasickSet(kws, True, engine="device")
    sc = ShardedScanner(m, data_mesh())
    assert sc.count(text) == len(gold.gold_ac(m.compiled, text))


def test_sharded_triples_match_gold():
    rng = random.Random(22)
    kws = ["aa", "ab", "abc", "bcd", "dd"]
    text = _random_text(rng, 3000, "abcd")
    m = act.AhoCorasickSet(kws, True, engine="device")
    sc = ShardedScanner(m, data_mesh())
    s, e, v = sc.match_triples(text)
    got = list(zip(s.tolist(), e.tolist()))
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    assert got == want


def test_sharded_cross_boundary_matches():
    # A keyword spanning every shard boundary: halo exchange must catch it.
    n_dev = 8
    kws = ["xyzw"]
    seg = "a" * 97  # deliberately not divisible by n_dev
    text = ("xyzw" + seg) * (n_dev + 3)
    m = act.AhoCorasickSet(kws, True, engine="device")
    sc = ShardedScanner(m, data_mesh())
    assert sc.count(text) == n_dev + 3


def test_sharded_longest_resolution():
    rng = random.Random(23)
    kws = ["ab", "abc", "bc", "c"]
    text = _random_text(rng, 2000, "abc")
    m = act.LongestMatchSet(kws, True, engine="device")
    sc = ShardedScanner(m, data_mesh())
    s, e, v = sc.match_triples(text)
    got = list(zip(s.tolist(), e.tolist()))
    want = [(a, b) for a, b, _ in gold.gold_longest(m.compiled, text)]
    assert got == want


def test_sharded_shortest_matches_gold():
    from ahocorasick_tpu.models.matchers import ShortestMatchMap
    from ahocorasick_tpu.parallel.sharding import ShardedScanner

    m = ShortestMatchMap(["she", "he", "hers", "abab"], [1, 2, 3, 4], engine="gold")
    text = "ushers abababab heshe xx " * 13
    sc = ShardedScanner(m)
    starts, ends, vals = sc.match_triples(text)
    got = list(zip(starts.tolist(), ends.tolist(), vals.tolist()))
    expected = [(s, e, v) for s, e, v in
                zip(*[x.tolist() for x in m.match_triples(text)])]
    assert got == expected


def test_sharded_arrival_states_match_flat():
    import jax.numpy as jnp
    import numpy as np
    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.ops import scan_dfa
    from ahocorasick_tpu.parallel.sharding import data_mesh, sharded_arrival_states

    m = AhoCorasickSet(["ab", "bc", "cab"], engine="gold")
    rng = np.random.default_rng(0)
    cls = m.compiled.charmap[
        np.frombuffer("".join(rng.choice(list("abcx"), size=301)).encode("utf-16-le"),
                      dtype=np.uint16)]
    states = sharded_arrival_states(m.dev.dfa_next, cls, data_mesh())
    flat = np.asarray(scan_dfa.dfa_states(m.dev.dfa_next, jnp.asarray(cls.astype(np.int32))))
    np.testing.assert_array_equal(states, flat)


def test_make_sharded_counter_all_tiers():
    """Best-engine sharded counter: each tier counts exactly, on the mesh."""
    import numpy as np

    from ahocorasick_tpu.core import gold
    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.ops import scan_rowdfa
    from ahocorasick_tpu.parallel import sharding

    rng = np.random.default_rng(77)
    mesh = sharding.data_mesh()

    cases = {
        # stride-2 row tier: tiny dictionary
        "rowdfa2": ["he", "she", "hers"],
        # split tier: long keywords overflow the packed layout
        "batched": ["a" * 35, "b" * 33, "ab" * 17],
    }
    # a mid dictionary for a row tier (whichever the model picks)
    cases["row"] = list({
        "".join(rng.choice(list("abcdefgh"), size=int(rng.integers(3, 9))))
        for _ in range(900)
    })

    for label, kws in cases.items():
        m = AhoCorasickSet(kws, engine="gold")
        which = scan_rowdfa.pick_engine(m.compiled)
        if label in ("rowdfa2", "batched"):
            assert which == label
        text = "".join(rng.choice(list("abhersx "), size=7001))
        if label == "batched":
            text += "a" * 40 + " " + "ab" * 17
        prepare, count, engine = sharding.make_sharded_counter(m, mesh)
        from ahocorasick_tpu.ops import scan_batched

        if which == "batched" and scan_batched.count_packable(m.compiled) \
                and not scan_batched.inline_packable(m.compiled):
            which = "packedcount"  # count-only scans upgrade the split path
        assert engine == which
        total = int(count(prepare(m._classes(text))))
        assert total == len(gold.gold_match(m.compiled, text)), (label, engine)


def test_make_sharded_counter_reps_scale_counts():
    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.parallel import sharding

    m = AhoCorasickSet(["ab", "ba"], engine="gold")
    mesh = sharding.data_mesh()
    prepare, count, _ = sharding.make_sharded_counter(m, mesh)
    x = prepare(m._classes("abba " * 400))
    one = int(count(x, reps=1))
    # rolled windows change emit positions but the total stays proportional
    assert int(count(x, reps=1)) == one


def test_sharded_table_count_tp_analog():
    """State-sharded (table-parallel) scan: table rows sharded over the
    mesh, per-char psum combine — exact vs gold on the 8-device CPU mesh."""
    import numpy as np

    from ahocorasick_tpu.core import gold
    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.ops import scan_batched
    from ahocorasick_tpu.parallel import sharding

    rng = np.random.default_rng(20260820)
    kws = list({
        "".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
        for _ in range(60)
    })
    m = AhoCorasickSet(kws)
    pd = scan_batched.build_packed(m.compiled)
    assert pd.emit_mask is None
    text = "".join(rng.choice(list("abcdx"), size=3000))
    cls = m._classes(text)
    mesh = sharding.model_mesh()
    got = sharding.sharded_table_count(
        pd.table, cls, pd.halo, pd.state_bits, mesh
    )
    assert got == len(gold.gold_match(m.compiled, text))
    assert got > 0


def test_sharded_hotstate_planes_long_keywords():
    """Huge-dict layout sharded: the plan-driven planes path runs the
    hotstate one-gather kernel under shard_map and decodes exactly."""
    from ahocorasick_tpu.ops import scan_batched, scan_rowdfa

    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    m = act.AhoCorasickSet(kws, True, engine="device")
    assert scan_batched.hotstate_layout(m.compiled)
    sc = ShardedScanner(m, data_mesh())
    rng = random.Random(7)
    text = _random_text(rng, 9000, "ab")
    s, e, v = sc.match_triples(text)
    got = list(zip(s.tolist(), e.tolist()))
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    assert got == want
    assert sc.count(text) == len(want)


def test_sharded_halo_exceeds_chunk():
    """Keywords longer than the 512-unit window chunk force halo > chunk;
    the sharded builders must widen the chunk instead of silently clamping
    the warmup (found by review: _windows_on_device reshape clamp)."""
    kw = "ab" * 300  # 600 units > 512 chunk
    kws = [kw, "ab", "ba", "bb"]
    m = act.AhoCorasickSet(kws, True, engine="device")
    rng = random.Random(3)
    text = ("ab" * 310 + "x") * 3 + _random_text(rng, 3000, "ab")
    sc = ShardedScanner(m, data_mesh())
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    s, e, v = sc.match_triples(text)
    assert list(zip(s.tolist(), e.tolist())) == want
    assert sc.count(text) == len(want)


def test_table_sharded_scanner_planes_extraction():
    """TP-analog FULL match surface (round-4): state-sharded table, emit
    planes combined by psum, exact triples vs gold — the reference's
    ``match`` delivers every span at any size (AhoCorasickSet.java:193-252).
    """
    import numpy as np

    from ahocorasick_tpu.models.matchers import AhoCorasickMap
    from ahocorasick_tpu.parallel import sharding

    rng = np.random.default_rng(42)
    kws = list({
        "".join(rng.choice(list("abcd"), size=int(rng.integers(1, 6))))
        for _ in range(60)
    })
    m = AhoCorasickMap(kws, [f"v{i}" for i in range(len(kws))])
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts.layout == "planes"
    text = "".join(rng.choice(list("abcdx"), size=3000))
    s, e, v = ts.match_triples(text)
    want = gold.gold_ac(m.compiled, text)
    assert list(zip(s.tolist(), e.tolist(), v.tolist())) == want
    assert ts.count(text) == len(want) > 0


def test_table_sharded_scanner_hotstate_extraction():
    """TP-analog extraction for dictionaries whose emit mask overflows the
    packed-inline layout (the >HBM motivating shape): the (state, count)
    hotstate plane rides the state-sharded scan; masks recovered host-side.
    """
    from ahocorasick_tpu.ops import scan_batched
    from ahocorasick_tpu.parallel import sharding

    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    m = act.AhoCorasickSet(kws, True)
    assert scan_batched.hotstate_layout(m.compiled)
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts.layout == "hotstate"
    rng = random.Random(9)
    text = _random_text(rng, 6000, "ab")
    s, e, v = ts.match_triples(text)
    got = list(zip(s.tolist(), e.tolist()))
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    assert got == want
    assert ts.count(text) == len(want) > 0


def test_table_sharded_scanner_quotient():
    """State-sharded scan over a row-compressed QUOTIENT table (dictionary
    forced over the dense budget via the Thresholder SPI)."""
    import numpy as np

    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.parallel import sharding

    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    rng = np.random.default_rng(3)
    kws = list({
        "".join(rng.choice(list("abcdefgh"), size=int(rng.integers(1, 5))))
        for _ in range(40)
    })
    m = AhoCorasickSet(kws, thresholder=_NeverDense())
    assert m.compiled.is_row_compressed
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    text = "".join(rng.choice(list("abcdefghx"), size=2500))
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want


def test_sharded_wwl_scan_engine_quotient():
    """Round-4: sharded WWL rides the scan engine, including row-compressed
    (quotient) dictionaries — previously the sharded path required dense
    per-state tables and row-compressed WWL had no mesh path at all."""
    import numpy as np

    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet

    kws = [chr(c) for c in range(32, 0xD800)]
    m = WholeWordLongestMatchSet(kws)
    assert m.compiled.is_row_compressed
    sc = ShardedScanner(m, data_mesh())
    rng = np.random.default_rng(5)
    t = "".join(chr(int(x)) for x in rng.integers(32, 0xD800, size=9000))
    s, e, v = sc.match_triples(t)
    want = [(a, b) for a, b, _ in gold.gold_whole_word_longest(m.compiled, t)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert len(want) > 0


def test_sharded_wwl_scan_engine_fuzz():
    """Sharded scan-engine WWL vs gold across separator-quirk dictionaries
    and boundary-straddling walks (left/right halo exactness)."""
    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet

    mesh = data_mesh()
    pool = ["a", "b", "ab", "ba", "aab", " ", "!!", "bab"]
    for trial in range(25):
        r = random.Random(500 + trial)
        kws = list({r.choice(pool) for _ in range(r.randint(1, 6))})
        m = WholeWordLongestMatchSet(kws)
        sc = ShardedScanner(m, mesh)
        t = "".join(r.choice("ab !") for _ in range(r.randint(0, 4000)))
        s, e, v = sc.match_triples(t)
        want = [(a, b) for a, b, _ in
                gold.gold_whole_word_longest(m.compiled, t)]
        assert list(zip(s.tolist(), e.tolist())) == want, (trial, kws)


def test_table_sharded_longest():
    """TP-analog longest (round-5): the state-sharded candidate scan feeds
    the exact greedy resolve — full match surface at any dictionary size,
    matching ``LongestMatchSet.java:211-232``."""
    from ahocorasick_tpu.models.matchers import LongestMatchSet
    from ahocorasick_tpu.parallel import sharding

    rng = random.Random(51)
    m = LongestMatchSet(["ab", "abc", "bc", "c"], engine="gold")
    text = _random_text(rng, 2500, "abc")
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in gold.gold_longest(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert ts.count(text) == len(want) > 0


def test_table_sharded_longest_hotstate():
    """TP-analog longest over the hotstate layout (emit mask overflows the
    packed-inline word — the huge-dictionary shape the TP path exists for)."""
    from ahocorasick_tpu.models.matchers import LongestMatchSet
    from ahocorasick_tpu.ops import scan_batched
    from ahocorasick_tpu.parallel import sharding

    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    m = LongestMatchSet(kws, engine="gold")
    assert scan_batched.hotstate_layout(m.compiled)
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts.layout == "hotstate"
    rng = random.Random(52)
    text = _random_text(rng, 4000, "ab")
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in gold.gold_longest(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert len(want) > 0


def test_table_sharded_shortest_map():
    """TP-analog shortest: the internal insert-survivors AC is state-sharded
    and the min-end resolve runs host-side (``ShortestMatchSet.java:182-260``);
    map values ride through."""
    from ahocorasick_tpu.models.matchers import ShortestMatchMap
    from ahocorasick_tpu.parallel import sharding

    m = ShortestMatchMap(["she", "he", "hers", "abab"], [1, 2, 3, 4],
                         engine="gold")
    text = "ushers abababab heshe xx " * 13
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts.layout == "shortest"
    s, e, v = ts.match_triples(text)
    want = [(a, b, c) for a, b, c in
            zip(*[x.tolist() for x in m.match_triples(text)])]
    assert list(zip(s.tolist(), e.tolist(), v.tolist())) == want
    assert ts.count(text) == len(want) > 0


def test_table_sharded_whole_word():
    """TP-analog whole-word: state-sharded AC candidates + the vectorized
    boundary filter (``WholeWordMatchSet.java:47-132``)."""
    from ahocorasick_tpu.models.matchers import WholeWordMatchSet
    from ahocorasick_tpu.parallel import sharding

    rng = random.Random(53)
    m = WholeWordMatchSet(["ab", "a", "bab"], engine="gold")
    text = _random_text(rng, 2500, "ab !")
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in gold.gold_whole_word(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert ts.count(text) == len(want) > 0


def test_table_sharded_wwl():
    """TP-analog whole-word-longest: the packed wwl-scan table state-shards
    in raw mode; die sweep + restart chain run host-side
    (``WholeWordLongestMatchSet.java:47-178``)."""
    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet
    from ahocorasick_tpu.parallel import sharding

    rng = random.Random(54)
    m = WholeWordLongestMatchSet(["a", "ab", "ba", "aab"], engine="gold")
    text = _random_text(rng, 2500, "ab !")
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts.layout == "wwl"
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in
            gold.gold_whole_word_longest(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert ts.count(text) == len(want) > 0


def test_table_sharded_wwl_quotient():
    """TP-analog WWL over a row-compressed (quotient) scan table."""
    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet
    from ahocorasick_tpu.parallel import sharding

    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    kws = [chr(c) for c in range(97, 123)] + ["ab", "ba"]
    m = WholeWordLongestMatchSet(kws, thresholder=_NeverDense())
    assert m.compiled.is_row_compressed
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts._wwl.quotient
    rng = random.Random(55)
    text = _random_text(rng, 2500, "ab x!")
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in
            gold.gold_whole_word_longest(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert len(want) > 0


def test_table_sharded_dp_tp_2d_mesh():
    """DP x TP composition on a 2x4 mesh: windows shard over ``data``, table
    rows over ``model``; per-char psum rides only the model axis.  Count and
    triples gold-exact for AC and a resolved kind (SURVEY §2.2 composition)."""
    from ahocorasick_tpu.models.matchers import (
        AhoCorasickSet, WholeWordLongestMatchSet,
    )
    from ahocorasick_tpu.parallel import sharding

    mesh2 = sharding.dp_tp_mesh()
    assert mesh2.axis_names == ("data", "model")
    assert mesh2.devices.shape == (2, 4)
    rng = random.Random(56)

    m = AhoCorasickSet(["ab", "abc", "bcd", "dd"], engine="gold")
    text = _random_text(rng, 4000, "abcd")
    ts = sharding.TableShardedScanner(m, mesh2)
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert ts.count(text) == len(want) > 0

    m = WholeWordLongestMatchSet(["a", "ab", "ba", "aab"], engine="gold")
    text = _random_text(rng, 2500, "ab !")
    ts = sharding.TableShardedScanner(m, mesh2)
    s, e, v = ts.match_triples(text)
    want = [(a, b) for a, b, _ in
            gold.gold_whole_word_longest(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want


def test_sharded_stream_chunked_feeds():
    """Streaming cursor over the data-parallel mesh scan: uneven chunked
    feeds equal the one-shot match list at global offsets (the reference's
    stream carry, ``AhoCorasickMap.java:208-275``, at mesh scale), and the
    JSON-safe cursor resumes mid-stream."""
    rng = random.Random(57)
    m = act.AhoCorasickSet(["ab", "abc", "bcd", "dd"], engine="device")
    sc = ShardedScanner(m, data_mesh())
    text = _random_text(rng, 5000, "abcd ")
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]

    st = sc.stream()
    got = []
    cuts = [0, 1203, 2011, 3999, len(text)]
    for a, b in zip(cuts[:-1], cuts[1:]):
        s, e, v = st.feed(text[a:b], is_final=(b == len(text)))
        got += list(zip(s.tolist(), e.tolist()))
    assert got == want and len(want) > 0

    st2 = sc.stream()
    s, e, v = st2.feed(text[:2500])
    got2 = list(zip(s.tolist(), e.tolist()))
    st3 = sc.stream()
    st3.load_state_dict(st2.state_dict())
    s, e, v = st3.feed(text[2500:], is_final=True)
    got2 += list(zip(s.tolist(), e.tolist()))
    assert got2 == want


def test_table_sharded_wwl_mixed():
    """Separator-spanning WWL on the TP path (round 5): truncated-closure
    raw-plane scan + host continuations, gold-exact."""
    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet
    from ahocorasick_tpu.parallel import sharding

    m = WholeWordLongestMatchSet(["new york", "new", "york", "a b", "ab"],
                                 case_sensitive=False)
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    assert ts._wwl.has_cross
    rng = random.Random(58)
    t = "".join(rng.choice(["new", "york", " ", "a", "b ", "!x"])
                for _ in range(2000)) + " new york a b"
    s, e, v = ts.match_triples(t)
    want = [(a, b) for a, b, _ in
            gold.gold_whole_word_longest(m.compiled, t)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert len(want) > 0


def test_sharded_wwl_mixed():
    """Separator-spanning WWL on the data-parallel mesh: per-shard truncated
    scan with halo exchange + host continuation fixes, gold-exact across
    shard boundaries."""
    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet

    m = WholeWordLongestMatchSet(["new york", "new", "york", "a b", "ab"],
                                 case_sensitive=False, engine="device")
    sc = ShardedScanner(m, data_mesh())
    for trial in range(10):
        rng = random.Random(590 + trial)
        t = "".join(rng.choice(["new", "york", " ", "a", "b ", "!x"])
                    for _ in range(rng.randint(0, 3000)))
        s, e, v = sc.match_triples(t)
        want = [(a, b) for a, b, _ in
                gold.gold_whole_word_longest(m.compiled, t)]
        assert list(zip(s.tolist(), e.tolist())) == want, trial


def test_table_sharded_scanner_caches_build():
    """Table upload + jit closure are cached across calls (the scanner
    exists for >HBM tables; a per-call re-upload would dominate)."""
    import numpy as np

    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.parallel import sharding

    m = AhoCorasickSet(["ab", "bc"])
    ts = sharding.TableShardedScanner(m, sharding.model_mesh())
    text = "abcabc" * 40
    c1 = ts.count(text)
    built1 = {k: v for k, v in ts._built.items()}
    c2 = ts.count(text)
    assert c1 == c2
    assert ts._built is not None and all(
        ts._built[k][0] is built1[k][0] and ts._built[k][1] is built1[k][1]
        for k in built1
    )


def test_sharded_wwl_long_keywords_halo_widening():
    """WWL keywords longer than the 512 base window force cw > 512 (the
    _chunk_for widening); walks must still die/emit exactly across shard
    edges with the widened halos."""
    from ahocorasick_tpu.models.matchers import WholeWordLongestMatchSet

    long_kw = "ab" * 300  # 600 units > 512
    kws = [long_kw, "ab", "abab", "b"]
    m = WholeWordLongestMatchSet(kws)
    sc = ShardedScanner(m, data_mesh())
    text = (" " + long_kw + " abab b ab " + long_kw[:-1] + " ") * 8
    s, e, v = sc.match_triples(text)
    want = [(a, b) for a, b, _ in gold.gold_whole_word_longest(m.compiled, text)]
    assert list(zip(s.tolist(), e.tolist())) == want
    assert len(want) > 0


def test_table_sharded_mesh_shapes_and_edges():
    """TP scanner robustness: degenerate DP x TP shapes ((1, 8), (4, 2)),
    a model axis wider than the table's row count, and empty text."""
    from ahocorasick_tpu.models.matchers import AhoCorasickSet, LongestMatchSet
    from ahocorasick_tpu.parallel import sharding

    rng = random.Random(60)
    m = AhoCorasickSet(["ab", "abc", "bcd"], engine="gold")
    text = _random_text(rng, 1500, "abcd")
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    for shape in ((1, 8), (4, 2)):
        ts = sharding.TableShardedScanner(m, sharding.dp_tp_mesh(shape=shape))
        s, e, v = ts.match_triples(text)
        assert list(zip(s.tolist(), e.tolist())) == want, shape
        assert ts.count(text) == len(want)

    # More model shards than quotient rows: padded rows must stay inert.
    class _NeverDense:
        def is_over_threshold(self, size, lo, hi):
            return False

    mq = AhoCorasickSet(["x", "y"], thresholder=_NeverDense())
    assert mq.compiled.is_row_compressed
    from ahocorasick_tpu.ops import scan_batched

    assert scan_batched.effective_rows(mq.compiled) < 8
    tq = sharding.TableShardedScanner(mq, sharding.model_mesh())
    t2 = "xxyxy x!y"
    wantq = [(a, b) for a, b, _ in gold.gold_ac(mq.compiled, t2)]
    sq, eq, _ = tq.match_triples(t2)
    assert list(zip(sq.tolist(), eq.tolist())) == wantq

    # Empty text through every kind path that builds.
    for mk in (m, LongestMatchSet(["ab", "abcd"], engine="gold")):
        ts = sharding.TableShardedScanner(mk, sharding.model_mesh())
        s, e, v = ts.match_triples("")
        assert len(s) == 0
        assert ts.count("") == 0


def test_stream_gate_rejects_resolved_kinds():
    """Both scanners' stream() fronts share the ONE AC-only gate."""
    from ahocorasick_tpu.models.matchers import LongestMatchSet
    from ahocorasick_tpu.parallel import sharding

    m = LongestMatchSet(["ab", "abcd"], engine="gold")
    with pytest.raises(ValueError):
        ShardedScanner(m, data_mesh()).stream()
    with pytest.raises(ValueError):
        sharding.TableShardedScanner(m, sharding.model_mesh()).stream()


def test_table_sharded_stream_chunked_feeds():
    """Streaming at >HBM scale: the tail-carry cursor over the state-
    sharded scan — uneven chunked feeds equal the one-shot match list at
    global offsets, on 1-axis and DP x TP meshes."""
    from ahocorasick_tpu.parallel import sharding

    rng = random.Random(61)
    m = act.AhoCorasickSet(["ab", "abc", "bcd", "dd"], engine="gold")
    text = _random_text(rng, 4000, "abcd ")
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    for mesh in (sharding.model_mesh(), sharding.dp_tp_mesh()):
        st = sharding.TableShardedScanner(m, mesh).stream()
        got = []
        cuts = [0, 977, 2011, 3500, len(text)]
        for a, b in zip(cuts[:-1], cuts[1:]):
            s, e, v = st.feed(text[a:b], is_final=(b == len(text)))
            got += list(zip(s.tolist(), e.tolist()))
        assert got == want and len(want) > 0, mesh.axis_names


def test_sharded_stream_hotstate_layout():
    """Streaming over a hotstate-layout dictionary (emit mask overflows the
    packed word) through BOTH mesh scanners: chunked feeds equal gold."""
    from ahocorasick_tpu.ops import scan_batched
    from ahocorasick_tpu.parallel import sharding

    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    m = act.AhoCorasickSet(kws, True, engine="device")
    assert scan_batched.hotstate_layout(m.compiled)
    rng = random.Random(62)
    text = _random_text(rng, 3000, "ab")
    want = [(a, b) for a, b, _ in gold.gold_ac(m.compiled, text)]
    for scanner in (ShardedScanner(m, data_mesh()),
                    sharding.TableShardedScanner(m, sharding.model_mesh())):
        st = scanner.stream()
        got = []
        cuts = [0, 700, 1501, len(text)]
        for a, b in zip(cuts[:-1], cuts[1:]):
            s, e, v = st.feed(text[a:b], is_final=(b == len(text)))
            got += list(zip(s.tolist(), e.tolist()))
        assert got == want and len(want) > 0, type(scanner).__name__
