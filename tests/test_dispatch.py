"""Unit tests for the shared engine dispatcher (``ops/dispatch.py``).

Integration parity for every engine is covered by the engine test modules;
these pin the *plan* contract all four call sites rely on: which engine a
dictionary shape selects, and that count/planes plans agree with each other
and with the gold model over the same windows.
"""

import numpy as np
import pytest

from ahocorasick_tpu.models.matchers import AhoCorasickSet
from ahocorasick_tpu.ops import dispatch, scan_batched


def _matcher(n_keywords: int, seed=11, lo=2, hi=8, letters="abcdefgh"):
    rng = np.random.default_rng(seed)
    kws = set()
    while len(kws) < n_keywords:
        kws.add("".join(rng.choice(list(letters),
                                   size=int(rng.integers(lo, hi)))))
    return AhoCorasickSet(sorted(kws), engine="device"), sorted(kws)


def _text(m, n_units=20000, seed=5):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("abcdefgh "), size=n_units))


def test_force_batched_overrides_pick():
    m, _ = _matcher(200)
    plan = dispatch.planes_plan(m.compiled, m.dev, "batched")
    assert plan.which in ("batched", "split")


@pytest.mark.parametrize("n_kw", [40, 3000])
def test_count_and_planes_plans_agree_with_gold(n_kw):
    import jax.numpy as jnp

    m, kws = _matcher(n_kw)
    text = _text(m)
    expected = AhoCorasickSet(kws, engine="gold").count(text)

    cls = m._classes(text)
    cp = dispatch.count_plan(m.compiled, m.dev)
    w = jnp.asarray(scan_batched.chunk_classes(cls, 512, cp.halo))
    assert int(cp.fn(cp.tables, w)) == expected

    pp = dispatch.planes_plan(m.compiled, m.dev)
    w = jnp.asarray(scan_batched.chunk_classes(cls, 512, pp.halo))
    bits = np.asarray(pp.fn(pp.tables, w))
    # Bit-population over the text positions == total matches (END-indexed
    # planes; padded lanes beyond len(cls) never emit for PAD_CLASS text).
    pops = np.bitwise_count(bits[:, : len(cls)].astype(np.uint32))
    assert int(pops.sum()) == expected


def test_forced_batched_plan_matches_picked_plan():
    import jax.numpy as jnp

    m, _ = _matcher(500)
    text = _text(m)
    cls = m._classes(text)
    picked = dispatch.planes_plan(m.compiled, m.dev)
    forced = dispatch.planes_plan(m.compiled, m.dev, "batched")
    wp = jnp.asarray(scan_batched.chunk_classes(cls, 512, picked.halo))
    wf = jnp.asarray(scan_batched.chunk_classes(cls, 512, forced.halo))
    bp = np.asarray(picked.fn(picked.tables, wp))[:, : len(cls)]
    bf = np.asarray(forced.fn(forced.tables, wf))[:, : len(cls)]
    np.testing.assert_array_equal(bp, bf)


def test_long_keyword_dictionary_plans_pick_hotstate():
    # state_bits + max_depth > 32 (inline overflow) but counts fit:
    # the planes plan outputs the packed (state, count) plane.
    kws = ["a" * i for i in range(1, 101)] + ["bc", "cab"]
    m = AhoCorasickSet(kws, engine="device")
    assert not scan_batched.inline_packable(m.compiled)
    assert scan_batched.hotstate_layout(m.compiled)
    plan = dispatch.planes_plan(m.compiled, m.dev)
    assert plan.which == "hotstate"


def test_hotstate_matcher_conformance_long_keywords():
    from ahocorasick_tpu.models.matchers import (
        AhoCorasickMap,
        LongestMatchSet,
        ShortestMatchSet,
    )

    kws = ["a" * i for i in range(1, 80)] + ["ab", "ba", "bb"]
    text = ("aab" * 300 + "a" * 150 + "b") * 2
    for cls_m in (AhoCorasickSet, LongestMatchSet, ShortestMatchSet):
        dev = cls_m(kws, engine="device")
        gold = cls_m(kws, engine="gold")
        assert dev.match(text) == gold.match(text), cls_m.__name__
    vals = list(range(len(kws)))
    dev = AhoCorasickMap(kws, vals, engine="device")
    gold = AhoCorasickMap(kws, vals, engine="gold")
    assert dev.match(text) == gold.match(text)


def test_auto_threshold_is_engine_aware():
    from ahocorasick_tpu.models import matchers

    small = AhoCorasickSet(["abc", "bcd", "cde"])  # small-table dict
    big_kws = ["a" * i for i in range(1, 90)] + ["bc"]  # hotstate-size depth
    assert matchers._auto_min_units(small.compiled) == 1 << 12
    rng = np.random.default_rng(0)
    mid = AhoCorasickSet(sorted({
        "".join(rng.choice(list("abcdefghijklmnop"), size=int(rng.integers(3, 9))))
        for _ in range(30000)}))
    thr_mid = matchers._auto_min_units(mid.compiled)
    assert thr_mid >= 1 << 12
    # Engine choice follows the per-matcher threshold.
    assert small._pick_engine(1 << 12) == "device"
    assert small._pick_engine((1 << 12) - 1) == "gold"
