"""Corpus scanning facade: batching, retry, determinism."""

import numpy as np
import pytest

from ahocorasick_tpu.models.matchers import AhoCorasickMap, AhoCorasickSet
from ahocorasick_tpu.parallel.corpus import scan_corpus


def test_scan_corpus_basic():
    m = AhoCorasickSet(["he", "she"], engine="gold")
    docs = ["she said", "nothing", "hehe"]
    results, stats = scan_corpus(m, docs)
    assert results == [m.match(d) for d in docs]
    assert stats.documents == 3
    assert stats.matches == 2 + 0 + 2
    assert stats.retries == 0


def test_scan_corpus_streams_results():
    m = AhoCorasickMap(["a"], ["A"], engine="gold")
    seen = []
    scan_corpus(m, ["a", "b"], on_result=lambda i, ms: seen.append((i, ms)))
    assert seen == [(0, [(0, 1, "A")]), (1, [])]


def test_scan_corpus_retries_then_gold_fallback():
    m = AhoCorasickSet(["he"], engine="gold")
    calls = {"n": 0}
    orig = m.match

    def flaky(doc, listener=None):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise RuntimeError("transient device failure")
        return orig(doc, listener)

    m.match = flaky
    results, stats = scan_corpus(m, ["he there"], max_retries=2)
    # 3 failures exhaust the attempts; only 2 were RETRIES (the last
    # failure retries nowhere — review finding r5); gold fallback answers.
    assert results == [[(0, 2), (4, 6)]]
    assert stats.retries == 2
    assert stats.gold_fallbacks == 1


def test_scan_corpus_raises_when_even_gold_fails():
    m = AhoCorasickSet(["he"], engine="gold")
    m.match = lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom"))
    m.compiled = None  # breaks the gold fallback too
    with pytest.raises(RuntimeError):
        scan_corpus(m, ["he"], max_retries=0)


def test_determinism_across_runs_and_engines():
    """Same input => identical match arrays across runs and engines (the
    device analog of the reference's immutability thread-safety note)."""
    rng = np.random.default_rng(11)
    kws = ["ab", "ba", "aab", "b", "abab"]
    text = "".join(rng.choice(list("ab "), size=4000))
    gold_m = AhoCorasickSet(kws, engine="gold")
    dev_m = AhoCorasickSet(kws, engine="device")
    first = dev_m.match(text)
    for _ in range(3):
        assert dev_m.match(text) == first
    assert gold_m.match(text) == first
