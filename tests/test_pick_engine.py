"""The engine pick (``ops/scan_rowdfa.pick_engine``) and the plans built
from it (``ops/dispatch.py``), on the CPU.

The cost table was measured on the card (see the constants' comment);
these tests pin the choices it implies and that every engine a plan can
name scans exactly like the gold model.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ahocorasick_tpu.core import gold
from ahocorasick_tpu.core.compiler import compile_matcher
from ahocorasick_tpu.models.matchers import AhoCorasickSet
from ahocorasick_tpu.ops import dispatch, scan_batched, scan_rowdfa


def _words(n, seed=3, letters="abcdefgh", lo=2, hi=8):
    rng = np.random.default_rng(seed)
    out = set()
    while len(out) < n:
        out.add("".join(rng.choice(list(letters), size=int(rng.integers(lo, hi)))))
    return sorted(out)


def test_small_dictionary_picks_stride2():
    m = compile_matcher(["he", "she", "his", "hers"], "ac", True)
    assert scan_rowdfa.fits(m) and scan_rowdfa.fits1(m)
    assert scan_rowdfa.pick_engine(m) == "rowdfa2"


def test_past_stride2_budget_picks_batched(monkeypatch):
    """rowdfa1 costs more per character than batched on the card, so a
    dictionary past the stride-2 budget goes to batched, not rowdfa1."""
    m = compile_matcher(["he", "she", "his", "hers"], "ac", True)
    monkeypatch.setattr(scan_rowdfa, "_MAX_BYTES", 10)
    assert not scan_rowdfa.fits(m) and scan_rowdfa.fits1(m)
    assert scan_rowdfa.pick_engine(m) == "batched"


def test_row_engines_never_undercut_batched_by_rowdfa1():
    assert scan_rowdfa._NS_ROWDFA2 < scan_rowdfa._NS_BATCHED
    assert scan_rowdfa._NS_ROWDFA1 > scan_rowdfa._NS_BATCHED
    for n in (5, 50, 500):
        assert scan_rowdfa.pick_engine(compile_matcher(
            _words(n, seed=n), "ac", True)) != "rowdfa1"


def test_wide_alphabet_skips_row_engines():
    kws = [chr(0x4E00 + i) + chr(0x4E00 + i + 1)
           for i in range(0, scan_rowdfa._MAX_SELECT_CLASSES + 40, 2)]
    m = compile_matcher(kws, "ac", True)
    assert m.num_classes > scan_rowdfa._MAX_SELECT_CLASSES
    assert not scan_rowdfa.fits(m) and not scan_rowdfa.fits1(m)
    assert scan_rowdfa.pick_engine(m) == "batched"


def test_deep_dictionary_plans_leave_packed_inline():
    """state bits + depth > 32: no row engine; the count plan packs the
    emit count, the planes plan the (state, count) hotstate word."""
    m = AhoCorasickSet(["a" * 40, "ab" * 17, "b"], engine="device")
    assert not scan_batched.inline_packable(m.compiled)
    assert scan_rowdfa.pick_engine(m.compiled) == "batched"
    assert dispatch.count_plan(m.compiled, m.dev).which == "packedcount"
    assert dispatch.planes_plan(m.compiled, m.dev).which == "hotstate"


@pytest.mark.parametrize("engine", ["batched", "rowdfa1", "rowdfa2"])
def test_forced_engine_plans_equal_gold(engine):
    kws = _words(60)
    m = AhoCorasickSet(kws, engine="device")
    rng = np.random.default_rng(9)
    text = "".join(rng.choice(list("abcdefgh "), size=5000))
    cls = m._classes(text)
    want = gold.gold_ac(m.compiled, text)
    cp = dispatch.count_plan(m.compiled, m.dev, engine)
    pp = dispatch.planes_plan(m.compiled, m.dev, engine)
    assert cp.which == pp.which == engine
    w = jnp.asarray(scan_batched.chunk_classes(
        cls, 512, pp.halo, m.compiled.num_classes))
    assert int(cp.fn(cp.tables, w)) == len(want)
    s, e, _ = scan_batched.ac_matches_batched(
        m.compiled, cls, np.asarray(pp.fn(pp.tables, w)))
    assert list(zip(s.tolist(), e.tolist())) == [(a, b) for a, b, _ in want]


def test_cpu_backend_is_not_an_accelerator():
    """On the CPU the whole-word stream cursors default to the host walk."""
    from ahocorasick_tpu.core import stream

    assert not stream._default_backend_is_accelerator()
    m = compile_matcher(["new york", "york"], "whole_word_longest", False)
    assert type(stream.make_cursor(m, dev=object())).__name__ == "_WordCursor"
