"""``chip_smoke.py`` on the CPU: its phases at a tiny size (exact against
gold, device engines only), and its refusal to run without a GPU."""

import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(
    map_keywords=300, map_units=1 << 16, set_keywords=30, set_units=1 << 16,
    resolve_keywords=500, resolve_units=1 << 16, word_keywords=200,
    word_units=1 << 16, quotient_units=1 << 15, big_keywords=3000,
    big_units=1 << 17, gold_units=1 << 15)


def _check(rec):
    assert rec["matches"] > 0
    assert rec["gold_matches"] > 0
    assert rec["setup_s"] >= rec["compile_s"] >= 0


@pytest.mark.parametrize("phase", chip_smoke.ONE_CARD_PHASES,
                         ids=lambda f: f.__name__)
def test_phase_tiny(phase):
    out = phase(TINY, 3)
    for rec in out if isinstance(out, list) else [out]:
        _check(rec)


def test_four_cards_tiny():
    """The --four path on four of the virtual CPU devices."""
    chip_smoke.four_cards(TINY, 5)


def test_random_words_distinct_and_seeded():
    a = chip_smoke.random_words(np.random.default_rng(1), 500)
    b = chip_smoke.random_words(np.random.default_rng(1), 500)
    assert a == b and len(set(a)) == 500
    assert all(3 <= len(w) < 13 and w.isalpha() for w in a)


def test_soup_length_and_hits():
    rng = np.random.default_rng(2)
    kws = chip_smoke.random_words(rng, 50)
    text = chip_smoke.soup(rng, kws, 5000, base_units=1000)
    assert len(text) == 5000
    assert sum(text.count(k) for k in kws) > 0


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)


def test_script_exits_nonzero_without_gpu():
    out = subprocess.run([sys.executable, chip_smoke.__file__],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_platform_gpu_refuses_cpu():
    from ahocorasick_tpu.bench.__main__ import main

    with pytest.raises(SystemExit) as e:
        main(["--platform", "gpu", "--keywords", "10", "--units", "1024"])
    assert e.value.code not in (0, None)
