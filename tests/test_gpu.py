"""Card-only tests: the XLA engines as compiled for the GPU.

Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_gpu.py -m gpu

Each test skips (from the ``gpu`` fixture, never at import) when JAX's
first device is not a GPU.  The engines are compared bit for bit with each
other at the widths of the BASELINE #1 and #6 dictionaries, and the
facade's pick with the gold model.
"""

import numpy as np
import pytest

import chip_smoke

pytestmark = pytest.mark.gpu

_UNITS = 4 << 20


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX's first device is not a GPU)")


def _baseline1():
    from ahocorasick_tpu import AhoCorasickSet

    rng = np.random.default_rng(1)
    kws = chip_smoke.random_words(rng, 100)
    return AhoCorasickSet(kws), chip_smoke.soup(rng, kws, _UNITS)


def _baseline6():
    from ahocorasick_tpu import AhoCorasickSet

    rng = np.random.default_rng(6)
    m = AhoCorasickSet([chr(c) for c in range(32, 0xD800)])
    return m, chip_smoke.wide_text(rng, _UNITS)


def _engines(m):
    from ahocorasick_tpu.ops import scan_rowdfa

    return ["batched"] + [e for e, ok in (
        ("rowdfa1", scan_rowdfa.fits1(m.compiled)),
        ("rowdfa2", scan_rowdfa.fits(m.compiled))) if ok]


@pytest.mark.parametrize("make", [_baseline1, _baseline6],
                         ids=["baseline1", "baseline6"])
def test_engines_agree_at_real_width(gpu, make):
    import jax.numpy as jnp

    from ahocorasick_tpu.ops import dispatch, scan_batched

    m, text = make()
    cls = m._classes(text)
    planes, counts = [], []
    for eng in _engines(m):
        pp = dispatch.planes_plan(m.compiled, m.dev, eng)
        w = jnp.asarray(scan_batched.chunk_classes(
            cls, 512, pp.halo, m.compiled.num_classes))
        planes.append(np.asarray(pp.fn(pp.tables, w))[:, : len(cls)])
        cp = dispatch.count_plan(m.compiled, m.dev, eng)
        counts.append(int(cp.fn(cp.tables, w)))
    for p in planes[1:]:
        np.testing.assert_array_equal(p, planes[0])
    assert len(set(counts)) == 1 and counts[0] > 0
    assert counts[0] == int(np.bitwise_count(planes[0]).sum())


@pytest.mark.parametrize("make,want", [(_baseline1, "rowdfa2"),
                                       (_baseline6, "batched")],
                         ids=["baseline1", "baseline6"])
def test_facade_pick_on_card(gpu, make, want):
    import jax

    from ahocorasick_tpu.core import gold
    from ahocorasick_tpu.ops import dispatch

    m, text = make()
    assert jax.default_backend() == "gpu"
    assert dispatch.planes_plan(m.compiled, m.dev).which == want
    text = text[: 1 << 17]
    s, e, v = m.match_triples(text)
    assert m.last_stats.engine == "device"
    assert list(zip(s.tolist(), e.tolist(), v.tolist())) == [
        tuple(t) for t in gold.gold_ac(m.compiled, text)]
    assert m.count(text) == len(s)
