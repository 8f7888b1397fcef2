"""Smoke run of the matchers on one NVIDIA GPU, end to end.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # four cards: the sharded scanners only

Start-up: a child process asks JAX for its first device, which must be a
GPU (there is no CPU path); the card's name and power limit come from
``nvidia-smi``; the native host compiler must be built; the card-only
tests (``pytest -m gpu``) run as a child process before this process
imports JAX, so only one JAX process holds the card at a time.

Each one-card phase drives the public matcher classes at the sizes of the
BASELINE configs, with text generated from ``--seed`` by tiling a seeded
base, and prints the engine and dispatch plan it ran, set-up seconds
(dictionary compile + first call, which compiles the device programs),
end-to-end seconds of a second call, and the device's peak memory.
Every phase checks that its scans ran on the device engine (never the
host gold loop), that its triples equal ``core/gold.py`` exactly on a
prefix of its text, and that ``count`` equals ``len(match_triples)`` on
the full text.  All of the arithmetic is integer (class ids, packed
uint32 table entries, popcounts), so every comparison is exact: there is
no tolerance, and TF32 does not apply.

The last line of standard output is one JSON object naming the device.
Any failure raises and exits non-zero before that line is printed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MI = 1 << 20


class Sizes(NamedTuple):
    map_keywords: int  # BASELINE #2
    map_units: int
    set_keywords: int  # BASELINE #1
    set_units: int
    resolve_keywords: int  # BASELINE #3
    resolve_units: int
    word_keywords: int  # BASELINE #4 / #7
    word_units: int
    quotient_units: int  # BASELINE #6
    big_keywords: int  # BASELINE #5
    big_units: int
    gold_units: int  # prefix checked against core/gold.py


FULL = Sizes(10_000, 50 * MI, 100, 16 * MI, 100_000, 4 * MI, 1000, 4 * MI,
             16 * MI, 1_000_000, 4 * MI, MI)


# --------------------------------------------------------------------------
# Seeded data, built from pools so Python text generation stays cheap.

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)


def random_words(rng: np.random.Generator, n: int, lo: int = 3,
                 hi: int = 13) -> list:
    """``n`` distinct lowercase words of length [lo, hi), sorted."""
    out: set = set()
    w = hi - 1
    while len(out) < n:
        k = 2 * (n - len(out)) + 16
        lens = rng.integers(lo, hi, size=k).tolist()
        rows = _LETTERS[rng.integers(0, 26, size=(k, w))].tobytes().decode()
        out.update(rows[i * w: i * w + n_] for i, n_ in enumerate(lens))
    return sorted(out)[:n]


def soup(rng: np.random.Generator, keywords: list, n_units: int,
         hit_rate: float = 0.1, base_units: int = MI) -> str:
    """Space-separated words (``hit_rate`` of them dictionary keywords),
    ``n_units`` long, made by tiling a seeded base of ``base_units``."""
    base_units = min(base_units, n_units)
    kws = [keywords[i] for i in rng.integers(0, len(keywords), size=512)]
    noise = random_words(rng, 4096, 3, 11)
    words = []
    total = 0
    while total <= base_units:
        pick = rng.random(4096) < hit_rate
        src = rng.integers(0, 512, size=4096)
        for is_kw, j in zip(pick, src):
            w = kws[j] if is_kw else noise[j]
            words.append(w)
            total += len(w) + 1
    base = " ".join(words)[:base_units]
    reps = -(-n_units // len(base))
    return (base * reps)[:n_units]


def adversarial(rng: np.random.Generator, keywords: list, n_units: int) -> str:
    """BASELINE #3 text: long ``a`` runs against ``a``-prefix keywords,
    then word soup."""
    half = n_units // 2
    runs = ("a" * 28 + "b") * (half // 29 + 1)
    return (runs[:half] + soup(rng, keywords, n_units - half))[:n_units]


def wide_text(rng: np.random.Generator, n_units: int) -> str:
    """BASELINE #6 text: uniform BMP characters below the surrogates."""
    base = rng.integers(32, 0xD800, size=min(n_units, MI)).astype(np.uint16)
    units = np.tile(base, -(-n_units // len(base)))[:n_units]
    return units.tobytes().decode("utf-16-le")


# --------------------------------------------------------------------------
# Phase helpers.

def _peak_bytes(device=None):
    """Peak bytes in use so far on ``device`` (default: the first); None
    where JAX keeps no memory stats."""
    import jax

    device = device or jax.devices()[0]
    return (device.memory_stats() or {}).get("peak_bytes_in_use")


def plan_name(m) -> str:
    """The device engine the matcher's scans ran: the dispatch plan for the
    AC family (count plan / planes plan), the WWL scan variant."""
    from ahocorasick_tpu.ops import dispatch, scan_wwl

    if m.kind == "whole_word_longest":
        c = m.compiled
        if scan_wwl.scan_applicable(c):
            return "wwl-scan"
        return "wwl-mixed" if scan_wwl.mixed_scan_applicable(c) else "wwl-walks"
    target = m._ac if m.kind == "shortest" else m
    planes = dispatch.planes_plan(target.compiled, target.dev).which
    if m.kind != "ac":
        return planes
    count = dispatch.count_plan(target.compiled, target.dev).which
    return f"count={count} planes={planes}"


def _device_call(m, fn, *args):
    out = fn(*args)
    engine = m.last_stats.engine
    if engine != "device":
        raise AssertionError(f"{m.kind}: ran engine {engine!r}, not device")
    return out


def check_gold(m, text: str, units: int) -> int:
    """Device triples on ``text[:units]`` must equal the gold model's."""
    from ahocorasick_tpu.core import gold

    prefix = text[:units]
    s, e, v = _device_call(m, m.match_triples, prefix)
    want = gold.GOLD_BY_KIND[m.kind](m.compiled, prefix)
    got = list(zip(s.tolist(), e.tolist(), v.tolist()))
    if got != [tuple(t) for t in want]:
        raise AssertionError(
            f"{m.kind}: device triples differ from gold on {units} units "
            f"({len(got)} vs {len(want)})")
    return len(want)


def run_phase(name: str, make, text: str, sz: Sizes) -> dict:
    """Build the matcher, then time match_triples (and count) on ``text``:
    set-up = compile + first call, end-to-end = second call."""
    t0 = time.perf_counter()
    m = make()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _device_call(m, m.match_triples, text)
    setup_s = compile_s + time.perf_counter() - t0
    t0 = time.perf_counter()
    s, e, v = _device_call(m, m.match_triples, text)
    triples_s = time.perf_counter() - t0
    rec = {"phase": name, "kind": m.kind, "plan": plan_name(m),
           "units": len(text), "matches": int(len(s)),
           "compile_s": compile_s, "setup_s": setup_s,
           "match_triples_s": triples_s}
    _device_call(m, m.count, text)  # compiles the count program
    t0 = time.perf_counter()
    n = _device_call(m, m.count, text)
    rec["count_s"] = time.perf_counter() - t0
    if n != len(s):
        raise AssertionError(f"{name}: count {n} != {len(s)} triples")
    rec["gold_units"] = min(sz.gold_units, len(text))
    rec["gold_matches"] = check_gold(m, text, rec["gold_units"])
    rec["peak_bytes"] = _peak_bytes()
    rec["_matcher"], rec["_triples"] = m, (s, e, v)
    return rec


def _emit(rec: dict) -> dict:
    print(json.dumps({k: v for k, v in rec.items() if not k.startswith("_")}),
          flush=True)
    return rec


# --------------------------------------------------------------------------
# One-card phases (BASELINE configs).

def phase_map(sz: Sizes, seed: int) -> dict:
    """#2: 10k-keyword case-insensitive map; count, match_triples and
    match_stream over a real file with 1 Mi-unit chunks."""
    import ahocorasick_tpu as ac

    rng = np.random.default_rng(seed)
    kws = random_words(rng, sz.map_keywords)
    text = soup(rng, kws, sz.map_units).upper()
    rec = run_phase(
        "map-10k-folded",
        lambda: ac.AhoCorasickMap(kws, list(range(len(kws))), False),
        text, sz)
    m, (s, e, v) = rec["_matcher"], rec["_triples"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "text.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        t0 = time.perf_counter()
        with open(path, encoding="utf-8") as f:
            streamed = m.match_stream(f, chunk_units=MI)
        rec["match_stream_s"] = time.perf_counter() - t0
    want = list(zip(s.tolist(), e.tolist(), v.tolist()))
    if streamed != want:
        raise AssertionError("match_stream differs from match_triples")
    return _emit(rec)


def phase_set(sz: Sizes, seed: int) -> dict:
    """#1: 100-keyword case-sensitive set."""
    import ahocorasick_tpu as ac

    rng = np.random.default_rng(seed + 1)
    kws = random_words(rng, sz.set_keywords)
    text = soup(rng, kws, sz.set_units)
    return _emit(run_phase("set-100", lambda: ac.AhoCorasickSet(kws), text, sz))


def phase_resolve(sz: Sizes, seed: int) -> list:
    """#3: leftmost-longest and leftmost-shortest, 100k keywords plus the
    ``a``-run keywords, on the adversarial overlap text."""
    import ahocorasick_tpu as ac

    rng = np.random.default_rng(seed + 2)
    kws = random_words(rng, sz.resolve_keywords) + ["a" * i for i in range(1, 9)]
    text = adversarial(rng, kws, sz.resolve_units)
    out = []
    for name, klass in (("longest-100k", ac.LongestMatchSet),
                        ("shortest-100k", ac.ShortestMatchSet)):
        out.append(_emit(run_phase(name, lambda k=klass: k(kws), text, sz)))
    return out


def _word_chars():
    from ahocorasick_tpu.utils import chartables

    wc = chartables.default_word_chars().copy()
    wc[ord("'")] = True  # custom override: apostrophes are word chars
    return wc


def phase_words(sz: Sizes, seed: int) -> list:
    """#4 (Unicode keywords, custom word chars) through WholeWordMatchSet
    and WholeWordLongestMatchSet; #7 (separator-spanning phrases) through
    WholeWordLongestMatchSet."""
    import ahocorasick_tpu as ac

    rng = np.random.default_rng(seed + 3)
    wc = _word_chars()
    kws4 = random_words(rng, sz.word_keywords) + ["naïve", "can't", "übermäßig"]
    text4 = (" can't naïve übermäßig can'tx " + soup(rng, kws4, sz.word_units)
             )[: sz.word_units]
    base7 = random_words(rng, sz.word_keywords - sz.word_keywords // 20)
    n_phr = max(1, len(base7) // 19)
    kws7 = base7 + [f"{a} {b}" for a, b in
                    zip(base7[:n_phr], base7[n_phr: 2 * n_phr])]
    text7 = soup(rng, kws7, sz.word_units)
    return [
        _emit(run_phase("wholeword-unicode",
                        lambda: ac.WholeWordMatchSet(kws4, word_chars=wc),
                        text4, sz)),
        _emit(run_phase("wwl-unicode",
                        lambda: ac.WholeWordLongestMatchSet(kws4, word_chars=wc),
                        text4, sz)),
        _emit(run_phase("wwl-phrases",
                        lambda: ac.WholeWordLongestMatchSet(kws7, word_chars=wc),
                        text7, sz)),
    ]


def phase_quotient(sz: Sizes, seed: int) -> dict:
    """#6: every BMP character below the surrogates as a keyword — the
    row-compressed automaton scanned through its packed quotient DFA."""
    import ahocorasick_tpu as ac

    rng = np.random.default_rng(seed + 4)
    kws = [chr(c) for c in range(32, 0xD800)]
    text = wide_text(rng, sz.quotient_units)
    return _emit(run_phase("fullnode-quotient",
                           lambda: ac.AhoCorasickSet(kws), text, sz))


def phase_big(sz: Sizes, seed: int) -> dict:
    """#5: 1M-keyword set (packedcount count, hotstate planes), then a
    save/load_matcher round trip giving the same triples."""
    import ahocorasick_tpu as ac

    rng = np.random.default_rng(seed + 5)
    kws = random_words(rng, sz.big_keywords)
    text = soup(rng, kws, sz.big_units)
    rec = run_phase("set-1m", lambda: ac.AhoCorasickSet(kws), text, sz)
    m, (s, e, v) = rec["_matcher"], rec["_triples"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "big.npz")
        t0 = time.perf_counter()
        m.save(path)
        loaded = ac.load_matcher(path)
        rec["save_load_s"] = time.perf_counter() - t0
        s2, e2, v2 = _device_call(loaded, loaded.match_triples, text)
    if not (np.array_equal(s, s2) and np.array_equal(e, e2)
            and np.array_equal(v, v2)):
        raise AssertionError("loaded matcher's triples differ")
    return _emit(rec)


ONE_CARD_PHASES = (phase_map, phase_set, phase_resolve, phase_words,
                   phase_quotient, phase_big)


# --------------------------------------------------------------------------
# Four cards.

def _shard_devices(arr) -> set:
    return {s.device for s in arr.addressable_shards}


def four_cards(sz: Sizes, seed: int, n_dev: int = 4) -> None:
    """The sharded scanners on ``n_dev`` cards against the one-card facade
    and gold: data-parallel count/match_triples/stream for the 10k map,
    state-sharded (1-axis and 2x2 meshes) for the 1M dictionary, and
    ``dryrun_multichip``."""
    import jax

    import ahocorasick_tpu as ac
    from __graft_entry__ import dryrun_multichip
    from ahocorasick_tpu.parallel import sharding

    devices = np.asarray(jax.devices()[:n_dev])
    if len(devices) < n_dev:
        raise SystemExit(f"--four needs {n_dev} devices, found {len(devices)}")

    rng = np.random.default_rng(seed)
    kws = random_words(rng, sz.map_keywords)
    text = soup(rng, kws, sz.map_units).upper()
    m = ac.AhoCorasickMap(kws, list(range(len(kws))), False)
    s1, e1, v1 = _device_call(m, m.match_triples, text)
    check_gold(m, text, sz.gold_units)

    mesh = sharding.data_mesh(devices)
    prepare, _, engine = sharding.make_sharded_counter(m, mesh)
    x = prepare(m._classes(text))
    held = _shard_devices(x)
    if len(held) != n_dev:
        raise AssertionError(f"sharded input on {len(held)} devices, not {n_dev}")
    print(json.dumps({"check": "sharded-input-devices",
                      "devices": sorted(str(d) for d in held)}), flush=True)

    sc = sharding.ShardedScanner(m, mesh)
    t0 = time.perf_counter()
    n = sc.count(text)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = sc.count(text)
    count_s = time.perf_counter() - t0
    sc.match_triples(text)
    t0 = time.perf_counter()
    s4, e4, v4 = sc.match_triples(text)
    triples_s = time.perf_counter() - t0
    if not (n == len(s1) and np.array_equal(s1, s4) and np.array_equal(e1, e4)
            and np.array_equal(v1, v4)):
        raise AssertionError("ShardedScanner differs from the one-card facade")
    cuts = [0, len(text) // 3, len(text) // 2, len(text)]
    st = sc.stream()
    got = [st.feed(text[a:b], is_final=b == len(text)) for a, b in
           zip(cuts[:-1], cuts[1:])]
    if not np.array_equal(np.concatenate([g[1] for g in got]), e1):
        raise AssertionError("sharded stream differs from the facade")
    print(json.dumps({"phase": "sharded-map-10k", "engine": engine,
                      "units": len(text), "matches": int(n),
                      "setup_s": setup_s, "count_s": count_s,
                      "match_triples_s": triples_s}), flush=True)

    big = random_words(rng, sz.big_keywords)
    btext = soup(rng, big, sz.big_units)
    mb = ac.AhoCorasickSet(big)
    sb, eb, _ = _device_call(mb, mb.match_triples, btext)
    for label, bmesh in (("model", sharding.model_mesh(devices)),
                         ("dp_tp", sharding.dp_tp_mesh(devices))):
        ts = sharding.TableShardedScanner(mb, bmesh)
        t0 = time.perf_counter()
        st_, et_, _ = ts.match_triples(btext)
        dt = time.perf_counter() - t0
        if not (np.array_equal(sb, st_) and np.array_equal(eb, et_)):
            raise AssertionError(f"TableShardedScanner ({label}) differs")
        if ts.count(btext) != len(sb):
            raise AssertionError(f"TableShardedScanner ({label}) count differs")
        print(json.dumps({"phase": f"table-sharded-1m-{label}",
                          "mesh": dict(bmesh.shape), "layout": ts.layout,
                          "units": len(btext), "matches": int(len(sb)),
                          "first_match_triples_s": dt}), flush=True)

    dryrun_multichip(n_dev)
    print(json.dumps({"check": "dryrun_multichip", "devices": n_dev}),
          flush=True)
    print(json.dumps({"peak_bytes_per_device": [
        _peak_bytes(d) for d in devices]}), flush=True)


# --------------------------------------------------------------------------
# Start-up.

def _probe_platform() -> str:
    """First JAX device's platform, asked in a child process so this
    process stays off the card until the card-only tests have run."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        sys.stderr.write(out.stderr)
        raise SystemExit("JAX failed to start")
    return out.stdout.strip().splitlines()[-1]


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _card_tests() -> str:
    """``pytest -m gpu`` in a child; every selected test must pass."""
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_gpu.py", "-m", "gpu",
         "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-1] if out.stdout.strip() else ""
    if out.returncode != 0 or not re.search(r"\d+ passed", tail) or re.search(
            r"skipped|failed|error", tail):
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"card tests did not pass: {tail!r}")
    return tail


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded checks")
    p.add_argument("--seed", type=int, default=20261016)
    args = p.parse_args(argv)

    platform = _probe_platform()
    if platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {platform!r}")
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    sys.path.insert(0, ROOT)
    from ahocorasick_tpu.native import lib
    from ahocorasick_tpu.utils import compile_cache

    print(f"compile cache: {compile_cache.configure()}", flush=True)
    if not lib.available():
        raise SystemExit("native host compiler did not build")
    if not args.four:
        print(f"card tests: {_card_tests()}", flush=True)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    if args.four:
        four_cards(FULL, args.seed)
    else:
        for phase in ONE_CARD_PHASES:
            phase(FULL, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
