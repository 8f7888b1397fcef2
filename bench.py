"""Headline benchmark: DFA-scan throughput on one GPU.

Config (BASELINE.json config #2 scale): 10k seeded English-like keywords,
case-sensitive set matcher, 32 Mi UTF-16 units (64 MiB) of synthetic text,
device-resident classes, empty-listener analog (total match count on
device).  Times the count kernel of the engine the facade picks
(``ops/dispatch.count_plan``).  Prints ONE JSON line, with the device it
ran on; exits non-zero when JAX's first device is not a GPU.

* A 1 Mi-unit base text is generated on the host and uploaded; tiling to
  32 Mi units and the halo windowing happen on the device.
* ONE compiled program does all timed work; the rep count is a *dynamic*
  argument (``lax.fori_loop`` bound), so adapting reps to the wall-clock
  budget never recompiles.
* An internal budget (``BENCH_BUDGET_S``, default 480 s) degrades the rep
  count rather than dying; the persistent compile cache
  (``utils/compile_cache.py``) makes warm reruns take seconds.

``vs_baseline``: the reference README reports 3.6 us to full-match one
English paragraph with an empty listener (README.md:148, 235,886-word
dictionary, ~2015 JVM).  Taking a paragraph as ~700 UTF-16 units gives
~0.19 G units/s = ~0.39 GB/s; we use 0.4 GB/s as the reference-throughput
denominator.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

REFERENCE_GBPS = 0.4

N_KEYWORDS = 10_000
TEXT_UNITS = 1 << 25  # 32 Mi units = 64 MiB UTF-16
BASE_UNITS = 1 << 20  # host-generated + uploaded; tiled on device
CHUNK = 512
SEED = 20260817


def make_dictionary(rng: np.random.Generator, n: int) -> list:
    # Letter-frequency-weighted on purpose and DELIBERATELY kept stable and
    # separate from bench/__main__.english_like_keywords: the headline
    # dictionary identity must not drift between commits (results stay
    # comparable), and the suite's config #2 is the same SCALE, not the
    # same dictionary.
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    freqs = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.2, 0.8, 4.0,
                      2.4, 6.7, 7.5, 1.9, 0.1, 6.0, 6.3, 9.1, 2.8, 1.0, 2.4, 0.2,
                      2.0, 0.1])
    p = freqs / freqs.sum()
    words = set()
    while len(words) < n:
        length = int(rng.integers(3, 13))
        words.add("".join(rng.choice(letters, size=length, p=p)))
    return sorted(words)


def make_text_classes(m, keywords, rng: np.random.Generator, n_units: int) -> np.ndarray:
    """Synthetic text in compact-class space: seeded word soup.

    Built directly in class space (avoiding a giant Python string): words
    drawn from the dictionary's own class sequences (so there are real
    matches) mixed with random in-alphabet noise words, separated by the
    class of ' '.  Content repetition from on-device tiling is irrelevant
    for throughput measurement.
    """
    sep = int(m.compiled.charmap[ord(" ")])
    out = np.empty(n_units + 16, dtype=np.int32)
    pos = 0
    classes = np.arange(2, m.compiled.num_classes, dtype=np.int32)
    kw_cls = [m.compiled.charmap[np.frombuffer(kw.encode("utf-16-le"), dtype=np.uint16).astype(np.int64)]
              for kw in rng.choice(keywords, size=512)]
    noise = [rng.choice(classes, size=int(rng.integers(3, 11))) for _ in range(512)]
    while pos < n_units:
        if rng.random() < 0.10:
            w = kw_cls[int(rng.integers(len(kw_cls)))]
        else:
            w = noise[int(rng.integers(len(noise)))]
        k = min(len(w), n_units + 16 - pos)
        out[pos : pos + k] = w[:k]
        pos += k
        if pos < n_units + 16:
            out[pos] = sep
            pos += 1
    return out[:n_units]


def main() -> None:
    t_start = time.perf_counter()
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "480"))

    from ahocorasick_tpu.utils import compile_cache

    compile_cache.configure()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from ahocorasick_tpu.bench.__main__ import device_fields
    from ahocorasick_tpu.models.matchers import AhoCorasickSet
    from ahocorasick_tpu.ops import dispatch, scan_batched

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {jax.devices()[0]}")

    text_units = int(os.environ.get("BENCH_TEXT_UNITS", TEXT_UNITS))
    base_units = min(BASE_UNITS, text_units)
    assert text_units % base_units == 0 and text_units % CHUNK == 0

    rng = np.random.default_rng(SEED)
    keywords = make_dictionary(rng, N_KEYWORDS)

    m = AhoCorasickSet(keywords, engine="device")
    base = make_text_classes(m, keywords, rng, base_units)

    plan = dispatch.count_plan(m.compiled, m.dev)
    halo, count_fn = plan.halo, plan.fn
    assert halo <= CHUNK
    B = text_units // CHUNK
    reps_tile = text_units // base_units

    base_dev = jax.device_put(jnp.asarray(base.astype(np.int16)))

    @jax.jit
    def build_windows(b16):
        """(B, halo + CHUNK) windows == scan_batched.chunk_classes(tile(b16)).

        chunk i covers [i*CHUNK, (i+1)*CHUNK) with a left halo = the last
        ``halo`` units of chunk i-1 (PAD_CLASS before the text start)."""
        t = jnp.tile(b16.astype(jnp.int32), reps_tile)
        body = t.reshape(B, CHUNK)
        pad = jnp.full((1, halo), scan_batched.PAD_CLASS, jnp.int32)
        prev = jnp.concatenate([pad, body[:-1, CHUNK - halo:]], axis=0)
        return jnp.concatenate([prev, body], axis=1)

    windows = build_windows(base_dev)
    windows.block_until_ready()

    @jax.jit
    def reps_count(tables, w, reps):
        def one(i, tot):
            # jnp.roll reorders lanes per rep: same total work, defeats CSE.
            wi = jnp.roll(w, i, axis=0)
            return tot + count_fn(tables, wi)
        return lax.fori_loop(0, reps, one, jnp.int32(0))

    # Warmup (the one compile) + correctness guard: rep 0 is the plain scan.
    total = int(reps_count(plan.tables, windows, jnp.int32(1)))
    assert total > 0, "benchmark text produced zero matches"

    def timed(reps: int) -> float:
        t0 = time.perf_counter()
        int(reps_count(plan.tables, windows, jnp.int32(reps)))
        return time.perf_counter() - t0

    # Paired measurement cancels per-dispatch overhead:
    # dt/rep = (t(hi) - t(lo)) / (hi - lo).
    lo = 2
    t_lo = timed(lo)
    per_rep_est = max(t_lo / lo, 1e-4)
    remaining = budget_s - (time.perf_counter() - t_start) - 15.0
    hi = lo + int(max(4, min(32, remaining / (3.5 * per_rep_est))))
    t_his, t_los = [], []
    for _ in range(3):
        t_his.append(timed(hi))
        t_los.append(timed(lo))
        if time.perf_counter() - t_start > budget_s - 2.5 * (t_his[-1] + t_los[-1]):
            break
    # Pair the BEST hi with the BEST lo (standard differencing): min over
    # per-round differences pairs a lucky hi with an unlucky lo and can
    # even go non-positive under jitter.
    dt = (min(t_his) - min(t_los)) / (hi - lo)
    if dt <= 0:  # jitter swamped the extra reps; fall back to raw rate
        dt = min(t_his) / hi

    gbps = (text_units * 2) / dt / 1e9
    print(json.dumps({
        "metric": "dfa_scan_throughput",
        "value": round(gbps, 3),
        "unit": "GB/s",
        "vs_baseline": round(gbps / REFERENCE_GBPS, 2),
        "engine": plan.which,
        **device_fields(),
    }))


if __name__ == "__main__":
    main()
