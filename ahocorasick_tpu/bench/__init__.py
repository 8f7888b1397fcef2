"""Microbenchmark CLI — the device replacement for the reference's per-test
``main()`` perf loops and ``bin/test-branches`` A/B harness.

    python -m ahocorasick_tpu.bench --kind ac --keywords 10000 --units 1048576

Prints one JSON line per run with ScanStats fields; diff two git branches by
running this in each and comparing (the ``bin/test-branches`` workflow).
"""

from __future__ import annotations

import time

import numpy as np


def ac_kernel_rate(m, cls: np.ndarray, reps: int = 8, chunk: int = 512,
                   engine=None):
    """Device-resident scan rate (GB/s) of the matcher's count kernel.

    Uploads the chunked windows once and times ``reps`` on-device scans
    inside one jit (shifted windows defeat CSE) — the same methodology as
    the repo-root ``bench.py``.  This isolates the DFA-scan kernel from
    host-side encode, chunking, upload and extraction (the end-to-end
    ``gbps`` column).  Applies to the AC-candidates engines (ac / longest /
    whole_word kinds and their maps).  ``engine`` times that engine
    instead of ``pick_engine``'s choice (per-engine cost measurement).
    Returns ``(GB/s, count per scan, engine)``.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ahocorasick_tpu.ops import dispatch, scan_batched

    # Scale reps so the timed work stays well above per-dispatch overhead:
    # target >= 128 Mi units per call.
    reps = max(reps, -(-(128 << 20) // max(len(cls), 1)))

    plan = dispatch.count_plan(m.compiled, m.dev, engine)
    which, count_fn = plan.which, plan.fn
    windows = scan_batched.chunk_classes(cls, chunk, plan.halo,
                                         m.compiled.num_classes)
    wdev = jax.device_put(jnp.asarray(windows))

    @jax.jit
    def reps_count(tables, w):
        def one(i, tot):
            wi = jnp.roll(w, i, axis=0)
            return tot + count_fn(tables, wi)

        return lax.fori_loop(0, reps, one, jnp.int32(0))

    # Warmup compiles the ONE program; rolling windows only permutes the
    # self-contained (halo + body) rows, so every rep counts identically
    # and the per-scan total falls out of the warmup value — no separate
    # count_fn program (a second cold compile per config otherwise).
    warm = int(reps_count(plan.tables, wdev))
    total = warm // reps
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(reps_count(plan.tables, wdev))
        best = min(best, time.perf_counter() - t0)
    dt = best / reps
    return (len(cls) * 2) / dt / 1e9, total, which


def wwl_kernel_rate(m, cls: np.ndarray, reps: int = 8):
    """Device walk rate (GB/s of text) for the whole-word-longest engine.

    Times the production single-chip path — the scan-based engine
    (``scan_wwl.wwl_scan_walks``, one DFA gather per character) when
    applicable, else the compacted word-start walks — with the
    ac_kernel_rate methodology: data uploaded once, reps inside one jit
    with rolled inputs (CSE-proof).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from ahocorasick_tpu.models.matchers import _wwl_compact_lanes
    from ahocorasick_tpu.ops import scan_batched, scan_wwl

    # The ONE production lane setup (padding, bucketing, lane-0 rule) —
    # shared with WholeWordLongestMatchSet._device_triples.
    cls_p, starts, lanes, ws, d = _wwl_compact_lanes(m.compiled, cls)

    pure = scan_wwl.scan_applicable(m.compiled)
    if pure or scan_wwl.mixed_scan_applicable(m.compiled):
        reps = max(reps, -(-(64 << 20) // max(len(cls), 1)))
        sc = m.dev.wwl_scan if pure else m.dev.wwl_scan_mixed
        # Time the PRODUCTION pick (scan_walks_auto's switch): the fused-
        # carry kernel when applicable, else the plane-sweep kernel.
        fused = scan_wwl.FUSED_DEFAULT and scan_wwl.fused_applicable(sc, d)
        if fused:
            windows = scan_wwl.chunk_classes_overlap(
                cls_p, 512, d, d + 1, m.compiled.num_classes)
        else:
            windows = scan_batched.chunk_classes(cls_p, 512, d,
                                                 m.compiled.num_classes)
        wdev = jax.device_put(jnp.asarray(windows))
        sdev = jax.device_put(jnp.asarray(starts))

        @jax.jit
        def reps_scan(w, st):
            def one(i, tot):
                if fused:
                    outs = scan_wwl.wwl_scan_walks_fused(
                        sc.table, sc.outrows, jnp.roll(w, i, axis=0), st,
                        halo=d, id_bits=sc.id_bits,
                        depth_bits=sc.depth_bits,
                        num_classes=sc.num_classes, d=d,
                        row_layout=sc.row_layout, cross=not pure)
                else:
                    outs = scan_wwl.wwl_scan_walks(
                        sc.table, sc.rows_flat, sc.outrows,
                        jnp.roll(w, i, axis=0), st,
                        halo=d, id_bits=sc.id_bits,
                        depth_bits=sc.depth_bits,
                        num_classes=sc.num_classes, d=d,
                        row_layout=sc.row_layout, quotient=sc.quotient,
                        cross=not pure)
                return tot + jnp.sum(outs[1].astype(jnp.int32))

            return lax.fori_loop(0, reps, one, jnp.int32(0))

        reps_fn, args = reps_scan, (wdev, sdev)
    else:
        reps = max(reps, -(-(16 << 20) // max(len(cls), 1)))
        tables = (m.dev.trie_next, m.dev.own_len, m.dev.own_val,
                  m.dev.fail_len, m.dev.fail_off, m.dev.fail_val,
                  m.dev.class_is_word)
        cdev = jax.device_put(jnp.asarray(cls_p))
        sdev = jax.device_put(jnp.asarray(starts))

        @jax.jit
        def reps_walks(cp, st):
            def one(i, tot):
                _, has, _, _, _ = scan_wwl.wwl_walks_at(
                    *tables, cp, jnp.roll(st, i), d)
                return tot + jnp.sum(has.astype(jnp.int32))

            return lax.fori_loop(0, reps, one, jnp.int32(0))

        reps_fn, args = reps_walks, (cdev, sdev)

    float(reps_fn(*args))  # compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(reps_fn(*args))
        best = min(best, time.perf_counter() - t0)
    dt = best / reps
    return (len(cls) * 2) / dt / 1e9
