"""Engine measurements on one GPU: the numbers behind ``pick_engine``.

    python tools/engine_costs.py [--out build/engine_costs.jsonl]

Prints one JSON line per measurement (and appends it to ``--out``), each
with the card's name and power limit:

* ``cost``: per-character kernel cost (``bench.ac_kernel_rate``, data on
  the device, reps inside one jit) for every AC engine at three
  dictionary sizes: 100, 10k (the headline) and 100k keywords.
* ``select``: the same for alphabets of 64 to 512 classes (the row
  engines' one-hot select grows with the alphabet).
* ``wwl``: the WWL fused-carry kernel against the plane sweep at BASELINE
  #4 widths, and the row table layout against the flat one at BASELINE #4
  and with 100k keywords.

Exits non-zero when JAX's first device is not a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

MI = 1 << 20


def run_costs(emit, label, m, text, engines):
    """``engines`` are forced whether or not their size gate admits the
    dictionary; the packed-inline ones are skipped where it does not fit
    (that layout is what they scan)."""
    from ahocorasick_tpu.bench import ac_kernel_rate
    from ahocorasick_tpu.ops import scan_batched

    c = m.compiled
    if not scan_batched.inline_packable(c):
        engines = [e for e in engines if e == "batched"]
    cls = m._classes(text)
    for eng in engines:
        gbps, total, which = ac_kernel_rate(m, cls, reps=4, engine=eng)
        emit({"what": "cost", "config": label, "engine": which,
              "states": int(c.num_states), "classes": int(c.num_classes),
              "packed_table_bytes": int(
                  scan_batched.effective_rows(c) * c.num_classes * 4),
              "units": len(cls), "count": total, "kernel_gbps": gbps,
              "ns_per_char": 2.0 / gbps})


def run_wwl(emit, label, text, kws, wc, fused=(False, True, True, False),
            flat=(True, False, False, True)):
    """Turns of the fused-carry kernel against the sweep, then of the flat
    table layout against the row layout."""
    import ahocorasick_tpu as ac
    from ahocorasick_tpu.bench import wwl_kernel_rate
    from ahocorasick_tpu.ops import scan_wwl

    default, gate = scan_wwl.FUSED_DEFAULT, scan_wwl._ROW_MAX_CLASSES

    def one(**rec):
        m = ac.WholeWordLongestMatchSet(kws, word_chars=wc)
        sc = m.dev.wwl_scan
        gbps = wwl_kernel_rate(m, m._classes(text), reps=4)
        emit({"what": "wwl", "config": label, **rec,
              "row_layout": sc.row_layout, "table_bytes": int(sc.table.nbytes),
              "units": len(text), "kernel_gbps": gbps})

    try:
        for f in fused:
            scan_wwl.FUSED_DEFAULT = f
            one(variant="fused" if f else "sweep")
        scan_wwl.FUSED_DEFAULT = default
        for fl in flat:
            scan_wwl._ROW_MAX_CLASSES = 0 if fl else gate
            one(variant="fused" if default else "sweep")
    finally:
        scan_wwl.FUSED_DEFAULT, scan_wwl._ROW_MAX_CLASSES = default, gate


def wide_alphabet(rng, n_classes: int, n_units: int):
    """Keywords (4-grams of a shuffled alphabet, so every character is in a
    keyword and the dictionary has ``n_classes`` classes) and text over
    ``n_classes - 1`` CJK characters plus space."""
    chars = rng.permutation(
        np.array([chr(0x4E00 + i) for i in range(n_classes - 1)]))
    kws = sorted({"".join(chars[i:i + 4]) for i in range(0, len(chars) - 3, 2)})
    base = rng.integers(0, n_classes - 1, size=MI)
    base[rng.random(MI) < 0.15] = -1
    text = "".join(np.append(chars, " ")[base].tolist())
    return kws, (text * (n_units // MI + 1))[:n_units]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(
        ROOT, "build", "engine_costs.jsonl"))
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)

    from ahocorasick_tpu.utils import compile_cache

    compile_cache.configure()
    import jax

    import ahocorasick_tpu as ac

    if jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {jax.devices()[0]}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    def emit(rec):
        rec = {**rec, "card": card}
        line = json.dumps(rec)
        print(line, flush=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")

    rng = np.random.default_rng(args.seed)
    engines = ("batched", "rowdfa1", "rowdfa2")
    for n_kw in (100, 10_000, 100_000):
        kws = chip_smoke.random_words(rng, n_kw)
        m = ac.AhoCorasickSet(kws)
        run_costs(emit, f"set-{n_kw}", m, chip_smoke.soup(rng, kws, 32 * MI),
                  engines if n_kw < 100_000 else engines[:2])

    for n_classes in (64, 128, 256, 512):
        kws, text = wide_alphabet(rng, n_classes, 32 * MI)
        m = ac.AhoCorasickSet(kws)
        run_costs(emit, f"select-{m.compiled.num_classes}", m, text, engines)

    wc = chip_smoke._word_chars()
    kws4 = chip_smoke.random_words(rng, 1000) + ["naïve", "can't", "übermäßig"]
    run_wwl(emit, "baseline-4", chip_smoke.soup(rng, kws4, 4 * MI), kws4, wc)
    big = chip_smoke.random_words(rng, 100_000)
    run_wwl(emit, "wwl-100k", chip_smoke.soup(rng, big, 4 * MI), big, wc,
            fused=())


if __name__ == "__main__":
    main()
