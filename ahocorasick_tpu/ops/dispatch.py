"""One engine dispatcher for the AC-family device scan paths.

``pick_engine`` (ops/scan_rowdfa) chooses the fastest applicable engine;
this module turns that choice into a concrete *plan* — the device tables to
pass through jit/shard_map boundaries, the chunker halo, and a kernel
closure over plain ``chunk_classes``-layout windows.  It exists so the four
former hand-rolled copies of the engine switch (matcher emit-planes path,
fused device count, bench kernel-rate harness, sharded counter) cannot
drift: adding an engine or changing a halo convention happens here once.

Window contract: every ``fn(tables, windows)`` takes ``int[B, halo + C]``
windows as built by ``scan_batched.chunk_classes(cls, chunk, plan.halo)``
(left halo warmup, PAD_CLASS padding).  ``chunk`` must be even (the
stride-2 engine pairs characters; 512 everywhere).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple


class EnginePlan(NamedTuple):
    which: str  # rowdfa2 | rowdfa1 | batched | split | packedcount | hotstate
    halo: int  # left-halo length for chunk_classes
    tables: Tuple  # device (jnp) arrays; pass back as fn(tables, windows)
    fn: Callable  # fn(tables, windows) -> int32 count | uint32[P, N] planes


def count_plan(compiled, dev, engine: Optional[str] = None) -> EnginePlan:
    """Plan for the fused COUNT kernels (popcount summed on device).

    ``engine`` names the engine to run instead of ``pick_engine``'s choice
    (the matchers' ``device_engine="batched"`` cross-check knob, and the
    bench harness's per-engine cost measurement)."""
    from ahocorasick_tpu.ops import scan_batched, scan_rowdfa

    A = compiled.num_classes
    which = engine or scan_rowdfa.pick_engine(compiled)
    if which == "rowdfa2":
        rd = dev.row_dfa
        fn = lambda tables, w: scan_rowdfa.rowdfa_count(
            tables[0], w, rd.halo, rd.state_bits, rd.num_classes)
        return EnginePlan("rowdfa2", rd.halo, (rd.table,), fn)
    if which == "rowdfa1":
        rd = dev.row_dfa1
        fn = lambda tables, w: scan_rowdfa.rowdfa1_count(
            tables[0], w, rd.halo, rd.state_bits, rd.num_classes)
        return EnginePlan("rowdfa1", rd.halo, (rd.table,), fn)
    if not scan_batched.inline_packable(compiled):
        if scan_batched.count_packable(compiled):
            # One gather per character: the emit COUNT rides the packed
            # entry even when the per-length mask cannot.
            flat, cp_bits, halo = dev.count_packed_dfa
            fn = lambda tables, w: scan_batched.packedcount_count(
                tables[0], w, halo, cp_bits, A)
            return EnginePlan("packedcount", halo, (flat,), fn)
        return _split_plan(compiled, dev, scan_batched.split_count)
    pd = dev.packed_dfa
    fn = lambda tables, w: scan_batched.batched_count(
        tables[0], w, pd.halo, pd.state_bits)
    return EnginePlan("batched", pd.halo, (pd.table,), fn)


def planes_plan(compiled, dev, engine: Optional[str] = None) -> EnginePlan:
    """Plan for the END-indexed emit-plane kernels (``uint32[P, N]`` bits);
    ``engine`` as in ``count_plan``."""
    from ahocorasick_tpu.ops import scan_batched, scan_rowdfa

    which = engine or scan_rowdfa.pick_engine(compiled)
    if which == "rowdfa2":
        rd = dev.row_dfa
        fn = lambda tables, w: scan_rowdfa.rowdfa_emit_planes(
            tables[0], w, rd.halo, rd.state_bits, rd.num_classes, 1)
        return EnginePlan("rowdfa2", rd.halo, (rd.table,), fn)
    if which == "rowdfa1":
        rd = dev.row_dfa1
        fn = lambda tables, w: scan_rowdfa.rowdfa1_emit_planes(
            tables[0], w, rd.halo, rd.state_bits, rd.num_classes)
        return EnginePlan("rowdfa1", rd.halo, (rd.table,), fn)
    if not scan_batched.inline_packable(compiled):
        if scan_batched.hotstate_layout(compiled):
            # Huge dictionary, count-packable: ONE gather per character;
            # output is the packed (state, count) plane, decoded host-side
            # by the same predicate (scan_batched.hotstate_layout).
            flat, cp_bits, halo = dev.count_packed_dfa
            A = compiled.num_classes
            fn = lambda tables, w: scan_batched.packedcount_hotstate_plane(
                tables[0], w, halo, cp_bits, A)
            return EnginePlan("hotstate", halo, (flat,), fn)
        # Packed layout overflows and counts don't fit either:
        # split path — one next-state gather + P emit gathers per char.
        return _split_plan(compiled, dev, scan_batched.split_emit_planes)
    pd = dev.packed_dfa
    fn = lambda tables, w: scan_batched.batched_emit_planes(
        tables[0], w, pd.halo, pd.state_bits, 1)
    return EnginePlan("batched", pd.halo, (pd.table,), fn)


def _split_plan(compiled, dev, kernel) -> EnginePlan:
    dfa_flat, emit_tab, halo = dev.split_dfa
    planes = (max(compiled.max_depth, 1) + 31) // 32
    fn = lambda tables, w: kernel(
        tables[0], tables[1], w, halo, compiled.num_classes, planes)
    return EnginePlan("split", halo, (dfa_flat, emit_tab), fn)
