"""Data-parallel sharded scanning over a device mesh.

The corpus is sharded across the ``data`` mesh axis; the compiled tables are
replicated (they are read-only and small next to the text).  Because PFAC
lanes read at most ``max_depth - 1`` characters past their own position, the
only cross-device dependency is a right-halo of ``max_depth`` classes,
exchanged on-device with ``lax.ppermute`` (NVLink between the cards of
one host) — no host gathers.  The
last shard's missing halo arrives as zeros, which is exactly ``PAD_CLASS``.

Counts reduce with ``psum``; bitplanes stay shard-local (out_spec sharded on
the lane axis) so variable-length match extraction never moves ragged data
across devices — global offsets are just shard offsets, mirroring the
reference's observation that matches are chunk-local once entry state is
known (``AhoCorasickMap.java:208-275``).

Across hosts the same code runs under ``jax.distributed`` with the mesh
spanning them.  Tests exercise the mesh on virtual CPU devices.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ahocorasick_tpu.core.compiler import CompiledMatcher



def data_mesh(devices=None, axis: str = "data") -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (axis,))


def _right_halo(cls_local: jax.Array, max_depth: int, axis: str, n_dev: int) -> jax.Array:
    """First ``max_depth`` classes of the right neighbor (zeros past the end)."""
    halo_src = lax.slice_in_dim(cls_local, 0, max_depth)
    # dest i receives from source i+1; the last device receives zeros.
    perm = [(i + 1, i) for i in range(n_dev - 1)]
    return lax.ppermute(halo_src, axis, perm)


def sharded_wwl_walks(
    matcher,
    cls: np.ndarray,
    mesh: Mesh,
):
    """Per-position whole-word-longest walk outcomes across the mesh.

    Every walk reads at most ``max_depth + 1`` classes past its own lane
    (``ops/scan_wwl.wwl_walks``), so the only cross-device dependency is a
    right halo exchanged with ``ppermute``; the last shard's halo arrives as zeros —
    exactly the non-word pad class the single-chip path uses.  Outcomes are
    returned in global coordinates as ``(die, has, ms, me, mv, cont)``;
    ``cont`` is None except on the truncated-closure (mixed-dictionary)
    scan, where True flags positions whose walk needs the full-trie host
    continuation (``scan_wwl.host_walks_at``).  The sequential restart
    chain is followed host-side (``resolve/wholeword.follow_chain``),
    mirroring the reference loop ``WholeWordLongestMatchSet.java:47-178``.
    """
    from ahocorasick_tpu.ops import scan_wwl

    m = matcher.compiled
    dev = matcher.dev
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    d = scan_wwl.bucket_depth(m.max_depth)  # bucketed like single-chip
    n = len(cls)

    pure = scan_wwl.scan_applicable(m)
    if pure or scan_wwl.mixed_scan_applicable(m):
        # Scan-based engine per shard (one DFA gather/char): a LEFT halo of
        # ``d`` classes makes the depth plane exact at every local position
        # (trie-prefix suffixes are <= d long — the same d-synchronization
        # as the AC engines; the truncated closure satisfies the same
        # argument), and a RIGHT halo of ``cw >= d+1`` covers walks dying
        # past the shard edge.  Also the ONLY sharded WWL path for
        # row-compressed dictionaries — uniform (quotient) or mixed.
        sc = dev.wwl_scan if pure else dev.wwl_scan_mixed
        n_out = 5 if pure else 6
        cw = _chunk_for(d + 1, 512)
        chunk = -(-max(n, 1) // (n_dev * cw)) * cw
        cls_p = np.pad(cls, (0, chunk * n_dev - n), constant_values=0)
        from ahocorasick_tpu.ops.scan_batched import class_dtype

        cls_dev = jnp.asarray(cls_p.astype(class_dtype(m.num_classes)))
        tabs = (sc.table, sc.outrows)
        if sc.rows_flat is not None:
            tabs = tabs + (sc.rows_flat,)
        # Cache the shard_map closure by (mesh, chunk): jax's trace cache
        # keys on function identity, so a fresh closure per call would
        # retrace/recompile every scan.  The dev table cache pins it for the
        # matcher's lifetime.
        key = ("wwl_shard_scan", pure, id(mesh), chunk)
        run_scan = dev._cache.get(key)
        if run_scan is None:
            tab_specs = tuple(P(*([None] * np.ndim(t))) for t in tabs)

            @functools.partial(
                shard_map,
                mesh=mesh,
                in_specs=tab_specs + (P(axis),),
                out_specs=(P(axis),) * n_out,
            )
            def run_scan(*args):
                cls_local = args[-1]
                table, outr = args[0], args[1]
                rows_flat = args[2] if sc.rows_flat is not None else None
                lh = _left_halo(cls_local, d, axis, n_dev)
                rh = _right_halo(cls_local, cw, axis, n_dev)
                region = jnp.concatenate([lh, cls_local, rh])
                windows = _windows_on_device(region, cw, d)
                outs = scan_wwl.wwl_scan_walks_all(
                    table, rows_flat, outr, windows,
                    halo=d, id_bits=sc.id_bits, depth_bits=sc.depth_bits,
                    num_classes=sc.num_classes, d=d, row_layout=sc.row_layout,
                    quotient=sc.quotient, n_keep=chunk, cross=not pure)
                die, has, ms, me, mv = outs[:5]
                off = lax.axis_index(axis) * cls_local.shape[0]
                res = (die + off, has, ms + off, me + off, mv)
                if not pure:
                    res = res + (outs[5],)
                return res

            dev._cache[key] = run_scan
        outs = run_scan(*tabs, cls_dev)
        outs = tuple(np.asarray(o)[:n] for o in outs)
        if pure:
            return outs + (None,)
        return outs

    chunk = max(-(-max(n, 1) // n_dev), d + 1)
    cls_p = np.pad(cls, (0, chunk * n_dev - n), constant_values=0)

    key = ("wwl_shard_walk", id(mesh), chunk)
    run = dev._cache.get(key)
    if run is None:
        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(
                P(None, None), P(None), P(None), P(None), P(None), P(None),
                P(None), P(axis),
            ),
            out_specs=(P(axis),) * 5,
        )
        def run(trie, ol, ov, fl, fo, fv, ciw, cls_local):
            halo = _right_halo(cls_local, d + 1, axis, n_dev)
            local = jnp.concatenate([cls_local, halo])
            die, has, ms, me, mv = scan_wwl.wwl_walks(
                trie, ol, ov, fl, fo, fv, ciw, local, d
            )
            off = lax.axis_index(axis) * cls_local.shape[0]
            return die + off, has, ms + off, me + off, mv

        dev._cache[key] = run
    outs = run(
        dev.trie_next, dev.own_len, dev.own_val, dev.fail_len, dev.fail_off,
        dev.fail_val, dev.class_is_word, jnp.asarray(cls_p.astype(np.int32)),
    )
    return tuple(np.asarray(o)[:n] for o in outs) + (None,)


def _left_halo(cls_local: jax.Array, halo: int, axis: str, n_dev: int) -> jax.Array:
    """Last ``halo`` classes of the left neighbor (zeros before the start)."""
    src = lax.slice_in_dim(cls_local, cls_local.shape[0] - halo, cls_local.shape[0])
    perm = [(i, i + 1) for i in range(n_dev - 1)]
    return lax.ppermute(src, axis, perm)


def _chunk_for(halo: int, chunk: int) -> int:
    """Window chunk length >= halo (multiples of the base chunk).

    The overlapped-window construction below requires halo <= chunk;
    split/hotstate-layout dictionaries can have halo (= max keyword
    length) beyond the 512 base, so the sharded builders widen the chunk
    instead of silently clamping the warmup."""
    return max(chunk, -(-halo // chunk) * chunk)


def _windows_on_device(cls_with_halo: jax.Array, chunk: int, halo: int) -> jax.Array:
    """(B, halo+chunk) overlapped windows from [halo | N_local] classes."""
    assert halo <= chunk, (halo, chunk)  # callers widen via _chunk_for
    n_local = cls_with_halo.shape[0] - halo
    B = n_local // chunk
    body = cls_with_halo[halo:].reshape(B, chunk)
    lefts = cls_with_halo[: B * chunk].reshape(B, chunk)[:, :halo]
    return jnp.concatenate([lefts, body], axis=1)


def sharded_arrival_states(
    table: jax.Array,  # int32[S(+pad), A] total transition function
    cls: np.ndarray,
    mesh: Mesh,
) -> np.ndarray:
    """Exact sequential arrival states across the mesh via sigma-stitching.

    Each device scans its shard once carrying all S entry-state lanes (the
    sigma map), the tiny (D, S) sigma set is all-gathered, each
    device folds its predecessors' maps to find its true entry state, then
    rescans its shard.  Exactly the stream-mode state-carry invariant
    (AhoCorasickMap.java:208-275) parallelized; suits small-to-medium S.
    Returns int32[len(cls)] arrival states (s_1..s_N of the flat scan).
    """
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    n = len(cls)
    chunk = -(-max(n, 1) // n_dev)
    # Class 0 never advances toward a match but does change state in a total
    # DFA; padding must therefore be sliced off by the caller — we pad with
    # class 0 and return only the first n states.
    cls_p = np.pad(cls, (0, chunk * n_dev - n), constant_values=0)
    S = table.shape[0]

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(P(None, None), P(axis)), out_specs=P(axis)
    )
    def run(tab, cls_local):
        def step_sigma(v, c):
            return tab[v, c], None

        # pcast: mark replicated initial carries as device-varying so the
        # scan carry types match (shard_map varying-axes discipline).
        v0 = lax.pcast(jnp.arange(S, dtype=jnp.int32), (axis,), to="varying")
        sigma, _ = lax.scan(step_sigma, v0, cls_local[0])
        sigmas = lax.all_gather(sigma, axis)  # (D, S)
        idx = lax.axis_index(axis)

        def fold(j, s):
            return jnp.where(j < idx, sigmas[j, s], s)

        entry = lax.fori_loop(
            0, n_dev, fold, lax.pcast(jnp.int32(0), (axis,), to="varying")
        )

        def step(s, c):
            s2 = tab[s, c]
            return s2, s2

        _, states = lax.scan(step, entry, cls_local[0])
        return states[None]

    out = run(table, jnp.asarray(cls_p.astype(np.int32)).reshape(n_dev, chunk))
    return np.asarray(out).reshape(-1)[:n]


def model_mesh(devices=None, axis: str = "model") -> Mesh:
    return data_mesh(devices, axis)


def dp_tp_mesh(devices=None, shape: Optional[Tuple[int, int]] = None,
               axes: Tuple[str, str] = ("data", "model")) -> Mesh:
    """2-D DP x TP mesh: text windows shard over ``data``, table rows over
    ``model`` (SURVEY §2.2 composition — the per-character ``psum`` rides
    only the model axis, so text replication is confined to a model group
    instead of the whole slice)."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if shape is None:
        n = devices.size
        shape = (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)
    return Mesh(devices.reshape(shape), axes)


def _table_sharded_run(
    packed_table: np.ndarray,  # uint32[S, A] packed rows
    cls: np.ndarray,
    halo: int,
    state_bits: int,
    mesh: Mesh,
    chunk: int,
    mode: str,  # count | count_packed | planes | hotstate
):
    """State-sharded (TP-analog) packed-DFA scan core: the TABLE is sharded
    over the mesh rows, the text replicated.

    SURVEY §2.2 "Table sharding": only needed when the packed table exceeds
    one device's memory.  Each device holds a contiguous row slice; per
    character every device gathers rows for the lanes whose state falls in
    its slice (others contribute the identity 0) and one ``psum`` combines
    the full packed value — one vector collective per character, so this
    trades collective latency for memory capacity and is slower than a
    replicated scan whenever the table fits (its cost on the card is not
    measured).  Data-parallel ``make_sharded_counter`` remains the fast
    path; the DP x TP composition lives in
    ``_table_sharded_build`` (2-axis mesh: windows shard over ``data``,
    rows over ``model``).

    Modes (payload = packed bits above ``state_bits``):
    ``count``        — payload is an emit mask; return its total popcount.
    ``count_packed`` — payload is an emit count; return its total sum.
    ``planes``       — return the END-indexed emit-mask plane uint32[1, N]
                       (same contract as ``batched_emit_planes``).
    ``hotstate``     — return the packed (state, count) word at positions
                       whose arrival state ends >= 1 keyword, 0 elsewhere
                       (same contract as ``packedcount_hotstate_plane``).
    """
    tab_dev, run, A = _table_sharded_build(
        packed_table, halo, state_bits, mesh, mode)
    from ahocorasick_tpu.ops import scan_batched

    windows = jnp.asarray(scan_batched.chunk_classes(cls, chunk, halo, A))
    return run(tab_dev, windows)


def _table_sharded_build(packed_table, halo, state_bits, mesh, mode):
    """(tab_dev, run, A): sharded table upload + jitted scan closure.

    Split from ``_table_sharded_run`` so ``TableShardedScanner`` caches
    both across calls — the scanner exists for tables at/above per-chip
    HBM, where a per-call re-upload/retrace would dominate everything.

    Meshes: a 1-axis mesh shards table rows over that axis and replicates
    the windows; a 2-axis ``(data, model)`` mesh additionally shards the
    WINDOWS over the leading ``data`` axis — the DP x TP composition.  The
    per-character combine is a ``psum`` over the model axis only, so text
    replication is confined to each model group and the output planes come
    back sharded over ``data`` in flat text order (windows tile the text
    contiguously and each carries its own left halo, so data shards need no
    halo exchange).

    Modes (payload = packed bits above ``state_bits``):
    ``count`` / ``count_packed`` / ``planes`` / ``hotstate`` — as on
    ``_table_sharded_run``; ``raw`` — return the full packed table word at
    EVERY position, uint32[1, N] (the whole-word-longest TP path: the die
    sweep over the (id, depth, word) plane runs host-side,
    ``ops.scan_wwl.host_walks_from_raw``).
    """
    axes = mesh.axis_names
    if len(axes) not in (1, 2):
        raise ValueError(f"table-sharded scan takes a 1- or 2-axis mesh, got {axes}")
    model_axis = axes[-1]
    data_axis = axes[0] if len(axes) == 2 else None
    n_model = int(mesh.shape[model_axis])
    S, A = packed_table.shape
    rows_per = -(-S // n_model)
    pad_rows = rows_per * n_model - S
    tab = np.pad(np.asarray(packed_table), ((0, pad_rows), (0, 0)))
    smask = jnp.uint32((1 << state_bits) - 1)
    sb = jnp.uint32(state_bits)

    from jax.sharding import NamedSharding

    tab_dev = jax.device_put(
        jnp.asarray(tab), NamedSharding(mesh, P(model_axis, None)))
    win_spec = P(data_axis, None) if data_axis else P(None, None)
    if mode in ("count", "count_packed"):
        out_spec = P()
    else:
        out_spec = P(None, data_axis) if data_axis else P(None, None)

    @jax.jit
    def run(tab, windows):
        @functools.partial(
            shard_map, mesh=mesh, in_specs=(P(model_axis, None), win_spec),
            out_specs=out_spec,
        )
        def body(tab_local, w):
            lo = (lax.axis_index(model_axis).astype(jnp.uint32)
                  * jnp.uint32(rows_per))

            def gather(s, c):
                rel = s - lo
                mine = rel < jnp.uint32(rows_per)
                rel = jnp.where(mine, rel, 0)
                rows = tab_local[rel]
                iota = lax.broadcasted_iota(jnp.int32, (1, A), 1)
                v = jnp.sum(
                    jnp.where(iota == c[:, None], rows, jnp.uint32(0)), axis=1
                )
                v = jnp.where(mine, v, jnp.uint32(0))
                return lax.psum(v, model_axis)

            def warm(s, c):
                return gather(s, c) & smask, None

            s0 = (w[:, 0] * 0).astype(jnp.uint32)
            s_h, _ = lax.scan(warm, s0, w[:, :halo].T)

            if mode in ("count", "count_packed"):
                def step(carry, c):
                    s, tot = carry
                    v = gather(s, c)
                    hi = v >> sb
                    d = (lax.population_count(hi) if mode == "count" else hi)
                    return (v & smask, tot + jnp.sum(d.astype(jnp.int32))), None

                tot0 = (w[0, 0] * 0).astype(jnp.int32)
                (_, total), _ = lax.scan(step, (s_h, tot0), w[:, halo:].T)
                if data_axis is not None:
                    total = lax.psum(total, data_axis)
                return total

            def step(s, c):
                v = gather(s, c)
                if mode == "planes":
                    out = v >> sb
                elif mode == "hotstate":
                    out = jnp.where((v >> sb) != 0, v, jnp.uint32(0))
                else:  # raw
                    out = v
                return v & smask, out

            _, outs = lax.scan(step, s_h, w[:, halo:].T)  # (C, B)
            return outs.T.reshape(1, -1)

        return body(tab, windows)

    return tab_dev, run, A


def sharded_table_count(
    packed_table: np.ndarray,  # uint32[S, A] packed next | emit << state_bits
    cls: np.ndarray,
    halo: int,
    state_bits: int,
    mesh: Mesh,
    chunk: int = 512,
) -> int:
    """State-sharded packed-DFA count (see ``_table_sharded_run``)."""
    return int(_table_sharded_run(
        packed_table, cls, halo, state_bits, mesh, chunk, "count"))


class TableShardedScanner:
    """State-sharded (TP-analog) scanner with the FULL match surface for
    ALL FIVE kinds.

    For dictionaries whose packed table exceeds per-chip HBM: the table is
    sharded over the mesh rows, and ``match_triples`` delivers every
    (start, end, value) span exactly as the reference's ``match`` does at
    any size — for every variant, not just plain AC
    (``AhoCorasickSet.java:193-252``, ``LongestMatchSet.java:211-232``,
    ``ShortestMatchSet.java:182-260``, ``WholeWordMatchSet.java:47-132``,
    ``WholeWordLongestMatchSet.java:47-178``).  Kind decomposition — the
    same candidates-then-resolve split the data-parallel ``ShardedScanner``
    uses, with the candidate scan state-sharded:

    * ``ac`` — packed-inline emit planes, or the hotstate (state, count)
      plane for huge dictionaries (masks recovered host-side);
    * ``longest`` — the AC candidate scan of its own packed table + the
      exact greedy resolve;
    * ``shortest`` — state-shards the internal AC over the insert-surviving
      keywords (``ShortestMatchSet._ac``) + the min-end resolve; artifacts
      without the AC sidecar fall back to the exact host cursor;
    * ``whole_word`` — AC candidate scan + the vectorized boundary filter;
    * ``whole_word_longest`` — state-shards the packed wwl-scan table in
      "raw" mode; the elementwise die sweep and the restart chain run
      host-side (``ops.scan_wwl.host_walks_from_raw``).

    Meshes: a 1-axis (model) mesh replicates the windows to every device; a
    2-axis ``("data", "model")`` mesh shards windows over ``data`` and
    table rows over ``model`` — the DP x TP composition (``dp_tp_mesh``),
    which confines text replication to each model group.
    """

    def __init__(self, matcher, mesh: Optional[Mesh] = None, chunk: int = 512):
        from ahocorasick_tpu.ops import scan_batched

        self.matcher = matcher
        self.m = matcher.compiled
        self.mesh = mesh if mesh is not None else model_mesh()
        if len(self.mesh.axis_names) not in (1, 2):
            raise ValueError(
                "TableShardedScanner takes a 1-axis (model) or 2-axis "
                f"(data, model) mesh, got axes {self.mesh.axis_names}")
        self.chunk = chunk
        self._built = {}  # mode -> (tab_dev, run, A)
        self._inner = None  # shortest: TP scanner over the internal AC
        self._wwl = None  # whole_word_longest: host WwlScan tables
        m = self.m
        if m.kind == "shortest":
            ac = getattr(matcher, "_ac", None)
            if ac is not None:
                self._inner = TableShardedScanner(ac, self.mesh, chunk)
                self.layout = "shortest"
            else:
                # from_compiled artifact without the AC sidecar: the exact
                # host cursor is the only remaining path (same fallback as
                # the data-parallel ShardedScanner).
                self.layout = "host"
            return
        if m.kind == "whole_word_longest":
            from ahocorasick_tpu.ops import scan_wwl

            # Reuse the matcher's dev-cached host tables: one (truncated-)
            # closure build serves the single-chip, DP and TP paths.
            if scan_wwl.scan_applicable(m):
                sc = matcher.dev.wwl_scan_host
            elif scan_wwl.mixed_scan_applicable(m):
                # Separator-spanning dictionary: truncated-closure tables;
                # crossing walks re-run on the sparse host walker.
                sc = matcher.dev.wwl_scan_mixed_host
            else:
                raise ValueError(
                    "whole-word-longest matcher has no packed scan table "
                    "(unpackable shape); no state-sharded path applies")
            self._wwl = sc
            self._table = (sc.table if sc.row_layout
                           else sc.table.reshape(-1, sc.num_classes))
            self._sb = sc.id_bits
            self._halo = sc.halo
            self.layout = "wwl"
            return
        if scan_batched.inline_packable(m):
            pd = scan_batched.build_packed(m)
            self._table = pd.table
            self._sb = pd.state_bits
            self._halo = pd.halo
            self.layout = "planes"
        elif scan_batched.count_packable(m):
            flat, sb, halo = scan_batched.build_count_packed(m)
            self._table = flat.reshape(m.num_states, m.num_classes)
            self._sb = sb
            self._halo = halo
            self.layout = "hotstate"
        else:
            raise ValueError(
                "matcher has neither a packed-inline nor a count-packed "
                "layout; no state-sharded scan applies")

    def _scan(self, cls: np.ndarray, mode: str):
        from ahocorasick_tpu.ops import scan_batched

        if mode not in self._built:
            self._built[mode] = _table_sharded_build(
                self._table, self._halo, self._sb, self.mesh, mode)
        tab_dev, run, A = self._built[mode]
        windows = scan_batched.chunk_classes(cls, self.chunk, self._halo, A)
        if len(self.mesh.axis_names) == 2:
            # Windows shard over the data axis: pad B up to a multiple of
            # its size with all-PAD windows (they scan class 0 from the
            # root — no emits; positions past the text are trimmed anyway).
            nd = int(self.mesh.shape[self.mesh.axis_names[0]])
            if windows.shape[0] % nd:
                pad = nd - windows.shape[0] % nd
                windows = np.concatenate(
                    [windows,
                     np.zeros((pad, windows.shape[1]), windows.dtype)])
        return run(tab_dev, jnp.asarray(windows))

    def count(self, text: str) -> int:
        if self.m.kind == "ac":
            cls = self.matcher._classes(text)
            mode = "count" if self.layout == "planes" else "count_packed"
            return int(self._scan(cls, mode))
        # Resolution / boundary filtering changes counts for the other kinds.
        return int(len(self.match_triples(text)[0]))

    def stream(self) -> "ShardedStream":
        """Streaming cursor whose per-chunk scans run state-sharded on the
        mesh (AC kind tail carry) — streaming for dictionaries beyond
        per-chip HBM (``AhoCorasickMap.java:208-275`` at any size)."""
        return ShardedStream(self)

    def match_triples(self, text: str):
        """(starts, ends, value_ids) in reference emission order."""
        return self.match_triples_classes(self.matcher._classes(text))

    def match_triples_classes(self, cls: np.ndarray):
        """``match_triples`` over a precomputed class array (the streaming
        cursor's entry point: feeds arrive as [tail | chunk])."""
        from ahocorasick_tpu.ops import scan_batched

        m = self.m
        if self.layout == "host":
            from ahocorasick_tpu.core.stream import make_cursor

            trip = make_cursor(m).feed(cls, is_final=True)
            return _triples_from_list(trip)
        if self.layout == "shortest":
            from ahocorasick_tpu.resolve.queue import resolve_shortest

            # The inner scanner scans its own charmap's classes (remap via
            # the matcher); positions are shared (same UTF-16 text).
            return resolve_shortest(*self._inner.match_triples_classes(
                self.matcher._ac_classes(cls)))
        if self.layout == "wwl":
            from ahocorasick_tpu.ops import scan_wwl
            from ahocorasick_tpu.resolve.wholeword import (
                follow_chain, word_starts,
            )

            n = len(cls)
            if n == 0:
                return _triples_from_list([])
            sc = self._wwl
            d = sc.halo
            # The die sweep reads d+1 positions past each start: pad so the
            # raw plane covers them (PAD class 0 = non-word dead end).
            cls_p = np.pad(cls, (0, d + 1))
            raw = np.asarray(self._scan(cls_p, "raw"))[0]
            outs = scan_wwl.host_walks_from_raw(sc, raw, cls_p, n)
            die, has, ms, me, mv = outs[:5]
            is_word = np.asarray(m.class_is_word)[cls]
            ws = word_starts(is_word)
            if sc.has_cross:
                lanes = scan_wwl.chain_lanes(ws, n)
                need = lanes[outs[5][lanes]]
                scan_wwl.apply_crossing_fixes(m, cls_p, d,
                                              (die, has, ms, me, mv),
                                              need, need)
            trip = follow_chain(die, has, ms, me, mv, ws, n)
            return _triples_from_list(trip)
        bits = self._scan(cls, self.layout)
        triples = scan_batched.ac_matches_batched(
            m, cls, np.asarray(bits), layout=self.layout)
        if m.kind == "longest":
            from ahocorasick_tpu.resolve.queue import resolve_longest

            return resolve_longest(*triples)
        if m.kind == "whole_word":
            from ahocorasick_tpu.resolve.wholeword import boundary_filter

            return boundary_filter(m.class_is_word, cls, *triples)
        return triples


def _triples_from_list(trip):
    if not trip:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), z.copy()
    a = np.asarray(trip, dtype=np.int64)
    return a[:, 0], a[:, 1], a[:, 2]


def make_sharded_counter(matcher, mesh: Mesh, chunk: int = 512):
    """Best-engine data-parallel match counter over ``mesh``.

    Dispatches inside ``shard_map`` to the same engine ``pick_engine``
    chooses single-chip (rowdfa2 / rowdfa1 / batched / split), with
    the left halo exchanged with ``ppermute``.  Returns ``(prepare, count, engine)``:
    ``prepare(cls)`` pads and device-puts the class array with the mesh
    sharding (upload once), ``count(x, reps)`` is a jitted all-device
    reduction running ``reps`` scans on-device (for benchmarking;
    ``reps=1`` for real use).  Used by ``--scaling`` in the bench CLI.
    """
    from jax.sharding import NamedSharding

    from ahocorasick_tpu.ops import dispatch, scan_batched

    m = matcher.compiled
    if m.is_row_compressed and not scan_batched.quotient_packable(m):
        raise ValueError(
            "row-compressed (wide-alphabet) matcher has no packed quotient "
            "device layout; use the host path or parallel.corpus.scan_corpus"
        )
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    # One shared engine switch (ops/dispatch.py): the same plan the
    # single-chip count and the bench kernel-rate harness run.
    plan = dispatch.count_plan(m, matcher.dev)
    which, halo, kernel = plan.which, plan.halo, plan.fn
    chunk = _chunk_for(halo, chunk)

    def prepare(cls: np.ndarray):
        n = len(cls)
        per = -(-max(n, 1) // (n_dev * chunk)) * chunk
        cls_p = np.pad(cls, (0, per * n_dev - n),
                       constant_values=scan_batched.PAD_CLASS)
        # Narrow class upload (uint8/uint16); engines widen on device.
        dt = scan_batched.class_dtype(m.num_classes)
        return jax.device_put(
            jnp.asarray(cls_p.astype(dt)),
            NamedSharding(mesh, P(axis)),
        )

    table_specs = tuple(P(*([None] * np.ndim(t))) for t in plan.tables)

    @functools.partial(jax.jit, static_argnames=("reps",))
    def _count(tables, cls_dev, reps: int = 1):
        @functools.partial(
            shard_map, mesh=mesh, in_specs=(table_specs, P(axis)),
            out_specs=P(),
            # The engines' scan carries start from replicated constants; the
            # reduction is explicitly psum'd below, so skipping the
            # varying-axes check is sound.
            check_vma=False,
        )
        def run(tables, cls_local):
            hl = _left_halo(cls_local, halo, axis, n_dev)
            windows = _windows_on_device(
                jnp.concatenate([hl, cls_local]), chunk, halo)

            def one(i, tot):
                wi = jnp.roll(windows, i, axis=0)
                return tot + kernel(tables, wi)

            return lax.psum(lax.fori_loop(0, reps, one, jnp.int32(0)), axis)

        return run(tables, cls_dev)

    def count(cls_dev, reps: int = 1):
        # Tables travel as jit ARGUMENTS, not closure constants: a 1M-
        # keyword count-packed table is ~0.5 GB and must not be baked
        # into the executable.
        return _count(plan.tables, cls_dev, reps=reps)

    return prepare, count, which


def make_sharded_planes(matcher, mesh: Mesh, chunk: int = 512):
    """Plan-driven sharded emit-plane scan: ``(fn, which)`` where
    ``fn(cls) -> np.ndarray[P, N_padded]``.

    Same structure as ``make_sharded_counter`` but for the planes plans —
    every engine the dispatcher can pick (rowdfa / batched / split
    / hotstate) runs under ``shard_map`` with the halo ppermute, so huge
    dictionaries (split/hotstate layouts) shard-scan at their single-chip
    engine rate instead of falling back to the trie walk.  ``which`` tells
    the caller how to decode (``"hotstate"`` = packed (state, count) plane,
    else END-indexed emit planes).
    """
    from ahocorasick_tpu.ops import dispatch, scan_batched

    m = matcher.compiled
    plan = dispatch.planes_plan(m, matcher.dev)
    which, halo, kernel = plan.which, plan.halo, plan.fn
    chunk = _chunk_for(halo, chunk)
    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size

    table_specs = tuple(P(*([None] * np.ndim(t))) for t in plan.tables)

    @jax.jit
    def run_all(tables, cls_dev):
        @functools.partial(
            shard_map, mesh=mesh, in_specs=(table_specs, P(axis)),
            out_specs=P(None, axis), check_vma=False,
        )
        def run(tables, cls_local):
            hl = _left_halo(cls_local, halo, axis, n_dev)
            windows = _windows_on_device(
                jnp.concatenate([hl, cls_local]), chunk, halo)
            return kernel(tables, windows)

        return run(tables, cls_dev)

    def fn(cls: np.ndarray) -> np.ndarray:
        from jax.sharding import NamedSharding

        n = len(cls)
        per = -(-max(n, 1) // (n_dev * chunk)) * chunk
        cls_p = np.pad(cls, (0, per * n_dev - n),
                       constant_values=scan_batched.PAD_CLASS)
        # Narrow class upload (uint8/uint16); engines widen on device.
        cls_dev = jax.device_put(
            jnp.asarray(cls_p.astype(scan_batched.class_dtype(m.num_classes))),
            NamedSharding(mesh, P(axis)))
        return np.asarray(run_all(plan.tables, cls_dev))

    return fn, which, chunk


class ShardedScanner:
    """Data-parallel façade over a compiled AC-kind matcher.

    ``count`` is an all-device reduction; ``match_triples`` extracts exact
    global triples from shard-local bitplanes.
    """

    def __init__(self, matcher, mesh: Optional[Mesh] = None):
        from ahocorasick_tpu.models.matchers import _device_capable

        m = matcher.compiled
        if not _device_capable(m, m.kind):
            raise ValueError(
                "row-compressed (wide-alphabet) matcher has no sharded "
                "device path for this kind; scan on the host path "
                "(matcher.match) or shard the corpus with "
                "parallel.corpus.scan_corpus"
            )
        self.matcher = matcher
        self.mesh = mesh if mesh is not None else data_mesh()
        self._inner = None  # shortest: lazy scanner over the internal AC
        self._counter = None  # lazy plan-driven sharded count closures
        self._planes = None  # lazy plan-driven sharded planes closures

    def _shard_boundaries(self, n: int, chunk: int = 512):
        """Per-device shard cut positions in text coordinates (the same
        split ``make_sharded_planes`` uses) — the resolve stitch points."""
        n_dev = self.mesh.devices.size
        per = -(-max(n, 1) // (n_dev * chunk)) * chunk
        return [per * i for i in range(1, n_dev)]

    def count(self, text: str) -> int:
        cls = self.matcher._classes(text)
        m = self.matcher.compiled
        if m.kind == "ac":
            # Plan-driven: the same dispatcher switch as single-chip —
            # covers packed/batched, rowdfa, AND the huge-dictionary
            # packedcount layout (previously only packed-inline dicts had a
            # fused sharded count; 1M-keyword dicts fell to the trie walk).
            if self._counter is None:
                self._counter = make_sharded_counter(self.matcher, self.mesh)
            prepare, count, _ = self._counter
            return int(count(prepare(cls), reps=1))
        if m.kind in ("longest", "shortest", "whole_word", "whole_word_longest"):
            # Counting needs the resolved/filtered match set for these kinds
            # (non-overlap resolution and boundary filtering change counts).
            return len(self.match_triples(text)[0])
        raise AssertionError(f"unhandled kind {m.kind!r}")  # all 5 return above

    def stream(self) -> "ShardedStream":
        """Streaming cursor whose per-chunk scans run on the mesh (AC kind:
        the d-synchronizing tail carry, ``AhoCorasickMap.java:208-275``)."""
        return ShardedStream(self)

    def match_triples(self, text: str):
        return self.match_triples_classes(self.matcher._classes(text))

    def match_triples_classes(self, cls: np.ndarray):
        """``match_triples`` over a precomputed class array (the sharded
        streaming cursor's entry point: feeds arrive as [tail | chunk])."""
        m = self.matcher.compiled
        if m.kind == "shortest":
            # Candidates-then-resolve: shard-scan the internal AC automaton
            # over the insert-surviving keywords with the standard batched
            # engines, then the exact min-end greedy resolve
            # (resolve.queue.resolve_shortest).  Matchers without a keyword
            # source (from_compiled artifacts) use the exact host cursor.
            from ahocorasick_tpu.models.matchers import _device_capable

            ac = getattr(self.matcher, "_ac", None)
            if ac is not None and _device_capable(ac.compiled, "ac"):
                if self._inner is None:
                    self._inner = ShardedScanner(ac, self.mesh)
                from ahocorasick_tpu.resolve.parallel import (
                    resolve_shortest_sharded,
                )

                # The internal AC sees the same UTF-16 unit count (classes
                # differ, positions don't — matcher._ac_classes remaps), so
                # the shard cuts follow the INNER scanner's planes chunk.
                inner_trip = self._inner.match_triples_classes(
                    self.matcher._ac_classes(cls))
                if self._inner._planes is not None:
                    inner_chunk = self._inner._planes[2]
                else:  # host-cursor path: boundaries are irrelevant
                    inner_chunk = 512
                return resolve_shortest_sharded(
                    *inner_trip,
                    boundaries=self._shard_boundaries(len(cls), inner_chunk),
                    max_depth=ac.compiled.max_depth,
                )
            from ahocorasick_tpu.core.stream import make_cursor

            trip = make_cursor(m).feed(cls, is_final=True)
            if not trip:
                z = np.zeros(0, dtype=np.int64)
                return z, z, z.copy()
            a = np.asarray(trip, dtype=np.int64)
            return a[:, 0], a[:, 1], a[:, 2]
        if m.kind == "whole_word_longest":
            from ahocorasick_tpu.resolve.wholeword import follow_chain, word_starts

            die, has, ms, me, mv, cont = sharded_wwl_walks(
                self.matcher, cls, self.mesh)
            is_word = np.asarray(m.class_is_word)[cls]
            ws = word_starts(is_word)
            if cont is not None:
                # Mixed dictionary: re-run walks whose die char crossed into
                # the truncated region, at the positions the restart chain
                # can consume — sparse host walks.
                from ahocorasick_tpu.ops import scan_wwl

                d = scan_wwl.bucket_depth(m.max_depth)
                lanes = scan_wwl.chain_lanes(ws, len(cls))
                need = lanes[cont[lanes]]
                die, has, ms, me, mv = (np.array(a) for a in
                                        (die, has, ms, me, mv))
                scan_wwl.apply_crossing_fixes(
                    m, np.pad(cls, (0, d + 1)), d, (die, has, ms, me, mv),
                    need, need)
            trip = follow_chain(die, has, ms, me, mv, ws, len(cls))
            if not trip:
                z = np.zeros(0, dtype=np.int64)
                return z, z, z.copy()
            a = np.asarray(trip, dtype=np.int64)
            return a[:, 0], a[:, 1], a[:, 2]
        from ahocorasick_tpu.ops import scan_batched

        # Plan-driven sharded scan: the dispatcher's picked engine (rowdfa /
        # batched / split / hotstate) runs under shard_map with the
        # halo ppermute, so every dictionary size shard-scans at its
        # single-chip engine rate.
        if self._planes is None:
            self._planes = make_sharded_planes(self.matcher, self.mesh)
        fn, which, planes_chunk = self._planes
        bits = fn(cls)
        layout = "hotstate" if which == "hotstate" else "planes"
        triples = scan_batched.ac_matches_batched(m, cls, bits, layout=layout)
        if m.kind == "longest":
            # Shard-parallel resolve: each shard's candidates resolve
            # locally (in a pod, on their own host) and the boundary
            # (anchor, tail) stitch repairs interactions exactly —
            # replaces the round-2 single-host global resolver funnel
            # (resolve/parallel.py; SetMatchQueue.java:45-95 semantics).
            from ahocorasick_tpu.resolve.parallel import resolve_longest_sharded

            return resolve_longest_sharded(
                *triples,
                boundaries=self._shard_boundaries(len(cls), planes_chunk),
                max_depth=m.max_depth,
            )
        if m.kind == "whole_word":
            # Boundary filter over AC candidates — the same equivalence the
            # single-chip device path uses (resolve/wholeword.boundary_filter;
            # WholeWordMatchSet.java:47-132).
            from ahocorasick_tpu.resolve.wholeword import boundary_filter

            return boundary_filter(m.class_is_word, cls, *triples)
        return triples


class ShardedStream:
    """Streaming cursor whose per-chunk scans run on the mesh.

    The same d-synchronizing tail-carry invariant as the single-chip cursor
    (``core/stream._DfaCursor``; reference stream carry
    ``AhoCorasickMap.java:208-275``): the last ``max_depth`` classes replay
    as the next feed's left context, and candidates ending inside the tail
    region (already delivered last feed) are dropped — so an unbounded
    stream scans chunk-at-a-time with exact global offsets at any chunking.
    Wraps either mesh scanner: data-parallel ``ShardedScanner`` (full mesh
    width per chunk) or state-sharded ``TableShardedScanner`` (streaming
    for dictionaries beyond per-chip HBM).
    """

    def __init__(self, scanner):
        m = scanner.matcher.compiled
        if m.kind != "ac":
            # The ONE gate for both scanners' stream() fronts.
            raise ValueError(
                "sharded streaming carries the AC tail invariant; use the "
                "matcher's own stream() for the resolved/filtered kinds")
        self.scanner = scanner
        self.halo = max(m.max_depth, 1)
        self.tail = np.zeros(0, dtype=np.int32)
        self.off = 0  # global index of the next unit

    def feed(self, text: str, is_final: bool = False):
        """New matches this feed as GLOBAL (starts, ends, value_ids)."""
        cls = self.scanner.matcher._classes(text)
        if len(cls) == 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        buf = np.concatenate([self.tail, cls]) if len(self.tail) else cls
        off0 = self.off - len(self.tail)
        starts, ends, vals = self.scanner.match_triples_classes(buf)
        keep_after = self.off - off0
        if keep_after > 0:
            keep = ends > keep_after
            starts, ends, vals = starts[keep], ends[keep], vals[keep]
        self.off += len(cls)
        keep_tail = min(len(buf), self.halo)
        self.tail = np.asarray(buf[len(buf) - keep_tail:], dtype=np.int32)
        return starts + off0, ends + off0, vals

    def state_dict(self) -> dict:
        return {"tail": self.tail.tolist(), "off": int(self.off)}

    def load_state_dict(self, d: dict) -> None:
        self.tail = np.asarray(d["tail"], dtype=np.int32)
        self.off = int(d["off"])
