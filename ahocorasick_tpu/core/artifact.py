"""Compiled-automaton artifacts: save/load, plus resumable scan cursors.

The reference has no persistence — matchers are rebuilt from the keyword
iterable every process start (README.md:29 advertises memory-frugal keyword
streaming instead).  For accelerator-scale dictionaries that is the wrong
trade: a
1M-keyword compile produces ~GBs of tables and takes minutes, so the
compiled artifact is saved once and mapped thereafter.

Format: a single ``.npz`` (numpy archive) holding every table plus a JSON
header; map values are stored as JSON when possible, else pickled only when
``allow_pickle=True`` is passed at *load* time (the flag gates reading, not
writing, mirroring numpy's own posture).

Resumable scans: ``StreamScanner`` cursors expose ``state_dict() /
load_state_dict()`` — the stream analog of the reference's observation that
cross-chunk state is one node pointer (``AhoCorasickMap.java:208-275``);
here it is (state id, global offset, pending queue / tail), JSON-safe.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pickle
from typing import Optional

import numpy as np

from ahocorasick_tpu.core.compiler import CompiledMatcher, RowTable

FORMAT_VERSION = 1

_META_FIELDS = ("kind", "case_sensitive", "num_states", "num_classes", "max_depth")


def save(m: CompiledMatcher, path, *, ac: Optional[CompiledMatcher] = None) -> None:
    """Write a compiled matcher to ``path`` (.npz).

    ``ac``: an auxiliary automaton bundled INTO the same npz (the shortest
    kind's internal AC over the insert-surviving keywords,
    ``ShortestMatchSet.java:23-42`` — re-derivable state that must survive
    persistence).  One file, any path-like or file-like target; pre-round-4
    saves used a ``<path>.ac`` sidecar, which ``load_with_ac`` still reads.
    """
    arrays = {}
    if ac is not None:
        arrays["__ac__"] = np.frombuffer(save_bytes(ac), dtype=np.uint8)
    for f in dataclasses.fields(m):
        v = getattr(m, f.name)
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        elif isinstance(v, RowTable):
            # Row-compressed tables persist as their two component arrays.
            arrays[f.name + "__rows"] = v.rows
            arrays[f.name + "__rowid"] = v.row_id
    meta = {name: getattr(m, name) for name in _META_FIELDS}
    meta["format_version"] = FORMAT_VERSION
    meta["has_values"] = m.values is not None
    values_json = None
    values_pickle = None
    if m.values is not None:
        try:
            values_json = json.dumps(m.values)
            # JSON must round-trip FAITHFULLY, not merely serialize: tuples
            # become lists and non-string dict keys become strings, which
            # would silently hand a loaded matcher different value objects
            # than the compiled one.  Such values take the pickle path.
            if json.loads(values_json) != m.values:
                values_json = None
        except (TypeError, ValueError):
            pass
        if values_json is None:
            values_pickle = pickle.dumps(m.values, protocol=4)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    if values_json is not None:
        arrays["__values_json__"] = np.frombuffer(values_json.encode(), dtype=np.uint8)
    if values_pickle is not None:
        arrays["__values_pickle__"] = np.frombuffer(values_pickle, dtype=np.uint8)
    if isinstance(path, (str, bytes)) or hasattr(path, "__fspath__"):
        # np.savez appends ".npz" to extension-less paths; open the file
        # ourselves so save(p) / load(p) round-trips for ANY path.
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)
    else:
        np.savez(path, **arrays)


def load(path, allow_pickle: bool = False) -> CompiledMatcher:
    """Load a compiled matcher saved by :func:`save`.

    ``allow_pickle`` must be True to load artifacts whose map values were
    not JSON-serializable (pickle deserialization runs arbitrary code; only
    enable for artifacts you produced).
    """
    return _load_impl(path, allow_pickle)[0]


def load_with_ac(path, allow_pickle: bool = False):
    """Load a matcher artifact plus its bundled auxiliary AC automaton.

    Returns ``(matcher, ac_or_None)``.  ``ac`` is the shortest kind's
    internal survivors-AC bundled by ``save(..., ac=...)``; absent in
    artifacts of other kinds and in pre-round-4 saves (which used a
    ``<path>.ac`` sidecar — the caller handles that legacy lookup).
    """
    return _load_impl(path, allow_pickle, want_ac=True)


def _load_impl(path, allow_pickle: bool, want_ac: bool = False):
    with np.load(path, allow_pickle=False) as z:
        ac = None
        if want_ac and "__ac__" in z.files:
            ac = load_bytes(bytes(z["__ac__"]), allow_pickle=allow_pickle)
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported artifact version {meta.get('format_version')}")
        values = None
        if meta["has_values"]:
            if "__values_json__" in z.files:
                values = json.loads(bytes(z["__values_json__"]).decode())
            elif "__values_pickle__" in z.files:
                if not allow_pickle:
                    raise ValueError(
                        "artifact stores pickled values; pass allow_pickle=True "
                        "to load (only for artifacts you trust)"
                    )
                values = pickle.loads(bytes(z["__values_pickle__"]))
        kwargs = {}
        for f in dataclasses.fields(CompiledMatcher):
            if f.name in _META_FIELDS:
                kwargs[f.name] = meta[f.name]
            elif f.name == "values":
                kwargs[f.name] = values
            elif f.name in z.files:
                kwargs[f.name] = z[f.name]
            elif f.name + "__rows" in z.files:
                kwargs[f.name] = RowTable(z[f.name + "__rows"], z[f.name + "__rowid"])
            else:
                kwargs[f.name] = None
        return CompiledMatcher(**kwargs), ac


def save_bytes(m: CompiledMatcher) -> bytes:
    buf = io.BytesIO()
    save(m, buf)
    return buf.getvalue()


def load_bytes(data: bytes, allow_pickle: bool = False) -> CompiledMatcher:
    return load(io.BytesIO(data), allow_pickle=allow_pickle)
