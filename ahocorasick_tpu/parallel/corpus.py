"""Batch corpus scanning: many documents, device batching, idempotent retry.

The reference is a synchronous single-call library; its failure story is
"exceptions propagate" (SURVEY.md §5).  At device scale the unit of failure is
a document shard, and because matchers are pure functions of (tables, text),
the correct recovery is simply to re-scan the failed shard — implemented
here as bounded idempotent retries with the gold engine as the terminal
fallback (it shares no device state with the failing path).

``scan_corpus`` returns per-document match lists in input order plus a
:class:`CorpusStats`; document offsets are the caller's business (documents
are independent — unlike one long stream, there is nothing to stitch).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CorpusStats:
    documents: int = 0
    units: int = 0
    matches: int = 0
    seconds: float = 0.0
    retries: int = 0
    gold_fallbacks: int = 0

    @property
    def gbps(self) -> float:
        return self.units * 2 / self.seconds / 1e9 if self.seconds > 0 else 0.0


def scan_corpus(
    matcher,
    documents: Sequence[str],
    max_retries: int = 2,
    on_result: Optional[Callable[[int, list], None]] = None,
) -> tuple:
    """Scan each document; returns (list of per-doc match lists, CorpusStats).

    Retries a failed document up to ``max_retries`` times on the configured
    engine, then falls back to the sequential gold engine; only raises if
    even the fallback fails.  ``on_result(doc_index, matches)`` streams
    results as they complete.
    """
    from ahocorasick_tpu.core import gold

    stats = CorpusStats(documents=len(documents))
    out: List[list] = []
    t0 = time.perf_counter()
    for i, doc in enumerate(documents):
        # UTF-16 units, matching the package's ScanStats/offset contract
        # (astral code points count 2).  ASCII fast path: the per-char
        # Python loop runs at ~tens of MB/s and would otherwise sit inside
        # the timed region distorting gbps on large ASCII corpora (review
        # finding r5); non-ASCII documents pay one C-speed scan + the loop.
        if doc.isascii():
            stats.units += len(doc)
        else:
            stats.units += len(doc) + sum(1 for ch in doc if ord(ch) > 0xFFFF)
        matches = None
        err = None
        for attempt in range(max_retries + 1):
            try:
                matches = matcher.match(doc)
                break
            except KeyboardInterrupt:
                raise
            except Exception as e:  # idempotent: just re-scan
                err = e
                if attempt < max_retries:
                    stats.retries += 1  # the LAST failure retries nowhere
        if matches is None:
            try:
                trip = gold.gold_match(matcher.compiled, doc)
                values = matcher.compiled.values
                if matcher.is_map:
                    matches = [(s, e, values[v]) for s, e, v in trip]
                else:
                    matches = [(s, e) for s, e, _ in trip]
                stats.gold_fallbacks += 1
            except Exception:
                raise err
        stats.matches += len(matches)
        out.append(matches)
        if on_result is not None:
            on_result(i, matches)
    stats.seconds = time.perf_counter() - t0
    return out, stats
