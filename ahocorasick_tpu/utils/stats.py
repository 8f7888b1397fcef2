"""Per-scan statistics and profiling hooks.

The reference's only observability is test-side ``System.out.println`` of
nanotimes (``SetTest.java:147-189``) plus blocking-stdin profiler attach in
each test's ``main()``.  Here every matcher records a :class:`ScanStats`
for its last run (``matcher.last_stats``), and ``trace()`` wraps
``jax.profiler`` for Perfetto/XProf captures of device scans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class ScanStats:
    units: int = 0  # UTF-16 units scanned
    matches: int = 0
    seconds: float = 0.0
    engine: str = ""  # "gold" | "device" | "sharded" | "stream"
    kind: str = ""

    @property
    def bytes_scanned(self) -> int:
        return self.units * 2

    @property
    def gbps(self) -> float:
        return self.bytes_scanned / self.seconds / 1e9 if self.seconds > 0 else 0.0

    @property
    def matches_per_sec(self) -> float:
        return self.matches / self.seconds if self.seconds > 0 else 0.0

    def __str__(self) -> str:
        return (
            f"ScanStats(kind={self.kind}, engine={self.engine}, "
            f"units={self.units}, matches={self.matches}, "
            f"{self.seconds * 1e3:.2f} ms, {self.gbps:.3f} GB/s)"
        )


@contextlib.contextmanager
def timed(stats: ScanStats):
    t0 = time.perf_counter()
    try:
        yield stats
    finally:
        stats.seconds = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace (view with XProf/Perfetto)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
