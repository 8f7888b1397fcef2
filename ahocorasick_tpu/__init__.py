"""ahocorasick_tpu — multi-pattern string matching on JAX accelerators.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
RokLenarcic/AhoCorasick Java library: Aho-Corasick all-matches,
leftmost-longest, leftmost-shortest and whole-word multi-keyword search,
compiled host-side into dense tables and executed as data-parallel scans on
an NVIDIA GPU (or JAX's CPU backend), sharded across device meshes for
large corpora.

Multi-chip surfaces live in ``ahocorasick_tpu.parallel.sharding``
(``ShardedScanner`` — data-parallel; ``TableShardedScanner`` —
state-sharded for beyond-HBM dictionaries; ``dp_tp_mesh`` — the 2-D
composition; both scanners stream via ``.stream()``).  They are not
re-exported here on purpose: importing them pulls in jax eagerly, while
the compile-only surface above stays importable without a device runtime.
"""

from ahocorasick_tpu.core.compiler import CompiledMatcher, compile_matcher
from ahocorasick_tpu.models.matchers import (
    AhoCorasickMap,
    AhoCorasickSet,
    LongestMatchMap,
    LongestMatchSet,
    ShortestMatchMap,
    ShortestMatchSet,
    WholeWordLongestMatchMap,
    WholeWordLongestMatchSet,
    WholeWordMatchMap,
    WholeWordMatchSet,
    load_matcher,
)
from ahocorasick_tpu.utils import chartables
from ahocorasick_tpu.utils.chartables import default_word_chars
from ahocorasick_tpu.utils.thresholds import RangeNodeThreshold, Thresholder

__all__ = [
    "AhoCorasickSet",
    "AhoCorasickMap",
    "LongestMatchSet",
    "LongestMatchMap",
    "ShortestMatchSet",
    "ShortestMatchMap",
    "WholeWordMatchSet",
    "WholeWordMatchMap",
    "WholeWordLongestMatchSet",
    "WholeWordLongestMatchMap",
    "CompiledMatcher",
    "compile_matcher",
    "chartables",
    "default_word_chars",
    "Thresholder",
    "RangeNodeThreshold",
]

__version__ = "0.5.0"
