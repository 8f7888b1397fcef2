"""A/B bench-result comparison (reference bin/test-branches:1-18 analog).

The reference's harness checks out two git branches and eyeballs perf
main() output; here two JSON-lines result files pair up by config identity
and the compare exits nonzero on a >5% throughput regression, which makes
it usable from CI / git-bisect (bin/bench-ab drives it across revisions).
"""

import json

from ahocorasick_tpu.bench.__main__ import compare_results


def _write(tmp_path, name, records):
    p = tmp_path / name
    p.write_text("\n".join(json.dumps(r) for r in records) + "\n")
    return str(p)


_REC = {"config": "c1", "kind": "ac", "map": False, "keywords": 100,
        "units": 1024, "gbps": 1.0, "scan_s": 0.5}


def test_no_regression_exits_zero(tmp_path, capsys):
    a = _write(tmp_path, "a.jsonl", [_REC])
    b = _write(tmp_path, "b.jsonl", [{**_REC, "gbps": 1.05, "scan_s": 0.4}])
    assert compare_results(a, b) == 0
    out = capsys.readouterr().out
    assert "1.050x" in out and "gbps" in out


def test_throughput_regression_exits_one(tmp_path):
    a = _write(tmp_path, "a.jsonl", [_REC])
    b = _write(tmp_path, "b.jsonl", [{**_REC, "gbps": 0.9}])
    assert compare_results(a, b) == 1


def test_unpaired_records_reported_not_fatal(tmp_path, capsys):
    a = _write(tmp_path, "a.jsonl", [_REC, {**_REC, "config": "only-a"}])
    b = _write(tmp_path, "b.jsonl", [_REC, {**_REC, "config": "only-b"}])
    assert compare_results(a, b) == 0
    out = capsys.readouterr().out
    assert "only in A: only-a" in out and "only in B: only-b" in out


def test_non_json_lines_skipped(tmp_path):
    a = _write(tmp_path, "a.jsonl", [_REC])
    p = tmp_path / "b.jsonl"
    p.write_text("== side b ==\n" + json.dumps({**_REC, "gbps": 2.0}) + "\n")
    assert compare_results(a, str(p)) == 0


def test_compare_flags_projected_scan_regression(tmp_path):
    """The projected_* columns (a host-link model, not a measurement) are
    gone: old files that carry them no longer gate; the measured
    kernel_gbps of the resolved kinds does."""
    rec = {"config": "c", "kind": "longest", "map": False, "keywords": 5,
           "units": 100}
    a = _write(tmp_path, "a.jsonl", [{**rec, "projected_scan_gbps": 1.0,
                                      "kernel_gbps": 1.0}])
    bad = _write(tmp_path, "bad.jsonl", [{**rec, "projected_scan_gbps": 1.0,
                                          "kernel_gbps": 0.5}])
    ok = _write(tmp_path, "ok.jsonl", [{**rec, "projected_scan_gbps": 0.5,
                                        "kernel_gbps": 1.01}])
    assert compare_results(a, bad) == 1
    assert compare_results(a, ok) == 0


def test_memory_columns_compared_lower_is_better(tmp_path, capsys):
    """table_mb/device_mb (the reference README's memory column analog)
    print as lower-is-better deltas and never trip the throughput gate."""
    import re

    a = _write(tmp_path, "a.jsonl", [{**_REC, "table_mb": 100.0, "device_mb": 50.0}])
    b = _write(tmp_path, "b.jsonl", [{**_REC, "table_mb": 120.0, "device_mb": 40.0}])
    assert compare_results(a, b) == 0  # memory growth reports, never gates
    out = capsys.readouterr().out
    # Bind the marker to the metric's own row, so an accidental direction
    # flip cannot be satisfied by some other row's marker.
    assert re.search(r"^- c1\s+table_mb", out, re.M)    # growth marked "-"
    assert re.search(r"^\+ c1\s+device_mb", out, re.M)  # shrink marked "+"


def test_memory_columns_zero_values_not_flagged(tmp_path, capsys):
    """Rounded-to-0.0 memory values (sub-50 KB tables, gold records) must
    not print spurious inf-ratio regressions; 0 -> nonzero still flags."""
    import re

    a = _write(tmp_path, "a.jsonl", [{**_REC, "device_mb": 0.0}])
    same = _write(tmp_path, "same.jsonl", [{**_REC, "device_mb": 0.0}])
    grew = _write(tmp_path, "grew.jsonl", [{**_REC, "device_mb": 3.0}])
    assert compare_results(a, same) == 0
    out = capsys.readouterr().out
    assert re.search(r"^\+ c1\s+device_mb\s+0\b.*1\.000x", out, re.M)
    assert compare_results(a, grew) == 0  # reported, never gates
    out = capsys.readouterr().out
    assert re.search(r"^- c1\s+device_mb", out, re.M)
