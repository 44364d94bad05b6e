"""The result's last line: its keys and what they hold, on the CPU at tiny
widths (``run_cell``); and no result without a card or without the
program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import REPO, run_tiny

TOP = ["correct", "attempted", "failed", "metrics", "device"]


def _common(res, trace):
    keys = list(res)
    assert keys[:5] == TOP and keys[-1] == "checks"
    assert set(keys) <= set(TOP) | {"breakdown", "checks"}
    assert json.loads(json.dumps(res)) == res        # plain JSON numbers
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "breakdown" not in res


def test_files_cell_lines(tiny_root, tmp_path):
    res = run_tiny(tiny_root, "tiny-files", 2 ** 31 + 5, 2.0, False,
                   tmp_path / "a")
    _common(res, False)
    assert list(res["metrics"]) == ["audio_s_per_s", "setup_s"]
    assert res["metrics"]["audio_s_per_s"]["unit"] == "audio_s/s"
    assert set(res["checks"]) == {"code_gap", "frame_errors", "mse_rel_err"}
    traced = run_tiny(tiny_root, "tiny-files", 2 ** 31 + 6, 2.0, True,
                      tmp_path / "b")
    _common(traced, True)
    names = set(traced["metrics"])
    assert {"io.load_ms_per_audio_s", "pipeline.evaluate_ms_per_audio_s",
            "forward.mfu", "graphs.replay_share"} <= names
    assert "server.spans_per_dispatch" not in names
    assert "audio_s_per_s" not in names


def test_serve_cell_lines(tiny_root, tmp_path):
    res = run_tiny(tiny_root, "tiny-serve", 2 ** 31 + 7, 4.0, False, tmp_path)
    _common(res, False)
    assert list(res["metrics"]) == ["first_frame_p95_ms", "request_p95_ms",
                                    "setup_s"]
    assert res["attempted"] == 8 and set(res["checks"]) == {
        "code_gap", "frame_errors"}


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", "base-file-default",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_no_card_no_result():
    out = _run_py(REPO)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_bare_directory_no_result(tmp_path):
    """A directory with only ``BENCHMARK.json`` and the paths."""
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
