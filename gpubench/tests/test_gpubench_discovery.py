"""Discovery by name, the contract's shape of ``BENCHMARK.json``, and an
addition that needs no edit: a configuration, two mixes, two cells and a
per-layer metric added as files of their own run through the unchanged
harness."""

from __future__ import annotations

import hashlib
import json
import re

from gpubench import cells

from conftest import REPO, run_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpubench/") and c["reduced"] == []
        names.add(c["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for w in m.get("workloads", ()):
            reported = [e for e in BENCH["end_to_end"]
                        if e["name"] == m["moves"]]
            assert w in reported[0].get("workloads", [w])
        layers.setdefault(m["layer"], []).append(m["name"])
    text = json.dumps(BENCH)
    assert len(text.encode()) <= 64 * 1024


def test_every_cell_resolves():
    for w in BENCH["workloads"]:
        cell = cells.load(w["name"], REPO)
        assert cell.config["name"] == w["config"]
        assert cells.driver(cell, REPO).run
        for m in cell.per_layer:
            assert cells.reader(m["name"], REPO).read
        assert set(cell.spec["limits"]) >= {"code_gap", "frame_errors"}
        assert [e["name"] for e in cell.end_to_end][-1] == "setup_s"


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in (root / "gpubench").rglob("*")
        if p.is_file() and "__pycache__" not in p.parts
        and "tests" not in p.parts}


def test_additions_need_no_edit(tiny_root, tmp_path):
    """The tiny configuration, mixes and cells (``conftest.make_root``) and
    one more per-layer metric are new files and entries; every file the
    benchmark had is byte for byte the same, and the new cell runs."""
    before = _digests(REPO)
    g = tiny_root / "gpubench"
    (g / "layer_metrics" / "tiny.audio_s_in_window.py").write_text(
        '"""Seconds of audio the window tokenized."""\n\n\n'
        'def read(ctx):\n    return ctx.get("audio_s")\n')
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append(dict(
        name="tiny.audio_s_in_window", unit="s", better="higher",
        source="host_clock", layer="tests", moves="audio_s_per_s",
        workloads=["tiny-files"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tiny_root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "gpubench/configs/tiny.json", "gpubench/traffic/tiny-files.json",
        "gpubench/traffic/tiny-serve.json",
        "gpubench/workloads/tiny-files.json",
        "gpubench/workloads/tiny-serve.json",
        "gpubench/layer_metrics/tiny.audio_s_in_window.py"}
    res = run_tiny(tiny_root, "tiny-files", 2 ** 31 + 77, 2.0, True, tmp_path)
    assert res["correct"] is True
    assert res["metrics"]["tiny.audio_s_in_window"]["value"] > 0
