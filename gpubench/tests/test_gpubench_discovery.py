"""Discovery by name, the contract's shape of ``BENCHMARK.json``, and an
addition that needs no edit: a configuration, two mixes, two cells and a
per-layer metric added as files of their own run through the unchanged
harness."""

from __future__ import annotations

import hashlib
import json
import math
import re
import subprocess
import sys

import pytest

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


# Run in a fresh process with the checkout first on the path, so that
# ``gpubench`` and its trunk files are the checkout's.
PRENORM_PROBE = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
from gpubench import flops, plan, traffic, weights
from gpubench.reference import model, tokenize, trunks

cfg = json.loads(open(sys.argv[2]).read())
sr = cfg["sample_rate"]
trunk = trunks.of(cfg)
params, cbs = weights.make(cfg, 2 ** 31 + 5, "cpu", False)
sem = params["semantic_encoder"]
norms = [v for k, v in sem.items() if "layer_norms" in k and "weight" in k]
ref = tokenize.Reference(cfg, params, cbs, "cpu",
                         model.Numerics(trunk_gelu_tanh=False))
n = int(35.5 * sr)
audio = traffic.signal(2 ** 31 + 6, 35.5, sr).astype(np.float32) / 32768.0
s, a = ref.features(audio)
print(json.dumps({
    "file": trunk.__file__, "rate": trunk.rate(cfg),
    "frames": [plan.semantic_frames(k * sr, sr, cfg) for k in (1, 10)],
    "flops_1s": flops.file_flops(sr, cfg, False),
    "keys": list(sem), "holder": list(trunk.holder(cfg).state_dict()),
    "norm_mean": float(sum(float(t.mean()) for t in norms) / len(norms)),
    "features": [list(s.shape), list(a.shape)],
    "file_frames": plan.file_frames(n, sr, cfg),
    "finite": bool(s.isfinite().all() and a.isfinite().all())}))
'''


def test_a_trunk_of_another_kind_needs_no_edit(tmp_path):
    """A trunk of a second kind is a file and a configuration naming it: a
    pre-norm stand-in at 24 kHz with a LayerNorm after every conv
    (``prenorm_trunk.py``), at tiny widths.  Every file the benchmark had
    is byte for byte the same; the frame and FLOP arithmetic, the seeded
    weights and the reference follow the new file."""
    from conftest import TINY_ARCH, make_root, tiny_config, trunk_files

    before = _digests(REPO)
    root = make_root(tmp_path)
    g = root / "gpubench"
    (g / "reference" / "trunks" / "prenorm.py").write_bytes(
        (REPO / "gpubench" / "tests" / "prenorm_trunk.py").read_bytes())
    arch = dict(TINY_ARCH, sample_rate=24000)
    cfg = dict(tiny_config(), name="tiny-prenorm", semantic_arch="prenorm",
               semantic_arch_config=arch)
    cfg_path = g / "configs" / "tiny-prenorm.json"
    cfg_path.write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny-prenorm", source="tests",
                                 reduced=[], why="tests",
                                 file="gpubench/configs/tiny-prenorm.json"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "gpubench/configs/tiny.json", "gpubench/traffic/tiny-files.json",
        "gpubench/traffic/tiny-serve.json",
        "gpubench/workloads/tiny-files.json",
        "gpubench/workloads/tiny-serve.json",
        "gpubench/reference/trunks/prenorm.py",
        "gpubench/configs/tiny-prenorm.json"}
    assert "prenorm.py" in trunk_files(g / "reference" / "trunks")

    out = subprocess.run(
        [sys.executable, "-c", PRENORM_PROBE, str(root), str(cfg_path)],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["file"] == str(g / "reference" / "trunks" / "prenorm.py")
    assert got["rate"] == 24000
    # 75 frames a second: 24000 samples → 74 frames, 240000 → 749.
    assert got["frames"] == [74, 749]

    # A 1 s file by hand: the resampler to 24 kHz (up 160, down 147), the
    # trunk's 74 frames, the acoustic side and 3 frames of RVQ.
    h, f, sr = arch["hidden"], arch["ffn_dim"], 22050
    t, cin, extractor = 24000, 1, 0.0
    for cout, k, s in arch["conv_layers"]:
        t = (t - k) // s + 1
        extractor += 2 * t * cin * cout * k
        cin = cout
    assert t == 74
    trunk = (t * (2 * 32 * h + 2 * h * (h // 4) * 16
                  + 2 * (2 * 4 * h * h + 2 * 2 * h * f) + 2 * h * 32)
             + 2 * 4 * t * t * h)
    resampler = 2 * 24000 * math.ceil((2 * 10 * 160 + 1) / 160)
    mel_t = sr // 512 + 1
    acoustic = mel_t * (5 * 2048 * 11 + 2 * 1025 * 16)
    tt, mm, c = mel_t, 16, 1
    for i, co in enumerate((32, 64, 128, 256, 512, 512)):
        if i < 4:
            tt, mm = -(-tt // 2), -(-mm // 2)
        acoustic += 2 * tt * mm * c * co * 9
        c = co
    acoustic += 2 * tt * mm * 512 * 32

    def temporal(t, d):
        out = 0.0
        for s in (1, 2, 4, 8, 16):
            out += 2 * -(-t // s) * (d * 128 * (2 * s + 1) + 128 * 128 * 3)
        return out + 2 * t * 640 * d

    rvq = 2 * 3 * 4 * 64 * (32 + 32)
    want = (resampler + extractor + trunk + acoustic + temporal(74, 32)
            + temporal(-(-mel_t // 16), 32) + rvq)
    assert got["flops_1s"] == pytest.approx(want)

    assert got["keys"] == got["holder"]
    for key in ("prenorm.feature_extractor.convs.0.bias",
                "prenorm.feature_extractor.layer_norms.6.weight",
                "prenorm.layers.1.layer_norm.weight",
                "prenorm.encoder_layer_norm.bias", "projection.weight"):
        assert key in got["keys"]
    assert not any(k.startswith("wav2vec2.") for k in got["keys"])
    assert got["norm_mean"] == pytest.approx(1.0, abs=0.05)
    frames = got["file_frames"]
    assert got["features"] == [[frames, 32], [frames, 32]] and got["finite"]
