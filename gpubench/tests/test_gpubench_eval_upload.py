"""The reader of the metric suite's upload region: nothing to read gives
None, a hand-worked window gives its milliseconds an audio second."""

from __future__ import annotations

import pytest

from gpubench import cells

from conftest import REPO

NAME = "eval.upload_ms_per_audio_s"


def _read(ctx):
    return cells.reader(NAME, REPO).read(ctx)


def _ctx(**over):
    ctx = {"driver": "files", "audio_s": 80.0, "wall_s": 1.0,
           "traffic": {"sample_rate": 22050}, "stages": {}}
    ctx.update(over)
    return ctx


def test_without_the_region_it_reads_none():
    """The parent's program, the CPU evaluator and the tokens mixes open
    no ``nat/eval/upload``; a serving run is not read."""
    assert _read(_ctx()) is None
    assert _read(_ctx(stages={"nat/eval/spectral": 0.5})) is None
    assert _read(_ctx(driver="serve_open",
                      stages={"nat/eval/upload": 0.5})) is None
    assert _read(_ctx(audio_s=0.0, stages={"nat/eval/upload": 0.5})) is None


def test_upload_by_hand():
    """Two files of 40 s, each uploading twice 40 × 22 050 float32 samples
    (3.53 MB) in 0.6 ms: 1.2 ms over 80 audio seconds, 0.015 ms each."""
    ctx = _ctx(stages={"nat/eval/upload": 2 * 0.0006, "nat/evaluate": 0.1})
    assert _read(ctx) == pytest.approx(0.015)
