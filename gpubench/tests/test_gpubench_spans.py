"""The readers of the files path's host regions and of the forward's useful
share: nothing to read gives None, a hand-worked file gives its share, and
a traced CPU run of a files cell reads every one of them."""

from __future__ import annotations

import pytest

from gpubench import cells, plan

from conftest import REPO, run_tiny

SPANS = {
    "pipeline.decode_ms_per_audio_s": "nat/decode",
    "eval.spectral_ms_per_audio_s": "nat/eval/spectral",
    "eval.pitch_ms_per_audio_s": "nat/eval/pitch",
    "eval.rhythm_ms_per_audio_s": "nat/eval/rhythm",
    "eval.timbral_ms_per_audio_s": "nat/eval/timbral",
    "tokenizer.stage_ms_per_audio_s": "nat/stage",
    "tokenizer.finalize_ms_per_audio_s": "nat/finalize",
}
READERS = sorted(SPANS) + ["forward.useful_share"]
EVAL = [m for m in SPANS if m.startswith("eval.")]


def _read(name, ctx):
    return cells.reader(name, REPO).read(ctx)


def _ctx(**over):
    ctx = {"driver": "files", "audio_s": 70.0, "wall_s": 1.0,
           "traffic": {"sample_rate": 22050}, "stages": {},
           "graphs": {"replays": 3, "eager": 0}}
    ctx.update(over)
    return ctx


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_is_none(name):
    """The parent's program has none of these regions or counters."""
    assert _read(name, _ctx()) is None
    full = _ctx(stages=dict.fromkeys(SPANS.values(), 0.5),
                graphs={"replays": 3, "eager": 0, "samples": 1764000})
    assert _read(name, full) is not None
    assert _read(name, dict(full, driver="serve_open")) is None


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_readers_by_hand(name):
    """0.35 s in the region over 70 s of audio: 5 ms an audio second."""
    ctx = _ctx(stages={SPANS[name]: 0.35, "nat/evaluate": 9.0})
    assert _read(name, ctx) == pytest.approx(5.0)


def test_useful_share_of_a_70_s_file_by_hand():
    """One 70 s file at 22.05 kHz (1 543 500 samples; overlap 22 050).

    Spans (start, length): the ramp's (0, 66 150), then cores of 617 400
    (30 s less twice the overlap): (66 150, 617 400), (683 550, 617 400),
    and the rest, (1 300 950, 242 550).  Extended by the overlap they are
    88 200, 661 500, 661 500 and 264 600 samples, in buckets of 4, 30, 30
    and 16 s: 88 200, 661 500, 661 500 and 352 800.  Plan items in groups
    of 8: the first span alone, the two 30 s spans together (2 rows, a
    power of two: no zero row), the 16 s span alone.  Forwarded:
    88 200 + 2 × 661 500 + 352 800 = 1 764 000 samples, of which the
    file's own are 1 543 500: 87.5%."""
    sr, n = 22050, 70 * 22050
    spans = plan.spans_of(n, sr)
    assert [(s.start, s.length) for s in spans] == [
        (0, 66150), (66150, 617400), (683550, 617400), (1300950, 242550)]
    assert [s.bucket for s in spans] == [88200, 661500, 661500, 352800]
    forwarded = sum(it[0].bucket * plan.padded_rows(len(it), 8)
                    for it in plan.plan_items(spans, 8))
    assert forwarded == 88200 + 2 * 661500 + 352800 == 1764000
    ctx = _ctx(audio_s=n / sr, graphs={"replays": 3, "eager": 0,
                                       "samples": 1764000})
    assert _read("forward.useful_share", ctx) == pytest.approx(87.5)


def test_a_traced_files_run_reads_them_all(tiny_root, tmp_path):
    """On the CPU at tiny widths, with reconstruction: every new metric
    reads a number, the metric suite's parts lie within ``nat/evaluate``
    and the useful share within (0, 100]."""
    res = run_tiny(tiny_root, "tiny-files", 2 ** 31 + 11, 2.0, True,
                   tmp_path)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(got)
    evaluate = got["pipeline.evaluate_ms_per_audio_s"]
    assert all(got[m] <= evaluate for m in EVAL)
    assert sum(got[m] for m in EVAL) <= evaluate
    assert 0.0 < got["forward.useful_share"] <= 100.0
