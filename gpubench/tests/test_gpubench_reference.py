"""The plain reference against ``nat_tpu_torch`` at tiny widths on the CPU,
where both compute in IEEE float32: the same frames and codes, the same
reconstruction; and the float8 control is told apart."""

from __future__ import annotations

import io

import numpy as np
import pytest

from gpubench import program, traffic, weights
from gpubench.reference import model, tokenize

from conftest import tiny_config

SR = 22050
SEED = 2 ** 31 + 4242


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    program.prepare_env(tmp_path_factory.mktemp("env"),
                        tmp_path_factory.mktemp("tmp"))
    cfg = tiny_config()
    pipe = program.build(cfg, True, SEED, "cpu")
    params, cbs = weights.make(cfg, SEED, "cpu", True)
    ref = tokenize.Reference(cfg, params, cbs, "cpu",
                             model.Numerics(trunk_gelu_tanh=False))
    return cfg, pipe, ref, params, cbs


@pytest.mark.parametrize("seconds", [2.5, 47.0])
def test_files_path_matches(setup, tmp_path, seconds):
    cfg, pipe, ref, _, _ = setup
    pcm = traffic.signal(SEED, seconds, SR)
    path = tmp_path / "a.wav"
    path.write_bytes(traffic.wav_bytes(pcm, SR))
    lines = []
    pipe.stream_audio(str(path), lines.append)
    ans = tokenize.parse_stream(lines)
    audio = pcm.astype(np.float32) / 32768.0
    audio /= np.maximum(audio.max(), -audio.min()) + 1e-8
    got = ref.judge(audio, ans, reconstruct=True)
    assert got["frame_errors"] == 0 and got["code_gap"] == 0.0
    assert got["code_agree"] == 1.0
    assert 0 < ans.mse_loss and got["mse_rel_err"] < 1e-5


def test_streamed_path_matches(setup):
    cfg, pipe, ref, _, _ = setup
    pcm = traffic.signal(SEED + 1, 35.0, SR)
    lines = []
    pipe.stream_stdin(io.BytesIO(traffic.wav_bytes(pcm, SR)), lines.append)
    ans = tokenize.parse_stream(lines)
    got = ref.judge(pcm.astype(np.float32) / 32768.0, ans, reconstruct=False)
    assert got == {"frame_errors": 0.0, "code_gap": 0.0, "code_agree": 1.0}


def test_judge_sees_faults(setup):
    """An altered code, a dropped frame and a wrong timestamp each read."""
    cfg, pipe, ref, _, _ = setup
    pcm = traffic.signal(SEED + 2, 6.0, SR)
    audio = pcm.astype(np.float32) / 32768.0
    good = ref.answer(audio, reconstruct=False)
    sem = good.sem.copy()
    sem[3, 0] = (sem[3, 0] + 1) % cfg["codebook_size"]
    assert ref.judge(audio, good._replace(sem=sem), False)["code_gap"] > 1e-3
    short = good._replace(fi=good.fi[:-1], ts=good.ts[:-1], sem=good.sem[:-1],
                          acc=good.acc[:-1])
    assert ref.judge(audio, short, False)["frame_errors"] == 1
    ts = list(good.ts)
    ts[2] += 1.0
    assert ref.judge(audio, good._replace(ts=ts), False)["frame_errors"] == 1


def test_control_is_told_apart(setup):
    """The reference in float8 e4m3 (one step below bf16) moves codes by
    gaps far above float32 rounding."""
    cfg, _, ref, params, cbs = setup
    ctl = tokenize.Reference(cfg, params, cbs, "cpu", model.Numerics(
        encoders="fp8", tf32=True, trunk_gelu_tanh=False))
    pcm = traffic.signal(SEED + 3, 40.0, SR)
    audio = pcm.astype(np.float32) / 32768.0
    got = ref.judge(audio, ctl.answer(audio, reconstruct=True), True)
    assert got["code_gap"] > 1e-2 and got["code_agree"] < 0.99
