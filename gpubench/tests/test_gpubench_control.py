"""On the card: the control comes out not correct, and the program comes
out correct, at the published widths on inputs a test run can hold.

    python -m pytest -p no:cacheprovider gpubench/tests/test_gpubench_control.py -m cuda

The control is the reference one step below the configuration's precision
(``Numerics(encoders="fp8", tf32=True)``); the program is the port on the
card at its defaults.  Both are judged by the float32 reference against
``base-file-default``'s limits.  The cell-size readings are
``gpubench/tools/control.py``'s.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from gpubench import program, traffic, weights
from gpubench.reference import model, tokenize

from conftest import REPO

SR = 22050
CELL = json.loads((REPO / "gpubench/workloads/base-file-default.json")
                  .read_text())
CFG = json.loads((REPO / "gpubench/configs/nat-w2v2-base.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_control_fails_program_passes(cuda, tmp_path, seed):
    program.prepare_env(REPO, tmp_path)
    pcm = traffic.signal(seed, 70.0, SR)
    audio = pcm.astype(np.float32) / 32768.0
    audio /= np.maximum(audio.max(), -audio.min()) + 1e-8
    params, cbs = weights.make(CFG, seed, "cuda", True)
    ref = tokenize.Reference(CFG, params, cbs, "cuda",
                             model.Numerics(trunk_gelu_tanh=True))
    ctl = tokenize.Reference(CFG, params, cbs, "cuda", model.Numerics(
        encoders="fp8", tf32=True, trunk_gelu_tanh=True))
    limits = CELL["limits"]
    got = ref.judge(audio, ctl.answer(audio, True), True)
    assert any(got[k] > v for k, v in limits.items())

    pipe = program.build(CFG, True, seed, "cuda")
    path = tmp_path / "a.wav"
    path.write_bytes(traffic.wav_bytes(pcm, SR))
    lines = []
    pipe.stream_audio(str(path), lines.append)
    mine = ref.judge(audio, tokenize.parse_stream(lines), True)
    assert all(mine[k] <= v for k, v in limits.items()), mine
