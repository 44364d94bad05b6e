"""A run whose timed path is broken underneath comes out not correct: a code
altered where K1 (here its plain CPU version) produces it, in a files cell
and in the daemon's cell.  The harness's look for a card is skipped
(``run_cell`` on the CPU); everything else is a whole run."""

from __future__ import annotations

import pytest

from conftest import run_tiny


@pytest.fixture
def altered_codes(monkeypatch):
    from nat_tpu_torch.ops import rvq_kernel

    real = rvq_kernel.rvq_encode

    def altered(state, x, *args, **kwargs):
        codes, quantized, losses = real(state, x, *args, **kwargs)
        codes = codes.clone()
        t = min(2, codes.shape[-1] - 1)
        codes[0, 0, t] = (codes[0, 0, t] + 1) % state.codebook_size
        return codes, quantized, losses

    monkeypatch.setattr(rvq_kernel, "rvq_encode", altered)


@pytest.mark.parametrize("cell,seconds", [("tiny-files", 2.0),
                                          ("tiny-serve", 3.0)])
def test_altered_token_is_not_correct(altered_codes, tiny_root, tmp_path,
                                      cell, seconds):
    res = run_tiny(tiny_root, cell, 2 ** 31 + 11, seconds, False, tmp_path)
    assert res["correct"] is False
    gap = res["checks"]["code_gap"]
    assert gap["value"] > gap["limit"]
    assert res["checks"]["frame_errors"]["value"] == 0
