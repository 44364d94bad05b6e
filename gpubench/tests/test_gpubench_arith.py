"""The yardstick's arithmetic on hand-worked cases, and its frozen span plan
against the program's own (only these tests import both)."""

from __future__ import annotations

import math

import numpy as np
import pytest

from gpubench import devtrace, flops, plan

from conftest import tiny_config

SR = 22050


def test_chain_bound_by_hand():
    # 2·81·4·4096·512 FLOPs at 67 TFLOP/s: compute-bound.
    ops_s = 2 * 81 * 4 * 4096 * 512 / 67e12
    assert flops.chain_bound(81, 4, 4096, 512) == pytest.approx(ops_s)
    # One row against a large codebook: the codebook's bytes bound it.
    bytes_s = 4.0 * (64 + 4 * 65536 * 64 + 2 * 4 + 64) / 3.35e12
    assert flops.chain_bound(1, 4, 65536, 64) == pytest.approx(bytes_s)
    cfg = tiny_config()
    assert flops.k1_bound(10, cfg) == pytest.approx(
        2 * flops.chain_bound(10, 4, 64, 32))


def test_union_of_intervals_by_hand():
    # [0, 10] ∪ [5, 12] ∪ [20, 21]: 13 µs, not the 18 µs of the sum.
    busy, merged = devtrace.union_seconds([(5, 12), (0, 10), (20, 21)])
    assert busy == pytest.approx(13e-6)
    assert merged == [[0, 12], [20, 21]]
    assert devtrace.union_seconds([])[0] == 0.0


def test_open_region_is_innermost():
    regions = sorted([(0, 100, "nat/tokenize"), (10, 20, "nat/dispatch"),
                      (40, 45, "nat/serialize")])
    starts = [r[0] for r in regions]
    assert devtrace._open_region(regions, starts, 15) == "nat/dispatch"
    assert devtrace._open_region(regions, starts, 30) == "nat/tokenize"
    assert devtrace._open_region(regions, starts, 150) == "no nat/ region open"


def test_flops_of_one_short_span_by_hand():
    """A 1 s file: one span, no overlap; every term worked out apart."""
    cfg = tiny_config()
    a = cfg["semantic_arch_config"]
    n = SR
    t16 = math.ceil(n * 320 / 441)                  # 16000
    assert t16 == 16000
    ext = 0.0
    t, cin = t16, 1
    for cout, k, s in a["conv_layers"]:
        t = (t - k) // s + 1
        ext += 2 * t * cin * cout * k
        cin = cout
    t_sem = t                                       # 49 frames
    assert t_sem == 49
    h, f = a["hidden"], a["ffn_dim"]
    trunk = t_sem * (2 * 32 * h + 2 * h * (h // 4) * 16
                     + 2 * (2 * 4 * h * h + 2 * 2 * h * f)
                     + 2 * h * cfg["semantic_dim"])
    attention = 2 * 4 * t_sem * t_sem * h
    resampler = 2 * t16 * math.ceil((2 * 10 * 441 + 1) / 320)
    mel_t = n // 512 + 1                             # 44
    fft = mel_t * (5 * 2048 * 11 + 2 * 1025 * 16)
    stack, tt, mm, c = 0.0, mel_t, 16, 1
    for i, co in enumerate((32, 64, 128, 256, 512, 512)):
        if i < 4:
            tt, mm = -(-tt // 2), -(-mm // 2)
        stack += 2 * tt * mm * c * co * 9
        c = co
    stack += 2 * tt * mm * 512 * 32
    t_acc = -(-mel_t // 16)                          # 3

    def temporal(t, d):
        out = 0.0
        for s in (1, 2, 4, 8, 16):
            out += 2 * -(-t // s) * (d * 128 * (2 * s + 1) + 128 * 128 * 3)
        return out + 2 * t * 640 * d

    frames = plan.file_frames(n, SR, cfg)
    assert frames == min(t_sem, t_acc) == 3
    rvq = 2 * frames * 4 * 64 * (32 + 32)
    decoder = 2 * frames * 5 * (64 * 512 + 512 * 256 + 256 * 128 + 128)
    want = (ext + trunk + attention + resampler + fft + stack
            + temporal(t_sem, 32) + temporal(t_acc, 32) + rvq)
    assert flops.file_flops(n, cfg, False) == pytest.approx(want)
    assert flops.file_flops(n, cfg, True) == pytest.approx(want + decoder)


def test_flops_count_no_overlap_twice():
    """Spans add their own samples' work: a long file costs about its
    length times a 28 s span's rate, not more for the 1 s overlaps."""
    cfg = tiny_config()
    per_s_30 = flops.file_flops(28 * SR, cfg, False) / 28
    per_s_300 = flops.file_flops(300 * SR, cfg, False) / 300
    assert per_s_300 == pytest.approx(per_s_30, rel=0.05)


@pytest.mark.parametrize("seconds", [0.7, 3.0, 29.9, 30.0, 31.5, 47.0,
                                     86.0, 300.0])
def test_span_plan_is_the_programs(seconds):
    """The frozen plan, frame counts and forward shapes equal the program's
    (``bucketing.chunk_spans``, the tokenizer's frame arithmetic and
    ``_plan_span_groups`` / ``_pad_group_rows``)."""
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer
    from nat_tpu_torch.runtime.bucketing import bucket_length, chunk_spans

    cfg = tiny_config()
    n = int(seconds * SR)
    tok = NeuralAudioTokenizer(
        semantic_dim=32, acoustic_dim=32, codebook_size=64, n_mels=16,
        semantic_arch="wav2vec2", use_pretrained_semantic=False,
        semantic_arch_config=cfg["semantic_arch_config"], device="cpu")
    tok.semantic_fallback = False
    spans = plan.spans_of(n, SR)
    overlap = SR if len(spans) > 1 else 0
    assert [(s.start, s.length) for s in spans] == chunk_spans(n, SR, SR)
    total = 0
    for s in spans:
        assert s.bucket == bucket_length(s.ext_len, SR)
        assert plan.target_frames(s.ext_len, SR, cfg) == \
            tok._target_frames(s.ext_len, SR)
        valid_t = tok._target_frames(s.ext_len, SR)
        idx = np.arange(valid_t)
        if overlap:
            centers = s.ext_start + (idx + 0.5) * (s.ext_len / valid_t)
            idx = idx[(centers >= s.start) & (centers < s.start + s.length)]
        assert list(plan.kept(s, SR, cfg)) == list(idx)
        total += len(idx)
    assert plan.file_frames(n, SR, cfg) == total
    items = tok._plan_span_groups(chunk_spans(n, SR, overlap), overlap, SR,
                                  n, 8)
    shapes = {(bucket_length(min(n, it[0][0] + it[0][1] + overlap)
                             - max(0, it[0][0] - overlap), SR),
               tok._pad_group_rows(np.zeros((len(it), 1)), 8).shape[0])
              for it in items}
    assert plan.file_shapes(n, SR, 8) == shapes
