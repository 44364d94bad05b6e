"""The trunk files hold the yardstick where it stood: frames, span plans,
warm shapes, FLOP counts and K1 bounds of the two wav2vec2 configurations
equal, exactly, the arithmetic that fixed the trunk at 16 kHz wav2vec2
before the trunk had a file of its own (frozen below); the seeded weights
and the reference's features are the same bits as then (digests recorded
from that arithmetic's tree, torch 2.13 on the CPU, one thread)."""

from __future__ import annotations

import hashlib
import json
import math

import numpy as np
import pytest
import torch

from gpubench import flops, plan, traffic, weights
from gpubench.reference import model, trunks

from conftest import REPO, tiny_config, trunk_files

SR = 22050
CONFIGS = ("nat-w2v2-base", "nat-w2v2-large")


def _config(name):
    return json.loads((REPO / "gpubench" / "configs" / f"{name}.json")
                      .read_text())


# ---------------------------------------------------------------------------
# The frozen arithmetic: the trunk fixed at wav2vec2, 16 kHz.  The helpers
# that know nothing of the trunk (spans, mel and acoustic frames, the
# acoustic and temporal FLOPs, chain_bound) are the live ones.
# ---------------------------------------------------------------------------
FROZEN_SEMANTIC_SR = 16000


def frozen_extractor_length(t, conv_layers):
    for _, kernel, stride in conv_layers:
        t = (t - kernel) // stride + 1
    return t


def frozen_semantic_frames(num_samples, sr, cfg):
    t16 = plan.resample_length(num_samples, sr, FROZEN_SEMANTIC_SR)
    return frozen_extractor_length(
        t16, cfg["semantic_arch_config"]["conv_layers"])


def frozen_target_frames(num_samples, sr, cfg):
    return max(min(frozen_semantic_frames(num_samples, sr, cfg),
                   plan.acoustic_frames(num_samples, cfg["hop_length"])), 1)


def frozen_kept(span, sr, cfg):
    valid_t = frozen_target_frames(span.ext_len, sr, cfg)
    idx = np.arange(valid_t)
    if not span.overlap:
        return idx
    centers = span.ext_start + (idx + 0.5) * (span.ext_len / max(valid_t, 1))
    keep = (centers >= span.start) & (centers < span.start + span.length)
    return idx[keep]


def frozen_file_frames(num_samples, sr, cfg):
    return int(sum(len(frozen_kept(s, sr, cfg))
                   for s in plan.spans_of(num_samples, sr)))


def frozen_file_shapes(num_samples, sr, group):
    return {(item[0].bucket, plan.padded_rows(len(item), group))
            for item in plan.plan_items(plan.spans_of(num_samples, sr),
                                        group)}


def frozen_resampler(samples, sr):
    g = math.gcd(FROZEN_SEMANTIC_SR, sr)
    up, down = FROZEN_SEMANTIC_SR // g, sr // g
    taps = -(-(2 * 10 * max(up, down) + 1) // up)
    return 2.0 * plan.resample_length(samples, sr, FROZEN_SEMANTIC_SR) * taps


def frozen_trunk_frame(a):
    h, f = a["hidden"], a["ffn_dim"]
    feat = a["conv_layers"][-1][0]
    pos = 2.0 * h * (h // a["pos_conv_groups"]) * a["pos_conv_kernel"]
    layer = 2.0 * 4 * h * h + 2.0 * 2 * h * f
    return 2.0 * feat * h + pos + a["num_layers"] * layer


def frozen_extractor(t16, a):
    total, t, cin = 0.0, t16, 1
    for cout, kernel, stride in a["conv_layers"]:
        t = (t - kernel) // stride + 1
        total += 2.0 * t * cin * cout * kernel
        cin = cout
    return total


def frozen_file_flops(samples, cfg, reconstruct):
    sr, hop = cfg["sample_rate"], cfg["hop_length"]
    a = cfg["semantic_arch_config"]
    d_sem, d_acc = cfg["semantic_dim"], cfg["acoustic_dim"]
    total = 0.0
    for span in plan.spans_of(samples, sr):
        own = span.length / max(span.ext_len, 1)
        ext16 = plan.resample_length(span.ext_len, sr, FROZEN_SEMANTIC_SR)
        t_sem = frozen_extractor_length(ext16, a["conv_layers"])
        mel_t = plan.mel_frames(span.ext_len, hop)
        t_acc = plan.acoustic_frames(span.ext_len, hop)
        q_sem = t_sem * own
        per_span = (frozen_resampler(span.ext_len, sr)
                    + frozen_extractor(ext16, a)
                    + mel_t * (flops.FFT_FLOPS
                               + 2.0 * (plan.N_FFT // 2 + 1) * cfg["n_mels"])
                    + flops._mel_stack(mel_t, cfg["n_mels"], d_acc)
                    + flops._temporal(t_sem, d_sem)
                    + flops._temporal(t_acc, d_acc))
        total += per_span * own
        total += q_sem * (frozen_trunk_frame(a) + 2.0 * a["hidden"] * d_sem)
        total += a["num_layers"] * 4.0 * q_sem * t_sem * a["hidden"]
    frames = frozen_file_frames(samples, sr, cfg)
    k = cfg["codebook_size"]
    nq = cfg["num_quantizers"] // 2
    total += 2.0 * frames * nq * k * (d_sem + d_acc)
    if reconstruct:
        cin = d_sem + d_acc
        for cout in flops.DECODER_CHANNELS:
            total += 2.0 * frames * cin * cout * flops.DECODER_KERNEL
            cin = cout
    return total


def frozen_k1_bound(frames, cfg):
    nq = cfg["num_quantizers"] // 2
    k = cfg["codebook_size"]
    return (flops.chain_bound(frames, nq, k, cfg["semantic_dim"])
            + flops.chain_bound(frames, nq, k, cfg["acoustic_dim"]))


def sample_counts():
    """0.5 s to 300 s at 22.05 kHz: every half second, each bucket's edge,
    the single span's edge at 30 s, and of a longer file each span's end
    (the 3 s ramp, then 28 s cores) and each bucket edge of its last
    span's window, one sample either side of each."""
    sr = SR
    first, core = 3 * sr, 28 * sr
    edges = {int(round(s * sr)) for s in np.arange(0.5, 300.25, 0.5)}
    for b in (int(round(s * sr)) for s in plan.BUCKET_SECONDS):
        edges.add(b)
        edges.update(first + k * core + b - sr for k in range(11))
    edges.update(first + k * core for k in range(11))
    ns = {n + d for n in edges for d in (-1, 0, 1)}
    return sorted(n for n in ns if sr // 2 <= n <= 300 * sr)


SAMPLES = sample_counts()


@pytest.mark.parametrize("name", CONFIGS)
def test_frames_plans_and_shapes_are_frozen(name):
    cfg = _config(name)
    assert len(SAMPLES) > 900
    for n in SAMPLES:
        assert plan.semantic_frames(n, SR, cfg) == \
            frozen_semantic_frames(n, SR, cfg), n
        assert plan.target_frames(n, SR, cfg) == \
            frozen_target_frames(n, SR, cfg), n
        for span in plan.spans_of(n, SR):
            assert list(plan.kept(span, SR, cfg)) == \
                list(frozen_kept(span, SR, cfg)), (n, span)
        assert plan.file_frames(n, SR, cfg) == \
            frozen_file_frames(n, SR, cfg), n
        for group in (1, 8):
            assert plan.file_shapes(n, SR, group) == \
                frozen_file_shapes(n, SR, group), (n, group)


@pytest.mark.parametrize("reconstruct", [False, True],
                         ids=["tokens", "reconstruct"])
@pytest.mark.parametrize("name", CONFIGS)
def test_flop_counts_are_frozen(name, reconstruct):
    cfg = _config(name)
    for n in SAMPLES:
        assert flops.file_flops(n, cfg, reconstruct) == \
            frozen_file_flops(n, cfg, reconstruct), n


@pytest.mark.parametrize("name", CONFIGS)
def test_k1_bounds_are_frozen(name):
    cfg = _config(name)
    for n in SAMPLES:
        assert flops.k1_bound(plan.file_frames(n, SR, cfg), cfg) == \
            frozen_k1_bound(frozen_file_frames(n, SR, cfg), cfg), n


# ---------------------------------------------------------------------------
# Bits recorded from the tree before the trunk files
# ---------------------------------------------------------------------------
SEED = 2 ** 31 + 17
WEIGHT_DIGESTS = {
    "nat-w2v2-base":
        "73cd6e85b5cf8a0759521cef22a95ab929e3b2df1a3831e13707daf72acad41f",
    "nat-w2v2-large":
        "bd3e05e8beb9572e2389a76d8748048c08bb93a33f16040884a56254077b0f04",
}
FEATURE_DIGESTS = {
    "reference":
        "b56679301c1d78c6c8b40f8e07abfe3b4f7badf4b71629a59868c0e526cdd466",
    "control":
        "2d75515e49711dea2f8d91849da35b7173becd52e9184fd56c62bc63b713e19d",
}


def weights_digest(params, codebooks) -> str:
    """SHA-256 of the codebooks, then of every leaf in order, each after its
    module, name and shape."""
    h = hashlib.sha256()
    for t in codebooks:
        h.update(t.contiguous().numpy().tobytes())
    for name, leaves in params.items():
        for key, leaf in leaves.items():
            h.update(f"{name}/{key}{tuple(leaf.shape)}".encode())
            h.update(leaf.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_seeded_weights_are_the_same_bits(name):
    params, codebooks = weights.make(_config(name), SEED, "cpu", True)
    assert weights_digest(params, codebooks) == WEIGHT_DIGESTS[name]


NUMERICS = {
    "reference": model.Numerics(trunk_gelu_tanh=False),
    "control": model.Numerics(encoders="fp8", tf32=True, trunk_gelu_tanh=True),
}


@pytest.mark.parametrize("label", sorted(FEATURE_DIGESTS))
def test_reference_features_are_the_same_bits(label):
    """Two rows of a 4 s bucket through ``span_features`` at the tiny
    widths, one thread (the sums' order follows the thread count)."""
    cfg = tiny_config()
    params, _ = weights.make(cfg, SEED, "cpu", True)
    mods = model.load(model.build(cfg, True), params, "cpu")
    bucket = 4 * SR
    pcm = np.stack([traffic.signal(SEED + i, 4.0, SR)[:bucket]
                    for i in (0, 1)])
    wave = torch.from_numpy(pcm.astype(np.float32) / 32768.0)
    t_target = plan.target_frames(bucket, SR, cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            s, a = model.span_features(mods, cfg, wave, t_target,
                                       model.Ops(NUMERICS[label]))
    finally:
        torch.set_num_threads(threads)
    assert s.shape == a.shape == (2, 11, 32)
    got = hashlib.sha256(s.numpy().tobytes() + a.numpy().tobytes())
    assert got.hexdigest() == FEATURE_DIGESTS[label]


def test_trunks_import_nothing_of_the_program():
    names = trunk_files(REPO / "gpubench" / "reference" / "trunks")
    assert {"__init__.py", "wav2vec2.py"} <= set(names)


def test_an_unknown_trunk_is_named():
    with pytest.raises(ModuleNotFoundError, match="no_such_trunk"):
        trunks.of({"semantic_arch": "no_such_trunk"})
    with pytest.raises(ValueError, match="not a module name"):
        trunks.of({"semantic_arch": "../model"})
