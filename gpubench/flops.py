"""Peaks of the card and the arithmetic of the work: the forward's FLOPs per
file and K1's least time per call.

The FLOPs count what a file's own samples need, from the configuration's
shapes: neither the bucket padding nor the span overlap.  Each span adds
the frames of the samples it is responsible for; its attention runs those
frames against the frames of its real extended window.  A multiply-add is
two FLOPs.  Counted, in the forward's order: the 22.05 → 16 kHz polyphase
resampler, the wav2vec2 conv extractor, the feature projection, the
positional conv, the transformer layers, the projection to the semantic
width, the log-mel front end (FFT and mel matrix), the acoustic conv stack,
both temporal encoders, the two RVQ chains' distances, and, where the mix
reconstructs, the decoder over the file's frames.  Norms, activations and
the alignment's lerp are left out (a few per element, under 1% here).
"""

from __future__ import annotations

import math
from typing import Dict

from . import plan

# NVIDIA H100 SXM data sheet, dense, at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12          # outside the tensor cores (K1 runs here)
PEAK_HBM_BYTES = 3.35e12

MEL_CHANNELS = (32, 64, 128, 256, 512, 512)
TEMPORAL_SCALES = (1, 2, 4, 8, 16)
TEMPORAL_BRANCH = 128
DECODER_CHANNELS = (512, 256, 128, 1)
DECODER_KERNEL = 5
# One STFT frame's FFT, by the usual count of 5·N·log2(N).
FFT_FLOPS = 5.0 * plan.N_FFT * math.log2(plan.N_FFT)


def chain_bound(m: int, n: int, k: int, d: int) -> float:
    """Least seconds of one RVQ chain call (``chip_smoke.chain_bound``):
    its 2·M·N·K·D fp32 FLOPs at the fp32 peak, against x, the codebook,
    codes, errors and qsum read or written once at the HBM rate."""
    ops = 2.0 * m * n * k * d
    nbytes = 4.0 * (m * d + n * k * d + 2 * n * m + m * d)
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)


def _resampler(samples: int, sr: int) -> float:
    """Each output sample sums the input under its phase of the
    kaiser-windowed sinc (2·10·max(up, down) + 1 taps over ``up`` phases)."""
    g = math.gcd(plan.SEMANTIC_SR, sr)
    up, down = plan.SEMANTIC_SR // g, sr // g
    taps = -(-(2 * 10 * max(up, down) + 1) // up)
    return 2.0 * plan.resample_length(samples, sr, plan.SEMANTIC_SR) * taps


def _trunk_frame(a: Dict) -> float:
    """Per-frame FLOPs of the feature projection, positional conv and the
    layers' projections and FFN (attention's scores apart)."""
    h, f = a["hidden"], a["ffn_dim"]
    feat = a["conv_layers"][-1][0]
    pos = 2.0 * h * (h // a["pos_conv_groups"]) * a["pos_conv_kernel"]
    layer = 2.0 * 4 * h * h + 2.0 * 2 * h * f
    return 2.0 * feat * h + pos + a["num_layers"] * layer


def _extractor(t16: int, a: Dict) -> float:
    total, t, cin = 0.0, t16, 1
    for cout, kernel, stride in a["conv_layers"]:
        t = (t - kernel) // stride + 1
        total += 2.0 * t * cin * cout * kernel
        cin = cout
    return total


def _mel_stack(mel_t: int, n_mels: int, out_dim: int) -> float:
    total, t, m, cin = 0.0, mel_t, n_mels, 1
    for i, cout in enumerate(MEL_CHANNELS):
        if i < 4:
            t, m = -(-t // 2), -(-m // 2)
        total += 2.0 * t * m * cin * cout * 9
        cin = cout
    return total + 2.0 * t * m * cin * out_dim


def _temporal(t: int, dim: int) -> float:
    total = 0.0
    for s in TEMPORAL_SCALES:
        ts = -(-t // s)
        total += 2.0 * ts * dim * TEMPORAL_BRANCH * (2 * s + 1)
        total += 2.0 * ts * TEMPORAL_BRANCH * TEMPORAL_BRANCH * 3
    return total + 2.0 * t * TEMPORAL_BRANCH * len(TEMPORAL_SCALES) * dim


def file_flops(samples: int, cfg: Dict, reconstruct: bool) -> float:
    """FLOPs the forward needs for one file of ``samples`` (see above)."""
    sr, hop = cfg["sample_rate"], cfg["hop_length"]
    a = cfg["semantic_arch_config"]
    d_sem, d_acc = cfg["semantic_dim"], cfg["acoustic_dim"]
    total = 0.0
    for span in plan.spans_of(samples, sr):
        own = span.length / max(span.ext_len, 1)   # share of real samples
        ext16 = plan.resample_length(span.ext_len, sr, plan.SEMANTIC_SR)
        t_sem = plan.extractor_length(ext16, a["conv_layers"])
        mel_t = plan.mel_frames(span.ext_len, hop)
        t_acc = plan.acoustic_frames(span.ext_len, hop)
        q_sem = t_sem * own                        # the span's own frames
        per_span = (_resampler(span.ext_len, sr) + _extractor(ext16, a)
                    + mel_t * (FFT_FLOPS
                               + 2.0 * (plan.N_FFT // 2 + 1) * cfg["n_mels"])
                    + _mel_stack(mel_t, cfg["n_mels"], d_acc)
                    + _temporal(t_sem, d_sem) + _temporal(t_acc, d_acc))
        total += per_span * own
        total += q_sem * (_trunk_frame(a) + 2.0 * a["hidden"] * d_sem)
        # scores and the weighted sum: 2 products of [t, hidden]·[hidden, T]
        total += a["num_layers"] * 4.0 * q_sem * t_sem * a["hidden"]
    frames = plan.file_frames(samples, sr, cfg)
    k = cfg["codebook_size"]
    nq = cfg["num_quantizers"] // 2
    total += 2.0 * frames * nq * k * (d_sem + d_acc)
    if reconstruct:
        cin = d_sem + d_acc
        for cout in DECODER_CHANNELS:
            total += 2.0 * frames * cin * cout * DECODER_KERNEL
            cin = cout
    return total


def k1_bound(frames: int, cfg: Dict) -> float:
    """Least seconds of K1 for one file's ``frames``: one chain per stream."""
    nq = cfg["num_quantizers"] // 2
    k = cfg["codebook_size"]
    return (chain_bound(frames, nq, k, cfg["semantic_dim"])
            + chain_bound(frames, nq, k, cfg["acoustic_dim"]))
