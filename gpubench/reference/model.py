"""The plain reference of the tokenizer's forward and decoder, in float32.

Plain PyTorch and NumPy: it imports nothing of the program.  It follows
the port's modules (``nat_tpu_torch/models/{semantic,encoders,decoder}.py``,
``nat_tpu_torch/dsp/``) with the same parameter names, so one state dict
fits both, and it works out again everything the program derives: the
resampling filter, the STFT window, the mel matrix, the alignment.  The
resampler is the direct sum of the polyphase formula, the alignment
``F.interpolate``'s linear mode; neither is the program's form of them.

Precision is set by :class:`Numerics`.  The reference is IEEE float32 (TF32
off) everywhere; the wav2vec2 trunk's GELU is the tanh form when the
configuration computes in bfloat16, as the port's model defines it (erf in
float32).  The control, ``Numerics(encoders="fp8", tf32=True)``, is the
reference one step below what the configuration states: every product of
the encoders (linear layers, convolutions, attention's scores and weighted
sum) on operands rounded to float8 e4m3 with a per-tensor scale, where the
configuration computes in bfloat16; the RVQ distances and the decoder in
TF32, where it computes in float32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NORM_EPS = 1e-6
SEMANTIC_SR = 16000
FP8_MAX = 448.0      # largest float8 e4m3 value


class Numerics(NamedTuple):
    encoders: str = "float32"     # or "fp8": the control
    tf32: bool = False            # RVQ distances and decoder in TF32
    trunk_gelu_tanh: bool = True  # the configuration's bf16 trunk


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The products of the encoders, at the numerics asked for."""

    def __init__(self, numerics: Numerics) -> None:
        self.fp8 = numerics.encoders == "fp8"
        self.trunk_tanh = numerics.trunk_gelu_tanh

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.fp8 else t

    def linear(self, x, m: nn.Linear):
        return F.linear(self.q(x), self.q(m.weight), m.bias)

    def conv1d(self, x, m: nn.Conv1d, **kw):
        return F.conv1d(self.q(x), self.q(m.weight), m.bias, **kw)

    def conv2d(self, x, m: nn.Conv2d, **kw):
        return F.conv2d(self.q(x), self.q(m.weight), m.bias, **kw)

    def trunk_gelu(self, x):
        return F.gelu(x, approximate="tanh" if self.trunk_tanh else "none")


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def same_padding(size: int, kernel: int, stride: int):
    """XLA ``SAME`` padding ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def resize(x: torch.Tensor, new_t: int) -> torch.Tensor:
    """Linear resize of the last axis (align_corners=False)."""
    if x.shape[-1] == new_t:
        return x
    lead = x.shape[:-1]
    y = F.interpolate(x.reshape(1, -1, x.shape[-1]), size=new_t,
                      mode="linear", align_corners=False)
    return y.reshape(*lead, new_t)


# ---------------------------------------------------------------------------
# DSP
# ---------------------------------------------------------------------------
def kaiser_sinc(up: int, down: int) -> np.ndarray:
    """The resampler's low-pass: kaiser(5.0)-windowed sinc of 10 zero
    crossings a side at the lower Nyquist, unity gain after upsampling."""
    max_rate = max(up, down)
    cutoff = 1.0 / max_rate
    numtaps = 2 * 10 * max_rate + 1
    n = np.arange(numtaps) - (numtaps - 1) / 2
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(numtaps, 5.0)
    return h * (up / np.sum(h))


def resample(x: torch.Tensor, sr: int, new_sr: int) -> torch.Tensor:
    """``y[m] = Σ_j x[j] · h[m·down − j·up + half]`` over the taps that
    exist, for ``x [B, T]``: the direct polyphase sum."""
    g = math.gcd(sr, new_sr)
    up, down = new_sr // g, sr // g
    h = torch.from_numpy(kaiser_sinc(up, down).astype(np.float32)).to(x.device)
    numtaps = h.numel()
    half = (numtaps - 1) // 2
    t = x.shape[-1]
    out_len = int(math.ceil(t * up / down))
    m = torch.arange(out_len, device=x.device, dtype=torch.int64)
    j_lo = torch.div(m * down + half - (numtaps - 1) + up - 1, up,
                     rounding_mode="floor")
    width = -(-numtaps // up) + 1
    j = j_lo[:, None] + torch.arange(width, device=x.device)[None, :]
    tap = m[:, None] * down - j * up + half
    valid = (tap >= 0) & (tap < numtaps) & (j >= 0) & (j < t)
    weights = torch.where(valid, h[tap.clamp(0, numtaps - 1)],
                          torch.zeros((), device=x.device))
    samples = x[:, j.clamp(0, t - 1)]                       # [B, out, width]
    return torch.sum(samples * weights[None], dim=-1)


def mel_matrix(n_freqs: int, n_mels: int, sr: int) -> np.ndarray:
    """HTK-scale triangular filters ``[n_freqs, n_mels]``, no norm, from 0
    to Nyquist."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sr // 2, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down_ = -slopes[:, :-2] / f_diff[:-1]
    up_ = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down_, up_)).astype(np.float32)


def log_mel(x: torch.Tensor, sr: int, n_fft: int, hop: int,
            n_mels: int) -> torch.Tensor:
    """``log(mel + 1e-5)`` of the centered, reflect-padded power STFT
    (periodic Hann) divided by ``Σ window²``: ``[B, n_mels, frames]``."""
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32,
                               device=x.device)
    spec = torch.stft(x, n_fft=n_fft, hop_length=hop, win_length=n_fft,
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec.abs() ** 2 / torch.sum(window * window)
    fb = torch.from_numpy(mel_matrix(n_fft // 2 + 1, n_mels, sr)).to(x.device)
    return torch.log(torch.einsum("bft,fm->bmt", power, fb) + 1e-5)


# ---------------------------------------------------------------------------
# Modules (parameter holders named as the port's; forwards are functions)
# ---------------------------------------------------------------------------
class FeatureExtractor(nn.Module):
    def __init__(self, conv_layers):
        super().__init__()
        ins = (1, *(c[0] for c in conv_layers[:-1]))
        self.convs = nn.ModuleList(
            nn.Conv1d(i, c[0], c[1], stride=c[2], bias=False)
            for i, c in zip(ins, conv_layers))
        self.group_norm = nn.GroupNorm(conv_layers[0][0], conv_layers[0][0],
                                       eps=NORM_EPS)


class Layer(nn.Module):
    def __init__(self, hidden, ffn_dim):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)
        self.layer_norm = nn.LayerNorm(hidden, eps=NORM_EPS)
        self.fc1 = nn.Linear(hidden, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, hidden)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=NORM_EPS)


class Wav2Vec2(nn.Module):
    def __init__(self, a: Dict):
        super().__init__()
        h = a["hidden"]
        feat = a["conv_layers"][-1][0]
        self.feature_extractor = FeatureExtractor(a["conv_layers"])
        self.fp_layer_norm = nn.LayerNorm(feat, eps=NORM_EPS)
        self.fp_projection = nn.Linear(feat, h)
        self.pos_conv = nn.Conv1d(h, h, a["pos_conv_kernel"],
                                  groups=a["pos_conv_groups"])
        self.encoder_layer_norm = nn.LayerNorm(h, eps=NORM_EPS)
        self.layers = nn.ModuleList(Layer(h, a["ffn_dim"])
                                    for _ in range(a["num_layers"]))
        self.num_heads = a["num_heads"]
        self.conv_layers = [tuple(c) for c in a["conv_layers"]]


class SemanticEncoder(nn.Module):
    def __init__(self, output_dim: int, a: Dict):
        super().__init__()
        self.wav2vec2 = Wav2Vec2(a)
        self.projection = nn.Linear(a["hidden"], output_dim)


class ConvNorm2d(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, 3, stride=stride)
        self.norm = nn.GroupNorm(min(8, cout), cout, eps=NORM_EPS)


class MelEncoder(nn.Module):
    def __init__(self, output_dim, n_mels, hop, sr,
                 channels=(32, 64, 128, 256, 512, 512)):
        super().__init__()
        ins = (1, *channels[:-1])
        self.blocks = nn.ModuleList(
            ConvNorm2d(i, o, 2 if n < 4 else 1)
            for n, (i, o) in enumerate(zip(ins, channels)))
        self.proj = nn.Conv2d(channels[-1], output_dim, 1)
        self.n_mels, self.hop, self.sr = n_mels, hop, sr


class ConvNorm1d(nn.Module):
    def __init__(self, cin, cout, kernel, stride=1):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride)
        self.norm = nn.GroupNorm(min(8, cout), cout, eps=NORM_EPS)


class Temporal(nn.Module):
    def __init__(self, dim, scales=(1, 2, 4, 8, 16), branch=128):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(ConvNorm1d(dim, branch, 2 * s + 1, s),
                          ConvNorm1d(branch, branch, 3))
            for s in scales)
        self.fuse = nn.Conv1d(branch * len(scales), dim, 1)


class Decoder(nn.Module):
    def __init__(self, input_dim, channels=(512, 256, 128), kernel=5):
        super().__init__()
        ins = (input_dim, *channels)
        outs = (*channels, 1)
        self.convs = nn.ModuleList(nn.Conv1d(i, o, kernel, padding=kernel // 2)
                                   for i, o in zip(ins, outs))


def build(cfg: Dict, reconstruct: bool) -> Dict[str, nn.Module]:
    """The modules by the port's names (``decoder`` only with
    reconstruction), uninitialized, on the meta device."""
    with torch.device("meta"):
        mods = {
            "mel_encoder": MelEncoder(cfg["acoustic_dim"], cfg["n_mels"],
                                      cfg["hop_length"], cfg["sample_rate"]),
            "semantic_encoder": SemanticEncoder(cfg["semantic_dim"],
                                                cfg["semantic_arch_config"]),
            "temporal_semantic": Temporal(cfg["semantic_dim"]),
            "temporal_acoustic": Temporal(cfg["acoustic_dim"]),
        }
        if reconstruct:
            mods["decoder"] = Decoder(cfg["semantic_dim"]
                                      + cfg["acoustic_dim"])
    return mods


# ---------------------------------------------------------------------------
# Forwards
# ---------------------------------------------------------------------------
def trunk(m: SemanticEncoder, wave16: torch.Tensor, ops: Ops) -> torch.Tensor:
    """``[B, S16]`` → ``[B, T', D]``."""
    w = m.wav2vec2
    h = wave16[:, None]
    for i, conv in enumerate(w.feature_extractor.convs):
        h = ops.conv1d(h, conv, stride=conv.stride)
        if i == 0:
            gn = w.feature_extractor.group_norm
            h = F.group_norm(h, gn.num_groups, gn.weight, gn.bias, NORM_EPS)
        h = ops.trunk_gelu(h)
    feats = h.transpose(1, 2)
    ln = w.fp_layer_norm
    h = ops.linear(F.layer_norm(feats, ln.normalized_shape, ln.weight,
                                ln.bias, NORM_EPS), w.fp_projection)
    t = h.shape[1]
    k = w.pos_conv.kernel_size[0]
    pos = ops.conv1d(h.transpose(1, 2), w.pos_conv, padding=k // 2,
                     groups=w.pos_conv.groups)[:, :, :t].transpose(1, 2)
    ln = w.encoder_layer_norm
    h = F.layer_norm(h + ops.trunk_gelu(pos), ln.normalized_shape, ln.weight,
                     ln.bias, NORM_EPS)
    b = h.shape[0]
    for layer in w.layers:
        def heads(proj):
            return ops.linear(h, proj).reshape(b, t, w.num_heads,
                                               -1).transpose(1, 2)
        q, kk, v = heads(layer.query), heads(layer.key), heads(layer.value)
        scores = (ops.q(q) @ ops.q(kk).transpose(-1, -2)
                  / math.sqrt(q.shape[-1]))
        attn = ops.q(torch.softmax(scores, dim=-1)) @ ops.q(v)
        attn = ops.linear(attn.transpose(1, 2).reshape(b, t, -1), layer.out)
        ln = layer.layer_norm
        h = F.layer_norm(h + attn, ln.normalized_shape, ln.weight, ln.bias,
                         NORM_EPS)
        ffn = ops.linear(ops.trunk_gelu(ops.linear(h, layer.fc1)), layer.fc2)
        ln = layer.final_layer_norm
        h = F.layer_norm(h + ffn, ln.normalized_shape, ln.weight, ln.bias,
                         NORM_EPS)
    return ops.linear(h, m.projection)


def _block(x, blk, ops: Ops):
    """conv (SAME) → GroupNorm → tanh-GELU, 1-D or 2-D."""
    if isinstance(blk, ConvNorm2d):
        h_lo, h_hi = same_padding(x.shape[2], 3, blk.stride)
        w_lo, w_hi = same_padding(x.shape[3], 3, blk.stride)
        x = ops.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)), blk.conv,
                       stride=blk.stride)
    else:
        x = ops.conv1d(F.pad(x, same_padding(x.shape[2], blk.kernel,
                                             blk.stride)),
                       blk.conv, stride=blk.stride)
    x = F.group_norm(x, blk.norm.num_groups, blk.norm.weight, blk.norm.bias,
                     NORM_EPS)
    return gelu_tanh(x)


def mel_stack(m: MelEncoder, wave: torch.Tensor, sr: int,
              ops: Ops) -> torch.Tensor:
    """``[B, S]`` → ``[B, T/16, D]``."""
    x = log_mel(wave, sr, 2048, m.hop, m.n_mels).transpose(1, 2)[:, None]
    for blk in m.blocks:
        x = _block(x, blk, ops)
    x = ops.conv2d(x, m.proj)
    return x.mean(dim=3).transpose(1, 2)


def temporal(m: Temporal, x: torch.Tensor, ops: Ops) -> torch.Tensor:
    """``[B, T, D]`` → ``[B, T, D]``."""
    t = x.shape[1]
    x = x.transpose(1, 2)
    parts = []
    for branch in m.branches:
        h = x
        for blk in branch:
            h = _block(h, blk, ops)
        parts.append(resize(h, t))
    return ops.conv1d(torch.cat(parts, dim=1), m.fuse).transpose(1, 2)


def span_features(mods: Dict[str, nn.Module], wave: torch.Tensor, sr: int,
                  t_target: int, ops: Ops):
    """Both streams of a padded batch ``[B, bucket]``, aligned to
    ``t_target``: ``([B, T, Ds], [B, T, Da])``."""
    sem = temporal(mods["temporal_semantic"],
                   trunk(mods["semantic_encoder"],
                         resample(wave, sr, SEMANTIC_SR), ops), ops)
    acc = temporal(mods["temporal_acoustic"],
                   mel_stack(mods["mel_encoder"], wave, sr, ops), ops)

    def align(f):
        return resize(f.transpose(1, 2), t_target).transpose(1, 2)

    return align(sem), align(acc)


def decode(dec: Decoder, joint: torch.Tensor,
           out_samples: int) -> torch.Tensor:
    """``[B, T, C]`` quantized → ``[B, out_samples]``."""
    h = joint.transpose(1, 2)
    for conv in dec.convs[:-1]:
        h = gelu_tanh(F.conv1d(h, conv.weight, conv.bias, padding=2))
    last = dec.convs[-1]
    wave = torch.tanh(F.conv1d(h, last.weight, last.bias, padding=2)[:, 0])
    return resize(wave, out_samples)


def distances(r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[M, K]`` of rows ``r`` to codewords ``c``."""
    return ((r * r).sum(1, keepdim=True) - 2.0 * (r @ c.T)
            + (c * c).sum(1)[None])


def rvq_codes(x: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Argmin residual VQ of ``x [M, D]``: codes ``[M, N]`` (lowest index on
    ties)."""
    r = x.clone()
    codes = []
    for c in codebook:
        d = distances(r, c)
        idx = torch.argmin(d, dim=1)
        codes.append(idx)
        r = r - c[idx]
    return torch.stack(codes, dim=1)


def code_gaps(x: torch.Tensor, codes: torch.Tensor,
              codebook: torch.Tensor) -> torch.Tensor:
    """How far each given code lies from the best, in float64: per frame
    and layer, ``(d(r, chosen) − min_k d(r, k)) / min_k d(r, k)``, the
    residual ``r`` following the given codes (as the program's chain did)."""
    r = x.double()
    out = []
    for layer, c in enumerate(codebook.double()):
        d = distances(r, c)
        best = d.min(dim=1).values
        chosen = d.gather(1, codes[:, layer:layer + 1].long())[:, 0]
        out.append((chosen - best) / best.clamp_min(1e-300))
        r = r - c[codes[:, layer].long()]
    return torch.stack(out, dim=1)


def tf32(enabled: bool):
    """A context with TF32 on or off for matmuls and cuDNN."""
    class _Ctx:
        def __enter__(self):
            self.saved = (torch.backends.cuda.matmul.allow_tf32,
                          torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = enabled
            torch.backends.cudnn.allow_tf32 = enabled

        def __exit__(self, *exc):
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = self.saved

    return _Ctx()


def load(mods: Dict[str, nn.Module],
         params: Dict[str, Dict[str, torch.Tensor]],
         device) -> Dict[str, nn.Module]:
    """The modules on ``device`` in float32 with ``params``' values."""
    out = {}
    for name, m in mods.items():
        m = m.to_empty(device=device).float()
        m.load_state_dict(params[name], strict=True)
        out[name] = m.eval().requires_grad_(False)
    return out
