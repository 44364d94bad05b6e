"""The post-norm wav2vec2 trunk at 16 kHz, as the port's
``nat_tpu_torch/models/semantic.py`` runs it at any size that
``semantic_arch_config`` gives (wav2vec2-base, wav2vec2-large-960h).

A bias-free strided conv extractor with a GroupNorm after conv 0 only, the
feature projection, a grouped positional conv, post-norm layers (the
encoder's LayerNorm after the positional conv, each layer's after its
residual adds), then the tokenizer's projection to ``semantic_dim``.  The
module interface is ``trunks/__init__.py``'s.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..model import NORM_EPS, Ops

RATE = 16000


def rate(cfg: Dict) -> int:
    return RATE


def extractor_length(t: int, conv_layers: Sequence[Sequence[int]]) -> int:
    for _, kernel, stride in conv_layers:
        t = (t - kernel) // stride + 1
    return t


def frames(samples: int, cfg: Dict) -> int:
    return extractor_length(samples,
                            cfg["semantic_arch_config"]["conv_layers"])


# ---------------------------------------------------------------------------
# Parameter holders, named as the port's
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


def holder(cfg: Dict) -> SemanticEncoder:
    return SemanticEncoder(cfg["semantic_dim"], cfg["semantic_arch_config"])


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------
def forward(m: SemanticEncoder, wave16: torch.Tensor,
            ops: Ops) -> torch.Tensor:
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


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
def _frame(a: Dict) -> float:
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


def span_flops(samples: int, own: float, cfg: Dict
               ) -> Tuple[float, Tuple[float, ...]]:
    """The conv extractor over the window; the own frames' projections,
    FFN and projection to ``semantic_dim``, then attention: scores and the
    weighted sum, 2 products of ``[t, hidden]·[hidden, T]`` a layer."""
    a = cfg["semantic_arch_config"]
    t = frames(samples, cfg)
    q = t * own
    return _extractor(samples, a), (
        q * (_frame(a) + 2.0 * a["hidden"] * cfg["semantic_dim"]),
        a["num_layers"] * 4.0 * q * t * a["hidden"])
