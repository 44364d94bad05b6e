"""A stand-in trunk of a second kind, for the tests: a pre-norm ("stable
layer norm") wav2vec2 at the rate its configuration gives (24 kHz in the
tests), with conv biases and a LayerNorm over channels after every conv of
its extractor, the encoder's LayerNorm after the last layer: the kind of
trunk MERT-v1-330M has.  A test copies it to
``gpubench/reference/trunks/prenorm.py`` of a checkout; nothing imports it
from here.  The program runs no such trunk yet, so its parameter names are
this file's own; the module interface is ``trunks/__init__.py``'s.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..model import NORM_EPS, Ops


def rate(cfg: Dict) -> int:
    return cfg["semantic_arch_config"]["sample_rate"]


def frames(samples: int, cfg: Dict) -> int:
    t = samples
    for _, kernel, stride in cfg["semantic_arch_config"]["conv_layers"]:
        t = (t - kernel) // stride + 1
    return t


class FeatureExtractor(nn.Module):
    def __init__(self, conv_layers):
        super().__init__()
        ins = (1, *(c[0] for c in conv_layers[:-1]))
        self.convs = nn.ModuleList(
            nn.Conv1d(i, c[0], c[1], stride=c[2])
            for i, c in zip(ins, conv_layers))
        self.layer_norms = nn.ModuleList(nn.LayerNorm(c[0], eps=NORM_EPS)
                                         for c in conv_layers)


class Layer(nn.Module):
    def __init__(self, hidden, ffn_dim):
        super().__init__()
        self.layer_norm = nn.LayerNorm(hidden, eps=NORM_EPS)
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=NORM_EPS)
        self.fc1 = nn.Linear(hidden, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, hidden)


class Trunk(nn.Module):
    def __init__(self, a: Dict):
        super().__init__()
        h = a["hidden"]
        feat = a["conv_layers"][-1][0]
        self.feature_extractor = FeatureExtractor(a["conv_layers"])
        self.fp_layer_norm = nn.LayerNorm(feat, eps=NORM_EPS)
        self.fp_projection = nn.Linear(feat, h)
        self.pos_conv = nn.Conv1d(h, h, a["pos_conv_kernel"],
                                  groups=a["pos_conv_groups"])
        self.layers = nn.ModuleList(Layer(h, a["ffn_dim"])
                                    for _ in range(a["num_layers"]))
        self.encoder_layer_norm = nn.LayerNorm(h, eps=NORM_EPS)
        self.num_heads = a["num_heads"]


class SemanticEncoder(nn.Module):
    def __init__(self, output_dim: int, a: Dict):
        super().__init__()
        self.prenorm = Trunk(a)
        self.projection = nn.Linear(a["hidden"], output_dim)


def holder(cfg: Dict) -> SemanticEncoder:
    return SemanticEncoder(cfg["semantic_dim"], cfg["semantic_arch_config"])


def _ln(x, m: nn.LayerNorm):
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, NORM_EPS)


def forward(m: SemanticEncoder, wave: torch.Tensor,
            ops: Ops) -> torch.Tensor:
    """``[B, S]`` at the trunk's rate → ``[B, T', D]``."""
    w = m.prenorm
    h = wave[:, None]
    fe = w.feature_extractor
    for conv, ln in zip(fe.convs, fe.layer_norms):
        h = ops.conv1d(h, conv, stride=conv.stride)
        h = ops.trunk_gelu(_ln(h.transpose(1, 2), ln).transpose(1, 2))
    h = ops.linear(_ln(h.transpose(1, 2), w.fp_layer_norm), w.fp_projection)
    t = h.shape[1]
    k = w.pos_conv.kernel_size[0]
    pos = ops.conv1d(h.transpose(1, 2), w.pos_conv, padding=k // 2,
                     groups=w.pos_conv.groups)[:, :, :t].transpose(1, 2)
    h = h + ops.trunk_gelu(pos)
    b = h.shape[0]
    for layer in w.layers:
        x = _ln(h, layer.layer_norm)

        def heads(proj):
            return ops.linear(x, proj).reshape(b, t, w.num_heads,
                                               -1).transpose(1, 2)
        q, kk, v = heads(layer.query), heads(layer.key), heads(layer.value)
        scores = (ops.q(q) @ ops.q(kk).transpose(-1, -2)
                  / math.sqrt(q.shape[-1]))
        attn = ops.q(torch.softmax(scores, dim=-1)) @ ops.q(v)
        h = h + ops.linear(attn.transpose(1, 2).reshape(b, t, -1), layer.out)
        x = _ln(h, layer.final_layer_norm)
        h = h + ops.linear(ops.trunk_gelu(ops.linear(x, layer.fc1)),
                           layer.fc2)
    return ops.linear(_ln(h, w.encoder_layer_norm), m.projection)


def span_flops(samples: int, own: float, cfg: Dict
               ) -> Tuple[float, Tuple[float, ...]]:
    """As wav2vec2's: norms and biases are not counted."""
    a = cfg["semantic_arch_config"]
    h, f = a["hidden"], a["ffn_dim"]
    extractor, t, cin = 0.0, samples, 1
    for cout, kernel, stride in a["conv_layers"]:
        t = (t - kernel) // stride + 1
        extractor += 2.0 * t * cin * cout * kernel
        cin = cout
    pos = 2.0 * h * (h // a["pos_conv_groups"]) * a["pos_conv_kernel"]
    layer = 2.0 * 4 * h * h + 2.0 * 2 * h * f
    frame = 2.0 * cin * h + pos + a["num_layers"] * layer
    q = t * own
    return extractor, (q * (frame + 2.0 * h * cfg["semantic_dim"]),
                       a["num_layers"] * 4.0 * q * t * h)
