"""Weights and codebooks from the seed, made on the card in a few large calls
and handed alike to the program and to the reference.

The codebooks first, then one ``torch.randn`` per module for all its values
at once (the decoder last, so the other values do not depend on whether the
mix reconstructs), each leaf then scaled in place: linear and conv kernels
normal with variance ``1/fan_in`` (Flax's LeCun default, the program's own
init), norm scales ``1 + 0.1·n``, biases and norm offsets ``0.05·n`` (non-
zero, so the comparison covers them); codebooks standard normal, as the
program's random ladder. The same seed on the same device gives the same
tensors, so the reference makes them again after the window instead of
holding a copy.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .reference import model

Params = Dict[str, Dict[str, torch.Tensor]]


def make(cfg: Dict, seed: int, device, reconstruct: bool
         ) -> Tuple[Params, Tuple[torch.Tensor, torch.Tensor]]:
    """``(params by module, (semantic codebook, acoustic codebook))``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    nq = cfg["num_quantizers"] // 2
    k = cfg["codebook_size"]
    sem = torch.randn((nq, k, cfg["semantic_dim"]), generator=gen,
                      device=device)
    acc = torch.randn((nq, k, cfg["acoustic_dim"]), generator=gen,
                      device=device)
    params: Params = {}
    for name, m in model.build(cfg, reconstruct).items():
        shapes = [(key, tuple(t.shape)) for key, t in m.state_dict().items()]
        flat = torch.randn(sum(math.prod(s) for _, s in shapes),
                           generator=gen, device=device)
        params[name] = {}
        offset = 0
        for key, shape in shapes:
            n = math.prod(shape)
            leaf = flat[offset:offset + n].view(shape)
            offset += n
            if len(shape) >= 2:
                leaf.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
            elif key.endswith("weight"):
                leaf.mul_(0.1).add_(1.0)
            else:
                leaf.mul_(0.05)
            params[name][key] = leaf
    return params, (sem, acc)
