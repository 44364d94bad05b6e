"""Traffic from a seed: the signal, the files pool and the open-loop
schedule.  One general generator reads every mix's parameters
(``traffic/<name>.json``).

Every seed gets the same set of sizes and gaps, in another order: sizes are
the quantiles of a log-uniform law, gaps those of an exponential law (a
Poisson process), each permuted by the seed, and the audio is cut from a
seeded signal at seeded offsets.  So seeds change the order and the content,
never the amount of work.

The signal is ``chip_smoke.py``'s ``write_wav``: a slowly swept tone, a
gated 660 Hz tone and white noise, 16-bit PCM.
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def signal(seed: int, seconds: float, sr: int) -> np.ndarray:
    """``write_wav``'s signal as int16 PCM (scaled as ``encode_wav_pcm16``)."""
    n = np.arange(int(seconds * sr)) / sr
    sweep = np.sin(2 * np.pi * (180.0 + 40.0 * np.sin(0.3 * n)) * n)
    audio = 0.4 * sweep + 0.2 * np.sin(2 * np.pi * 660.0 * n) * (n % 1.0 < 0.5)
    audio = audio + 0.05 * rng(seed, 0).standard_normal(n.size)
    return (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    """A 16-bit mono WAV of ``pcm``."""
    data = np.ascontiguousarray(pcm, dtype="<i2").tobytes()
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data),
                         b"WAVE", b"fmt ", 16, 1, 1, sr, sr * 2, 2, 16,
                         b"data", len(data))
    return header + data


def log_uniform_sizes(n: int, lo_s: float, hi_s: float, sr: int) -> np.ndarray:
    """``n`` lengths in samples at the mid-quantiles of log-uniform(lo, hi)."""
    q = (np.arange(n) + 0.5) / n
    seconds = np.exp(np.log(lo_s) + q * (np.log(hi_s) - np.log(lo_s)))
    return np.round(seconds * sr).astype(np.int64)


class Clip(NamedTuple):
    index: int
    samples: int     # length
    offset: int      # start in the seed's signal
    due_s: float     # send time after the window opens (open loop only)


def pool(params: Dict, seed: int) -> List[Clip]:
    """The files mix: ``pool`` files, in the seed's order."""
    sr = params["sample_rate"]
    sizes = log_uniform_sizes(params["pool"], params["min_s"],
                              params["max_s"], sr)
    r = rng(seed, 1)
    sizes = sizes[r.permutation(len(sizes))]
    span = int(params["signal_s"] * sr)
    offsets = r.integers(0, span - sizes + 1)
    return [Clip(i, int(n), int(o), 0.0)
            for i, (n, o) in enumerate(zip(sizes, offsets))]


def schedule(params: Dict, seed: int, seconds: float,
             rate: float = None) -> List[Clip]:
    """The open-loop mix: ``rate × seconds`` requests due in the window,
    Poisson gaps scaled to fill it exactly, in the seed's order."""
    sr = params["sample_rate"]
    rate = params["rate_per_s"] if rate is None else rate
    n = max(1, int(round(rate * seconds)))
    sizes = log_uniform_sizes(n, params["min_s"], params["max_s"], sr)
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    r = rng(seed, 2)
    sizes = sizes[r.permutation(n)]
    gaps = gaps[r.permutation(n)]
    gaps = gaps * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    span = int(params["signal_s"] * sr)
    offsets = r.integers(0, span - sizes + 1)
    return [Clip(i, int(n_), int(o), float(d))
            for i, (n_, o, d) in enumerate(zip(sizes, offsets, due))]


def clip_pcm(sig: np.ndarray, clip: Clip) -> np.ndarray:
    return sig[clip.offset:clip.offset + clip.samples]


def sample_indices(count: int, want: int, longest: int,
                   seed: int) -> List[int]:
    """``want`` indices of ``count`` drawn from the seed, with ``longest``
    among them: the answers the comparison checks."""
    r = rng(seed, 3)
    picked = set(r.choice(count, size=min(want, count),
                          replace=False).tolist())
    picked.discard(longest)
    picked = sorted(picked)[:max(want - 1, 0)]
    return sorted(picked + [longest])
