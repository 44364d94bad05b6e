"""Span and frame arithmetic of the tokenizer, frozen here so the yardstick
does not move with the program.

Copied from ``nat_tpu_torch/runtime/bucketing.py`` (buckets, the span plan
with its first-frame ramp) and ``nat_tpu_torch/models/tokenizer.py``
(``_acoustic_frames``, ``_semantic_frames``, ``_target_frames``, the
keep-mask of ``finalize_span``, ``_plan_span_groups``, ``_pad_group_rows``)
at the program's defaults: the ramp on, timebase ``compat``, span groups of
8 on the card.  The semantic frames are the configuration's trunk's
(``reference/trunks/<kind>.py``: its input rate and frame count).  The
reference uses it to cut a file into the spans the program forwards; the
FLOP count and the warm-up use it to know the work and the shapes.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Set, Tuple

import numpy as np

from .reference import trunks

BUCKET_SECONDS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 30.0)
MAX_SINGLE_CHUNK_S = 30.0
FIRST_SPAN_S = 4.0
N_FFT = 2048


class Span(NamedTuple):
    ext_start: int   # first sample of the overlap-extended span
    start: int       # first sample the span is responsible for
    length: int      # samples it is responsible for
    overlap: int     # overlap margin (0 for a single-span signal)
    ext_len: int     # real samples of the extended span
    bucket: int      # padded length of its forward


def bucket_length(num_samples: int, sr: int) -> int:
    for seconds in BUCKET_SECONDS:
        b = int(round(seconds * sr))
        if num_samples <= b:
            return b
    return int(round(MAX_SINGLE_CHUNK_S * sr))


def chunk_spans(num_samples: int, sr: int,
                overlap: int) -> List[Tuple[int, int]]:
    """``(start, length)`` spans; the first fills the 4 s bucket exactly."""
    max_len = int(round(MAX_SINGLE_CHUNK_S * sr))
    if num_samples <= max_len:
        return [(0, num_samples)]
    core_len = max(max_len - 2 * overlap, max_len // 2)
    spans = []
    start = 0
    if overlap > 0:
        l0 = int(round(FIRST_SPAN_S * sr)) - overlap
        if 0 < l0 < core_len:
            spans.append((0, l0))
            start = l0
    while start < num_samples:
        length = min(core_len, num_samples - start)
        spans.append((start, length))
        start += length
    return spans


def spans_of(num_samples: int, sr: int) -> List[Span]:
    """The spans the program forwards for a signal of ``num_samples``."""
    overlap = int(sr)
    raw = chunk_spans(num_samples, sr, overlap)
    if len(raw) == 1:
        overlap = 0
    out = []
    for start, length in raw:
        ext_start = max(0, start - overlap)
        ext_len = min(num_samples, start + length + overlap) - ext_start
        out.append(Span(ext_start, start, length, overlap, ext_len,
                        bucket_length(ext_len, sr)))
    return out


def resample_length(num_samples: int, sr: int, new_sr: int) -> int:
    g = math.gcd(int(new_sr), int(sr))
    up, down = new_sr // g, sr // g
    return int(math.ceil(num_samples * up / down))


def mel_frames(num_samples: int, hop: int) -> int:
    return num_samples // hop + 1     # centered STFT


def acoustic_frames(num_samples: int, hop: int) -> int:
    return -(-mel_frames(num_samples, hop) // 16)   # four stride-2 convs


def semantic_frames(num_samples: int, sr: int, cfg: Dict) -> int:
    """The configuration's trunk's frames of a signal resampled to its
    rate."""
    trunk = trunks.of(cfg)
    return trunk.frames(resample_length(num_samples, sr, trunk.rate(cfg)),
                        cfg)


def target_frames(num_samples: int, sr: int, cfg: Dict) -> int:
    return max(min(semantic_frames(num_samples, sr, cfg),
                   acoustic_frames(num_samples, cfg["hop_length"])), 1)


def kept(span: Span, sr: int, cfg: Dict) -> np.ndarray:
    """Indices of the frames of a span's forward that the program keeps:
    the first ``valid_t`` (those of its real samples), and of an interior
    span those whose centres fall inside its own extent."""
    valid_t = target_frames(span.ext_len, sr, cfg)
    idx = np.arange(valid_t)
    if not span.overlap:
        return idx
    centers = span.ext_start + (idx + 0.5) * (span.ext_len / max(valid_t, 1))
    keep = (centers >= span.start) & (centers < span.start + span.length)
    return idx[keep]


def file_frames(num_samples: int, sr: int, cfg: Dict) -> int:
    return int(sum(len(kept(s, sr, cfg)) for s in spans_of(num_samples, sr)))


def plan_items(spans: List[Span], group: int) -> List[List[Span]]:
    """The dispatch items of a file's span loop: the first span alone, then
    runs of same-bucket spans in groups of at most ``group``."""
    items: List[List[Span]] = []
    i = 0
    if group > 1 and len(spans) > 1:
        items.append([spans[0]])
        i = 1
    while i < len(spans):
        if group == 1:
            items.append([spans[i]])
            i += 1
            continue
        j = i
        while (j < len(spans) and j - i < group
               and spans[j].bucket == spans[i].bucket):
            j += 1
        items.append(spans[i:j])
        i = j
    return items


def padded_rows(rows: int, group: int) -> int:
    """Rows of a forward of ``rows`` spans: the next power of two, at most
    the group."""
    target = 1
    while target < rows:
        target *= 2
    return min(target, max(group, 1))


def file_shapes(num_samples: int, sr: int, group: int) -> Set[Tuple[int, int]]:
    """``(bucket, rows)`` of every forward of one file's span loop."""
    return {(item[0].bucket, padded_rows(len(item), group))
            for item in plan_items(spans_of(num_samples, sr), group)}
