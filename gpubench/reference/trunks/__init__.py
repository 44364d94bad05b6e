"""The semantic trunks, one file per kind, found by name.

A configuration's ``"semantic_arch"``, the trunk kind that the program is
given, names its file: ``trunks/<semantic_arch>.py`` holds everything of
the benchmark that belongs to that kind.  It is plain PyTorch and imports
nothing of the program.  It defines:

- ``rate(cfg) -> int``: the samples a second the trunk takes in; the
  tokenizer resamples its input to it.
- ``frames(samples, cfg) -> int``: the trunk's frames of ``samples`` taken
  at its rate.
- ``holder(cfg) -> nn.Module``: the parameters of the program's
  ``semantic_encoder`` (the trunk and its projection to ``semantic_dim``),
  by the port's names.  ``weights.make`` draws them in its
  ``state_dict`` order.
- ``forward(m, wave, ops) -> Tensor``: the float32 forward of a holder,
  ``[B, samples]`` at its rate to ``[B, frames, semantic_dim]``, every
  product through ``ops`` (``model.Ops``), so that the control rounds them.
- ``span_flops(samples, own, cfg) -> (window, own_terms)``: the FLOPs of
  one span of ``samples`` at its rate, of which the share ``own`` is the
  span's own, by the rules of ``flops.py``.  ``window`` is the work over
  the whole window (``file_flops`` counts it at ``own``, with the
  resampler and the acoustic stream); ``own_terms`` is a tuple of the
  work of the span's own frames, which ``file_flops`` adds to the file's
  total one term at a time (a trunk may give a single term).  The pair
  keeps the sum in the order it had before the trunks had files, so the
  counts of the wav2vec2 configurations stay equal to the bit.

A trunk file imports from the reference only ``..model`` (``Ops``,
``NORM_EPS``), never another trunk file.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict


def of(cfg: Dict) -> ModuleType:
    """The trunk file that the configuration ``cfg`` names."""
    kind = cfg["semantic_arch"]
    if not kind.isidentifier():
        raise ValueError(f"semantic_arch {kind!r} is not a module name")
    return importlib.import_module(f"{__name__}.{kind}")
