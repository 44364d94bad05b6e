"""Profiling hooks, port of ``nat_tpu/utils/profiling.py``.

``NAT_TPU_PROFILE=DIR`` starts a ``torch.profiler`` trace (host and, on
the card, CUDA activity) when a pipeline is built; it is written to
``DIR/nat_trace_<pid>.json`` (Chrome trace format, for Perfetto) when it
stops: at :func:`stop_trace`, or at the process's exit.  torch.profiler's
notices (``UserWarning``) at start and stop are not shown: default mode
writes nothing to stderr.

:func:`annotate` names a region two ways: its inclusive wall time summed
into :data:`stage_timings` (under a lock: the daemon's batcher opens
regions on other threads), and, while a profiler records, a
``record_function`` range of the same name in its trace.  With no
profiler running a region costs two clock reads and a locked add.  The
pipeline and the tokenizer use the reference's names and a few of their
own:

- ``nat/file``, one input's whole path, the root; its children
  ``nat/load_audio``, ``nat/sha256``, ``nat/begin`` (the stream's
  header, codebook seeding), ``nat/tokenize``, ``nat/decode`` (the
  reconstruction's whole-file decode, its copy back included),
  ``nat/evaluate`` and ``nat/finish`` (the codes' concatenation, the
  budget meter, the diversity check, the ``end`` event);
- under ``nat/tokenize``: ``nat/pcm16_wire``, ``nat/stage`` (prepare,
  stack, pad rows, start the upload), ``nat/dispatch``, ``nat/prefetch``,
  ``nat/device_get``, ``nat/finalize`` (overlap discard, row slicing) and
  the consumer's ``nat/serialize``;
- under ``nat/evaluate``: ``nat/eval/spectral`` (waveform and STFT
  distances), ``nat/eval/pitch``, ``nat/eval/rhythm``,
  ``nat/eval/timbral`` and ``nat/eval/tokens`` (entropies, mutual
  information, diversity, the closing memory probe).
"""

from __future__ import annotations

import atexit
import os
import threading
import time
import warnings
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .logging import logger

_active: Optional[tuple] = None     # (profiler, trace file)
stage_timings: Dict[str, float] = {}
_timings_lock = threading.Lock()


def maybe_start_trace_from_env() -> None:
    trace_dir = os.environ.get("NAT_TPU_PROFILE")
    if trace_dir:
        start_trace(trace_dir)


def start_trace(trace_dir: str) -> None:
    """Start a profiler trace to be written under ``trace_dir`` (one per
    process; a second start is ignored)."""
    global _active
    if _active is not None:
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(trace_dir, exist_ok=True)
        prof = profile(activities=activities)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.start()
    except (OSError, RuntimeError) as exc:
        logger.warn(f"Could not start profiler trace: {exc}")
        return
    _active = (prof, os.path.join(trace_dir, f"nat_trace_{os.getpid()}.json"))
    atexit.register(stop_trace)
    logger.info(f"Profiler trace started → {trace_dir}")


def stop_trace() -> Optional[str]:
    """Stop the trace and write it; returns the file, or None when no trace
    was running."""
    global _active
    if _active is None:
        return None
    prof, path = _active
    _active = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.stop()
        prof.export_chrome_trace(path)
    except (OSError, RuntimeError) as exc:
        logger.warn(f"Could not write profiler trace: {exc}")
        return None
    logger.info(f"Profiler trace written to {path}")
    return path


class _Region:
    __slots__ = ("name", "_range", "_start")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> None:
        self._start = time.perf_counter()
        self._range = None
        # Whether a profiler records, in any thread: the module flag is
        # process-wide, where ``torch.autograd._profiler_enabled()`` reads
        # False on threads other than the one that started the profiler.
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        elapsed = time.perf_counter() - self._start
        with _timings_lock:
            stage_timings[self.name] = (stage_timings.get(self.name, 0.0)
                                        + elapsed)


def annotate(name: str) -> _Region:
    """A named region (``with annotate(name): ...``): its wall time added
    to ``stage_timings[name]``, and a profiler range while a profiler
    records."""
    return _Region(name)


def reset_timings() -> None:
    stage_timings.clear()
