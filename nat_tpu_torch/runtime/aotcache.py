"""CUDA-graph forward cache, the port's counterpart of
``nat_tpu/runtime/aotcache.py`` and of the reference's
``_AotForwardDispatch`` (``nat_tpu/models/tokenizer.py:68-127``).

The reference runs one compiled XLA executable per forward shape.  The
port runs eagerly: a span forward is hundreds of launches (cuDNN, cuBLAS,
elementwise kernels, K1/K2), each issued from Python.  This cache records
them once per key into a CUDA graph and replays the graph, one launch from
the host.  A key holds everything that decides which kernels a capture
records: the reference's ``_aot_config`` (rate, bucket, widths, compute
type, encoder class and arch config, stochastic and temperature), the
rows, ``reconstruct``, the tokenizer's ``row_invariant`` and
``batch_invariant``, and torch's TF32, deterministic and benchmark
switches.

* **When.**  The first sight of a key in a thread runs eagerly: that run
  builds K1, queries its occupancy, and sets up the thread's cuDNN and
  cuBLAS handles, the algorithm choices and the cuFFT plans the capture
  then records (a handle made during a capture breaks it, so a thread
  never captures a key it has not run).  The next sight in that thread
  captures and replays; every later sight, in any thread, replays.  A
  one-file run pays no more than eager; ``prewarm_forwards`` runs each
  prewarmed shape twice, so it captures up front, as the reference's
  prewarm compiles.
* **Memory.**  The graphs of one cache share one memory pool
  (``torch.cuda.graph_pool_handle``): a forward at 8 rows of 30 s holds
  GB-scale activations, and private pools would add up across buckets and
  row counts.  Sharing is safe because replays run one at a time on the
  compute stream and each replay's outputs are copied out on that stream
  before anything else runs there.  Static inputs live outside the pool.
  The pool sits beside the allocator's cache of the key's eager run, for
  the process's life, so the caller keeps its largest forwards out of the
  cache (``capture=False``: the tokenizer's forwards of more rows than a
  span group, which only ``DataParallelRunner`` dispatches).
* **Inputs and outputs.**  Before a replay the caller's tensors are copied
  into the graph's static inputs on the compute stream (the waveform
  batch, and K2's seeds, which the kernel reads from device memory).
  After it, the outputs are cloned on the compute stream, so a later
  replay of the same graph (the next span of a bucket, with two items in
  flight and their copies to the host still running) never overwrites
  what an earlier caller holds.
* **Launch counts.**  A capture records K1/K2 launches into a tally
  (:func:`nat_tpu_torch.ops.rvq_kernel.recording`) and each replay adds
  the tally to the kernels' counts.  ``stats`` counts captures, replays,
  eager runs, failed captures and invalidations, and the samples of
  every forward (padded rows, bucket padding and overlap included).
* **Invalidation.**  A graph holds the addresses of the weights and
  codebooks it read.  The tokenizer drops its graphs (:meth:`invalidate`)
  wherever it replaces them, as the reference clears ``_forward_cache``.
* **Failures.**  A capture that fails is logged at WARN with the error
  and its key runs eagerly from then on.
* **The switch** is ``NAT_TPU_AOT_CACHE``, read as the reference reads it
  (``nat_tpu/runtime/aotcache.py:69-82``): on by default for a CUDA
  device, ``=0`` off.  There are no CPU graphs, so it does nothing on the
  CPU.  Graphs live in the process that captured them: nothing persists
  across processes, and ``NAT_TPU_AOT_CACHE_DIR`` is not read.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import rvq_kernel
from ..utils.heartbeat import heartbeat
from ..utils.logging import logger

# capture(fn, static_inputs, pool, stream) -> (replay, static_outputs):
# records fn(*static_inputs) on ``stream`` so that replay() recomputes the
# outputs in place.
Capture = Callable[[Callable, Sequence, Any, Any],
                   Tuple[Callable[[], None], Any]]


def cache_enabled() -> bool:
    """``NAT_TPU_AOT_CACHE``: unset or ``1`` on, anything else off."""
    env = os.environ.get("NAT_TPU_AOT_CACHE")
    return env is None or env == "1"


def capture_stream(device) -> "torch.cuda.Stream":
    """A stream to capture on: from torch's pool of high-priority streams,
    which nothing else here draws from.  The copy streams come from the
    pool of ordinary ones, round robin; a capture stream from that pool
    would, after enough streams, be one of them, and another thread's
    upload on it would break the capture."""
    return torch.cuda.Stream(device, priority=-1)


def cuda_capture(fn: Callable, static_inputs: Sequence, pool, side):
    """Capture ``fn(*static_inputs)`` into a CUDA graph on the shared
    ``pool``, on the stream ``side``, ordered after the compute stream's
    work (the static inputs' copies).  Capture errors are raised only for
    this thread's own calls (``thread_local``): serving's upload, fetch
    and prewarm threads keep working on their streams meanwhile, and the
    caller holds the tokenizer's device lock, so no other forward runs.
    Unlike ``torch.cuda.graph``, it neither synchronizes the card nor
    empties the allocator's cache first: a daemon that captures a new
    batch shape keeps its other work and its cached blocks."""
    graph = torch.cuda.CUDAGraph()
    compute = torch.cuda.current_stream()
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            outputs = fn(*static_inputs)
        finally:
            graph.capture_end()
    compute.wait_stream(side)
    return graph.replay, outputs


def map_tensors(fn: Callable, tree):
    """``tree`` (dicts, lists, tuples, None, scalars) with ``fn`` applied
    to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


@dataclass
class CapturedForward:
    replay: Callable[[], None]
    static_inputs: Tuple[Optional[torch.Tensor], ...]
    static_outputs: Any
    tally: Dict[str, int]       # K1/K2 launches one replay makes


class ForwardGraphs:
    """The graph cache of one tokenizer.  ``capture`` stands in for
    :func:`cuda_capture` (the CPU tests drive the bookkeeping with one);
    without it the cache captures only on a CUDA device."""

    def __init__(self, device, capture: Optional[Capture] = None) -> None:
        self.device = torch.device(device)
        self.capture = capture or (cuda_capture
                                   if self.device.type == "cuda" else None)
        self.graphs: Dict[tuple, CapturedForward] = {}
        self._ran = threading.local()    # .keys: what this thread ran
        self.failed: set = set()
        self._pool = None
        self._stream = None
        self.stats = {"captures": 0, "replays": 0, "eager": 0, "failed": 0,
                      "invalidations": 0, "samples": 0}
        self._samples_lock = threading.Lock()

    def enabled(self) -> bool:
        return self.capture is not None and cache_enabled()

    def invalidate(self) -> None:
        """Drop every graph (the weights or codebooks they read were
        replaced).  A thread captures a key it has run at its next
        sight."""
        if self.graphs:
            self.stats["invalidations"] += 1
        self.graphs.clear()
        self._pool = None

    def run(self, key: tuple, fn: Callable, inputs: Sequence,
            describe: str = "forward", capture: bool = True) -> Any:
        """``fn(*inputs)``: by replaying the key's graph where there is
        one; else eagerly at the key's first sight in this thread (and
        whenever graphs are off, ``capture`` is False or its capture
        failed); else captured now and replayed.  ``inputs`` are tensors
        on the cache's device, or None.  ``stats["samples"]`` counts the
        elements of the first input of every run, eager, captured or
        replayed (the tokenizer's padded ``[rows, bucket]`` batch), under
        a lock: threads share the cache."""
        with self._samples_lock:
            self.stats["samples"] += inputs[0].numel()
        ran = getattr(self._ran, "keys", None)
        if ran is None:
            ran = self._ran.keys = set()
        first = key not in ran
        capture = capture and self.enabled()
        graph = self.graphs.get(key) if capture else None
        if graph is None and (first or not capture or key in self.failed):
            self.stats["eager"] += 1
            ran.add(key)        # a replay sets up nothing in this thread
            if not first:
                return fn(*inputs)
            with heartbeat(f"preparing {describe}", announce=(
                    f"preparing {describe} — the first run builds the "
                    "kernels and picks algorithms"
                    + ("; the next one captures a CUDA graph"
                       if capture else ""))):
                return fn(*inputs)
        if graph is None:
            graph = self._capture(key, fn, inputs, describe)
            if graph is None:
                self.stats["eager"] += 1
                return fn(*inputs)
        return self._replay(graph, inputs)

    def _capture(self, key, fn, inputs, describe
                 ) -> Optional[CapturedForward]:
        static_inputs = tuple(None if x is None else x.clone()
                              for x in inputs)
        if self.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            if self._stream is None:
                self._stream = capture_stream(self.device)
        try:
            with heartbeat(f"capturing a CUDA graph of the {describe}"), \
                    rvq_kernel.recording() as tally:
                replay, outputs = self.capture(fn, static_inputs, self._pool,
                                               self._stream)
        except Exception as exc:     # the key runs eagerly from now on
            self.failed.add(key)
            self.stats["failed"] += 1
            # The pool of an aborted capture is not handed to the next.
            self._pool = None
            logger.warn(f"CUDA graph capture of the {describe} failed "
                        f"({type(exc).__name__}: {exc}); running it eagerly")
            return None
        graph = CapturedForward(replay, static_inputs, outputs, tally)
        self.graphs[key] = graph
        self.stats["captures"] += 1
        logger.debug(f"Captured a CUDA graph of the {describe} "
                     f"(K1 {tally['launches']}, K2 "
                     f"{tally['sample_launches']} launches a replay)")
        return graph

    def _replay(self, graph: CapturedForward, inputs: Sequence) -> Any:
        for static, x in zip(graph.static_inputs, inputs):
            if static is not None:
                static.copy_(x)
        graph.replay()
        rvq_kernel.add_launches(graph.tally)
        self.stats["replays"] += 1
        return map_tensors(torch.clone, graph.static_outputs)
