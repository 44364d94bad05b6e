"""The port's named regions (``utils/profiling.annotate``) and the graph
cache's forward counters, on the CPU.

A region sums its inclusive wall into ``stage_timings`` under a lock and
enters a ``record_function`` range only while a profiler records (in any
thread).  One file through ``stream_audio`` with reconstruction on names
every host step: the root ``nat/file`` and its children, the metric
suite's parts under ``nat/evaluate``, the span loop's staging and
finalize; no region stays open across the span loop's ``yield``.
``ForwardGraphs.stats`` counts the samples of every forward, from any
thread.
"""

import json
import sys
import threading
import wave

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nat_tpu_torch.runtime import aotcache
from nat_tpu_torch.runtime.pipeline import AudioTokenizationPipeline
from nat_tpu_torch.utils import profiling

SR = 22050
PIPE_CONFIG = dict(semantic_dim=32, acoustic_dim=32, codebook_size=64,
                   n_mels=16, hop_length=64)
FILE_CHILDREN = ("nat/load_audio", "nat/sha256", "nat/begin", "nat/tokenize",
                 "nat/decode", "nat/evaluate", "nat/finish")
EVAL_CHILDREN = ("nat/eval/spectral", "nat/eval/pitch", "nat/eval/rhythm",
                 "nat/eval/timbral", "nat/eval/tokens")
NEW_NAMES = {"nat/file", "nat/decode", "nat/stage", "nat/finalize",
             *EVAL_CHILDREN}
OLD_NAMES = {"nat/load_audio", "nat/sha256", "nat/tokenize", "nat/serialize",
             "nat/evaluate", "nat/pcm16_wire", "nat/dispatch",
             "nat/device_get"}


@pytest.fixture
def ranges_entered(monkeypatch):
    """The names of the ``record_function`` ranges entered."""
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return entered


def _all_threads_profiler():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def test_threads_lose_no_update(monkeypatch):
    """8 threads × 1000 regions of one name, each 1.0 s on a per-thread
    stand-in clock, with the interpreter switching threads as often as it
    can: the sum is 8000.0 exactly."""
    local = threading.local()

    class Clock:
        @staticmethod
        def perf_counter():
            local.t = getattr(local, "t", -1.0) + 1.0
            return local.t

    monkeypatch.setattr(profiling, "time", Clock)
    profiling.reset_timings()
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(1000):
            with profiling.annotate("nat/x"):
                pass

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.stage_timings == {"nat/x": 8000.0}


def test_no_range_without_a_profiler(ranges_entered):
    profiling.reset_timings()
    with profiling.annotate("nat/file"):
        with profiling.annotate("nat/tokenize"):
            pass
    assert ranges_entered == []
    assert set(profiling.stage_timings) == {"nat/file", "nat/tokenize"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("nat/file"):
            pass
    assert ranges_entered == ["nat/file"]
    assert "nat/file" in {ev.name for ev in prof.events()}
    with profiling.annotate("nat/file"):
        pass
    assert len(ranges_entered) == 1         # the profiler has stopped


def test_a_second_threads_region_is_traced(ranges_entered):
    """Under a profiler of every thread, a region opened on another thread
    enters its range and is in the trace."""
    def work():
        with profiling.annotate("nat/dispatch"):
            torch.ones(4).add_(1)

    with _all_threads_profiler() as prof:
        t = threading.Thread(target=work)
        t.start()
        t.join()
    assert ranges_entered == ["nat/dispatch"]
    events = [ev for ev in prof.events() if ev.name == "nat/dispatch"]
    assert events and events[0].thread != threading.get_ident()


def test_profile_env_trace_keeps_every_name(tmp_path, monkeypatch):
    """``NAT_TPU_PROFILE``'s trace holds every region opened while it
    ran."""
    monkeypatch.setenv("NAT_TPU_PROFILE", str(tmp_path / "trace"))
    profiling.maybe_start_trace_from_env()
    try:
        for name in sorted(NEW_NAMES | OLD_NAMES):
            with profiling.annotate(name):
                pass
    finally:
        path = profiling.stop_trace()
    events = json.load(open(path))["traceEvents"]
    assert NEW_NAMES | OLD_NAMES <= {e.get("name") for e in events}


def _write_wav(path, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    x = 0.4 * np.sin(2 * np.pi * 330.0 * t) * (1 + 0.5 * np.sin(3 * t)) \
        + 0.05 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def recon_pipe():
    return AudioTokenizationPipeline(model_config=PIPE_CONFIG, device="cpu",
                                     deterministic_seed=42,
                                     enable_codebook_cache=False,
                                     enable_reconstruction=True)


@pytest.fixture(scope="module")
def long_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "long.wav"
    _write_wav(path, 33.0)
    return path


def test_every_host_step_is_named(recon_pipe, long_wav):
    """One file with reconstruction: every new and old region is timed;
    ``nat/file``'s children, and ``nat/evaluate``'s, sum to at most their
    parent's wall and hold nearly all of it."""
    lines = []
    recon_pipe.stream_audio(str(long_wav), lines.append)   # warm
    profiling.reset_timings()
    lines.clear()
    result = recon_pipe.stream_audio(str(long_wav), lines.append)
    assert result["spans"] == 3 and result["metrics"].mse_loss > 0
    timings = dict(profiling.stage_timings)
    assert NEW_NAMES | OLD_NAMES <= set(timings)
    for parent, children in (("nat/file", FILE_CHILDREN),
                             ("nat/evaluate", EVAL_CHILDREN)):
        inside = sum(timings[c] for c in children)
        assert inside <= timings[parent] * (1 + 1e-9), parent
        assert inside >= 0.9 * timings[parent], (parent, timings)


def test_no_region_is_open_across_a_yield(recon_pipe, long_wav):
    """The consumer's ``nat/serialize`` runs between the span loop's
    yields: none lies inside a staging, finalize or fetch region."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recon_pipe.stream_audio(str(long_wav), lambda line: None)
    spans = {}
    for ev in prof.events():
        if ev.name.startswith("nat/"):
            spans.setdefault(ev.name, []).append(
                (ev.time_range.start, ev.time_range.end))
    assert len(spans["nat/serialize"]) == 3
    assert len(spans["nat/file"]) == 1
    for a, b in spans["nat/serialize"]:
        for name in ("nat/stage", "nat/finalize", "nat/device_get"):
            assert not any(lo <= a and b <= hi for lo, hi in spans[name]), \
                name


def _stand_in_capture(fn, static_inputs, pool, stream):
    outputs = fn(*static_inputs)

    def replay():
        outputs.copy_(fn(*static_inputs))
    return replay, outputs


@pytest.mark.parametrize("capture", [True, False])
def test_graph_cache_counts_samples(monkeypatch, capture):
    """Eager at the first sight, captured at the second, replayed at the
    third, or always eager: every run adds its rows × length."""
    monkeypatch.setenv("NAT_TPU_AOT_CACHE", "1")
    graphs = aotcache.ForwardGraphs("cpu", capture=_stand_in_capture)
    stats = graphs.stats

    def fn(x, seeds):
        return x * 2.0

    wave4 = torch.ones(4, 1000)
    counts = []
    for _ in range(3):
        out = graphs.run(("k", 4), fn, (wave4, None), capture=capture)
        assert torch.equal(out, wave4 * 2.0)
        counts.append(stats["samples"])
    graphs.run(("k", 1), fn, (torch.ones(1, 250), None), capture=capture)
    assert counts == [4000, 8000, 12000]
    assert stats["samples"] == 12250
    if capture:
        assert (stats["eager"], stats["captures"], stats["replays"]) == \
            (2, 1, 2)
    else:
        assert (stats["eager"], stats["captures"]) == (4, 0)


def test_graph_cache_threads_lose_no_sample():
    """8 threads × 500 eager forwards of 3 × 7 samples, with the
    interpreter switching threads as often as it can: 84 000 exactly."""
    graphs = aotcache.ForwardGraphs("cpu")
    wave = torch.ones(3, 7)
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(500):
            graphs.run(("k", 3), lambda x, seeds: x, (wave, None))

    threads = [threading.Thread(target=work) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert graphs.stats["samples"] == 8 * 500 * 21
