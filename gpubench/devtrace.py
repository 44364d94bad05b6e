"""The device's activity from torch.profiler, and the card's identity.

A traced sub-window runs under ``torch.profiler`` (host and CUDA activity,
kernels inside CUDA-graph replays among them); nothing is written to disk.
:func:`reduce` gives the seconds in which some device activity ran (the
union of their intervals: on the H100 kernels' intervals overlap, so their
sum overstates; ``chip_smoke.busy_ms``'s rule), the device operations by
name, and the idle gaps named by the innermost ``nat/*`` host region open
at each gap's middle.  The ``nat/*`` regions' annotations on the device's
timeline are ranges, not operations, and are left out of the activity.
"""

from __future__ import annotations

import bisect
import subprocess
import sys
import time
from typing import Dict, List, Tuple

FORBIDDEN = ("jax", "jaxlib", "flax", "nat_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that no run may load, compared
    whole (``nat_tpu_torch`` is not ``nat_tpu``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def card_label() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
            else "nvidia-smi gave nothing"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi not read ({type(exc).__name__})"


def union_seconds(spans: List[Tuple[float, float]]) -> Tuple[float, list]:
    """Seconds covered by ``(start_us, end_us)`` intervals, and the merged
    intervals."""
    merged: list = []
    for start, stop in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], stop)
        else:
            merged.append([start, stop])
    return sum(b - a for a, b in merged) / 1e6, merged


class Traced:
    """A profiled sub-window: ``with Traced(torch) as t: ...``."""

    def __init__(self, torch) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.torch = torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # Every thread: the daemon's forwards run on its batcher's threads,
        # and without this the device work they launch is not recorded.
        try:
            from torch._C._profiler import _ExperimentalConfig

            self.prof = profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True)))
        except TypeError:
            self.prof = profile(activities=acts)
        self.window_s = 0.0

    def __enter__(self) -> "Traced":
        self.prof.__enter__()
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*exc)

    def reduce(self) -> Dict:
        from torch.autograd import DeviceType

        device, regions = [], []
        events = self.prof.events()
        kinds: Dict[str, int] = {}
        for ev in events:
            kinds[str(ev.device_type)] = kinds.get(str(ev.device_type), 0) + 1
        for ev in events:
            start, stop = ev.time_range.start, ev.time_range.end
            # A host region also appears on the device's timeline as a user
            # annotation spanning its kernels: a range, not an operation.
            if ev.name.startswith("nat/") or getattr(
                    ev, "is_user_annotation", False):
                if ev.device_type != DeviceType.CUDA:
                    regions.append((start, stop, ev.name))
            elif ev.device_type == DeviceType.CUDA:
                device.append((start, stop, ev.name))
        busy, merged = union_seconds([(a, b) for a, b, _ in device])
        ops: Dict[str, float] = {}
        for a, b, name in device:
            ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
        idle: Dict[str, float] = {}
        if merged:
            lo = min([merged[0][0]] + [a for a, _, _ in regions])
            hi = max([merged[-1][1]] + [b for _, b, _ in regions])
            edges = [lo] + [x for ab in merged for x in ab] + [hi]
            regions.sort()
            starts = [r[0] for r in regions]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    name = _open_region(regions, starts, (a + b) / 2)
                    idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        return {"busy_s": busy, "window_s": self.window_s, "ops": ops,
                "idle": idle, "events": kinds, "threads": len(
                    {ev.thread for ev in events})}


def _open_region(regions, starts, t: float, look_back: int = 4000) -> str:
    """The innermost region open at ``t`` (the latest-starting one that
    covers it); regions are sorted by start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        if regions[j][1] >= t:
            return regions[j][2]
    return "no nat/ region open"


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
