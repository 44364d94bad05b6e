"""The daemon under open-loop load.

A ``TokenServer`` (the ``--serve`` daemon, at its defaults: cross-session
span batching, prewarm, reconstruction as configured) runs in this process
on ``127.0.0.1``; the load generator (:mod:`gpubench.loadgen`) runs in a
process of its own and sends the mix's requests at their due times,
whatever the daemon's pace.  Latency counts from each request's due time;
a request that fails or never completes counts with the generator's whole
wait, the window's close plus its grace, and as failed.

Set-up: the pipeline and its weights, the daemon and its own prewarm, every
bucket the mix's span plans use at 1, 2, 4 and 8 rows (eager, then
captured), and eight requests of the mix's sizes through the socket.  A
traced run profiles ``profile_s`` in the middle of the window.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

from gpubench import plan, program, traffic, wire
from gpubench.reference.tokenize import parse_stream

PROFILE_S = 3.0
GRACE_S = 60.0
LEAD_S = 1.5          # generator start-up before the first due time
WARM_REQUESTS = 8


def _samples(pcm: np.ndarray) -> np.ndarray:
    """The streamed path's samples: ``int16 / 32768``, not normalized."""
    return pcm.astype(np.float32) / np.float32(32768.0)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


class Daemon:
    """The daemon in this process, warmed for the mix's shapes."""

    def __init__(self, r) -> None:
        from nat_tpu_torch.runtime.server import TokenServer

        cfg, tr = r.cell.config, r.cell.traffic
        self.r, self.sr = r, tr["sample_rate"]
        marks = [("start", time.time())]
        self.pipe = program.build(cfg, bool(tr["reconstruction"]), r.seed,
                                  r.device)
        r.sync()
        marks.append(("program", time.time()))
        self.server = TokenServer(self.pipe, "127.0.0.1:0")
        self.host, self.port = self.server.bound_address
        self.accept = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.accept.start()
        prewarm = getattr(self.server, "_prewarm_thread", None)
        if prewarm is not None:
            prewarm.join()
        marks.append(("daemon and its prewarm", time.time()))
        self.batcher = self.server._batcher
        self.sig = traffic.signal(r.seed, tr["signal_s"], self.sr)
        sched = traffic.schedule(tr, r.seed, r.seconds)
        rows = [1]
        while (self.batcher is not None
               and rows[-1] * 2 <= self.batcher.max_group):
            rows.append(rows[-1] * 2)
        if r.device != "cpu":
            buckets = {s.bucket for c in sched
                       for s in plan.spans_of(c.samples, self.sr)}
            program.warm_shapes(self.pipe.tokenizer, self.sr,
                                {(b, n) for b in buckets for n in rows})
        r.sync()
        marks.append(("shapes", time.time()))
        by_len = sorted(sched, key=lambda c: c.samples)
        warm = [by_len[int(q * (len(by_len) - 1))]
                for q in np.linspace(0.0, 1.0, WARM_REQUESTS)]
        with ThreadPoolExecutor(len(warm)) as ex:
            for lines in ex.map(lambda c: wire.request(
                    self.host, self.port, traffic.wav_bytes(
                        traffic.clip_pcm(self.sig, c), self.sr)), warm):
                if not wire.complete(lines):
                    raise RuntimeError("a warm-up request did not complete")
        r.sync()
        marks.append(("warm requests", time.time()))
        r.log("set-up: " + ", ".join(f"{name} {b - a:.3f} s"
                                     for (_, a), (name, b)
                                     in zip(marks, marks[1:])))

    def window(self, seconds: float, rate: float = None,
               trace: bool = False) -> Dict:
        """One open-loop window: the generator's records and what the
        program counted."""
        from nat_tpu_torch.utils import profiling

        r = self.r
        out_file = r.tmp / "loadgen.json"
        t0 = time.monotonic() + LEAD_S
        cmd = [sys.executable, "-m", "gpubench.loadgen",
               "--traffic", str(r.traffic_path), "--seed", str(r.seed),
               "--seconds", repr(seconds), "--host", self.host,
               "--port", str(self.port), "--t0", repr(t0),
               "--grace", str(GRACE_S), "--out", str(out_file)]
        if rate is not None:
            cmd += ["--rate", repr(rate)]
        gen = subprocess.Popen(cmd, cwd=str(r.root), env=r.child_env)
        time.sleep(max(0.0, t0 - time.monotonic()))
        opened = time.time()
        profiling.reset_timings()
        stats0 = dict(self.batcher.stats) if self.batcher is not None else {}
        ctx: Dict = {"driver": "serve_open"}
        if trace:
            from gpubench.devtrace import Traced

            time.sleep(max(0.0, t0 + 0.4 * seconds - time.monotonic()))
            with Traced(r.torch) as traced:
                time.sleep(PROFILE_S)
            ctx["device"] = traced.reduce()
        time.sleep(max(0.0, t0 + seconds - time.monotonic()))
        stats1 = dict(self.batcher.stats) if self.batcher is not None else {}
        ctx["stages"] = dict(profiling.stage_timings)
        ctx["batcher"] = {k: stats1.get(k, 0) - stats0.get(k, 0)
                          for k in stats1}
        try:
            gen.wait(timeout=seconds + GRACE_S + 60)
        finally:
            if gen.poll() is None:
                gen.kill()
                gen.wait()
        if gen.returncode != 0:
            raise RuntimeError(f"load generator exited {gen.returncode}")
        with open(out_file) as f:
            recs = json.load(f)
        return {"opened": opened, "recs": recs, "ctx": ctx}

    def close(self) -> None:
        self.server.stop_accepting()
        self.server.drain(timeout=30)
        self.server.close()
        self.accept.join(timeout=30)


def summary(recs, seconds: float, sr: int) -> Dict:
    """Latencies from the due times (a failed request counts with the
    generator's whole wait), the generator's lateness, the backlog at the
    window's close and what was served."""
    wait = seconds + GRACE_S
    ok = [rec for rec in recs if rec["ok"]]
    first = [(rec["first"] if rec["ok"] and rec["first"] is not None
              else wait) - rec["due"] for rec in recs]
    whole = [(rec["end"] if rec["ok"] else wait) - rec["due"] for rec in recs]
    late = [rec["sent"] - rec["due"] for rec in recs
            if rec["sent"] is not None] or [0.0]
    last_end = max([rec["end"] for rec in ok] or [seconds])
    audio_s = sum(rec["samples"] for rec in ok) / sr
    return {
        "sent": len(recs), "succeeded": len(ok), "failed": len(recs) - len(ok),
        "backlog": sum(1 for rec in recs
                       if not (rec["ok"] and rec["end"] <= seconds)),
        "late_p50_ms": percentile(late, 50) * 1e3,
        "late_p95_ms": percentile(late, 95) * 1e3,
        "late_max_ms": max(late) * 1e3,
        "offered_audio_s_per_s": sum(rec["samples"] for rec in recs) / sr
        / seconds,
        "served_audio_s": audio_s, "last_end_s": last_end,
        "served_audio_s_per_s": audio_s / last_end,
        "first_frame_p50_ms": percentile(first, 50) * 1e3,
        "first_frame_p95_ms": percentile(first, 95) * 1e3,
        "request_p50_ms": percentile(whole, 50) * 1e3,
        "request_p95_ms": percentile(whole, 95) * 1e3,
    }


def run(r) -> Dict:
    d = Daemon(r)
    w = d.window(r.seconds, trace=r.trace)
    d.close()
    ctx = w["ctx"]
    if r.torch.cuda.is_available():
        ctx["reserved_bytes"] = r.torch.cuda.max_memory_reserved()
    recs = w["recs"]
    s = summary(recs, r.seconds, d.sr)
    ctx.update(audio_s=s["served_audio_s"], wall_s=r.seconds)
    r.log("load: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                               else f"{k} {v}" for k, v in s.items()))
    sched = traffic.schedule(r.cell.traffic, r.seed, r.seconds)
    longest = max(range(len(recs)), key=lambda k: recs[k]["samples"])
    checked = traffic.sample_indices(len(recs), r.cell.traffic["check"],
                                     longest, r.seed)
    answers = [(_samples(traffic.clip_pcm(d.sig, sched[k])),
                parse_stream(recs[k]["lines"]), f"request {k}")
               for k in checked if recs[k]["ok"]]
    del d
    return {"setup_end": w["opened"], "attempted": s["sent"],
            "failed": s["failed"], "ctx": ctx, "answers": answers,
            "reconstruct": False,
            "metrics": {"first_frame_p95_ms": s["first_frame_p95_ms"],
                        "request_p95_ms": s["request_p95_ms"]}}
