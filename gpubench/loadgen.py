"""The open-loop load generator, a process of its own beside the daemon.

``python -m gpubench.loadgen --traffic FILE --seed N --seconds S --host H
--port P --t0 T --out FILE [--rate R]`` sends the mix's requests at their
due times (``t0`` plus the schedule's offsets, on the shared monotonic
clock) whatever the daemon's pace, each on a connection of its own, and
writes one JSON object: per request its due, send, first-frame and end
times (seconds after ``t0``), whether it completed, and its lines.  It
waits for every request up to ``--grace`` seconds past the window's close;
one that has not completed by then has failed.  It imports numpy and the
benchmark's traffic and wire modules only: no torch, nothing of the
program.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

from . import traffic, wire


async def _one(clip, sig, sr, t0, host, port, deadline, rec):
    await asyncio.sleep(max(0.0, t0 + clip.due_s - time.monotonic()))
    payload = traffic.wav_bytes(traffic.clip_pcm(sig, clip), sr)
    rec["sent"] = time.monotonic() - t0
    lines = []
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port),
            timeout=max(0.1, deadline - time.monotonic()))
        try:
            writer.write(payload)
            await writer.drain()
            writer.write_eof()
            while True:
                line = await asyncio.wait_for(
                    reader.readline(),
                    timeout=max(0.1, deadline - time.monotonic()))
                if not line:
                    break
                if rec["first"] is None and b'"event":"frame"' in line:
                    rec["first"] = time.monotonic() - t0
                lines.append(line.decode("utf-8").rstrip("\n"))
        finally:
            writer.close()
    except (OSError, asyncio.TimeoutError) as exc:
        rec["error"] = f"{type(exc).__name__}: {exc}"
    rec["end"] = time.monotonic() - t0
    rec["lines"] = lines
    rec["ok"] = wire.complete(lines) and "error" not in rec


async def _run(args) -> list:
    with open(args.traffic) as f:
        params = json.load(f)
    sr = params["sample_rate"]
    sig = traffic.signal(args.seed, params["signal_s"], sr)
    clips = traffic.schedule(params, args.seed, args.seconds, args.rate)
    deadline = args.t0 + args.seconds + args.grace
    recs = [{"index": c.index, "due": c.due_s, "samples": c.samples,
             "sent": None, "first": None, "end": None, "ok": False}
            for c in clips]
    await asyncio.gather(*(_one(c, sig, sr, args.t0, args.host, args.port,
                                deadline, r) for c, r in zip(clips, recs)))
    return recs


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rate", type=float, default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--t0", type=float, required=True)
    p.add_argument("--grace", type=float, default=60.0)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    recs = asyncio.run(_run(args))
    with open(args.out, "w") as f:
        json.dump(recs, f)


if __name__ == "__main__":
    main()
