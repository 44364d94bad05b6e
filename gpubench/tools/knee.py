"""The daemon's knee: windows of the serving mix at rising rates, on the
card, against one warmed daemon.

    python3 -m gpubench.tools.knee --workload base-serve --seed N \\
        --seconds 15 --rates 8,12,16,20

For each rate: requests sent, succeeded and failed, the backlog at the
window's close, the generator's lateness, the audio offered and served per
second and the latency percentiles from the due times (one JSON line).
The knee is the highest rate whose requests finish as fast as they fall
due: no failure, no backlog growing with the rate.  The cell's rate is
written by hand into its mix's file, at about 0.8 of it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import cells, program  # noqa: E402
from gpubench.drivers import serve_open  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="base-serve")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rates", required=True)
    args = p.parse_args()
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    program.prepare_env(ROOT, base)
    import torch

    from gpubench.run import Run

    cell = cells.load(args.workload, ROOT, listed=False)
    tmp = Path(tempfile.mkdtemp(prefix="gpubench-knee-", dir=base))
    try:
        r = Run(cell, args.seed, args.seconds, False, "cuda", ROOT, tmp, torch)
        d = serve_open.Daemon(r)
        for rate in (float(x) for x in args.rates.split(",")):
            w = d.window(args.seconds, rate=rate)
            s = serve_open.summary(w["recs"], args.seconds, d.sr)
            b = w["ctx"]["batcher"]
            print(json.dumps(dict(rate_per_s=rate, **s,
                                  spans_per_dispatch=b.get("spans", 0)
                                  / max(b.get("dispatches", 0), 1))),
                  flush=True)
        d.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
