"""The control's readings at a cell's own size, on the card.

    python3 -m gpubench.tools.control --workload CELL --seeds 11,12,13

The control is the plain reference one step below the configuration's
precision, put in the program's place (``Numerics(encoders="fp8",
tf32=True)``): encoders on float8 e4m3 operands where the configuration
computes in bfloat16, RVQ distances and decoder in TF32 where it computes
in float32.  For each seed it answers the inputs a run of the cell checks
(the same seeded sample of the same mix, the longest among them) and the
float32 reference judges them as it judges the program.  One JSON line per
seed; a limit lies above the program's readings and below these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gpubench import cells, program, traffic, weights  # noqa: E402


def inputs(cell, seed: int, seconds: float):
    """The audio of the inputs a run of ``cell`` checks."""
    tr = cell.traffic
    sig = traffic.signal(seed, tr["signal_s"], tr["sample_rate"])
    if tr["driver"] == "files":
        from gpubench.drivers.files import _normalized

        clips = traffic.pool(tr, seed)
        prep = _normalized
    else:
        from gpubench.drivers.serve_open import _samples

        clips = traffic.schedule(tr, seed, seconds)
        prep = _samples
    longest = max(range(len(clips)), key=lambda k: clips[k].samples)
    picked = traffic.sample_indices(len(clips), tr["check"], longest, seed)
    return [prep(traffic.clip_pcm(sig, clips[k])) for k in picked]


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    args = p.parse_args()
    program.prepare_env(ROOT, Path("."))
    import torch

    from gpubench.reference import model
    from gpubench.reference.tokenize import Reference, combine

    cell = cells.load(args.workload, ROOT, listed=False)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    cfg = cell.config
    recon = bool(cell.traffic["reconstruction"])
    judged = recon and cell.traffic["driver"] == "files"
    tanh = cfg["compute_dtype"] == "bfloat16"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        params, cbs = weights.make(cfg, seed, "cuda", recon)
        ref = Reference(cfg, params, cbs, "cuda",
                        model.Numerics(trunk_gelu_tanh=tanh))
        ctl = Reference(cfg, params, cbs, "cuda", model.Numerics(
            encoders="fp8", tf32=True, trunk_gelu_tanh=tanh))
        readings = [ref.judge(a, ctl.answer(a, judged), judged)
                    for a in inputs(cell, seed, seconds)]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": combine(readings),
                          "seconds": time.time() - t0}), flush=True)
        del ref, ctl, params, cbs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
