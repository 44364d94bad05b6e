"""Run one cell of the benchmark once.

    python3 gpubench/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (imports, the program with the seed's weights, the cell's warm-up)
is ``setup_s``; the cell's driver then measures for ``--seconds``; with
``--trace 1`` it also reads the per-layer metrics, the device's activity
and a breakdown.  After the window the program's state is freed and the
plain reference judges a seeded sample of the window's answers.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced runs)
and last ``checks``, each number compared beside its limit; the same
numbers end standard error.

It needs a CUDA card (``torch.cuda.is_available()`` and as many devices as
the cell asks for); without one it prints no result and exits 2.  It exits
3, with no result, if ``jax``, ``jaxlib``, ``flax`` or ``nat_tpu`` was
loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if not __package__:                 # run as a script: import from the root
    sys.path[0] = str(ROOT)

from gpubench import cells, devtrace, program, weights  # noqa: E402


class Run:
    """What a driver is given."""

    def __init__(self, cell, seed, seconds, trace, device, root, tmp, torch):
        self.cell, self.seed, self.seconds = cell, seed, float(seconds)
        self.trace, self.device, self.root = bool(trace), device, root
        self.tmp, self.torch = tmp, torch
        self.traffic_path = (root / "gpubench" / "traffic"
                             / f"{cell.spec['traffic']}.json")
        self.child_env = dict(os.environ, PYTHONPATH=str(root))

    def log(self, msg: str) -> None:
        print(f"[gpubench] {msg}", file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device != "cpu":
            self.torch.cuda.synchronize()


def judge(r: Run, answers, reconstruct: bool):
    """Readings of the window's sampled answers by the float32 reference
    (the reconstruction's only where the program reconstructed them)."""
    from gpubench.reference import model
    from gpubench.reference.tokenize import Reference, combine

    cfg = r.cell.config
    params, codebooks = weights.make(cfg, r.seed, r.device,
                                     bool(r.cell.traffic["reconstruction"]))
    ref = Reference(cfg, params, codebooks, r.device, model.Numerics(
        trunk_gelu_tanh=cfg["compute_dtype"] == "bfloat16"))
    readings = []
    for audio, ans, label in answers:
        reading = ref.judge(audio, ans, reconstruct)
        r.log(f"checked {label}: {len(ans.fi)} frames, "
              + ", ".join(f"{k} {v!r}" for k, v in reading.items()))
        readings.append(reading)
    return combine(readings)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             root: Path, tmp: Path, torch) -> dict:
    """One run of ``cell``: the result object (without printing it)."""
    r = Run(cell, seed, seconds, trace, device, root, tmp, torch)
    r.log(f"imports done {time.time() - T_START:.3f} s after the start")
    out = cells.driver(cell, root).run(r)
    setup_s = out["setup_end"] - T_START
    gc.collect()
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if device != "cpu" else 0)}
    result = {"correct": False, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {}, "device": dev}
    if device != "cpu":
        torch.cuda.empty_cache()
    if trace:
        ctx = dict(out["ctx"], config=cell.config, traffic=cell.traffic,
                   device_kind=dev["kind"])
        for metric in cell.per_layer:
            value = cells.reader(metric["name"], root).read(ctx)
            if value is not None:
                result["metrics"][metric["name"]] = {"value": value,
                                                     "unit": metric["unit"]}
        traced = ctx.get("device")
        if traced is not None:
            r.log(f"traced sub-window: events by device type "
                  f"{traced['events']}, {traced['threads']} threads, busy "
                  f"{traced['busy_s']:.4f} s of {traced['window_s']:.4f} s")
            dev["busy_s"] = traced["busy_s"]
            dev["window_s"] = traced["window_s"]
            result["breakdown"] = {"device_ops": devtrace.top(traced["ops"]),
                                   "idle_gaps": devtrace.top(traced["idle"])}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        for metric in cell.end_to_end:
            result["metrics"][metric["name"]] = {
                "value": values[metric["name"]], "unit": metric["unit"]}
    r.log(f"setup_s {setup_s:.3f}; memory peak {dev['memory_peak_bytes']} "
          f"bytes")

    t_ref = time.time()
    readings = judge(r, out["answers"], out["reconstruct"])
    r.log(f"reference: {len(out['answers'])} answers in "
          f"{time.time() - t_ref:.3f} s; code_agree "
          f"{readings.get('code_agree')!r}")
    limits = cell.spec["limits"]
    checks = {k: {"value": readings.get(k), "limit": v}
              for k, v in limits.items()}
    result["correct"] = bool(
        out["answers"] and out["failed"] == 0
        and all(c["value"] is not None and c["value"] <= c["limit"]
                for c in checks.values()))
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load(args.workload, ROOT)
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    program.prepare_env(ROOT, base)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"gpubench: cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[gpubench] card: {devtrace.card_label()}", file=sys.stderr)
    tmp = Path(tempfile.mkdtemp(prefix="gpubench-", dir=base))
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", ROOT, tmp, torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = devtrace.forbidden_modules()
    if found:
        print(f"gpubench: modules that no run may load were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
