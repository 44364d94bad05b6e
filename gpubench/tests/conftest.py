"""Fixtures of the benchmark's own tests (``python -m pytest gpubench/tests``).

``tiny_root`` is a checkout to run cells in on the CPU: ``BENCHMARK.json``
and ``gpubench/`` copied, the program linked, and a tiny configuration, two
tiny mixes and two tiny cells added the way a later change adds them: as
new files and new entries, with no existing file of ``gpubench/`` edited.
The serving cell brings the daemon's metrics along.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_ARCH = dict(hidden=64, num_layers=2, num_heads=4, ffn_dim=128,
                 conv_layers=[[32, 10, 5], [32, 3, 2], [32, 3, 2], [32, 3, 2],
                              [32, 3, 2], [32, 2, 2], [32, 2, 2]],
                 pos_conv_kernel=16, pos_conv_groups=4)


def tiny_config() -> dict:
    cfg = json.loads((REPO / "gpubench/configs/nat-w2v2-base.json").read_text())
    cfg.update(name="tiny", source="the port's CPU test sizes",
               semantic_dim=32, acoustic_dim=32, codebook_size=64, n_mels=16,
               compute_dtype="float32", semantic_arch_config=dict(TINY_ARCH))
    return cfg


def add_cell(root: Path, name: str, config: str, mix: str, why: str,
             limits: dict, like: str = None) -> None:
    """A new cell entry in ``BENCHMARK.json`` and its file; metrics listed
    for cell ``like`` are reported in it too."""
    g = root / "gpubench"
    (g / "workloads" / f"{name}.json").write_text(json.dumps(dict(
        config=config, traffic=mix, chips=1, why=why, limits=limits)))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name=name, config=config, traffic=mix,
                                   chips=1, why=why))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if like in metric.get("workloads", ()):
            metric["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def make_root(base: Path) -> Path:
    root = base / "checkout"
    shutil.copytree(REPO / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    os.symlink(REPO / "nat_tpu_torch", root / "nat_tpu_torch")
    g = root / "gpubench"
    (g / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(name="tiny", source="tests", reduced=[],
                                 file="gpubench/configs/tiny.json", why="tests"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    files = json.loads((g / "traffic" / "files-default.json").read_text())
    (g / "traffic" / "tiny-files.json").write_text(json.dumps(dict(
        files, pool=4, min_s=2.0, max_s=40.0, signal_s=45.0, check=2)))
    serve = json.loads((g / "traffic" / "serve-open.json").read_text())
    (g / "traffic" / "tiny-serve.json").write_text(json.dumps(dict(
        serve, min_s=1.0, max_s=35.0, signal_s=40.0, rate_per_s=2.0,
        check=3)))
    exact = {"code_gap": 1e-6, "frame_errors": 0}
    add_cell(root, "tiny-files", "tiny", "tiny-files", "tests",
             dict(exact, mse_rel_err=1e-5), like="base-file-default")
    add_cell(root, "tiny-serve", "tiny", "tiny-serve", "tests", exact)
    add_serve_metrics(root, "tiny-serve")
    return root


def add_serve_metrics(root: Path, cell: str) -> None:
    """The daemon's metrics, as a change that adds a serving cell adds
    them (``base-serve`` is parked: PERF.md, Open questions)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"][-1:-1] = [
        dict(name=n, unit="ms", better="lower", bound=0.25,
             source="host_clock", workloads=[cell])
        for n in ("first_frame_p95_ms", "request_p95_ms")]
    bench["per_layer"] += [
        dict(name="server.spans_per_dispatch", unit="spans", better="higher",
             source="program_counter", layer="front end (runtime/server.py)",
             moves="first_frame_p95_ms", workloads=[cell]),
        dict(name="device.idle_share.serve", unit="%", better="lower",
             source="device_trace", layer="device (one H100)",
             moves="first_frame_p95_ms", workloads=[cell])]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("gpubench"))


def run_tiny(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, tmp: Path) -> dict:
    """One CPU run of a cell of ``root`` through ``run_cell``."""
    import gpubench.run as run
    from gpubench import cells, program

    program.prepare_env(root, tmp)
    import torch

    tmp.mkdir(parents=True, exist_ok=True)
    cell = cells.load(cell_name, root)
    return run.run_cell(cell, seed, seconds, trace, "cpu", root, tmp, torch)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
