"""The system under test: ``nat_tpu_torch``'s pipeline at the program's
defaults, with the benchmark's weights and codebooks.

:func:`prepare_env` runs before torch or the program is imported.  It
drops every ``NAT_TPU_*`` variable (no switch of the program is set from
outside; only the parameter cache is off, below), points ``HF_HOME`` at an
empty directory under ``TMPDIR`` (no checkpoint is found and none is
fetched, so the trunk is the configuration's with the benchmark's
weights), and keeps kernel caches (``TORCH_EXTENSIONS_DIR``,
``TRITON_CACHE_DIR``) at fixed paths inside the checkout.  The program
builds K1 and its host library into ``build/nat_tpu_torch/`` of the
checkout by itself.  The parameter cache (``NAT_TPU_PARAM_CACHE=0``) is off:
it would write the program's own seeded initial values, which the
benchmark replaces, under ``HOME`` at every new seed.  The codebook cache is
off through the pipeline's own argument.

:func:`build` makes the pipeline as ``nat FILE`` does, then loads the
weights and codebooks through the program's loading path, the steps of
``runtime/checkpoint.py::load_model`` in memory: ``load_float_params`` and
the RVQ states' setters.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

from . import weights

MODEL_KEYS = ("semantic_dim", "acoustic_dim", "codebook_size",
              "num_quantizers", "n_mels", "hop_length", "semantic_arch",
              "semantic_arch_config")


def prepare_env(root: Path, tmp: Path) -> None:
    for key in list(os.environ):
        if key.startswith("NAT_TPU_"):
            del os.environ[key]
    for key in ("HF_HUB_CACHE", "HUGGINGFACE_HUB_CACHE", "TRANSFORMERS_CACHE",
                "HF_ENDPOINT"):
        os.environ.pop(key, None)
    hf_home = tmp / "gpubench-hf-empty"
    hf_home.mkdir(parents=True, exist_ok=True)
    build = root / "build" / "gpubench"
    os.environ.update(
        HF_HOME=str(hf_home), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
        USE_FLAX="0", USE_TF="0", NAT_TPU_PARAM_CACHE="0",
        TORCH_EXTENSIONS_DIR=str(build / "torch_extensions"),
        TRITON_CACHE_DIR=str(build / "triton"))


def build(cfg: Dict, reconstruct: bool, seed: int, device: str):
    """The pipeline, its tokenizer holding the benchmark's weights."""
    from nat_tpu_torch.quant.rvq import RVQState
    from nat_tpu_torch.runtime.pipeline import AudioTokenizationPipeline

    pipe = AudioTokenizationPipeline(
        sample_rate=cfg["sample_rate"],
        model_config={k: cfg[k] for k in MODEL_KEYS}, device=device,
        enable_codebook_cache=False, enable_reconstruction=reconstruct,
        compute_dtype=cfg["compute_dtype"])
    params, (sem, acc) = weights.make(cfg, seed, device, reconstruct)
    tok = pipe.tokenizer
    tok.load_float_params(params)
    tok.sem_rvq = RVQState.from_codebook(sem)
    tok.acc_rvq = RVQState.from_codebook(acc)
    return pipe


def warm_shapes(tok, sr: int, shapes) -> None:
    """Each ``(bucket, rows)`` forward the cell's traffic will run, through
    the program's prewarm: an eager forward, then the CUDA graph's
    capture."""
    from nat_tpu_torch.runtime.prewarm import prewarm_forwards

    by_bucket: Dict[int, set] = {}
    for bucket, rows in shapes:
        by_bucket.setdefault(bucket, set()).add(rows)
    for bucket, rows in sorted(by_bucket.items()):
        prewarm_forwards(tok, sr, seconds=[bucket / sr], rows=sorted(rows))
