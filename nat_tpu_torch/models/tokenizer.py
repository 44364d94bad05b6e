"""The neural audio tokenizer, port of ``nat_tpu/models/tokenizer.py``.

Forward (per bucket-padded span, ``_build_forward`` in the reference):
resample to 16 kHz → semantic encoder; log-mel → acoustic conv stack; a
multi-scale temporal encoder on each stream; linear alignment of both
streams to ``T_target``; a residual VQ on each stream through the CUDA
kernels (:mod:`nat_tpu_torch.ops.rvq_kernel`): argmin (K1), or with
``stochastic=True`` Gumbel-max sampling at ``temperature`` (K2), seeded per
span and stream from a generator seeded by ``seed``.  Codes are int16 when
the codebook fits, losses are per row.  With ``enable_reconstruction`` the
decoder turns the quantized streams back into a waveform and the forward
adds ``reconstructed`` and a per-row ``reconstruction_loss`` when the caller
asks (``reconstruct``): only ``__call__`` does by default, for the
visualizations of the buffered outputs; the span dispatch that the NDJSON
streams and the daemon use skips the decoder and its fetch.
:meth:`NeuralAudioTokenizer.decode_tokens` decodes a whole token matrix in
one float32 pass, as the reference's ``decode_tokens`` does.

Long signals are cut into spans (:func:`chunk_spans`).  On the card,
``iter_chunks`` runs the reference's pipelined schedule
(``nat_tpu/models/tokenizer.py:791-1124``): after the first span,
consecutive same-bucket spans are stacked into one padded ``[G, bucket]``
forward (G = 8, ``NAT_TPU_STREAM_GROUP``); each plan item is staged ahead
into a pinned host buffer and uploaded on a copy stream; the outputs'
device → host copies start on a second copy stream behind the forward; up to
two items stay in flight before the oldest is finalized, together with any
later item already done.  Forwards and kernels run on the compute stream
only, under ``_device_lock``, which serializes every dispatch so serving
threads can share one tokenizer.  On the CPU the same plan runs with group
1, no streams and no pinning.  Stochastic mode keeps group 1.  In a
batched forward the resampler and the wav2vec2 positional conv run one row
at a time (``row_invariant``): on the card their cuDNN and cuBLAS
algorithms change with the batch size, and the trunk amplifies their
last-bit differences into code flips.  A feature-seeded model, whose
codebooks make many more near ties, runs the whole encoder stack one row
at a time (``batch_invariant``).

Initialization follows the reference's (``ensure_initialized``): the
default ``semantic_arch="auto"`` loads a local ``facebook/wav2vec2-base``
checkpoint over the seed's trunk (the 768→512 projection keeps the seed's
values) and takes the spectral fallback when there is none; the codebooks
are seeded from a local MERT or EnCodec checkpoint (``mert`` by default)
through the codebook cache (:mod:`nat_tpu_torch.quant.seeding`), and are
the deterministic random ladder without one.  The feature-driven methods
(``kmeans``, ``encodec-kmeans``) start from the random ladder unless the
cache holds their codebooks, and :meth:`maybe_seed_from_audio` replaces
them by residual k-means over features of the first input: this model's
own encoder outputs (``kmeans``), or EnCodec latents
(``encodec-kmeans``, :mod:`nat_tpu_torch.models.encodec`), extracted and
clustered on the tokenizer's device.

The int16 upload wire (the reference's ``_pcm16_wire``): a wave that is
provably PCM16 scaled by one divisor (:mod:`nat_tpu_torch.dsp.pcm`: a
loader's ``pcm16_hint``, else a bitwise recovery) is staged and uploaded
as int16, half the bytes, and a 65,536-entry table gather on the compute
stream gives the card the same float32 samples.  On for a CUDA device, off
on the CPU unless ``NAT_TPU_PCM16_WIRE=1``; ``NAT_TPU_PCM16_WIRE=0`` turns
it off everywhere.  A wave that fails the bitwise checks is uploaded as
float32.  ``upload_stats`` counts the batches of each kind and the bytes.

Several devices (:meth:`dispatch_prepared_group` with a ``mesh``, the
reference's dp-sharded dispatch): a group's padded rows split into ``dp``
contiguous shards, and each shard runs on its device's replica of the
model (:meth:`replicas`), with the replica's own streams, CUDA-graph cache
and int16 tables; the outputs are gathered onto the tokenizer's device for
:meth:`finalize_span_group`.  The tokenizer is its own replica on its
device, so a mesh that names one device twice runs both shards there in
turn.  Replicas of other devices are made at their first use and dropped
wherever the graphs are (the RVQ setters, :meth:`load_float_params`).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import math
import os
import threading
from collections import deque
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..device import compute_dtype_for, ieee_float32, resolve_device
from ..dsp import pcm
from ..dsp.resample import resample_output_length, resample_torch
from ..dsp.stft import num_frames as stft_num_frames
from ..ops import rvq_kernel
from ..ops.interp import interp_linear
from ..parallel.mesh import batch_sharding, canonical_device, replicated
from ..quant import seeding
from ..quant.rvq import RVQState, rvq_decode
from ..runtime import aotcache, paramcache
from ..runtime.bucketing import bucket_length, chunk_spans
from ..utils.heartbeat import heartbeat
from ..utils.logging import logger
from ..utils.profiling import annotate
from ..utils.warmup import start_backend_warmup
from .decoder import ReconstructionDecoder
from .encoders import MelResidualEncoder, MultiScaleTemporalEncoder
from .semantic import (SemanticAudioEncoder, SpectralFallbackEncoder,
                       by_rows, feature_extractor_output_length,
                       load_pretrained_semantic_params)

SEMANTIC_SR = 16000
# The tokenizer's modules with parameters (the reference's ``params``
# keys); ``decoder`` exists only with reconstruction.
MODULE_NAMES = ("mel_encoder", "semantic_encoder", "temporal_semantic",
                "temporal_acoustic", "decoder")
SEMANTIC_ARCHS = ("auto", "wav2vec2", "spectral")
# Codebook-init methods that k-means features of the input audio.
FEATURE_INIT_METHODS = ("encodec-kmeans", "kmeans")
# Without a checkpoint, mert and encodec take the deterministic random
# ladder, as random does.
CODEBOOK_INIT_METHODS = ("mert", "encodec", "random") + FEATURE_INIT_METHODS
# Most rows of a forward the CUDA-graph cache captures, whatever the span
# group (the card's default group, 8).
GRAPH_ROWS = 8
# Outputs of a forward that finalize reads, beside the losses.
OUTPUT_KEYS = ("semantic_codes", "acoustic_codes", "reconstructed",
               "semantic_features", "acoustic_features")


def _locked(fn):
    """Run ``fn`` under ``self._device_lock`` (reentrant): initialization,
    the span-seed draw and every dispatch, so concurrent serving sessions
    share one tokenizer and its compute stream."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._device_lock:
            return fn(self, *args, **kwargs)
    return wrapper


def _env_count(name: str, default: int) -> int:
    """A count of at least 1 from the environment, else ``default``."""
    env = os.environ.get(name)
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    return default


class Staged(NamedTuple):
    """One batch on its way to the card (see ``_upload``)."""

    tensor: torch.Tensor      # float32, or int16 on the wire
    ready: Any                # the upload's CUDA event, None on the CPU
    pcm_divisor: Optional[float]   # the int16 batch's divisor


class SpanMeta(NamedTuple):
    """Geometry of one overlap-extended span (see ``iter_chunks``)."""

    ext_start: int   # first sample of the extended span in the full signal
    start: int       # first sample the span is responsible for
    length: int      # samples the span is responsible for
    overlap: int     # overlap margin in samples (0 = single-span signal)
    sr: int
    ext_len: int     # true (pre-padding) extended-span length
    bucket: int      # padded bucket length


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initializers, drawn from ``generator``: Dense/Conv
    kernels normal with variance ``1/fan_in`` (LeCun), biases zero, norm
    scales one.  Walks submodules in registration order, so a seed fixes
    every value on every device."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            with torch.no_grad():
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


class NeuralAudioTokenizer:
    """Dual-path neural tokenizer: explicit init, then per-span forwards."""

    def __init__(
        self,
        sample_rate: int = 22050,
        semantic_dim: int = 512,
        acoustic_dim: int = 512,
        codebook_size: int = 4096,
        num_quantizers: int = 8,
        n_mels: int = 128,
        hop_length: int = 512,
        enable_reconstruction: bool = False,
        codebook_init_method: str = "mert",
        encodec_model: str = "facebook/encodec_24khz",
        codebook_cache_dir: Optional[str] = None,
        enable_codebook_cache: bool = True,
        force_reinit_codebooks: bool = False,
        seed: int = 42,
        stochastic: bool = False,
        temperature: float = 0.5,
        timebase: str = "compat",
        use_pretrained_semantic: bool = True,
        semantic_arch: str = "auto",
        compute_dtype: Optional[str] = None,
        semantic_arch_config: Optional[Dict[str, Any]] = None,
        device="cuda",
    ) -> None:
        if codebook_init_method not in CODEBOOK_INIT_METHODS:
            raise ValueError(
                f"codebook_init_method must be one of "
                f"{CODEBOOK_INIT_METHODS}, got {codebook_init_method!r}")
        if semantic_arch not in SEMANTIC_ARCHS:
            raise ValueError(f"semantic_arch must be one of {SEMANTIC_ARCHS}, "
                             f"got {semantic_arch!r}")
        if timebase not in ("compat", "frame"):
            raise ValueError(f"timebase must be compat or frame, got "
                             f"{timebase!r}")
        if stochastic and not temperature > 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.sample_rate = sample_rate
        self.semantic_dim = semantic_dim
        self.acoustic_dim = acoustic_dim
        self.codebook_size = codebook_size
        self.num_quantizers = num_quantizers
        # Both groups get num_quantizers // 2 layers (reference rule).
        self.num_semantic_layers = num_quantizers // 2
        self.num_acoustic_layers = num_quantizers // 2
        self.n_mels = n_mels
        self.hop_length = hop_length
        self.enable_reconstruction = enable_reconstruction
        self.codebook_init_method = codebook_init_method
        self.encodec_model = encodec_model
        self.codebook_cache_dir = codebook_cache_dir
        self.enable_codebook_cache = enable_codebook_cache
        self.force_reinit_codebooks = force_reinit_codebooks
        self.seed = seed
        self.stochastic = stochastic
        self.temperature = temperature
        # Per-span sampling seeds (the reference splits its PRNG key per
        # span, tokenizer.py:1396, and draws one seed per stream, :707-708).
        self._span_seeds = torch.Generator().manual_seed(seed)
        self.timebase = timebase
        self.use_pretrained_semantic = use_pretrained_semantic
        # "auto": the wav2vec2 trunk when a checkpoint is on the machine,
        # else the spectral fallback; "wav2vec2": the trunk regardless
        # (random init without a checkpoint); "spectral": the fallback.
        # Resolved at initialization.
        self.semantic_arch = semantic_arch
        self.semantic_fallback = semantic_arch == "spectral"
        self.semantic_arch_config = semantic_arch_config
        self.device = resolve_device(device)
        self.dtype = compute_dtype_for(self.device, compute_dtype)
        self.compute_dtype = ("bfloat16" if self.dtype == torch.bfloat16
                              else "float32")

        # The CUDA-graph forward cache (NAT_TPU_AOT_CACHE); dropped
        # wherever weights or codebooks are replaced.
        self._graphs = aotcache.ForwardGraphs(self.device)
        # Replicas of the model on other devices, by device (replicas()).
        self._replicas: Dict[torch.device, "NeuralAudioTokenizer"] = {}
        self._first_fetch_done = False
        self.mel_encoder: Optional[nn.Module] = None
        self.semantic_encoder: Optional[nn.Module] = None
        self.temporal_semantic: Optional[nn.Module] = None
        self.temporal_acoustic: Optional[nn.Module] = None
        self.decoder: Optional[nn.Module] = None
        self.sem_rvq: Optional[RVQState] = None
        self.acc_rvq: Optional[RVQState] = None
        # A feature-driven method whose cache missed seeds from the first
        # input (maybe_seed_from_audio).
        self._needs_audio_seeding = False
        # float32 state dicts (on the CPU) of weights loaded or trained
        # into modules of a lower precision; None means the seed's values.
        self._float_params: Optional[
            Dict[str, Dict[str, torch.Tensor]]] = None
        self._device_lock = threading.RLock()
        # (upload, fetch) copy streams on the card, made at initialization.
        self._copy_streams = None
        # int16 wire: conversion tables on the card by divisor, and what
        # _upload sent (batches per transport, bytes).
        self._pcm16_tables: Dict[float, torch.Tensor] = {}
        self.upload_stats = {"int16": 0, "float32": 0, "bytes": 0}
        # Resample and positional-conv each row of a batched forward alone,
        # so a span's codes do not depend on the spans it is batched with.
        self.row_invariant = True
        # Codebooks that k-means fits to features of the input sit among
        # the frames they quantize: many codes are near ties that any
        # batch-size-dependent last bit decides, in bfloat16 and in float32
        # alike.  A feature-seeded model runs its encoders on each row of a
        # batch alone, so its tokens follow neither the span grouping nor,
        # on a daemon, the other connections (the RVQ chain's bits do not
        # depend on the batch).
        self.batch_invariant = codebook_init_method in FEATURE_INIT_METHODS

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    @_locked
    def ensure_initialized(self) -> None:
        if self.mel_encoder is not None:
            return
        # The card's context comes up on a thread while the host seeds or
        # reads the parameters.
        start_backend_warmup(self.device)
        # The checkpoint's presence decides the encoder; it is parsed only
        # when the parameter cache misses.
        ckpt_path = None
        if self.semantic_arch != "spectral" and self.use_pretrained_semantic:
            from ..quant.checkpoint_io import find_local_checkpoint

            ckpt_path = find_local_checkpoint("facebook/wav2vec2-base")
        predicted_w2v2 = (self.semantic_arch == "wav2vec2"
                          or (self.semantic_arch == "auto"
                              and ckpt_path is not None))
        cache_key = cached = None
        if paramcache.cache_enabled():
            cache_key = paramcache.params_key(
                self._init_cache_config(predicted_w2v2),
                paramcache.checkpoint_identity(ckpt_path), self.device.type)
            cached = paramcache.load_params(cache_key)
        if cached is not None:
            use_w2v2, from_checkpoint = predicted_w2v2, cached["pretrained"]
            self.semantic_fallback = not use_w2v2
            params = cached["modules"]
            modules = self._module_skeletons()
            for name, m in modules.items():
                m.load_state_dict(params[name], strict=True)
        else:
            pretrained = None
            if (self.semantic_arch != "spectral"
                    and self.use_pretrained_semantic):
                pretrained = load_pretrained_semantic_params()
            use_w2v2 = (self.semantic_arch == "wav2vec2"
                        or (self.semantic_arch == "auto"
                            and pretrained is not None))
            self.semantic_fallback = not use_w2v2
            modules = self._seeded_modules()
            # float32 values on the CPU, by module.
            params = {name: dict(m.state_dict())
                      for name, m in modules.items()}
            from_checkpoint = use_w2v2 and pretrained is not None
            if from_checkpoint:
                from ..bridge import wav2vec2_state

                # The checkpoint's trunk over the seed's; the projection
                # and every other module keep the seed's values.
                params["semantic_encoder"].update(
                    (f"wav2vec2.{k}", v) for k, v in
                    wav2vec2_state(pretrained["wav2vec2"]).items())
        if self.device.type == "cuda":
            self._copy_streams = (torch.cuda.Stream(self.device),
                                  torch.cuda.Stream(self.device))
        for name, m in modules.items():
            m = m.to(self.device).eval()
            # The spectral fallback and the decoder have no compute type in
            # the reference: they stay float32.
            if name != "decoder" and not isinstance(m,
                                                    SpectralFallbackEncoder):
                m = m.to(self.dtype)
            setattr(self, name, m)
        if from_checkpoint:
            # float32 values kept for training and saving, as any loaded
            # weights (a bf16 module holds only their rounding).
            self.load_float_params(params)
            logger.info("Semantic encoder: pretrained wav2vec2-base weights"
                        + (" (cached init)" if cached is not None else ""))
        elif use_w2v2:
            logger.warn("Semantic encoder: wav2vec2 architecture with "
                        "random-init weights (no checkpoint available — "
                        "run `nat --fetch` once on a networked machine "
                        "to install it)")
        elif self.semantic_arch == "auto" and self.use_pretrained_semantic:
            logger.warn("wav2vec2 checkpoint unavailable; using spectral "
                        "fallback semantic encoder (run `nat --fetch` "
                        "once on a networked machine for real semantic "
                        "tokens)")
        if (cached is None and cache_key is not None
                and use_w2v2 == predicted_w2v2):
            paramcache.save_params(cache_key, {"modules": params,
                                               "pretrained": from_checkpoint})
        self._seed_initial_codebooks()

    def _init_cache_config(self, use_w2v2: bool) -> Dict[str, Any]:
        """Everything the initial parameters depend on (the parameter
        cache's key), as the reference's ``_init_cache_config``."""
        return dict(
            seed=self.seed, sample_rate=self.sample_rate,
            semantic_dim=self.semantic_dim, acoustic_dim=self.acoustic_dim,
            n_mels=self.n_mels, hop_length=self.hop_length,
            reconstruction=self.enable_reconstruction,
            compute_dtype=self.compute_dtype,
            arch="wav2vec2" if use_w2v2 else "spectral",
            arch_config=self.semantic_arch_config,
        )

    def _module_skeletons(self) -> Dict[str, nn.Module]:
        """The modules by name, on the CPU with uninitialized float32
        storage: the encoders, then the decoder with reconstruction."""
        with torch.device("meta"):
            mel = MelResidualEncoder(output_dim=self.acoustic_dim,
                                     n_mels=self.n_mels,
                                     hop_length=self.hop_length,
                                     sample_rate=self.sample_rate)
            if self.semantic_fallback:
                sem = SpectralFallbackEncoder(output_dim=self.semantic_dim)
            else:
                sem = SemanticAudioEncoder(output_dim=self.semantic_dim,
                                           arch=self.semantic_arch_config)
            ts = MultiScaleTemporalEncoder(input_dim=self.semantic_dim)
            ta = MultiScaleTemporalEncoder(input_dim=self.acoustic_dim)
            modules = dict(zip(MODULE_NAMES, (mel, sem, ts, ta)))
            if self.enable_reconstruction:
                modules["decoder"] = ReconstructionDecoder(
                    input_dim=self.semantic_dim + self.acoustic_dim)
        return {name: m.to_empty(device="cpu") for name, m in modules.items()}

    def _seeded_modules(self) -> Dict[str, nn.Module]:
        """The modules with the seed's float32 values, on the CPU, by
        name, filled from one seeded generator in order (the decoder last,
        so the encoders' values for a seed do not depend on
        reconstruction): CPU and CUDA tokenizers built from the same seed
        hold identical parameters."""
        generator = torch.Generator().manual_seed(self.seed)
        modules = self._module_skeletons()
        for m in modules.values():
            init_parameters(m, generator)
        return modules

    def float_params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """float32 state dicts of the modules, by name: the values that
        modules computing in bfloat16 were rounded from (the reference
        keeps float32 params and computes in bfloat16).  Training starts
        from these, and :func:`~nat_tpu_torch.runtime.checkpoint.save_model`
        writes them."""
        self.ensure_initialized()
        if self._float_params is not None:
            return self._float_params
        if self.dtype == torch.float32:
            return {name: getattr(self, name).state_dict()
                    for name in MODULE_NAMES
                    if getattr(self, name) is not None}
        return {name: m.state_dict()
                for name, m in self._seeded_modules().items()}

    def load_float_params(self, params: Dict[str, Dict[str, torch.Tensor]]
                          ) -> None:
        """Load float32 state dicts into every module (each cast to its
        module's dtype and device) and keep them as :meth:`float_params`."""
        self.ensure_initialized()
        present = {n for n in MODULE_NAMES if getattr(self, n) is not None}
        if set(params) != present:
            raise ValueError(f"params for {sorted(params)}, modules "
                             f"{sorted(present)}")
        for name, sd in params.items():
            getattr(self, name).load_state_dict(sd, strict=True)
        self._invalidate()
        self._float_params = None
        if self.dtype != torch.float32:
            self._float_params = {
                name: {k: v.detach().to("cpu", torch.float32, copy=True)
                       for k, v in sd.items()}
                for name, sd in params.items()}

    def _seed_initial_codebooks(self) -> None:
        """Codebooks from the cache, else seeded from the method's
        checkpoint, else the random ladder: semantic at ``seed``, acoustic
        at ``seed + 81``.  A feature-driven method only probes its cache
        here; on a miss it keeps the random ladder until
        :meth:`maybe_seed_from_audio` has an input to seed from."""
        if self.codebook_init_method in FEATURE_INIT_METHODS:
            cached = self._load_cached_feature_codebooks()
            if cached is not None:
                self._set_codebooks(*cached)
                return
            self._needs_audio_seeding = True
            self._set_codebooks(
                seeding.random_codebooks(
                    self.num_semantic_layers, self.codebook_size,
                    self.semantic_dim, self.seed),
                seeding.random_codebooks(
                    self.num_acoustic_layers, self.codebook_size,
                    self.acoustic_dim,
                    self.seed + seeding.ACOUSTIC_SEED_OFFSET))
            return
        common = dict(
            method=self.codebook_init_method,
            model_name=(self.encodec_model
                        if self.codebook_init_method == "encodec" else None),
            codebook_size=self.codebook_size,
            cache_dir=self.codebook_cache_dir,
            use_cache=self.enable_codebook_cache,
            force_reinit=self.force_reinit_codebooks,
            device=self.device,
        )
        sem_cb = seeding.seed_codebooks(
            extraction_type="semantic", num_layers=self.num_semantic_layers,
            input_dim=self.semantic_dim, seed=self.seed, **common)
        acc_cb = seeding.seed_codebooks(
            extraction_type="acoustic", num_layers=self.num_acoustic_layers,
            input_dim=self.acoustic_dim,
            seed=self.seed + seeding.ACOUSTIC_SEED_OFFSET, **common)
        self._set_codebooks(sem_cb, acc_cb)

    # The RVQ states: replacing one drops the captured graphs, which read
    # the codebooks at the addresses they had at capture, and the replicas,
    # which hold copies.
    @property
    def sem_rvq(self) -> Optional[RVQState]:
        return self._sem_rvq

    @sem_rvq.setter
    def sem_rvq(self, state: Optional[RVQState]) -> None:
        self._sem_rvq = state
        self._invalidate()

    @property
    def acc_rvq(self) -> Optional[RVQState]:
        return self._acc_rvq

    @acc_rvq.setter
    def acc_rvq(self, state: Optional[RVQState]) -> None:
        self._acc_rvq = state
        self._invalidate()

    def _invalidate(self) -> None:
        """Drop what holds the old weights or codebooks: the graphs and the
        replicas of other devices."""
        self._graphs.invalidate()
        self._replicas = {}

    # ------------------------------------------------------------------
    # Replicas (several devices)
    # ------------------------------------------------------------------
    def replicas(self, mesh) -> Dict[torch.device, "NeuralAudioTokenizer"]:
        """The model on each distinct device of ``mesh``, by device: this
        tokenizer on its own device, a replica elsewhere (made at its first
        use, kept until the weights or codebooks change)."""
        return replicated(mesh, self._replica)

    @_locked
    def _replica(self, device) -> "NeuralAudioTokenizer":
        device = canonical_device(device)
        if device == canonical_device(self.device):
            return self
        rep = self._replicas.get(device)
        if rep is None:
            rep = self._replicas[device] = self._make_replica(device)
        return rep

    def _make_replica(self, device: torch.device) -> "NeuralAudioTokenizer":
        """A copy of this tokenizer on ``device``: its modules and RVQ
        states copied there, and its own copy streams, graph cache and
        int16 tables.  It shares the configuration, the device lock, the
        span seeds and ``upload_stats`` (so the counts cover every
        shard)."""
        self.ensure_initialized()
        rep = copy.copy(self)
        rep.__dict__.update(
            device=device, _graphs=aotcache.ForwardGraphs(device),
            _replicas={}, _pcm16_tables={},
            _sem_rvq=self.sem_rvq.to(device),
            _acc_rvq=self.acc_rvq.to(device),
            _copy_streams=((torch.cuda.Stream(device),
                            torch.cuda.Stream(device))
                           if device.type == "cuda" else None))
        for name in MODULE_NAMES:
            module = getattr(self, name)
            if module is not None:
                setattr(rep, name, copy.deepcopy(module).to(device))
        logger.debug(f"Replicated the model onto {device}")
        return rep

    def _set_codebooks(self, sem_cb: np.ndarray, acc_cb: np.ndarray) -> None:
        """Both RVQ states from host codebooks, on the device.  They are
        the only copies the card holds: K1 reads them on every forward and
        ``decode_tokens`` gathers from them, and nothing derived from them
        is cached (prewarming keeps no tables)."""
        self.sem_rvq = RVQState.from_codebook(
            torch.from_numpy(np.ascontiguousarray(sem_cb))).to(self.device)
        self.acc_rvq = RVQState.from_codebook(
            torch.from_numpy(np.ascontiguousarray(acc_cb))).to(self.device)

    def _feature_seed_kwargs(self, extraction_type: str) -> Dict[str, Any]:
        sem = extraction_type == "semantic"
        return dict(
            method=self.codebook_init_method,
            extraction_type=extraction_type,
            num_layers=(self.num_semantic_layers if sem
                        else self.num_acoustic_layers),
            codebook_size=self.codebook_size,
            input_dim=self.semantic_dim if sem else self.acoustic_dim,
            seed=(self.seed if sem
                  else self.seed + seeding.ACOUSTIC_SEED_OFFSET),
            cache_dir=self.codebook_cache_dir,
            use_cache=self.enable_codebook_cache,
            force_reinit=self.force_reinit_codebooks,
        )

    def _load_cached_feature_codebooks(self):
        """``(semantic, acoustic)`` codebooks of a feature-driven method
        from the cache (read only), or None when either misses."""
        from ..quant import cache as cb_cache

        if not self.enable_codebook_cache or self.force_reinit_codebooks:
            return None
        cache_dir = (self.codebook_cache_dir
                     or cb_cache.get_default_codebook_cache_dir())
        out = []
        for extraction_type in ("semantic", "acoustic"):
            kw = self._feature_seed_kwargs(extraction_type)
            key = cb_cache.get_codebook_cache_key(
                f"{kw['method']}_nat-tpu", kw["codebook_size"],
                kw["num_layers"], kw["input_dim"], extraction_type)
            cached = cb_cache.load_codebooks(
                cache_dir, key, expect_shape=(
                    kw["num_layers"], kw["codebook_size"], kw["input_dim"]))
            if cached is None:
                return None
            out.append(cached[0])
        return tuple(out)

    # ------------------------------------------------------------------
    # Feature-driven seeding (needs input audio)
    # ------------------------------------------------------------------
    @_locked
    def maybe_seed_from_audio(self, audio, sample_rate: int) -> None:
        """Seed the codebooks by residual k-means over features of
        ``audio``: EnCodec latents for ``encodec-kmeans`` (a 30 s window),
        this model's own temporal-encoder outputs for ``kmeans`` (up to
        8 × 30 s spread evenly over the file).  A no-op unless a
        feature-driven method missed its cache and nothing has seeded
        yet.  Holds the device lock throughout, so no forward runs on
        half-replaced codebooks."""
        if not self._needs_audio_seeding:
            return
        self.ensure_initialized()
        audio = np.asarray(audio, dtype=np.float32).reshape(-1)
        sr = sample_rate or self.sample_rate
        max_samples = int(30.0 * sr)
        if self.codebook_init_method == "kmeans":
            # Eight 30 s chunks spread over the whole file, not its head:
            # a codebook that never saw the later content collapses there.
            max_samples *= 8
            if len(audio) > max_samples:
                chunk = int(30.0 * sr)
                starts = np.linspace(0, len(audio) - chunk,
                                     max_samples // chunk)
                audio = np.concatenate(
                    [audio[int(s):int(s) + chunk] for s in starts])
        audio = audio[:max_samples]

        if self.codebook_init_method == "encodec-kmeans":
            from .encodec import EncodecFeatureBridge

            bridge = EncodecFeatureBridge(self.encodec_model,
                                          device=self.device)
            if not bridge.available:
                logger.warn("encodec-kmeans init requested but no local "
                            "EnCodec checkpoint; keeping deterministic "
                            "random codebooks")
                self._needs_audio_seeding = False
                return
            f_sem = f_acc = bridge.extract_features_for_initialization(
                audio, sr)
        else:
            f_sem, f_acc = self._own_features(audio, sr)

        # k-means in the quantizer's own space keeps its scale (unwhitened);
        # EnCodec latents are a foreign space and are standardized.
        whiten = self.codebook_init_method != "kmeans"
        sem_cb = seeding.seed_codebooks(
            features=f_sem, whiten_features=whiten, device=self.device,
            **self._feature_seed_kwargs("semantic"))
        acc_cb = seeding.seed_codebooks(
            features=f_acc, whiten_features=whiten, device=self.device,
            **self._feature_seed_kwargs("acoustic"))
        self._set_codebooks(sem_cb, acc_cb)
        self._needs_audio_seeding = False
        logger.info(f"Codebooks seeded from input audio "
                    f"({self.codebook_init_method})")

    @torch.inference_mode()
    def _own_features(self, audio: np.ndarray, sr: int):
        """``(semantic [Ms, Ds], acoustic [Ma, Da])`` float32 features of
        ``audio`` through the forward's own encoders in the compute type:
        the audio cut into rows of one bucket (each row's padding frames
        trimmed by the exact frame arithmetic), and the acoustic stream
        over as many hop-shifted copies (stride phases of its /16 grid,
        at most 16) as the codebook needs rows."""
        bucket = bucket_length(min(len(audio), int(30.0 * sr)), sr)
        n_rows = max(1, -(-len(audio) // bucket))
        wave_np = np.zeros((n_rows, bucket), np.float32)
        fills = []
        for i in range(n_rows):
            row = audio[i * bucket:(i + 1) * bucket]
            wave_np[i, :len(row)] = row
            fills.append(len(row))
        rows_per_pass = max(1, sum(self._acoustic_frames(f) for f in fills))
        n_shift = int(min(16, max(
            1, -(-self.codebook_size // rows_per_pass))))
        acc_in = (np.concatenate([np.roll(wave_np, -s * self.hop_length,
                                          axis=1) for s in range(n_shift)])
                  if n_shift > 1 else wave_np)
        acc_f = self.temporal_acoustic(self.mel_encoder(
            torch.from_numpy(acc_in).to(self.device)))
        acc_np = acc_f.float().cpu().numpy()
        del acc_f
        wave = torch.from_numpy(wave_np).to(self.device)
        wave16 = by_rows(lambda w: resample_torch(w, sr, SEMANTIC_SR), wave,
                         self.row_invariant)
        sem_f = self.temporal_semantic(
            self.semantic_encoder(wave16, rowwise=self.row_invariant))
        sem_np = sem_f.float().cpu().numpy()
        f_sem = np.concatenate([
            sem_np[i, :min(self._semantic_frames(fills[i], sr),
                           sem_np.shape[1])] for i in range(n_rows)])
        acc_parts = []
        for s in range(n_shift):
            for i in range(n_rows):
                # Shifted content [s·hop, fill) lands at [0, fill − s·hop);
                # the roll wraps head samples into the tail, so one more
                # trailing frame is dropped as a purity guard.
                valid = self._acoustic_frames(
                    max(fills[i] - s * self.hop_length, 0))
                if s:
                    valid -= 1
                if valid > 0:
                    acc_parts.append(acc_np[s * n_rows + i,
                                            :min(valid, acc_np.shape[1])])
        return f_sem, np.concatenate(acc_parts)

    # ------------------------------------------------------------------
    # Frame arithmetic
    # ------------------------------------------------------------------
    def _acoustic_frames(self, samples: int) -> int:
        t_mel = stft_num_frames(samples, 2048, self.hop_length, center=True)
        return -(-t_mel // 16)  # four stride-2 convs with SAME padding

    def _semantic_frames(self, samples: int,
                         sample_rate: Optional[int] = None) -> int:
        sr = sample_rate or self.sample_rate
        t16 = resample_output_length(samples, sr, SEMANTIC_SR)
        if self.semantic_arch == "auto":
            self.ensure_initialized()     # resolves the encoder
        if self.semantic_fallback:
            return t16 // 320 + 1
        conv_layers = (self.semantic_arch_config or {}).get("conv_layers")
        if conv_layers is not None:
            return feature_extractor_output_length(t16, conv_layers)
        return feature_extractor_output_length(t16)

    def _target_frames(self, samples: int,
                       sample_rate: Optional[int] = None) -> int:
        if self.timebase == "frame":
            return max(samples // self.hop_length, 1)
        return max(min(self._semantic_frames(samples, sample_rate),
                       self._acoustic_frames(samples)), 1)

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _sampling_seeds(self) -> Optional[torch.Tensor]:
        """The next span's sampling seeds, one per stream (the reference
        splits its PRNG key per span, tokenizer.py:1396, and draws one seed
        per stream, :707-708): an int64 ``[2]`` tensor on the tokenizer's
        device, which K2 reads when it runs; None in argmin mode.  On the
        card they go up from a pinned buffer on the compute stream; the
        host allocator keeps that buffer until the copy has run."""
        if not self.stochastic:
            return None
        seeds = torch.randint(0, 2 ** 31 - 1, (2,),
                              generator=self._span_seeds)
        if self.device.type != "cuda":
            return seeds
        return seeds.pin_memory().to(self.device, non_blocking=True)

    def _features(self, waveform: torch.Tensor, sr: int, t_target: int):
        """Both streams' encoder outputs for a padded batch, aligned to
        ``t_target`` frames: ``[B, T_target, D]`` float32, contiguous."""
        wave16 = by_rows(lambda w: resample_torch(w, sr, SEMANTIC_SR),
                         waveform, self.row_invariant)
        sem = self.temporal_semantic(
            self.semantic_encoder(wave16, rowwise=self.row_invariant))
        acc = self.temporal_acoustic(self.mel_encoder(waveform,
                                                      sample_rate=sr))

        def align(f):
            return interp_linear(f.transpose(1, 2),
                                 t_target).transpose(1, 2).contiguous()

        return align(sem), align(acc)

    def _aot_config(self, sr: int, bucket: int) -> Dict[str, Any]:
        """What a forward's kernels depend on beyond the batch's shape,
        as the reference's ``_aot_config``."""
        return dict(
            sr=sr, bucket=bucket, sample_rate=self.sample_rate,
            semantic_dim=self.semantic_dim, acoustic_dim=self.acoustic_dim,
            n_mels=self.n_mels, hop_length=self.hop_length,
            reconstruction=self.enable_reconstruction,
            timebase=self.timebase, stochastic=self.stochastic,
            temperature=self.temperature, compute_dtype=self.compute_dtype,
            arch=type(self.semantic_encoder).__name__,
            arch_config=self.semantic_arch_config,
        )

    def _graph_key(self, sr: int, shape, reconstruct: bool) -> tuple:
        """The graph cache's key of a forward of a ``shape`` batch: the
        reference's config, the rows, ``reconstruct``, the row- and
        batch-invariance switches, and torch's switches that decide which
        cuDNN and cuBLAS kernels a capture records."""
        config = self._aot_config(sr, int(shape[-1]))
        config.update(
            rows=int(shape[0]), reconstruct=reconstruct,
            row_invariant=self.row_invariant,
            batch_invariant=self.batch_invariant,
            cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
            cudnn_deterministic=torch.backends.cudnn.deterministic,
            cudnn_benchmark=torch.backends.cudnn.benchmark,
            matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
        return tuple(sorted((k, repr(v) if isinstance(v, (dict, list))
                             else v) for k, v in config.items()))

    @_locked
    def forward(self, waveform: torch.Tensor,
                sample_rate: Optional[int] = None,
                reconstruct: bool = False) -> Dict[str, Any]:
        """One padded batch ``[B, bucket]`` (float32, on the tokenizer's
        device) → codes ``[N, B, T_target]``, features ``[B, D, T_target]``
        and per-row losses ``[B]``, all still on the device; with a decoder
        and ``reconstruct`` also ``reconstructed [B, T_target·hop]``.  In
        stochastic mode each call draws the next span's seeds.  On the card
        each shape goes through the CUDA-graph cache
        (:mod:`nat_tpu_torch.runtime.aotcache`): eager at its first sight,
        captured at its second, replayed from then on; a batch of more
        rows than :meth:`_graph_rows` always runs eagerly."""
        # Initialized outside inference mode: modules made inside it would
        # hold inference tensors, which later weight loads cannot write.
        self.ensure_initialized()
        sr = sample_rate or self.sample_rate
        reconstruct = bool(reconstruct and self.decoder is not None)
        # A replica on another card captures and replays there.
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        with torch.inference_mode(), on_card:
            return self._graphs.run(
                self._graph_key(sr, waveform.shape, reconstruct),
                functools.partial(self._forward_impl, sr, reconstruct),
                (waveform, self._sampling_seeds()),
                describe=(f"forward program (bucket={waveform.shape[-1]}, "
                          f"rows={waveform.shape[0]})"),
                capture=waveform.shape[0] <= self._graph_rows())

    def _forward_impl(self, sr: int, reconstruct: bool,
                      waveform: torch.Tensor,
                      seeds: Optional[torch.Tensor]) -> Dict[str, Any]:
        """The forward of :meth:`forward`, as a graph captures it: device
        work only (no host sync, no upload), from the batch and the
        seeds."""
        t_target = self._target_frames(waveform.shape[-1], sr)
        if self.batch_invariant and waveform.shape[0] > 1:
            rows = [self._features(row, sr, t_target)
                    for row in waveform.split(1)]
            sem_a, acc_a = (torch.cat(f) for f in zip(*rows))
        else:
            sem_a, acc_a = self._features(waveform, sr, t_target)
        sample_s = sample_a = {}
        if seeds is not None:
            sample_s = {"temperature": self.temperature, "seed": seeds[0:1]}
            sample_a = {"temperature": self.temperature, "seed": seeds[1:2]}
        sem_codes, sem_q, sem_losses = rvq_kernel.rvq_encode(
            self.sem_rvq, sem_a, per_row=True, **sample_s)
        acc_codes, acc_q, acc_losses = rvq_kernel.rvq_encode(
            self.acc_rvq, acc_a, per_row=True, **sample_a)
        if self.codebook_size <= 32767:
            sem_codes = sem_codes.to(torch.int16)
            acc_codes = acc_codes.to(torch.int16)
        losses = {
            "semantic_vq_loss": sem_losses["total_vq_loss"],
            "acoustic_vq_loss": acc_losses["total_vq_loss"],
            "total_vq_loss": (sem_losses["total_vq_loss"]
                              + acc_losses["total_vq_loss"]),
        }
        reconstructed = None
        if reconstruct:
            out_samples = t_target * self.hop_length
            reconstructed = self.decoder(torch.cat([sem_q, acc_q], dim=-1),
                                         out_samples)
            losses["reconstruction_loss"] = torch.mean(
                (reconstructed - waveform[:, :out_samples]) ** 2, dim=1)
        return {
            "semantic_codes": sem_codes,
            "acoustic_codes": acc_codes,
            "semantic_features": sem_a.transpose(1, 2),
            "acoustic_features": acc_a.transpose(1, 2),
            "reconstructed": reconstructed,
            "losses": losses,
        }

    # ------------------------------------------------------------------
    # Spans
    # ------------------------------------------------------------------
    def prepare_span(self, chunk: np.ndarray, ext_start: int, start: int,
                     length: int, overlap: int, sr: int):
        """Bucket-pad one overlap-extended span: ``(padded [B, bucket],
        SpanMeta)``; an int16 span (the wire) stays int16."""
        chunk = np.atleast_2d(np.asarray(chunk))
        if chunk.dtype != np.int16:
            chunk = chunk.astype(np.float32, copy=False)
        ext_len = chunk.shape[-1]
        bucket = bucket_length(ext_len, sr)
        if ext_len < bucket:
            chunk = np.pad(chunk, ((0, 0), (0, bucket - ext_len)))
        return chunk, SpanMeta(ext_start, start, length, overlap, sr,
                               ext_len, bucket)

    @_locked
    def dispatch_span(self, chunk: np.ndarray, ext_start: int, start: int,
                      length: int, overlap: int, sr: int, pcm_divisor=None):
        """Upload one span (int16 with its ``pcm_divisor`` on the wire) and
        enqueue its forward: ``(device outputs, SpanMeta)`` for
        :meth:`finalize_span`."""
        chunk, meta = self.prepare_span(chunk, ext_start, start, length,
                                        overlap, sr)
        return self._dispatch_staged(self._upload(chunk, pcm_divisor),
                                     sr), meta

    @_locked
    def dispatch_span_group(self, wave, group, overlap, sr, total,
                            group_size, pcm_divisor=None):
        """One batched forward over ``group``'s spans of ``wave`` (all of
        one bucket; zero rows pad to a power of two ≤ ``group_size``):
        ``(device outputs, List[SpanMeta])`` for
        :meth:`finalize_span_group`."""
        chunks, metas = self._prepare_group(wave, group, overlap, sr, total)
        return self.dispatch_prepared_group(chunks, metas, group_size,
                                            pcm_divisor=pcm_divisor)

    @_locked
    def dispatch_prepared_group(self, chunks, metas, group_size,
                                pcm_divisor=None, mesh=None,
                                state_override=None, reconstruct=False):
        """Stack prepared ``[1, bucket]`` chunks (one bucket, rate and
        transport: spans of one file, or concurrent serving requests) into
        one padded batched forward: ``(device outputs, List[SpanMeta])``
        for :meth:`finalize_span_group`.

        ``mesh``: pad the rows to a ``dp`` multiple as well and split them
        into ``dp`` contiguous shards; each shard is uploaded and runs on
        its device's replica (``state_override``: the replicas by device,
        by default :meth:`replicas`), and the real rows of the shards'
        outputs are gathered onto this tokenizer's device."""
        stacked = self._pad_group_rows(
            np.concatenate(chunks, axis=0), group_size,
            dp=None if mesh is None else mesh.shape["dp"])
        sr = metas[0].sr
        if mesh is None:
            if state_override is not None:
                raise ValueError("state_override needs a mesh")
            return self._dispatch_staged(self._upload(stacked, pcm_divisor),
                                         sr, reconstruct), metas
        reps = (state_override if state_override is not None
                else self.replicas(mesh))
        shards = [(reps[d], stacked[rows]) for d, rows in zip(
            mesh.dp_devices(), batch_sharding(mesh, stacked.shape[0]))]
        # Every shard's upload starts before the first forward.
        staged = [(rep, rep._upload(host, pcm_divisor))
                  for rep, host in shards]
        outs = [rep._dispatch_staged(upload, sr, reconstruct)
                for rep, upload in staged]
        return self._gather_rows(outs, sum(c.shape[0] for c in chunks)), \
            metas

    def _gather_rows(self, outs: List[Dict], rows: int) -> Dict:
        """The shards' outputs as one output of the first ``rows`` rows (the
        rest pad), on this tokenizer's device."""
        def gather(parts, dim):
            parts = [p.to(self.device) for p in parts]
            whole = torch.cat(parts, dim) if len(parts) > 1 else parts[0]
            return whole.narrow(dim, 0, rows)

        out = {k: (None if outs[0][k] is None else gather(
                   [o[k] for o in outs], 1 if k.endswith("codes") else 0))
               for k in OUTPUT_KEYS}
        out["losses"] = {k: gather([o["losses"][k] for o in outs], 0)
                         for k in outs[0]["losses"]}
        return out

    def _prepare_group(self, wave, group, overlap, sr, total):
        chunks, metas = [], []
        for start, length in group:
            ext_start = max(0, start - overlap)
            ext_end = min(total, start + length + overlap)
            chunk, meta = self.prepare_span(wave[:, ext_start:ext_end],
                                            ext_start, start, length,
                                            overlap, sr)
            chunks.append(chunk)
            metas.append(meta)
        return chunks, metas

    @staticmethod
    def _pad_group_rows(stacked: np.ndarray, group_size: int,
                        dp: Optional[int] = None) -> np.ndarray:
        """Pad a stacked ``[G, bucket]`` batch with zero rows to the next
        power of two ≤ ``group_size`` (and then to a ``dp`` multiple, for
        even shards): at most log2(G) + 1 batch shapes per bucket, and a
        tail of 3 spans uploads 4 rows, not 8."""
        target = 1
        while target < stacked.shape[0]:
            target *= 2
        target = min(target, max(group_size, 1))
        if dp is not None:
            target = -(-max(target, dp) // dp) * dp
        if stacked.shape[0] < target:
            stacked = np.pad(stacked,
                             ((0, target - stacked.shape[0]), (0, 0)))
        return stacked

    @staticmethod
    def _plan_span_groups(spans, overlap, sr, total, group_size,
                          first_single: bool = True):
        """Dispatch items: the first span alone (first frames after one
        single-row forward; ``first_single=False`` when all data is in
        hand), then runs of same-bucket spans in groups of ≤
        ``group_size``; a run of one stays a single-row item."""
        def span_bucket(start, length):
            ext = (min(total, start + length + overlap)
                   - max(0, start - overlap))
            return bucket_length(ext, sr)

        items = []
        i = 0
        if first_single and group_size > 1 and len(spans) > 1:
            items.append([spans[0]])
            i = 1
        while i < len(spans):
            if group_size == 1:
                items.append([spans[i]])
                i += 1
                continue
            b = span_bucket(*spans[i])
            j = i
            while (j < len(spans) and j - i < group_size
                   and span_bucket(*spans[j]) == b):
                j += 1
            items.append(list(spans[i:j]) if j - i > 1 else [spans[i]])
            i = j
        return items

    def _graph_rows(self) -> int:
        """Most rows a forward is captured at: a span group's, and at
        least ``GRAPH_ROWS``.  The runner's larger batches (16 and 32 rows
        of the 30 s bucket) run eagerly: their graphs' pool would hold
        another copy of their activations for the process's life."""
        return max(GRAPH_ROWS, self._stream_group_size())

    def _stream_group_size(self) -> int:
        """Spans per batched dispatch: 8 on the card, 1 on the CPU (padded
        rows are not free there); ``NAT_TPU_STREAM_GROUP`` overrides."""
        return _env_count("NAT_TPU_STREAM_GROUP",
                          8 if self.device.type == "cuda" else 1)

    @staticmethod
    def _stream_lookahead() -> int:
        """Dispatched items kept in flight before the oldest is finalized
        (``NAT_TPU_STREAM_LOOKAHEAD``)."""
        return _env_count("NAT_TPU_STREAM_LOOKAHEAD", 2)

    @staticmethod
    def _stage_ahead() -> int:
        """Plan items staged (prepared and uploading) beyond the one being
        dispatched (``NAT_TPU_STREAM_STAGE_AHEAD``); each holds one
        ``[G, bucket]`` buffer on the card."""
        return _env_count("NAT_TPU_STREAM_STAGE_AHEAD", 2)

    # ------------------------------------------------------------------
    # Host ↔ device
    # ------------------------------------------------------------------
    def _pcm16_wire(self, wave: np.ndarray, hint=None):
        """``(int16 wave, divisor)`` when ``wave`` can ride the int16 wire,
        else None (float32 upload).  On for a CUDA device, off on the CPU
        unless ``NAT_TPU_PCM16_WIRE=1``; ``NAT_TPU_PCM16_WIRE=0`` turns it
        off everywhere.  ``hint=(i16, divisor)``, a loader's sidecar, is
        probe-checked and skips the full recovery scan."""
        env = os.environ.get("NAT_TPU_PCM16_WIRE")
        if env == "0" or (env != "1" and self.device.type != "cuda"):
            return None
        if hint is not None:
            i16, divisor = hint
            i16 = np.atleast_2d(np.asarray(i16))
            if (i16.shape == wave.shape
                    and pcm.verify_hint(wave, i16, divisor)
                    and pcm.device_conversion_exact(divisor, self.device)):
                return i16, np.float32(divisor)
        rec = pcm.recover_pcm16(wave)
        if rec is None or not pcm.device_conversion_exact(rec[1],
                                                           self.device):
            return None
        return rec

    def _pcm16_table(self, divisor) -> torch.Tensor:
        """The conversion table of ``divisor`` on the card, made once (on
        the compute stream, before any gather that reads it) and kept for
        every later span."""
        key = float(divisor)
        table = self._pcm16_tables.get(key)
        if table is None:
            if len(self._pcm16_tables) > 32:
                self._pcm16_tables.clear()
            table = torch.from_numpy(pcm.conversion_table(
                np.float32(divisor))).to(self.device)
            self._pcm16_tables[key] = table
        return table

    def _upload(self, host: np.ndarray, pcm_divisor=None) -> Staged:
        """Start the upload of one prepared ``[B, bucket]`` batch, float32
        or int16 (the wire, with its ``pcm_divisor``).  On the card the
        batch is copied into a pinned buffer and sent with ``non_blocking``
        on the upload stream; the event marks the copy's end, and the host
        caching allocator keeps the pinned buffer until then.  On the CPU
        the tensor holds the array's values."""
        self.ensure_initialized()     # makes the copy streams
        wire = host.dtype == np.int16
        if wire and pcm_divisor is None:
            raise ValueError("an int16 batch needs its pcm_divisor")
        host = np.ascontiguousarray(host,
                                    dtype=np.int16 if wire else np.float32)
        with self._device_lock:
            self.upload_stats["int16" if wire else "float32"] += 1
            self.upload_stats["bytes"] += host.nbytes
        divisor = float(pcm_divisor) if wire else None
        if self.device.type != "cuda":
            if not host.flags.writeable:    # a view of the file's bytes
                host = host.copy()
            return Staged(torch.from_numpy(host), None, divisor)
        pinned = torch.empty(host.shape, pin_memory=True,
                             dtype=torch.int16 if wire else torch.float32)
        pinned.numpy()[...] = host
        upload = self._copy_streams[0]
        with torch.cuda.stream(upload):
            dev = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(upload)
        return Staged(dev, ready, divisor)

    @_locked
    def _dispatch_staged(self, staged: Staged, sr: int,
                         reconstruct: bool = False):
        """Enqueue the forward of an uploaded batch on the compute stream,
        after its upload: the compute stream waits on the upload's event,
        and the batch's memory is marked in use there, so the allocator
        cannot hand it to the next upload while the compute stream reads
        it.  An int16 batch becomes the pipeline's float32 by the table
        gather, on the compute stream too (padded rows are int16 zeros, and
        ``table[32768]`` is 0.0)."""
        dev = staged.tensor
        if staged.ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(staged.ready)
            dev.record_stream(compute)
        if dev.dtype == torch.int16:
            dev = pcm.convert_on_device(dev,
                                        self._pcm16_table(staged.pcm_divisor))
        return self.forward(dev, sr, reconstruct)

    @staticmethod
    def _fetch_leaves(out: Dict, want_features: bool) -> Dict:
        """The outputs finalize reads, flat: output keys, and
        ``("losses", name)`` for the per-row losses."""
        keys = OUTPUT_KEYS if want_features else OUTPUT_KEYS[:3]
        leaves = {k: out[k] for k in keys if out.get(k) is not None}
        leaves.update({("losses", k): v for k, v in out["losses"].items()})
        return leaves

    def _prefetch_outputs(self, out: Dict, want_features: bool) -> None:
        """Start the device → host copies of what finalize reads, into
        pinned buffers on the fetch stream, ordered after the forward; an
        event after them is kept in ``out["_host"]``.  Outputs that are not
        on the card (the CPU, or rows already fetched) are left alone."""
        leaves = {k: v for k, v in self._fetch_leaves(out,
                                                      want_features).items()
                  if isinstance(v, torch.Tensor) and v.is_cuda}
        if not leaves or "_host" in out:
            return
        fetch = self._copy_streams[1]
        fetch.wait_stream(torch.cuda.current_stream(self.device))
        host = {}
        # The forward's outputs are inference tensors: marking their use
        # on another stream counts as an update of them.
        with annotate("nat/prefetch"), torch.inference_mode(), \
                torch.cuda.stream(fetch):
            for key, v in leaves.items():
                # The forward's buffers are in use on the fetch stream until
                # the copy ends.
                v.record_stream(fetch)
                host[key] = torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                host[key].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(fetch)
        out["_host"] = (host, done)

    @staticmethod
    def _outputs_ready(out: Dict) -> bool:
        """True when a dispatched item's prefetched outputs have arrived
        (or were never on the card): the coalescing test of
        ``iter_chunks``."""
        prefetched = out.get("_host")
        return prefetched is None or prefetched[1].query()

    def _device_get(self):
        """The region of a wait for device results: a verbose-mode
        heartbeat around a process's first (which waits for the first
        forward's kernels to build and run), ``nat/device_get`` after."""
        if self._first_fetch_done:
            return annotate("nat/device_get")
        self._first_fetch_done = True
        return heartbeat("waiting for first device results", announce=(
            "waiting for first device results (the first forward builds "
            "its kernels; later fetches are fast)"))

    def _host_outputs(self, out: Dict, want_features: bool) -> Dict:
        """The outputs finalize reads, as numpy: the prefetched copies once
        their event has completed (a buffer is never read before), the
        rest copied now."""
        needed = self._fetch_leaves(out, want_features)
        self._prefetch_outputs(out, want_features)
        host, done = out.get("_host", ({}, None))
        with self._device_get():
            if done is not None:
                done.synchronize()
            arrays = {}
            for key, v in needed.items():
                if key in host:
                    v = host[key]
                arrays[key] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
        result = {k: arrays.get(k) for k in OUTPUT_KEYS}
        result["losses"] = {k[1]: v for k, v in arrays.items()
                            if isinstance(k, tuple)}
        return result

    # ------------------------------------------------------------------
    # Finalize
    # ------------------------------------------------------------------
    @staticmethod
    def row_losses(losses: Dict, row: int) -> Dict[str, float]:
        """One batch row's losses as floats."""
        out = {}
        for k, v in losses.items():
            a = np.asarray(v).reshape(-1)
            out[k] = float(a[row] if a.size > 1 else a[0])
        return out

    def finalize_span(self, out: Dict, meta: SpanMeta,
                      want_features: bool = True) -> Dict:
        """Fetch one span's outputs and keep the frames whose centers fall
        inside the span's own extent (overlap-discard)."""
        out = self._host_outputs(out, want_features)
        with annotate("nat/finalize"):
            valid_t = self._target_frames(meta.ext_len, meta.sr)
            sem = out["semantic_codes"][:, :, :valid_t]
            acc = out["acoustic_codes"][:, :, :valid_t]
            if meta.overlap:
                # Frame f covers samples centered at (f+0.5)*ext_len/valid_t
                # (relative to ext_start); keep centers inside [start, end).
                centers = meta.ext_start + (np.arange(valid_t) + 0.5) * (
                    meta.ext_len / max(valid_t, 1))
                keep = ((centers >= meta.start)
                        & (centers < meta.start + meta.length))
                sem, acc = sem[:, :, keep], acc[:, :, keep]
            reconstructed = None
            if out["reconstructed"] is not None:
                valid_samples = min(valid_t * self.hop_length, meta.ext_len)
                reconstructed = out["reconstructed"][:, :valid_samples]
                if meta.overlap:
                    lo = meta.start - meta.ext_start
                    reconstructed = reconstructed[:, lo:lo + meta.length]
            return {
                "semantic_codes": sem,
                "acoustic_codes": acc,
                "reconstructed": reconstructed,
                "losses": self.row_losses(out["losses"], 0),
                "semantic_features": (out["semantic_features"]
                                      if want_features else None),
                "acoustic_features": (out["acoustic_features"]
                                      if want_features else None),
            }

    def finalize_span_group(self, out: Dict, metas: List[SpanMeta],
                            want_features: bool = True):
        """Fetch one group's outputs (one host fetch for the group) and
        finalize each real row, in span order.  A group of one span is
        :meth:`finalize_span`, all of its rows kept."""
        host = self._host_outputs(out, want_features)
        if len(metas) == 1:
            yield self.finalize_span(host, metas[0], want_features)
            return
        for g, meta in enumerate(metas):
            # No region stays open across the yield: the consumer's own
            # regions run between yields.
            with annotate("nat/finalize"):
                row = {k: (None if host[k] is None
                           else host[k][:, g:g + 1] if k.endswith("codes")
                           else host[k][g:g + 1]) for k in OUTPUT_KEYS}
                row["losses"] = {k: np.asarray(v).reshape(-1)[g:g + 1]
                                 for k, v in host["losses"].items()}
            yield self.finalize_span(row, meta, want_features)

    def tokenize_span(self, chunk: np.ndarray, ext_start: int, start: int,
                      length: int, overlap: int, sr: int,
                      want_features: bool = True, pcm_divisor=None) -> Dict:
        """Tokenize one overlap-extended span (samples
        ``[ext_start : start+length+overlap]``; int16 with its
        ``pcm_divisor`` on the wire)."""
        return self.finalize_span(
            *self.dispatch_span(chunk, ext_start, start, length, overlap, sr,
                                pcm_divisor=pcm_divisor),
            want_features=want_features)

    # ------------------------------------------------------------------
    # The pipelined span loop
    # ------------------------------------------------------------------
    def iter_chunks(self, waveform, actual_sample_rate: Optional[int] = None,
                    want_features: bool = True, reconstruct: bool = False,
                    pcm16_hint=None):
        """Tokenize a signal span by span; yields one dict per span, in
        order, with codes ``[N, B, t]``, losses and (optionally) features.

        Each interior span is extended by ~1 s of real neighbour audio on
        both sides and only the frames centred inside its own extent are
        kept, so every frame is kept exactly once.  Spans are dispatched by
        the plan of :meth:`_plan_span_groups`: item k+1 is uploading while
        item k computes, and up to ``lookahead`` items are in flight before
        the oldest is finalized (with every later item already done), so
        the host's serialization overlaps the card's work.
        ``reconstruct`` runs the decoder in each span's forward.  Spans of
        a PCM16 wave ride the int16 wire (:meth:`_pcm16_wire`;
        ``pcm16_hint`` is the loader's ``(i16, divisor)``)."""
        self.ensure_initialized()
        wave = np.atleast_2d(np.asarray(waveform, dtype=np.float32))
        sr = actual_sample_rate or self.sample_rate
        total = wave.shape[-1]
        overlap = int(sr)
        spans = chunk_spans(total, sr, overlap=overlap)
        if len(spans) == 1:
            overlap = 0
        group_size = self._stream_group_size()
        if self.stochastic or wave.shape[0] != 1:
            group_size = 1
        plan = iter(self._plan_span_groups(spans, overlap, sr, total,
                                           group_size))
        src, divisor = wave, None
        with annotate("nat/pcm16_wire"):
            wire = self._pcm16_wire(wave, hint=pcm16_hint)
        if wire is not None:
            src, divisor = wire
        lookahead = self._stream_lookahead()
        staged: deque = deque()   # (Staged, metas)
        pending: List[Any] = []   # (device outputs, metas)

        def stage_next() -> None:
            item = next(plan, None)
            if item is not None:
                with annotate("nat/stage"):
                    chunks, metas = self._prepare_group(src, item, overlap,
                                                        sr, total)
                    staged.append((self._upload(self._pad_group_rows(
                        np.concatenate(chunks, 0), group_size), divisor),
                        metas))

        for _ in range(1 + self._stage_ahead()):
            stage_next()
        while staged:
            upload, metas = staged.popleft()
            with annotate("nat/dispatch"):
                out = self._dispatch_staged(upload, sr, reconstruct)
            del upload
            stage_next()
            self._prefetch_outputs(out, want_features)
            pending.append((out, metas))
            while len(pending) > lookahead:
                batch = [pending.pop(0)]
                while pending and self._outputs_ready(pending[0][0]):
                    batch.append(pending.pop(0))
                yield from self._finalize_plan_items(batch, want_features)
        yield from self._finalize_plan_items(pending, want_features)

    def _finalize_plan_items(self, items, want_features: bool):
        for out, metas in items:
            yield from self.finalize_span_group(out, metas, want_features)

    def eval(self) -> "NeuralAudioTokenizer":
        return self

    def encode(self, waveform, actual_sample_rate: Optional[int] = None
               ) -> Dict:
        """The reference's ``encode``: :meth:`__call__`."""
        return self(waveform, actual_sample_rate)

    def __call__(self, waveform, actual_sample_rate: Optional[int] = None,
                 want_features: bool = True, reconstruct: bool = True,
                 pcm16_hint=None) -> Dict:
        sem_parts: List[np.ndarray] = []
        acc_parts: List[np.ndarray] = []
        recon_parts: List[np.ndarray] = []
        losses: Dict[str, float] = {}
        last: Dict = {"semantic_features": None, "acoustic_features": None}
        for out in self.iter_chunks(waveform, actual_sample_rate,
                                    want_features=want_features,
                                    reconstruct=reconstruct,
                                    pcm16_hint=pcm16_hint):
            sem_parts.append(out["semantic_codes"])
            acc_parts.append(out["acoustic_codes"])
            if out["reconstructed"] is not None:
                recon_parts.append(out["reconstructed"])
            losses = out["losses"]
            last = out
        sem_codes = np.concatenate(sem_parts, axis=-1)
        acc_codes = np.concatenate(acc_parts, axis=-1)
        return {
            "semantic_codes": [sem_codes[i] for i in range(sem_codes.shape[0])],
            "acoustic_codes": [acc_codes[i] for i in range(acc_codes.shape[0])],
            "losses": losses,
            "reconstructed": (np.concatenate(recon_parts, axis=-1)
                              if recon_parts else None),
            "semantic_features": last["semantic_features"],
            "acoustic_features": last["acoustic_features"],
            "num_frames": int(sem_codes.shape[-1]),
        }

    @_locked
    @torch.inference_mode()
    def decode_tokens(self, semantic_codes: List,
                      acoustic_codes: List) -> np.ndarray:
        """Token layers (``[B, T]`` each) → waveform ``[B, T·hop]`` float32:
        the RVQ decode of both streams, concatenated, through the
        reconstruction decoder over the whole token matrix in one pass
        (``nat_tpu/models/tokenizer.py:1452-1479``).  The decoder and the
        codebooks are float32 whatever the encoders' compute type, and
        TF32 is off for its convolutions and products
        (:func:`~nat_tpu_torch.device.ieee_float32`), as in the
        reference's float32 decode.  One device → host copy of the
        waveform."""
        self.ensure_initialized()
        if self.decoder is None:
            raise ValueError("decode_tokens requires enable_reconstruction")

        def stack(codes):
            return torch.from_numpy(np.stack(
                [np.asarray(c, dtype=np.int64) for c in codes])).to(
                    self.device)

        sem, acc = stack(semantic_codes), stack(acoustic_codes)
        joint = torch.cat([rvq_decode(self.sem_rvq, sem),
                           rvq_decode(self.acc_rvq, acc)], dim=-1)
        with ieee_float32():
            wave = self.decoder(joint, sem.shape[-1] * self.hop_length)
        return wave.cpu().numpy()
