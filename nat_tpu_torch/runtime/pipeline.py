"""Audio → token streams and outputs, port of ``AudioTokenizationPipeline``
(``nat_tpu/runtime/pipeline.py``).

* :meth:`stream_audio` — a file: decode (WAV, AU, AIFF, FLAC, or raw PCM),
  peak-normalize, header, frames per span as the tokenizer's pipelined
  span loop yields them, ``end``.
* :meth:`stream_audio_array` — audio already in memory (serving's
  buffered fallback), through ``span_executor`` when one is set.
* :meth:`stream_stdin` — a byte stream decoded as it arrives
  (``--stream-stdin``), one complete stream per ASCII-FS-delimited file;
  spans that are already buffered dispatch as one group.

* :meth:`process_audio` — one file, buffered: text tokens in the three
  formats, the JSON dump, the ``--streaming`` text protocol, the whole
  NDJSON stream, the reconstruction and the metadata;
  :meth:`batch_process` writes them per file into a directory.  Several
  files tokenize together (:meth:`_tokenize_many`): their spans share the
  batched forwards of the data-parallel runner.

Every stream ends with the reference's ``end`` event: the 20
:class:`~nat_tpu_torch.eval.metrics.TokenizationMetrics` fields and the
budget fields.  With ``enable_reconstruction`` (the default, as in the
reference) the file and in-memory streams decode their whole token matrix
once (:meth:`NeuralAudioTokenizer.decode_tokens`) and the ``end`` event
carries the reconstruction metrics and ``decoding_time``; stdin streams
hold only their last span's audio and, as in the reference, leave those
fields 0.0.  The span forwards of the streams skip the decoder.
``rle_mode``, ``per_layer_encoding``, ``keyframe_interval_seconds`` and
``include_legend`` set the NDJSON encoding.  ``model_config`` holds the
sizes and ``semantic_arch`` (default ``auto``: the local wav2vec2-base
checkpoint, else the spectral fallback); ``codebook_init_method``,
``encodec_model`` and the three codebook-cache arguments set the seeding
of the codebooks, as in the reference.  ``model_path`` loads a
checkpoint written by :func:`nat_tpu_torch.runtime.checkpoint.save_model`;
``stochastic`` samples tokens at ``temperature`` (spans stay one per
forward).  ``resample_rate`` resamples every input on the host (numpy
polyphase) and makes that the model's rate; ``max_length`` trims or
zero-pads the loaded audio to that many samples.  With a feature-driven
``codebook_init_method`` each entry seeds the codebooks from the window the
reference uses: the whole file (the first loaded one for a batch), or the
first span's extended window of a ``--stream-stdin`` stream.

``enable_compat_fallback`` asks for the compatibility tokenizer
(:mod:`nat_tpu_torch.models.compat`): labeled random tokens, flagged
``compat_mode`` in every header.  It is used only when asked for: unlike
the reference, a neural tokenizer that cannot be built (no card, a kernel
that does not build) raises instead of falling back to random tokens.
"""

from __future__ import annotations

import copy
import hashlib
import time
from dataclasses import asdict
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..eval.budget import TokenBudgetMeter
from ..eval.metrics import TokenizationEvaluator
from ..io import audio as audio_io
from ..models.compat import CompatTokenizer
from ..models.tokenizer import NeuralAudioTokenizer
from ..stream.formatter import TokenFormatter
from ..stream.protocol import StreamingProtocol
from ..utils.logging import logger
from ..utils.memory import check_memory_requirements
from ..utils.profiling import annotate, maybe_start_trace_from_env
from ..version import MODEL_ID, VERSION
from .bucketing import (MAX_SINGLE_CHUNK_S, chunk_spans, first_core_len,
                        ramp_enabled)


class AudioTokenizationPipeline:
    """Orchestrates load → tokenize → meter → evaluate → serialize."""

    def __init__(self, sample_rate: int = 22050,
                 model_config: Optional[Dict[str, Any]] = None,
                 device="cuda", deterministic_seed: int = 42,
                 codebook_cache_dir: Optional[str] = None,
                 enable_codebook_cache: bool = True,
                 force_reinit_codebooks: bool = False,
                 codebook_init_method: str = "mert",
                 encodec_model: str = "facebook/encodec_24khz",
                 timebase: str = "compat",
                 compute_dtype: Optional[str] = None,
                 model_path: Optional[str] = None,
                 stochastic: bool = False,
                 temperature: float = 0.5,
                 enable_reconstruction: bool = True,
                 rle_mode: bool = False,
                 per_layer_encoding: Optional[Dict[str, str]] = None,
                 keyframe_interval_seconds: float = 5.0,
                 include_legend: bool = True,
                 model_id: str = MODEL_ID,
                 enable_compat_fallback: bool = False,
                 deterministic: bool = False,
                 resample_rate: Optional[int] = None,
                 max_length: Optional[int] = None) -> None:
        cfg = dict(model_config or {})
        self.sample_rate = sample_rate = resample_rate or sample_rate
        self.resample_rate = resample_rate
        self.max_length = max_length
        self.model_id = model_id
        self.device_spec = str(device)
        self.enable_reconstruction = enable_reconstruction
        self.include_legend = include_legend
        self.hop_length = hop_length = cfg.get("hop_length", 512)
        self.compat_mode = enable_compat_fallback
        num_quantizers = cfg.get("num_quantizers", 8)
        self._streaming_kwargs = dict(
            sample_rate=sample_rate, hop_length=hop_length, rle_mode=rle_mode,
            model_id=model_id, codebook_size=cfg.get("codebook_size", 4096),
            num_semantic_layers=num_quantizers // 2,
            num_acoustic_layers=num_quantizers // 2,
            per_layer_encoding=per_layer_encoding,
            keyframe_interval_seconds=keyframe_interval_seconds,
            compat_mode=self.compat_mode)
        self.streaming = StreamingProtocol(**self._streaming_kwargs)
        self.budget_meter = TokenBudgetMeter(sample_rate)
        self.evaluator = TokenizationEvaluator(sample_rate)
        self.formatter = TokenFormatter()
        maybe_start_trace_from_env()
        # Cross-session span executor (runtime/server.SpanBatcher): when
        # set, buffered and stdin streams dispatch spans through it, so
        # concurrent serving connections share batched forwards.
        self.span_executor = None
        if self.compat_mode:
            self.tokenizer = CompatTokenizer(
                sample_rate, num_semantic_layers=num_quantizers // 2,
                num_acoustic_layers=num_quantizers // 2,
                seed=deterministic_seed if deterministic else None)
            logger.warn("RUNNING IN COMPATIBILITY MODE - tokens are not from "
                        "trained quantizers")
            logger.info(f"Initialized nat-tpu-torch pipeline {VERSION} "
                        f"(model_id={model_id}, compat=True, "
                        f"rle={rle_mode})")
            return
        self.tokenizer = NeuralAudioTokenizer(
            sample_rate=sample_rate,
            semantic_dim=cfg.get("semantic_dim", 512),
            acoustic_dim=cfg.get("acoustic_dim", 512),
            codebook_size=cfg.get("codebook_size", 4096),
            num_quantizers=cfg.get("num_quantizers", 8),
            n_mels=cfg.get("n_mels", 128),
            hop_length=hop_length,
            enable_reconstruction=enable_reconstruction,
            codebook_init_method=codebook_init_method,
            encodec_model=encodec_model,
            codebook_cache_dir=codebook_cache_dir,
            enable_codebook_cache=enable_codebook_cache,
            force_reinit_codebooks=force_reinit_codebooks,
            seed=deterministic_seed,
            stochastic=stochastic,
            temperature=temperature,
            timebase=timebase,
            semantic_arch=cfg.get("semantic_arch", "auto"),
            compute_dtype=compute_dtype,
            semantic_arch_config=cfg.get("semantic_arch_config"),
            device=device,
        )
        self.tokenizer.ensure_initialized()
        if model_path:
            from .checkpoint import load_model

            load_model(model_path, self.tokenizer)
        logger.info(f"Initialized nat-tpu-torch pipeline {VERSION} "
                    f"(model_id={model_id}, device={self.tokenizer.device}, "
                    f"compute={self.tokenizer.compute_dtype}, "
                    f"rle={rle_mode}, "
                    f"reconstruction={enable_reconstruction})")

    def session(self) -> "AudioTokenizationPipeline":
        """A per-connection view for concurrent serving: shares the
        tokenizer (its ``_device_lock`` serializes dispatch) with fresh
        serialization, budget and metric state, so interleaved connections
        cannot corrupt each other's streams."""
        s = copy.copy(self)
        s.streaming = StreamingProtocol(**self._streaming_kwargs)
        s.budget_meter = TokenBudgetMeter(self.sample_rate)
        s.evaluator = TokenizationEvaluator(self.sample_rate)
        s.formatter = TokenFormatter()
        return s

    # ------------------------------------------------------------------
    def load_audio(self, file_path: str):
        """Decode and peak-normalize: ``(audio float32, sample_rate)``."""
        return self._load_audio_ex(file_path)[:2]

    def _load_audio_ex(self, file_path: str):
        """:meth:`load_audio` plus the int16 wire hint ``(i16, divisor)``
        or None: for a mono PCM16 source the decoder returns its integers
        and the normalization its divisor, so ``(i16 / 32768) / divisor``
        is the normalized float32 by construction and the tokenizer skips
        its recovery scan.  Resamples to ``resample_rate`` first (which
        drops the hint) and trims or zero-pads to ``max_length`` after the
        normalization (the hint with it), as the reference does."""
        if not Path(file_path).exists():
            raise FileNotFoundError(f"Audio file not found: {file_path}")
        audio, sr, pcm16 = audio_io.load_audio_file_ex(file_path)
        if self.resample_rate and sr != self.resample_rate:
            from ..dsp.resample import resample_poly

            audio = resample_poly(audio, sr, self.resample_rate)
            sr = self.resample_rate
            pcm16 = None    # resampled floats are no longer int16-derived
        # inplace: the decoder returned a fresh array; a copying divide
        # would hold twice the audio at once on long files.
        audio, divisor = audio_io.peak_normalize_ex(audio, inplace=True)
        if self.max_length:
            if len(audio) > self.max_length:
                audio = audio[:self.max_length]
                if pcm16 is not None:
                    pcm16 = pcm16[:self.max_length]
            elif len(audio) < self.max_length:
                pad = self.max_length - len(audio)
                audio = np.pad(audio, (0, pad))
                if pcm16 is not None:
                    # an int16 zero is exactly 0.0 after the gather
                    pcm16 = np.pad(pcm16, (0, pad))
        hint = ((pcm16, np.float32(divisor))
                if pcm16 is not None and divisor is not None else None)
        return audio, sr, hint

    def _seed_from(self, audio: np.ndarray, sr: int) -> None:
        """Let a feature-driven codebook method seed from ``audio`` (a
        no-op once seeded, and for the compat tokenizer)."""
        if not self.compat_mode:
            self.tokenizer.maybe_seed_from_audio(audio, sr)

    @staticmethod
    def _audio_sha256(audio: np.ndarray) -> str:
        return hashlib.sha256(memoryview(
            np.ascontiguousarray(audio, np.float32))).hexdigest()

    def _log_token_diversity(self, semantic_codes, acoustic_codes) -> None:
        """Near-constant token streams usually mean degenerate codebooks
        (not checked for the compat tokenizer's random tokens)."""
        if self.compat_mode:
            return
        for group, codes in (("semantic", semantic_codes),
                             ("acoustic", acoustic_codes)):
            flat = (np.concatenate([np.asarray(c).ravel() for c in codes])
                    if codes else np.array([], dtype=int))
            diversity = len(np.unique(flat)) / flat.size if flat.size else 0.0
            logger.debug(f"Token diversity - {group}: {diversity:.3f}")
            if flat.size > 50 and diversity < 0.1:
                logger.warn(f"Very low {group} token diversity "
                            f"({diversity:.3f}) - codebook seeding may have "
                            "collapsed")

    # ------------------------------------------------------------------
    def stream_audio(self, file_path: str,
                     write: Callable[[str], Any]) -> Dict[str, Any]:
        """Emit the NDJSON stream of one file through ``write(line)``:
        header, frames per span as the card finishes them, end."""
        if self.compat_mode:
            # The compat tokenizer is single-shot: the buffered stream.
            result = self.process_audio(file_path, ndjson_streaming=True)
            for line in result["ndjson_output"].splitlines():
                write(line)
            return result
        with annotate("nat/file"):
            logger.info(f"Processing (streaming): {file_path}")
            start_time = time.time()
            self.budget_meter.reset()
            with annotate("nat/load_audio"):
                audio, sr, pcm16_hint = self._load_audio_ex(file_path)
            duration = len(audio) / sr
            with annotate("nat/sha256"):
                audio_hash = self._audio_sha256(audio)
            self._begin_stream(write, file_path, audio, sr, duration,
                               audio_hash)
            sem_parts: List[np.ndarray] = []
            acc_parts: List[np.ndarray] = []
            encode_start = time.time()
            with annotate("nat/tokenize"):
                for out in self.tokenizer.iter_chunks(audio[None, :],
                                                      actual_sample_rate=sr,
                                                      want_features=False,
                                                      pcm16_hint=pcm16_hint):
                    self._emit_frames(write, out, sem_parts, acc_parts)
            encoding_time = time.time() - encode_start
            result = self._finalize_stream(write, audio, sr, sem_parts,
                                           acc_parts, encoding_time)
            result["metadata"] = self._metadata(file_path, sr, duration,
                                                audio_hash)
            logger.info("Streaming complete in "
                        f"{time.time() - start_time:.2f}s")
            return result

    def _begin_stream(self, write, label: str, audio: np.ndarray, sr: int,
                      duration: float, audio_hash) -> None:
        """``nat/begin``: the stream's header, then the codebooks' seeding
        from ``audio`` where a feature-driven method still waits for it."""
        with annotate("nat/begin"):
            self._emit_stream_header(write, label, sr, duration, audio_hash)
            self._seed_from(audio, sr)

    def _emit_stream_header(self, write, label: str, sr: int,
                            duration: float, audio_hash) -> None:
        """The header of a file or in-memory stream."""
        self.streaming.ndjson_streamer.audio_sha256 = audio_hash
        write(self.streaming.begin_stream(
            metadata=self._header_metadata(label, sr, duration, audio_hash),
            duration_seconds=duration, include_legend=self.include_legend))

    def _header_metadata(self, label: str, sr: int, duration: float,
                         audio_hash) -> Dict[str, Any]:
        """The ``metadata`` of a file's NDJSON header (key order is part of
        the wire format)."""
        return {"file_path": label, "sample_rate": sr,
                "processing_sample_rate": self.sample_rate,
                "duration": duration, "audio_sha256": audio_hash,
                "model_id": self.model_id, "compat_mode": self.compat_mode}

    def _emit_frames(self, write, out: Dict[str, Any], sem_parts: List,
                     acc_parts: List) -> None:
        """One span's frame lines, and its codes kept for the end stats."""
        with annotate("nat/serialize"):
            for line in self.streaming.feed_frames(
                    out["semantic_codes"][:, 0], out["acoustic_codes"][:, 0]):
                write(line)
        sem_parts.append(out["semantic_codes"])
        acc_parts.append(out["acoustic_codes"])

    def _metadata(self, label: str, sr: int, duration: float,
                  audio_hash) -> Dict[str, Any]:
        return {"file_path": label, "sample_rate": sr, "duration": duration,
                "audio_sha256": audio_hash, "model_id": self.model_id,
                "compat_mode": self.compat_mode}

    def _decode_reconstruction(self, reconstruct: bool, semantic_codes,
                               acoustic_codes):
        """Decode the whole token matrix (timed apart from the encode):
        ``(reconstruction [T·hop] or None, decoding_time)``."""
        if not reconstruct:
            return None, 0.0
        if self.compat_mode or self.tokenizer.decoder is None:
            logger.debug("Reconstruction requested but the tokenizer was "
                         "built without a decoder; skipping")
            return None, 0.0
        decode_start = time.time()
        with annotate("nat/decode"):
            recon = self.tokenizer.decode_tokens(semantic_codes,
                                                 acoustic_codes)
        return recon.reshape(-1), time.time() - decode_start

    def _finalize_stream(self, write, audio: np.ndarray, sr: int,
                         sem_parts, acc_parts, encoding_time: float,
                         num_samples: Optional[int] = None,
                         sha: Optional[str] = None,
                         reconstruct: Optional[bool] = None
                         ) -> Dict[str, Any]:
        """Concatenate the streamed spans' codes, decode (when
        ``reconstruct``, by default the pipeline's setting), meter and
        evaluate them, emit the ``end`` event and build the result dict:
        the tail of every streaming path.  ``num_samples`` counts the audio
        when ``audio`` holds only its end (``--stream-stdin`` trims as spans
        finish); ``sha`` is the raw bytes' digest for the ``end`` stats."""
        if num_samples is None:
            num_samples = len(audio)
        with annotate("nat/finish"):
            sem_codes = np.concatenate(sem_parts, axis=-1)
            acc_codes = np.concatenate(acc_parts, axis=-1)
            result = {
                "semantic_codes": [sem_codes[i]
                                   for i in range(sem_codes.shape[0])],
                "acoustic_codes": [acc_codes[i]
                                   for i in range(acc_codes.shape[0])],
            }
            num_frames = int(sem_codes.shape[-1])
            self.budget_meter.sample_rate = sr
            self.budget_meter.update(num_samples, num_frames,
                                     int(sem_codes.size), int(acc_codes.size))
            self._log_token_diversity(result["semantic_codes"],
                                      result["acoustic_codes"])
        if reconstruct is None:
            reconstruct = self.enable_reconstruction
        reconstructed, decoding_time = self._decode_reconstruction(
            reconstruct, result["semantic_codes"], result["acoustic_codes"])
        self.evaluator.sample_rate = sr
        with annotate("nat/evaluate"):
            metrics = self.evaluator.evaluate_tokenization(
                audio, self.tokenizer, reconstructed,
                precomputed_result=result, encoding_time=encoding_time,
                decoding_time=decoding_time, num_samples=num_samples)
        with annotate("nat/finish"):
            budget = self.budget_meter.get_metrics()
            stats = {**asdict(metrics), **asdict(budget)}
            if sha:
                stats["audio_sha256"] = sha
            for line in self.streaming.end_stream(stats):
                write(line)
        return {
            **result,
            "metrics": metrics,
            "budget_metrics": budget,
            "encoding_time": encoding_time,
            "num_frames": num_frames,
            "spans": len(sem_parts),
        }

    # ------------------------------------------------------------------
    def stream_audio_array(self, audio: np.ndarray, sr: int, write,
                           label: str = "<payload>", pcm16_hint=None,
                           normalize: bool = True) -> Dict[str, Any]:
        """Stream NDJSON for audio already in memory (serving's buffered
        fallback).  Every span goes through ``span_executor`` when one is
        set, so buffered connections batch with streaming ones; else the
        tokenizer's span loop.  ``normalize=False`` is for audio that came
        out of :meth:`load_audio`, which already peak-normalized it;
        ``pcm16_hint`` is :meth:`_load_audio_ex`'s."""
        if self.compat_mode:
            raise ValueError("stream_audio_array requires the neural "
                             "tokenizer")
        with annotate("nat/file"):
            tok = self.tokenizer
            tok.ensure_initialized()
            start_time = time.time()
            self.budget_meter.reset()
            audio = np.asarray(audio, dtype=np.float32).reshape(-1)
            if normalize:
                audio = audio_io.peak_normalize(audio)
            duration = len(audio) / sr
            with annotate("nat/sha256"):
                audio_hash = self._audio_sha256(audio)
            self._begin_stream(write, label, audio, sr, duration, audio_hash)
            total = len(audio)
            overlap = int(sr)
            spans = chunk_spans(total, sr, overlap=overlap)
            if len(spans) == 1:
                overlap = 0
            sem_parts: List[np.ndarray] = []
            acc_parts: List[np.ndarray] = []
            wave = audio[None, :]
            encode_start = time.time()
            with annotate("nat/tokenize"):
                self._tokenize_spans(write, wave, sr, spans, overlap,
                                     pcm16_hint, sem_parts, acc_parts)
            encoding_time = time.time() - encode_start
            result = self._finalize_stream(write, audio, sr, sem_parts,
                                           acc_parts, encoding_time)
            result["metadata"] = self._metadata(label, sr, duration,
                                                audio_hash)
            logger.info(f"Buffered-stream complete in "
                        f"{time.time() - start_time:.2f}s ({duration:.1f}s "
                        f"audio, {result['num_frames']} frames)")
            return result

    def _tokenize_spans(self, write, wave, sr, spans, overlap, pcm16_hint,
                        sem_parts, acc_parts) -> None:
        """:meth:`stream_audio_array`'s spans, through ``span_executor``
        or the tokenizer's span loop, their frames written in order."""
        tok = self.tokenizer
        total = wave.shape[-1]
        if self.span_executor is not None and not tok.stochastic:
            # Submit every span at once: the batcher coalesces them with
            # other connections' spans; results come back in span order.
            wire = tok._pcm16_wire(wave, hint=pcm16_hint)
            src, div = wire if wire is not None else (wave, None)
            futs = []
            for s, length in spans:
                ext_start = max(0, s - overlap)
                ext_end = min(total, s + length + overlap)
                futs.append(self.span_executor.submit_span(
                    src[:, ext_start:ext_end], ext_start, s, length,
                    overlap, sr, want_features=False, pcm_divisor=div))
            for fut in futs:
                self._emit_frames(write, fut.result(), sem_parts, acc_parts)
        else:
            for out in tok.iter_chunks(wave, actual_sample_rate=sr,
                                       want_features=False,
                                       pcm16_hint=pcm16_hint):
                self._emit_frames(write, out, sem_parts, acc_parts)

    # ------------------------------------------------------------------
    def stream_stdin(self, stream, write) -> Dict[str, Any]:
        """Tokenize an audio byte stream as it arrives (``--stream-stdin``):
        frames are emitted while later audio is still being piped in.
        WAV/AIFF/AU payloads decode block by block, FLAC frame by frame
        (:mod:`nat_tpu_torch.io.stream_reader`).

        ASCII-FS (0x1C) delimited multi-file pipes give one complete NDJSON
        stream per file.  Spans are those of the buffered path
        (``chunk_spans``), so tokens match the buffered path on the same raw
        samples; but no peak normalization (the peak is unknown until EOF),
        and the header carries ``audio_sha256: null`` while
        ``end.stats.audio_sha256`` carries the raw bytes' digest.

        Returns the last file's result; every file's is under
        ``"all_results"``."""
        from ..io.stream_reader import eager_events, iter_fs_streams

        if self.compat_mode:
            raise ValueError("--stream-stdin requires the neural tokenizer "
                             "(compat mode reads buffered stdin)")
        self.tokenizer.ensure_initialized()
        # A reader thread decodes ahead of the card; samples that arrived
        # while a span computed come merged, so already-buffered spans
        # dispatch as one group.
        gen = eager_events(iter_fs_streams(stream))
        results: List[Dict[str, Any]] = []
        for kind, payload in gen:
            if kind != "file":
                raise ValueError(f"unexpected stream event {kind!r}")
            results.append(self._stream_one_file(gen, write, int(payload)))
        if not results:
            raise ValueError("empty stream: no audio before EOF")
        return {**results[-1], "all_results": results}

    def _stream_one_file(self, gen, write, index: int) -> Dict[str, Any]:
        """Consume one file's rate/samples/sha256 events from ``gen`` and
        emit its complete NDJSON stream through ``write``."""
        tok = self.tokenizer
        start_time = time.time()
        self.budget_meter.reset()
        kind, sr = next(gen)
        if kind != "rate":
            raise ValueError(f"stream event {kind!r} before the sample rate")
        max_len = int(MAX_SINGLE_CHUNK_S * sr)
        overlap = int(sr)
        core_len = max(max_len - 2 * overlap, max_len // 2)
        # The ramp's first span, as chunk_spans plans it, so the live
        # stream's spans are the buffered path's.
        ramp0 = first_core_len(sr, overlap) if ramp_enabled() else 0
        if not 0 < ramp0 < core_len:
            ramp0 = 0

        def span_len_at(start: int) -> int:
            """Span length at ``start``, whatever arrives later."""
            return ramp0 if (ramp0 and start == 0) else core_len

        self.streaming.ndjson_streamer.audio_sha256 = None
        write(self.streaming.begin_stream(
            metadata={
                "file_path": "<stdin>" if index == 0 else f"<stdin#{index}>",
                "sample_rate": sr,
                "processing_sample_rate": self.sample_rate,
                "audio_sha256": None,
                "model_id": self.model_id,
                "compat_mode": self.compat_mode,
                "streaming_input": True,
            },
            duration_seconds=None, include_legend=self.include_legend))

        buf = np.zeros(0, np.float32)
        base = 0          # absolute sample index of buf[0]
        total = 0
        next_start = 0    # absolute sample index of the next unemitted span
        sha: Optional[str] = None
        sem_parts: List[np.ndarray] = []
        acc_parts: List[np.ndarray] = []
        encode_start = time.time()
        # Spans are emitted as soon as their window has arrived (arrival is
        # the bottleneck on a live pipe, and a lookahead would hold span k
        # back until span k+1 arrived).  Spans that are already buffered
        # together dispatch as one padded group: none could have been
        # emitted earlier anyway.
        group_size = 1 if tok.stochastic else tok._stream_group_size()
        executor = self.span_executor

        def emit(out: Dict[str, Any]) -> None:
            self._emit_frames(write, out, sem_parts, acc_parts)

        def window(start: int, length: int, ov: int):
            ext_start = max(0, start - ov)
            ext_end = min(total, start + length + ov)
            return buf[None, ext_start - base: ext_end - base], ext_start

        def on_wire(seg: np.ndarray):
            """``(segment to send, divisor)``: int16 when the segment is
            PCM16 (stdin audio is not peak-normalized, so a PCM16 payload
            has divisor 1.0), else the float32 segment and None."""
            wire = tok._pcm16_wire(seg)
            return wire if wire is not None else (seg, None)

        def process_span(start: int, length: int, ov: int) -> None:
            seg, ext_start = window(start, length, ov)
            tok.maybe_seed_from_audio(seg[0], sr)
            run = executor.tokenize_span if executor is not None \
                else tok.tokenize_span
            src, div = on_wire(seg)
            emit(run(src, ext_start, start, length, ov, sr,
                     want_features=False, pcm_divisor=div))

        def process_spans(spans, ov: int) -> None:
            if len(spans) > 1:
                # Seed from the first span's extended window, as a single
                # span would (not the whole buffer).
                tok.maybe_seed_from_audio(window(*spans[0], ov)[0][0], sr)
            if executor is not None and len(spans) > 1:
                # Serving: submit every span to the shared batcher at once
                # (it coalesces them with other sessions' spans), then
                # emit in order.
                futs = []
                for s, length in spans:
                    seg, ext_start = window(s, length, ov)
                    src, div = on_wire(seg)
                    futs.append(executor.submit_span(
                        src, ext_start, s, length, ov, sr,
                        want_features=False, pcm_divisor=div))
                for fut in futs:
                    emit(fut.result())
                return
            if group_size <= 1 or len(spans) < 2:
                for s, length in spans:
                    process_span(s, length, ov)
                return
            # Coordinates shift to the buffer window; the keep masks are
            # shift-invariant.
            shifted = [(s - base, length) for s, length in spans]
            plan = tok._plan_span_groups(shifted, ov, sr, total - base,
                                         group_size, first_single=False)
            src, div = on_wire(buf[None, :])
            for item in plan:
                if len(item) == 1:
                    s, length = item[0]
                    process_span(s + base, length, ov)
                    continue
                out, metas = tok.dispatch_span_group(
                    src, item, ov, sr, total - base, group_size,
                    pcm_divisor=div)
                for res in tok.finalize_span_group(out, metas,
                                                   want_features=False):
                    emit(res)

        for kind, payload in gen:
            if kind == "sha256":
                sha = payload
                break  # ends this file's events
            buf = np.concatenate([buf, payload])
            total += int(payload.size)
            # Interior span k is ready once its extended window has arrived
            # and the stream is known to be multi-span (total > max_len),
            # exactly when the buffered path would split too.
            if total > max_len:
                ready = []
                while next_start + span_len_at(next_start) + overlap <= total:
                    length = span_len_at(next_start)
                    ready.append((next_start, length))
                    next_start += length
                if ready:
                    process_spans(ready, overlap)
                    keep_from = next_start - overlap
                    if keep_from > base:
                        buf = buf[keep_from - base:]
                        base = keep_from

        if next_start == 0 and total <= max_len:
            process_span(0, total, 0)  # one span, no overlap (as buffered)
        else:
            tail = []
            start = next_start
            while start < total:
                length = min(span_len_at(start), total - start)
                tail.append((start, length))
                start += length
            process_spans(tail, overlap)
        encoding_time = time.time() - encode_start
        # ``buf`` holds only the last span's window by EOF: the sample
        # count is passed explicitly, and there is no whole signal to hold
        # a reconstruction against (the reference evaluates stdin streams
        # without one too).
        result = self._finalize_stream(write, buf, sr, sem_parts, acc_parts,
                                       encoding_time, num_samples=total,
                                       sha=sha, reconstruct=False)
        logger.info(
            f"Streaming-stdin complete in {time.time() - start_time:.2f}s "
            f"({total / sr:.1f}s audio, {result['num_frames']} frames)")
        return result

    # ------------------------------------------------------------------
    # Buffered outputs
    # ------------------------------------------------------------------
    def process_audio(
        self,
        file_path: str,
        output_format: str = "hierarchical",
        streaming_mode: bool = False,
        ndjson_streaming: bool = False,
        _preloaded: Optional[tuple] = None,
        _pretokenized: Optional[tuple] = None,
        want_features: bool = True,
    ) -> Dict[str, Any]:
        """Tokenize one file whole and build every buffered output: text
        tokens in ``output_format``, the JSON dump, the ``--streaming``
        text (``streaming_mode``), the NDJSON stream
        (``ndjson_streaming``), the reconstruction (DC removed, tanh
        limited) and the metrics.  ``want_features=False`` leaves the
        feature maps and the per-span reconstruction, which only the
        visualizations read, on the device.  ``_preloaded`` (audio, sr)
        and ``_pretokenized`` (result, encoding_time) inject the work of
        :meth:`_tokenize_many`."""
        with annotate("nat/file"):
            logger.info(f"Processing: {file_path}")
            start_time = time.time()
            self.budget_meter.reset()
            pcm16_hint = None
            if _preloaded is not None:
                audio, sr = _preloaded
            else:
                with annotate("nat/load_audio"):
                    audio, sr, pcm16_hint = self._load_audio_ex(file_path)
            duration = len(audio) / sr
            logger.info(f"Loaded audio: {len(audio)} samples, {sr} Hz, "
                        f"{duration:.2f}s")
            if not check_memory_requirements(len(audio), sr):
                logger.warn("May not have sufficient memory for processing "
                            "this file")
            with annotate("nat/sha256"):
                audio_hash = self._audio_sha256(audio)
            self.streaming.ndjson_streamer.audio_sha256 = audio_hash

            if _pretokenized is not None:
                result, encoding_time = _pretokenized
            else:
                self._seed_from(audio, sr)
                encode_start = time.time()
                with annotate("nat/tokenize"):
                    result = self._tokenize(audio, sr, want_features,
                                            pcm16_hint)
                encoding_time = time.time() - encode_start
            semantic_codes = result["semantic_codes"]
            acoustic_codes = result["acoustic_codes"]
            num_frames = int(result.get("num_frames", 0))

            recon, decoding_time = self._decode_reconstruction(
                self.enable_reconstruction, semantic_codes, acoustic_codes)
            num_sem = sum(int(np.asarray(c).size) for c in semantic_codes)
            num_acc = sum(int(np.asarray(c).size) for c in acoustic_codes)
            self.budget_meter.sample_rate = sr
            self.budget_meter.update(len(audio), num_frames, num_sem, num_acc)
            logger.info(f"Total tokens: {num_sem + num_acc}")
            self._log_token_diversity(semantic_codes, acoustic_codes)

            logger.progress("Evaluating tokenization quality...")
            self.evaluator.sample_rate = sr
            with annotate("nat/evaluate"):
                metrics = self.evaluator.evaluate_tokenization(
                    audio, self.tokenizer, recon, precomputed_result=result,
                    encoding_time=encoding_time, decoding_time=decoding_time)
            text_tokens = self.formatter.to_text_sequence(
                semantic_codes, acoustic_codes, output_format)
            budget_metrics = self.budget_meter.get_metrics()
            json_tokens = self.formatter.to_json(
                semantic_codes, acoustic_codes, metadata={
                    "file_path": file_path,
                    "sample_rate": sr,
                    "processing_sample_rate": self.sample_rate,
                    "duration": duration,
                    "processing_time": time.time() - start_time,
                    "budget_metrics": asdict(budget_metrics),
                    "audio_sha256": audio_hash,
                    "model_id": self.model_id,
                    "frames_per_second":
                        budget_metrics.audio_frames_per_second,
                    "hop_ms": (self.hop_length / sr) * 1000.0,
                    "num_frames": num_frames,
                    "compat_mode": self.compat_mode,
                })
            stats = {**asdict(metrics), **asdict(budget_metrics)}
            streaming_output = None
            if streaming_mode:
                header = self.streaming.create_stream_header(sr, len(audio))
                chunk = self.streaming.create_chunk_marker(0, len(audio),
                                                           result)
                footer = self.streaming.create_stream_footer(stats)
                streaming_output = f"{header}\n{chunk}\n{footer}"
            ndjson_output = None
            if ndjson_streaming:
                ndjson_output = self.streaming.create_ndjson_stream(
                    result, metadata=self._header_metadata(
                        file_path, sr, duration, audio_hash),
                    processing_stats=stats, duration_seconds=duration,
                    include_legend=self.include_legend)
            total_time = time.time() - start_time
            logger.info(f"Processing complete in {total_time:.2f}s")

            # The reference's post-processing: DC removal, tanh soft limit.
            reconstructed_audio = None
            if recon is not None:
                reconstructed_audio = np.tanh(
                    (recon - np.mean(recon)) * 0.95) * 0.95
            return {
                "semantic_codes": semantic_codes,
                "acoustic_codes": acoustic_codes,
                "text_tokens": text_tokens,
                "json_tokens": json_tokens,
                "streaming_output": streaming_output,
                "ndjson_output": ndjson_output,
                "reconstructed_audio": reconstructed_audio,
                "metrics": metrics,
                "budget_metrics": budget_metrics,
                "processing_time": total_time,
                "original_audio": audio,
                "tokenizer_result": result,
                "metadata": {**self._metadata(file_path, sr, duration,
                                              audio_hash),
                             "processing_sample_rate": self.sample_rate,
                             "device": self.device_spec},
            }

    def _tokenize(self, audio: np.ndarray, sr: int, want_features: bool,
                  pcm16_hint=None):
        """The whole-file tokenizer call (the compat tokenizer has no
        features or decoder to skip, and no upload)."""
        if self.compat_mode:
            return self.tokenizer(audio[None, :], actual_sample_rate=sr)
        return self.tokenizer(audio[None, :], actual_sample_rate=sr,
                              want_features=want_features,
                              reconstruct=want_features,
                              pcm16_hint=pcm16_hint)

    def _tokenize_many(self, input_paths: List[str],
                       want_features: bool = True) -> List[Any]:
        """Load every file, seed a feature-driven codebook method from the
        first one that loaded, then tokenize: per path ``(audio, sr,
        result, encoding_time)``, or the exception that file raised.  Two
        or more files that loaded go through one
        :class:`~nat_tpu_torch.parallel.runner.DataParallelRunner` over the
        local devices (their spans share batched forwards; the encoding
        time is the batch's wall over its files), as the reference's
        ``_tokenize_many`` does; compat and stochastic mode, and a batch
        that fails (with a warning), run file by file."""
        loaded: List[Any] = []
        for path in input_paths:
            try:
                loaded.append(self.load_audio(path))
            except Exception as exc:
                loaded.append(exc)
        eligible = [i for i, item in enumerate(loaded)
                    if not isinstance(item, Exception)]
        if eligible:
            self._seed_from(*loaded[eligible[0]])
        results: List[Any] = list(loaded)
        if (len(eligible) > 1 and not self.compat_mode
                and not self.tokenizer.stochastic):
            from ..parallel.runner import DataParallelRunner

            runner = DataParallelRunner(self.tokenizer)
            logger.info(f"Data-parallel batch: {len(eligible)} file(s) over "
                        f"{runner.dp} device(s)")
            start = time.time()
            try:
                with annotate("nat/tokenize"):
                    batch = runner.tokenize_many(
                        [loaded[i][0] for i in eligible],
                        [loaded[i][1] for i in eligible],
                        want_features=want_features)
                per_file = (time.time() - start) / len(eligible)
                for i, result in zip(eligible, batch):
                    results[i] = (*loaded[i], result, per_file)
                eligible = []
            except Exception as exc:
                logger.warn(f"Data-parallel batch failed "
                            f"({type(exc).__name__}: {exc}); falling back "
                            "to sequential")
        for i in eligible:
            audio, sr = loaded[i]
            try:
                encode_start = time.time()
                with annotate("nat/tokenize"):
                    result = self._tokenize(audio, sr, want_features)
                results[i] = (audio, sr, result, time.time() - encode_start)
            except Exception as exc:
                results[i] = exc
        return results

    def batch_process(self, input_paths: List[str], output_dir: str,
                      output_format: str = "hierarchical",
                      sequential_vis: bool = False) -> List[Dict]:
        """Process many files and write every artifact of each into
        ``output_dir``; a file that fails gives ``{"file_path", "error"}``
        and the others go on."""
        import json

        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        results: List[Dict] = []
        for path, prep in zip(input_paths, self._tokenize_many(input_paths)):
            try:
                if isinstance(prep, Exception):
                    raise prep
                audio, sr, tok_result, encoding_time = prep
                result = self.process_audio(
                    path, output_format=output_format, ndjson_streaming=True,
                    _preloaded=(audio, sr),
                    _pretokenized=(tok_result, encoding_time))
                base = Path(path).stem
                (out / f"{base}_tokens.txt").write_text(result["text_tokens"])
                (out / f"{base}_tokens.json").write_text(result["json_tokens"])
                (out / f"{base}_tokens.ndjson").write_text(
                    result["ndjson_output"])
                if result["reconstructed_audio"] is not None:
                    audio_io.write_wav(str(out / f"{base}_reconstructed.wav"),
                                       result["reconstructed_audio"], sr)
                (out / f"{base}_metrics.json").write_text(json.dumps(
                    {**asdict(result["metrics"]),
                     **asdict(result["budget_metrics"])}, indent=2))
                try:
                    from ..eval.visualize import generate_visualizations

                    generate_visualizations(
                        result["original_audio"], result["tokenizer_result"],
                        str(out), base, sample_rate=sr,
                        sequential=sequential_vis)
                except Exception as exc:
                    logger.warn(f"Visualization failed for {path}: {exc}")
                results.append(result)
            except Exception as exc:
                logger.error(f"Failed to process {path}: {exc}")
                results.append({"file_path": path, "error": str(exc)})
        return results
