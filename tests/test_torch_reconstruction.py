"""Reconstruction in the port against the JAX package, on the CPU in
float32: ``decode_tokens``, the host metric suite (``audio_metrics`` and
``librosa_compat``), the evaluator's eight reconstruction fields, the
``end`` event of a stream with reconstruction on, the buffered
``process_audio`` outputs, and checkpoints without a decoder; then what
one evaluation computes and where.

Sizes are tiny (spectral semantic encoder, dims 32, codebook 64, 16 mels).
Tolerances are stated where they are used: the metric modules are torch
ports of numpy code, run on the same arrays (1e-6 relative); the decoder
sums float32 products in another order than XLA (1e-5 absolute on values
in [-1, 1]), and the metrics computed from the two decodes are held to
1e-4 relative.
"""

import json
from dataclasses import asdict

import numpy as np
import pytest
import torch

import jax

from nat_tpu.eval import audio_metrics as jax_am
from nat_tpu.eval import librosa_compat as jax_lc
from nat_tpu.eval import metrics as jax_metrics
from nat_tpu.runtime.pipeline import \
    AudioTokenizationPipeline as JaxPipeline
from nat_tpu_torch import bridge
from nat_tpu_torch.eval import audio_metrics as am
from nat_tpu_torch.eval import librosa_compat as lc
from nat_tpu_torch.eval import metrics
from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer
from nat_tpu_torch.runtime import checkpoint
from nat_tpu_torch.runtime.pipeline import AudioTokenizationPipeline

SR = 22050
CONFIG = dict(semantic_dim=32, acoustic_dim=32, codebook_size=64, n_mels=16,
              semantic_arch="spectral")
RECON = ("mse_loss", "spectral_loss", "perceptual_loss", "mr_stft_loss",
         "log_spectral_distance", "pitch_accuracy", "rhythm_accuracy",
         "timbral_similarity")
TIMING = {"encoding_time", "decoding_time", "memory_usage",
          "tokens_per_second", "processing_time",
          "processing_frames_per_second", "processing_tokens_per_second"}


def _signal(seed: int, seconds: float = 1.0) -> np.ndarray:
    """A gliding tone with noise and four bursts (pitch and onsets that the
    music metrics can follow)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    f = 220.0 + 180.0 * t
    x = 0.4 * np.sin(2 * np.pi * np.cumsum(f) / SR)
    x += 0.02 * rng.standard_normal(t.size)
    for k in range(4):
        at = int((0.1 + 0.22 * k) * SR)
        x[at:at + 400] += 0.6 * rng.standard_normal(400)
    return x.astype(np.float32)


def _pairs():
    a, b = _signal(0), _signal(1)
    return a, (0.8 * a + 0.2 * b).astype(np.float32)


def _close(ours, ref, rel=1e-6):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=rel, atol=0)


# -- the metric modules ------------------------------------------------------
PAIR_METRICS = ["spectral_mse", "mr_stft_loss", "log_spectral_distance"]
SR_PAIR_METRICS = ["spectral_l1", "perceptual_loss", "pitch_accuracy",
                   "rhythm_accuracy", "timbral_similarity"]
SR_SIGNAL = ["dominant_pitch_track", "onset_strength", "detect_onsets",
             "mfcc", "_mel_spec", "spectral_centroid", "spectral_rolloff"]


@pytest.mark.parametrize("name", PAIR_METRICS + SR_PAIR_METRICS + SR_SIGNAL
                         + ["stft_mag", "zero_crossing_rate"])
def test_audio_metrics_match_jax(name):
    """Each function of ``audio_metrics`` on the same arrays: 1e-6
    relative."""
    a, b = _pairs()
    if name in PAIR_METRICS:
        args = (a, b)
    elif name in SR_PAIR_METRICS:
        args = (a, b, SR)
    elif name in SR_SIGNAL:
        args = (a, SR)
    elif name == "stft_mag":
        args = (a, 1024, 256)
    else:
        args = (a,)
    ours = getattr(am, name)(*args)
    ref = getattr(jax_am, name)(*args)
    _close(ours, ref)
    if name.endswith(("accuracy", "similarity")):
        assert ours != 0.0        # the signals are not degenerate


@pytest.mark.parametrize("name,args", [
    ("stft", lambda x: (x, 512, 128)),
    ("stft_mag", lambda x: (x, 2048, 512)),
    ("fft_frequencies", lambda x: (SR, 2048)),
    ("mel_fb", lambda x: (SR, 2048, 40)),
    ("melspectrogram", lambda x: (x, SR)),
    ("power_to_db", lambda x: (np.abs(x[:4096]) ** 2,)),
    ("mfcc", lambda x: (x, SR)),
    ("piptrack", lambda x: (x, SR)),
    ("onset_strength", lambda x: (x, SR)),
    ("onset_detect", lambda x: (x, SR)),
])
def test_librosa_compat_matches_jax(name, args):
    """Each ``librosa_compat`` function on the same array (the port's copy
    runs over its own mel scale): 1e-6 relative."""
    x = _signal(2).astype(np.float64)
    ours = getattr(lc, name)(*args(x))
    ref = getattr(jax_lc, name)(*args(x))
    if isinstance(ref, tuple):
        for o, r in zip(ours, ref):
            _close(o, r)
    else:
        _close(ours, ref)


def test_peak_pick_matches_jax():
    env = lc.onset_strength(_signal(3).astype(np.float64), SR)
    args = (env, 3, 3, 3, 5, 0.07, 10)
    np.testing.assert_array_equal(lc.peak_pick(*args),
                                  jax_lc.peak_pick(*args))


def test_evaluator_reconstruction_fields_match_jax():
    """The eight reconstruction fields of the same audio, reconstruction
    and codes: 1e-6 relative (DC removed before the aligned losses, the
    music metrics on the raw signals)."""
    a, b = _pairs()
    recon = (b[:-300] + 0.05).astype(np.float32)     # shorter, with DC
    rng = np.random.default_rng(4)
    result = {k: [rng.integers(0, 64, (1, 40)) for _ in range(4)]
              for k in ("semantic_codes", "acoustic_codes")}
    ours = asdict(metrics.TokenizationEvaluator(SR).evaluate_tokenization(
        a, reconstructed=recon, precomputed_result=result,
        decoding_time=0.25))
    ref = asdict(jax_metrics.TokenizationEvaluator(SR).evaluate_tokenization(
        a, reconstructed=recon, precomputed_result=result,
        decoding_time=0.25))
    assert list(ours) == list(ref)
    for key in RECON:
        assert ours[key] == pytest.approx(ref[key], rel=1e-6, abs=0), key
        assert ours[key] != 0.0, key
    assert ours["decoding_time"] == 0.25


def test_evaluation_computes_each_spectrogram_once(monkeypatch):
    """One evaluation of a 2 s pair (the reconstruction shorter and with
    DC) asks for 18 spectrograms and computes 7, one FFT block each: the
    original, the DC-removed and the raw reconstruction at 2048/512, and
    the first two at 512/128 and 1024/256.  Signals a region needs
    together share an FFT call ``[signals, frames, n_fft]``."""
    a = _signal(5, seconds=2.0)
    recon = (0.8 * a + 0.2 * _signal(6, seconds=2.0))[:-300] + 0.05
    blocks = []
    rfft = torch.fft.rfft
    monkeypatch.setattr(torch.fft, "rfft", lambda x, **kw: blocks.extend(
        [x.shape[-1]] * x.shape[0]) or rfft(x, **kw))
    out = metrics.TokenizationEvaluator(SR)._reconstruction_metrics(
        a, recon.astype(np.float32))
    assert sorted(blocks) == [512, 512, 1024, 1024, 2048, 2048, 2048]
    assert len(out) == len(RECON) and all(out[k] != 0.0 for k in RECON)


def test_evaluator_runs_on_the_tokenizers_device():
    """The CPU without a tokenizer, for a CPU tokenizer, and for one with
    no device (compat mode); the upload region opens only on a card."""
    from nat_tpu_torch.models.compat import CompatTokenizer
    from nat_tpu_torch.utils import profiling

    cpu = torch.device("cpu")
    device_of = metrics.TokenizationEvaluator.device_of
    assert device_of(None) == cpu
    assert device_of(CompatTokenizer(sample_rate=SR)) == cpu
    tok = NeuralAudioTokenizer(**CONFIG, seed=1, enable_codebook_cache=False,
                               device="cpu")
    assert device_of(tok) == cpu
    a, b = _pairs()
    profiling.reset_timings()
    metrics.TokenizationEvaluator(SR).evaluate_tokenization(
        a, tok, reconstructed=b)
    assert {"nat/eval/spectral", "nat/eval/pitch", "nat/eval/rhythm",
            "nat/eval/timbral"} <= set(profiling.stage_timings)
    assert "nat/eval/upload" not in profiling.stage_timings


# -- the decoder ---------------------------------------------------------------
@pytest.fixture(scope="module")
def pipelines():
    """A JAX pipeline with reconstruction and the port's default one,
    holding the same weights and codebooks."""
    jax_pipe = JaxPipeline(model_config=CONFIG, codebook_init_method="random",
                           enable_codebook_cache=False,
                           compute_dtype="float32")
    jtok = jax_pipe.tokenizer
    pipe = AudioTokenizationPipeline(model_config=CONFIG, device="cpu",
                                     enable_codebook_cache=False)
    assert pipe.enable_reconstruction and pipe.tokenizer.decoder is not None
    bridge.load_into_tokenizer(pipe.tokenizer,
                               jax.tree.map(np.asarray, jtok.params),
                               np.asarray(jtok.sem_rvq.codebook),
                               np.asarray(jtok.acc_rvq.codebook))
    return jax_pipe, pipe


@pytest.mark.parametrize("frames", [1, 7, 130])
def test_decode_tokens_matches_jax(pipelines, frames):
    """Seeded codes through both ``decode_tokens``: the waveform of
    ``frames × hop`` samples within 1e-5."""
    jax_pipe, pipe = pipelines
    rng = np.random.default_rng(frames)
    sem = [rng.integers(0, 64, (1, frames)).astype(np.int16)
           for _ in range(4)]
    acc = [rng.integers(0, 64, (1, frames)).astype(np.int16)
           for _ in range(4)]
    ours = pipe.tokenizer.decode_tokens(sem, acc)
    ref = np.asarray(jax_pipe.tokenizer.decode_tokens(sem, acc))
    assert ours.shape == ref.shape == (1, frames * 512)
    assert ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)


def _end(lines):
    end = json.loads(lines[-1])
    assert end["event"] == "end"
    return end["stats"]


def test_stream_end_line_with_reconstruction_matches_jax(pipelines,
                                                         simple_wav):
    """The port's ``end`` line for a file with reconstruction on against
    JAX's ``_finalize_stream`` fed the same codes (so JAX decodes them with
    its own decoder): every field but the timings, the reconstruction
    fields within 1e-4 relative and not zero."""
    jax_pipe, pipe = pipelines
    lines = []
    result = pipe.stream_audio(str(simple_wav), lines.append)
    ours = _end(lines)
    audio, sr = pipe.load_audio(str(simple_wav))
    sem = np.stack(result["semantic_codes"])      # [N, 1, T]
    acc = np.stack(result["acoustic_codes"])
    ref_lines = []
    jax_pipe._finalize_stream(ref_lines.append, audio, sr, str(simple_wav),
                              len(audio) / sr, "sha", [sem], [acc], [], 0.1)
    ref = _end(ref_lines)
    assert list(ours) == list(ref)
    for key, value in ref.items():
        if key in TIMING:
            continue
        if key in RECON:
            assert ours[key] == pytest.approx(value, rel=1e-4), key
        elif isinstance(value, float):
            assert ours[key] == pytest.approx(value, rel=1e-12, abs=0), key
        else:
            assert ours[key] == value, key
    assert ours["mse_loss"] > 0 and ours["decoding_time"] > 0


def test_streams_run_the_decoder_once(pipelines, simple_wav, monkeypatch):
    """A stream decodes its whole token matrix once, in ``decode_tokens``:
    its span forwards skip the decoder.  A stdin stream holds no whole
    signal and, as in the reference, reconstructs nothing."""
    import io

    _, pipe = pipelines
    calls = []
    dec = pipe.tokenizer.decoder
    orig = dec.forward
    monkeypatch.setattr(dec, "forward",
                        lambda q, n: calls.append(q.shape) or orig(q, n))
    lines = []
    result = pipe.stream_audio(str(simple_wav), lines.append)
    assert calls == [(1, result["num_frames"], 64)]
    calls.clear()
    stdin_lines = []
    pipe.session().stream_stdin(io.BytesIO(simple_wav.read_bytes()),
                                stdin_lines.append)
    assert calls == []
    stats = _end(stdin_lines)
    assert all(stats[k] == 0.0 for k in RECON) and stats["decoding_time"] == 0


def test_process_audio_matches_jax(pipelines, simple_wav):
    """``process_audio`` of one file in both packages (their codes agree at
    this size): text tokens, the NDJSON stream but its ``end`` line, and
    the DC-removed, tanh-limited reconstruction within 1e-5."""
    jax_pipe, pipe = pipelines
    ours = pipe.process_audio(str(simple_wav), ndjson_streaming=True,
                              want_features=False)
    ref = jax_pipe.process_audio(str(simple_wav), ndjson_streaming=True,
                                 want_features=False)
    assert ours["text_tokens"] == ref["text_tokens"]
    assert (ours["ndjson_output"].splitlines()[:-1]
            == ref["ndjson_output"].splitlines()[:-1])
    np.testing.assert_allclose(ours["reconstructed_audio"],
                               np.asarray(ref["reconstructed_audio"]),
                               atol=1e-5, rtol=0)
    for key in RECON:
        assert getattr(ours["metrics"], key) == pytest.approx(
            getattr(ref["metrics"], key), rel=1e-4), key


# -- checkpoints -----------------------------------------------------------------
def test_checkpoint_without_decoder_loads_with_reconstruction(simple_wav,
                                                              tmp_path):
    """A checkpoint of a tokenizer without a decoder, loaded into the
    default pipeline: the encoders and codebooks come from the file (the
    frames are those of a pipeline without reconstruction that loads it),
    the decoder stays the seed's, and the ``end`` event reconstructs."""
    tok = NeuralAudioTokenizer(**CONFIG, seed=9, enable_codebook_cache=False,
                               device="cpu")
    tok.ensure_initialized()
    with torch.no_grad():
        tok.mel_encoder.proj.weight.mul_(1.5)     # differ from the seed
    path = str(tmp_path / "m.pt")
    checkpoint.save_model(path, tok)
    plain = AudioTokenizationPipeline(model_config=CONFIG, device="cpu",
                                      enable_codebook_cache=False,
                                      model_path=path,
                                      enable_reconstruction=False)
    full = AudioTokenizationPipeline(model_config=CONFIG, device="cpu",
                                     enable_codebook_cache=False,
                                     model_path=path)
    seeded = AudioTokenizationPipeline(model_config=CONFIG, device="cpu",
                                       enable_codebook_cache=False)
    assert torch.equal(full.tokenizer.mel_encoder.proj.weight,
                       tok.mel_encoder.proj.weight)
    for k, v in seeded.tokenizer.decoder.state_dict().items():
        assert torch.equal(full.tokenizer.decoder.state_dict()[k], v)
    a, b = [], []
    plain.stream_audio(str(simple_wav), a.append)
    full.stream_audio(str(simple_wav), b.append)
    assert a[1:-1] == b[1:-1]
    assert _end(b)["mse_loss"] > 0 and _end(a)["mse_loss"] == 0.0
