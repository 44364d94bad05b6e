"""Tokenization quality metrics, copied from ``nat_tpu/eval/metrics.py``:
the 20-field :class:`TokenizationMetrics` the ``end`` event carries, with
entropy in nats, mutual information over all semantic against all acoustic
tokens with adaptive binning, and grouped token diversity.

Given a reconstruction, the evaluator adds the reconstruction metrics of
:mod:`nat_tpu_torch.eval.audio_metrics`, split as in the reference: the DC
offset is removed from the reconstruction before MSE, spectral, MR-STFT,
LSD and perceptual losses over the common length; pitch, rhythm and timbre
compare the raw signals cut to that length.  Without one they stay 0.0,
as in the reference's ``--no-reconstruction`` runs.  They run in one torch
pass on the device of the tokenizer the evaluator is handed (the CPU
without one): both signals go up once, each spectrogram is computed once,
and only scalars and per-frame tracks come back.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.memory import get_memory_usage_mb
from ..utils.profiling import annotate


@dataclass
class TokenizationMetrics:
    """Comprehensive metrics for evaluating tokenization quality."""

    # Basic statistics
    num_semantic_tokens: int
    num_acoustic_tokens: int
    compression_ratio: float
    token_diversity: float
    # Reconstruction metrics
    mse_loss: float
    spectral_loss: float
    perceptual_loss: float
    # Additional standard audio metrics
    mr_stft_loss: float
    log_spectral_distance: float
    # Information theory metrics
    semantic_entropy: float
    acoustic_entropy: float
    mutual_information: float
    # Music-specific metrics
    pitch_accuracy: float
    rhythm_accuracy: float
    timbral_similarity: float
    # Efficiency metrics
    encoding_time: float
    decoding_time: float
    memory_usage: float
    # Token budget metrics
    tokens_per_second: float = 0.0
    frames_per_second: float = 0.0


def shannon_entropy(tokens: np.ndarray) -> float:
    """Entropy (nats) of a discrete token sequence."""
    if tokens.size == 0:
        return 0.0
    _, counts = np.unique(tokens, return_counts=True)
    p = counts / counts.sum()
    return float(-np.sum(p * np.log(p)))


def mutual_information(a: np.ndarray, b: np.ndarray,
                       bins: Optional[int] = None) -> float:
    """MI (bits) between two token streams via a 2-D joint histogram:
    streams cut to the common length, ``min(64, max(unique_a, unique_b,
    2))`` bins unless given, joint cells masked at 1e-12, denominator
    regularized by 1e-12."""
    a = np.asarray(a).astype(np.int64).ravel()
    b = np.asarray(b).astype(np.int64).ravel()
    n = min(a.size, b.size)
    if n == 0:
        return 0.0
    a, b = a[:n], b[:n]
    if bins is None:
        bins = min(64, max(len(np.unique(a)), len(np.unique(b)), 2))
    joint, _, _ = np.histogram2d(a, b, bins=bins)
    total = joint.sum()
    if total == 0:
        return 0.0
    pxy = joint / total
    px = pxy.sum(axis=1, keepdims=True)
    py = pxy.sum(axis=0, keepdims=True)
    mask = pxy > 1e-12
    px_e = np.broadcast_to(px, pxy.shape)[mask]
    py_e = np.broadcast_to(py, pxy.shape)[mask]
    pxy_nz = pxy[mask]
    if pxy_nz.size == 0:
        return 0.0
    mi = float(np.sum(pxy_nz * np.log2(pxy_nz / (px_e * py_e + 1e-12))))
    return mi if np.isfinite(mi) else 0.0


def token_diversity(all_tokens: np.ndarray) -> float:
    """unique / total for one token group."""
    if all_tokens.size == 0:
        return 0.0
    return float(len(np.unique(all_tokens)) / all_tokens.size)


def grouped_token_diversity(sem: np.ndarray, acc: np.ndarray) -> float:
    """Mean of the semantic and acoustic per-group diversities."""
    return (token_diversity(sem) + token_diversity(acc)) / 2.0


class TokenizationEvaluator:
    """Computes the metric set from a tokenizer result dict."""

    def __init__(self, sample_rate: int = 22050) -> None:
        self.sample_rate = sample_rate

    def evaluate_tokenization(
        self,
        audio: np.ndarray,
        tokenizer=None,
        reconstructed: Optional[np.ndarray] = None,
        precomputed_result: Optional[Dict] = None,
        encoding_time: float = 0.0,
        decoding_time: float = 0.0,
        num_samples: Optional[int] = None,
    ) -> TokenizationMetrics:
        """``num_samples`` overrides ``audio.size`` for the compression
        ratio (streaming callers evaluate after trimming their buffers).
        The reconstruction's parts run in regions of their own,
        ``nat/eval/spectral``, ``nat/eval/pitch``, ``nat/eval/rhythm`` and
        ``nat/eval/timbral`` (on a card after ``nat/eval/upload``), then the
        token statistics in ``nat/eval/tokens``; the memory probe that
        opens the evaluation lies in none of them."""
        initial_memory = get_memory_usage_mb()
        recon = (self._reconstruction_metrics(audio, reconstructed,
                                              self.device_of(tokenizer))
                 if reconstructed is not None else {})
        with annotate("nat/eval/tokens"):
            result = precomputed_result or {}
            sem_codes: List[np.ndarray] = [
                np.asarray(c).reshape(-1)
                for c in result.get("semantic_codes", [])]
            acc_codes: List[np.ndarray] = [
                np.asarray(c).reshape(-1)
                for c in result.get("acoustic_codes", [])]
            sem_all = (np.concatenate(sem_codes) if sem_codes
                       else np.array([], dtype=int))
            acc_all = (np.concatenate(acc_codes) if acc_codes
                       else np.array([], dtype=int))
            if num_samples is None:
                num_samples = int(np.asarray(audio).size)
            total_tokens = int(sem_all.size + acc_all.size)
            mi = mutual_information(sem_all, acc_all)
            final_memory = get_memory_usage_mb()
            return TokenizationMetrics(
                num_semantic_tokens=int(sem_all.size),
                num_acoustic_tokens=int(acc_all.size),
                compression_ratio=num_samples / max(total_tokens, 1),
                token_diversity=grouped_token_diversity(sem_all, acc_all),
                mse_loss=recon.get("mse_loss", 0.0),
                spectral_loss=recon.get("spectral_loss", 0.0),
                perceptual_loss=recon.get("perceptual_loss", 0.0),
                mr_stft_loss=recon.get("mr_stft_loss", 0.0),
                log_spectral_distance=recon.get("log_spectral_distance", 0.0),
                semantic_entropy=shannon_entropy(sem_all),
                acoustic_entropy=shannon_entropy(acc_all),
                mutual_information=mi,
                pitch_accuracy=recon.get("pitch_accuracy", 0.0),
                rhythm_accuracy=recon.get("rhythm_accuracy", 0.0),
                timbral_similarity=recon.get("timbral_similarity", 0.0),
                encoding_time=encoding_time,
                decoding_time=decoding_time,
                # Memory increase during evaluation.
                memory_usage=max(final_memory - initial_memory, 0.0),
            )

    @staticmethod
    def device_of(tokenizer) -> torch.device:
        """Where the reconstruction metrics run: the tokenizer's device,
        the CPU without one (or for one that has no device)."""
        device = getattr(tokenizer, "device", None)
        return torch.device("cpu" if device is None else device)

    def _reconstruction_metrics(self, audio: np.ndarray,
                                reconstructed: np.ndarray,
                                device: torch.device = torch.device("cpu")
                                ) -> Dict[str, float]:
        """The eight reconstruction fields (``nat_tpu/eval/metrics.py``
        145-172); all 0.0 when either signal is empty.  Each region ends
        with the fetch of its results, so its time holds its device work;
        a spectrogram two regions share is paid in the first."""
        from . import audio_metrics as am

        sr = self.sample_rate
        recon_host = np.asarray(reconstructed, dtype=np.float32).reshape(-1)
        orig_host = np.asarray(audio, dtype=np.float32).reshape(-1)
        n = min(recon_host.size, orig_host.size)
        if n == 0:
            return {}
        with (annotate("nat/eval/upload") if device.type == "cuda"
              else nullcontext()):
            orig_full = torch.from_numpy(orig_host).to(device)
            recon_raw = torch.from_numpy(recon_host).to(device)
        with annotate("nat/eval/spectral"):
            recon = recon_raw - recon_raw.mean(dtype=torch.float64).float()
            orig = orig_full[:n]
            sp = am.Spectra({"o": orig, "d": recon[:n],
                             "r": recon_raw[:n]}, sr)
            diff = recon[:n] - orig
            pair = ("o", "d")
            values = torch.stack([
                (diff * diff).mean(dtype=torch.float64),
                am._spectral_mse(sp, pair),
                am._mr_stft(sp, pair),
                am._lsd(sp, pair),
                am._perceptual(sp, pair),
            ]).tolist()
            out = dict(zip(("mse_loss", "spectral_loss", "mr_stft_loss",
                            "log_spectral_distance", "perceptual_loss"),
                           values))
        raw = ("o", "r")
        with annotate("nat/eval/pitch"):
            tracks = am._tracks(sp, raw).cpu().numpy()
            out["pitch_accuracy"] = am._correlation(tracks[0], tracks[1])
        with annotate("nat/eval/rhythm"):
            masks = am._onset_masks(sp, raw).cpu().numpy()
            out["rhythm_accuracy"] = am._rhythm(
                am._onset_times(masks[0], sr), am._onset_times(masks[1], sr))
        with annotate("nat/eval/timbral"):
            means = am._mfcc13_means(sp, raw).cpu().numpy()
            out["timbral_similarity"] = am._cosine(means[0], means[1])
        return out
