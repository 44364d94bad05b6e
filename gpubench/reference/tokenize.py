"""The reference tokenizer: a file's frames, codes and reconstruction from
the plain modules, span by span as the program cuts it (``plan``), and the
judge that reads the program's answers against it.

Every span runs alone at its padded bucket length (the frames of a span do
not depend on the spans batched with it in float32), and only the frames
the program keeps are kept.  The judge reads the program's codes to judge
them: each code's distance gap to the best code of the reference's residual
(:func:`model.code_gaps`), which follows the program's own codes as its
chain did, and, where the mix reconstructs, the decoder's output of the
program's codes held against the ``mse_loss`` the program reported.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import plan
from . import model


class Answer(NamedTuple):
    """What the program (or the control) returned for one input."""

    fi: List[int]              # frame indices, in order
    ts: List[float]            # frame timestamps (ms)
    sem: np.ndarray            # [F, N] semantic codes
    acc: np.ndarray            # [F, N] acoustic codes
    mse_loss: Optional[float]  # the end event's mse_loss


def parse_stream(lines: List[str]) -> Answer:
    """An NDJSON stream's frames and its end event's ``mse_loss``."""
    import json

    fi, ts, sem, acc, mse = [], [], [], [], None
    for line in lines:
        if '"event":"frame"' in line:
            ev = json.loads(line)
            fi.append(ev["fi"])
            ts.append(ev["ts"])
            sem.append(ev["S"])
            acc.append(ev["A"])
        elif '"event":"end"' in line:
            mse = json.loads(line).get("stats", {}).get("mse_loss")
    shape = (0, 0)
    return Answer(fi, ts, np.array(sem, np.int64).reshape(len(sem), -1)
                  if sem else np.zeros(shape, np.int64),
                  np.array(acc, np.int64).reshape(len(acc), -1)
                  if acc else np.zeros(shape, np.int64), mse)


def mse_loss(recon: np.ndarray, audio: np.ndarray) -> float:
    """The reconstruction's MSE as the metric suite defines it: the DC
    offset removed, over the common length (float64 here)."""
    r = recon.astype(np.float64)
    r = r - r.mean()
    n = min(r.size, audio.size)
    return float(np.mean((r[:n] - audio[:n].astype(np.float64)) ** 2))


class Reference:
    """The plain modules of one configuration with the benchmark's weights,
    on ``device``, at ``numerics``."""

    def __init__(self, cfg: Dict, params, codebooks, device,
                 numerics: model.Numerics) -> None:
        self.cfg = cfg
        self.sr = cfg["sample_rate"]
        self.numerics = numerics
        self.ops = model.Ops(numerics)
        self.mods = model.load(model.build(cfg, "decoder" in params),
                               params, device)
        self.codebooks = tuple(c.float() for c in codebooks)
        self.device = torch.device(device)

    @torch.no_grad()
    def features(self, audio: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """The kept frames' features of both streams, ``[F, D]`` each."""
        sem, acc = [], []
        for span in plan.spans_of(audio.size, self.sr):
            chunk = np.zeros(span.bucket, np.float32)
            chunk[:span.ext_len] = audio[span.ext_start:
                                         span.ext_start + span.ext_len]
            wave = torch.from_numpy(chunk)[None].to(self.device)
            t_target = plan.target_frames(span.bucket, self.sr, self.cfg)
            with model.tf32(False):
                s, a = model.span_features(self.mods, wave, self.sr, t_target,
                                           self.ops)
            keep = torch.from_numpy(plan.kept(span, self.sr,
                                              self.cfg)).to(self.device)
            sem.append(s[0, keep])
            acc.append(a[0, keep])
        return torch.cat(sem), torch.cat(acc)

    @torch.no_grad()
    def answer(self, audio: np.ndarray, reconstruct: bool) -> Answer:
        """The reference's own answer at its numerics: the control's
        stand-in for the program."""
        sem, acc = self.features(audio)
        with model.tf32(self.numerics.tf32):
            s = model.rvq_codes(sem, self.codebooks[0]).cpu().numpy()
            a = model.rvq_codes(acc, self.codebooks[1]).cpu().numpy()
        mse = (mse_loss(self.reconstruct(s, a), audio) if reconstruct
               else None)
        dur = 1000.0 * self.cfg["hop_length"] / self.sr
        return Answer(list(range(len(s))),
                      [round(i * dur, 3) for i in range(len(s))], s, a, mse)

    @torch.no_grad()
    def reconstruct(self, sem_codes: np.ndarray,
                    acc_codes: np.ndarray) -> np.ndarray:
        """The decoder's waveform of the given codes, ``[F·hop]``."""
        def quantized(codes, codebook):
            idx = torch.from_numpy(codes).to(self.device)
            return sum(codebook[layer][idx[:, layer]]
                       for layer in range(codebook.shape[0]))

        joint = torch.cat([quantized(sem_codes, self.codebooks[0]),
                           quantized(acc_codes, self.codebooks[1])], dim=-1)
        with model.tf32(self.numerics.tf32):
            wave = model.decode(self.mods["decoder"], joint[None],
                                len(sem_codes) * self.cfg["hop_length"])
        return wave[0].cpu().numpy()

    @torch.no_grad()
    def judge(self, audio: np.ndarray, ans: Answer,
              reconstruct: bool) -> Dict[str, float]:
        """Readings of one answer: ``code_gap`` (the widest relative distance
        gap of any code), ``frame_errors`` (missing or extra frames, and
        frames whose index or timestamp is not the reference's),
        ``code_agree`` (the share equal to the reference's own argmin, for
        the record) and, with ``reconstruct``, ``mse_rel_err``."""
        sem, acc = self.features(audio)
        frames = sem.shape[0]
        got = len(ans.fi)
        dur = 1000.0 * self.cfg["hop_length"] / self.sr
        errors = abs(frames - got) + sum(
            1 for i, (f, t) in enumerate(zip(ans.fi, ans.ts))
            if f != i or abs(t - round(i * dur, 3)) > 5e-4)
        n = min(frames, got)
        out = {"frame_errors": float(errors), "code_gap": 0.0,
               "code_agree": 1.0}
        if n:
            agree = []
            for feats, codes, codebook in ((sem, ans.sem, self.codebooks[0]),
                                           (acc, ans.acc, self.codebooks[1])):
                given = torch.from_numpy(codes[:n]).to(self.device)
                gaps = model.code_gaps(feats[:n], given, codebook)
                out["code_gap"] = max(out["code_gap"], float(gaps.max()))
                agree.append(float((gaps == 0).double().mean()))
            out["code_agree"] = float(np.mean(agree))
        if reconstruct:
            ref = mse_loss(self.reconstruct(ans.sem, ans.acc), audio)
            mse = float("nan") if ans.mse_loss is None else ans.mse_loss
            rel = abs(mse - ref) / max(ref, 1e-30)
            out["mse_rel_err"] = rel if np.isfinite(rel) else 1e30
        return out


def combine(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """Readings over many answers: the widest gap and error, the summed
    frame errors, the mean agreement."""
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            if k == "frame_errors":
                out[k] = out.get(k, 0.0) + v
            elif k == "code_agree":
                out.setdefault("_agree", []).append(v)
            else:
                out[k] = max(out.get(k, 0.0), v)
    if "_agree" in out:
        out["code_agree"] = float(np.mean(out.pop("_agree")))
    return out
