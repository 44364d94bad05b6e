"""Files in a closed loop: ``nat f1 f2 …`` on the incremental stdout path.

One client: ``AudioTokenizationPipeline.stream_audio`` on one file after
another, each file's NDJSON lines kept in memory in place of stdout, the
next file started when the last one's ``end`` event is out.  The files are
the mix's seeded pool of 16-bit mono WAVs, written under the run's
temporary directory in set-up and taken in the seed's order, round and
round.

Set-up: the pipeline and its weights, the pool, every ``(bucket, rows)``
forward the pool's span plans run (eager, then captured), and the shortest
and the longest file through the whole path (host code, decode, metric
suite).  The window then runs whole files until ``seconds`` have passed;
``audio_s_per_s`` is the audio of the files it completed over its wall
time, the last file included.  A traced run then profiles whole files for
about ``profile_s`` more, after the window.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from gpubench import flops, plan, program, traffic
from gpubench.reference.tokenize import parse_stream

PROFILE_S = 3.0


def _normalized(pcm: np.ndarray) -> np.ndarray:
    """The loader's samples: ``int16 / 32768``, then divided by the peak
    plus 1e-8 (float32)."""
    audio = pcm.astype(np.float32) / np.float32(32768.0)
    audio /= np.maximum(audio.max(), -audio.min()) + 1e-8
    return audio


def run(r) -> Dict:
    torch = r.torch
    cfg, tr = r.cell.config, r.cell.traffic
    sr = tr["sample_rate"]
    recon = bool(tr["reconstruction"])
    marks = [("start", time.time())]
    pipe = program.build(cfg, recon, r.seed, r.device)
    tok = pipe.tokenizer
    r.sync()
    marks.append(("program", time.time()))
    clips = traffic.pool(tr, r.seed)
    sig = traffic.signal(r.seed, tr["signal_s"], sr)
    pool_dir = r.tmp / "pool"
    pool_dir.mkdir()
    paths = []
    for clip in clips:
        path = pool_dir / f"{clip.index:03d}.wav"
        path.write_bytes(traffic.wav_bytes(traffic.clip_pcm(sig, clip), sr))
        paths.append(str(path))
    marks.append(("pool", time.time()))
    group = tok._stream_group_size()
    if r.device != "cpu":
        program.warm_shapes(tok, sr, set().union(
            *(plan.file_shapes(c.samples, sr, group) for c in clips)))
    r.sync()
    marks.append(("shapes", time.time()))
    by_len = sorted(range(len(clips)), key=lambda i: clips[i].samples)
    for i in (by_len[0], by_len[-1]):
        pipe.stream_audio(paths[i], lambda line: None)
    r.sync()
    setup_end = time.time()
    marks.append(("warm files", setup_end))
    r.log("set-up: " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                 in zip(marks, marks[1:])))

    from nat_tpu_torch.ops import rvq_kernel
    from nat_tpu_torch.utils import profiling

    profiling.reset_timings()
    graphs0 = dict(tok._graphs.stats)
    k1_0 = rvq_kernel.launches
    records = []
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < r.seconds:
        clip = clips[i % len(clips)]
        lines: list = []
        try:
            pipe.stream_audio(paths[clip.index], lines.append)
            ok = True
        except Exception as exc:          # a failed answer, counted
            r.log(f"file {clip.index} failed: {type(exc).__name__}: {exc}")
            ok = False
        records.append((clip, lines, ok))
        i += 1
    r.sync()
    wall = time.perf_counter() - t0
    done = [c for c, _, ok in records if ok]
    audio_s = sum(c.samples for c in done) / sr
    ctx = {
        "driver": "files", "audio_s": audio_s, "wall_s": wall,
        "stages": dict(profiling.stage_timings),
        "graphs": {k: v - graphs0.get(k, 0)
                   for k, v in tok._graphs.stats.items()},
        "k1_launches": rvq_kernel.launches - k1_0,
        "flops": sum(flops.file_flops(c.samples, cfg, recon) for c in done),
    }
    r.log(f"window: {len(records)} files, {audio_s:.1f} s of audio in "
          f"{wall:.3f} s, K1 launches {ctx['k1_launches']}, "
          f"graphs {ctx['graphs']}")

    if r.trace:
        from gpubench.devtrace import Traced

        frames, j = 0, i
        with Traced(torch) as traced:
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < PROFILE_S:
                clip = clips[j % len(clips)]
                pipe.stream_audio(paths[clip.index], lambda line: None)
                n = plan.file_frames(clip.samples, sr, cfg)
                frames += n
                ctx["k1_bound_s"] = (ctx.get("k1_bound_s", 0.0)
                                     + flops.k1_bound(n, cfg))
                j += 1
        ctx["device"] = traced.reduce()
        r.log(f"traced {j - i} files ({frames} frames) in "
              f"{traced.window_s:.3f} s")
    if torch.cuda.is_available():
        ctx["reserved_bytes"] = torch.cuda.max_memory_reserved()

    # Each file of the pool the window reached once (its first run), the
    # longest among them.
    first = list({c.index: k for k, (c, _, _) in reversed(
        list(enumerate(records)))}.values())
    longest = max(range(len(first)),
                  key=lambda k: records[first[k]][0].samples)
    checked = [first[k] for k in traffic.sample_indices(
        len(first), tr["check"], longest, r.seed)]
    answers = [(_normalized(traffic.clip_pcm(sig, records[k][0])),
                parse_stream(records[k][1]), f"file {records[k][0].index}")
               for k in checked if records[k][2]]
    del pipe, tok
    return {"setup_end": setup_end, "attempted": len(records),
            "failed": len(records) - len(done), "ctx": ctx,
            "answers": answers, "reconstruct": recon,
            "metrics": {"audio_s_per_s": audio_s / wall}}
