"""Host milliseconds in ``nat/eval/spectral`` per second of audio tokenized in
the window: the metric suite's waveform and STFT distances (MSE, spectral
MSE, MR-STFT, LSD, perceptual loss; ``eval/audio_metrics.py``); only where
the mix reconstructs. Inclusive wall of the program's span, summed over
threads (``utils/profiling.stage_timings``); None where the program has no
such span. Moves ``audio_s_per_s``."""

SPAN = "nat/eval/spectral"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
