"""Host milliseconds in ``nat/evaluate`` per second of audio tokenized in
the window: the metric suite of the end event, with the reconstruction's
eight fields where the mix reconstructs (eval/). Inclusive wall of the
program's span, summed over threads (``utils/profiling.stage_timings``).
Moves ``audio_s_per_s``."""

SPAN = "nat/evaluate"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
