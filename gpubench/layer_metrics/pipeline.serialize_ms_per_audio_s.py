"""Host milliseconds in ``nat/serialize`` per second of audio tokenized in
the window: the NDJSON frame lines (stream/). Inclusive wall of the
program's span, summed over threads (``utils/profiling.stage_timings``).
Moves ``audio_s_per_s``."""

SPAN = "nat/serialize"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
