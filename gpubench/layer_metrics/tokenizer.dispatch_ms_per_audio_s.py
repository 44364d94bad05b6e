"""Host milliseconds in ``nat/dispatch`` per second of audio tokenized in
the window: enqueuing span forwards (graph replays) in the span loop
(models/tokenizer.py iter_chunks). Inclusive wall of the program's span,
summed over threads (``utils/profiling.stage_timings``). Moves
``audio_s_per_s``."""

SPAN = "nat/dispatch"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
