"""Host milliseconds in ``nat/finalize`` per second of audio tokenized in the
window: the span loop's host work after each fetch (``finalize_span``'s
overlap discard and slicing, ``finalize_span_group``'s row split).
Inclusive wall of the program's span, summed over threads
(``utils/profiling.stage_timings``); None where the program has no such
span. Moves ``audio_s_per_s``."""

SPAN = "nat/finalize"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
