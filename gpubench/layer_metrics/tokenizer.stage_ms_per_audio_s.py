"""Host milliseconds in ``nat/stage`` per second of audio tokenized in the
window: the span loop's staging of each plan item (``iter_chunks``'
``stage_next``: slicing, ``prepare_span``, stacking, ``_pad_group_rows``,
the upload's start). Inclusive wall of the program's span, summed over
threads (``utils/profiling.stage_timings``); None where the program has no
such span. Moves ``audio_s_per_s``."""

SPAN = "nat/stage"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
