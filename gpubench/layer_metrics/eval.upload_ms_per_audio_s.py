"""Host milliseconds in ``nat/eval/upload`` per second of audio tokenized
in the window: the metric suite's two host-to-device copies (the original
and the reconstruction) before its passes run on the card; only where the
mix reconstructs and the evaluator's device is a card. Inclusive wall of
the program's span, summed over threads (``utils/profiling.stage_timings``);
None where the program has no such span. Moves ``audio_s_per_s``."""

SPAN = "nat/eval/upload"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
