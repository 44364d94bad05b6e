"""Host milliseconds in ``nat/decode`` per second of audio tokenized in the
window: the reconstruction's whole-file decode (``decode_tokens``: the RVQ
decode and the float32 decoder, TF32 off), its blocking copy back to the
host included; only where the mix reconstructs. Inclusive wall of the
program's span, summed over threads (``utils/profiling.stage_timings``);
None where the program has no such span. Moves ``audio_s_per_s``."""

SPAN = "nat/decode"


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("audio_s"):
        return None
    seconds = ctx["stages"].get(SPAN)
    if seconds is None:
        return None
    return 1e3 * seconds / ctx["audio_s"]
