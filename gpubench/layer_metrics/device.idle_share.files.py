"""Share of the traced sub-window in which no operation ran on the card: 1 −
(union of the profiled device activities' intervals ÷ the sub-window's
wall). Moves ``audio_s_per_s``."""


def read(ctx):
    dev = ctx.get("device")
    if ctx.get("driver") != "files" or not dev or not dev["window_s"]:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
