"""The forward's share of the card's bf16 dense peak over the window: the
FLOPs the window's audio needs (``gpubench/flops.py``: each file's own
samples, no padding, no overlap) over the window's wall time times 989
TFLOP/s. The encoders compute in bf16, so that is their peak. Moves
``audio_s_per_s``."""

from gpubench.flops import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("driver") != "files" or not ctx.get("wall_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["wall_s"] * PEAK_BF16_FLOPS)
