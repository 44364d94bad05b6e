"""K1's share of its roofline on the main path: the least time the traced
files' frames need (``flops.k1_bound``: per file and stream, 2·M·N·K·D fp32
FLOPs at 67 TFLOP/s against its bytes at 3.35 TB/s) over the profiled device
time of ``rvq_chain_kernel`` in the traced sub-window. Padded rows and
bucket padding are work the kernel does that the audio does not need. Moves
``audio_s_per_s``."""

KERNEL = "rvq_chain_kernel"


def read(ctx):
    dev = ctx.get("device")
    if ctx.get("driver") != "files" or not dev or not ctx.get("k1_bound_s"):
        return None
    spent = sum(s for name, s in dev["ops"].items() if KERNEL in name)
    if not spent:
        return None
    return 100.0 * ctx["k1_bound_s"] / spent
