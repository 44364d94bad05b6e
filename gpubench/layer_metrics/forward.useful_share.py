"""Share of the samples the window's forwards took in that are the window's
own audio: the audio seconds completed times the mix's rate, over the graph
cache's ``samples`` (rows × padded length of every forward, eager or
replayed; ``runtime/aotcache.py``'s ``stats``). What is left is overlap,
bucket padding and the zero rows that round a span group up to a power of
two. None where the program does not count samples. Moves
``audio_s_per_s``."""


def read(ctx):
    samples = (ctx.get("graphs") or {}).get("samples")
    if ctx.get("driver") != "files" or not samples:
        return None
    return 100.0 * ctx["audio_s"] * ctx["traffic"]["sample_rate"] / samples
