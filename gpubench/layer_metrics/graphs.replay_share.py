"""Share of the window's span forwards that replayed a CUDA graph, of those
replayed or run eagerly (``runtime/aotcache.py``'s ``stats``). Moves
``audio_s_per_s``."""


def read(ctx):
    g = ctx.get("graphs") or {}
    runs = g.get("replays", 0) + g.get("eager", 0)
    if ctx.get("driver") != "files" or not runs:
        return None
    return 100.0 * g["replays"] / runs
