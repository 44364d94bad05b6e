"""GiB the caching allocator reserved at its most over the run, set-up
included (``torch.cuda.max_memory_reserved``): graphs' pools and cached
blocks, which limit the rows a forward can take. Moves ``audio_s_per_s``."""


def read(ctx):
    if ctx.get("driver") != "files" or "reserved_bytes" not in ctx:
        return None
    return ctx["reserved_bytes"] / 2 ** 30
