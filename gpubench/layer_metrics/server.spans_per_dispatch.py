"""Spans per batched forward of the daemon's ``SpanBatcher`` over the window
(its ``stats``): how far the batcher coalesces concurrent connections'
spans. Moves ``first_frame_p95_ms``."""


def read(ctx):
    b = ctx.get("batcher") or {}
    if not b.get("dispatches"):
        return None
    return b["spans"] / b["dispatches"]
