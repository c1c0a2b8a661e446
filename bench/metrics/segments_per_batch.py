"""streaming: segments a query batch searches (frozen segments plus the
delta), the mean over the window's batches, from ``index_stats()``."""


def read(ctx):
    s = ctx.get("segments") or []
    if not s:
        return None
    return sum(s) / len(s)
