"""device: the share of the traced stretch in which no kernel, copy or
set ran on the device (1 - union of device intervals / wall time)."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
