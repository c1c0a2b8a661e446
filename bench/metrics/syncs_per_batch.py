"""engine: host waits on the device (cudaStreamSynchronize /
cudaDeviceSynchronize / cudaEventSynchronize on the control thread)
inside the index call, per query batch of the traced stretch; the
benchmark's own synchronise after the call is outside and not counted."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("batches"):
        return None
    return t["syncs"] / t["batches"]
