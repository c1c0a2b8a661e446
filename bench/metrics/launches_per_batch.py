"""engine: device kernels that ran inside a query batch's range, per
query batch of the traced stretch."""


def read(ctx):
    t = ctx.get("trace") or {}
    if not t.get("batches"):
        return None
    return t["launches"] / t["batches"]
