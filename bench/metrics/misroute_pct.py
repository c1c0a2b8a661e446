"""cost model: the share of judged queries whose route was the dearer one
once Eq. 1 is priced with the reference's exact collisions and distinct
candidates (Eq. 2 with the index's scanned rows)."""


def read(ctx):
    c = ctx.get("checks") or {}
    if not c.get("judged_queries"):
        return None
    return c["misroute_pct"]
