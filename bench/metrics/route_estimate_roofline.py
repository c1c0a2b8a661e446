"""estimate: the HLL merge-and-estimate kernel's share of its roofline.
Least work of the sampled traced batches: each distinct probed bucket of each
frozen segment read once (m register bytes and two 4 B offsets), the query buckets (4 B a table), and two 4 B results a query;
over the device time of the kernel below."""
from bench.lib import peaks
from bench.lib.trace import kernel_seconds

KERNELS = ("route_estimate_kernel",)


def read(ctx):
    w, t = ctx.get("work"), ctx.get("work_device_s")
    if not w or t is None:
        return None
    q = w["q_lsh"] + w["q_linear"]
    nbytes = w["probed_buckets"] * (w["m"] + 8.0) + 4.0 * q * w["L"] \
        + 8.0 * q
    return peaks.share(kernel_seconds(t, KERNELS), 0.0, nbytes, peaks.FP32)
