"""linear route: the dot tile's share of its roofline.  Least work of the
sampled traced batches' linear groups: each segment's live rows read once a
batch (d float32), the group's queries, the reported (id, distance)
pairs, and 2*Q*N*d operations at the float32-accurate tensor-core rate;
over the device time of the kernels below."""
from bench.lib import peaks
from bench.lib.trace import kernel_seconds

KERNELS = ("dot_tile_kernel",)


def read(ctx):
    w, t = ctx.get("work"), ctx.get("work_device_s")
    if not w or t is None or not w["q_linear"]:
        return None
    flops = 2.0 * w["linear_qrows"] * w["d"]
    nbytes = 4.0 * (w["linear_rows"] * w["d"] + w["q_linear"] * w["d"]) \
        + 8.0 * w["linear_pairs"]
    return peaks.share(kernel_seconds(t, KERNELS), flops, nbytes,
                       peaks.FP32_VIA_TF32)
