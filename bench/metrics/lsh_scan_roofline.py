"""LSH route: the verification kernel's share of its roofline.  Least
work of the sampled traced batches' LSH groups: each distinct candidate row the
cap surely admits read once a batch (d float32), the bucket-list entries
gathered (4 B each), the group's queries, the reported pairs (8 B), and
2*d operations per (query, candidate) at the float32 rate; over the
device time of the kernel below."""
from bench.lib import peaks
from bench.lib.trace import kernel_seconds

KERNELS = ("lsh_scan_kernel",)


def read(ctx):
    w, t = ctx.get("work"), ctx.get("work_device_s")
    if not w or t is None or not w["q_lsh"]:
        return None
    d = w["d"]
    flops = 2.0 * d * w["lsh_cands"]
    nbytes = 4.0 * (w["lsh_rows_union"] * d + w["bucket_entries"]
                    + w["q_lsh"] * d) + 8.0 * w["lsh_pairs"]
    return peaks.share(kernel_seconds(t, KERNELS), flops, nbytes, peaks.FP32)
