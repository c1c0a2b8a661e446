"""Peaks of one NVIDIA H100 SXM5 80GB HBM3 at its 700 W limit (NVIDIA's
H100 Tensor Core GPU data sheet, dense rates, no sparsity): a frozen copy
of the port's ``launch/roofline.py`` constants, so that a change to the
program cannot move the yardstick."""
HBM_BW = 3.35e12           # B/s
FP32 = 67e12               # FLOP/s on the CUDA cores
TF32 = 495e12              # FLOP/s on the tensor cores
# the linear route's dot tile keeps float32 accuracy with three TF32
# products a multiply-add (hi*hi + hi*lo + lo*hi)
FP32_VIA_TF32 = TF32 / 3


def share(seconds: float, flops: float, nbytes: float, peak_flops: float):
    """Percent of the least time the work needs (the larger of its
    operations at ``peak_flops`` and its bytes at HBM_BW) in ``seconds``
    of device time; None when the kernel did not run."""
    if seconds <= 0.0:
        return None
    least = max(flops / peak_flops, nbytes / HBM_BW)
    return 100.0 * least / seconds
