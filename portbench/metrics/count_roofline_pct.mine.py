"""The counting kernels' share of their roofline: the least time of every
counting job in the window (harness/roofline.py: count_work; the b1 rate
and HBM bandwidth of peaks.json) over the device time of the counting
kernels (csrc/overlap_mma.cuh, csrc/counting.cu) in the trace."""

KERNELS = ("overlap_mma_kernel", "vertical_tile_kernel", "vertical_l2_kernel")


def read(rec):
    return rec.roofline_pct("count", *KERNELS)
