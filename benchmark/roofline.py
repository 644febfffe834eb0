"""The yardstick of kernel rooflines: published peaks and each kernel's
work, counted from what its inputs need and not from any implementation.

A share of the roofline is the least time the chip could take, the larger
of operations over the peak operation rate and bytes over the peak memory
bandwidth, divided by the kernel's measured time.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (the "H100 80GB HBM3" part), NVIDIA H100 Tensor Core GPU
# Architecture white paper (2022), table of peak rates at the 700 W limit:
# the highest non-tensor arithmetic rate is packed FP16/BF16, 133.8
# TFLOP/s (twice FP32's 66.9); HBM3 bandwidth 3.35 TB/s.  Packed 16-bit
# arithmetic is the fastest the decode could run outside the tensor
# cores, so no change of number format in a kernel can read over 100%.
PEAK_OPS = 133.8e12          # operations per second
PEAK_BYTES = 3.35e12         # bytes per second

# K=7 Viterbi: 192 operations per trellis step and row (64 states, an
# add-compare-select of two branch metrics each).  Bytes per step: the two
# soft values at the 4 bits the decode's metrics resolve (round(8 x)
# clamped to +-7) read once, and the decoded bit written once.
VITERBI_OPS_PER_STEP = 192
VITERBI_BYTES_PER_STEP = 2 * 4 / 8 + 1 / 8


def least_time(ops: float, nbytes: float) -> float:
    """Seconds the chip needs at the least for ``ops`` and ``nbytes``."""
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def viterbi_least_time(steps: int) -> float:
    """Least seconds for ``steps`` trellis steps (summed over rows)."""
    return least_time(VITERBI_OPS_PER_STEP * steps,
                      VITERBI_BYTES_PER_STEP * steps)
