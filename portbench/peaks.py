"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Shares of a roofline or of a peak
are stated against these, with the card's power limit printed beside them."""

BF16_FLOPS = 989e12          # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12           # float32 outside the tensor cores
FP8_FLOPS = 1979e12
HBM_BYTES = 3.35e12          # bytes a second


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS) -> float:
    """The least time the card could take: the larger of the operations at
    the peak rate and the bytes at HBM's rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)
