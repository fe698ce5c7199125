"""``kernels.ops.flash_attention``, causal self-attention of ``S`` queries
over ``S`` keys (GQA: ``H`` query heads over ``K`` KV heads, head dim
``D``), in ``elem``-byte elements."""

NAMES = r"\bflash_tc_kernel\b|\bflash_kernel\b"


def flops(B: int, S: int, H: int, K: int, D: int, elem: int = 2) -> float:
    return 2.0 * B * H * D * S * (S + 1)                # QK^T and PV over i >= j


def nbytes(B: int, S: int, H: int, K: int, D: int, elem: int = 2) -> float:
    return float(elem * (2 * B * S * H * D + 2 * B * S * K * D))   # q, o; k, v
