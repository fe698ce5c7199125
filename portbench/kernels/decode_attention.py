"""``kernels.ops.decode_attention``: one query row per sequence against the
first ``kv_len`` rows of its K/V cache (GQA: ``H`` query heads over ``K``
KV heads, head dim ``D``), in ``elem``-byte elements."""

NAMES = r"\bdecode_split_kernel\b"


def flops(B: int, H: int, K: int, D: int, kv_len: int, elem: int = 2) -> float:
    return 4.0 * B * H * D * kv_len                      # QK^T and PV, 2 per multiply-add


def nbytes(B: int, H: int, K: int, D: int, kv_len: int, elem: int = 2) -> float:
    return float(elem * (2 * B * H * D                  # q in, o out
                         + 2 * B * kv_len * K * D)      # the live rows of K and V
                 + 4 * B)                               # kv_len
