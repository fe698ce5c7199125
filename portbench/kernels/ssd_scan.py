"""``kernels.ops.ssd_scan``, the Mamba-2 SSD scan of one sequence batch:
x and y (B, S, H, P) and B, C (B, S, G, N) in ``elem``-byte elements, dt
(B, S, H) and A (H,) in float32, the final state (B, H, P, N) in float32.
Operations: the recurrence's state update and read-out, 4 * P * N per
head and position (2 per multiply-add), the least any form needs."""

NAMES = r"\bchunk_state_kernel\b|\bchunk_scan_kernel\b|\bssd_scan_kernel\b"


def flops(B: int, S: int, H: int, P: int, G: int, N: int, elem: int = 2) -> float:
    return 4.0 * B * S * H * P * N


def nbytes(B: int, S: int, H: int, P: int, G: int, N: int, elem: int = 2) -> float:
    return float(elem * (2 * B * S * H * P + 2 * B * S * G * N)   # x, y; B, C
                 + 4 * (B * S * H + H + B * H * P * N))           # dt, A; final state
