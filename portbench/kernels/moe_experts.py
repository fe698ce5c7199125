"""``kernels.ops.moe_experts``, a dropless MoE's routed experts: the SwiGLU
of width ``f`` of each of ``T * k`` rows (``T`` tokens, ``k`` experts a
token, out of ``E``), grouped by expert, in ``elem``-byte elements.  Bytes:
the rows in and out, the int32 end row of each expert, and the weights of
the experts the rows reach, read once: ``k`` at ``T`` 1 (a token's experts
are distinct), and the expected count under uniform routing,
``E * (1 - (1 - k/E)**T)``, beyond (all ``E`` from a few hundred tokens on,
where a missed expert has a probability under 1e-16 at E 72, k 10).  The
device trace names the grouped products' kernels after their problem
shape, and their setup kernel; the SiLU and product between them are not
matched, and not counted."""

NAMES = r"GroupProblemShape|prepare_grouped_gemm_data"


def experts_read(T: int, k: int, E: int) -> float:
    return float(k) if T == 1 else E * (1.0 - (1.0 - k / E) ** T)


def flops(T: int, k: int, E: int, d: int, f: int, elem: int = 2) -> float:
    return 6.0 * T * k * d * f                          # gate, up and down, 2 per multiply-add


def nbytes(T: int, k: int, E: int, d: int, f: int, elem: int = 2) -> float:
    return (elem * (experts_read(T, k, E) * 3 * d * f   # the experts' weights
                    + 2 * T * k * d)                    # rows in, rows out
            + 4 * E)                                    # end rows
