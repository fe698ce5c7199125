"""The int8 quantize kernel's launch plan and epilogue (``kernels/comm_quant.py``
``quantize_plan``, ``csrc/comm_quant.cu``), on the CPU.

* The plan: the thread-to-element map that ``quantize_kernel`` follows,
  written out here in numpy, writes every q of every row exactly once and
  each row's scale once, for every gradient leaf width of granite-3-2b and
  mamba2-130m and for D 1, 24, 257, 8192 and 16384, bf16 and fp32, rows on
  16 bytes or not; every model leaf takes the vector branch.
* The epilogue: a plain PyTorch mirror of the kernel's arithmetic (a per-row
  reciprocal, the tie guard, rounding by adding 1.5 * 2**23 and taking the
  low byte) equals IEEE division followed by round half to even, and the
  JAX package's Pallas kernel run in interpret mode, on random rows, exact
  ties, the 1-4 ulp neighbours of (k + 0.5) * scale at many scales that are
  not powers of two, absmax near FLT_MAX and near the 1e-12 floor, and NaN
  and Inf rows.  Tolerance: q equal element for element, the scale within
  rtol 1e-6 (``tests/test_kernels.py``'s hold on the Pallas kernel).

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the plain version at these plans.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import comm_quant as RQ
from repro_torch.configs import get_arch
from repro_torch.kernels import comm_quant as cq
from repro_torch.kernels import ops
from repro_torch.kernels.rowplan import MAX_PER, row_plan
from repro_torch.models import model as M
from repro_torch.utils import tree_leaves

CU = Path(cq.__file__).resolve().parent / "csrc" / "comm_quant.cu"
ROUND = np.float32(1.5 * 2 ** 23)       # the kernel's kRound
TIE_GUARD = np.float32(2.0 ** -12)      # the kernel's kTieGuard
BOUND = 1.25 * 2.0 ** -16               # |x * r - RN(x / s)| for |x / s| < 128 (the header)


def leaf_widths(arch: str) -> list[int]:
    return sorted({tuple(cq.leaf_rows(t).shape)[1]
                   for t in tree_leaves(M.abstract_params(get_arch(arch)))})


LEAF_D = sorted(set(leaf_widths("granite-3-2b")) | set(leaf_widths("mamba2-130m")))
DTYPES = [torch.bfloat16, torch.float32]


def rows_of(D: int, dtype, n: int, aligned: bool):
    """x (n, D) on rows that lie on 16 bytes or (a view past the first
    column) do not."""
    base = torch.zeros(n, D + (0 if aligned else 1), dtype=dtype)
    return base if aligned else base[:, 1:]


def covered(plan, rows: int, D: int):
    """How many times each q[row, j] and each scale[row] is written under
    ``plan``: thread t of block blk serves row blk * rpb + t // tpr, lane
    t % tpr; the vector path writes vectors lane + k * tpr (k < per, below
    D / vec), the scalar loop elements lane + k * tpr below D; lane 0 of a
    live row writes its scale."""
    q_count = np.zeros((rows, D), np.int64)
    s_count = np.zeros(rows, np.int64)
    blocks = -(-rows // plan.rpb)
    t = np.arange(plan.tpr * plan.rpb)
    row = (np.arange(blocks)[:, None] * plan.rpb + t[None, :] // plan.tpr).ravel()
    lane = np.broadcast_to(t % plan.tpr, (blocks, t.size)).ravel()
    live = row < rows
    row, lane = row[live], lane[live]
    np.add.at(s_count, row[lane == 0], 1)
    if plan.per:
        for k in range(plan.per):
            vi = lane + k * plan.tpr
            ok = vi < D // plan.vec
            for i in range(plan.vec):
                np.add.at(q_count, (row[ok], vi[ok] * plan.vec + i), 1)
    else:
        for k in range(-(-D // plan.tpr)):
            j = lane + k * plan.tpr
            ok = j < D
            np.add.at(q_count, (row[ok], j[ok]), 1)
    return q_count, s_count


@pytest.mark.parametrize("D", LEAF_D + [1, 24, 257, 8192, 16384])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off16"])
def test_plan_covers_every_element_once(D, dtype, aligned):
    probe = rows_of(D, dtype, 1, aligned)
    plan = cq.quantize_plan(probe)
    rows = 2 * plan.rpb + 1                          # whole blocks and a ragged last one
    x = rows_of(D, dtype, rows, aligned)
    assert cq.quantize_plan(x) == plan
    itemsize = x.element_size()
    assert plan.vec == 16 // itemsize
    vector = aligned and D % plan.vec == 0 and D // plan.vec <= MAX_PER * 256
    assert (plan.per > 0) == vector
    tpr, threads = plan.tpr, plan.tpr * plan.rpb
    assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
    assert threads % 32 == 0 and threads <= 1024
    if plan.per:                                     # the C entry's own checks
        assert plan.per in (1, 2, 4, 8) and plan.per >= min(cq.MIN_PER, MAX_PER)
        assert plan.per * tpr * plan.vec >= D
    q_count, s_count = covered(plan, rows, D)
    assert (q_count == 1).all() and (s_count == 1).all()


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
def test_every_model_leaf_takes_the_vector_branch(arch, dtype):
    """Each gradient leaf's rows (``leaf_rows``, contiguous as the exchange
    hands them over) plan the 16-byte vector path, in either dtype."""
    for D in leaf_widths(arch):
        x = rows_of(D, dtype, 2, True)
        plan = cq.quantize_plan(x)
        assert plan.per > 0, (arch, D, plan)


@pytest.mark.parametrize("D,dtype,aligned,want", [
    (64, torch.bfloat16, True, (4, 2, 128)),      # wq, wk, wv: two threads a row
    (2048, torch.bfloat16, True, (4, 64, 4)),     # w_down, wo, embed: four rows a block
    (8192, torch.bfloat16, True, (4, 256, 1)),    # w_gate, w_up: 256 threads, 4 vectors each
    (8192, torch.float32, True, (8, 256, 1)),
    (768, torch.bfloat16, True, (4, 32, 8)),      # mamba2's d_model
    (24, torch.bfloat16, True, (4, 1, 256)),      # 3 vectors a row, one thread
    (16384, torch.float32, True, (0, 256, 1)),    # more than 8 vectors a thread: the scalar loop
    (257, torch.bfloat16, True, (0, 256, 1)),     # D not a multiple of the vector: the scalar loop
    (2048, torch.bfloat16, False, (0, 256, 1)),   # rows off 16 bytes: the scalar loop
])
def test_plan_shapes(D, dtype, aligned, want):
    x = rows_of(D, dtype, 1, aligned)
    plan = cq.quantize_plan(x)
    assert (plan.per, plan.tpr, plan.rpb) == want


def test_rmsnorm_keeps_its_own_plan():
    """The shared rule at rmsnorm's default (one vector a thread and up)
    is the one ``tests/test_torch_rmsnorm_plan.py`` pins; the quantize asks
    for at least MIN_PER vectors a thread."""
    from repro_torch.kernels import rmsnorm as rk
    assert rk.rmsnorm_plan(2048, 2, True) == row_plan(2048, 2, True) == (1, 256, 1, 8)
    assert row_plan(2048, 2, True, cq.MIN_PER) == (4, 64, 4, 8)


# ---------------------------------------------------------------------------
# the epilogue
# ---------------------------------------------------------------------------

def test_mirror_constants_match_the_kernel():
    src = CU.read_text()
    assert re.search(r"kRound = 12582912\.0f;", src) and float(ROUND) == 12582912.0
    assert re.search(r"kTieGuard = 0x1p-12f;", src) and float(TIE_GUARD) == 2.0 ** -12
    assert float(TIE_GUARD) >= 12 * BOUND


def scale_of(xf: torch.Tensor) -> torch.Tensor:
    """The kernel's per-row scale: max(NaN-propagating absmax, 1e-12) / 127 in fp32."""
    absmax = torch.amax(xf.abs(), dim=-1, keepdim=True)
    return torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, 127.0)


def quotient_mirror(xf: torch.Tensor, s: torch.Tensor, guard: bool = True) -> torch.Tensor:
    """``quantize_one`` up to the clamp: t = x * (1/s), or the IEEE x / s
    where t lies within the tie guard of a half-integer."""
    r = torch.ones_like(s) / s                       # correctly rounded, as __frcp_rn
    t = xf * r
    k = (t + ROUND) - ROUND                          # rint(t), half to even
    if guard:
        t = torch.where((t - k).abs() >= 0.5 - TIE_GUARD, xf / s, t)
    return t


def epilogue_mirror(xf: torch.Tensor, s: torch.Tensor, guard: bool = True) -> torch.Tensor:
    """The kernel's q: the NaN test, the clamp, then c + 1.5 * 2**23 and its
    low byte."""
    t = quotient_mirror(xf, s, guard)
    c = torch.where(t.isnan(), torch.zeros_like(t), t.clamp(-127.0, 127.0))
    word = (c + ROUND).view(torch.int32)
    return (word & 0xFF).to(torch.uint8).view(torch.int8)


def ieee_q(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """IEEE division, round half to even, clip; a NaN quotient gives 0."""
    v = torch.round(xf / s)
    return torch.where(v.isnan(), torch.zeros_like(v), v.clamp(-127, 127)).to(torch.int8)


def near_ties(seed: int, rows: int = 64, cols: int = 256) -> np.ndarray:
    """fp32 rows, each with its own absmax (column 0; 1e-13 to 3e38, none a
    power of two times 127), whose other entries are the 0-4 ulp
    neighbours of (k + 0.5) * scale."""
    rng = np.random.default_rng(seed)
    absmax = (10.0 ** rng.uniform(-13, 38.4, rows)).astype(np.float32)
    absmax[:4] = [np.finfo(np.float32).max, 3.0e38, 1.1e-12, 1e-13]
    s = np.maximum(absmax, np.float32(1e-12)) / np.float32(127)
    k = rng.integers(-126, 126, (rows, cols)).astype(np.float32)
    x = ((k + np.float32(0.5)) * s[:, None]).astype(np.float32)
    off = rng.integers(-4, 5, (rows, cols))
    for _ in range(4):
        x = np.where(off != 0, np.nextafter(x, np.where(off > 0, np.inf, -np.inf).astype(np.float32)),
                     x).astype(np.float32)
        off = off - np.sign(off)
    x[:, 0] = absmax
    return x


def exact_ties(cols: int = 256) -> np.ndarray:
    """x / scale exactly k + 0.5 (scale 2**-7), a zero row, a row of
    +-absmax."""
    ties = np.resize((np.arange(-127, 127) + 0.5) * 2.0 ** -7, (3, cols))
    ties[:, 0] = 127 * 2.0 ** -7
    ties[1] *= -1
    signs = np.where(np.arange(cols) % 2 == 0, 3.25, -3.25)
    return np.concatenate([ties, np.zeros((1, cols)), signs[None]]).astype(np.float32)


def random_rows(seed: int, rows: int = 64, cols: int = 256) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, cols)) * 10.0 ** rng.uniform(-6, 3, (rows, 1))
            ).astype(np.float32)


def nonfinite_rows(cols: int = 256) -> np.ndarray:
    x = random_rows(5, 3, cols)
    x[0, cols // 2] = np.nan
    x[1, 0], x[1, -1] = np.inf, -np.inf
    x[2, 3] = -np.inf
    return x


CASES = {"random": lambda: random_rows(0), "exact ties": exact_ties,
         "near ties": lambda: near_ties(1), "near ties 2": lambda: near_ties(2),
         "non-finite": nonfinite_rows}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_matches_ieee_division_and_pallas(case, dtype):
    x = CASES[case]()
    """q from the mirror equals IEEE division and the plain version at the
    IEEE scale, and the Pallas kernel's q at the Pallas kernel's own scale:
    XLA on the CPU rounds max(absmax, 1e-12) / 127 an ulp away from the IEEE
    quotient on some rows (within the rtol 1e-6 hold), and at a near tie an
    ulp of scale moves q."""
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    xf = tx.float()                                  # bf16 -> fp32 is exact
    s = scale_of(xf)
    q = epilogue_mirror(xf, s)
    assert torch.equal(q, ieee_q(xf, s))
    tq, ts = ops.quantize_int8(tx)                  # the plain version the wrapper takes here
    assert torch.equal(q, tq)
    torch.testing.assert_close(ts, s, rtol=0, atol=0, equal_nan=True)
    pq, ps = RQ.quantize_int8(jnp.asarray(x, getattr(jnp, dtype)), interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=1e-6)   # NaN, Inf in place
    q_at_ps = epilogue_mirror(xf, torch.from_numpy(np.array(ps)))
    np.testing.assert_array_equal(q_at_ps.numpy(), np.asarray(pq))


def test_near_ties_need_the_guard_and_stay_inside_its_bound():
    """Without the guard, t = x * (1/s) rounds to the other integer at some
    near ties (so the cases above reach it); |t - RN(x / s)| stays within
    the header's bound, which the guard exceeds twelve times over."""
    misses = 0
    for seed in (1, 2, 3):
        xf = torch.from_numpy(near_ties(seed))
        s = scale_of(xf)
        misses += int((epilogue_mirror(xf, s, guard=False) != ieee_q(xf, s)).sum())
        t = quotient_mirror(xf, s, guard=False)
        assert float((t.double() - (xf / s).double()).abs().max()) <= BOUND
    assert misses > 0


def test_cpu_dispatch_counts_no_launch_and_no_branch():
    ops.reset_launch_counts()
    x = torch.from_numpy(random_rows(7, 8, 64)).bfloat16()
    q, s = ops.quantize_int8(x)
    assert q.dtype == torch.int8 and tuple(s.shape) == (8, 1)
    counts = ops.launch_counts()
    assert counts["quantize_int8"] == 0
    assert counts["quantize_int8_vec"] == counts["quantize_int8_scalar"] == 0
