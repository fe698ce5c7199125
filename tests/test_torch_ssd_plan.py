"""The tensor-core SSD scan's decomposition (``csrc/ssd_scan.cu``, the
``chunk_state_kernel`` / ``chunk_scan_kernel`` pair) in plain PyTorch,
against the JAX package: the Pallas ``ssd_scan_kernel`` in interpret mode
and ``ssd_sequential``.

The decomposition is the published SSD one (chunk states, state passing,
chunk scan), written here twice: with fp32 operands, and with the kernels'
operand rounding emulated -- x, B and C in bf16 (exact on the tensor
cores), and each fp32 operand of a product (the decayed scores, x * w, the
state entering a chunk) as a bf16 pair hi + lo, with y rounded to bf16.
Tolerances are those ``chip_smoke.py`` holds the kernels to on the card: y
within ``2e-4 * (max|y| + 1)`` (plus one bf16 ulp, rtol 1e-2, where y is
bf16) and the final state within ``2e-4 * (max|state| + 1)``.  A single
bf16 per fp32 operand does not hold at mamba2-130m's chunk shape, which is
why the kernels take the pairs.  The kernels split a head into slices of at
most 64 columns of P (jamba-1.5-large's head dim 128 is two), each block
computing its slice alone: the decomposition on each slice gives that
slice of y and of the state.  Also here: the host's branch rule between
the tensor-core and CUDA-core kernels, the slice rule, and the chunk rule.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssd as jssd
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as sk


def _inputs(B, S, H, P, G, N, seed=0):
    """x, dt (post-softplus), A (negative), B, C as numpy float32 in the
    distribution of ``chip_smoke.py``'s SSD cases; x, B and C rounded to
    bf16 (the tensor-core branch's inputs), so both frameworks see the same
    values."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    bf = [torch.from_numpy(a).bfloat16().float().numpy() for a in (x, Bm, Cm)]
    return bf[0], dt, A, bf[1], bf[2]


def _hi_lo(v):
    """v as the kernels feed it to the tensor cores: hi = bf16(v), lo =
    bf16(v - hi); hi + lo is exact in fp32 (at most 17 significant bits)."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


def _one_bf16(v):
    return v.bfloat16().float()


def ssd_chunk_parallel(x, dt, A, Bm, Cm, L, operand=None):
    """The kernels' decomposition on fp32 tensors (S zero-padded to whole
    chunks, as the kernels read positions past S as zero).  ``operand``
    rounds each fp32 product operand (None: fp32 throughout).  Returns (y
    (B,S,H,P) fp32, final state (B,H,P,N) fp32)."""
    rnd = operand or (lambda v: v)
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep, pad = h // g, (-s) % L
    nc = (s + pad) // L
    xc = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)).reshape(b, nc, L, h, p)
    dtc = torch.nn.functional.pad(dt, (0, 0, 0, pad)).reshape(b, nc, L, h)
    Bc = torch.nn.functional.pad(Bm, (0, 0, 0, 0, 0, pad)).reshape(b, nc, L, g, n)
    Cc = torch.nn.functional.pad(Cm, (0, 0, 0, 0, 0, pad)).reshape(b, nc, L, g, n)
    Bh = Bc.repeat_interleave(rep, dim=3)
    Ch = Cc.repeat_interleave(rep, dim=3)
    cum = torch.cumsum(dtc * A, dim=2)                               # (b,nc,L,h)
    last = cum[:, :, -1:, :]

    # 1. chunk states S_c = (x * w)^T B and decays exp(cum_last)
    w = torch.exp(last - cum) * dtc
    S_c = torch.einsum("bclhp,bclhn->bchpn", rnd(xc * w[..., None]), Bh)
    decay = torch.exp(last[:, :, 0, :])                             # (b,nc,h)

    # 2. state passing, in fp32: in(0) = 0, in(c+1) = in(c) * decay(c) + S_c
    st = torch.zeros(b, h, p, n)
    entering = []
    for c in range(nc):
        entering.append(st)
        st = st * decay[:, c, :, None, None] + S_c[:, c]
    ins = torch.stack(entering, dim=1)                               # (b,nc,h,p,n)

    # 3. chunk scan, tile by tile: C_i B_j^T for j-tiles up to the diagonal,
    # exp(cum_i - cum_j) only where j <= i, the inter-chunk term from in(c)
    cb = torch.einsum("bclhn,bcmhn->bchlm", Ch, Bh)
    cum_h = cum.transpose(2, 3)                                      # (b,nc,h,L)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    diff = (cum_h[..., :, None] - cum_h[..., None, :]).masked_fill(~causal, float("-inf"))
    scores = cb * torch.exp(diff) * dtc.transpose(2, 3)[..., None, :]
    y = torch.einsum("bchlm,bcmhp->bclhp", rnd(scores), xc)
    inter = torch.einsum("bclhn,bchpn->bclhp", Ch, rnd(ins))
    y = inter * torch.exp(cum)[..., None] + y
    return y.reshape(b, nc * L, h, p)[:, :s], st


def _hold(y, st, y_want, st_want, bf16_y):
    """chip_smoke.py's hold on the kernels -> (y ok, state ok)."""
    y_want, st_want = np.asarray(y_want, np.float32), np.asarray(st_want, np.float32)
    tol_y = 2e-4 * (np.abs(y_want).max() + 1.0) + (1e-2 * np.abs(y_want) if bf16_y else 0.0)
    tol_s = 2e-4 * (np.abs(st_want).max() + 1.0)
    return (bool((np.abs(y - y_want) <= tol_y).all()),
            bool((np.abs(st - st_want) <= tol_s).all()))


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().float().numpy()


CASES = [                 # (B, S, H, P, G, N, chunk)
    (1, 512, 2, 64, 1, 128, 256),   # mamba2-130m's widths, two chunks
    (1, 512, 2, 128, 1, 128, 256),  # jamba-1.5-large's widths (P 128: two slices), two chunks
    (2, 300, 4, 128, 2, 64, 128),   # P 128, ragged S, G > 1
    (2, 300, 4, 64, 2, 32, 128),    # ragged S (last chunk 44), G > 1
    (1, 1024, 2, 16, 1, 16, 64),    # 16 chunks: the state passes along 16
    (2, 64, 4, 32, 4, 64, 64),      # one chunk (nc 1), G == H
    (1, 37, 2, 16, 1, 32, 64),      # S < chunk: L 37 (a CUDA-core shape; the same math)
    (2, 1, 2, 16, 1, 16, 64),       # S 1
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", CASES)
@pytest.mark.parametrize("rounding", ["fp32", "kernel"])
def test_chunk_parallel_vs_pallas_interpret_and_sequential(B, S, H, P, G, N, chunk, rounding):
    """Both versions of the decomposition hold against the Pallas kernel
    (interpret mode) and the sequential recurrence at the card's tolerance."""
    x, dt, A, Bm, Cm = _inputs(B, S, H, P, G, N, seed=S + H)
    L = ops.ssd_chunk_len(S, chunk)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y, st = ssd_chunk_parallel(*t, L, operand=_hi_lo if rounding == "kernel" else None)
    y = y.bfloat16().float().numpy() if rounding == "kernel" else y.numpy()
    j = [jnp.asarray(a) for a in (x, dt, A, Bm, Cm)]
    for y_want, st_want in (jops.ssd_scan(*j, chunk=chunk, impl="pallas"), jssd.ssd_sequential(*j)):
        if rounding == "kernel":
            y_want = _bf16(y_want)
        assert _hold(y, st.numpy(), y_want, st_want, bf16_y=rounding == "kernel") == (True, True)


def test_one_bf16_per_operand_breaks_the_hold_and_pairs_keep_it():
    """At mamba2-130m's chunk shape (L 256, P 64, N 128), rounding each fp32
    operand to a single bf16 puts y outside the hold; the hi/lo pairs the
    kernels use keep it inside, with room to spare."""
    x, dt, A, Bm, Cm = _inputs(1, 512, 2, 64, 1, 128, seed=11)
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    y_want, st_want = jops.ssd_scan(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm)), chunk=256,
                                    impl="pallas")
    y_want = np.asarray(y_want, np.float32)
    y1, st1 = ssd_chunk_parallel(*t, 256, operand=_one_bf16)
    y2, st2 = ssd_chunk_parallel(*t, 256, operand=_hi_lo)
    # before y's own rounding to bf16: the error the products add
    err1 = np.abs(y1.numpy() - y_want).max() / (np.abs(y_want).max() + 1.0)
    err2 = np.abs(y2.numpy() - y_want).max() / (np.abs(y_want).max() + 1.0)
    assert err1 > 2e-4 > 10 * err2
    held = _hold(y1.bfloat16().float().numpy(), st1.numpy(), _bf16(y_want), st_want, True)
    assert held[0] is False
    assert _hold(y2.bfloat16().float().numpy(), st2.numpy(), _bf16(y_want), st_want, True) == (
        True, True)


@pytest.mark.parametrize("dtype,P,N,S,chunk,tc", [
    (torch.bfloat16, 64, 128, 1024, 256, True),     # mamba2-130m's prefill and score
    (torch.bfloat16, 64, 128, 4096, 256, True),     # 16 chunks
    (torch.bfloat16, 64, 128, 300, 256, True),      # ragged last chunk: L stays 256
    (torch.bfloat16, 32, 64, 128, 64, True),
    (torch.bfloat16, 16, 16, 200, 64, True),
    (torch.float32, 64, 128, 1024, 256, False),     # fp32: TF32 would break the hold
    (torch.bfloat16, 16, 16, 37, 8, False),         # the reduced configs: L 8
    (torch.bfloat16, 64, 128, 37, 256, False),      # S < chunk: L 37
    (torch.bfloat16, 64, 128, 1, 256, False),       # S 1: L 1
    (torch.bfloat16, 128, 64, 256, 256, True),      # P 128: two slices of 64
    (torch.bfloat16, 128, 128, 1024, 256, True),    # jamba-1.5-large's prefill and score
    (torch.bfloat16, 96, 128, 256, 64, True),       # slices of 64 and 32
    (torch.bfloat16, 144, 128, 1024, 256, False),   # P over 128
    (torch.bfloat16, 256, 128, 1024, 256, False),
    (torch.bfloat16, 64, 24, 256, 256, False),      # N not a multiple of 16
    (torch.bfloat16, 64, 128, 8192, 4096, False),   # L over 2048
])
def test_branch_rule(dtype, P, N, S, chunk, tc):
    assert sk.tensor_core_branch(dtype, P, N, ops.ssd_chunk_len(S, chunk)) is tc


@pytest.mark.parametrize("P,slices", [(16, 1), (48, 1), (64, 1), (80, 2), (96, 2), (128, 2)])
def test_tc_slices(P, slices):
    """A block takes at most 64 columns of P; the last slice the rest."""
    assert sk.TC_SLICE_P == 64 and sk.tc_slices(P) == slices
    assert (slices - 1) * sk.TC_SLICE_P < P <= slices * sk.TC_SLICE_P


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", [(1, 512, 2, 128, 1, 128, 256),
                                               (2, 300, 4, 96, 2, 64, 128)])
def test_p_slices_are_independent(B, S, H, P, G, N, chunk):
    """The premise of the kernels' slices: the decomposition on the
    columns p0 .. p0 + 63 of x alone gives those columns of y and rows of
    the final state (in the kernels' operand rounding), so two blocks of
    one head need nothing from each other."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a) for a in _inputs(B, S, H, P, G, N, seed=P))
    L = ops.ssd_chunk_len(S, chunk)
    y, st = ssd_chunk_parallel(x, dt, A, Bm, Cm, L, operand=_hi_lo)
    w = sk.TC_SLICE_P
    parts = [ssd_chunk_parallel(x[..., p0:p0 + w], dt, A, Bm, Cm, L, operand=_hi_lo)
             for p0 in range(0, P, w)]
    assert len(parts) == sk.tc_slices(P)
    tol_y = 1e-6 * (float(y.abs().max()) + 1.0)
    tol_s = 1e-6 * (float(st.abs().max()) + 1.0)
    assert float((torch.cat([yp for yp, _ in parts], dim=-1) - y).abs().max()) <= tol_y
    assert float((torch.cat([sp for _, sp in parts], dim=2) - st).abs().max()) <= tol_s


def test_branch_counters_stay_zero_on_the_cpu():
    """A CPU tensor takes the plain version: neither branch counts."""
    ops.reset_launch_counts()
    t = [torch.from_numpy(a) for a in _inputs(1, 64, 2, 16, 1, 16)]
    t[0], t[3], t[4] = t[0].bfloat16(), t[3].bfloat16(), t[4].bfloat16()
    y, st = ops.ssd_scan(*t, chunk=64)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("ssd_scan_tc", "ssd_scan_simt", "quantize_int8_vec",
                                   "quantize_int8_scalar")} == {
        "ssd_scan_tc": 0, "ssd_scan_simt": 0, "quantize_int8_vec": 0, "quantize_int8_scalar": 0}
    assert counts["ssd_scan"] == 0


@pytest.mark.parametrize("S,chunk,L", [(1024, 256, 256), (4096, 256, 256), (300, 256, 256),
                                       (37, 64, 37), (1, 256, 1), (256, 256, 256)])
def test_chunk_len(S, chunk, L):
    assert ops.ssd_chunk_len(S, chunk) == L
