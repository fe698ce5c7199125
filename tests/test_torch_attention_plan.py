"""The host-side plans of the port's attention kernels, on the CPU.

The split-K decode kernel and the tensor-core flash kernel run only on the
card (``chip_smoke.py`` holds them against their plain versions there).
What decides their work is host Python, checked here:

- ``decode_attention.split_plan`` cuts the cache into splits from the cache
  length, B*K and the SM count alone (never from ``kv_len``), and covers
  every key of every (b, KV head) exactly once;
- split-then-merge on that plan -- each split's (m, l, acc) partial with
  empty splits left as (-1e30, 0), merged in split order in fp32, the
  kernel's algorithm written in plain PyTorch -- equals the JAX package's
  ``repro.kernels.ref.decode_attention`` within 2e-5 (fp32,
  ``tests/test_kernels.py``'s tolerance);
- the flash wrapper's 16-byte row rule: which strided inputs the kernel
  reads in place and which it gets as a copy;
- the scratch pool of the decode kernels and the SSD scan only grows, and
  an outgrown buffer stays alive for a CUDA graph that still addresses it.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels.ref import NEG_INF

H100_SMS = 132


# ---------------------------------------------------------------------------
# the split plan
# ---------------------------------------------------------------------------

def test_split_plan_reads_no_kv_len():
    assert list(inspect.signature(dk.split_plan).parameters) == ["S", "B", "K", "n_sm"]


@pytest.mark.parametrize("B,K,n_sm", [(2, 8, H100_SMS), (8, 8, H100_SMS), (1, 1, H100_SMS),
                                      (64, 32, H100_SMS), (3, 2, 16)])
def test_split_plan_covers_every_key_once(B, K, n_sm):
    for S in range(1, 4097):
        split_len, n_split = dk.split_plan(S, B, K, n_sm)
        assert split_len % dk.SPLIT_UNIT == 0 and split_len > 0 and n_split >= 1
        cover = np.zeros(S, np.int32)
        for s in range(n_split):
            lo, hi = s * split_len, min((s + 1) * split_len, S)
            assert lo < hi                       # no split lies wholly past the cache
            cover[lo:hi] += 1
        assert (cover == 1).all(), S


@pytest.mark.parametrize("S,B,K,want", [(256, 2, 8, (32, 8)), (4096, 2, 8, (128, 32)),
                                        (256, 8, 8, (32, 8)), (0, 2, 8, (32, 1))])
def test_split_plan_at_the_main_shapes(S, B, K, want):
    """granite-3-2b's decode (B 2, K 8, 256-slot cache): 8 splits of 32 keys,
    128 blocks on the 132 SMs, not 16; a 4096-slot cache: 512 blocks."""
    assert dk.split_plan(S, B, K, H100_SMS) == want


# ---------------------------------------------------------------------------
# split-then-merge on the plan against the JAX package's oracle
# ---------------------------------------------------------------------------

def split_merge(q, k, v, kv_len, split_len, n_split):
    """The decode kernel's algorithm in plain fp32 PyTorch: one (m, l, acc)
    partial per split and query head, then the merge in split order."""
    B, K, G, D = q.shape
    S = k.shape[2]
    parts = []
    for s in range(n_split):
        lo, hi = s * split_len, min((s + 1) * split_len, S)
        sc = torch.einsum("bkgd,bksd->bkgs", q.float(), k[:, :, lo:hi].float()) * D ** -0.5
        valid = torch.arange(lo, hi)[None, :] < kv_len[:, None]            # (B, n)
        sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        acc = torch.einsum("bkgs,bksd->bkgd", p, v[:, :, lo:hi].float())
        empty = ~valid.any(-1)[:, None, None]                               # reads nothing
        parts.append((torch.where(empty, NEG_INF, m), torch.where(empty, 0.0, p.sum(-1)), acc))
    live = [l > 0 for _, l, _ in parts]
    M = torch.full(parts[0][0].shape, NEG_INF)
    for (m, _, _), ok in zip(parts, live):
        M = torch.where(ok, torch.maximum(M, m), M)
    L, out = torch.zeros_like(M), torch.zeros(B, K, G, D)
    for (m, l, acc), ok in zip(parts, live):
        w = torch.where(ok, torch.exp(m - M), 0.0)
        L = L + l * w
        out = out + torch.where(ok[..., None], w[..., None] * acc, 0.0)
    return out / torch.clamp(L, min=1e-30)[..., None]


def _pair(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("B,K,G,S,D", [(2, 8, 4, 256, 64), (2, 2, 4, 300, 16),
                                       (1, 1, 8, 4096, 16), (3, 2, 1, 70, 128)])
@pytest.mark.parametrize("lens", ["one", "full", "boundary", "past_boundary", "random"])
def test_split_merge_matches_jax_ref(B, K, G, S, D, lens):
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s) for s in
                                    [(B, K, G, D), (B, K, S, D), (B, K, S, D)])
    split_len, n_split = dk.split_plan(S, B, K, H100_SMS)
    kv = {"one": np.ones(B), "full": np.full(B, S),
          "boundary": np.full(B, min(S, split_len)),           # ends on a split boundary
          "past_boundary": np.full(B, min(S, split_len + 1)),  # one key into the next split
          "random": rng.integers(1, S + 1, B)}[lens].astype(np.int32)
    got = split_merge(qt, kt, vt, torch.from_numpy(kv), split_len, n_split)
    want = jref.decode_attention(qj, kj, vj, jnp.asarray(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the 16-byte row rule of the flash (bf16) and decode kernels
# ---------------------------------------------------------------------------

def _model_layout(B=2, S=16, H=4, D=64, dtype=torch.bfloat16):
    """(B,H,S,D) view of a (B,S,H,D) tensor: what ops.flash_attention hands over."""
    return torch.randn(B, S, H, D).to(dtype).transpose(1, 2)


@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_model_layout_goes_in_place(D, dtype):
    t = _model_layout(D=D, dtype=dtype)
    assert _build.rows_aligned(t) and _build.aligned_rows(t) is t
    cache = torch.zeros(2, 256, 8, D, dtype=dtype)
    assert _build.aligned_rows(cache[:, :136].transpose(1, 2)).data_ptr() == cache.data_ptr()


@pytest.mark.parametrize("case", ["base_offset", "head_stride", "seq_stride", "last_stride"])
def test_rows_off_16_bytes_are_copied(case):
    B, S, H, D = 2, 16, 4, 64
    if case == "base_offset":         # a view one element into its storage
        t = torch.randn(B, S, H * D + 1).to(torch.bfloat16)[..., 1:].unflatten(-1, (H, D))
    elif case == "head_stride":       # heads 66 elements (132 bytes) apart
        t = torch.randn(B, S, H, D + 2).to(torch.bfloat16)[..., :D]
    elif case == "seq_stride":        # positions H*D + 4 elements apart
        t = torch.randn(B, S, H * D + 4).to(torch.bfloat16)[..., :H * D].unflatten(-1, (H, D))
    else:                             # head dim not contiguous
        t = torch.randn(B, S, D, H).to(torch.bfloat16).transpose(-1, -2)
    t = t.transpose(1, 2)
    assert not _build.rows_aligned(t)
    c = _build.aligned_rows(t)
    assert c is not t and c.is_contiguous() and _build.rows_aligned(c) and torch.equal(c, t)


def test_size_one_dims_do_not_count():
    t = torch.randn(1, 40, 1, 64).to(torch.bfloat16)[:, 3:, :, :]   # offset 3 rows of 128 B
    t = t.as_strided((1, 1, 37, 64), (7, 5, 64, 1), t.storage_offset())
    assert _build.rows_aligned(t)


def test_flash_kernel_inputs_by_dtype():
    """bf16 (tensor cores) needs 16-byte rows; fp32 (CUDA cores) only a unit
    last stride, so an fp32 view off 16 bytes stays in place."""
    q = torch.randn(2, 16, 4 * 64 + 2)[..., 1:257].unflatten(-1, (4, 64)).transpose(1, 2)
    k = v = torch.randn(2, 16, 2, 64).transpose(1, 2)
    assert not _build.rows_aligned(q)
    assert fk.kernel_inputs(q, k, v)[0] is q
    kb, vb = k.to(torch.bfloat16), v.to(torch.bfloat16)
    qb = torch.randn(2, 16, 4 * 64 + 2).to(torch.bfloat16)[..., 1:257].unflatten(
        -1, (4, 64)).transpose(1, 2)
    got = fk.kernel_inputs(qb, kb, vb)
    assert got[0] is not qb and _build.rows_aligned(got[0]) and torch.equal(got[0], qb)
    assert got[1] is kb and got[2] is vb


@pytest.mark.parametrize("asks, sizes", [
    # decode_attention's and mamba_step's (int32 counters, fp32 floats)
    ([(8, 1000), (8, 1000), (8, (1 << 16) + 1), (300, 3 << 17)],
     [(256, 1 << 16), (256, 1 << 16), (256, 1 << 17), (512, 3 << 17)]),
    # the SSD scan's tensor-core branch, (B, H, P, N, chunks, L) through
    # ssd_scan.tc_scratch: three heads of 16 in one chunk of 64 (its fp32
    # part ends off 16 bytes), mamba2-130m's prefill at B 2, S 1024, head dim
    # 128 in two slices, S 1280
    ([(1, 3, 16, 16, 1, 64), (2, 24, 64, 128, 4, 256), (2, 4, 128, 64, 3, 128),
      (2, 24, 64, 128, 5, 256)],
     [(256, 1 << 16), (256, 3244224), (256, 3244224), (256, 2 * 3244224)]),
], ids=["decode", "ssd_scan"])
def test_decode_scratch_grows_by_doubling_and_keeps_what_it_outgrew(asks, sizes):
    """The pool the decode kernels and the SSD scan share
    (``_build.scratch``): a buffer that holds the ask is reused, a growth
    at least doubles, and an outgrown buffer is kept for a CUDA graph that
    still addresses it; the scan's bf16 regions start on 16 bytes past its
    fp32 part and end inside the floats it asks for."""
    state = [132, torch.zeros(0, dtype=torch.int32), torch.empty(0), []]
    for ask, want in zip(asks, sizes):
        if len(ask) == 6:
            B, H, P, N, nc, L = ask
            n_ints, n_floats, hi, lo = sk.tc_scratch(*ask)
            n_states = B * H * nc * P * N
            assert n_ints == B * H * sk.tc_slices(P) and hi % 16 == 0 and lo % 16 == 0
            assert hi >= 4 * (n_states + B * H * nc * (2 * L + sk.tc_slices(P)))
            assert lo >= hi + 2 * n_states and 4 * n_floats >= lo + 2 * n_states
        else:
            n_ints, n_floats = ask
        before = state[1], state[2]
        counter, part = _build.grow_scratch(state, n_ints, n_floats)
        assert (counter.numel(), part.numel()) == want
        for old, new, n in zip(before, (counter, part), (n_ints, n_floats)):
            assert (new is old) == (old.numel() >= n)
            assert new is old or any(t is old for t in state[3])
