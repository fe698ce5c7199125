"""The port's plain kernel versions against the JAX package's oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode.

Inputs come from a numpy seed and are handed to both frameworks; bf16
inputs are rounded once in numpy-float32 -> bf16 by each framework (both
round to nearest even, so both see the same values).  Tolerances are those
of ``tests/test_kernels.py``: 2e-5 in float32, 2e-2 in bfloat16, 1e-5 for
rmsnorm.  The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds them against these plain versions there); here the wrappers' CPU
dispatch, layouts and counters are checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rk

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 2e-5, BF16: 2e-2}


def _pair(rng, shape, dtype):
    """Same values as a jax array and a torch tensor."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _close(torch_out, jax_out, tol):
    np.testing.assert_allclose(torch_out.float().numpy(), np.asarray(jax_out, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_DIVISIBLE = [
    (2, 4, 2, 128, 128, 64, F32),
    (1, 8, 2, 128, 256, 128, F32),
    (1, 4, 4, 128, 128, 64, BF16),
    (1, 4, 1, 128, 256, 16, F32),     # MQA, reduced-config head_dim
]


@pytest.mark.parametrize("B,H,K,Sq,Sk,D,dtype", FLASH_DIVISIBLE)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_vs_jax_ref(B, H, K, Sq, Sk, D, dtype, causal):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in
                                    [(B, H, Sq, D), (B, K, Sk, D), (B, K, Sk, D)])
    _close(ref.flash_attention(qt, kt, vt, causal=causal),
           jref.flash_attention(qj, kj, vj, causal=causal), TOL[dtype])


@pytest.mark.parametrize("B,H,K,Sq,Sk,D,dtype", FLASH_DIVISIBLE[:3])
def test_flash_plain_vs_pallas_interpret(B, H, K, Sq, Sk, D, dtype):
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in
                                    [(B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)])
    _close(ops.flash_attention(qt, kt, vt, causal=True),
           jops.flash_attention(qj, kj, vj, causal=True, impl="pallas"), TOL[dtype])


@pytest.mark.parametrize("Sq,Sk,causal", [(77, 77, True), (37, 53, False), (19, 45, True),
                                          (1, 9, True), (33, 33, False)])
def test_flash_plain_ragged_vs_jax_ref(Sq, Sk, causal):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, F32) for s in
                                    [(2, 4, Sq, 64), (2, 2, Sk, 64), (2, 2, Sk, 64)])
    _close(ref.flash_attention(qt, kt, vt, causal=causal),
           jref.flash_attention(qj, kj, vj, causal=causal), TOL[F32])


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,K,G,S,D,dtype", [
    (2, 2, 4, 512, 64, F32),
    (1, 4, 1, 256, 128, F32),
    (3, 2, 8, 128, 16, F32),
    (2, 8, 4, 256, 64, BF16),         # granite-3-2b's grouping
])
@pytest.mark.parametrize("lens", ["random", "one", "full"])
def test_decode_plain_vs_jax(B, K, G, S, D, dtype, lens):
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in
                                    [(B, K, G, D), (B, K, S, D), (B, K, S, D)])
    kv = {"random": rng.integers(1, S + 1, B), "one": np.ones(B),
          "full": np.full(B, S)}[lens].astype(np.int32)
    got = ref.decode_attention(qt, kt, vt, torch.from_numpy(kv))
    _close(got, jref.decode_attention(qj, kj, vj, jnp.asarray(kv)), TOL[dtype])
    if dtype == F32:      # the Pallas kernel asserts S % bk == 0: S is a multiple of 128
        _close(got, jops.decode_attention(qj.reshape(B, 1, K * G, D),
                                          kj.transpose(0, 2, 1, 3), vj.transpose(0, 2, 1, 3),
                                          jnp.asarray(kv), impl="pallas").reshape(B, K, G, D),
               TOL[dtype])


@pytest.mark.parametrize("S", [37, 100])
def test_decode_plain_ragged_cache_vs_jax_ref(S):
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, F32) for s in
                                    [(2, 2, 4, 16), (2, 2, S, 16), (2, 2, S, 16)])
    kv = np.array([1, S], np.int32)
    _close(ref.decode_attention(qt, kt, vt, torch.from_numpy(kv)),
           jref.decode_attention(qj, kj, vj, jnp.asarray(kv)), TOL[F32])


def test_decode_model_layout_wrapper_vs_jax_ops():
    """ops.decode_attention views the (B,S,K,D) cache in place; same result
    as the JAX package's layout wrapper."""
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, F32) for s in
                                    [(2, 1, 8, 16), (2, 40, 2, 16), (2, 40, 2, 16)])
    kv = np.array([7, 40], np.int32)
    _close(ops.decode_attention(qt, kt, vt, torch.from_numpy(kv)),
           jops.decode_attention(qj, kj, vj, jnp.asarray(kv), impl="ref"), TOL[F32])


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(37, 512), (256, 128), (8, 2048), (1, 256), (2, 5, 64)])
def test_rmsnorm_plain_vs_jax(shape):
    rng = np.random.default_rng(6)
    (xj, xt), (sj, st) = _pair(rng, shape, F32), _pair(rng, shape[-1:], F32)
    got = ref.rmsnorm(xt, st)
    _close(got, jref.rmsnorm(xj, sj), 1e-5)
    _close(got, jops.rmsnorm(xj, sj, impl="pallas"), 1e-5)


def test_rmsnorm_plain_bf16_vs_jax_ref():
    rng = np.random.default_rng(7)
    (xj, xt), (sj, st) = _pair(rng, (16, 256), BF16), _pair(rng, (256,), F32)
    _close(ref.rmsnorm(xt, st), jref.rmsnorm(xj, sj), TOL[BF16])


# ---------------------------------------------------------------------------
# dispatch and counters
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    x, s = torch.randn(3, 64), torch.randn(64)
    q, k = torch.randn(1, 5, 4, 16), torch.randn(1, 5, 2, 16)
    assert rk.rmsnorm_plain is ref.rmsnorm and fk.flash_attention_plain is ref.flash_attention
    assert dk.decode_attention_plain is ref.decode_attention
    assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm(x, s))
    assert torch.equal(ops.flash_attention(q, k, k),
                       ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                           k.transpose(1, 2)).transpose(1, 2))
    kv = torch.tensor([3])
    assert torch.equal(ops.decode_attention(q[:, :1], k, k, kv),
                       ref.decode_attention(q[:, 0].reshape(1, 2, 2, 16), k.transpose(1, 2),
                                            k.transpose(1, 2), kv).reshape(1, 1, 4, 16))
    qi, sc = ops.quantize_int8(x)
    assert torch.equal(ops.dequantize_int8(qi, sc), ref.dequantize_int8(*ref.quantize_int8(x)))
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
                                   "ssd_scan": 0, "moe_experts": 0, "quantize_int8": 0,
                                   "dequantize_int8": 0, "mamba_step": 0, "moe_route": 0,
                                   "moe_combine": 0, "ssd_scan_tc": 0, "ssd_scan_simt": 0,
                                   "quantize_int8_vec": 0, "quantize_int8_scalar": 0}


@pytest.mark.parametrize("rc, capturing, names, counted", [
    (0, False, ("rmsnorm",), {"rmsnorm": 1}),
    (0, False, ("ssd_scan", "ssd_scan_tc"), {"ssd_scan": 1, "ssd_scan_tc": 1}),
    (0, False, ("quantize_int8", "quantize_int8_scalar"),
     {"quantize_int8": 1, "quantize_int8_scalar": 1}),
    (-1, False, ("ssd_scan", "ssd_scan_simt"), "unsupported arguments"),
    (700, False, ("decode_attention",), "cudaError_t 700"),
    (0, True, ("ssd_scan", "ssd_scan_tc"), {}),
], ids=["kernel", "kernel-and-branch", "quantize-branch", "refused", "failed", "capturing"])
def test_launch_calls_the_entry_raises_on_its_rc_and_counts_outside_captures(
        monkeypatch, rc, capturing, names, counted):
    """``_build.launch`` on a stand-in C entry: a zero rc counts the kernel
    and its branch; a negative or positive rc raises and counts nothing; a
    launch while the stream is being captured counts nothing."""
    calls = []

    def entry(*args):
        calls.append(args)
        return rc
    monkeypatch.setitem(_build._fns, "avec_stand_in", entry)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    ops.reset_launch_counts()
    if isinstance(counted, str):
        with pytest.raises(RuntimeError, match=f"{'/'.join(names)} failed to launch: {counted}"):
            _build.launch("avec_stand_in", [], (3, 5), *names)
        counted = {}
    else:
        _build.launch("avec_stand_in", [], (3, 5), *names)
    assert calls == [(3, 5)]
    assert ops.launch_counts() == {k: counted.get(k, 0) for k in ops.launch_counts()}


@pytest.mark.parametrize("capturing", [False, True], ids=["eager", "capturing"])
def test_a_kernel_without_a_c_entry_counts_through_the_same_counter(monkeypatch, capturing):
    """``moe_experts`` (no C entry) counts with ``_build.count`` alone."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing)
    ops.reset_launch_counts()
    _build.count("moe_experts")
    assert ops.launch_counts()["moe_experts"] == int(not capturing)
    assert sum(ops.launch_counts().values()) == int(not capturing)


def test_kernel_paths_refuse_cpu_tensors():
    x, s = torch.randn(3, 64), torch.randn(64)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        ops.rmsnorm(x, s, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        rk.rmsnorm_cuda(x, s)
    q = torch.randn(1, 2, 4, 16)
    with pytest.raises(ValueError, match="CUDA device"):
        fk.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA device"):
        dk.decode_attention_cuda(q, q, q, torch.tensor([2]))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.rmsnorm(x, s, impl="pallas")


def test_force_impl_scopes_the_plain_versions():
    x, s = torch.randn(3, 64), torch.randn(64)
    with ops.force_impl("ref"):
        assert torch.equal(ops.rmsnorm(x, s), ref.rmsnorm(x, s))
        with pytest.raises(RuntimeError):
            ops.rmsnorm(x, s, impl="cuda")
    assert ops._forced is None
