"""The port's SSD scan (``repro_torch.models.ssd`` and ``ops.ssd_scan`` on
the CPU) against the JAX package: ``repro.models.ssd`` and the Pallas
``ssd_scan_kernel`` in interpret mode.

Inputs come from a numpy seed and are handed to both frameworks.
Tolerances: atol 1e-4 for the SSD algorithms in float32 (the same sums in
another order); ``2e-4 * (max|y| + 1)`` for the scan's output and the final
state, as ``tests/test_kernels.py`` holds the Pallas kernel to the oracle.
The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``ref.ssd_scan`` there); here the wrapper's chunk rule, CPU
dispatch and counter are checked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import ssd as jssd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.models import ssd

TOL = 1e-4


def _inputs(B, S, H, P, G, N, seed=0):
    """x, dt (post-softplus), A (negative), B, C as numpy float32, in the
    distribution of ``tests/test_kernels.py``'s SSD cases."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    Bm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


def _scan_close(y, st, y_want, st_want):
    y_want, st_want = np.asarray(y_want, np.float32), np.asarray(st_want, np.float32)
    np.testing.assert_allclose(y.float().numpy(), y_want,
                               atol=2e-4 * (np.abs(y_want).max() + 1.0), rtol=0)
    np.testing.assert_allclose(st.numpy(), st_want,
                               atol=2e-4 * (np.abs(st_want).max() + 1.0), rtol=0)


SHAPES = [(2, 37, 4, 16, 1, 16), (1, 64, 4, 32, 2, 32), (2, 13, 8, 16, 4, 8)]


@pytest.mark.parametrize("B,S,H,P,G,N", SHAPES)
def test_ssd_sequential_vs_jax(B, S, H, P, G, N):
    j, t = _both(_inputs(B, S, H, P, G, N))
    y, st = ssd.ssd_sequential(*t)
    yj, stj = jssd.ssd_sequential(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("B,S,H,P,G,N", SHAPES)
@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_vs_jax(B, S, H, P, G, N, chunk):
    j, t = _both(_inputs(B, S, H, P, G, N, seed=1))
    y, st = ssd.ssd_chunked(*t, chunk)
    yj, stj = jssd.ssd_chunked(*j, chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=TOL, rtol=TOL)


def test_ssd_chunked_with_initial_state_vs_jax():
    x, dt, A, Bm, Cm = _inputs(2, 21, 4, 16, 2, 16, seed=2)
    s0 = np.random.default_rng(3).standard_normal((2, 4, 16, 16)).astype(np.float32)
    j, t = _both([x, dt, A, Bm, Cm, s0])
    y, st = ssd.ssd_chunked(*t[:5], 8, state0=t[5])
    yj, stj = jssd.ssd_chunked(*j[:5], 8, state0=j[5])
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_step_vs_jax(G):
    rng = np.random.default_rng(4)
    B, H, P, N = 2, 4, 16, 16
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    x, dt, A, Bm, Cm = _inputs(B, 1, H, P, G, N, seed=5)
    j, t = _both([state, x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0]])
    y, st = ssd.ssd_step(*t)
    yj, stj = jssd.ssd_step(*j)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), atol=TOL, rtol=TOL)


# ---------------------------------------------------------------------------
# ops.ssd_scan: the kernel's wrapper, on the CPU through the plain version
# ---------------------------------------------------------------------------

SCAN_CASES = [            # (B, S, H, P, G, N, chunk)
    (2, 64, 4, 16, 2, 16, 16),      # S a multiple of the chunk, G > 1
    (2, 37, 8, 16, 1, 16, 8),       # reduced mamba2-130m: ragged S
    (1, 50, 4, 32, 4, 32, 16),      # ragged, G == H
    (1, 5, 2, 16, 1, 16, 8),        # S < chunk
    (2, 1, 2, 16, 1, 16, 8),        # S == 1
]


@pytest.mark.parametrize("B,S,H,P,G,N,chunk", SCAN_CASES)
def test_ops_ssd_scan_vs_pallas_interpret_and_sequential(B, S, H, P, G, N, chunk):
    j, t = _both(_inputs(B, S, H, P, G, N, seed=6))
    y, st = ops.ssd_scan(*t, chunk=chunk)
    assert y.shape == (B, S, H, P) and st.shape == (B, H, P, N) and st.dtype == torch.float32
    yk, stk = jops.ssd_scan(*j, chunk=chunk, impl="pallas")
    _scan_close(y, st, yk, stk)
    yq, stq = jssd.ssd_sequential(*j)
    _scan_close(y, st, yq, stq)


def test_ops_ssd_scan_bf16_inputs_vs_jax_sequential():
    """bf16 x, B, C (the model's compute dtype); y comes back in bf16, the
    state in fp32; one bf16 ulp on y."""
    x, dt, A, Bm, Cm = _inputs(2, 24, 4, 16, 1, 16, seed=7)
    j, t = _both([x, dt, A, Bm, Cm])
    jb = [j[0].astype(jnp.bfloat16), j[1], j[2], j[3].astype(jnp.bfloat16),
          j[4].astype(jnp.bfloat16)]
    tb = [t[0].bfloat16(), t[1], t[2], t[3].bfloat16(), t[4].bfloat16()]
    y, st = ops.ssd_scan(*tb, chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yq, stq = jssd.ssd_sequential(*jb)
    yq = np.asarray(yq, np.float32)
    np.testing.assert_allclose(y.float().numpy(), yq,
                               atol=2e-4 * (np.abs(yq).max() + 1.0), rtol=1e-2)
    np.testing.assert_allclose(st.numpy(), np.asarray(stq),
                               atol=2e-4 * (np.abs(np.asarray(stq)).max() + 1.0))


def test_ops_ssd_scan_reads_strided_views():
    """x, B and C as views of one (B,S,conv_dim) tensor, as the model hands
    them over: same result as contiguous copies."""
    B, S, H, P, G, N = 2, 19, 4, 16, 2, 8
    rng = np.random.default_rng(8)
    big = torch.from_numpy(rng.standard_normal((B, S, H * P + 2 * G * N)).astype(np.float32))
    x = big[..., :H * P].unflatten(-1, (H, P))
    Bm = big[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = big[..., H * P + G * N:].unflatten(-1, (G, N))
    _, dt, A, _, _ = _inputs(B, S, H, P, G, N, seed=9)
    dt, A = torch.from_numpy(dt), torch.from_numpy(A)
    assert not x.is_contiguous() and not Bm.is_contiguous()
    y, st = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    y2, st2 = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), chunk=8)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("S,chunk,L", [(1024, 256, 256), (300, 128, 128), (5, 8, 5),
                                       (64, 256, 64), (1, 8, 1), (37, 8, 8)])
def test_ops_ssd_scan_chunk_rule(monkeypatch, S, chunk, L):
    """The JAX wrapper's rule: S itself when it fits and divides, else the
    configured chunk (ragged last chunk)."""
    seen = []
    monkeypatch.setattr(sk, "ssd_scan_plain", lambda *a: seen.append(a[5]) or (None, None))
    x = torch.zeros(1, S, 2, 4)
    ops.ssd_scan(x, torch.zeros(1, S, 2), torch.zeros(2), torch.zeros(1, S, 1, 4),
                 torch.zeros(1, S, 1, 4), chunk=chunk)
    assert seen == [L]


def test_ssd_scan_dispatch_and_counter():
    ops.reset_launch_counts()
    t = [torch.from_numpy(a) for a in _inputs(1, 9, 2, 16, 1, 16)]
    assert sk.ssd_scan_plain is ref.ssd_scan is ssd.ssd_chunked   # one function, one body
    y, st = ops.ssd_scan(*t, chunk=8)
    y2, st2 = ref.ssd_scan(*t, 8)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    assert ops.launch_counts()["ssd_scan"] == 0
    with pytest.raises(RuntimeError, match="needs CUDA"):
        ops.ssd_scan(*t, chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        sk.ssd_scan_cuda(*t, chunk=8)
    with ops.force_impl("ref"):
        assert torch.equal(ops.ssd_scan(*t, chunk=8)[0], y)
