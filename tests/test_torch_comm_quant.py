"""The port's int8 codec and gradient compression against the JAX package,
on the CPU, with inputs made by numpy from a seed.

Tolerances: ``q`` EQUAL and ``scale`` within rtol 1e-6, the hold
``tests/test_kernels.py`` puts on the Pallas kernel (the same IEEE division
and round-half-to-even, so nothing may differ); the numpy helpers bit for
bit (they are the same numpy code); dequantized values within 1e-6 of the
reference's fp32 product (XLA may fuse the multiply-and-cast differently,
the plain product is exact to one rounding).  The CUDA kernels themselves
are held against these plain versions on the card by ``chip_smoke.py``.
"""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import collectives as RC
from repro.kernels import comm_quant as RQ
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.optim import compression as RCP
from repro_torch.distributed import collectives as TC
from repro_torch.kernels import comm_quant as TQ
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import KernelFunction
from repro_torch.optim import compression as TCP
from repro_torch.utils import tree_leaves


def _ties(rows: int, cols: int) -> np.ndarray:
    """Rows whose x / scale is exactly k + 0.5 (scale 2**-7), a zero row and
    a row of +-absmax."""
    s = 2.0 ** -7
    ties = np.resize((np.arange(-127, 127) + 0.5) * s, (rows, cols))
    ties[:, 0] = 127 * s
    ties[1::2] *= -1
    out = np.concatenate([ties, np.zeros((1, cols)),
                          np.where(np.arange(cols) % 2 == 0, 3.25, -3.25)[None]], axis=0)
    return out.astype(np.float32)


def _x(n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * rng.random((n, 1)) * 0.01).astype(np.float32)
    x[:min(n, 5)] = _ties(3, d)[:min(n, 5)]
    return x


SHAPES = [(64, 256), (100, 128), (3, 512), (7, 24), (5, 257), (1, 64)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_plain_quantize_matches_reference_and_pallas(n, d):
    x = _x(n, d)
    tq, ts = ops.quantize_int8(torch.from_numpy(x))
    for q, s in (rref.quantize_int8(jnp.asarray(x)),
                 rops.quantize_int8(jnp.asarray(x), impl="pallas")):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-6)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (n, 1)
    rq, rs = rref.quantize_int8(jnp.asarray(x))
    for dt, rdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = ops.dequantize_int8(tq, ts, dt).float().numpy()
        for want in (rref.dequantize_int8(rq, rs, rdt),
                     rops.dequantize_int8(rq, rs, rdt, impl="pallas")):
            np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=1e-6, atol=1e-30)


def test_ties_round_half_to_even():
    x = _ties(3, 256)
    q, s = ops.quantize_int8(torch.from_numpy(x))
    assert float(s[0]) == 2.0 ** -7
    k = np.arange(-127, 127)
    halves = np.resize(k + 0.5, 256)[1:]
    assert np.all(q[0, 1:].numpy() == np.rint(halves))          # half to even
    assert np.all(np.abs(q[0, 1:].numpy()) % 2 == 0)
    assert q[0, 0] == 127 and q[1, 0] == -127
    assert np.all(q[3].numpy() == 0) and float(s[3]) == np.float32(1e-12) / np.float32(127)
    assert set(np.abs(q[4].numpy()).tolist()) == {127}


def _nonfinite(d: int, seed: int = 10) -> np.ndarray:
    """A row holding one NaN and a row holding +Inf and -Inf, among finite
    values."""
    x = np.random.default_rng(seed).standard_normal((2, d)).astype(np.float32)
    x[0, d // 2] = np.nan
    x[1, 0], x[1, -1] = np.inf, -np.inf
    return x


@pytest.mark.parametrize("d", [24, 257])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonfinite_rows_match_reference(d, dtype):
    """A NaN row's scale is NaN and an Inf row's is Inf, as the reference's
    max gives them; each NaN quotient casts to q 0, as in the reference; both
    rows dequantize to all NaN, so a non-finite gradient stays non-finite
    through compression.  Finite rows: q equal, scale rtol 1e-6 as above."""
    x = np.concatenate([_x(3, d), _nonfinite(d)])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rx = jnp.asarray(x, getattr(jnp, dtype))
    tq, ts = ops.quantize_int8(tx)
    for q, s in (rref.quantize_int8(rx), rops.quantize_int8(rx, impl="pallas")):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        np.testing.assert_allclose(ts.numpy(), np.asarray(s), rtol=1e-6)   # NaN, Inf in place
    assert np.isnan(ts[3, 0].item()) and ts[4, 0].item() == np.inf and np.all(tq[3:].numpy() == 0)
    deq = ops.dequantize_int8(tq, ts).numpy()
    assert np.isnan(deq[3:]).all() and np.isfinite(deq[:3]).all()
    np.testing.assert_allclose(deq, np.asarray(rref.dequantize_int8(*rref.quantize_int8(rx))),
                               rtol=1e-6, atol=1e-30)
    back = TCP.decompress_tree(TCP.compress_tree({"g": tx})[0])["g"]
    assert back.isnan()[3:].all() and back[:3].isfinite().all()
    if dtype == "float32":                 # the numpy helpers, bit for bit
        with np.errstate(invalid="ignore"):
            nq, ns = TQ.quantize_int8_np(x)
            rq, rs = RQ.quantize_int8_np(x)
        assert nq.tobytes() == rq.tobytes() and ns.tobytes() == rs.tobytes()
        assert nq.tobytes() == tq.numpy().tobytes() and ns.tobytes() == ts.numpy().tobytes()


@pytest.mark.parametrize("shape", [(), (37,), (4, 6, 40), (2, 3, 5, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_helpers_match_reference(shape, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    rx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    rq, rs = RQ.quantize_leaf(rx)
    tq, ts = TQ.quantize_leaf(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(rs), rtol=1e-6)
    want = RQ.dequantize_leaf(rq, rs, shape, rx.dtype)
    got = TQ.dequantize_leaf(tq, ts, shape, tx.dtype)
    assert tuple(got.shape) == shape and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=1e-6)


def test_leaf_rows_of_a_strided_view():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((8, 6, 40)).astype(np.float32))
    v = x.transpose(0, 1)
    q, s = TQ.quantize_leaf(v)
    q2, s2 = TQ.quantize_leaf(v.contiguous())
    assert torch.equal(q, q2) and torch.equal(s, s2) and q.shape == (48, 40)


@pytest.mark.parametrize("shape", [(), (5,), (64, 32), (3, 4, 24)])
def test_numpy_helpers_bit_for_bit(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    if x.ndim == 2:
        x[:5] = _ties(3, x.shape[1])[:5]
    tq, ts = TQ.quantize_int8_np(x)
    rq, rs = RQ.quantize_int8_np(x)
    assert tq.tobytes() == rq.tobytes() and ts.tobytes() == rs.tobytes()
    assert tq.dtype == rq.dtype and ts.dtype == rs.dtype and tq.shape == rq.shape
    for dt in (np.float32, np.float16):
        assert TQ.dequantize_int8_np(tq, ts, dt).tobytes() == \
            RQ.dequantize_int8_np(rq, rs, dt).tobytes()
    assert TQ.leaf_rows(x).shape == RQ.leaf_rows(x).shape
    # and the numpy mirror agrees with the torch plain version
    pq, ps = ops.quantize_int8(torch.from_numpy(np.ascontiguousarray(TQ.leaf_rows(x))))
    assert pq.numpy().tobytes() == tq.tobytes() and ps.numpy().tobytes() == ts.tobytes()


def test_wire_codec_quantizes_through_the_kernels_module():
    from repro_torch.core import serialization
    assert serialization.quantize_int8_np is TQ.quantize_int8_np
    assert serialization.dequantize_int8_np is TQ.dequantize_int8_np


def _grad_tree(seed=6):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((16, 32)).astype(np.float32) * 1e-2,
            "b": rng.standard_normal((32,)).astype(np.float32),
            "blocks": [{"k": rng.standard_normal((2, 8, 24)).astype(np.float32)}]}


def _both(tree, dtype="float32"):
    return (jax.tree_util.tree_map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), tree),
            jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), tree))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_tree_matches_reference(dtype):
    rt, tt = _both(_grad_tree(), dtype)
    rc, rwire = RCP.compress_tree(rt)
    tcq, twire = TCP.compress_tree(tt)
    assert twire == rwire
    for r, t in zip(jax.tree_util.tree_leaves(rc, is_leaf=lambda x: isinstance(x, dict) and "q" in x),
                    tree_leaves(tcq, is_leaf=lambda x: isinstance(x, dict) and "q" in x)):
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(r["q"]))
        np.testing.assert_allclose(t["s"].numpy(), np.asarray(r["s"]), rtol=1e-6)
        assert t["shape"] == r["shape"] and t["dtype"] == r["dtype"]
    rd, td = RCP.decompress_tree(rc), TCP.decompress_tree(tcq)
    for r, t in zip(jax.tree_util.tree_leaves(rd), tree_leaves(td)):
        assert t.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(t.float().numpy(), np.asarray(r, np.float32), rtol=1e-6)


def test_error_feedback_matches_reference_over_steps():
    rt, tt = _both(_grad_tree(7))
    rres, tres = RCP.ErrorFeedback.init(rt), TCP.ErrorFeedback.init(tt)
    for _ in range(5):
        rout, rres = RCP.ErrorFeedback.compress(rt, rres)
        tout, tres = TCP.ErrorFeedback.compress(tt, tres)
        for a, b in zip(jax.tree_util.tree_leaves(rout), tree_leaves(tout)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)
        for a, b in zip(jax.tree_util.tree_leaves(rres), tree_leaves(tres)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-9)
    assert all(not t.requires_grad and t.dtype == torch.float32 for t in tree_leaves(tres))


@pytest.fixture
def gloo_group():
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def test_compressed_psum_and_allreduce_match_reference(gloo_group):
    from jax.sharding import AxisType, PartitionSpec
    x = np.random.default_rng(8).standard_normal((16, 32)).astype(np.float32)
    mesh = jax.make_mesh((1,), ("pod",), axis_types=(AxisType.Auto,))
    want = jax.shard_map(
        lambda t: RCP.compressed_psum({"g": t}, "pod")["g"], mesh=mesh,
        in_specs=PartitionSpec(), out_specs=PartitionSpec())(jnp.asarray(x))
    got = TCP.compressed_psum({"g": torch.from_numpy(x)}, gloo_group)["g"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    bound = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    assert np.all(np.abs(got.numpy() - x) <= bound + 1e-6)
    # the reference's hierarchical_psum over a mesh with only a pod axis, as
    # its compressed_grad_allreduce composes it (that function passes its
    # in_specs as a bare dict, which this jax's shard_map refuses for a
    # one-argument call, so the composition is written out with a tuple)
    spec = {"g": PartitionSpec()}
    rgot = jax.shard_map(
        lambda g: RC.hierarchical_psum(g, fast_axes=(), slow_axis="pod"), mesh=mesh,
        in_specs=(spec,), out_specs=spec)({"g": jnp.asarray(x)})["g"]
    tgot = TC.compressed_grad_allreduce(TC.ReduceGroups(slow=gloo_group),
                                        {"g": torch.from_numpy(x)})["g"]
    np.testing.assert_allclose(tgot.numpy(), np.asarray(rgot), rtol=1e-6)
    # uncompressed slow hop and a full-precision fast hop are exact sums
    raw = TC.compressed_grad_allreduce(TC.ReduceGroups(fast=gloo_group, slow=gloo_group),
                                       {"g": torch.from_numpy(x)}, compress=False)["g"]
    assert np.array_equal(raw.numpy(), x)


def test_dcn_wire_bytes_match_reference_and_pin_the_row_count():
    tree = _grad_tree()
    rt, tt = _both(tree)
    for compressed in (False, True):
        assert TC.dcn_wire_bytes(tt, compressed) == RC.dcn_wire_bytes(rt, compressed)
    # the reference counts leaf.shape[0] scales; the quantizer makes one per
    # leaf_rows row: for the rank-3 leaf (2, 8, 24) that is 2, not 16
    k = {"k": tt["blocks"][0]["k"]}
    assert TC.dcn_wire_bytes(k, True) == 2 * 8 * 24 + 2 * 4
    assert TCP.compress_tree(k)[1] == 2 * 8 * 24 + 16 * 4


def test_ops_dispatch_by_device():
    x = torch.from_numpy(_x(4, 64))
    with pytest.raises(RuntimeError, match="needs CUDA"):
        ops.quantize_int8(x, impl="cuda")
    ops.reset_launch_counts()
    ops.quantize_int8(x)
    counts = ops.launch_counts()
    assert counts["quantize_int8"] == 0 and counts["dequantize_int8"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        TQ.quantize_int8_cuda(x)


def test_kernel_function_gradients_and_unused_output():
    """KernelFunction's backward (the plain version recomputed) gives the
    plain path's gradients, in each input's own dtype, and takes None for
    an output whose gradient is unused.  The kernel is stood in for by the
    plain version here; on the card chip_smoke.py runs the real ones."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    s = torch.from_numpy(rng.standard_normal(16).astype(np.float32)).to(torch.bfloat16)
    gy = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32))
    a = [t.clone().requires_grad_() for t in (x, s)]
    b = [t.clone().requires_grad_() for t in (x, s)]
    y1 = KernelFunction.apply(ref.rmsnorm, ref.rmsnorm, {"eps": 1e-6}, *a)
    y2 = ref.rmsnorm(*b, eps=1e-6)
    assert y1.grad_fn is not None
    g1 = torch.autograd.grad(y1, a, gy)
    g2 = torch.autograd.grad(y2, b, gy)
    for u, v, t in zip(g1, g2, (x, s)):
        assert u.dtype == t.dtype and u.shape == t.shape
        assert torch.equal(u, v)
    # two outputs, gradient through the first only (the SSD scan in training)
    xs = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).requires_grad_()
          for sh in ((1, 12, 2, 4), (1, 12, 2), (2,), (1, 12, 1, 4), (1, 12, 1, 4))]
    with torch.no_grad():
        xs[1].abs_()
        xs[2].neg_()
    y, st = KernelFunction.apply(
        lambda *t, chunk: ref.ssd_scan(*t, chunk), lambda *t, chunk: ref.ssd_scan(*t, chunk),
        {"chunk": 4}, *xs)
    g1 = torch.autograd.grad(y.sum(), xs)
    yr, _ = ref.ssd_scan(*xs, 4)
    g2 = torch.autograd.grad(yr.sum(), xs)
    for u, v in zip(g1, g2):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
