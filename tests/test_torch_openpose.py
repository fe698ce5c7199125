"""The port's OpenPose-lite against the JAX package's, on the CPU.

The same weights (the reference's ``init_params`` carried across with
``from_numpy_tree``) and the same frames go through both ``op_forward``s.
Tolerances: beliefs within 1e-5·max|ref| (float32 convolutions summed in
another order by XLA and by PyTorch's CPU backend); the SAME-padding rule
alone within 1e-5·max|ref|; ``render_pose``, ``make_frames``, ``op_flops``
and the model fingerprint exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core.cache import model_fingerprint as ref_fingerprint
from repro.models import openpose as R
from repro.models.params import init_params as ref_init
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.executor import DestinationExecutor, HostRuntime
from repro_torch.core.library import make_openpose_library
from repro_torch.core.transport import DirectChannel
from repro_torch.models import openpose as P
from repro_torch.models.params import from_numpy_tree

TOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    net = R.OpenPoseLite()
    params = jax.tree_util.tree_map(
        np.asarray, ref_init(R.op_param_specs(net), jax.random.PRNGKey(0), jnp.float32))
    return net, params, from_numpy_tree(params, device="cpu")


@pytest.mark.parametrize("B,H,W", [(1, 368, 656), (2, 37, 53), (2, 45, 77)])
def test_op_forward_matches_reference(weights, B, H, W):
    net, params, tparams = weights
    frames = np.asarray(R.make_frames(B, H, W, seed=B + H))
    want = np.asarray(R.op_forward(net, params, frames))
    got = P.op_forward(P.OpenPoseLite(), tparams, torch.from_numpy(frames))
    assert got.shape == want.shape == (B, -(-H // 8), -(-W // 8), 57)
    assert got.dtype == torch.float32 and got.is_contiguous()
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max()


@pytest.mark.parametrize("size", [368, 656, 37, 53, 46, 45])
@pytest.mark.parametrize("stride,k", [(1, 3), (2, 3), (1, 1)])
def test_same_padding_matches_xla(size, stride, k):
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((1, size, size + 1, 4), dtype=np.float32)   # odd and even dims
    w = rng.standard_normal((k, k, 4, 5), dtype=np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = P._conv(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
                  stride).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_same_padding_is_asymmetric_at_stride_two():
    """At 368 rows, k 3, stride 2 XLA pads 0 before and 1 after; a symmetric
    ``padding=1`` shifts every output."""
    assert P.same_pads(368, 3, 2) == (0, 1)
    assert P.same_pads(656, 3, 2) == (0, 1)
    assert P.same_pads(37, 3, 2) == (1, 1)
    assert P.same_pads(46, 3, 1) == (1, 1)
    x = torch.randn(1, 2, 368, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(3, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    symmetric = F.conv2d(x, w.permute(3, 2, 0, 1), stride=2, padding=1)
    assert symmetric.shape == P._conv(x, w, 2).shape
    assert not torch.allclose(symmetric, P._conv(x, w, 2))


@pytest.mark.parametrize("hw,HW", [((46, 82), (368, 656)), ((5, 7), (37, 53)),
                                   ((6, 10), (45, 77)), ((3, 4), (20, 29))])
def test_render_pose_bit_equal(hw, HW):
    rng = np.random.default_rng(hw[0])
    frames = rng.standard_normal((2, *HW, 3), dtype=np.float32)
    beliefs = rng.standard_normal((2, *hw, 57), dtype=np.float32)
    want = np.asarray(R.render_pose(jnp.asarray(frames), jnp.asarray(beliefs)))
    t_frames = torch.from_numpy(frames.copy())
    got = P.render_pose(t_frames, torch.from_numpy(beliefs))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_frames.numpy(), frames)     # a new tensor


@pytest.mark.parametrize("B,H,W,seed", [(1, 368, 656, 0), (3, 37, 53, 7)])
def test_make_frames_bit_equal(B, H, W, seed):
    got = P.make_frames(B, H, W, seed)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, H, W, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(R.make_frames(B, H, W, seed)))


@pytest.mark.parametrize("net", [R.OpenPoseLite(), R.OpenPoseLite(channels=16, stages=3)])
@pytest.mark.parametrize("H,W", [(368, 656), (37, 53)])
def test_op_flops_and_specs_equal(net, H, W):
    tnet = P.OpenPoseLite(*net)
    assert P.op_flops(tnet, H, W) == R.op_flops(net, H, W)
    assert repr(tnet) == repr(net)
    ref_specs, tspecs = R.op_param_specs(net), P.op_param_specs(tnet)
    assert sorted(tspecs) == sorted(ref_specs)
    for name, leaf in ref_specs.items():
        s, t = leaf["w"], tspecs[name]["w"]
        assert (t.shape, t.axes, t.init, t.scale) == (s.shape, s.axes, s.init, s.scale)


def test_fingerprint_equal_across_packages(weights):
    net, params, tparams = weights
    want = ref_fingerprint(net, params)
    assert model_fingerprint(P.OpenPoseLite(), params) == want
    assert model_fingerprint(P.OpenPoseLite(), tparams) == want


def test_library_forward_through_executor_equals_op_forward(weights):
    net, params, tparams = weights
    tnet = P.OpenPoseLite()
    ex = DestinationExecutor({"openpose": make_openpose_library(tnet, device="cpu")},
                             device="cpu")
    rt = HostRuntime(DirectChannel(ex))
    fp = model_fingerprint(tnet, params)
    rt.put_model(fp, "openpose", params)
    frames = P.make_frames(2, 45, 77, seed=3)
    out = rt.run(fp, "forward", {"frames": frames})
    np.testing.assert_array_equal(np.asarray(out["beliefs"]),
                                  P.op_forward(tnet, tparams, frames).numpy())
    assert rt.last_compute_s > 0
    ex.shutdown()


def test_openpose_library_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_openpose_library(P.OpenPoseLite())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_openpose_library(P.OpenPoseLite(), device="cuda")
