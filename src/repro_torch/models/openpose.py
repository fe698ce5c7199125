"""OpenPose-lite: a runnable miniature of the paper's workload.

The paper offloads OpenPose's Caffe backbone (VGG-19 feature stem + iterative
part-affinity-field / heatmap stages, ~160 GFLOPs at 368x656).  This module
is the JAX package's ``models/openpose.py`` in PyTorch: a conv stem, two
prediction stages, and the paper's output geometry (feature maps at stride 8,
so output elements = input_dims / c with c ≈ 3.37 matching Eq. 1).

Host/destination split (paper §V.4): the *backbone* runs at the destination;
frame assembly + pose rendering stay on the host.

Layouts are the reference's at every boundary: frames and beliefs NHWC,
weights HWIO (as they cross the wire).  Inside, the convolutions run NCHW on
OIHW views of the weights.  XLA's ``"SAME"`` padding puts the odd pixel
after, not before (at 368 rows, k 3, stride 2: 0 before, 1 after), so the
pads are explicit (:func:`same_pads`); a symmetric ``padding=1`` would
shift every output.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


class OpenPoseLite(NamedTuple):
    channels: int = 32          # reduced from VGG 128/256/512
    stages: int = 2             # paper model has 6 PAF + 2 heatmap stages
    n_parts: int = 19           # COCO keypoints + background
    n_pafs: int = 38


def op_param_specs(net: OpenPoseLite):
    C = net.channels
    specs = {
        # stem: 3 stride-2 convs -> stride 8 feature map (as VGG pool3)
        "stem1": {"w": ParamSpec((3, 3, 3, C), (None, None, None, None), "normal", 0.05)},
        "stem2": {"w": ParamSpec((3, 3, C, C), (None, None, None, None), "normal", 0.05)},
        "stem3": {"w": ParamSpec((3, 3, C, C), (None, None, None, None), "normal", 0.05)},
    }
    in_c = C
    for s in range(net.stages):
        specs[f"stage{s}_a"] = {"w": ParamSpec((3, 3, in_c, C), (None,) * 4, "normal", 0.05)}
        specs[f"stage{s}_b"] = {"w": ParamSpec(
            (1, 1, C, net.n_parts + net.n_pafs), (None,) * 4, "normal", 0.05)}
        in_c = C + net.n_parts + net.n_pafs   # stage input = features ++ prev belief
    return specs


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim -> (before, after): the
    output has ceil(size / stride) elements and the odd pixel goes after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride=1):
    """x (N, C, H, W), w HWIO -> (N, O, ceil(H/stride), ceil(W/stride))."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], w.shape[0], stride),
                                    same_pads(x.shape[3], w.shape[1], stride))
    w = w.permute(3, 2, 0, 1)                    # HWIO -> OIHW, on w's device
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _op_forward(net: OpenPoseLite, params, frames):
    """frames: (B, H, W, 3) float32 -> beliefs (B, ceil(H/8), ceil(W/8),
    parts+pafs), NHWC."""
    x = frames.permute(0, 3, 1, 2)
    h = F.relu(_conv(x, params["stem1"]["w"], 2))
    h = F.relu(_conv(h, params["stem2"]["w"], 2))
    feat = F.relu(_conv(h, params["stem3"]["w"], 2))
    belief = None
    x = feat
    for s in range(net.stages):
        h = F.relu(_conv(x, params[f"stage{s}_a"]["w"]))
        belief = _conv(h, params[f"stage{s}_b"]["w"])
        x = torch.cat([feat, belief], dim=1)
    return belief.permute(0, 2, 3, 1).contiguous()


# the public name is what an application calls and what interception
# replaces; the destination's library calls the private one, so no
# interception in its process can reroute the real backbone
op_forward = _op_forward


def op_flops(net: OpenPoseLite, H: int, W: int) -> float:
    """Analytic forward FLOPs of OpenPose-lite at an HxW input."""
    C = net.channels
    f = 0.0
    f += 2 * (H // 2) * (W // 2) * 9 * 3 * C
    f += 2 * (H // 4) * (W // 4) * 9 * C * C
    f += 2 * (H // 8) * (W // 8) * 9 * C * C
    h8, w8 = H // 8, W // 8
    in_c = C
    for _ in range(net.stages):
        f += 2 * h8 * w8 * 9 * in_c * C
        f += 2 * h8 * w8 * 1 * C * (net.n_parts + net.n_pafs)
        in_c = C + net.n_parts + net.n_pafs
    return f


def render_pose(frames, beliefs):
    """Host-side 'rendering' kernel stand-in (paper: renderPoseCoco stays on
    the host): upsample the heatmaps' peak onto channel 0 of a new copy of
    the frames.  ``jax.image.resize(..., "nearest")`` samples at half-pixel
    centres, which is ``"nearest-exact"`` here (``"nearest"`` differs at
    every non-integer ratio)."""
    B, H, W, _ = frames.shape
    peak = beliefs[..., :19].amax(dim=-1)
    up = F.interpolate(peak[:, None], size=(H, W), mode="nearest-exact")[:, 0]
    out = frames.clone()
    out[..., 0] += up.to(frames.dtype)
    return out


def make_frames(batch: int, h: int = 368, w: int = 656, seed: int = 0):
    """(batch, h, w, 3) float32 frames on the host, bit-equal to the JAX
    package's for the same arguments."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((batch, h, w, 3), dtype=np.float32))
