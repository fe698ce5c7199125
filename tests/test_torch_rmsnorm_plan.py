"""The rmsnorm kernel's launch plan (``kernels/rmsnorm.py``
``rmsnorm_plan``), on the CPU: the thread-to-element map that
``csrc/rmsnorm.cu`` follows, written out here in numpy, covers every
element of every row exactly once, for the vector path (16-byte loads held
in registers) and for the scalar loop that rows off 16 bytes take; and the
plan's shape rules (threads per row follow D, about 256 threads a block).
The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against the plain version at these plans."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rk


def covered(plan, rows: int, D: int) -> np.ndarray:
    """How many times each (row, element) is read and written under
    ``plan``: thread t of block blk serves row blk * rpb + t // tpr; in the
    vector path it holds vectors q + k * tpr (k < per, below D / vec), in
    the scalar loop elements q + k * tpr below D, q = t % tpr."""
    count = np.zeros((rows, D), np.int64)
    blocks = -(-rows // plan.rpb)
    t = np.arange(plan.tpr * plan.rpb)
    row = (np.arange(blocks)[:, None] * plan.rpb + t[None, :] // plan.tpr).ravel()
    q = np.broadcast_to(t % plan.tpr, (blocks, t.size)).ravel()
    live = row < rows
    row, q = row[live], q[live]
    if plan.per:
        for k in range(plan.per):
            vi = q + k * plan.tpr
            ok = vi < D // plan.vec
            for i in range(plan.vec):
                np.add.at(count, (row[ok], vi[ok] * plan.vec + i), 1)
    else:
        for k in range(-(-D // plan.tpr)):
            j = q + k * plan.tpr
            ok = j < D
            np.add.at(count, (row[ok], j[ok]), 1)
    return count


@pytest.mark.parametrize("D", [16, 128, 512, 768, 1536, 2048])
@pytest.mark.parametrize("rows", [1, 2, 5, 256, 2048])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_element_once(D, rows, aligned):
    for itemsize in (2, 4):                      # bf16, fp32
        plan = rk.rmsnorm_plan(D, itemsize, aligned)
        assert plan.vec == 16 // itemsize
        assert (plan.per > 0) == aligned          # every D here is a multiple of the vector
        tpr, threads = plan.tpr, plan.tpr * plan.rpb
        assert (tpr <= 32 and tpr & (tpr - 1) == 0) or tpr % 32 == 0
        assert threads % 32 == 0 and threads <= 1024
        if plan.per:                              # the C entry's own check
            assert plan.per * tpr * plan.vec >= D
        assert (covered(plan, rows, D) == 1).all()


@pytest.mark.parametrize("D,itemsize,aligned,want", [
    (2048, 2, True, (1, 256, 1)),     # granite-3-2b bf16: 256 threads x 16 bytes
    (768, 2, True, (1, 96, 2)),       # mamba2-130m bf16: 96 threads, two rows a block
    (1536, 4, True, (2, 192, 1)),     # the gated norm, fp32
    (2048, 4, True, (2, 256, 1)),
    (16, 4, True, (1, 4, 64)),
    (13, 2, True, (0, 16, 16)),       # D not a multiple of the vector: the scalar loop
    (2048, 2, False, (0, 256, 1)),    # rows off 16 bytes: the scalar loop
    (40000, 2, True, (0, 256, 1)),    # more than 8 vectors a thread: the scalar loop
])
def test_plan_shapes(D, itemsize, aligned, want):
    plan = rk.rmsnorm_plan(D, itemsize, aligned)
    assert (plan.per, plan.tpr, plan.rpb) == want


def test_cpu_dispatch_takes_the_plain_version_with_a_bf16_scale():
    """On the CPU the wrapper takes the plain version, for an fp32 or a
    bf16 scale alike, and counts no launch."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, 768)).astype(np.float32)).bfloat16()
    s = torch.from_numpy(rng.standard_normal(768).astype(np.float32))
    for scale in (s, s.bfloat16()):
        assert torch.equal(ops.rmsnorm(x, scale), ref.rmsnorm(x, scale))
    assert ops.launch_counts()["rmsnorm"] == 0
