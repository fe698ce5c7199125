"""The port's sharding rules, optimizer-state specs, dry-run input specs and
the small helpers the dry-run needs, against the JAX package on the CPU.

Everything here is exact: specs, shapes, dtypes and partition specs are
equal, not close.  The reference's ``NamedSharding`` needs a mesh, so its
rules run on ``jax.sharding.AbstractMesh`` (no devices); the port's on the
reference test's ``FakeMesh`` (``axis_names`` and a ``shape`` dict), which
is all its rules read.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as RP

from repro import utils as RU
from repro.configs import ARCH_IDS, SHAPES, get_arch
from repro.distributed import sharding as RS
from repro.models import blocks as RB
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import params as RPM
from repro.optim import optimizer as RO
from repro_torch import configs as tconfigs
from repro_torch import utils as TU
from repro_torch.distributed import sharding as TS
from repro_torch.distributed.sharding import P
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TPM
from repro_torch.optim import optimizer as TO

PROFILES = ["dp_tp", "fsdp_tp", "dp_tp_hd", "fsdp_tp_hd"]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _meshes(name):
    shape, axes = MESHES[name]
    return FakeMesh(shape, axes), AbstractMesh(shape, axes)


def _specs(arch):
    return (RM.param_specs(get_arch(arch)),
            TM.param_specs(tconfigs.get_arch(arch)))


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else jnp.dtype(dt).name


def _ref_flat(tree, is_leaf=None):
    return [(TU.keystr(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)), leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)]


def _port_flat(tree, is_leaf=None):
    return [(TU.keystr(path), leaf) for path, leaf in TU.tree_leaves_with_path(tree, is_leaf)]


# ---------------------------------------------------------------------------
# the reference test's cases (tests/test_serving_and_sharding.py)
# ---------------------------------------------------------------------------

def test_sharding_rules_divisibility_and_profiles():
    mesh = FakeMesh((16, 16), ("data", "model"))
    ParamSpec = TPM.ParamSpec
    # vocab padded to a 2048-multiple always divides
    s = ParamSpec((51200, 2048), ("vocab", "embed"))
    assert TS.spec_to_pspec(mesh, s, "dp_tp") == RP("model", None)
    assert TS.spec_to_pspec(mesh, s, "fsdp_tp") == RP("model", "data")
    # uneven heads replicate (36 % 16 != 0)
    s = ParamSpec((2304, 36, 64), ("embed", "heads", "head_dim"))
    assert TS.spec_to_pspec(mesh, s, "dp_tp") == RP(None, None, None)
    # even heads shard
    s = ParamSpec((4096, 32, 128), ("embed", "heads", "head_dim"))
    assert TS.spec_to_pspec(mesh, s, "dp_tp") == RP(None, "model", None)
    # experts shard over model
    s = ParamSpec((128, 7168, 4864), ("experts", "embed", "expert_mlp"))
    assert TS.spec_to_pspec(mesh, s, "dp_tp") == RP("model", None, None)
    # fsdp never double-books a mesh axis
    s = ParamSpec((2048, 2048), ("embed", "embed"))
    assert TS.spec_to_pspec(mesh, s, "fsdp_tp") == RP("data", None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_param_axes_cover_shapes(arch):
    for path, spec in _port_flat(TM.param_specs(tconfigs.get_arch(arch)), TPM.is_spec):
        assert len(spec.shape) == len(spec.axes), (arch, path)


# ---------------------------------------------------------------------------
# parameter rules: every ParamSpec of every arch, four profiles, two meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_to_pspec_equals_reference(arch, mesh_name, profile):
    fake, amesh = _meshes(mesh_name)
    rspecs, tspecs = _specs(arch)
    ref = _ref_flat(RS.specs_to_shardings(amesh, rspecs, profile))
    port = _port_flat(TS.specs_to_shardings(fake, tspecs, profile))
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, t), (_, r) in zip(port, ref):
        assert t.spec == r.spec, (arch, path, t.spec, r.spec)
        assert isinstance(t.spec, tuple) and len(t.spec) == len(r.spec)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh((2, 16, 16), ("pod", "data", "model"))
    assert TS.to_placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.to_placements(mesh, P(None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert TS.to_placements(mesh, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        TS.to_placements(mesh, P("model", "model"))
    with pytest.raises(ValueError):
        TS.to_placements(FakeMesh((16, 16), ("data", "model")), P("pod", None))
    sh = TS.NamedSharding(mesh, P(None, "data"))
    assert sh.placements == (Replicate(), Shard(1), Replicate())
    assert TS.replicated(mesh).spec == RP()


# ---------------------------------------------------------------------------
# inputs and caches: every arch x shape cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_shardings_equal_reference(arch, mesh_name):
    fake, amesh = _meshes(mesh_name)
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    for shape in SHAPES.values():
        rb, tb = RM.input_specs(cfg, shape), TM.input_specs(tcfg, shape)
        ri, ti = RS.input_shardings(amesh, cfg, rb), TS.input_shardings(fake, tcfg, tb)
        assert sorted(ti) == sorted(ri)
        assert {k: v.spec for k, v in ti.items()} == {k: v.spec for k, v in ri.items()}
        for rank in (1, 2, 3):
            for seq_axis in (None, rank - 1):
                args = (shape.global_batch, rank, seq_axis, shape.seq_len)
                assert TS.batch_pspec(fake, *args) == RS.batch_pspec(amesh, *args)
        if shape.kind == "train":
            continue
        B, S = shape.global_batch, shape.seq_len
        for profile in PROFILES:
            rc = _ref_flat(RS.cache_shardings(amesh, cfg, RM.abstract_cache(cfg, B, S), B,
                                              profile))
            tc = _port_flat(TS.cache_shardings(fake, tcfg, TM.abstract_cache(tcfg, B, S), B,
                                               profile))
            assert [(p, s.spec) for p, s in tc] == [(p, s.spec) for p, s in rc], \
                (arch, shape.name, profile)


@pytest.mark.parametrize("batch,seq", [(1, 524288), (1, 7), (8, 64), (512, 16), (48, 4096)])
def test_batch_pspec_small_and_uneven_batches(batch, seq):
    for name in MESHES:
        fake, amesh = _meshes(name)
        for rank in (2, 3, 4):
            assert TS.batch_pspec(fake, batch, rank, 1, seq) == \
                RS.batch_pspec(amesh, batch, rank, 1, seq)


# ---------------------------------------------------------------------------
# optimizer state, dry-run inputs and caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_equal_reference(arch, opt):
    rspecs, tspecs = _specs(arch)
    ref = _ref_flat(RO.opt_state_specs(RO.OptimizerConfig(name=opt), rspecs), RPM.is_spec)
    port = _port_flat(TO.opt_state_specs(TO.OptimizerConfig(name=opt), tspecs), TPM.is_spec)
    assert [p for p, _ in port] == [p for p, _ in ref]
    for (path, t), (_, r) in zip(port, ref):
        assert (tuple(t.shape), tuple(t.axes), t.init) == (tuple(r.shape), tuple(r.axes), r.init)
        assert _dtype_name(t.dtype) == _dtype_name(r.dtype) == "float32", path


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_opt_state_specs_mirror_init_opt_state(opt):
    """The specs describe the state ``init_opt_state`` builds."""
    tcfg = tconfigs.reduced(tconfigs.get_arch("jamba-1.5-large-398b"))
    specs = TM.param_specs(tcfg)
    ocfg = TO.OptimizerConfig(name=opt)
    state = TO.init_opt_state(ocfg, TPM.abstract_params(specs))
    flat = _port_flat(TO.opt_state_specs(ocfg, specs), TPM.is_spec)
    assert [(p, tuple(s.shape)) for p, s in flat] == \
        [(p, tuple(x.shape)) for p, x in _port_flat(state)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_abstract_cache_equal_reference(arch):
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    for shape in SHAPES.values():
        rb, tb = RM.input_specs(cfg, shape), TM.input_specs(tcfg, shape)
        assert sorted(tb) == sorted(rb)
        for k in rb:
            assert tb[k].device.type == "meta"
            assert (tuple(tb[k].shape), _dtype_name(tb[k].dtype)) == \
                (tuple(rb[k].shape), _dtype_name(rb[k].dtype)), (arch, shape.name, k)
        if shape.kind == "train":
            continue
        B, S = shape.global_batch, shape.seq_len
        rc = _ref_flat(RM.abstract_cache(cfg, B, S))
        tc = _port_flat(TM.abstract_cache(tcfg, B, S))
        assert [(p, tuple(x.shape), _dtype_name(x.dtype)) for p, x in tc] == \
            [(p, tuple(x.shape), _dtype_name(x.dtype)) for p, x in rc], (arch, shape.name)
        assert all(x.device.type == "meta" for _, x in tc)


# ---------------------------------------------------------------------------
# the small helpers: params, layers, blocks, utils
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_reference(arch):
    rspecs, tspecs = _specs(arch)
    ref = _ref_flat(RPM.param_axes(rspecs), lambda x: isinstance(x, tuple))
    port = _port_flat(TPM.param_axes(tspecs), lambda x: isinstance(x, tuple))
    assert port == ref


def test_cast_tree():
    tree = {"a": torch.ones(2, 3), "b": [torch.zeros(4, dtype=torch.float64)]}
    out = TPM.cast_tree(tree, torch.bfloat16)
    assert [x.dtype for x in TU.tree_leaves(out)] == [torch.bfloat16] * 2
    assert out["a"].shape == (2, 3) and out["b"][0].shape == (4,)
    ref = RPM.cast_tree({"a": jnp.ones((2, 3)), "b": [jnp.zeros(4)]}, jnp.bfloat16)
    assert [x.shape for x in TU.tree_leaves(out)] == [x.shape for x in jax.tree_util.tree_leaves(ref)]


@pytest.mark.parametrize("bias,scale", [(False, None), (True, None), (True, 0.5)])
def test_linear_specs_equal_reference(bias, scale):
    r = RL.linear_specs(64, 96, ("embed", "mlp"), bias=bias, scale=scale)
    t = TL.linear_specs(64, 96, ("embed", "mlp"), bias=bias, scale=scale)
    assert sorted(t) == sorted(r)
    for k in r:
        assert tuple(t[k]) == tuple(r[k])


@pytest.mark.parametrize("arch", [a for a in ARCH_IDS if get_arch(a).family != "encdec"])
def test_block_cache_and_stacked_cache_equal_reference(arch):
    """(Whisper's cache is built by ``models/encdec.py``, not by blocks.)"""
    cfg, tcfg = get_arch(arch), tconfigs.get_arch(arch)
    ref = jax.eval_shape(lambda: RB.block_cache(cfg, 2, 16))
    port = TB.block_cache(tcfg, 2, 16, device="meta")
    shapes = [(p, tuple(x.shape), _dtype_name(x.dtype)) for p, x in _port_flat(port)]
    assert shapes == [(p, tuple(x.shape), _dtype_name(x.dtype)) for p, x in _ref_flat(ref)]
    stacked = TB.stacked_cache(tcfg, 2, 16, device="meta")
    nb = TB.num_blocks(tcfg)
    assert [(p, (nb,) + s, d) for p, s, d in shapes] == \
        [(p, tuple(x.shape), _dtype_name(x.dtype)) for p, x in _port_flat(stacked)]


def test_tree_sizes_and_formats_equal_reference():
    rng = np.random.default_rng(0)
    arrays = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": [rng.integers(0, 9, (7,)).astype(np.int32), np.zeros((2, 2), np.float16)]}
    tensors = TU.tree_map(lambda a: torch.from_numpy(a), arrays)
    meta = TU.tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"), tensors)
    bf16 = TU.to_numpy(torch.ones(3, 4, dtype=torch.bfloat16))
    for tree in (arrays, tensors, meta):
        assert TU.tree_bytes(tree) == RU.tree_bytes(arrays) == 15 * 4 + 7 * 4 + 4 * 2
        assert TU.tree_params(tree) == RU.tree_params(arrays) == 26
    assert TU.tree_bytes({"x": bf16}) == 24
    for n in (0, 1.5, 999, 1023, 1024, 5e6, 3.2e9, 7e12, 2e15, 9e18, -4096):
        assert TU.fmt_bytes(n) == RU.fmt_bytes(n)
        assert TU.fmt_count(n) == RU.fmt_count(n)
    for obj in ({"b": 1, "a": [1, 2.5, "x"]}, b"\x00\x01avec", [None, True], "granite"):
        assert TU.stable_hash(obj) == RU.stable_hash(obj)
    for seq, size in ((range(7), 3), ([], 2), ("abcd", 4), (range(5), 1)):
        assert list(TU.chunks(seq, size)) == list(RU.chunks(seq, size))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), None])
def test_check_finite_equals_reference(bad):
    a = np.ones((2, 3), np.float32)
    if bad is not None:
        a[1, 2] = bad
    tree = {"blocks": [{"w": a}], "x": np.zeros(2, np.float32)}
    ttree = TU.tree_map(torch.from_numpy, tree)
    if bad is None:
        RU.check_finite(tree)
        TU.check_finite(ttree)
        TU.check_finite(tree)
        return
    with pytest.raises(FloatingPointError) as r:
        RU.check_finite(jax.tree_util.tree_map(jnp.asarray, tree), "params")
    for t in (ttree, tree):
        with pytest.raises(FloatingPointError) as e:
            TU.check_finite(t, "params")
        assert str(e.value) == str(r.value)


def test_stopwatch():
    sw = TU.Stopwatch()
    time.sleep(0.01)
    a = sw.lap("a")
    b = sw.lap("b")
    sw.lap("a")
    assert a >= 0.01 and b >= 0.0
    assert set(sw.laps) == {"a", "b"} and sw.laps["a"] >= a
    assert sw.total() == pytest.approx(sum(sw.laps.values()))
