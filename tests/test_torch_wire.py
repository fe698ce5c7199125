"""The port's AVC2 wire against the JAX package's: frames cross between the
packages bit-exact, the port's own msgpack matches ``msgpack.packb``, and the
model fingerprint and config repr agree for every arch."""
import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch, reduced, with_overrides
from repro.core import serialization as jser
from repro.core.cache import model_fingerprint as jfingerprint
from repro.models import model as RM
from repro_torch import configs as tconfigs
from repro_torch.core import serialization as tser
from repro_torch.core.cache import model_fingerprint as tfingerprint
from repro_torch.models.params import from_numpy_tree
from repro_torch.utils import BF16Array, keystr, to_numpy, tree_leaves_with_path


def _tree(rng, bf16_as):
    x = rng.standard_normal((4, 96)).astype(np.float32)
    bits = rng.standard_normal((3, 64)).astype(ml_dtypes.bfloat16)
    bf = bits if bf16_as == "ml_dtypes" else bits.view(np.uint16).view(BF16Array)
    return {"x": x, "nested": [rng.standard_normal(80).astype(np.float32),
                               (np.arange(6, dtype=np.int32).reshape(2, 3), 7)],
            "bf": bf, "scalar": np.float32(1.5), "name": "granite"}


def _bits(a):
    """Raw bytes of any leaf (bf16 of either kind included)."""
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _assert_same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.shape == np.shape(want)
        name = "bfloat16" if isinstance(want, BF16Array) else str(np.asarray(want).dtype)
        got_name = "bfloat16" if isinstance(got, BF16Array) else str(np.asarray(got).dtype)
        assert got_name == name
        assert _bits(got) == _bits(want)
    else:
        assert got == want


@pytest.mark.parametrize("codec", ["raw", "zlib", "int8", "fp16"])
@pytest.mark.parametrize("sender", ["port", "ref"])
def test_frames_cross_bit_exact(codec, sender):
    """Both packages put the same bytes on the wire for the same tree, and a
    frame from either decodes in the other to the bits its sender reads."""
    meta = {"op": "run", "fp": "abc", "codec": codec, "batchable": False, "n": -3,
            "qos": {"weight": 0.5, "priority": 2}}
    port_frame = tser.pack_message(meta, _tree(np.random.default_rng(0), "bf16array"),
                                   codec=codec, request_id=42)
    ref_frame = jser.pack_message(meta, _tree(np.random.default_rng(0), "ml_dtypes"),
                                  codec=codec, request_id=42)
    assert bytes(port_frame) == bytes(ref_frame)
    frame, src, dst = ((port_frame, tser, jser) if sender == "port"
                       else (ref_frame, jser, tser))
    _, want = src.unpack_message(bytes(frame))
    for data in (bytes(frame), memoryview(bytearray(bytes(frame)))):
        got_meta, got = dst.unpack_message(data)
        assert got_meta == meta and dst.frame_request_id(data) == 42
        _assert_same(got, want)


def test_bf16_leaves_decode_to_each_packages_host_type():
    rng = np.random.default_rng(1)
    frame = bytes(jser.pack_message({"op": "x"}, _tree(rng, "ml_dtypes")))
    _, port = tser.unpack_message(frame)
    assert isinstance(port["bf"], BF16Array)
    t = from_numpy_tree(port, "cpu")["bf"]
    assert t.dtype == torch.bfloat16
    _, ref = jser.unpack_message(frame)
    np.testing.assert_array_equal(t.float().numpy(), ref["bf"].astype(np.float32))
    back = bytes(tser.pack_message({"op": "x"}, {"bf": to_numpy(t)}))
    _, again = jser.unpack_message(back)
    assert again["bf"].dtype == ml_dtypes.bfloat16 and _bits(again["bf"]) == _bits(ref["bf"])


HEADERS = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
    2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63,
    0.0, 1.5, -2.25e-300, float("inf"), "", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
    "é" * 40000, b"", b"\x00" * 300, b"\x01" * 70000, [], list(range(15)), list(range(16)),
    list(range(70000)), (1, "two", 3.0), {}, {f"k{i}": i for i in range(15)},
    {f"k{i}": i for i in range(16)}, {f"k{i}": i for i in range(70000)},
    {"meta": {"op": "run", "fp": "0123456789abcdef", "codec": ["int8", "zstd", "raw"],
              "tenant": None, "qos": {"weight": 2.0, "priority": -1}},
     "template": {"tokens": {"__leaf__": 0, "dtype": "int32", "shape": [2, 128]}},
     "leaves": [{"dtype": "bfloat16", "shape": [40, 2048], "codec": "raw"}],
     "buf_lens": [163840, 2 ** 33]},
]


@pytest.mark.parametrize("obj", HEADERS, ids=lambda o: type(o).__name__)
def test_msgpack_matches_reference(obj):
    packed = tser.packb(obj)
    assert packed == msgpack.packb(obj, use_bin_type=True)
    want = msgpack.unpackb(packed, raw=False, strict_map_key=False)
    assert tser.unpackb(packed) == want


def test_msgpack_rejects_trailing_bytes_and_types_outside_the_header_subset():
    with pytest.raises(ValueError, match="extra data"):
        tser.unpackb(b"\xc0\xc0")
    with pytest.raises(ValueError, match="unsupported"):
        tser.unpackb(msgpack.packb(0.5, use_single_float=True))      # float32
    with pytest.raises(TypeError):
        tser.packb({1.5})


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fingerprint_and_repr_match_reference(arch):
    cfg = reduced(get_arch(arch))
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    assert repr(tconfigs.get_arch(arch)) == repr(get_arch(arch))
    assert repr(tcfg) == repr(cfg)
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    assert tfingerprint(tcfg, tparams) == jfingerprint(cfg, params)
    assert tfingerprint(tcfg) == jfingerprint(cfg)
    paths = [keystr(p) for p, _ in tree_leaves_with_path(tparams)]
    assert paths == [jax.tree_util.keystr(p)
                     for p, _ in jax.tree_util.tree_leaves_with_path(params)]


def test_fingerprint_of_bf16_params_matches_reference():
    cfg = with_overrides(reduced(get_arch("granite-3-2b")), param_dtype="bfloat16")
    tcfg = tconfigs.with_overrides(tconfigs.reduced(tconfigs.get_arch("granite-3-2b")),
                                   param_dtype="bfloat16")
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    want = jfingerprint(cfg, params)
    assert tfingerprint(tcfg, tparams) == want
    # host arrays (BF16Array leaves) fingerprint the same as the tensors
    assert tfingerprint(tcfg, jax.tree_util.tree_map(lambda t: to_numpy(t), tparams)) == want
