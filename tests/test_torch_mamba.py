"""The port's mamba2 model (``repro_torch.models.mamba`` and the ``ssm``
family of the stack) against ``repro.models`` with the same weights (made
by the JAX package's ``init_params`` and carried over with
``from_numpy_tree``), on reduced mamba2-130m in float32 on the CPU.

Tolerance 1e-4 against the reference (float32 sums in another order); the
cache-consistency property (prefill + decode == forward) keeps the
reference's own 2e-3 (``tests/test_decode_consistency.py``).  The Mamba
initializers (``dt_bias``, ``A_log``) are deterministic numpy and must be
bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced, with_overrides
from repro.models import mamba as jmb
from repro.models import model as RM
from repro_torch import configs as tconfigs
from repro_torch.models import mamba as mb
from repro_torch.models import model as TM
from repro_torch.models.params import from_numpy_tree
from repro_torch.utils import keystr, tree_leaves, tree_leaves_with_path

ARCH = "mamba2-130m"
TOL = 1e-4
B, S, CACHE = 2, 12, 16


def _setup(**overrides):
    cfg = with_overrides(reduced(get_arch(ARCH)), **overrides)
    tcfg = tconfigs.with_overrides(tconfigs.reduced(tconfigs.get_arch(ARCH)), **overrides)
    assert repr(cfg) == repr(tcfg)
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tcfg, params, tparams, toks


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _clone(cache):
    return {"layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]}


def test_spec_tree_and_mamba_initializers_match_reference(setup):
    _, tcfg, ref, _, _ = setup
    port = TM.init_params(tcfg, 0, device="cpu")
    rl, pl_ = jax.tree_util.tree_leaves_with_path(ref), tree_leaves_with_path(port)
    assert [jax.tree_util.keystr(p) for p, _ in rl] == [keystr(p) for p, _ in pl_]
    assert any("['mamba']['A_log']" in keystr(p) for p, _ in pl_)
    assert not any("ffn_norm" in keystr(p) or "mlp" in keystr(p) for p, _ in pl_)
    for (path, a), (_, b) in zip(rl, pl_):
        name = jax.tree_util.keystr(path)
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}", name
        if name.endswith("['dt_bias']") or name.endswith("['A_log']"):
            assert np.array_equal(b.numpy(), np.asarray(a)), name          # bit-equal
    # the stacked dt_bias spreads its linspace over all L*nh values
    dtb = port["blocks"]["layers"][0]["mamba"]["dt_bias"]
    assert dtb.shape[0] == tcfg.num_layers and not torch.equal(dtb[0], dtb[1])


def test_forward_hidden_logits_and_loss(setup):
    cfg, tcfg, params, tparams, toks = setup
    h, _ = RM.forward_hidden(cfg, params, {"tokens": jnp.asarray(toks)})
    th, aux = TM.forward_hidden(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(th), _np(h), atol=TOL, rtol=TOL)
    lg = RM.logits_from_hidden(cfg, params, h)
    tlg = TM.logits_from_hidden(tcfg, tparams, th)
    assert tlg.dtype == torch.float32 and tuple(tlg.shape) == lg.shape
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    assert float(aux) == 0.0
    tgt = np.roll(toks, -1, axis=1)
    tgt[0, -1] = -1                                   # IGNORE
    loss, m = RM.loss_fn(cfg, params, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    tloss, tm = TM.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                           "targets": torch.from_numpy(tgt)})
    assert abs(float(tloss) - float(loss)) <= TOL
    assert abs(float(tm["xent"]) - float(m["xent"])) <= TOL


def test_prefill_logits_and_cache_vs_reference(setup):
    cfg, tcfg, params, tparams, toks = setup
    lg, cache = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :9])}, CACHE,
                           cache_dtype=jnp.bfloat16)
    tlg, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :9])}, CACHE,
                             cache_dtype=torch.bfloat16)
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    ref_leaves = jax.tree_util.tree_leaves_with_path(cache)
    port_leaves = tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in ref_leaves] == [keystr(p) for p, _ in port_leaves]
    for (_, a), (_, b) in zip(ref_leaves, port_leaves):
        # conv takes the compute dtype, ssm stays fp32, whatever cache_dtype says
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}" == "torch.float32"
        np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("pos_kind", ["scalar", "per_row"])
def test_decode_steps_vs_reference(setup, pos_kind):
    cfg, tcfg, params, tparams, toks = setup
    lg, cache = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :8])}, CACHE)
    tlg, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :8])}, CACHE)
    for pos in range(8, S):
        nt = toks[:, pos:pos + 1]
        p = np.full(B, pos, np.int32) if pos_kind == "per_row" else np.int32(pos)
        lg, cache = RM.decode_step(cfg, params, cache, {"tokens": jnp.asarray(nt),
                                                        "pos": jnp.asarray(p)})
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache, {"tokens": torch.from_numpy(nt),
                                                             "pos": torch.from_numpy(np.asarray(p))})
        np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for a, b in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(cache)):
        assert str(a.dtype) == f"torch.{b.dtype}"
        np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=TOL)


def test_prefill_plus_decode_equals_forward_on_port(setup):
    _, tcfg, _, tparams, toks = setup
    t = torch.from_numpy(toks)
    full = TM.logits_from_hidden(tcfg, tparams, TM.forward_hidden(tcfg, tparams, {"tokens": t})[0])
    lg, cache = TM.prefill(tcfg, tparams, {"tokens": t[:, :6]}, CACHE)
    steps = [lg]
    for pos in range(6, S):
        lg, cache = TM.decode_step(tcfg, tparams, cache, {"tokens": t[:, pos:pos + 1], "pos": pos})
        steps.append(lg)
    V = tcfg.vocab_size
    np.testing.assert_allclose(_np(torch.cat(steps, 1))[..., :V], _np(full[:, 5:])[..., :V],
                               atol=2e-3, rtol=2e-3)


def test_decode_writes_the_stacked_cache_in_place(setup):
    _, tcfg, _, tparams, toks = setup
    t = torch.from_numpy(toks)
    _, cache = TM.prefill(tcfg, tparams, {"tokens": t[:, :7]}, CACHE)
    before = _clone(cache)
    ptrs = [x.data_ptr() for x in tree_leaves(cache)]
    _, after = TM.decode_step(tcfg, tparams, cache, {"tokens": t[:, 7:8], "pos": 7})
    assert [x.data_ptr() for x in tree_leaves(after)] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(tree_leaves(after), tree_leaves(before)))


def test_fresh_cache_layout_and_bf16_conv_cache_decode(setup):
    """``init_cache`` gives conv in its ``dtype`` and ssm in fp32, as the
    reference's; decoding from a bf16 cache under float32 compute returns
    the conv window in float32, as the reference does, with its logits."""
    cfg, tcfg, params, tparams, toks = setup
    cache = RM.init_cache(cfg, B, CACHE, dtype=jnp.bfloat16)
    tcache = TM.init_cache(tcfg, B, CACHE, dtype=torch.bfloat16, device="cpu")
    for (p, a), (q, b) in zip(jax.tree_util.tree_leaves_with_path(cache),
                              tree_leaves_with_path(tcache)):
        assert jax.tree_util.keystr(p) == keystr(q)
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"
    for pos in range(3):
        nt = toks[:, pos:pos + 1]
        lg, cache = RM.decode_step(cfg, params, cache, {"tokens": jnp.asarray(nt),
                                                        "pos": jnp.int32(pos)})
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache, {"tokens": torch.from_numpy(nt),
                                                             "pos": pos})
        np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for a, b in zip(jax.tree_util.tree_leaves(cache), tree_leaves(tcache)):
        assert str(b.dtype) == f"torch.{a.dtype}" == "torch.float32"
        np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


def test_bf16_compute_prefill_cache_dtypes():
    cfg, tcfg, params, tparams, toks = _setup(compute_dtype="bfloat16", param_dtype="bfloat16")
    _, rc = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :4])}, CACHE,
                       cache_dtype=jnp.float32)
    _, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :4])}, CACHE,
                       cache_dtype=torch.float32)
    got = {keystr(p): str(b.dtype) for p, b in tree_leaves_with_path(tc)}
    want = {jax.tree_util.keystr(p): f"torch.{a.dtype}"
            for p, a in jax.tree_util.tree_leaves_with_path(rc)}
    assert got == want
    assert sorted(got.values()) == ["torch.bfloat16", "torch.float32"]


# ---------------------------------------------------------------------------
# the mixer's pieces, one layer
# ---------------------------------------------------------------------------

def _layer(params, i=0):
    return jax.tree_util.tree_map(lambda x: x[i], params["blocks"]["layers"][0]["mamba"])


def test_mamba_forward_and_decode_one_layer_vs_reference(setup):
    cfg, tcfg, params, _, _ = setup
    p = _layer(params)
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, p), "cpu")
    x = np.random.default_rng(2).standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    out, cache = jmb.mamba_forward(cfg, p, jnp.asarray(x[:, :10]), return_cache=True)
    tout, tcache = mb.mamba_forward(tcfg, tp, torch.from_numpy(x[:, :10]), return_cache=True)
    np.testing.assert_allclose(_np(tout), _np(out), atol=TOL, rtol=TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tcache[k]), _np(cache[k]), atol=TOL, rtol=TOL)
    out, cache = jmb.mamba_decode(cfg, p, jnp.asarray(x[:, 10:]), cache)
    tout, tcache = mb.mamba_decode(tcfg, tp, torch.from_numpy(x[:, 10:]), tcache)
    np.testing.assert_allclose(_np(tout), _np(out), atol=TOL, rtol=TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tcache[k]), _np(cache[k]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S_", [1, 2, 7])
def test_causal_conv_and_short_prompt_window_vs_reference(setup, S_):
    """The conv (one over the concatenated x/B/C channels) and the cache
    window, left-padded when the prompt is shorter than ck - 1."""
    cfg, tcfg, params, _, _ = setup
    p = _layer(params, 1)
    tp = from_numpy_tree(jax.tree_util.tree_map(np.asarray, p), "cpu")
    x = np.random.default_rng(3).standard_normal((B, S_, cfg.d_model)).astype(np.float32)
    out, cache = jmb.mamba_forward(cfg, p, jnp.asarray(x), return_cache=True)
    tout, tcache = mb.mamba_forward(tcfg, tp, torch.from_numpy(x), return_cache=True)
    np.testing.assert_allclose(_np(tout), _np(out), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(_np(tcache["conv"]), _np(cache["conv"]), atol=TOL, rtol=TOL)
    w = np.asarray(p["conv_x"])
    xs = np.random.default_rng(4).standard_normal((B, S_, w.shape[1])).astype(np.float32)
    np.testing.assert_allclose(_np(mb._causal_conv(torch.from_numpy(xs), torch.from_numpy(w),
                                                   torch.from_numpy(np.asarray(p["conv_bx"])))),
                               _np(jmb._causal_conv(jnp.asarray(xs), p["conv_x"], p["conv_bx"])),
                               atol=TOL, rtol=TOL)


def test_gated_norm_goes_through_the_rmsnorm_op(setup, monkeypatch):
    from repro_torch.kernels import ops
    cfg, _, params, _, _ = setup
    rng = np.random.default_rng(4)
    di = cfg.ssm.d_inner(cfg.d_model)
    y, z = (rng.standard_normal((B, 3, di)).astype(np.float32) for _ in range(2))
    scale = np.asarray(_layer(params)["norm_scale"]) + rng.standard_normal(di).astype(np.float32)
    want = jmb._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(scale))
    calls = []
    real = ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm", lambda x, s, **kw: calls.append(x.dtype) or real(x, s, **kw))
    got = mb._gated_norm(torch.from_numpy(y), torch.from_numpy(z), torch.from_numpy(scale))
    assert calls == [torch.float32]
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
