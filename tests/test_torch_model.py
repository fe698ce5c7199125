"""The port's dense models against ``repro.models.model`` with the same
weights (made by the JAX package's ``init_params`` and carried over with
``from_numpy_tree``), on the reduced dense archs, in float32 on the CPU.

Tolerance 1e-4 against the reference (float32 sums in another order); the
cache-consistency property (prefill + decode == forward) keeps the
reference's own 2e-3 (``tests/test_decode_consistency.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced, with_overrides
from repro.models import model as RM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models.params import from_numpy_tree
from repro_torch.utils import tree_leaves, tree_leaves_with_path, keystr

ARCHS = ["granite-3-2b", "deepseek-7b", "minicpm-2b", "command-r-plus-104b"]
TOL = 1e-4
B, S, CACHE = 2, 12, 16


def _setup(arch, **overrides):
    cfg = with_overrides(reduced(get_arch(arch)), **overrides)
    tcfg = tconfigs.with_overrides(tconfigs.reduced(tconfigs.get_arch(arch)), **overrides)
    assert repr(cfg) == repr(tcfg)
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return cfg, tcfg, params, tparams, toks


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _clone_cache(cache):
    return {"layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]}


@pytest.fixture(scope="module", params=ARCHS)
def arch_setup(request):
    return _setup(request.param)


def test_forward_hidden_and_logits(arch_setup):
    cfg, tcfg, params, tparams, toks = arch_setup
    h, _ = RM.forward_hidden(cfg, params, {"tokens": jnp.asarray(toks)})
    th, aux = TM.forward_hidden(tcfg, tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(th), _np(h), atol=TOL, rtol=TOL)
    lg = RM.logits_from_hidden(cfg, params, h)
    tlg = TM.logits_from_hidden(tcfg, tparams, th)
    assert tlg.dtype == torch.float32 and tuple(tlg.shape) == lg.shape
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    assert float(aux) == 0.0


def test_loss_fn(arch_setup):
    cfg, tcfg, params, tparams, toks = arch_setup
    tgt = np.roll(toks, -1, axis=1)
    tgt[0, -1] = -1                                   # IGNORE
    loss, m = RM.loss_fn(cfg, params, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    tloss, tm = TM.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                           "targets": torch.from_numpy(tgt)})
    assert abs(float(tloss) - float(loss)) <= TOL
    assert abs(float(tm["xent"]) - float(m["xent"])) <= TOL


def test_prefill_and_decode_vs_reference(arch_setup):
    cfg, tcfg, params, tparams, toks = arch_setup
    lg, cache = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :8])}, CACHE)
    tlg, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :8])}, CACHE)
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for pos in range(8, S):
        nt = toks[:, pos:pos + 1]
        lg, cache = RM.decode_step(cfg, params, cache, {"tokens": jnp.asarray(nt),
                                                        "pos": jnp.int32(pos)})
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache, {"tokens": torch.from_numpy(nt),
                                                             "pos": pos})
        np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for a, b in zip(tree_leaves(tcache), jax.tree_util.tree_leaves(cache)):
        np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=TOL)


def test_prefill_plus_decode_equals_forward_on_port(arch_setup):
    _, tcfg, _, tparams, toks = arch_setup
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


def test_per_row_pos_equals_scalar_pos(arch_setup):
    _, tcfg, _, tparams, toks = arch_setup
    t = torch.from_numpy(toks)
    _, cache = TM.prefill(tcfg, tparams, {"tokens": t[:, :7]}, CACHE)
    nt = t[:, 7:8]
    lg_s, c_s = TM.decode_step(tcfg, tparams, _clone_cache(cache), {"tokens": nt, "pos": 7})
    lg_r, c_r = TM.decode_step(tcfg, tparams, _clone_cache(cache),
                               {"tokens": nt, "pos": torch.tensor([7, 7], dtype=torch.int32)})
    np.testing.assert_allclose(_np(lg_r), _np(lg_s), atol=1e-6)
    for a, b in zip(tree_leaves(c_r), tree_leaves(c_s)):
        assert torch.equal(a, b)


def test_cache_dtype_and_layout_match_reference(arch_setup):
    cfg, tcfg, params, tparams, toks = arch_setup
    ref_init = RM.init_cache(cfg, B, CACHE)                           # bf16 default
    port_init = TM.init_cache(tcfg, B, CACHE, device="cpu")
    for (p, a), (q, b) in zip(jax.tree_util.tree_leaves_with_path(ref_init),
                              tree_leaves_with_path(port_init)):
        assert jax.tree_util.keystr(p) == keystr(q)
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"
    # prefill: the cache takes the compute dtype whatever cache_dtype says
    _, rc = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :4])}, CACHE,
                       cache_dtype=jnp.bfloat16)
    _, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :4])}, CACHE,
                       cache_dtype=torch.bfloat16)
    for a, b in zip(jax.tree_util.tree_leaves(rc), tree_leaves(tc)):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}" == "torch.float32"


@pytest.mark.parametrize("arch", ["granite-3-2b", "command-r-plus-104b"])
def test_bf16_cache_override_decode(arch):
    """A bf16 cache under float32 compute stays bf16 through decode, and the
    logits match the reference's."""
    cfg, tcfg, params, tparams, toks = _setup(arch)
    cache = RM.init_cache(cfg, B, CACHE, dtype=jnp.bfloat16)
    tcache = TM.init_cache(tcfg, B, CACHE, dtype=torch.bfloat16, device="cpu")
    for pos in range(3):
        nt = toks[:, pos:pos + 1]
        lg, cache = RM.decode_step(cfg, params, cache, {"tokens": jnp.asarray(nt),
                                                        "pos": jnp.int32(pos)})
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache, {"tokens": torch.from_numpy(nt),
                                                             "pos": pos})
        np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for a, b in zip(jax.tree_util.tree_leaves(cache), tree_leaves(tcache)):
        assert b.dtype == torch.bfloat16 and str(a.dtype) == "bfloat16"
        # float32 keys differ by ~1e-7 before the cast: at most one bf16 ulp
        np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=2 ** -7)


def test_bf16_compute_prefill_cache_is_bf16():
    cfg, tcfg, params, tparams, toks = _setup("granite-3-2b", compute_dtype="bfloat16",
                                              param_dtype="bfloat16")
    _, rc = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :4])}, CACHE,
                       cache_dtype=jnp.float32)
    _, tc = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :4])}, CACHE,
                       cache_dtype=torch.float32)
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(rc)} == {"bfloat16"}
    assert {b.dtype for b in tree_leaves(tc)} == {torch.bfloat16}


@pytest.mark.parametrize("pos", ["scalar", "per_row"])
def test_decode_write_index_past_end_matches_reference(pos):
    """At pos >= S_max the reference clamps a scalar write index to S_max-1
    (dynamic_update_slice) and drops a per-row write past the end
    (out-of-bounds scatter); every cache row stays visible."""
    cfg, tcfg, params, tparams, toks = _setup("granite-3-2b")
    S_max = 8
    _, cache = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :S_max])}, S_max)
    _, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :S_max])}, S_max)
    p = np.array([S_max + 2, 5], np.int32) if pos == "per_row" else np.int32(S_max + 2)
    nt = toks[:, S_max:S_max + 1]
    lg, cache = RM.decode_step(cfg, params, cache, {"tokens": jnp.asarray(nt), "pos": jnp.asarray(p)})
    tlg, tcache = TM.decode_step(tcfg, tparams, tcache, {"tokens": torch.from_numpy(nt),
                                                         "pos": torch.from_numpy(np.asarray(p))})
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for a, b in zip(jax.tree_util.tree_leaves(cache), tree_leaves(tcache)):
        np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


def test_init_params_shapes_dtypes_scales_match_reference():
    cfg = get_arch("granite-3-2b")
    small = with_overrides(reduced(cfg), param_dtype="bfloat16", d_model=128, d_ff=256)
    tsmall = tconfigs.with_overrides(tconfigs.reduced(tconfigs.get_arch("granite-3-2b")),
                                     param_dtype="bfloat16", d_model=128, d_ff=256)
    ref = RM.init_params(small, jax.random.PRNGKey(0))
    port = TM.init_params(tsmall, 0, device="cpu")
    rl, pl_ = jax.tree_util.tree_leaves_with_path(ref), tree_leaves_with_path(port)
    assert [jax.tree_util.keystr(p) for p, _ in rl] == [keystr(p) for p, _ in pl_]
    for (_, a), (_, b) in zip(rl, pl_):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"
        sa, sb = float(jnp.std(a.astype(jnp.float32))), float(b.float().std())
        assert abs(sa - sb) <= 0.1 * sa + 1e-6, (sa, sb)
    again = TM.init_params(tsmall, 0, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(port), tree_leaves(again)))


def test_non_dense_families_raise():
    for arch in ["mamba2-130m", "moonshot-v1-16b-a3b", "whisper-medium"]:
        with pytest.raises(NotImplementedError):
            TM.param_specs(tconfigs.reduced(tconfigs.get_arch(arch)))
