"""The port's other model families against ``repro.models.model`` with the
same weights (made by the JAX package's ``init_params``, carried over with
``from_numpy_tree``), on the reduced configs in float32 on the CPU:
jamba (hybrid: mamba and attention layers in one block, MoE on odd layers),
moonshot and arctic (MoE; arctic with its dense residual MLP),
llama-3.2-vision (cross-attention to vision rows every 5th layer) and
whisper (encoder-decoder, layernorm and gelu, sinusoidal positions).

The cross-attention gates are zeros at init (``tanh(0) = 0`` would hide the
cross path), so both packages get the same non-zero gates here.

Tolerances: 1e-4 against the reference (float32 sums in another order), as
``tests/test_torch_model.py``; prefill + decode against the port's own
forward at the reference's 2e-3 (``tests/test_decode_consistency.py``);
gradients within 1e-4 of each leaf's largest, as ``tests/test_torch_train.py``
(and no tighter than 1e-7 of the largest leaf's: whisper's key biases have
a gradient that is zero up to rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.models import model as RM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models.params import from_numpy_tree
from repro_torch.train.steps import loss_and_grads
from repro_torch.utils import keystr, tree_leaves, tree_leaves_with_path

ARCHS = ["jamba-1.5-large-398b", "moonshot-v1-16b-a3b", "arctic-480b",
         "llama-3.2-vision-90b", "whisper-medium"]
TOL = 1e-4
B, S, CACHE, P = 2, 12, 16, 8


def with_cross_gates(params, value: float = 0.7):
    """``params`` with every ``cross_gate`` leaf set to ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, value, x.dtype)
        if "cross_gate" in jax.tree_util.keystr(path) else x, params)


def family_batch(cfg, rng, batch: int = B, seq: int = S) -> dict:
    """Tokens, targets (one IGNORE) and the family's extra input, as numpy."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[0, -1] = -1
    out = {"tokens": toks, "targets": tgt}
    if cfg.family == "vlm":
        out["vision"] = (0.5 * rng.standard_normal(
            (batch, cfg.num_vision_tokens, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = (0.5 * rng.standard_normal(
            (batch, cfg.num_audio_frames, cfg.d_model))).astype(np.float32)
    return out


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    name = request.param
    cfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    assert repr(cfg) == repr(tcfg)
    params = with_cross_gates(jax.tree_util.tree_map(
        np.asarray, RM.init_params(cfg, jax.random.PRNGKey(0))))
    batch = family_batch(cfg, np.random.default_rng(1))
    return name, cfg, tcfg, params, from_numpy_tree(params, "cpu"), batch


def _decode_batch(cfg, batch, t, tensors: bool):
    db = {"tokens": batch["tokens"][:, t:t + 1], "pos": t}
    if cfg.family == "vlm":
        db["vision"] = batch["vision"]
    if tensors:
        return {**_tb({k: v for k, v in db.items() if k != "pos"}), "pos": t}
    return {**_jb({k: v for k, v in db.items() if k != "pos"}), "pos": jnp.int32(t)}


def test_forward_hidden_and_logits(setup):
    _, cfg, tcfg, params, tparams, batch = setup
    h, aux = RM.forward_hidden(cfg, params, _jb(batch))
    th, taux = TM.forward_hidden(tcfg, tparams, _tb(batch))
    np.testing.assert_allclose(_np(th), _np(h), atol=TOL, rtol=TOL)
    tlg = TM.logits_from_hidden(tcfg, tparams, th)
    np.testing.assert_allclose(_np(tlg), _np(RM.logits_from_hidden(cfg, params, h)),
                               atol=TOL, rtol=TOL)
    assert taux.dtype == torch.float32 and taux.ndim == 0
    assert abs(float(taux) - float(aux)) <= TOL * max(1.0, abs(float(aux)))
    assert (float(taux) > 0) == (tcfg.moe is not None)


def test_score_loss_with_aux(setup):
    _, cfg, tcfg, params, tparams, batch = setup
    loss, m = RM.loss_fn(cfg, params, _jb(batch))
    tloss, tm = TM.loss_fn(tcfg, tparams, _tb(batch))
    for k in ("loss", "xent", "aux"):
        assert abs(float(tm[k]) - float(m[k])) <= TOL, k
    assert float(tm["loss"]) == pytest.approx(float(tm["xent"]) + float(tm["aux"]), abs=1e-6)


def test_prefill_and_decode_vs_reference(setup):
    _, cfg, tcfg, params, tparams, batch = setup
    pb = {k: (v[:, :P] if k in ("tokens", "targets") else v) for k, v in batch.items()}
    lg, cache = RM.prefill(cfg, params, _jb(pb), CACHE)
    tlg, tcache = TM.prefill(tcfg, tparams, _tb(pb), CACHE)
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for t in range(P, S):
        lg, cache = RM.decode_step(cfg, params, cache, _decode_batch(cfg, batch, t, False))
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache, _decode_batch(cfg, batch, t, True))
        np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    rl, tl = jax.tree_util.tree_leaves_with_path(cache), tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in rl] == [keystr(p) for p, _ in tl]
    for (_, a), (_, b) in zip(rl, tl):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


def test_prefill_plus_decode_equals_forward_on_port(setup):
    _, cfg, tcfg, _, tparams, batch = setup
    full = TM.logits_from_hidden(tcfg, tparams, TM.forward_hidden(tcfg, tparams, _tb(batch))[0])
    pb = {k: (v[:, :P] if k in ("tokens", "targets") else v) for k, v in batch.items()}
    lg, cache = TM.prefill(tcfg, tparams, _tb(pb), CACHE)
    steps = [lg]
    for t in range(P, S):
        lg, cache = TM.decode_step(tcfg, tparams, cache, _decode_batch(cfg, batch, t, True))
        steps.append(lg)
    V = tcfg.vocab_size
    np.testing.assert_allclose(_np(torch.cat(steps, 1))[..., :V], _np(full[:, P - 1:])[..., :V],
                               atol=2e-3, rtol=2e-3)


def test_loss_fn_gradients_match_jax_grad(setup):
    _, cfg, tcfg, params, tparams, batch = setup
    (loss, _), grads = jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, p, _jb(batch)), has_aux=True)(params)
    tloss, tm, tgrads = loss_and_grads(tcfg, tparams, _tb(batch))
    assert float(tloss) == pytest.approx(float(loss), rel=1e-5)
    rflat = jax.tree_util.tree_leaves_with_path(grads)
    tflat = tree_leaves_with_path(tgrads)
    assert [jax.tree_util.keystr(p) for p, _ in rflat] == [keystr(p) for p, _ in tflat]
    # a key bias shifts every score of a query alike, so its gradient is
    # zero up to rounding (~1e-9 here): leaves are held to 1e-4 of their
    # largest gradient, and no tighter than 1e-7 of the largest overall
    gmax = max(float(np.abs(np.asarray(r)).max()) for _, r in rflat)
    for (path, r), (_, t) in zip(rflat, tflat):
        r = np.asarray(r, np.float32)
        assert tuple(t.shape) == r.shape
        assert np.abs(_np(t) - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-3 * gmax), \
            jax.tree_util.keystr(path)


def test_per_row_pos_equals_scalar_pos(setup):
    """Continuous batching's per-row positions give the scalar-position
    step when they agree (cross-attention and MoE rows included)."""
    _, cfg, tcfg, _, tparams, batch = setup
    pb = {k: (v[:, :P] if k in ("tokens", "targets") else v) for k, v in batch.items()}
    _, c1 = TM.prefill(tcfg, tparams, _tb(pb), CACHE)
    _, c2 = TM.prefill(tcfg, tparams, _tb(pb), CACHE)
    db = _decode_batch(cfg, batch, P, True)
    lg_s, c1 = TM.decode_step(tcfg, tparams, c1, db)
    lg_r, c2 = TM.decode_step(tcfg, tparams, c2, {**db, "pos": torch.full((B,), P,
                                                                          dtype=torch.int32)})
    np.testing.assert_allclose(_np(lg_r), _np(lg_s), atol=1e-6)
    for a, b in zip(tree_leaves(c1), tree_leaves(c2)):
        assert torch.equal(a, b)
