"""The port's chunked cross-entropy (``xent_impl="chunked"``) against the
JAX package's ``_xent_chunked`` on the CPU, in float32.

Tolerances, and why:

* ``_xent_chunked`` alone, loss and the gradients of ``h`` and of the
  weight: 1e-5 relative to each one's largest value (float32; the
  reference's streaming logsumexp in the same order, its gradient through
  XLA's differentiation of the scan against the port's recomputed
  ``softmax - onehot``: the same sums in another order);
* the whole model's loss and gradients (``loss_fn`` with the chunked
  cross-entropy, through two reduced layers): 1e-4 of each leaf's largest
  gradient, the tolerance ``test_torch_train.py`` holds ``loss_fn`` to;
* chunked against full in the port: 1e-5 relative (float32 both ways).
"""
import dataclasses

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
from repro_torch.utils import keystr, tree_flatten, tree_leaves_with_path, tree_unflatten

B, S = 2, 8


def _cfgs(arch, **kw):
    cfg = dataclasses.replace(reduced(get_arch(arch)), **kw)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(arch)), **kw)
    return cfg, tcfg


def _inputs(cfg, seed):
    """h (B,S,d), the embedding tree and targets with IGNORE rows and a
    target in the pad columns (padded vocab 2048 over the real 257)."""
    rng = np.random.default_rng(seed)
    d, Vp = cfg.d_model, cfg.padded_vocab
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    emb = {"tok": (0.3 * rng.standard_normal((Vp, d))).astype(np.float32)}
    if not cfg.tie_embeddings:
        emb["head"] = (0.3 * rng.standard_normal((d, Vp))).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt[0, :3] = -1                       # IGNORE
    tgt[1, 5] = cfg.vocab_size + 3        # a pad column
    tgt[1, 6] = Vp - 1                    # the last pad column
    return h, emb, tgt


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("chunk", [256, 2048])
@pytest.mark.parametrize("tied", [True, False])
def test_xent_chunked_loss_and_grads_equal_reference(tied, chunk):
    cfg, tcfg = _cfgs("granite-3-2b", tie_embeddings=tied, xent_chunk=chunk)
    h, emb, tgt = _inputs(cfg, seed=3 + tied)
    wkey = "tok" if tied else "head"

    def ref(hh, w):
        return RM._xent_chunked(cfg, {"embed": {**emb, wkey: w}}, hh, jnp.asarray(tgt))

    loss_r, (dh_r, dw_r) = jax.value_and_grad(ref, argnums=(0, 1))(jnp.asarray(h),
                                                                  jnp.asarray(emb[wkey]))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(emb[wkey]).requires_grad_()
    tparams = {"embed": {**{k: torch.from_numpy(v) for k, v in emb.items()}, wkey: tw}}
    loss_t = TM._xent_chunked(tcfg, tparams, th, torch.from_numpy(tgt))
    dh_t, dw_t = torch.autograd.grad(loss_t, (th, tw))
    assert _rel(loss_t.item(), float(loss_r)) < 1e-5
    assert _rel(dh_t.numpy(), dh_r) < 1e-5
    assert _rel(dw_t.numpy(), dw_r) < 1e-5
    # the pad columns take no gradient, as the reference's where gives none
    pad = dw_t[cfg.vocab_size:] if tied else dw_t[:, cfg.vocab_size:]
    assert not pad.any()


@pytest.mark.parametrize("tied", [True, False])
def test_xent_chunked_equals_full_in_the_port(tied):
    _, tcfg = _cfgs("granite-3-2b", tie_embeddings=tied, xent_chunk=512)
    h, emb, tgt = _inputs(tcfg, seed=11)
    params = {"embed": {k: torch.from_numpy(v) for k, v in emb.items()}}
    th, tt = torch.from_numpy(h), torch.from_numpy(tgt)
    tt[1, 5:7] = 7                        # the full path gathers pad logits of -1e30
    chunked = TM._xent_chunked(tcfg, params, th, tt)
    full = TM._xent_full(tcfg, params, th, tt)
    assert _rel(chunked.item(), full.item()) < 1e-5


@pytest.mark.parametrize("chunk", [3, 1000, 4096])
def test_vocab_divisibility_fails_as_the_reference(chunk):
    cfg, tcfg = _cfgs("granite-3-2b", xent_chunk=chunk)
    h, emb, tgt = _inputs(cfg, seed=0)
    with pytest.raises(AssertionError):
        RM._xent_chunked(cfg, {"embed": emb}, jnp.asarray(h), jnp.asarray(tgt))
    with pytest.raises(AssertionError):
        TM._xent_chunked(tcfg, {"embed": {k: torch.from_numpy(v) for k, v in emb.items()}},
                         torch.from_numpy(h), torch.from_numpy(tgt))


def _saved_shapes(tcfg, tparams, batch) -> list:
    """The shape of every tensor autograd saves for the backward of
    loss_fn."""
    shapes: list = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    leaves, treedef = tree_flatten(tparams)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = TM.loss_fn(tcfg, tree_unflatten(treedef, live), batch)
    torch.autograd.grad(loss, live, allow_unused=True)
    return shapes


@pytest.mark.parametrize("arch", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_chunked_backward_keeps_no_logits(arch):
    cfg, tcfg = _cfgs(arch, xent_chunk=256)
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok), "targets": torch.from_numpy(np.roll(tok, -1, 1))}

    def logits_like(shape):             # (B, S, V) or (B*S, V), V >= one chunk
        return (len(shape) >= 2 and shape[-1] >= cfg.xent_chunk
                and int(np.prod(shape[:-1])) == B * S)

    full = _saved_shapes(dataclasses.replace(tcfg, xent_impl="full"), tparams, batch)
    chunked = _saved_shapes(dataclasses.replace(tcfg, xent_impl="chunked"), tparams, batch)
    assert any(logits_like(s) for s in full)        # the hook sees the full path's logits
    assert not any(logits_like(s) for s in chunked), chunked


@pytest.mark.parametrize("arch", ["granite-3-2b", "moonshot-v1-16b-a3b", "minicpm-2b"])
def test_loss_fn_chunked_matches_reference(arch):
    """The slice as a whole: ``loss_fn`` dispatching on ``xent_impl`` and
    its gradients, against ``jax.grad`` of the reference's."""
    cfg, tcfg = _cfgs(arch, xent_impl="chunked", xent_chunk=512)
    params = RM.init_params(cfg, jax.random.PRNGKey(2))
    tparams = from_numpy_tree(jax.tree_util.tree_map(np.asarray, params), "cpu")
    rng = np.random.default_rng(4)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt = np.roll(tok, -1, 1)
    tgt[:, -1] = -1
    (loss_r, _), g_r = jax.value_and_grad(
        lambda p: RM.loss_fn(cfg, p, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}),
        has_aux=True)(params)
    loss_t, _, g_t = loss_and_grads(tcfg, tparams, {"tokens": torch.from_numpy(tok),
                                                    "targets": torch.from_numpy(tgt)})
    assert _rel(loss_t.item(), float(loss_r)) < 1e-5
    ref_leaves = dict((keystr(p), np.asarray(x)) for p, x in
                      tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, g_r)))
    for path, g in tree_leaves_with_path(g_t):
        want = ref_leaves[keystr(path)]
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-12), (arch, keystr(path), err)
