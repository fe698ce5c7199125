"""jamba-1.5-large-398b's published SSD widths (head dim 128, d_state 128)
through the port against ``repro.models.model``, in float32 on the CPU.

The reduced config keeps jamba's family (attention every 8th layer, MoE on
the odd ones) at narrow widths, with the SSM given jamba's published head
dim and state dim and a d_model of 128, so that the mixer has two SSD heads
of 128 columns.  The weights are made by the JAX package's ``init_params``
and the same numpy tree goes to both packages.  Tolerances are
``tests/test_torch_families.py``'s: 1e-4 (float32 sums in another order).

Also here: ``chip_smoke.py``'s cut of the published config to 3 layers
(``cut_depth``, which phase 10c serves at full width on the card) builds
the same layers in the port as in the reference -- attention with a dense
FFN, mamba with the MoE, mamba with a dense FFN -- with every parameter's
shape as published.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import get_arch, with_overrides
from repro.models import model as RM
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.models.params import from_numpy_tree
from repro_torch.utils import keystr, tree_leaves_with_path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4
B, S, CACHE, PROMPT = 2, 12, 16, 8


def narrow(mod):
    """``mod``'s reduced jamba with the published SSD head dim and state dim
    (chunk 8: the 8-token prompt is one chunk, the 12-token score a whole
    chunk and a ragged one)."""
    cfg = mod.reduced(mod.get_arch(ARCH))
    return dataclasses.replace(cfg, d_model=128, ssm=mod.SSMConfig(
        d_state=128, expand=2, head_dim=128, conv_kernel=4, chunk=8, n_groups=1))


@pytest.fixture(scope="module")
def setup():
    cfg, tcfg = narrow(rconfigs), narrow(tconfigs)
    assert repr(cfg) == repr(tcfg)
    assert cfg.ssm.n_heads(cfg.d_model) == 2 and cfg.ssm.head_dim == cfg.ssm.d_state == 128
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt = np.roll(toks, -1, axis=1)
    tgt[0, -1] = -1
    return cfg, tcfg, params, from_numpy_tree(params, "cpu"), toks, tgt


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def test_prefill_and_four_decode_steps(setup):
    cfg, tcfg, params, tparams, toks, _ = setup
    lg, cache = RM.prefill(cfg, params, {"tokens": jnp.asarray(toks[:, :PROMPT])}, CACHE)
    tlg, tcache = TM.prefill(tcfg, tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT])}, CACHE)
    np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    for t in range(PROMPT, PROMPT + 4):
        lg, cache = RM.decode_step(cfg, params, cache,
                                   {"tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        tlg, tcache = TM.decode_step(tcfg, tparams, tcache,
                                     {"tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
        np.testing.assert_allclose(_np(tlg), _np(lg), atol=TOL, rtol=TOL)
    # the SSM states after the steps: (B, H, P, N) = (2, 2, 128, 128) a layer
    rl, tl = jax.tree_util.tree_leaves_with_path(cache), tree_leaves_with_path(tcache)
    assert [jax.tree_util.keystr(p) for p, _ in rl] == [keystr(p) for p, _ in tl]
    assert any(tuple(b.shape)[-3:] == (2, 128, 128) for _, b in tl)
    for (_, a), (_, b) in zip(rl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(_np(b), _np(a), atol=TOL, rtol=TOL)


def test_score_loss(setup):
    cfg, tcfg, params, tparams, toks, tgt = setup
    _, m = RM.loss_fn(cfg, params, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    _, tm = TM.loss_fn(tcfg, tparams, {"tokens": torch.from_numpy(toks),
                                       "targets": torch.from_numpy(tgt)})
    for k in ("loss", "xent", "aux"):
        assert abs(float(tm[k]) - float(m[k])) <= TOL, k
    assert float(tm["aux"]) > 0                     # the MoE layers ran


def _layer_kinds(leaves):
    """(mixer, FFN) of each layer of one block, read from parameter paths."""
    kinds = {}
    for path in leaves:
        if "['layers']" not in path:
            continue
        i = int(path.split("['layers'][")[1].split("]")[0])
        mixer, ffn = kinds.get(i, (None, None))
        mixer = "attn" if "['attn']" in path else "mamba" if "['mamba']" in path else mixer
        ffn = "moe" if "['moe']" in path else "dense" if "['mlp']" in path else ffn
        kinds[i] = (mixer, ffn)
    return [kinds[i] for i in sorted(kinds)]


def test_three_layer_cut_has_each_kind_of_layer_at_published_widths():
    tcfg = chip_smoke.cut_depth(tconfigs.get_arch(ARCH), 3)
    cfg = with_overrides(get_arch(ARCH), num_layers=3, attn_every=tcfg.attn_every)
    assert repr(cfg) == repr(tcfg)
    full = get_arch(ARCH)
    for k in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size", "moe",
              "ssm"):
        assert getattr(cfg, k) == getattr(full, k), k
    ref = {jax.tree_util.keystr(p): tuple(a.shape) for p, a in jax.tree_util.tree_leaves_with_path(
        jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0))))}
    port = {keystr(p): tuple(t.shape) for p, t in tree_leaves_with_path(TM.abstract_params(tcfg))}
    assert port == ref
    want = [("attn", "dense"), ("mamba", "moe"), ("mamba", "dense")]
    assert _layer_kinds(ref) == _layer_kinds(port) == want
    assert [(tcfg.layer_kind(i), "moe" if tcfg.layer_has_moe(i) else "dense")
            for i in range(3)] == want
    assert sum(int(np.prod(s)) for s in port.values()) == 12_908_358_912
    assert full.ssm.head_dim == full.ssm.d_state == 128
