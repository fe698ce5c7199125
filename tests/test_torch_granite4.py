"""granite-4.0-h's departures from the port's other models, on the CPU:
attention without RoPE and with its own score scale against PyTorch's
plain SDPA; granite's scalar multipliers, wired where the published layer
puts them and leaving every other model bit-identical at their defaults
(and its config's repr, so its fingerprint, the JAX package's); and a MoE
layer's stages and wrapper counter in a traced call."""
import math
from dataclasses import replace

import pytest
import torch
import torch.nn.functional as F

from repro import configs as rconfigs
from repro_torch.configs import get_arch, reduced
from repro_torch.core.library import GRAPH_FAMILIES, make_model_library
from repro_torch.kernels import ops
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.obs import trace

TOL = 1e-5


def _granite4():
    return reduced(get_arch("granite-4.0-h-small"))


def _sdpa(cfg, p, x):
    """The attention layer by PyTorch's plain SDPA: no rotation, GQA by
    repeating the KV heads, the scores scaled by ``cfg.attention_multiplier``."""
    B, S, d = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"].reshape(d, -1)).view(B, S, H, hd).transpose(1, 2)
    k = (x @ p["wk"].reshape(d, -1)).view(B, S, K, hd).transpose(1, 2)
    v = (x @ p["wv"].reshape(d, -1)).view(B, S, K, hd).transpose(1, 2)
    o = F.scaled_dot_product_attention(q, k.repeat_interleave(H // K, 1),
                                       v.repeat_interleave(H // K, 1), is_causal=True,
                                       scale=cfg.attention_multiplier)
    return o.transpose(1, 2).reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, d)


def test_nope_attention_and_its_scale_against_plain_sdpa():
    cfg = _granite4()
    assert cfg.nope and not cfg.uses_rope and cfg.attn_scale == cfg.attention_multiplier
    assert cfg.attention_multiplier != cfg.head_dim ** -0.5
    p = M.init_params(cfg, 3, "cpu")["blocks"]["layers"][cfg.attn_offset]["attn"]
    p = {k: v[0] for k, v in p.items()}
    B, S = 2, 11
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(S)[None].expand(B, S)
    want = _sdpa(cfg, p, x)
    torch.testing.assert_close(attn.self_attention(cfg, p, x, pos, rope=cfg.uses_rope), want,
                               atol=TOL, rtol=TOL)
    cache = attn.init_attn_cache(cfg, B, S, torch.float32, "cpu")
    out, cache = attn.self_attention_prefill(cfg, p, x[:, :-1], pos[:, :-1], cache,
                                             rope=cfg.uses_rope)
    torch.testing.assert_close(out, want[:, :-1], atol=TOL, rtol=TOL)
    at = attn.decode_index(cfg, S - 1, B, S, "cpu", rope=cfg.uses_rope)
    assert at.tables is None
    last, _ = attn.self_attention_decode(cfg, p, x[:, -1:], cache, at, rope=cfg.uses_rope)
    torch.testing.assert_close(last, want[:, -1:], atol=TOL, rtol=TOL)
    # with RoPE the same layer is another function
    roped = attn.self_attention(replace(cfg, nope=False), p, x, pos, rope=True)
    assert not torch.allclose(roped, want, atol=1e-3)


@pytest.mark.parametrize("scale", [None, 0.0078125, 0.3])
def test_attention_ops_take_the_scale(scale):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(2, 7, n, 16, generator=g) for n in (4, 2, 2))
    want = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(2, 2).transpose(1, 2),
        v.repeat_interleave(2, 2).transpose(1, 2), is_causal=True, scale=scale).transpose(1, 2)
    torch.testing.assert_close(ops.flash_attention(q, k, v, scale=scale), want,
                               atol=TOL, rtol=TOL)
    kv = torch.tensor([7, 7])
    torch.testing.assert_close(ops.decode_attention(q[:, -1:], k, v, kv, scale=scale),
                               want[:, -1:], atol=TOL, rtol=TOL)


def _serve(cfg, params, prompt, steps=3):
    lib = make_model_library(cfg, max_cache_len=prompt.shape[1] + steps, device="cpu")
    state, out = {}, []
    logits = lib["prefill"](params, state, {"tokens": prompt})["logits"]
    out.append(logits)
    for _ in range(steps):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        logits = lib["decode"](params, state, {"tokens": tok})["logits"]
        out.append(logits)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multipliers_at_their_defaults_leave_granite_3_2b_bit_identical(dtype):
    """The defaults are the neutral values: no multiply, 1/sqrt(head_dim),
    epsilon 1e-6.  Setting each to that value by hand gives the same bits,
    and each non-neutral value reaches the output."""
    cfg = replace(reduced(get_arch("granite-3-2b")), param_dtype=dtype, compute_dtype=dtype)
    assert (cfg.embedding_multiplier, cfg.attention_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.norm_eps, cfg.nope) == (1.0, 0.0, 1.0, 1.0, 1e-6, False)
    params = M.init_params(cfg, 4, "cpu")
    prompt = torch.randint(0, cfg.vocab_size, (1, 9), generator=torch.Generator().manual_seed(5))
    base = _serve(cfg, params, prompt)
    neutral = replace(cfg, embedding_multiplier=1.0, attention_multiplier=cfg.head_dim ** -0.5,
                      residual_multiplier=1.0, logits_scaling=1.0, norm_eps=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(base, _serve(neutral, params, prompt)))
    for field, value in (("embedding_multiplier", 12.0), ("attention_multiplier", 1 / 16),
                         ("residual_multiplier", 0.22), ("logits_scaling", 8.0),
                         ("norm_eps", 1e-2), ("nope", True)):
        other = _serve(replace(cfg, **{field: value}), params, prompt, steps=0)[0]
        assert not torch.allclose(other, base[0], atol=1e-4), field


def test_configs_the_jax_package_shares_keep_its_repr():
    """The fields it lacks are left out of the repr at their defaults, so a
    host of either package finds the same model fingerprint."""
    for name in rconfigs.ARCH_IDS:
        assert repr(get_arch(name)) == repr(rconfigs.get_arch(name)), name
        assert repr(reduced(get_arch(name))) == repr(rconfigs.reduced(rconfigs.get_arch(name)))
    assert "dropless=True" in repr(get_arch("granite-4.0-h-small"))


def test_granite4_sizes_are_the_published():
    cfg = get_arch("granite-4.0-h-small")
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn"] == [5, 15, 25, 35]
    assert all(cfg.layer_has_moe(i) for i in range(cfg.num_layers))
    assert (cfg.d_model, cfg.head_dim, cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff,
            cfg.d_ff, cfg.padded_vocab) == (4096, 128, 72, 10, 768, 1536, 100352)
    assert cfg.ssm.n_heads(cfg.d_model) == 128 and cfg.ssm.head_dim == 64
    assert math.isclose(cfg.param_count() / 1e9, 32.2, abs_tol=0.05)
    assert cfg.family in GRAPH_FAMILIES


def test_a_traced_moe_call_books_its_stages_inside_ffn():
    cfg = _granite4()
    params = M.init_params(cfg, 6, "cpu")
    lib = make_model_library(cfg, max_cache_len=16, device="cpu")
    trace.CURRENT.stages = stages = trace.Stages()
    try:
        lib["prefill"](params, {}, {"tokens": torch.randint(0, cfg.vocab_size, (1, 12))})
    finally:
        trace.CURRENT.stages = None
    L = cfg.num_layers
    assert {k: v[2] for k, v in stages.spans.items()} == {
        "mixer": L, "ffn": L, "route": L, "experts": L, "shared": L}
    assert stages.wrappers["moe_experts"][0] == L
    inner = sum(stages.spans[k][1] for k in ("route", "experts", "shared"))
    assert 0 < inner <= stages.spans["ffn"][1]
    rec = trace.TraceRecord(fn="prefill")
    rec.merge({"spans": {"issue": 1.0}, "stages": stages.spans, "wrappers": stages.wrappers})
    parents = {s[0]: s[3] for s in rec.spans}
    assert parents == {"issue": None, "mixer": "issue", "ffn": "issue", "route": "ffn",
                       "experts": "ffn", "shared": "ffn"}
