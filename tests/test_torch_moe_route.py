"""``ops.moe_route`` and ``ops.moe_combine``: a dropless MoE's routing and
combine around ``ops.moe_experts`` (``kernels/moe_route.py``,
``csrc/moe_route.cu``), and the MoE's aux loss left out of prefills and
decodes.

On the CPU: the plain versions against the chain ``models/moe.py`` ran before
the kernels (written out below as it was), bit for bit; a reduced
granite-4.0-h-small's decode calling each op once a MoE layer, a prefill over
the kernel's limit taking the chain, no aux loss outside training and the same
logits as the mode-less path; the kernels' argument checks.  On the card
(``-m card``): the kernels against the plain versions forced there, at
granite-4.0-h-small's published widths and the reduced ones, and a replayed
decode of the reduced model against its eager steps, with the kernels'
launches counted in a device trace.  This file imports no JAX, so it runs on
the card's host without the directory's ``conftest.py``:
``PYTHONPATH=src python -m pytest --noconftest -m card tests/test_torch_moe_route.py``."""
import re
import time
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_arch, with_overrides
from repro_torch.configs.base import reduced
from repro_torch.kernels import moe_route as mr
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks
from repro_torch.models import moe as moe_mod

BF16, F32 = torch.bfloat16, torch.float32
#: (E, k, d): granite-4.0-h-small's published widths, the reduced config's,
#: and one between
WIDTHS = [(72, 10, 4096), (4, 2, 64), (16, 4, 128)]


def _inputs(T, E, k, d, *, dtype=BF16, device="cpu", seed=0):
    """(x (T, d), router (d, E) fp32, out (T*k, d), shared (T, d)) at the
    model's magnitudes: x normed, the router at its init scale."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(T, d, generator=g).to(device=device, dtype=dtype)
    router = (torch.randn(d, E, generator=g) * d ** -0.5).to(device)
    out = torch.randn(T * k, d, generator=g).to(device=device, dtype=dtype)
    shared = torch.randn(T, d, generator=g).to(device=device, dtype=dtype)
    return x, router, out, shared


def _seed_chain(x, router, k, out, shared):
    """The dropless routing and combine as ``models/moe.py`` composed them
    before the kernels -> (rows, ends, w, sort_idx, y)."""
    d, E = x.shape[-1], router.shape[1]
    xt = x.reshape(1, -1, d)
    T = xt.shape[1]
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(T * k)
    sort_idx = torch.argsort(flat_e, stable=True)
    ends = torch.searchsorted(flat_e[sort_idx], torch.arange(E, device=x.device), right=True)
    rows = xt[0].index_select(0, sort_idx // k)
    w = top_p.reshape(T * k)[sort_idx].to(x.dtype)
    contrib = out * w[:, None]
    y = contrib.new_empty(contrib.shape).index_copy_(0, sort_idx, contrib)
    y = y.reshape(T, k, d).sum(dim=1)
    if shared is not None:
        y = y + shared
    return rows, ends, w, sort_idx, y


# ---------------------------------------------------------------------------
# CPU: the plain versions are the seed's chain, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,d", WIDTHS)
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("with_shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_plain_route_and_combine_are_the_seed_chain_bit_for_bit(E, k, d, T, with_shared, dtype):
    x, router, out, shared = _inputs(T, E, k, d, dtype=dtype, seed=E + T)
    shared = shared if with_shared else None
    rows0, ends0, w0, idx0, y0 = _seed_chain(x, router, k, out, shared)
    rows, ends, w, order = ops.moe_route(x, router, k)
    assert ends.dtype == order.dtype == torch.int32 and w.dtype == rows.dtype == dtype
    assert torch.equal(rows, rows0) and torch.equal(ends, ends0.to(torch.int32))
    assert torch.equal(w, w0) and torch.equal(order, idx0.to(torch.int32))
    y = ops.moe_combine(out, w, order, k, shared)
    assert y.dtype == dtype and torch.equal(y, y0)


def _granite4(dtype="float32"):
    from repro_torch.models import model as M

    cfg = with_overrides(reduced(get_arch("granite-4.0-h-small")), param_dtype=dtype,
                         compute_dtype=dtype)
    return cfg, M.init_params(cfg, 3, device="cpu")


def _tokens(cfg, B, S, seed=1):
    return torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(seed))


def _count_calls(monkeypatch) -> list:
    """Record the model's calls of the two ops and of the chain's plain
    steps (``models/moe.py``'s own references, so the ops' plain versions on
    the CPU count as the ops) by name, in order."""
    calls = []

    def counting(name, real):
        return lambda *a, **kw: calls.append(name) or real(*a, **kw)
    for name in ("moe_route", "moe_combine"):
        monkeypatch.setattr(ops, name, counting(name, getattr(ops, name)))
    monkeypatch.setattr(moe_mod, "ref", SimpleNamespace(
        moe_dispatch=counting("moe_dispatch", ref.moe_dispatch),
        moe_combine=counting("plain_combine", ref.moe_combine)))
    return calls


@pytest.mark.parametrize("B", [1, 2])
def test_model_decode_calls_each_op_once_a_moe_layer(B, monkeypatch):
    """A reduced granite-4.0-h-small's decode step routes and combines
    through ``ops.moe_route`` and ``ops.moe_combine``, once each a MoE layer,
    and runs no step of the chain."""
    from repro_torch.models import model as M

    cfg, params = _granite4()
    tokens = _tokens(cfg, B, 5)
    _, cache = M.prefill(cfg, params, {"tokens": tokens}, 16)
    calls = _count_calls(monkeypatch)
    M.decode_step(cfg, params, cache, {"tokens": tokens[:, :1], "pos": 5})
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.num_layers))
    assert n_moe > 0
    assert calls == ["moe_route", "moe_combine"] * n_moe


@pytest.mark.parametrize("S,fused", [(130, True), (257, False)])
def test_prefill_takes_the_kernels_within_their_limit_and_the_chain_over_it(S, fused,
                                                                             monkeypatch):
    """A prefill whose T*k assignments the route kernel sorts takes the ops;
    one over ``MAX_ROWS`` (k 2: 257 tokens) takes the plain chain."""
    from repro_torch.models import model as M

    cfg, params = _granite4()
    assert (S * cfg.moe.top_k <= mr.MAX_ROWS) == fused
    calls = _count_calls(monkeypatch)
    M.prefill(cfg, params, {"tokens": _tokens(cfg, 1, S)}, S + 8)
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.num_layers))
    want = ["moe_route", "moe_combine"] if fused else ["moe_dispatch", "plain_combine"]
    assert calls == want * n_moe


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_compute_no_aux_and_keep_their_logits(dtype, monkeypatch):
    """Outside training no MoE computes its aux loss, each layer's aux is
    0.0, and the logits are those of the mode-less path (the seed's, which
    computes the aux and runs the chain), bit for bit."""
    from repro_torch.models import model as M

    cfg, params = _granite4(dtype)
    tokens = _tokens(cfg, 2, 7)
    real_apply = moe_mod.apply_moe
    seen, aux_calls = [], []

    def apply_moe(cfg_, p, x, mode=None):
        y, aux = real_apply(cfg_, p, x, mode)
        seen.append((mode, aux))
        return y, aux
    real_aux = moe_mod._aux_loss
    monkeypatch.setattr(blocks, "apply_moe", apply_moe)
    monkeypatch.setattr(moe_mod, "_aux_loss",
                        lambda *a, **kw: aux_calls.append(1) or real_aux(*a, **kw))
    with torch.inference_mode():
        lg, cache = M.prefill(cfg, params, {"tokens": tokens}, 16)
        lg2, _ = M.decode_step(cfg, params, cache, {"tokens": tokens[:, :1], "pos": 7})
    assert not aux_calls
    assert {m for m, _ in seen} == {"prefill", "decode"}
    assert all(isinstance(a, float) and a == 0.0 for _, a in seen)

    # the seed's path: every MoE called without a mode
    monkeypatch.setattr(blocks, "apply_moe", lambda cfg_, p, x, mode=None: real_apply(cfg_, p, x))
    with torch.inference_mode():
        want, cache = M.prefill(cfg, params, {"tokens": tokens}, 16)
        want2, _ = M.decode_step(cfg, params, cache, {"tokens": tokens[:, :1], "pos": 7})
    assert aux_calls
    assert torch.equal(lg, want) and torch.equal(lg2, want2)


def test_training_and_modeless_calls_keep_the_aux_loss():
    """``mode`` "train" gives the mode-less call's output and aux loss, bit
    for bit, and the aux is a tensor that autograd records; a decode's is
    0.0."""
    cfg, params = _granite4()

    def first(tree):                      # the first block's layer of the stacked leaves
        return {k: first(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}
    p = first(params["blocks"]["layers"][0]["moe"])
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(4))
    y0, aux0 = moe_mod.apply_moe(cfg, p, x)
    y1, aux1 = moe_mod.apply_moe(cfg, p, x, "train")
    y2, aux2 = moe_mod.apply_moe(cfg, p, x, "decode")
    assert torch.is_tensor(aux0) and aux0.item() > 0 and torch.equal(aux0, aux1)
    assert torch.equal(y0, y1) and torch.equal(y0, y2) and aux2 == 0.0
    router = p["router"].detach().requires_grad_(True)
    _, aux = moe_mod.apply_moe(cfg, dict(p, router=router), x, "train")
    aux.backward()
    assert router.grad is not None and router.grad.abs().sum() > 0


def _bad_route(case):
    kw = dict(T=2, E=8, k=2, d=64)
    if case == "e_not_multiple_of_4":
        kw["E"] = 6
    elif case == "e_over_max":
        kw["E"] = mr.MAX_E + 4
    elif case == "k_over_max":
        kw.update(E=64, k=mr.MAX_K + 1)
    elif case == "k_over_e":
        kw.update(E=4, k=5)
    elif case == "k_zero":
        kw["k"] = 0
    elif case == "rows_over_max":
        kw.update(T=mr.MAX_ROWS // 2 + 1)
    elif case == "d_not_multiple_of_8":
        kw["d"] = 60
    x, router, _, _ = _inputs(kw["T"], kw["E"], max(kw["k"], 1), kw["d"])
    if case == "fp32_x":
        x = x.float()
    elif case == "bf16_router":
        router = router.to(BF16)
    elif case == "x_3d":
        x = x[None]
    elif case == "router_rows":
        router = router[1:]
    return x, router, kw["k"]


@pytest.mark.parametrize("case", ["e_not_multiple_of_4", "e_over_max", "k_over_max",
                                  "k_over_e", "k_zero", "rows_over_max",
                                  "d_not_multiple_of_8", "fp32_x", "bf16_router", "x_3d",
                                  "router_rows"])
def test_unsupported_route_arguments_raise(case):
    with pytest.raises((ValueError, TypeError)):
        mr.check_route_args(*_bad_route(case))


def _bad_combine(case):
    T, k, d = 2, 2, 64
    _, _, out, shared = _inputs(T, 4, k, d)
    w = torch.rand(T * k).to(BF16)
    order = torch.randperm(T * k).to(torch.int32)
    if case == "w_short":
        w = w[:-1]
    elif case == "order_int64":
        order = order.long()
    elif case == "shared_shape":
        shared = shared[:, :-8]
    elif case == "out_fp32":
        out = out.float()
    elif case == "k_over_max":
        k = mr.MAX_K + 1
    elif case == "rows_not_multiple_of_k":
        k = 3
    elif case == "rows_over_max":
        out, w = out.repeat(mr.MAX_ROWS // 2, 1), w.repeat(mr.MAX_ROWS // 2)
        order = torch.arange(out.shape[0], dtype=torch.int32)
        shared = None
    return out, w, order, k, shared


@pytest.mark.parametrize("case", ["w_short", "order_int64", "shared_shape", "out_fp32",
                                  "k_over_max", "rows_not_multiple_of_k", "rows_over_max"])
def test_unsupported_combine_arguments_raise(case):
    with pytest.raises((ValueError, TypeError)):
        mr.check_combine_args(*_bad_combine(case))


@pytest.mark.parametrize("E,k,d", WIDTHS)
@pytest.mark.parametrize("T", [1, 32])
def test_supported_arguments_pass_the_checks(E, k, d, T):
    x, router, out, shared = _inputs(T, E, k, d)
    assert mr.check_route_args(x, router, k) == (T, d, E)
    w, order = torch.ones(T * k, dtype=BF16), torch.arange(T * k, dtype=torch.int32)
    assert mr.check_combine_args(out, w, order, k, shared) == (T, d)
    assert mr.check_combine_args(out, w, order, k) == (T, d)


@pytest.mark.parametrize("T,d,want", [(1, 4096, 128), (8, 4096, 128), (16, 4096, 256),
                                       (32, 4096, 512), (1, 64, 64), (51, 4096, 820)])
def test_route_plan_follows_the_shapes(T, d, want):
    """Slices of ``ROUTER_ROWS`` rows while T x slices fit in two waves of
    132 SMs, fewer and larger ones past that."""
    rb = mr.route_plan(T, d, 132)
    assert rb == want and rb >= min(d, mr.ROUTER_ROWS)
    assert T * -(-d // rb) <= max(2 * 132, T)


def test_the_kernel_paths_refuse_cpu_tensors():
    x, router, out, shared = _inputs(1, 8, 2, 64)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        ops.moe_route(x, router, 2, impl="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        mr.moe_route_cuda(x, router, 2)
    w, order = torch.ones(2, dtype=BF16), torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        mr.moe_combine_cuda(out, w, order, 2, shared)
    assert mr.moe_route_plain is ref.moe_route and mr.moe_combine_plain is ref.moe_combine


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ulp(t):
    """One bf16 ulp at each of t's magnitudes (fp32 tensor)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126))) - 7)


def _experts(ends, order, k, T):
    """Each token's set of experts, from the sorted rows' experts and tokens."""
    rows = torch.arange(order.numel(), device=order.device)
    e = torch.searchsorted(ends.long(), rows, right=True).tolist()
    tok = (order.long() // k).tolist()
    return [sorted(ei for ei, ti in zip(e, tok) if ti == t) for t in range(T)]


@pytest.mark.card
@pytest.mark.parametrize("E,k,d", WIDTHS)
@pytest.mark.parametrize("B", [1, 2])
def test_kernels_against_the_plain_versions_on_the_card(E, k, d, B):
    """The kernel's logits sum in another order than cuBLAS's GEMV, so an
    expert can change places only where the k-th and (k+1)-th probabilities
    lie within ~1e-5 of the largest: where every token's gap is wider,
    ``ends`` and ``order`` are equal and ``rows`` bit-equal; elsewhere each
    token with a wide gap keeps its experts.  ``w`` and the combine are each
    within one bf16 ulp (the renormalising sum's order; the routed sum's
    rounding, then the shared add's).  A second call is bit-identical."""
    _require_card()
    x, router, out, shared = _inputs(B, E, k, d, device="cuda", seed=31 * B + E)
    want = ops.moe_route(x, router, k, impl="ref")
    before = ops.launch_counts()
    got = ops.moe_route(x, router, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["moe_route"] == before["moe_route"] + 1
    probs = torch.softmax(x.float() @ router, dim=-1).topk(k + 1, dim=-1).values
    clear = (probs[:, k - 1] - probs[:, k]) > 1e-5 * probs[:, 0]
    assert clear.any()
    if clear.all():
        assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
        assert torch.equal(got[0], want[0])
        err = (got[2].float() - want[2].float()).abs()
        assert (err <= _ulp(want[2].float())).all(), err.max().item()
    else:
        g, wt = _experts(got[1], got[3], k, B), _experts(want[1], want[3], k, B)
        assert all(g[t] == wt[t] for t in range(B) if clear[t])
    again = ops.moe_route(x.clone(), router.clone(), k)
    assert all(torch.equal(a, b) for a, b in zip(again, got))

    for sh in (None, shared):
        y_want = ops.moe_combine(out, want[2], want[3], k, sh, impl="ref")
        routed = ops.moe_combine(out, want[2], want[3], k, impl="ref")
        y = ops.moe_combine(out, want[2], want[3], k, sh)
        torch.cuda.synchronize()
        assert y.dtype == BF16 and y.shape == (B, d)
        bound = _ulp(torch.maximum(y_want.float().abs(), routed.float().abs()))
        err = (y.float() - y_want.float()).abs()
        assert (err <= bound).all(), err.max().item()
        assert torch.equal(ops.moe_combine(out, want[2], want[3], k, sh), y)


@pytest.mark.card
def test_an_exact_tie_goes_to_the_lower_expert():
    """Two identical router columns give two equal probabilities; with one
    place left in the top k, the lower expert id takes it."""
    _require_card()
    E, k, d = 8, 2, 64
    x, router, _, _ = _inputs(1, E, k, d, device="cuda", seed=5)
    col = router[:, 0].clone()
    router[:, 0] = x[0].float() * 0.2                   # expert 0 first by far
    router[:, 3], router[:, 5] = col, col               # 3 and 5 tied, then the rest
    router[:, [1, 2, 4, 6, 7]] = col[:, None] - x[0].float()[:, None] * 0.01
    logits = x.float() @ router
    assert logits[0, 0] > logits[0, 3] > logits[0, 1]
    _, ends, _, _ = ops.moe_route(x, router, k)
    counts = torch.diff(ends, prepend=ends.new_zeros(1)).tolist()
    assert counts == [1, 0, 0, 1, 0, 0, 0, 0]


@pytest.mark.card
@pytest.mark.parametrize("bad", ["e_not_multiple_of_4", "rows_over_max", "fp32_x"])
def test_kernel_raises_on_what_it_does_not_take(bad):
    _require_card()
    x, router, k = _bad_route(bad)
    with pytest.raises((ValueError, TypeError)):
        ops.moe_route(x.cuda(), router.cuda(), k)


STEPS = 24
#: idle seconds at each end of a traced window: the profiler keeps only the
#: kernels that lie wholly inside its window on the host's clock, and the
#: device's timestamps, mapped onto that clock, may be off by microseconds
EDGE_S = 0.05


@pytest.mark.card
def test_replayed_decode_equals_eager_and_launches_one_route_and_combine_a_layer():
    """Reduced granite-4.0-h-small in bf16: a library decode replayed as a
    CUDA graph gives the eager steps' logits bit for bit, and a device trace
    of the replays shows one ``moe_route`` and one ``moe_combine`` launch a
    MoE layer a step, and no radix sort."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.library import make_model_library
    from repro_torch.models import model as M
    from repro_torch.obs import trace

    _require_card()
    cfg = with_overrides(reduced(get_arch("granite-4.0-h-small")), param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    params = M.init_params(cfg, 5, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, 21), generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32).cuda()
    lib = make_model_library(cfg, 128, device="cuda")
    state = {}
    logits = lib["prefill"](params, state, {"tokens": prompt})["logits"]

    def nxt(lg):
        return lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    def decode(lg):
        trace.CURRENT.stages = stages = trace.Stages()
        try:
            out = lib["decode"](params, state, {"tokens": nxt(lg)})["logits"]
        finally:
            trace.CURRENT.stages = None
        return out, "replay" in stages.spans

    got = []

    def replay(n):
        nonlocal logits
        for _ in range(n):
            logits, replayed = decode(logits)
            assert replayed
            got.append(logits)

    logits, replayed = decode(logits)                                  # the capture
    assert not replayed
    got.append(logits)
    traced = max(2, 64 // cfg.num_layers)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        replay(traced)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    replay(STEPS - traced)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    n_moe = sum(cfg.layer_has_moe(i) for i in range(cfg.num_layers))
    assert n_moe > 0
    for kernel in ("moe_route_kernel", "moe_combine_kernel"):
        assert sum(bool(re.search(rf"\b{kernel}\b", n)) for n in names) == traced * n_moe
    assert not any("radixSort" in n for n in names)

    with torch.inference_mode():
        lg, cache = M.prefill(cfg, params, {"tokens": prompt}, 128, cache_dtype=torch.float32)
        want, pos = [], prompt.shape[1]
        for _ in range(STEPS + 1):
            lg, cache = M.decode_step(cfg, params, cache, {"tokens": nxt(lg), "pos": pos})
            want.append(lg.clone())
            pos += 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"decode {i}: replayed logits differ from eager"
