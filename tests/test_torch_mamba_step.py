"""``ops.mamba_step``: a Mamba-2 layer's decode step between its input
projections and ``wo`` (``kernels/mamba_step.py``, ``csrc/mamba_step.cu``).

On the CPU: the plain version against the composition the model ran before
the kernel (the conv over the concatenated window, ``ssd_step``, the D skip
and the gated norm, written out below as it was), bit for bit, with the cache
leaves written in place; the kernel's argument checks and its launch plan.
On the card (``-m card``): the kernel against the plain version forced there,
at published and reduced widths, and the decode of reduced SSM and hybrid
models replayed as a CUDA graph against its eager steps, with the kernel's
launches counted in a device trace.  This file imports no JAX, so it runs on
the card's host without the directory's ``conftest.py``:
``PYTHONPATH=src python -m pytest --noconftest -m card tests/test_torch_mamba_step.py``."""
import itertools
import re
import time

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch, with_overrides
from repro_torch.configs.base import reduced
from repro_torch.kernels import mamba_step as ms
from repro_torch.kernels import ops

BF16, F32 = torch.bfloat16, torch.float32


def _inputs(B, H, P, N, G, ck, d, *, act=BF16, wdt=BF16, conv_dtype=BF16, device="cpu",
            seed=0):
    """A step's inputs at realistic magnitudes: (u, z, x, Bm, Cm, p, conv, ssm)."""
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, std=1.0, dtype=F32):
        return (torch.randn(shape, generator=g) * std).to(device=device, dtype=dtype)

    di, gn = H * P, G * N
    dt0 = torch.rand(H, generator=g) * 0.099 + 0.001              # softplus(dt_bias)
    p = {"wdt": randn(d, H, std=d ** -0.5, dtype=wdt),
         "dt_bias": (dt0 + torch.log(-torch.expm1(-dt0))).to(device),
         "A_log": torch.log(torch.rand(H, generator=g) * 15 + 1).to(device),
         "D": randn(H, std=0.5) + 1,
         "conv_x": randn(ck, di, std=ck ** -0.5, dtype=wdt),
         "conv_B": randn(ck, gn, std=ck ** -0.5, dtype=wdt),
         "conv_C": randn(ck, gn, std=ck ** -0.5, dtype=wdt),
         "conv_bx": randn(di, std=0.1, dtype=wdt), "conv_bB": randn(gn, std=0.1, dtype=wdt),
         "conv_bC": randn(gn, std=0.1, dtype=wdt), "norm_scale": randn(di, std=0.2) + 1}
    u = randn(B, 1, d, dtype=act)
    z, x = randn(B, 1, di, dtype=act), randn(B, 1, di, dtype=act)
    Bm, Cm = randn(B, 1, gn, dtype=act), randn(B, 1, gn, dtype=act)
    conv = randn(B, ck - 1, di + 2 * gn, dtype=conv_dtype)
    ssm = randn(B, H, P, N, std=0.5)
    return u, z, x, Bm, Cm, p, conv, ssm


def _seed_chain(u, z, x, Bm, Cm, p, conv, ssm, eps):
    """The decode step as the model composed it before the kernel
    (``models/mamba.py`` ``_project``'s dt, ``_mix_step``, ``_conv_step``,
    ``models/ssd.py`` ``ssd_step``, ``_gated_norm``) -> (out, new window,
    new state)."""
    B_, _, di = x.shape
    H, hd, n = ssm.shape[1:]
    gn = Bm.shape[-1]
    dt = F.softplus((u.float() @ p["wdt"].float()) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    pre = torch.cat([x, Bm, Cm], dim=-1)
    window = torch.cat([conv.to(pre.dtype), pre], dim=1)
    w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=1)
    b = torch.cat([p["conv_bx"], p["conv_bB"], p["conv_bC"]])
    post = F.silu(torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()).to(
        window.dtype)
    x_t = post[:, :di].reshape(B_, -1, hd)
    B_t, C_t = post[:, di:di + gn].reshape(B_, -1, n), post[:, di + gn:].reshape(B_, -1, n)
    rep = H // B_t.shape[1]
    dtf = dt[:, 0].float()
    da = torch.exp(dtf * A.float())
    Bh, Ch = (torch.repeat_interleave(t.float(), rep, dim=1) if rep > 1 else t.float()
              for t in (B_t, C_t))
    sf = ssm.float() * da[..., None, None] + torch.einsum("bh,bhn,bhp->bhpn", dtf, Bh,
                                                          x_t.float())
    y = torch.einsum("bhn,bhpn->bhp", Ch, sf).to(x_t.dtype)
    y = (y + (p["D"][None, :, None] * x_t.float()).to(y.dtype)).reshape(B_, 1, di)
    yf = (y * F.silu(z.float())).float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    out = (yf * torch.rsqrt(var + eps) * p["norm_scale"].float()).to(y.dtype)
    return out, window[:, 1:, :], sf


# ---------------------------------------------------------------------------
# CPU: the plain version is the seed's composition, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,n,groups,B,conv_dtype,eps", list(itertools.product(
    (16, 64, 128), (16, 128), (1, 2), (1, 2), (BF16, F32), (1e-6, 1e-5))))
def test_plain_step_is_the_seed_chain_bit_for_bit(hd, n, groups, B, conv_dtype, eps):
    H = 4
    args = _inputs(B, H, hd, n, groups, 4, 48, conv_dtype=conv_dtype, seed=hd + n + groups)
    u, z, x, Bm, Cm, p, conv, ssm = args
    want, want_conv, want_state = _seed_chain(*args, eps)
    ptrs = (conv.data_ptr(), ssm.data_ptr())
    got = ops.mamba_step(u, z, x, Bm, Cm, p, conv, ssm, eps=eps)
    assert got.dtype == z.dtype and got.shape == (B, 1, H * hd)
    assert torch.equal(got, want)
    assert (conv.data_ptr(), ssm.data_ptr()) == ptrs
    assert conv.dtype == conv_dtype and ssm.dtype == F32
    assert torch.equal(conv, want_conv.to(conv_dtype)) and torch.equal(ssm, want_state)


@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-4.0-h-small", "jamba-1.5-large-398b"])
def test_model_decode_takes_the_op_and_writes_its_cache_in_place(arch, monkeypatch):
    """A reduced model's decode step calls ``ops.mamba_step`` once a Mamba-2
    layer, and the stacked cache's leaves are the ones written."""
    from repro_torch.models import model as M

    cfg = reduced(get_arch(arch))
    params = M.init_params(cfg, 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=torch.Generator().manual_seed(1))
    _, cache = M.prefill(cfg, params, {"tokens": tokens}, 16)
    leaves = {id(layer[k]): layer[k].data_ptr() for layer in cache["layers"]
              for k in ("conv", "ssm") if k in layer}
    calls = []
    real = ops.mamba_step
    monkeypatch.setattr(ops, "mamba_step", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    _, cache2 = M.decode_step(cfg, params, cache, {"tokens": tokens[:, :1], "pos": 5})
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.num_layers))
    assert len(calls) == n_mamba > 0
    assert {id(layer[k]): layer[k].data_ptr() for layer in cache2["layers"]
            for k in ("conv", "ssm") if k in layer} == leaves


def _bad(case):
    """Inputs the kernel does not take, one way each."""
    kw = dict(B=1, H=4, P=16, N=16, G=1, ck=4, d=32)
    dt = {}
    if case == "head_dim_32":
        kw["P"] = 32
    elif case == "n_256":
        kw["N"] = 256
    elif case == "n_not_multiple_of_4":
        kw["N"] = 18
    elif case == "groups_not_dividing_heads":
        kw["G"] = 3
    elif case == "five_taps":
        kw["ck"] = 5
    elif case == "fp16_activations":
        dt["act"] = torch.float16
    elif case == "fp16_conv_cache":
        dt["conv_dtype"] = torch.float16
    args = list(_inputs(*kw.values(), **dt))
    if case == "bf16_state":
        args[7] = args[7].to(BF16)
    elif case == "bf16_norm_scale":
        args[5] = dict(args[5], norm_scale=args[5]["norm_scale"].to(BF16))
    elif case == "z_too_short":
        args[1] = args[1][..., :-1]
    elif case == "strided_state":
        args[7] = args[7].transpose(2, 3)
    return args


@pytest.mark.parametrize("case", ["head_dim_32", "n_256", "n_not_multiple_of_4",
                                  "groups_not_dividing_heads", "five_taps", "fp16_activations",
                                  "fp16_conv_cache", "bf16_state", "bf16_norm_scale",
                                  "z_too_short", "strided_state"])
def test_unsupported_arguments_raise(case):
    with pytest.raises((ValueError, TypeError)):
        ms.check_args(*_bad(case))


def test_supported_arguments_pass_the_checks():
    for P in ms.HEAD_DIMS:
        for N in (16, 128):
            assert ms.check_args(*_inputs(2, 4, P, N, 2, 4, 32)) == (2, 4, P, N, 2, 4, 32)


@pytest.mark.parametrize("B,H,P,N,want", [(1, 24, 64, 128, 4),     # mamba2-130m
                                          (2, 24, 64, 128, 2),
                                          (1, 128, 64, 128, 1),    # granite-4.0-h-small
                                          (1, 128, 128, 128, 2),   # jamba-1.5-large
                                          (1, 8, 16, 16, 1)])      # the reduced configs
def test_launch_plan_follows_the_shapes(B, H, P, N, want):
    S = ms.mamba_step_plan(B, H, P, N, 132)
    assert S == want and P % S == 0 and (P // S) * N // 4 <= ms.MAX_VECTORS


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _widths(arch, small):
    cfg = get_arch(arch)
    cfg = reduced(cfg) if small else cfg
    s = cfg.ssm
    return (s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.n_groups, s.conv_kernel,
            cfg.d_model, cfg.norm_eps)


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("arch,small", [("mamba2-130m", False), ("granite-4.0-h-small", False),
                                        ("jamba-1.5-large-398b", False), ("mamba2-130m", True),
                                        ("granite-4.0-h-small", True)])
@pytest.mark.parametrize("B", [1, 2])
def test_kernel_against_the_plain_version_on_the_card(arch, small, B):
    """The kernel keeps the conv's x, B and C and y in fp32 where the plain
    version rounds each to bf16 (its state update, D skip and norm then
    start from bf16 values): the output, a bf16 row normalised to unit
    RMS, differs by a few of those roundings, held at 2 % of its largest
    value; the fp32 state by the update's dt * x * B term rounded through
    bf16 x and B, held at 1 % of its largest value.  The conv window holds
    the same values in both (inputs moved, never computed): equal."""
    _require_card()
    H, P, N, G, ck, d, eps = _widths(arch, small)
    args = _inputs(B, H, P, N, G, ck, d, device="cuda", seed=B)
    u, z, x, Bm, Cm, p, conv, ssm = args
    conv_ref, ssm_ref = conv.clone(), ssm.clone()
    want = ops.mamba_step(u, z, x, Bm, Cm, p, conv_ref, ssm_ref, eps=eps, impl="ref")
    ptrs = (conv.data_ptr(), ssm.data_ptr())
    before = ops.launch_counts()["mamba_step"]
    got = ops.mamba_step(u, z, x, Bm, Cm, p, conv, ssm, eps=eps)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba_step"] == before + 1
    assert (conv.data_ptr(), ssm.data_ptr()) == ptrs and ssm.dtype == F32
    assert got.dtype == BF16 and conv.dtype == BF16
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.02 * want.float().abs().max().item(), err
    serr = (ssm - ssm_ref).abs().max().item()
    assert serr <= 0.01 * ssm_ref.abs().max().item(), serr
    assert torch.equal(conv, conv_ref)
    # a second call from the same inputs is bit-identical (no float atomics)
    again = _inputs(B, H, P, N, G, ck, d, device="cuda", seed=B)
    assert torch.equal(ops.mamba_step(*again, eps=eps), got)
    assert torch.equal(again[6], conv) and torch.equal(again[7], ssm)


@pytest.mark.card
@pytest.mark.parametrize("bad", ["head_dim_32", "fp16_activations", "bf16_state"])
def test_kernel_raises_on_what_it_does_not_take(bad):
    _require_card()
    args = [t.cuda() if isinstance(t, torch.Tensor) else {k: v.cuda() for k, v in t.items()}
            for t in _bad(bad)]
    with pytest.raises((ValueError, TypeError)):
        ops.mamba_step(*args, eps=1e-6)


STEPS = 24
#: idle seconds at each end of a traced window: the profiler keeps only the
#: kernels that lie wholly inside its window on the host's clock, and the
#: device's timestamps, mapped onto that clock, may be off by microseconds
EDGE_S = 0.05


@pytest.mark.card
@pytest.mark.parametrize("arch", ["mamba2-130m", "granite-4.0-h-small"])
def test_replayed_decode_equals_eager_and_launches_one_kernel_a_layer(arch):
    """A reduced SSM and hybrid model in bf16: a library decode replayed as a
    CUDA graph gives the eager steps' logits bit for bit, and a device trace
    of the replays shows one ``mamba_step`` launch per Mamba-2 layer a step
    and no gated norm (an rmsnorm per mixer and FFN norm, and the final)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.library import make_model_library
    from repro_torch.models import model as M
    from repro_torch.obs import trace

    _require_card()
    cfg = with_overrides(reduced(get_arch(arch)), param_dtype="bfloat16",
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
    # as many layer-steps traced as the decode-graph tests trace (the
    # profiler drops a few events of much longer traces)
    traced = max(2, 64 // cfg.num_layers)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        replay(traced)
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    replay(STEPS - traced)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    n_mamba = sum(cfg.layer_kind(i) == "mamba" for i in range(cfg.num_layers))
    ffn = sum(cfg.layer_kind(i) == "attn" or cfg.family != "ssm" for i in range(cfg.num_layers))
    assert sum(bool(re.search(r"\bmamba_step_kernel\b", n)) for n in names) == traced * n_mamba
    assert sum(bool(re.search(r"\brmsnorm_kernel\b", n)) for n in names) == traced * (
        cfg.num_layers + ffn + 1)

    with torch.inference_mode():
        lg, cache = M.prefill(cfg, params, {"tokens": prompt}, 128, cache_dtype=torch.float32)
        want, pos = [], prompt.shape[1]
        for _ in range(STEPS + 1):
            lg, cache = M.decode_step(cfg, params, cache, {"tokens": nxt(lg), "pos": pos})
            want.append(lg.clone())
            pos += 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"decode {i}: replayed logits differ from eager"
