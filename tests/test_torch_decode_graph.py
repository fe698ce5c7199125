"""On the card: the library's decode replayed as a CUDA graph
(``core.library.DecodeGraph``) against the eager step (``models.model.
decode_step``) on the tests' small dense, SSM and hybrid configurations in
bf16 (granite-4.0-h-small's: Mamba-2, NoPE attention, a dropless MoE with a
shared expert; jamba's: Mamba, attention, a capacity-bounded MoE), cache
256: greedy tokens equal and logits bit-equal over 64 decodes,
whatever happens to the session's state between calls, and a replay's
kernels, counted in a device trace, those of an eager step.  This file
imports no JAX (the card's host has none), so it runs there without the
directory's ``conftest.py``:
``PYTHONPATH=src python -m pytest --noconftest -m card tests/test_torch_decode_graph.py``."""
import re
import time

import pytest
import torch

from repro_torch.configs import get_arch, with_overrides
from repro_torch.configs.base import reduced
from repro_torch.core.library import make_model_library
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs import trace
from repro_torch.utils import to_numpy_tree, tree_leaves

CACHE = 256
STEPS = 64
#: the hand-written kernels a decode step launches, by the counter's key and
#: the kernel's name in a device trace
STEP_KERNELS = {"rmsnorm": "rmsnorm_kernel", "decode_attention": "decode_split_kernel",
                "mamba_step": "mamba_step_kernel", "moe_route": "moe_route_kernel",
                "moe_combine": "moe_combine_kernel"}
#: the grouped products of ``ops.moe_experts`` in a device trace, three a call
GROUPED_GEMM = "GroupProblemShape"
#: idle seconds at each end of a traced window: the profiler keeps only the
#: kernels that lie wholly inside its window on the host's clock, and the
#: device's timestamps, mapped onto that clock, may be off by microseconds
EDGE_S = 0.05


@pytest.fixture(params=["granite-3-2b", "mamba2-130m", "granite-4.0-h-small",
                        "jamba-1.5-large-398b"])
def model(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = with_overrides(reduced(get_arch(request.param)), param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    return cfg, M.init_params(cfg, 7, device="cuda")


def _prompt(cfg, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (1, n), generator=g, dtype=torch.int32).cuda()


def _next(logits):
    return logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)


def _eager(cfg, params, prompt, steps=STEPS):
    """Each step's logits of a greedy request, eager."""
    with torch.inference_mode():
        logits, cache = M.prefill(cfg, params, {"tokens": prompt}, CACHE,
                                  cache_dtype=torch.float32)
        out, pos = [], prompt.shape[1]
        for _ in range(steps):
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"tokens": _next(logits), "pos": pos})
            out.append(logits.clone())
            pos += 1
    return out


def _decode(lib, params, state, logits):
    """One library decode of the token ``logits`` choose, checked to have
    replayed the graph (its ``replay`` stage) unless it is the first."""
    trace.CURRENT.stages = stages = trace.Stages()
    try:
        out = lib["decode"](params, state, {"tokens": _next(logits)})["logits"]
    finally:
        trace.CURRENT.stages = None
    return out, "replay" in stages.spans


def _assert_same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"decode {i}: captured logits differ from eager"


@pytest.mark.card
def test_two_requests_back_to_back_the_second_shorter(model):
    cfg, params = model
    lib = make_model_library(cfg, CACHE, device="cuda")
    state, replays = {}, 0
    for n, seed in ((40, 1), (17, 2)):
        prompt = _prompt(cfg, n, seed)
        logits, got = lib["prefill"](params, state, {"tokens": prompt})["logits"], []
        for _ in range(STEPS):
            logits, replayed = _decode(lib, params, state, logits)
            got.append(logits)
            replays += replayed
        _assert_same(got, _eager(cfg, params, prompt))
    assert replays == 2 * STEPS - 1 and state["pos"] == 17 + STEPS


@pytest.mark.card
def test_snapshot_and_restore_in_the_middle_of_a_request(model):
    cfg, params = model
    lib = make_model_library(cfg, CACHE, device="cuda")
    prompt = _prompt(cfg, 33, 3)
    state = {}
    logits, got = lib["prefill"](params, state, {"tokens": prompt})["logits"], []
    for _ in range(20):
        logits, _ = _decode(lib, params, state, logits)
        got.append(logits)
    snap, at = to_numpy_tree(state), logits
    for _ in range(10):                  # a continuation the restore throws away
        logits, _ = _decode(lib, params, state, logits)
    state, logits = from_numpy_tree(snap, "cuda"), at     # the executor's restore
    for _ in range(STEPS - 20):
        logits, replayed = _decode(lib, params, state, logits)
        assert replayed
        got.append(logits)
    _assert_same(got, _eager(cfg, params, prompt))


@pytest.mark.card
def test_a_rolled_back_state_replays_the_same_token(model):
    """The benchmark's ``stale_state`` fault: each decode's cache leaves and
    ``pos`` put back in place after it, then the same token decoded again."""
    cfg, params = model
    lib = make_model_library(cfg, CACHE, device="cuda")
    prompt = _prompt(cfg, 25, 4)
    state = {}
    logits, got = lib["prefill"](params, state, {"tokens": prompt})["logits"], []
    for _ in range(STEPS):
        saved = ([t.clone() for t in tree_leaves(state["cache"])], state["pos"])
        first, _ = _decode(lib, params, state, logits)
        with torch.inference_mode():        # the cache is made under it
            for t, was in zip(tree_leaves(state["cache"]), saved[0]):
                t.copy_(was)
        state["pos"] = saved[1]
        logits, replayed = _decode(lib, params, state, logits)
        assert replayed
        _assert_same([first], [logits])
        got.append(logits)
    _assert_same(got, _eager(cfg, params, prompt))


@pytest.mark.card
def test_two_sessions_interleaved_on_one_library(model):
    cfg, params = model
    lib = make_model_library(cfg, CACHE, device="cuda")
    prompts = [_prompt(cfg, 30, 5), _prompt(cfg, 21, 6)]
    states = [{}, {}]
    logits = [lib["prefill"](params, s, {"tokens": p})["logits"]
              for s, p in zip(states, prompts)]
    got = [[], []]
    for _ in range(STEPS):
        for i in (0, 1):
            logits[i], _ = _decode(lib, params, states[i], logits[i])
            got[i].append(logits[i])
        a, b = (tree_leaves(s["cache"]) for s in states)
        assert not any(x.data_ptr() == y.data_ptr() for x in a for y in b)
    for i in (0, 1):
        _assert_same(got[i], _eager(cfg, params, prompts[i]))


def _device_launches(fn) -> dict:
    """Run ``fn`` under the profiler -> launches of each of STEP_KERNELS
    that the device ran, replayed ones included."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(EDGE_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(EDGE_S)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return {**{key: sum(bool(re.search(rf"\b{k}\b", n)) for n in names)
               for key, k in STEP_KERNELS.items()},
            "grouped_gemm": sum(GROUPED_GEMM in n for n in names)}


@pytest.mark.card
def test_replays_launch_the_kernels_of_eager_steps(model):
    """The device runs a replay's kernels as it runs an eager step's, and no
    wrapper counts them: the counters count the capturing call's eager step
    alone.  The steps traced are as many layer-steps as the 2-layer models'
    64 (a hybrid's 16 or 20 layers in 8 or 6 steps): the profiler drops a few
    events of a trace ten times as long (7 of 3,008 rmsnorm launches seen)."""
    cfg, params = model
    steps = max(1, STEPS * 2 // cfg.num_layers)
    lib = make_model_library(cfg, CACHE, device="cuda")
    prompt = _prompt(cfg, 19, 8)
    state = {}
    logits = lib["prefill"](params, state, {"tokens": prompt})["logits"]
    with torch.inference_mode():
        _, cache = M.prefill(cfg, params, {"tokens": prompt}, CACHE)

        def eager_steps():
            for j in range(steps):
                M.decode_step(cfg, params, cache, {"tokens": prompt[:, :1], "pos": 19 + j})
        ops.reset_launch_counts()
        eager = _device_launches(eager_steps)
    counted = ops.launch_counts()
    assert eager["rmsnorm"] and {k: eager[k] for k in STEP_KERNELS} == {
        k: counted[k] for k in STEP_KERNELS}
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    assert eager["decode_attention"] == steps * n_attn
    assert eager["mamba_step"] == steps * (cfg.num_layers - n_attn)
    dropless = cfg.moe is not None and cfg.moe.dropless
    assert eager["grouped_gemm"] == 3 * counted["moe_experts"] == (
        3 * steps * cfg.num_layers if dropless else 0)
    assert eager["moe_route"] == eager["moe_combine"] == counted["moe_experts"]
    ops.reset_launch_counts()
    logits, replayed = _decode(lib, params, state, logits)         # the capture
    assert not replayed
    assert ops.launch_counts() == {k: n // steps for k, n in counted.items()}
    ops.reset_launch_counts()

    def replays():
        nonlocal logits
        for _ in range(steps):
            logits, replayed = _decode(lib, params, state, logits)
            assert replayed
    assert _device_launches(replays) == eager
    assert not any(ops.launch_counts().values())
