"""The port's continuous-batching engine against the JAX package's, at
reduced granite-3-2b and mamba2-130m (float32, on the CPU), with weights
from ``repro.models.model.init_params`` fed to both packages; then the
other decoder families: jamba (a hybrid block's mixed KV and conv/SSM
caches spliced into slots), moonshot (MoE under global dispatch: the slots'
tokens share expert capacity) and llama-3.2-vision (``context_fn``: each
request's vision rows, its cross-attention keys and values spliced in).

Against the reference, a few prompts of ONE length (so JAX compiles the
engine's prefill once): the greedy tokens of both engines and of the port's
``generate_sequential`` are identical.  Against the port's own
``generate_sequential``: ragged prompts, more requests than slots, so slots
free and refill while others keep decoding at their own positions; and the
EOS stop.  Then the entry point: ``launch/serve.main`` in the local role and
in the host role against a port destination, with ``--device cpu``; with no
card, the default device raises."""
import json

import jax
import numpy as np
import pytest

from repro.configs import get_arch, reduced
from repro.models import model as RM
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServingEngine as RefEngine
from repro_torch import configs as tconfigs
from repro_torch.core.executor import DestinationExecutor
from repro_torch.core.library import make_model_library
from repro_torch.core.transport import TCPServer
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serving.engine import Request, ServingEngine, generate_sequential

ARCHS = ["granite-3-2b", "mamba2-130m"]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    cfg = reduced(get_arch(name))
    params = jax.tree_util.tree_map(np.asarray, RM.init_params(cfg, jax.random.PRNGKey(0)))
    return name, cfg, tconfigs.reduced(tconfigs.get_arch(name)), params


def test_engine_and_sequential_tokens_equal_reference(arch):
    name, cfg, tcfg, params = arch
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 7).tolist() for _ in range(3)]
    ref = RefEngine(cfg, params, max_batch=2, max_len=32)
    eng = ServingEngine(tcfg, params, max_batch=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(f"r{i}", p, max_new_tokens=6))
        eng.submit(Request(f"r{i}", p, max_new_tokens=6))
    want, got = ref.run(), eng.run()
    assert got == want, name
    assert eng.steps == ref.steps
    for i, p in enumerate(prompts):
        assert generate_sequential(tcfg, params, p, 6, max_len=32, device="cpu") == want[f"r{i}"]


def test_continuous_batching_matches_sequential_on_ragged_prompts(arch):
    """Five requests of 3–9 tokens through three slots."""
    name, _, tcfg, params = arch
    eng = ServingEngine(tcfg, params, max_batch=3, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(f"r{i}", rng.integers(0, tcfg.vocab_size, rng.integers(3, 10)).tolist(),
                    max_new_tokens=int(rng.integers(2, 8))) for i in range(5)]
    assert len({len(r.prompt) for r in reqs}) > 1
    for r in reqs:
        eng.submit(r)
    out = eng.run()
    for r in reqs:
        assert r.done and len(out[r.rid]) == r.max_new_tokens
        assert out[r.rid] == generate_sequential(tcfg, params, r.prompt, r.max_new_tokens,
                                                 max_len=64, device="cpu"), (name, r.rid)


FAMILIES = ["jamba-1.5-large-398b", "moonshot-v1-16b-a3b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_other_families_engine_tokens_equal_sequential_and_reference(name):
    """Against the reference's engine: three prompts of one length through
    two slots (one prefill compile there).  Against the port's
    ``generate_sequential``: five ragged prompts through three slots.  The
    cross gates are set non-zero (they are zeros at init).

    The reference's engine hands ``context_fn``'s row to its prefill as it
    is, where the model needs a batch axis, and stacks the rows with
    unbatched zeros for empty slots at each tick; it runs only with
    (1, Tv, d) rows and no empty slot at a tick.  So the vlm meets it with
    two requests in two slots, finishing together, and its rows batched;
    the port's engine takes (Tv, d) rows, as its ``generate_sequential``
    and the reference's take a context."""
    cfg = reduced(get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(x.shape, 0.7, x.dtype)
        if "cross_gate" in jax.tree_util.keystr(path) else np.asarray(x),
        RM.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    vision = {f"r{i}": (0.5 * rng.standard_normal((cfg.num_vision_tokens, cfg.d_model))
                        ).astype(np.float32) for i in range(5)}
    ctx = vision.__getitem__ if cfg.family == "vlm" else None

    prompts = [rng.integers(0, cfg.vocab_size, 7).tolist() for _ in range(2 if ctx else 3)]
    ref = RefEngine(cfg, params, max_batch=2, max_len=32,
                    context_fn=ctx and (lambda rid: vision[rid][None]))
    eng = ServingEngine(tcfg, params, max_batch=2, max_len=32, context_fn=ctx, device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(f"r{i}", p, max_new_tokens=5))
        eng.submit(Request(f"r{i}", p, max_new_tokens=5))
    want, got = ref.run(), eng.run()
    assert got == want and eng.steps == ref.steps, name

    eng = ServingEngine(tcfg, params, max_batch=3, max_len=48, context_fn=ctx, device="cpu")
    reqs = [Request(f"r{i}", rng.integers(0, cfg.vocab_size, rng.integers(3, 10)).tolist(),
                    max_new_tokens=int(rng.integers(2, 7))) for i in range(5)]
    for r in reqs:
        eng.submit(r)
    out = eng.run()
    for r in reqs:
        seq = generate_sequential(tcfg, params, r.prompt, r.max_new_tokens, max_len=48,
                                  context=None if ctx is None else ctx(r.rid), device="cpu")
        assert out[r.rid] == seq, (name, r.rid)


def test_engine_respects_eos():
    tcfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    params = M.init_params(tcfg, 0, device="cpu")
    probe = ServingEngine(tcfg, params, max_batch=1, max_len=32, device="cpu")
    probe.submit(Request("p", [1, 2, 3], max_new_tokens=8))
    full = probe.run()["p"]
    eos = full[2]
    eng = ServingEngine(tcfg, params, max_batch=1, max_len=32, device="cpu")
    eng.submit(Request("q", [1, 2, 3], max_new_tokens=8, eos_id=eos))
    assert eng.run()["q"] == full[:full.index(eos) + 1]


def test_engine_cache_is_fp32_and_splices_in_place():
    """The batched cache stays fp32 under a bf16 compute dtype and keeps
    its storage: a prefill is copied into the slot, never reallocated."""
    tcfg = tconfigs.with_overrides(tconfigs.reduced(tconfigs.get_arch("granite-3-2b")),
                                   param_dtype="bfloat16", compute_dtype="bfloat16")
    eng = ServingEngine(tcfg, M.init_params(tcfg, 0, device="cpu"), max_batch=2, max_len=16,
                        device="cpu")
    k = eng.cache["layers"][0]["k"]
    ptr = k.data_ptr()
    eng.submit(Request("a", [4, 5, 6], max_new_tokens=3))
    eng.submit(Request("b", [7, 8], max_new_tokens=2))
    eng.run()
    k = eng.cache["layers"][0]["k"]
    assert k.dtype.is_floating_point and str(k.dtype) == "torch.float32"
    assert k.data_ptr() == ptr
    assert eng.pos.tolist() == [3 + 2, 2 + 1]       # each slot at its own position


def test_entry_points_refuse_cuda_without_a_card():
    tcfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    params = M.init_params(tcfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tcfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_sequential(tcfg, params, [1, 2], 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--role", "local", "--requests", "1"])


def _events(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        rec = json.loads(line)
        out[rec["event"]] = rec
    return out


def test_serve_local_role_on_cpu(capsys):
    serve.main(["--role", "local", "--device", "cpu", "--requests", "3", "--max-len", "48"])
    ev = _events(capsys.readouterr().out)["engine_complete"]
    assert ev["requests"] == 3 and ev["tokens"] == 3 * 16 and ev["engine_ticks"] > 0


def test_serve_host_role_against_port_destination(capsys):
    """The host role's facade session against a destination serving the
    same reduced model: handshake, a map of scores, runtime stats."""
    tcfg = tconfigs.reduced(tconfigs.get_arch("granite-3-2b"))
    ex = DestinationExecutor({"lm": make_model_library(tcfg, 128, device="cpu")},
                             name="serve-dest", device="cpu")
    server = TCPServer(ex.handle).start()
    try:
        serve.main(["--role", "host", "--device", "cpu", "--requests", "4",
                    "--connect", f"127.0.0.1:{server.port}", "--tenant", "acme"])
    finally:
        server.stop()
        ex.shutdown()
    ev = _events(capsys.readouterr().out)
    assert ev["handshake"]["runtime"] == "PipelinedHostRuntime"
    assert ev["offload_complete"]["requests"] == 4
    assert sum(ev["offload_complete"]["assigned"].values()) == 4
    assert ev["tenant_stats"]["tenant"] == "acme" and ev["tenant_stats"]["served"] == 4
