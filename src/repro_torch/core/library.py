"""Executor library adapters: expose the port's model zoo and OpenPose-lite
as destination-executable libraries (the "Caffe" of this reproduction).

Library functions have signature ``fn(params, state, args) -> outputs`` where
``state`` is the mutable per-session dict (serving caches live there, which
is what migration snapshots: KV caches, conv windows and SSM states,
cross-attention keys and values, all plain tensor trees).  Arguments arrive
as tensors on the executor's device (the parameters' device), a VLM's
``"vision"`` rows and an encoder-decoder's ``"frames"`` beside the
``"tokens"``; outputs are tensors the executor brings back to host numpy.

On the card, a dense, SSM or hybrid model's decode runs as one CUDA graph
(:class:`DecodeGraph`): the host launches the step once instead of each of
its kernels."""
from __future__ import annotations

import threading
import time
import weakref

import torch

from repro_torch.models import model as M
from repro_torch.models import openpose
from repro_torch.obs import trace as _trace
from repro_torch.utils import resolve_device, tree_flatten, tree_leaves, tree_map, tree_unflatten

#: the families whose decode step is held captured against eager on the card
#: (``tests/test_torch_decode_graph.py``): their steps launch no
#: host-synchronizing op.  The other families' decodes run eagerly.
GRAPH_FAMILIES = frozenset({"dense", "ssm", "hybrid"})


def make_model_library(cfg, max_cache_len: int = 256, device="cuda") -> dict:
    """Serving library for one ModelConfig of any family: score / prefill /
    decode / hidden.  A VLM's calls carry ``"vision"`` (B, Tv, d), each
    decode too, as the reference's model requires; an encoder-decoder's
    score, prefill and hidden carry ``"frames"`` (B, F, d)."""
    resolve_device(device)      # the entry point's device rule: no quiet CPU fallback
    graph = DecodeGraph(cfg) if cfg.family in GRAPH_FAMILIES else None

    @torch.inference_mode()
    def score(params, state, args):
        return {"loss": M.loss_fn(cfg, params, args)[0]}

    @torch.inference_mode()
    def prefill(params, state, args):
        # cache_dtype is float32 as in the reference library, where it has no
        # effect either: the prefill cache takes the compute dtype
        logits, cache = M.prefill(cfg, params, args, max_cache_len,
                                  cache_dtype=torch.float32)
        state["cache"] = cache
        state["pos"] = int(args["tokens"].shape[1])
        return {"logits": logits}

    @torch.inference_mode()
    def decode(params, state, args):
        pos = int(state["pos"])
        logits = graph.run(params, state, args, pos) if graph is not None else None
        if logits is None:
            logits, cache = M.decode_step(cfg, params, state["cache"], {**args, "pos": pos})
            state["cache"] = cache
        state["pos"] = pos + 1
        return {"logits": logits}

    @torch.inference_mode()
    def hidden(params, state, args):
        h, _ = M.forward_hidden(cfg, params, args)
        return {"hidden": h}

    return {"score": score, "prefill": prefill, "decode": decode, "hidden": hidden}


def _spec(t) -> tuple:
    return tuple(t.shape), t.dtype, t.device


class DecodeGraph:
    """One library's decode step, captured as a CUDA graph by its first
    call that can be and replayed by every later call that matches it.

    A call can be captured when its only argument is the ``(B, 1)`` tokens
    and its tokens and cache lie on one CUDA device; a later call replays
    when its tokens and cache also have the captured shapes and dtypes and
    its parameters are the captured ones.  Any other call returns None, and
    the library runs the eager step.  The capturing call runs the eager step
    itself, on the capture's stream (which sizes ``decode_attention``'s
    scratch and cuBLAS's workspace there), and returns its logits.

    The graph reads and writes fixed tensors: the token rows, a device
    ``pos`` (int32, set from ``state["pos"]`` before each replay) and the
    cache leaves.  The cache leaves are the capturing session's own, and
    ``state["cache"]`` holds them after every replay, so whatever changes
    the state between calls -- a rolled-back ``pos``, a leaf written in
    place -- is what the next replay reads.  A state whose cache holds
    other tensors (a new prefill's, a restored snapshot's, another
    session's) has them copied into the graph's before the replay; the
    state that held the graph's leaves until then is given copies of them,
    so no two states share them.  The graph itself stays out of the state,
    which migration snapshots as plain tensor trees.

    A replay books the ``replay`` stage in a traced call (``obs.trace``);
    no layer stage or kernel wrapper runs under it, so ``ops``' launch
    counters count the capturing call's eager step and nothing of the
    replays (the capture records its launches without counting them):
    a replay's kernels show only in a device trace.  The logits come back
    as a copy of the graph's output, which the next replay overwrites."""

    def __init__(self, cfg) -> None:
        self.cfg = cfg
        self.graph = None
        self._lock = threading.Lock()     # one replay's inputs, replay and output at a time

    def run(self, params, state, args, pos: int):
        """The logits of one step, or None where the call must run eagerly."""
        tokens = args["tokens"]
        if len(args) != 1 or not tokens.is_cuda or tokens.ndim != 2 or tokens.shape[1] != 1:
            return None
        leaves, treedef = tree_flatten(state["cache"])
        if not all(t.device == tokens.device for t in leaves):
            return None
        with self._lock:
            if self.graph is None or any(r() is None for r in self.params):
                return self._capture(params, state, args, pos)
            p_leaves = tree_leaves(params)
            if ((treedef, _spec(tokens), [_spec(t) for t in leaves]) != self.key
                    or len(p_leaves) != len(self.params)
                    or any(r() is not p for r, p in zip(self.params, p_leaves))):
                return None
            return self._replay(state, tokens, leaves, pos)

    def _capture(self, params, state, args, pos: int):
        cfg, dev = self.cfg, args["tokens"].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            logits, cache = M.decode_step(cfg, params, state["cache"], {**args, "pos": pos})
        torch.cuda.current_stream(dev).wait_stream(side)
        leaves, treedef = tree_flatten(cache)
        tokens = args["tokens"].clone()
        pos_dev = torch.zeros((), dtype=torch.int32, device=dev)
        graph = torch.cuda.CUDAGraph()
        stages, _trace.CURRENT.stages = _trace.CURRENT.stages, None
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                out, _ = M.decode_step(cfg, params, tree_unflatten(treedef, leaves),
                                       {"tokens": tokens, "pos": pos_dev})
        finally:
            _trace.CURRENT.stages = stages
        self.graph, self.logits = graph, out
        self.tokens, self.pos, self.leaves, self.treedef = tokens, pos_dev, leaves, treedef
        self.key = (treedef, _spec(tokens), [_spec(t) for t in leaves])
        self.params = [weakref.ref(p) for p in tree_leaves(params)]
        state["cache"] = tree_unflatten(treedef, leaves)
        self.owner = state
        return logits

    def _replay(self, state, tokens, leaves, pos: int):
        stages = _trace.CURRENT.stages
        t = time.perf_counter_ns() if stages is not None else 0
        if state is not self.owner or any(a is not b for a, b in zip(leaves, self.leaves)):
            self._adopt(state, leaves)
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        logits = self.logits.clone()
        if stages is not None:
            stages.stage("replay", t)
        return logits

    def _adopt(self, state, leaves) -> None:
        """Make ``state`` the holder of the graph's cache leaves, holding
        what its own cache held; the previous holder keeps copies."""
        prev = self.owner
        if prev is not state and "cache" in prev:
            prev["cache"] = tree_map(
                lambda t: t.clone() if any(t is m for m in self.leaves) else t, prev["cache"])
        for mine, theirs in zip(self.leaves, leaves):
            if mine is not theirs:
                mine.copy_(theirs)
        state["cache"] = tree_unflatten(self.treedef, self.leaves)
        self.owner = state


def make_openpose_library(net, device="cuda") -> dict:
    """The paper's workload: the Caffe backbone as a destination library.
    ``forward`` takes NHWC ``frames`` on the executor's device and returns
    NHWC ``beliefs``; the weights stay HWIO as they crossed the wire."""
    resolve_device(device)      # the entry point's device rule: no quiet CPU fallback

    @torch.inference_mode()
    def forward(params, state, args):
        # the private name: an application in this process may have
        # ``op_forward`` intercepted, and the destination runs the backbone
        return {"beliefs": openpose._op_forward(net, params, args["frames"])}

    return {"forward": forward}
