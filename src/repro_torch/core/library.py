"""Executor library adapters: expose the port's model zoo and OpenPose-lite
as destination-executable libraries (the "Caffe" of this reproduction).

Library functions have signature ``fn(params, state, args) -> outputs`` where
``state`` is the mutable per-session dict (serving caches live there, which
is what migration snapshots: KV caches, conv windows and SSM states,
cross-attention keys and values, all plain tensor trees).  Arguments arrive
as tensors on the executor's device (the parameters' device), a VLM's
``"vision"`` rows and an encoder-decoder's ``"frames"`` beside the
``"tokens"``; outputs are tensors the executor brings back to host numpy."""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models import openpose
from repro_torch.utils import resolve_device


def make_model_library(cfg, max_cache_len: int = 256, device="cuda") -> dict:
    """Serving library for one ModelConfig of any family: score / prefill /
    decode / hidden.  A VLM's calls carry ``"vision"`` (B, Tv, d), each
    decode too, as the reference's model requires; an encoder-decoder's
    score, prefill and hidden carry ``"frames"`` (B, F, d)."""
    resolve_device(device)      # the entry point's device rule: no quiet CPU fallback

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
        batch = dict(args)
        batch["pos"] = int(state["pos"])
        logits, cache = M.decode_step(cfg, params, state["cache"], batch)
        state["cache"] = cache
        state["pos"] = int(state["pos"]) + 1
        return {"logits": logits}

    @torch.inference_mode()
    def hidden(params, state, args):
        h, _ = M.forward_hidden(cfg, params, args)
        return {"hidden": h}

    return {"score": score, "prefill": prefill, "decode": decode, "hidden": hidden}


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
