"""Executor library adapters: expose the port's model zoo as
destination-executable libraries (the "Caffe" of this reproduction).

Library functions have signature ``fn(params, state, args) -> outputs`` where
``state`` is the mutable per-session dict (serving caches live there, which
is what migration snapshots).  Arguments arrive as tensors on the
executor's device (the parameters' device); outputs are tensors the executor
brings back to host numpy.  The OpenPose-lite library is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.utils import resolve_device


def make_model_library(cfg, max_cache_len: int = 256, device="cuda") -> dict:
    """Serving library for one ModelConfig: score / prefill / decode / hidden."""
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
