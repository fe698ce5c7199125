"""Whether the timed path produced the right logits.

After the window has closed and the destination has exited, a sample of
the requests the session finished (drawn from the seed, the longest
always among them) is run once through the configuration's plain float32
reference: the prompt and the tokens the host fed back, teacher-forced,
with the weights drawn again from the seed by ``weights.py``.  At every
position where the host received logits the check reads

* ``gap``: how far the reference's logit of the token the host sampled
  lies below the reference's best logit (0 where the greedy token is the
  reference's too), the widest over the sample;
* ``logit_err``: the largest absolute difference between the logits
  received and the reference's, over the reference's largest absolute
  logit at that position, the widest over the sample.

With ``control`` it reads the same two numbers for the reference computed
with every projection in fp8 (``reference.Linear``), put in the program's
place: the gap of the token the fp8 logits put first, and their error.
"""
from __future__ import annotations

import math

import numpy as np

from portbench import traffic

NUMBERS = ("gap", "logit_err")
NOT_FINITE = 1e30


def compare(spec, seed: int, requests: list, device: str, control: bool = False) -> dict:
    import torch

    from portbench import reference as R
    from portbench import weights

    R.exact_fp32()
    lengths = [len(r["prompt"]) for r in requests]
    finished = [i for i, r in enumerate(requests) if r["finished"]]
    pick = traffic.check_sample(finished, lengths, spec.mix["check_requests"], seed)
    out = {"compared_tokens": 0, "compared_requests": len(pick)}
    out.update({k: 0.0 for k in NUMBERS})
    if control:
        out.update({f"control.{k}": 0.0 for k in NUMBERS})
    if not pick:
        return out
    c, ref = spec.config, spec.reference
    W = weights.make(ref.layout(c), seed, device)
    lin, lin8 = R.Linear(False), R.Linear(True)
    with torch.inference_mode():
        for i in pick:
            r = requests[i]
            served = np.asarray(r["served"], dtype=np.int64)
            seq = np.concatenate([r["prompt"].astype(np.int64), served[:-1]])
            pos = len(r["prompt"]) - 1 + np.arange(len(served))
            tokens = torch.from_numpy(seq).to(device)
            want = ref.forward(c, W, tokens, pos, lin)
            got = torch.from_numpy(np.stack(r["logits"])).to(device)
            tok = torch.from_numpy(served).to(device)[:, None]
            _update(out, "", want, got, tok)
            if control:
                low = ref.forward(c, W, tokens, pos, lin8)
                _update(out, "control.", want, low, low.argmax(-1, keepdim=True))
            out["compared_tokens"] += len(served)
    return out


def _update(out: dict, prefix: str, want, got, tok) -> None:
    best = want.amax(-1)
    gap = (best - want.gather(-1, tok)[:, 0]).max().item()
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    for k, v in (("gap", gap), ("logit_err", err)):
        # a NaN or an infinity (logits the program broke) reads as far off,
        # and stays a number the result line can carry
        v = v if math.isfinite(v) else NOT_FINITE
        out[prefix + k] = max(out[prefix + k], v)
