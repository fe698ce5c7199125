"""The plain reference against the port at a size the CPU holds: the
benchmark's weights have the port's parameter layout, and the port's
prefill and greedy decodes through its own library agree with the
reference's teacher-forced logits; the fp8 control does not."""
import json
import os

import numpy as np
import pytest
import torch

from portbench import harness, weights
from portbench import reference as R
from portbench.destination import port_config
from repro_torch.core.cache import model_fingerprint
from repro_torch.core.library import make_model_library
from repro_torch.models.model import abstract_params

HERE = os.path.dirname(os.path.abspath(__file__))
# bf16 weights and activations through 2 layers against float32: about 2 %
# of the largest logit measured on both configurations; 5 % leaves room
BF16_TOL = 0.05


def _serve(name, seed, prompt_len=37, decodes=5):
    with open(os.path.join(HERE, "testdata", name + ".json")) as f:
        c = json.load(f)
    ref = harness.load_module(c["reference"])
    cfg = port_config(c)
    W = weights.make(ref.layout(c), seed, "cpu")
    assert model_fingerprint(cfg, W) == model_fingerprint(cfg, abstract_params(cfg))
    lib = make_model_library(cfg, max_cache_len=prompt_len + decodes, device="cpu")
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, c["vocab_size"], size=prompt_len).astype(np.int64)
    state, got, served = {}, [], []
    out = lib["prefill"](W, state, {"tokens": torch.from_numpy(prompt)[None]})
    for _ in range(decodes + 1):
        lg = out["logits"][0, -1, :c["vocab_size"]].float()
        got.append(lg)
        served.append(int(lg.argmax()))
        out = lib["decode"](W, state, {"tokens": torch.tensor([[served[-1]]])})
    seq = torch.from_numpy(np.concatenate([prompt, served[:-1]]))
    pos = prompt_len - 1 + np.arange(len(served))
    want = ref.forward(c, W, seq, pos, R.Linear(False))
    low = ref.forward(c, W, seq, pos, R.Linear(True))
    scale = want.abs().amax(-1)
    return torch.stack(got), want, low, scale


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-ssm"])
def test_port_agrees_with_the_reference(name):
    got, want, low, scale = _serve(name, 2 ** 31 + 3)
    err = ((got - want).abs().amax(-1) / scale).max().item()
    ctrl = ((low - want).abs().amax(-1) / scale).max().item()
    assert err < BF16_TOL, err
    assert ctrl > BF16_TOL, ctrl


def test_same_seed_same_weights_other_seed_other_weights():
    with open(os.path.join(HERE, "testdata", "tiny-ssm.json")) as f:
        c = json.load(f)
    lay = harness.load_module(c["reference"]).layout(c)
    a, b, d = (dict(weights.leaves(weights.make(lay, s, "cpu"))) for s in (5, 5, 6))
    assert a.keys() == b.keys() == d.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[("embed", "tok")], d[("embed", "tok")])
    dt = torch.nn.functional.softplus(a[("blocks", "layers", 0, "mamba", "dt_bias")])
    assert 1e-3 * 0.999 <= dt.min() and dt.max() <= 1e-1 * 1.001


@pytest.mark.parametrize("chunk", [4, 8, 256])
def test_reference_scan_is_the_recurrence(chunk):
    g = torch.Generator().manual_seed(0)
    S, H, P, G, N = 21, 4, 3, 2, 5
    x = torch.randn(S, H, P, generator=g)
    dt = torch.rand(S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 2
    B, C = torch.randn(S, G, N, generator=g), torch.randn(S, G, N, generator=g)
    h = torch.zeros(H, P, N)
    want = []
    for t in range(S):
        Bt, Ct = B[t].repeat_interleave(H // G, 0), C[t].repeat_interleave(H // G, 0)
        h = h * torch.exp(dt[t] * A)[:, None, None] + dt[t][:, None, None] * x[t][:, :, None] \
            * Bt[:, None, :]
        want.append(torch.einsum("hpn,hn->hp", h, Ct))
    assert torch.allclose(R.ssd(x, dt, A, B, C, chunk=chunk), torch.stack(want), atol=1e-5)
