"""Plain float32 reference of a Mamba-2 language model (mamba2-130m as the
port runs it): token embedding, per layer RMSNorm -> Mamba-2 mixer ->
residual, final RMSNorm, logits by the tied embedding.  The mixer projects
z, x, B, C and dt from the normed input, runs a causal depthwise conv (then
SiLU) over x, B and C, the SSD recurrence with dt = softplus(. + dt_bias)
and A = -exp(A_log), adds D * x, gates with SiLU(z) before an RMSNorm, and
projects back.  Sizes come from the configuration file ``c``.

``layout`` names every weight in the port's parameter tree, with the
benchmark's own initial distribution; ``weights.py`` draws them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import reference as R

VOCAB_PAD = 2048          # the port holds the vocabulary in rows padded to this


def sizes(c: dict) -> dict:
    d, V = c["d_model"], c["vocab_size"]
    di = c["expand"] * d
    return {"d": d, "L": c["n_layer"], "di": di, "P": c["headdim"], "nh": di // c["headdim"],
            "G": c["ngroups"], "N": c["d_state"], "ck": c["d_conv"], "V": V,
            "Vp": -(-V // VOCAB_PAD) * VOCAB_PAD, "eps": c["norm_epsilon"]}


def layout(c: dict) -> list:
    s = sizes(c)
    d, L, di, nh, ck = s["d"], s["L"], s["di"], s["nh"], s["ck"]
    gn = s["G"] * s["N"]
    m = ("blocks", "layers", 0, "mamba")
    norm = ("around", 1.0, 0.1)
    return [
        (("embed", "tok"), (s["Vp"], d), "bfloat16", ("normal", 0.02)),
        (("blocks", "layers", 0, "mixer_norm", "scale"), (L, d), "float32", norm),
        (m + ("wz",), (L, d, di), "bfloat16", ("normal", d ** -0.5)),
        (m + ("wx",), (L, d, di), "bfloat16", ("normal", d ** -0.5)),
        (m + ("wB",), (L, d, gn), "bfloat16", ("normal", d ** -0.5)),
        (m + ("wC",), (L, d, gn), "bfloat16", ("normal", d ** -0.5)),
        (m + ("wdt",), (L, d, nh), "bfloat16", ("normal", d ** -0.5)),
        (m + ("dt_bias",), (L, nh), "float32", ("softplus_inv_loguniform", 1e-3, 1e-1)),
        (m + ("A_log",), (L, nh), "float32", ("log_uniform", 1.0, 16.0)),
        (m + ("D",), (L, nh), "float32", norm),
        (m + ("conv_x",), (L, ck, di), "bfloat16", ("normal", ck ** -0.5)),
        (m + ("conv_B",), (L, ck, gn), "bfloat16", ("normal", ck ** -0.5)),
        (m + ("conv_C",), (L, ck, gn), "bfloat16", ("normal", ck ** -0.5)),
        (m + ("conv_bx",), (L, di), "bfloat16", ("normal", 0.1)),
        (m + ("conv_bB",), (L, gn), "bfloat16", ("normal", 0.1)),
        (m + ("conv_bC",), (L, gn), "bfloat16", ("normal", 0.1)),
        (m + ("norm_scale",), (L, di), "float32", norm),
        (m + ("wo",), (L, di, d), "bfloat16", ("normal", di ** -0.5)),
        (("final_norm", "scale"), (d,), "float32", norm),
    ]


def forward(c: dict, W: dict, tokens: torch.Tensor, positions, lin: R.Linear):
    """Logits (len(positions), vocab_size) in float32 at ``positions`` of
    the sequence ``tokens`` (1-D), each from the tokens up to it; every
    projection through ``lin``."""
    s = sizes(c)
    di, nh, P, G, N = s["di"], s["nh"], s["P"], s["G"], s["N"]
    gn = G * N
    lp = W["blocks"]["layers"][0]
    M = lp["mamba"]
    S = tokens.shape[0]
    x = W["embed"]["tok"][tokens].float()
    for i in range(s["L"]):
        h = R.rmsnorm(x, lp["mixer_norm"]["scale"][i], s["eps"])
        z = lin(h, ("wz", i), M["wz"][i])
        pre = torch.cat([lin(h, ("wx", i), M["wx"][i]), lin(h, ("wB", i), M["wB"][i]),
                         lin(h, ("wC", i), M["wC"][i])], dim=-1)
        dt = F.softplus(lin(h, ("wdt", i), M["wdt"][i]) + M["dt_bias"][i].float())
        post = R.causal_conv(pre, torch.cat([M["conv_x"][i], M["conv_B"][i], M["conv_C"][i]], 1),
                             torch.cat([M["conv_bx"][i], M["conv_bB"][i], M["conv_bC"][i]]))
        xh = post[:, :di].reshape(S, nh, P)
        y = R.ssd(xh, dt, -torch.exp(M["A_log"][i].float()),
                  post[:, di:di + gn].reshape(S, G, N), post[:, di + gn:].reshape(S, G, N))
        y = (y + M["D"][i].float()[:, None] * xh).reshape(S, di)
        y = R.rmsnorm(y * F.silu(z), M["norm_scale"][i], s["eps"])
        x = x + lin(y, ("wo", i), M["wo"][i])
    h = R.rmsnorm(x[torch.as_tensor(positions, device=x.device)], W["final_norm"]["scale"],
                  s["eps"])
    return lin(h, "unembed", W["embed"]["tok"][:s["V"]].T)


def call_flops(c: dict, kind: str, n_tokens: int, pos: int) -> float:
    """Floating-point operations one library call needs: a prefill of
    ``n_tokens`` returning the last position's logits, or a decode of one
    token.  Products only (2 per multiply-add): the projections, the conv,
    and the SSD recurrence counted as its state update and read-out, 4 * P
    * N per head and token (what the recurrence needs, whatever form
    computes it); norms, gates and activations are left out."""
    s = sizes(c)
    d, di, nh, P, N, L, V = s["d"], s["di"], s["nh"], s["P"], s["N"], s["L"], s["V"]
    gn = s["G"] * N
    per_token = L * (2 * d * (2 * di + 2 * gn + nh) + 2 * s["ck"] * (di + 2 * gn)
                     + 4 * nh * P * N + 2 * di * d)
    n = n_tokens if kind == "prefill" else 1
    return float(per_token * n + 2 * d * V)


def kernel_calls(c: dict, kind: str, n_tokens: int, pos: int) -> list:
    """(kernel op, shape, launches) of one library call: the SSD scan once a
    layer in a prefill; a decode steps the recurrence without a kernel op."""
    s = sizes(c)
    if kind == "prefill":
        return [("ssd_scan", {"B": 1, "S": n_tokens, "H": s["nh"], "P": s["P"], "G": s["G"],
                              "N": s["N"]}, s["L"])]
    return []
