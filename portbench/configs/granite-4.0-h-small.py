"""Plain float32 reference of granite-4.0-h (``granitemoehybrid``): a
Mamba-2 + attention hybrid with a dropless mixture of experts and a shared
expert in every layer.  Written from the published layer equations:

* ``x = embed(tokens) * embedding_multiplier``;
* per layer, ``h = x + residual_multiplier * mixer(rmsnorm(x))``, the mixer
  Mamba-2 (z, x, B, C and dt projected from the normed input, a causal
  depthwise conv then SiLU over x, B and C, the SSD recurrence with
  dt = softplus(. + dt_bias) and A = -exp(A_log), D * x added, an RMSNorm of
  the output times SiLU(z), the output projection) or, at the layers
  ``layer_types`` names ``attention``, causal GQA attention without position
  embedding (``position_embedding_type`` "nope") and its scores scaled by
  ``attention_multiplier``;
* ``x = h + residual_multiplier * (moe(n) + shared(n))``, ``n =
  rmsnorm(h)``: the router's logits, the top ``num_experts_per_tok`` taken
  and a softmax over them, each chosen expert's SwiGLU of width
  ``intermediate_size`` on the rows routed to it, weighted and summed, no
  row dropped; the shared expert a SwiGLU of width
  ``shared_intermediate_size`` on every row;
* logits by the tied embedding of ``rmsnorm(x)``, divided by
  ``logits_scaling``.

It runs one layer at a time, in float32, with no kernel, cache or batching,
and imports nothing of the program.  Under the fp8 control each layer's
rounded weights live only while the layer runs (a fresh ``Linear`` a
layer): the whole model rounded and held in float32 would be four times its
bf16 size.  Sizes come from the configuration file ``c``.

``layout`` names every weight in the port's parameter tree (layers stacked
over blocks of one period of ``layer_types``), with the benchmark's own
initial distribution; ``weights.py`` draws them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import reference as R

VOCAB_PAD = 2048          # the port holds the vocabulary in rows padded to this


def sizes(c: dict) -> dict:
    d, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    kinds = c["layer_types"]
    attn = [i for i, t in enumerate(kinds) if t == "attention"]
    period = attn[1] - attn[0] if len(attn) > 1 else len(kinds)
    P, nh = c["mamba_d_head"], c["mamba_n_heads"]
    return {"d": d, "L": c["num_hidden_layers"], "kinds": kinds, "period": period,
            "nb": c["num_hidden_layers"] // period, "H": H, "K": c["num_key_value_heads"],
            "hd": d // H, "di": nh * P, "P": P, "nh": nh, "G": c["mamba_n_groups"],
            "N": c["mamba_d_state"], "ck": c["mamba_d_conv"], "chunk": c["mamba_chunk_size"],
            "E": c["num_local_experts"], "k": c["num_experts_per_tok"],
            "f": c["intermediate_size"], "fs": c["shared_intermediate_size"], "V": V,
            "Vp": -(-V // VOCAB_PAD) * VOCAB_PAD, "eps": c["rms_norm_eps"],
            "scale": c["attention_multiplier"], "emb": c["embedding_multiplier"],
            "res": c["residual_multiplier"], "logits": c["logits_scaling"]}


def layout(c: dict) -> list:
    s = sizes(c)
    d, nb, H, K, hd = s["d"], s["nb"], s["H"], s["K"], s["hd"]
    di, nh, ck, E, f, fs = s["di"], s["nh"], s["ck"], s["E"], s["f"], s["fs"]
    gn = s["G"] * s["N"]
    norm = ("around", 1.0, 0.1)
    out = [(("embed", "tok"), (s["Vp"], d), "bfloat16", ("normal", 0.02))]
    for j in range(s["period"]):
        lay = ("blocks", "layers", j)
        out.append((lay + ("mixer_norm", "scale"), (nb, d), "float32", norm))
        if s["kinds"][j] == "attention":
            a = lay + ("attn",)
            out += [(a + ("wq",), (nb, d, H, hd), "bfloat16", ("normal", d ** -0.5)),
                    (a + ("wk",), (nb, d, K, hd), "bfloat16", ("normal", d ** -0.5)),
                    (a + ("wv",), (nb, d, K, hd), "bfloat16", ("normal", d ** -0.5)),
                    (a + ("wo",), (nb, H, hd, d), "bfloat16", ("normal", (H * hd) ** -0.5))]
        else:
            m = lay + ("mamba",)
            out += [
                (m + ("wz",), (nb, d, di), "bfloat16", ("normal", d ** -0.5)),
                (m + ("wx",), (nb, d, di), "bfloat16", ("normal", d ** -0.5)),
                (m + ("wB",), (nb, d, gn), "bfloat16", ("normal", d ** -0.5)),
                (m + ("wC",), (nb, d, gn), "bfloat16", ("normal", d ** -0.5)),
                (m + ("wdt",), (nb, d, nh), "bfloat16", ("normal", d ** -0.5)),
                (m + ("dt_bias",), (nb, nh), "float32", ("softplus_inv_loguniform", 1e-3, 1e-1)),
                (m + ("A_log",), (nb, nh), "float32", ("log_uniform", 1.0, 16.0)),
                (m + ("D",), (nb, nh), "float32", norm),
                (m + ("conv_x",), (nb, ck, di), "bfloat16", ("normal", ck ** -0.5)),
                (m + ("conv_B",), (nb, ck, gn), "bfloat16", ("normal", ck ** -0.5)),
                (m + ("conv_C",), (nb, ck, gn), "bfloat16", ("normal", ck ** -0.5)),
                (m + ("conv_bx",), (nb, di), "bfloat16", ("normal", 0.1)),
                (m + ("conv_bB",), (nb, gn), "bfloat16", ("normal", 0.1)),
                (m + ("conv_bC",), (nb, gn), "bfloat16", ("normal", 0.1)),
                (m + ("norm_scale",), (nb, di), "float32", norm),
                (m + ("wo",), (nb, di, d), "bfloat16", ("normal", di ** -0.5))]
        e = lay + ("moe",)
        out += [(lay + ("ffn_norm", "scale"), (nb, d), "float32", norm),
                (e + ("router",), (nb, d, E), "float32", ("normal", d ** -0.5)),
                (e + ("w_gate",), (nb, E, d, f), "bfloat16", ("normal", d ** -0.5)),
                (e + ("w_up",), (nb, E, d, f), "bfloat16", ("normal", d ** -0.5)),
                (e + ("w_down",), (nb, E, f, d), "bfloat16", ("normal", f ** -0.5)),
                (e + ("dense", "w_gate"), (nb, d, fs), "bfloat16", ("normal", d ** -0.5)),
                (e + ("dense", "w_up"), (nb, d, fs), "bfloat16", ("normal", d ** -0.5)),
                (e + ("dense", "w_down"), (nb, fs, d), "bfloat16", ("normal", fs ** -0.5))]
    return out + [(("final_norm", "scale"), (d,), "float32", norm)]


def _swiglu(lin, x, key, wg, wu, wd):
    return lin(F.silu(lin(x, key + ("g",), wg)) * lin(x, key + ("u",), wu), key + ("d",), wd)


def _mamba(s, lin, M, b, h):
    S = h.shape[0]
    di, nh, P, G, N = s["di"], s["nh"], s["P"], s["G"], s["N"]
    gn = G * N
    z = lin(h, "wz", M["wz"][b])
    pre = torch.cat([lin(h, "wx", M["wx"][b]), lin(h, "wB", M["wB"][b]),
                     lin(h, "wC", M["wC"][b])], dim=-1)
    dt = F.softplus(lin(h, "wdt", M["wdt"][b]) + M["dt_bias"][b].float())
    post = R.causal_conv(pre, torch.cat([M["conv_x"][b], M["conv_B"][b], M["conv_C"][b]], 1),
                         torch.cat([M["conv_bx"][b], M["conv_bB"][b], M["conv_bC"][b]]))
    xh = post[:, :di].reshape(S, nh, P)
    y = R.ssd(xh, dt, -torch.exp(M["A_log"][b].float()), post[:, di:di + gn].reshape(S, G, N),
              post[:, di + gn:].reshape(S, G, N), s["chunk"])
    y = (y + M["D"][b].float()[:, None] * xh).reshape(S, di)
    y = R.rmsnorm(y * F.silu(z), M["norm_scale"][b], s["eps"])
    return lin(y, "wo", M["wo"][b])


def _attention(s, lin, A, b, h):
    S = h.shape[0]
    d, H, K, hd = s["d"], s["H"], s["K"], s["hd"]
    q = lin(h, "wq", A["wq"][b].reshape(d, H * hd)).view(S, H, hd)
    k = lin(h, "wk", A["wk"][b].reshape(d, K * hd)).view(S, K, hd)
    v = lin(h, "wv", A["wv"][b].reshape(d, K * hd)).view(S, K, hd)
    o = R.causal_attention(q, k, v, s["scale"])                  # no RoPE: "nope"
    return lin(o.reshape(S, H * hd), "wo", A["wo"][b].reshape(H * hd, d))


def _moe(s, lin, Mo, b, h):
    """Dropless top-k MoE plus the shared expert, each routed expert on the
    rows routed to it."""
    top_v, top_i = lin(h, "router", Mo["router"][b]).topk(s["k"], dim=-1)
    gates = torch.softmax(top_v, dim=-1)
    y = _swiglu(lin, h, ("shared",), Mo["dense"]["w_gate"][b], Mo["dense"]["w_up"][b],
                Mo["dense"]["w_down"][b])
    for e in range(s["E"]):
        tok, slot = torch.nonzero(top_i == e, as_tuple=True)
        if len(tok):
            ye = _swiglu(lin, h[tok], ("expert", e), Mo["w_gate"][b, e], Mo["w_up"][b, e],
                         Mo["w_down"][b, e])
            y.index_add_(0, tok, gates[tok, slot][:, None] * ye)
    return y


def forward(c: dict, W: dict, tokens: torch.Tensor, positions, lin: R.Linear):
    """Logits (len(positions), vocab_size) in float32 at ``positions`` of
    the sequence ``tokens`` (1-D), each from the tokens up to it; every
    projection through ``lin``'s precision, the router's included."""
    s = sizes(c)
    x = W["embed"]["tok"][tokens].float() * s["emb"]
    for i in range(s["L"]):
        b, j = divmod(i, s["period"])
        lp = W["blocks"]["layers"][j]
        ll = R.Linear(lin.fp8)                       # this layer's rounded weights only
        h = R.rmsnorm(x, lp["mixer_norm"]["scale"][b], s["eps"])
        if s["kinds"][i] == "attention":
            mix = _attention(s, ll, lp["attn"], b, h)
        else:
            mix = _mamba(s, ll, lp["mamba"], b, h)
        x = x + s["res"] * mix
        h = R.rmsnorm(x, lp["ffn_norm"]["scale"][b], s["eps"])
        x = x + s["res"] * _moe(s, ll, lp["moe"], b, h)
    h = R.rmsnorm(x[torch.as_tensor(positions, device=x.device)], W["final_norm"]["scale"],
                  s["eps"])
    return lin(h, "unembed", W["embed"]["tok"][:s["V"]].T) / s["logits"]


def call_flops(c: dict, kind: str, n_tokens: int, pos: int) -> float:
    """Floating-point operations one library call needs: a prefill of
    ``n_tokens`` returning the last position's logits, or a decode of one
    token at position ``pos`` (attending to pos + 1 keys).  Products only
    (2 per multiply-add): the projections, the conv, the SSD recurrence as
    its state update and read-out (4 * P * N per head and token), the
    attention's two products, the router, the ``num_experts_per_tok``
    routed experts and the shared expert a token (not all experts); norms,
    gates, softmax and activations are left out."""
    s = sizes(c)
    d, H, K, hd, di, nh, P, N = s["d"], s["H"], s["K"], s["hd"], s["di"], s["nh"], s["P"], s["N"]
    gn = s["G"] * N
    n_attn = sum(t == "attention" for t in s["kinds"])
    mamba = (2 * d * (2 * di + 2 * gn + nh) + 2 * s["ck"] * (di + 2 * gn) + 4 * nh * P * N
             + 2 * di * d)
    attn = 2 * d * (H + 2 * K) * hd + 2 * H * hd * d
    ffn = 2 * d * s["E"] + 6 * d * (s["k"] * s["f"] + s["fs"])
    per_token = (s["L"] - n_attn) * mamba + n_attn * attn + s["L"] * ffn
    if kind == "prefill":
        scores = 2 * n_attn * H * hd * n_tokens * (n_tokens + 1)      # QK^T and PV, causal
        return float(per_token * n_tokens + scores + 2 * d * s["V"])
    return float(per_token + 4 * n_attn * H * hd * (pos + 1) + 2 * d * s["V"])


def kernel_calls(c: dict, kind: str, n_tokens: int, pos: int) -> list:
    """(kernel op, shape, launches) of one library call: in a prefill the
    SSD scan once a Mamba-2 layer, flash attention once an attention layer,
    the grouped experts once a layer; in a decode decode attention once an
    attention layer and the grouped experts once a layer (the recurrence
    steps without a kernel op)."""
    s = sizes(c)
    n_attn = sum(t == "attention" for t in s["kinds"])
    T = n_tokens if kind == "prefill" else 1
    experts = ("moe_experts", {"T": T, "k": s["k"], "E": s["E"], "d": s["d"], "f": s["f"]},
               s["L"])
    if kind == "prefill":
        return [("ssd_scan", {"B": 1, "S": n_tokens, "H": s["nh"], "P": s["P"], "G": s["G"],
                              "N": s["N"]}, s["L"] - n_attn),
                ("flash_attention", {"B": 1, "S": n_tokens, "H": s["H"], "K": s["K"],
                                     "D": s["hd"]}, n_attn), experts]
    return [("decode_attention", {"B": 1, "H": s["H"], "K": s["K"], "D": s["hd"],
                                  "kv_len": pos + 1}, n_attn), experts]
