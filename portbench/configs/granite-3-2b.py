"""Plain float32 reference of a dense GQA decoder (granite-3.0 as the port
runs it): token embedding, per layer RMSNorm -> GQA attention with RoPE ->
residual, RMSNorm -> SwiGLU MLP -> residual, final RMSNorm, logits by the
tied embedding.  Sizes come from the configuration file ``c``; the port's
departures from granite-3.0 (no scalar multipliers, the port's epsilon)
are the file's ``departures`` and are followed here.

``layout`` names every weight in the port's parameter tree, with the
benchmark's own initial distribution; ``weights.py`` draws them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import reference as R

VOCAB_PAD = 2048          # the port holds the vocabulary in rows padded to this


def sizes(c: dict) -> dict:
    d, H = c["hidden_size"], c["num_attention_heads"]
    V = c["vocab_size"]
    return {"d": d, "L": c["num_hidden_layers"], "H": H, "K": c["num_key_value_heads"],
            "hd": d // H, "f": c["intermediate_size"], "V": V,
            "Vp": -(-V // VOCAB_PAD) * VOCAB_PAD, "eps": c["rms_norm_eps"],
            "theta": c["rope_theta"], "scale": c["attention_multiplier"]}


def layout(c: dict) -> list:
    s = sizes(c)
    d, L, H, K, hd, f = s["d"], s["L"], s["H"], s["K"], s["hd"], s["f"]
    lay = ("blocks", "layers", 0)
    norm = ("around", 1.0, 0.1)
    return [
        (("embed", "tok"), (s["Vp"], d), "bfloat16", ("normal", 0.02)),
        (lay + ("mixer_norm", "scale"), (L, d), "float32", norm),
        (lay + ("attn", "wq"), (L, d, H, hd), "bfloat16", ("normal", d ** -0.5)),
        (lay + ("attn", "wk"), (L, d, K, hd), "bfloat16", ("normal", d ** -0.5)),
        (lay + ("attn", "wv"), (L, d, K, hd), "bfloat16", ("normal", d ** -0.5)),
        (lay + ("attn", "wo"), (L, H, hd, d), "bfloat16", ("normal", (H * hd) ** -0.5)),
        (lay + ("ffn_norm", "scale"), (L, d), "float32", norm),
        (lay + ("mlp", "w_gate"), (L, d, f), "bfloat16", ("normal", d ** -0.5)),
        (lay + ("mlp", "w_up"), (L, d, f), "bfloat16", ("normal", d ** -0.5)),
        (lay + ("mlp", "w_down"), (L, f, d), "bfloat16", ("normal", f ** -0.5)),
        (("final_norm", "scale"), (d,), "float32", norm),
    ]


def forward(c: dict, W: dict, tokens: torch.Tensor, positions, lin: R.Linear):
    """Logits (len(positions), vocab_size) in float32 at ``positions`` of
    the sequence ``tokens`` (1-D), each from the tokens up to it; every
    projection through ``lin``."""
    s = sizes(c)
    d, H, K, hd = s["d"], s["H"], s["K"], s["hd"]
    P = W["blocks"]["layers"][0]
    S = tokens.shape[0]
    x = W["embed"]["tok"][tokens].float()
    for i in range(s["L"]):
        h = R.rmsnorm(x, P["mixer_norm"]["scale"][i], s["eps"])
        q = lin(h, ("wq", i), P["attn"]["wq"][i].reshape(d, H * hd)).view(S, H, hd)
        k = lin(h, ("wk", i), P["attn"]["wk"][i].reshape(d, K * hd)).view(S, K, hd)
        v = lin(h, ("wv", i), P["attn"]["wv"][i].reshape(d, K * hd)).view(S, K, hd)
        o = R.causal_attention(R.rope(q, s["theta"]), R.rope(k, s["theta"]), v, s["scale"])
        x = x + lin(o.reshape(S, H * hd), ("wo", i), P["attn"]["wo"][i].reshape(H * hd, d))
        h = R.rmsnorm(x, P["ffn_norm"]["scale"][i], s["eps"])
        g = F.silu(lin(h, ("w_gate", i), P["mlp"]["w_gate"][i])) * lin(h, ("w_up", i),
                                                                       P["mlp"]["w_up"][i])
        x = x + lin(g, ("w_down", i), P["mlp"]["w_down"][i])
    h = R.rmsnorm(x[torch.as_tensor(positions, device=x.device)], W["final_norm"]["scale"],
                  s["eps"])
    return lin(h, "unembed", W["embed"]["tok"][:s["V"]].T)


def call_flops(c: dict, kind: str, n_tokens: int, pos: int) -> float:
    """Floating-point operations one library call needs: a prefill of
    ``n_tokens`` returning the last position's logits, or a decode of one
    token at position ``pos`` (attending to pos + 1 keys).  Products only
    (2 per multiply-add); norms, RoPE, softmax and activations are left out."""
    s = sizes(c)
    d, H, K, hd, f, L, V = s["d"], s["H"], s["K"], s["hd"], s["f"], s["L"], s["V"]
    per_token = 2 * L * (d * (H + 2 * K) * hd + H * hd * d + 3 * d * f)
    if kind == "prefill":
        attn = 2 * L * H * hd * n_tokens * (n_tokens + 1)      # QK^T and PV, causal
        return float(per_token * n_tokens + attn + 2 * d * V)
    return float(per_token + 4 * L * H * hd * (pos + 1) + 2 * d * V)


def kernel_calls(c: dict, kind: str, n_tokens: int, pos: int) -> list:
    """(kernel op, shape, launches) of one library call: flash attention
    once a layer in a prefill, decode attention once a layer in a decode."""
    s = sizes(c)
    if kind == "prefill":
        return [("flash_attention", {"B": 1, "S": n_tokens, "H": s["H"], "K": s["K"],
                                     "D": s["hd"]}, s["L"])]
    return [("decode_attention", {"B": 1, "H": s["H"], "K": s["K"], "D": s["hd"],
                                  "kv_len": pos + 1}, s["L"])]
