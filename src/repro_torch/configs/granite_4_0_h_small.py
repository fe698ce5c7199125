"""granite-4.0-h-small — hybrid Mamba-2 + NoPE GQA attention, a dropless MoE
with a shared expert in every layer.
[hf:ibm-granite/granite-4.0-h-small; hf]
40L d_model=4096 (attention at layers 5, 15, 25, 35) 32H (GQA kv=8, head 128)
vocab=100352, MoE 72e top-10 (width 768) + shared SwiGLU 1536, Mamba-2 128 heads of 64
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=1536,                # the shared expert (shared_intermediate_size)
    vocab_size=100352,
    tie_embeddings=True,
    attn_every=10,            # attention at i % 10 == 5, Mamba-2 elsewhere
    attn_offset=5,
    moe=MoEConfig(num_experts=72, top_k=10, d_ff=768, dense_residual=True, every=1,
                  dropless=True),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4, chunk=256, n_groups=1),
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    norm_eps=1e-5,
    nope=True,
    notes="granitemoehybrid: h = x + 0.22 mixer(norm x); out = h + 0.22 (moe + shared)(norm h); "
          "router softmax over the top-10 logits; no token dropped.",
))
