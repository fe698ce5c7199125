"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7) MoE decoder LM.
[arXiv:2403.19887; hf]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,            # 1 attention layer per 8 (1:7 with mamba)
    attn_offset=0,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, every=2),
    ssm=SSMConfig(d_state=128, expand=2, head_dim=128, conv_kernel=4, chunk=256),
    optimizer="adafactor",
    notes="attn at i%8==0, mamba otherwise; MoE on odd layers; runs long_500k.",
))
