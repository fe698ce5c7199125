"""moonshot-v1-16b-a3b — MoE decoder LM (kimi/moonlight), 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]
48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,               # mirrors per-expert hidden in the assignment line
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff=1408),
    notes="64 experts top-6; EP over the model mesh axis (4 experts/chip).",
))
