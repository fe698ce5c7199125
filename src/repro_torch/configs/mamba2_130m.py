"""mamba2-130m — attention-free SSM (state-space duality / SSD).
[arXiv:2405.21060; unverified]
24L d_model=768 (attn-free) vocab=50280, ssm_state=128
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=24,            # SSD heads = d_inner/head_dim = 1536/64
    num_kv_heads=24,
    d_ff=0,                  # Mamba2 blocks have no separate FFN
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, conv_kernel=4, chunk=256),
    notes="pure Mamba2/SSD stack; O(1) decode state -> runs long_500k.",
))
