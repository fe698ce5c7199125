"""llama-3.2-vision-90b — VLM decoder with cross-attention image layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256

The vision encoder is a STUB: ``input_specs`` provides precomputed patch
embeddings (batch, num_vision_tokens, d_model).  Every 5th layer carries a
gated cross-attention block over the vision tokens.
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_every=5,
    num_vision_tokens=1600,   # ~4 tiles x 400 patches (stubbed)
    optimizer="adafactor",
    notes="gated cross-attn image layers at i%5==4; vision frontend stubbed.",
))
