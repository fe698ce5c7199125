"""whisper-medium — encoder-decoder audio transformer backbone.
[arXiv:2212.04356; unverified]
24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865

The conv frontend is a STUB: ``input_specs`` provides precomputed frame
embeddings of shape (batch, num_audio_frames, d_model); the backbone is
24 encoder + 24 decoder layers (LayerNorm + GELU, per Whisper).
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,          # decoder layers
    enc_layers=24,
    num_audio_frames=1500,  # 30 s of audio after conv stem (stubbed)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    use_bias=True,
    notes="enc-dec; conv frontend stubbed as precomputed frame embeddings.",
))
