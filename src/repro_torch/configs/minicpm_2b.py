"""minicpm-2b — dense llama-like decoder LM trained with the WSD schedule.
[arXiv:2404.06395; hf]
40L d_model=2304 36H (GQA kv=36) d_ff=5760 vocab=122753
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122753,
    tie_embeddings=True,
    notes="WSD (warmup-stable-decay) LR schedule wired in optim.schedules; "
          "36 heads shard unevenly over model=16 (GSPMD padded sharding).",
))

# The arch-defining training feature: WSD schedule parameters.
WSD = dict(warmup_steps=0.01, stable_frac=0.9, final_lr_frac=0.1)
