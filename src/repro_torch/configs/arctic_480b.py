"""arctic-480b — MoE decoder LM with dense residual path.
[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864, dense_residual=True),
    optimizer="adafactor",   # 480B params: factored 2nd moment
    notes="dense-residual MoE (dense FFN in parallel with 128e top-2); "
          "56 heads shard unevenly over model=16 (GSPMD padded sharding).",
))
