"""command-r-plus-104b — dense GQA decoder LM, no biases, parallel block.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000
"""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    use_bias=False,
    parallel_block=True,
    optimizer="adafactor",   # 104B params: factored 2nd moment to fit v5e HBM
    notes="Cohere-style parallel attn+ffn residual; no-bias.",
))
