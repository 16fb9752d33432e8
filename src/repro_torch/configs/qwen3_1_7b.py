"""qwen3-1.7b — dense GQA with qk-norm.

Matches the published ``Qwen/Qwen3-1.7B`` ``config.json``: 28 layers,
hidden 2048, 16 heads (8 kv heads) of dim 128, intermediate 6144, vocab
151936, rope theta 1e6, tied word embeddings.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen3-1.7B config.json; hf]",
)
