"""yi-9b — llama-architecture dense GQA.

Matches the published ``01-ai/Yi-9B`` ``config.json`` (arXiv:2403.04652): 48
layers, hidden 4096, 32 heads (4 kv heads) of dim 128, intermediate 11008
(SwiGLU), vocab 64000, rope theta 5e6, untied embeddings.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab=64_000,
    rope_theta=5_000_000.0,
    source="[hf:01-ai/Yi-9B config.json; arXiv:2403.04652; hf]",
)
