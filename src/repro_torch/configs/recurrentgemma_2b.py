"""recurrentgemma-2b — RG-LRU and local-attention hybrid, two recurrent
layers to one attention layer.

The architecture of arXiv:2402.19427 (Griffin) at the widths of the
published ``google/recurrentgemma-2b`` ``config.json``: 26 layers, hidden
2560, 10 heads (1 kv head) of dim 256, intermediate 7680 (GeGLU), vocab
256000, a 2048-token attention window, LRU width 2560, rope theta 1e4, tied
embeddings.  As the JAX package's config, it leaves out three things the
published model has: the final logit soft-cap at 30, the sqrt(d) scaling
of the embeddings, and rope on only half of each head.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256_000,
    block_pattern=("rglru", "rglru", "attn_local"),
    attn_kind="gqa",
    mlp_kind="geglu",
    local_window=2048,
    lru_width=2560,
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=True,
    source="[arXiv:2402.19427; hf:google/recurrentgemma-2b config.json; hf]",
)
