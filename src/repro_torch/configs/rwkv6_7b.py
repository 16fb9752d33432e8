"""rwkv6-7b (Finch) — attention-free, data-dependent decay.

Matches the published ``RWKV/v6-Finch-7B-HF`` ``config.json``: 32 layers,
hidden 4096, head size 64 (64 WKV heads), intermediate 14336, vocab 65536,
untied embeddings; the architecture is that of arXiv:2404.05892.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab=65_536,
    block_pattern=("rwkv",),
    attn_kind="none",
    mlp_kind="relu2",
    rwkv_head_dim=64,
    subquadratic=True,
    source="[hf:RWKV/v6-Finch-7B-HF config.json; arXiv:2404.05892; hf]",
)
