"""minicpm3-4b — dense, with Multi-head Latent Attention (MLA).

Matches the published ``openbmb/MiniCPM3-4B`` ``config.json``: 62 layers,
hidden 2560, 40 heads (padded to 48 in the parameters; n_kv_heads =
n_heads), SwiGLU of 6400, vocab 73448, rope theta 1e4, untied embeddings;
MLA ranks q_lora 768 and kv_lora 256, head dims nope 64, rope 32 and v 64.
"""
from repro_torch.types import ArchConfig, MLAConfig

CONFIG = ArchConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab=73_448,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64),
    rope_theta=10_000.0,
    source="[hf:openbmb/MiniCPM3-4B config.json; hf]",
)
