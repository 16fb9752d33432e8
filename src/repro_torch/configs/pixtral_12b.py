"""pixtral-12b — pixtral-ViT frontend (stub) and mistral-nemo decoder backbone.

[hf:mistralai/Pixtral-12B-2409; unverified]  40 layers, d_model 5120, 32
heads (GQA over 8 kv heads) of dim 128, d_ff 14336 (SwiGLU), vocab 131072,
rope theta 1e6, untied embeddings.  The vision frontend is a stub: a prompt
is precomputed patch embeddings (B, n_patches, d_model) fed to the
backbone, as in the JAX package; decoding then reads tokens.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131_072,
    rope_theta=1_000_000.0,
    frontend="vision",
    source="[hf:mistralai/Pixtral-12B-2409; unverified]",
)
