"""qwen3-moe-30b-a3b — 128 routed experts, top-8, with qk-norm.

Matches the published ``Qwen/Qwen3-30B-A3B`` ``config.json``: 48 layers,
hidden 2048, 32 heads (4 kv heads) of dim 128 with q and k RMS-normed, 128
experts of intermediate 768 with top-8 routing and the top-8 gates
renormalised, no shared expert, vocab 151936, rope theta 1e6, untied
embeddings.
"""
from repro_torch.types import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151_936,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768,
                  n_shared=0, d_shared=0, router_norm_topk=True),
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-30B-A3B config.json; hf]",
)
