"""qwen2-moe-a2.7b — 60 routed experts (top-4) beside 4 shared experts.

Matches the published ``Qwen/Qwen1.5-MoE-A2.7B`` ``config.json``: 24
layers, hidden 2048, 16 heads (16 kv heads) of dim 128, 60 experts of
intermediate 1408 with top-4 routing and no renormalisation of the top-4
gates, a shared expert of intermediate 5632 (4 x 1408) behind a sigmoid
gate, vocab 151936, rope theta 1e6, untied embeddings.  The 60 experts are
padded to 64 (``padded_experts``); the router never picks the padded ones.
"""
from repro_torch.types import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151_936,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632, router_norm_topk=False),
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B config.json; hf]",
)
