"""minitron-4b — pruned Nemotron: squared-ReLU MLP with no gate.

Matches the published ``nvidia/Minitron-4B-Base`` ``config.json``
(arXiv:2407.14679): 32 layers, hidden 3072, 24 heads (8 kv heads) of dim
128, intermediate 9216 (relu2, ungated), vocab 256000, rope theta 1e4,
untied embeddings.  As the JAX package's config, the 24 query heads are
padded to 32 (``padded_heads``), and head h reads kv head h // 4, so the
real heads read kv heads 0-5 only, where the published model maps h to
h // 3.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256_000,
    mlp_kind="relu2",
    rope_theta=10_000.0,
    source="[hf:nvidia/Minitron-4B-Base config.json; arXiv:2407.14679; hf]",
)
