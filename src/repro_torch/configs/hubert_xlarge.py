"""hubert-xlarge — encoder-only audio transformer (w2v2 architecture).

[arXiv:2106.07447; unverified]  48 layers, d_model 1280, 16 heads (16 kv
heads) of dim 80, d_ff 5120, vocab 504 (cluster targets, padded to 512).
Bidirectional attention, ungated GELU MLP, no decode step: its head is
``cls_head``, and prefill returns the frame logits.  The audio frontend
(the conv feature extractor) is a stub: the model reads precomputed frame
embeddings (B, n_frames, d_model), as in the JAX package.
"""
from repro_torch.types import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    mlp_kind="gelu",
    causal=False,
    has_decoder=False,
    frontend="audio",
    rope_theta=10_000.0,
    source="[arXiv:2106.07447; unverified]",
)
