"""Architecture configuration, copied from the JAX package's ``ArchConfig``.

The port keeps its own copy so that it imports nothing of the JAX package.
The fields, the derived properties, the analytic parameter count and
``reduced()`` are the same as there, so one config object describes the
same model in both packages.  ``ShapeConfig``, the four input shapes
(``SHAPES``) and ``applicable`` come too, for the dry-run.  ``HardwareProfile`` holds the
roofline's four constants and, for the cluster scheduler
(``repro_torch.core``), the cluster's shape and its network tiers
(``NetworkTier``).  Two profiles: the H100's (``H100_SXM``), which the
dry-run prices with, and the paper's NVIDIA cluster (``NVIDIA_PAPER``),
which the scheduler defaults to; the JAX package's TPU profile is not
copied.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int           # per-expert FFN hidden dim
    n_shared: int = 0       # number of (always-on) shared experts
    d_shared: int = 0       # total shared-expert hidden dim
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # renormalize top-k gate weights


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek/MiniCPM3 style)."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # block_pattern is tiled/truncated to n_layers.  Kinds:
    #   "attn"       global attention + mlp
    #   "attn_local" sliding-window attention + mlp
    #   "rglru"      RG-LRU recurrent block + mlp
    #   "rwkv"       RWKV6 time-mix + channel-mix
    block_pattern: Tuple[str, ...] = ("attn",)
    attn_kind: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False
    causal: bool = True
    mlp_kind: str = "swiglu"        # swiglu | geglu | gelu | relu2
    local_window: Optional[int] = None
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    has_decoder: bool = True        # False for encoder-only (hubert)
    subquadratic: bool = False      # can run long_500k decode
    frontend: Optional[str] = None  # None | "audio" | "vision" (stub embeddings)
    rwkv_head_dim: int = 64
    lru_width: Optional[int] = None  # RG-LRU recurrence width (defaults d_model)
    source: str = ""                # provenance note [source; tier]

    # -- derived ------------------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 so it shards over 16-way TP."""
        return -(-self.vocab // 128) * 128

    @property
    def padded_heads(self) -> int:
        """Query-head count padded to a multiple of 16 so head-sharding works
        on a 16-way "model" axis (40 -> 48, 24 -> 32, 10 -> 16).  Padded
        heads have zero-initialized weights and are masked before the output
        projection."""
        if self.attn_kind == "none":
            return self.n_heads
        return -(-self.n_heads // 16) * 16

    @property
    def padded_experts(self) -> int:
        """Expert count padded to a multiple of 16 (60 -> 64)."""
        if self.moe is None:
            return 0
        return -(-self.moe.n_experts // 16) * 16

    @property
    def uniform_blocks(self) -> bool:
        """True when every layer has identical structure (stackable)."""
        return len(set(self.layer_kinds())) == 1

    # ---- analytic parameter counts -----------------------------------------
    def _block_params(self, kind: str) -> int:
        d = self.d_model
        n = 0
        if kind in ("attn", "attn_local"):
            n += d  # ln
            if self.attn_kind == "mla":
                m = self.mla
                qk = m.qk_nope_dim + m.qk_rope_dim
                n += d * m.q_lora_rank + m.q_lora_rank          # wq_a + norm
                n += m.q_lora_rank * self.n_heads * qk          # wq_b
                n += d * (m.kv_lora_rank + m.qk_rope_dim) + m.kv_lora_rank
                n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                n += self.n_heads * m.v_head_dim * d            # wo
            else:
                hd = self.head_dim
                n += d * self.n_heads * hd                       # wq
                n += 2 * d * self.n_kv_heads * hd                # wk, wv
                n += self.n_heads * hd * d                       # wo
                if self.qk_norm:
                    n += 2 * hd
        elif kind == "rglru":
            w = self.lru_width or self.d_model
            n += d
            n += 2 * d * w          # x / gate branch linear-in
            n += 5 * w              # conv1d (width 4) + bias
            n += 3 * w              # a_param + gate biases
            n += 2 * w * w // 16    # block-diag gate projections (16 blocks)
            n += w * d              # linear-out
        elif kind == "rwkv":
            n += d
            n += 6 * d              # token-shift mus
            n += d * 32 * 5 + 32 * 5 * d  # ddlerp lora
            n += d * 64 + 64 * d    # decay lora
            n += (self.d_model // self.rwkv_head_dim) * self.rwkv_head_dim  # u
            n += 5 * d * d          # wr, wk, wv, wg, wo
            n += 2 * (self.d_model // self.rwkv_head_dim) * self.rwkv_head_dim  # ln_x
        # mlp / channel-mix
        if kind == "rwkv":
            n += d + 2 * d          # ln2 + mus
            n += d * self.d_ff + self.d_ff * d + d * d
        else:
            n += d  # ln2
            if self.moe is not None:
                m = self.moe
                exp = d * (2 * m.d_expert if self._gated else m.d_expert) + m.d_expert * d
                n += m.n_experts * exp + d * m.n_experts  # experts + router
                if m.n_shared:
                    n += d * 2 * m.d_shared + m.d_shared * d + d  # shared + gate
            else:
                f = self.d_ff
                n += d * (2 * f if self._gated else f) + f * d
        return n

    @property
    def _gated(self) -> bool:
        return self.mlp_kind in ("swiglu", "geglu")

    def n_params(self) -> int:
        n = self.padded_vocab * self.d_model  # embed
        if not self.tie_embeddings and self.has_decoder:
            n += self.padded_vocab * self.d_model  # lm head
        if not self.has_decoder:
            n += self.padded_vocab * self.d_model  # cls head
        n += self.d_model  # final norm
        for kind in self.layer_kinds():
            n += self._block_params(kind)
        return n

    def padding_delta(self) -> int:
        """Extra zero-weights introduced by head/expert padding."""
        delta = 0
        dh = self.padded_heads - self.n_heads
        if dh:
            for kind in self.layer_kinds():
                if kind not in ("attn", "attn_local"):
                    continue
                if self.attn_kind == "mla":
                    m = self.mla
                    delta += dh * ((m.qk_nope_dim + m.qk_rope_dim)
                                   * m.q_lora_rank
                                   + (m.qk_nope_dim + m.v_head_dim)
                                   * m.kv_lora_rank
                                   + m.v_head_dim * self.d_model)
                else:
                    delta += dh * self.head_dim * 2 * self.d_model
        if self.moe is not None:
            de = self.padded_experts - self.moe.n_experts
            if de:
                per = (self.d_model * (2 * self.moe.d_expert if self._gated
                                       else self.moe.d_expert)
                       + self.moe.d_expert * self.d_model)
                delta += self.n_layers * (de * per + de * self.d_model)
        return delta

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if self.moe is None:
            return self.n_params()
        m = self.moe
        per_exp = (self.d_model * (2 * m.d_expert if self._gated else m.d_expert)
                   + m.d_expert * self.d_model)
        inactive = (m.n_experts - m.top_k) * per_exp * self.n_layers
        return self.n_params() - inactive

    # ---- reduced config for CPU smoke tests -------------------------------
    def reduced(self) -> "ArchConfig":
        kw = dict(
            n_layers=min(self.n_layers, 2 * len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=96,
            vocab=256,
            lru_width=64 if self.lru_width else None,
            rwkv_head_dim=16,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=32,
                d_shared=64 if self.moe.n_shared else 0)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.local_window is not None:
            kw["local_window"] = 16
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of a step: a batch of ``global_batch`` sequences of
    ``seq_len`` tokens, for a ``kind`` of step ("train", "prefill" or
    "decode")."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether the (arch, shape) cell is architecturally runnable."""
    if shape.kind == "decode" and not arch.has_decoder:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch; 500k dense decode is quadratic (skip per assignment)"
    return True, ""


@dataclass(frozen=True)
class NetworkTier:
    name: str
    bandwidth: float       # bytes/s usable per participant
    latency: float         # seconds per hop (per collective step)


@dataclass(frozen=True)
class HardwareProfile:
    """What the dry-run's roofline prices a step with, per chip, and the
    cluster the scheduler's communication model prices a placement on."""
    name: str
    peak_flops: float    # FLOP/s, bf16 dense
    hbm_bw: float        # bytes/s of device memory
    link_bw: float       # bytes/s a direction of one chip's links (the collective term)
    hbm_per_chip: float  # bytes of device memory
    accel_per_machine: int = 8
    machines_per_rack: int = 8
    tiers: Tuple[NetworkTier, ...] = ()  # ordered best -> worst

    def tier(self, name: str) -> NetworkTier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)


# NVIDIA H100 SXM, data sheet: 989e12 bf16 dense FLOP/s, 3.35e12 B/s of HBM3,
# NVLink 4 at 900e9 B/s a chip, 450e9 each way, 80e9 bytes of HBM3.
H100_SXM = HardwareProfile(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12,
                           link_bw=450e9, hbm_per_chip=80e9)

# The paper's NVIDIA profile (Fig. 2 cluster: NVSwitch / Quantum IB / Spectrum).
NVIDIA_PAPER = HardwareProfile(
    name="nvidia_paper",
    peak_flops=312e12,          # A100-class bf16
    hbm_bw=2039e9,
    link_bw=112.5e9,            # 900 Gb/s NVSwitch per-GPU
    hbm_per_chip=80e9,
    accel_per_machine=8,
    machines_per_rack=8,
    tiers=(
        NetworkTier("machine", 112.5e9, 0.5e-6),  # NVSwitch 900 Gb/s
        NetworkTier("rack", 50e9, 1.5e-6),        # Quantum IB 400 Gb/s RDMA
        NetworkTier("network", 100e9, 10e-6),     # Spectrum 800 Gb/s, high latency
    ),
)

PROFILES = {p.name: p for p in (H100_SXM, NVIDIA_PAPER)}
