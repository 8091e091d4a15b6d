"""Model/architecture configuration — one frozen dataclass per assigned arch.

A copy of `repro/models/config.py` (the port never imports the reference
package); every field stays.

The same decoder composition serves all 10 assigned architectures via a
per-layer `block_pattern` ("attn" | "mamba" | "mlstm" | "slstm"), an optional
MoE config, and an optional modality frontend stub (audio/vlm per assignment).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mamba", "mlstm", "slstm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int                # routed experts (may be padded for EP divisibility)
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_padded: int = 0             # experts added for model-axis divisibility (never routed)
    shared_d_ff: int = 0          # shared-expert MLP hidden size (0 = none)
    every_n: int = 1              # MoE every n-th layer (others dense MLP)
    capacity_factor: float = 1.25
    group_size: int = 2048        # GShard dispatch group size (tokens)

    @property
    def n_total(self) -> int:
        return self.n_experts + self.n_padded


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 256              # chunked selective-scan block length


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3334
    n_heads: int = 4
    chunk: int = 256              # mLSTM chunkwise-parallel block length
    slstm_every: int = 6          # one sLSTM block per this many layers
    slstm_offset: int = 2


@dataclasses.dataclass(frozen=True)
class ParallelismPolicy:
    """Per-arch sharding policy (DESIGN.md §4)."""

    dp_only: bool = False         # tiny archs: replicate params, shard batch everywhere
    shard_vocab: bool = True      # embed/logits vocab dim over 'model'
    fsdp_params: bool = True      # shard param d_model dim over 'data' (ZeRO-3 style)
    remat: str = "full"           # "none" | "full" | "dots"
    scan_layers: bool = True      # lax.scan over the repeating layer block
    seq_shard_cache: bool = False  # KV cache: shard seq dim (when kv_heads < model axis)
    accum: int = 1                # gradient-accumulation microbatches (train)
    attn_chunk: int = 1024        # causal-attention query-chunk length
    pad_heads_to: int = 0         # pad q heads for TP divisibility (masked)
    pad_kv_heads_to: int = 0      # pad kv heads likewise
    pad_vocab_to: int = 0         # pad embed/lm_head rows (masked in CE)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    block_period: int = 1         # layer pattern repeats with this period
    pattern: tuple[BlockKind, ...] = ("attn",)   # one entry per layer-in-period
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    frontend: str = "none"        # none | audio | vision
    n_frontend_tokens: int = 0    # vision: patch tokens prepended into the sequence
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    policy: ParallelismPolicy = dataclasses.field(default_factory=ParallelismPolicy)
    # which layers get MoE within the period (True entry per period position)
    moe_layers: tuple[bool, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if len(self.pattern) != self.block_period:
            object.__setattr__(self, "pattern", tuple(["attn"] * self.block_period))
        if self.moe is not None and len(self.moe_layers) != self.block_period:
            object.__setattr__(self, "moe_layers", tuple([True] * self.block_period))
        if self.n_layers % self.block_period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"block_period={self.block_period}"
            )

    @property
    def n_repeat(self) -> int:
        return self.n_layers // self.block_period

    # padded-for-parallelism sizes (pad rows are masked: zero gradient, zero
    # contribution — capacity is EXACTLY the assigned config's)
    @property
    def hq_eff(self) -> int:
        return max(self.n_heads, self.policy.pad_heads_to)

    @property
    def hkv_eff(self) -> int:
        return max(self.n_kv_heads, self.policy.pad_kv_heads_to)

    @property
    def vocab_eff(self) -> int:
        return max(self.vocab_size, self.policy.pad_vocab_to)

    def kind_of_layer(self, i: int) -> BlockKind:
        return self.pattern[i % self.block_period]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return bool(self.moe_layers[i % self.block_period])

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model-FLOPs accounting)."""
        d, hd = self.d_model, self.head_dim
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size
        for i in range(self.block_period):
            kind = self.pattern[i]
            if kind == "attn":
                n += d * (self.n_heads + 2 * self.n_kv_heads) * hd + self.n_heads * hd * d
            elif kind == "mamba":
                mc = self.mamba
                din = mc.expand * d
                dtr = mc.dt_rank or -(-d // 16)
                n += d * 2 * din + mc.d_conv * din + din * (dtr + 2 * mc.d_state)
                n += dtr * din + din * mc.d_state + din + din * d
            elif kind == "mlstm":
                xc = self.xlstm
                din = int(xc.proj_factor_mlstm * d)
                din -= din % xc.n_heads
                # up (d,2din) + q/k/v (din,din)x3 + wif (din,nh,2) + down
                n += 2 * d * din + 3 * din * din + 2 * din * xc.n_heads + din * d
            elif kind == "slstm":
                xc = self.xlstm
                din = int(xc.proj_factor_slstm * d)
                din -= din % xc.n_heads
                # up (d,din) + wx (din,4,din) + r (nh,hd,4,hd) + down
                n += d * din + 4 * din * din + 4 * din * (din // xc.n_heads) + din * d
            if self.is_moe_layer(i):
                mo = self.moe
                n += d * mo.n_total + 3 * mo.n_experts * d * mo.d_expert
                if mo.shared_d_ff:
                    n += 3 * d * mo.shared_d_ff
            elif kind == "attn" or kind == "mamba":
                if self.d_ff > 0 and kind == "attn":
                    n += 3 * d * self.d_ff
            # hybrid: mamba layers in jamba also carry the (MoE or dense) FFN
            if kind == "mamba" and not self.is_moe_layer(i) and self.d_ff > 0:
                n += 3 * d * self.d_ff
        # the period repeats n_repeat times; norms are negligible
        per_period = n - self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.vocab_size * d * (1 if self.tie_embeddings else 2) + per_period * self.n_repeat

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        moe_layers_total = sum(
            1 for i in range(self.n_layers) if self.is_moe_layer(i)
        )
        inactive = 3 * self.d_model * mo.d_expert * (mo.n_experts - mo.top_k)
        return full - moe_layers_total * inactive
