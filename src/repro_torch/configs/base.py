"""Config dataclasses of the language models (a copy of the reference's
``configs/base.py``): ``ModelConfig`` and its sub-configs with the same
fields, properties and analytic parameter count, and the four input shapes
(``ShapeConfig``, ``SHAPES``) with ``cell_is_runnable``, which
``registry.py`` crosses with the ten architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Arctic-style dense FFN residual branch running in parallel with the MoE.
    dense_residual: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block configuration."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2          # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 128         # SSD chunk length (MXU-aligned)


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block configuration."""
    lru_width: int = 0       # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("R", "R", "L")  # 2 recurrent : 1 local attn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm | vgg
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # --- attention flavour ---------------------------------------------------
    qk_norm: bool = False            # qwen3
    window: int = 0                  # sliding-window size; 0 = full attention
    # pattern over layers, tiled: "L"=local(window), "G"=global, "R"=recurrent
    layer_pattern: Tuple[str, ...] = ("G",)
    attn_softcap: float = 0.0        # gemma2: 50.0
    logit_softcap: float = 0.0       # gemma2: 30.0
    rope_theta: float = 10_000.0
    mlp_act: str = "swiglu"          # swiglu | geglu | gelu
    post_block_norm: bool = False    # gemma2 applies norms after attn/mlp too

    # --- enc-dec / multimodal stubs ------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 0             # whisper: 1500 precomputed frame embeddings
    num_patches: int = 0             # internvl2: precomputed ViT patch embeddings

    tie_embeddings: bool = False
    optimizer: str = "adamw"         # sgd | adamw | adafactor (per-arch, see DESIGN.md)
    remat: bool = True

    # ``long_500k`` only runs for sub-quadratic archs (see DESIGN.md §5).
    subquadratic: bool = False

    # ------------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n_mlp_mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        total = v * d                                     # embedding
        if not self.tie_embeddings:
            total += v * d                                # unembedding
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if self.family == "ssm" or kind == "R":
                if self.family == "ssm" and self.ssm is not None:
                    di = self.ssm.expand * d
                    nheads = di // self.ssm.head_dim
                    total += d * (2 * di + nheads) + di * self.ssm.conv_width
                    total += di * d + 2 * di * self.ssm.state_dim  # B,C projections folded
                else:  # RG-LRU
                    w = (self.rglru.lru_width or d) if self.rglru else d
                    total += 2 * d * w + 2 * w * w + w * d \
                        + w * (self.rglru.conv_width + 3)
            else:
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            # FFN / MoE
            if self.family == "ssm":
                continue  # mamba2 has no separate FFN (d_ff = 0)
            if self.moe is not None:
                total += d * self.moe.num_experts                  # router
                total += self.moe.num_experts * n_mlp_mats * d * f
                if self.moe.dense_residual:
                    total += n_mlp_mats * d * f
            else:
                total += n_mlp_mats * d * f
        if self.encoder_layers:
            for _ in range(self.encoder_layers):
                total += 4 * d * d + n_mlp_mats * d * f            # self-attn + ffn
                total += 4 * d * d                                 # decoder cross-attn (charged here)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_mlp_mats = 3 if self.mlp_act in ("swiglu", "geglu") else 2
        inactive = (self.moe.num_experts - self.moe.top_k) * n_mlp_mats * d * f
        return self.param_count() - self.num_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned input shapes (identical across the LM family pool).
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """40-cell matrix membership: (runnable, reason-if-skipped)."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "long_500k needs sub-quadratic attention (DESIGN.md §5)"
    return True, ""
