"""Model and shape configuration dataclasses, and the architecture registry.

Counterpart of ``repro.configs.base``: the same fields, defaults and
properties, so a configuration means the same model in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | rwkv | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    act: str = "swiglu"           # swiglu | gelu
    rope_theta: float = 500_000.0
    rotary_pct: float = 1.0       # stablelm-style partial rotary
    window: Optional[int] = None  # sliding-window attention width
    qk_norm: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0             # expert hidden size (falls back to d_ff)
    n_shared_experts: int = 0     # llama4-style always-on shared expert
    # hybrid (zamba2): Mamba2 backbone + one shared attn block every k layers
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0
    # rwkv
    rwkv_chunk: int = 128
    # modality frontend stubs
    frontend: Optional[str] = None   # vision | audio
    frontend_frac: float = 0.25      # fraction of seq that is frontend embeds
    # encoder-decoder
    enc_layers: int = 0
    tie_embeddings: bool = True
    # numerics / memory
    dtype: str = "bfloat16"          # compute dtype (params master f32)
    block_q: int = 512               # blockwise-attention tile sizes
    block_k: int = 512
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | dots (saves matmul outputs)
    scan_layers: bool = True
    use_pallas: bool = False         # attention on the hand-written kernel
    # Head and vocab dims are padded up to a multiple of `shard_pad` for a
    # sharded mesh; 1 keeps the architecture's own shapes.
    shard_pad: int = 1

    def _pad(self, n: int) -> int:
        p = self.shard_pad
        return ((n + p - 1) // p) * p

    @property
    def heads_c(self) -> int:
        return self._pad(self.n_heads)

    @property
    def kv_heads_c(self) -> int:
        kv = self._pad(self.n_kv_heads)
        return min(kv, self.heads_c)

    @property
    def vocab_c(self) -> int:
        return self._pad(self.vocab)

    @property
    def gqa_groups(self) -> int:
        return max(self.heads_c // max(self.kv_heads_c, 1), 1)

    @property
    def d_inner(self) -> int:        # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            window=min(self.window, 64) if self.window else None,
            n_experts=min(self.n_experts, 4),
            moe_d_ff=128 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            rwkv_chunk=16,
            attn_every=2 if self.attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            block_q=64,
            block_k=64,
            dtype="float32",
            remat=False,
        )
        if self.attn_every:
            small["n_layers"] = 4
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell: sequence length, global batch and kind."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode | long_decode

    @property
    def is_training(self) -> bool:
        return self.kind == "train"


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.archs  # noqa: F401  (populates the registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401
    return sorted(_REGISTRY)
