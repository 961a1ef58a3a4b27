"""ModelConfig / ShapeConfig: the port's copy of the JAX package's config system.

A field-for-field copy of ``repro.configs.base`` with no JAX behind it:
the reference module pulls JAX in through ``repro.configs.shapes``, and the
port imports nothing of ``repro``. ``tests/test_torch_isolation.py`` holds
this copy equal to ``repro.configs.get_config(name)`` for every registered
architecture. ``param_count`` uses the port's own counter
(:func:`repro_torch.params.count_params`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Tuple

__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "REGISTRY",
    "register",
    "get_config",
    "list_archs",
    "smoke_variant",
]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 ⇒ d_model // num_heads

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0  # stablelm partial rotary
    window: int = 0  # 0 ⇒ global attention; >0 ⇒ local window
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu | relu
    glu: bool = True
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0  # per-expert hidden; 0 ⇒ d_ff
    first_k_dense: int = 0  # leading dense layers (DeepSeek-V3)
    router_aux_coef: float = 0.001
    moe_capacity_factor: float = 1.25
    moe_group_size: int = 256  # tokens per dispatch group (GShard style)
    moe_impl: str = "einsum"  # einsum (GShard baseline) | sort (optimized)

    # MLA (DeepSeek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # multi-token prediction (DeepSeek-V3)
    mtp: bool = False
    mtp_coef: float = 0.3

    # hybrid (RecurrentGemma / Griffin)
    block_pattern: Tuple[str, ...] = ()  # per-layer kinds, len == num_layers
    lru_width: int = 0
    conv1d_width: int = 4

    # ssm (RWKV6)
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # encoder-decoder (Seamless)
    encoder_layers: int = 0  # >0 ⇒ enc-dec; encoder is bidirectional
    source_len_for_decode: int = 4096  # cross-cache length for decode shapes

    # modality frontends (stubs: the caller supplies embeddings)
    frontend: str = "none"  # none | vision_stub | audio_stub
    num_frontend_tokens: int = 0  # vlm: patch tokens prepended
    frontend_dim: int = 0  # embedding dim delivered by the stub

    # numerics / training
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots  (activation ckpt policy)
    z_loss_coef: float = 1e-4

    # attention impl selector (kernels/ops.py): auto | pallas | ref | dense
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.moe_d_ff == 0 and self.num_experts:
            object.__setattr__(self, "moe_d_ff", self.d_ff)
        if self.block_pattern and len(self.block_pattern) != self.num_layers:
            raise ValueError(f"block_pattern len {len(self.block_pattern)} != {self.num_layers}")

    # -- derived -----------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: no O(S²) global-attention term."""
        if self.family == "ssm":
            return True
        if self.block_pattern:
            return all(k != "attn" or self.window > 0 for k in self.block_pattern)
        return False

    def param_count(self) -> int:
        """Parameter count of the port's tree (shapes only, nothing drawn)."""
        from repro_torch.params import count_params

        return count_params(self)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401 (registers all arch modules)

    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401 (registers all arch modules)

    return tuple(sorted(REGISTRY))


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Mechanically reduced same-family config for CPU smoke tests."""
    n_layers = min(cfg.num_layers, 4)
    if cfg.block_pattern:
        pattern = cfg.block_pattern[:n_layers]
        # keep at least one of each kind present in the original pattern
        kinds = []
        for k in cfg.block_pattern:
            if k not in kinds:
                kinds.append(k)
        if len(set(pattern)) < len(kinds):
            pattern = tuple((list(pattern) + kinds)[:n_layers])
    else:
        pattern = ()
    changes = dict(
        num_layers=n_layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(max(1, cfg.num_kv_heads * 4 // cfg.num_heads), 4),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=pattern,
        first_k_dense=min(cfg.first_k_dense, 1),
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.num_experts:
        changes.update(
            num_experts=min(cfg.num_experts, 8),
            num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
            moe_d_ff=64,
            moe_group_size=32,
        )
    if cfg.mla:
        changes.update(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32
        )
    if cfg.lru_width:
        changes.update(lru_width=128)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, source_len_for_decode=32)
    if cfg.num_frontend_tokens:
        changes.update(num_frontend_tokens=8, frontend_dim=min(cfg.frontend_dim, 64) or 64)
    if cfg.window:
        changes.update(window=16)
    return replace(cfg, name=cfg.name + "-smoke", **changes)
