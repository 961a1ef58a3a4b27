"""The registered architectures, copied from ``repro.configs.archs``.

Every architecture the JAX package registers is registered here with the
same fields, so that later slices of the port need no new config code.
This slice runs only the dense kind (``serpytor-demo-100m`` at full size).
"""

from __future__ import annotations

from .base import ModelConfig, register

__all__ = []


@register("yi-6b")
def yi_6b() -> ModelConfig:
    # llama-arch GQA [arXiv:2403.04652]
    return ModelConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5_000_000.0,
    )


@register("qwen1.5-110b")
def qwen15_110b() -> ModelConfig:
    # QKV bias [hf:Qwen/Qwen1.5 family]
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


@register("stablelm-1.6b")
def stablelm_16b() -> ModelConfig:
    # partial rotary (25%), LayerNorm [hf:stabilityai/stablelm-2-1_6b]
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        norm="layernorm",
        norm_eps=1e-5,
        rope_fraction=0.25,
    )


@register("qwen3-1.7b")
def qwen3_17b() -> ModelConfig:
    # qk_norm, GQA [hf:Qwen/Qwen3 family]
    return ModelConfig(
        name="qwen3-1.7b",
        family="dense",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab_size=151936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


@register("granite-moe-3b-a800m")
def granite_moe() -> ModelConfig:
    # 40 experts top-8 (assignment header; hf pointer names a 32e sibling)
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        num_experts=40,
        num_experts_per_tok=8,
        moe_d_ff=512,
        tie_embeddings=True,
        moe_impl="a2a",
    )


@register("deepseek-v3-671b")
def deepseek_v3() -> ModelConfig:
    # MLA, 1 shared + 256 routed top-8, MTP [arXiv:2412.19437]
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=18432,
        vocab_size=129280,
        num_experts=256,
        num_experts_per_tok=8,
        num_shared_experts=1,
        moe_d_ff=2048,
        first_k_dense=3,
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        mtp=True,
        rope_theta=10_000.0,
        moe_impl="a2a",
    )


@register("internvl2-2b")
def internvl2_2b() -> ModelConfig:
    # InternViT (stub) + InternLM2-1.8b backbone [arXiv:2404.16821]
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        frontend="vision_stub",
        num_frontend_tokens=256,
        frontend_dim=1024,
    )


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    # Griffin: (rec, rec, attn) pattern, MQA window 2048 [arXiv:2402.19427]
    n_layers = 38
    pattern = tuple(("rec", "rec", "attn")[i % 3] for i in range(n_layers))
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=n_layers,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=pattern,
        lru_width=4096,
        window=2048,
        act="gelu",
        logit_softcap=30.0,
    )


@register("rwkv6-7b")
def rwkv6_7b() -> ModelConfig:
    # Finch: data-dependent decay, attention-free [arXiv:2404.05892]
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        rwkv_head_size=64,
        norm="layernorm",
    )


@register("seamless-m4t-large-v2")
def seamless_m4t() -> ModelConfig:
    # enc-dec multimodal backbone; speech frontend stubbed [arXiv:2308.11596]
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        encoder_layers=24,
        frontend="audio_stub",
        frontend_dim=1024,
        norm="layernorm",
        act="relu",
        glu=False,
        source_len_for_decode=4096,
    )


@register("serpytor-demo-100m")
def serpytor_demo() -> ModelConfig:
    """The paper's own end-to-end demo scale (~100M): served in full by this port."""
    return ModelConfig(
        name="serpytor-demo-100m",
        family="dense",
        num_layers=8,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32000,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
