"""nat-qwen3-8b — the paper's own subject model (Qwen3-8B): 36 layers,
d_model 4096, 32 query heads over 8 KV heads (GQA), head_dim 128, d_ff
12288, vocab 151936, SwiGLU, RoPE theta 1e6.  ``smoke()`` is the
reference's small test size of the same family."""
from repro_torch.models.config import ModelConfig, dense_blocks

ARCH_ID = "nat-qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        blocks=dense_blocks(36),
        mlp_kind="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=251,
        blocks=dense_blocks(3),
        mlp_kind="swiglu",
    )
