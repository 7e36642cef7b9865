"""Model code of the PyTorch port vs the JAX reference at nat-qwen3-8b
smoke size: parameter conversion, the init rule, paged prefill, and a
paged decode step through a block-table pool.

Parity runs under f32 params (the JAX params are upcast inside the test,
per the rule in docs/kernels.md), so the two frameworks differ only in
summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import nat_qwen3_8b as jax_configs
from repro.models import init_params as jax_init_params, model_decl
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import paged_prefill as jax_paged_prefill
from repro_torch.configs import nat_qwen3_8b
from repro_torch.models import model as M
from repro_torch.models.capabilities import CapabilityError
from repro_torch.models.config import ModelConfig, dense_blocks
from repro_torch.models.params import (
    ModelParams,
    init_params,
    params_from_jax,
)

# f32 logits after 3 layers, same inputs, sums in another order: observed
# ~1e-6; 1e-4 sits inside the f32-exactness bound of docs/kernels.md (2e-4)
ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_configs.smoke(), nat_qwen3_8b.smoke()
    jp_bf16 = jax_init_params(jax.random.PRNGKey(0), model_decl(jcfg))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), jp_bf16)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp_bf16, jp, tp


def test_params_from_jax_round_trips_bf16_exactly(setup):
    """bf16 leaves (ml_dtypes arrays) convert exactly, layers unstack in
    execution order, and every leaf lands in its counterpart."""
    _, cfg, jp_bf16, _, _ = setup
    tp = params_from_jax(jax.tree.map(np.asarray, jp_bf16), cfg, device="cpu")
    assert tp.dtype == torch.bfloat16

    def same(t, a):
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(a, np.float32))

    same(tp.embed, jp_bf16["embed"]["table"])
    same(tp.head, jp_bf16["head"]["w"])
    same(tp.final_norm, jp_bf16["final_norm"]["scale"])
    g = jp_bf16["group0"]["l0"]
    for r, blk in enumerate(tp.layers):
        same(blk.ln1, g["ln1"]["scale"][r])
        same(blk.ln2, g["ln2"]["scale"][r])
        for key in ("wq", "wk", "wv", "wo"):
            same(getattr(blk.mixer, key), g["mixer"][key][r])
        for key in ("w_gate", "w_up", "w_down"):
            same(getattr(blk.mlp, key), g["mlp"][key][r])


def test_init_params_follows_the_reference_rule(setup):
    """Same shapes as the reference's declaration; norms zero; embeddings
    N(0, 1); every matrix N(0, 1/fan_in) with fan_in = all dims but the
    last.  Draws come from the caller's generator."""
    jcfg, cfg, jp_bf16, _, _ = setup
    gen = torch.Generator().manual_seed(0)
    tp = init_params(cfg, gen, device="cpu")
    assert tp.dtype == torch.bfloat16
    assert tuple(tp.embed.shape) == jp_bf16["embed"]["table"].shape
    g = jp_bf16["group0"]["l0"]
    assert len(tp.layers) == g["mixer"]["wq"].shape[0] == cfg.n_layers
    blk = tp.layers[0]
    for key in ("wq", "wk", "wv", "wo"):
        assert tuple(getattr(blk.mixer, key).shape) == g["mixer"][key].shape[1:]
    assert torch.all(blk.ln1 == 0) and torch.all(tp.final_norm == 0)
    # sample std of n >= 4096 normal draws is within ~1% (1/sqrt(2n)) of
    # the rule; 10% still rejects any wrong fan-in (off by >= sqrt(2))
    assert abs(tp.embed.float().std().item() - 1.0) < 0.1
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    for w, fan_in in ((blk.mixer.wq, d * h), (blk.mixer.wo, h * dh),
                      (blk.mlp.w_down, cfg.d_ff), (tp.head, d)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.1
    tp2 = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(tp.layers[2].mlp.w_up, tp2.layers[2].mlp.w_up)


def test_paged_prefill_matches_jax(setup):
    jcfg, cfg, _, jp, tp = setup
    rng = np.random.default_rng(0)
    toks = rng.integers(3, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    lens = np.array([12, 7], np.int32)
    jl, jraw = jax_paged_prefill(jp, jcfg, jnp.asarray(toks), cache_len=32,
                                 prefill_len=jnp.asarray(lens))
    tl, traw = M.paged_prefill(tp, cfg, torch.from_numpy(toks),
                               prefill_len=torch.from_numpy(lens))
    assert tl.dtype == torch.float32 and tl.shape == (2, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for layer, entry in enumerate(traw):
        for key in ("k", "v"):
            want = np.asarray(jraw["group0"]["l0"][key][layer])
            for b, n in enumerate(lens):   # rows past a length are unused
                np.testing.assert_allclose(entry[key][b, :n].numpy(),
                                           want[b, :n], atol=ATOL)


def _pools(raw_np, prompt_pages, plen, num_pages, page_len):
    """Numpy pools with each slot's prompt K/V scattered into its prompt
    pages (one list of page ids per slot)."""
    n_layers, _, _, kvh, dh = raw_np["k"].shape
    k = np.zeros((n_layers, num_pages, page_len, kvh, dh), np.float32)
    v = np.zeros_like(k)
    pos = np.full((n_layers, num_pages, page_len), -1, np.int32)
    for s, row in enumerate(prompt_pages):
        for t in range(plen[s]):
            page, off = row[t // page_len], t % page_len
            k[:, page, off] = raw_np["k"][:, s, t]
            v[:, page, off] = raw_np["v"][:, s, t]
            pos[:, page, off] = t
    return k, v, pos


def test_decode_step_matches_jax_through_paged_pool(setup):
    """One decode step over a block-table pool: a slot with a -1 hole in
    its table, a slot on another page layout, and an inactive slot whose
    write is dropped (write_page == P).  Logits and the updated pool
    match the reference."""
    jcfg, cfg, _, jp, tp = setup
    rng = np.random.default_rng(1)
    pl_, num_pages = 4, 12
    plen = np.array([9, 6, 5], np.int32)
    toks = rng.integers(3, cfg.vocab_size, size=(3, 9)).astype(np.int32)
    _, jraw = jax_paged_prefill(jp, jcfg, jnp.asarray(toks), cache_len=32,
                                prefill_len=jnp.asarray(plen))
    raw_np = {k: np.asarray(jraw["group0"]["l0"][k]) for k in ("k", "v")}
    bt = np.array([[0, 1, 2, 3, -1], [5, 4, -1, 6, -1], [7, 8, -1, -1, -1]],
                  np.int32)
    k, v, pos = _pools(raw_np, [[0, 1, 2], [5, 4], [7, 8]], plen,
                       num_pages, pl_)
    new_tok = rng.integers(3, cfg.vocab_size, size=(3,)).astype(np.int32)
    qpos = plen.copy()
    wp = np.array([3, 6, num_pages], np.int32)       # slot 2 inactive: drop
    wo = np.array([0, 0, 0], np.int32)

    jcache = {"group0": {"l0": {"k": jnp.asarray(k), "v": jnp.asarray(v),
                                "pos": jnp.asarray(pos)}}}
    jl, jnew = jax_decode_step(
        jp, jcfg, jnp.asarray(new_tok), jcache, jnp.asarray(qpos),
        block_tables=jnp.asarray(bt), write_page=jnp.asarray(wp),
        write_off=jnp.asarray(wo), attn_impl="kernel")

    tcache = M.paged_cache_init(cfg, num_pages=num_pages, page_len=pl_,
                                dtype=torch.float32, device="cpu")
    for layer, pool in enumerate(tcache):
        pool["k"][:num_pages] = torch.from_numpy(k[layer])
        pool["v"][:num_pages] = torch.from_numpy(v[layer])
        pool["pos"][:num_pages] = torch.from_numpy(pos[layer])
    tl = M.decode_step(tp, cfg, torch.from_numpy(new_tok), tcache,
                       torch.from_numpy(qpos),
                       block_tables=torch.from_numpy(bt),
                       write_page=torch.from_numpy(wp),
                       write_off=torch.from_numpy(wo))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for layer, pool in enumerate(tcache):
        for key in ("k", "v", "pos"):
            np.testing.assert_allclose(
                pool[key][:num_pages].numpy(),
                np.asarray(jnew["group0"]["l0"][key][layer]), atol=ATOL)


def test_invalidate_pages_poisons_only_masked_pages(setup):
    _, cfg, _, _, _ = setup
    cache = M.paged_cache_init(cfg, num_pages=4, page_len=2,
                               dtype=torch.float32, device="cpu")
    for pool in cache:
        pool["pos"][:] = 7
    M.invalidate_pages(cache, torch.tensor([False, True, False, True]))
    for pool in cache:
        assert pool["pos"][:, 0].tolist() == [7, -1, 7, -1, 7]


def test_unported_mixers_raise_naming_the_roadmap_item():
    cfg = ModelConfig(name="m", d_model=16, n_heads=2, n_kv_heads=1,
                      head_dim=8, d_ff=32, vocab_size=11,
                      blocks=dense_blocks(2, mixer="mla"))
    with pytest.raises(CapabilityError, match="ROADMAP.md queue 1 item 4"):
        ModelParams(cfg, dtype=torch.float32, device="cpu")


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the cuda default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(nat_qwen3_8b.smoke(), torch.Generator())
