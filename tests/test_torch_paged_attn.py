"""Paged decode attention in the PyTorch port vs the JAX reference.

The port's plain version (``repro_torch.kernels.paged_attn.ref``, which the
wrapper runs for CPU tensors) is held against the JAX Pallas kernel in
interpret mode and against the JAX oracle, on the sweep of
``tests/test_kernels_paged_attn.py`` (GQA / MHA / MQA, shared prompt pages,
partial-page gaps, unallocated ``-1`` columns, an inactive slot).  The CUDA
kernel is held against the plain version on the card (``gpu`` marker).

JAX is imported inside the tests that use it, so the ``gpu`` case also runs
on a card machine without JAX: ``python -m pytest -q --noconftest -m gpu
tests/test_torch_paged_attn.py`` (``tests/conftest.py`` imports JAX)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attn import paged_attention, paged_attention_ref

# (S, KV, G, D, P, page_len, M) — the reference kernel test's sweep
SWEEP = [
    (4, 2, 2, 32, 12, 8, 4),
    (2, 4, 1, 16, 8, 4, 5),     # MHA
    (3, 1, 8, 32, 16, 16, 3),   # MQA
    (5, 2, 3, 64, 20, 8, 6),
]
# f32 kernel vs oracle on identical inputs: the bound the reference kernel
# test uses (tests/test_kernels_paged_attn.py), sums in another order only
TOL = 2e-5


def data(s, kv, g, d, p, pl, m, seed=0):
    """Pool + block tables shaped like the engine's: a shared two-page
    prompt with a partial second page, slot-private decode pages, a -1 hole
    in the middle of one row, unallocated table tails, and an inactive last
    slot.  All numpy, from one seed."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((s, kv, g, d)) * 0.3).astype(np.float32)
    kp = (rng.standard_normal((p, pl, kv, d)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((p, pl, kv, d)) * 0.3).astype(np.float32)
    pos = np.full((p, pl), -1, np.int32)
    bt = np.full((s, m), -1, np.int32)
    plen = pl + max(1, pl // 2)
    pos[0] = np.arange(pl)
    pos[1, :plen - pl] = np.arange(pl, plen)
    q_pos = np.full((s,), -1, np.int32)
    nxt = 2
    for si in range(s - 1):  # last slot stays inactive
        bt[si, 0], bt[si, 1] = 0, 1
        ndec = int(rng.integers(0, m - 2)) if m > 2 else 0
        tok = 0
        for pi in range(ndec):
            if nxt >= p:
                break
            bt[si, 2 + pi] = nxt
            fill = int(rng.integers(1, pl + 1))
            pos[nxt, :fill] = 2 * pl + tok + np.arange(fill)
            tok += fill
            nxt += 1
        q_pos[si] = 2 * pl + max(tok - 1, 0)
    if m > 3 and bt[0, m - 1] < 0:
        bt[0, m - 1] = bt[0, 2]      # a named page after a -1 hole
        bt[0, 2] = -1
    return q, kp, vp, pos, bt, q_pos


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("s,kv,g,d,p,pl,m", SWEEP)
def test_plain_version_matches_jax_kernel_and_oracle(s, kv, g, d, p, pl, m):
    import jax.numpy as jnp
    from repro.kernels.paged_attn import (
        paged_attention_ref as jax_paged_attention_ref,
        paged_decode_pallas,
    )

    arrays = data(s, kv, g, d, p, pl, m)
    out = paged_attention_ref(*_torch(arrays)).numpy()
    jx = [jnp.asarray(a) for a in arrays]
    o_kernel = np.asarray(paged_decode_pallas(*jx))   # interpret mode
    o_ref = np.asarray(jax_paged_attention_ref(*jx))
    np.testing.assert_allclose(out, o_kernel, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, o_ref, rtol=TOL, atol=TOL)
    assert np.all(out[-1] == 0)     # inactive slot: exact zeros


@pytest.mark.parametrize("s,kv,g,d,p,pl,m", SWEEP[:1] + SWEEP[2:3])
def test_flat_head_wrapper_matches_jax_wrapper(s, kv, g, d, p, pl, m):
    """GQA regrouping of (S, H, D) queries: head h reads kv head h // G."""
    import jax.numpy as jnp
    from repro.kernels.paged_attn import paged_attention as jax_paged_attention

    q, kp, vp, pos, bt, qp = data(s, kv, g, d, p, pl, m, seed=1)
    qf = q.reshape(s, kv * g, d)
    out = paged_attention(*_torch((qf, kp, vp, pos, bt, qp))).numpy()
    ref = np.asarray(jax_paged_attention(
        *(jnp.asarray(a) for a in (qf, kp, vp, pos, bt, qp))))
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)


def test_nan_in_invisible_entries_does_not_leak():
    """NaN bytes in entries with pos = -1, and in pages no block table
    names, leave the output bitwise unchanged."""
    q, kp, vp, pos, bt, qp = data(*SWEEP[3])
    clean = paged_attention_ref(*_torch((q, kp, vp, pos, bt, qp)))
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[pos < 0] = np.nan
    vp2[pos < 0] = np.nan
    named = set(bt[bt >= 0].tolist())
    for page in range(kp.shape[0]):
        if page not in named:
            kp2[page] = np.nan
            vp2[page] = np.nan
    dirty = paged_attention_ref(*_torch((q, kp2, vp2, pos, bt, qp)))
    assert torch.equal(clean, dirty)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, kp, vp, pos, bt, qp = _torch(data(*SWEEP[0]))
    qf = q.reshape(q.shape[0], -1, q.shape[-1])
    with pytest.raises(TypeError, match="block_tables must be int32"):
        paged_attention(qf, kp, vp, pos, bt.long(), qp)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        paged_attention(qf.half(), kp, vp, pos, bt, qp)
    with pytest.raises(TypeError, match="share a dtype"):
        paged_attention(qf.bfloat16(), kp, vp, pos, bt, qp)
    with pytest.raises(ValueError, match="do not match"):
        paged_attention(qf, kp, vp[..., :-1], pos, bt, qp)
    with pytest.raises(ValueError, match="slots"):
        paged_attention(qf, kp, vp, pos, bt[:-1], qp)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The CUDA kernel against its plain version on the card, f32 and bf16
    pools, over the sweep plus NaN-poisoned invisible entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for case in SWEEP:
        q, kp, vp, pos, bt, qp = data(*case)
        kp[pos < 0] = np.nan
        vp[pos < 0] = np.nan
        s, kv, g, d = q.shape
        for dtype, tol in ((torch.float32, TOL),
                           # bf16 output rounding: one ulp at |o| < 1
                           (torch.bfloat16, 2 ** -8)):
            args = [t.cuda() for t in _torch(
                (q.reshape(s, kv * g, d), kp, vp, pos, bt, qp))]
            args[:3] = [a.to(dtype) for a in args[:3]]
            got = paged_attention(*args)
            want = paged_attention_ref(args[0].reshape(s, kv, g, d),
                                       *args[1:]).reshape(s, kv * g, d)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                       atol=tol)
            assert torch.all(got[-1] == 0)
