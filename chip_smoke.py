#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build   — the port's CUDA kernel from the checkout's source with nvcc,
             printing torch's and nvcc's versions and the build's seconds.
2. kernel  — each kernel against its plain PyTorch version on the card at
             the serving path's shapes (H=32, KV=8, D=128, page_len 16, bf16
             pool; S in {16, 64}; 512 and 2048 cached tokens per slot; -1
             block-table columns, an inactive slot, NaN bytes in invisible
             entries), with its time, its bound, the plain version's time
             and one PyTorch call's time (``library_ms``, a yardstick the
             port never calls).
3. reference — the whole serving path at nat-qwen3-8b smoke size in f32:
             greedy tokens on the card equal the CPU's plain path, logprobs
             within 1e-4.
4. slice   — full-width nat-qwen3-8b (36 layers, random bf16 weights from a
             seed, made on the card): (a) ``AsyncLMServer`` streams 16
             requests for two tenants, (b) ``run_groups`` serves 6 prompts x
             G=8 so siblings park and resume.  Every request returns exactly
             its budget; the kernel's launch counter equals 36 x the decode
             substeps of each phase.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Prompts, budgets and weights come from
seeded torch generators; the script imports only ``repro_torch``, ``torch``
and the standard library.
"""
import asyncio
import json
import math
import os
import subprocess
import sys
import time

SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet, at the 700 W limit
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak, same source
# Kernel vs plain version on the same bf16 inputs: both accumulate in f32
# in different orders and round the output to bf16 once.  One bf16 ulp for
# |o| < 1 is 2**-8 = 3.9e-3, the bound the gpu-marked test uses; the kernel
# phase's outputs (printed as max_abs_out) stay under 1.  Measured on an
# H100: 9.8e-4.
BF16_ATOL = 2 ** -8
# Whole serving path, card vs CPU, f32 params: sums in another order only
F32_LOGP_ATOL = 1e-4
L2_BYTES = 50 * 2 ** 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` with CUDA events, L2 flushed before each
    launch (a serving step finds each layer's pool cold)."""
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    events = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    for a, b in events:
        total += a.elapsed_time(b)
    return total / iters


# ------------------------------------------------------------ kernel phase
def paged_case(torch, s, ntok, seed, h=32, kvh=8, d=128, pl=16):
    """A pool shaped like the serving path's: ragged contexts with a
    partial last page, a -1 hole in odd slots' tables, -1 tails, slot 1
    inactive, NaN K/V in every entry whose pos is -1 and in pages no table
    names."""
    g = torch.Generator().manual_seed(seed)
    m = -(-ntok // pl) + 2
    p = s * m + 4
    pos = torch.full((p, pl), -1, dtype=torch.int32)
    bt = torch.full((s, m), -1, dtype=torch.int32)
    q_pos = torch.full((s,), -1, dtype=torch.int32)
    perm = torch.randperm(p, generator=g).tolist()
    for si in range(s):
        n = ntok - (si % 4) * 7
        cols = [c for c in range(m) if not (si % 2 and c == 1)]
        for ci in range(-(-n // pl)):
            page = perm.pop()
            bt[si, cols[ci]] = page
            cnt = min(pl, n - ci * pl)
            pos[page, :cnt] = torch.arange(ci * pl, ci * pl + cnt)
        q_pos[si] = n - 1
    q_pos[1] = -1
    q = torch.randn(s, h, d, generator=g)
    kp = torch.randn(p, pl, kvh, d, generator=g)
    vp = torch.randn(p, pl, kvh, d, generator=g)
    kp[pos < 0] = float("nan")
    vp[pos < 0] = float("nan")
    bf = torch.bfloat16
    return [t.to("cuda") for t in (q.to(bf), kp.to(bf), vp.to(bf), pos, bt,
                                   q_pos)]


def paged_bound(torch, q, kp, pos, bt, q_pos):
    """Least time for the work: bytes of every input read once (q, the
    pages the active slots' tables reach, their pos rows, the tables) and
    the output written once, against HBM; 4*H*D operations per visible
    key against the bf16 peak.  Returns (ms, "bytes" | "operations")."""
    s, h, d = q.shape
    _, pl, kvh, _ = kp.shape
    active = q_pos >= 0
    pages = torch.unique(bt[active][bt[active] >= 0])
    nbytes = (2 * q.numel() * q.element_size()
              + pages.numel() * pl * (2 * kvh * d * kp.element_size() + 4)
              + bt.numel() * 4 + q_pos.numel() * 4)
    bt_a, qp_a = bt[active], q_pos[active]
    posg = pos[bt_a.clamp(min=0).long()]                      # (S', M, pl)
    vis = (bt_a[..., None] >= 0) & (posg >= 0) & (posg <= qp_a[:, None, None])
    ops = 4 * h * d * int(vis.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_phase(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import (
        paged_attention,
        paged_attention_ref,
    )
    from repro_torch.models.attention import gather_pages, repeat_kv

    rows = []
    for s, ntok in ((16, 512), (16, 2048), (64, 512), (64, 2048)):
        q, kp, vp, pos, bt, q_pos = paged_case(torch, s, ntok, SEED + s + ntok)
        h, d = q.shape[1:]
        kvh = kp.shape[2]
        args = (q, kp, vp, pos, bt, q_pos)
        out = paged_attention(*args)
        want = paged_attention_ref(q.reshape(s, kvh, h // kvh, d), kp, vp,
                                   pos, bt, q_pos).reshape(s, h, d)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            fail(f"paged_decode S={s} ctx={ntok}: non-finite output")
        if not torch.all(out[1] == 0):
            fail(f"paged_decode S={s} ctx={ntok}: inactive slot not zero")
        err = (out.float() - want.float()).abs().max().item()
        out_max = out.float().abs().max().item()
        if err > BF16_ATOL:
            fail(f"paged_decode S={s} ctx={ntok}: max |err| {err} > "
                 f"{BF16_ATOL}")
        ms = time_ms(torch, lambda: paged_attention(*args))
        plain_ms = time_ms(torch, lambda: paged_attention_ref(
            q.reshape(s, kvh, h // kvh, d), kp, vp, pos, bt, q_pos))
        # yardstick: SDPA over the same KV already gathered densely, with
        # the visibility mask; the gather is outside the timed call
        kg, vg, posg = gather_pages({"k": kp, "v": vp, "pos": pos}, bt)
        kd = repeat_kv(kg, h // kvh).transpose(1, 2).contiguous()
        vd = repeat_kv(vg, h // kvh).transpose(1, 2).contiguous()
        vd = torch.nan_to_num(vd)
        kd = torch.nan_to_num(kd)
        mask = ((posg >= 0) & (posg <= q_pos[:, None]))[:, None, None, :]
        q4 = q[:, :, None, :]
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask))
        bound_ms, bound_by = paged_bound(torch, q, kp, pos, bt, q_pos)
        row = {"S": s, "ctx": ntok, "max_abs_err": err,
               "max_abs_out": out_max, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        print(f"kernel paged_decode S={s} ctx={ntok}: max_abs_err={err:.3e} "
              f"(tol {BF16_ATOL:.3e}, max_abs_out={out_max:.3f}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({bound_by})", flush=True)
        rows.append(row)
        del kg, vg, kd, vd
    return rows


# --------------------------------------------------------- reference phase
def reference_phase(torch):
    """The serving path at smoke size, f32, on the card vs on the CPU."""
    from repro_torch.configs import nat_qwen3_8b
    from repro_torch.models.params import init_params
    from repro_torch.rl.engine import (
        PagedEngineConfig,
        PagedRolloutEngine,
        Request,
    )
    from repro_torch.rl.rollout import RolloutConfig

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    cfg = nat_qwen3_8b.smoke()
    p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                        device="cpu", dtype=torch.float32)
    p_gpu = init_params(cfg, torch.Generator().manual_seed(SEED),
                        device="cpu", dtype=torch.float32).to("cuda")
    g = torch.Generator().manual_seed(SEED + 1)
    groups = []
    for gi in range(4):
        n = int(torch.randint(4, 40, (1,), generator=g))
        toks = torch.randint(3, cfg.vocab_size, (n,), generator=g,
                             dtype=torch.int32).numpy()
        groups.append([Request(uid=gi * 3 + j, tokens=toks,
                               budget=int(torch.randint(
                                   4, 24, (1,), generator=g)))
                       for j in range(3)])
    rcfg = RolloutConfig(max_new_tokens=24, temperature=0.0, eos_id=-1)
    ecfg = PagedEngineConfig(num_slots=4, max_prompt_len=40, page_len=16,
                             steps_per_sync=4, max_group=3)
    out = {}
    for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = PagedRolloutEngine(cfg, rcfg, ecfg, device=dev)
        out[dev] = eng.run_groups(params, groups, SEED)
    worst = 0.0
    for a, b in zip(out["cpu"], out["cuda"]):
        if a.uid != b.uid or not (a.tokens == b.tokens).all():
            fail(f"reference: uid {a.uid} tokens differ card vs CPU")
        worst = max(worst, float(abs(a.logp - b.logp).max()))
    if worst > F32_LOGP_ATOL:
        fail(f"reference: logp differs by {worst} > {F32_LOGP_ATOL}")
    print(f"reference nat-qwen3-8b-smoke f32: {len(out['cuda'])} completions "
          f"token-exact card vs CPU, max |dlogp|={worst:.2e} "
          f"(tol {F32_LOGP_ATOL})", flush=True)


# ------------------------------------------------------------- slice phase
def _check_completions(comps, budgets, vocab, what):
    for c in comps:
        if c.response_len != budgets[c.uid]:
            fail(f"{what}: uid {c.uid} returned {c.response_len} tokens, "
                 f"budget {budgets[c.uid]}")
        if c.response_len and (int(c.tokens.min()) < 0
                               or int(c.tokens.max()) >= vocab):
            fail(f"{what}: uid {c.uid} token out of range")
        if not all(math.isfinite(x) and x <= 1e-4 for x in c.logp.tolist()):
            fail(f"{what}: uid {c.uid} logprob not finite or > 0")


def _rand_prompt(torch, g, vocab, lo, hi):
    n = int(torch.randint(lo, hi + 1, (1,), generator=g))
    return torch.randint(3, vocab, (n,), generator=g, dtype=torch.int32).numpy()


def slice_phase(torch):
    from repro_torch.configs import nat_qwen3_8b
    from repro_torch.kernels.paged_attn import paged_attention
    from repro_torch.models.params import init_params
    from repro_torch.rl.engine import (
        PagedEngineConfig,
        PagedRolloutEngine,
        Request,
    )
    from repro_torch.rl.rollout import RolloutConfig
    from repro_torch.serve import AsyncLMServer, ServeConfig

    cfg = nat_qwen3_8b.config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED),
                         device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"slice: {cfg.name} {cfg.n_layers} layers d_model={cfg.d_model} "
          f"random bf16 weights {nbytes / 1e9:.2f} GB made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rcfg = RolloutConfig(max_new_tokens=128, eos_id=-1)
    ecfg = PagedEngineConfig(num_slots=16, max_prompt_len=256, page_len=16,
                             steps_per_sync=8, max_group=8)
    eng = PagedRolloutEngine(cfg, rcfg, ecfg, device="cuda")
    g = torch.Generator().manual_seed(SEED + 2)
    results = {}
    launches = 0

    # (a) the async server: two tenants, 16 streamed requests
    reqs = [(("alice", "bob")[i % 2],
             _rand_prompt(torch, g, cfg.vocab_size, 16, 256),
             int(torch.randint(16, 129, (1,), generator=g))) for i in range(16)]

    async def serve():
        server = AsyncLMServer(eng, params, SEED,
                               ServeConfig(max_queue=64, quantum=256))
        streams = [server.submit(p, tenant=t, max_new=b) for t, p, b in reqs]
        await server.start()

        async def consume(st):
            deltas = [d async for d in st]
            return deltas, await st.result()

        got = await asyncio.gather(*(consume(st) for st in streams))
        await server.stop()
        return server, streams, got

    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    server, streams, got = asyncio.run(serve())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = paged_attention.launches
    comps = [c for _, c in got]
    budgets = {st.uid: b for st, (_, _, b) in zip(streams, reqs)}
    _check_completions(comps, budgets, cfg.vocab_size, "serve")
    for deltas, c in got:
        streamed = [int(x) for d in deltas for x in d.tolist()]
        if streamed != c.tokens.tolist():
            fail(f"serve: uid {c.uid} streamed deltas differ from its tokens")
    if eng.stats["prompt_prefills"] != len(reqs):
        fail(f"serve: {eng.stats['prompt_prefills']} prefills for "
             f"{len(reqs)} requests")
    if n_launch != cfg.n_layers * eng.stats["decode_steps"]:
        fail(f"serve: {n_launch} kernel launches != {cfg.n_layers} x "
             f"{eng.stats['decode_steps']} decode substeps")
    launches += n_launch
    toks = sum(c.response_len for c in comps)
    results["serve"] = {
        "requests": len(comps), "tokens": toks, "seconds": wall,
        "tokens_per_s": toks / wall, "mean_ttft_s": server.mean_ttft,
        "decode_substeps": eng.stats["decode_steps"],
        "kernel_launches": n_launch,
        "peak_pages_in_use": eng.stats["peak_pages_in_use"],
        "num_pages": eng.num_pages,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("slice (a) AsyncLMServer: " + json.dumps(results["serve"]),
          flush=True)

    # (b) run_groups: 6 prompts x G=8 on 16 slots — siblings park/resume
    groups, budgets = [], {}
    for gi in range(6):
        toks0 = _rand_prompt(torch, g, cfg.vocab_size, 16, 256)
        grp = []
        for j in range(8):
            uid = gi * 8 + j
            budgets[uid] = int(torch.randint(16, 129, (1,), generator=g))
            grp.append(Request(uid=uid, tokens=toks0, budget=budgets[uid]))
        groups.append(grp)
    torch.cuda.reset_peak_memory_stats()
    paged_attention.launches = 0
    t0 = time.perf_counter()
    comps = eng.run_groups(params, groups, SEED + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_launch = paged_attention.launches
    if len(comps) != 48:
        fail(f"run_groups: {len(comps)} completions for 48 requests")
    _check_completions(comps, budgets, cfg.vocab_size, "run_groups")
    if eng.stats["prompt_prefills"] != len(groups):
        fail(f"run_groups: {eng.stats['prompt_prefills']} prefills for "
             f"{len(groups)} groups")
    if n_launch != cfg.n_layers * eng.stats["decode_steps"]:
        fail(f"run_groups: {n_launch} kernel launches != {cfg.n_layers} x "
             f"{eng.stats['decode_steps']} decode substeps")
    launches += n_launch
    toks = sum(c.response_len for c in comps)
    results["run_groups"] = {
        "requests": len(comps), "tokens": toks, "seconds": wall,
        "tokens_per_s": toks / wall,
        "decode_substeps": eng.stats["decode_steps"],
        "kernel_launches": n_launch, "refills": eng.stats["refills"],
        "peak_pages_in_use": eng.stats["peak_pages_in_use"],
        "num_pages": eng.num_pages,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("slice (b) run_groups: " + json.dumps(results["run_groups"]),
          flush=True)
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail("src/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attn import ops

    print(nvidia_smi(), flush=True)
    ver = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout
    rel = [ln.strip() for ln in ver.splitlines() if "release" in ln]
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); nvcc: "
          f"{rel[0] if rel else ver.strip()}", flush=True)
    lib, secs, log = _build.build(ops.SOURCE)
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build paged_decode: {secs:.1f} s ({lib.name}); "
          f"{regs[0] if regs else ''}", flush=True)

    rows = kernel_phase(torch)
    reference_phase(torch)
    launches = slice_phase(torch)
    if launches == 0:
        fail("the serving path launched no paged_decode kernel")

    main_row = rows[0]          # S=16, 512 cached tokens: the slice's shape
    print(json.dumps({"kernels": [{
        "name": "paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attn/csrc/paged_decode.cu",
        "replaces": "src/repro/kernels/paged_attn/kernel.py:207",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shapes": rows}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
