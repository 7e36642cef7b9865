"""The PyTorch port's async serving front-end: DRR admission between
tenants (on a fake engine, as the reference's tests/test_serve.py does),
the streaming contract over the port's paged engine, graceful shedding,
and greedy tokens served equal to the JAX server's on the same requests.

Async tests run through ``asyncio.run`` inside plain sync tests (no
pytest-asyncio here)."""
import asyncio
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import nat_qwen3_8b as jax_configs
from repro.models import init_params as jax_init_params, model_decl
from repro.rl.engine import PagedEngineConfig as JaxPagedEngineConfig
from repro.rl.engine import PagedRolloutEngine as JaxPagedRolloutEngine
from repro.rl.rollout import RolloutConfig as JaxRolloutConfig
from repro.serve import AsyncLMServer as JaxAsyncLMServer
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import nat_qwen3_8b
from repro_torch.models.params import params_from_jax
from repro_torch.rl.engine import (
    Completion,
    PagedEngineConfig,
    PagedRolloutEngine,
    Request,
)
from repro_torch.rl.rollout import RolloutConfig
from repro_torch.serve import AsyncLMServer, ServeConfig, ServerSaturated

GEOM = dict(num_slots=3, max_prompt_len=24, steps_per_sync=2, page_len=8,
            max_group=1)
SCFG = dict(max_queue=16, max_backlog=2, quantum=16)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_configs.smoke(), nat_qwen3_8b.smoke()
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jax_init_params(jax.random.PRNGKey(0), model_decl(jcfg)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(("alice", "bob")[i % 2],
             rng.integers(3, cfg.vocab_size, size=int(rng.integers(4, 24)))
             .astype(np.int32), int(rng.integers(3, 10))) for i in range(8)]
    return types.SimpleNamespace(jcfg=jcfg, cfg=cfg, jp=jp, tp=tp, reqs=reqs)


def _serve(server, reqs):
    """Submit every request, stream to completion; returns per-uid
    (streamed deltas concatenated, Completion) in submission order."""
    async def main():
        streams = [server.submit(p, tenant=t, max_new=b) for t, p, b in reqs]
        await server.start()

        async def consume(s):
            deltas = [d async for d in s]
            return (np.concatenate(deltas) if deltas
                    else np.zeros((0,), np.int32)), await s.result()

        out = await asyncio.gather(*(consume(s) for s in streams))
        await server.stop()
        return out

    return asyncio.run(main())


def test_greedy_tokens_served_equal_the_jax_server(setup):
    rcfg = RolloutConfig(max_new_tokens=10, temperature=0.0, eos_id=-1)
    eng = PagedRolloutEngine(setup.cfg, rcfg, PagedEngineConfig(**GEOM),
                             device="cpu")
    got = _serve(AsyncLMServer(eng, setup.tp, 0, ServeConfig(**SCFG)),
                 setup.reqs)
    jeng = JaxPagedRolloutEngine(
        setup.jcfg, JaxRolloutConfig(max_new_tokens=10, temperature=0.0,
                                     eos_id=-1),
        JaxPagedEngineConfig(**GEOM))
    want = _serve(JaxAsyncLMServer(jeng, setup.jp, jax.random.PRNGKey(0),
                                   JaxServeConfig(**SCFG)), setup.reqs)
    for (deltas, comp), (_, jcomp), (_, _, budget) in zip(got, want,
                                                          setup.reqs):
        np.testing.assert_array_equal(comp.tokens, jcomp.tokens)
        np.testing.assert_array_equal(deltas, comp.tokens)
        assert comp.response_len == budget
    assert eng.stats["prompt_prefills"] == jeng.stats["prompt_prefills"]


def test_streaming_deltas_precede_completion(setup):
    """on_token deltas for a uid always arrive before its Completion, and
    their concatenation is exactly the completion's token array."""
    rcfg = RolloutConfig(max_new_tokens=10, temperature=1.0, eos_id=-1)
    eng = PagedRolloutEngine(setup.cfg, rcfg, PagedEngineConfig(**GEOM),
                             device="cpu")
    events = []
    eng.begin(setup.tp, 0,
              on_finish=lambda c: events.append(("fin", c.uid, c)),
              on_token=lambda u, t: events.append(("tok", u, t.copy())))
    for uid, (_, p, b) in enumerate(setup.reqs[:5]):
        eng.submit_group([Request(uid=uid, tokens=p, budget=b)])
    while not eng.idle:
        eng.drive()
    fins = {u: c for k, u, c in events if k == "fin"}
    assert len(fins) == 5
    for uid, comp in fins.items():
        fin_at = next(i for i, e in enumerate(events)
                      if e[0] == "fin" and e[1] == uid)
        deltas = [t for i, (k, u, t) in enumerate(events)
                  if k == "tok" and u == uid]
        assert not [i for i, (k, u, _t) in enumerate(events)
                    if k == "tok" and u == uid and i > fin_at]
        np.testing.assert_array_equal(np.concatenate(deltas), comp.tokens)


class FakeEngine:
    """Just enough engine for the scheduler: placement order is recorded,
    drive() hands every live request one token per round and retires it
    at its budget."""

    def __init__(self, max_new=4):
        self.rcfg = types.SimpleNamespace(max_new_tokens=max_new)
        self.order = []
        self._live = []

    def begin(self, params, seed, *, on_finish=None, on_token=None):
        self._fin, self._tok = on_finish, on_token

    def submit_group(self, reqs):
        (r,) = reqs
        self.order.append(r.uid)
        self._live.append([r, 0])

    @property
    def backlog(self):
        return 0          # placement is immediate; fairness stays upstream

    @property
    def idle(self):
        return not self._live

    def drive(self):
        done = []
        for ent in self._live:
            r, n = ent
            self._tok(r.uid, np.int32([n]))
            ent[1] = n + 1
            if ent[1] >= (r.budget or self.rcfg.max_new_tokens):
                done.append(ent)
        for ent in done:
            self._live.remove(ent)
            r, n = ent
            self._fin(Completion(uid=r.uid, prompt_len=len(r.tokens),
                                 tokens=np.arange(n, dtype=np.int32),
                                 logp=np.zeros(n), entropy=np.zeros(n),
                                 completed=True))
        return []


@pytest.mark.parametrize("weights,quantum", [(None, 64),
                                             ({"a": 2.0, "b": 1.0}, 32)])
def test_drr_shares_admission_between_tenants(weights, quantum):
    """Equal tenants alternate (every prefix of the admission order is
    within one request of balanced); a weight-2 tenant drains first but
    never starves the light one out of the early admissions."""
    async def main():
        eng = FakeEngine()
        # cost = 8 prompt + 56 budget = 64 tokens per request
        srv = AsyncLMServer(eng, None, 0,
                            ServeConfig(max_queue=64, max_backlog=8,
                                        quantum=quantum, default_budget=56),
                            tenant_weights=weights)
        streams = [srv.submit(np.arange(8), tenant=t)
                   for t in ["a"] * 6 + ["b"] * 6]
        await srv.start()
        await srv.drain()
        await srv.stop()
        return [dict((s.uid, s.tenant) for s in streams)[u]
                for u in eng.order]

    seq = asyncio.run(main())
    assert sorted(seq) == ["a"] * 6 + ["b"] * 6
    if weights is None:
        for i in range(1, len(seq) + 1):
            assert abs(seq[:i].count("a") - seq[:i].count("b")) <= 1, seq
    else:
        last = {t: max(i for i, x in enumerate(seq) if x == t) for t in "ab"}
        assert last["a"] < last["b"]
        assert "b" in seq[:4], f"light tenant starved: {seq}"


def test_shedding_is_graceful_and_recovers():
    """Past max_queue, submit sheds with ServerSaturated; admitted work
    still completes, and the queue accepts again once it drains."""
    async def main():
        srv = AsyncLMServer(FakeEngine(), None, 0,
                            ServeConfig(max_queue=3, max_backlog=2,
                                        quantum=64, default_budget=4))
        streams = [srv.submit(np.arange(4)) for _ in range(3)]
        with pytest.raises(ServerSaturated):
            srv.submit(np.arange(4))
        await srv.start()
        await srv.drain()
        streams.append(srv.submit(np.arange(4)))
        await srv.drain()
        await srv.stop()
        return [await s.result() for s in streams], srv.stats

    comps, stats = asyncio.run(main())
    assert all(c.completed for c in comps)
    assert stats["shed"] == 1 and stats["completed"] == 4


def test_engine_failure_reaches_every_stream():
    """An exception in the engine's round ends every open stream and is
    raised from its result(), instead of leaving consumers waiting."""
    class Broken(FakeEngine):
        def drive(self):
            raise RuntimeError("device fault")

    async def main():
        srv = AsyncLMServer(Broken(), None, 0,
                            ServeConfig(max_queue=8, max_backlog=1,
                                        quantum=64, default_budget=4))
        streams = [srv.submit(np.arange(4)) for _ in range(3)]
        await srv.start()
        for s in streams:
            assert [d async for d in s] == []
            with pytest.raises(RuntimeError, match="device fault"):
                await s.result()
        await srv.drain()
        with pytest.raises(RuntimeError, match="device fault"):
            await srv.stop()

    asyncio.run(main())
