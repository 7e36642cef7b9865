"""Async serving front-end over the paged rollout engine — port of
``src/repro/serve/server.py`` (DESIGN.md §10).  Host code, copied with the
engine's JAX key replaced by a sampling seed.

``AsyncLMServer`` turns the batch-oriented ``PagedRolloutEngine`` into a
request/response server: callers ``submit()`` token prompts and get back a
``TokenStream`` they can async-iterate for incremental output, while one
pump task drives the engine and a deficit-round-robin scheduler arbitrates
admission between tenants.

Three concerns live here and NOT in the engine, on purpose:

* **Admission + fairness.**  Requests queue per tenant; each scheduler
  cycle credits every active tenant ``quantum * weight`` token-credits and
  admits from the head of its queue while credits cover the request's cost
  (prompt tokens + decode budget).  A tenant flooding the server therefore
  cannot starve a light one — admission interleaves proportionally to
  weight, not arrival order.  Deficits reset when a tenant's queue drains,
  so credit cannot be hoarded while idle (classic DRR).
* **Backpressure, two layers.**  The engine-side backlog is capped at
  ``max_backlog`` groups so queued work stays in the server where fairness
  applies; the server-side queue is capped at ``max_queue`` requests, past
  which ``submit`` raises ``ServerSaturated`` — graceful shedding, the
  caller sees an explicit signal while admitted requests keep streaming.
* **Streaming.**  The engine's ``on_token`` deltas land on each request's
  ``TokenStream`` queue; its ``on_finish`` completion resolves the
  stream's result future.  Deltas always precede the completion (engine
  contract), so a consumer that exhausts the iterator has seen every
  token before ``result()`` resolves.

The pump is deliberately simple: one asyncio task alternating
``admit -> engine.drive() -> yield``.  ``drive`` is a blocking device
round — fine here, because the engine batches all live requests into
that one call; concurrency between *requests* comes from the engine's
continuous batching, and the event loop only needs to interleave
*consumers* between rounds.
"""
from __future__ import annotations

import asyncio
import dataclasses
import itertools
import time
from typing import AsyncIterator, Dict, List, Optional

import numpy as np

from repro_torch.rl.engine import Completion, Request


class ServerSaturated(RuntimeError):
    """Both queues are full — the request was shed, try again later.

    ``retry_after_s`` is the server's own estimate of when a slot will
    free up, derived from the recent completion drain rate (see
    ``AsyncLMServer._retry_after``): a saturated caller can sleep that
    long instead of hammering ``submit`` in a tight loop.  Falls back to
    0.1 s when the server has not completed anything recently."""

    def __init__(self, msg: str, retry_after_s: float = 0.1):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Front-end knobs (the engine keeps its own ``PagedEngineConfig``)."""

    max_queue: int = 64       # server-side cap: pending requests before shed
    max_backlog: int = 2      # engine-side cap: unplaced groups pushed ahead
    quantum: int = 64         # DRR token-credits per tenant per cycle
    default_budget: int = 0   # 0 -> the engine rollout config's max_new

    def __post_init__(self):
        if self.quantum < 1:
            raise ValueError("quantum must be >= 1 (DRR cannot progress)")
        if self.max_queue < 1 or self.max_backlog < 1:
            raise ValueError("max_queue and max_backlog must be >= 1")


class TokenStream:
    """One request's live output: async-iterate numpy token deltas, then
    ``await result()`` for the final ``Completion``."""

    _DONE = object()

    def __init__(self, uid: int, tenant: str, loop: asyncio.AbstractEventLoop):
        self.uid = uid
        self.tenant = tenant
        self.submit_time = time.perf_counter()
        self.first_token_time: Optional[float] = None
        self._deltas: asyncio.Queue = asyncio.Queue()
        self._result: asyncio.Future = loop.create_future()

    # -- producer side (server callbacks) ---------------------------------
    def _push(self, toks: np.ndarray) -> None:
        if self.first_token_time is None:
            self.first_token_time = time.perf_counter()
        self._deltas.put_nowait(toks)

    def _finish(self, comp: Completion) -> None:
        # a zero-delta finish still records TTFT at completion time so
        # empty responses don't poison the latency statistics with None
        if self.first_token_time is None:
            self.first_token_time = time.perf_counter()
        self._deltas.put_nowait(self._DONE)
        if not self._result.done():
            self._result.set_result(comp)

    def _fail(self, exc: BaseException) -> None:
        # the pump died: end the iteration and raise from result(), so no
        # consumer waits forever on a request that will never finish
        self._deltas.put_nowait(self._DONE)
        if not self._result.done():
            self._result.set_exception(exc)

    # -- consumer side ----------------------------------------------------
    def __aiter__(self) -> AsyncIterator[np.ndarray]:
        return self

    async def __anext__(self) -> np.ndarray:
        item = await self._deltas.get()
        if item is self._DONE:
            raise StopAsyncIteration
        return item

    async def result(self) -> Completion:
        return await self._result

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time


@dataclasses.dataclass
class _Queued:
    request: Request
    stream: TokenStream
    cost: int


class AsyncLMServer:
    """Admission + fairness + streaming over one paged engine session.

    Usage::

        server = AsyncLMServer(engine, params, seed, scfg)
        await server.start()
        stream = server.submit(tokens, tenant="alice", max_new=32)
        async for delta in stream: ...
        comp = await stream.result()
        await server.stop()

    ``tenant_weights`` scales each tenant's DRR credit (default 1.0); an
    unknown tenant gets weight 1.0 — tenants are created on first submit.
    """

    def __init__(self, engine, params, seed: int, scfg: ServeConfig = ServeConfig(),
                 *, tenant_weights: Optional[Dict[str, float]] = None):
        self.engine = engine
        self.scfg = scfg
        self._params = params
        self._seed = seed
        self._weights = dict(tenant_weights or {})
        self._queues: Dict[str, List[_Queued]] = {}
        self._deficit: Dict[str, float] = {}
        self._rr: List[str] = []          # tenant visit order (rotating)
        self._streams: Dict[int, TokenStream] = {}
        self._uid = itertools.count()
        self._pump_task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._stopping = False
        # recent completion timestamps -> drain-rate estimate for the
        # retry_after_s hint carried by ServerSaturated (DESIGN.md §13)
        self._finish_times: List[float] = []
        self.stats = {"submitted": 0, "admitted": 0, "completed": 0,
                      "shed": 0, "tokens_out": 0, "ttft_sum": 0.0,
                      "ttft_max": 0.0, "drive_rounds": 0}

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._wake = asyncio.Event()
        self.engine.begin(self._params, self._seed,
                          on_finish=self._on_finish,
                          on_token=self._on_token)
        self._stopping = False
        self._pump_task = loop.create_task(self._pump())

    async def stop(self) -> None:
        """Stop pumping after in-flight work drains; queued-but-unadmitted
        requests are still admitted first (stop is graceful, not abort)."""
        self._stopping = True
        self._wake.set()
        if self._pump_task is not None:
            await self._pump_task
            self._pump_task = None

    async def drain(self) -> None:
        """Wait until every admitted and queued request has completed."""
        while self._streams or any(self._queues.values()):
            self._wake.set()
            await asyncio.sleep(0)

    # ------------------------------------------------------------- ingress
    def submit(self, tokens, *, tenant: str = "default",
               max_new: int = 0) -> TokenStream:
        """Queue one prompt; returns its ``TokenStream`` or raises
        ``ServerSaturated`` when the server-side queue is full."""
        queued = sum(len(q) for q in self._queues.values())
        if queued >= self.scfg.max_queue:
            self.stats["shed"] += 1
            hint = self._retry_after()
            raise ServerSaturated(
                f"queue full ({queued}/{self.scfg.max_queue} requests); "
                f"retry in ~{hint:.2f}s (completion drain-rate estimate)",
                retry_after_s=hint)
        budget = int(max_new) or self.scfg.default_budget
        uid = next(self._uid)
        req = Request(uid=uid,
                      tokens=np.asarray(tokens, np.int32).reshape(-1),
                      budget=budget)
        stream = TokenStream(uid, tenant, asyncio.get_event_loop())
        cost = len(req.tokens) + (budget or self.engine.rcfg.max_new_tokens)
        if tenant not in self._queues:
            self._queues[tenant] = []
            self._deficit[tenant] = 0.0
            self._rr.append(tenant)
        self._queues[tenant].append(_Queued(req, stream, cost))
        self._streams[uid] = stream
        self.stats["submitted"] += 1
        if self._wake is not None:
            self._wake.set()
        return stream

    async def submit_with_retry(self, tokens, *, tenant: str = "default",
                                max_new: int = 0, attempts: int = 3,
                                max_sleep_s: float = 1.0) -> TokenStream:
        """``submit`` with bounded backoff on ``ServerSaturated``.

        Sleeps ``min(retry_after_s, max_sleep_s)`` between attempts — the
        server's own drain-rate estimate paces the retry instead of a
        blind fixed interval — and re-raises the last ``ServerSaturated``
        once ``attempts`` are exhausted (never an unbounded spin)."""
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        for attempt in range(attempts):
            try:
                return self.submit(tokens, tenant=tenant, max_new=max_new)
            except ServerSaturated as e:
                if attempt + 1 >= attempts:
                    raise
                await asyncio.sleep(min(e.retry_after_s, max_sleep_s))
        raise AssertionError("unreachable")  # pragma: no cover

    def _retry_after(self) -> float:
        """Seconds until a queue slot likely frees: the mean gap between
        the last few completions.  With fewer than two recent completions
        there is no rate to measure — fall back to 0.1 s."""
        now = time.perf_counter()
        # only completions from the last few seconds say anything about
        # the *current* drain rate
        recent = [t for t in self._finish_times if now - t < 5.0]
        self._finish_times = recent
        if len(recent) < 2:
            return 0.1
        span = recent[-1] - recent[0]
        if span <= 0.0:
            return 0.1
        gap = span / (len(recent) - 1)
        return max(gap, 1e-3)

    # ----------------------------------------------------------- scheduler
    def _admit(self) -> int:
        """One DRR sweep: rotate tenants, credit ``quantum * weight``,
        admit head-of-line requests while credits cover their cost and the
        engine backlog stays under ``max_backlog``.  Returns admissions."""
        n = 0
        active = [t for t in self._rr if self._queues[t]]
        for tenant in active:
            if self.engine.backlog >= self.scfg.max_backlog:
                break
            q = self._queues[tenant]
            self._deficit[tenant] += (
                self.scfg.quantum * self._weights.get(tenant, 1.0))
            while q and self._deficit[tenant] >= q[0].cost:
                if self.engine.backlog >= self.scfg.max_backlog:
                    break
                item = q.pop(0)
                self._deficit[tenant] -= item.cost
                self.engine.submit_group([item.request])
                self.stats["admitted"] += 1
                n += 1
            if not q:
                self._deficit[tenant] = 0.0  # idle tenants hoard nothing
        # rotate so the next sweep starts with a different tenant
        if self._rr:
            self._rr.append(self._rr.pop(0))
        return n

    # -------------------------------------------------------- engine hooks
    def _on_token(self, uid: int, toks: np.ndarray) -> None:
        stream = self._streams.get(uid)
        if stream is not None and len(toks):
            stream._push(toks)
            self.stats["tokens_out"] += int(len(toks))

    def _on_finish(self, comp: Completion):
        stream = self._streams.pop(comp.uid, None)
        if stream is not None:
            stream._finish(comp)
            if stream.ttft is not None:
                self.stats["ttft_sum"] += stream.ttft
                self.stats["ttft_max"] = max(self.stats["ttft_max"],
                                             stream.ttft)
        self.stats["completed"] += 1
        self._finish_times.append(time.perf_counter())
        if len(self._finish_times) > 64:
            del self._finish_times[:-64]
        return None

    # ---------------------------------------------------------------- pump
    async def _pump(self) -> None:
        try:
            await self._pump_rounds()
        except BaseException as e:
            for stream in self._streams.values():
                stream._fail(e)
            self._streams.clear()
            for q in self._queues.values():
                q.clear()
            raise

    async def _pump_rounds(self) -> None:
        while True:
            while self._admit():
                pass
            has_queued = any(self._queues.values())
            if self.engine.idle and not has_queued:
                if self._stopping:
                    return
                self._wake.clear()
                await self._wake.wait()
                continue
            if not self.engine.idle:
                self.engine.drive()
                self.stats["drive_rounds"] += 1
            # yield so consumers can drain the deltas this round produced
            await asyncio.sleep(0)

    # ---------------------------------------------------------------- misc
    @property
    def queued(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @property
    def mean_ttft(self) -> float:
        done = self.stats["completed"]
        return self.stats["ttft_sum"] / done if done else 0.0
