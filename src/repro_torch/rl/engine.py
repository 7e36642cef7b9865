"""Paged slot-arena rollout / serving engine — port of
``src/repro/rl/engine.py::PagedRolloutEngine`` (DESIGN.md §8).

A fixed set of decode slots runs over a paged KV pool per attention layer:
``(num_pages, page_len)`` pages named by host-built per-slot block tables.
A request that emits EOS or exhausts its budget is retired at the next
host round and its slot refilled from the queue while the other slots
keep decoding.

* ``submit_group`` registers a GRPO group: the shared prompt is prefilled
  ONCE into refcounted read-only pages and every sibling's block table
  starts with them; decode tokens always open a fresh slot-private page,
  so copy-on-write is never needed.
* Siblings beyond the free slots are PARKED: the prompt pages plus the
  prompt logits are the whole prompt state, so a parked sibling resumes
  into any freed slot by a pure scatter — one prefill per group, ever.
* APRIL cancellation frees a straggler's pages the round the host learns
  of it; freed pages are pos-poisoned on the device before any reuse.
* Allocation is host-side and allocate-ahead: before each round every
  occupied slot owns pages for every token it can write in the round, so
  the device never allocates; exhaustion raises ``PagePoolExhausted``.

The reference runs each round as one jitted step with a ``lax.scan`` over
``steps_per_sync`` decode substeps on donated state.  Here a round is an
eager Python loop of ``steps_per_sync`` substeps, and the device state
(pools and per-slot planes) is updated in place.  The host logic —
placement, parking, allocate-ahead, retirement, streaming, statistics —
is the reference's, so greedy runs give the same tokens and counters.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import capabilities as caps
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    decode_step,
    invalidate_pages,
    paged_cache_init,
    paged_prefill,
)

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class Request:
    uid: int
    tokens: np.ndarray  # (Tp,) int32, unpadded prompt
    budget: int = 0  # max new tokens; 0 -> rollout config's max_new_tokens


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: np.ndarray  # (response_len,) generated tokens (incl. EOS if hit)
    logp: np.ndarray  # (response_len,) behaviour logprobs
    entropy: np.ndarray  # (response_len,) behaviour entropies
    completed: bool  # emitted EOS within budget
    cancelled: bool = False  # retired early by the caller (quota met)

    @property
    def response_len(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass(frozen=True)
class PagedEngineConfig:
    """Geometry of the paged arena."""

    num_slots: int = 8
    max_prompt_len: int = 32
    steps_per_sync: int = 4    # decode substeps per host round-trip
    page_len: int = 16         # tokens per KV page
    num_pages: int = 0         # pool size; 0 -> dense-equivalent worst case
    group_lanes: int = 1       # groups prefilled per round
    max_group: int = 8         # widest group submit_group accepts
    resume_lanes: int = 0      # parked siblings placed per round; 0 -> auto

    @property
    def lanes(self) -> int:
        return self.group_lanes

    @property
    def resumes(self) -> int:
        """Parked siblings placed per round: a group's worth."""
        return self.resume_lanes or max(1, min(self.num_slots,
                                               self.max_group))


class PagePoolExhausted(RuntimeError):
    """The page pool cannot satisfy an allocation.

    Raised eagerly on the host — never silently corrupting the arena —
    with the pool occupancy in the message.  Fix by growing ``num_pages``
    (the auto default of ``num_slots * pages_per_slot`` can never
    exhaust) or shrinking slots/budgets.
    """


class PageAllocator:
    """Host-side free list + refcounts over the device page pool.

    A GRPO group's prompt pages carry one reference per live sibling and
    are freed when the last sibling retires; decode pages are slot-private
    (refcount 1) and return to the free list the moment their slot retires
    or is cancelled.  The allocator only does bookkeeping — the device
    learns about reuse via the engine's free-page invalidation mask.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))  # LIFO stack
        self.refcount = np.zeros((num_pages,), np.int32)
        self.peak_in_use = 0

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int, what: str = "") -> list:
        if n > len(self._free):
            raise PagePoolExhausted(
                f"page pool exhausted allocating {n} page(s){what}: "
                f"{self.in_use}/{self.num_pages} pages in use "
                f"({len(self._free)} free); grow PagedEngineConfig.num_pages "
                "or reduce num_slots / budgets")
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        self.refcount[list(pages)] += 1

    def release(self, pages: Sequence[int]) -> list:
        """Drop one reference per page; returns the pages actually freed
        (refcount hit zero) — these need invalidation before reuse."""
        freed = []
        for p in pages:
            if self.refcount[p] <= 0:
                raise RuntimeError(f"page {p} over-released")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


# --------------------------------------------------- shared substep pieces
def _substep_sample(st: dict, rcfg, n: int, gen: torch.Generator):
    """Sample the next token from the current logits and record it for live
    slots.  Temperature 0 is argmax; otherwise Gumbel-max over
    ``logits / temperature`` with uniforms drawn from ``gen``.  Mutates
    ``st`` in place (out_* planes) and returns (nxt, live)."""
    live = st["active"] & ~st["done"]
    logits = st["logits"]
    if rcfg.temperature == 0.0:
        nxt = logits.argmax(dim=-1)
    else:
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(F32).tiny)))
        nxt = (logits / rcfg.temperature + gumbel).argmax(dim=-1)
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, nxt[:, None])[:, 0]
    ent = -(logp_all.exp() * logp_all).sum(dim=-1)
    nxt = torch.where(live, nxt, torch.full_like(nxt, rcfg.pad_id)).to(I32)

    bi = torch.arange(live.shape[0], device=live.device)
    idx = st["n_gen"].clamp(max=n - 1).long()
    for key, val in (("out_tok", nxt), ("out_logp", logp), ("out_ent", ent)):
        plane = st[key]
        plane[bi, idx] = torch.where(live, val.to(plane.dtype), plane[bi, idx])
    return nxt, live


def _place_slot_planes(st: dict, slots: torch.Tensor, lens: torch.Tensor,
                       budgets: torch.Tensor, logits: torch.Tensor,
                       pad_id: int) -> None:
    """Install freshly-placed slots' per-slot planes in place — shared by
    group placement and parked-sibling resume: prompt logits in, counters
    zeroed, output buffers cleared."""
    st["logits"][slots] = logits.to(F32)
    st["pos"][slots] = lens
    st["prompt_len"][slots] = lens
    st["n_gen"][slots] = 0
    st["budget"][slots] = budgets
    st["active"][slots] = True
    st["done"][slots] = False
    st["eos_hit"][slots] = False
    st["out_tok"][slots] = pad_id
    st["out_logp"][slots] = 0.0
    st["out_ent"][slots] = 0.0


def _substep_advance(st: dict, nxt, live, new_logits, rcfg) -> None:
    """Substep tail, in place: merge the new logits for live slots, advance
    the position/count planes, latch EOS/budget retirement."""
    st["logits"] = torch.where(live[:, None], new_logits.to(F32),
                               st["logits"])
    st["pos"] += live
    st["n_gen"] += live
    hit_eos = live & (nxt == rcfg.eos_id)
    st["eos_hit"] |= hit_eos
    st["done"] |= live & (hit_eos | (st["n_gen"] >= st["budget"]))


class PagedRolloutEngine:
    """Slot arena over a paged KV pool with group-level prefix sharing.

    Session API (``src/repro/rl/engine.py``): ``begin`` installs params, a
    seeded sampling generator and a fresh pool; ``submit`` /
    ``submit_group`` enqueue at any time; ``drive`` runs one
    harvest/place/decode round and returns the Completions it retired;
    ``drain``, ``run_groups`` and ``run`` are run-to-completion wrappers.
    ``device`` defaults to ``"cuda"``; ``"cpu"`` runs the plain PyTorch
    path (tests).
    """

    def __init__(self, cfg: ModelConfig, rcfg, ecfg: PagedEngineConfig,
                 *, device="cuda"):
        caps.check_paged(cfg)
        self.device = resolve_device(device)
        self.cfg, self.rcfg, self.ecfg = cfg, rcfg, ecfg
        pl_ = ecfg.page_len
        self._n_pp = -(-ecfg.max_prompt_len // pl_)    # max prompt pages
        self._n_dp = -(-rcfg.max_new_tokens // pl_)    # max decode pages
        self._max_pages = self._n_pp + self._n_dp      # block table width
        self.num_pages = ecfg.num_pages or ecfg.num_slots * self._max_pages
        # parking needs the prompt state to live wholly in shared pages +
        # saved logits: true for pure pool-resident stacks
        self._pure_pool = caps.pure_pool_prefix(cfg)
        if not self._pure_pool and ecfg.max_group > ecfg.num_slots:
            raise ValueError("max_group cannot exceed num_slots: per-slot-"
                             "state mixers place groups atomically")
        self.stats: dict = {}
        self._params = None
        self._gen: Optional[torch.Generator] = None
        self._on_finish = None
        self._on_token = None
        self._streamed: list = [0] * ecfg.num_slots
        self._queue: collections.deque = collections.deque()
        self._slot_uid: list = [None] * ecfg.num_slots
        self._to_cancel: set = set()
        self._state: Optional[dict] = None
        self._reset_pool()

    # ------------------------------------------------------------ host pool
    def _reset_pool(self) -> None:
        s = self.ecfg.num_slots
        self._alloc = PageAllocator(self.num_pages)
        self._slot_prompt_pages: list = [[] for _ in range(s)]
        self._slot_decode_pages: list = [[] for _ in range(s)]
        self._slot_plen = np.zeros((s,), np.int32)
        self._slot_budget = np.zeros((s,), np.int32)
        self._n_gen_ub = np.zeros((s,), np.int64)  # host upper bound on n_gen
        self._dirty: set = set()  # freed pages awaiting pos-invalidation
        # partially-placed groups: prompt prefilled, some siblings parked
        # awaiting a free slot; each record holds one extra prompt-page
        # reference until its last sibling places or cancels
        self._pending: list = []

    def _init_state(self, params) -> dict:
        """Pools (every page pos-poisoned) + zeroed per-slot planes."""
        s, n = self.ecfg.num_slots, self.rcfg.max_new_tokens
        dev = self.device

        def z(*shape, dtype=I32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "cache": paged_cache_init(self.cfg, num_pages=self.num_pages,
                                      page_len=self.ecfg.page_len,
                                      dtype=params.dtype, device=dev),
            "logits": z(s, self.cfg.vocab_size, dtype=F32),
            "pos": z(s), "prompt_len": z(s), "n_gen": z(s), "budget": z(s),
            "active": z(s, dtype=torch.bool), "done": z(s, dtype=torch.bool),
            "eos_hit": z(s, dtype=torch.bool),
            "out_tok": torch.full((s, n), self.rcfg.pad_id, dtype=I32,
                                  device=dev),
            "out_logp": z(s, n, dtype=F32), "out_ent": z(s, n, dtype=F32),
        }

    # ----------------------------------------------------- host side: session
    def begin(
        self,
        params,
        seed: int,
        *,
        on_finish: Optional[Callable[[Completion], Optional[Iterable[int]]]]
        = None,
        on_token: Optional[Callable[[int, np.ndarray], None]] = None,
    ) -> None:
        """Open a session: fresh pool, empty queue, zeroed stats, sampling
        generator seeded with ``seed``.

        ``on_finish(completion)`` fires as each request retires (inside
        ``drive``) and may return uids to cancel — queued uids are dropped
        before placement, in-flight uids retire early with
        ``cancelled=True`` in the same round they are discovered.

        ``on_token(uid, tokens)`` streams incremental output: it fires at
        the top of each ``drive`` with the tokens a request generated
        since its last delivery, and a request's deltas always arrive
        before its Completion."""
        if params.device != self.device:
            raise ValueError(f"params live on {params.device}, the engine "
                             f"on {self.device}")
        self._params = params
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._on_finish = on_finish
        self._on_token = on_token
        self._streamed = [0] * self.ecfg.num_slots
        self._queue = collections.deque()
        self._slot_uid = [None] * self.ecfg.num_slots
        self._to_cancel = set()
        self._state = self._init_state(params)
        self._reset_pool()
        self.stats = {"rounds": 0, "decode_steps": 0, "refills": 0,
                      "tokens_generated": 0, "cancelled": 0,
                      "slot_substeps": 0, "prompt_prefills": 0,
                      "pages_in_use": 0, "peak_pages_in_use": 0,
                      "prompt_tokens": 0, "prefill_tokens": 0}

    def _validate_requests(self, requests: Sequence[Request]) -> None:
        rcfg, tp = self.rcfg, self.ecfg.max_prompt_len
        for r in requests:
            if len(r.tokens) > tp:
                raise ValueError(f"request {r.uid}: prompt longer than {tp}")
            if len(r.tokens) < 1:
                raise ValueError(f"request {r.uid}: empty prompt")
            if r.budget > rcfg.max_new_tokens:
                raise ValueError(f"request {r.uid}: budget > max_new_tokens")

    def submit(self, requests: Sequence[Request]) -> None:
        """Ungrouped requests: each becomes its own group of one."""
        for r in requests:
            self.submit_group([r])

    def submit_group(self, requests: Sequence[Request]) -> None:
        """Enqueue one group: siblings share a single prompt whose pages
        are prefilled once and refcounted across all of them."""
        reqs = list(requests)
        if not reqs:
            return
        if len(reqs) > self.ecfg.max_group:
            raise ValueError(
                f"group of {len(reqs)} exceeds max_group="
                f"{self.ecfg.max_group}")
        self._validate_requests(reqs)
        t0 = np.asarray(reqs[0].tokens)
        for r in reqs[1:]:
            if not np.array_equal(np.asarray(r.tokens), t0):
                raise ValueError(
                    "submit_group: siblings must share one prompt "
                    f"(uid {r.uid} differs from uid {reqs[0].uid})")
        pl_, n = self.ecfg.page_len, self.rcfg.max_new_tokens
        # worst-case CONCURRENT need: prompt pages once, plus decode pages
        # for the largest siblings that can run at the same time (parking
        # bounds concurrency by the slot count)
        dp = sorted((-(-(r.budget or n) // pl_) for r in reqs), reverse=True)
        need = -(-len(t0) // pl_) + sum(dp[:self.ecfg.num_slots])
        if need > self.num_pages:
            raise PagePoolExhausted(
                f"group needs up to {need} concurrent pages but the pool "
                f"holds only {self.num_pages}; grow "
                "PagedEngineConfig.num_pages")
        self._queue.append(reqs)

    def cancel(self, uids: Iterable[int]) -> None:
        """Mark uids for cancellation, handled at the next ``drive``."""
        self._to_cancel.update(uids)

    @property
    def idle(self) -> bool:
        """No queued or parked work and every slot free."""
        return (not self._queue and not self._pending
                and all(u is None for u in self._slot_uid))

    @property
    def backlog(self) -> int:
        """Queued groups plus partially-placed (parked) groups — the
        admission signal the serving front-end throttles on."""
        return len(self._queue) + len(self._pending)

    def _free_slot_pages(self, s: int) -> None:
        freed = self._alloc.release(self._slot_decode_pages[s])
        freed += self._alloc.release(self._slot_prompt_pages[s])
        self._dirty.update(freed)
        self._slot_decode_pages[s] = []
        self._slot_prompt_pages[s] = []

    def _harvest(self, s: int, host, cancelled: bool) -> Completion:
        uid = self._slot_uid[s]
        rl = int(host["n_gen"][s])
        comp = Completion(
            uid=uid,
            prompt_len=int(host["prompt_len"][s]),
            tokens=host["out_tok"][s, :rl].copy(),
            logp=host["out_logp"][s, :rl].copy(),
            entropy=host["out_ent"][s, :rl].copy(),
            completed=bool(host["eos_hit"][s]) and not cancelled,
            cancelled=cancelled)
        self._slot_uid[s] = None
        self.stats["tokens_generated"] += rl
        if cancelled:
            self.stats["cancelled"] += 1
        if self._on_finish is not None:
            self._to_cancel.update(self._on_finish(comp) or ())
        self._free_slot_pages(s)
        return comp

    def _collect_retirements(self) -> tuple:
        """Sync the control planes and harvest every retired or cancelled
        slot.  Returns (harvested Completions, cancel_mask (S,) bool)."""
        state, slot_uid = self._state, self._slot_uid
        to_cancel = self._to_cancel
        s_slots = self.ecfg.num_slots
        harvested: list = []

        # -- streaming: deliver each live slot's new tokens before any
        # harvest below, so a request's deltas always precede its finish
        if self._on_token is not None and any(
                u is not None for u in slot_uid):
            n_gen_h = state["n_gen"].cpu().numpy()
            out_tok_h = state["out_tok"].cpu().numpy()
            for s in range(s_slots):
                if slot_uid[s] is None:
                    continue
                k = int(n_gen_h[s])
                if k > self._streamed[s]:
                    self._on_token(
                        slot_uid[s],
                        out_tok_h[s, self._streamed[s]:k].copy())
                    self._streamed[s] = k

        # -- sync the two control planes; fetch buffers only on retirement
        active = state["active"].cpu().numpy()
        done = state["done"].cpu().numpy()
        retired = [s for s in range(s_slots)
                   if slot_uid[s] is not None and active[s] and done[s]]
        cancel_mask = np.zeros((s_slots,), bool)
        host = None
        if retired or any(u in to_cancel for u in slot_uid if u is not None):
            host = {k: state[k].cpu().numpy() for k in
                    ("n_gen", "prompt_len", "eos_hit",
                     "out_tok", "out_logp", "out_ent")}
        # snapshot cancel state first: rows in `retired` finished on
        # their own (EOS/budget), so cancellations issued by on_finish
        # callbacks *during* this harvest loop must not relabel them
        was_cancelled = {s: slot_uid[s] in to_cancel for s in retired}
        for s in retired:
            harvested.append(self._harvest(s, host, was_cancelled[s]))
            cancel_mask[s] = True  # clears active/done on device
        # quota-cancel rows still decoding (including cancellations the
        # on_finish callbacks just issued): retire them as partials now
        if host is not None:
            for s in range(s_slots):
                if slot_uid[s] is not None and slot_uid[s] in to_cancel:
                    harvested.append(self._harvest(s, host, True))
                    cancel_mask[s] = True
        return harvested, cancel_mask

    def _cancelled_completion(self, r: Request) -> Completion:
        """Empty Completion for a request cancelled before placement; the
        contract fires on_finish for every request, including these."""
        comp = Completion(
            uid=r.uid, prompt_len=len(r.tokens),
            tokens=np.zeros((0,), np.int32),
            logp=np.zeros((0,), np.float32),
            entropy=np.zeros((0,), np.float32),
            completed=False, cancelled=True)
        self.stats["cancelled"] += 1
        if self._on_finish is not None:
            self._to_cancel.update(self._on_finish(comp) or ())
        return comp

    # ------------------------------------------------------------- drive
    def drive(self) -> list:
        """One round: harvest (freeing pages), resume parked siblings into
        freed slots, place queued groups with one shared prompt prefill
        each, allocate-ahead decode pages, then run the round on the
        device.  Returns the Completions retired this round."""
        ecfg, rcfg = self.ecfg, self.rcfg
        s_slots = ecfg.num_slots
        pl_, sps = ecfg.page_len, ecfg.steps_per_sync
        slot_uid, queue = self._slot_uid, self._queue
        harvested, cancel_mask = self._collect_retirements()

        # -- allocate-ahead for slots already decoding: each must own
        # pages for every token it can write this round (exhaustion here
        # is a real undersized pool — raise, never corrupt)
        occupied = [s for s in range(s_slots) if slot_uid[s] is not None]
        for s in occupied:
            want = int(min(self._n_gen_ub[s] + sps, self._slot_budget[s]))
            need = -(-want // pl_)
            while len(self._slot_decode_pages[s]) < need:
                self._slot_decode_pages[s].extend(
                    self._alloc.alloc(1, f" (slot {s} decode-ahead)"))
        free_slots = [s for s in range(s_slots) if slot_uid[s] is None]

        def place(s: int, r: Request, plen: int, ppages: list,
                  first_ref: bool) -> int:
            """Install sibling ``r`` in slot ``s``: take a prompt-page
            reference (unless it inherits the allocation's first ref) and
            allocate its first decode pages."""
            budget = r.budget or rcfg.max_new_tokens
            if not first_ref:
                self._alloc.retain(ppages)
            slot_uid[s] = r.uid
            self._streamed[s] = 0
            self._slot_prompt_pages[s] = ppages
            self._slot_decode_pages[s] = self._alloc.alloc(
                -(-min(sps, budget) // pl_), f" (slot {s} decode)")
            self._slot_plen[s] = plen
            self._slot_budget[s] = budget
            self._n_gen_ub[s] = 0
            occupied.append(s)
            return budget

        # -- resume parked siblings into freed slots (pure scatter: their
        # prompt state is the shared pages + the saved prompt logits); the
        # lane width bounds resumes per round, leftovers wait
        resumes: list = []   # (slot, plen, budget, logits (V,))
        for rec in list(self._pending):
            still = []
            for r in rec["reqs"]:
                if r.uid in self._to_cancel:
                    harvested.append(self._cancelled_completion(r))
                else:
                    still.append(r)
            rec["reqs"] = still
            while still and free_slots and len(resumes) < ecfg.resumes:
                budget = still[0].budget or rcfg.max_new_tokens
                if self._alloc.num_free < -(-min(sps, budget) // pl_):
                    if not occupied and not resumes:
                        self._alloc.alloc(  # raises with occupancy
                            -(-min(sps, budget) // pl_), " (sibling resume)")
                    break
                r = still.pop(0)
                s = free_slots.pop(0)
                resumes.append((s, rec["plen"],
                                place(s, r, rec["plen"], rec["ppages"],
                                      first_ref=False), rec["logits"]))
            if not rec["reqs"]:
                # last sibling placed/cancelled: drop the record's ref
                self._dirty.update(self._alloc.release(rec["ppages"]))
                self._pending.remove(rec)

        # -- place queued groups, one prompt prefill each; siblings beyond
        # the free slots are parked (pure-pool stacks) or the whole group
        # waits (per-slot-state mixers place atomically)
        placed_groups: list = []  # (toks, pages, slots, budgets, parked rec)
        while len(placed_groups) < ecfg.lanes and queue and free_slots:
            group = queue[0]
            live = []
            for r in group:
                if r.uid in self._to_cancel:
                    harvested.append(self._cancelled_completion(r))
                else:
                    live.append(r)
            # strip emitted cancellations from the QUEUED group in place:
            # a group deferred below stays at the queue head, and a
            # re-examined sibling must never re-emit its Completion
            group[:] = live
            if not live:
                queue.popleft()
                continue
            if not self._pure_pool and len(live) > len(free_slots):
                break  # atomic placement: wait for slots to free up
            placed = live[:len(free_slots)]
            parked = live[len(placed):]
            toks0 = np.asarray(live[0].tokens)
            plen = len(toks0)
            n_fresh = -(-plen // pl_)
            need = n_fresh + sum(
                -(-min(sps, r.budget or rcfg.max_new_tokens) // pl_)
                for r in placed)
            if self._alloc.num_free < need:
                if not occupied and not placed_groups and not resumes:
                    self._alloc.alloc(need, " (group placement)")  # raises
                break  # wait for retirements to return pages
            ppages = self._alloc.alloc(n_fresh, " (group prompt)")
            queue.popleft()
            slots, budgets = [], []
            for gidx, r in enumerate(placed):
                s = free_slots.pop(0)
                slots.append(s)
                budgets.append(place(s, r, plen, ppages,
                                     first_ref=(gidx == 0)))
            rec = None
            if parked:
                self._alloc.retain(ppages)  # the pending record's ref
                rec = {"reqs": parked, "ppages": ppages, "plen": plen,
                       "logits": None}
                self._pending.append(rec)
            placed_groups.append((toks0, ppages, slots, budgets, rec))
            self.stats["prompt_tokens"] += plen
            self.stats["prefill_tokens"] += plen
            self.stats["prompt_prefills"] += 1

        if not placed_groups and not resumes and not occupied:
            return harvested  # session quiescent

        # -- block tables + free-page invalidation mask, rebuilt per round
        bt = np.full((s_slots, self._max_pages), -1, np.int32)
        for s in occupied:
            n_pp_s = -(-int(self._slot_plen[s]) // pl_)
            bt[s, :n_pp_s] = self._slot_prompt_pages[s]
            dp = self._slot_decode_pages[s]
            bt[s, n_pp_s:n_pp_s + len(dp)] = dp
        free_mask = None
        if self._dirty:
            free_mask = np.zeros((self.num_pages,), bool)
            free_mask[sorted(self._dirty)] = True

        self._run_round(bt, free_mask, cancel_mask, placed_groups, resumes)
        self._dirty.clear()
        for s in occupied:
            self._n_gen_ub[s] = min(self._n_gen_ub[s] + sps,
                                    int(self._slot_budget[s]))
        self.stats["rounds"] += 1
        self.stats["decode_steps"] += sps
        self.stats["slot_substeps"] += sps * s_slots
        self.stats["refills"] += (sum(len(g[2]) for g in placed_groups)
                                  + len(resumes))
        self.stats["pages_in_use"] = self._alloc.in_use
        self.stats["peak_pages_in_use"] = self._alloc.peak_in_use
        return harvested

    @torch.no_grad()
    def _run_round(self, bt, free_mask, cancel_mask, placed_groups,
                   resumes) -> None:
        """The device half of a round, in place on ``self._state``:
        cancel, poison freed pages, prefill + scatter placed groups, resume
        parked siblings, then ``steps_per_sync`` masked decode substeps."""
        st, dev = self._state, self.device
        params, cfg, rcfg = self._params, self.cfg, self.rcfg
        pl_, npg = self.ecfg.page_len, self.num_pages
        n = rcfg.max_new_tokens

        def t(a, dtype=I32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        # 1. cancelled slots become free (harvest happened on the host)
        if cancel_mask.any():
            keep = ~t(cancel_mask, torch.bool)
            st["active"] &= keep
            st["done"] &= keep
        # 2. pos-poison freed pages before any reuse this round: a recycled
        # page must never leak its previous occupant's positions
        if free_mask is not None:
            invalidate_pages(st["cache"], t(free_mask, torch.bool))

        # 3. group placement: one prompt prefill per group, its raw K/V
        # scattered into the shared prompt pages, logits to every sibling
        for toks0, ppages, slots, budgets, rec in placed_groups:
            plen = len(toks0)
            logits0, raw = paged_prefill(params, cfg, t(toks0)[None])
            pages = t(ppages, torch.long)
            pad = len(ppages) * pl_ - plen
            for pool, e in zip(st["cache"], raw):
                for key in ("k", "v"):
                    blk = torch.nn.functional.pad(e[key][0],
                                                  (0, 0, 0, 0, 0, pad))
                    pool[key][pages] = blk.reshape(
                        len(ppages), pl_, *blk.shape[1:]).to(pool[key].dtype)
                qpos = torch.arange(len(ppages) * pl_, dtype=I32, device=dev)
                pool["pos"][pages] = torch.where(
                    qpos < plen, qpos, torch.full_like(qpos, -1)).reshape(
                        len(ppages), pl_)
            k = len(slots)
            _place_slot_planes(st, t(slots, torch.long),
                               t([plen] * k), t(budgets),
                               logits0.expand(k, -1), rcfg.pad_id)
            if rec is not None:
                rec["logits"] = logits0[0].clone()

        # 3b. resume parked siblings: prompt pages are already in their
        # block tables and the saved prompt logits seed sampling
        if resumes:
            _place_slot_planes(
                st, t([r[0] for r in resumes], torch.long),
                t([r[1] for r in resumes]), t([r[2] for r in resumes]),
                torch.stack([r[3] for r in resumes]), rcfg.pad_id)

        # 4. masked decode substeps through the block tables
        block_tables = t(bt)
        max_pages = bt.shape[1]
        for _ in range(self.ecfg.steps_per_sync):
            nxt, live = _substep_sample(st, rcfg, n, self._gen)
            # decode token i = n_gen opens/extends the slot's private pages
            # AFTER its prompt pages — never a shared page
            n_pp_s = (st["prompt_len"] + pl_ - 1) // pl_
            page_slot = (n_pp_s + st["n_gen"] // pl_).clamp(max=max_pages - 1)
            bt_entry = block_tables.gather(1, page_slot[:, None].long())[:, 0]
            wp = torch.where(live & (bt_entry >= 0), bt_entry,
                             torch.full_like(bt_entry, npg))
            wo = st["n_gen"] % pl_
            new_logits = decode_step(params, cfg, nxt, st["cache"], st["pos"],
                                     block_tables=block_tables, write_page=wp,
                                     write_off=wo)
            _substep_advance(st, nxt, live, new_logits, rcfg)

    def drain(self) -> list:
        """Drive rounds until the session is idle; returns all Completions
        harvested along the way."""
        out: list = []
        while True:
            got = self.drive()
            out.extend(got)
            if self.idle and not got:
                return out

    def run_groups(
        self,
        params,
        groups: Sequence[Sequence[Request]],
        seed: int,
        *,
        on_finish: Optional[Callable[[Completion], Optional[Iterable[int]]]]
        = None,
    ) -> list:
        """Serve ``groups`` (one ``submit_group`` each) to completion;
        returns Completions in submission order.  Each group's prompt pages
        are shared across its siblings."""
        self.begin(params, seed, on_finish=on_finish)
        for g in groups:
            self.submit_group(g)
        out = {c.uid: c for c in self.drain()}
        return [out[r.uid] for g in groups for r in g if r.uid in out]

    def run(
        self,
        params,
        requests: Sequence[Request],
        seed: int,
        *,
        on_finish: Optional[Callable[[Completion], Optional[Iterable[int]]]]
        = None,
    ) -> list:
        """Serve ungrouped ``requests``; returns Completions in submission
        order (``run_groups`` with singleton groups)."""
        return self.run_groups(params, [[r] for r in requests], seed,
                               on_finish=on_finish)
