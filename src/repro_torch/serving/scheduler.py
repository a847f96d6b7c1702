"""Continuous-batching request scheduler over a slot-class cache pool.

The port of the reference's `serving/scheduler.py` (the HSA sequencer, paper
Sec. IV): the engine's *prefill* path (MMM dataflow) admits new requests into
free cache slots while the resident slots advance through the *decode* path
(MVM dataflow) one token per step.

  * **Chunk-granular admission** — `_admit` advances at most ONE prefill
    chunk per `step()` (`InferenceEngine.begin_chunked_prefill`), so a long
    prompt overlaps ~n_chunks decode cycles instead of stalling every lane
    for one monolithic MMM pass.

  * **Slot classes** — `CachePool` holds classes of slots (cache lengths
    over the same cache layout) instead of one global ``cache_len``;
    admission picks the smallest class that fits ``prompt + budget``.

  * **Host spill tier + preemption** — `CachePool.spill` copies a slot's
    whole cache to host memory (pinned on the card) bit-exactly and frees
    its lane, `fetch` restores it, and with ``host_spill=True`` the
    scheduler preempts the lowest-priority resident lane when a
    higher-priority request finds the pool full.

  * **Shared-prefix reuse** — with ``prefix_cache=True`` the pool owns a
    `PrefixCache` (serving/paging.py): admission adopts the longest cached
    prefix of the prompt (page rows, or a recurrent snapshot, copied into a
    private warm cache) and chunk-prefills only the suffix; every finished
    prompt is registered for later adopters.

Each class is one decode cache of ``n_slots`` lanes whose positions are
per lane (``lm.make_decode_cache(..., per_lane=True)``): the port's
counterpart of the reference's stacked per-slot pytrees under ``vmap``.  A
class advances in one `ClassStep` (one captured step per class on the card,
replayed every cycle; eager on the CPU), whose static buffers *are* the
class's store: writing a prefilled lane, spilling and fetching copy rows of
those tensors in place, and the store is never copied whole.  The graphs
live with the pool (``pool.steps``) and go with it.  Free lanes compute
garbage that is never read.

Speculative decode (``gen.speculative``, the ngram drafter): each class
advances through a `SpecClassStep` instead, which drafts from each lane's
own history, verifies every lane's ``k + 1`` block in one MMM dispatch and
commits each lane's own accepted prefix (no lockstep minimum, as in the
reference's vmapped ``spec_pool_step``); the scheduler emits 1..k+1 tokens
per lane and step, truncated at the budget or a stop token.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch

from repro_torch.models import lm
from repro_torch.obs import Observability, request_track
from repro_torch.serving.engine import (CacheCapacityError, ClassStep, InferenceEngine,
                                        SpecClassStep, to_host, tree_items, tree_map,
                                        tree_nbytes)
from repro_torch.serving.paging import PrefixCache
from repro_torch.serving.sampling import GenerationConfig, sample


@dataclasses.dataclass
class Request:
    """One generation request; `max_new_tokens` overrides the scheduler's.

    ``priority``: higher admits first; FIFO among equal priorities (0 is the
    default class, negative deprioritizes).
    """

    uid: int
    prompt: list                         # int sequence [S_in]
    max_new_tokens: int | None = None
    priority: int = 0


@dataclasses.dataclass
class FinishedRequest:
    uid: int
    prompt_len: int
    tokens: list[int]                    # emitted tokens incl. any stop token
    slot: int                            # pool slot handle (for tests/stats)
    cache_len: int = 0                   # cache class the request ran in
    cancelled: bool = False              # retired early via `cancel(uid)`
    # Speculative decode (zero on the per-token path):
    verify_steps: int = 0                # verify dispatches while resident
    accepted_drafts: int = 0             # drafted tokens verification accepted

    @property
    def tokens_per_step(self) -> float:
        if not self.verify_steps:
            return 1.0
        return 1.0 + self.accepted_drafts / self.verify_steps


def lane_view(store: dict, lane: int) -> dict:
    """One lane of a class store as a batch-1 decode cache of views: the
    position and rope angles at ``[lane]``, every block leaf at
    ``[lane:lane + 1]``.  Writing into it writes the store."""
    view = {"pos": store["pos"][lane],
            "blocks": tree_map(lambda t: t[lane:lane + 1], store["blocks"])}
    if "rope" in store:
        view["rope"] = tree_map(lambda t: t[lane], store["rope"])
    return view


class CachePool:
    """Decode-cache pool: slot *classes* of increasing cache length, backed
    by a device tier and a host spill tier.

    ``classes`` is a sequence of ``(n_slots, cache_len)`` pairs; the legacy
    single-class form ``CachePool(cfg, n_slots, cache_len)`` still works.
    Each class is one decode cache of ``n_slots`` lanes with per-lane
    positions; a prefilled batch-1 cache is copied into a lane with
    ``write``.

    Slot ids are *request-lifetime handles*, not lane indices: ``acquire``
    binds a fresh id to a free device lane in the smallest fitting class,
    ``spill`` copies the slot's whole cache to host memory (freeing the
    lane for another request — this is what lets the pool oversubscribe its
    device capacity), and ``fetch`` binds a free lane again and restores the
    cache bit-exactly.  ``residency(slot)`` reports which tier a slot lives
    in; ``spill_stats`` counts spills, fetches, and bytes moved each way.

    ``steps`` holds one `ClassStep` per class once a `RequestScheduler` has
    built them over the stores.

    With ``prefix_cache=True`` the pool also owns a `PrefixCache`
    (serving/paging.py): a refcounted-page radix index (a whole-cache
    snapshot index on recurrent archs) over finished prompt prefixes.
    ``prefix_lookup`` at admission returns an adopted-prefix length and an
    assembled warm cache; ``prefix_register`` indexes a finished prefill;
    page leases are tied to slot ids and dropped in ``release``;
    ``prefix_maintain`` runs the LRU / host-migration cycle once per
    scheduler step.
    """

    def __init__(self, cfg, n_slots: int | None = None, cache_len: int | None = None, *,
                 classes: Sequence[tuple[int, int]] | None = None,
                 dtype=torch.float32, device="cuda", obs: Observability | None = None,
                 prefix_cache: bool = False, prefix_page_size: int = 16,
                 max_prefix_pages: int | None = None,
                 device_prefix_pages: int | None = None):
        if classes is None:
            classes = [(n_slots if n_slots is not None else 4,
                        cache_len if cache_len is not None else 128)]
        classes = sorted(classes, key=lambda c: c[1])
        if not classes or any(n < 1 or length < 1 for n, length in classes):
            raise ValueError(f"bad cache classes: {classes}")
        if len({length for _, length in classes}) != len(classes):
            raise ValueError(f"duplicate class cache_len: {classes}")
        self.cfg = cfg
        self.classes = [(int(n), int(length)) for n, length in classes]
        self.n_slots = sum(n for n, _ in self.classes)
        self.cache_len = self.classes[-1][1]      # largest class (compat)
        self.dtype = dtype
        self.device = torch.device(device)

        self._stores: dict[int, dict] = {}
        self._lanes: dict[int, list[int]] = {}          # clen -> free lanes
        self._lane_of: dict[int, tuple[int, int]] = {}  # sid -> (clen, lane)
        self._class_of: dict[int, int] = {}             # live sid -> clen
        self._host: dict[int, dict] = {}                # sid -> host cache
        # Slot ids are issued monotonically, so "released" vs "unknown" is a
        # generation check against _next_sid.
        self._next_sid = 0
        with torch.inference_mode():
            for n, clen in self.classes:
                self._stores[clen] = lm.make_decode_cache(cfg, n, clen, dtype=dtype,
                                                          device=self.device,
                                                          per_lane=True)
                self._lanes[clen] = list(range(n))
        self.steps: dict[int, ClassStep] = {}
        # Observability: `spill_stats` is a live view over the metrics
        # registry; per-transfer byte histograms ride alongside.
        self.obs = obs if obs is not None else Observability()
        self.spill_stats = self.obs.metrics.counter_view(
            "pool.", ["spills", "fetches", "bytes_to_host", "bytes_to_device"])
        for n, clen in self.classes:
            self.obs.metrics.gauge(f"pool.device_bytes[{clen}]").set(
                tree_nbytes(self._stores[clen]))
        # Shared-prefix tier (opt-in): refcounted pages / snapshots indexed
        # by token prefix, leased per slot, maintained once per step.
        self.prefix = PrefixCache(cfg, dtype, enabled=prefix_cache,
                                  page_size=prefix_page_size, max_pages=max_prefix_pages,
                                  device_pages=device_prefix_pages, device=self.device,
                                  obs=self.obs)

    # -- slot accounting ----------------------------------------------------

    @property
    def free_slots(self) -> int:
        """Free *device lanes* (host-resident slots hold no lane)."""
        return sum(len(f) for f in self._lanes.values())

    @property
    def host_resident(self) -> int:
        return len(self._host)

    @property
    def host_bytes(self) -> int:
        """Bytes currently parked in the host tier."""
        return sum(tree_nbytes(c) for c in self._host.values())

    @property
    def device_bytes(self) -> int:
        """Bytes of the device-resident class stores (all lanes)."""
        return sum(tree_nbytes(s) for s in self._stores.values())

    def fits(self, min_len: int) -> bool:
        """Could a request needing `min_len` cache positions EVER be placed?"""
        return min_len <= self.cache_len

    def slot_len(self, slot: int) -> int:
        """Cache length of a *live* (device- or host-resident) slot."""
        if slot not in self._class_of:
            raise ValueError(f"slot {slot} is not live ({self._where(slot)})")
        return self._class_of[slot]

    def locate(self, slot: int) -> tuple[int, int]:
        """(cache_len, lane) of a *device-resident* slot."""
        if slot not in self._lane_of:
            raise ValueError(f"slot {slot} is not device-resident "
                             f"({self._where(slot)})")
        return self._lane_of[slot]

    def residency(self, slot: int) -> str:
        """'device' | 'host' for a live slot; ValueError otherwise."""
        where = self._where(slot)
        if where not in ("device", "host"):
            raise ValueError(f"slot {slot} is not resident ({where})")
        return where

    def _where(self, slot: int) -> str:
        if slot in self._lane_of:
            return "device"
        if slot in self._host:
            return "host"
        return "released" if 0 <= slot < self._next_sid else "unknown"

    def has_free_lane(self, clen: int) -> bool:
        return bool(self._lanes[clen])

    def acquire(self, min_len: int = 0) -> int | None:
        """Smallest-class-first placement: the cheapest free lane that fits.

        Returns a fresh slot id bound to that lane, or None when every
        fitting class is busy (the caller may then `spill` a victim).
        """
        for _, clen in self.classes:
            if clen >= min_len and self._lanes[clen]:
                lane = self._lanes[clen].pop(0)
                sid = self._next_sid
                self._next_sid += 1
                self._lane_of[sid] = (clen, lane)
                self._class_of[sid] = clen
                return sid
        return None

    def release(self, slot: int) -> None:
        """Retire a slot: free its device lane, or drop its host copy.  Any
        prefix-page leases the slot holds are dropped with it (the single
        refcount-decrement path: retire, cancel and preempted cancel all
        come through here)."""
        if slot in self._lane_of:
            clen, lane = self._lane_of.pop(slot)
            self._lanes[clen].append(lane)
        elif slot in self._host:
            del self._host[slot]
        elif 0 <= slot < self._next_sid:
            raise ValueError(f"slot {slot} double-released")
        else:
            raise ValueError(f"release of unknown slot id {slot}")
        del self._class_of[slot]
        self.prefix.release(slot)

    # -- shared-prefix tier --------------------------------------------------

    def prefix_lookup(self, prompt, slot: int, *, chunk_size: int = 1
                      ) -> tuple[int, dict | None]:
        """Longest adoptable cached prefix of ``prompt`` for ``slot``:
        ``(n_tokens, warm batch-1 cache)`` or ``(0, None)``.  Leases the
        backing pages under the slot until `release`."""
        return self.prefix.lookup(prompt, self.slot_len(slot), slot, chunk_size=chunk_size)

    def prefix_register(self, prompt, cache: dict, slot: int) -> int:
        """Index a finished prefill's prefix for future adopters."""
        return self.prefix.register(prompt, cache, self.slot_len(slot))

    def prefix_maintain(self) -> None:
        """One prefix-tier bookkeeping cycle (LRU eviction, host migration of
        cold unreferenced pages, gauge refresh)."""
        self.prefix.maintain()

    # -- host spill tier ----------------------------------------------------

    @torch.inference_mode()
    def spill(self, slot: int) -> None:
        """Copy a slot's full cache (KV rows or retention state, RoPE angle
        memory, position) to host memory and free its device lane.

        The copy is bit-exact (pinned host buffers on the card); the freed
        lane's stale contents are overwritten by the next `write`.
        """
        if slot in self._host:
            raise ValueError(f"slot {slot} already spilled")
        clen, lane = self.locate(slot)
        t0 = time.perf_counter()
        host = tree_map(to_host, lane_view(self._stores[clen], lane))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        del self._lane_of[slot]
        self._lanes[clen].append(lane)
        self._host[slot] = host
        nbytes = tree_nbytes(host)
        self.spill_stats["spills"] += 1
        self.spill_stats["bytes_to_host"] += nbytes
        self.obs.metrics.histogram("pool.spill_bytes").record(nbytes)
        self.obs.metrics.histogram("pool.spill_s").record(dt)

    @torch.inference_mode()
    def fetch(self, slot: int) -> None:
        """Bind a spilled slot to a free lane in its class and restore its
        cache to the device, bit-exactly.  The caller checks
        ``has_free_lane(slot_len(slot))`` first (or handles the raise)."""
        if slot not in self._host:
            raise ValueError(f"slot {slot} is not spilled to host "
                             f"({self._where(slot)})")
        clen = self._class_of[slot]
        if not self._lanes[clen]:
            raise ValueError(f"no free lane in class {clen} to fetch "
                             f"slot {slot} into")
        host = self._host.pop(slot)
        lane = self._lanes[clen].pop(0)
        self._lane_of[slot] = (clen, lane)
        nbytes = tree_nbytes(host)
        self.spill_stats["fetches"] += 1
        self.spill_stats["bytes_to_device"] += nbytes
        self.obs.metrics.histogram("pool.fetch_bytes").record(nbytes)
        t0 = time.perf_counter()
        self.write(slot, host)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.obs.metrics.histogram("pool.fetch_s").record(time.perf_counter() - t0)

    # -- class stores -------------------------------------------------------

    @property
    def store(self) -> dict:
        """Legacy single-class view of the class store."""
        if len(self.classes) != 1:
            raise ValueError("`store` is single-class; use get_store(clen)")
        return self._stores[self.classes[0][1]]

    def get_store(self, clen: int) -> dict:
        return self._stores[clen]

    def lane_cache(self, slot: int) -> dict:
        """A device-resident slot's cache as a batch-1 tree of views into its
        class store (read it, or clone it; writing it writes the store)."""
        clen, lane = self.locate(slot)
        return lane_view(self._stores[clen], lane)

    @torch.inference_mode()
    def write(self, slot: int, cache: dict) -> None:
        """Copy one batch-1 cache (fresh from prefill, or a host copy) into a
        slot's lane of its class store, in place.

        The incoming tree must match the slot class's structure and leaf
        shapes — a cache built for another class would silently corrupt the
        store otherwise.  Values are cast to the store's dtypes.
        """
        clen, lane = self.locate(slot)
        dst = list(tree_items(lane_view(self._stores[clen], lane)))
        src = list(tree_items(cache))
        if [p for p, _ in dst] != [p for p, _ in src]:
            raise ValueError(f"cache tree structure does not match slot {slot}'s "
                             f"class (cache_len {clen})")
        for (path, d), (_, c) in zip(dst, src):
            if d.shape != c.shape:
                raise ValueError(
                    f"cache leaf {path} shape {tuple(c.shape)} does not match slot "
                    f"{slot}'s class shape {tuple(d.shape)} (cache_len {clen})")
        for (_, d), (_, c) in zip(dst, src):
            d.copy_(c)


def lane_seed(seed: int, uid: int) -> int:
    """The seed of request ``uid``'s sampling generator under a scheduler
    seeded ``seed``: the port's counterpart of the reference's
    ``fold_in(key, uid)``."""
    return (seed * 0x9E3779B97F4A7C15 + uid) % (1 << 63)


class RequestScheduler:
    """Admit-while-decoding serving loop around one `InferenceEngine`.

    ``step()`` performs one sequencer cycle: (1) advance the in-flight
    admission by at most one prefill chunk (starting the next queued request
    that fits a free slot class when idle), (2) advance every resident class
    one token through its `ClassStep` (a graph replay on the card), (3)
    retire slots that hit a stop token or their token budget.  ``run()``
    drains the queue.

    ``on_token(uid, token)`` streams tokens as they are emitted;
    ``on_finish(finished)`` fires once per terminal `FinishedRequest`
    (retire, in-flight cancel) — the async front end's completion hook;
    ``cancel(uid)`` drops a queued request, aborts an in-flight admission, or
    retires an active or preempted slot (its partial output is returned
    with ``cancelled=True``).  ``clock`` injects the timebase for every
    latency stamp (virtual time in tests; monotonic by default).

    Admission order is FIFO with skip: a request whose smallest fitting class
    is momentarily full does not block later requests that fit elsewhere.

    ``host_spill=True`` adds priority preemption over the pool's host tier:
    when a queued request finds no free lane, the lowest-priority resident
    lane of *strictly lower* priority (the one freeing the most device
    bytes, then the oldest admitted) is spilled — its cache moves to host
    memory (``CachePool.spill``) along with its sampling generator's state
    and pending token — and parks on a resumable list.  Resume re-enters the
    class step through the pool's ``fetch``: no re-prefill, no new capture,
    and greedy output is token-identical to an unpreempted run.

    Stochastic sampling stays per-request reproducible: each request draws
    from its own generator, seeded from (``seed``, uid) at admission
    (`lane_seed`), whatever lane it lands in and whatever shares the class.

    ``prefix_cache=True`` turns on shared-prefix reuse (`CachePool`'s
    `PrefixCache`; ``prefix_page_size``, ``max_prefix_pages`` and
    ``device_prefix_pages`` size it): an admission starts its chunked prefill
    at the longest cached prefix of its prompt, and greedy output is
    token-identical to a run without it.

    ``gen.speculative`` (the 'ngram' drafter only: the MTP drafter needs
    per-lane hidden state) steps each class with a `SpecClassStep`; a
    request reserves ``k`` cache positions past its budget for the verify
    block's overrun, carries its draft history through preemption, and
    reports ``verify_steps`` / ``accepted_drafts``.
    """

    def __init__(self, engine: InferenceEngine, *, n_slots: int = 4,
                 cache_len: int = 128,
                 classes: Sequence[tuple[int, int]] | None = None,
                 gen: GenerationConfig = GenerationConfig(),
                 seed: int = 0,
                 chunk_size: int = 32,
                 host_spill: bool = False,
                 cache_dtype=None,
                 on_token: Callable[[int, int], None] | None = None,
                 on_finish: Callable[[FinishedRequest], None] | None = None,
                 obs: Observability | None = None,
                 clock: Callable[[], float] | None = None,
                 prefix_cache: bool = False, prefix_page_size: int = 16,
                 max_prefix_pages: int | None = None,
                 device_prefix_pages: int | None = None):
        self.engine = engine
        self.gen = gen
        # The timebase for every latency stamp; histogram records carry
        # `t=self._now()` so windowed percentiles share it.
        self._now = clock if clock is not None else time.perf_counter
        # Each scheduler defaults to its OWN bundle; pass the engine's
        # (`obs=engine.obs`) to unify them, as `launch.serve` does.  The
        # pool shares the scheduler's bundle.
        self.obs = obs if obs is not None else Observability()
        self._tr = self.obs.tracer
        # The pool-wide cache dtype: an explicit ``cache_dtype`` wins, then
        # `gen.cache_format`, then f32.  Chunked admission appends straight
        # into that layout (`begin_chunked_prefill(cache_dtype=...)`).
        if cache_dtype is None:
            cache_dtype = gen.cache_format or torch.float32
        self.pool = CachePool(engine.cfg, n_slots, cache_len, classes=classes,
                              dtype=cache_dtype, device=engine.device, obs=self.obs,
                              prefix_cache=prefix_cache, prefix_page_size=prefix_page_size,
                              max_prefix_pages=max_prefix_pages,
                              device_prefix_pages=device_prefix_pages)
        # Speculative decode: each lane is its own batch row, so acceptance
        # is per request, and each lane keeps its own draft history.
        self._spec = gen.speculative
        if self._spec is not None and self._spec.drafter != "ngram":
            raise ValueError("RequestScheduler speculative decode supports the model-free "
                             "'ngram' drafter (the MTP drafter needs per-lane hidden "
                             "state; use engine.generate)")
        w = engine.cfg.sliding_window
        if self._spec is not None and w and self._spec.k + 1 > w:
            raise ValueError(f"verify block k+1 ({self._spec.k + 1}) "
                             f"must fit the sliding window ({w})")
        # One captured step per class, over the class store (see ClassStep).
        self.pool.steps = {
            clen: (ClassStep(engine, self.pool.get_store(clen), gen) if self._spec is None
                   else SpecClassStep(engine, self.pool.get_store(clen), gen, clen))
            for _, clen in self.pool.classes}
        self.capture_s = sum(st.capture_s for st in self.pool.steps.values())
        self.seed = seed
        self.chunk_size = chunk_size
        self.host_spill = host_spill
        self.on_token = on_token
        self.on_finish = on_finish
        self._class_nbytes: dict[int, int] = {}   # clen -> lane bytes memo

        self._queue: list[Request] = []
        self._admitting: dict | None = None      # the one in-flight prefill
        self._active: dict[int, dict] = {}       # sid -> per-request state
        self._preempted: list[dict] = []         # parked, host-resident
        self._seq = 0                            # admission order stamp
        self._finished: list[FinishedRequest] = []
        self.stats = self.obs.metrics.counter_view(
            "sched.", ["steps", "emitted", "prefill_chunks", "admitted",
                       "cancelled", "decode_stall_steps", "verify_steps",
                       "accepted_drafts", "preempted", "resumed"])
        self._t_submit: dict[int, float] = {}    # uid -> submit time

    # -- queue management ---------------------------------------------------

    def submit(self, request: Request, priority: int | None = None) -> None:
        """Enqueue; ``priority`` (or ``request.priority``) orders admission:
        higher priorities admit first, FIFO within a level.  A ``priority``
        argument is submission-scoped: the caller's Request is not mutated.

        Sizing is validated *here*: a request whose ``max_new_tokens`` is
        invalid or that could never fit any pool class raises immediately,
        so the drain loop (`run`) can never throw mid-flight.
        """
        if priority is not None:
            request = dataclasses.replace(request, priority=priority)
        if request.max_new_tokens is not None and request.max_new_tokens < 1:
            raise ValueError(f"request {request.uid}: max_new_tokens must be "
                             f">= 1, got {request.max_new_tokens}")
        need, budget = self._request_need(request)
        if not self.pool.fits(need):
            # Decode writes cache positions s .. s+budget-1; past-capacity
            # positions would silently clamp onto the last slot, so reject.
            raise CacheCapacityError(
                f"request {request.uid}: prompt ({len(request.prompt)}) + "
                f"max_new_tokens ({budget}) exceeds every pool class "
                f"(largest cache_len {self.pool.cache_len})")
        i = len(self._queue)
        while i > 0 and self._queue[i - 1].priority < request.priority:
            i -= 1
        self._queue.insert(i, request)
        self._t_submit[request.uid] = self._now()
        rt = request_track(request.uid)
        self._tr.begin("request", rt, prompt_len=len(request.prompt),
                       priority=request.priority)
        self._tr.begin("queued", rt)

    def _request_need(self, req: Request) -> tuple[int, int]:
        """(cache positions needed, effective token budget)."""
        budget = (req.max_new_tokens if req.max_new_tokens is not None
                  else self.gen.max_new_tokens)
        need = len(req.prompt) + budget
        if self._spec is not None:
            need += self._spec.k        # a verify block's overrun before rollback
        return need, budget

    @property
    def pending(self) -> int:
        return (len(self._queue) + len(self._active) + len(self._preempted)
                + (1 if self._admitting is not None else 0))

    def cancel(self, uid: int) -> bool:
        """Drop a queued request / abort its admission / retire its slot —
        including a preempted slot parked in the host tier."""
        for i, req in enumerate(self._queue):
            if req.uid == uid:
                self._queue.pop(i)
                self.stats["cancelled"] += 1
                self._t_submit.pop(uid, None)
                rt = request_track(uid)
                self._tr.end("queued", rt)
                self._tr.instant("cancel", rt)
                self._tr.end("request", rt)
                return True
        if self._admitting is not None and self._admitting["req"].uid == uid:
            # Clear `_admitting` before the release: `_finish`'s on_finish
            # callback may re-enter the scheduler.
            adm = self._admitting
            self._admitting = None
            clen = self.pool.slot_len(adm["slot"])
            self.pool.release(adm["slot"])
            self.stats["cancelled"] += 1
            self._t_submit.pop(uid, None)
            rt = request_track(uid)
            self._tr.end("admit", rt)
            self._tr.instant("cancel", rt)
            self._tr.end("request", rt)
            self._finish(FinishedRequest(
                uid=uid, prompt_len=len(adm["req"].prompt), tokens=[],
                slot=adm["slot"], cache_len=clen, cancelled=True))
            return True
        for slot, st in self._active.items():
            if st["req"].uid == uid:
                self._retire(slot, cancelled=True)
                self.stats["cancelled"] += 1
                return True
        for entry in self._preempted:
            if entry["req"].uid == uid:
                self._preempted.remove(entry)
                clen = self.pool.slot_len(entry["slot"])
                self.pool.release(entry["slot"])   # drops the host copy
                self.stats["cancelled"] += 1
                rt = request_track(uid)
                self._tr.end("preempted", rt)
                self._tr.instant("cancel", rt)
                self._tr.end("request", rt)
                self._finish(FinishedRequest(
                    uid=uid, prompt_len=len(entry["req"].prompt),
                    tokens=entry["emitted"], slot=entry["slot"],
                    cache_len=clen, cancelled=True))
                return True
        return False

    # -- the sequencer cycle ------------------------------------------------

    def _start_admission(self) -> None:
        """Pick the next admission: resume a parked (preempted) request or
        start the first queued request that fits a free slot class.

        With ``host_spill``, a queued request that finds no free lane may
        preempt a resident lane of strictly lower priority (`_pick_victim`).
        Parked requests resume ahead of queued arrivals at the same or lower
        priority; a strictly higher-priority arrival admits first.
        """
        best_queued = self._queue[0].priority if self._queue else None
        for entry in self._resume_order():
            if best_queued is not None and best_queued > entry["req"].priority:
                break              # the higher-priority arrival admits first
            if self._try_resume(entry):
                return
        for i, req in enumerate(self._queue):
            need, budget = self._request_need(req)
            slot = self.pool.acquire(need)
            if slot is None and self.host_spill:
                victim = self._pick_victim(req.priority, need)
                if victim is not None:
                    self._preempt(victim)
                    slot = self.pool.acquire(need)
            if slot is None:
                continue                 # fitting classes all busy: try next
            self._queue.pop(i)
            t_sub = self._t_submit.get(req.uid)
            if t_sub is not None:
                t_adm = self._now()
                self.obs.metrics.histogram("sched.queue_wait_s").record(
                    t_adm - t_sub, t=t_adm)
            prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                     device=self.engine.device)[None, :]
            try:
                # Shared-prefix adoption: start the chunked prefill at the
                # longest cached prefix; those tokens are never prefilled.
                # The warm cache is private to this slot (page rows are
                # copied in), so the chunks may write it in place; the
                # pages stay leased until the slot releases.
                hit, warm = self.pool.prefix_lookup(req.prompt, slot,
                                                    chunk_size=self.chunk_size)
                prefill = self.engine.begin_chunked_prefill(
                    prompt, cache_len=self.pool.slot_len(slot),
                    chunk_size=self.chunk_size, cache_dtype=self.pool.dtype,
                    initial_cache=warm, start_offset=hit)
            except Exception:
                self.pool.release(slot)
                raise
            rt = request_track(req.uid)
            self._tr.end("queued", rt)
            self._tr.begin("admit", rt, cache_len=self.pool.slot_len(slot), prefix_hit=hit)
            self._admitting = {"req": req, "slot": slot, "prefill": prefill,
                               "budget": budget}
            return
        # Nothing queued could start: resume any parked request that fits,
        # ignoring the priority gate above (it only defers resumes).
        for entry in self._resume_order():
            if self._try_resume(entry):
                return

    # -- host-spill preemption ---------------------------------------------

    def _resume_order(self) -> list[dict]:
        """Parked requests in resume order: priority desc, admission asc."""
        return sorted(self._preempted, key=lambda e: (-e["req"].priority, e["seq"]))

    def _slot_nbytes(self, clen: int) -> int:
        """Bytes one lane of class ``clen`` holds (`engine.cache_nbytes`,
        memoized): the spill's transfer and the device memory it frees."""
        n = self._class_nbytes.get(clen)
        if n is None:
            n = self._class_nbytes[clen] = self.engine.cache_nbytes(clen,
                                                                    dtype=self.pool.dtype)
        return n

    def _pick_victim(self, priority: int, need: int) -> int | None:
        """Byte-aware preemption: among resident lanes of strictly lower
        priority whose class could hold ``need`` positions, pick the lowest
        priority first, then the lane freeing the most device bytes, then
        the oldest admission."""
        best = None
        for slot, st in self._active.items():
            if st["req"].priority >= priority:
                continue
            if self.pool.slot_len(slot) < need:
                continue
            rank = (st["req"].priority, -self._slot_nbytes(self.pool.slot_len(slot)),
                    st["seq"])
            if best is None or rank < best[0]:
                best = (rank, slot)
        return None if best is None else best[1]

    def _preempt(self, slot: int) -> None:
        """Spill a resident lane to the host tier and park it, resumable
        bit-exactly: its cache (`CachePool.spill`), pending token, sampling
        generator's state and, when speculative, its draft history survive
        the round trip."""
        st = self._active.pop(slot)
        clen, lane = self.pool.locate(slot)
        step = self.pool.steps[clen]
        entry = {"req": st["req"], "slot": slot, "seq": st["seq"],
                 "budget": st["budget"], "emitted": st["emitted"],
                 "verify_steps": st["verify_steps"],
                 "accepted_drafts": st["accepted_drafts"],
                 "t_submit": st.get("t_submit"), "t_last": st.get("t_last"),
                 "token": step.tok[lane].clone(),
                 "gen_state": (None if step.generators is None
                               else step.generators[lane].get_state())}
        if self._spec is not None:
            entry["hist"] = to_host(step.hist[lane])
            entry["hist_len"] = to_host(step.hist_len[lane])
        self.pool.spill(slot)
        self._preempted.append(entry)
        self.stats["preempted"] += 1
        rt = request_track(st["req"].uid)
        self._tr.end("decode", rt)
        self._tr.instant("preempt", rt, cache_len=clen)
        self._tr.begin("preempted", rt)

    def _try_resume(self, entry: dict) -> bool:
        """Fetch a parked request's cache back into a free lane of its class
        and rejoin the class step — no re-prefill, no new capture."""
        slot = entry["slot"]
        if not self.pool.has_free_lane(self.pool.slot_len(slot)):
            return False
        self.pool.fetch(slot)
        clen, lane = self.pool.locate(slot)
        step = self.pool.steps[clen]
        step.tok[lane].copy_(entry["token"])
        if entry["gen_state"] is not None:
            step.generators[lane].set_state(entry["gen_state"])
        if self._spec is not None:
            step.hist[lane].copy_(entry["hist"])
            step.hist_len[lane].copy_(entry["hist_len"])
        self._active[slot] = {"req": entry["req"], "emitted": entry["emitted"],
                              "budget": entry["budget"], "seq": entry["seq"],
                              "verify_steps": entry["verify_steps"],
                              "accepted_drafts": entry["accepted_drafts"],
                              "t_submit": entry.get("t_submit"),
                              "t_last": entry.get("t_last")}
        self._preempted.remove(entry)
        self.stats["resumed"] += 1
        rt = request_track(entry["req"].uid)
        self._tr.end("preempted", rt)
        self._tr.instant("resume", rt, cache_len=clen)
        self._tr.begin("decode", rt)
        return True

    def _admit(self) -> bool:
        """MMM phase: advance the in-flight admission by at most one chunk.
        Returns whether a chunk ran."""
        if self._admitting is None:
            self._start_admission()
        if self._admitting is None:
            return False
        adm = self._admitting
        rt = request_track(adm["req"].uid)
        now = self._now()
        if "t_chunk" in adm:
            # Pacing: the gap between successive chunk dispatches is the
            # decode latency the admission is overlapping with.
            self.obs.metrics.histogram("sched.prefill_chunk_interval_s").record(
                now - adm["t_chunk"], t=now)
        adm["t_chunk"] = now
        with self._tr.span("prefill_chunk", rt):
            logits = adm["prefill"].advance()
        self.stats["prefill_chunks"] += 1
        if not adm["prefill"].done:
            return True
        req, slot = adm["req"], adm["slot"]
        self.pool.write(slot, adm["prefill"].cache)
        # The finished prompt's cache covers [0, len(prompt)): index it so
        # later admissions sharing this prefix skip their prefill (`write`
        # copied it, and the pages copy it again).
        self.pool.prefix_register(req.prompt, adm["prefill"].cache, slot)
        clen, lane = self.pool.locate(slot)
        step = self.pool.steps[clen]
        g = None
        if step.generators is not None:
            g = torch.Generator(device=self.engine.device)
            g.manual_seed(lane_seed(self.seed, req.uid))
        step.tok[lane:lane + 1].copy_(sample(logits, self.gen.sampling, g))
        if g is not None:
            step.generators[lane].set_state(g.get_state())
        if self._spec is not None:
            # The lane's draft history starts as the prompt.
            step.hist[lane].zero_()
            step.hist[lane, :len(req.prompt)].copy_(torch.as_tensor(req.prompt))
            step.hist_len[lane].fill_(len(req.prompt))
        self._active[slot] = {"req": req, "emitted": [], "budget": adm["budget"],
                              "verify_steps": 0, "accepted_drafts": 0,
                              "seq": self._seq,
                              "t_submit": self._t_submit.pop(req.uid, None),
                              "t_last": None}
        self._seq += 1
        self._admitting = None
        self.stats["admitted"] += 1
        self._tr.end("admit", rt)
        self._tr.begin("decode", rt)
        return True

    def _finish(self, fr: FinishedRequest) -> None:
        """The single completion sink: every terminal `FinishedRequest`
        lands here, so `on_finish` observers see each exactly once.
        Bookkeeping is already consistent when the callback fires."""
        self._finished.append(fr)
        if self.on_finish is not None:
            self.on_finish(fr)

    def _retire(self, slot: int, cancelled: bool = False) -> None:
        st = self._active.pop(slot)
        clen = self.pool.slot_len(slot)
        self.pool.release(slot)
        t_sub = st.get("t_submit")
        if t_sub is not None:
            t_fin = self._now()
            self.obs.metrics.histogram("sched.request_latency_s").record(
                t_fin - t_sub, t=t_fin)
        rt = request_track(st["req"].uid)
        self._tr.end("decode", rt)
        self._tr.instant("finish", rt, tokens=len(st["emitted"]), cancelled=cancelled)
        self._tr.end("request", rt)
        self._finish(FinishedRequest(
            uid=st["req"].uid, prompt_len=len(st["req"].prompt),
            tokens=st["emitted"], slot=slot, cache_len=clen, cancelled=cancelled,
            verify_steps=st["verify_steps"], accepted_drafts=st["accepted_drafts"]))

    @torch.inference_mode()
    def step(self) -> int:
        """One admit+decode cycle; returns the number of tokens emitted."""
        chunked = self._admit()
        self.pool.prefix_maintain()
        self.stats["steps"] += 1
        # Occupancy gauges + trace counter series, sampled once per cycle.
        m = self.obs.metrics
        m.gauge("sched.queue_depth").set(len(self._queue))
        m.gauge("sched.active").set(len(self._active))
        m.gauge("sched.preempted_depth").set(len(self._preempted))
        m.gauge("pool.host_bytes").set(self.pool.host_bytes)
        if self._tr.enabled:
            self._tr.counter("queue_depth", len(self._queue))
            self._tr.counter("active", len(self._active))
            self._tr.counter("host_bytes", self.pool.host_bytes)
        if not self._active:
            if self._admitting is not None:
                self.stats["decode_stall_steps"] += 1
            return 0

        # One step per resident class.  Each lane emits a block: on the
        # per-token path the token it fed (sampled from the previous step's
        # or prefill's logits), on the speculative path the 1..k+1 tokens it
        # committed.
        active_classes = sorted({self.pool.locate(s)[0] for s in self._active})
        stepped = {}
        for clen in active_classes:
            step = self.pool.steps[clen]
            if self._spec is None:
                with self.obs.annotation("sched.pool_step"):
                    step.run()
                stepped[clen] = [[t] for t in step.fed.tolist()]
            else:
                with self.obs.annotation("sched.spec_pool_step"):
                    step.run()
                stepped[clen] = [row[:row[-1]] for row in step.result.tolist()]

        emitted = 0
        now = self._now()
        for slot in list(self._active):
            st = self._active.get(slot)
            if st is None:           # retired by an on_token cancel mid-loop
                continue
            clen, lane = self.pool.locate(slot)
            block = stepped[clen][lane]
            if self._spec is not None:
                st["verify_steps"] += 1
                st["accepted_drafts"] += len(block) - 1
                self.stats["verify_steps"] += 1
                self.stats["accepted_drafts"] += len(block) - 1
                m.histogram("sched.tokens_per_verify_step").record(len(block), t=now)
            # SLO latencies, stamped at the drain boundary: TTFT covers
            # submit -> first drained token; inter-token the gap since the
            # previous drain, spread over the block (also recorded apart
            # while a chunk ran).
            if st.get("t_last") is None:
                if st.get("t_submit") is not None:
                    m.histogram("sched.ttft_s").record(now - st["t_submit"], t=now)
                self._tr.instant("first_token", request_track(st["req"].uid))
            else:
                dt = (now - st["t_last"]) / len(block)
                for _ in block:
                    m.histogram("sched.inter_token_s").record(dt, t=now)
                    if chunked:
                        m.histogram("sched.inter_token_admitting_s").record(dt, t=now)
            st["t_last"] = now
            for tok in block:
                st["emitted"].append(tok)
                emitted += 1
                if self.on_token is not None:
                    # The callback may cancel() any request, this one included.
                    self.on_token(st["req"].uid, tok)
                if slot not in self._active:
                    break
                if tok in self.gen.stop_tokens or len(st["emitted"]) >= st["budget"]:
                    # Committed tokens past the budget or a stop are dropped.
                    self._retire(slot)
                    break
        self.stats["emitted"] += emitted
        return emitted

    def run(self) -> dict[int, FinishedRequest]:
        """Drain queue + active slots; returns results keyed by request uid."""
        while self.pending:
            self.step()
        return {f.uid: f for f in self._finished}
