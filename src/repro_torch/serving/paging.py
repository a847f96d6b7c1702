"""Refcounted cache pages + radix prefix index: shared-prefix reuse with COW.

The port of the reference's `serving/paging.py`.  Much serving traffic
re-prefills the *same* tokens: long shared system or template prefixes.  This
module gives `CachePool` a second residency tier for them: an index from token
prefixes to **immutable cache pages** (runs of KV rows cut on the cache axis),
so admission adopts the longest cached prefix, skips that much prefill, and
chunk-prefills only the suffix.

Two index shapes, selected per architecture by `lm.prefix_sharing_mode`:

  * `RadixPageIndex` — a radix tree with page-granular edges: each node owns
    up to ``page_size`` tokens and the cache rows those tokens produced
    (every block leaf, encoded planes included).  Lookup walks the longest
    matching page run; registration appends pages under the deepest full
    match (no edge splitting: divergence inside a page creates a sibling, so
    a shared page is never rewritten).  Pages carry **refcounts** (leases
    held by adopting requests) and an LRU clock; eviction only removes
    unreferenced leaves, and a host tier parks cold pages in pinned host
    memory instead of dropping them.

  * `SnapshotPrefixIndex` — recurrent caches (RetNet S) fold history into
    O(1) state, so token pages cannot represent them; the *whole cache* at a
    finished prompt is registered as an adoptable snapshot at that exact
    token boundary, with the same lease / LRU / host-tier accounting.

Copy-on-write is by construction, and torch makes it explicit: a slice of a
tensor is a view, so every page is a *clone* of its rows
(`lm.slice_cache_rows`), a snapshot is a clone of the registered cache, and an
adopter never receives a page or snapshot tensor.  Adoption *assembles* a
fresh batch-1 cache (`lm.assemble_prefix_cache`, page rows copied under a cold
scaffold) or clones the snapshot; the chunked prefill then writes that private
cache in place, and `CachePool.write` copies it into a class store that is a
captured graph's static buffer.  The partial tail page an unaligned adoption
cuts is the COW event ``pool.cow_bytes`` prices.

Every copy here (assembly, spill, fetch) is issued on the caller's current
stream, the scheduler's one stream: `kernels.hopper.ticket_counters` keeps one
split-K buffer per device, which is safe on one stream only.

`PrefixCache` is the facade `CachePool` owns: mode selection, MoE chunk
alignment (expert-capacity routing is per dispatch, so adoption boundaries
land on chunk boundaries there: olmoe, deepseek-v3's MoE layers), lease
bookkeeping by slot id, page budgets (`maintain` spills cold pages to host
and LRU-evicts past ``max_pages``), and the ``pool.`` counters and gauges.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import lm
from repro_torch.obs import Observability
from repro_torch.serving.engine import _clone, to_host, tree_map, tree_nbytes


class PageLeaseError(ValueError):
    """Refcount misuse: releasing a never-leased page / negative refs."""


def token_key(prompt) -> tuple[int, ...]:
    """Normalize a prompt (list / tensor of token ids) into the hashable
    token tuple the prefix indexes key on."""
    return tuple(int(t) for t in prompt)


# ---------------------------------------------------------------------------
# Paged tier: radix tree over token prefixes -> immutable page runs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class PageNode:
    """One page: up to ``page_size`` tokens and their cache rows.

    ``rows`` (device) / ``host_rows`` (host memory) are mutually exclusive
    for a resident page; both None only on the root sentinel.  ``refs``
    counts live leases (requests whose adoption walked through this page); a
    page with ``refs > 0`` is pinned: never evicted, never spilled.
    """

    tokens: tuple[int, ...]
    rows: dict | None = None
    host_rows: dict | None = None
    nbytes: int = 0
    refs: int = 0
    tick: int = 0
    children: list["PageNode"] = dataclasses.field(default_factory=list)
    parent: "PageNode | None" = None

    @property
    def on_device(self) -> bool:
        return self.rows is not None


def _common_prefix(a: tuple[int, ...], b: tuple[int, ...]) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


class RadixPageIndex:
    """Radix tree with page-granular edges over token prefixes.

    Pure bookkeeping over page trees: it never touches the engine.  The
    `PrefixCache` facade owns assembly, metrics and device/host transfers
    (the ``spill`` callable injected into `spill_lru` keeps this class free
    of transfers, so it is property-testable with small CPU rows).
    """

    def __init__(self, page_size: int = 16):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self.root = PageNode(tokens=())
        self._tick = 0

    # -- traversal ----------------------------------------------------------

    def nodes(self) -> list[PageNode]:
        """Every page (excluding the root sentinel), preorder."""
        out: list[PageNode] = []
        stack = list(self.root.children)
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children)
        return out

    @property
    def n_pages(self) -> int:
        return len(self.nodes())

    def _touch(self, node: PageNode) -> None:
        self._tick += 1
        node.tick = self._tick

    # -- match / insert ------------------------------------------------------

    def match(self, key: tuple[int, ...]) -> list[tuple[PageNode, int]]:
        """*Maximal* page-run match: ``[(node, tokens_used), ...]`` walking
        from the root; every entry but the last uses its page fully, the
        last may be a partial (mid-page) match.

        Sibling pages (created when prompts diverge mid-page) can share
        leading tokens, so the walk compares whole descent chains, not single
        children: a short fully-matched page that allows deeper descent beats
        a longer partial match.  Ties prefer the chain whose final page is
        fully used, the chain a re-insert of the same key descends, which
        keeps insertion idempotent.
        """
        def go(node: PageNode, i: int) -> list[tuple[PageNode, int]]:
            best: list[tuple[PageNode, int]] = []
            best_rank = (0, True)
            for child in node.children:
                m = _common_prefix(child.tokens, key[i:])
                if m < 1:
                    continue
                if m == len(child.tokens):
                    cand = [(child, m)] + go(child, i + m)
                else:
                    cand = [(child, m)]
                last, used = cand[-1]
                rank = (sum(u for _, u in cand), used == len(last.tokens))
                if rank > best_rank:
                    best, best_rank = cand, rank
            return best

        return go(self.root, 0)

    def insert(self, key: tuple[int, ...], rows_of: Callable[[int, int], dict],
               nbytes_of: Callable[[dict], int] = tree_nbytes) -> list[PageNode]:
        """Register ``key``'s pages, reusing every fully-matching existing
        page and creating nodes for the remainder.  ``rows_of(a, b)`` gives
        the rows for token positions [a, b) (copies: a page owns its rows).
        Returns the nodes created (empty when the whole prefix was resident).

        A partial overlap with an existing page creates a *sibling* rather
        than splitting the shared page: shared pages are immutable, so the
        few duplicated rows are the price of never rewriting one.
        """
        node, i = self.root, 0
        for child, m in self.match(key):
            if m < len(child.tokens):
                break                                # diverged mid-page
            self._touch(child)
            node, i = child, i + m
        created: list[PageNode] = []
        while i < len(key):
            stop = min(i + self.page_size, len(key))
            rows = rows_of(i, stop)
            child = PageNode(tokens=key[i:stop], rows=rows, nbytes=nbytes_of(rows),
                             parent=node)
            node.children.append(child)
            self._touch(child)
            created.append(child)
            node, i = child, stop
        return created

    # -- leases --------------------------------------------------------------

    def lease(self, nodes: list[PageNode]) -> None:
        for n in nodes:
            n.refs += 1
            self._touch(n)

    def release(self, nodes: list[PageNode]) -> None:
        for n in nodes:
            if n.refs < 1:
                raise PageLeaseError("page lease released more times than "
                                     "acquired (refcount would go negative)")
            n.refs -= 1

    # -- eviction / host migration ------------------------------------------

    def _detach(self, node: PageNode) -> None:
        node.parent.children.remove(node)
        node.parent = None
        node.rows = node.host_rows = None

    def evict_lru(self) -> PageNode | None:
        """Drop the least-recently-used unreferenced *leaf* page (interior
        pages are pinned by their children: a child's rows mean nothing
        without the prefix above them)."""
        victims = [n for n in self.nodes() if n.refs == 0 and not n.children]
        if not victims:
            return None
        victim = min(victims, key=lambda n: n.tick)
        self._detach(victim)
        return victim

    def spill_lru(self, spill: Callable[[dict], dict]) -> PageNode | None:
        """Move the coldest unreferenced device-resident page's rows to the
        host tier (proactive migration, before capacity pressure forces a
        synchronous eviction).  Spilled pages stay matchable; adoption
        fetches them back."""
        victims = [n for n in self.nodes() if n.refs == 0 and n.on_device]
        if not victims:
            return None
        victim = min(victims, key=lambda n: n.tick)
        victim.host_rows = spill(victim.rows)
        victim.rows = None
        return victim


# ---------------------------------------------------------------------------
# Snapshot tier: whole-cache prefix states for recurrent archs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Snapshot:
    """A whole warm cache at one finished-prompt boundary."""

    key: tuple[int, ...]
    cache_len: int
    cache: dict | None = None            # device-resident
    host_cache: dict | None = None       # spilled to host memory
    nbytes: int = 0
    refs: int = 0
    tick: int = 0

    @property
    def on_device(self) -> bool:
        return self.cache is not None


class SnapshotPrefixIndex:
    """Prefix states for architectures whose caches cannot page.

    Entries are keyed by (token tuple, cache_len): a snapshot is only
    adoptable into the cache class it was produced in.  Lookup returns the
    longest registered prompt that strictly prefixes the query: adoption
    happens at exact snapshot boundaries only, which is what makes it exact
    for recurrent state.  `insert` stores a clone of the cache it is given,
    so the caller's cache stays free to be written afterwards.
    """

    def __init__(self):
        self._entries: dict[tuple[tuple[int, ...], int], Snapshot] = {}
        self._tick = 0

    def nodes(self) -> list[Snapshot]:
        return list(self._entries.values())

    @property
    def n_pages(self) -> int:
        return len(self._entries)

    def _touch(self, snap: Snapshot) -> None:
        self._tick += 1
        snap.tick = self._tick

    def match(self, key: tuple[int, ...], cache_len: int) -> Snapshot | None:
        best = None
        for (k, clen), snap in self._entries.items():
            if clen != cache_len or len(k) >= len(key):
                continue                   # strict prefix: >= 1 suffix token
            if key[:len(k)] == k and (best is None or len(k) > len(best.key)):
                best = snap
        return best

    def insert(self, key: tuple[int, ...], cache_len: int, cache: dict
               ) -> Snapshot | None:
        ix = (key, cache_len)
        if ix in self._entries:
            self._touch(self._entries[ix])
            return None
        cache = _clone(cache)
        snap = Snapshot(key=key, cache_len=cache_len, cache=cache,
                        nbytes=tree_nbytes(cache))
        self._entries[ix] = snap
        self._touch(snap)
        return snap

    def lease(self, snaps: list[Snapshot]) -> None:
        for s in snaps:
            s.refs += 1
            self._touch(s)

    def release(self, snaps: list[Snapshot]) -> None:
        for s in snaps:
            if s.refs < 1:
                raise PageLeaseError("snapshot lease released more times "
                                     "than acquired")
            s.refs -= 1

    def evict_lru(self) -> Snapshot | None:
        victims = [s for s in self._entries.values() if s.refs == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda s: s.tick)
        del self._entries[(victim.key, victim.cache_len)]
        victim.cache = victim.host_cache = None
        return victim

    def spill_lru(self, spill: Callable[[dict], dict]) -> Snapshot | None:
        victims = [s for s in self._entries.values() if s.refs == 0 and s.on_device]
        if not victims:
            return None
        victim = min(victims, key=lambda s: s.tick)
        victim.host_cache = spill(victim.cache)
        victim.cache = None
        return victim


# ---------------------------------------------------------------------------
# The facade CachePool owns
# ---------------------------------------------------------------------------


class PrefixCache:
    """Shared-prefix reuse for one model config: lookup at admission,
    registration at prefill completion, leases tied to pool slot ids.

    ``max_pages`` bounds the total page count (LRU eviction past it);
    ``device_pages`` bounds the *device-resident* page count: `maintain`
    migrates the coldest unreferenced pages to host memory past that budget.
    In snapshot mode both budgets count snapshots.  ``dtype`` is the pool's
    cache dtype or kvq format and ``device`` the engine's: adopted caches are
    assembled, and spilled pages fetched, there.
    """

    def __init__(self, cfg, dtype, *, enabled: bool = False, page_size: int = 16,
                 max_pages: int | None = None, device_pages: int | None = None,
                 device="cuda", obs: Observability | None = None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = torch.device(device)
        self.mode = lm.prefix_sharing_mode(cfg) if enabled else None
        self.enabled = self.mode is not None
        self.page_size = page_size
        self.max_pages = max_pages
        self.device_pages = device_pages
        self.obs = obs if obs is not None else Observability()
        # MoE expert-capacity dropping is per dispatch: tokens routed in a
        # different chunk decomposition can drop differently, so adoption
        # boundaries must be chunk-aligned there to keep the suffix's
        # dispatches identical to the cold run's.
        self._align_chunks = any(kind == "moe" for _, _, kind in lm.layer_groups(cfg))
        self._index = (RadixPageIndex(page_size) if self.mode == "paged"
                       else SnapshotPrefixIndex())
        self._leases: dict[int, list] = {}        # slot id -> leased nodes
        self.stats = self.obs.metrics.counter_view(
            "pool.", ["prefix_lookups", "prefix_hits", "prefix_hit_tokens",
                      "prefix_insert_pages", "cow_copies", "page_spills",
                      "page_fetches", "page_evictions"])

    # -- metrics -------------------------------------------------------------

    @property
    def n_pages(self) -> int:
        return self._index.n_pages

    @property
    def shared_pages(self) -> int:
        return sum(1 for n in self._index.nodes() if n.refs > 0)

    @property
    def free_pages(self) -> int:
        return sum(1 for n in self._index.nodes() if n.refs == 0)

    @property
    def device_resident_pages(self) -> int:
        return sum(1 for n in self._index.nodes() if n.on_device)

    @property
    def host_pages(self) -> int:
        return self.n_pages - self.device_resident_pages

    @property
    def prefix_bytes(self) -> int:
        return sum(n.nbytes for n in self._index.nodes())

    def _set_gauges(self) -> None:
        g = self.obs.metrics.gauge
        g("pool.pages_shared").set(self.shared_pages)
        g("pool.pages_free").set(self.free_pages)
        g("pool.pages_host").set(self.host_pages)
        g("pool.prefix_bytes").set(self.prefix_bytes)

    # -- host transfers -------------------------------------------------------

    def _spill(self, tree: dict) -> dict:
        """A page's (or snapshot's) host copy, pinned on the card, complete
        when this returns."""
        self.stats["page_spills"] += 1
        host = tree_map(to_host, tree)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host

    def _fetch(self, tree: dict) -> dict:
        self.stats["page_fetches"] += 1
        return tree_map(lambda t: t.to(self.device, non_blocking=True), tree)

    def _node_rows(self, node: PageNode) -> dict:
        """A page's device rows, fetching (and re-promoting) a host-resident
        page: adoption touches it, so it is hot again by definition."""
        if node.rows is None:
            node.rows = self._fetch(node.host_rows)
            node.host_rows = None
        return node.rows

    # -- admission-side API --------------------------------------------------

    def lookup(self, prompt, cache_len: int, slot: int, *,
               chunk_size: int = 1) -> tuple[int, dict | None]:
        """Longest adoptable cached prefix of ``prompt`` for a slot of class
        ``cache_len``: ``(n_tokens, warm_cache)``, the assembled batch-1
        cache covering positions [0, n_tokens), or ``(0, None)``.

        The hit is capped at ``len(prompt) - 1`` (at least one suffix token
        must run so admission still produces last-token logits), and floored
        to a ``chunk_size`` multiple on MoE archs (routing exactness).  A
        hit shorter than one full page is a miss: a tiny adoption costs more
        than it saves (the assembly copy and an odd-offset suffix chunk
        outweigh a few skipped prefill tokens), and a chance few-token
        overlap between unrelated prompts must not trigger any of that.  The
        pages (or snapshot) backing the hit are leased under ``slot`` until
        `release(slot)`.
        """
        if not self.enabled:
            return 0, None
        key = token_key(prompt)
        self.stats["prefix_lookups"] += 1
        if self.mode == "snapshot":
            return self._lookup_snapshot(key, cache_len, slot)
        matched = self._index.match(key)
        total = sum(m for _, m in matched)
        p = min(total, len(key) - 1)
        if self._align_chunks:
            p -= p % max(chunk_size, 1)
        if p < self.page_size:
            return 0, None
        parts: list[dict] = []
        used: list[PageNode] = []
        taken = 0
        for node, m in matched:
            take = min(m, p - taken)
            if take < 1:
                break
            rows = self._node_rows(node)
            if take < len(node.tokens):
                # The COW event: the adopter copies the shared tail page's
                # first `take` rows; the page itself is never written.
                rows = lm.slice_cache_rows(rows, self.cfg, 0, take)
                self.stats["cow_copies"] += 1
                self.obs.metrics.histogram("pool.cow_bytes").record(tree_nbytes(rows))
            parts.append(rows)
            used.append(node)
            taken += take
            if taken >= p:
                break
        cache = lm.assemble_prefix_cache(self.cfg, parts, p, cache_len, self.dtype,
                                         self.device)
        self._index.lease(used)
        self._leases.setdefault(slot, []).extend(used)
        self.stats["prefix_hits"] += 1
        self.stats["prefix_hit_tokens"] += p
        self._set_gauges()
        return p, cache

    def _lookup_snapshot(self, key, cache_len: int, slot: int
                         ) -> tuple[int, dict | None]:
        snap = self._index.match(key, cache_len)
        if snap is None or len(snap.key) < self.page_size:
            return 0, None
        if snap.cache is None:
            snap.cache = self._fetch(snap.host_cache)
            snap.host_cache = None
        # The chunk forward writes its cache in place, so the adopter gets a
        # fresh copy: the registered snapshot must survive for the next
        # adopter (this is the snapshot tier's COW).
        cache = _clone(snap.cache)
        self.stats["cow_copies"] += 1
        self.obs.metrics.histogram("pool.cow_bytes").record(snap.nbytes)
        self._index.lease([snap])
        self._leases.setdefault(slot, []).append(snap)
        p = len(snap.key)
        self.stats["prefix_hits"] += 1
        self.stats["prefix_hit_tokens"] += p
        self._set_gauges()
        return p, cache

    def register(self, prompt, cache: dict, cache_len: int) -> int:
        """Index a finished prompt's cache for future adopters; returns the
        number of new pages (snapshot mode: 1 for a new boundary, 0 for an
        already-registered one).  The rows are copied here, so the caller's
        cache stays free to be written afterwards."""
        if not self.enabled:
            return 0
        key = token_key(prompt)
        if self.mode == "snapshot":
            snap = self._index.insert(key, cache_len, cache)
            n_new = 1 if snap is not None else 0
        else:
            created = self._index.insert(
                key, lambda a, b: lm.slice_cache_rows(cache, self.cfg, a, b))
            n_new = len(created)
        self.stats["prefix_insert_pages"] += n_new
        self._set_gauges()
        return n_new

    def release(self, slot: int) -> None:
        """Drop every page lease a slot holds (idempotent per slot: the pool
        calls this on every release path: retire, cancel, preempted
        cancel)."""
        held = self._leases.pop(slot, None)
        if held:
            self._index.release(held)
            self._set_gauges()

    @property
    def leased_slots(self) -> int:
        return len(self._leases)

    # -- background maintenance ---------------------------------------------

    def maintain(self) -> None:
        """One bookkeeping cycle (the scheduler calls this once per step):
        spill cold unreferenced pages past the device budget, LRU-evict past
        ``max_pages``, refresh the occupancy gauges."""
        if not self.enabled:
            return
        if self.device_pages is not None:
            while (self.device_resident_pages > self.device_pages
                   and self._index.spill_lru(self._spill) is not None):
                pass
        if self.max_pages is not None:
            while (self.n_pages > self.max_pages
                   and self._index.evict_lru() is not None):
                self.stats["page_evictions"] += 1
        self._set_gauges()
