"""The shared-prefix page index of repro_torch against the JAX package.

Pure bookkeeping first (small torch rows, no engine), so hundreds of
examples run in well under a second each:

* the reference's property tests (tests/test_prefix_properties.py) on the
  port's `RadixPageIndex` and `SnapshotPrefixIndex`: radix insert / match /
  evict correctness and the refcount invariants (refs never negative, leases
  never leaked, leased pages never evicted or spilled, page rows never
  mutated, spilled pages still matchable, longest strict snapshot prefix);
* a differential check: the same random op sequences through
  `repro.serving.paging`'s indexes (numpy rows) and the port's (torch rows)
  give the same match runs, refcounts, page counts, LRU ticks, and
  eviction and spill victims, op by op;

then the cache helpers on reduced qwen3-8b and the ds3 cut, the JAX
engines' fp weights carried over: `lm.slice_cache_rows` and
`lm.assemble_prefix_cache` on the same cache (bridged from the reference's
chunked prefill) give the reference's rows, f32 exactly and encoded planes
byte for byte, and the port's pages are copies, never views.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_scheduler import DS3, _jax_layers, engines, prompts, to_port_cache

from repro.models import lm as Jlm
from repro.serving import paging as Jpaging
from repro_torch.models import lm as Tlm
from repro_torch.serving.paging import (PageLeaseError, PrefixCache, RadixPageIndex,
                                        SnapshotPrefixIndex, token_key)

SETTINGS = dict(max_examples=60, deadline=None)

# Small alphabet + short keys => heavy prefix collision, which is the
# interesting regime for a radix tree.
_KEY = st.lists(st.integers(min_value=0, max_value=3), min_size=1,
                max_size=12).map(tuple)
_KEYS = st.lists(_KEY, min_size=1, max_size=8)


def _rows_of(key):
    """Page rows that are the token ids themselves, so a row's content says
    exactly which positions a page claims to hold."""
    return lambda a, b: {"rows": torch.tensor(key[a:b], dtype=torch.int64)}


def _insert(ix, key):
    return ix.insert(key, _rows_of(key))


def _matched_tokens(matched):
    out = []
    for node, m in matched:
        out.extend(node.tokens[:m])
    return tuple(out)


def _matched_rows(matched):
    out = []
    for node, m in matched:
        rows = node.rows if node.rows is not None else node.host_rows
        out.extend(rows["rows"][:m].tolist())
    return tuple(out)


# -- radix insert / match (the reference's properties) ---------------------------


@settings(**SETTINGS)
@given(keys=_KEYS, page_size=st.integers(min_value=1, max_value=5), probe=_KEY)
def test_match_is_true_prefix_with_matching_rows(keys, page_size, probe):
    ix = RadixPageIndex(page_size)
    for k in keys:
        _insert(ix, k)
    matched = ix.match(probe)
    toks = _matched_tokens(matched)
    assert toks == probe[:len(toks)]
    assert _matched_rows(matched) == toks
    for node, m in matched[:-1]:           # maximality of the walk
        assert m == len(node.tokens)


@settings(**SETTINGS)
@given(keys=_KEYS, page_size=st.integers(min_value=1, max_value=5))
def test_insert_then_match_covers_whole_key(keys, page_size):
    ix = RadixPageIndex(page_size)
    for k in keys:
        _insert(ix, k)
    for k in keys:
        assert _matched_tokens(ix.match(k)) == k
        assert _insert(ix, k) == []


@settings(**SETTINGS)
@given(keys=_KEYS, page_size=st.integers(min_value=1, max_value=5))
def test_pages_are_never_mutated(keys, page_size):
    ix = RadixPageIndex(page_size)
    snapshots = []
    for k in keys:
        for node in _insert(ix, k):
            snapshots.append((node, node.tokens, node.rows["rows"].clone()))
        for probe in keys:
            ix.match(probe)
    for node, toks, rows in snapshots:
        assert node.tokens == toks
        assert torch.equal(node.rows["rows"], rows)


# -- refcount invariants -----------------------------------------------------------


_OPS = st.lists(st.tuples(st.sampled_from(["insert", "lease", "release", "evict", "spill"]),
                          _KEY), min_size=1, max_size=30)


@settings(**SETTINGS)
@given(ops=_OPS, page_size=st.integers(min_value=1, max_value=4))
def test_refcounts_never_negative_never_leaked(ops, page_size):
    ix = RadixPageIndex(page_size)
    outstanding: list[list] = []            # model: one entry per live lease
    for kind, key in ops:
        if kind == "insert":
            _insert(ix, key)
        elif kind == "lease":
            nodes = [n for n, _ in ix.match(key)]
            ix.lease(nodes)
            outstanding.append(nodes)
        elif kind == "release" and outstanding:
            ix.release(outstanding.pop())
        elif kind == "evict":
            victim = ix.evict_lru()
            if victim is not None:
                assert victim.refs == 0 and not victim.children
        elif kind == "spill":
            victim = ix.spill_lru(lambda rows: rows)
            if victim is not None:
                assert victim.refs == 0
                assert not victim.on_device and victim.host_rows is not None
        model: dict = {}
        for nodes in outstanding:
            for n in nodes:
                model[id(n)] = model.get(id(n), 0) + 1
        for n in ix.nodes():
            assert n.refs == model.get(id(n), 0) >= 0
    for nodes in outstanding:
        ix.release(nodes)
    assert all(n.refs == 0 for n in ix.nodes())
    pages = ix.nodes()
    if pages:
        with pytest.raises(PageLeaseError):
            ix.release([pages[0]])


@settings(**SETTINGS)
@given(keys=_KEYS, page_size=st.integers(min_value=1, max_value=4))
def test_evict_drains_everything_unreferenced(keys, page_size):
    ix = RadixPageIndex(page_size)
    for k in keys:
        _insert(ix, k)
    evicted = 0
    while ix.evict_lru() is not None:
        evicted += 1
    assert ix.n_pages == 0
    assert evicted >= len(set(keys)) > 0


@settings(**SETTINGS)
@given(keys=_KEYS, page_size=st.integers(min_value=1, max_value=4))
def test_spilled_pages_stay_matchable(keys, page_size):
    ix = RadixPageIndex(page_size)
    for k in keys:
        _insert(ix, k)
    want = {k: _matched_tokens(ix.match(k)) for k in keys}
    while ix.spill_lru(lambda rows: rows) is not None:
        pass
    assert all(not n.on_device for n in ix.nodes())
    for k in keys:
        assert _matched_tokens(ix.match(k)) == want[k]


# -- snapshot tier -------------------------------------------------------------------


@settings(**SETTINGS)
@given(keys=_KEYS, probe=_KEY)
def test_snapshot_match_is_longest_strict_prefix(keys, probe):
    ix = SnapshotPrefixIndex()
    for k in keys:
        ix.insert(k, 32, {"cache": torch.tensor(k)})
        ix.insert(k, 64, {"cache": torch.tensor(k)})
    got = ix.match(probe, 32)
    want = [k for k in set(keys) if len(k) < len(probe) and probe[:len(k)] == k]
    if not want:
        assert got is None
    else:
        assert got.key == max(want, key=len)
        assert got.cache_len == 32


@settings(**SETTINGS)
@given(keys=_KEYS)
def test_snapshot_refcounts_and_eviction(keys):
    ix = SnapshotPrefixIndex()
    for k in keys:
        ix.insert(k, 16, {"cache": torch.tensor(k)})
    snaps = ix.nodes()
    ix.lease(snaps)
    assert ix.evict_lru() is None            # everything pinned
    ix.release(snaps)
    with pytest.raises(PageLeaseError):
        ix.release([snaps[0]])
    while ix.evict_lru() is not None:
        pass
    assert ix.n_pages == 0


def test_snapshot_insert_stores_a_copy():
    """The snapshot is a clone: writing the registered cache afterwards (as
    the pool's next admission may) leaves the snapshot as it was."""
    ix = SnapshotPrefixIndex()
    cache = {"s": torch.arange(6.0)}
    snap = ix.insert((1, 2), 16, cache)
    cache["s"].zero_()
    assert snap.cache["s"].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    assert (snap.cache["s"].untyped_storage().data_ptr()
            != cache["s"].untyped_storage().data_ptr())


# -- the port's indexes against the reference's, op by op ----------------------------


def _state(ix) -> list:
    """Every page of a radix index: (token path from the root, refs, tick,
    on device), in a canonical order."""
    out = []
    for n in ix.nodes():
        path, p = [], n
        while p is not None and p.tokens:
            path.append(p.tokens)
            p = p.parent
        out.append((tuple(reversed(path)), n.refs, n.tick, n.on_device))
    return sorted(out)


def _victim(v):
    return None if v is None else (v.tokens, v.tick, v.refs)


@settings(**SETTINGS)
@given(ops=_OPS, page_size=st.integers(min_value=1, max_value=4))
def test_radix_index_matches_the_reference_op_by_op(ops, page_size):
    mine, ref = RadixPageIndex(page_size), Jpaging.RadixPageIndex(page_size)
    held: list[tuple[list, list]] = []
    for kind, key in ops:
        if kind == "insert":
            a = _insert(mine, key)
            b = ref.insert(key, lambda x, y, key=key: {"rows": np.asarray(key[x:y])},
                           nbytes_of=lambda r: int(r["rows"].nbytes))
            assert [n.tokens for n in a] == [n.tokens for n in b]
            assert [n.nbytes for n in a] == [n.nbytes for n in b]
        elif kind == "lease":
            a, b = mine.match(key), ref.match(key)
            assert [(n.tokens, m) for n, m in a] == [(n.tokens, m) for n, m in b]
            mine.lease([n for n, _ in a])
            ref.lease([n for n, _ in b])
            held.append(([n for n, _ in a], [n for n, _ in b]))
        elif kind == "release" and held:
            a, b = held.pop()
            mine.release(a)
            ref.release(b)
        elif kind == "evict":
            assert _victim(mine.evict_lru()) == _victim(ref.evict_lru())
        elif kind == "spill":
            assert _victim(mine.spill_lru(lambda r: r)) == _victim(ref.spill_lru(lambda r: r))
        assert mine.n_pages == ref.n_pages
        assert _state(mine) == _state(ref)
        assert ([(n.tokens, m) for n, m in mine.match(key)]
                == [(n.tokens, m) for n, m in ref.match(key)])


_SNAP_OPS = st.lists(st.tuples(st.sampled_from(["insert", "match", "lease", "release",
                                                "evict", "spill"]),
                               _KEY, st.sampled_from([16, 32])), min_size=1, max_size=30)


@settings(**SETTINGS)
@given(ops=_SNAP_OPS)
def test_snapshot_index_matches_the_reference_op_by_op(ops):
    mine, ref = SnapshotPrefixIndex(), Jpaging.SnapshotPrefixIndex()
    held: list[tuple] = []

    def state(ix):
        return sorted((s.key, s.cache_len, s.refs, s.tick, s.on_device) for s in ix.nodes())

    for kind, key, clen in ops:
        if kind == "insert":
            a = mine.insert(key, clen, {"cache": torch.tensor(key)})
            b = ref.insert(key, clen, {"cache": np.asarray(key)})
            assert (a is None) == (b is None)
        elif kind in ("match", "lease"):
            a, b = mine.match(key, clen), ref.match(key, clen)
            assert (None if a is None else a.key) == (None if b is None else b.key)
            if kind == "lease" and a is not None:
                mine.lease([a])
                ref.lease([b])
                held.append((a, b))
        elif kind == "release" and held:
            a, b = held.pop()
            mine.release([a])
            ref.release([b])
        elif kind == "evict":
            a, b = mine.evict_lru(), ref.evict_lru()
            assert (None if a is None else (a.key, a.cache_len, a.tick)) == (
                None if b is None else (b.key, b.cache_len, b.tick))
        elif kind == "spill":
            a, b = mine.spill_lru(lambda c: c), ref.spill_lru(lambda c: c)
            assert (None if a is None else (a.key, a.tick)) == (
                None if b is None else (b.key, b.tick))
        assert state(mine) == state(ref)


def test_lease_release_misuse_raises():
    ix = RadixPageIndex(page_size=2)
    created = ix.insert(token_key([1, 2, 3]), lambda a, b: {"x": None},
                        nbytes_of=lambda r: 0)
    ix.lease(created)
    ix.release(created)
    with pytest.raises(PageLeaseError):
        ix.release(created)


# -- the cache helpers against the reference's ---------------------------------------

CLEN, PROMPT = 24, 19       # a class of 24 positions; a 19-token prompt
PAGED = [("qwen3-8b", None), ("qwen3-8b", "int8_tok"), ("qwen3-8b", "mxint4_blk"),
         (DS3, None), (DS3, "int8_tok"), (DS3, "mxint4_blk")]
PAGED_IDS = ["qwen3-f32", "qwen3-int8_tok", "qwen3-mxint4_blk", "ds3_cut-f32",
             "ds3_cut-int8_tok", "ds3_cut-mxint4_blk"]


@functools.lru_cache(maxsize=None)
def caches(arch: str, fmt):
    """The reference's chunked-prefill cache of one prompt, in ``fmt``, and
    the same cache as the port's tree (carried over byte for byte)."""
    je, te = engines(arch)
    p = prompts(te.cfg.vocab_size, [PROMPT], seed=71)[0]
    _, jcache = je.prefill_chunked(jnp.asarray([p], jnp.int32), cache_len=CLEN,
                                   chunk_size=8, cache_dtype=fmt or jnp.float32)
    return jcache, to_port_cache(jcache, te.cfg.n_layers)


def _assert_rows_equal(mine: list, want: list, what: str) -> None:
    """Port block leaves (one dict per layer) against the reference's, byte
    for byte (plain leaves and encoded planes alike)."""
    assert len(mine) == len(want)
    for i, (a, b) in enumerate(zip(mine, want)):
        assert a.keys() == b.keys()
        for name in a:
            pa = a[name] if isinstance(a[name], dict) else {"": a[name]}
            pb = b[name] if isinstance(b[name], dict) else {"": b[name]}
            assert pa.keys() == pb.keys()
            for plane in pa:
                x, y = pa[plane].numpy(), np.asarray(pb[plane])
                assert x.dtype == y.dtype and x.shape == y.shape, (what, i, name, plane)
                np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                              err_msg=f"{what} layer {i} {name} {plane}")


@pytest.mark.parametrize("start,stop", [(0, 16), (16, PROMPT), (5, 11)], ids=str)
@pytest.mark.parametrize("arch,fmt", PAGED, ids=PAGED_IDS)
def test_slice_cache_rows_matches_the_reference(arch, fmt, start, stop):
    je, te = engines(arch)
    jcache, tcache = caches(arch, fmt)
    mine = Tlm.slice_cache_rows(tcache, te.cfg, start, stop)
    want = _jax_layers(Jlm.slice_cache_rows(jcache, je.cfg, start, stop), te.cfg.n_layers)
    _assert_rows_equal(mine["blocks"], want, f"rows [{start}, {stop})")
    for (_, t), (_, src) in zip(Tlm._block_leaves(mine["blocks"]),
                                Tlm._block_leaves(tcache["blocks"])):
        assert t.untyped_storage().data_ptr() != src.untyped_storage().data_ptr()
        assert t.is_contiguous()


@pytest.mark.parametrize("arch,fmt", PAGED, ids=PAGED_IDS)
def test_assemble_prefix_cache_matches_the_reference(arch, fmt):
    """Two pages ([0, 16) and the tail [16, 19)) assembled into a class of 24
    positions: every block leaf byte for byte, ``pos`` exactly, the rope
    angles at the reference's 1e-6."""
    je, te = engines(arch)
    jcache, tcache = caches(arch, fmt)
    pages = [(0, 16), (16, PROMPT)]
    mine = Tlm.assemble_prefix_cache(te.cfg, [Tlm.slice_cache_rows(tcache, te.cfg, a, b)
                                              for a, b in pages],
                                     PROMPT, CLEN, fmt or torch.float32, "cpu")
    jrows = Jpaging._tree_concat_rows([Jlm.slice_cache_rows(jcache, je.cfg, a, b)
                                       for a, b in pages])
    want = Jlm.assemble_prefix_cache(je.cfg, jrows, PROMPT, CLEN, fmt or jnp.float32)
    _assert_rows_equal(mine["blocks"], _jax_layers(want, te.cfg.n_layers), "assembled")
    _assert_rows_equal(mine["blocks"], _jax_layers(jcache, te.cfg.n_layers),
                       "assembled against the prefill cache")
    assert mine["pos"].dtype == torch.int32 and int(mine["pos"]) == int(want["pos"]) == PROMPT
    for f in ("sin", "cos"):
        np.testing.assert_allclose(getattr(mine["rope"], f).numpy(),
                                   np.asarray(getattr(want["rope"], f)), atol=1e-6)
    cold = Tlm.make_decode_cache(te.cfg, 1, CLEN, dtype=fmt or torch.float32, device="cpu")
    assert [(p, t.shape, t.dtype) for p, t in Tlm._block_leaves(mine["blocks"])] == [
        (p, t.shape, t.dtype) for p, t in Tlm._block_leaves(cold["blocks"])]


@pytest.mark.parametrize("arch,mode", [("retnet-1.3b", "snapshot"), ("qwen3-8b", "paged"),
                                       (DS3, "paged")], ids=["retnet", "qwen3", "ds3_cut"])
def test_prefix_sharing_mode_matches_the_reference(arch, mode):
    je, te = engines(arch)
    assert Tlm.prefix_sharing_mode(te.cfg) == Jlm.prefix_sharing_mode(je.cfg) == mode
    if mode == "paged":
        assert Tlm.prefix_page_groups(te.cfg) == Jlm.prefix_page_groups(je.cfg)
    else:
        with pytest.raises(ValueError, match="not pageable"):
            Tlm.prefix_page_groups(te.cfg)


def test_unaligned_lookup_copies_the_tail_page_and_assembles_a_private_cache():
    """A lookup that stops inside a page (the COW event) gives the donor's
    rows up to the boundary, in a cache that shares no storage with any
    page; the pages are unchanged after the adopter's cache is written."""
    _, te = engines("qwen3-8b")
    _, tcache = caches("qwen3-8b", None)
    donor = prompts(te.cfg.vocab_size, [PROMPT], seed=71)[0]
    pc = PrefixCache(te.cfg, torch.float32, enabled=True, page_size=8, device="cpu")
    assert pc.register(donor, tcache, CLEN) == 3
    before = [{p: t.clone() for p, t in Tlm._block_leaves(n.rows["blocks"])}
              for n in pc._index.nodes()]
    query = donor[:13] + [1, 2, 3]
    hit, warm = pc.lookup(query, CLEN, slot=0)
    assert hit == 13 and pc.stats["cow_copies"] == 1
    want = Tlm.slice_cache_rows(tcache, te.cfg, 0, 13)
    got = Tlm.slice_cache_rows(warm, te.cfg, 0, 13)
    for (_, a), (_, b) in zip(Tlm._block_leaves(got["blocks"]),
                              Tlm._block_leaves(want["blocks"])):
        assert torch.equal(a, b)
    pages = {t.untyped_storage().data_ptr() for n in pc._index.nodes()
             for _, t in Tlm._block_leaves(n.rows["blocks"])}
    for _, t in Tlm._block_leaves(warm["blocks"]):
        assert t.untyped_storage().data_ptr() not in pages
        t.fill_(7.0)                        # the adopter writes its own cache
    for n, b in zip(pc._index.nodes(), before):
        assert all(torch.equal(t, b[p]) for p, t in Tlm._block_leaves(n.rows["blocks"]))
    pc.release(0)
    assert pc.leased_slots == 0
