"""Shared-prefix reuse in repro_torch's scheduler, against the JAX package.

On the CPU, with the JAX engines' fp weights carried over (reduced
retnet-1.3b, the snapshot tier; reduced qwen3-8b in f32, ``int8_tok`` and
``mxint4_blk``, and the reduced deepseek-v3 cut to its 3 dense layers, the
paged tier):

* the port's scheduler with ``prefix_cache=True`` gives the reference
  scheduler's greedy tokens, and the same ``pool.prefix`` counters, on the
  repeated-system-prompt shape (a 16-token base alone, then extensions), and
  the port's own cold tokens;
* the reference's cases of tests/test_serving_prefix.py that need neither
  speculative decode (its case is in tests/test_torch_speculative.py) nor
  MoE layers (its case is in tests/test_torch_moe_serving.py), on the port:
  preemption, engine-level adoption, offset validation, the COW of an
  unaligned adoption, the last-token cap, the sub-page miss, sibling pages,
  encoded pages, page budgets (LRU eviction, host migration, snapshots),
  the metrics, the disabled default, a cancel mid-admission (lease misuse
  is in tests/test_torch_paging.py).

The pool with ``prefix_cache=True`` on its own is in
tests/test_torch_scheduler.py, the serve CLI's ``--prefix-cache`` in
tests/test_torch_serve.py.

The card's side (pages are clones on CUDA tensors, a pinned spill and its
fetch bit-exact, pages unchanged by graph replays over an adopted lane) is
in tests/test_torch_cuda.py.
"""

import functools

import pytest
import torch
from test_torch_scheduler import ARCH_IDS, ARCHS, DS3, engines, prompts

from repro.serving import GenerationConfig as JGen
from repro.serving import Request as JRequest
from repro.serving import RequestScheduler as JScheduler
from repro_torch.models import lm as Tlm
from repro_torch.serving import GenerationConfig, PrefixCache, Request, RequestScheduler
from repro_torch.serving.engine import tree_items
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NEW, CHUNK, SLOTS, CLEN = 6, 8, 2, 48
CELLS = [("retnet-1.3b", None), ("qwen3-8b", None), ("qwen3-8b", "int8_tok"),
         ("qwen3-8b", "mxint4_blk"), (DS3, None)]
CELL_IDS = ["retnet", "qwen3-f32", "qwen3-int8_tok", "qwen3-mxint4_blk", "ds3_cut-f32"]


def prompt(arch: str, n: int, seed: int) -> list[int]:
    return prompts(engines(arch)[1].cfg.vocab_size, [n], seed=seed)[0]


def shared_prompts(arch: str, n_ext: int = 3, shared: int = 16, ext: int = 8) -> list:
    """The repeated-system-prompt shape: the shared prefix alone (so the
    snapshot tier has an exact boundary to register), then extensions."""
    base = prompt(arch, shared, 3)
    return [base] + [base + prompt(arch, ext, 10 + i) for i in range(n_ext)]


def run_sched(arch, reqs, *, prefix_cache, fmt=None, chunk_size=CHUNK, **kw):
    """Drain ``reqs`` through a fresh port scheduler: ({uid: tokens}, sched)."""
    _, te = engines(arch)
    sched = RequestScheduler(te, n_slots=SLOTS, cache_len=CLEN,
                             gen=GenerationConfig(max_new_tokens=NEW, cache_format=fmt),
                             chunk_size=chunk_size, prefix_cache=prefix_cache, **kw)
    for uid, p in enumerate(reqs):
        sched.submit(Request(uid=uid, prompt=p))
    return {u: f.tokens for u, f in sched.run().items()}, sched


@functools.lru_cache(maxsize=None)
def port_runs(arch: str, fmt=None):
    """The port's cold and warm runs of `shared_prompts`: (cold, warm, sched)."""
    reqs = shared_prompts(arch)
    cold, _ = run_sched(arch, reqs, prefix_cache=False, fmt=fmt)
    warm, sched = run_sched(arch, reqs, prefix_cache=True, fmt=fmt)
    return cold, warm, sched


# -- the scheduler against the reference's ------------------------------------------


@pytest.mark.parametrize("arch,fmt", CELLS, ids=CELL_IDS)
def test_warm_tokens_and_prefix_stats_match_the_reference_scheduler(arch, fmt):
    je, _ = engines(arch)
    ref = JScheduler(je, n_slots=SLOTS, cache_len=CLEN,
                     gen=JGen(max_new_tokens=NEW, cache_format=fmt), chunk_size=CHUNK,
                     prefix_cache=True)
    for uid, p in enumerate(shared_prompts(arch)):
        ref.submit(JRequest(uid=uid, prompt=p))
    want = {u: f.tokens for u, f in ref.run().items()}
    cold, warm, sched = port_runs(arch, fmt)
    assert warm == want == cold
    assert dict(sched.pool.prefix.stats) == dict(ref.pool.prefix.stats)
    assert sched.pool.prefix.mode == ref.pool.prefix.mode
    assert sched.pool.prefix.n_pages == ref.pool.prefix.n_pages


# -- the reference's cases (tests/test_serving_prefix.py) on the port ----------------


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_warm_vs_cold_identity_chunked(arch):
    cold, warm, sched = port_runs(arch)
    assert warm == cold
    st = sched.pool.prefix.stats
    assert st["prefix_hits"] >= 2 and st["prefix_hit_tokens"] >= 2 * 8
    assert sched.pool.prefix.leased_slots == 0


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_warm_vs_cold_identity_preempt_resume(arch):
    reqs = shared_prompts(arch)

    def run(prefix_cache):
        _, te = engines(arch)
        sched = RequestScheduler(te, n_slots=SLOTS, cache_len=CLEN,
                                 gen=GenerationConfig(max_new_tokens=NEW), chunk_size=CHUNK,
                                 host_spill=True, prefix_cache=prefix_cache)
        for uid in range(3):
            sched.submit(Request(uid=uid, prompt=reqs[uid]))
        for _ in range(6):
            sched.step()
        sched.submit(Request(uid=3, prompt=reqs[3]), priority=5)
        return {u: f.tokens for u, f in sched.run().items()}, sched

    cold, _ = run(False)
    warm, sched = run(True)
    assert warm == cold
    assert sched.stats["preempted"] >= 1
    assert sched.pool.prefix.leased_slots == 0


def greedy_continue(te, logits, cache, n: int) -> list[int]:
    toks = []
    tok = logits.argmax(-1)[:, None]
    for _ in range(n):
        toks.append(int(tok[0, 0]))
        logits, cache = te.decode_step(tok, cache)
        tok = logits.argmax(-1)[:, None]
    return toks


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_engine_adopted_prefill_matches_cold(arch):
    _, te = engines(arch)
    donor = prompt(arch, 16, 3)
    query = donor + prompt(arch, 9, 11)
    _, donor_cache = te.prefill_chunked(torch.tensor([donor]), cache_len=CLEN, chunk_size=8)
    pc = PrefixCache(te.cfg, torch.float32, enabled=True, page_size=4, device="cpu")
    pc.register(donor, donor_cache, CLEN)
    p, warm = pc.lookup(query, CLEN, slot=0, chunk_size=8)
    assert p == len(donor)
    cp = te.begin_chunked_prefill(torch.tensor([query]), cache_len=CLEN, chunk_size=8,
                                  initial_cache=warm, start_offset=p)
    assert sum(cp.schedule) == len(query) - p
    while not cp.done:
        cp.advance()
    logits_cold, cache_cold = te.prefill_chunked(torch.tensor([query]), cache_len=CLEN,
                                                 chunk_size=8)
    assert (greedy_continue(te, cp.logits, cp.cache, 6)
            == greedy_continue(te, logits_cold, cache_cold, 6))


def test_chunked_prefill_offset_validation():
    _, te = engines("qwen3-8b")
    toks = torch.tensor([prompt("qwen3-8b", 8, 1)])
    with pytest.raises(ValueError, match="start_offset"):
        te.begin_chunked_prefill(toks, cache_len=16, start_offset=8)
    with pytest.raises(ValueError, match="initial_cache"):
        te.begin_chunked_prefill(toks, cache_len=16, start_offset=4)


def test_unaligned_adoption_cow_never_mutates_shared_pages():
    """An adoption boundary inside a page copies the tail page's rows (the
    COW event); the donor's pages still rebuild the donor's own prefill
    rows afterwards, and the adopter's tokens match a cold run."""
    arch = "qwen3-8b"
    _, te = engines(arch)
    donor = prompt(arch, 16, 3)
    query = donor[:14] + prompt(arch, 10, 12)        # diverges inside the last page
    cold, _ = run_sched(arch, [donor, query], prefix_cache=False)
    warm, sched = run_sched(arch, [donor, query], prefix_cache=True, prefix_page_size=4)
    pc = sched.pool.prefix
    assert pc.stats["cow_copies"] >= 1 and pc.stats["prefix_hit_tokens"] == 14
    assert warm == cold
    p, again = pc.lookup(donor, CLEN, slot=999, chunk_size=1)
    assert p == len(donor) - 1
    _, donor_cache = te.prefill_chunked(torch.tensor([donor]), cache_len=CLEN, chunk_size=8)
    got = Tlm.slice_cache_rows(again, te.cfg, 0, p)
    want = Tlm.slice_cache_rows(donor_cache, te.cfg, 0, p)
    for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
        assert torch.equal(a, b)
    pc.release(999)
    assert pc.leased_slots == 0


def test_full_prompt_repeat_capped_at_last_token():
    arch = "qwen3-8b"
    p = prompt(arch, 16, 3)
    cold, _ = run_sched(arch, [p, p], prefix_cache=False)
    warm, sched = run_sched(arch, [p, p], prefix_cache=True, prefix_page_size=8)
    assert sched.pool.prefix.stats["prefix_hit_tokens"] == len(p) - 1
    assert warm == cold


def test_sub_page_hit_is_a_miss():
    _, te = engines("qwen3-8b")
    donor = prompt("qwen3-8b", 12, 3)
    _, cache = te.prefill_chunked(torch.tensor([donor]), cache_len=24, chunk_size=8)
    pc = PrefixCache(te.cfg, torch.float32, enabled=True, page_size=8, device="cpu")
    pc.register(donor, cache, 24)
    query = donor[:4] + prompt("qwen3-8b", 8, 9)
    assert pc.lookup(query, 24, slot=0, chunk_size=1) == (0, None)
    assert pc.leased_slots == 0
    assert pc.stats["prefix_lookups"] == 1 and pc.stats["prefix_hits"] == 0


def test_divergent_prompts_build_siblings_and_stay_exact():
    arch = "qwen3-8b"
    base = prompt(arch, 10, 3)
    a, b = base + prompt(arch, 6, 21), base + prompt(arch, 6, 22)
    cold, _ = run_sched(arch, [a, b, a, b], prefix_cache=False)
    warm, sched = run_sched(arch, [a, b, a, b], prefix_cache=True, prefix_page_size=4)
    assert warm == cold
    assert sched.pool.prefix.stats["prefix_hits"] >= 2
    assert any(len(n.children) > 1 for n in sched.pool.prefix._index.nodes())


@pytest.mark.parametrize("fmt", ["int8_tok", "mxint4_blk"])
def test_quantized_pages_share_like_fp(fmt):
    arch = "qwen3-8b"
    reqs = shared_prompts(arch, n_ext=2)
    cold, _ = run_sched(arch, reqs, prefix_cache=False, fmt=fmt)
    warm, sched = run_sched(arch, reqs, prefix_cache=True, fmt=fmt)
    assert warm == cold
    assert sched.pool.prefix.stats["prefix_hits"] >= 2
    node = sched.pool.prefix._index.nodes()[0]
    assert all(isinstance(leaf, dict) for layer in node.rows["blocks"]
               for leaf in layer.values())


def test_page_budget_evicts_lru_unreferenced_only():
    arch = "qwen3-8b"
    reqs = [prompt(arch, 16, s) for s in range(3, 8)]
    _, sched = run_sched(arch, reqs, prefix_cache=True, max_prefix_pages=2)
    pc = sched.pool.prefix
    assert pc.n_pages <= 2
    assert pc.stats["page_evictions"] >= 1
    assert all(n.refs == 0 for n in pc._index.nodes())


def test_cold_pages_migrate_to_host_and_fetch_back():
    arch = "qwen3-8b"
    reqs = shared_prompts(arch, n_ext=2)
    cold, _ = run_sched(arch, reqs, prefix_cache=False)
    warm, sched = run_sched(arch, reqs, prefix_cache=True, prefix_page_size=4,
                            device_prefix_pages=0)
    pc = sched.pool.prefix
    st = pc.stats
    assert st["page_spills"] >= 1 and st["page_fetches"] >= 1 and st["prefix_hits"] >= 2
    assert warm == cold
    sched.pool.prefix_maintain()
    assert pc.device_resident_pages == 0 and pc.host_pages == pc.n_pages


def test_snapshot_tier_budgets():
    arch = "retnet-1.3b"
    reqs = shared_prompts(arch, n_ext=2)
    cold, _ = run_sched(arch, reqs, prefix_cache=False)
    warm, sched = run_sched(arch, reqs, prefix_cache=True, device_prefix_pages=0)
    st = sched.pool.prefix.stats
    assert st["page_spills"] >= 1 and st["prefix_hits"] >= 2
    assert warm == cold


def test_prefix_metrics_and_gauges_surface():
    arch = "qwen3-8b"
    reqs = shared_prompts(arch, n_ext=2)
    _, sched = run_sched(arch, reqs, prefix_cache=True)
    snap = sched.obs.metrics.snapshot()
    assert snap["counters"]["pool.prefix_lookups"] == len(reqs)
    assert snap["counters"]["pool.prefix_hits"] >= 2
    assert snap["gauges"]["pool.pages_free"]["value"] == sched.pool.prefix.n_pages
    assert snap["gauges"]["pool.prefix_bytes"]["value"] > 0


def test_prefix_cache_default_off():
    _, sched = run_sched("qwen3-8b", shared_prompts("qwen3-8b", n_ext=1), prefix_cache=False)
    pc = sched.pool.prefix
    assert not pc.enabled and pc.n_pages == 0
    assert pc.stats["prefix_lookups"] == 0


def test_cancel_mid_admission_releases_leases():
    arch = "qwen3-8b"
    _, te = engines(arch)
    donor = prompt(arch, 16, 3)
    query = donor + prompt(arch, 8, 11)
    sched = RequestScheduler(te, n_slots=SLOTS, cache_len=CLEN,
                             gen=GenerationConfig(max_new_tokens=4), chunk_size=8,
                             prefix_cache=True)
    sched.submit(Request(uid=0, prompt=donor))
    assert 0 in sched.run()
    sched.submit(Request(uid=1, prompt=query))
    sched.step()                       # admission in flight, lease held
    assert sched.pool.prefix.leased_slots == 1
    sched.cancel(1)
    assert sched.pool.prefix.leased_slots == 0
    assert all(n.refs == 0 for n in sched.pool.prefix._index.nodes())
