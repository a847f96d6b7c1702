"""The continuous-batching scheduler of repro_torch against the JAX package.

On the CPU, with numpy inputs from a seed and the JAX engines' fp weights
carried over by `repro_torch.bridge` (reduced retnet-1.3b, reduced qwen3-8b
and the reduced deepseek-v3 config cut to its 3 leading dense layers):

* per-lane positions: `lm.forward_decode` over a class store whose lanes sit
  at different positions against the reference's batch-1
  `forward_decode` per lane (which its scheduler vmaps), two steps, 1e-5;
  `flash_decode_ref` with a ``[B]`` kv_len against the Pallas kernel in
  interpret mode lane by lane (1e-5), and a ``[B]`` kv_len of equal lengths
  bit-identical to the scalar;
* `RequestScheduler.run()` greedy tokens identical to the reference's
  scheduler on the same request set (two slot classes, mixed lengths,
  chunks of 8) and to `generate` of each request alone;
* the host tier: a spill/fetch round trip bit for bit, and a preempted and
  resumed request token-identical to an unpreempted run (greedy, and
  sampled from its own generator); a sampled request gives the same tokens
  alone and beside another, in either lane;
* `cancel` in each state (queued, admitting, active, preempted), the
  pool's write checks, `cache_nbytes`, the refused prefix cache, and the
  metrics registry and tracer against the reference's on the same records.

The card's side (per-lane kv_len in both kernel modes, a class step
replayed against its eager body) is in tests/test_torch_cuda.py.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import fp_engine

from repro import configs as Jconfigs
from repro.core import online_rope as Jrope
from repro.kernels import ops as Jops
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import layers as JL
from repro.obs import metrics as Jmetrics
from repro.obs import trace as Jtrace
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import RequestScheduler as JScheduler
from repro_torch import bridge
from repro_torch import configs as Tconfigs
from repro_torch.core import online_rope as Trope
from repro_torch.core.online_rope import OnlineRopeState
from repro_torch.kernels import ops as Tops
from repro_torch.models import layers as TL
from repro_torch.models import lm as Tlm
from repro_torch.obs import Observability, Tracer
from repro_torch.obs import metrics as Tmetrics
from repro_torch.serving import (CacheCapacityError, CachePool, EngineSpec,
                                 GenerationConfig, InferenceEngine, Request,
                                 RequestScheduler, SamplingParams, chunk_schedule)
from repro_torch.serving.engine import tree_items, tree_nbytes

DS3 = "deepseek-v3-671b"
ARCHS = ["retnet-1.3b", "qwen3-8b", DS3]
ARCH_IDS = ["retnet", "qwen3", "ds3_cut"]
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)
CLASSES = [(2, 24), (2, 34)]          # two slot classes
CHUNK, NEW = 8, 8
PROMPT_LENS = [5, 13, 9, 20, 3, 16]   # mixed: both classes, 1-3 chunks each


def _cfgs(arch):
    if arch == DS3:
        return (dataclasses.replace(Jconfigs.get_config(DS3).reduced(), n_layers=3),
                dataclasses.replace(Tconfigs.get_config(DS3).reduced(), n_layers=3))
    return Jconfigs.get_config(arch).reduced(), Tconfigs.get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def engines(arch: str):
    """The JAX fp engine (`conftest.fp_engine` where it serves the arch) and
    the port's on its carried weights, on the CPU."""
    jcfg, tcfg = _cfgs(arch)
    je = fp_engine(arch) if arch != DS3 else JEngine.from_config(jcfg, JSpec(quantize=False))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    te = InferenceEngine.from_config(tcfg, EngineSpec(quantize=False),
                                     model=bridge.model_from_tree(tcfg, tree, device="cpu"),
                                     device="cpu")
    return je, te


def prompts(vocab: int, lens=PROMPT_LENS, seed: int = 3) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, s).tolist() for s in lens]


def port_run(te, reqs, gen=None, **kw) -> dict:
    kw.setdefault("classes", CLASSES)
    sched = RequestScheduler(te, gen=gen or GenerationConfig(max_new_tokens=NEW),
                             chunk_size=CHUNK, **kw)
    for uid, p in enumerate(reqs):
        sched.submit(Request(uid=uid, prompt=p))
    return {u: f.tokens for u, f in sched.run().items()}


@functools.lru_cache(maxsize=None)
def default_run(arch: str, fmt=None) -> dict:
    """The port's scheduler on the default request set (`PROMPT_LENS` in
    `CLASSES`, chunks of `CHUNK`), greedy: uid -> tokens."""
    _, te = engines(arch)
    return port_run(te, prompts(te.cfg.vocab_size),
                    GenerationConfig(max_new_tokens=NEW, cache_format=fmt))


# -- per-lane positions through forward_decode -----------------------------------

def _jax_layers(cache: dict, n_layers: int) -> list:
    """The reference's stacked per-group cache -> one dict per layer."""
    groups = [cache[g] for g in ("dense_head", "blocks") if g in cache]
    return [jax.tree.map(lambda a, i=i: np.asarray(a[i]), g)
            for g in groups for i in range(jax.tree.leaves(g)[0].shape[0])][:n_layers]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def to_port_cache(jcache: dict, n_layers: int) -> dict:
    """A batch-1 JAX decode cache as the port's cache tree (same values)."""
    out = {"pos": _t(jcache["pos"]).to(torch.int32),
           "blocks": [{name: ({k: _t(v) for k, v in leaf.items()} if isinstance(leaf, dict)
                              else _t(leaf)) for name, leaf in layer.items()}
                      for layer in _jax_layers(jcache, n_layers)]}
    if "rope" in jcache:
        r = jcache["rope"]
        out["rope"] = OnlineRopeState(sin=_t(r.sin), cos=_t(r.cos),
                                      pos=_t(r.pos).to(torch.int32))
    return out


LANE_LENS = (3, 9, 14)   # three lanes at three positions
LANE_C = 20


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", None),
                                      ("qwen3-8b", "int8_tok"), ("qwen3-8b", "mxint4_blk"),
                                      (DS3, None)],
                         ids=["retnet", "qwen3-f32", "qwen3-int8_tok", "qwen3-mxint4_blk",
                              "ds3_cut-f32"])
def test_per_lane_forward_decode_matches_reference_per_lane(arch, fmt):
    """Three lanes prefilled to positions 3, 9 and 14 (the reference's caches,
    carried over), written into a per-lane class store, then two decode
    steps of the whole class: each lane's logits and position equal the
    reference's batch-1 step on that lane's own cache."""
    je, te = engines(arch)
    jgen = JGen(cache_format=fmt)
    n = len(LANE_LENS)
    pool = CachePool(te.cfg, n, LANE_C, dtype=fmt or torch.float32, device="cpu")
    jcaches, toks = [], []
    for lane, p in enumerate(prompts(te.cfg.vocab_size, LANE_LENS, seed=11)):
        logits, cache = je.prefill(jnp.asarray([p], jnp.int32), cache_len=LANE_C)
        cache = je._encode_cache(cache, jgen)
        jcaches.append(cache)
        toks.append(int(jnp.argmax(logits[0])))
        slot = pool.acquire(LANE_C)
        assert pool.locate(slot) == (LANE_C, lane)
        pool.write(slot, to_port_cache(cache, te.cfg.n_layers))
    store = pool.store
    assert store["pos"].tolist() == list(LANE_LENS)
    tok = torch.tensor(toks)
    for step in range(2):
        with torch.inference_mode():
            got, store = Tlm.forward_decode(te.model, tok[:, None], store, te.cfg, te.hsa)
        assert store["pos"].tolist() == [s + step + 1 for s in LANE_LENS]
        for lane in range(n):
            want, jcaches[lane] = je.decode_step(jnp.asarray([[toks[lane]]], jnp.int32),
                                                 jcaches[lane])
            np.testing.assert_allclose(got[lane].numpy(), np.asarray(want[0]),
                                       err_msg=f"{arch} {fmt} lane {lane} step {step}",
                                       **DECODE_TOL)
            if "rope" in store:
                np.testing.assert_allclose(store["rope"].sin[lane].numpy(),
                                           np.asarray(jcaches[lane]["rope"].sin), atol=1e-6)
        toks = [int(t) for t in got.argmax(-1)]
        tok = torch.tensor(toks)


@pytest.mark.parametrize("dim", [16, 128])
def test_per_lane_advance_resyncs_each_lane_at_its_own_multiple(dim):
    """Lanes at 60, 62 and 63 advanced 6 steps: each crosses 64 (an exact
    resync) at its own step, against the reference's scalar state per lane."""
    starts = (60, 62, 63)
    thj, tht = Jrope.rope_thetas(dim), Trope.rope_thetas(dim)
    sj = [Jrope.init_state(dim, pos=p) for p in starts]
    pos = torch.tensor(starts, dtype=torch.int32)
    st = Trope.OnlineRopeState(*Trope.rope_table(pos, tht), pos=pos)
    for _ in range(6):
        sj = [Jrope.advance(s, thj) for s in sj]
        st = Trope.advance(st, tht)
        assert st.pos.tolist() == [int(s.pos) for s in sj]
        for lane, s in enumerate(sj):
            np.testing.assert_allclose(st.sin[lane].numpy(), np.asarray(s.sin), atol=2e-5)
            np.testing.assert_allclose(st.cos[lane].numpy(), np.asarray(s.cos), atol=2e-5)


def _leaf_map(fn, leaf):
    return {k: fn(v) for k, v in leaf.items()} if isinstance(leaf, dict) else fn(leaf)


@pytest.mark.parametrize("fmt", ["f32", "bf16", "int8_tok", "mxint4_blk"])
def test_per_lane_cache_update_matches_dynamic_update_slice_per_lane(fmt):
    """Row b lands at slot pos[b] (clamped to C - 1, as the reference's
    ``dynamic_update_slice`` clamps), in place, byte for byte against the
    reference's jitted write on that lane alone."""
    from test_torch_decode_loop import C, _bytes, _resident
    rng = np.random.default_rng(61)
    jleaf, tleaf = _resident(fmt, rng)                     # [2, C, 2, 32]
    jleaf3 = jax.tree.map(lambda a: jnp.concatenate([a, a[:1]]), jleaf)
    tleaf3 = _leaf_map(lambda t: torch.cat([t, t[:1]]), tleaf)
    rows = rng.normal(size=(3, 1, 2, 32)).astype(np.float32)
    pos = (0, C - 1, C + 3)
    got = TL.cache_update(tleaf3, torch.from_numpy(rows), torch.tensor(pos, dtype=torch.int32))
    assert got is tleaf3
    upd = jax.jit(JL.cache_update)
    for b, p in enumerate(pos):
        lane = jax.tree.map(lambda a: a[b:b + 1], jleaf3)
        want = _bytes(upd(lane, jnp.asarray(rows[b:b + 1]), jnp.int32(p)))
        mine = _bytes(_leaf_map(lambda t: t[b:b + 1], got))
        for name in want:
            np.testing.assert_array_equal(mine[name], want[name], err_msg=f"{fmt} lane {b}")


@pytest.mark.parametrize("kv_len", [(1, 48), (17, 5)], ids=str)
@pytest.mark.parametrize("fmt", ["fp", "legacy_int8", "int8_tok", "mxint4_blk"])
def test_gqa_flash_decode_with_per_lane_kv_len_matches_pallas_per_lane(fmt, kv_len):
    from test_torch_decode_loop import _encode_both
    rng = np.random.default_rng(sum(kv_len))
    b, kv, g, d, c = 2, 2, 4, 32, 48
    q = rng.normal(size=(b, kv, g, d)).astype(np.float32)
    kj, kt = _encode_both(rng.normal(size=(b, c, kv, d)).astype(np.float32), fmt)
    vj, vt = _encode_both(rng.normal(size=(b, c, kv, d)).astype(np.float32), fmt)
    got = Tops.flash_decode(torch.from_numpy(q), kt, vt,
                            torch.tensor(kv_len, dtype=torch.int32))
    lane = lambda x, i: jax.tree.map(lambda a: a[i:i + 1], x)   # noqa: E731
    for i, n in enumerate(kv_len):
        want = flash_decode_pallas(jnp.asarray(q[i:i + 1]), lane(kj, i), lane(vj, i),
                                   jnp.int32(n), interpret=True)
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want),
                                   err_msg=f"lane {i}", **DECODE_TOL)


@pytest.mark.parametrize("kv_len", [(1, 48), (30, 12)], ids=str)
@pytest.mark.parametrize("fmt", [None, "int8_tok", "mxint4_blk"],
                         ids=["f32", "int8_tok", "mxint4_blk"])
def test_mla_flash_decode_with_per_lane_kv_len_matches_pallas_per_lane(fmt, kv_len):
    from test_torch_decode_loop import _encode_both
    rng = np.random.default_rng(200 + sum(kv_len))
    b, h, r, dr, c = 2, 4, 32, 16, 48
    q, q2 = (rng.normal(size=(b, h, w)).astype(np.float32) for w in (r, dr))
    latj, latt = _encode_both(rng.normal(size=(b, c, r)).astype(np.float32), fmt)
    ropej, ropet = _encode_both(rng.normal(size=(b, c, dr)).astype(np.float32), fmt)
    scale = float(1.0 / np.sqrt(np.float32(48)))
    got = Tops.flash_decode(torch.from_numpy(q), latt, latt,
                            torch.tensor(kv_len, dtype=torch.int32),
                            q2=torch.from_numpy(q2), k2=ropet, scale=scale)
    lane = lambda x, i: jax.tree.map(lambda a: a[i:i + 1], x)   # noqa: E731
    for i, n in enumerate(kv_len):
        want = Jops.flash_decode(jnp.asarray(q[i:i + 1]), lane(latj, i), lane(latj, i),
                                 jnp.int32(n), q2=jnp.asarray(q2[i:i + 1]),
                                 k2=lane(ropej, i), scale=scale, impl="pallas",
                                 interpret=True)
        np.testing.assert_allclose(got[i:i + 1].numpy(), np.asarray(want),
                                   err_msg=f"lane {i}", **DECODE_TOL)


@pytest.mark.parametrize("mla", [False, True], ids=["gqa", "mla"])
def test_equal_per_lane_kv_len_is_bit_identical_to_the_scalar(mla):
    g = torch.Generator().manual_seed(5)
    if mla:
        q, k, q2, k2 = (torch.randn(*s, generator=g) for s in
                        ((2, 4, 32), (2, 24, 32), (2, 4, 16), (2, 24, 16)))
        kw = dict(q2=q2, k2=k2, scale=0.2)
        v = k
    else:
        q, k, v = (torch.randn(*s, generator=g) for s in
                   ((2, 2, 4, 32), (2, 24, 2, 32), (2, 24, 2, 32)))
        kw = {}
    for n in (1, 13, 24):
        scalar = Tops.flash_decode(q, k, v, torch.tensor(n, dtype=torch.int32), **kw)
        lanes = Tops.flash_decode(q, k, v, torch.tensor([n, n], dtype=torch.int32), **kw)
        assert torch.equal(scalar, lanes)


@pytest.mark.parametrize("bad", [(3,), (2, 1)], ids=str)
def test_flash_decode_rejects_a_kv_len_of_the_wrong_shape(bad):
    q, k = torch.zeros(2, 2, 4, 32), torch.zeros(2, 8, 2, 32)
    with pytest.raises(ValueError, match="kv_len"):
        Tops.flash_decode(q, k, k, torch.ones(bad, dtype=torch.int32))


# -- the scheduler against the reference's ---------------------------------------


@functools.lru_cache(maxsize=None)
def reference_run(arch: str, fmt) -> dict:
    je, te = engines(arch)
    sched = JScheduler(je, classes=CLASSES, gen=JGen(max_new_tokens=NEW, cache_format=fmt),
                       chunk_size=CHUNK)
    for uid, p in enumerate(prompts(te.cfg.vocab_size)):
        sched.submit(JRequest(uid=uid, prompt=p))
    return {u: f.tokens for u, f in sched.run().items()}


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", None),
                                      ("qwen3-8b", "mxint4_blk"), (DS3, None)],
                         ids=["retnet", "qwen3-f32", "qwen3-mxint4_blk", "ds3_cut-f32"])
def test_run_matches_the_reference_scheduler(arch, fmt):
    assert default_run(arch, fmt) == reference_run(arch, fmt)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_run_matches_generate_of_each_request_alone(arch):
    _, te = engines(arch)
    got = default_run(arch)
    for uid, p in enumerate(prompts(te.cfg.vocab_size)):
        alone = te.generate(torch.tensor([p]), GenerationConfig(max_new_tokens=NEW))
        assert got[uid] == alone.tokens[0].tolist(), f"uid {uid}"


def test_run_reports_classes_and_metrics():
    _, te = engines("retnet-1.3b")
    sched = RequestScheduler(te, classes=CLASSES, gen=GenerationConfig(max_new_tokens=NEW),
                             chunk_size=CHUNK)
    for uid, p in enumerate(prompts(te.cfg.vocab_size)):
        sched.submit(Request(uid=uid, prompt=p))
    res = sched.run()
    assert {f.cache_len for f in res.values()} == {24, 34}
    assert all(len(f.tokens) == NEW for f in res.values())
    snap = sched.obs.metrics.snapshot()
    c = snap["counters"]
    assert c["sched.admitted"] == len(PROMPT_LENS) and c["sched.emitted"] == NEW * 6
    assert c["sched.prefill_chunks"] == sum(len(chunk_schedule(s, CHUNK))
                                            for s in PROMPT_LENS)
    for h in ("sched.ttft_s", "sched.inter_token_s", "sched.queue_wait_s",
              "sched.request_latency_s", "sched.prefill_chunk_interval_s"):
        assert snap["histograms"][h]["count"] > 0, h
    assert snap["gauges"]["pool.device_bytes[24]"]["value"] == tree_nbytes(
        sched.pool.get_store(24))
    assert te.obs.metrics.counter("engine.prefill_chunks").value >= c["sched.prefill_chunks"]


def test_stop_token_retires_the_lane():
    _, te = engines("qwen3-8b")
    reqs = prompts(te.cfg.vocab_size)
    free = default_run("qwen3-8b")
    stop = free[1][2]
    got = port_run(te, reqs, GenerationConfig(max_new_tokens=NEW, stop_tokens=(stop,)))
    for uid, toks in free.items():
        want = toks[:toks.index(stop) + 1] if stop in toks else toks
        assert got[uid] == want


# -- the host tier ---------------------------------------------------------------


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", "int8_tok"),
                                      ("qwen3-8b", "mxint4_blk"), (DS3, None)],
                         ids=["retnet", "qwen3-int8_tok", "qwen3-mxint4_blk", "ds3_cut"])
def test_spill_and_fetch_round_trip_bit_exact(arch, fmt):
    _, te = engines(arch)
    pool = CachePool(te.cfg, classes=[(2, 16)], dtype=fmt or torch.float32, device="cpu")
    logits, cache = te.prefill_chunked(torch.tensor([prompts(te.cfg.vocab_size, [7])[0]]),
                                       cache_len=16, chunk_size=4,
                                       cache_dtype=fmt or torch.float32)
    a = pool.acquire(16)                        # lane 0
    pool.write(a, cache)
    before = {p: t.clone() for p, t in tree_items(pool.lane_cache(a))}
    b = pool.acquire(16)                        # lane 1
    pool.spill(a)
    assert pool.residency(a) == "host" and pool.free_slots == 1
    assert pool.host_bytes == te.cache_nbytes(16, dtype=pool.dtype)
    pool.release(b)
    assert pool.locate(pool.acquire(16)) == (16, 0)   # lane 0 taken over
    pool.fetch(a)
    assert pool.locate(a) == (16, 1)                  # a comes back in lane 1
    after = dict(tree_items(pool.lane_cache(a)))
    assert before.keys() == after.keys()
    for p in before:
        assert torch.equal(before[p], after[p]), p
    ss = pool.spill_stats
    assert (ss["spills"], ss["fetches"]) == (1, 1)
    assert ss["bytes_to_host"] == ss["bytes_to_device"] == te.cache_nbytes(16, dtype=pool.dtype)


def test_write_checks_structure_and_shapes():
    _, te = engines("qwen3-8b")
    pool = CachePool(te.cfg, classes=[(1, 16), (1, 24)], device="cpu")
    small, large = pool.acquire(16), pool.acquire(24)
    cache16 = Tlm.make_decode_cache(te.cfg, 1, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        pool.write(large, cache16)
    with pytest.raises(ValueError, match="structure"):
        pool.write(small, Tlm.make_decode_cache(te.cfg, 1, 16, dtype="int8_tok",
                                                device="cpu"))
    pool.write(small, cache16)


def test_cache_nbytes_is_a_lane_of_the_store():
    for arch in ("retnet-1.3b", "qwen3-8b"):
        _, te = engines(arch)
        for fmt in (torch.float32, "int8_tok", "mxint4_blk"):
            pool = CachePool(te.cfg, 3, 20, dtype=fmt, device="cpu")
            assert te.cache_nbytes(20, dtype=fmt) == tree_nbytes(
                pool.lane_cache(pool.acquire()))


def _preempted_run(te, gen, reqs, burst):
    """Two default-priority residents decode; then a priority-1 burst preempts
    one of them into the host tier; everything drains."""
    sched = RequestScheduler(te, classes=[(2, 34)], gen=gen, chunk_size=CHUNK,
                             host_spill=True, seed=7)
    for uid, p in enumerate(reqs):
        sched.submit(Request(uid=uid, prompt=p))
    while sched.stats["emitted"] < 4:
        sched.step()
    for uid, p in enumerate(burst, start=len(reqs)):
        sched.submit(Request(uid=uid, prompt=p), priority=1)
    res = sched.run()
    return {u: f.tokens for u, f in res.items()}, sched


@pytest.mark.parametrize("arch,sampling", [
    *((a, SamplingParams()) for a in ARCHS),
    ("retnet-1.3b", SamplingParams(temperature=1.0, top_k=8))],
    ids=[f"greedy-{a}" for a in ARCH_IDS] + ["top_k-retnet"])
def test_preempted_request_resumes_token_identically(arch, sampling):
    _, te = engines(arch)
    reqs = prompts(te.cfg.vocab_size, [6, 11], seed=21)
    burst = prompts(te.cfg.vocab_size, [9], seed=22)
    gen = GenerationConfig(max_new_tokens=NEW, sampling=sampling)
    got, sched = _preempted_run(te, gen, reqs, burst)
    assert sched.stats["preempted"] == 1 and sched.stats["resumed"] == 1
    ss = sched.pool.spill_stats
    assert ss["bytes_to_host"] == ss["bytes_to_device"] == te.cache_nbytes(34)
    want = port_run(te, reqs + burst, gen, classes=[(4, 34)], seed=7)
    assert got == want


def test_sampled_request_is_the_same_alone_and_beside_another_in_either_lane():
    _, te = engines("retnet-1.3b")
    gen = GenerationConfig(max_new_tokens=NEW,
                           sampling=SamplingParams(temperature=1.0, top_p=0.9))
    p, other = prompts(te.cfg.vocab_size, [7, 12], seed=31)

    def tokens_of(uid, reqs):
        sched = RequestScheduler(te, classes=[(2, 24)], gen=gen, chunk_size=CHUNK, seed=3)
        for u, q in reqs:
            sched.submit(Request(uid=u, prompt=q))
        res = sched.run()
        return res[uid].tokens, sched

    alone, _ = tokens_of(5, [(5, p)])
    lane1, _ = tokens_of(5, [(9, other), (5, p)])     # admitted second: lane 1
    assert alone == lane1
    assert tokens_of(5, [(5, p), (9, other)])[0] == alone
    reseeded, _ = tokens_of(6, [(6, p)])
    assert reseeded != alone


# -- cancel in each state --------------------------------------------------------


@pytest.mark.parametrize("state", ["queued", "admitting", "active", "preempted"])
def test_cancel_in_each_state(state):
    _, te = engines("qwen3-8b")
    finished = []
    sched = RequestScheduler(te, classes=[(1, 34)], gen=GenerationConfig(max_new_tokens=NEW),
                             chunk_size=4, host_spill=True, on_finish=finished.append)
    p0, p1 = prompts(te.cfg.vocab_size, [12, 6], seed=41)
    sched.submit(Request(uid=0, prompt=p0))
    gone = 1 if state == "queued" else 0
    if state == "queued":
        sched.submit(Request(uid=1, prompt=p1))
        assert sched.cancel(1) and not finished
    elif state == "admitting":
        sched.step()
        assert sched._admitting is not None and not sched._admitting["prefill"].done
        assert sched.cancel(0)
        assert finished[-1].uid == 0 and finished[-1].cancelled and finished[-1].tokens == []
    else:
        while sched.stats["emitted"] < 2:
            sched.step()
        if state == "preempted":
            sched.submit(Request(uid=1, prompt=p1), priority=1)
            sched.step()
            assert sched.pool.residency(sched._preempted[0]["slot"]) == "host"
        assert sched.cancel(0)
        assert finished[-1].uid == 0 and finished[-1].cancelled
        assert len(finished[-1].tokens) == 2
        assert sched.pool.host_resident == 0
    assert sched.stats["cancelled"] == 1
    assert not sched.cancel(gone)
    res = sched.run()
    assert sched.pool.free_slots == 1 and sched.pool.host_resident == 0
    assert gone not in res if state == "queued" else res[0].cancelled
    assert all(not f.cancelled for u, f in res.items() if u != gone)


def test_submit_rejects_what_no_class_holds():
    _, te = engines("retnet-1.3b")
    sched = RequestScheduler(te, classes=[(1, 16)], gen=GenerationConfig(max_new_tokens=8))
    with pytest.raises(CacheCapacityError):
        sched.submit(Request(uid=0, prompt=list(range(1, 10))))
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(Request(uid=1, prompt=[1, 2], max_new_tokens=0))


def test_prefix_cache_raises_naming_its_roadmap_item():
    _, te = engines("retnet-1.3b")
    with pytest.raises(NotImplementedError, match="A11b"):
        RequestScheduler(te, classes=[(1, 16)], prefix_cache=True)
    with pytest.raises(NotImplementedError, match="A11b"):
        CachePool(te.cfg, 1, 16, device="cpu", prefix_cache=True)


# -- the metrics registry and the tracer against the reference's -----------------


RECORDS = [(0.5, 0.0), (0.1, 1.0), (0.9, 2.5), (0.3, 3.0), (0.7, 7.5), (0.2, 9.0),
           (1.4, 9.5), (0.05, 11.0)]


@pytest.mark.parametrize("q", [0.0, 25.0, 50.0, 95.0, 99.0, 100.0])
def test_histogram_percentiles_and_windows_match_the_reference(q):
    mine, ref = Tmetrics.Histogram("h"), Jmetrics.Histogram("h")
    for v, t in RECORDS:
        mine.record(v, t=t)
        ref.record(v, t=t)
    assert mine.percentile(q) == ref.percentile(q)
    for window, now in ((5.0, 11.0), (2.0, 9.5), (100.0, 11.0)):
        assert (mine.percentile(q, window_s=window, now=now)
                == ref.percentile(q, window_s=window, now=now))
    assert mine.summary() == ref.summary()
    assert Tmetrics.percentile([v for v, _ in RECORDS], q) == pytest.approx(
        float(np.percentile([v for v, _ in RECORDS], q)), abs=0, rel=1e-12)


def test_registry_snapshot_reset_and_views_match_the_reference():
    regs = (Tmetrics.MetricsRegistry(), Jmetrics.MetricsRegistry())
    for reg in regs:
        view = reg.counter_view("sched.", ["steps", "emitted"])
        view["steps"] += 3
        view["emitted"] += 2
        reg.gauge("pool.host_bytes").set(10)
        reg.gauge("pool.host_bytes").set(4)
        for v, t in RECORDS:
            reg.histogram("sched.ttft_s").record(v, t=t)
        with pytest.raises(KeyError):
            view["nope"] += 1
        with pytest.raises(ValueError):
            reg.gauge("sched.steps")
    assert regs[0].snapshot() == regs[1].snapshot()
    for reg in regs:
        reg.reset()
    assert regs[0].snapshot() == regs[1].snapshot()


def test_histogram_decimates_like_the_reference():
    mine, ref = Tmetrics.Histogram("h", max_samples=8), Jmetrics.Histogram("h", max_samples=8)
    for i in range(37):
        mine.record(i, t=float(i))
        ref.record(i, t=float(i))
    assert mine.samples == ref.samples and mine.count == ref.count == 37


def test_tracer_events_match_the_reference_and_flush_tensor_args(tmp_path):
    clock = iter(range(100)).__next__
    mine, ref = Tracer(clock=clock), Jtrace.Tracer(clock=iter(range(100)).__next__)
    for tr, arg in ((mine, torch.tensor([1, 2])), (ref, jnp.asarray([1, 2]))):
        tr.begin("request", "req 0", prompt_len=5)
        with tr.span("prefill_chunk", "req 0"):
            tr.instant("first_token", "req 0", toks=arg)
        tr.counter("queue_depth", 2)
        with pytest.raises(ValueError):
            tr.end("decode", "req 0")
        tr.end("request", "req 0")
    assert mine.to_dict() == json.loads(json.dumps(ref.to_dict()))
    mine.export(str(tmp_path / "t.json"))
    assert json.load(open(tmp_path / "t.json"))["traceEvents"][-1]["name"] == "request"


def test_scheduler_trace_pairs_every_span():
    _, te = engines("retnet-1.3b")
    obs = Observability(tracer=Tracer())
    reqs = prompts(te.cfg.vocab_size, [6, 11], seed=21)
    sched = RequestScheduler(te, classes=[(1, 34)], gen=GenerationConfig(max_new_tokens=4),
                             chunk_size=CHUNK, host_spill=True, obs=obs)
    sched.submit(Request(uid=0, prompt=reqs[0]))
    while sched.stats["emitted"] < 1:
        sched.step()
    sched.submit(Request(uid=1, prompt=reqs[1]), priority=1)
    sched.run()
    names = [e["name"] for e in obs.tracer.events if e["ph"] in "Bi"]
    for name in ("request", "queued", "admit", "prefill_chunk", "decode", "preempt",
                 "preempted", "resume", "first_token", "finish"):
        assert name in names, name
    assert all(not obs.tracer.open_spans(f"req {u}") for u in (0, 1))
