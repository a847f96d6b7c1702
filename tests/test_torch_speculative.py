"""Speculative decode of repro_torch against the JAX package.

On the CPU, with numpy inputs from a seed and the JAX engines' weights
carried over by `repro_torch.bridge` (reduced retnet-1.3b, reduced qwen3-8b
with its f32, ``int8_tok`` and ``mxint4_blk`` caches, and the reduced
deepseek-v3 config cut to its 3 leading dense layers in the same formats):

* `ngram_propose` against the reference's on seeded histories (no match, an
  n-gram longer than the buffer, a garbage ``hist_len`` that every index
  clamps), per lane and shared, and the reference's lookup case;
* `retention_recurrent(return_states=True)` and `retention_apply(
  collect_states=True)` against the reference's, 1e-4;
* `forward_verify_chunk` and `commit_verified_cache` at every ``n_accept``
  in 1..k+1 against the reference's from the same cache, with one decode
  step from each committed cache (retnet, qwen3-8b in its three formats,
  the ds3 cut in f32): fp weights within 1e-4, deployed weights within 1e-2
  of max|reference|, positions exact; the reference's full-rejection
  rollback case on retnet;
* greedy `generate(speculative=)` on fp weights: tokens, lengths,
  ``verify_steps`` and ``accepted_drafts`` equal the reference's, and the
  tokens equal the port's plain loop, in all 7 cells; the reference's
  lockstep-batch, stop-inside-a-block, MTP-head (refused without one, an
  MTP run on the ds3 cut) and fixed-generator cases;
* the scheduler's speculative mode: tokens equal the engine's in all 7
  cells, budget truncation, the verify overrun reserved, the MTP drafter
  refused; a per-lane ``[B]``-position verify block against lane-by-lane
  scalar ones (tokens identical, 1e-6), and lane isolation on deployed
  weights (a lane's outputs bit-identical whatever its co-tenant holds);
* composition: prefix adoption warm against cold, and preemption carrying
  the draft history.

The card's side (a captured verify step against its eager body, W8A8 in a
graph, the per-lane activation scale) is in tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scheduler import DS3, _cfgs, _jax_layers, engines, prompts, to_port_cache

from repro.core import retention as Jret
from repro.models import lm as Jlm
from repro.models import retnet as JR
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro.serving import SpeculativeConfig as JSpecCfg
from repro.serving import ngram_propose as jngram
from repro_torch import bridge, configs as Tconfigs
from repro_torch.core import retention as Tret
from repro_torch.models import lm as Tlm
from repro_torch.models import retnet as TR
from repro_torch.serving import (CachePool, EngineSpec, GenerationConfig, InferenceEngine,
                                 Request, RequestScheduler, SamplingParams, SpecClassStep,
                                 SpeculativeConfig, ngram_propose)
from repro_torch.serving.engine import _clone, tree_items
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

CELLS = [("retnet-1.3b", None), ("qwen3-8b", None), ("qwen3-8b", "int8_tok"),
         ("qwen3-8b", "mxint4_blk"), (DS3, None), (DS3, "int8_tok"), (DS3, "mxint4_blk")]
CELL_IDS = ["retnet", "qwen3-f32", "qwen3-int8_tok", "qwen3-mxint4_blk", "ds3_cut-f32",
            "ds3_cut-int8_tok", "ds3_cut-mxint4_blk"]
FP_TOL, DEPLOYED_TOL = 1e-4, 1e-2


@functools.lru_cache(maxsize=None)
def deployed(arch: str):
    """The JAX engine with the default W8A8 / MXINT4 deployment and the port
    on its carried (deployed) weights, on the CPU."""
    jcfg, tcfg = _cfgs(arch)
    je = JEngine.from_config(jcfg, JSpec())
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    te = InferenceEngine.from_config(tcfg, EngineSpec(),
                                     model=bridge.model_from_tree(tcfg, tree, device="cpu"),
                                     device="cpu")
    return je, te


def _pair(arch: str, quantize: bool):
    return deployed(arch) if quantize else engines(arch)


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    """|got - want| within ``tol`` of max|want| (and of 1 for small values)."""
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got.detach().numpy().astype(np.float32) - want).max())
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol} x {scale:.3e}"


def _decoded(leaf):
    from repro_torch.core import kvq
    return kvq.decode(leaf)


def _jdecoded(leaf):
    from repro.core import kvq as Jkvq
    return np.asarray(Jkvq.decode(leaf) if isinstance(leaf, dict) else leaf, np.float32)


# -- (1) ngram_propose ---------------------------------------------------------

NGRAM_CASES = [  # (seed, vocab, cap, k, m, hist_lens per row)
    (0, 3, 12, 3, 2, (7, 12)),        # a small vocab: matches everywhere
    (1, 4, 16, 4, 3, (9, 5)),
    (2, 50, 10, 2, 2, (10, 6)),       # a large vocab: mostly no match
    (3, 3, 8, 3, 1, (4, 8)),
    (4, 3, 4, 2, 8, (4, 2)),          # m > history: the fallback
    (5, 3, 12, 3, 2, (-3, 40)),       # garbage fill levels: clamped
]


_jngram = jax.jit(jngram, static_argnames=("k", "m"))


@pytest.mark.parametrize("case", NGRAM_CASES, ids=lambda c: f"seed{c[0]}")
def test_ngram_propose_matches_reference(case):
    """Per lane (a ``[B]`` hist_len, the scheduler's) against the reference
    row by row, and shared (a scalar, the engine's lockstep) against the
    reference on the batch."""
    seed, vocab, cap, k, m, lens = case
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, vocab, (len(lens), cap))
    tok = rng.integers(0, vocab, len(lens))
    got = ngram_propose(torch.from_numpy(hist), torch.tensor(lens), torch.from_numpy(tok),
                        k=k, m=m)
    assert got.dtype == torch.int64 and got.shape == (len(lens), k)
    for b, n in enumerate(lens):
        want = _jngram(jnp.asarray(hist[b:b + 1], jnp.int32), jnp.int32(n),
                      jnp.asarray(tok[b:b + 1], jnp.int32), k=k, m=m)
        np.testing.assert_array_equal(got[b:b + 1].numpy(), np.asarray(want), err_msg=f"row {b}")
    shared = ngram_propose(torch.from_numpy(hist), torch.tensor(lens[0]),
                           torch.from_numpy(tok), k=k, m=m)
    want = _jngram(jnp.asarray(hist, jnp.int32), jnp.int32(lens[0]),
                  jnp.asarray(tok, jnp.int32), k=k, m=m)
    np.testing.assert_array_equal(shared.numpy(), np.asarray(want))


def test_ngram_propose_lookup_and_fallback():
    """The reference's case: the lookup n-gram is (last m-1 committed tokens,
    pending token); the most recent match wins; a continuation past the
    committed end, no match, and an n-gram longer than the buffer fall back
    to repeating the pending token."""
    hist = torch.tensor([[5, 1, 8, 5, 1, 9, 5, 0]])
    t = torch.tensor
    assert ngram_propose(hist, t(7), t([1]), k=2, m=2).tolist() == [[9, 5]]
    assert ngram_propose(hist, t(5), t([8]), k=3, m=2).tolist() == [[5, 1, 8]]
    assert ngram_propose(hist, t(7), t([7]), k=3, m=2).tolist() == [[7, 7, 7]]
    assert ngram_propose(hist[:, :4], t(4), t([3]), k=2, m=8).tolist() == [[3, 3]]


# -- (2) retention snapshots --------------------------------------------------------

def test_retention_recurrent_states_match_reference():
    rng = np.random.default_rng(7)
    b, h, s, dk, dv = 2, 3, 5, 8, 16
    q, k = (rng.normal(size=(b, h, s, dk)).astype(np.float32) for _ in range(2))
    v = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    st = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    gamma = Tret.head_decays(h)
    y, fin, states = Tret.retention_recurrent(*(torch.from_numpy(a) for a in (q, k, v)),
                                              gamma, state=torch.from_numpy(st),
                                              return_states=True)
    jy, jfin, jstates = Jret.retention_recurrent(*(jnp.asarray(a) for a in (q, k, v)),
                                                 Jret.head_decays(h), state=jnp.asarray(st),
                                                 return_states=True)
    assert states.shape == (b, h, s, dk, dv)
    for got, want, what in ((y, jy, "y"), (fin, jfin, "final state"),
                            (states, np.moveaxis(np.asarray(jstates), 1, 2), "states")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    assert torch.equal(states[:, :, -1], fin)


def test_retention_apply_collect_states_matches_reference():
    """Layer 0 of reduced retnet-1.3b over a warm state, a 5-position block
    at positions 9..13: the output, the final state and every snapshot."""
    je, te = engines("retnet-1.3b")
    cfg = te.cfg
    rng = np.random.default_rng(8)
    d, h = cfg.d_model, cfg.n_heads
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    sig = rng.uniform(0.5, 1.5, (2, 5)).astype(np.float32)
    s0 = (rng.normal(size=(2, h, d // h, 2 * d // h)) * 0.1).astype(np.float32)
    tsin, tcos = Tlm._rope_tables(cfg, 5, torch.device("cpu"), start=torch.tensor(9))
    jp = jax.tree.map(lambda a: a[0], je.params["blocks"])["ret"]
    jsin, jcos = (jnp.asarray(t.numpy()) for t in (tsin, tcos))
    jout, jcache = jax.jit(lambda x, sig, s0: JR.retention_apply(
        jp, x, sig, je.hsa, "prefill", je.cfg, rope_sin=jsin, rope_cos=jcos,
        cache={"s": s0}, collect_states=True))(jnp.asarray(x), jnp.asarray(sig),
                                               jnp.asarray(s0))
    with torch.inference_mode():
        out, cache = TR.retention_apply(te.model.blocks[0].ret, torch.from_numpy(x),
                                        torch.from_numpy(sig), te.hsa, "prefill", cfg,
                                        rope_sin=tsin, rope_cos=tcos,
                                        cache={"s": torch.from_numpy(s0)},
                                        collect_states=True)
    assert set(cache) == {"s", "s_all"}
    _close(out, jout, FP_TOL, "out")
    _close(cache["s"], jcache["s"], FP_TOL, "s")
    _close(cache["s_all"], np.moveaxis(np.asarray(jcache["s_all"]), 1, 2), FP_TOL, "s_all")


# -- (3) verify and commit -------------------------------------------------------

K = 3


def _warm(je, fmt, seed: int):
    """The reference's warm cache after a [2, 9] prompt (room for 8 more
    tokens and the verify overrun) and its greedy next token."""
    p = prompts(je.cfg.vocab_size, (9, 9), seed=seed)
    logits, cache = je.prefill(jnp.asarray(p, jnp.int32), cache_len=9 + 8 + K)
    cache = je._encode_cache(cache, JGen(cache_format=fmt))
    return cache, np.asarray(jnp.argmax(logits, -1))


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch,fmt", CELLS[:5], ids=CELL_IDS[:5])
def test_verify_and_commit_match_reference(arch, fmt, quantize):
    je, te = _pair(arch, quantize)
    tol = DEPLOYED_TOL if quantize else FP_TOL
    cfg, n_layers = te.cfg, te.cfg.n_layers
    jcache, tok = _warm(je, fmt, seed=21)
    rng = np.random.default_rng(22)
    block = np.concatenate([tok[:, None], rng.integers(1, cfg.vocab_size, (2, K))], axis=1)
    jlog, jhid, jver = jax.jit(lambda p, b, c: Jlm.forward_verify_chunk(
        p, {"tokens": b}, c, je.cfg, je.hsa))(je.params, jnp.asarray(block, jnp.int32), jcache)
    tcache = to_port_cache(jcache, n_layers)
    with torch.inference_mode():
        logits, hidden, ver = Tlm.forward_verify_chunk(te.model, torch.from_numpy(block),
                                                       _clone(tcache), cfg, te.hsa)
    assert logits.shape == (2, K + 1, cfg.padded_vocab)
    _close(logits, jlog, tol, f"{arch} {fmt} logits")
    _close(hidden, jhid, tol, f"{arch} {fmt} hidden")
    assert ver["pos"].tolist() == int(jver["pos"]) == 9 + K + 1
    jl = _jax_layers(jver, n_layers)
    for i, (tl, jlay) in enumerate(zip(ver["blocks"], jl)):
        for name, leaf in tl.items():
            want = np.moveaxis(np.asarray(jlay[name]), 1, 2) if name == "s_all" \
                else _jdecoded(jlay[name])
            _close(_decoded(leaf), want, tol, f"{arch} {fmt} layer {i} {name}")
    for n in range(1, K + 2):
        jc = Jlm.commit_verified_cache(jcache, jver, jnp.int32(n), K + 1, je.cfg)
        with torch.inference_mode():
            tc = Tlm.commit_verified_cache(tcache, ver, torch.tensor(n, dtype=torch.int32),
                                           K + 1, cfg)
        assert tc["pos"].dtype == torch.int32 and int(tc["pos"]) == int(jc["pos"]) == 9 + n
        np.testing.assert_allclose(tc["rope"].sin.numpy(), np.asarray(jc["rope"].sin),
                                   atol=1e-6)
        for i, (tl, jlay) in enumerate(zip(tc["blocks"], _jax_layers(jc, n_layers))):
            for name, leaf in tl.items():
                _close(_decoded(leaf), _jdecoded(jlay[name]), tol,
                       f"{arch} {fmt} n_accept {n} layer {i} {name}")
        # One decode step from the committed cache, on both sides.
        nxt = block[:, min(n, K)]
        jlogits, _ = je.decode_step(jnp.asarray(nxt[:, None], jnp.int32), jc)
        with torch.inference_mode():
            got, _ = Tlm.forward_decode(te.model, torch.from_numpy(nxt)[:, None],
                                        _clone(tc), cfg, te.hsa)
        _close(got, jlogits, tol, f"{arch} {fmt} decode after n_accept {n}")


def test_rollback_restores_exact_state_after_full_rejection():
    """The reference's case on retnet: drafts chosen to miss the argmax, the
    block fully rejected (n_accept 1), and the next decode step from the
    committed cache matches two plain decode steps."""
    _, te = engines("retnet-1.3b")
    cfg = te.cfg
    p = torch.tensor(prompts(cfg.vocab_size, (9,), seed=3))
    with torch.inference_mode():
        logits, cache = te.prefill(p, cache_len=9 + 8 + K)
        tok = logits.argmax(-1)
        ref_logits, ref_cache = te.decode_step(tok[:, None], _clone(cache))
        bad = (tok[:, None] + torch.tensor([[1, 2, 3]])) % cfg.vocab_size
        block = torch.cat([tok[:, None], bad], dim=1)
        la, _, ver = Tlm.forward_verify_chunk(te.model, block, _clone(cache), cfg, te.hsa)
        assert int(la[0, 0].argmax()) != int(bad[0, 0])          # really rejected
        committed = Tlm.commit_verified_cache(cache, ver, torch.tensor(1, dtype=torch.int32),
                                              K + 1, cfg)
        assert int(committed["pos"]) == int(cache["pos"]) + 1
        nxt = la[:, 0].argmax(-1)
        out_spec, _ = Tlm.forward_decode(te.model, nxt[:, None], committed, cfg, te.hsa)
        ref2, _ = te.decode_step(ref_logits.argmax(-1)[:, None], ref_cache)
    assert int(out_spec[0].argmax()) == int(ref2[0].argmax())
    torch.testing.assert_close(committed["blocks"][0]["s"], ref_cache["blocks"][0]["s"],
                               rtol=1e-5, atol=1e-5)


def test_commit_of_an_unported_family_names_a9():
    """Every family rolls back now (MoE since its slice, A9c): on reduced
    olmoe-1b-7b, fp weights and the f32 cache, the verify block (its MoE
    dispatch never drops), the commit at every ``n_accept`` (a MoE layer's
    cache rewinds its pointer, as a dense one's) and a decode step from
    each committed cache equal the reference's."""
    test_verify_and_commit_match_reference("olmoe-1b-7b", None, False)


# -- (4) greedy identity ----------------------------------------------------------


def _ref_prompts(vocab: int) -> list:
    """The reference test's periodic prompt and a seeded one of its length
    (one compile of the reference's loop serves both)."""
    return [np.asarray([[5, 9, 13] * 4]),
            np.random.default_rng(1).integers(1, vocab, (1, 12))]


@pytest.mark.parametrize("arch,fmt", CELLS, ids=CELL_IDS)
def test_greedy_speculative_matches_reference_and_the_plain_loop(arch, fmt):
    je, te = engines(arch)
    gen = GenerationConfig(max_new_tokens=14, cache_format=fmt)
    for p in _ref_prompts(te.cfg.vocab_size):
        want = je.generate(jnp.asarray(p, jnp.int32), JGen(max_new_tokens=14,
                                                           cache_format=fmt),
                           speculative=JSpecCfg(k=3))
        got = te.generate(torch.from_numpy(p), gen, speculative=SpeculativeConfig(k=3))
        plain = te.generate(torch.from_numpy(p), gen)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
        assert (got.verify_steps, got.accepted_drafts) == (want.verify_steps,
                                                           want.accepted_drafts)
        assert got.drafted == 3 * got.verify_steps and got.decode_steps == got.verify_steps
        assert torch.equal(got.tokens, plain.tokens)


def test_greedy_identity_batched_lockstep():
    """Rows of different acceptance advance in lockstep (the commit depth is
    the least over live rows) and reproduce the plain loop and the
    reference's speculative loop."""
    je, te = engines("qwen3-8b")
    p = np.concatenate([np.asarray([[5, 9, 13] * 3]),
                        np.random.default_rng(9).integers(1, te.cfg.vocab_size, (1, 9))])
    gen = GenerationConfig(max_new_tokens=12)
    got = te.generate(torch.from_numpy(p), gen, speculative=SpeculativeConfig(k=3))
    assert torch.equal(got.tokens, te.generate(torch.from_numpy(p), gen).tokens)
    want = je.generate(jnp.asarray(p, jnp.int32), JGen(max_new_tokens=12),
                       speculative=JSpecCfg(k=3))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert got.verify_steps == want.verify_steps


def test_stop_token_inside_accepted_block():
    """A stop token mid-block ends the row there: later block tokens become
    pad and the length counts the stop token."""
    _, te = engines("retnet-1.3b")
    p = torch.tensor(prompts(te.cfg.vocab_size, (5,), seed=4))
    free = te.generate(p, GenerationConfig(max_new_tokens=8))
    gen = GenerationConfig(max_new_tokens=8, stop_tokens=(int(free.tokens[0, 3]),),
                           pad_token_id=-1)
    base = te.generate(p, gen)
    spec = te.generate(p, gen, speculative=SpeculativeConfig(k=4))
    assert torch.equal(spec.tokens, base.tokens) and torch.equal(spec.lengths, base.lengths)
    assert int(spec.lengths[0]) == 4 and spec.tokens[0, 4:].eq(-1).all()


def test_mtp_drafter_requires_mtp_head():
    _, te = engines("retnet-1.3b")
    with pytest.raises(ValueError, match="MTP head"):
        te.generate(torch.tensor([[3, 4, 5, 6]]), GenerationConfig(max_new_tokens=2),
                    speculative=SpeculativeConfig(k=2, drafter="mtp"))


def test_mtp_drafter_on_the_ds3_cut_names_a9():
    """The ds3 cut carries its MTP head (an MoE block over MLA): greedy
    speculative decode with the MTP drafter gives the reference's tokens,
    verify steps and accepted drafts, and the port's plain loop's tokens."""
    je, te = engines(DS3)
    assert te.cfg.mtp and isinstance(te.model.mtp.block, Tlm.MoEBlock)
    for p in _ref_prompts(te.cfg.vocab_size):
        want = je.generate(jnp.asarray(p, jnp.int32), JGen(max_new_tokens=8),
                           speculative=JSpecCfg(k=2, drafter="mtp"))
        got = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=8),
                          speculative=SpeculativeConfig(k=2, drafter="mtp"))
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        assert (got.verify_steps, got.accepted_drafts) == (want.verify_steps,
                                                           want.accepted_drafts)
        plain = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=8))
        assert torch.equal(got.tokens, plain.tokens)


def test_stochastic_speculative_is_deterministic_under_a_fixed_generator():
    """Sampled speculative decode repeats with the generator's seed and
    differs with another seed."""
    _, te = engines("retnet-1.3b")
    gen = GenerationConfig(max_new_tokens=10,
                           sampling=SamplingParams(temperature=0.9, top_k=50),
                           speculative=SpeculativeConfig(k=3))
    p = torch.tensor(prompts(te.cfg.vocab_size, (5,), seed=5))
    runs = [te.generate(p, gen, generator=torch.Generator().manual_seed(s)).tokens
            for s in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


# -- (5) the scheduler -----------------------------------------------------------------

SCHED_PROMPTS = {0: [2, 3, 4, 2, 3, 4, 2, 3], 1: [5, 6, 7, 8], 2: [9, 10, 11]}


def _engine_tokens(te, p, n: int, fmt) -> list:
    """The engine's greedy tokens for one request: `generate` on an f32
    cache; on an encoded one the scheduler's own admission (a chunked prefill
    that appends encoded rows, then `resume_generate`)."""
    prompt = torch.tensor([p])
    if fmt is None:
        return te.generate(prompt, GenerationConfig(max_new_tokens=n)).tokens[0].tolist()
    logits, cache = te.prefill_chunked(prompt, cache_len=32, chunk_size=8, cache_dtype=fmt)
    res = te.resume_generate(logits.argmax(-1), cache, GenerationConfig(max_new_tokens=n))
    return res.tokens[0].tolist()


@pytest.mark.parametrize("arch,fmt", CELLS, ids=CELL_IDS)
def test_scheduler_speculative_matches_the_engine(arch, fmt):
    """Per-lane speculative lanes reproduce each request's own engine run,
    stream the same tokens, and report per-request acceptance."""
    _, te = engines(arch)
    gen = GenerationConfig(max_new_tokens=6, speculative=SpeculativeConfig(k=3),
                           cache_format=fmt)
    sched = RequestScheduler(te, n_slots=2, cache_len=32, gen=gen, chunk_size=8)
    streamed = []
    sched.on_token = lambda uid, tok: streamed.append((uid, tok))
    for uid, p in SCHED_PROMPTS.items():
        sched.submit(Request(uid=uid, prompt=p))
    res = sched.run()
    for uid, p in SCHED_PROMPTS.items():
        want = _engine_tokens(te, p, 6, fmt)
        assert res[uid].tokens == want, f"{arch} {fmt} uid {uid}"
        assert [t for u, t in streamed if u == uid] == want
        assert res[uid].verify_steps >= 1
        assert res[uid].tokens_per_step == 1 + res[uid].accepted_drafts / res[uid].verify_steps
    assert sched.stats["verify_steps"] == sum(r.verify_steps for r in res.values())
    assert sched.stats["accepted_drafts"] == sum(r.accepted_drafts for r in res.values())
    h = sched.obs.metrics.histogram("sched.tokens_per_verify_step")
    assert h.count == sched.stats["verify_steps"]


def test_scheduler_speculative_budget_truncates_block():
    _, te = engines("retnet-1.3b")
    gen = GenerationConfig(max_new_tokens=5, speculative=SpeculativeConfig(k=4))
    sched = RequestScheduler(te, n_slots=1, cache_len=32, gen=gen, chunk_size=8)
    sched.submit(Request(uid=0, prompt=[2, 3, 4]))
    res = sched.run()
    assert res[0].tokens == te.generate(torch.tensor([[2, 3, 4]]),
                                        GenerationConfig(max_new_tokens=5)).tokens[0].tolist()


def test_scheduler_speculative_reserves_verify_overrun():
    """A request that fits without speculation but not with its k-slot
    verify overrun is refused at submission."""
    _, te = engines("retnet-1.3b")
    gen = GenerationConfig(max_new_tokens=4, speculative=SpeculativeConfig(k=4))
    sched = RequestScheduler(te, n_slots=1, cache_len=16, gen=gen, chunk_size=8)
    with pytest.raises(ValueError, match="exceeds every pool class"):
        sched.submit(Request(uid=0, prompt=list(range(2, 12))))    # 10 + 4 + 4 > 16


def test_scheduler_rejects_mtp_drafter():
    _, te = engines("retnet-1.3b")
    gen = GenerationConfig(max_new_tokens=4,
                           speculative=SpeculativeConfig(k=2, drafter="mtp"))
    with pytest.raises(ValueError, match="ngram"):
        RequestScheduler(te, n_slots=1, cache_len=32, gen=gen)


LANE_LENS, LANE_C = (3, 9, 14), 24


def _lane_store(te, fmt, lens=LANE_LENS):
    """A per-lane class store whose lanes hold chunked prefills of prompts of
    ``lens`` tokens (lane b at position lens[b]), each lane's batch-1 cache,
    and each prompt's greedy next token."""
    pool = CachePool(te.cfg, len(lens), LANE_C, dtype=fmt or torch.float32, device="cpu")
    lanes, toks = [], []
    for p in prompts(te.cfg.vocab_size, lens, seed=31):
        logits, cache = te.prefill_chunked(torch.tensor([p]), cache_len=LANE_C, chunk_size=8,
                                           cache_dtype=fmt or torch.float32)
        pool.write(pool.acquire(LANE_C), cache)
        lanes.append(cache)
        toks.append(int(logits.argmax()))
    return pool.store, lanes, toks


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", "int8_tok"),
                                      (DS3, None)], ids=["retnet", "qwen3-int8_tok", "ds3_cut"])
def test_per_lane_verify_block_matches_lane_by_lane(arch, fmt):
    """One verify block over a class store whose 3 lanes sit at 3 positions
    (a ``[B]`` position: per-lane masks, RoPE tables and row writes) against
    each lane's batch-1 block at its scalar position: the same argmax, values
    within 1e-6, and the same committed positions and rows."""
    _, te = engines(arch)
    with torch.inference_mode():
        store, lanes, toks = _lane_store(te, fmt)
        rng = np.random.default_rng(32)
        block = torch.cat([torch.tensor(toks)[:, None],
                           torch.from_numpy(rng.integers(1, te.cfg.vocab_size, (3, K)))], 1)
        logits, _, ver = Tlm.forward_verify_chunk(te.model, block, _clone(store), te.cfg,
                                                  te.hsa)
        n_acc = torch.tensor([1, K + 1, 2])
        committed = Tlm.commit_verified_cache(store, ver, n_acc, K + 1, te.cfg)
        for b, cache in enumerate(lanes):
            lg, _, v1 = Tlm.forward_verify_chunk(te.model, block[b:b + 1], _clone(cache),
                                                 te.cfg, te.hsa)
            assert torch.equal(logits[b].argmax(-1), lg[0].argmax(-1)), f"lane {b}"
            torch.testing.assert_close(logits[b], lg[0], rtol=1e-6, atol=1e-6)
            c1 = Tlm.commit_verified_cache(cache, v1, n_acc[b].to(torch.int32), K + 1, te.cfg)
            assert int(committed["pos"][b]) == int(c1["pos"]) == LANE_LENS[b] + int(n_acc[b])
            for (path, got), (_, want) in zip(tree_items(committed["blocks"]),
                                              tree_items(c1["blocks"])):
                torch.testing.assert_close(got[b:b + 1].float(), want.float(), rtol=1e-6,
                                           atol=1e-6, msg=f"lane {b} {path}")


@pytest.mark.parametrize("arch", ["retnet-1.3b", "qwen3-8b", DS3],
                         ids=["retnet", "qwen3", "ds3_cut"])
def test_lane_isolation_on_deployed_weights(arch):
    """The speculative class step on deployed weights (each lane's own W8A8
    activation scale): lane 0's block, commit count, next token, history and
    store rows are bit-identical whether lane 1 holds another request or the
    garbage of a free lane."""
    _, te = deployed(arch)
    gen = GenerationConfig(max_new_tokens=8, speculative=SpeculativeConfig(k=K))
    outs = []
    with torch.inference_mode():
        for other in ("request", "garbage"):
            store, lanes, toks = _lane_store(te, None, lens=(9, 14))
            step = SpecClassStep(te, store, gen, LANE_C)
            step.tok.copy_(torch.tensor(toks))
            step.hist[:, :14] = torch.from_numpy(
                np.random.default_rng(33).integers(1, 9, (2, 14)))
            step.hist_len.copy_(torch.tensor([9, 14]))
            if other == "garbage":
                for _, t in tree_items(store):
                    t[1:] = (torch.randn_like(t[1:]) * 7 if t.dtype.is_floating_point
                             else torch.randint_like(t[1:], -50, 50))
                step.tok[1], step.hist_len[1] = 3, 10 ** 6
                step.hist[1].random_(0, 5)
            step.body()
            outs.append((step.result[0].clone(), step.tok[0].clone(), step.hist[0].clone(),
                         [t[0].clone() for _, t in tree_items(store)]))
    (r0, t0, h0, s0), (r1, t1, h1, s1) = outs
    assert torch.equal(r0, r1) and torch.equal(t0, t1) and torch.equal(h0, h1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    assert 1 <= int(r0[-1]) <= K + 1


# -- (6) composition --------------------------------------------------------------


def _shared_prompts(vocab: int, n_ext=3, shared=16, ext=8) -> list:
    base = prompts(vocab, (shared,), seed=3)[0]
    return [base] + [base + prompts(vocab, (ext,), seed=10 + i)[0] for i in range(n_ext)]


@pytest.mark.parametrize("arch", ["retnet-1.3b", "qwen3-8b", DS3],
                         ids=["retnet", "qwen3", "ds3_cut"])
def test_prefix_warm_vs_cold_identity_speculative(arch):
    """Prefix adoption composes with the scheduler's speculative mode: warm
    tokens equal cold ones, and the prefix index is really hit."""
    _, te = engines(arch)
    gen = GenerationConfig(max_new_tokens=6, speculative=SpeculativeConfig(k=2))
    reqs = _shared_prompts(te.cfg.vocab_size)
    out = {}
    for warm in (False, True):
        sched = RequestScheduler(te, n_slots=2, cache_len=48, gen=gen, chunk_size=8,
                                 prefix_cache=warm)
        for uid, p in enumerate(reqs):
            sched.submit(Request(uid=uid, prompt=p))
        out[warm] = {u: f.tokens for u, f in sched.run().items()}
    assert out[True] == out[False]
    assert sched.pool.prefix.stats["prefix_hits"] >= 2


def test_preemption_carries_the_draft_history():
    """A preempted speculative lane's draft history, pending token and
    counts survive the host round trip: tokens identical to the unpreempted
    drain, and acceptance keeps accumulating across the spill."""
    _, te = engines("retnet-1.3b")
    k = 2
    gen = GenerationConfig(max_new_tokens=6, speculative=SpeculativeConfig(k=k))
    (p1,) = prompts(te.cfg.vocab_size, (8,), seed=22)
    runs = {}
    for preempt in (False, True):
        sched = RequestScheduler(te, classes=[(1, 8 + 6 + k)], gen=gen, chunk_size=8,
                                 host_spill=preempt)
        sched.submit(Request(uid=0, prompt=[2, 3, 4, 2, 3, 4, 2, 3]))
        if preempt:
            while not sched._active:
                sched.step()
            sched.step()
            sched.submit(Request(uid=1, prompt=p1), priority=5)
        else:
            sched.submit(Request(uid=1, prompt=p1))
        res = sched.run()
        runs[preempt] = ({u: r.tokens for u, r in res.items()}, res, sched)
    assert runs[True][0] == runs[False][0]
    assert runs[True][2].stats["preempted"] >= 1
    for u in (0, 1):
        assert runs[True][1][u].verify_steps == runs[False][1][u].verify_steps
        assert runs[True][1][u].accepted_drafts == runs[False][1][u].accepted_drafts
