"""deepseek-v3's MTP drafter through repro_torch against the JAX package.

On the CPU, on reduced deepseek-v3 (3 dense MLA layers, 2 MoE layers with
the shared expert, and the MTP head: ``proj`` and an MoE block over MLA),
the JAX engines' weights carried over by `repro_torch.bridge`, fp and the
default W8A8 / MXINT4 deployment:

* the bridge consumes every leaf of the reference tree, the ``mtp`` subtree
  included, and the port holds nothing else;
* `lm.mtp_decode_step`: logits and the head's hidden against the
  reference's at 1e-5 of max|reference| on fp weights and at `QUANT_REL` on
  deployed ones (the port's MoE decode tolerance), also with 6 rows that
  all take the same experts, so the head's dispatch drops assignments as
  the reference's does; the prefill's ``return_hidden`` (exact and
  bucketed) against the reference's;
* `MTPDrafter`: k drafts from the same ``(h, tok)`` equal the reference
  drafter's, and ``observe`` takes the hidden at the acceptance boundary;
* greedy `generate(speculative=SpeculativeConfig(k, drafter="mtp"))`: on fp
  weights the reference's tokens, lengths, verify steps and accepted drafts
  and the port's plain loop's tokens, in the f32 and ``int8_tok`` caches;
  on deployed weights the reference's tokens and counts, or, where the two
  part, the same tokens, blocks and acceptances up to the verify step where
  they part, which must fall on a near tie of the reference's logits (a
  top-two margin under `QUANT_REL` of max|logit|, ROADMAP C: the B 2
  prompt's second token parts so on some hosts, whose f32 summation order
  differs);
* `make_drafter` builds the MTP drafter only with a head, and the scheduler
  refuses it (the reference's rule: it needs per-lane hidden state).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import DS, engines
from test_torch_retnet import QUANT_REL

from repro.models import lm as Jlm
from repro.serving import GenerationConfig as JGen
from repro.serving import SpeculativeConfig as JSpecCfg
from repro.serving.speculative import MTPDrafter as JMTPDrafter
from repro_torch import bridge, configs as Tconfigs
from repro_torch.models import lm as Tlm
from repro_torch.models import mlp as TM
from repro_torch.serving import (GenerationConfig, MTPDrafter, NgramDrafter, RequestScheduler,
                                 SpeculativeConfig, make_drafter)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

FP_TOL = 1e-5
K = 3
QUANT = [False, True]
QUANT_IDS = ["fp", "deployed"]


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    """max|got - want| within ``tol`` of max|want|."""
    want = np.asarray(want, dtype=np.float32)
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: {err:.3e}"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=None)
def _step(quantize: bool):
    """The reference's `mtp_decode_step` on its engine's weights, jitted."""
    je, _ = engines(DS, quantize)
    return jax.jit(lambda h, t: Jlm.mtp_decode_step(je.params, h, t, je.cfg, je.hsa))


def _inputs(b: int, seed: int, same: bool = False):
    """(h [B, D] f32, tok [B]): seeded; ``same`` gives every row one h and
    one token, so every row takes the same experts."""
    rng = np.random.default_rng(seed)
    d = engines(DS, False)[1].cfg.d_model
    h = rng.normal(size=(1 if same else b, d)).astype(np.float32)
    tok = rng.integers(1, 512, 1 if same else b)
    if same:
        h, tok = np.repeat(h, b, axis=0), np.repeat(tok, b)
    return h, tok.astype(np.int32)


# -- the bridge ---------------------------------------------------------------------


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_bridge_consumes_every_leaf_with_the_mtp_head(quantize):
    """Every leaf of the reference tree, the MTP head's included, lands value
    for value in the port's tensor of that name (a deployed W8A8 weight in
    the corner of its K-major buffer, a bias in the head of its padding),
    and the port holds no other tensor."""
    je, te = engines(DS, quantize)
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    port = {**dict(te.model.named_parameters()), **dict(te.model.named_buffers())}
    assert set(tree) == {"embed", "dense_head", "blocks", "final_norm", "lm_head", "mtp"}
    assert isinstance(te.model.mtp, Tlm.MTPHead)
    assert isinstance(te.model.mtp.block, Tlm.MoEBlock)
    seen, offset = set(), 0
    named = []
    for gname, count, _ in Tlm.layer_groups(te.cfg):
        for name, leaf in _leaves(tree[gname]):
            named += [(f"blocks.{offset + i}.{name}", leaf[i]) for i in range(count)]
        offset += count
    for top in ("embed", "final_norm", "lm_head", "mtp"):
        named += list(_leaves(tree[top], top))
    for name, leaf in named:
        name = name.replace("_mx.packed", "_packed").replace("_mx.exps", "_exps")
        got, want = port[name], bridge.to_tensor(leaf)
        if name.endswith("w8_vals"):
            got = got[:want.shape[0], :want.shape[1]]
        elif name.endswith(".b"):
            got = got[:want.shape[0]]
        assert got.dtype == want.dtype and torch.equal(got, want), name
        seen.add(name)
    assert seen == set(port)
    assert any(n.startswith("mtp.block.moe.experts.") for n in seen)


# -- mtp_decode_step -------------------------------------------------------------------


@pytest.mark.parametrize("b,same", [(2, False), (5, False), (6, True)],
                         ids=["b2", "b5", "b6-one-route"])
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_mtp_decode_step_matches_reference(quantize, b, same):
    je, te = engines(DS, quantize)
    h, tok = _inputs(b, 40 + b, same)
    want_logits, want_h = _step(quantize)(jnp.asarray(h), jnp.asarray(tok))
    calls, orig = [], TM.dispatch

    def spy(idx, e, cap):
        calls.append((orig(idx, e, cap), cap))
        return calls[-1][0]

    TM.dispatch = spy
    try:
        with torch.inference_mode():
            logits, hx = Tlm.mtp_decode_step(te.model, torch.from_numpy(h),
                                             torch.from_numpy(tok).long(), te.cfg, te.hsa)
    finally:
        TM.dispatch = orig
    assert logits.shape == (b, te.cfg.padded_vocab) and hx.shape == (b, te.cfg.d_model)
    assert logits.dtype == hx.dtype == torch.float32
    tol = QUANT_REL if quantize else FP_TOL
    _close(logits, want_logits, tol, "logits")
    _close(hx, want_h, tol, "hidden")
    (pos, cap), = calls                   # one dispatch of the B rows together
    assert pos.shape == (1, b, te.cfg.top_k) and cap == TM.capacity(b, te.cfg)
    if same:                  # b rows on the same top_k experts, cap slots each
        assert int((pos == cap).sum()) == te.cfg.top_k * (b - cap) > 0


@pytest.mark.parametrize("bucket", [False, True], ids=["exact", "bucketed"])
def test_prefill_returns_the_last_real_tokens_hidden(bucket):
    """``return_hidden``: the pre-final-norm hidden of the last real token,
    as the reference's prefill returns it (a 13-token prompt; bucketed, in
    a 16-token bucket, against the reference's bucketed prefill: the padding
    shares the MoE dispatch)."""
    je, te = engines(DS, False)
    p = np.random.default_rng(3).integers(1, 512, (2, 13)).astype(np.int32)
    _, _, want = je.prefill(jnp.asarray(p), cache_len=20, bucket=bucket, return_hidden=True)
    with torch.inference_mode():
        logits, cache, got = te.prefill(torch.from_numpy(p), cache_len=20, bucket=bucket,
                                        return_hidden=True)
    assert got.shape == (2, te.cfg.d_model) and int(cache["pos"]) == 13
    _close(got, want, FP_TOL, "hidden")


# -- the drafter -------------------------------------------------------------------


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_mtp_drafts_match_the_reference_drafter(quantize):
    """k = 4 chained head steps from the same (h, tok): the same drafts;
    then ``observe`` takes each lane's hidden at the acceptance boundary."""
    je, te = engines(DS, quantize)
    h, tok = _inputs(3, 7)
    jd = JMTPDrafter(k=4, cfg=je.cfg, hsa=je.hsa)
    want = jax.jit(lambda h, t: jd.draft(je.params, {"h": h}, t))(jnp.asarray(h),
                                                                  jnp.asarray(tok))
    drafter = make_drafter(SpeculativeConfig(k=4, drafter="mtp"), te.cfg, te.hsa)
    assert isinstance(drafter, MTPDrafter)
    with torch.inference_mode():
        state = drafter.init(None, None, torch.from_numpy(h).clone())
        got = drafter.draft(te.model, state, torch.from_numpy(tok).long())
        assert got.dtype == torch.int64 and got.shape == (3, 4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        hidden_all = torch.randn(3, 5, te.cfg.d_model, generator=torch.Generator().manual_seed(1))
        for n in (1, 3, 5):
            drafter.observe(state, None, torch.tensor(n), hidden_all, None)
            assert torch.equal(state["h"], hidden_all[:, n - 1])
        drafter.observe(state, None, torch.tensor([2, 5, 1]), hidden_all, None)
        assert torch.equal(state["h"], hidden_all[torch.arange(3), torch.tensor([1, 4, 0])])


def test_make_drafter_needs_an_mtp_head_and_the_scheduler_refuses_it():
    _, te = engines(DS, False)
    ngram = make_drafter(SpeculativeConfig(k=2), te.cfg, te.hsa)
    assert isinstance(ngram, NgramDrafter) and ngram.k == 2
    no_head = Tconfigs.get_config("qwen3-8b").reduced()
    with pytest.raises(ValueError, match="MTP head"):
        make_drafter(SpeculativeConfig(k=2, drafter="mtp"), no_head, te.hsa)
    gen = GenerationConfig(max_new_tokens=4, speculative=SpeculativeConfig(k=2, drafter="mtp"))
    with pytest.raises(ValueError, match="ngram"):
        RequestScheduler(te, n_slots=1, cache_len=32, gen=gen)


# -- greedy speculative decode ----------------------------------------------------------

GREEDY = [(False, None), (False, "int8_tok"), (True, None)]


def _prompts(vocab: int) -> list:
    """A periodic prompt and a seeded one, 12 tokens each, one row each."""
    return [np.asarray([[5, 9, 13] * 4], np.int32),
            np.random.default_rng(2).integers(1, vocab, (1, 12)).astype(np.int32)]


@pytest.mark.parametrize("quantize,fmt", GREEDY, ids=["fp-f32", "fp-int8_tok", "deployed-f32"])
def test_greedy_mtp_speculative_matches_reference_and_the_plain_loop(quantize, fmt):
    je, te = engines(DS, quantize)
    gen = GenerationConfig(max_new_tokens=10, cache_format=fmt)
    both = [*_prompts(te.cfg.vocab_size),
            np.concatenate(_prompts(te.cfg.vocab_size))]       # B 2: lockstep
    for p in both:
        want = je.generate(jnp.asarray(p), JGen(max_new_tokens=10, cache_format=fmt),
                           speculative=JSpecCfg(k=K, drafter="mtp"))
        got = te.generate(torch.from_numpy(p), gen,
                          speculative=SpeculativeConfig(k=K, drafter="mtp"))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
        assert got.drafted == K * got.verify_steps
        if quantize and not np.array_equal(got.tokens.numpy(), np.asarray(want.tokens)):
            _parts_at_a_near_tie(je, te, p, fmt, got, want)
            continue
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        assert (got.verify_steps, got.accepted_drafts) == (want.verify_steps,
                                                           want.accepted_drafts)
        if not quantize:
            plain = te.generate(torch.from_numpy(p), gen)
            assert torch.equal(got.tokens, plain.tokens)


def _spec_steps(draft, verify, commit, logits, cache, h, n: int) -> list:
    """The greedy lockstep speculative loop one verify step at a time (numpy
    in and out): per step the block, the target's logits at every block
    position, each row's acceptance and the tokens it emitted."""
    tok, steps, emitted = np.argmax(logits, -1), [], 0
    while emitted < n:
        block = np.concatenate([tok[:, None], draft(h, tok)], axis=1)
        lg, hidden, ver = verify(block, cache)
        cand = np.argmax(lg, -1)
        acc = np.cumprod(cand[:, :K] == block[:, 1:], axis=1).sum(axis=1)
        a = int(acc.min())
        cache = commit(cache, ver, a + 1)
        steps.append(dict(block=block, logits=lg, acc=acc, emit=block[:, :a + 1]))
        emitted += a + 1
        tok, h = cand[:, a], hidden[:, a]
    return steps


def _parts_at_a_near_tie(je, te, p, fmt, got, want) -> None:
    """The port's and the reference's speculative streams, replayed a verify
    step at a time (each replay reproduces its engine's tokens): up to the
    step where their emitted tokens part, the same blocks, acceptances and
    tokens, and there the reference's top-two margin, at the block position
    whose target token parts, under `QUANT_REL` of max|logit|."""
    n, cache_len = got.tokens.shape[1], p.shape[1] + got.tokens.shape[1] + K
    gen, jgen = GenerationConfig(cache_format=fmt), JGen(cache_format=fmt)
    jd = JMTPDrafter(k=K, cfg=je.cfg, hsa=je.hsa)
    jdraft = jax.jit(lambda h, t: jd.draft(je.params, {"h": h}, t))
    jverify = jax.jit(lambda b, c: Jlm.forward_verify_chunk(je.params, {"tokens": b}, c,
                                                            je.cfg, je.hsa))
    jl, jc, jh = je.prefill(jnp.asarray(p), cache_len=cache_len, return_hidden=True)
    jsteps = _spec_steps(
        lambda h, t: np.asarray(jdraft(h, jnp.asarray(t, jnp.int32))),
        lambda b, c: (lambda lg, hid, ver: (np.asarray(lg, np.float32), hid, ver))(
            *jverify(jnp.asarray(b, jnp.int32), c)),
        lambda c, ver, m: Jlm.commit_verified_cache(c, ver, jnp.int32(m), K + 1, je.cfg),
        np.asarray(jl, np.float32), je._encode_cache(jc, jgen), jh, n)
    td = make_drafter(SpeculativeConfig(k=K, drafter="mtp"), te.cfg, te.hsa)
    with torch.inference_mode():
        tl, tc, th = te.prefill(torch.from_numpy(p), cache_len=cache_len, return_hidden=True)
        tsteps = _spec_steps(
            lambda h, t: td.draft(te.model, {"h": h}, torch.from_numpy(t)).numpy(),
            lambda b, c: (lambda lg, hid, ver: (lg.float().numpy(), hid, ver))(
                *Tlm.forward_verify_chunk(te.model, torch.from_numpy(b), c, te.cfg, te.hsa)),
            lambda c, ver, m: Tlm.commit_verified_cache(c, ver, torch.tensor(m, dtype=torch.int32),
                                                        K + 1, te.cfg),
            tl.float().numpy(), te._encode_cache(tc, gen), th, n)
    for steps, res in ((jsteps, want), (tsteps, got)):
        emitted = np.concatenate([s["emit"] for s in steps], axis=1)[:, :n]
        np.testing.assert_array_equal(emitted, np.asarray(res.tokens))
        assert (len(steps), sum(s["emit"].shape[1] - 1 for s in steps)) == (
            res.verify_steps, res.accepted_drafts)
    # Emitted column c is the argmax of the logits at ``src[c]``: the
    # prefill's (None) for the first, then per step i, block positions
    # 0 .. a_i (the accepted drafts equal the target's samples before them;
    # the last is the next step's pending token).
    src = [None] + [(i, j) for i, st in enumerate(jsteps)
                    for j in range(st["emit"].shape[1])]
    col = int(np.flatnonzero((got.tokens.numpy() != np.asarray(want.tokens)).any(axis=0))[0])
    if src[col] is None:
        step, at, logits = 0, -1, np.asarray(jl, np.float32)
    else:
        step, at = src[col]
        logits = jsteps[step]["logits"][:, at]
    for j, t in zip(jsteps[:step], tsteps):             # before the parting: one stream
        np.testing.assert_array_equal(t["block"], j["block"])
        np.testing.assert_array_equal(t["acc"], j["acc"])
    if at >= 0:
        np.testing.assert_array_equal(tsteps[step]["block"][:, :at + 1],
                                      jsteps[step]["block"][:, :at + 1])
    for lane in np.flatnonzero(got.tokens.numpy()[:, col] != np.asarray(want.tokens)[:, col]):
        top2 = np.sort(logits[lane])[-2:]
        margin = float((top2[1] - top2[0]) / np.abs(logits[lane]).max())
        assert margin < QUANT_REL, (lane, col, margin)
