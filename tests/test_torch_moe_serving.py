"""The routed MoE through every serving path of repro_torch, against the JAX
package: reduced olmoe-1b-7b and reduced deepseek-v3 with its MoE layers, on
the CPU, fp weights carried over by `repro_torch.bridge`.

* the admission paths: bucketed prefill (the zero padding routes and takes
  expert capacity, as in the reference), chunked prefill (each chunk its own
  dispatch) against the reference's chunk by chunk, and `resume_generate`
  from a chunked cache against the reference's greedy continuation;
  chunked against monolithic is not asserted (the reference excludes MoE
  from that identity: capacity drops are per dispatch);
* the `RequestScheduler` against the reference's scheduler, and on a config
  whose batched B 2 dispatch drops (capacity factor 0.5) the class step's
  per-lane dispatch, which the reference's per-slot ``vmap`` gives;
* the shared-prefix cache in paged mode: an MoE hit floored to the chunk
  size (the port's `test_moe_adoption_is_chunk_aligned`), warm tokens equal
  cold ones and the reference's;
* speculative decode with the ngram drafter at B 1: the plain loop's tokens
  and the reference's (verify dispatches never drop), and the speculative
  scheduler against the reference's;
* the serve CLI's ``--arch olmoe-1b-7b`` in every mode.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import greedy_continue, prompt_list
from test_torch_moe import DS, NEW, OL, _close, _tight, engines

from repro.serving import GenerationConfig as JGen
from repro.serving import Request as JRequest
from repro.serving import RequestScheduler as JScheduler
from repro.serving import SpeculativeConfig as JSpecCfg
from repro_torch.serving import Request, RequestScheduler
from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS, ARCH_IDS = [OL, DS], ["olmoe", "ds3"]
FP_TOL = 1e-4


def _prompts(s: int, seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(np.int32)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_layer(jcache: dict, i: int, first: int) -> dict:
    """Layer ``i`` of the reference's cache (its dense head, then blocks)."""
    group, j = ("dense_head", i) if i < first else ("blocks", i - first)
    out = {}
    for path, leaf in _leaves(jcache[group]):
        out[path] = np.asarray(leaf[j])
    return out


def _same_cache(tc: dict, jc: dict, cfg, what: str) -> None:
    assert int(tc["pos"]) == int(jc["pos"])
    for i, blk in enumerate(tc["blocks"]):
        want = _jax_layer(jc, i, cfg.first_dense_layers)
        for path, leaf in _leaves(blk):
            _close(leaf.numpy(), want[path], FP_TOL, f"{what} layer {i} {path}")


# -- admission paths ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_bucketed_prefill_matches_reference(arch):
    """13 -> 16: the three padding tokens take expert slots in the prefill's
    one dispatch, in the port as in the reference."""
    je, te = engines(arch)
    prompts = _prompts(13, 4)
    lj, cj = je.prefill(jnp.asarray(prompts), cache_len=13 + NEW, bucket=True)
    lt, ct = te.prefill(torch.from_numpy(prompts), cache_len=13 + NEW, bucket=True)
    _close(lt.numpy(), lj, FP_TOL, "logits")
    _same_cache(ct, cj, te.cfg, "bucketed")


@pytest.mark.parametrize("arch,s,chunk", [(OL, 37, 8), (DS, 21, 8)], ids=ARCH_IDS)
def test_chunked_prefill_and_resume_match_reference(arch, s, chunk):
    """Chunk by chunk (each its own dispatch) against the reference's
    `prefill_chunked`: logits and the final cache; then `resume_generate`
    from the chunked cache gives the reference's greedy continuation from
    its own."""
    je, te = engines(arch)
    prompts = _prompts(s, 5, b=1)
    lj, cj = je.prefill_chunked(jnp.asarray(prompts), cache_len=s + NEW, chunk_size=chunk)
    lt, ct = te.prefill_chunked(torch.from_numpy(prompts), cache_len=s + NEW,
                                chunk_size=chunk)
    _close(lt.numpy(), lj, FP_TOL, "logits")
    _same_cache(ct, cj, te.cfg, "chunked")
    want = greedy_continue(je, lj, cj, NEW)
    res = te.resume_generate(lt.argmax(-1), ct, GenerationConfig(max_new_tokens=NEW))
    assert res.tokens[0].tolist() == want


# -- scheduler and prefix cache ------------------------------------------------------------


CLASSES, CHUNK = [(2, 24), (2, 40)], 8
LENS = [5, 13, 9, 30, 3, 16]


def _requests(vocab: int) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, n).tolist() for n in LENS]


def _both(je, te, reqs, gen: JGen, port_gen: GenerationConfig, **kw):
    ref = JScheduler(je, gen=gen, **kw)
    port = RequestScheduler(te, gen=port_gen, **kw)
    for uid, p in enumerate(reqs):
        ref.submit(JRequest(uid=uid, prompt=p))
        port.submit(Request(uid=uid, prompt=p))
    return ({u: f.tokens for u, f in port.run().items()},
            {u: f.tokens for u, f in ref.run().items()}, port, ref)


@pytest.mark.parametrize("arch,fmt", [(OL, None), (OL, "int8_tok"), (DS, None)],
                         ids=["olmoe-f32", "olmoe-int8_tok", "ds3-f32"])
def test_scheduler_matches_the_reference_scheduler(arch, fmt):
    """Six mixed-length requests through two slot classes, chunks of 8,
    greedy: the reference scheduler's tokens."""
    je, te = engines(arch)
    got, want, _, _ = _both(je, te, _requests(te.cfg.vocab_size),
                            JGen(max_new_tokens=NEW, cache_format=fmt),
                            GenerationConfig(max_new_tokens=NEW, cache_format=fmt),
                            classes=CLASSES, chunk_size=CHUNK)
    assert got == want


def test_class_step_dispatches_each_lane_alone():
    """Capacity factor 0.5: a batched B 2 decode dispatch has one slot per
    expert, a lane alone never drops.  The class step dispatches per lane
    (the reference vmaps one slot at a time), so the drain gives the
    reference scheduler's tokens, and each request alone its tokens beside
    a co-tenant."""
    je, te = _tight()
    reqs = _requests(te.cfg.vocab_size)[:4]
    gen = GenerationConfig(max_new_tokens=NEW)
    got, want, _, _ = _both(je, te, reqs, JGen(max_new_tokens=NEW), gen,
                            classes=[(2, 40)], chunk_size=CHUNK)
    assert got == want
    for uid in range(2):
        alone = RequestScheduler(te, classes=[(1, 40)], gen=gen, chunk_size=CHUNK)
        alone.submit(Request(uid=uid, prompt=reqs[uid]))
        assert alone.run()[uid].tokens == got[uid], f"uid {uid}"


def test_moe_adoption_is_chunk_aligned():
    """The reference's case: a 13-token donor, then the donor plus 8 tokens,
    page size 4, chunks of 8, cold and warm, through both schedulers.  An
    MoE hit floors to the chunk size: the 13-token shared prefix adopts 8
    tokens (paged mode), and the warm tokens equal the cold ones and the
    reference's, with the reference's counters."""
    je, te = engines(OL)
    donor = prompt_list(je, 13, seed=3)
    query = donor + prompt_list(je, 8, seed=11)
    kw = dict(n_slots=2, cache_len=48, chunk_size=8)
    cold, cold_ref, _, _ = _both(je, te, [donor, query], JGen(max_new_tokens=6),
                                 GenerationConfig(max_new_tokens=6), prefix_cache=False, **kw)
    warm, warm_ref, sched, ref = _both(je, te, [donor, query], JGen(max_new_tokens=6),
                                       GenerationConfig(max_new_tokens=6), prefix_cache=True,
                                       prefix_page_size=4, **kw)
    pc = sched.pool.prefix
    assert pc.mode == "paged"
    assert pc.stats["prefix_hits"] == 1 and pc.stats["prefix_hit_tokens"] == 8
    assert warm == cold == cold_ref == warm_ref
    assert dict(pc.stats) == dict(ref.pool.prefix.stats)
    assert pc.leased_slots == 0


# -- speculative decode ---------------------------------------------------------------------


# (seed, n) of each arch's echo prompt: on random weights the model's
# continuation after P's repeat rarely follows its first one; these take
# some drafts.
ECHO = {OL: (2, 3), DS: (3, 3)}


@functools.lru_cache(maxsize=None)
def _echo_prompt(arch: str) -> tuple:
    """P (n tokens), the model's own 2n greedy tokens after P, then P again:
    the ngram drafter proposes what followed P."""
    _, te = engines(arch)
    seed, n = ECHO[arch]
    p = np.random.default_rng(seed).integers(1, 512, n)
    out = te.generate(torch.from_numpy(p[None]), GenerationConfig(max_new_tokens=2 * n))
    return tuple(np.concatenate([p, out.tokens[0].numpy(), p]).tolist())


@pytest.mark.parametrize("fmt", [None, "int8_tok"], ids=["f32", "int8_tok"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_speculative_equals_plain_and_reference(arch, fmt):
    """k 3, the ngram drafter, B 1, fp weights: the plain loop's greedy
    tokens (a verify dispatch never drops, a decode one at t = 1 never
    does) and the reference's speculative run with its verify steps and
    acceptance."""
    je, te = engines(arch)
    prompts = np.asarray([_echo_prompt(arch)], dtype=np.int32)
    gen = GenerationConfig(max_new_tokens=12, cache_format=fmt)
    plain = te.generate(torch.from_numpy(prompts), gen)
    got = te.generate(torch.from_numpy(prompts), gen, speculative=SpeculativeConfig(k=3))
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12, cache_format=fmt,
                                                  speculative=JSpecCfg(k=3)))
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert (got.verify_steps, got.accepted_drafts) == (want.verify_steps,
                                                       want.accepted_drafts)
    assert got.accepted_drafts > 0


def test_speculative_scheduler_matches_reference():
    """The scheduler in speculative mode (per-lane verify dispatches, per-lane
    acceptance) gives the reference speculative scheduler's tokens and
    acceptance, and the plain scheduler's tokens."""
    je, te = engines(OL)
    reqs = _requests(te.cfg.vocab_size)[:4] + [list(_echo_prompt(OL))]
    classes = [(2, 24 + 3), (2, 40 + 3)]
    spec = SpeculativeConfig(k=3)
    got, want, sched, ref = _both(je, te, reqs,
                                  JGen(max_new_tokens=NEW, speculative=JSpecCfg(k=3)),
                                  GenerationConfig(max_new_tokens=NEW, speculative=spec),
                                  classes=classes, chunk_size=CHUNK)
    assert got == want
    assert sched.stats["accepted_drafts"] == ref.stats["accepted_drafts"] > 0
    plain = RequestScheduler(te, classes=classes, chunk_size=CHUNK,
                             gen=GenerationConfig(max_new_tokens=NEW))
    for uid, p in enumerate(reqs):
        plain.submit(Request(uid=uid, prompt=p))
    assert {u: f.tokens for u, f in plain.run().items()} == got


# -- the serve CLI ---------------------------------------------------------------------------


CLI_MODES = {
    "generate": [],
    "top_p": ["--temperature", "1", "--top-p", "0.9"],
    "scheduler": ["--requests", "4", "--slots", "2", "--chunk-size", "8"],
    "host_spill": ["--requests", "4", "--host-spill", "--oversubscribe", "2"],
    "frontend": ["--frontend", "--virtual-clock", "--requests", "4"],
    "prefix": ["--requests", "4", "--slots", "2", "--chunk-size", "8", "--prefix-cache"],
    "speculative": ["--speculative", "--draft-k", "3"],
    "speculative_scheduler": ["--speculative", "--draft-k", "3", "--requests", "4"],
}


@pytest.mark.parametrize("mode", sorted(CLI_MODES))
def test_serve_cli_every_mode(mode, capsys):
    """``--arch olmoe-1b-7b`` in every mode of the serve CLI."""
    from repro_torch.launch import serve
    serve.main(["--arch", OL, "--reduced", "--device", "cpu", "--scale", "0.05",
                *CLI_MODES[mode]])
    out = capsys.readouterr().out
    assert "[serve]" in out
    if mode == "prefix":
        assert "prefix cache [paged]" in out
    if mode == "frontend":
        assert "frontend smoke OK" in out
