"""The SSM families through every serving path of repro_torch, against the
JAX package: falcon-mamba-7b (Mamba-1) and hymba-1.5b (a sliding-window
ring beside Mamba), reduced, on the CPU.

* `generate`: JAX's greedy tokens on fp weights in every cache format, and
  on the default W8A8 / MXINT4 deployment (hymba's ragged ``x_proj`` and
  ``dt_proj`` through the padded W8A8 operands);
* the admission paths: bucketed and chunked prefill against the reference's
  (hymba's prompt wrapping its ring), chunked against monolithic (a prompt
  that fits the window, where the two are the same function), and
  `resume_generate` from a chunked cache;
* the `RequestScheduler` against the reference's scheduler, and the
  shared-prefix cache in snapshot mode (warm tokens equal cold ones, the
  reference's counters);
* speculative decode with the ngram drafter: the plain loop's tokens and
  JAX's speculative tokens on fp weights, and the window guards.

Weights are the JAX engines' params carried over by `repro_torch.bridge`;
engines are built once per (arch, quantize).  Deployed weights hold greedy
tokens up to near ties (ROADMAP C); the seeded prompts here have none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import fp_engine
from test_torch_admission import _close

from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import RequestScheduler as JScheduler
from repro.serving import SpeculativeConfig as JSpecCfg
from repro_torch import bridge, configs as Tconfigs
from repro_torch.serving import Request, RequestScheduler
from repro_torch.serving.engine import (EngineSpec, InferenceEngine, _clone, _write_back,
                                        tree_items)
from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

FM, HY = "falcon-mamba-7b", "hymba-1.5b"
ARCHS, ARCH_IDS = [FM, HY], ["falcon_mamba", "hymba"]
FORMATS, FORMAT_IDS = [None, "int8_tok", "mxint4_blk"], ["f32", "int8_tok", "mxint4_blk"]
NEW = 8


@functools.lru_cache(maxsize=None)
def engines(arch: str, quantize: bool = False):
    je = (fp_engine(arch) if not quantize
          else JEngine.from_config(arch, JSpec(reduced=True)))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    tcfg = Tconfigs.get_config(arch).reduced()
    te = InferenceEngine.from_config(tcfg, EngineSpec(quantize=quantize),
                                     model=bridge.model_from_tree(tcfg, tree, device="cpu"),
                                     device="cpu")
    return je, te


def _prompts(s: int, seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(np.int32)


def _greedy(te, logits, cache, n: int) -> list:
    """Greedy decode_step continuation from a warm (logits, cache)."""
    out, tok = [], logits.argmax(-1)[:, None]
    for _ in range(n):
        out.append(tok[:, 0].tolist())
        logits, cache = te.decode_step(tok, cache)
        tok = logits.argmax(-1)[:, None]
    return out


# -- generate -------------------------------------------------------------------------


GREEDY_CELLS = ([(FM, False, f) for f in FORMATS] + [(FM, True, None)]
                + [(HY, q, f) for q in (False, True) for f in FORMATS])


@pytest.mark.parametrize("arch,quantize,fmt", GREEDY_CELLS, ids=[
    f"{a.split('-')[0]}-{'deployed' if q else 'fp'}-{f or 'f32'}" for a, q, f in GREEDY_CELLS])
def test_greedy_tokens_identical_to_jax(arch, quantize, fmt):
    """24-token prompts (within hymba's window; `test_generate_past_the_window`
    wraps the ring) and 8 new tokens, in every cache format (falcon-mamba's
    cache has no KV: a format passes through, so its deployed cell is one)."""
    je, te = engines(arch, quantize)
    prompts = _prompts(24, 1)
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=NEW, cache_format=fmt))
    got = te.generate(torch.from_numpy(prompts),
                      GenerationConfig(max_new_tokens=NEW, cache_format=fmt))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
def test_generate_past_the_window(fmt):
    """Hymba with a 40-token prompt (window 32): the prefill seeds a rolled
    ring and decode writes past its wrap, as the reference's."""
    je, te = engines(HY)
    prompts = _prompts(40, 2)
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=NEW, cache_format=fmt))
    got = te.generate(torch.from_numpy(prompts),
                      GenerationConfig(max_new_tokens=NEW, cache_format=fmt))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_quantize_cache_encodes_only_attention(arch):
    """``quantize_cache``: hymba's attention leaves are encoded, Mamba state
    and falcon-mamba's whole cache pass through (the same tensors)."""
    _, te = engines(arch)
    _, cache = te.prefill(torch.from_numpy(_prompts(9, 3)), cache_len=12)
    enc = te._encode_cache(cache, GenerationConfig(cache_format="int8_tok"))
    for raw, blk in zip(cache["blocks"], enc["blocks"]):
        mamba, raw_m = blk.get("mamba", blk), raw.get("mamba", raw)
        assert mamba["h"] is raw_m["h"] and mamba["conv"] is raw_m["conv"]
        if "attn" in blk:
            assert sorted(blk["attn"]["k"]) == ["q", "s"]


# -- admission paths ------------------------------------------------------------------


@pytest.mark.parametrize("s", [13, 40], ids=["fits", "wraps"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_bucketed_prefill_matches_reference(arch, s):
    """Bucketed prefill (13 -> 16, 40 -> 64): the padded tail never enters
    the Mamba state, the conv window or the ring; logits and cache as the
    reference's, and the same greedy continuation as exact prefill."""
    je, te = engines(arch)
    prompts = _prompts(s, 4)
    lj, cj = je.prefill(jnp.asarray(prompts), cache_len=s + NEW, bucket=True)
    lt, ct = te.prefill(torch.from_numpy(prompts), cache_len=s + NEW, bucket=True)
    _close(lt, lj, False, "logits")
    assert int(ct["pos"]) == int(cj["pos"]) == s
    for i, blk in enumerate(ct["blocks"]):
        jb = jax.tree.map(lambda a, i=i: np.asarray(a[i]), cj["blocks"])
        for (path, leaf) in _leaves(blk):
            _close(leaf, _get(jb, path), False, f"layer {i} {path}")
    le, ce = te.prefill(torch.from_numpy(prompts), cache_len=s + NEW)
    assert _greedy(te, lt, ct, 4) == _greedy(te, le, ce, 4)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch,s,chunk", [(FM, 37, 8), (HY, 45, 8), (HY, 70, 64)],
                         ids=["falcon_mamba", "hymba_wraps", "hymba_chunk_clamped"])
def test_chunked_prefill_matches_reference(arch, s, chunk):
    """Chunk by chunk against the reference's `prefill_chunked` (hymba's
    prompt past its window; a chunk size over the window is clamped to it,
    as the reference clamps it): logits and the final cache."""
    je, te = engines(arch)
    prompts = _prompts(s, 5)
    lj, cj = je.prefill_chunked(jnp.asarray(prompts), cache_len=s + NEW, chunk_size=chunk)
    cp = te.begin_chunked_prefill(torch.from_numpy(prompts), cache_len=s + NEW,
                                  chunk_size=chunk)
    assert max(cp.schedule) <= (te.cfg.sliding_window or chunk)
    while not cp.done:
        cp.advance()
    _close(cp.logits, lj, False, "logits")
    for i, blk in enumerate(cp.cache["blocks"]):
        jb = jax.tree.map(lambda a, i=i: np.asarray(a[i]), cj["blocks"])
        for path, leaf in _leaves(blk):
            _close(leaf, _get(jb, path), False, f"layer {i} {path}")


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_chunked_equals_monolithic_then_resumes(arch):
    """The reference's identity gate: a prompt that fits hymba's window,
    chunked (11 = 4 + 4 + 2 + 1) or monolithic, continues with the same
    greedy tokens; `resume_generate` from the chunked cache gives them
    too."""
    _, te = engines(arch)
    prompts = torch.from_numpy(_prompts(11, 6))
    lm_, cm = te.prefill(prompts, cache_len=11 + NEW)
    lc, cc = te.prefill_chunked(prompts, cache_len=11 + NEW, chunk_size=4)
    _close(lc, lm_.numpy(), False, "logits")
    want = _greedy(te, lm_, cm, NEW)
    res = te.resume_generate(lc.argmax(-1), cc, GenerationConfig(max_new_tokens=NEW))
    assert res.tokens.T.tolist() == want


# -- scheduler and prefix cache -----------------------------------------------------------


CLASSES, CHUNK = [(2, 24), (2, 40)], 8
LENS = [5, 13, 9, 30, 3, 16]


def _requests(vocab: int) -> list:
    rng = np.random.default_rng(3)
    return [rng.integers(1, vocab, n).tolist() for n in LENS]


@pytest.mark.parametrize("arch,fmt", [(FM, None), (HY, None), (HY, "int8_tok")],
                         ids=["falcon_mamba", "hymba-f32", "hymba-int8_tok"])
def test_scheduler_matches_the_reference_scheduler(arch, fmt):
    """Six mixed-length requests through two slot classes (hymba's 30-token
    prompt in the 40 class), chunks of 8, greedy: the reference
    scheduler's tokens."""
    je, te = engines(arch)
    reqs = _requests(te.cfg.vocab_size)
    ref = JScheduler(je, classes=CLASSES, gen=JGen(max_new_tokens=NEW, cache_format=fmt),
                     chunk_size=CHUNK)
    port = RequestScheduler(te, classes=CLASSES,
                            gen=GenerationConfig(max_new_tokens=NEW, cache_format=fmt),
                            chunk_size=CHUNK)
    for uid, p in enumerate(reqs):
        ref.submit(JRequest(uid=uid, prompt=p))
        port.submit(Request(uid=uid, prompt=p))
    want = {u: f.tokens for u, f in ref.run().items()}
    assert {u: f.tokens for u, f in port.run().items()} == want


def test_deployed_hymba_scheduler_lanes_are_isolated():
    """Hymba's decode runs x_proj in W8A8 (N 132 takes no MXINT4): a class
    step quantizes each lane's activations with its own scale, so on the
    default deployment a request's tokens beside a co-tenant equal its
    tokens alone, and the reference scheduler's (which vmaps one slot at a
    time)."""
    je, te = engines(HY, True)
    reqs = _requests(te.cfg.vocab_size)[:3]

    def run(lanes, which):
        s = RequestScheduler(te, classes=[(lanes, 40)], chunk_size=CHUNK,
                             gen=GenerationConfig(max_new_tokens=NEW))
        for uid in which:
            s.submit(Request(uid=uid, prompt=reqs[uid]))
        return {u: f.tokens for u, f in s.run().items()}

    together = run(2, range(3))
    for uid in range(3):
        assert run(1, [uid])[uid] == together[uid], f"uid {uid}"
    ref = JScheduler(je, classes=[(2, 40)], gen=JGen(max_new_tokens=NEW), chunk_size=CHUNK)
    for uid, p in enumerate(reqs):
        ref.submit(JRequest(uid=uid, prompt=p))
    assert {u: f.tokens for u, f in ref.run().items()} == together

    # One class step, lane 1 holding garbage at two scales: lane 0's store
    # and token are the same bit for bit.
    sched = RequestScheduler(te, classes=[(2, 40)], chunk_size=CHUNK,
                             gen=GenerationConfig(max_new_tokens=NEW))
    sched.submit(Request(uid=0, prompt=reqs[0]))
    while sched.stats["admitted"] < 1:
        sched.step()
    step = sched.pool.steps[40]
    (sid,) = sched._active
    lane = sched.pool.locate(sid)[1]
    outs = []
    with torch.inference_mode():
        cold, tok0 = _clone(step.store), step.tok.clone()
        for scale in (1.0, 50.0):
            _write_back(step.store, cold)
            step.tok.copy_(tok0)
            for _, t in tree_items(step.store["blocks"]):
                t[1 - lane] = torch.randn(t[1 - lane].shape,
                                          generator=torch.Generator().manual_seed(3)) * scale
            step.body()
            outs.append([t[lane].clone() for _, t in tree_items(step.store)]
                        + [step.tok[lane].clone()])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_prefix_snapshots_warm_equals_cold(arch):
    """A 16-token base alone, then three extensions of 8: with the prefix
    cache on (snapshot mode) the extensions adopt the base's cache, and
    every token equals the cold run's and the reference's, with the
    reference's counters."""
    je, te = engines(arch)
    rng = np.random.default_rng(9)
    base = rng.integers(1, 512, 16).tolist()
    reqs = [base] + [base + rng.integers(1, 512, 8).tolist() for _ in range(3)]

    def run(prefix_cache):
        s = RequestScheduler(te, n_slots=2, cache_len=40, chunk_size=CHUNK,
                             gen=GenerationConfig(max_new_tokens=6),
                             prefix_cache=prefix_cache)
        for uid, p in enumerate(reqs):
            s.submit(Request(uid=uid, prompt=p))
        return {u: f.tokens for u, f in s.run().items()}, s

    ref = JScheduler(je, n_slots=2, cache_len=40, gen=JGen(max_new_tokens=6),
                     chunk_size=CHUNK, prefix_cache=True)
    for uid, p in enumerate(reqs):
        ref.submit(JRequest(uid=uid, prompt=p))
    want = {u: f.tokens for u, f in ref.run().items()}
    cold, _ = run(False)
    warm, sched = run(True)
    assert warm == cold == want
    assert sched.pool.prefix.mode == "snapshot"
    assert sched.pool.prefix.stats["prefix_hits"] == 3
    assert dict(sched.pool.prefix.stats) == dict(ref.pool.prefix.stats)


# -- speculative decode ---------------------------------------------------------------


ECHO_SEED = {FM: 3, HY: 2}


@functools.lru_cache(maxsize=None)
def _echo_prompt(arch: str, n: int = 4) -> tuple:
    """P (n tokens), the model's own 2n greedy tokens after P, then P again:
    the ngram drafter proposes what followed P, which the target accepts in
    part (on random weights little else repeats).  4n + 12 new tokens + k 3
    fit hymba's reduced window of 32 for n = 4."""
    _, te = engines(arch)
    p = np.random.default_rng(ECHO_SEED[arch]).integers(1, 512, n)
    out = te.generate(torch.from_numpy(p[None]), GenerationConfig(max_new_tokens=2 * n))
    return tuple(np.concatenate([p, out.tokens[0].numpy(), p]).tolist())


@pytest.mark.parametrize("arch,fmt", [(FM, None), (HY, None), (HY, "int8_tok")],
                         ids=["falcon_mamba", "hymba-f32", "hymba-int8_tok"])
def test_speculative_equals_plain_and_reference(arch, fmt):
    """k 3 with the ngram drafter on fp weights: the plain loop's greedy
    tokens (rollback is exact: the ring's evicted rows, the Mamba snapshot)
    and the reference's speculative run, with its verify steps and
    acceptance (some drafts accepted, others not)."""
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


def test_speculative_past_the_window_matches_reference():
    """Past hymba's window a full-attention layer's verify block attends to
    the ring and the block (``window = pos + C``) where decode reads the ring
    alone, so speculative and plain tokens may part, in the reference as in
    the port: the port's speculative run is the reference's, token for
    token."""
    je, te = engines(HY)
    prompts = np.asarray([_echo_prompt(HY, 10)], dtype=np.int32)
    got = te.generate(torch.from_numpy(prompts), GenerationConfig(max_new_tokens=12),
                      speculative=SpeculativeConfig(k=3))
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12,
                                                  speculative=JSpecCfg(k=3)))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert (got.verify_steps, got.accepted_drafts) == (want.verify_steps,
                                                       want.accepted_drafts)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_speculative_scheduler_matches_reference(arch):
    """The scheduler in speculative mode (per-lane acceptance, per-lane
    rollback of rings and Mamba state) gives the reference speculative
    scheduler's tokens and acceptance, and falcon-mamba's equal its plain
    scheduler's (hymba's 30-token prompt runs past the window, see
    `test_speculative_past_the_window_matches_reference`)."""
    je, te = engines(arch)
    reqs = _requests(te.cfg.vocab_size)[:4] + [list(_echo_prompt(arch))]
    classes = [(2, 24 + 3), (2, 40 + 3)]

    def run(spec):
        s = RequestScheduler(te, classes=classes, chunk_size=CHUNK,
                             gen=GenerationConfig(max_new_tokens=NEW, speculative=spec))
        for uid, p in enumerate(reqs):
            s.submit(Request(uid=uid, prompt=p))
        return {u: f.tokens for u, f in s.run().items()}, s

    ref = JScheduler(je, classes=classes, chunk_size=CHUNK,
                     gen=JGen(max_new_tokens=NEW, speculative=JSpecCfg(k=3)))
    for uid, p in enumerate(reqs):
        ref.submit(JRequest(uid=uid, prompt=p))
    want = {u: f.tokens for u, f in ref.run().items()}
    spec, sched = run(SpeculativeConfig(k=3))
    assert spec == want
    assert sched.stats["accepted_drafts"] == ref.stats["accepted_drafts"] > 0
    if arch == FM:
        assert run(None)[0] == spec


def test_speculative_block_must_fit_the_window():
    """k + 1 over the window raises, in `generate` and in the scheduler,
    with the reference's texts."""
    _, te = engines(HY)
    w = te.cfg.sliding_window
    with pytest.raises(ValueError, match=rf"k\+1 \({w + 1}\) must fit the sliding "
                                         rf"window \({w}\): a larger block"):
        te.generate(torch.tensor([[3, 4, 5]]), GenerationConfig(max_new_tokens=2),
                    speculative=SpeculativeConfig(k=w))
    with pytest.raises(ValueError, match=rf"k\+1 \({w + 1}\) must fit the sliding "
                                         rf"window \({w}\)$"):
        RequestScheduler(te, classes=[(1, 80)],
                         gen=GenerationConfig(max_new_tokens=2,
                                              speculative=SpeculativeConfig(k=w)))
    te.generate(torch.tensor([[3, 4, 5]]), GenerationConfig(max_new_tokens=2),
                speculative=SpeculativeConfig(k=w - 1))


# -- the serve CLI ----------------------------------------------------------------------


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
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_serve_cli_every_mode(arch, mode, capsys):
    """``--arch`` takes both families in every mode of the serve CLI."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--scale", "0.05",
                *CLI_MODES[mode]])
    out = capsys.readouterr().out
    assert "[serve]" in out
    if mode == "prefix":
        assert "prefix cache [snapshot]" in out
    if mode == "frontend":
        assert "frontend smoke OK" in out
