"""The admission paths through repro_torch against the JAX package: the
bucket and chunk ladders, `flash_attention` with offsets, retention from a
warm state and over a padded tail, `gqa_chunk` / `mla_chunk` into f32 and
encoded caches, `forward_prefill_chunk` chunk by chunk, bucketed prefill,
and the reference's identity gates (chunked and bucketed prefill, then
greedy decode resumed from the cache, equal monolithic prefill).

Weights are the JAX engines' params carried over by `repro_torch.bridge`, on
reduced retnet-1.3b, reduced qwen3-8b and the reduced deepseek-v3 config cut
to its 3 leading dense layers; engines are built once per (arch, quantize).
fp weights hold 1e-4 (1e-5 for one attention layer); deployed weights hold
1e-2 of max|reference| (`test_torch_retnet.QUANT_REL`: the int8 activation
rounding).  The JAX side runs its chunk step under ``jit``, as its engine
does, so int8_tok rows appended by a chunk take the reciprocal scale form
there and here (`core/kvq.py`).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import fp_engine
from test_torch_retnet import QUANT_REL

from repro import configs as Jconfigs
from repro.models import layers as JL
from repro.models import lm as Jlm
from repro.models import retnet as JR
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro.serving import bucket_length as j_bucket_length
from repro.serving import chunk_schedule as j_chunk_schedule
from repro_torch import bridge, configs as Tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import lm as Tlm
from repro_torch.models import retnet as TR
from repro_torch.serving import engine as TE
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig

DS3 = "deepseek-v3-671b"
ARCHS = ["retnet-1.3b", "qwen3-8b", DS3]
ARCH_IDS = ["retnet", "qwen3", "ds3_cut"]
FORMATS = [None, "int8_tok", "mxint4_blk"]
FORMAT_IDS = ["f32", "int8_tok", "mxint4_blk"]
FP_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
S, NEW, CHUNK = 11, 6, 4          # 11 = 4 + 4 + 2 + 1, the reference's gate
CACHE_LEN = S + NEW


def _cfgs(arch):
    if arch == DS3:
        return (dataclasses.replace(Jconfigs.get_config(DS3).reduced(), n_layers=3),
                dataclasses.replace(Tconfigs.get_config(DS3).reduced(), n_layers=3))
    return Jconfigs.get_config(arch).reduced(), Tconfigs.get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _engines(arch: str, quantize: bool):
    """The JAX engine (`conftest.fp_engine` where it serves the arch) and the
    port's on its carried weights."""
    jcfg, tcfg = _cfgs(arch)
    je = (fp_engine(arch) if not quantize and arch != DS3
          else JEngine.from_config(jcfg, JSpec(quantize=quantize)))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    model = bridge.model_from_tree(tcfg, tree, device="cpu")
    te = InferenceEngine.from_config(tcfg, EngineSpec(quantize=quantize), model=model,
                                     device="cpu")
    return je, te, tree


def _prompts(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 512, (2, S)).astype(np.int32)


def _close(got, want, quantize, msg="", tol=FP_TOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if quantize:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=QUANT_REL * np.abs(want).max(), err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _jax_blocks(cache: dict, n_layers: int) -> list:
    """The reference's stacked per-group cache -> one dict per layer."""
    groups = [cache[g] for g in ("dense_head", "blocks") if g in cache]
    return [jax.tree.map(lambda a, i=i: np.asarray(a[i]), g)
            for g in groups for i in range(jax.tree.leaves(g)[0].shape[0])][:n_layers]


def _assert_cache_close(tcache: dict, jcache: dict, quantize: bool, n_layers: int):
    assert int(tcache["pos"]) == int(jcache["pos"])
    if "rope" in jcache:
        for f in ("sin", "cos"):
            np.testing.assert_allclose(getattr(tcache["rope"], f).numpy(),
                                       np.asarray(getattr(jcache["rope"], f)),
                                       rtol=1e-6, atol=1e-6)
    for i, (tb, jb) in enumerate(zip(tcache["blocks"], _jax_blocks(jcache, n_layers))):
        for name, leaf in jb.items():
            _close(TL.from_cache_dtype(tb[name]), leaf, quantize, f"layer {i} {name}")


# -- the ladders ---------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 3, 5, 7, 8, 9, 11, 16, 31, 32, 33, 100, 500,
                               750, 1023])
def test_ladders_match_reference(s):
    assert TE.bucket_length(s) == j_bucket_length(s)
    for chunk in (1, 4, 32, 64, 128):
        assert TE.chunk_schedule(s, chunk) == j_chunk_schedule(s, chunk)
        assert sum(TE.chunk_schedule(s, chunk)) == s


def test_ladders_reject_what_the_reference_rejects():
    assert TE.chunk_schedule(500, 32) == [32] * 15 + [16, 4]
    for fn, args in ((TE.bucket_length, (0,)), (TE.chunk_schedule, (5, 0))):
        with pytest.raises(ValueError):
            fn(*args)
    assert issubclass(TE.CacheCapacityError, ValueError)
    assert TE.MIN_BUCKET == 8


# -- flash attention with offsets ------------------------------------------------------

# (sq, sk, q_offset, kv_len, causal, q_chunk, kv_chunk, as device scalars)
FLASH_CASES = {
    "chunk_at_7": (5, 20, 7, 12, True, 512, 1024, False),
    "device_offsets": (4, 16, 3, 7, True, 2, 8, True),
    "default_kv_len": (6, 10, 4, None, True, 4, 4, False),
    "one_row_at_device_end": (1, 12, 11, 12, True, 512, 1024, True),
    "bidirectional_kv_len": (5, 13, 0, 9, False, 4, 8, False),
    "padded_chunks": (7, 13, 6, 13, True, 4, 8, True),
    "chunk_at_0_device": (4, 9, 0, 4, True, 2, 4, True),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_offsets_match_reference(case):
    sq, sk, qo, kv_len, causal, qc, kc, dev = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    qj, qt = _pair(rng.normal(size=(2, sq, 2, 3, 16)).astype(np.float32))
    kj, kt = _pair(rng.normal(size=(2, sk, 2, 16)).astype(np.float32))
    vj, vt = _pair(rng.normal(size=(2, sk, 2, 16)).astype(np.float32))
    want = jax.jit(lambda q, k, v: JL.flash_attention(
        q, k, v, causal=causal, q_offset=jnp.int32(qo),
        kv_len=None if kv_len is None else jnp.int32(kv_len), q_chunk=qc,
        kv_chunk=kc))(qj, kj, vj)

    def arg(x):
        return torch.tensor(x, dtype=torch.int32) if dev and x is not None else x

    got = TL.flash_attention(qt, kt, vt, causal=causal, q_offset=arg(qo),
                             kv_len=arg(kv_len), q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# -- retention from a warm state and over a padded tail ------------------------------

# (s, warm state, valid_len): warm chunks at the ladder's sizes, lengths that
# are not whole 128-chunks (the port runs 128 + 2 and 3 x 128 + 116 where the
# reference takes its plain chunkwise or parallel form), and bucketed tails.
RET_CASES = {"warm_16": (16, True, None), "warm_1": (1, True, None),
             "warm_130": (130, True, None), "cold_130": (130, False, None),
             "warm_500": (500, True, None), "cold_500": (500, False, None),
             "bucket_11_of_16": (16, False, 11), "bucket_130_of_136": (136, False, 130)}


@pytest.mark.parametrize("case", list(RET_CASES))
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_retention_apply_warm_state_and_valid_len_match_reference(quantize, case):
    s, warm, valid = RET_CASES[case]
    je, te, tree = _engines("retnet-1.3b", quantize)
    jcfg, tcfg = _cfgs("retnet-1.3b")
    p_j = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["ret"])
    p_t = te.model.blocks[0].ret
    rng = np.random.default_rng(s)
    d, h = tcfg.d_model, tcfg.n_heads
    xj, xt = _pair(rng.normal(size=(2, s, d)).astype(np.float32))
    sj, st = _pair((rng.random((2, s)) + 0.5).astype(np.float32))
    sin_j, cos_j = Jlm._rope_tables(jcfg, s + 7)
    sin_j, cos_j = sin_j[7:], cos_j[7:]               # the chunk sits at position 7
    sin_t, cos_t = (torch.from_numpy(np.array(a)) for a in (sin_j, cos_j))
    cache_j = cache_t = None
    if warm:
        st0 = (rng.normal(size=(2, h, d // h, 2 * d // h)) * 0.1).astype(np.float32)
        cache_j, cache_t = {"s": jnp.asarray(st0)}, {"s": torch.from_numpy(st0)}
    vj = None if valid is None else jnp.int32(valid)
    vt = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    out_j, c_j = jax.jit(lambda p, x, sig, sin, cos, c, v: JR.retention_apply(
        p, x, sig, je.hsa, "prefill", jcfg, rope_sin=sin, rope_cos=cos, cache=c,
        valid_len=v))(p_j, xj, sj, sin_j, cos_j, cache_j, vj)
    out_t, c_t = TR.retention_apply(p_t, xt, st, te.hsa, "prefill", tcfg, rope_sin=sin_t,
                                    rope_cos=cos_t, cache=cache_t, valid_len=vt)
    rows = slice(None) if valid is None else slice(0, valid)
    _close(out_t[:, rows], np.asarray(out_j)[:, rows], quantize, "out")
    _close(c_t["s"], c_j["s"], quantize, "state")


# -- gqa_chunk / mla_chunk into f32 and encoded caches --------------------------------

CHUNKS = ((0, 5), (5, 4), (9, 1))                 # (pos, c) in a 12-slot cache


def _disagreeing_rows(shape) -> np.ndarray:
    """Rows, from the first seed that gives them, whose int8_tok scale
    differs between the division and the reciprocal form in some rows, so
    the site test tells the forms apart."""
    for seed in range(100):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=shape).astype(np.float32)
        x *= rng.uniform(0.01, 10.0, size=shape[:-1] + (1,)).astype(np.float32)
        absmax = np.abs(x).max(-1, keepdims=True)
        if (absmax / np.float32(127.0) != absmax * np.float32(1 / 127.0)).any():
            return x
    raise AssertionError("no seed gives rows on which the forms disagree")


@pytest.mark.parametrize("fmt", ["int8_tok", "mxint4_blk"])
@pytest.mark.parametrize("leaf", ["gqa_kv", "mla_latent", "mla_rope"])
def test_chunk_append_site_is_jitted(leaf, fmt):
    """Chunks of 5, 4 and 1 rows appended at device positions by the port's
    `cache_update`, against the reference's `cache_update` under jit (its
    chunk step is jitted): encoded bytes exactly, from rows on which the
    two int8_tok scale forms disagree."""
    tail = {"gqa_kv": (2, 32), "mla_latent": (32,), "mla_rope": (16,)}[leaf]
    rows = _disagreeing_rows((2, 10) + tail)
    upd = jax.jit(JL.cache_update)
    jleaf, tleaf = JL.make_cache_leaf((2, 12) + tail, fmt), TL.make_cache_leaf((2, 12) + tail,
                                                                              fmt)
    for pos, c in CHUNKS:
        jleaf = upd(jleaf, jnp.asarray(rows[:, pos:pos + c]), jnp.int32(pos))
        out = TL.cache_update(tleaf, torch.from_numpy(rows[:, pos:pos + c]),
                              torch.tensor(pos, dtype=torch.int32))
        assert out is tleaf
        for n in jleaf:
            np.testing.assert_array_equal(tleaf[n].numpy(), np.asarray(jleaf[n]),
                                          err_msg=f"chunk at {pos}: {n}")


def _quant_step(leaf) -> np.ndarray:
    """One quantization step of every decoded element of an encoded leaf."""
    if "s" in leaf:
        return np.broadcast_to(leaf["s"].numpy(), leaf["q"].shape)
    e = leaf["e"].numpy().astype(np.float32)
    step = np.exp2(e - 2.0)                        # MXINT4's scale 2^(e - 2)
    return np.repeat(step, 16, axis=-1)


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("arch", ["qwen3-8b", DS3], ids=["gqa_chunk", "mla_chunk"])
def test_attention_chunk_appends_and_attends_as_reference(arch, fmt):
    """Three chunks (5, 4, 1 rows) into one cache, against the reference's
    chunk under jit: outputs at 1e-5 and, after each chunk, the cache (f32
    at 1e-5; encoded leaves within one quantization step, decoded).  The
    appended rows pass through RMSNorm's rsqrt and RoPE, whose last bits
    differ between XLA and torch, so bytes are pinned by
    `test_chunk_append_site_is_jitted` on shared rows."""
    je, te, tree = _engines(arch, False)
    jcfg, tcfg = _cfgs(arch)
    group = "dense_head" if arch == DS3 else "blocks"
    p_j = jax.tree.map(lambda a: jnp.asarray(a[0]), tree[group]["attn"])
    p_t = te.model.blocks[0].attn
    jfn, tfn = (JL.mla_chunk, TL.mla_chunk) if arch == DS3 else (JL.gqa_chunk, TL.gqa_chunk)
    make_j, make_t = ((JL.mla_make_cache, TL.mla_make_cache) if arch == DS3
                      else (JL.gqa_make_cache, TL.gqa_make_cache))
    cache_j = make_j(jcfg, 2, 12, fmt or jnp.float32)
    cache_t = make_t(tcfg, 2, 12, fmt or torch.float32)
    step_j = jax.jit(lambda p, x, sig, c, pos, sin, cos: jfn(
        p, x, sig, je.hsa, jcfg, c, pos, rope_sin=sin, rope_cos=cos))
    sin_all, cos_all = Jlm._rope_tables(jcfg, 12)
    rng = np.random.default_rng(3)
    for pos, c in CHUNKS:
        xj, xt = _pair(rng.normal(size=(2, c, tcfg.d_model)).astype(np.float32))
        sj, st = _pair((rng.random((2, c)) + 0.5).astype(np.float32))
        sin, cos = sin_all[pos:pos + c], cos_all[pos:pos + c]
        out_j, cache_j = step_j(p_j, xj, sj, cache_j, jnp.int32(pos), sin, cos)
        out_t, cache_t = tfn(p_t, xt, st, te.hsa, tcfg, cache_t,
                             torch.tensor(pos, dtype=torch.int32),
                             rope_sin=torch.from_numpy(np.array(sin)),
                             rope_cos=torch.from_numpy(np.array(cos)))
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   err_msg=f"chunk at {pos}", **LAYER_TOL)
        for name, jleaf in cache_j.items():
            got = TL.from_cache_dtype(cache_t[name]).numpy()
            want = np.asarray(JL.from_cache_dtype(jleaf))
            if fmt is None:
                np.testing.assert_allclose(got, want, err_msg=name, **LAYER_TOL)
                continue
            step = np.maximum(_quant_step(cache_t[name]),
                              _quant_step({n: torch.from_numpy(np.array(a))
                                           for n, a in jleaf.items()}))
            assert (np.abs(got - want) <= step * 1.001 + 1e-6).all(), name
            assert (got[:, pos + c:] == 0).all()


def test_attention_chunk_rings_raise_until_ported():
    _, te, _ = _engines("qwen3-8b", False)
    _, tcfg = _cfgs("qwen3-8b")
    x = torch.zeros(1, 2, tcfg.d_model)
    cache = TL.gqa_make_cache(tcfg, 1, 8, torch.float32)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TL.gqa_chunk(te.model.blocks[0].attn, x, None, te.hsa,
                     dataclasses.replace(tcfg, sliding_window=4), cache,
                     torch.tensor(0, dtype=torch.int32))


# -- the model: chunk by chunk, bucketed --------------------------------------------


def _chunked_both(arch: str, quantize: bool, prompts: np.ndarray):
    """The reference's `prefill_chunked` and the port's, chunk by chunk:
    [(jax logits, port logits)], and both final caches."""
    je, te, _ = _engines(arch, quantize)
    cj = je.begin_chunked_prefill(jnp.asarray(prompts), cache_len=CACHE_LEN,
                                  chunk_size=CHUNK)
    ct = te.begin_chunked_prefill(torch.from_numpy(prompts), cache_len=CACHE_LEN,
                                  chunk_size=CHUNK)
    assert ct.schedule == cj.schedule == [4, 4, 2, 1]
    logits = []
    while not cj.done:
        cj.advance()
        ct.advance()
        logits.append((np.asarray(cj.logits), ct.logits))
    assert ct.done and ct.n_chunks == cj.n_chunks
    return logits, cj.cache, ct.cache


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_forward_prefill_chunk_matches_reference_per_chunk(arch, quantize):
    """Each chunk's logits and the final cache against the reference's
    chunked admission (its chunk step under jit) on the same weights."""
    logits, cache_j, cache_t = _chunked_both(arch, quantize, _prompts())
    for i, (lj, lt) in enumerate(logits):
        _close(lt, lj, quantize, f"chunk {i} logits")
    _assert_cache_close(cache_t, cache_j, quantize, _cfgs(arch)[1].n_layers)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_bucketed_prefill_matches_reference(arch, quantize):
    """11 tokens padded to the 16-bucket, the cache at the ladder's 32 slots:
    logits at the real last token and the cache against the reference's
    ``prefill(bucket=True)``."""
    je, te, _ = _engines(arch, quantize)
    prompts = _prompts(2)
    lj, cj = je.prefill(jnp.asarray(prompts), cache_len=CACHE_LEN, bucket=True)
    lt, ct = te.prefill(torch.from_numpy(prompts), cache_len=CACHE_LEN, bucket=True)
    _close(lt, lj, quantize, "logits")
    assert int(ct["pos"]) == S
    _assert_cache_close(ct, cj, quantize, _cfgs(arch)[1].n_layers)
    for blk in ct["blocks"]:
        assert all(TL.cache_capacity(leaf) == 32 for name, leaf in blk.items() if name != "s")


# -- the reference's identity gates, on fp weights ----------------------------------


@functools.lru_cache(maxsize=None)
def _monolithic(arch: str, seed: int):
    _, te, _ = _engines(arch, False)
    prompts = _prompts(seed)
    lg, cache = te.prefill(torch.from_numpy(prompts), cache_len=CACHE_LEN)
    res = te.resume_generate(lg.argmax(-1), cache, GenerationConfig(max_new_tokens=NEW))
    return prompts, lg, res.tokens


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_chunked_prefill_token_identity(arch):
    """Chunked prefill (11 = 4+4+2+1) then greedy decode resumed from its
    cache equals monolithic prefill, and equals the reference's
    `prefill_chunked` then `resume_generate`."""
    je, te, _ = _engines(arch, False)
    prompts, lg_m, want = _monolithic(arch, 1)
    lg_c, cache_c = te.prefill_chunked(torch.from_numpy(prompts), cache_len=CACHE_LEN,
                                       chunk_size=CHUNK)
    np.testing.assert_allclose(lg_c.numpy(), lg_m.numpy(), rtol=2e-4, atol=2e-4)
    got = te.resume_generate(lg_c.argmax(-1), cache_c, GenerationConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(got.tokens.numpy(), want.numpy())
    assert got.decode_steps == NEW and got.prefill_s == 0.0
    lj, cj = je.prefill_chunked(jnp.asarray(prompts), cache_len=CACHE_LEN, chunk_size=CHUNK)
    jres = je.resume_generate(jnp.argmax(lj, -1).astype(jnp.int32), cj,
                              JGen(max_new_tokens=NEW))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(jres.lengths))


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_bucketed_prefill_token_identity(arch):
    """Bucketed prefill then greedy decode resumed from its cache equals
    monolithic prefill (RetNet's state decay-corrected, dense caches'
    padded tails masked then overwritten)."""
    _, te, _ = _engines(arch, False)
    prompts, lg_m, want = _monolithic(arch, 1)
    lg_b, cache_b = te.prefill(torch.from_numpy(prompts), cache_len=CACHE_LEN, bucket=True)
    np.testing.assert_allclose(lg_b.numpy(), lg_m.numpy(), rtol=2e-4, atol=2e-4)
    got = te.resume_generate(lg_b.argmax(-1), cache_b, GenerationConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(got.tokens.numpy(), want.numpy())


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_start_offset_adopts_a_warm_prefix(arch):
    """A chunked admission that adopts a cache warm over the first 4 tokens
    and prefills only the other 7 (4+2+1) equals the full chunked prefill
    bit for bit: the same chunks run in the same order."""
    _, te, _ = _engines(arch, False)
    prompts = torch.from_numpy(_prompts(1))
    lg_full, cache_full = te.prefill_chunked(prompts, cache_len=CACHE_LEN, chunk_size=CHUNK)
    _, warm = te.prefill_chunked(prompts[:, :4], cache_len=CACHE_LEN, chunk_size=CHUNK)
    cp = te.begin_chunked_prefill(prompts, cache_len=CACHE_LEN, chunk_size=CHUNK,
                                  initial_cache=warm, start_offset=4)
    assert cp.schedule == [4, 2, 1] and cp.start_offset == 4
    while not cp.done:
        cp.advance()
    assert torch.equal(cp.logits, lg_full)
    flat = [t for t in (cache_full, cp.cache)]
    assert TE._layout(flat[0]) == TE._layout(flat[1])
    for (a, b) in zip(_leaves(cache_full), _leaves(cp.cache)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_resume_in_two_halves_equals_one_resume(arch):
    """`resume_generate` leaves the caller's cache warm over every token fed
    and returns the next pending token: 3 + 3 steps from a chunked
    admission's cache equal one resume of 6, tokens and final cache bit for
    bit."""
    _, te, _ = _engines(arch, False)
    prompts = torch.from_numpy(_prompts(1))
    lg, cache = te.prefill_chunked(prompts, cache_len=CACHE_LEN, chunk_size=CHUNK)
    halves = TE._clone(cache)
    whole = te.resume_generate(lg.argmax(-1), cache, GenerationConfig(max_new_tokens=NEW))
    half = GenerationConfig(max_new_tokens=NEW // 2)
    first = te.resume_generate(lg.argmax(-1), halves, half)
    second = te.resume_generate(first.next_token, halves, half)
    assert torch.equal(torch.cat([first.tokens, second.tokens], dim=1), whole.tokens)
    assert torch.equal(second.next_token, whole.next_token)
    assert int(halves["pos"]) == S + NEW
    for a, b in zip(_leaves(cache), _leaves(halves)):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]


def test_chunked_admission_rejects_what_the_reference_rejects():
    _, te, _ = _engines("retnet-1.3b", False)
    prompts = torch.ones(1, 6, dtype=torch.long)
    with pytest.raises(TE.CacheCapacityError):
        te.begin_chunked_prefill(prompts, cache_len=5)
    with pytest.raises(ValueError, match="initial_cache"):
        te.begin_chunked_prefill(prompts, cache_len=8, start_offset=2)
    with pytest.raises(ValueError, match="start_offset"):
        te.begin_chunked_prefill(prompts, cache_len=8, start_offset=6,
                                 initial_cache=Tlm.make_decode_cache(te.cfg, 1, 8,
                                                                     device="cpu"))
    with pytest.raises(ValueError, match=r"\[B, S\]"):
        te.begin_chunked_prefill(prompts[0], cache_len=8)


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_decode_graph_key_is_the_cache_layout(arch, fmt):
    """A chunked admission's cache (in ``fmt``) and a monolithic prefill's
    (encoded at the boundary) share a graph key when their capacities match,
    and a different capacity or format gives another key."""
    _, te, _ = _engines(arch, False)
    prompts = torch.from_numpy(_prompts(1))
    gen = GenerationConfig(max_new_tokens=NEW, cache_format=fmt)
    _, chunked = te.prefill_chunked(prompts, cache_len=CACHE_LEN, chunk_size=CHUNK,
                                    cache_dtype=fmt or torch.float32)
    _, mono = te.prefill(prompts, cache_len=CACHE_LEN)
    mono = te._encode_cache(mono, gen)
    key = InferenceEngine.graph_key(chunked, gen)
    assert key == InferenceEngine.graph_key(mono, gen)
    dense = arch != "retnet-1.3b"        # RetNet's state has no capacity or format
    _, longer = te.prefill(prompts, cache_len=CACHE_LEN + 1)
    assert (InferenceEngine.graph_key(te._encode_cache(longer, gen), gen) != key) == dense
    other = GenerationConfig(cache_format="int8_tok" if fmt != "int8_tok" else "mxint4_blk")
    _, fresh = te.prefill(prompts, cache_len=CACHE_LEN)
    assert (InferenceEngine.graph_key(te._encode_cache(fresh, other), gen) != key) == dense
