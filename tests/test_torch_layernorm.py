"""LayerNorm (reduced starcoder2-15b) and the dense greedy gates through
repro_torch against the JAX package, on the CPU.

* `fused_rmsnorm.layernorm_stats`, `fused_layernorm_emit` and `layernorm`
  against the reference's: mu and sigma^-1 at 1e-6, outputs at 1e-5 (a
  bf16 output within one bf16 step), a nonzero beta on the unfused path;
  `layers.norm_emit` / `norm_full` on a LayerNorm `Norm` against the
  reference's, fused (no beta read, as the reference) and unfused (beta
  added);
* reduced starcoder2-15b (LayerNorm, ungated GeLU MLP, GQA 4 / 2 heads),
  the JAX engines' weights carried over by `repro_torch.bridge`: prefill
  logits and every layer's K/V cache, and 6 decode steps per cache format,
  at 1e-4 for fp weights and `QUANT_REL` of max|reference| for deployed
  ones; greedy tokens equal to the JAX engine's in every cache format, fp
  and deployed;
* admission: chunked and bucketed prefill give monolithic prefill's logits
  and, resumed, its greedy tokens (fp);
* speculative decode with the ngram drafter gives the plain loop's tokens
  and the reference's, with its verify steps (fp);
* the greedy gates of the other dense archs, qwen1.5-4b (qkv bias) and
  internlm2-1.8b, against the JAX engine, fp and deployed.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_retnet import QUANT_REL

from repro.core import fused_rmsnorm as Jfr
from repro.core.hsa import HSAConfig as JHSAConfig, HSAEngine as JHSA
from repro.models import layers as JL
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro.serving import SpeculativeConfig as JSpecCfg
from repro_torch import bridge, configs as Tconfigs
from repro_torch.core import fused_rmsnorm as Tfr
from repro_torch.core.hsa import HSAConfig as THSAConfig, HSAEngine as THSA
from repro_torch.models import lm as Tlm
from repro_torch.models.modules import Norm
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "starcoder2-15b"
FORMATS, FORMAT_IDS = [None, "int8_tok", "mxint4_blk"], ["f32", "int8_tok", "mxint4_blk"]
QUANT, QUANT_IDS = [False, True], ["fp", "deployed"]
S, NEW = 16, 6
CACHE_LEN = S + NEW


def _close(got, want, quantize: bool, what: str = "") -> None:
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    if quantize:
        np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_REL * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


# -- the norm functions -------------------------------------------------------------

SHAPES = [(4, 64), (2, 3, 128), (7, 96)]


def _rows(shape, seed: int, dtype):
    """Rows with an offset (so centring matters) in f32 or bf16, on both
    sides with the same bytes."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=shape) * 2.0 + 3.0).astype(np.float32)
    yj = jnp.asarray(y).astype(dtype)
    return yj, bridge.to_tensor(np.asarray(yj))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["4x64", "2x3x128", "7x96"])
def test_layernorm_functions_match_reference(shape, dtype):
    yj, yt = _rows(shape, sum(shape), dtype)
    d = shape[-1]
    rng = np.random.default_rng(d)
    g = rng.uniform(0.5, 1.5, d).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)
    mu_j, sig_j = Jfr.layernorm_stats(yj)
    mu_t, sig_t = Tfr.layernorm_stats(yt)
    assert mu_t.dtype == sig_t.dtype == torch.float32 and sig_t.shape == shape[:-1]
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-6, atol=1e-6)
    ys_j, s_j = Jfr.fused_layernorm_emit(yj, jnp.asarray(g))
    ys_t, s_t = Tfr.fused_layernorm_emit(yt, torch.from_numpy(g))
    assert ys_t.dtype == yt.dtype
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-6)
    # A bf16 output may sit one bf16 step (at most 2^-7 of its value) from
    # the reference's where the two f32 values straddle a rounding boundary.
    out_tol = 1e-5 if dtype == jnp.float32 else 2.0 ** -7
    for beta in (None, b):
        want = Jfr.layernorm(yj, jnp.asarray(g), None if beta is None else jnp.asarray(beta))
        got = Tfr.layernorm(yt, torch.from_numpy(g),
                            None if beta is None else torch.from_numpy(beta))
        assert got.dtype == yt.dtype
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=out_tol, atol=out_tol)
    np.testing.assert_allclose(ys_t.float().numpy(), np.asarray(ys_j, np.float32),
                               rtol=out_tol, atol=out_tol)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_norm_emit_and_full_on_a_layernorm_norm(fused):
    """A `Norm` with a bias is a LayerNorm: the fused emission reads no bias
    (the reference's), the unfused path and `norm_full` add it."""
    from repro.configs import get_config
    from repro_torch.models import layers as TL
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(5)
    y = (rng.normal(size=(2, 5, 64)) + 1.0).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = rng.normal(size=64).astype(np.float32)
    p = Norm(torch.from_numpy(g), torch.from_numpy(b))
    assert p.layernorm and not Norm(torch.from_numpy(g)).layernorm
    jp = {"g": jnp.asarray(g), "b": jnp.asarray(b)}
    je = JHSA(JHSAConfig(fuse_rmsnorm=fused))
    te = THSA(THSAConfig(fuse_rmsnorm=fused))
    xj, sj = JL.norm_emit(jp, jnp.asarray(y), je, cfg)
    xt, st = TL.norm_emit(p, torch.from_numpy(y), te)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)
    assert (st is None) == (sj is None) == (not fused)
    if fused:
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TL.norm_full(p, torch.from_numpy(y)).numpy(),
                               np.asarray(JL.norm_full(jp, jnp.asarray(y), cfg)),
                               rtol=1e-5, atol=1e-5)


# -- reduced starcoder2-15b -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def engines(arch: str, quantize: bool):
    """The JAX engine (reduced; fp or the default deployment) and the port's
    on its carried weights, on the CPU."""
    je = JEngine.from_config(arch, JSpec(reduced=True, quantize=quantize))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    cfg = Tconfigs.get_config(arch).reduced()
    te = InferenceEngine.from_config(cfg, EngineSpec(quantize=quantize),
                                     model=bridge.model_from_tree(cfg, tree, device="cpu"),
                                     device="cpu")
    return je, te


def _prompts(seed: int, b: int = 2, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(np.int32)


def test_starcoder2_builds_with_layernorm_and_an_ungated_mlp():
    eng = InferenceEngine.from_config(ARCH, EngineSpec(reduced=True), device="cpu")
    blk = eng.model.blocks[0]
    assert isinstance(blk, Tlm.DenseBlock) and blk.mlp.wg is None
    for norm in (blk.ln1, blk.ln2, eng.model.final_norm):
        assert norm.layernorm and not norm.b.any()            # beta starts at 0
    assert blk.attn.wq.b is None                              # no qkv bias
    assert eng.model.lm_head.w is None and eng.model.lm_head.mx_packed is not None


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_prefill_logits_and_kv_cache(quantize):
    je, te = engines(ARCH, quantize)
    p = _prompts(7)
    jl, jc = je.prefill(jnp.asarray(p), cache_len=CACHE_LEN)
    with torch.inference_mode():
        tl, tc = te.prefill(torch.from_numpy(p), cache_len=CACHE_LEN)
    _close(tl.numpy(), jl, quantize, "logits")
    for name in ("k", "v"):
        got = np.stack([blk[name].numpy() for blk in tc["blocks"]])
        assert got.shape == (te.cfg.n_layers, 2, CACHE_LEN, te.cfg.n_kv_heads,
                             te.cfg.head_dim_)
        _close(got, jc["blocks"][name], quantize, name)
    assert int(tc["pos"]) == int(jc["pos"]) == S


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_decode_steps(quantize, fmt):
    """Six decode steps from one prefill, both sides fed the same tokens."""
    je, te = engines(ARCH, quantize)
    p = _prompts(8)
    jl, jc = je.prefill(jnp.asarray(p), cache_len=CACHE_LEN)
    jc = je._encode_cache(jc, JGen(cache_format=fmt))
    with torch.inference_mode():
        tl, tc = te.prefill(torch.from_numpy(p), cache_len=CACHE_LEN)
        tc = te._encode_cache(tc, GenerationConfig(cache_format=fmt))
        for step in range(NEW):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = je.decode_step(jnp.asarray(tok), jc)
            tl, tc = te.decode_step(torch.from_numpy(tok).long(), tc)
            _close(tl.numpy(), jl, quantize, f"step {step}")
    assert int(tc["pos"]) == S + NEW


def _greedy_gate(arch: str, quantize: bool, fmt, seed: int) -> None:
    je, te = engines(arch, quantize)
    p = _prompts(seed)
    want = je.generate(jnp.asarray(p), JGen(max_new_tokens=10, cache_format=fmt))
    got = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=10, cache_format=fmt))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_greedy_tokens_identical_to_jax(quantize, fmt):
    _greedy_gate(ARCH, quantize, fmt, 4)


def test_chunked_and_bucketed_admission_equal_monolithic():
    """A 21-token prompt: bucketed (to 32) and chunked (in chunks of 8, 4
    and 1 on the ladder) prefill give monolithic prefill's logits, and the
    decode resumed from the chunked cache gives `generate`'s tokens."""
    _, te = engines(ARCH, False)
    p = torch.from_numpy(_prompts(9, s=21))
    gen = GenerationConfig(max_new_tokens=8)
    with torch.inference_mode():
        mono, _ = te.prefill(p, cache_len=29)
        bucketed, _ = te.prefill(p, cache_len=29, bucket=True)
        chunked, cache = te.prefill_chunked(p, cache_len=29, chunk_size=8)
    torch.testing.assert_close(bucketed, mono, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(chunked, mono, rtol=1e-5, atol=1e-5)
    resumed = te.resume_generate(chunked.argmax(-1), cache, gen)
    assert torch.equal(resumed.tokens, te.generate(p, gen).tokens)


def test_ngram_speculative_equals_the_plain_loop_and_reference():
    je, te = engines(ARCH, False)
    for p in (np.asarray([[5, 9, 13] * 4], np.int32), _prompts(10, b=1, s=12)):
        got = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=12),
                          speculative=SpeculativeConfig(k=3))
        want = je.generate(jnp.asarray(p), JGen(max_new_tokens=12), speculative=JSpecCfg(k=3))
        plain = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=12))
        assert torch.equal(got.tokens, plain.tokens)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        assert (got.verify_steps, got.accepted_drafts) == (want.verify_steps,
                                                           want.accepted_drafts)


# -- the other dense archs' greedy gates ---------------------------------------------------

DENSE = [(a, q, f) for a in ("qwen1.5-4b", "internlm2-1.8b") for q in QUANT
         for f in (None, "int8_tok")]


@pytest.mark.parametrize("arch,quantize,fmt", DENSE, ids=[
    f"{a}-{'deployed' if q else 'fp'}-{f or 'f32'}" for a, q, f in DENSE])
def test_dense_greedy_gate(arch, quantize, fmt):
    _greedy_gate(arch, quantize, fmt, 11)
