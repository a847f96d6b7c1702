"""Dense GQA (reduced qwen3-8b) through repro_torch against the JAX package.

Kernel level: the plain versions of the two slice-2 kernels against the JAX
Pallas kernels run as the reference's own tests run them on the CPU
(interpret mode): `flash_decode_ref` for every cache format at rtol 2e-5 /
atol 2e-6 (tests/test_flash_decode.py), `rmsnorm_stats_ref` at 1e-6
(tests/test_kernels.py).  Layer level: prefill attention against
`layers.flash_attention` at 1e-5.  Model level: one JAX param tree
(``lm.init``, then ``deploy.deploy_quantize`` for the deployed case) carried
into the port by `repro_torch.bridge`; prefill logits, every layer's K/V
cache and 8 decode steps' logits, with the fp cache and both encoded ones,
at 1e-4 for fp weights and `QUANT_REL` of max|reference| for deployed ones
(the dynamic int8 activation rounding, ROADMAP C).  Decode feeds both sides
the same tokens.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_retnet import QUANT_REL

from repro import configs as Jconfigs
from repro.core import kvq as Jkvq
from repro.core.hsa import HSAConfig, HSAEngine as JHSA
from repro.kernels import ops as Jops
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import deploy as Jdeploy
from repro.models import layers as JL
from repro.models import lm as Jlm
from repro_torch import bridge, configs as Tconfigs
from repro_torch.core.hsa import HSAConfig as THSAConfig, HSAEngine as THSA
from repro_torch.kernels import ops as Tops
from repro_torch.models import deploy as Tdeploy
from repro_torch.models import layers as TL
from repro_torch.models import lm as Tlm

TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-5, atol=2e-6)
CACHE_FORMATS = [None, "int8_tok", "mxint4_blk"]


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


# -- kernels -------------------------------------------------------------------


def _encode_both(x: np.ndarray, fmt: str):
    """The same cache bytes on both sides (the JAX encoding, carried over)."""
    if fmt == "fp":
        return _pair(x)
    if fmt == "legacy_int8":
        j = JL.to_cache_dtype(jnp.asarray(x), jnp.int8)
        return j, torch.from_numpy(np.array(j))
    j = Jkvq.encode(jnp.asarray(x), fmt)
    return j, {n: torch.from_numpy(np.array(a)) for n, a in j.items()}


@pytest.mark.parametrize("kv_len", [1, 17, 24])
@pytest.mark.parametrize("fmt", ["fp", "legacy_int8", "int8_tok", "mxint4_blk"])
def test_flash_decode_plain_matches_pallas(fmt, kv_len):
    rng = np.random.default_rng(11)
    b, kv, g, d, c = 2, 2, 3, 32, 24
    qj, qt = _pair(rng.normal(size=(b, kv, g, d)).astype(np.float32))
    kj, kt = _encode_both(rng.normal(size=(b, c, kv, d)).astype(np.float32), fmt)
    vj, vt = _encode_both(rng.normal(size=(b, c, kv, d)).astype(np.float32), fmt)
    want = flash_decode_pallas(qj, kj, vj, jnp.int32(kv_len), interpret=True)
    got = Tops.flash_decode(qt, kt, vt, torch.tensor(kv_len, dtype=torch.int32), impl="ref")
    assert got.dtype == torch.float32 and got.shape == (b, kv, g, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)


def test_flash_decode_plain_matches_attend_one_step_with_mixed_formats():
    """K and V may be encoded differently; the prefix mask equals the
    reference oracle's explicit mask."""
    rng = np.random.default_rng(12)
    q = rng.normal(size=(1, 2, 4, 32)).astype(np.float32)
    kj, kt = _encode_both(rng.normal(size=(1, 9, 2, 32)).astype(np.float32), "mxint4_blk")
    vj, vt = _encode_both(rng.normal(size=(1, 9, 2, 32)).astype(np.float32), "int8_tok")
    valid = jnp.arange(9)[None, :] < 6
    want = JL.attend_one_step(jnp.asarray(q), kj, vj, valid)
    got = Tops.flash_decode(torch.from_numpy(q), kt, vt, torch.tensor(6, dtype=torch.int32),
                           impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)
    also = TL.attend_one_step(torch.from_numpy(q), kt, vt,
                              torch.from_numpy(np.array(valid)))
    np.testing.assert_allclose(also.numpy(), np.asarray(want), **DECODE_TOL)


def test_flash_decode_rejects_bad_lengths_and_the_mla_layout():
    """Bad lengths raise in both layouts: kv_len is an int32 tensor on the
    query's device, a scalar as the Pallas kernel's operand is or one length
    per batch lane (a host int, an int64 tensor, or a vector whose length is
    not the batch's, is not); the MLA layout (q.ndim == 3) needs q2, k2 and
    scale, as the reference's rule is."""
    q, k = torch.zeros(1, 1, 2, 16), torch.zeros(1, 4, 1, 16)
    lat, q2, k2 = k[:, :, 0], torch.zeros(1, 2, 4), torch.zeros(1, 4, 4)
    two = torch.tensor(2, dtype=torch.int32)
    for bad in (2, torch.tensor(2), torch.tensor([2, 2], dtype=torch.int32)):
        with pytest.raises((TypeError, ValueError), match="kv_len"):
            Tops.flash_decode(q, k, k, bad)
        with pytest.raises((TypeError, ValueError), match="kv_len"):
            Tops.flash_decode(torch.zeros(1, 2, 16), lat, lat, bad, q2=q2, k2=k2, scale=0.5)
    for missing in ("q2", "k2", "scale"):
        kw = {n: v for n, v in (("q2", q2), ("k2", k2), ("scale", 0.5)) if n != missing}
        with pytest.raises(ValueError, match="MLA"):
            Tops.flash_decode(torch.zeros(1, 2, 16), lat, lat, two, **kw)
    assert Tops.flash_decode(torch.zeros(1, 2, 16), lat, lat, two, q2=q2, k2=k2,
                             scale=0.5).shape == (1, 2, 16)


@pytest.mark.parametrize("m,d", [(8, 64), (32, 512), (7, 96)])
def test_rmsnorm_stats_plain_matches_pallas(m, d):
    yj, yt = _pair(np.random.default_rng(m + d).normal(size=(m, d)).astype(np.float32))
    want = Jops.rmsnorm_stats(yj, impl="pallas", interpret=True)
    got = Tops.rmsnorm_stats(yt, impl="ref")
    assert got.shape == (m,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_rmsnorm_stats_keeps_leading_dims_and_takes_bf16():
    y = np.random.default_rng(2).normal(size=(2, 3, 64)).astype(np.float32)
    yb = jnp.asarray(y).astype(jnp.bfloat16)
    want = Jops.rmsnorm_stats(yb, impl="pallas", interpret=True)
    got = Tops.rmsnorm_stats(bridge.to_tensor(np.asarray(yb)))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sq,causal,q_chunk,kv_chunk", [
    (16, True, 512, 1024), (37, True, 8, 16), (20, False, 8, 8)])
def test_prefill_attention_matches_flash_attention(sq, causal, q_chunk, kv_chunk):
    rng = np.random.default_rng(sq)
    qj, qt = _pair(rng.normal(size=(2, sq, 2, 2, 32)).astype(np.float32))
    kj, kt = _pair(rng.normal(size=(2, sq, 2, 32)).astype(np.float32))
    vj, vt = _pair(rng.normal(size=(2, sq, 2, 32)).astype(np.float32))
    want = JL.flash_attention(qj, kj, vj, causal=causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk)
    got = TL.flash_attention(qt, kt, vt, causal=causal, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- configs -------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(Tconfigs.REGISTRY))
def test_rope_dim_matches_reference(name):
    tc, jc = Tconfigs.get_config(name), Jconfigs.get_config(name)
    assert Tlm._rope_dim(tc) == Jlm._rope_dim(jc)
    assert Tlm._rope_dim(tc.reduced()) == Jlm._rope_dim(jc.reduced())


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen1.5-4b", "internlm2-1.8b",
                                  "starcoder2-15b", "hymba-1.5b", "llava-next-34b",
                                  "deepseek-v3-671b", "olmoe-1b-7b"])
def test_dense_family_gate(name):
    """Dense RMSNorm archs pass; deepseek-v3 passes only cut to its leading
    dense layers (its MoE layers, like olmoe's, are not ported)."""
    cfg = Tconfigs.get_config(name).reduced()
    if name in ("qwen3-8b", "qwen1.5-4b", "internlm2-1.8b"):
        Tlm._check_family(cfg)
    else:
        with pytest.raises(NotImplementedError, match="not ported"):
            Tlm._check_family(cfg)
    if name == "deepseek-v3-671b":
        for full in (cfg, Tconfigs.get_config(name)):
            with pytest.raises(NotImplementedError, match="MoE"):
                Tlm._check_family(full)
        for cut in (cfg, Tconfigs.get_config(name)):
            Tlm._check_family(dataclasses.replace(cut, n_layers=cut.first_dense_layers))


# -- reduced qwen3-8b, model level ------------------------------------------------

CFG = Jconfigs.get_config("qwen3-8b").reduced()
S, NEW = 16, 8
CACHE_LEN = S + NEW


def _close(got, want, quantize, msg=""):
    want = np.asarray(want)
    if quantize:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=QUANT_REL * np.abs(want).max(), err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **TOL)


@functools.lru_cache(maxsize=None)
def _sides(arch: str, quantize: bool):
    cfg = Jconfigs.get_config(arch).reduced()
    params, _, paths = Jlm.init(cfg, jax.random.key(0))
    if quantize:
        params = Jdeploy.deploy_quantize(params, paths)
    fmt = ("w8a8", "mxint4") if quantize else ("fp", "fp")
    jh = JHSA(HSAConfig(prefill_format=fmt[0], decode_format=fmt[1]))
    th = THSA(THSAConfig(prefill_format=fmt[0], decode_format=fmt[1]))
    model = bridge.model_from_tree(cfg, jax.tree.map(np.asarray, jax.device_get(params)))
    prefill = jax.jit(lambda p, t: Jlm.forward_prefill(p, {"tokens": t}, cfg, jh,
                                                       cache_len=CACHE_LEN))
    decode = jax.jit(lambda p, t, c: Jlm.forward_decode(p, t, c, cfg, jh))
    return cfg, params, prefill, decode, model, th


def _prompts(seed=7):
    return np.random.default_rng(seed).integers(1, CFG.vocab_size, (2, S)).astype(np.int32)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_prefill_logits_and_kv_cache(quantize):
    cfg, params, prefill, _, model, th = _sides("qwen3-8b", quantize)
    toks = _prompts()
    jl, jc = prefill(params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(model, torch.from_numpy(toks).long(), cfg, th,
                                 cache_len=CACHE_LEN)
    _close(tl.numpy(), jl, quantize)
    for name in ("k", "v"):
        got = np.stack([blk[name].numpy() for blk in tc["blocks"]])
        assert got.shape == (cfg.n_layers, 2, CACHE_LEN, cfg.n_kv_heads, cfg.head_dim_)
        _close(got, jc["blocks"][name], quantize, name)
        assert not got[:, :, S:].any()          # right-padded with zeros
    assert tc["pos"] == int(jc["pos"]) == S


@pytest.mark.parametrize("fmt", CACHE_FORMATS, ids=["f32", "int8_tok", "mxint4_blk"])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_eight_decode_steps(quantize, fmt):
    cfg, params, prefill, decode, model, th = _sides("qwen3-8b", quantize)
    toks = _prompts()
    jl, jc = prefill(params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(model, torch.from_numpy(toks).long(), cfg, th,
                                 cache_len=CACHE_LEN)
    if fmt is not None:                 # eagerly, as the JAX engine does
        jc, tc = Jlm.quantize_cache(jc, cfg, fmt), Tlm.quantize_cache(tc, cfg, fmt)
    for step in range(NEW):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = decode(params, jnp.asarray(tok), jc)
        tl, tc = Tlm.forward_decode(model, torch.from_numpy(tok).long(), tc, cfg, th)
        _close(tl.numpy(), jl, quantize, f"step {step}")
    assert tc["pos"] == int(jc["pos"]) == S + NEW
    np.testing.assert_allclose(tc["rope"].sin.numpy(), np.asarray(jc["rope"].sin),
                               atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "internlm2-1.8b"])
def test_other_dense_rmsnorm_archs_prefill(arch):
    """The dense gate admits every RMSNorm GQA arch without windows or
    frontends: qwen1.5 (qkv bias, no QK-norm) and internlm2 go the same way."""
    cfg, params, prefill, _, model, th = _sides(arch, False)
    toks = _prompts(3)
    jl, jc = prefill(params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(model, torch.from_numpy(toks).long(), cfg, th,
                                 cache_len=CACHE_LEN)
    _close(tl.numpy(), jl, False)
    _close(tc["blocks"][-1]["k"].numpy(), jc["blocks"]["k"][-1], False)


def test_decode_from_cold_cache_matches_one_token_prefill():
    """`make_decode_cache(start_pos=0)` is the exact empty state: decoding
    the first token from it gives the logits and K/V of a one-token prefill."""
    cfg, _, _, _, model, th = _sides("qwen3-8b", False)
    tok = torch.from_numpy(_prompts()[:, :1]).long()
    lp, cp = Tlm.forward_prefill(model, tok, cfg, th, cache_len=4)
    cold = Tlm.make_decode_cache(cfg, 2, 4, dtype=torch.float32, device="cpu")
    ld, cd = Tlm.forward_decode(model, tok, cold, cfg, th)
    torch.testing.assert_close(ld, lp, **TOL)
    assert cd["pos"] == cp["pos"] == 1
    for a, b in zip(cd["blocks"], cp["blocks"]):
        torch.testing.assert_close(a["k"], b["k"], **TOL)
        torch.testing.assert_close(a["v"], b["v"], **TOL)


def test_port_deploy_matches_reference_deploy():
    """The port's deploy pass gives the reference's bytes for every dense
    linear; wk/wv (N = KV * hd, a multiple of 32) carry MXINT4 too."""
    cfg, params = _sides("qwen3-8b", False)[:2]
    deployed = _sides("qwen3-8b", True)[1]
    model = Tdeploy.deploy_quantize(bridge.model_from_tree(
        cfg, jax.tree.map(np.asarray, jax.device_get(params))))
    want = bridge.model_from_tree(cfg, jax.tree.map(np.asarray,
                                                    jax.device_get(deployed)))
    got_bufs, want_bufs = dict(model.named_buffers()), dict(want.named_buffers())
    assert got_bufs.keys() == want_bufs.keys()
    for name, t in want_bufs.items():
        assert torch.equal(got_bufs[name], t), name
    for blk in model.blocks:
        assert blk.attn.wk.mx_packed is not None and blk.attn.wv.mx_packed is not None
        assert blk.attn.qnorm.g.shape == (cfg.head_dim_,)
