"""The encoder-decoder (seamless-m4t-medium) through repro_torch against the
JAX package, on the CPU.

Two configurations: reduced seamless-m4t-medium (2 encoder and 2 decoder
layers, d_model 128, 4 heads over 2 KV heads of 32, LayerNorm, an ungated
GeLU MLP, 8 frames) and the reference's own encoder-decoder test shape
(``FAMILIES["encdec"]`` of tests/test_models.py: d_model 64, head dim 16,
16 frames), each with the reference's weights carried over by
`repro_torch.bridge`, on fp weights and on the default deployment:

* the frontend stubs' bytes and `_sinusoidal` against the reference's;
* the encoder's output, one decoder block over the full sequence (output
  and cache seed, cross leaves included) and in decode, and the prefill
  logits with every cache leaf: 1e-5 on fp weights, 1e-2 of max|reference|
  deployed;
* prefill(S) + decode(token S) against prefill(S + 1) (the reference's
  ``test_decode_consistency``), 1e-4;
* 6 decode steps' logits in each cache format from one prefill, both sides
  fed the same tokens, and greedy `generate` tokens equal to the JAX
  engine's in each cache format, fp and deployed;
* `quantize_cache`'s cross leaves byte for byte against the reference's
  `kvq.encode`, `cache_nbytes`, the deploy pass over the new linears, the
  bridge's refusal of an unknown group;
* the reference's refusals: bucketed prefill, chunked admission (and so the
  scheduler's), speculative decode.

The card's side (flash-decode at the cross and self shapes, the captured
step against the eager loop) is in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_models import FAMILIES
from test_torch_retnet import QUANT_REL

from repro.core import kvq as Jkvq
from repro.models import deploy as Jdeploy
from repro.models import frontends as JF
from repro.models import lm as Jlm
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import RequestScheduler as JScheduler
from repro.serving import SpeculativeConfig as JSpecCfg
from repro_torch import bridge, configs as Tconfigs
from repro_torch.models import deploy as Tdeploy
from repro_torch.models import frontends as TF
from repro_torch.models import lm as Tlm
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.modules import Linear
from repro_torch.serving import Request, RequestScheduler
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "seamless-m4t-medium"
MODELS = ["seamless", "family"]
FORMATS, FORMAT_IDS = [None, "int8_tok", "mxint4_blk"], ["f32", "int8_tok", "mxint4_blk"]
QUANT, QUANT_IDS = [False, True], ["fp", "deployed"]
FP_TOL = 1e-5
B, S, NEW = 2, 12, 6
CACHE_LEN = S + NEW


@functools.lru_cache(maxsize=None)
def engines(model: str, quantize: bool):
    """(JAX engine, port engine on its carried weights, frames as both
    sides take them).  ``seamless``: the reduced registry config through
    the JAX engine; ``family``: the reference's test shape, its params from
    `lm.init` (deployed by `deploy.deploy_quantize` when ``quantize``)."""
    if model == "seamless":
        je = JEngine.from_config(ARCH, JSpec(reduced=True, quantize=quantize))
        cfg = Tconfigs.get_config(ARCH).reduced()
    else:
        jcfg = FAMILIES["encdec"]
        params, _, paths = Jlm.init(jcfg, jax.random.key(0))
        if quantize:
            params = Jdeploy.deploy_quantize(params, paths)
        je = JEngine(jcfg, params, JSpec(quantize=quantize))
        cfg = TConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    te = InferenceEngine.from_config(cfg, EngineSpec(quantize=quantize),
                                     model=bridge.model_from_tree(cfg, tree, device="cpu"),
                                     device="cpu")
    src = JF.synth_frame_embeds(je.cfg, B, je.cfg.frontend_tokens, seed=3)
    return je, te, src


def _src(src) -> torch.Tensor:
    return bridge.to_tensor(np.asarray(src))


def _close(got, want, quantize: bool, what: str = "", fp_tol: float = FP_TOL) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    if quantize:
        np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_REL * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=fp_tol, atol=fp_tol, err_msg=what)


def _prompts(te, seed: int, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, te.cfg.vocab_size, (B, s)).astype(np.int32)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# -- the frontend stubs and the sinusoid ----------------------------------------------


@pytest.mark.parametrize("full", [False, True], ids=["reduced_f32", "full_bf16"])
def test_synth_embeds_bytes_equal_the_reference(full):
    from repro.configs import get_config
    jcfg = get_config(ARCH) if full else get_config(ARCH).reduced()
    tcfg = Tconfigs.get_config(ARCH) if full else Tconfigs.get_config(ARCH).reduced()
    for seed in (0, 7):
        want = np.asarray(JF.synth_frame_embeds(jcfg, 2, 24, seed=seed))
        got = TF.synth_frame_embeds(tcfg, 2, 24, seed=seed, device="cpu")
        assert got.dtype == getattr(torch, tcfg.param_dtype)
        assert np.array_equal(bridge.to_tensor(want).view(torch.uint8).numpy(),
                              got.view(torch.uint8).numpy())
    vcfg, tv = get_config("llava-next-34b").reduced(), Tconfigs.get_config("llava-next-34b")
    want = np.asarray(JF.synth_patch_embeds(vcfg, 2, seed=1))
    got = TF.synth_patch_embeds(tv.reduced(), 2, seed=1, device="cpu")
    assert torch.equal(got, bridge.to_tensor(want))
    assert TF.vision_tokens(tv) == JF.vision_tokens(get_config("llava-next-34b")) == 2880


@pytest.mark.parametrize("d", [64, 128, 1024])
def test_sinusoid_matches_the_reference(d):
    pos = np.arange(2048)
    want = np.asarray(Jlm._sinusoidal(jnp.asarray(pos), d))
    got = Tlm._sinusoidal(torch.from_numpy(pos).to(torch.int32), d)
    assert got.dtype == torch.float32 and got.shape == (2048, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    lanes = Tlm._sinusoidal(torch.tensor([[5], [700]], dtype=torch.int32), d)
    np.testing.assert_allclose(lanes[:, 0].numpy(), want[[5, 700]], rtol=0, atol=1e-6)


# -- blocks and prefill ------------------------------------------------------------------


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_encoder_output(model, quantize):
    je, te, src = engines(model, quantize)
    jh, th = je.hsa, te.hsa
    want = Jlm._encode(je.params, {"src_embeds": src}, je.cfg, jh, "prefill")
    with torch.inference_mode():
        got = Tlm._encode(te.model, _src(src), te.cfg, th)
    assert got.shape == (B, je.cfg.frontend_tokens, je.cfg.d_model)
    _close(got.numpy(), want, quantize, "encoder output")


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_decoder_block_full_sequence_and_decode(model, quantize):
    """Decoder layer 0 on the same input and encoder output: the full-
    sequence block's output and cache seed (self K/V padded to the cache
    length, the cross K/V over the frames), then one decode step from the
    reference's cache at position S."""
    je, te, src = engines(model, quantize)
    jh, th = je.hsa, te.hsa
    cfg, d = te.cfg, te.cfg.d_model
    rng = np.random.default_rng(11)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    enc = np.array(Jlm._encode(je.params, {"src_embeds": src}, je.cfg, jh, "prefill"))
    jp = _layer(je.params["blocks"], 0)
    jy, jc, _ = Jlm._block_apply(jp, jnp.asarray(x), je.cfg, jh, "prefill", "dec",
                                 enc_kv=jnp.asarray(enc), cache_len=CACHE_LEN)
    blk = te.model.blocks[0]
    assert isinstance(blk, Tlm.DecoderBlock)
    with torch.inference_mode():
        ty, tc = Tlm._block_apply(blk, torch.from_numpy(x), cfg, th, "prefill", None, None,
                                  CACHE_LEN, enc_out=torch.from_numpy(enc))
    _close(ty.numpy(), jy, quantize, "block output")
    for name, got, want in (("self k", tc["self"]["k"], jc["self"]["k"]),
                            ("self v", tc["self"]["v"], jc["self"]["v"]),
                            ("cross k", tc["cross_k"], jc["cross_k"]),
                            ("cross v", tc["cross_v"], jc["cross_v"])):
        assert tuple(got.shape) == np.shape(want), name
        _close(got.numpy(), want, quantize, name)

    x1 = rng.normal(size=(B, 1, d)).astype(np.float32)
    jy1, jc1 = Jlm._block_decode(jp, jnp.asarray(x1), je.cfg, jh, "dec", jc, jnp.int32(S))
    tcache = jax.tree.map(lambda a: bridge.to_tensor(np.asarray(a)), jc)
    with torch.inference_mode():
        ty1, tc1 = Tlm._block_decode(blk, torch.from_numpy(x1), cfg, th, tcache,
                                     torch.tensor(S, dtype=torch.int32), None, None)
    _close(ty1.numpy(), jy1, quantize, "decode block output")
    _close(tc1["self"]["k"].numpy(), jc1["self"]["k"], quantize, "decode self k")
    assert tc1["cross_k"] is tcache["cross_k"]                  # read, never written


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_prefill_logits_and_every_cache_leaf(model, quantize):
    je, te, src = engines(model, quantize)
    p = _prompts(te, 7)
    jl, jc = je.prefill(jnp.asarray(p), cache_len=CACHE_LEN, extras={"src_embeds": src})
    with torch.inference_mode():
        tl, tc = te.prefill(torch.from_numpy(p), cache_len=CACHE_LEN,
                            extras={"src_embeds": _src(src)})
    _close(tl.numpy(), jl, quantize, "logits")
    cfg = te.cfg
    t_frames = je.cfg.frontend_tokens
    for path, shape in ((("self", "k"), CACHE_LEN), (("self", "v"), CACHE_LEN),
                        (("cross_k",), t_frames), (("cross_v",), t_frames)):
        def at(c, path=path):
            for k in path:
                c = c[k]
            return c
        got = np.stack([at(blk).numpy() for blk in tc["blocks"]])
        assert got.shape == (cfg.n_layers, B, shape, cfg.n_kv_heads, cfg.head_dim_), path
        _close(got, at(jc["blocks"]), quantize, "/".join(path))
    assert int(tc["pos"]) == int(jc["pos"]) == S and "rope" not in tc


@pytest.mark.parametrize("model", MODELS)
def test_decode_consistency(model):
    """prefill(S) + decode(token S) == prefill(S + 1) last logits (fp)."""
    _, te, src = engines(model, False)
    p = torch.from_numpy(_prompts(te, 8, S + 1))
    extras = {"src_embeds": _src(src)}
    with torch.inference_mode():
        _, cache = te.prefill(p[:, :S], cache_len=S + 4, extras=extras)
        dec, _ = te.decode_step(p[:, S:], cache)
        ref, _ = te.prefill(p, extras=extras)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 1e-4, rel


# -- decode steps and greedy generate -----------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_decode_step_logits(model, quantize, fmt):
    """NEW decode steps from one prefill, both sides fed the reference's
    greedy tokens: every step's logits, not only its token (on these seeded
    random weights the greedy stream repeats one token)."""
    je, te, src = engines(model, quantize)
    p = _prompts(te, 9)
    jl, jc = je.prefill(jnp.asarray(p), cache_len=CACHE_LEN, extras={"src_embeds": src})
    jc = je._encode_cache(jc, JGen(cache_format=fmt))
    with torch.inference_mode():
        tl, tc = te.prefill(torch.from_numpy(p), cache_len=CACHE_LEN,
                            extras={"src_embeds": _src(src)})
        tc = te._encode_cache(tc, GenerationConfig(cache_format=fmt))
        _close(tl.numpy(), jl, quantize, "prefill")
        for step in range(NEW):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            jl, jc = je.decode_step(jnp.asarray(tok), jc)
            tl, tc = te.decode_step(torch.from_numpy(tok).long(), tc)
            _close(tl.numpy(), jl, quantize, f"step {step}")
    assert int(tc["pos"]) == S + NEW


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_greedy_tokens_identical_to_jax(model, quantize, fmt):
    je, te, src = engines(model, quantize)
    p = _prompts(te, 4)
    want = je.generate(jnp.asarray(p), JGen(max_new_tokens=10, cache_format=fmt),
                       extras={"src_embeds": src})
    got = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=10, cache_format=fmt),
                      extras={"src_embeds": _src(src)})
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


# -- cache, deployment, bridge ------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS[1:], ids=FORMAT_IDS[1:])
def test_quantize_cache_encodes_cross_leaves_as_the_reference(fmt):
    """The reference's prefill cache, encoded by each side: the cross (and
    self) leaves' planes byte for byte, layer by layer."""
    je, te, src = engines("seamless", False)
    _, jc = je.prefill(jnp.asarray(_prompts(te, 5)), cache_len=CACHE_LEN,
                       extras={"src_embeds": src})
    tcache = {"pos": torch.tensor(int(jc["pos"]), dtype=torch.int32),
              "blocks": [jax.tree.map(lambda a, i=i: bridge.to_tensor(np.asarray(a[i])),
                                      jc["blocks"]) for i in range(te.cfg.n_layers)]}
    want = Jlm.quantize_cache(jc, je.cfg, fmt)["blocks"]
    got = Tlm.quantize_cache(tcache, te.cfg, fmt)["blocks"]
    for i, layer in enumerate(got):
        for name in ("cross_k", "cross_v"):
            ref = Jkvq.encode(jc["blocks"][name][i], fmt)
            for plane, t in layer[name].items():
                assert torch.equal(t, bridge.to_tensor(np.asarray(ref[plane]))), (i, name)
                assert torch.equal(t, bridge.to_tensor(np.asarray(want[name][plane][i])))
        for name in ("k", "v"):
            for plane, t in layer["self"][name].items():
                assert torch.equal(t, bridge.to_tensor(np.asarray(want["self"][name][plane][i])))


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
def test_cache_nbytes_matches_the_reference(fmt):
    je, te, _ = engines("seamless", False)
    for n in (1, 2):
        want = je.cache_nbytes(CACHE_LEN, batch=n, dtype=fmt or jnp.float32)
        assert te.cache_nbytes(CACHE_LEN, batch=n, dtype=fmt or torch.float32) == want
    cache = Tlm.make_decode_cache(te.cfg, 2, CACHE_LEN, dtype=fmt or torch.float32,
                                  device="cpu")
    cross = cache["blocks"][0]["cross_k"]
    assert Tlm.L.cache_capacity(cross) == te.cfg.frontend_tokens


def test_deploy_reaches_the_encoder_and_the_cross_attention():
    """`deploy.deploy_quantize` walks modules: the port's deploy of the
    reference's master weights gives the reference's deployed bytes on every
    linear, the encoder's and the cross-attention's included."""
    _, fp, _ = engines("seamless", False)
    _, dep, _ = engines("seamless", True)
    import copy
    mine = Tdeploy.deploy_quantize(copy.deepcopy(fp.model))
    lin = {n: m for n, m in mine.named_modules() if isinstance(m, Linear)}
    ref = {n: m for n, m in dep.model.named_modules() if isinstance(m, Linear)}
    assert lin.keys() == ref.keys()
    assert any(n.startswith("enc_blocks.") for n in lin)
    assert any(".cross.wk" in n for n in lin)
    for name, m in lin.items():
        assert m.w is None and m.w8_vals is not None and m.mx_packed is not None, name
        for buf in ("w8_vals", "w8_scale", "mx_packed", "mx_exps"):
            assert torch.equal(getattr(m, buf), getattr(ref[name], buf)), (name, buf)


def test_bridge_builds_both_stacks_and_rejects_an_unknown_group():
    je, te, _ = engines("seamless", False)
    assert len(te.model.enc_blocks) == te.cfg.encoder_layers == 2
    assert all(isinstance(b, Tlm.EncoderBlock) for b in te.model.enc_blocks)
    assert all(isinstance(b, Tlm.DecoderBlock) for b in te.model.blocks)
    assert te.model.enc_final_norm.layernorm
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    with pytest.raises(ValueError, match="unknown"):
        bridge.model_from_tree(te.cfg, dict(tree, dec_blocks=tree["blocks"]))
    with pytest.raises(ValueError, match="layers"):
        bridge.model_from_tree(te.cfg, dict(tree, enc_blocks=jax.tree.map(
            lambda a: a[:1], tree["enc_blocks"])))


def test_from_config_serves_seamless_and_its_init():
    eng = InferenceEngine.from_config(ARCH, EngineSpec(reduced=True), device="cpu")
    m = eng.model
    assert [type(b) for b in m.enc_blocks] == [Tlm.EncoderBlock] * 2
    assert [type(b) for b in m.blocks] == [Tlm.DecoderBlock] * 2
    assert m.blocks[0].mlp.wg is None and m.blocks[0].ln_cross.layernorm
    assert m.lm_head.w is None and m.blocks[0].cross.wk.mx_packed is not None
    from repro.configs import get_config
    assert Tlm.layer_groups(eng.cfg) == Jlm.layer_groups(get_config(ARCH).reduced()) == [
        ("enc_blocks", 2, "enc"), ("blocks", 2, "dec")]


# -- the reference's refusals -------------------------------------------------------------


@pytest.mark.parametrize("what", ["bucketed", "chunked", "speculative", "scheduler"])
def test_refusals_match_the_reference(what):
    """Each admission path the reference refuses for an encoder-decoder
    raises NotImplementedError on both sides."""
    je, te, src = engines("seamless", False)
    p = _prompts(te, 2)
    gen = GenerationConfig(max_new_tokens=4)

    def port():
        if what == "bucketed":
            te.prefill(torch.from_numpy(p), extras={"src_embeds": _src(src)}, bucket=True)
        elif what == "chunked":
            te.begin_chunked_prefill(torch.from_numpy(p), cache_len=20, chunk_size=8).advance()
        elif what == "speculative":
            te.generate(torch.from_numpy(p), gen, speculative=SpeculativeConfig(k=3),
                        extras={"src_embeds": _src(src)})
        else:
            sched = RequestScheduler(te, classes=[(2, 20)], gen=gen, chunk_size=8)
            sched.submit(Request(uid=0, prompt=p[0].tolist()))
            sched.run()

    def reference():
        if what == "bucketed":
            je.prefill(jnp.asarray(p), extras={"src_embeds": src}, bucket=True)
        elif what == "chunked":
            je.begin_chunked_prefill(jnp.asarray(p), cache_len=20, chunk_size=8).advance()
        elif what == "speculative":
            je.generate(jnp.asarray(p), JGen(max_new_tokens=4), speculative=JSpecCfg(k=3),
                        extras={"src_embeds": src})
        else:
            sched = JScheduler(je, classes=[(2, 20)], gen=JGen(max_new_tokens=4), chunk_size=8)
            sched.submit(JRequest(uid=0, prompt=p[0].tolist()))
            sched.run()

    for run in (reference, port):
        with pytest.raises(NotImplementedError):
            run()
