"""The vision frontend (llava-next-34b) through repro_torch against the JAX
package, on the CPU.

Two configurations: reduced llava-next-34b (2 dense GQA layers, d_model
128, 4 heads over 2 KV heads of 32, 8 patch tokens) and the reference's own
``vlm`` test shape (``FAMILIES["vlm"]`` of tests/test_models.py: d_model 64,
head dim 16, 8 patch tokens), each with the reference's weights carried over
by `repro_torch.bridge`, on fp weights and on the default deployment:

* `_embed`'s splice of the patch embeddings over the prompt's head, bit for
  bit, at S > P and S = P (and a prompt shorter than its patches refused);
* the prefill logits and every cache leaf, exact and bucketed: 1e-5 on fp
  weights, 1e-2 of max|reference| deployed (`QUANT_REL`);
* prefill(S) + decode(token S) against prefill(S + 1) (the reference's
  ``test_decode_consistency``), 1e-4;
* greedy `generate` tokens equal to the JAX engine's in the f32, int8_tok
  and mxint4_blk caches, fp and deployed;
* the bridge consuming every leaf of the reduced llava tree;
* the reference's refusals: chunked admission, the scheduler (its chunked
  admission), the prefix cache (no sharing mode, so its admission is the
  scheduler's) and speculative decode;
* `lm.init(deployed=True)`, which deploys block by block as it draws,
  equal byte for byte to the whole init followed by `deploy_quantize`.

The card's side (llava's full-width shapes through the kernels, the
captured step against the eager loop) is driven by chip_smoke.py.
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
from repro_torch.serving import Request, RequestScheduler
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "llava-next-34b"
MODELS = ["llava", "family"]
FORMATS, FORMAT_IDS = [None, "int8_tok", "mxint4_blk"], ["f32", "int8_tok", "mxint4_blk"]
QUANT, QUANT_IDS = [False, True], ["fp", "deployed"]
FP_TOL = 1e-5
B, S, NEW = 2, 13, 6
CACHE_LEN = S + NEW


@functools.lru_cache(maxsize=None)
def engines(model: str, quantize: bool):
    """(JAX engine, port engine on its carried weights, patch embeddings as
    the reference's stub gives them).  ``llava``: the reduced registry
    config through the JAX engine; ``family``: the reference's test shape,
    its params from `lm.init` (deployed by `deploy.deploy_quantize` when
    ``quantize``)."""
    if model == "llava":
        je = JEngine.from_config(ARCH, JSpec(reduced=True, quantize=quantize))
        cfg = Tconfigs.get_config(ARCH).reduced()
    else:
        jcfg = FAMILIES["vlm"]
        params, _, paths = Jlm.init(jcfg, jax.random.key(0))
        if quantize:
            params = Jdeploy.deploy_quantize(params, paths)
        je = JEngine(jcfg, params, JSpec(quantize=quantize))
        cfg = TConfig(**dataclasses.asdict(jcfg))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    te = InferenceEngine.from_config(cfg, EngineSpec(quantize=quantize),
                                     model=bridge.model_from_tree(cfg, tree, device="cpu"),
                                     device="cpu")
    return je, te, JF.synth_patch_embeds(je.cfg, B, seed=3)


def _patches(p) -> torch.Tensor:
    return bridge.to_tensor(np.asarray(p))


def _close(got, want, quantize: bool, what: str = "") -> None:
    want = np.asarray(want, dtype=np.float32)
    got = np.asarray(got, dtype=np.float32)
    if quantize:
        np.testing.assert_allclose(got, want, rtol=0, atol=QUANT_REL * np.abs(want).max(),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=FP_TOL, atol=FP_TOL, err_msg=what)


def _prompts(te, seed: int, s: int = S) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, te.cfg.vocab_size, (B, s)).astype(np.int32)


# -- the splice -----------------------------------------------------------------------


@pytest.mark.parametrize("extra", [0, 5], ids=["s_eq_p", "s_gt_p"])
@pytest.mark.parametrize("model", MODELS)
def test_embed_splices_the_patches_over_the_prompts_head(model, extra):
    je, te, patches = engines(model, False)
    p = je.cfg.frontend_tokens
    toks = _prompts(te, 11, p + extra)
    want = Jlm._embed(je.params, {"tokens": jnp.asarray(toks), "patch_embeds": patches}, je.cfg)
    with torch.inference_mode():
        got = Tlm._embed(te.model, torch.from_numpy(toks).long(), te.cfg,
                         patch_embeds=_patches(patches))
        plain = Tlm._embed(te.model, torch.from_numpy(toks).long(), te.cfg)
    assert got.shape == (B, p + extra, te.cfg.d_model) and got.dtype == plain.dtype
    assert torch.equal(got, bridge.to_tensor(np.asarray(want)))
    assert torch.equal(got[:, :p], _patches(patches).to(got.dtype))
    assert torch.equal(got[:, p:], plain[:, p:])


def test_embed_refuses_more_patches_than_tokens():
    _, te, patches = engines("llava", False)
    toks = torch.from_numpy(_prompts(te, 1, te.cfg.frontend_tokens - 1)).long()
    with pytest.raises(ValueError, match="patch embeddings"):
        Tlm._embed(te.model, toks, te.cfg, patch_embeds=_patches(patches))


def test_stub_and_config_match_the_reference():
    from repro.configs import get_config
    jcfg, tcfg = get_config(ARCH), Tconfigs.get_config(ARCH)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert TF.vision_tokens(tcfg) == JF.vision_tokens(jcfg) == 2880
    want = np.asarray(JF.synth_patch_embeds(jcfg.reduced(), 2, seed=2))
    got = TF.synth_patch_embeds(tcfg.reduced(), 2, seed=2, device="cpu")
    assert torch.equal(got, bridge.to_tensor(want))
    assert Tlm.layer_groups(tcfg) == Jlm.layer_groups(jcfg) == [("blocks", 60, "dense")]


# -- prefill --------------------------------------------------------------------------


@pytest.mark.parametrize("bucket", [False, True], ids=["exact", "bucketed"])
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_prefill_logits_and_every_cache_leaf(model, quantize, bucket):
    """13 tokens (8 of them patches; bucketed: padded to 16, the cache at
    the ladder's 32 slots): the logits at the real last token, every K / V
    leaf, the position and the rope state against the reference's."""
    je, te, patches = engines(model, quantize)
    toks = _prompts(te, 7)
    jl, jc = je.prefill(jnp.asarray(toks), cache_len=CACHE_LEN, bucket=bucket,
                        extras={"patch_embeds": patches})
    with torch.inference_mode():
        tl, tc = te.prefill(torch.from_numpy(toks), cache_len=CACHE_LEN, bucket=bucket,
                            extras={"patch_embeds": _patches(patches)})
    _close(tl.numpy(), jl, quantize, "logits")
    cfg, c = te.cfg, 32 if bucket else CACHE_LEN
    for name in ("k", "v"):
        got = np.stack([blk[name].numpy() for blk in tc["blocks"]])
        assert got.shape == (cfg.n_layers, B, c, cfg.n_kv_heads, cfg.head_dim_), name
        _close(got, jc["blocks"][name], quantize, name)
    assert int(tc["pos"]) == int(jc["pos"]) == S
    np.testing.assert_allclose(tc["rope"].sin.numpy(), np.asarray(jc["rope"].sin), atol=2e-5)
    np.testing.assert_allclose(tc["rope"].cos.numpy(), np.asarray(jc["rope"].cos), atol=2e-5)


@pytest.mark.parametrize("model", MODELS)
def test_bucketed_prefill_equals_the_exact_one(model):
    """fp weights: the bucketed prefill's logits and real cache rows equal
    the exact prefill's (the padding is causal-masked from every real
    token), the splice included."""
    _, te, patches = engines(model, False)
    toks = torch.from_numpy(_prompts(te, 5))
    extras = {"patch_embeds": _patches(patches)}
    with torch.inference_mode():
        le, ce = te.prefill(toks, cache_len=CACHE_LEN, extras=extras)
        lb, cb = te.prefill(toks, cache_len=CACHE_LEN, extras=extras, bucket=True)
    np.testing.assert_allclose(lb.numpy(), le.numpy(), rtol=FP_TOL, atol=FP_TOL)
    for be, bb in zip(ce["blocks"], cb["blocks"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(bb[name][:, :S].numpy(), be[name][:, :S].numpy(),
                                       rtol=FP_TOL, atol=FP_TOL)


@pytest.mark.parametrize("model", MODELS)
def test_decode_consistency(model):
    """prefill(S) + decode(token S) == prefill(S + 1) last logits (fp): the
    patches reach the decode step only through the cache."""
    _, te, patches = engines(model, False)
    p = torch.from_numpy(_prompts(te, 8, S + 1))
    extras = {"patch_embeds": _patches(patches)}
    with torch.inference_mode():
        _, cache = te.prefill(p[:, :S], cache_len=S + 4, extras=extras)
        dec, _ = te.decode_step(p[:, S:], cache)
        ref, _ = te.prefill(p, extras=extras)
    rel = float((dec - ref).abs().max() / ref.abs().max())
    assert rel < 1e-4, rel


def test_the_patches_move_the_prefill():
    """The splice is not a no-op: the same tokens without their patches
    give other logits (a prompt's head is then its own token ids)."""
    _, te, patches = engines("llava", False)
    toks = torch.from_numpy(_prompts(te, 9))
    with torch.inference_mode():
        with_p, _ = te.prefill(toks, extras={"patch_embeds": _patches(patches)})
        without, _ = te.prefill(toks)
    assert float((with_p - without).abs().max()) > 1e-3 * float(without.abs().max())


# -- greedy generate -------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
@pytest.mark.parametrize("model", MODELS)
def test_greedy_tokens_identical_to_jax(model, quantize, fmt):
    je, te, patches = engines(model, quantize)
    p = _prompts(te, 4)
    want = je.generate(jnp.asarray(p), JGen(max_new_tokens=NEW, cache_format=fmt),
                       extras={"patch_embeds": patches})
    got = te.generate(torch.from_numpy(p), GenerationConfig(max_new_tokens=NEW, cache_format=fmt),
                      extras={"patch_embeds": _patches(patches)})
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


# -- bridge, deployment, init ---------------------------------------------------------


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("quantize", QUANT, ids=QUANT_IDS)
def test_bridge_consumes_every_leaf(quantize):
    """Every leaf of the reduced llava tree lands value for value in the
    port's tensor of that name (a deployed W8A8 weight in the corner of its
    K-major buffer), and the port holds no other tensor."""
    je, te, _ = engines("llava", quantize)
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    port = {**dict(te.model.named_parameters()), **dict(te.model.named_buffers())}
    assert set(tree) == {"embed", "blocks", "final_norm", "lm_head"}
    assert all(type(b) is Tlm.DenseBlock for b in te.model.blocks)
    named = [(f"blocks.{i}.{name}", leaf[i]) for name, leaf in _leaves(tree["blocks"])
             for i in range(te.cfg.n_layers)]
    for top in ("embed", "final_norm", "lm_head"):
        named += list(_leaves(tree[top], top))
    seen = set()
    for name, leaf in named:
        got, want = port[name], bridge.to_tensor(leaf)
        if name.endswith("w8_vals"):
            got = got[:want.shape[0], :want.shape[1]]
        assert got.dtype == want.dtype and torch.equal(got, want), name
        seen.add(name)
    assert seen == set(port)
    assert any(n.endswith("mx_packed") for n in seen) == quantize


def _tensors(model) -> dict:
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("arch", [ARCH, "deepseek-v3-671b", "seamless-m4t-medium",
                                  "olmoe-1b-7b"])
def test_init_deployed_block_by_block_equals_init_then_deploy(arch):
    """`lm.init(deployed=True)` deploys each block as soon as it is drawn,
    then the rest: every tensor byte for byte (dtype, shape and bits) equal
    to the whole init followed by `deploy_quantize`, and no master left
    where deploy drops it (reduced configs: llava, deepseek-v3 with its MoE
    layers, MTP head and kept MLA masters, the encoder-decoder, olmoe)."""
    cfg = Tconfigs.get_config(arch).reduced()
    whole = Tdeploy.deploy_quantize(Tlm.init(cfg, seed=3, device="cpu"))
    blockwise = Tlm.init(cfg, seed=3, device="cpu", deployed=True)
    a, b = _tensors(whole), _tensors(blockwise)
    assert a.keys() == b.keys()
    for name, t in a.items():
        u = b[name]
        assert (t.dtype, t.shape) == (u.dtype, u.shape), name
        assert t.stride() == u.stride() and torch.equal(_bytes(t), _bytes(u)), name
    assert not Tdeploy.is_master(blockwise)
    eng = InferenceEngine.from_config(cfg, EngineSpec(seed=3), device="cpu")
    assert all(torch.equal(t, _tensors(eng.model)[n]) for n, t in a.items())


def test_from_config_serves_llava():
    eng = InferenceEngine.from_config(ARCH, EngineSpec(reduced=True), device="cpu")
    m = eng.model
    assert [type(b) for b in m.blocks] == [Tlm.DenseBlock] * 2
    assert m.lm_head.w is None and m.blocks[0].mlp.wg.mx_packed is not None
    assert eng.cfg.frontend == "vision" and eng.cfg.frontend_tokens == 8
    assert Tlm.prefix_sharing_mode(eng.cfg) is None


# -- the reference's refusals ---------------------------------------------------------


@pytest.mark.parametrize("what", ["chunked", "scheduler", "prefix", "speculative"])
def test_refusals_match_the_reference(what):
    """Each path the reference refuses a vision model raises
    NotImplementedError on both sides: chunked admission, the scheduler's
    admission (its chunks), the scheduler with the prefix cache on (no
    sharing mode: its admission is the same chunked prefill) and
    speculative decode."""
    je, te, patches = engines("llava", False)
    p = _prompts(te, 2)
    gen = GenerationConfig(max_new_tokens=4)

    def port():
        if what == "chunked":
            te.begin_chunked_prefill(torch.from_numpy(p), cache_len=20, chunk_size=8).advance()
        elif what == "speculative":
            te.generate(torch.from_numpy(p), gen, speculative=SpeculativeConfig(k=3),
                        extras={"patch_embeds": _patches(patches)})
        else:
            sched = RequestScheduler(te, classes=[(2, 20)], gen=gen, chunk_size=8,
                                     prefix_cache=what == "prefix")
            assert sched.pool.prefix.mode is None
            sched.submit(Request(uid=0, prompt=p[0].tolist()))
            sched.run()

    def reference():
        if what == "chunked":
            je.begin_chunked_prefill(jnp.asarray(p), cache_len=20, chunk_size=8).advance()
        elif what == "speculative":
            je.generate(jnp.asarray(p), JGen(max_new_tokens=4), speculative=JSpecCfg(k=3),
                        extras={"patch_embeds": patches})
        else:
            sched = JScheduler(je, classes=[(2, 20)], gen=JGen(max_new_tokens=4), chunk_size=8,
                               prefix_cache=what == "prefix")
            sched.submit(JRequest(uid=0, prompt=p[0].tolist()))
            sched.run()

    for run in (reference, port):
        with pytest.raises(NotImplementedError):
            run()
