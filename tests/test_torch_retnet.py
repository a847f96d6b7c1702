"""Reduced retnet-1.3b through repro_torch against `repro.models.lm`.

One JAX param tree (``lm.init`` then, for the quantized case,
``deploy.deploy_quantize``) is carried into the port by `repro_torch.bridge`.
Prefill logits, every layer's retention state and 8 decode steps' logits
must agree, with fp weights and with the deployed W8A8/MXINT4 weights.
Decode feeds both sides the same tokens.

fp weights agree within the retention tolerance (1e-4).  Deployed weights
are held to 1e-2 of max|reference|: the dynamic int8 activation rounding is
a step function, so a last-bit difference upstream (rsqrt, f32 summation
order) can move one activation across a rounding boundary and shift the
logits by about one quantization step (2.5e-3 of max|logit| observed at
S = 256; logged in ROADMAP C).  Greedy tokens stay identical
(tests/test_torch_engine.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.hsa import HSAConfig, HSAEngine as JHSA
from repro.models import deploy as Jdeploy
from repro.models import lm as Jlm
from repro_torch import bridge
from repro_torch.core.hsa import HSAConfig as THSAConfig, HSAEngine as THSA
from repro_torch.models import deploy as Tdeploy
from repro_torch.models import lm as Tlm

TOL = dict(rtol=1e-4, atol=1e-4)
QUANT_REL = 1e-2


def _close(got, want, quantize, msg=""):
    want = np.asarray(want)
    if quantize:
        bound = QUANT_REL * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **TOL)


CFG = get_config("retnet-1.3b").reduced()


@functools.lru_cache(maxsize=None)
def _sides(quantize: bool):
    params, _, paths = Jlm.init(CFG, jax.random.key(0))
    if quantize:
        params = Jdeploy.deploy_quantize(params, paths)
    fmt = ("w8a8", "mxint4") if quantize else ("fp", "fp")
    jh = JHSA(HSAConfig(prefill_format=fmt[0], decode_format=fmt[1]))
    th = THSA(THSAConfig(prefill_format=fmt[0], decode_format=fmt[1]))
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    model = bridge.model_from_tree(CFG, tree, device="cpu")
    prefill = jax.jit(lambda p, t: Jlm.forward_prefill(p, {"tokens": t}, CFG, jh))
    decode = jax.jit(lambda p, t, c: Jlm.forward_decode(p, t, c, CFG, jh))
    return params, prefill, decode, model, th


def _prompts(s=16):
    return np.random.default_rng(7).integers(1, CFG.vocab_size, (2, s)).astype(np.int32)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("s", [16, 256])
def test_prefill_logits_and_state(quantize, s):
    params, prefill, _, model, th = _sides(quantize)
    toks = _prompts(s)
    jl, jc = prefill(params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(model, torch.from_numpy(toks).long(), CFG, th)
    _close(tl.numpy(), jl, quantize)
    st = np.stack([c["s"].numpy() for c in tc["blocks"]])
    _close(st, jc["blocks"]["s"], quantize)
    assert tc["pos"] == int(jc["pos"]) == s


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_eight_decode_steps(quantize):
    params, prefill, decode, model, th = _sides(quantize)
    toks = _prompts()
    jl, jc = prefill(params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(model, torch.from_numpy(toks).long(), CFG, th)
    for step in range(8):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = decode(params, jnp.asarray(tok), jc)
        tl, tc = Tlm.forward_decode(model, torch.from_numpy(tok).long(), tc, CFG, th)
        _close(tl.numpy(), jl, quantize, f"step {step}")
    st = np.stack([c["s"].numpy() for c in tc["blocks"]])
    _close(st, jc["blocks"]["s"], quantize)
    np.testing.assert_allclose(tc["rope"].sin.numpy(), np.asarray(jc["rope"].sin),
                               atol=2e-5)


def test_unfused_rmsnorm_prefill_matches():
    """The Eq. (4) ablation (``fuse_rmsnorm=False``) on both sides."""
    params, _, _, model, _ = _sides(False)
    cfg = dict(prefill_format="fp", decode_format="fp", fuse_rmsnorm=False)
    jh, th = JHSA(HSAConfig(**cfg)), THSA(THSAConfig(**cfg))
    toks = _prompts()
    jl, _ = jax.jit(lambda p, t: Jlm.forward_prefill(p, {"tokens": t}, CFG, jh))(
        params, jnp.asarray(toks))
    tl, _ = Tlm.forward_prefill(model, torch.from_numpy(toks).long(), CFG, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_decode_from_cold_cache_matches_one_token_prefill():
    """`make_decode_cache` is the exact empty state: decoding the first token
    from it gives the logits and state of a one-token prefill."""
    _, _, _, model, th = _sides(False)
    tok = torch.from_numpy(_prompts()[:, :1]).long()
    lp, cp = Tlm.forward_prefill(model, tok, CFG, th)
    ld, cd = Tlm.forward_decode(model, tok, Tlm.make_decode_cache(CFG, 2, device="cpu"),
                                CFG, th)
    torch.testing.assert_close(ld, lp, **TOL)
    assert cd["pos"] == cp["pos"] == 1
    for a, b in zip(cd["blocks"], cp["blocks"]):
        torch.testing.assert_close(a["s"], b["s"], **TOL)


def test_port_deploy_matches_reference_deploy():
    """The port's own deploy pass gives the bytes the bridge carries over."""
    params, deployed = _sides(False)[0], _sides(True)[0]
    tree = jax.tree.map(np.asarray, jax.device_get(params))
    model = Tdeploy.deploy_quantize(bridge.model_from_tree(CFG, tree))
    want = bridge.model_from_tree(CFG, jax.tree.map(np.asarray,
                                                    jax.device_get(deployed)))
    got_bufs, want_bufs = dict(model.named_buffers()), dict(want.named_buffers())
    assert got_bufs.keys() == want_bufs.keys()
    for name, t in want_bufs.items():
        assert torch.equal(got_bufs[name], t), name
    assert all(lin.w is None for lin in model.modules() if hasattr(lin, "w8_vals"))


def test_bridge_copies_bf16_bytes():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32))
                   .astype(jnp.bfloat16)).reshape(3, 4)
    t = bridge.to_tensor(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
