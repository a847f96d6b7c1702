"""Slice gates: repro_torch's `InferenceEngine.generate` emits the same
greedy tokens as the JAX engine, for reduced retnet-1.3b (slice 1) and for
reduced qwen3-8b with each KV-cache format (slice 2).

The JAX engine's params are carried into the port by `repro_torch.bridge`;
prompts are ``[2, 16]`` made with numpy from a seed, 12 new tokens each (the
quickstart shape), with ``quantize=False`` and with the default W8A8/MXINT4
deployment.  Engines are built once per (arch, quantize).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fp_engine
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro_torch import bridge
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SamplingParams


@functools.lru_cache(maxsize=None)
def _engines(quantize: bool, arch: str = "retnet-1.3b"):
    je = (fp_engine(arch) if not quantize else
          JEngine.from_config(arch, JSpec(reduced=True)))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    model = bridge.model_from_tree(je.cfg, tree, device="cpu")
    te = InferenceEngine.from_config(arch,
                                     EngineSpec(reduced=True, quantize=quantize),
                                     model=model, device="cpu")
    return je, te


def _prompts(seed=0):
    return np.random.default_rng(seed).integers(1, 512, (2, 16)).astype(np.int32)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "default_spec"])
def test_greedy_tokens_identical_to_jax(quantize):
    je, te = _engines(quantize)
    prompts = _prompts()
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12))
    got = te.generate(torch.from_numpy(prompts), GenerationConfig(max_new_tokens=12))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.decode_steps == 12


@pytest.mark.parametrize("cache_format", [None, "int8_tok", "mxint4_blk"],
                         ids=["f32_cache", "int8_tok", "mxint4_blk"])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "default_spec"])
def test_qwen3_greedy_tokens_identical_to_jax(quantize, cache_format):
    """Slice-2 gate: dense GQA with QK-norm, the KV cache kept f32 or encoded
    at the prefill/decode boundary."""
    je, te = _engines(quantize, "qwen3-8b")
    prompts = _prompts(4)
    want = je.generate(jnp.asarray(prompts),
                       JGen(max_new_tokens=12, cache_format=cache_format))
    got = te.generate(torch.from_numpy(prompts),
                      GenerationConfig(max_new_tokens=12, cache_format=cache_format))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.decode_steps == 12


def test_stop_tokens_pad_and_lengths_match_jax():
    je, te = _engines(False)
    prompts = _prompts(1)
    free = np.asarray(je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12)).tokens)
    stop = (int(free[0, 3]), int(free[1, 6]))
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12, stop_tokens=stop,
                                                  pad_token_id=511))
    got = te.generate(torch.from_numpy(prompts),
                      GenerationConfig(max_new_tokens=12, stop_tokens=stop,
                                       pad_token_id=511))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.decode_steps <= 12


def test_top_k_sampling_stays_in_support():
    _, te = _engines(False)
    prompts = torch.from_numpy(_prompts(2))
    logits, _ = te.prefill(prompts)
    gen = GenerationConfig(max_new_tokens=1,
                           sampling=SamplingParams(temperature=0.7, top_k=3))
    allowed = torch.topk(logits, 3, dim=-1).indices
    g = torch.Generator().manual_seed(0)
    for _ in range(5):
        tok = te.generate(prompts, gen, generator=g).tokens[:, 0]
        assert all(int(t) in allowed[i].tolist() for i, t in enumerate(tok))


def test_from_config_inits_and_deploys_reduced_model_on_cpu():
    eng = InferenceEngine.from_config("retnet-1.3b", EngineSpec(reduced=True),
                                      device="cpu")
    head = eng.model.lm_head
    assert head.w is None and head.w8_vals.dtype == torch.int8
    assert head.mx_packed.shape == (128, eng.cfg.padded_vocab // 2)
    res = eng.generate(torch.ones(1, 8, dtype=torch.long),
                       GenerationConfig(max_new_tokens=3))
    assert res.tokens.shape == (1, 3) and int(res.lengths[0]) == 3
