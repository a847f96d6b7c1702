"""The fused decode loop of repro_torch against the JAX package, on the CPU.

The reference runs its decode phase as one compiled ``lax.while_loop`` with
the position on the device.  The port keeps every piece of that loop's state
on the device too, so that the card can capture one step as a CUDA graph and
replay it (`serving/engine.py`); on the CPU the same step runs eagerly, and
these tests hold each piece to the reference with numpy inputs from a seed:

* the online-RoPE `advance` with a device position, across a resync
  (positions 60-70, the reference's own bound 2e-5);
* `cache_update` at a device slot against the reference's
  ``dynamic_update_slice``, every cache format, the clamp at capacity
  included (bytes exact);
* the plain flash-decode with an int32 tensor ``kv_len`` against the Pallas
  kernel in interpret mode, both modes, at kv_len 1, 17, C - 1 and C (1e-5);
* the engine's step, through `generate`: greedy tokens, ``lengths`` and
  ``decode_steps`` identical to the JAX engine's on reduced retnet-1.3b
  (fp and deployed weights), qwen3-8b and the 3-layer deepseek-v3 cut in
  every cache format (fp weights, where the two frameworks' logits agree to
  1e-4; deployed weights hold only 1e-2 of max|logit|, ROADMAP C, and a
  near tie can flip there), with and without stop tokens;
* the step's contract with a captured graph: it updates its state in place
  and counts replayed launches.

The card's side (the kernels with a device ``kv_len``, one graph replayed
against eager launches) is in tests/test_torch_cuda.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as Jconfigs
from repro.core import kvq as Jkvq
from repro.core import online_rope as Jrope
from repro.kernels import ops as Jops
from repro.kernels.flash_decode import flash_decode_pallas
from repro.models import layers as JL
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as Tconfigs
from repro_torch.core import online_rope as Trope
from repro_torch.kernels import hopper
from repro_torch.kernels import ops as Tops
from repro_torch.models import layers as TL
from repro_torch.serving.engine import DecodeState, EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig, SamplingParams
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

DS3 = "deepseek-v3-671b"
FORMATS = [None, "int8_tok", "mxint4_blk"]
FORMAT_IDS = ["f32", "int8_tok", "mxint4_blk"]
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)


def _i32(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


# -- online RoPE ------------------------------------------------------------------


@pytest.mark.parametrize("dim", [16, 64, 128])
def test_advance_with_a_device_position_matches_reference_across_a_resync(dim):
    """From position 60 to 70: the step to 64 resyncs exactly (a select on
    the device, as the reference's ``jnp.where``), the others rotate."""
    thj, tht = Jrope.rope_thetas(dim), Trope.rope_thetas(dim)
    sj, st = Jrope.init_state(dim, pos=60), Trope.init_state(dim, pos=60)
    assert st.pos.dtype == torch.int32 and st.pos.dim() == 0
    for _ in range(10):
        sj, st = Jrope.advance(sj, thj), Trope.advance(st, tht)
        assert int(st.pos) == int(sj.pos)
        np.testing.assert_allclose(st.sin.numpy(), np.asarray(sj.sin), atol=2e-5)
        np.testing.assert_allclose(st.cos.numpy(), np.asarray(sj.cos), atol=2e-5)
    assert int(st.pos) == 70


# -- cache_update at a device slot ------------------------------------------------

CACHE_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": (jnp.int8, torch.int8), "int8_tok": ("int8_tok", "int8_tok"),
                "mxint4_blk": ("mxint4_blk", "mxint4_blk")}
C = 12


def _bytes(leaf) -> dict:
    """A leaf's arrays as numpy, bf16 as its bit pattern."""
    parts = leaf if isinstance(leaf, dict) else {"": leaf}
    out = {}
    for name, a in parts.items():
        if isinstance(a, torch.Tensor):
            a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
            out[name] = a.numpy()
        else:
            a = np.asarray(a)
            out[name] = a.view(np.int16) if a.dtype == jnp.bfloat16 else a
    return out


def _resident(fmt: str, rng):
    """A full cache leaf, the same bytes on both sides (encoded by JAX)."""
    x = jnp.asarray(rng.normal(size=(2, C, 2, 32)).astype(np.float32))
    jd, _ = CACHE_DTYPES[fmt]
    j = Jkvq.encode(x, jd) if isinstance(jd, str) else JL.to_cache_dtype(x, jd)
    t = ({n: torch.from_numpy(np.array(a)) for n, a in j.items()} if isinstance(j, dict)
         else torch.from_numpy(np.array(j.view(jnp.int16))).view(torch.bfloat16)
         if jd == jnp.bfloat16 else torch.from_numpy(np.array(j)))
    return j, t


@pytest.mark.parametrize("fmt", list(CACHE_DTYPES))
@pytest.mark.parametrize("pos,n", [(0, 1), (5, 1), (C - 1, 1), (C, 1), (C + 3, 1),
                                   (C - 1, 2)])
def test_cache_update_at_a_device_slot_matches_dynamic_update_slice(fmt, pos, n):
    """The rows land where the reference's jitted ``dynamic_update_slice``
    puts them, the start clamped to [0, C - n] (a position at or past the
    capacity rewrites the last rows), in place, byte for byte."""
    rng = np.random.default_rng(pos * 7 + n)
    jleaf, tleaf = _resident(fmt, rng)
    rows = rng.normal(size=(2, n, 2, 32)).astype(np.float32)
    want = jax.jit(JL.cache_update)(jleaf, jnp.asarray(rows), jnp.int32(pos))
    got = TL.cache_update(tleaf, torch.from_numpy(rows), _i32(pos))
    assert got is tleaf
    w, g = _bytes(want), _bytes(got)
    assert w.keys() == g.keys()
    for name in w:
        np.testing.assert_array_equal(g[name], w[name], err_msg=f"{fmt} {name}")


@pytest.mark.parametrize("pos", [0, C - 2, C - 1, C, 40])
def test_decode_slots_clamp_on_the_device(pos):
    slot, kv_len = TL.decode_slots(_i32(pos), C)
    assert slot.dtype == kv_len.dtype == torch.int32
    assert (int(slot), int(kv_len)) == (min(pos, C - 1), min(pos + 1, C))


# -- flash-decode with a tensor kv_len ------------------------------------------


def _encode_both(x: np.ndarray, fmt):
    if fmt in (None, "fp"):
        return jnp.asarray(x), torch.from_numpy(x)
    if fmt == "legacy_int8":
        j = JL.to_cache_dtype(jnp.asarray(x), jnp.int8)
        return j, torch.from_numpy(np.array(j))
    j = Jkvq.encode(jnp.asarray(x), fmt)
    return j, {n: torch.from_numpy(np.array(a)) for n, a in j.items()}


FD_C = 48


@pytest.mark.parametrize("kv_len", [1, 17, FD_C - 1, FD_C])
@pytest.mark.parametrize("fmt", ["fp", "legacy_int8", "int8_tok", "mxint4_blk"])
def test_gqa_flash_decode_with_a_tensor_kv_len_matches_pallas(fmt, kv_len):
    rng = np.random.default_rng(kv_len)
    b, kv, g, d = 2, 2, 4, 32
    q = rng.normal(size=(b, kv, g, d)).astype(np.float32)
    kj, kt = _encode_both(rng.normal(size=(b, FD_C, kv, d)).astype(np.float32), fmt)
    vj, vt = _encode_both(rng.normal(size=(b, FD_C, kv, d)).astype(np.float32), fmt)
    want = flash_decode_pallas(jnp.asarray(q), kj, vj, jnp.int32(kv_len), interpret=True)
    got = Tops.flash_decode(torch.from_numpy(q), kt, vt, _i32(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)


@pytest.mark.parametrize("kv_len", [1, 17, FD_C - 1, FD_C])
@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
def test_mla_flash_decode_with_a_tensor_kv_len_matches_pallas(fmt, kv_len):
    rng = np.random.default_rng(100 + kv_len)
    b, h, r, dr = 2, 4, 32, 16
    q, q2 = (rng.normal(size=(b, h, w)).astype(np.float32) for w in (r, dr))
    latj, latt = _encode_both(rng.normal(size=(b, FD_C, r)).astype(np.float32), fmt)
    ropej, ropet = _encode_both(rng.normal(size=(b, FD_C, dr)).astype(np.float32), fmt)
    scale = float(1.0 / np.sqrt(np.float32(48)))
    want = Jops.flash_decode(jnp.asarray(q), latj, latj, jnp.int32(kv_len),
                             q2=jnp.asarray(q2), k2=ropej, scale=scale, impl="pallas",
                             interpret=True)
    got = Tops.flash_decode(torch.from_numpy(q), latt, latt, _i32(kv_len),
                            q2=torch.from_numpy(q2), k2=ropet, scale=scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)


# -- the loop, end to end ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engines(arch: str, quantize: bool = True):
    """The JAX engine and the port's on its carried weights (reduced; the
    deepseek-v3 config cut to its 3 leading dense layers)."""
    if arch == DS3:
        jcfg = dataclasses.replace(Jconfigs.get_config(DS3).reduced(), n_layers=3)
        tcfg = dataclasses.replace(Tconfigs.get_config(DS3).reduced(), n_layers=3)
    else:
        jcfg, tcfg = Jconfigs.get_config(arch).reduced(), Tconfigs.get_config(arch).reduced()
    je = JEngine.from_config(jcfg, JSpec(quantize=quantize))
    model = bridge.model_from_tree(tcfg, jax.tree.map(np.asarray, jax.device_get(je.params)))
    te = InferenceEngine.from_config(tcfg, EngineSpec(quantize=quantize), model=model,
                                     device="cpu")
    return je, te


@functools.lru_cache(maxsize=None)
def _free_run(arch: str, quantize: bool, fmt):
    """The JAX engine's tokens for 12 new tokens of a seeded [2, 16] prompt."""
    je, _ = _engines(arch, quantize)
    prompts = np.random.default_rng(len(arch)).integers(1, 512, (2, 16)).astype(np.int32)
    res = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12, cache_format=fmt))
    return prompts, np.asarray(res.tokens), np.asarray(res.lengths)


def _check_against_jax(arch, quantize, fmt, stop):
    je, te = _engines(arch, quantize)
    prompts, free, free_lengths = _free_run(arch, quantize, fmt)
    if stop:
        # Each lane's token at a different column stops it; the other lane
        # may meet its stop token earlier, which the reference decides.
        stops = (int(free[0, 3]), int(free[1, 6]))
        want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=12, cache_format=fmt,
                                                      stop_tokens=stops, pad_token_id=511))
        want_t, want_l = np.asarray(want.tokens), np.asarray(want.lengths)
        gen = GenerationConfig(max_new_tokens=12, cache_format=fmt, stop_tokens=stops,
                               pad_token_id=511)
    else:
        want_t, want_l = free, free_lengths
        gen = GenerationConfig(max_new_tokens=12, cache_format=fmt)
    got = te.generate(torch.from_numpy(prompts), gen)
    np.testing.assert_array_equal(got.tokens.numpy(), want_t)
    np.testing.assert_array_equal(got.lengths.numpy(), want_l)
    # The reference's loop runs while a sequence is live: as many steps as
    # the longest sequence emitted.
    assert got.decode_steps == int(want_l.max())
    if stop:
        assert got.decode_steps < 12


@pytest.mark.parametrize("stop", [False, True], ids=["free", "stop_tokens"])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "default_spec"])
def test_retnet_loop_matches_jax(quantize, stop):
    _check_against_jax("retnet-1.3b", quantize, None, stop)


@pytest.mark.parametrize("stop", [False, True], ids=["free", "stop_tokens"])
@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
def test_qwen3_loop_matches_jax(fmt, stop):
    _check_against_jax("qwen3-8b", False, fmt, stop)


@pytest.mark.parametrize("stop", [False, True], ids=["free", "stop_tokens"])
@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
def test_ds3_dense_loop_matches_jax(fmt, stop):
    _check_against_jax(DS3, False, fmt, stop)


# -- the step's contract with a captured graph ----------------------------------


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


@pytest.mark.parametrize("arch,fmt", [("retnet-1.3b", None), ("qwen3-8b", "int8_tok"),
                                      (DS3, "mxint4_blk")])
def test_step_updates_its_state_in_place(arch, fmt):
    """A graph replays the step on the buffers it captured: every tensor of
    the state, the cache's position, rope angles and leaves included, stays
    where it was, and the step moves the position and ``i`` by one."""
    _, te = _engines(arch)
    prompts = torch.from_numpy(_free_run(arch, True, fmt)[0]).long()
    gen = GenerationConfig(max_new_tokens=4, cache_format=fmt)
    logits, cache = te.prefill(prompts, cache_len=prompts.shape[1] + 4)
    st = DecodeState.start(logits.argmax(-1), te._encode_cache(cache, gen), gen)
    before = [(t, t.data_ptr()) for t in _tensors(dataclasses.asdict(st) | {"c": st.cache})]
    pos = int(st.cache["pos"])
    with torch.inference_mode():
        te._step(st, gen, None, None)
        te._step(st, gen, None, None)
    assert all(t.data_ptr() == p for t, p in before)
    assert int(st.cache["pos"]) == pos + 2 and int(st.i) == 2
    assert int(st.cache["rope"].pos) == pos + 2
    assert st.lengths.tolist() == [2, 2] and (st.out[:, 2:] == 0).all()


def test_sampled_generate_repeats_with_the_same_seed():
    _, te = _engines("qwen3-8b")
    prompts = torch.from_numpy(_free_run("qwen3-8b", True, None)[0]).long()
    gen = GenerationConfig(max_new_tokens=6, sampling=SamplingParams(temperature=0.8,
                                                                      top_k=5))
    runs = [te.generate(prompts, gen, generator=torch.Generator().manual_seed(3)).tokens
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(te.generate(prompts, gen).tokens, te.generate(prompts, gen).tokens)


def test_replays_count_the_launches_their_capture_recorded():
    """Under capture a wrapper's count records a launch that has not run:
    `captured_launches` takes those counts out of `LAUNCHES`, and each
    `count_replay` adds them back when the graph runs them."""
    hopper.reset_launches()
    hopper.LAUNCHES["mxint4_matmul"] += 3                 # launches before the capture
    with hopper.captured_launches() as recorded:
        hopper.LAUNCHES["mxint4_matmul"] += 5
        hopper.LAUNCHES["flash_decode"] += 2
    assert hopper.LAUNCHES["mxint4_matmul"] == 3 and hopper.LAUNCHES["flash_decode"] == 0
    assert recorded["mxint4_matmul"] == 5 and recorded["flash_decode"] == 2
    for _ in range(4):
        hopper.count_replay(recorded)
    assert hopper.LAUNCHES["mxint4_matmul"] == 3 + 20 and hopper.LAUNCHES["flash_decode"] == 8
    hopper.reset_launches()
