"""Hymba's attention half against the JAX package: `flash_attention` with a
sliding window and key offsets, the ring the prefill seeds (S below, at and
above the window, bucketed), `gqa_decode` past the ring's wrap, `gqa_chunk`
into a ring beyond the window, and the speculative rollbacks (the ring's
and the Mamba commit), with one position for the batch and per lane.

Weights are layer 0 of reduced hymba-1.5b's JAX params carried over by
`repro_torch.bridge` (fp), inputs seeded numpy arrays.  One attention layer
holds 1e-5; encoded caches hold one quantization step, decoded (the rows
pass through RMSNorm's rsqrt and RoPE, whose last bits differ between XLA
and torch).  The JAX chunk and decode steps run under ``jit``, as its
engine runs them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import fp_engine
from test_torch_admission import _quant_step

from repro import configs as Jconfigs
from repro.models import layers as JL
from repro.models import lm as Jlm
from repro_torch import bridge, configs as Tconfigs
from repro_torch.models import layers as TL
from repro_torch.models import lm as Tlm
from repro_torch.serving.engine import EngineSpec, InferenceEngine, _clone, tree_items
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "hymba-1.5b"
JCFG, TCFG = Jconfigs.get_config(ARCH).reduced(), Tconfigs.get_config(ARCH).reduced()
W = TCFG.sliding_window
TOL = dict(rtol=1e-5, atol=1e-5)
FORMATS = [None, "int8_tok", "mxint4_blk"]
FORMAT_IDS = ["f32", "int8_tok", "mxint4_blk"]
RNG = np.random.default_rng(0)


@functools.lru_cache(maxsize=None)
def _sides():
    je = fp_engine(ARCH)
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    te = InferenceEngine.from_config(ARCH, EngineSpec(reduced=True, quantize=False),
                                     model=bridge.model_from_tree(TCFG, tree, device="cpu"),
                                     device="cpu")
    p_j = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["attn"])
    return je, te, p_j, te.model.blocks[0].attn


def _t(a):
    return torch.from_numpy(np.array(a))


def _i32(n):
    return torch.tensor(n, dtype=torch.int32)


def _rope(n: int):
    sin, cos = Jlm._rope_tables(JCFG, n)
    return (sin, cos), (_t(sin), _t(cos))


def _leaf_close(tleaf, jleaf, msg=""):
    """A cache leaf against the reference's: f32 at 1e-5, encoded leaves
    within one quantization step of each other, decoded."""
    got = TL.from_cache_dtype(tleaf).numpy()
    want = np.asarray(JL.from_cache_dtype(jleaf))
    if not isinstance(tleaf, dict):
        np.testing.assert_allclose(got, want, err_msg=msg, **TOL)
        return
    step = np.maximum(_quant_step(tleaf), _quant_step({n: _t(a) for n, a in jleaf.items()}))
    assert (np.abs(got - want) <= step + 1e-6).all(), msg


def _jcache(fmt, batch):
    return JL.gqa_make_cache(JCFG, batch, 4 * W, fmt or jnp.float32)


def _tcache(fmt, batch):
    return TL.gqa_make_cache(TCFG, batch, 4 * W, fmt or torch.float32)


# -- flash_attention: window and offsets ------------------------------------------


@pytest.mark.parametrize("sq,sk,causal,window,qc,kc", [
    (24, 24, True, 0, 8, 8), (32, 48, False, 0, 16, 16), (40, 40, True, 12, 16, 8),
    (33, 57, True, 0, 16, 16), (16, 16, True, 0, 16, 16), (57, 57, True, 20, 16, 16)])
def test_flash_attention_window_matches_reference(sq, sk, causal, window, qc, kc):
    """The reference's `test_flash_attention` cases (and a ragged window)."""
    q = RNG.normal(size=(2, sq, 2, 3, 8)).astype(np.float32)
    k, v = (RNG.normal(size=(2, sk, 2, 8)).astype(np.float32) for _ in range(2))
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, window=window,
                              q_chunk=qc, kv_chunk=kc)
    got = TL.flash_attention(*map(_t, (q, k, v)), causal=causal, window=window,
                             q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("win", [4, 16])
def test_flash_attention_device_window(win):
    """A window held on the device (hymba's full-attention layers pass S,
    or ``pos + C`` in a chunk) gives what the int does."""
    q = RNG.normal(size=(1, 16, 1, 2, 8)).astype(np.float32)
    k, v = (RNG.normal(size=(1, 16, 1, 8)).astype(np.float32) for _ in range(2))
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              window=jnp.int32(win), q_chunk=8, kv_chunk=8)
    got = TL.flash_attention(*map(_t, (q, k, v)), causal=True, window=_i32(win),
                             q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ints = TL.flash_attention(*map(_t, (q, k, v)), causal=True, window=win,
                              q_chunk=8, kv_chunk=8)
    torch.testing.assert_close(got, ints, rtol=0, atol=0)


def test_flash_attention_k_offset_masks_leading_garbage():
    """The reference's ring-linearization case: keys at negative positions
    (a negative k_offset) never contribute."""
    s, lead = 16, 4
    q = RNG.normal(size=(1, s, 2, 2, 8)).astype(np.float32)
    k, v = (RNG.normal(size=(1, s, 2, 8)).astype(np.float32) for _ in range(2))
    junk = np.full((1, lead, 2, 8), 7.0, np.float32)
    kj, vj = np.concatenate([junk, k], 1), np.concatenate([junk, v], 1)
    want = JL.flash_attention(*map(jnp.asarray, (q, kj, vj)), causal=True,
                              k_offset=jnp.int32(-lead), kv_len=jnp.int32(s),
                              q_chunk=8, kv_chunk=8)
    got = TL.flash_attention(*map(_t, (q, kj, vj)), causal=True, k_offset=_i32(-lead),
                             kv_len=_i32(s), q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = TL.flash_attention(*map(_t, (q, k, v)), causal=True, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5, atol=2e-6)


def test_flash_attention_per_lane_window_and_offsets():
    """``[B]`` window, q_offset, k_offset and kv_len: each lane as the
    reference computes it alone."""
    q = RNG.normal(size=(2, 6, 2, 2, 8)).astype(np.float32)
    k, v = (RNG.normal(size=(2, 20, 2, 8)).astype(np.float32) for _ in range(2))
    qo, ko, win = np.array([3, 9]), np.array([-5, 1]), np.array([7, 14])
    got = TL.flash_attention(*map(_t, (q, k, v)), causal=True,
                             window=_t(win.astype(np.int32)), q_offset=_t(qo.astype(np.int32)),
                             k_offset=_t(ko.astype(np.int32)),
                             kv_len=_t((qo + 6).astype(np.int32)), q_chunk=4, kv_chunk=8)
    for b in range(2):
        want = JL.flash_attention(*(jnp.asarray(a[b:b + 1]) for a in (q, k, v)), causal=True,
                                  window=jnp.int32(win[b]), q_offset=jnp.int32(qo[b]),
                                  k_offset=jnp.int32(ko[b]), kv_len=jnp.int32(qo[b] + 6),
                                  q_chunk=4, kv_chunk=8)
        np.testing.assert_allclose(got[b:b + 1].numpy(), np.asarray(want), **TOL)


# -- the ring a prefill seeds ------------------------------------------------------


@pytest.mark.parametrize("s,valid", [(5, None), (W, None), (W + 7, None), (3 * W + 5, None),
                                     (64, 21), (64, W), (64, 45), (128, 100)])
def test_seed_ring_matches_reference(s, valid):
    """Slot p % window holds position p: short prompts padded, long ones
    rolled, bucketed ones gathered from their real positions only."""
    k, v = (RNG.normal(size=(2, s, 2, 8)).astype(np.float32) for _ in range(2))
    vl_j = None if valid is None else jnp.int32(valid)
    vl_t = None if valid is None else _i32(valid)
    want = Jlm._seed_attn_cache(JCFG, jnp.asarray(k), jnp.asarray(v), s + 4, valid_len=vl_j)
    got = Tlm._seed_attn_cache(TCFG, {"k": _t(k), "v": _t(v)}, s + 4, vl_t)
    for n in ("k", "v"):
        assert tuple(got[n].shape) == want[n].shape == (2, W, 2, 8)
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))


def test_make_cache_ring_is_window_slots():
    for fmt in FORMATS:
        for cl in (4, W, 5 * W):
            t = TL.gqa_make_cache(TCFG, 2, cl, fmt or torch.float32)
            j = JL.gqa_make_cache(JCFG, 2, cl, fmt or jnp.float32)
            assert TL.cache_capacity(t["k"]) == JL.cache_capacity(j["k"]) == W


# -- decode past the wrap -----------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
def test_gqa_decode_past_the_wrap(fmt):
    """Decode steps at positions W - 2 .. W + 3 from a seeded ring: each
    writes slot pos % W and attends to min(pos + 1, W) rows, as the
    reference's step under jit."""
    je, te, p_j, p_t = _sides()
    cj, ct = _jcache(fmt, 2), _tcache(fmt, 2)
    filled = RNG.normal(size=(2, W, 2, 32)).astype(np.float32)
    cj = {n: JL.cache_update(cj[n], jnp.asarray(filled), jnp.int32(0)) for n in cj}
    ct = {n: TL.cache_update(ct[n], _t(filled), _i32(0)) for n in ct}
    step = jax.jit(lambda p, x, c, pos, sin, cos: JL.gqa_decode(
        p, x, None, je.hsa, JCFG, c, pos, window=W, rope_sin=sin, rope_cos=cos))
    (sin_j, cos_j), (sin_t, cos_t) = _rope(W + 4)
    for pos in range(W - 2, W + 4):
        x = RNG.normal(size=(2, 1, TCFG.d_model)).astype(np.float32)
        oj, cj = step(p_j, jnp.asarray(x), cj, jnp.int32(pos), sin_j[pos], cos_j[pos])
        ot, ct = TL.gqa_decode(p_t, _t(x), None, te.hsa, TCFG, ct, _i32(pos),
                               rope_sin=sin_t[pos], rope_cos=cos_t[pos])
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), err_msg=f"pos {pos}", **TOL)
        for n in ("k", "v"):
            _leaf_close(ct[n], cj[n], f"pos {pos} {n}")


def test_gqa_decode_per_lane_positions():
    """A ``[B]`` position: lane b writes slot pos[b] % W and reads its own
    kv_len, as the reference's batch-1 step at that lane's position."""
    je, te, p_j, p_t = _sides()
    filled = RNG.normal(size=(2, W, 2, 32)).astype(np.float32)
    ct = {n: TL.cache_update(_tcache(None, 2)[n], _t(filled), _i32(0)) for n in ("k", "v")}
    pos = np.array([5, W + 9])
    th = Tlm._thetas(TCFG.head_dim_, TCFG.rope_base, torch.device("cpu"))
    sin_t, cos_t = Tlm.orp.rope_table(_t(pos.astype(np.int32)), th)
    x = RNG.normal(size=(2, 1, TCFG.d_model)).astype(np.float32)
    ot, ct = TL.gqa_decode(p_t, _t(x), None, te.hsa, TCFG, ct, _t(pos.astype(np.int32)),
                           rope_sin=sin_t, rope_cos=cos_t)
    (sin_j, cos_j), _ = _rope(W + 10)
    for b in range(2):
        cj = {n: JL.cache_update(_jcache(None, 1)[n], jnp.asarray(filled[b:b + 1]),
                                 jnp.int32(0)) for n in ("k", "v")}
        oj, cj = JL.gqa_decode(p_j, jnp.asarray(x[b:b + 1]), None, je.hsa, JCFG, cj,
                               jnp.int32(pos[b]), window=W, rope_sin=sin_j[pos[b]],
                               rope_cos=cos_j[pos[b]])
        np.testing.assert_allclose(ot[b:b + 1].numpy(), np.asarray(oj), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(ct[n][b:b + 1].numpy(), np.asarray(cj[n]), **TOL)


# -- chunks into a ring --------------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("full", [False, True], ids=["window", "full_attn"])
def test_gqa_chunk_ring_beyond_window(fmt, full):
    """48 tokens (past the window of 32) in chunks of 8 into a ring, each
    against the reference's chunk under jit (attend before evict): outputs,
    and the ring after every chunk.  ``full``: a full-attention layer's
    window ``pos + C``, a device scalar."""
    je, te, p_j, p_t = _sides()
    cj, ct = _jcache(fmt, 2), _tcache(fmt, 2)
    step = jax.jit(lambda p, x, c, pos, win, sin, cos: JL.gqa_chunk(
        p, x, None, je.hsa, JCFG, c, pos, window=win, rope_sin=sin, rope_cos=cos))
    (sin_j, cos_j), (sin_t, cos_t) = _rope(48)
    for pos in range(0, 48, 8):
        x = RNG.normal(size=(2, 8, TCFG.d_model)).astype(np.float32)
        win_j, win_t = (jnp.int32(pos + 8), _i32(pos) + 8) if full else (jnp.int32(W), W)
        oj, cj = step(p_j, jnp.asarray(x), cj, jnp.int32(pos), win_j, sin_j[pos:pos + 8],
                      cos_j[pos:pos + 8])
        ot, ct = TL.gqa_chunk(p_t, _t(x), None, te.hsa, TCFG, ct, _i32(pos), window=win_t,
                              rope_sin=sin_t[pos:pos + 8], rope_cos=cos_t[pos:pos + 8])
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), err_msg=f"chunk {pos}", **TOL)
        for n in ("k", "v"):
            _leaf_close(ct[n], cj[n], f"chunk {pos} {n}")


def test_gqa_chunk_ring_equals_one_windowed_pass():
    """The reference's `test_windowed_ring_chunked_beyond_window` on the
    port: chunks of 8 of a 48-token prompt equal one monolithic windowed
    pass, and the final ring equals the monolithic seed."""
    _, te, _, p_t = _sides()
    s = 48
    _, (sin, cos) = _rope(s)
    x = _t(0.2 * RNG.normal(size=(1, s, TCFG.d_model)).astype(np.float32))
    mono, (k, v) = TL.gqa_apply(p_t, x, None, te.hsa, "prefill", TCFG, window=W,
                                rope_sin=sin, rope_cos=cos)
    cache, outs = _tcache(None, 1), []
    for pos in range(0, s, 8):
        o, cache = TL.gqa_chunk(p_t, x[:, pos:pos + 8], None, te.hsa, TCFG, cache,
                                _i32(pos), window=W, rope_sin=sin[pos:pos + 8],
                                rope_cos=cos[pos:pos + 8])
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), mono, **TOL)
    ring = Tlm._seed_attn_cache(TCFG, {"k": k, "v": v}, s)
    for n in ("k", "v"):
        torch.testing.assert_close(cache[n], ring[n], **TOL)


# -- the speculative rollbacks ---------------------------------------------------------


@pytest.mark.parametrize("fmt", FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("n_accept", [1, 3, 5])
def test_ring_rollback_matches_reference(fmt, n_accept):
    """A 5-token verify block into a ring at pos 30 (wrapping), then the
    rollback to ``n_accept``: the reference restores rejected slots from the
    pre-verify ring, the port from the rows the chunk kept; the rings agree
    and every restored slot is bit-equal to the pre-verify ring."""
    je, te, p_j, p_t = _sides()
    filled = RNG.normal(size=(2, W, 2, 32)).astype(np.float32)
    cj = {n: JL.cache_update(_jcache(fmt, 2)[n], jnp.asarray(filled), jnp.int32(0))
          for n in ("k", "v")}
    ct = {n: TL.cache_update(_tcache(fmt, 2)[n], _t(filled), _i32(0)) for n in ("k", "v")}
    before = {n: TL.cache_gather(ct[n], torch.arange(W)) for n in ct}
    pos, c = 30, 5
    (sin_j, cos_j), (sin_t, cos_t) = _rope(pos + c)
    x = RNG.normal(size=(2, c, TCFG.d_model)).astype(np.float32)
    _, vj = JL.gqa_chunk(p_j, jnp.asarray(x), None, je.hsa, JCFG, cj, jnp.int32(pos),
                         window=W, rope_sin=sin_j[pos:], rope_cos=cos_j[pos:])
    rj = JL.ring_rollback(cj, vj, jnp.int32(pos), c, jnp.int32(n_accept), W)
    _, vt = TL.gqa_chunk(p_t, _t(x), None, te.hsa, TCFG, ct, _i32(pos), window=W,
                         rope_sin=sin_t[pos:], rope_cos=cos_t[pos:], keep_evicted=True)
    rt = TL.ring_rollback(vt, _i32(pos), c, _i32(n_accept), W)
    restored = [(pos + i) % W for i in range(n_accept, c)]
    for n in ("k", "v"):
        _leaf_close(rt[n], rj[n], n)
        got = TL.cache_gather(rt[n], torch.tensor(restored, dtype=torch.int64))
        want = TL.cache_gather(before[n], torch.tensor(restored, dtype=torch.int64))
        for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_ring_rollback_per_lane():
    """``[B]`` pos and n_accept: each lane rolls back as it would alone."""
    _, te, _, p_t = _sides()
    filled = _t(RNG.normal(size=(2, W, 2, 32)).astype(np.float32))
    pos, n_acc, c = np.array([29, 3]), np.array([2, 4]), 5
    th = Tlm._thetas(TCFG.head_dim_, TCFG.rope_base, torch.device("cpu"))
    x = _t(RNG.normal(size=(2, c, TCFG.d_model)).astype(np.float32))

    def run(lanes, p, na):
        cache = {n: TL.cache_update(_tcache(None, len(lanes))[n], filled[lanes], _i32(0))
                 for n in ("k", "v")}
        sin, cos = Tlm.orp.rope_table(p[:, None] + torch.arange(c), th) \
            if p.ndim else Tlm.orp.rope_table(p + torch.arange(c), th)
        _, ver = TL.gqa_chunk(p_t, x[lanes], None, te.hsa, TCFG, cache, p, window=W,
                              rope_sin=sin, rope_cos=cos, keep_evicted=True)
        return TL.ring_rollback(ver, p, c, na, W)

    both = run([0, 1], _t(pos.astype(np.int32)), _t(n_acc.astype(np.int32)))
    for b in range(2):
        one = run([b], _i32(int(pos[b])), _i32(int(n_acc[b])))
        for n in ("k", "v"):
            torch.testing.assert_close(both[n][b:b + 1], one[n], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
@pytest.mark.parametrize("n_accept", [1, 2, 4])
def test_commit_verified_cache_matches_reference(arch, n_accept):
    """A 4-token verify block over a warm 40-token cache (hymba's ring
    wrapped), then the commit: the reference's forward_verify_chunk and
    commit_verified_cache under jit against the port's (the Mamba state
    ``h_all[:, n - 1]``, the conv window ``conv_ext[:, n : n + cw - 1]``,
    the ring's restored slots), and the committed cache decodes the next
    token as the reference's does."""
    je = fp_engine(arch)
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    tcfg = Tconfigs.get_config(arch).reduced()
    te = InferenceEngine.from_config(arch, EngineSpec(reduced=True, quantize=False),
                                     model=bridge.model_from_tree(tcfg, tree, device="cpu"),
                                     device="cpu")
    prompt = np.random.default_rng(2).integers(1, 500, (2, 40)).astype(np.int32)
    block = np.random.default_rng(3).integers(1, 500, (2, 4)).astype(np.int32)
    _, cj = je.prefill(jnp.asarray(prompt), cache_len=48)
    _, ct = te.prefill(_t(prompt), cache_len=48)

    @jax.jit
    def jverify(params, toks, cache, n):
        lg, _, ver = Jlm.forward_verify_chunk(params, {"tokens": toks}, cache, je.cfg, je.hsa)
        com = Jlm.commit_verified_cache(cache, ver, n, 4, je.cfg)
        nxt, _ = Jlm.forward_decode(params, toks[:, :1], com, je.cfg, je.hsa)
        return lg, com, nxt

    lg_j, com_j, nxt_j = jverify(je.params, jnp.asarray(block), cj, jnp.int32(n_accept))
    with torch.inference_mode():      # the prefill's cache is written in place
        lg_t, _, ver = Tlm.forward_verify_chunk(te.model, _t(block).long(), ct, tcfg, te.hsa)
        com_t = Tlm.commit_verified_cache(ct, ver, _i32(n_accept), 4, tcfg)
        nxt_t, _ = Tlm.forward_decode(te.model, _t(block[:, :1]).long(), _clone(com_t),
                                      tcfg, te.hsa)        # decode writes its ring row in place
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=1e-4, atol=1e-4)
    assert int(com_t["pos"]) == int(com_j["pos"]) == 40 + n_accept
    for i, tb in enumerate(com_t["blocks"]):
        jb = jax.tree.map(lambda a, i=i: np.asarray(a[i]), com_j["blocks"])
        for path, t in (("h", lambda b: b.get("mamba", b)["h"]),
                        ("conv", lambda b: b.get("mamba", b)["conv"])):
            np.testing.assert_allclose(t(tb).numpy(), t(jb), rtol=1e-4, atol=1e-4,
                                       err_msg=f"layer {i} {path}")
        if "attn" in tb:
            assert sorted(tb["attn"]) == ["k", "v"]
            for n in ("k", "v"):
                np.testing.assert_allclose(tb["attn"][n].numpy(), jb["attn"][n],
                                           rtol=1e-4, atol=1e-4)
        else:
            assert sorted(tb) == ["conv", "h"]
    np.testing.assert_allclose(nxt_t.numpy(), np.asarray(nxt_j), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
def test_commit_per_lane_equals_each_lane_alone(arch):
    """A ``[B]`` position and ``[B]`` n_accept (a slot class): every
    committed leaf of lane b is what the shared-position commit with lane
    b's n_accept gives it."""
    te = InferenceEngine.from_config(arch, EngineSpec(reduced=True, quantize=False),
                                     device="cpu")
    cfg, c = te.cfg, 4
    prompt = torch.from_numpy(np.random.default_rng(4).integers(1, 500, (2, 36)))
    block = torch.from_numpy(np.random.default_rng(5).integers(1, 500, (2, c)))
    n_acc = torch.tensor([1, 3], dtype=torch.int32)

    @torch.inference_mode()
    def committed(n, per_lane):
        _, cache = te.prefill(prompt, cache_len=44)
        if per_lane:
            cache["pos"] = cache["pos"].repeat(2)
            if cfg.rope:
                cache["rope"] = Tlm._rope_state(cfg, cache["pos"])
        _, _, ver = Tlm.forward_verify_chunk(te.model, block, cache, cfg, te.hsa)
        return Tlm.commit_verified_cache(cache, ver, n, c, cfg)

    lanes = committed(n_acc, True)
    for b in range(2):
        alone = committed(n_acc[b], False)
        assert int(lanes["pos"][b]) == 36 + int(n_acc[b])
        pairs = zip(tree_items(lanes["blocks"]), tree_items(alone["blocks"]))
        for (path, x), (_, y) in pairs:
            torch.testing.assert_close(x[b], y[b], rtol=1e-6, atol=1e-6, msg=path)
