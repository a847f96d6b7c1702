"""deepseek-v3's MLA path through repro_torch against the JAX package, on the
config cut to its three leading dense layers (reduced widths).

Op level: the plain MLA flash-decode against the reference's Pallas kernel
in interpret mode (its two-stream mode), in every cache format the model
path makes, at rtol 2e-5 / atol 2e-6 (tests/test_flash_decode.py).  Module
level: `mla_apply` and `mla_decode` against `repro.models.layers` on the same
carried weights, 1e-5 with fp weights and `QUANT_REL` of max|reference|
deployed (the int8 activation rounding, ROADMAP C).  Slice level: prefill
logits and the ``{c_kv, k_rope}`` cache against `repro.models.lm`, 8 decode
steps per cache format, and greedy tokens identical to the JAX engine's.
The bridge consumes every leaf of the reference tree, the MTP head too, and
the MLA plan fits the card at the main and reduced shapes.

The JAX engines are built once per ``quantize`` and shared.
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
from repro.kernels import ops as Jops
from repro.models import layers as JL
from repro.models import lm as Jlm
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro_torch import bridge, configs as Tconfigs
from repro_torch.kernels import hopper
from repro_torch.kernels import ops as Tops
from repro_torch.models import deploy as Tdeploy
from repro_torch.models import layers as TL
from repro_torch.models import lm as Tlm
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "deepseek-v3-671b"
JCFG = dataclasses.replace(Jconfigs.get_config(ARCH).reduced(), n_layers=3)
TCFG = dataclasses.replace(Tconfigs.get_config(ARCH).reduced(), n_layers=3)
DECODE_TOL = dict(rtol=2e-5, atol=2e-6)
FP_TOL = dict(rtol=1e-5, atol=1e-5)
CACHE_FORMATS = [None, "int8_tok", "mxint4_blk"]
FORMAT_IDS = ["f32", "int8_tok", "mxint4_blk"]
S, NEW = 16, 8
CACHE_LEN = S + NEW


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _encode_both(x: np.ndarray, fmt):
    """The same cache bytes on both sides (the JAX encoding, carried over)."""
    if fmt is None:
        return _pair(x)
    j = Jkvq.encode(jnp.asarray(x), fmt)
    return j, {n: torch.from_numpy(np.array(a)) for n, a in j.items()}


def _close(got, want, quantize, msg=""):
    want = np.asarray(want)
    if quantize:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=QUANT_REL * np.abs(want).max(), err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **FP_TOL)


# -- op level: flash-decode's MLA mode ----------------------------------------------


@pytest.mark.parametrize("kv_len", [1, 13, 24])
@pytest.mark.parametrize("fmt", CACHE_FORMATS, ids=FORMAT_IDS)
def test_mla_flash_decode_plain_matches_pallas(fmt, kv_len):
    """The reduced cut's widths (H 4, latent 32, rope 16) over C = 24 rows;
    both sides read the same encoded leaves, the latent as K and V."""
    rng = np.random.default_rng(21)
    b, h, r, dr, c = 2, 4, TCFG.kv_lora_rank, TCFG.qk_rope_head_dim, 24
    qj, qt = _pair(rng.normal(size=(b, h, r)).astype(np.float32))
    q2j, q2t = _pair(rng.normal(size=(b, h, dr)).astype(np.float32))
    latj, latt = _encode_both(rng.normal(size=(b, c, r)).astype(np.float32), fmt)
    ropej, ropet = _encode_both(rng.normal(size=(b, c, dr)).astype(np.float32), fmt)
    scale = float(1.0 / np.sqrt(np.float32(TCFG.qk_nope_head_dim + dr)))
    want = Jops.flash_decode(qj, latj, latj, jnp.int32(kv_len), q2=q2j, k2=ropej,
                             scale=scale, impl="pallas", interpret=True)
    got = Tops.flash_decode(qt, latt, latt, torch.tensor(kv_len, dtype=torch.int32), q2=q2t,
                            k2=ropet, scale=scale, impl="ref")
    assert got.dtype == torch.float32 and got.shape == (b, h, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)


def test_mla_flash_decode_plain_takes_a_distinct_v_as_the_reference_does():
    """The plain version follows the reference for any v; only the card's
    kernel needs v to be k (tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(22)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 3, 16), (1, 9, 16), (1, 9, 16)))
    q2, k2 = (rng.normal(size=s).astype(np.float32) for s in ((1, 3, 4), (1, 9, 4)))
    want = Jops.flash_decode(*(jnp.asarray(a) for a in (q, k, v)), jnp.int32(7),
                             q2=jnp.asarray(q2), k2=jnp.asarray(k2), scale=0.3, impl="ref")
    got = Tops.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.tensor(7, dtype=torch.int32), q2=torch.from_numpy(q2), k2=torch.from_numpy(k2), scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)


# -- the MLA plan ---------------------------------------------------------------------

MAIN = (2, 128, 512, 64)             # B, H, latent, rope of deepseek-v3's decode
REDUCED = (2, TCFG.n_heads, TCFG.kv_lora_rank, TCFG.qk_rope_head_dim)
ALL_FORMATS = ["f32", "bf16", "int8", "int8_tok", "mxint4_blk"]


def _covers(plan, c):
    """The ranges cut the capacity ``c`` into whole tiles, every split
    holding some; at every kv_len tested the rows the splits stream
    (`hopper.fd_split_rows`) are [0, kv_len), each once, in split order,
    and the empty splits (which still join the cluster's merge) trail."""
    ranges, tile = plan["ranges"], plan["tile"]
    assert len(ranges) == plan["splits"] >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == c
    for (s, e), (s2, _) in zip(ranges, ranges[1:]):
        assert e == s2 and s < e and s % tile == 0
    assert plan["tiles"] == -(-c // tile)
    for kv_len in sorted({1, 31, 32, 33, c // 2, c - 1, c} & set(range(1, c + 1))):
        rows = hopper.fd_split_rows(ranges, kv_len)
        assert [r for s, e in rows for r in range(s, e)] == list(range(kv_len))
        empty = [s == e for s, e in rows]
        assert not empty[0] and empty == sorted(empty)


def _fits(plan, fmt, r, dr):
    """Every array of a raw stage 16-byte aligned, in order, and holding a
    tile of its rows with no slack past the next 16 bytes.  (The staging
    tile and the rest of shared memory are the launch's: the card tests
    take every format at the widest rows.)"""
    off_ls, off_rv, off_rs, stage = plan["layout"]
    lb, ls = hopper.fd_row_bytes(fmt, r)
    rb, rs = hopper.fd_row_bytes(fmt, dr)
    t = hopper.MLA_TILE
    assert off_ls >= t * lb and off_rv >= off_ls + t * ls
    assert off_rs >= off_rv + t * rb and stage >= off_rs + t * rs
    assert all(o % 16 == 0 for o in plan["layout"])
    assert stage - (off_rs + t * rs) < 16 and off_ls - t * lb < 16


@pytest.mark.parametrize("fmt", ALL_FORMATS)
@pytest.mark.parametrize("c", [1, 31, 33, 257, 528, 544])
def test_mla_plan_at_the_main_shape(fmt, c):
    b, h, r, dr = MAIN
    plan = hopper.flash_decode_mla_plan(b, h, r, dr, c, fmt)
    _covers(plan, c)
    # One cluster per (b, group of 16 heads), all 16 resident at once on an
    # H100.
    assert plan["groups"] == 8
    assert plan["blocks"] == b * 8 * plan["splits"]
    assert b * 8 <= hopper.MLA_RESIDENT_H100[plan["splits"] - 1]
    assert plan["splits"] == {1: 1, 2: 2, 9: 5, 17: 6}[plan["tiles"]]
    _fits(plan, fmt, r, dr)


@pytest.mark.parametrize("fmt", ["f32", "int8_tok", "mxint4_blk"])
@pytest.mark.parametrize("c", [1, 16, 24, 33, 200])
def test_mla_plan_at_the_reduced_shape(fmt, c):
    b, h, r, dr = REDUCED
    plan = hopper.flash_decode_mla_plan(b, h, r, dr, c, fmt)
    _covers(plan, c)
    assert plan["groups"] == 1
    assert plan["splits"] == min(8, plan["tiles"])          # 2 units: a tile per split
    _fits(plan, fmt, r, dr)


@pytest.mark.parametrize("units,tiles,splits", [(16, 17, 6), (16, 9, 5), (8, 17, 6),
                                                (2, 17, 6), (32, 17, 3), (1, 3, 3)])
def test_mla_plan_keeps_every_cluster_resident(units, tiles, splits):
    """The splits minimise waves of clusters times the longest split's tiles:
    clusters of 7 or 8 would leave deepseek-v3's 16th unit to a second wave."""
    plan = hopper.flash_decode_mla_plan(units, 16, 512, 64, 32 * tiles, "f32")
    assert plan["splits"] == splits
    assert units <= hopper.MLA_RESIDENT_H100[splits - 1]


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("h", [1, 4, 17, 20, 128])
def test_mla_head_groups_cover_the_heads(b, h):
    """Whole groups of 16 heads cover H with no empty group, and every
    cluster of the launch is resident."""
    plan = hopper.flash_decode_mla_plan(b, h, 512, 64, 528, "int8_tok")
    groups = plan["groups"]
    assert (groups - 1) * hopper.MLA_HEADS < h <= groups * hopper.MLA_HEADS
    assert b * groups <= hopper.MLA_RESIDENT_H100[plan["splits"] - 1]
    assert plan["blocks"] == b * groups * plan["splits"]


@pytest.mark.parametrize("fmt,r,dr", [
    (fmt, r, dr) for fmt in ALL_FORMATS
    for r, dr in ((512, 64), (512, 128), (32, 16), (384, 128), (100, 20), (4, 4))
    if fmt != "mxint4_blk" or not (r % 16 or dr % 16)])
def test_mla_raw_stage_holds_a_tile_of_each_array(fmt, r, dr):
    """From r 512 with the widest rope down to one float4 of each (mxint4_blk
    in whole groups of 16), every format's raw stage holds its four arrays,
    16-byte aligned."""
    plan = hopper.flash_decode_mla_plan(1, 16, r, dr, 1000, fmt)
    _fits(plan, fmt, r, dr)


def test_mla_copy_widths_take_the_reduced_rope_rows():
    """The reduced cut's mxint4_blk rope rows are 8 bytes of nibbles and 1
    exponent byte: narrower than a bulk copy's 16-byte chunks, the kernel
    copies them 8 and 1 bytes at a time."""
    rb, rs = hopper.fd_row_bytes("mxint4_blk", TCFG.qk_rope_head_dim)
    assert (rb, rs) == (8, 1)
    assert hopper.fd_alignment_width(rb) == 8 and hopper.fd_alignment_width(rs) == 1
    assert hopper.fd_alignment_width(4 * 512) == 16


@pytest.mark.parametrize("r,dr,fmt", [(513, 64, "f32"), (512, 132, "f32"),
                                      (516, 64, "f32"), (40, 16, "mxint4_blk"),
                                      (32, 6, "int8_tok")])
def test_mla_plan_rejects_widths_the_kernel_does_not_take(r, dr, fmt):
    with pytest.raises(ValueError, match="MLA"):
        hopper.flash_decode_mla_plan(2, 4, r, dr, 8, fmt)


# -- the bridge -----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _engines(quantize: bool):
    je = JEngine.from_config(JCFG, JSpec(quantize=quantize))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    model = bridge.model_from_tree(TCFG, tree)
    te = InferenceEngine.from_config(TCFG, EngineSpec(quantize=quantize), model=model,
                                     device="cpu")
    return je, te, tree


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_bridge_consumes_every_leaf_but_the_mtp_head(quantize):
    """Each leaf of the reference tree lands, value for value, in the port's
    tensor of the same name (layer groups in order: ``dense_head`` then the
    empty MoE ``blocks``; the MTP head's ``mtp`` subtree too, under the
    model's ``mtp``: no subtree is skipped), and the port holds nothing
    else."""
    _, te, tree = _engines(quantize)
    port = {**dict(te.model.named_parameters()), **dict(te.model.named_buffers())}
    offset, seen = 0, set()
    for gname, count, kind in Tlm.layer_groups(TCFG):
        for name, leaf in _leaves(tree[gname]):
            assert leaf.shape[0] == count, (gname, name)
            for i in range(count):
                key = f"blocks.{offset + i}.{name}"
                got = port[key]
                assert got.dtype == bridge.to_tensor(leaf[i]).dtype, key
                assert torch.equal(got, bridge.to_tensor(leaf[i])), key
                seen.add(key)
        offset += count
    assert Tlm.layer_groups(TCFG)[1] == ("blocks", 0, "moe")
    for top in ("embed", "final_norm", "lm_head", "mtp"):
        for name, leaf in _leaves(tree[top], top):
            name = name.replace("_mx.packed", "_packed").replace("_mx.exps", "_exps")
            got, want = port[name], bridge.to_tensor(leaf)
            if name.endswith("w8_vals"):            # the K-major buffer's [K, N] corner
                got = got[:want.shape[0], :want.shape[1]]
            elif name.endswith(".b") and got.shape != want.shape:   # padded with N
                got = got[:want.shape[0]]
            assert torch.equal(got, want), name
            seen.add(name)
    assert set(tree) == {"dense_head", "blocks", "embed", "final_norm", "lm_head", "mtp"}
    assert seen == set(port)
    attn = te.model.blocks[0].attn
    assert (attn.wk_b.w is not None) and (attn.wv_b.w is not None)
    if quantize:
        for lin in (attn.wq_a, attn.wkv_a, attn.wk_b, attn.wo, te.model.lm_head):
            assert lin.w8_vals.t().is_contiguous()          # K-major
        assert attn.wq_a.w is None and attn.wo.w is None


def test_bridge_rejects_a_group_of_the_wrong_depth():
    _, _, tree = _engines(False)
    bad = dict(tree, dense_head=jax.tree.map(lambda a: a[:2], tree["dense_head"]))
    with pytest.raises(ValueError, match="dense_head"):
        bridge.model_from_tree(TCFG, bad)


def test_port_deploy_keeps_the_absorbed_masters_like_the_reference():
    """Deploying the bridged master model gives the reference's deployed
    bytes, the wk_b / wv_b masters included (those of the MTP head's MLA
    too)."""
    master = _engines(False)[2]
    model = Tdeploy.deploy_quantize(bridge.model_from_tree(TCFG, master))
    want = _engines(True)[1].model
    got_t = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    want_t = {**dict(want.named_parameters()), **dict(want.named_buffers())}
    assert got_t.keys() == want_t.keys()
    for name, t in want_t.items():
        assert torch.equal(got_t[name], t), name
    assert TCFG.mtp and model.mtp is not None
    assert sum(name.endswith(("wk_b.w", "wv_b.w")) for name in got_t) == 2 * (TCFG.n_layers + 1)
    assert not any(name.endswith(".w") and not name.endswith(("wk_b.w", "wv_b.w"))
                   for name in got_t)


# -- module level -------------------------------------------------------------------


def _layer0(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree["dense_head"]["attn"])


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_mla_apply_and_decode_match_reference(quantize):
    je, te, tree = _engines(quantize)
    p_j, p_t = _layer0(tree), te.model.blocks[0].attn
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng.normal(size=(2, S, TCFG.d_model)).astype(np.float32))
    sj, st = _pair((rng.random((2, S)) + 0.5).astype(np.float32))
    sin_j, cos_j = Jlm._rope_tables(JCFG, S + 1)
    sin_t, cos_t = (torch.from_numpy(np.array(a)) for a in (sin_j, cos_j))
    apply_j = jax.jit(lambda p, x, sig, sin, cos: JL.mla_apply(
        p, x, sig, je.hsa, "prefill", JCFG, rope_sin=sin, rope_cos=cos))
    decode_j = jax.jit(lambda p, x, sig, c, pos, sin, cos: JL.mla_decode(
        p, x, sig, je.hsa, JCFG, c, pos, rope_sin=sin, rope_cos=cos))
    out_j, (ckv_j, kr_j) = apply_j(p_j, xj, sj, sin_j[:S], cos_j[:S])
    out_t, (ckv_t, kr_t) = TL.mla_apply(p_t, xt, st, te.hsa, "prefill", TCFG,
                                        rope_sin=sin_t[:S], rope_cos=cos_t[:S])
    _close(out_t.numpy(), out_j, quantize, "mla_apply out")
    _close(ckv_t.numpy(), ckv_j, quantize, "c_kv")
    _close(kr_t.numpy(), kr_j, quantize, "k_rope")

    # One decode step at position S from the reference's latents (a cache of
    # S + 4 slots), the same new token on both sides.
    pad = ((0, 0), (0, 4), (0, 0))
    cache_j = {"c_kv": jnp.pad(ckv_j, pad), "k_rope": jnp.pad(kr_j, pad)}
    cache_t = {k: torch.from_numpy(np.array(v)) for k, v in cache_j.items()}
    yj, yt = _pair(rng.normal(size=(2, 1, TCFG.d_model)).astype(np.float32))
    gj, gt = _pair((rng.random((2, 1)) + 0.5).astype(np.float32))
    dj, new_j = decode_j(p_j, yj, gj, cache_j, jnp.int32(S), sin_j[S], cos_j[S])
    dt, new_t = TL.mla_decode(p_t, yt, gt, te.hsa, TCFG, cache_t,
                              torch.tensor(S, dtype=torch.int32),
                              rope_sin=sin_t[S], rope_cos=cos_t[S])
    _close(dt.numpy(), dj, quantize, "mla_decode out")
    for name in ("c_kv", "k_rope"):
        _close(new_t[name].numpy(), new_j[name], quantize, name)


# -- slice level ----------------------------------------------------------------------


def _prompts(seed=7):
    return np.random.default_rng(seed).integers(1, JCFG.vocab_size, (2, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jit(quantize: bool):
    je = _engines(quantize)[0]
    prefill = jax.jit(lambda p, t: Jlm.forward_prefill(p, {"tokens": t}, JCFG, je.hsa,
                                                       cache_len=CACHE_LEN))
    decode = jax.jit(lambda p, t, c: Jlm.forward_decode(p, t, c, JCFG, je.hsa))
    return prefill, decode


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_prefill_logits_and_latent_cache(quantize):
    je, te, _ = _engines(quantize)
    prefill, _ = _jit(quantize)
    toks = _prompts()
    jl, jc = prefill(je.params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(te.model, torch.from_numpy(toks).long(), TCFG, te.hsa,
                                 cache_len=CACHE_LEN)
    _close(tl.numpy(), jl, quantize)
    widths = {"c_kv": TCFG.kv_lora_rank, "k_rope": TCFG.qk_rope_head_dim}
    for name, width in widths.items():
        got = np.stack([blk[name].numpy() for blk in tc["blocks"]])
        assert got.shape == (3, 2, CACHE_LEN, width)
        _close(got, jc["dense_head"][name], quantize, name)
        assert not got[:, :, S:].any()          # right-padded with zeros
    assert all(set(blk) == set(widths) for blk in tc["blocks"])
    assert tc["pos"] == int(jc["pos"]) == S


@pytest.mark.parametrize("fmt", CACHE_FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
def test_eight_decode_steps(quantize, fmt):
    je, te, _ = _engines(quantize)
    prefill, decode = _jit(quantize)
    toks = _prompts()
    jl, jc = prefill(je.params, jnp.asarray(toks))
    tl, tc = Tlm.forward_prefill(te.model, torch.from_numpy(toks).long(), TCFG, te.hsa,
                                 cache_len=CACHE_LEN)
    if fmt is not None:                 # eagerly, as the JAX engine does
        jc, tc = Jlm.quantize_cache(jc, JCFG, fmt), Tlm.quantize_cache(tc, TCFG, fmt)
        assert all(set(leaf) == set(jc["dense_head"][name])
                   for blk in tc["blocks"] for name, leaf in blk.items())
    for step in range(NEW):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = decode(je.params, jnp.asarray(tok), jc)
        tl, tc = Tlm.forward_decode(te.model, torch.from_numpy(tok).long(), tc, TCFG,
                                    te.hsa)
        _close(tl.numpy(), jl, quantize, f"step {step}")
    assert tc["pos"] == int(jc["pos"]) == S + NEW
    np.testing.assert_allclose(tc["rope"].sin.numpy(), np.asarray(jc["rope"].sin),
                               atol=2e-5)


@pytest.mark.parametrize("cache_format", CACHE_FORMATS, ids=FORMAT_IDS)
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "default_spec"])
def test_greedy_tokens_identical_to_jax(quantize, cache_format):
    """Slice-6 gate: reduced deepseek-v3 cut to its dense layers, the latent
    cache kept f32 or encoded at the prefill/decode boundary."""
    je, te, _ = _engines(quantize)
    prompts = _prompts(4)
    want = je.generate(jnp.asarray(prompts),
                       JGen(max_new_tokens=12, cache_format=cache_format))
    got = te.generate(torch.from_numpy(prompts),
                      GenerationConfig(max_new_tokens=12, cache_format=cache_format))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.decode_steps == 12


def test_cold_cache_matches_a_one_token_prefill():
    """`make_decode_cache(start_pos=0)` holds MLA's exact empty state: the
    first token decoded from it gives a one-token prefill's logits and
    latents (the online rope state at position 0 is exact)."""
    _, te, _ = _engines(False)
    tok = torch.from_numpy(_prompts()[:, :1]).long()
    lp, cp = Tlm.forward_prefill(te.model, tok, TCFG, te.hsa, cache_len=4)
    cold = Tlm.make_decode_cache(TCFG, 2, 4, dtype=torch.float32, device="cpu")
    assert set(cold["blocks"][0]) == {"c_kv", "k_rope"}
    ld, cd = Tlm.forward_decode(te.model, tok, cold, TCFG, te.hsa)
    torch.testing.assert_close(ld, lp, **FP_TOL)
    for a, b in zip(cd["blocks"], cp["blocks"]):
        for name in ("c_kv", "k_rope"):
            torch.testing.assert_close(a[name], b[name], **FP_TOL)
