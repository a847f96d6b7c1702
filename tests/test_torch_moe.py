"""The routed MoE of repro_torch against the JAX package, on the CPU.

Reduced olmoe-1b-7b (2 MoE layers: 4 experts, top 2, ``moe_d_ff`` 64, GQA
with QK-norm) and reduced deepseek-v3 with its MoE layers (3 dense layers,
then 2 MoE layers with the shared expert, over MLA), the JAX engines'
weights carried over by `repro_torch.bridge`:

* `mlp.dispatch` against the reference's `_dispatch` (random routing, a
  skewed one that drops, ``no_drop``, and per-lane dispatches against one
  reference dispatch each), the capacity rule at its edges;
* `mlp.moe_apply` against the reference's in the prefill (capacity form),
  decode (assigned form) and verify (``no_drop``) phases, on fp and deployed
  weights, with and without the shared expert, and with inputs skewed so
  that assignments drop;
* `mxint4_expert_matmul`'s plain version against the reference's
  ``dequantize_stacked`` and a per-row product (1e-5), and its ids read as
  they come;
* the deploy pass's expert bytes equal to the reference's, and
  `bridge.model_from_tree` on master and deployed trees;
* greedy `generate` tokens against the JAX engine in every cache format, on
  fp weights and on the default deployment (up to ROADMAP C's near ties:
  the seeded prompts here have none), and a B 2 decode whose one dispatch
  drops an assignment across lanes, step for step against the reference.

The serving paths (admission, scheduler, prefix cache, speculative decode,
the serve CLI) are in tests/test_torch_moe_serving.py; the card's side in
tests/test_torch_cuda.py.
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
from repro.models import deploy as Jdeploy
from repro.models import lm as Jlm
from repro.models import mlp as JM
from repro.serving import EngineSpec as JSpec
from repro.serving import GenerationConfig as JGen
from repro.serving import InferenceEngine as JEngine
from repro_torch import bridge, configs as Tconfigs
from repro_torch.core import mxint4 as Tmx
from repro_torch.kernels import hopper, ops, ref
from repro_torch.models import deploy as Tdeploy
from repro_torch.models import lm as Tlm
from repro_torch.models import mlp as TM
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from repro_torch.serving.sampling import GenerationConfig
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

OL, DS = "olmoe-1b-7b", "deepseek-v3-671b"
ARCHS, ARCH_IDS = [OL, DS], ["olmoe", "ds3"]
FORMATS, FORMAT_IDS = [None, "int8_tok", "mxint4_blk"], ["f32", "int8_tok", "mxint4_blk"]
FP_TOL = 1e-5
NEW = 8


def _carry(cfg, je) -> InferenceEngine:
    """The port's engine on the JAX engine's weights (its deployment)."""
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    quantize = je.spec.quantize
    return InferenceEngine.from_config(cfg, EngineSpec(quantize=quantize),
                                       model=bridge.model_from_tree(cfg, tree, device="cpu"),
                                       device="cpu")


@functools.lru_cache(maxsize=None)
def engines(arch: str, quantize: bool = False):
    je = fp_engine(arch) if not quantize else JEngine.from_config(arch, JSpec(reduced=True))
    return je, _carry(Tconfigs.get_config(arch).reduced(), je)


def _close(got, want, tol: float, what: str = "") -> None:
    """|got - want| within ``tol`` of max|want| (and of 1 for small values)."""
    want = np.asarray(want, dtype=np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(np.asarray(got, dtype=np.float32) - want).max())
    assert err <= tol * scale, f"{what}: max|diff| {err:.3e} > {tol} x {scale:.3e}"


# -- dispatch ----------------------------------------------------------------------


def _routing(kind: str, t: int, e: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "skewed":                 # every token's top k: the same experts
        return np.tile(np.arange(k), (t, 1))
    return np.stack([rng.permutation(e)[:k] for _ in range(t)])


@pytest.mark.parametrize("kind,t,e,k,cap", [
    ("random", 12, 4, 2, 8), ("random", 40, 8, 3, 4), ("skewed", 12, 4, 2, 8),
    ("skewed", 5, 4, 2, 1), ("random", 9, 4, 2, 9)],
    ids=["random", "random_tight", "skewed_drops", "skewed_cap1", "no_drop"])
def test_dispatch_matches_reference(kind, t, e, k, cap):
    idx = _routing(kind, t, e, k, seed=t + e)
    x = np.random.default_rng(1).normal(size=(t, 4)).astype(np.float32)
    gates = np.full((t, k), 1.0 / k, np.float32)
    _, slots = JM._dispatch(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(gates), e, cap)
    want = np.stack([np.asarray(pos) for _, pos, _ in slots], axis=-1)
    got = TM.dispatch(torch.from_numpy(idx)[None], e, cap)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "skewed":
        assert (want == cap).sum() == max(0, t - cap) * k     # the later tokens drop


def test_per_lane_dispatch_is_one_dispatch_per_lane():
    """G lanes of T tokens: each lane's slots are the reference's dispatch
    of that lane alone (the scheduler's per-slot vmap)."""
    e, k, cap = 4, 2, 3
    idx = np.stack([_routing("random", 6, e, k, seed=s) for s in (3, 4, 5)])
    got = TM.dispatch(torch.from_numpy(idx), e, cap).numpy()
    for lane in range(3):
        _, slots = JM._dispatch(jnp.zeros((6, 4)), jnp.asarray(idx[lane]),
                                jnp.ones((6, k)), e, cap)
        np.testing.assert_array_equal(got[lane], np.stack([np.asarray(p) for _, p, _ in slots],
                                                           axis=-1))


@pytest.mark.parametrize("t", [1, 2, 12, 100, 1000, 4096])
@pytest.mark.parametrize("arch", [OL, DS])
def test_capacity_rule(arch, t):
    """``round_cap(int(t k / E cf) + 1)`` at the published widths (olmoe at
    B 2 decode: 1, so two lanes on one expert drop the later), and ``t``
    under no_drop."""
    tc, jc = Tconfigs.get_config(arch), Jconfigs.get_config(arch)
    want = JM._round_cap(int(t * jc.top_k / jc.n_experts * jc.capacity_factor) + 1)
    assert TM.capacity(t, tc) == want
    assert TM.capacity(t, tc, no_drop=True) == t
    if arch == OL and t == 2:
        assert want == 1


# -- moe_apply -----------------------------------------------------------------------


def _moe_layer(arch: str, quantize: bool):
    """(JAX moe params, port MoE, JAX engine, port engine) of the first MoE
    layer."""
    je, te = engines(arch, quantize)
    first = te.cfg.first_dense_layers
    jp = jax.tree.map(lambda a: a[0], je.params["blocks"])["moe"]
    return jp, te.model.blocks[first].moe, je, te


PHASES = [("prefill", False), ("decode", False), ("prefill", True)]
PHASE_IDS = ["prefill", "decode", "verify"]


@pytest.mark.parametrize("skewed", [False, True], ids=["random", "skewed"])
@pytest.mark.parametrize("phase,no_drop", PHASES, ids=PHASE_IDS)
@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_moe_apply_matches_reference(arch, quantize, phase, no_drop, skewed):
    """[2, 6] tokens (cap 8 of 24 assignments); skewed: near-identical rows
    that all take the same experts, so 8 of 24 drop (but under no_drop)."""
    jp, tp, je, te = _moe_layer(arch, quantize)
    rng = np.random.default_rng(17)
    d = te.cfg.d_model
    if skewed:
        x = (rng.normal(size=(1, 1, d)) + 0.01 * rng.normal(size=(2, 6, d))).astype(np.float32)
    else:
        x = rng.normal(size=(2, 6, d)).astype(np.float32)
    sig = rng.uniform(0.5, 1.5, (2, 6)).astype(np.float32)
    want, _ = jax.jit(lambda x, s: JM.moe_apply(jp, x, s, je.hsa, phase, je.cfg,
                                                no_drop=no_drop))(jnp.asarray(x),
                                                                  jnp.asarray(sig))
    calls = []
    orig = TM.dispatch

    def spy(*a):
        calls.append(orig(*a))
        return calls[-1]

    TM.dispatch = spy
    try:
        with torch.inference_mode():
            got = TM.moe_apply(tp, torch.from_numpy(x), torch.from_numpy(sig), te.hsa, phase,
                               te.cfg, no_drop=no_drop)
    finally:
        TM.dispatch = orig
    assert got.shape == (2, 6, d) and got.dtype == torch.float32
    _close(got.numpy(), want, QUANT_REL if quantize else FP_TOL, "moe_apply")
    dropped = int((calls[0] == TM.capacity(12, te.cfg, no_drop)).sum())
    if no_drop:
        assert dropped == 0
    elif skewed:
        assert dropped == 8


def _decode_and_prefill(permute: bool = False):
    """One B 2 token layer of reduced olmoe on fp stacks through the assigned
    form (decode) and the capacity form (prefill); ``permute`` hands the
    assigned form each row's next expert instead of its own."""
    _, tp, _, te = _moe_layer(OL, False)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 1, 128)).astype(np.float32))
    real = TM._ffn_assigned

    def shifted(ex, rows, idx, impl):
        return real(ex, rows, (idx + 1) % te.cfg.n_experts, impl)

    if permute:
        TM._ffn_assigned = shifted
    try:
        with torch.inference_mode():
            dec = TM.moe_apply(tp, x, None, te.hsa, "decode", te.cfg)
            pre = TM.moe_apply(tp, x, None, te.hsa, "prefill", te.cfg)
    finally:
        TM._ffn_assigned = real
    return dec, pre


def test_fp_decode_gathers_only_the_chosen_experts():
    """On fp stacks the assigned form multiplies each row by its own
    expert's weight, gathered: the same as the capacity form's product up to
    f32 summation order (a bmm of one row against one of cap + 1 rows parts
    them by about 4e-7 of max|out| on some hosts), held at the file's f32
    tolerance."""
    dec, pre = _decode_and_prefill()
    _close(dec.numpy(), pre.numpy(), FP_TOL, "assigned vs capacity form")


def test_fp_decode_with_the_wrong_experts_parts_from_the_capacity_form():
    """The check above can see a wrong gather: each row times its next
    expert's weight moves the output far beyond FP_TOL."""
    dec, pre = _decode_and_prefill(permute=True)
    err = float((dec - pre).abs().max())
    assert err > 100 * FP_TOL * float(pre.abs().max()), err


# -- the expert kernel's plain version -----------------------------------------------------


@pytest.mark.parametrize("e,k,n,a", [(4, 128, 64, 6), (8, 64, 128, 16), (64, 96, 32, 5)])
def test_expert_matmul_plain_matches_reference_dequantize(e, k, n, a):
    """Row a times expert ids[a]: the plain version against the reference's
    ``quantize_stacked`` / ``dequantize_stacked`` bytes and values, and one
    f32 product per row, 1e-5."""
    rng = np.random.default_rng(e + k + n)
    w = (rng.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.normal(size=(a, k)).astype(np.float32)
    ids = rng.integers(0, e, a)
    jq = Jdeploy.quantize_stacked(jnp.asarray(w))
    packed, exps = Tdeploy.quantize_stacked(torch.from_numpy(w))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq["packed"]))
    np.testing.assert_array_equal(exps.numpy(), np.asarray(jq["exps"]))
    wd = np.asarray(Jdeploy.dequantize_stacked({"w_mx": jq}, "w"))
    np.testing.assert_array_equal(Tmx.dequantize_stacked(packed, exps).numpy(), wd)
    want = np.einsum("ak,akn->an", x, wd[ids])
    hopper.reset_launches()
    got = ops.mxint4_expert_matmul(torch.from_numpy(x), packed, exps, torch.from_numpy(ids))
    assert got.shape == (a, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert sum(hopper.LAUNCHES.values()) == 0           # the CPU runs the plain version
    got32 = ref.mxint4_expert_matmul_ref(torch.from_numpy(x), packed, exps,
                                         torch.from_numpy(ids).int())
    assert torch.equal(got32, got)


def test_expert_matmul_kernel_impl_on_cpu_raises():
    packed, exps = Tdeploy.quantize_stacked(torch.ones(2, 32, 32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.mxint4_expert_matmul(torch.zeros(3, 32), packed, exps, torch.zeros(3).long(),
                                 impl="kernel")


# -- deploy and the bridge ---------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_deployed_expert_bytes_equal_reference(arch):
    """The port's deploy pass on the reference's master weights gives the
    reference's deployed bytes for every linear and expert stack; experts
    keep no master and no INT8 copy."""
    cfg = Jconfigs.get_config(arch).reduced()
    tcfg = Tconfigs.get_config(arch).reduced()
    params, _, paths = Jlm.init(cfg, jax.random.key(0))
    deployed = Jdeploy.deploy_quantize(params, paths)
    model = Tdeploy.deploy_quantize(bridge.model_from_tree(
        tcfg, jax.tree.map(np.asarray, jax.device_get(params))))
    want = bridge.model_from_tree(tcfg, jax.tree.map(np.asarray, jax.device_get(deployed)))
    got_bufs, want_bufs = dict(model.named_buffers()), dict(want.named_buffers())
    assert got_bufs.keys() == want_bufs.keys()
    for name, t in want_bufs.items():
        assert torch.equal(got_bufs[name], t), name
    assert {n for n, _ in model.named_parameters()} == {n for n, _ in want.named_parameters()}
    for blk in model.blocks[tcfg.first_dense_layers:]:
        ex = blk.moe.experts
        assert ex.deployed and ex.wi is None and ex.wo is None
        assert ex.wg_packed.shape == (tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff // 2)
        assert ex.wo_exps.shape == (tcfg.n_experts, tcfg.moe_d_ff, tcfg.d_model // 32)
        assert blk.moe.router.w8_vals is not None


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_model_from_tree_copies_moe_leaves(arch, quantize):
    """Every MoE leaf of the reference's tree lands byte for byte: the expert
    stacks (master, or ``{wg, wi, wo}_mx.{packed, exps}``), the router and
    the shared expert; the groups' block kinds."""
    je, te = engines(arch, quantize)
    cfg = te.cfg
    assert [type(b) for b in te.model.blocks] == (
        [Tlm.DenseBlock] * cfg.first_dense_layers + [Tlm.MoEBlock] * 2)
    for i in range(2):
        jp = jax.tree.map(lambda a, i=i: np.asarray(a[i]), je.params["blocks"])["moe"]
        tp = te.model.blocks[cfg.first_dense_layers + i].moe
        for n in TM.EXPERT_WEIGHTS:
            if quantize:
                for part in ("packed", "exps"):
                    np.testing.assert_array_equal(
                        getattr(tp.experts, f"{n}_{part}").numpy(), jp["experts"][f"{n}_mx"][part])
            else:
                np.testing.assert_array_equal(getattr(tp.experts, n).numpy(),
                                              jp["experts"][n])
        key = "w8_vals" if quantize else "w"
        want = jp["router"][key]                 # W8A8: the K-major [K, 16] padding's corner
        np.testing.assert_array_equal(getattr(tp.router, key)[:, :want.shape[1]].numpy(), want)
        assert (tp.shared is not None) == ("shared" in jp)
        if tp.shared is not None:
            np.testing.assert_array_equal(
                getattr(tp.shared.wo, key).numpy(), jp["shared"]["wo"][key])


# -- generate ------------------------------------------------------------------------


def _prompts(s: int, seed: int, b: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 512, (b, s)).astype(np.int32)


GREEDY_CELLS = [(a, q, f) for a in ARCHS for q in (False, True) for f in FORMATS]


@pytest.mark.parametrize("arch,quantize,fmt", GREEDY_CELLS, ids=[
    f"{i}-{'deployed' if q else 'fp'}-{f or 'f32'}"
    for (a, q, f), i in zip(GREEDY_CELLS, [ARCH_IDS[ARCHS.index(a)] for a, _, _ in
                                           GREEDY_CELLS])])
def test_greedy_tokens_identical_to_jax(arch, quantize, fmt):
    """16-token prompts at B 2 and 8 new tokens: the decode dispatch holds
    both lanes (cap 2 of 4 assignments at the reduced widths)."""
    je, te = engines(arch, quantize)
    prompts = _prompts(16, 1)
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=NEW, cache_format=fmt))
    got = te.generate(torch.from_numpy(prompts),
                      GenerationConfig(max_new_tokens=NEW, cache_format=fmt))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))


@functools.lru_cache(maxsize=None)
def _tight():
    """Reduced olmoe with capacity factor 0.5: a B 2 decode dispatch has cap
    1 (as olmoe's published widths give at B 2), so two lanes that pick one
    expert drop the later lane's assignment."""
    jcfg = dataclasses.replace(Jconfigs.get_config(OL).reduced(), capacity_factor=0.5)
    tcfg = dataclasses.replace(Tconfigs.get_config(OL).reduced(), capacity_factor=0.5)
    je = JEngine.from_config(jcfg, JSpec(quantize=False))
    return je, _carry(tcfg, je)


def test_batched_decode_drops_across_lanes_as_the_reference():
    """Eight B 2 decode steps from one prefill: logits step for step and the
    greedy tokens equal the reference's, and the dispatches dropped some
    assignments (cap 1 per expert for both lanes)."""
    je, te = _tight()
    assert TM.capacity(2, te.cfg) == 1
    prompts = _prompts(12, 4)
    jl, jc = je.prefill(jnp.asarray(prompts), cache_len=12 + NEW)
    tl, tc = te.prefill(torch.from_numpy(prompts), cache_len=12 + NEW)
    _close(tl.numpy(), jl, 1e-4, "prefill")
    decode = jax.jit(lambda t, c: Jlm.forward_decode(je.params, t, c, je.cfg, je.hsa))
    drops, orig = [], TM.dispatch

    def spy(idx, e, cap):
        pos = orig(idx, e, cap)
        drops.append(int((pos == cap).sum()))
        return pos

    TM.dispatch = spy
    try:
        for step in range(NEW):
            tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
            assert tok.tolist() == tl.argmax(-1)[:, None].tolist(), f"step {step}"
            jl, jc = decode(jnp.asarray(tok), jc)
            tl, tc = te.decode_step(torch.from_numpy(tok).long(), tc)
            _close(tl.numpy(), jl, 1e-4, f"step {step}")
    finally:
        TM.dispatch = orig
    assert sum(drops) > 0
    want = je.generate(jnp.asarray(prompts), JGen(max_new_tokens=NEW))
    got = te.generate(torch.from_numpy(prompts), GenerationConfig(max_new_tokens=NEW))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
