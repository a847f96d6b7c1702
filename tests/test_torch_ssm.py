"""The Mamba mixer and the W8A8 ragged shapes of the SSM families against
the JAX package.

`mamba_apply` (cold, warm, bucketed, S not a multiple of the chunk, with
per-position snapshots) and `mamba_decode` run on layer 0 of reduced
falcon-mamba-7b's and reduced hymba-1.5b's JAX params, carried over by
`repro_torch.bridge`, on the same seeded numpy inputs: fp weights hold 1e-4
of max|value| (retention's tolerance), deployed weights 1e-2
(`test_torch_retnet.QUANT_REL`: the int8 activation rounding).  Deployment
keeps the reference's bytes: every deployed leaf (the padded W8A8 buffers'
corners included) equals `deploy_quantize`'s.  The W8A8 wrapper's padding of
K or N to multiples of 16 is exact against the unpadded product, and never
copies the weight.
"""

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
from repro.models import ssm as JS
from repro.serving import EngineSpec as JSpec
from repro.serving import InferenceEngine as JEngine
from repro_torch import bridge, configs as Tconfigs
from repro_torch.kernels import ops, ref as kref
from repro_torch.models import deploy as Tdeploy
from repro_torch.models import lm as Tlm
from repro_torch.models import ssm as TS
from repro_torch.models.modules import Linear
from repro_torch.serving.engine import EngineSpec, InferenceEngine
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
ARCH_IDS = ["falcon_mamba", "hymba"]
REL = 1e-4


@functools.lru_cache(maxsize=None)
def _engines(arch: str, quantize: bool):
    """The JAX engine and the port's on its carried weights (once per
    (arch, quantize))."""
    je = (fp_engine(arch) if not quantize
          else JEngine.from_config(arch, JSpec(reduced=True)))
    tree = jax.tree.map(np.asarray, jax.device_get(je.params))
    model = bridge.model_from_tree(Tconfigs.get_config(arch).reduced(), tree, device="cpu")
    te = InferenceEngine.from_config(arch, EngineSpec(reduced=True, quantize=quantize),
                                     model=model, device="cpu")
    return je, te, tree


def _layer0(tree: dict) -> dict:
    return jax.tree.map(lambda a: a[0], tree["blocks"]["mamba"])


def _inputs(cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    sig = (0.5 + rng.random((b, s))).astype(np.float32)
    return x, sig


def _warm(cfg, b: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"h": (0.3 * rng.standard_normal((b, cfg.d_inner_, cfg.ssm_state))
                  ).astype(np.float32),
            "conv": rng.standard_normal((b, cfg.conv_width - 1, cfg.d_inner_)
                                        ).astype(np.float32)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, quantize: bool, msg: str = ""):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    rel = QUANT_REL if quantize else REL
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max(),
                               err_msg=msg)


def _mixers(arch, quantize):
    je, te, tree = _engines(arch, quantize)
    return je, te, _layer0(je.params), te.model.blocks[0].mamba


# -- mamba_apply / mamba_decode -------------------------------------------------------


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("case", ["cold", "warm", "valid_len", "collect", "tail_chunk"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_mamba_apply_matches_reference(arch, case, quantize):
    je, te, jp, tp = _mixers(arch, quantize)
    cfg = te.cfg
    s = {"cold": 32, "warm": 16, "valid_len": 32, "collect": 5, "tail_chunk": 37}[case]
    x, sig = _inputs(cfg, 2, s, seed=len(case))
    warm = _warm(cfg, 2, 7) if case in ("warm", "collect") else None
    vl = 21 if case == "valid_len" else None
    kw_j = dict(cache=None if warm is None else jax.tree.map(jnp.asarray, warm),
                valid_len=None if vl is None else jnp.int32(vl),
                collect_states=case == "collect")
    kw_t = dict(cache=None if warm is None else {k: _t(v) for k, v in warm.items()},
                valid_len=None if vl is None else torch.tensor(vl, dtype=torch.int32),
                collect_states=case == "collect")
    jy, jc = JS.mamba_apply(jp, jnp.asarray(x), jnp.asarray(sig), je.hsa, "prefill",
                            je.cfg, **kw_j)
    ty, tc = TS.mamba_apply(tp, _t(x), _t(sig), te.hsa, "prefill", cfg, **kw_t)
    _close(ty, jy, quantize, "y")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        _close(tc[name], jc[name], quantize, name)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_mamba_decode_matches_reference(arch, quantize):
    """Three recurrent steps from a warm state."""
    je, te, jp, tp = _mixers(arch, quantize)
    cfg = te.cfg
    warm = _warm(cfg, 2, 3)
    jc = jax.tree.map(jnp.asarray, warm)
    tc = {k: _t(v) for k, v in warm.items()}
    for step in range(3):
        x, sig = _inputs(cfg, 2, 1, seed=10 + step)
        jy, jc = JS.mamba_decode(jp, jnp.asarray(x), jnp.asarray(sig), je.hsa, je.cfg, jc)
        ty, tc = TS.mamba_decode(tp, _t(x), _t(sig), te.hsa, cfg, tc)
        _close(ty, jy, quantize, f"step {step} y")
        for name in ("h", "conv"):
            _close(tc[name], jc[name], quantize, f"step {step} {name}")


def test_chunked_scan_equals_one_pass():
    """Chunks of the scan carry the state exactly: 37 tokens in chunks of 16
    against one pass of all 37 (the snapshot pass), on fp weights."""
    _, te, _, tp = _mixers("falcon-mamba-7b", False)
    x, sig = _inputs(te.cfg, 2, 37, seed=5)
    y1, c1 = TS.mamba_apply(tp, _t(x), _t(sig), te.hsa, "prefill", te.cfg)
    y2, c2 = TS.mamba_apply(tp, _t(x), _t(sig), te.hsa, "prefill", te.cfg,
                            collect_states=True)
    _close(y1, y2.numpy(), False)
    _close(c1["h"], c2["h"].numpy(), False)
    torch.testing.assert_close(c1["conv"], c2["conv"], rtol=0, atol=0)
    _close(c2["h_all"][:, -1], c2["h"].numpy(), False)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 128])
def test_prefix_scan_matches_sequential(n):
    """The doubling scan against the sequential recurrence h_t = a_t h_{t-1}
    + b_t, in float64."""
    g = torch.Generator().manual_seed(n)
    a = torch.rand(n, 3, 4, generator=g, dtype=torch.float64)
    b = torch.randn(n, 3, 4, generator=g, dtype=torch.float64)
    a_sc, b_sc = TS._prefix_scan(a.clone(), b.clone())
    h, ha, hb = torch.zeros(3, 4, dtype=torch.float64), [], []
    pa = torch.ones(3, 4, dtype=torch.float64)
    for t in range(n):
        h = a[t] * h + b[t]
        pa = pa * a[t]
        ha.append(pa.clone())
        hb.append(h.clone())
    torch.testing.assert_close(a_sc, torch.stack(ha), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(b_sc, torch.stack(hb), rtol=1e-12, atol=1e-12)


def test_scan_block_holds_one_chunk():
    """A 300-token prefill scans in chunks of ``ssm_chunk``: `_scan_block`
    never sees more than one chunk's positions."""
    _, te, _, tp = _mixers("falcon-mamba-7b", False)
    seen = []
    real = TS._scan_block

    def spy(h0, dt, *rest):
        seen.append(dt.shape[0])
        return real(h0, dt, *rest)

    x, sig = _inputs(te.cfg, 1, 300, seed=2)
    TS._scan_block = spy
    try:
        TS.mamba_apply(tp, _t(x), _t(sig), te.hsa, "prefill", te.cfg)
    finally:
        TS._scan_block = real
    c = te.cfg.ssm_chunk
    assert seen == [c] * (300 // c) + [300 % c]


def test_mamba_make_cache_matches_reference():
    cfg = Tconfigs.get_config("falcon-mamba-7b").reduced()
    want = JS.mamba_make_cache(Jconfigs.get_config("falcon-mamba-7b").reduced(), 3)
    got = TS.mamba_make_cache(cfg, 3)
    for name in ("h", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32 and not got[name].any()


# -- deployment and the bridge ------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_deployed_leaves_are_reference_bytes(arch):
    """The port's own `deploy_quantize` gives every deployed leaf of the
    reference's, byte for byte, and so does the bridge from the reference's
    deployed tree; a W8A8 weight of ragged K or N (and its bias) is
    zero-padded to multiples of 16 around the reference's bytes, its logical
    ``[K, N]`` in the linear's ``shape``.  Conv, a_log and d_skip stay
    unquantized."""
    jcfg, tcfg = Jconfigs.get_config(arch).reduced(), Tconfigs.get_config(arch).reduced()
    params, _, paths = Jlm.init(jcfg, jax.random.key(0))
    jtree = jax.tree.map(np.asarray, jax.device_get(Jdeploy.deploy_quantize(params, paths)))
    model = Tdeploy.deploy_quantize(bridge.model_from_tree(
        tcfg, jax.tree.map(np.asarray, jax.device_get(params))))
    carried = bridge.model_from_tree(tcfg, jtree)
    got, want = dict(model.named_buffers()), dict(carried.named_buffers())
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    n_padded = 0
    for i, blk in enumerate(model.blocks):
        mixers = {"mamba": blk.mamba, **({"attn": blk.attn} if hasattr(blk, "attn") else {})}
        for mname, mod in mixers.items():
            for lname, lin in mod.named_children():
                ref_leaf = jtree["blocks"][mname][lname]
                k, n = lin.shape
                assert (k, n) == ref_leaf["w8_vals"][i].shape
                corner = {"w8_vals": (slice(k), slice(n)), "b": (slice(n),)}
                for fmt in ("w8_vals", "w8_scale", "mx_packed", "mx_exps", "b"):
                    t = getattr(lin, fmt)
                    assert (t is None) == (fmt not in ref_leaf), (mname, lname, fmt)
                    if t is not None:
                        np.testing.assert_array_equal(t[corner.get(fmt, ())].numpy(),
                                                      ref_leaf[fmt][i],
                                                      err_msg=f"{mname}.{lname}.{fmt}")
                w8 = lin.w8_vals
                assert w8.shape == (ops.up16(k), ops.up16(n)) and w8.t().is_contiguous()
                assert not w8[k:].any() and not w8[:, n:].any()
                if lin.b is not None:
                    assert lin.b.shape == (ops.up16(n),) and not lin.b[n:].any()
                n_padded += (k % 16 or n % 16) > 0
        for pname in ("conv_w", "conv_b", "a_log", "d_skip"):
            np.testing.assert_array_equal(getattr(blk.mamba, pname).numpy(),
                                          jtree["blocks"]["mamba"][pname][i])
    assert n_padded == tcfg.n_layers * 2     # x_proj (N 24) and dt_proj (K 8)


@pytest.mark.parametrize("quantize", [False, True], ids=["fp", "deployed"])
@pytest.mark.parametrize("arch", ARCHS, ids=ARCH_IDS)
def test_model_from_tree_consumes_every_leaf(arch, quantize):
    """The bridge copies every leaf of the reference's tree byte for byte
    (its parameters and buffers hold the tree's numbers in order) and marks
    hymba's full-attention layers as the reference's flags do."""
    _, te, tree = _engines(arch, quantize)
    n_tree = sum(a.size for a in jax.tree.leaves(tree))
    n_model = sum(t.numel() for t in te.model.parameters())
    n_model += sum(t.numel() for t in te.model.buffers())
    for lin in te.model.modules():        # the zero padding of ragged W8A8 weights
        if isinstance(lin, Linear) and lin.w8_vals is not None:
            k, n = lin.shape
            n_model -= lin.w8_vals.numel() - k * n
            n_model -= 0 if lin.b is None else lin.b.numel() - n
    assert n_model == n_tree
    if arch == "hymba-1.5b":
        n = te.cfg.n_layers
        want = np.asarray(Jlm.hybrid_full_attn_flags(Jconfigs.get_config(arch), 32))
        assert Tlm.hybrid_full_attn_flags(te.cfg, 32) == want.tolist()
        assert [b.full_attn for b in te.model.blocks] == Tlm.hybrid_full_attn_flags(te.cfg, n)


# -- W8A8 on ragged K and N ----------------------------------------------------------


@pytest.mark.parametrize("k,n", [(100, 3200), (3200, 132), (8, 256), (256, 24), (37, 45),
                                 (128, 128)])
def test_w8a8_padded_operands_exact(k, n):
    """The operands the kernel gets for a ragged K or N (the deployed
    zero-padded weight and bias, read whole, and the activations padded
    with zero columns, `ops.w8a8_padded_x`) give exactly the unpadded
    product once the output is sliced back (int8 zeros add nothing to the
    int32 sum), and so does the wrapper's plain version on the padded
    buffers with the logical N."""
    g = torch.Generator().manual_seed(k * 7 + n)
    w = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    wk = Tdeploy.k_major(w)
    b = torch.randn(n, generator=g)
    bias = Tdeploy.padded_vector(b)
    x = torch.randint(-127, 128, (5, k), generator=g, dtype=torch.int8)
    scale = torch.tensor(0.013)
    rs = torch.rand(5, generator=g) + 0.5
    want = kref.w8a8_matmul_ref(x, w, scale, rs, b)
    xp = ops.w8a8_padded_x(x, wk, n)
    assert wk.shape == (ops.up16(k), ops.up16(n)) == (xp.shape[1], bias.shape[0])
    assert wk.t().is_contiguous() and torch.equal(wk[:k, :n], w)
    got = kref.w8a8_matmul_ref(xp, wk, scale, rs, bias)[:, :n]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ops.w8a8_matmul(x, wk, scale, rs, bias, n=n, impl="ref"),
                               want, rtol=0, atol=0)


def test_w8a8_unpadded_ragged_weight_raises():
    """A ragged weight that is not zero-padded to multiples of 16 is
    refused by the kernel path, not copied."""
    w = torch.ones(100, 24, dtype=torch.int8).t().contiguous().t()
    with pytest.raises(ValueError, match="zero-padded"):
        ops.w8a8_padded_x(torch.ones(2, 100, dtype=torch.int8), w, 24)
