"""Training in repro_torch against the JAX package (reduced configs, CPU).

One JAX train state per config (``runtime.train_step.init_state`` at key 0)
is carried into the port by `repro_torch.bridge`; the same batches (the
pipeline's, byte-equal on both sides) go through both.  Tolerances:

* ``forward_train``'s loss at 1e-4 of the reference's value, and every
  gradient at 1e-4 of max|reference leaf| (the reference's leaf: a block
  tensor is stacked over the layers there): the reduced models are f32,
  and the two differ in f32 summation order only (up to 5e-5 of max on
  reduced retnet's first block, whose GroupNorm divides small outputs);
* the moments after 3 AdamW steps, and after one step from a carried JAX
  state at step 2, at 1e-4 of max|reference leaf|; the params there too
  wherever the step is fixed by the gradients rather than their f32 noise.
  AdamW divides the first moment by the root of the second, so an element
  whose gradient is near zero takes a step of up to the learning rate
  whose sign is that noise.  So the params are held at 1e-4 where the
  first moment agrees to 1e-3 of itself (at least 90 % of every leaf), and
  everywhere within the most two such steps can differ (twice the summed
  learning rates).

Every master that the reference's gradient reaches must get a gradient in
the port (a missing one is a silent error, not an exception); the only
masters without one are those whose reference gradient is exactly zero (a
fused LayerNorm's bias, which its emission does not read).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.hsa import HSAEngine as JHSA
from repro.data import pipeline as Jpipe
from repro.models import lm as Jlm
from repro.optim import adamw as Jadamw
from repro.optim import compression as Jcomp
from repro.runtime import train_step as Jts
from repro_torch import bridge
from repro_torch.core.hsa import HSAEngine as THSA
from repro_torch.data import pipeline as Tpipe
from repro_torch.models import lm as Tlm
from repro_torch.optim import adamw as Tadamw
from repro_torch.optim import compression as Tcomp
from repro_torch.runtime import checkpoint as Tckpt
from repro_torch.runtime import train_step as Tts
from test_torch_threads import one_torch_thread  # noqa: F401

REL = 1e-4
ARCHS = ["retnet-1.3b", "internlm2-1.8b", "qwen3-8b", "starcoder2-15b"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
OPT_CFG = Tadamw.AdamWConfig(**OPT)
B, S = 2, 32


def _cfg(arch):
    return get_config(arch).reduced()


def _data(cfg, s=S):
    return Jpipe.SyntheticPipeline(Jpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                                    global_batch=B))


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _jax_grads(arch, s=S):
    """The reference's loss and gradient tree at its key-0 params."""
    cfg = _cfg(arch)
    state, _, _ = Jts.init_state(cfg, Jadamw.AdamWConfig(**OPT), Jts.TrainOptions(),
                                 jax.random.key(0))
    fn = jax.jit(jax.value_and_grad(lambda p, b: Jlm.forward_train(p, b, cfg, JHSA()),
                                    has_aux=True))
    batch = _data(cfg, s).batch(0)
    (loss, _), grads = fn(state["params"], jax.tree.map(jnp.asarray, batch))
    return _np(state), float(loss), _np(grads), batch


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, microbatches=1, compress=False, n=3):
    """The reference's states after 0..n steps of its train step."""
    cfg = _cfg(arch)
    opts = Jts.TrainOptions(microbatches=microbatches, compress_grads=compress)
    opt = Jadamw.AdamWConfig(**OPT)
    state, _, _ = Jts.init_state(cfg, opt, opts, jax.random.key(0))
    step = jax.jit(Jts.train_step_fn(cfg, JHSA(), opt, opts))
    data, states, losses = _data(cfg), [_np(state)], []
    for i in range(n):
        state, metrics = step(state, jax.tree.map(jnp.asarray, data.batch(i)))
        states.append(_np(state))
        losses.append(float(metrics["loss"]))
    return states, losses


def _stacked_max(flat: dict) -> dict:
    """max|a| of each master's reference leaf: a block tensor's over every
    layer of its group (the reference stacks them, `lm.leaf_key`)."""
    tops: dict = {}
    for n, a in flat.items():
        k = Tlm.leaf_key(n)
        tops[k] = max(tops.get(k, 0.0), float(np.abs(a).max()))
    return {n: tops[Tlm.leaf_key(n)] for n in flat}


def _close(got: torch.Tensor, want, name: str, top: float):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, (name, got.shape, want.shape)
    bound = REL * max(top, 1e-30)
    err = np.abs(got - want).max()
    assert err <= bound, f"{name}: max err {err:.3e} > {bound:.3e}"


def _check_grads(cfg, model, grads_tree):
    """Every master's gradient against the reference's; None only where
    the reference's is exactly zero."""
    want = bridge.flat_tree(cfg, grads_tree)
    tops = _stacked_max(want)
    leaves = Tlm.train_leaves(model)
    assert set(want) == set(leaves)
    for name, t in leaves.items():
        if t.grad is None:
            assert not np.any(want[name]), f"{name}: no gradient, reference's is not zero"
            continue
        _close(t.grad, want[name], f"grad {name}", tops[name])


def _noisy(cfg, state, want, lr_sum, noisy=None) -> dict:
    """Elements whose step is the gradients' f32 noise: where the first
    moment's difference from the reference's, relative to itself and
    carried through AdamW's m / sqrt(v) over steps of ``lr_sum``, could
    exceed the params' tolerance; or-ed into ``noisy`` (the earlier
    steps')."""
    m_ref = bridge.flat_tree(cfg, want["opt"]["m"])
    tops = _stacked_max(bridge.flat_tree(cfg, want["params"]))
    out = {}
    for name, a in m_ref.items():
        dm = np.abs(state["opt"]["m"][name].numpy().astype(np.float64) - a)
        out[name] = (lr_sum * dm > REL * tops[name] * np.abs(a)) | (
            False if noisy is None else noisy[name])
    return out


def _check_state(cfg, state, want, tag, lr_sum, noisy):
    """Moments, params and step against the reference's state ``want``;
    ``noisy`` marks the elements whose step was noise at some step taken,
    ``lr_sum`` sums the learning rates of those steps (module docstring)."""
    leaves = Tlm.train_leaves(state["model"])
    for part in ("m", "v"):
        flat = bridge.flat_tree(cfg, want["opt"][part])
        tops = _stacked_max(flat)
        for name, a in flat.items():
            _close(state["opt"][part][name], a, f"{tag} {part} {name}", tops[name])
    flat = bridge.flat_tree(cfg, want["params"])
    tops = _stacked_max(flat)
    for name, a in flat.items():
        fixed = ~noisy[name]
        assert fixed.mean() >= 0.9, (tag, name, fixed.mean())
        err = np.abs(leaves[name].detach().double().numpy() - a)
        bound = REL * tops[name]
        assert err[fixed].max(initial=0) <= bound, f"{tag} params {name}: {err.max():.3e}"
        assert err.max() <= bound + 2 * lr_sum, f"{tag} params {name}: {err.max():.3e}"
    assert int(state["opt"]["step"]) == int(want["opt"]["step"])


def _lr_sum(steps):
    cfg = Tadamw.AdamWConfig(**OPT)
    return sum(float(Tadamw.schedule(torch.tensor(s), cfg)) for s in steps)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    cfg = _cfg(arch)
    state, loss, grads, batch = _jax_grads(arch)
    model = bridge.model_from_tree(cfg, state["params"])
    Tlm.set_trainable(model)
    t_loss, metrics = Tlm.forward_train(model, _tbatch(batch), cfg, THSA())
    assert abs(float(t_loss) - loss) <= REL * abs(loss)
    assert int(metrics["tokens"]) == int((np.asarray(batch["labels"]) >= 0).sum())
    t_loss.backward()
    _check_grads(cfg, model, grads)


def test_retention_gradient_across_the_128_split():
    """S 200: the port runs 128 rows through the chunkwise op, then the
    72-row tail from the state they carried (the reference takes its
    parallel form); every gradient, the retention projections' included."""
    cfg = _cfg("retnet-1.3b")
    state, loss, grads, batch = _jax_grads("retnet-1.3b", 200)
    model = bridge.model_from_tree(cfg, state["params"])
    Tlm.set_trainable(model)
    t_loss, _ = Tlm.forward_train(model, _tbatch(batch), cfg, THSA())
    assert abs(float(t_loss) - loss) <= REL * abs(loss)
    t_loss.backward()
    _check_grads(cfg, model, grads)


# (B, Sq, KV, G, hd, causal, window, q_chunk, kv_chunk): GQA groups, ragged
# chunks (padded queries and keys), a sliding window, non-causal.
FLASH_CASES = [(2, 40, 2, 2, 16, True, 0, 16, 32), (1, 33, 1, 3, 8, True, 8, 8, 16),
               (2, 24, 2, 1, 16, False, 0, 512, 1024), (1, 64, 2, 4, 8, True, 0, 512, 1024)]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_gradients_match_jax(case):
    """`layers.FlashAttention`'s backward (the reference's `_flash_bwd`,
    the GQA sum over G included) against jax.grad of the reference's
    flash attention, at 1e-5; with grad off the forward is unchanged."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    b, sq, kv, g, hd, causal, window, qc, kc = case
    rng = np.random.default_rng(sq + g)
    q = rng.normal(size=(b, sq, kv, g, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, sq, kv, hd)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=(b, sq, kv, g, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    jg = jax.grad(lambda q, k, v: jnp.sum(JL.flash_attention(q, k, v, **kw) * w),
                  argnums=(0, 1, 2))(q, k, v)
    ts_ = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = TL.flash_attention(*ts_, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    for t, want in zip(ts_, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(TL.flash_attention(*(t.detach() for t in ts_), **kw), out.detach())


@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_match_jax(arch):
    cfg = _cfg(arch)
    states, losses = _jax_steps(arch)
    state = bridge.train_state_from_tree(cfg, states[0])
    step = Tts.train_step_fn(cfg, THSA(), Tadamw.AdamWConfig(**OPT), Tts.TrainOptions())
    data = Tpipe.SyntheticPipeline(Tpipe.DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                                    global_batch=B))
    noisy = None
    for i in range(3):
        state, metrics = step(state, _tbatch(data.batch(i)))
        assert abs(float(metrics["loss"]) - losses[i]) <= REL * abs(losses[i])
        assert set(metrics) == {"loss", "aux_loss", "tokens", "lr", "grad_norm"}
        noisy = _noisy(cfg, state, states[i + 1], _lr_sum(range(3)), noisy)
    _check_state(cfg, state, states[3], "after 3 steps", _lr_sum(range(3)), noisy)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_from_a_carried_jax_state(arch):
    cfg = _cfg(arch)
    states, _ = _jax_steps(arch)
    state = bridge.train_state_from_tree(cfg, states[2])
    assert int(state["opt"]["step"]) == 2
    step = Tts.train_step_fn(cfg, THSA(), Tadamw.AdamWConfig(**OPT), Tts.TrainOptions())
    state, _ = step(state, _tbatch(_data(cfg).batch(2)))
    _check_state(cfg, state, states[3], "step 2 -> 3", _lr_sum([2]),
                 _noisy(cfg, state, states[3], _lr_sum([2])))


def test_microbatches_match_jax():
    """Two microbatches, their gradients summed in f32: one step."""
    cfg = _cfg("retnet-1.3b")
    states, losses = _jax_steps("retnet-1.3b", 2, False, 1)
    state = bridge.train_state_from_tree(cfg, states[0])
    step = Tts.train_step_fn(cfg, THSA(), Tadamw.AdamWConfig(**OPT),
                             Tts.TrainOptions(microbatches=2))
    state, metrics = step(state, _tbatch(_data(cfg).batch(0)))
    assert set(metrics) == {"loss", "lr", "grad_norm"}
    assert abs(float(metrics["loss"]) - losses[0]) <= REL * abs(losses[0])
    _check_state(cfg, state, states[1], "microbatched", _lr_sum([0]),
                 _noisy(cfg, state, states[1], _lr_sum([0])))


def test_compressed_grads_equal_jax_on_equal_gradients():
    """The reference's gradient tree through both compressions: the codes'
    dequantized values and the residuals equal bit for bit, every per-layer
    tensor of a stacked leaf on that leaf's one scale."""
    cfg = _cfg("retnet-1.3b")
    _, _, grads, _ = _jax_grads("retnet-1.3b")
    rng = np.random.default_rng(5)
    res = jax.tree.map(lambda g: (rng.normal(size=g.shape) * 1e-3).astype(np.float32), grads)
    j_deq, j_res, j_wire = Jcomp.compressed_grads(grads, res)
    t_grads = bridge.grads_from_tree(cfg, grads)
    t_deq, t_res, t_wire = Tcomp.compressed_grads(t_grads, bridge.grads_from_tree(cfg, res),
                                                  Tlm.leaf_groups(t_grads))
    assert t_wire == j_wire
    for got, want in ((t_deq, j_deq), (t_res, j_res)):
        for name, a in bridge.flat_tree(cfg, _np(want)).items():
            np.testing.assert_array_equal(got[name].numpy(), a, err_msg=name)


def test_compressed_step_matches_jax():
    """Two microbatches and int8 error-feedback compression, one step.  A
    gradient whose f32 noise straddles a rounding boundary lands one int8
    code apart: the residuals are held to the gradients' tolerance plus one
    code of their leaf's scale, at most 1 % of any leaf a code apart, and
    the first moment and the params to their tolerance plus what one code
    moves them."""
    cfg = _cfg("retnet-1.3b")
    states, losses = _jax_steps("retnet-1.3b", 2, True, 1)
    state = bridge.train_state_from_tree(cfg, states[0])
    opts = Tts.TrainOptions(microbatches=2, compress_grads=True)
    step = Tts.train_step_fn(cfg, THSA(), Tadamw.AdamWConfig(**OPT), opts)
    state, metrics = step(state, _tbatch(_data(cfg).batch(0)))
    assert abs(float(metrics["loss"]) - losses[0]) <= REL * abs(losses[0])
    m_ref = bridge.flat_tree(cfg, states[1]["opt"]["m"])
    clip = min(1.0, OPT_CFG.clip_norm / (float(metrics["grad_norm"]) + 1e-9))
    # One code of each leaf's scale: m = (1 - b1) * clip * dequantized, whose
    # largest is 127 codes.
    code = {n: top / (0.1 * clip) / 127 for n, top in _stacked_max(m_ref).items()}
    for name, a in bridge.flat_tree(cfg, states[1]["residuals"]).items():
        err = np.abs(state["residuals"][name].numpy() - a)
        assert (err > 0.5 * code[name]).mean() <= 1e-2, name
        assert err.max() <= REL * 127 * code[name] + code[name], name
    flat_p = bridge.flat_tree(cfg, states[1]["params"])
    tops_p = _stacked_max(flat_p)
    leaves = Tlm.train_leaves(state["model"])
    for name, a in m_ref.items():
        err_m = np.abs(state["opt"]["m"][name].numpy() - a).max()
        assert err_m <= (REL * 127 + 1) * 0.1 * clip * code[name], name
        err_p = np.abs(leaves[name].detach().double().numpy() - flat_p[name]).max()
        assert err_p <= REL * tops_p[name] + 2 * _lr_sum([0]), name


def test_int8_codes_equal_on_equal_inputs():
    rng = np.random.default_rng(3)
    for shape in [(64, 48), (7,), (3, 5, 9)]:
        g = rng.normal(size=shape).astype(np.float32)
        r = (rng.normal(size=shape) * 0.01).astype(np.float32)
        jq, js, jr = Jcomp.compress(jnp.asarray(g), jnp.asarray(r))
        tq, ts, tr = Tcomp.compress(torch.from_numpy(g), torch.from_numpy(r))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    zq, zs, _ = Tcomp.compress(torch.zeros(4), torch.zeros(4))
    assert float(zs) == 1.0 and not zq.any()


def test_schedule_matches_jax():
    for kw in (OPT, dict(lr=3e-4, warmup_steps=5, total_steps=20, min_lr_ratio=0.1)):
        jc, tc = Jadamw.AdamWConfig(**kw), Tadamw.AdamWConfig(**kw)
        for s in range(0, 25):
            want = float(Jadamw.schedule(jnp.int32(s), jc))
            got = float(Tadamw.schedule(torch.tensor(s, dtype=torch.int32), tc))
            assert abs(got - want) <= 1e-6 * abs(want), (s, got, want)


def test_weight_decay_follows_the_reference_layout():
    """A block's norm gain is decayed (the reference stacks it [L, d]), the
    final norm's is not; every per-layer leaf and every top-level matrix is."""
    cfg = _cfg("starcoder2-15b")
    model = bridge.model_from_tree(cfg, _jax_grads("starcoder2-15b")[0]["params"])
    leaves = Tlm.train_leaves(model)
    leaf_of = Tlm.leaf_groups(leaves)
    rule = {n: Tadamw.decayed(t, leaf_of[n] != n) for n, t in leaves.items()}
    assert rule["blocks.0.ln1.g"] and rule["blocks.1.ln2.b"]
    assert not rule["final_norm.g"] and not rule["final_norm.b"]
    assert rule["embed"] and rule["lm_head.w"] and rule["blocks.0.attn.wq.w"]
    assert all(rule[n] for n in leaves if n.startswith("blocks."))


def test_naive_decay_rule_misses_the_reference(monkeypatch):
    """The per-tensor ``ndim >= 2`` rule on the port's per-layer tensors
    leaves block norm gains undecayed: after 3 steps they miss the
    reference's by more than the tolerance, which the layout rule meets."""
    cfg = _cfg("retnet-1.3b")
    states, _ = _jax_steps("retnet-1.3b")
    monkeypatch.setattr(Tadamw, "decayed", lambda t, stacked: t.ndim >= 2)
    state = bridge.train_state_from_tree(cfg, states[0])
    step = Tts.train_step_fn(cfg, THSA(), Tadamw.AdamWConfig(**OPT), Tts.TrainOptions())
    for i in range(3):
        state, _ = step(state, _tbatch(_data(cfg).batch(i)))
    want = bridge.flat_tree(cfg, states[3]["params"])["blocks.0.ln1.g"]
    with pytest.raises(AssertionError):
        _close(Tlm.train_leaves(state["model"])["blocks.0.ln1.g"], want, "naive",
               float(np.abs(want).max()))


@pytest.mark.parametrize("seed,n_hosts,host_id,step", [(17, 1, 0, 0), (17, 1, 0, 5),
                                                       (3, 4, 2, 7), (17, 2, 1, 123)])
def test_pipeline_batches_byte_equal(seed, n_hosts, host_id, step):
    kw = dict(vocab_size=512, seq_len=48, global_batch=8, seed=seed, n_hosts=n_hosts,
              host_id=host_id)
    want = Jpipe.SyntheticPipeline(Jpipe.DataConfig(**kw)).batch(step)
    got = Tpipe.SyntheticPipeline(Tpipe.DataConfig(**kw)).batch(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


# -- the port alone ------------------------------------------------------------------


def _bf16_state(opts=Tts.TrainOptions()):
    import dataclasses
    cfg = dataclasses.replace(_cfg("retnet-1.3b"), param_dtype="bfloat16")
    opt = Tadamw.AdamWConfig(**OPT)
    return cfg, opt, Tts.init_state(cfg, opt, opts, seed=0, device="cpu")


def test_checkpoint_round_trip_and_resume(tmp_path, monkeypatch):
    """bf16 masters and f32 moments saved and restored bit for bit (keep-N,
    async save, a missing step raises); the async save's writer is held
    until the next step has updated the state in place, and the checkpoint
    still holds the state it was given; resuming from step 1's checkpoint
    gives step 2's loss bit-equal to the uninterrupted run."""
    import threading
    released, savez = threading.Event(), np.savez

    def held_savez(*args, **kwargs):
        assert released.wait(60), "the writer was never released"
        return savez(*args, **kwargs)

    monkeypatch.setattr(np, "savez", held_savez)
    cfg, opt, state = _bf16_state()
    step = Tts.train_step_fn(cfg, THSA(), opt, Tts.TrainOptions())
    data = Tpipe.SyntheticPipeline(Tpipe.DataConfig(cfg.vocab_size, S, B))
    mgr = Tckpt.CheckpointManager(str(tmp_path), keep_n=2)
    for i in range(2):
        state, _ = step(state, _tbatch(data.batch(i)))
        if i == 0:
            released.set()
        else:
            released.clear()
        mgr.save(i, Tts.state_tensors(state), blocking=(i == 0))
    saved = {n: t.clone() for n, t in Tts.state_tensors(state).items()}
    assert saved["params/embed"].dtype == torch.bfloat16
    _, m2 = step(state, _tbatch(data.batch(2)))
    assert mgr.all_steps() == [0], "the held writer published early"
    assert not torch.equal(Tts.state_tensors(state)["params/embed"], saved["params/embed"])
    released.set()
    mgr.wait()
    assert mgr.all_steps() == [0, 1] and mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        mgr.restore(Tts.state_tensors(state), step=7)
    _, _, fresh = _bf16_state()
    _, manifest = mgr.restore(Tts.state_tensors(fresh))
    assert manifest["step"] == 1
    for n, t in Tts.state_tensors(fresh).items():
        assert torch.equal(t, saved[n]), n
    _, r2 = step(fresh, _tbatch(data.batch(2)))
    assert torch.equal(r2["loss"], m2["loss"])
    mgr.save(5, Tts.state_tensors(fresh))
    assert mgr.all_steps() == [1, 5]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.int32])
def test_snapshot_bytes_are_a_copy(dtype):
    """A save's host bytes of a CPU tensor are its own: changing the tensor
    in place afterwards leaves them as they were."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(dtype)
    snap = Tckpt._host_bytes(t)
    before = snap.copy()
    t.add_(1)
    np.testing.assert_array_equal(snap, before)
    assert torch.equal(torch.from_numpy(snap).view(dtype).reshape(3, 4), t - 1)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "retnet-1.3b", "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path), "--fail-at", "1"]
    losses = train.main(args)
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "elastic plan" in out and "[train] done." in out
    resumed = train.main(args[:-2] + ["--steps", "4", "--resume"])
    assert "resumed from step 2" in capsys.readouterr().out and len(resumed) == 1
    with pytest.raises(SystemExit):
        train.main(["--arch", "retnet-1.3b", "--mesh", "single"])


def test_train_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        Tts.init_state(_cfg("retnet-1.3b"), Tadamw.AdamWConfig(), Tts.TrainOptions())


def test_ten_reduced_retnet_steps_lower_the_loss():
    """The quickstart's loop on the port: B 4, S 64, 10 steps."""
    cfg = _cfg("retnet-1.3b")
    opt = Tadamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    state = Tts.init_state(cfg, opt, Tts.TrainOptions(), seed=0, device="cpu")
    step = Tts.train_step_fn(cfg, THSA(), opt, Tts.TrainOptions())
    data = Tpipe.SyntheticPipeline(Tpipe.DataConfig(cfg.vocab_size, 64, 4))
    losses = []
    for i in range(10):
        state, metrics = step(state, _tbatch(data.batch(i)))
        losses.append(float(metrics["loss"]))
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_trained_model_deploys_and_serves():
    """from_config adopts a train state: the optimizer dropped from it, the
    masters detached, then deployed and served like a fresh model of those
    weights (the same greedy tokens)."""
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    cfg = _cfg("retnet-1.3b")
    opt = Tadamw.AdamWConfig(**OPT)
    state = Tts.init_state(cfg, opt, Tts.TrainOptions(), seed=0, device="cpu")
    step = Tts.train_step_fn(cfg, THSA(), opt, Tts.TrainOptions())
    state, _ = step(state, _tbatch(_data(cfg).batch(0)))
    twin = Tlm.init(cfg, seed=0, device="cpu")
    with torch.no_grad():
        for n, t in Tlm.train_leaves(twin).items():
            t.copy_(Tlm.train_leaves(state["model"])[n])
    eng = InferenceEngine.from_config(cfg, EngineSpec(), model=state, device="cpu")
    assert set(state) == {"model"}
    assert not any(p.requires_grad for p in eng.model.parameters())
    fresh = InferenceEngine.from_config(cfg, EngineSpec(), model=twin, device="cpu")
    prompts = torch.from_numpy(_data(cfg).batch(9)["tokens"][:, :8]).long()
    gen = GenerationConfig(max_new_tokens=6)
    assert torch.equal(eng.generate(prompts, gen).tokens, fresh.generate(prompts, gen).tokens)


@pytest.mark.parametrize("arch", ["qwen3-8b", "retnet-1.3b"])
def test_training_after_serving_in_one_process(arch):
    """A served step caches its constants (the attention scale) under
    inference mode; a later training forward in the same process must not
    save them for backward."""
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    from repro_torch.serving.sampling import GenerationConfig
    cfg = _cfg(arch)
    eng = InferenceEngine.from_config(cfg, EngineSpec(), device="cpu")
    eng.generate(torch.from_numpy(_data(cfg).batch(3)["tokens"][:, :8]).long(),
                 GenerationConfig(max_new_tokens=2))
    state, _, grads, batch = _jax_grads(arch)
    model = bridge.model_from_tree(cfg, state["params"])
    Tlm.set_trainable(model)
    Tlm.forward_train(model, _tbatch(batch), cfg, THSA())[0].backward()
    _check_grads(cfg, model, grads)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b", "olmoe-1b-7b",
                                  "deepseek-v3-671b", "seamless-m4t-medium",
                                  "llava-next-34b"])
def test_forward_train_refuses_families_outside_the_slice(arch):
    from repro_torch import configs
    cfg = configs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match="A13b"):
        Tlm.check_train(cfg)
    with pytest.raises(NotImplementedError, match="A13b"):
        Tts.train_step_fn(cfg, THSA(), Tadamw.AdamWConfig(), Tts.TrainOptions())
