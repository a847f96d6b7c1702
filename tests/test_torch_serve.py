"""The port's serve demo path: top-p sampling against `repro.serving.sampling`,
the nucleus-mass property on the port, and `repro_torch.launch.serve` on the
CPU: the single-generate path, the scheduler, host-spill, front-end, trace,
metrics and speculative modes, and the mode not ported yet, which exits
nonzero naming the ROADMAP item that ports it."""

import json

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import edge_model as Jedge
from repro.serving import sampling as Jsampling
from repro_torch.core import edge_model as Tedge
from repro_torch.launch import serve
from repro_torch.serving import sampling as Tsampling
from repro_torch.serving.sampling import GenerationConfig, SamplingParams, sample
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tied_logits(seed: int, v: int = 97) -> np.ndarray:
    """[4, V] logits with runs of exact ties (values on a coarse grid) and a
    row that is one logit repeated."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.normal(size=(4, v)) * 4.0) / 4.0
    x[1] *= 3.0
    x[2, : v // 2] = x[2, 0]
    x[3] = 0.5
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 0.999])
def test_top_p_mask_keeps_the_set_jax_keeps(p, seed):
    x = _tied_logits(seed)
    want = np.isfinite(np.asarray(Jsampling._top_p_mask(jnp.asarray(x), p)))
    got = Tsampling._top_p_mask(torch.from_numpy(x), p)
    assert want.any(axis=-1).all()
    np.testing.assert_array_equal(torch.isfinite(got).numpy(), want)
    kept = torch.isfinite(got)
    np.testing.assert_array_equal(got[kept].numpy(), x[kept.numpy()])


@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_applies_temperature_then_top_k_then_top_p(top_k):
    """Every draw lies in the set the reference's order of filters keeps."""
    x = _tied_logits(7)
    params = SamplingParams(temperature=0.7, top_k=top_k, top_p=0.6)
    z = jnp.asarray(x) / params.temperature
    if top_k:
        z = Jsampling._top_k_mask(z, top_k)
    allowed = np.isfinite(np.asarray(Jsampling._top_p_mask(z, params.top_p)))
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = sample(torch.from_numpy(x), params, g).numpy()
        assert allowed[np.arange(4), tok].all()


def test_sampling_params_validate_top_p_as_the_reference_does():
    for bad in (0.0, -0.1, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            Jsampling.SamplingParams(top_p=bad)
        with pytest.raises(ValueError, match="top_p"):
            SamplingParams(top_p=bad)
    assert SamplingParams(top_p=1.0).top_p == Jsampling.SamplingParams().top_p


logits_strategy = st.lists(
    st.floats(min_value=-10.0, max_value=10.0, allow_nan=False, allow_infinity=False,
              width=32),
    min_size=2, max_size=32)


@settings(max_examples=40, deadline=None)
@given(vals=logits_strategy,
       p=st.floats(min_value=0.0625, max_value=0.998046875, width=32),
       seed=st.integers(min_value=0, max_value=2**31 - 1))
def test_top_p_nucleus_keeps_at_least_p_mass(vals, p, seed):
    """The nucleus (every token top-p can sample) carries >= p of the mass,
    and the sampled token lies in it.  The bounds of ``p`` are exact in
    32-bit floats (1/16 and 1 - 2^-9)."""
    logits = torch.tensor(vals, dtype=torch.float32)[None, :]
    kept = torch.isfinite(Tsampling._top_p_mask(logits, p))[0]
    probs = torch.softmax(logits, dim=-1)[0]
    assert float(probs[kept].sum()) >= p - 1e-5
    tok = int(sample(logits, SamplingParams(temperature=1.0, top_p=p),
                     torch.Generator().manual_seed(seed))[0])
    assert bool(kept[tok])


def test_scenarios_match_the_reference():
    for name in ("LISO", "SILO"):
        j, t = getattr(Jedge, name), getattr(Tedge, name)
        assert (t.name, t.tokens_in, t.tokens_out, t.total_tokens) == (
            j.name, j.tokens_in, j.tokens_out, j.total_tokens)


@pytest.mark.parametrize("extra", [[], ["--temperature", "1", "--top-p", "0.9"]],
                         ids=["greedy", "top_p"])
def test_serve_cli_runs_on_the_cpu(extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "retnet-1.3b",
         "--reduced", "--scale", "0.02", "--batch", "2", "--device", "cpu", *extra],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[serve]")]
    assert lines[0] == "[serve] retnet-1.3b-reduced scenario=SILO in/out=2/15 batch=2"
    assert "W8A8 prefill / MXINT4" in lines[1]
    assert lines[2].startswith("[serve] prefill ") and "ms/token" in lines[2]
    assert "tokens/s (paper convention, prompt+output)" in lines[3]
    toks = eval(lines[4].split("sample output tokens: ")[1])
    assert len(toks) == 15 and all(0 <= t < 512 for t in toks)


_VALUES = {"--mesh": "2,2"}


@pytest.mark.parametrize("flag,dest,item,what", serve.UNPORTED,
                         ids=[u[0] for u in serve.UNPORTED])
def test_unported_flag_exits_nonzero_naming_its_roadmap_item(flag, dest, item, what,
                                                             capsys):
    argv = ["--arch", "retnet-1.3b", "--reduced", "--device", "cpu", flag]
    if flag in _VALUES:
        argv.append(_VALUES[flag])
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert flag in err and f"ROADMAP {item}" in err and what in err


def test_generation_config_carries_top_p_into_the_loop():
    gen = GenerationConfig(max_new_tokens=2, sampling=SamplingParams(temperature=1.0,
                                                                     top_p=0.5))
    assert gen.sampling.top_p == 0.5 and not gen.sampling.greedy


_CLI = ["--arch", "retnet-1.3b", "--reduced", "--device", "cpu", "--scale", "0.04"]


def _serve_lines(argv, capsys) -> list[str]:
    serve.main(_CLI + argv)
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve]")]


def test_scheduler_mode_serves_every_request(capsys):
    lines = _serve_lines(["--requests", "4", "--slots", "2", "--chunk-size", "2"], capsys)
    assert lines[0].startswith("[serve] scheduler: 4 requests") and "classes [(2, 32)]" in lines[0]
    assert "cycles" in lines[1] and "prefill chunks" in lines[1]
    assert "tokens/s" in lines[-1]


def test_host_spill_mode_preempts_and_resumes_with_trace_and_metrics(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    lines = _serve_lines(["--requests", "4", "--host-spill", "--oversubscribe", "2",
                          "--trace", str(trace), "--metrics", str(metrics)], capsys)
    assert "host-spill preemption on" in lines[0] and "classes [(2, 32)]" in lines[0]
    tier = next(ln for ln in lines if "host tier" in ln)
    n = int(tier.split("host tier: ")[1].split()[0])
    assert n >= 1 and f"{n} resumed" in tier
    snap = json.loads(metrics.read_text())
    assert snap["counters"]["sched.preempted"] == n == snap["counters"]["pool.spills"]
    assert snap["counters"]["pool.bytes_to_host"] == snap["counters"]["pool.bytes_to_device"]
    assert snap["counters"]["engine.prefill_chunks"] == snap["counters"]["sched.prefill_chunks"]
    events = json.loads(trace.read_text())["traceEvents"]
    assert {"preempt", "resume", "prefill_chunk", "first_token"} <= {e["name"] for e in events}


@pytest.mark.parametrize("arrival", ["poisson"])
def test_frontend_mode_holds_the_smoke_contract_on_virtual_time(arrival, capsys):
    lines = _serve_lines(["--frontend", "--virtual-clock", "--arrival", arrival,
                          "--requests", "4", "--rate", "8", "--ttft-slo", "1.5", "--slots",
                          "2"], capsys)
    assert "virtual clock" in lines[0] and arrival in lines[0]
    assert lines[-1].startswith("[serve] frontend smoke OK") and "0 unexplained" in lines[-1]


def test_prefix_cache_mode_adopts_the_shared_prompt_and_prints_the_hit_line(capsys):
    """``--prefix-cache`` on the repeated-system-prompt stream: 5 prompts of
    60 tokens opening with one 45-token prefix, one lane of 64 (the 34-lane
    class is too small for them), so every admission after the first adopts
    45 tokens (2 pages of 16 and a COW of 13)."""
    serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu", "--scenario", "LISO",
                "--scale", "0.08", "--requests", "5", "--slots", "2", "--chunk-size", "8",
                "--prefix-cache"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[serve]")]
    assert "prefix-cache on (45-token shared prefix)" in lines[0]
    assert lines[2] == ("[serve] prefix cache [paged]: 4/5 admissions adopted a cached "
                        "prefix, 180 prefill tokens skipped, 12 pages resident "
                        "(4 COW copies)")
    assert "tokens/s" in lines[-1]


def test_speculative_generate_prints_the_verify_line(capsys):
    """``--speculative --draft-k 3`` in the single-`generate` mode: the
    reference's speculative line (verify steps, drafts accepted of drafted,
    tokens per step) before the timing lines."""
    lines = _serve_lines(["--speculative", "--draft-k", "3"], capsys)
    spec = next(ln for ln in lines if ln.startswith("[serve] speculative:"))
    steps = int(spec.split("speculative: ")[1].split()[0])
    acc, drafted = spec.split("steps, ")[1].split()[0].split("/")
    assert 1 <= steps <= 30 and int(drafted) == 3 * steps and 0 <= int(acc) <= int(drafted)
    assert f"({1 + int(acc) / steps:.2f} tokens/step)" in spec
    assert lines[-1].startswith("[serve] sample output tokens")


def test_speculative_scheduler_prints_per_request_and_total_lines(capsys):
    """``--speculative --draft-k 3 --requests 4``: one line per request (its
    tokens, verify steps, tokens per step, drafts accepted) and the total
    line, the classes reserving k slots for the verify overrun."""
    lines = _serve_lines(["--requests", "4", "--slots", "2", "--chunk-size", "2",
                          "--speculative", "--draft-k", "3"], capsys)
    assert "classes [(2, 35)]" in lines[0]
    reqs = [ln for ln in lines if ln.startswith("[serve]   req ")]
    assert len(reqs) == 4 and all("verify steps" in ln and "tokens/step" in ln for ln in reqs)
    total = next(ln for ln in lines if ln.startswith("[serve] speculative:"))
    steps = int(total.split(" over ")[1].split()[0])
    assert steps == sum(int(ln.split(" tokens in ")[1].split()[0]) for ln in reqs)
    assert "tokens/s" in lines[-1]


def test_oversubscribe_must_exceed_one(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(_CLI + ["--requests", "4", "--oversubscribe", "1.0"])
    assert exc.value.code == 2 and "--oversubscribe" in capsys.readouterr().err
