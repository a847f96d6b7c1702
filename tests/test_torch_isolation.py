"""repro_torch stands alone: no jax, no JAX package, card unless asked."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
print("NEW", all(m in sys.modules for m in NEW_MODULES))
"""

# Modules of the admission, serve-CLI, serving-stack, prefix-cache and training
# slices, which the probe must reach.
NEW_MODULES = ("repro_torch.launch.serve", "repro_torch.core.edge_model",
               "repro_torch.serving.engine", "repro_torch.serving.sampling",
               "repro_torch.serving.scheduler", "repro_torch.serving.frontend",
               "repro_torch.serving.loadgen", "repro_torch.serving.clock",
               "repro_torch.serving.paging", "repro_torch.serving.speculative",
               "repro_torch.obs", "repro_torch.obs.metrics", "repro_torch.obs.trace",
               "repro_torch.obs.profiler", "repro_torch.models.frontends",
               "repro_torch.data.pipeline", "repro_torch.optim.adamw",
               "repro_torch.optim.compression", "repro_torch.runtime.train_step",
               "repro_torch.runtime.checkpoint", "repro_torch.runtime.fault_tolerance",
               "repro_torch.launch.train")


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]))
    probe = f"NEW_MODULES = {NEW_MODULES!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "BAD []" in out.stdout, out.stdout
    assert int(out.stdout.split("LOADED")[1].split()[0]) >= 30
    assert "NEW True" in out.stdout, out.stdout


@pytest.mark.parametrize("argv", [
    ["--arch", "retnet-1.3b"],
    ["--arch", "retnet-1.3b", "--temperature", "1", "--top-p", "0.9"]])
def test_serve_cli_defaults_to_the_card(argv):
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(argv)


def test_from_config_defaults_to_the_card():
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine.from_config("retnet-1.3b", EngineSpec(reduced=True))


def test_from_config_rejects_unported_families():
    """A frontend the port does not serve raises, naming it: llava-next-34b's
    backbone with a ``video`` frontend (its ``vision`` frontend and
    seamless-m4t-medium's encoder-decoder are served)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    cfg = dataclasses.replace(configs.get_config("llava-next-34b"), frontend="video")
    with pytest.raises(NotImplementedError, match="video"):
        InferenceEngine.from_config(cfg, EngineSpec(reduced=True), device="cpu")


def test_from_config_rejects_deepseek_v3_with_its_moe_layers():
    """Reduced deepseek-v3 with its MoE layers builds on the CPU since the
    routed MoE was ported: 3 dense layers, then 2 MoE layers with the
    shared expert, deployed (the expert stacks in MXINT4 only)."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import EngineSpec, InferenceEngine
    eng = InferenceEngine.from_config("deepseek-v3-671b", EngineSpec(reduced=True),
                                      device="cpu")
    kinds = [type(b) for b in eng.model.blocks]
    assert kinds == [lm.DenseBlock] * 3 + [lm.MoEBlock] * 2
    moe = eng.model.blocks[-1].moe
    assert moe.shared is not None and moe.experts.deployed
    assert moe.experts.wg_packed.shape == (4, 128, 32)


@pytest.mark.parametrize("op", ["mxint4", "w8a8", "retention", "flash_decode",
                                "flash_decode_mla", "rmsnorm_stats"])
def test_kernel_impl_on_cpu_tensor_raises(op):
    from repro_torch.core import kvq
    from repro_torch.core import mxint4 as mx
    from repro_torch.core import retention as ret
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="CUDA"):
        if op == "mxint4":
            ops.mxint4_matmul(torch.zeros(2, 32), mx.quantize_mxint4(torch.ones(32, 32)),
                              impl="kernel")
        elif op == "w8a8":
            ops.w8a8_matmul(torch.zeros(2, 16, dtype=torch.int8),
                            torch.zeros(16, 16, dtype=torch.int8), 1.0, impl="kernel")
        elif op == "retention":
            q = torch.zeros(1, 2, 8, 4)
            ops.retention_chunkwise(q, q, q, ret.head_decays(2), chunk=8,
                                    impl="kernel")
        elif op == "flash_decode":
            kv = kvq.zeros((1, 8, 2, 32), "int8_tok")
            ops.flash_decode(torch.zeros(1, 2, 4, 32), kv, kv, torch.tensor(3, dtype=torch.int32),
                             impl="kernel")
        elif op == "flash_decode_mla":
            lat, rope = kvq.zeros((1, 8, 32), "int8_tok"), kvq.zeros((1, 8, 16), "int8_tok")
            ops.flash_decode(torch.zeros(1, 4, 32), lat, lat, torch.tensor(3, dtype=torch.int32),
                             q2=torch.zeros(1, 4, 16), k2=rope, scale=0.2, impl="kernel")
        else:
            ops.rmsnorm_stats(torch.ones(4, 64), impl="kernel")


def test_auto_on_cpu_runs_the_plain_version_and_counts_no_launch():
    from repro_torch.kernels import hopper, ops
    hopper.reset_launches()
    y = ops.w8a8_matmul(torch.ones(2, 16, dtype=torch.int8),
                        torch.ones(16, 16, dtype=torch.int8), 0.5)
    assert torch.equal(y, torch.full((2, 16), 8.0))
    assert sum(hopper.LAUNCHES.values()) == 0
