"""The train step (the reference's `runtime/train_step.py`): the loss's
gradient, microbatch accumulation, optional int8 error-feedback
compression, then AdamW.

The state is ``{"model": LM, "opt": {"m", "v", "step"}[, "residuals"]}``:
the parameters live in the model (its masters, `lm.train_leaves`), and the
step updates them and the moments in place.  The reference's
``param_axes`` / `build_train_step` place the step on a device mesh; they
wait for ROADMAP A12 and raise until then.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hsa import HSAEngine
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, compression


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatches: int = 1            # >1: sequential grad accumulation
    compress_grads: bool = False     # int8 error-feedback


def gradients(model: lm.LM, batch: dict, cfg: ModelConfig, engine: HSAEngine,
              opts: TrainOptions) -> tuple[torch.Tensor, dict, dict[str, torch.Tensor]]:
    """(loss, metrics, grads by name) of ``batch`` at the model's masters.

    One microbatch: each master's gradient in its own dtype (bf16 for bf16
    masters, as the reference's cotangents are).  Several: the batch is cut
    along B, and each microbatch's gradients are added into f32 buffers (as
    the reference's scan carries f32 zeros; ``.grad`` accumulation would sum
    in the masters' dtype), then divided by the count.  A master that the
    loss does not read (a fused LayerNorm's bias, whose emission reads no
    beta) has a zero gradient, as under the reference's autodiff."""
    leaves = lm.train_leaves(model)
    for t in leaves.values():
        t.grad = None
    n = opts.microbatches
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    acc, l_acc, metrics = None, None, None
    for i in range(n):
        mb = {k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
        loss, metrics = lm.forward_train(model, mb, cfg, engine)
        loss.backward()
        grads = {name: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for name, t in leaves.items()}
        for t in leaves.values():
            t.grad = None
        if n == 1:
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads
        if acc is None:
            acc = {name: g.to(torch.float32) for name, g in grads.items()}
            l_acc = loss.detach().to(torch.float32)
        else:
            for name, g in grads.items():
                acc[name] += g
            l_acc = l_acc + loss.detach()
    inv = 1.0 / n
    loss = l_acc * inv
    return loss, {"loss": loss}, {name: g * inv for name, g in acc.items()}


def train_step_fn(cfg: ModelConfig, engine: HSAEngine, opt_cfg: adamw.AdamWConfig,
                  opts: TrainOptions):
    """The step: ``(state, batch) -> (state, metrics)``, metrics the loss's
    (``loss``, ``aux_loss``, ``tokens``; ``loss`` alone with microbatches)
    and the optimizer's (``lr``, ``grad_norm``), as device scalars.  The
    state is updated in place and returned."""
    lm.check_train(cfg)

    def step(state: dict, batch: dict):
        model = state["model"]
        loss, metrics, grads = gradients(model, batch, cfg, engine, opts)
        params = lm.train_leaves(model)
        leaf_of = lm.leaf_groups(params)
        if opts.compress_grads:
            grads, state["residuals"], _ = compression.compressed_grads(
                grads, state["residuals"], leaf_of)
        opt_metrics = adamw.update(grads, state["opt"], params, opt_cfg, leaf_of)
        return state, {**metrics, **opt_metrics}

    return step


def init_state(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, opts: TrainOptions, *,
               seed: int = 0, device="cuda") -> dict:
    """A fresh train state: seeded master weights, made trainable, zero
    moments and step, and zero residuals when ``compress_grads``.
    ``device`` defaults to the card; the CPU runs only when asked for."""
    lm.check_train(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train on the CPU")
    model = lm.init(cfg, seed=seed, device=device)
    params = lm.set_trainable(model)
    state = {"model": model, "opt": adamw.init(params, opt_cfg)}
    if opts.compress_grads:
        state["residuals"] = compression.init_residuals(params)
    return state


def state_tensors(state: dict) -> dict[str, torch.Tensor]:
    """Every tensor of a train state by a flat name: ``params/<leaf>``,
    ``opt/m/<leaf>``, ``opt/v/<leaf>``, ``opt/step`` and, with compression,
    ``residuals/<leaf>`` (what a checkpoint saves and restores)."""
    out = {f"params/{n}": t for n, t in lm.train_leaves(state["model"]).items()}
    for part in ("m", "v"):
        out.update({f"opt/{part}/{n}": t for n, t in state["opt"][part].items()})
    out["opt/step"] = state["opt"]["step"]
    out.update({f"residuals/{n}": t for n, t in state.get("residuals", {}).items()})
    return out


def param_axes(*args, **kwargs):
    """The reference's sharding of the state over a device mesh."""
    raise NotImplementedError("param_axes: sharding over a device mesh is not ported yet "
                              "(ROADMAP A12)")


def build_train_step(*args, **kwargs):
    """The reference's mesh-placed step."""
    raise NotImplementedError("build_train_step: the train step on a device mesh is not "
                              "ported yet (ROADMAP A12); use train_step_fn on one device")
