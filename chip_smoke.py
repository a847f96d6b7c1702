#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: kernels, then serving.

    python3 chip_smoke.py

Phases, each fatal on a miss (no CPU fallback, nonzero exit):

1. the card's name and power limit (``nvidia-smi``);
2. build every Hopper kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, in parallel), with each kernel's
   registers, shared memory and spills from ``-Xptxas -v``;
3. each kernel at the main paths' full-width shapes against its plain
   PyTorch version on the same inputs, with its tolerance; times (CUDA events,
   L2 flushed before every launch, median), the bound from the card's data
   sheet and, where one PyTorch call computes the same function, its time
   (W8A8: ``torch._int_mm`` on the K-major weight the kernel reads, and on a
   row-major copy; flash-decode: ``scaled_dot_product_attention`` with
   ``enable_gqa`` on the f32 cache's views, and on K/V expanded to every
   query head; flash-decode's MLA mode: the same call on the concatenated
   latent and rope streams), each relaunch bit-equal to the first;
   flash-decode (both modes, every format) also with a per-lane kv_len
   (`LANE_KV_LENS`: [1, 528], [528, 300]) against the plain version, timed
   at the second (``per_lane_ms``), and an all-equal one bit-equal to the
   scalar; flash-decode's GQA mode also at hymba-1.5b's ring (B 2, KV 5, G
   5, d 64, C 1024; f32, int8_tok, mxint4_blk; timed at the full ring);
   W8A8 also at the SSM paths' shapes, hymba's x_proj (N 132) and dt_proj
   (K 100) on the zero-padded operands deploy holds (exact against the
   unpadded product; the library timed on the same padded operands), and
   hymba's x_proj at the decode step's M 2; flash-decode also at
   olmoe-1b-7b's G 1 (B 2, KV 16, d 128, C 544; f32, int8_tok, mxint4_blk),
   starcoder2-15b's G 12 (B 2, KV 4, d 128, C 544; the same formats) and
   seamless-m4t-medium's G 1 at d 64 (B 2, KV 16): its self-attention (C
   544) and its cross-attention over the 1536 encoder frames (C 1536, timed
   at kv_len = C, as decode reads it); W8A8 also at seamless's encoder and
   cross K/V shapes (M = 2 x 1536 frames) and MXINT4 at its LM head (N
   256256); llava-next-34b's shapes: MXINT4 at a layer's q / o (7168 x
   7168), k / v (7168 -> 1024), gate / up (7168 -> 20480), down (20480 ->
   7168) and its LM head (N 64000), W8A8 at M 6144 (2 x 3072), flash-decode
   at G 7 (B 2, KV 8, d 128) over its C 3104 in f32, int8_tok and
   mxint4_blk and over the 4096 slots its bucketed prefill leaves;
   the routed experts' GEMV (`mxint4_expert_matmul`: persistent blocks
   that stream each distinct expert's MXINT4 bytes once, in 2-D TMA tiles
   of 512 columns, for every row routed to it, K split for one wave) at
   olmoe's decode (A 16 rows) and verify (A 80) shapes and at deepseek-v3's
   MTP head step (A 16 rows of 256 experts, 7168 <-> 2048), its bound from
   the distinct experts' bytes, per launch beside `time_ms`'s floor, each
   row of olmoe's decode launches bit-equal to itself launched alone and
   beside other routings, beside the PyTorch gather + dequantize + bmm and
   the reference's whole-stack dataflow (`kernel_phase_mxint4_expert`); MXINT4
   also at the MTP head step's linears (M 2: proj 14336 -> 7168, MLA, the
   router at N 256, the shared expert, the LM head);
   retention on the model's strided views and the MLA mode, each bound by
   its split-TF32 instruction mix (the f32 CUDA-core bound beside it);
   retention's backward kernel at retnet-1.3b's training shape and at a
   warm-state tail against autograd of the plain version (1e-4 of max) and
   float64, bound by its split-TF32 mix (f32 FMAs beside it)
   (`kernel_phase_retention_bwd`); each with a profiler check that one call
   runs only its own launches (retention and its backward two, the MLA
   mode and rmsnorm_stats one); rmsnorm_stats at the sigma^-1
   shapes the served models normalise (`RMS_SHAPES`), also against float64,
   timed one call per replay and 8 calls on 8 inputs per replay
   (`amortised_ms`), beside
   ``torch.linalg.vector_norm`` as the nearest library reduction, and the
   price of the port's sigma^-1 chain of PyTorch kernels
   (`sigma_chain_price`); and the selective scan (plain PyTorch, not a
   kernel: `scan_phase`), device ms per layer, per prefill and per decode
   step at falcon-mamba-7b's and hymba-1.5b's widths;
4b. training (`train_phase`, before phase 4): retnet-1.3b and
   internlm2-1.8b at every published width (B 2, S 512, bf16 masters, f32
   moments, AdamW), step 0 on the kernel path against the plain path in an
   f32 stream (loss 1e-4, each gradient 1e-2 of its max; the bf16 readings
   recorded, and on retnet beside them the plain path with retention's
   output nudged one f32 ulp, the control for those gaps), every gradient
   bit-equal on a rerun, 4 steps with exact launches (48 retention forward
   and 24 backward a step on retnet) and finite losses, step ms, tokens/s,
   the steps' peak GiB (reset after the comparisons) and the retention
   share of a profiled step; the trained retnet through ``from_config(model=state)``
   and ``generate`` (graph = eager bit for bit); reduced retnet and
   internlm2 on the card against the CPU (S 200, gradients at 1e-4); a bf16
   checkpoint round trip on reduced retnet (the resumed loss bit-equal);
4. the nine main paths at full width, each through
   ``InferenceEngine.generate`` with the launch counters set to 0 just before
   and read just after, 2 prompts of 512 tokens plus 32 greedy tokens (each
   decode step a replay of one captured CUDA graph, its launches counted per
   replay; the capture's seconds logged), and the eager loop
   (``decode_step`` in a Python loop) in turns with it (after a path's
   first cache format, once each), whose tokens,
   lengths and final cache must match the graph's bit for bit:
   retnet-1.3b (24 layers, d_model 2048), qwen3-8b (36 layers, d_model
   4096, vocab 151936) with its f32, int8_tok and mxint4_blk KV caches, and
   ds3_dense, deepseek-v3-671b cut to its 3 leading dense layers (d_model
   7168, 128 MLA heads, kv_lora 512, vocab 129280) with the same three
   latent-cache formats, falcon-mamba-7b (64 Mamba-1 layers, d_model 4096,
   d_inner 8192, state 16, vocab 65024; its cache has no KV, one cell) and
   hymba-1.5b (32 layers, d_model 1600, 25 heads over 5 KV heads of 64 on a
   1024-slot ring beside Mamba, d_inner 3200; f32, int8_tok, mxint4_blk) and
   olmoe-1b-7b (16 layers, d_model 2048, 16 heads over 16 KV heads of 128
   with QK-norm, 64 experts, top 8, moe_d_ff 1024, vocab 50304; the same
   three formats; its B 2 decode dispatch drops, counted by `moe_drops`),
   and starcoder2-15b (40 layers, d_model 6144, LayerNorm, 48 heads over 4
   KV heads of 128, an ungated GeLU MLP of 24576, vocab 49152; the same
   three formats), and seamless-m4t-medium (an encoder-decoder: 12 encoder
   and 12 decoder layers, d_model 1024, 16 / 16 heads of 64, LayerNorm, an
   ungated GeLU MLP of 4096, vocab 256206; ``generate`` with
   ``extras={"src_embeds": ...}``, 1536 frames from the port's frontend
   stub; the same three formats, the cross K/V encoded with the self K/V;
   193 W8A8 launches a prefill, 97 MXINT4 and 24 flash-decode a step), and,
   first, llava-next-34b (60 layers, d_model 7168, 56 heads over 8 KV heads
   of 128, a gated MLP of 20480, vocab 64000; ``generate`` with
   ``extras={"patch_embeds": ...}``, 2880 patches from the stub over the
   head of a 3072-token prompt, so C 3104; the same three formats; 421 W8A8
   launches a prefill, 421 MXINT4 and 60 flash-decode a step; its init
   peak and resident GiB logged), all
   from seeded random weights in the default W8A8/MXINT4 deployment; then the
   same weights on the plain path (``kernel_impl="ref"``): every block in
   lockstep, prefill logits beside the network's own sensitivity, the
   first COMPARE_STEPS (2) decode steps' logits (see `compare_paths`; on
   the SSM paths with the residual stream in f32 as well), and, in a path's
   first format, free-running for FREE_RUN_NEW (4) tokens, where the two paths' greedy
   tokens and appended cache rows first part (recorded, see
   `free_running`); the profiler's busy shares in a path's first format; one top-k and one top-p generate through the graph
   (retnet-1.3b), each token in its step's top k or nucleus, repeated with
   its seed;
5. after phase 4 on each path, the admission paths (`serve_admission`) once
   per cache format of the chunked admission (phases 5, 7 and 8 run
   qwen3-8b, hymba-1.5b and starcoder2-15b in their first format only,
   olmoe-1b-7b in f32 and int8_tok and ds3_dense in all three,
   `phase_formats`; seamless-m4t-medium runs none of
   them: `serve_refusals` holds it to the reference's refusals of bucketed
   and chunked prefill, the scheduler's admission and speculative decode,
   untimed; nor does llava-next-34b, held to the refusals of chunked
   prefill, the scheduler, the prefix cache and speculative decode, its
   bucketed prefill (3072 -> 4096) held to the exact one by
   `bucketed_vs_exact`): 2 prompts of
   116 tokens in chunks of 32 (hymba-1.5b: 1100 in chunks of 256, so its 1024-slot ring
   wraps and its full-attention layers degrade to it, as in the reference;
   3 x 32 + 16 + 4: retention from a warm state at chunks
   32, 16 and 4; W8A8 at M = 64, 32 and 8, and MLA's per-chunk
   re-expansion of the whole latent) against the plain path block by
   block in lockstep (after a path's first cache format, its first 4
   chunks); the counted run (chunked prefill, then
   ``resume_generate`` of 32 greedy tokens through the graph, launches
   exact) and the eager loop from the same cache, bit for bit, and the
   same resume in two halves of 16; monolithic and bucketed prefill's
   launches exact; chunked and bucketed (116 -> 128) against monolithic
   prefill, recorded; the three prefills timed in turns (after the first
   format, once each);
6. after phase 5 on each path, the scheduler (`serve_scheduler`): a
   `RequestScheduler` drain of 6 mixed-length requests through two slot
   classes of 2 lanes (C 48 and 80, chunks of 16; on the dense paths the
   lanes' per-lane kv_len goes through flash-decode), each class step's
   launches per replay exact (169 MXINT4 on retnet), one replay against the
   eager class step mid-drain (tokens and every store tensor bit for bit),
   the drain's decode launches exactly its replays'; on retnet-1.3b then
   the `goodput_under_load` leg of the reference's serving bench through
   the port's `ServingFrontend` (`goodput_leg`: 8 requests, prompts 6-24,
   8 new tokens, 2 lanes, chunks of 8; closed-loop calibration, Poisson
   arrivals at 0.5, 1.5 and 4.0 x its rate, the front end against a
   direct run() token for token) and an oversubscribed host-spill run
   (`host_spill_run`: a spill/fetch round trip bit for bit, a preempted
   request token-identical to an unpreempted drain); goodput, TTFT and
   inter-token p50/p99 (also while a chunk ran), decode-stall steps,
   capture seconds, spill/fetch bytes and ms;
7. after phase 6 on each path, the shared-prefix cache (`serve_prefix`):
   in every cache format, a 32-token base prompt alone and then 3
   extensions of 8, drained cold and then warm through one class of 2 lanes
   (chunks of 16; `prefix_cell`): warm tokens equal cold ones, 3 adoptions
   of the base (page rows, or retnet's snapshot, copied into a private
   cache), every page's bytes after the drain equal to its bytes at
   registration, no lease held, the warm drain's launches exact (its
   chunks' and its replays'), page bytes, lookup / register ms and one
   page's spill and fetch ms recorded; on qwen3-8b then the `prefix_reuse`
   leg of the reference's serving bench (`prefix_reuse_leg`: a 96-token
   system prompt + 8 unique tokens, 4 requests, 8 new tokens, 2 lanes at C
   112, chunks of 16, shared fractions 0, 0.5 and 1.0, and 1.0 cold): at
   1.0, 3 of 4 admissions adopt 96 tokens and the tokens equal the cold
   stream's; hit rate, tokens skipped, chunks, TTFT p50/p99 and the TTFT
   p50 delta warm - cold recorded;
8. after phase 7 on each path, speculative decode (`serve_speculative`, k 4,
   the ngram drafter): in every cache format, `generate` of 2 prompts of
   512 tokens (one seeded, one [5, 9, 13] tiled) and 8 tokens with a cache
   of 524 (`speculative_cell`): each verify step one replay of a captured
   graph with W8A8 inside, its launches exact (W8A8 only: 169 on retnet,
   253 on qwen3-8b, 28 on ds3_dense) and the counted generate's; the graph
   against the eager loop bit for bit (tokens, lengths, verify steps,
   accepted drafts, history, final cache); one verify block against the
   plain path in lockstep at BLOCK_TOL (outputs, verified and committed
   caches, logits at all k + 1 positions), with the ngram drafts and with
   drafts forced to miss (a full rejection); tokens per step, acceptance,
   one replay's device ms, the host read of the loop's condition, ms per
   emitted token against the plain graph loop in turns, capture seconds,
   and where the tokens first part from the plain loop's (verify reads the
   W8A8 weights, decode the MXINT4 ones) with the top-two margin there
   recorded; then the phase-6 drain's requests in speculative mode
   (`spec_scheduler_drain`: classes (2, 52) and (2, 84)): one replay
   against the eager class step and lane isolation (lane 0 bit-identical
   whether lane 1 holds a request or garbage), launches exactly the
   chunks' and the replays', tokens per step and acceptance per request;
9. each model reduced, on the card against the CPU plain path, and the
   serve CLI (``python -m repro_torch.launch.serve``) at full width as
   subprocesses, CLI_WORKERS (8) at a time: on retnet-1.3b greedy and
   top-p generate, the scheduler, the front end on virtual time, the
   oversubscribed host-spill scheduler
   with its trace and metrics, and ``--speculative`` in the single-generate
   and the scheduler mode; on qwen3-8b ``--prefix-cache`` (4 of 5
   admissions adopt the shared prompt); one greedy generate each on
   falcon-mamba-7b, hymba-1.5b and olmoe-1b-7b; the train CLI
   (``python -m repro_torch.launch.train``, reduced retnet-1.3b, 3 steps, a
   simulated failure saved and restored) on its default device, the card;
   reduced deepseek-v3 with its
   MoE layers (3 dense, 2 MoE with the shared expert) and its MTP head
   against the CPU too, reduced seamless-m4t-medium on 8 frames, block by block on the CPU's input, its prefill
   logits end to end and on fp weights (`reduced_vs_cpu`, `cpu_lockstep`),
   and one MTP head step on the CPU's inputs (`mtp_head_vs_cpu`);
   before phase 9, the ds3_mtp cell (`serve_mtp`): the ds3 cut with its MTP
   head (proj, then an MoE block over MLA: 256 experts, top 8, moe_d_ff
   2048, one shared expert) at every published width, speculative
   `generate` with the MTP drafter (k 4, f32 latent cache), each verify
   replay 28 W8A8 and 4 chained head steps of 12 MXINT4 and 3 expert GEMV
   launches, counted; graph = eager bit for bit (the drafter's ``h``
   included); the verify block in lockstep with the plain path; one head
   step against the plain path (hidden DECODE_BLOCK_TOL, logits
   DECODE_TOL, tokens routed differently counted); the head chain captured
   alone and timed beside a verify replay (`mtp_head_checks`);
10. the selective scan's line, one JSON line ``{"kernels": [...]}`` (``scheduler_launches_by_path``,
   ``prefix_launches_by_path`` and ``speculative_launches_by_path`` beside
   ``launches``; W8A8's rows also at the verify step's shapes, M 10, under
   the path "<arch> verify") and, last, the ``{"ok": true, ...}`` line.

It imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core import fused_rmsnorm as fr  # noqa: E402
from repro_torch.core import kvq  # noqa: E402
from repro_torch.core import mxint4 as mx  # noqa: E402
from repro_torch.core import retention as ret  # noqa: E402
from repro_torch.kernels import hopper, ops, ref  # noqa: E402
from repro_torch.models import deploy, frontends, layers, lm  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.modules import Linear  # noqa: E402
from repro_torch.core.hsa import HSAConfig, HSAEngine  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.runtime import train_step as ts  # noqa: E402
from repro_torch.serving import engine as serving_engine  # noqa: E402
from repro_torch.serving.engine import (EngineSpec, GenerationResult,  # noqa: E402
                                        InferenceEngine, bucket_length, chunk_schedule)
from repro_torch.serving.sampling import (GenerationConfig, SamplingParams,  # noqa: E402
                                          _top_p_mask, sample)

# Data-sheet peaks (NVIDIA, dense): bytes/s of device memory, and operations/s
# for int8 and TF32 on the tensor cores and for f32 on the CUDA cores.
PEAKS = {
    "H100 SXM": dict(bytes=3.35e12, int8=1979e12, tf32=495e12, f32=67e12),
    "H100 PCIe": dict(bytes=2.0e12, int8=1513e12, tf32=378e12, f32=51e12),
    "H200": dict(bytes=4.8e12, int8=1979e12, tf32=495e12, f32=67e12),
}
SRC = {
    "mxint4_matmul": ("src/repro_torch/kernels/csrc/mxint4_matmul.cu",
                      "src/repro/kernels/mxint4_matmul.py:77"),
    "w8a8_matmul": ("src/repro_torch/kernels/csrc/w8a8_matmul.cu",
                    "src/repro/kernels/w8a8_matmul.py:52"),
    "retention_chunkwise": ("src/repro_torch/kernels/csrc/retention_chunkwise.cu",
                            "src/repro/kernels/retention_kernel.py:70"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:142"),
    "flash_decode_mla": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:108"),
    "rmsnorm_stats": ("src/repro_torch/kernels/csrc/rmsnorm_stats.cu",
                      "src/repro/kernels/rmsnorm_stats.py:38"),
    # The gradient of the retention kernel, which JAX's autodiff derives
    # from the Pallas kernel's function there.
    "retention_chunkwise_bwd": ("src/repro_torch/kernels/csrc/retention_chunkwise_bwd.cu",
                                "src/repro/kernels/retention_kernel.py:70"),
    # Replaces no Pallas kernel: the reference dequantizes every expert
    # stack and runs an einsum (its local MoE path).
    "mxint4_expert_matmul": ("src/repro_torch/kernels/csrc/mxint4_matmul.cu",
                             "src/repro/models/mlp.py:70"),
}
# The full-width main paths: per layer (K, N, linears of that shape) run in
# both phases (MXINT4 in decode), those whose N is no multiple of 32 and so
# run W8A8 in both phases (hymba's x_proj, N 132: `deploy._mx_ok`), and those
# run in prefill only (MLA's wk_b / wv_b, whose masters decode absorbs);
# ``attn`` names the decode attention (or retention) kernel; ``cfg`` builds
# the model, ``reduced`` its CPU-scale twin; ``admit_prompt`` is the
# admission phase's prompt length (ADMIT_PROMPT when absent);
# ``phase_formats`` the cache formats of its admission, prefix and
# speculative phases (every format of phase 4 when absent; cut to the first
# on qwen3-8b, hymba-1.5b and starcoder2-15b and to f32 and int8_tok on
# olmoe-1b-7b to keep the run inside its time, PERF.md section 4: encoded
# caches stay driven through these phases on a GQA path, olmoe's, and on
# MLA, ds3_dense's).
RETNET = dict(arch="retnet-1.3b", layers=24, d=2048, vocab=32768, formats=(None,),
              linears=((2048, 2048, 2), (2048, 4096, 3), (4096, 2048, 2)),
              decode_w8_linears=(), prefill_linears=(), attn="retention")
QWEN3 = dict(arch="qwen3-8b", layers=36, d=4096, vocab=152064, kv=8, g=4, hd=128,
             formats=(None, "int8_tok", "mxint4_blk"), phase_formats=(None,),
             linears=((4096, 4096, 2), (4096, 1024, 2), (4096, 12288, 2),
                      (12288, 4096, 1)),
             decode_w8_linears=(), prefill_linears=(), attn="gqa")
# ds3_dense is built without deepseek-v3's MTP head (``mtp=False``): none of
# its phases reads the head, which `DS3_MTP` carries.
_DS3 = configs.get_config("deepseek-v3-671b")
DS3 = dict(arch="ds3_dense", layers=3, d=7168, vocab=129280, heads=128, r=512, dr=64,
           formats=(None, "int8_tok", "mxint4_blk"),
           cfg=dataclasses.replace(_DS3, n_layers=_DS3.first_dense_layers, mtp=False),
           reduced=dataclasses.replace(_DS3.reduced(), n_layers=_DS3.first_dense_layers,
                                       mtp=False),
           linears=((7168, 1536, 1), (1536, 24576, 1), (7168, 576, 1), (16384, 7168, 1),
                    (7168, 18432, 2), (18432, 7168, 1)),
           decode_w8_linears=(), prefill_linears=((512, 16384, 2),), attn="mla")
# falcon-mamba-7b: in_proj, x_proj (dt rank 256 + 2 x state 16 = 288),
# dt_proj, out_proj; no attention, no MLP, no RoPE.
FALCON_MAMBA = dict(arch="falcon-mamba-7b", layers=64, d=4096, vocab=65024,
                    d_inner=8192, state=16, formats=(None,),
                    linears=((4096, 16384, 1), (8192, 288, 1), (256, 8192, 1),
                             (8192, 4096, 1)),
                    decode_w8_linears=(), prefill_linears=(), attn=None, f32_witness=True,
                    profile_prefill=False)
# hymba-1.5b: GQA (25 heads over 5 KV heads of 64) over a 1024-slot ring,
# Mamba (d_inner 3200, dt rank 100, state 16: x_proj N 132), a gated MLP of
# 5504; its admission prompt wraps the ring, in chunks of 256 (4 x 256 + 64
# + 8 + 4: a chunk runs host-bound, about 0.3 s at 32 tokens, PERF.md).
HYMBA = dict(arch="hymba-1.5b", layers=32, d=1600, vocab=32256, kv=5, g=5, hd=64,
             window=1024, d_inner=3200, state=16, formats=(None, "int8_tok", "mxint4_blk"),
             phase_formats=(None,),
             linears=((1600, 1600, 2), (1600, 320, 2), (1600, 6400, 1), (100, 3200, 1),
                      (3200, 1600, 1), (1600, 5504, 2), (5504, 1600, 1)),
             decode_w8_linears=((3200, 132, 1),), prefill_linears=(), attn="gqa",
             admit_prompt=1100, admit_chunk=256, f32_witness=True, profile_prefill=False)
# olmoe-1b-7b: GQA with QK-norm (16 heads over 16 KV heads of 128: G 1),
# the router (N 64) and, per MoE layer, the routed experts' wg / wi (2048 ->
# 1024) and wo (1024 -> 2048) through `mxint4_expert_matmul` in decode
# (``experts``: count, top k, d_ff) and a dequantized bmm in prefill.
OLMOE = dict(arch="olmoe-1b-7b", layers=16, d=2048, vocab=50432, kv=16, g=1, hd=128,
             formats=(None, "int8_tok", "mxint4_blk"), phase_formats=(None, "int8_tok"),
             linears=((2048, 2048, 4), (2048, 64, 1)),
             decode_w8_linears=(), prefill_linears=(), attn="gqa",
             experts=dict(e=64, k=8, f=1024), f32_witness=True)
# starcoder2-15b: LayerNorm, GQA (48 heads over 4 KV heads of 128: G 12,
# flash-decode's three G-chunks of 4), an ungated GeLU MLP of 24576, vocab
# 49152.
STARCODER2 = dict(arch="starcoder2-15b", layers=40, d=6144, vocab=49152, kv=4, g=12, hd=128,
                  formats=(None, "int8_tok", "mxint4_blk"), phase_formats=(None,),
                  linears=((6144, 6144, 2), (6144, 512, 2), (6144, 24576, 1),
                           (24576, 6144, 1)),
                  decode_w8_linears=(), prefill_linears=(), attn="gqa")
# seamless-m4t-medium: an encoder-decoder at every published width (12 encoder
# and 12 decoder layers, d_model 1024, 16 / 16 heads of 64: flash-decode at G
# 1, d 64; LayerNorm, an ungated GeLU MLP of 4096, vocab 256206 -> 256256),
# fed ``frames`` 1536 frames (`frontends.synth_frame_embeds`).  ``linears``
# are a decoder layer's (self q, k, v, o and cross q, o; wi, wo), which run
# in both phases; ``frame_linears`` run in prefill only, at M = B x frames:
# an encoder layer's q, k, v, o, wi, wo and a decoder layer's cross k, v
# (counted per layer: `serve_full_width` checks that the encoder has as many
# layers as the decoder).  A decode step reads two caches a layer
# (``fd_per_layer``): its own and the cross cache, at kv_len = 1536.  It has
# no admission, scheduler, prefix or speculative phase (the reference
# refuses them, `serve_refusals`).
SEAMLESS = dict(arch="seamless-m4t-medium", layers=12, d=1024, vocab=256256, kv=16, g=1,
                hd=64, frames=1536, formats=(None, "int8_tok", "mxint4_blk"),
                linears=((1024, 1024, 6), (1024, 4096, 1), (4096, 1024, 1)),
                frame_linears=((1024, 1024, 6), (1024, 4096, 1), (4096, 1024, 1)),
                decode_w8_linears=(), prefill_linears=(), attn="gqa", fd_per_layer=2)
# llava-next-34b: the vision model's backbone at every published width (60
# dense GQA layers, d_model 7168, 56 heads over 8 KV heads of 128: G 7,
# flash-decode's two G-chunks of 4 and 3; a gated MLP of 20480, vocab
# 64000), its ``prompt`` of 3072 tokens headed by ``patches`` 2880 patch
# embeddings from the stub (`frontends.synth_patch_embeds`, seed 2), so C
# 3104; about 49 GiB deployed, drawn and deployed block by block
# (`lm.init`).  Its admission, scheduler, prefix and speculative phases are the
# reference's refusals (`serve_refusals`); its bucketed prefill (3072 -> 4096)
# is held to the exact one (`bucketed_vs_exact`).  It runs first, on a card
# that holds nothing else.
# Its prefill is not profiled (``profile_prefill``: 17.7 s of profiler on a
# 3.1 s prefill, PERF.md section 4), nor are the SSM paths'; the decode
# profiles stay.
LLAVA = dict(arch="llava-next-34b", layers=60, d=7168, vocab=64000, kv=8, g=7, hd=128,
             patches=2880, prompt=3072, formats=(None, "int8_tok", "mxint4_blk"),
             linears=((7168, 7168, 2), (7168, 1024, 2), (7168, 20480, 2), (20480, 7168, 1)),
             decode_w8_linears=(), prefill_linears=(), attn="gqa", profile_prefill=False)
PATHS = (LLAVA, RETNET, QWEN3, DS3, FALCON_MAMBA, HYMBA, OLMOE, STARCODER2, SEAMLESS)
# ds3_mtp: the ds3 cut with its MTP head, at every published width (`serve_mtp`):
# speculative `generate` with the MTP drafter, each verify step (W8A8 over the
# block, as on ds3_dense) chaining SPEC_K head steps inside its graph.  A head
# step (``head``, one layer of its own) runs in the decode format at M = B:
# ``proj`` (14336 -> 7168), MLA's six linears (``wk_b`` / ``wv_b`` through
# MXINT4: the full-sequence block), the router (N 256), the shared expert and
# the LM head, all MXINT4, and the routed experts' GEMV three times (256
# experts, top 8, moe_d_ff 2048: A = B x 8 rows).  Its f32 latent cache only:
# the head reads no cache, so the other formats add nothing.
MTP_HEAD = dict(arch="ds3_mtp head", layers=1, d=7168, vocab=129280,
                linears=((14336, 7168, 1), (7168, 1536, 1), (1536, 24576, 1), (7168, 576, 1),
                         (512, 16384, 2), (16384, 7168, 1), (7168, 256, 1), (7168, 2048, 2),
                         (2048, 7168, 1)),
                experts=dict(e=256, k=8, f=2048), site="MTP head step (k of them a verify step)")
DS3_MTP = dict(DS3, arch="ds3_mtp", formats=(None,), drafter="mtp", head=MTP_HEAD,
               cfg=dataclasses.replace(_DS3, n_layers=_DS3.first_dense_layers))
# deepseek-v3 with its MoE layers: 3 dense then 2 MoE layers with the shared
# expert over MLA, reduced only (its 58 MoE layers of 256 experts do not fit
# one card), in `reduced_vs_cpu`.  It is held stage by stage (``lockstep``:
# each card block on the CPU's input to it, `cpu_lockstep`), and its prefill
# logits from the card's stack to LOGIT_TOL with the CPU's codes fed only
# into the blocks whose output a moved code moved past DECODE_BLOCK_TOL (on
# an H100 block 0 alone, PERF.md), and on fp weights.  With each side's own
# codes they part by 3.9e-2 of max|logit| on an H100 (PERF.md: an int8 code
# moved in block 0, as on ds3_dense, and one token routed to another expert
# downstream), a reading recorded beside them.
DS3_MOE = dict(arch="ds3_moe", formats=(None, "int8_tok", "mxint4_blk"),
               reduced=_DS3.reduced(), lockstep=True)
BATCH, PROMPT, NEW = 2, 512, 32
CACHE_LEN = PROMPT + NEW           # KV slots of a generate: 544
DECODE_KV_LEN = CACHE_LEN - 16     # kv_len at which flash-decode is timed
# and those it is checked at (a device scalar, as the main path passes it;
# at 1 to 17 most splits of the capacity's plan stream nothing)
DECODE_CHECK_LENS = (1, 16, 17, 257, CACHE_LEN - 1, CACHE_LEN)
# Kernel path vs plain path, relative to max|value| (see `compare_paths`).
BLOCK_TOL = 2e-2         # prefill block, same input: an int8 rounding step
DECODE_BLOCK_TOL = 1e-3  # decode block, same input: f32 summation order only
                         # (so too a card block against the CPU on the same
                         # input and int8 codes, `cpu_lockstep`)
PREFILL_TOL = 0.5        # end to end; the plain path's own one-bf16-step
                         # sensitivity measured 0.26 on an H100 (PERF.md)
DECODE_TOL = 0.1         # one decode step end to end from the same cache
# The SSM paths' decode logits end to end are held to DECODE_TOL with the
# residual stream in f32 on both paths and the same int8 codes into hymba's
# W8A8 x_proj (``f32_witness``, `_witness_step`): in bf16 their 64 / 32
# layers turn each block's f32 summation-order gap into rounding flips that
# grow layer by layer (0.11-0.53 of max|logit| on an H100, PERF.md), a
# reading recorded beside the gap after each block.  So is olmoe-1b-7b's:
# in bf16 a rounding flip moves a router's input by a bf16 step, enough to
# change a token's top 8 experts in some layer (0.21 of max|logit| on an
# H100 at the first step, PERF.md); the tokens whose experts differ between
# the paths are counted in each stream.  A decode block with a
# W8A8 linear is held as `_decode_lockstep` says.
LOGIT_TOL = 2e-2         # reduced model, card kernels vs CPU plain path
# Models whose random weights emit ids in the LM head's padding rows
# (hymba-1.5b: 32001 padded to 32256; seamless-m4t-medium: 256206 padded to
# 256256; olmoe-1b-7b: 50304 padded to 50432, id 50384 in its admission
# phase's resumed decode), which the reference samples too.
PADDING_IDS = ("hymba-1.5b", "seamless-m4t-medium", "olmoe-1b-7b")
# rmsnorm_stats where the served models take sigma^-1: (M, D, dtype, site),
# the dtype being the one the site passes (ln1/ln2 see the bf16 residual
# stream, q_norm and the per-head norms an f32 linear output), the other
# dtype beside it, the decode pair, a 16k-token prompt and a ragged M.
RMS_SHAPES = (
    (1024, 4096, torch.bfloat16, "qwen3-8b ln1/ln2, prefill B 2 x S 512"),
    (1024, 4096, torch.float32, "qwen3-8b ln1/ln2 in f32"),
    (1024, 2048, torch.bfloat16, "retnet-1.3b ln1/ln2, prefill"),
    (1024, 2048, torch.float32, "retnet-1.3b ln1/ln2 in f32"),
    (1024, 7168, torch.bfloat16, "ds3_dense ln1/ln2, prefill"),
    (1024, 7168, torch.float32, "ds3_dense ln1/ln2 in f32"),
    (1024, 1536, torch.float32, "ds3_dense q_norm on q_lat, prefill"),
    (1024, 1536, torch.bfloat16, "ds3_dense q_norm in bf16"),
    (32768, 128, torch.float32, "qwen3-8b per-head q norm, prefill"),
    (32768, 128, torch.bfloat16, "qwen3-8b per-head q norm in bf16"),
    (2, 4096, torch.bfloat16, "qwen3-8b ln1/ln2, decode"),
    (16384, 4096, torch.bfloat16, "a 16k-token prompt (2.7x the L2)"),
    (1000, 4096, torch.float32, "ragged M"),
)
# Per-lane kv_len (a scheduler's slot class, its two lanes at different
# positions): flash-decode is checked at each pair and timed at the second.
LANE_KV_LENS = ((1, 528), (528, 300))
# The admission phase: 2 prompts of 116 tokens admitted in chunks of 32 (3 x
# 32 + 16 + 4, so retention runs from a warm state at chunks 32, 16 and 4),
# bucketed to 128, and 32 greedy tokens resumed from the chunked cache (500
# tokens, 15 x 32 + 16 + 4, before a depth cut: PERF.md section 4).
ADMIT_PROMPT, ADMIT_CHUNK = 116, 32
# Depth of the phase-4 checks beside the counted run (cut when the SSM paths
# came, to keep the run inside its time: PERF.md): decode steps compared in
# lockstep per cell (`compare_paths`; NEW before), tokens each path
# generates on its own (`free_running`; NEW before); the graph and the
# eager loop run once beside the counted graph run in every format (a
# depth cut replaced the turns eager, graph, graph, eager of a path's first format and
# eager, graph of the others), and the profiler's busy shares
# (`profile_shares`) in a path's first cache format only.  Later depth cuts
# (PERF.md section 4): COMPARE_STEPS was 4, FREE_RUN_NEW 8, and free-running
# ran in every format, not the first only.
COMPARE_STEPS, FREE_RUN_NEW = 2, 4
# After a path's first cache format (cut when olmoe-1b-7b came, to keep the
# run inside its time: PERF.md), the plain-path comparison does not compare
# the prefill (which is the same function in every format: the cache is
# encoded after it); the admission phase's bucketed and monolithic prefills
# (their launches, times and resumed tokens) run in the first format only.
# Likewise in the admission phase (`serve_admission`): the lockstep with the
# plain path covers every chunk in a path's first cache format and the first
# LATER_LOCKSTEP_CHUNKS in the others, whose three prefills are timed once
# each (bucketed, monolithic, and the counted chunked run) and not in turns.
LATER_LOCKSTEP_CHUNKS = 4
TOP_P = 0.9
# The speculative phase (`serve_speculative`): k 4 drafts per verify step,
# the cache reserving k slots past the budget, the ngram drafter.
SPEC_K = 4
# Tokens of a speculative generate (NEW before the SSM paths came, 16 before
# later: depth cuts to keep the run inside its time, PERF.md), and its KV
# slots: 524.
SPEC_NEW = 8
SPEC_CACHE = PROMPT + SPEC_NEW + SPEC_K
RMS_MAIN = (1024, 4096, torch.bfloat16)
RMS_AMORTISED = 8        # calls on distinct inputs per graph in `amortised_ms`


def log(*args) -> None:
    print(*args, flush=True)


def prompt_len(path: dict) -> int:
    """A path's phase-4 prompt length: PROMPT unless it sets its own."""
    return path.get("prompt", PROMPT)


def frontend_path(path: dict) -> bool:
    """A path whose prompts carry frontend inputs (frames or patches): the
    reference refuses it the admission, scheduler, prefix and speculative
    phases, so it runs `serve_refusals` in their place."""
    return "frames" in path or "patches" in path


def card_peaks(name: str) -> dict:
    if "H200" in name:
        return PEAKS["H200"]
    if "H100" in name:
        return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


_FLUSH: list = []


def _flush_l2() -> None:
    """Write 256 MB, evicting the 50 MB L2."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(64 << 20, dtype=torch.float32, device="cuda"))
    _FLUSH[0].zero_()


def time_ms(fn, iters: int = 15) -> float:
    """Median device time of ``fn`` with a cold L2.

    ``fn`` is captured once in a CUDA graph and replayed between CUDA
    events, so the events time the card's work and not the Python wrapper
    around it (the wrapper's host cost is `call_ms`).  A 256 MB write before
    each replay evicts the 50 MB L2.
    """
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    pairs = []
    for _ in range(iters):
        _flush_l2()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in pairs)
    del graph
    return t[len(t) // 2]


def call_ms(fn, iters: int = 50) -> float:
    """Wall time per call of ``fn`` issued back to back, warm L2: the larger
    of its host cost (Python, checks, allocation, launch) and its device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def amortised_ms(fn, inputs, iters: int = 15) -> float:
    """Median device time per call of ``fn(x)`` over the distinct ``inputs``,
    captured back to back in one CUDA graph and replayed with a cold L2 as
    in `time_ms`, divided by their count: the replay's fixed cost (the floor
    of `time_ms`) is spread over every call."""
    return time_ms(lambda: [fn(x) for x in inputs], iters) / len(inputs)


def device_len(n) -> torch.Tensor:
    """kv_len as the main path passes it: an int32 scalar on the card (a
    ``[B]`` tensor for a tuple, one length per lane, as a slot class's step
    passes it)."""
    return torch.tensor(n, dtype=torch.int32, device="cuda")


def per_lane_checks(name, run, plain, n: int, pairs=LANE_KV_LENS) -> tuple[float, float]:
    """``run(kv_len)`` at each pair of ``pairs`` against ``plain`` under
    flash-decode's tolerance, and at a ``[B]`` kv_len of all ``n`` bit-equal
    to the scalar ``n``.  Returns the largest error and the kernel's time at
    the second pair."""
    err = 0.0
    for lens in pairs:
        nl = device_len(lens)
        err = max(err, _check(f"{name} per-lane kv_len {lens}", run(nl), plain(nl),
                              2e-5, 2e-6))
    if not torch.equal(run(device_len((n,) * BATCH)), run(device_len(n))):
        raise RuntimeError(f"{name}: a per-lane kv_len of equal lengths differs from "
                           "the scalar")
    lanes = device_len(pairs[1])
    return err, time_ms(lambda: run(lanes))


def bound_ms(nbytes: float, ops_: float, op_rate: float, peaks: dict):
    tb, to = nbytes / peaks["bytes"] * 1e3, ops_ / op_rate * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def _gen(seed: int) -> torch.Generator:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    return g


def _check(name, got, want, rtol, atol):
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: kernel vs plain: {m}")
    return err


def _linear_cases(path: dict, m: int, lm_head_m: int, prefill: bool = False):
    """(path, M, K, N, launches per unit) of every linear shape a path runs
    in one phase's format: MXINT4 in decode, W8A8 in prefill (the prefill-only
    and the never-MXINT4 linears with them, and an encoder-decoder's linears
    over its frames at M = B x frames)."""
    shapes = path["linears"] + (path["decode_w8_linears"] + path["prefill_linears"]
                                if prefill else ())
    cases = [(path["arch"], m, k, n, c * path["layers"]) for k, n, c in shapes]
    if prefill:
        cases += [(path["arch"], BATCH * path["frames"], k, n, c * path["layers"])
                  for k, n, c in path.get("frame_linears", ())]
    return cases + [(path["arch"], lm_head_m, path["d"], path["vocab"], 1)]


def kernel_phase_mxint4(peaks):
    """MXINT4 at every main path's decode shapes (M = B), and at an MTP head
    step's (``ds3_mtp head``: its rows carry the head's ``site``, not a
    decode step's)."""
    rows = []
    cases = [c + (path.get("site"),) for path in PATHS + (MTP_HEAD,)
             for c in _linear_cases(path, BATCH, BATCH)]
    for arch, m, k, n, count, site in cases:
        g = _gen(k + n)
        x = torch.randn(m, k, generator=g, device="cuda")
        w = torch.randn(k, n, generator=g, device="cuda") * k ** -0.5
        q = mx.quantize_mxint4(w)
        del w
        os_ = torch.rand(n, generator=g, device="cuda") + 0.5
        rs = torch.rand(m, generator=g, device="cuda") + 0.5
        b = torch.randn(n, generator=g, device="cuda")
        got = ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")
        want = ref.mxint4_matmul_ref(x, q, os_, rs, b)
        err = _check(f"mxint4 {k}x{n}", got, want, 1e-5, 1e-5)
        if not torch.equal(got, ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")):
            raise RuntimeError(f"mxint4 {k}x{n}: two launches differ")
        w_deq = mx.dequantize_mxint4(q, dtype=torch.float32)
        nbytes = 4 * m * k + k * n // 2 + k * n // 32 + 4 * (2 * n + m) + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, peaks["f32"], peaks)
        ms = time_ms(lambda: ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel"))
        rows.append(dict(
            path=arch, shape=[m, k, n], per_step=count, max_abs_err=err, ms=ms,
            call_ms=call_ms(lambda: ops.mxint4_matmul(x, q, os_, rs, b, impl="kernel")),
            plain_ms=time_ms(lambda: ref.mxint4_matmul_ref(x, q, os_, rs, b)),
            library_ms=time_ms(lambda: x @ w_deq), bound_ms=bms, bound_by=by,
            plan=hopper.mxint4_plan(m, n, k), rate=f"{nbytes / ms / 1e6:.1f} GB/s",
            bound_share=bms / ms))
        if site:
            rows[-1].update(main=False, site=site)
        del w_deq
    return rows


def _route(t: int, e: int, k: int, g: torch.Generator) -> torch.Tensor:
    """Expert ids ``[t * k]`` of t tokens that each take k distinct experts
    of e (a router's top k), token-major as the MoE's assigned form lays
    its rows out."""
    return torch.rand(t, e, generator=g, device="cuda").topk(k, dim=-1).indices.reshape(-1)


def _expert_cases(path: dict):
    """(path, tokens, K, N, launches per unit, site) of the routed experts'
    GEMV: olmoe's decode step (B 2 tokens: A = 16 rows; site None, a main
    row) and its speculative verify step (B 2 x k 4 + 1 tokens: A = 80), at
    wg / wi (2048 -> 1024, twice a layer) and wo (1024 -> 2048); a path with
    a ``site`` of its own (an MTP head step's B 2 tokens: A = 16 rows of 256
    experts, 7168 -> 2048 and 2048 -> 7168) at that site alone."""
    f, d, n = path["experts"]["f"], path["d"], path["layers"]
    units = (((path["arch"], BATCH, path["site"]),) if "site" in path else
             ((path["arch"], BATCH, None),
              (f"{path['arch']} verify", BATCH * (SPEC_K + 1), "speculative verify step")))
    return [(name, t, k_, n_, c * n, site) for name, t, site in units
            for k_, n_, c in ((d, f, 2), (f, d, 1))]


def _expert_rows_isolated(name, got, x, packed, exps, ids, e: int) -> None:
    """Each row of ``got`` (one expert GEMV launch) bit-equal to that row
    launched alone, and to that row in a launch whose other rows all move
    to other experts: a row's bits must not depend on the rest of the
    launch (the scheduler's lane-isolation gates rest on it)."""
    a = ids.numel()
    for i in range(a):
        alone = ops.mxint4_expert_matmul(x[i:i + 1], packed, exps, ids[i:i + 1],
                                         impl="kernel")
        moved = (ids + 1 + torch.arange(a, device="cuda") % (e - 1)) % e
        moved[i] = ids[i]
        others = ops.mxint4_expert_matmul(x, packed, exps, moved, impl="kernel")
        if not (torch.equal(got[i], alone[0]) and torch.equal(got[i], others[i])):
            raise RuntimeError(f"{name}: row {i} depends on the other rows of its launch")


def kernel_phase_mxint4_expert(peaks):
    """`mxint4_expert_matmul` at the MoE paths' decode and verify shapes
    against its plain version, on experts chosen as a router chooses them.
    The bound counts the distinct experts' MXINT4 bytes (the rows' ids are
    this run's data); ``library_ms`` is the PyTorch composition the plain
    version is (gather the experts, dequantize, bmm) and ``whole_stack_ms``
    the reference's own dataflow (every stack dequantized to f32, then the
    rows' products).  ``per_launch_us`` is ``ms`` in microseconds beside
    ``floor_us``, `time_ms` of a 1-element fill (the replay's fixed cost,
    inside every ``ms``).  At olmoe's decode shapes every row is also held
    bit-equal to itself launched alone and beside other routings
    (`_expert_rows_isolated`)."""
    one = torch.zeros(1, device="cuda")
    floor_us = time_ms(lambda: one.fill_(1.0)) * 1e3
    rows = []
    for path in [p for p in PATHS if "experts" in p] + [MTP_HEAD]:
        e, top = path["experts"]["e"], path["experts"]["k"]
        for arch, t, k, n, count, site in _expert_cases(path):
            g = _gen(t + k + n)
            packed, exps = deploy.quantize_stacked(
                torch.randn(e, k, n, generator=g, device="cuda") * k ** -0.5)
            a = t * top
            x = torch.randn(a, k, generator=g, device="cuda")
            ids = _route(t, e, top, g)
            run = lambda: ops.mxint4_expert_matmul(x, packed, exps, ids,  # noqa: E731
                                                   impl="kernel")
            got = run()
            want = ref.mxint4_expert_matmul_ref(x, packed, exps, ids)
            err = _check(f"mxint4_expert {a}x{k}x{n}", got, want, 1e-5, 1e-5)
            if not torch.equal(got, run()):
                raise RuntimeError(f"mxint4_expert {a}x{k}x{n}: two launches differ")
            if path is not MTP_HEAD and t == BATCH:
                _expert_rows_isolated(f"mxint4_expert {a}x{k}x{n}", got, x, packed, exps,
                                      ids, e)
            distinct = int(ids.unique().numel())
            nbytes = (distinct * (k * n // 2 + k * n // 32) + 4 * a * k + 8 * a
                      + 4 * a * n)
            bms, by = bound_ms(nbytes, 2 * a * k * n, peaks["f32"], peaks)
            ms = time_ms(run)

            def whole_stack():
                w = mx.dequantize_stacked(packed, exps)
                return torch.bmm(x[:, None], w.index_select(0, ids))[:, 0]

            rows.append(dict(
                path=arch, shape=[a, k, n], experts=e, distinct_experts=distinct,
                per_step=count, max_abs_err=err, ms=ms, per_launch_us=ms * 1e3,
                floor_us=floor_us, call_ms=call_ms(run),
                plain_ms=time_ms(lambda: ref.mxint4_expert_matmul_ref(x, packed, exps, ids)),
                library_ms=time_ms(lambda: torch.bmm(x[:, None], mx.dequantize_stacked(
                    packed.index_select(0, ids), exps.index_select(0, ids)))[:, 0]),
                whole_stack_ms=time_ms(whole_stack), bound_ms=bms, bound_by=by,
                rate=f"{nbytes / ms / 1e6:.1f} GB/s", bound_share=bms / ms))
            if site:
                rows[-1].update(main=False, site=site)
            del packed, exps
    return rows


def _verify_cases(path: dict):
    """(path, M, K, N, launches per verify step) of the speculative verify
    step (`serve_speculative`: B 2, k 4), under the path name "<arch>
    verify": every linear and the lm_head at M = 2 x 5 rows, and MLA's
    re-expansion of the whole latent at M = 2 x SPEC_CACHE rows."""
    m, name = BATCH * (SPEC_K + 1), f"{path['arch']} verify"
    cases = [(name,) + c[1:] for c in _linear_cases(path, m, m)]
    return cases + [(name, BATCH * SPEC_CACHE, k, n, c * path["layers"])
                    for k, n, c in path["prefill_linears"]] + [
        (name, m, k, n, c * path["layers"]) for k, n, c in path["decode_w8_linears"]]


def _decode_w8_cases(path: dict):
    """(path, M, K, N, launches per decode step) of the linears that run
    W8A8 in decode too (N no multiple of 32), under "<arch> decode"."""
    return [(f"{path['arch']} decode", BATCH, k, n, c * path["layers"])
            for k, n, c in path["decode_w8_linears"]]


def kernel_phase_w8a8(peaks):
    rows = []
    cases = [c + (True,) for path in PATHS
             for c in _linear_cases(path, BATCH * prompt_len(path), BATCH, True)]
    cases += [c + (False,) for path in PATHS if not frontend_path(path)
              for c in _verify_cases(path) + _decode_w8_cases(path)]
    for arch, m, k, n, count, main in cases:
        g = _gen(m + k + n)
        xq = torch.randint(-127, 128, (m, k), generator=g, device="cuda").to(torch.int8)
        # K-major, as deploy stores the main path's weights (K or N not a
        # multiple of 16: zero-padded to multiples of 16, and so is the bias;
        # the kernel reads them whole on zero-padded activations).
        wq = deploy.k_major(torch.randint(-127, 128, (k, n), generator=g,
                                          device="cuda").to(torch.int8))
        sc = torch.tensor(1e-4, device="cuda")
        rs = torch.rand(m, generator=g, device="cuda") + 0.5
        b = deploy.padded_vector(torch.randn(n, generator=g, device="cuda"))
        got = ops.w8a8_matmul(xq, wq, sc, rs, b, n=n, impl="kernel")
        want = ref.w8a8_matmul_ref(xq, wq[:k, :n], sc, rs, b[:n])
        err = _check(f"w8a8 {m}x{k}x{n}", got, want, 0.0, 0.0)   # exact
        if not torch.equal(got, ops.w8a8_matmul(xq, wq, sc, rs, b, n=n, impl="kernel")):
            raise RuntimeError(f"w8a8 {m}x{k}x{n}: two launches differ")
        # torch._int_mm needs M > 16: the M = 2 lm_head is timed padded to 32
        # rows, a verify step's M = 10 at the smallest M it takes, 17 (noted
        # as library_rows).  library_ms takes the K-major weight (cuBLASLt's
        # int8 "TN" layout, the one the kernel reads); library_rowmajor_ms
        # the row-major copy earlier runs timed.
        # A ragged K or N times the library on the padded operands the
        # kernel reads (``library_padded``).
        xp, wp = ops.w8a8_padded_x(xq, wq, n), wq
        xl = xp if m > 16 else F.pad(xp, (0, 0, 0, (32 if main else 17) - m))
        nbytes = m * k + k * n + 4 * (2 * n + m) + 4 * m * n
        bms, by = bound_ms(nbytes, 2 * m * k * n, peaks["int8"], peaks)
        ms = time_ms(lambda: ops.w8a8_matmul(xq, wq, sc, rs, b, n=n, impl="kernel"))
        lib = _library_ms(lambda: torch._int_mm(xl, wp))
        w_row = wp.contiguous()
        lib_row = _library_ms(lambda: torch._int_mm(xl, w_row))
        del w_row
        rows.append(dict(
            path=arch, shape=[m, k, n], per_prefill=count, max_abs_err=err, ms=ms,
            call_ms=call_ms(lambda: ops.w8a8_matmul(xq, wq, sc, rs, b, n=n, impl="kernel")),
            plain_ms=time_ms(lambda: ref.w8a8_matmul_ref(xq, wq[:k, :n], sc, rs, b[:n])),
            library_ms=lib, library_rowmajor_ms=lib_row, library_rows=xl.shape[0],
            bound_ms=bms, bound_by=by, plan=hopper.w8a8_plan(m, n),
            rate=f"{2 * m * k * n / ms / 1e9:.1f} TOP/s, {nbytes / ms / 1e6:.1f} GB/s",
            library_rate=(f"{2 * xl.shape[0] * k * n / lib / 1e9:.1f} TOP/s"
                          if lib is not None else None),
            bound_share=bms / ms))
        if wq.shape != (k, n):
            rows[-1].update(library_padded=list(wq.shape))
        if not main:
            rows[-1].update(main=False, site="decode step (x_proj, N 132)"
                            if arch.endswith(" decode") else "speculative verify step")
    return rows


def _library_ms(fn) -> float | None:
    """`time_ms` of a library call, or None where the library refuses the
    shape (cuBLASLt's int8 GEMM takes some layouts at some M only)."""
    try:
        return time_ms(fn)
    except RuntimeError as e:
        log(f"  library call refused: {str(e).splitlines()[0][:160]}")
        return None


def _launch_kernels(fn) -> list:
    """Names of the CUDA kernels (and copies) one call of ``fn`` runs on the
    card, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def _retention_f64(q, k, v, gamma):
    """y and the final state from a zero state in float64, by the parallel
    form over the whole sequence: the yardstick both f32 versions are held
    to (``f64_max_abs_err``)."""
    qd, kd, vd = (t.double() for t in (q, k, v))
    n = torch.arange(q.shape[2], dtype=torch.float64, device=q.device)
    lg = torch.log(gamma.double())[:, None, None]
    diff = n[:, None] - n[None, :]
    d = torch.where(diff >= 0, torch.exp(diff.clamp(min=0) * lg), 0.0)
    y = torch.einsum("bhnm,bhmv->bhnv", torch.einsum("bhnd,bhmd->bhnm", qd, kd) * d, vd)
    w = torch.exp((n[-1] - n)[None, :] * lg[:, :, 0])                 # [H, S]
    state = torch.einsum("bhnd,bhnv->bhdv", kd * w[None, :, :, None], vd)
    return y, state


def kernel_phase_retention(peaks):
    """retnet-1.3b prefill retention: B 2, H 8, S 512, dk 256, dv 512, c 128,
    on q, k and v as the model hands them over (transposes of ``[B, S, H,
    d]`` tensors; contiguous inputs are left to tests/test_torch_cuda.py).

    Checked from a zero and a warm state, relaunched bit-equal, and
    profiled: one wrapper call must run the kernel's two launches and no
    copy or elementwise kernel.  ``flops`` is the work the function needs
    from a zero state: Q K^T and P V over the pairs i >= j of a chunk, Q S
    for the chunks after the first, K^T V for every chunk.  ``bound_ms``
    prices it as the kernel's instruction mix, three TF32 tensor-core
    products per multiply-add; ``bound_f32_ms`` as f32 FMAs on the CUDA
    cores (the bound the kernel was first held to).  Both versions' errors
    against a float64 evaluation are printed beside the check, and the
    plain version's time on contiguous inputs (``plain_contiguous_ms``) beside
    its time on the views.  No single PyTorch call computes chunkwise
    retention."""
    h = 8
    dk, dv, c = RETNET["d"] // h, 2 * RETNET["d"] // h, 128
    g = _gen(7)
    gamma = ret.head_decays(h, device="cuda")
    bh, n_chunks = BATCH * h, PROMPT // c
    pairs = c * (c + 1) // 2
    flops = bh * (n_chunks * (2 * pairs * (dk + dv) + 2 * c * dk * dv)
                  + (n_chunks - 1) * 2 * c * dk * dv)
    nbytes = 4 * bh * PROMPT * (2 * dk + 2 * dv) + 4 * bh * dk * dv + 4 * h
    bms, by = bound_ms(nbytes, 3 * flops, peaks["tf32"], peaks)
    bf32, by32 = bound_ms(nbytes, flops, peaks["f32"], peaks)
    q, k = ((torch.randn(BATCH, PROMPT, h, dk, generator=g, device="cuda") * dk ** -0.5)
            .transpose(1, 2) for _ in range(2))
    v = torch.randn(BATCH, PROMPT, h, dv, generator=g, device="cuda").transpose(1, 2)
    run = lambda st=None: ops.retention_chunkwise(  # noqa: E731
        q, k, v, gamma, chunk=c, state=st, impl="kernel")
    errs = []
    for st in (None, torch.randn(BATCH, h, dk, dv, generator=g, device="cuda") * 0.1):
        y, s = run(st)
        y_r, s_r = ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c, state=st)
        errs.append(max(_check("retention y", y, y_r, 1e-4, 1e-4),
                        _check("retention state", s, s_r, 1e-4, 1e-4)))
        for _ in range(2):
            y2, s2 = run(st)
            if not (torch.equal(y, y2) and torch.equal(s, s2)):
                raise RuntimeError("retention: two launches differ")
    y64, s64 = _retention_f64(q, k, v, gamma)
    y_r, s_r = ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c)
    y, s = run()
    f64_err = {name: max((a.double() - y64).abs().max().item(),
                         (b.double() - s64).abs().max().item())
               for name, (a, b) in (("kernel", (y, s)), ("plain", (y_r, s_r)))}
    del y64, s64
    launched = _launch_kernels(run)
    if not launched:
        raise RuntimeError("retention: the profiler saw no device kernel")
    if len(launched) != 2 or not all("retention_pass" in n for n in launched):
        raise RuntimeError(f"retention: one call ran {launched}, "
                           "expected the kernel's two launches only")
    ms = time_ms(run)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    row = dict(
        path=RETNET["arch"], layout="model transpose(1, 2) views",
        shape=[BATCH, h, PROMPT, dk, dv, c], per_prefill=RETNET["layers"],
        max_abs_err=errs[0], warm_state_max_abs_err=errs[1], f64_max_abs_err=f64_err,
        ms=ms, call_ms=call_ms(run),
        plain_ms=time_ms(lambda: ref.retention_chunkwise_ref(q, k, v, gamma, chunk=c)),
        plain_contiguous_ms=time_ms(
            lambda: ref.retention_chunkwise_ref(qc, kc, vc, gamma, chunk=c)),
        library_ms=None, bound_ms=bms, bound_by=by, bound_f32_ms=bf32, bound_f32_by=by32,
        flops=flops, plan=hopper.retention_plan(bh, PROMPT, dk, dv, c),
        launch_kernels=launched, rate=f"{flops / ms / 1e9:.1f} TFLOP/s (needed work)",
        bound_share=bms / ms, bound_share_f32=bf32 / ms)
    return [row]


def events_ms(fn, iters: int = 5) -> float:
    """Median time of ``fn`` between CUDA events, eagerly (no graph: the
    plain backward runs autograd, host gaps included), L2 flushed first."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _flush_l2()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    t = sorted(s.elapsed_time(e) for s, e in pairs)
    return t[len(t) // 2]


def _retention_bwd_f64(q, k, v, gamma, state, dy, dstate):
    """dq, dk, dv (and dstate0) in float64: autograd of the parallel form
    over the whole sequence, plus the initial state's decayed term and the
    final state (the yardstick both f32 versions are held to)."""
    with torch.enable_grad():
        ins = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
        st = None if state is None else state.detach().double().requires_grad_(True)
        qd, kd, vd = ins
        n = torch.arange(q.shape[2], dtype=torch.float64, device=q.device)
        lg = torch.log(gamma.double())[:, None, None]
        diff = n[:, None] - n[None, :]
        d = torch.where(diff >= 0, torch.exp(diff.clamp(min=0) * lg), 0.0)
        y = torch.einsum("bhnm,bhmv->bhnv", torch.einsum("bhnd,bhmd->bhnm", qd, kd) * d, vd)
        outs, cots = [y], [dy.double()]
        if st is not None:
            y = y + torch.einsum("bhnd,bhdv->bhnv", qd * torch.exp((n + 1)[None, :, None]
                                                                   * lg), st)
            outs = [y]
        if dstate is not None:
            w = torch.exp((n[-1] - n)[None, :] * lg[:, :, 0])
            fin = torch.einsum("bhnd,bhnv->bhdv", kd * w[None, :, :, None], vd)
            if st is not None:
                fin = fin + torch.exp(q.shape[2] * lg[None]) * st
            outs.append(fin)
            cots.append(dstate.double())
        grads = torch.autograd.grad(outs, ins + ([st] if st is not None else []), cots)
    return (*grads[:3], grads[3] if st is not None else None)


# (label, B, H, S, dk, dv, chunk, warm, final-state cotangent, calls a train
# step, on the main path): retnet-1.3b's training shape (zero state, no
# cotangent of the final state: 24 calls a step), and the warm-state tail of
# a 200-token sequence (72 rows from the carried state, its state's
# cotangent asked for), which the S 512 path does not run.
RET_BWD_SHAPES = (("train, zero state", 2, 8, 512, 256, 512, 128, False, False, 24, True),
                  ("warm-state tail", 2, 8, 72, 256, 512, 72, True, False, 0, False))


def kernel_phase_retention_bwd(peaks):
    """The retention backward kernel at retnet-1.3b's training shapes
    (`RET_BWD_SHAPES`), on the model's strided views: dq, dk, dv (and the
    initial state's cotangent) against autograd of the plain version at
    1e-4 of max|plain| and against float64, relaunched bit-equal, profiled
    (one call runs the kernel's two launches and nothing else), timed
    with the L2 flushed.  ``bound_ms`` prices the work this call needs
    (`hopper.retention_bwd_flops`) as the kernel's instruction mix, three
    TF32 tensor-core products per multiply-add, against the bytes of q, k,
    v, dY in and dq, dk, dv out (and the states); ``bound_f32_ms`` as f32
    FMAs on the CUDA cores (the bound the first design was held to).  The
    plain version is timed eagerly between CUDA events (it is autograd).
    No PyTorch call computes retention's gradient."""
    rows = []
    for label, b, h, s, dk, dv, c, warm, final, per_step, main in RET_BWD_SHAPES:
        g = _gen(11 + s)
        gamma = ret.head_decays(h, device="cuda")
        q, k = ((torch.randn(b, s, h, dk, generator=g, device="cuda") * dk ** -0.5)
                .transpose(1, 2) for _ in range(2))
        v = torch.randn(b, s, h, dv, generator=g, device="cuda").transpose(1, 2)
        dy = torch.randn(b, s, h, dv, generator=g, device="cuda").transpose(1, 2)
        st = torch.randn(b, h, dk, dv, generator=g, device="cuda") * 0.1 if warm else None
        ds = torch.randn(b, h, dk, dv, generator=g, device="cuda") * 0.1 if final else None
        run = lambda: hopper.retention_chunkwise_bwd(  # noqa: E731
            q, k, v, gamma, st, dy, ds, c, need_dstate=warm)
        got = run()
        want = ref.retention_chunkwise_bwd_ref(q, k, v, gamma, st, dy, ds, c)
        f64 = _retention_bwd_f64(q, k, v, gamma, st, dy, ds)
        err, rel, f64_err = 0.0, 0.0, {"kernel": 0.0, "plain": 0.0}
        for name, a, w, x in zip(("dq", "dk", "dv", "dstate"), got, want, f64):
            if w is None:
                continue
            e = (a - w).abs().max().item()
            r = e / w.abs().max().item()
            if r > 1e-4:
                raise RuntimeError(f"retention backward {label} {name}: {r:.3e} of max|plain|")
            err, rel = max(err, e), max(rel, r)
            f64_err["kernel"] = max(f64_err["kernel"], (a.double() - x).abs().max().item())
            f64_err["plain"] = max(f64_err["plain"], (w.double() - x).abs().max().item())
        del f64
        for _ in range(2):
            again = run()
            if not all(a is None or torch.equal(a, x) for a, x in zip(got, again)):
                raise RuntimeError(f"retention backward {label}: two launches differ")
        launched = _launch_kernels(run)
        if len(launched) != 2 or not all("retention_bwd_" in n for n in launched):
            raise RuntimeError(f"retention backward: one call ran {launched}, expected the "
                               "kernel's two launches only")
        flops = hopper.retention_bwd_flops(b, h, s, dk, dv, c, warm, final, warm)
        nbytes = 4 * b * h * s * (2 * dk + 2 * dv + 2 * dk + dv) \
            + 4 * b * h * dk * dv * (2 * int(warm) + int(final)) + 4 * h
        bms, by = bound_ms(nbytes, 3 * flops, peaks["tf32"], peaks)
        bf32, by32 = bound_ms(nbytes, flops, peaks["f32"], peaks)
        ms = time_ms(run)
        rows.append(dict(
            path=RETNET["arch"] + " train", site=label, layout="model transpose(1, 2) views",
            shape=[b, h, s, dk, dv, c], warm=warm, final_cotangent=final, per_step=per_step,
            main=main, max_abs_err=err, rel_err=rel, f64_max_abs_err=f64_err, ms=ms,
            call_ms=call_ms(run), plain_ms=events_ms(lambda: ref.retention_chunkwise_bwd_ref(
                q, k, v, gamma, st, dy, ds, c)), plain_timing="CUDA events, eager autograd",
            library_ms=None, bound_ms=bms, bound_by=by, bound_f32_ms=bf32, bound_f32_by=by32,
            flops=flops, bytes=nbytes, plan=hopper.retention_bwd_plan(b * h, s, dk, dv, c),
            launch_kernels=launched, rate=f"{flops / ms / 1e9:.2f} TFLOP/s (needed work)",
            bound_share=bms / ms, bound_share_f32=bf32 / ms))
    return rows


def _cache_leaf(x: torch.Tensor, fmt: str):
    """A cache leaf in one of the kernel's formats (legacy int8: q / 32)."""
    if fmt in kvq.FORMATS:
        return kvq.encode(x, fmt)
    return layers.to_cache_dtype(x, {"f32": torch.float32, "bf16": torch.bfloat16,
                                     "int8": torch.int8}[fmt])


def sdpa_backend(fn) -> str:
    """The backend one `scaled_dot_product_attention` call took, read from
    the CUDA kernels it ran (torch.profiler), with their names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not names:
        return "not measured"
    text = " ".join(names).lower()
    kind = next((k for k, marks in (("flash", ("flash",)), ("cudnn", ("cudnn",)),
                                    ("efficient", ("fmha", "efficient", "cutlassf")))
                 if any(m in text for m in marks)), "math")
    return f"{kind}: " + "; ".join(n[:48] for n in names[:4])


# Flash-decode's GQA shapes: qwen3-8b (B 2, KV 8, G 4, d 128, C 544; every
# cache format, timed at kv_len 528), hymba-1.5b over its ring (B 2, KV 5,
# G 5: two group chunks, the second holding one head; d 64; C 1024, timed at
# 1024: the ring full, as it is from the wrap on), olmoe-1b-7b (B 2, KV
# 16, G 1: three of the four group rows of a block idle; d 128, C 544),
# starcoder2-15b (B 2, KV 4, G 12: three group chunks; d 128, C 544) and
# seamless-m4t-medium (B 2, KV 16, G 1, d 64): its self-attention (C 544)
# and its cross-attention (``site``), which reads the whole 1536-frame cache
# every step (kv_len = C), and llava-next-34b (B 2, KV 8, G 7: two group
# chunks, the second of three heads; d 128) at its C 3104, checked at
# DECODE_CHECK_LENS scaled to it and timed at C - 16, and at the capacity its
# bucketed prefill leaves (4096: ``main`` False, a site of its own, f32 as
# `bucketed_vs_exact` resumes it).
LLAVA_C = prompt_len(LLAVA) + NEW
LLAVA_LENS = (1, 16, 17, LLAVA_C // 2 + 1, LLAVA_C - 1, LLAVA_C)
FD_SHAPES = (
    dict(path=QWEN3, c=CACHE_LEN, kv_len=DECODE_KV_LEN, check=DECODE_CHECK_LENS,
         lanes=LANE_KV_LENS, formats=("f32", "bf16", "int8", "int8_tok", "mxint4_blk")),
    dict(path=HYMBA, c=HYMBA["window"], kv_len=HYMBA["window"],
         check=(1, 16, 17, 513, 1023, 1024), lanes=((1, 1024), (1024, 300)),
         formats=("f32", "int8_tok", "mxint4_blk")),
    dict(path=OLMOE, c=CACHE_LEN, kv_len=DECODE_KV_LEN, check=DECODE_CHECK_LENS,
         lanes=LANE_KV_LENS, formats=("f32", "int8_tok", "mxint4_blk")),
    dict(path=STARCODER2, c=CACHE_LEN, kv_len=DECODE_KV_LEN, check=DECODE_CHECK_LENS,
         lanes=LANE_KV_LENS, formats=("f32", "int8_tok", "mxint4_blk")),
    dict(path=SEAMLESS, c=CACHE_LEN, kv_len=DECODE_KV_LEN, check=DECODE_CHECK_LENS,
         lanes=LANE_KV_LENS, formats=("f32", "int8_tok", "mxint4_blk"), site="self"),
    dict(path=SEAMLESS, c=SEAMLESS["frames"], kv_len=SEAMLESS["frames"],
         check=(1, 17, 769, 1535, 1536), lanes=((1, 1536), (1536, 700)),
         formats=("f32", "int8_tok", "mxint4_blk"), site="cross"),
    dict(path=LLAVA, c=LLAVA_C, kv_len=LLAVA_C - 16, check=LLAVA_LENS,
         lanes=((1, LLAVA_C - 16), (LLAVA_C - 16, 1700)),
         formats=("f32", "int8_tok", "mxint4_blk")),
    dict(path=LLAVA, c=bucket_length(LLAVA_C), kv_len=LLAVA_C - 16,
         check=(1, 17, 2049, 3073, 4095, 4096), lanes=((1, LLAVA_C - 16), (LLAVA_C - 16, 1700)),
         formats=("f32",), site="bucketed", main=False),
)


def kernel_phase_flash_decode(peaks):
    """Decode attention at each of `FD_SHAPES`, B = 2, in each cache format,
    kv_len an int32 scalar on the card.  Checked at the shape's lengths,
    timed at its ``kv_len``; the f32 cache (the default ``cache_format=None``)
    is each path's main-path unit.  Its library yardsticks are
    `scaled_dot_product_attention` on the f32 K/V: ``library_gqa_ms`` with
    ``enable_gqa=True`` on the un-expanded ``[B, KV, n, d]`` views, and
    ``library_ms`` on K/V copied and expanded to every query head (G x the
    bytes).  No single PyTorch call reads an encoded cache."""
    rows = []
    for shape in FD_SHAPES:
        path = shape["path"]
        b, kvh, g, d, c, n = BATCH, path["kv"], path["g"], path["hd"], shape["c"], shape["kv_len"]
        gen = _gen(11)
        q = torch.randn(b, kvh, g, d, generator=gen, device="cuda")
        k32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
        v32 = torch.randn(b, c, kvh, d, generator=gen, device="cuda")
        for fmt in shape["formats"]:
            rows.append(_flash_decode_row(peaks, path, shape, fmt, q, k32, v32, b, kvh, g, d,
                                          c, n))
    return rows


def _flash_decode_row(peaks, path, shape, fmt, q, k32, v32, b, kvh, g, d, c, n):
    k, v = _cache_leaf(k32, fmt), _cache_leaf(v32, fmt)
    err = 0.0
    for kv_len in map(device_len, shape["check"]):
        got = ops.flash_decode(q, k, v, kv_len, impl="kernel")
        want = ref.flash_decode_ref(q, k, v, kv_len)
        err = max(err, _check(f"flash_decode {path['arch']} {fmt} kv_len {int(kv_len)}",
                              got, want, 2e-5, 2e-6))
        if not torch.equal(got, ops.flash_decode(q, k, v, kv_len, impl="kernel")):
            raise RuntimeError(f"flash_decode {fmt}: two launches differ")
    nd = device_len(n)
    lane_err, lane_ms = per_lane_checks(
        f"flash_decode {path['arch']} {fmt}",
        lambda n_: ops.flash_decode(q, k, v, n_, impl="kernel"),
        lambda n_: ref.flash_decode_ref(q, k, v, n_), n, shape["lanes"])
    row_bytes = {"f32": 4 * d, "bf16": 2 * d, "int8": d}.get(fmt) or kvq.nbytes_per_row(fmt, d)
    nbytes = 2 * 4 * b * kvh * g * d + 2 * n * b * kvh * row_bytes
    bms, by = bound_ms(nbytes, 4 * b * kvh * g * n * d, peaks["f32"], peaks)
    extra = {}
    if fmt == "f32":
        qs = q.reshape(b, kvh * g, 1, d)
        kg, vg = (t[:, :n].permute(0, 2, 1, 3) for t in (k32, v32))
        gqa = lambda: F.scaled_dot_product_attention(qs, kg, vg, enable_gqa=True)  # noqa: E731
        lib_err = (gqa().reshape(b, kvh, g, d) - ref.flash_decode_ref(q, k, v, nd)
                   ).abs().max().item()
        ks, vs = (t.repeat_interleave(g, dim=1).contiguous() for t in (kg, vg))
        extra = dict(library_ms=time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs)),
                     library_gqa_ms=time_ms(gqa), library_backend=sdpa_backend(gqa),
                     library_max_abs_err=lib_err)
        del ks, vs
    name = {"f32": path["arch"], "bf16": "bf16 (no model path)",
            "int8": "legacy int8 (no model path)"}.get(fmt, f"{path['arch']} {fmt}")
    main = fmt == "f32" and shape.get("main", True)
    if fmt == "f32" and not main:
        name = f"{name} {shape['site']}"
    ms = time_ms(lambda: ops.flash_decode(q, k, v, nd, impl="kernel"))
    row = dict(
        path=name, main=main, fmt=fmt, shape=[b, kvh, g, d, c], kv_len=n,
        per_step=path["layers"], max_abs_err=max(err, lane_err), ms=ms,
        per_lane_ms=lane_ms, per_lane_kv_len=list(shape["lanes"][1]),
        per_lane_max_abs_err=lane_err,
        call_ms=call_ms(lambda: ops.flash_decode(q, k, v, nd, impl="kernel")),
        **({"attention": shape["site"]} if "site" in shape else {}),
        plain_ms=time_ms(lambda: ref.flash_decode_ref(q, k, v, nd)),
        library_ms=None, library_gqa_ms=None, bound_ms=bms, bound_by=by,
        plan={key: val for key, val in hopper.flash_decode_plan(
            b, kvh, g, d, d, c, fmt, fmt).items() if key != "ranges"},
        rate=f"{nbytes / ms / 1e6:.1f} GB/s", bound_share=bms / ms)
    row.update(extra)
    return row


def scan_phase() -> list:
    """The selective scan (`models/ssm.py`: plain PyTorch, no kernel) at the
    SSM paths' full widths, device ms with a cold L2 (`time_ms`): one
    layer's chunked scan of a B x S prefill (`ssm.selective_scan`, chunks of
    128) and one layer's decode step (`ssm.ssm_step`), and each times the
    layers per prefill and per decode step; and on hymba the ring-row save
    of a speculative verify step (k + 1 rows of K and V per layer, in each
    cache format)."""
    rows = []
    for path in (FALCON_MAMBA, HYMBA):
        di, n = path["d_inner"], path["state"]
        g = _gen(di)
        dt = F.softplus(torch.randn(PROMPT, BATCH, di, generator=g, device="cuda") - 3)
        xc, bc, cc = (torch.randn(PROMPT, BATCH, w, generator=g, device="cuda")
                      for w in (di, n, n))
        a = -torch.exp(torch.zeros(di, n, device="cuda"))
        h0 = torch.zeros(BATCH, di, n, device="cuda")
        pre = time_ms(lambda: ssm.selective_scan(h0, dt, xc, bc, cc, a, 128))
        step = time_ms(lambda: ssm.ssm_step(h0, dt[0], xc[0], bc[0], cc[0], a))
        rows.append(dict(path=path["arch"], shape=[BATCH, PROMPT, di, n], chunk=128,
                         prefill_layer_ms=pre, prefill_ms=pre * path["layers"],
                         decode_layer_ms=step, decode_step_ms=step * path["layers"],
                         layers=path["layers"]))
        if path is HYMBA:
            # A verify block's save of the k + 1 ring rows it evicts
            # (`layers.gqa_chunk(keep_evicted=True)`), per verify step.
            ring = torch.randn(BATCH, path["window"], path["kv"], path["hd"], generator=g,
                               device="cuda")
            idx = torch.arange(SPEC_K + 1, device="cuda")
            rows[-1]["ring_row_save_ms_per_verify_step"] = {
                fmt: time_ms(lambda leaf=_cache_leaf(ring, fmt): [
                    layers.cache_gather(leaf, idx) for _ in range(2)]) * path["layers"]
                for fmt in ("f32", "int8_tok", "mxint4_blk")}
        log(f"  selective scan {path['arch']}: {json.dumps(rows[-1])}")
    return rows


def _mla_f64(q, q2, lat, rope, n, scale):
    """The MLA mode's output in float64 from the decoded cache."""
    ld, rd = (kvq.decode(x)[:, :n].double() for x in (lat, rope))
    s = (torch.einsum("bhr,bcr->bhc", q.double(), ld)
         + torch.einsum("bhr,bcr->bhc", q2.double(), rd)) * scale
    return torch.einsum("bhc,bcr->bhr", torch.softmax(s, dim=-1), ld)


def kernel_phase_flash_decode_mla(peaks):
    """deepseek-v3's absorbed decode attention (flash-decode's MLA mode): B 2,
    H 128, latent 512, rope 64, C 544, in every cache format, kv_len an int32
    scalar on the card.  Checked at `DECODE_CHECK_LENS` against the plain
    version, timed at 528; the f32
    cache is the main-path unit (3 launches a step).  The absorbed query is
    drawn at std 0.5, q_nope . wk_b for a unit-variance q_nope over the nope
    width 128 against a unit-RMS latent of 512 (scores of unit variance, as
    the model's scale assumes); with q ~ N(0, 1) the kernel is held to a
    float64 evaluation at the same tolerance (the plain version's own f32
    error nears it there), and ``f64_max_abs_err`` reports both versions'.
    ``flops`` counts the work the function needs: scores over latent and
    rope, then P.V.  ``bound_ms`` prices it at the kernel's instruction mix,
    three TF32 tensor-core products per multiply-add for the f32 cache
    (3xTF32) and two for the other formats (2xTF32, the cache values exact
    in TF32); ``bound_f32_ms`` as f32 FMAs on the CUDA cores (the bound an
    FMA kernel would be held to).  A profiler check holds one call to one
    device kernel.  The library yardstick is
    `scaled_dot_product_attention` with ``enable_gqa`` on ``[q | q2]``
    against ``[latent | rope]`` with the latent as V, concatenated outside
    the timed call; no PyTorch call reads an encoded cache."""
    b, h, r, dr = BATCH, DS3["heads"], DS3["r"], DS3["dr"]
    c, n = CACHE_LEN, DECODE_KV_LEN
    nope = DS3["cfg"].qk_nope_head_dim
    scale = 1.0 / (nope + dr) ** 0.5
    gen = _gen(13)
    q = torch.randn(b, h, r, generator=gen, device="cuda") * (nope / r) ** 0.5
    q_unit = torch.randn(b, h, r, generator=gen, device="cuda")
    q2 = torch.randn(b, h, dr, generator=gen, device="cuda")
    lat32 = torch.randn(b, c, r, generator=gen, device="cuda")
    rope32 = torch.randn(b, c, dr, generator=gen, device="cuda")
    rows = []
    for fmt in ("f32", "bf16", "int8", "int8_tok", "mxint4_blk"):
        lat, rope = _cache_leaf(lat32, fmt), _cache_leaf(rope32, fmt)
        run = lambda qq, n_: ops.flash_decode(qq, lat, lat, n_, q2=q2, k2=rope,  # noqa: E731
                                              scale=scale, impl="kernel")
        plain = lambda qq, n_: ref.flash_decode_ref(qq, lat, lat, n_, q2=q2, k2=rope,  # noqa: E731
                                                    scale=scale)
        err = 0.0
        for kv_len in map(device_len, DECODE_CHECK_LENS):
            got = run(q, kv_len)
            err = max(err, _check(f"flash_decode MLA {fmt} kv_len {int(kv_len)}", got,
                                  plain(q, kv_len), 2e-5, 2e-6))
            if not torch.equal(got, run(q, kv_len)):
                raise RuntimeError(f"flash_decode MLA {fmt}: two launches differ")
        nd = device_len(n)
        lane_err, lane_ms = per_lane_checks(f"flash_decode MLA {fmt}",
                                            lambda n_: run(q, n_), lambda n_: plain(q, n_), n)
        want64 = _mla_f64(q_unit, q2, lat, rope, n, scale)
        _check(f"flash_decode MLA {fmt} at q ~ N(0, 1) vs float64", run(q_unit, nd).double(),
               want64, 2e-5, 2e-6)
        f64_err = {name: (fn(q_unit, nd).double() - want64).abs().max().item()
                   for name, fn in (("kernel", run), ("plain", plain))}
        row_bytes = sum(hopper.fd_row_bytes(fmt, w)[i] for w in (r, dr) for i in (0, 1))
        nbytes = 4 * b * h * (2 * r + dr) + n * b * row_bytes
        flops = 2 * b * h * n * (r + dr) + 2 * b * h * n * r
        bms, by = bound_ms(nbytes, (3 if fmt == "f32" else 2) * flops, peaks["tf32"], peaks)
        bf32, by32 = bound_ms(nbytes, flops, peaks["f32"], peaks)
        launched = _launch_kernels(lambda: run(q, nd))
        if len(launched) != 1 or "flash_decode_mla" not in launched[0]:
            raise RuntimeError(f"flash_decode MLA {fmt}: one call ran {launched}, "
                               "expected the kernel's one launch only")
        extra = {}
        if fmt == "f32":
            q_cat = torch.cat([q, q2], dim=-1)[:, :, None]                 # [B, H, 1, r + dr]
            k_cat = torch.cat([lat32, rope32], dim=-1)[:, None, :n].contiguous()
            v_lat = lat32[:, None, :n].contiguous()                        # [B, 1, n, r]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q_cat, k_cat, v_lat, scale=scale, enable_gqa=True)
            lib_err = (sdpa()[:, :, 0] - plain(q, nd)).abs().max().item()
            extra = dict(library_ms=time_ms(sdpa), library_backend=sdpa_backend(sdpa),
                         library_max_abs_err=lib_err)
            del q_cat, k_cat, v_lat
        path = {"f32": DS3["arch"], "bf16": "bf16 (no model path)",
                "int8": "legacy int8 (no model path)"}.get(fmt, f"{DS3['arch']} {fmt}")
        ms = time_ms(lambda: run(q, nd))
        row = dict(
            path=path, main=fmt == "f32", fmt=fmt, shape=[b, h, r, dr, c], kv_len=n,
            per_step=DS3["layers"], max_abs_err=max(err, lane_err),
            f64_max_abs_err=f64_err, ms=ms, per_lane_ms=lane_ms,
            per_lane_kv_len=list(LANE_KV_LENS[1]), per_lane_max_abs_err=lane_err,
            call_ms=call_ms(lambda: run(q, nd)), plain_ms=time_ms(lambda: plain(q, nd)),
            library_ms=None, bound_ms=bms, bound_by=by, bound_f32_ms=bf32,
            bound_f32_by=by32, flops=flops, launch_kernels=launched,
            plan={key: val for key, val in hopper.flash_decode_mla_plan(
                b, h, r, dr, c, fmt, hopper._mla_resident(q.device)).items()
                  if key not in ("ranges", "smem")},
            rate=f"{flops / ms / 1e9:.1f} TFLOP/s, {nbytes / ms / 1e6:.1f} GB/s",
            bound_share=bms / ms, bound_share_f32=bf32 / ms)
        row.update(extra)
        rows.append(row)
    return rows


def ptxas_summary(report: str) -> dict:
    """Entry functions, registers, shared memory and spills from ``nvcc
    -Xptxas -v`` output."""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", report)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)]
    stack = [int(x) for x in re.findall(r"(\d+) bytes stack frame", report)]
    smem = [int(x) for x in re.findall(r"registers, (?:used \d+ barriers, )?(\d+) bytes smem",
                                       report)]
    return dict(entries=len(regs), registers=[min(regs, default=0), max(regs, default=0)],
                static_smem_bytes=max(smem, default=0), stack_bytes=max(stack, default=0),
                spill_bytes=max(spills, default=0))


def _rms_f64(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.rsqrt(y.double().square().mean(dim=-1) + eps)


def kernel_phase_rmsnorm_stats(peaks):
    """sigma^{-1} rows at `RMS_SHAPES`.  It has no model path (the reference
    routes no site through its kernel); its unit is one [1024, 4096] bf16
    call.  Each shape is checked against the plain version and float64, a
    relaunch must be bit-equal, and a profiler check holds one call to one
    device kernel.  ``ms`` is one call per replay (`time_ms`, whose floor
    is printed) and ``amortised_ms`` RMS_AMORTISED calls on distinct inputs
    per replay.  No PyTorch call computes rsqrt(mean(y^2) + eps), so
    ``library_ms`` is None; ``nearest_library_ms`` times
    ``torch.linalg.vector_norm(y, dim=-1, dtype=torch.float32)``, one
    library reduction over the same bytes, as a yardstick of the read."""
    rows = []
    for m, d, dt, site in RMS_SHAPES:
        ys = [torch.randn(m, d, generator=_gen(m + d + i), device="cuda").to(dt)
              for i in range(RMS_AMORTISED)]
        y = ys[0]
        run = lambda yy=y: ops.rmsnorm_stats(yy, impl="kernel")  # noqa: E731
        tag = f"rmsnorm_stats {m}x{d} {dt}"
        got = run()
        err = _check(tag, got, ref.rmsnorm_stats_ref(y), 1e-6, 1e-6)
        want64 = _rms_f64(y)
        _check(f"{tag} vs float64", got.double(), want64, 1e-6, 1e-6)
        if not torch.equal(got, run()):
            raise RuntimeError(f"{tag}: two launches differ")
        launched = _launch_kernels(run)
        if len(launched) != 1 or "rmsnorm_stats_kernel" not in launched[0]:
            raise RuntimeError(f"{tag}: one call ran {launched}, expected one kernel")
        elem = y.element_size()
        plan = hopper.rmsnorm_stats_plan(m, d, elem, hopper._sms(y.device), hopper.rms_width(
            y.data_ptr(), y.stride(0) * elem, elem))
        bms, by = bound_ms(m * d * elem + 4 * m, 2 * m * d, peaks["f32"], peaks)
        lib = lambda yy=y: torch.linalg.vector_norm(yy, dim=-1, dtype=torch.float32)  # noqa: E731
        ms = time_ms(run)
        am = amortised_ms(run, ys)
        rows.append(dict(
            path="ops.rmsnorm_stats (no model path)", main=(m, d, dt) == RMS_MAIN, site=site,
            shape=[m, d], dtype=str(dt).replace("torch.", ""), per_call=1, max_abs_err=err,
            f64_max_abs_err={"kernel": (got.double() - want64).abs().max().item(),
                             "plain": (ref.rmsnorm_stats_ref(y).double() - want64)
                             .abs().max().item()},
            ms=ms, amortised_ms=am, call_ms=call_ms(run),
            plain_ms=time_ms(lambda: ref.rmsnorm_stats_ref(y)), library_ms=None,
            nearest_library_ms=time_ms(lib),
            bound_ms=bms, bound_by=by, bound_share=bms / ms, amortised_bound_share=bms / am,
            launch_kernels=launched,
            plan={k: plan[k] for k in ("width", "loads", "rounds", "tpr", "rows", "blocks",
                                       "waves")}))
        del ys, y, want64
    return rows


def sigma_chain_price() -> list:
    """What the port's sigma^{-1} sites pay today: `fr.rms_sigma_inv` (a
    chain of PyTorch kernels) beside `ops.rmsnorm_stats`, on the bf16 rows
    `layers.norm_emit` passes in decode and in prefill: device kernels per
    call, their device time per call (torch.profiler over 20 calls back to
    back, warm L2), ``ms`` (`time_ms`, cold L2) and ``call_ms``."""
    from torch.profiler import ProfilerActivity, profile
    out = []
    for m in (2, 1024):
        y = torch.randn(m, 4096, generator=_gen(m), device="cuda").to(torch.bfloat16)
        for what, fn in (("ops.rmsnorm_stats", lambda: ops.rmsnorm_stats(y, impl="kernel")),
                         ("fr.rms_sigma_inv", lambda: fr.rms_sigma_inv(y))):
            names = _launch_kernels(fn)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            dev, _ = _device_us(prof)
            out.append(dict(what=what, shape=[m, 4096], dtype="bfloat16",
                            kernels_per_call=len(names), kernels=[n[:60] for n in names],
                            device_us_per_call=dev / 20, ms=time_ms(fn), call_ms=call_ms(fn)))
    return out


def summarize(name, rows, per_key, tol):
    """One `kernels` entry.  Times and bounds are summed over one unit (a
    decode step for mxint4 and flash_decode, a prefill for w8a8 and
    retention, a call for rmsnorm_stats) of each main path the kernel is on,
    from the rows marked main; ``per_path`` holds the same sums per path."""
    def total(key, pick):
        sel = [r for r in rows if pick(r)]
        if not sel or any(r[key] is None for r in sel):
            return None
        return sum(r[key] * r[per_key] for r in sel)
    main = lambda r: r.get("main", True)    # noqa: E731
    b = total("bound_ms", main)
    by_ops = sum(r["bound_ms"] * r[per_key] for r in rows
                 if main(r) and r["bound_by"] == "operations")
    keys = ("ms", "plain_ms", "library_ms", "bound_ms") + tuple(
        key for key in ("library_rowmajor_ms", "library_gqa_ms", "bound_f32_ms",
                        "plain_contiguous_ms", "amortised_ms", "nearest_library_ms",
                        "per_lane_ms", "whole_stack_ms")
        if key in rows[0])
    per_path = {p: {key: total(key, lambda r, p=p: r["path"] == p) for key in keys}
                for p in dict.fromkeys(r["path"] for r in rows)}
    entry = dict(name=name, route="cuda", source=SRC[name][0], replaces=SRC[name][1],
                 launches=None, max_abs_err=max(r["max_abs_err"] for r in rows),
                 tolerance=tol, per=per_key.replace("per_", ""),
                 ms=total("ms", main), plain_ms=total("plain_ms", main), bound_ms=b,
                 bound_by="operations" if by_ops > b / 2 else "bytes",
                 library_ms=total("library_ms", main))
    entry.update({key: total(key, main) for key in keys[4:]})
    return dict(entry, per_path=per_path, shapes=rows)


def retention_launches(s: int) -> int:
    """Retention launches per layer of an ``s``-token prefill: the whole
    128-row chunks in one launch, the tail in another."""
    return int(s >= 128) + int(s % 128 > 0)


def expected_launches(path: dict, s: int = PROMPT) -> tuple[dict, dict]:
    """Launches per ``s``-token prefill and per decode step on a main path."""
    per_prefill = dict.fromkeys(hopper.COUNTERS, 0)
    per_step = dict.fromkeys(hopper.COUNTERS, 0)
    both = sum(c for _, _, c in path["linears"])
    w8_both = sum(c for _, _, c in path["decode_w8_linears"])
    prefill_only = sum(c for _, _, c in path["prefill_linears"] + path.get("frame_linears", ()))
    per_prefill["w8a8_matmul"] = (both + w8_both + prefill_only) * path["layers"] + 1
    per_step["mxint4_matmul"] = both * path["layers"] + 1
    per_step["w8a8_matmul"] = w8_both * path["layers"]
    if path["attn"] == "retention":
        per_prefill["retention_chunkwise"] = path["layers"] * retention_launches(s)
    elif path["attn"] == "mla":
        per_step["flash_decode_mla"] = path["layers"]
    elif path["attn"] == "gqa":
        per_step["flash_decode"] = path["layers"] * path.get("fd_per_layer", 1)
    if "experts" in path:
        per_step["mxint4_expert_matmul"] = 3 * path["layers"]
    return per_prefill, per_step


def serve_full_width(path: dict, card: str):
    """One main path at full width, once per cache format: launch counts per
    phase and per counted generate (its decode steps replays of the captured
    step), the graph against the eager loop in turns (timings, and tokens,
    lengths and final cache bit for bit), busy shares, and the kernel path
    against the plain path on the same weights."""
    arch, s = path["arch"], prompt_len(path)
    c_len = s + NEW
    log(f"== full-width serving: {arch}, B={BATCH}, S={s}, {NEW} greedy tokens, "
        f"cache formats {[f or 'f32' for f in path['formats']]}")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = InferenceEngine.from_config(path.get("cfg", arch), EngineSpec(), device="cuda")
    torch.cuda.synchronize()
    memory = dict(init_deploy_s=time.perf_counter() - t0,
                  held_before_init_gib=before / 2**30,
                  init_deploy_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  resident_gib=torch.cuda.memory_allocated() / 2**30,
                  card_gib=torch.cuda.get_device_properties(0).total_memory / 2**30)
    log(f"{arch} init + deploy: {json.dumps(memory)}")
    cfg = eng.cfg
    if (cfg.n_layers, cfg.d_model, cfg.padded_vocab) != (path["layers"], path["d"],
                                                         path["vocab"]):
        raise RuntimeError(f"unexpected config {cfg}")
    if cfg.is_encdec and cfg.encoder_layers != path["layers"]:
        raise RuntimeError(f"{arch}: frame_linears count {path['layers']} encoder layers, "
                           f"the config has {cfg.encoder_layers}")
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, s), generator=_gen(1),
                            device="cuda")
    extras = frame_extras(cfg)
    want_p, want_s = expected_launches(path, s)
    plain = InferenceEngine(cfg, eng.model, EngineSpec(kernel_impl="ref"))
    # The plain path's prefill, made once by the first format's lockstep:
    # the same function in every cache format (the cache is encoded after
    # it), read by `compare_paths` and `free_running`.
    plain_start = None
    counted, results = dict.fromkeys(hopper.COUNTERS, 0), {}
    for fmt in path["formats"]:
        t_cell = time.perf_counter()
        tag = arch if fmt is None else f"{arch} {fmt}"
        gen = GenerationConfig(max_new_tokens=NEW, cache_format=fmt)
        # Per-phase launch counts, eagerly, then the capture.
        hopper.reset_launches()
        logits, cache = eng.prefill(prompts, cache_len=c_len, extras=extras)
        per_prefill = dict(hopper.LAUNCHES)
        cache = eng._encode_cache(cache, gen)
        hopper.reset_launches()
        eng.decode_step(logits.argmax(-1)[:, None], cache)
        per_step = dict(hopper.LAUNCHES)
        log(tag, "launches per prefill", per_prefill, "per decode step", per_step)
        if per_prefill != want_p or per_step != want_s:
            raise RuntimeError(f"{tag}: launch counts {per_prefill} / {per_step}, "
                               f"expected {want_p} / {want_s}")
        key = eng.graph_key(cache, gen)
        del cache
        first = eng.generate(prompts, gen, extras=extras)
        graph = eng._graphs[key]
        log(f"{tag} step captured in {first.capture_s:.3f} s; a replay launches "
            f"{graph.launches}")
        if graph.launches != per_step:
            raise RuntimeError(f"{tag}: the captured step launches {graph.launches}, "
                               f"an eager step {per_step}")

        # The main path, counted.
        hopper.reset_launches()
        res = eng.generate(prompts, gen, extras=extras)
        launches = dict(hopper.LAUNCHES)
        want = {k: want_p[k] + want_s[k] * res.decode_steps for k in hopper.COUNTERS}
        log(tag, "main-path launches", launches, "decode steps (replays)", res.decode_steps)
        if launches != want or res.capture_s:
            raise RuntimeError(f"{tag}: main-path launches {launches}, expected {want} "
                               f"(capture {res.capture_s} s)")
        for k in counted:
            counted[k] += launches[k]
        toks = res.tokens
        if toks.shape != (BATCH, NEW) or not _in_vocab(cfg, toks):
            raise RuntimeError(f"{tag}: bad tokens {toks.shape}")
        if not torch.equal(toks, first.tokens):
            raise RuntimeError(f"{tag}: a second generate's tokens differ from the first's")

        # The eager loop beside the counted graph run (in turns, eager, graph,
        # graph, eager, before a depth cut): tokens, lengths and final
        # cache bit for bit.
        t_turns = time.perf_counter()
        got, cache = eager_generate(eng, prompts, gen, extras)
        graph_runs, eager_runs = [res], [got]
        _same_as_graph(tag, res, graph.state.cache, got, cache)
        del cache
        serving = dict(card=card, runs=len(graph_runs), launches=launches,
                       capture_s=first.capture_s, replay_launches=graph.launches, prompt=s,
                       **(memory if fmt == path["formats"][0] else {}))
        for name, runs in (("", graph_runs), ("eager_", eager_runs)):
            pre = sorted(r.prefill_s for r in runs)[len(runs) // 2]
            dec = sorted(r.decode_s / r.decode_steps for r in runs)[len(runs) // 2]
            serving.update({f"{name}prefill_ms": pre * 1e3,
                            f"{name}decode_ms_per_token": dec * 1e3,
                            f"{name}decode_tokens_per_s": BATCH / dec,
                            f"{name}prefill_ms_runs": [r.prefill_s * 1e3 for r in runs],
                            f"{name}decode_ms_per_token_runs": [
                                r.decode_s * 1e3 / r.decode_steps for r in runs]})
        serving["prefill_tokens_per_s"] = BATCH * s / (serving["prefill_ms"] / 1e3)
        serving["graph_and_eager_bit_identical"] = True
        if "experts" in path and fmt == path["formats"][0]:
            serving["moe_dispatch"] = moe_drops(tag, eng, prompts, gen)
        t_profile = time.perf_counter()
        if fmt == path["formats"][0]:
            serving.update(profile_shares(eng, prompts, gen, extras=extras,
                                          prefill=path.get("profile_prefill", True)))
        serving.update(turns_s=t_profile - t_turns, profile_s=time.perf_counter() - t_profile)
        log(f"{tag} serving (kernel path, medians; graph and eager in turns):",
            json.dumps(serving))

        # The same weights on the plain path.
        t1 = time.perf_counter()
        checks, plain_start = compare_paths(path, eng, plain, prompts, gen, plain_start,
                                            logits, first=fmt == path["formats"][0],
                                            extras=extras)
        if fmt == path["formats"][0]:
            res_k, res_p, drift = free_running(eng, plain, prompts, gen, extras, plain_start)
            checks.update(
                greedy_token_agreement=(res_p.tokens == toks[:, :FREE_RUN_NEW]).float()
                .mean().item(),
                free_running=dict(drift, tokens=FREE_RUN_NEW, kernel_tokens_as_counted=bool(
                    (res_k.tokens == toks[:, :FREE_RUN_NEW]).all())),
                plain_decode_ms_per_token=res_p.decode_s * 1e3 / res_p.decode_steps)
        checks["compare_s"] = time.perf_counter() - t1
        serving.update(checks, cell_s=time.perf_counter() - t_cell)
        log(f"{tag} kernel vs plain path:", json.dumps(checks))
        results[tag] = serving
    if path is RETNET:
        results[f"{arch} top-k"] = sampled_through_graph(eng, prompts)
        results[f"{arch} top-p"] = top_p_through_graph(eng, prompts)
    del plain_start
    log(f"{arch} phase: {time.perf_counter() - t0:.1f} s")
    if frontend_path(path):
        if cfg.frontend == "vision":
            results[f"{arch} bucketed"] = bucketed_vs_exact(path, eng, prompts, extras, card)
        results[f"{arch} refusals"] = serve_refusals(eng, prompts, extras)
        none = dict.fromkeys(hopper.COUNTERS, 0)
        del eng, plain
        torch.cuda.empty_cache()
        return counted, none, dict(none), dict(none), dict(none), results
    admitted, admission = serve_admission(path, eng, plain, card)
    results.update(admission)
    scheduled, scheduling = serve_scheduler(path, eng, card)
    results.update(scheduling)
    prefixed, prefixing = serve_prefix(path, eng, card)
    results.update(prefixing)
    speculated, speculating = serve_speculative(path, eng, plain, card)
    results.update(speculating)
    del eng, plain
    torch.cuda.empty_cache()
    return counted, admitted, scheduled, prefixed, speculated, results


def frame_extras(cfg, batch: int = BATCH) -> dict | None:
    """A model's frontend inputs to `prefill` / `generate`, from the
    frontend stub and a fixed seed, on the card: an encoder-decoder's
    ``src_embeds`` (its ``frontend_tokens`` frames), a vision model's
    ``patch_embeds`` (its ``frontend_tokens`` patches); None elsewhere."""
    if cfg.is_encdec:
        return {"src_embeds": frontends.synth_frame_embeds(cfg, batch, cfg.frontend_tokens,
                                                           seed=2, device="cuda")}
    if cfg.frontend == "vision":
        return {"patch_embeds": frontends.synth_patch_embeds(cfg, batch, seed=2,
                                                             device="cuda")}
    return None


@torch.inference_mode()
def serve_refusals(eng, prompts, extras) -> dict:
    """The admission paths the reference refuses a frontend model, each
    raising NotImplementedError on the card too (untimed): chunked
    admission, the scheduler's admission (its chunked prefill) and
    speculative decode; an encoder-decoder's bucketed prefill; a vision
    model's prefix cache (no sharing mode, so the scheduler with it on
    admits through the same chunked prefill).  Returns each refusal's
    message."""
    from repro_torch.serving import Request, RequestScheduler
    from repro_torch.serving.sampling import SpeculativeConfig
    gen = GenerationConfig(max_new_tokens=8)

    def scheduler(prefix_cache: bool = False):
        sched = RequestScheduler(eng, classes=[(2, 48)], gen=gen, chunk_size=16,
                                 prefix_cache=prefix_cache)
        if sched.pool.prefix.mode is not None:
            raise RuntimeError(f"{eng.cfg.name}: a prefix cache in {sched.pool.prefix.mode} "
                               "mode; the reference shares no prefix of a frontend prompt")
        sched.submit(Request(uid=0, prompt=prompts[0, :32].tolist()))
        sched.run()

    cases = (("chunked", lambda: eng.begin_chunked_prefill(
                 prompts, cache_len=prompts.shape[1] + NEW, chunk_size=ADMIT_CHUNK).advance()),
             ("scheduler", scheduler),
             ("speculative", lambda: eng.generate(
                 prompts, gen, speculative=SpeculativeConfig(k=SPEC_K), extras=extras)))
    if eng.cfg.is_encdec:
        cases += (("bucketed", lambda: eng.prefill(prompts, extras=extras, bucket=True)),)
    else:
        cases += (("prefix", lambda: scheduler(prefix_cache=True)),)
    out = {}
    for name, fn in cases:
        try:
            fn()
        except NotImplementedError as e:
            out[name] = str(e)
            continue
        raise RuntimeError(f"{eng.cfg.name}: {name} ran; the reference refuses it")
    log(f"{eng.cfg.name} refusals: {json.dumps(out)}")
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def act_scales():
    """Record the per-tensor int8 activation scale of every W8A8 call
    (`mxint4.quantize_act_int8`, looked up at call time), in call order."""
    real, seen = mx.quantize_act_int8, []

    def spy(x):
        out = real(x)
        seen.append(out[1])
        return out

    mx.quantize_act_int8 = spy
    try:
        yield seen
    finally:
        mx.quantize_act_int8 = real


@torch.inference_mode()
def bucketed_vs_exact(path: dict, eng, prompts, extras, card: str) -> dict:
    """A vision prompt's bucketed prefill (its S padded up the ladder, the
    patches spliced over its head as in the exact one) against the exact
    prefill on the same weights.  Fatal: one bucketed prefill's launches
    exact; its logits, and its cache's real rows in every layer, within
    PREFILL_TOL of max|value| of the exact prefill's (a W8A8 linear takes one
    int8 scale over its whole input, padding rows included, so the two
    differ where a padding row holds a linear's absmax: the scales that
    differ are counted, and where none does the two must be bit-equal); its
    position at S and its capacity the ladder's; NEW greedy tokens resumed
    from each cache through the graph (the bucketed one at that capacity:
    flash-decode at C 4096), each resume's launches exact, where they part
    recorded."""
    arch, s = path["arch"], prompts.shape[1]
    c_len = s + NEW
    want_p, want_s = expected_launches(path, s)
    gen = GenerationConfig(max_new_tokens=NEW)
    out = dict(card=card)
    hopper.reset_launches()
    with act_scales() as sb:
        (lg_b, cache_b), out["bucketed_prefill_ms"] = _timed(
            lambda: eng.prefill(prompts, cache_len=c_len, extras=extras, bucket=True))
    if dict(hopper.LAUNCHES) != want_p:
        raise RuntimeError(f"{arch} bucketed prefill: launches {dict(hopper.LAUNCHES)}, "
                           f"expected {want_p}")
    with act_scales() as se:
        (lg_e, cache_e), out["exact_prefill_ms"] = _timed(
            lambda: eng.prefill(prompts, cache_len=c_len, extras=extras))
    cap = layers.cache_capacity(cache_b["blocks"][0]["k"])
    if int(cache_b["pos"]) != s or cap != bucket_length(c_len):
        raise RuntimeError(f"{arch} bucketed prefill: pos {int(cache_b['pos'])}, capacity "
                           f"{cap}; expected {s}, {bucket_length(c_len)}")
    differ = sum(int(not torch.equal(a, b)) for a, b in zip(sb, se))
    out.update(padded_to=bucket_length(s), capacity=cap, w8a8_calls=len(se),
               act_scales_differing=differ, tolerance=PREFILL_TOL,
               logit_rel_err=_rel(lg_b, lg_e, f"{arch} bucketed vs exact logits", PREFILL_TOL))
    worst = 0.0
    for i, (bb, be) in enumerate(zip(cache_b["blocks"], cache_e["blocks"])):
        for name in ("k", "v"):
            worst = max(worst, _rel(bb[name][:, :s], be[name][:, :s],
                                    f"{arch} bucketed vs exact layer {i} {name}", PREFILL_TOL))
    out["cache_rel_err"] = worst
    if not differ and not (torch.equal(lg_b, lg_e) and all(
            torch.equal(bb[n][:, :s], be[n][:, :s])
            for bb, be in zip(cache_b["blocks"], cache_e["blocks"]) for n in ("k", "v"))):
        raise RuntimeError(f"{arch} bucketed vs exact: the same int8 scales, other values")
    runs = {}
    for name, lg, cache in (("exact", lg_e, cache_e), ("bucketed", lg_b, cache_b)):
        fresh = eng.graph_key(cache, gen) not in eng._graphs
        hopper.reset_launches()
        res = eng.resume_generate(lg.argmax(-1), cache, gen)
        steps = res.decode_steps + int(fresh)          # the capture's warm-up step
        want = {k: want_s[k] * steps for k in hopper.COUNTERS}
        if dict(hopper.LAUNCHES) != want or res.tokens.shape != (BATCH, NEW) \
                or not _in_vocab(eng.cfg, res.tokens):
            raise RuntimeError(f"{arch} {name} resume: launches {dict(hopper.LAUNCHES)}, "
                               f"expected {want}; tokens {tuple(res.tokens.shape)}")
        runs[name] = res
        out[f"{name}_resumed_decode_ms_per_token"] = (
            (res.decode_s - res.capture_s) * 1e3 / res.decode_steps)
        if fresh:
            out[f"{name}_capture_s"] = res.capture_s
            del eng._graphs[eng.graph_key(cache, gen)]
    out["resumed_first_parting"] = _parting(runs["bucketed"].tokens, runs["exact"].tokens)
    log(f"{arch} bucketed vs exact prefill: {json.dumps(out)}")
    del cache_b, cache_e
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def dispatch_spy():
    """Record every MoE dispatch (`mlp.dispatch`): the experts chosen, the
    slot positions and the capacity (a position equal to it is a dropped
    assignment)."""
    from repro_torch.models import mlp
    real, seen = mlp.dispatch, []

    def spy(idx, e, cap):
        pos = real(idx, e, cap)
        seen.append((idx, pos, cap))
        return pos

    mlp.dispatch = spy
    try:
        yield seen
    finally:
        mlp.dispatch = real


def moe_drops(tag, eng, prompts, gen) -> dict:
    """One eager generate with every dispatch recorded: the assignments and
    drops of the prefill's dispatches (B x S tokens each) and of the decode
    steps' (B tokens, one dispatch a layer: at olmoe's widths cap 1, so two
    lanes that pick one expert drop the later lane's assignment).  Raises
    if no decode dispatch dropped: the drop path did not run."""
    with dispatch_spy() as seen:
        eager_generate(eng, prompts, gen)

    def count(calls):
        return (sum(p.numel() for _, p, _ in calls),
                sum(int((p == cap).sum()) for _, p, cap in calls),
                sorted({c for _, _, c in calls}))

    (pa, pd, pcap), (da, dd, dcap) = (count([c for c in seen if c[1].shape[1] == n])
                                      for n in (prompts.shape[1] * prompts.shape[0], BATCH))
    out = dict(prefill_assignments=pa, prefill_dropped=pd, prefill_cap=pcap,
               decode_assignments=da, decode_dropped=dd, decode_cap=dcap,
               dispatches=len(seen))
    log(f"{tag} MoE dispatch (one eager generate): {json.dumps(out)}")
    if not dd:
        raise RuntimeError(f"{tag}: no B {BATCH} decode dispatch dropped an assignment")
    return out


@torch.inference_mode()
def _in_vocab(cfg, toks: torch.Tensor) -> bool:
    """Every token an id of the model's vocabulary; on the models in
    PADDING_IDS, of its padded vocabulary, the rows of its embedding and LM
    head (neither the reference nor the port masks the padding rows, and
    random weights there emit such ids)."""
    limit = cfg.padded_vocab if cfg.name in PADDING_IDS else cfg.vocab_size
    return bool(((toks >= 0) & (toks < limit)).all())


def eager_generate(eng, prompts, gen, extras=None, start=None):
    """`generate` as the eager loop: prefill, then `decode_step` in a Python
    loop in the reference's body order (greedy, no stop tokens), timed as
    `generate` times itself.  ``start`` (logits, f32 cache) is a prefill
    already run at this length, whose cache is copied instead (its time is
    then not counted).  Returns a GenerationResult and the final cache."""
    if not gen.sampling.greedy or gen.stop_tokens:
        raise ValueError("eager_generate: greedy decoding without stop tokens only")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if start is None:
        logits, cache = eng.prefill(prompts, cache_len=prompts.shape[1] + gen.max_new_tokens,
                                    extras=extras)
    else:
        logits, cache = start[0], _clone(start[1])
    cache = eng._encode_cache(cache, gen)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    res, cache = eager_loop(eng, sample(logits, gen.sampling), cache, gen)
    res.prefill_s = t_prefill
    return res, cache


@torch.inference_mode()
def eager_loop(eng, tok, cache, gen):
    """The decode loop as `decode_step` in a Python loop from the first
    emitted token ``tok`` and ``cache`` (which dense decode writes in
    place), in the reference's body order (greedy, no stop tokens).
    Returns a GenerationResult (decode timed, no prefill) and the final
    cache."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b, n = tok.shape[0], gen.max_new_tokens
    out = torch.full((b, n), gen.pad_token_id, dtype=torch.long, device="cuda")
    lengths = torch.zeros(b, dtype=torch.int32, device="cuda")
    for i in range(n):
        out[:, i] = tok
        lengths += 1
        logits, cache = eng.decode_step(tok[:, None], cache)
        tok = sample(logits, gen.sampling)
    torch.cuda.synchronize()
    return GenerationResult(tokens=out, lengths=lengths, prefill_s=0.0,
                            decode_s=time.perf_counter() - t0, decode_steps=n), cache


def _same_as_graph(tag, res_g, cache_g, res_e, cache_e) -> None:
    """The graph's and the eager loop's tokens, lengths and final cache, bit
    for bit (every tensor of the cache: position, rope angles, rows)."""
    if not (torch.equal(res_g.tokens, res_e.tokens)
            and torch.equal(res_g.lengths, res_e.lengths)):
        raise RuntimeError(f"{tag}: graph and eager loop emit different tokens")
    a = dict(serving_engine.tree_items(cache_g))
    b = dict(serving_engine.tree_items(cache_e))
    if a.keys() != b.keys():
        raise RuntimeError(f"{tag}: graph and eager caches differ in structure")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        raise RuntimeError(f"{tag}: graph and eager final caches differ at {differ[:4]}")


@torch.inference_mode()
def sampled_through_graph(eng, prompts) -> dict:
    """Top-k sampling through the captured step: every token among the k
    largest logits of its step (checked on the first, from prefill, and by
    replaying the eager loop's logits on the graph's tokens), the same
    tokens again from the same seed, other tokens from another seed."""
    gen = GenerationConfig(max_new_tokens=NEW, sampling=SamplingParams(temperature=1.0,
                                                                        top_k=4))
    runs = [eng.generate(prompts, gen, generator=_gen(21)) for _ in range(2)]
    other = eng.generate(prompts, gen, generator=_gen(22))
    toks = runs[0].tokens
    logits, cache = eng.prefill(prompts, cache_len=CACHE_LEN)
    outside = 0
    for i in range(NEW):
        allowed = torch.topk(logits, 4, dim=-1).indices
        outside += int((allowed != toks[:, i:i + 1]).all(dim=-1).sum())
        logits, cache = eng.decode_step(toks[:, i:i + 1], cache)
    out = dict(capture_s=runs[0].capture_s, repeats=bool(torch.equal(toks, runs[1].tokens)),
               other_seed_differs=not torch.equal(toks, other.tokens),
               tokens_outside_top_k=outside, decode_ms_per_token=runs[1].decode_s * 1e3 / NEW)
    log("top-k through the graph:", json.dumps(out))
    if not out["repeats"] or not out["other_seed_differs"] or outside:
        raise RuntimeError(f"top-k sampling through the graph: {out}")
    return out


@torch.inference_mode()
def top_p_through_graph(eng, prompts) -> dict:
    """Top-p sampling through the captured step (temperature 1, p TOP_P):
    every token inside its step's nucleus, recomputed with the plain
    `_top_p_mask` from that step's logits (the first from prefill, the rest
    by replaying the eager loop on the graph's tokens), and the same tokens
    again from the same seed."""
    gen = GenerationConfig(max_new_tokens=NEW, sampling=SamplingParams(temperature=1.0,
                                                                        top_p=TOP_P))
    runs = [eng.generate(prompts, gen, generator=_gen(41)) for _ in range(2)]
    other = eng.generate(prompts, gen, generator=_gen(42))
    toks = runs[0].tokens
    logits, cache = eng.prefill(prompts, cache_len=CACHE_LEN)
    outside, sizes = 0, []
    for i in range(NEW):
        kept = torch.isfinite(_top_p_mask(logits.float(), TOP_P))
        outside += int((~kept.gather(1, toks[:, i:i + 1])).sum())
        sizes.append(kept.sum(dim=-1).tolist())
        logits, cache = eng.decode_step(toks[:, i:i + 1], cache)
    out = dict(p=TOP_P, capture_s=runs[0].capture_s,
               repeats=bool(torch.equal(toks, runs[1].tokens)),
               other_seed_differs=not torch.equal(toks, other.tokens),
               tokens_outside_nucleus=outside,
               nucleus_sizes_min_max=[min(min(z) for z in sizes), max(max(z) for z in sizes)],
               decode_ms_per_token=runs[1].decode_s * 1e3 / NEW)
    log("top-p through the graph:", json.dumps(out))
    if not out["repeats"] or outside:
        raise RuntimeError(f"top-p sampling through the graph: {out}")
    return out


def _bytes_differing(a, b) -> tuple[int, int]:
    """(differing, total) bytes of two cache trees, element by element."""
    diff = total = 0
    ib = dict(serving_engine.tree_items(b))
    for k, t in serving_engine.tree_items(a):
        diff += int((t != ib[k]).sum()) * t.element_size()
        total += t.numel() * t.element_size()
    return diff, total


def _cache_rel(tag, ck, cr, tol) -> float:
    """Largest relative difference of the (decoded) leaves of two layer
    caches, each within ``tol`` of its max|value| (equal where that is 0); a
    hybrid layer's ``attn`` and ``mamba`` subtrees are walked."""
    worst = 0.0
    for name in cr:
        if isinstance(cr[name], dict) and kvq.leaf_format(cr[name]) is None:
            worst = max(worst, _cache_rel(f"{tag} {name}", ck[name], cr[name], tol))
            continue
        a, b = kvq.decode(ck[name]), kvq.decode(cr[name])
        if not bool(b.abs().max() > 0):
            if not torch.equal(a, b):
                raise RuntimeError(f"{tag} {name}: kernel vs plain differ on a zero leaf")
            continue
        worst = max(worst, _rel(a, b, f"{tag} {name}", tol))
    return worst


def phase_formats(path: dict) -> tuple:
    """The cache formats the admission, prefix and speculative phases run
    a path in: every format of phase 4, unless ``phase_formats`` cuts them."""
    return path.get("phase_formats", path["formats"])


def admit_prompt(path: dict) -> tuple[int, int]:
    """The admission phase's prompt length and chunk size on ``path``."""
    return path.get("admit_prompt", ADMIT_PROMPT), path.get("admit_chunk", ADMIT_CHUNK)


@torch.inference_mode()
def chunk_lockstep(eng, plain, prompts, fmt, chunk_size: int,
                   n_chunks: int | None = None) -> dict:
    """The chunked admission, kernel path against plain path on the same
    weights, in lockstep: each chunk starts both paths from the plain path's
    cache (in ``fmt``), each block gets the plain path's input, and the
    block outputs, every tensor of each layer's new cache (decoded) and the
    chunk's logits (the lm_head on the plain path's final activations) must
    agree within BLOCK_TOL of max|value|.  Encoded bytes that differ are
    counted and reported.  ``n_chunks`` stops after that many chunks."""
    cfg, model = eng.cfg, eng.model
    cache = lm.make_decode_cache(cfg, prompts.shape[0], prompts.shape[1] + NEW,
                                 dtype=fmt or torch.float32, device="cuda")
    worst = dict(block=0.0, cache=0.0, logits=0.0)
    diff_bytes = total_bytes = 0
    off = 0
    for j, c in enumerate(chunk_schedule(prompts.shape[1], chunk_size)[:n_chunks]):
        pos = cache["pos"]
        x = lm._embed(model, prompts[:, off:off + c], cfg, start=pos)
        sin, cos = lm._rope_tables(cfg, c, x.device, start=pos)
        blocks = []
        for i, (blk, cl) in enumerate(zip(model.blocks, cache["blocks"])):
            yk, ck = lm._block_chunk(blk, x, cfg, eng.hsa, _clone(cl), pos, sin, cos)
            yr, cr = lm._block_chunk(blk, x, cfg, plain.hsa, _clone(cl), pos, sin, cos)
            tag = f"chunk {j} (c {c}) block {i}"
            worst["block"] = max(worst["block"], _rel(yk, yr, tag, BLOCK_TOL))
            worst["cache"] = max(worst["cache"], _cache_rel(tag, ck, cr, BLOCK_TOL))
            if fmt is not None:
                d, t = _bytes_differing(ck, cr)
                diff_bytes, total_bytes = diff_bytes + d, total_bytes + t
            x = yr.to(x.dtype)
            blocks.append(cr)
        h = layers.norm_full(model.final_norm, x[:, -1:])
        lk = eng.hsa.linear(model.lm_head, h, "prefill")[:, 0]
        lr = plain.hsa.linear(model.lm_head, h, "prefill")[:, 0]
        worst["logits"] = max(worst["logits"], _rel(lk, lr, f"chunk {j} logits", BLOCK_TOL))
        cache = {"pos": pos + c, "blocks": blocks}
        if cfg.rope:
            cache["rope"] = lm._rope_state(cfg, cache["pos"])
        off += c
    return dict(lockstep_block_max_rel_err=worst["block"],
                lockstep_cache_max_rel_err=worst["cache"],
                lockstep_logit_max_rel_err=worst["logits"], lockstep_tolerance=BLOCK_TOL,
                lockstep_encoded_bytes_differing=[diff_bytes, total_bytes])


def _mono_and_bucketed(tag, path, eng, prompts, gen, fns, lg_c, t_c0, res) -> dict:
    """The admission phase's bucketed and monolithic prefills beside the
    chunked one (``fns``: bucketed, monolithic, chunked): their launches,
    each exact (retention runs every length through the kernel: 116, the
    tail alone, one launch per layer; the 128 bucket one), host ms in turns
    (chunked, bucketed, monolithic, chunked: the two chunked prefills must
    give the same logits; twice each before a depth cut), and the
    chunked and bucketed logits and resumed tokens against monolithic's."""
    bucketed, mono, chunked = fns
    s = prompts.shape[1]
    want = dict(bucketed=expected_launches(path, bucket_length(s))[0],
                monolithic=expected_launches(path, s)[0])
    times = dict(chunked=[t_c0], bucketed=[], monolithic=[])
    runs, launches = {}, {}
    for name, fn in (("bucketed", bucketed), ("monolithic", mono), ("chunked", chunked)):
        hopper.reset_launches()
        runs[name], ms = _timed(fn)
        times[name].append(ms)
        if name in want:
            launches[name] = dict(hopper.LAUNCHES)
            if launches[name] != want[name]:
                raise RuntimeError(f"{tag}: a {name} prefill launches {launches[name]}, "
                                   f"expected {want[name]}")
    out = dict(prefill_ms_in_turns=times, prefill_launches=launches)
    (lg_m, cache_m), (lg_b, cache_b) = runs["monolithic"], runs["bucketed"]
    if not torch.equal(runs["chunked"][0], lg_c):
        raise RuntimeError(f"{tag}: two chunked prefills of one prompt differ")
    res_m = eng.resume_generate(lg_m.argmax(-1), cache_m, gen)
    res_b = eng.resume_generate(lg_b.argmax(-1), cache_b, gen)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()  # noqa: E731
    for r in (res_m, res_b):
        if r.tokens.shape != (BATCH, NEW) or not _in_vocab(eng.cfg, r.tokens):
            raise RuntimeError(f"{tag}: bad tokens {r.tokens.shape}")
    return dict(out, chunked_vs_monolithic_logit_rel=rel(lg_c, lg_m),
                bucketed_vs_monolithic_logit_rel=rel(lg_b, lg_m),
                chunked_vs_monolithic_first_parting=_parting(res.tokens, res_m.tokens),
                bucketed_vs_monolithic_first_parting=_parting(res_b.tokens, res_m.tokens),
                bucketed_capture_s=res_b.capture_s)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _parting(a: torch.Tensor, b: torch.Tensor):
    """The first token column at which two greedy runs part (None: never)."""
    cols = (a != b).any(dim=0).nonzero()[:, 0].tolist()
    return cols[0] if cols else None


@torch.inference_mode()
def serve_admission(path: dict, eng, plain, card: str):
    """The admission paths at full width, once per cache format of the
    chunked admission: 2 prompts of ADMIT_PROMPT tokens in chunks of
    ADMIT_CHUNK (`admit_prompt`).  Fatal: the chunked prefill against the
    plain path in lockstep (`chunk_lockstep`; the first
    LATER_LOCKSTEP_CHUNKS chunks after the first format); the launch counts of the counted run
    (chunked prefill, then `resume_generate` of NEW greedy tokens through
    the graph: W8A8 chunks x (linears + lm_head), retention chunks x
    layers, one eager warm-up step and the replays); the graph against the
    eager loop from the same cache, bit for bit, the final cache read from
    the caller's; for the first format, the resume in two halves against
    the one resume (`resume_in_halves`) and the launches of one monolithic
    and one bucketed prefill (`_mono_and_bucketed`).  Recorded, in the
    first format: the chunked and the bucketed (to 128) prefill against
    monolithic prefill on the same deployed weights
    (the last logits' largest relative difference, where the greedy tokens
    resumed from each cache part from monolithic's), and the three
    prefills' host ms in turns."""
    arch = path["arch"]
    t0 = time.perf_counter()
    cfg = eng.cfg
    s_admit, chunk_size = admit_prompt(path)
    admit_cache = s_admit + NEW
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, s_admit), generator=_gen(31),
                            device="cuda")
    sched = chunk_schedule(s_admit, chunk_size)
    log(f"== admission: {arch}, B={BATCH}, S={s_admit} in chunks {sched}, then "
        f"{NEW} greedy tokens resumed through the graph"
        + (f" (the ring of {cfg.sliding_window} wraps)" if cfg.sliding_window
           and s_admit > cfg.sliding_window else ""))
    want_p, want_s = expected_launches(path, chunk_size)
    want_chunked = {k: v * len(sched) for k, v in want_p.items()}
    counted, results = dict.fromkeys(hopper.COUNTERS, 0), {}
    for fmt in phase_formats(path):
        t_cell = time.perf_counter()
        tag = f"{arch} admission" + ("" if fmt is None else f" {fmt}")
        gen = GenerationConfig(max_new_tokens=NEW, cache_format=fmt)
        out = dict(card=card, schedule=sched)
        first = fmt == path["formats"][0]
        out.update(chunk_lockstep(eng, plain, prompts, fmt, chunk_size,
                                  None if first else LATER_LOCKSTEP_CHUNKS))

        # The counted run: chunked prefill, then decode resumed through the graph.
        hopper.reset_launches()
        (lg_c, cache_c), t_c0 = _timed(lambda: eng.prefill_chunked(
            prompts, cache_len=admit_cache, chunk_size=chunk_size,
            cache_dtype=fmt or torch.float32))
        per_chunked = dict(hopper.LAUNCHES)
        pending = lg_c.argmax(-1)
        eager_cache = serving_engine._clone(cache_c)
        cache_c0 = serving_engine._clone(cache_c)
        key = eng.graph_key(cache_c, gen)
        fresh = key not in eng._graphs
        res = eng.resume_generate(pending, cache_c, gen)
        launches = dict(hopper.LAUNCHES)
        steps = res.decode_steps + (1 if fresh else 0)     # the capture's warm-up step
        want = {k: want_chunked[k] + want_s[k] * steps for k in hopper.COUNTERS}
        log(tag, "launches per chunked prefill", per_chunked, "with the resumed decode",
            launches, "replays", res.decode_steps, "captured", fresh)
        if per_chunked != want_chunked or launches != want:
            raise RuntimeError(f"{tag}: launches {per_chunked} / {launches}, expected "
                               f"{want_chunked} / {want}")
        for k in counted:
            counted[k] += launches[k]
        got, cache_e = eager_loop(eng, pending, eager_cache, gen)
        _same_as_graph(tag, res, cache_c, got, cache_e)
        del eager_cache, cache_e
        if first:
            out["resumed_in_two_halves_bit_identical"] = resume_in_halves(
                tag, eng, pending, cache_c0, res, cache_c, gen)
        del cache_c0
        out.update(graph_and_eager_bit_identical=True, launches=launches,
                   capture_s=res.capture_s,
                   resumed_decode_ms_per_token=(res.decode_s - res.capture_s) * 1e3
                   / res.decode_steps,
                   eager_decode_ms_per_token=got.decode_s * 1e3 / got.decode_steps)

        # Bucketed and monolithic prefill on the same weights, timed in turns.
        def mono():
            lg, cache = eng.prefill(prompts, cache_len=admit_cache)
            return lg, eng._encode_cache(cache, gen)

        def bucketed():
            lg, cache = eng.prefill(prompts, cache_len=admit_cache, bucket=True)
            return lg, eng._encode_cache(cache, gen)

        def chunked():
            return eng.prefill_chunked(prompts, cache_len=admit_cache, chunk_size=chunk_size,
                                       cache_dtype=fmt or torch.float32)

        if first:
            out.update(_mono_and_bucketed(tag, path, eng, prompts, gen,
                                          (bucketed, mono, chunked), lg_c, t_c0, res))
        out["cell_s"] = time.perf_counter() - t_cell
        log(f"{tag}:", json.dumps(out))
        results[tag] = out
        del cache_c
    log(f"{arch} admission phase: {time.perf_counter() - t0:.1f} s")
    return counted, results


# The scheduler phase.  retnet-1.3b serves the `goodput_under_load` leg of
# the reference's serving bench (benchmarks/bench_serving.py: 8 requests,
# prompts 6-24, 8 new tokens, 2 lanes, chunks of 8; a closed-loop
# calibration, then Poisson arrivals at 0.5, 1.5 and 4.0 x the calibrated
# rate through the front end; the front end against a direct run()); qwen3-8b
# and ds3_dense each drain mixed lengths through two classes of 2 lanes.
GOODPUT = dict(requests=8, prompt_min=6, prompt_max=24, new=8, lanes=2, chunk=8,
               rate_mults=(0.5, 1.5, 4.0))
DRAIN_LENS, DRAIN_CLASSES, DRAIN_CHUNK = (6, 40, 17, 70, 25, 9), ((2, 48), (2, 80)), 16
DECODE_KERNELS = ("mxint4_matmul", "flash_decode", "flash_decode_mla")


def _summary(obs, name: str) -> dict:
    h = obs.metrics.histogram(name)
    return {k: v for k, v in h.summary().items() if k in ("count", "p50", "p99", "mean")}


def scheduler_report(sched, wall_s: float) -> dict:
    """The scheduler's serving numbers from its metrics registry."""
    c = sched.obs.metrics.snapshot()["counters"]
    return dict(wall_s=wall_s, steps=c["sched.steps"], emitted=c["sched.emitted"],
                prefill_chunks=c["sched.prefill_chunks"],
                decode_stall_steps=c["sched.decode_stall_steps"],
                tokens_per_s=c["sched.emitted"] / wall_s, capture_s=sched.capture_s,
                ttft_s=_summary(sched.obs, "sched.ttft_s"),
                inter_token_s=_summary(sched.obs, "sched.inter_token_s"),
                inter_token_admitting_s=_summary(sched.obs, "sched.inter_token_admitting_s"),
                prefill_chunk_interval_s=_summary(sched.obs,
                                                  "sched.prefill_chunk_interval_s"))


def check_class_steps(tag, sched, want_step: dict) -> None:
    """Each class step launches exactly one decode step's kernels per replay."""
    for clen, step in sched.pool.steps.items():
        got = {k: step.launches.get(k, 0) for k in hopper.COUNTERS}
        if step.graph is None or got != want_step:
            raise RuntimeError(f"{tag}: class {clen}'s captured step launches {got}, "
                               f"expected {want_step}")


@torch.inference_mode()
def class_step_identity(tag, step) -> dict:
    """One replay of a class step against its eager body from the same state:
    tokens and every store tensor bit for bit.  The state is put back after,
    so the scheduler goes on as if neither had run."""
    before, tok0 = serving_engine._clone(step.store), step.tok.clone()
    pos = step.store["pos"].tolist()
    step.graph.replay()
    got, got_tok = serving_engine._clone(step.store), step.tok.clone()
    serving_engine._write_back(step.store, before)
    step.tok.copy_(tok0)
    step.body()
    a, b = dict(serving_engine.tree_items(got)), dict(serving_engine.tree_items(step.store))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or not torch.equal(got_tok, step.tok):
        raise RuntimeError(f"{tag}: class-step replay and eager body differ at "
                           f"{differ[:4] or 'the tokens'}")
    serving_engine._write_back(step.store, before)
    step.tok.copy_(tok0)
    torch.cuda.synchronize()
    return dict(lane_positions=pos, replay_and_eager_bit_identical=True)


def _requests(vocab: int, lens, seed: int) -> list:
    g = _gen(seed)
    return [torch.randint(1, vocab, (n,), generator=g, device="cuda").tolist() for n in lens]


def scheduler_drain(path: dict, eng, card: str, classes, lens, chunk: int, seed: int,
                    new: int = GOODPUT["new"]) -> tuple[dict, dict]:
    """A drain of ``lens``-long requests through ``classes``: the class steps'
    launches per replay exact; mid-drain, once two lanes of a class sit at
    different positions, one replay against the eager body
    (`class_step_identity`); the drain's decode-kernel launches exactly its
    replays' (prefill runs W8A8 and retention only); every request's tokens
    in the vocabulary.  Returns the drain's launches and its report."""
    from repro_torch.serving import Request, RequestScheduler
    tag = f"{path['arch']} scheduler drain"
    cfg = eng.cfg
    gen = GenerationConfig(max_new_tokens=new)
    sched = RequestScheduler(eng, classes=list(classes), gen=gen, chunk_size=chunk, seed=0)
    check_class_steps(tag, sched, expected_launches(path)[1])
    for uid, p in enumerate(_requests(cfg.vocab_size, lens, seed)):
        sched.submit(Request(uid=uid, prompt=p))
    identity = None
    hopper.reset_launches()
    t0 = time.perf_counter()
    while sched.pending:
        sched.step()
        if identity is None:
            busy = [st for clen, st in sched.pool.steps.items()
                    if sum(1 for sl in sched._active if sched.pool.locate(sl)[0] == clen) == 2]
            if busy:
                launched = dict(hopper.LAUNCHES)
                identity = class_step_identity(tag, busy[0])
                hopper.LAUNCHES.update(launched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hopper.LAUNCHES)
    res = {f.uid: f for f in sched._finished}
    bad = [u for u, f in res.items() if len(f.tokens) != new
           or not _in_vocab(cfg, torch.tensor(f.tokens))]
    if len(res) != len(lens) or bad or identity is None:
        raise RuntimeError(f"{tag}: {len(res)} of {len(lens)} finished, bad {bad}, "
                           f"identity checked {identity is not None}")
    for k in DECODE_KERNELS:
        want = sum(st.replays * st.launches.get(k, 0) for st in sched.pool.steps.values())
        if launches[k] != want:
            raise RuntimeError(f"{tag}: {k} launched {launches[k]} times, the replays "
                               f"{want}")
    out = dict(card=card, classes=[list(c) for c in classes], prompt_lens=list(lens),
               chunk=chunk, launches=launches,
               replays={clen: st.replays for clen, st in sched.pool.steps.items()},
               replay_launches=sched.pool.steps[classes[0][1]].launches,
               class_step=identity, **scheduler_report(sched, wall))
    log(f"{tag}:", json.dumps(out))
    return launches, out


@torch.inference_mode()
def host_spill_run(path: dict, eng, card: str) -> dict:
    """An oversubscribed pool (one class of 2 lanes, host spill on): two
    residents decode; a spill and fetch of one of them round-trips its lane
    bit for bit; then a priority-1 arrival preempts a resident into the
    host tier, which resumes once a lane frees.  Every request's tokens
    must equal those of the same requests drained without preemption."""
    from repro_torch.serving import Request, RequestScheduler
    tag = f"{path['arch']} host spill"
    clen = GOODPUT["prompt_max"] + NEW
    reqs = _requests(eng.cfg.vocab_size, (10, 20, 14), 53)
    gen = GenerationConfig(max_new_tokens=NEW)

    def make():
        return RequestScheduler(eng, classes=[(2, clen)], gen=gen, chunk_size=GOODPUT["chunk"],
                                host_spill=True, seed=0)

    sched = make()
    for uid in (0, 1):
        sched.submit(Request(uid=uid, prompt=reqs[uid]))
    while sched.stats["emitted"] < 4:
        sched.step()
    slot = next(iter(sched._active))
    before = {k: v.clone()
              for k, v in serving_engine.tree_items(sched.pool.lane_cache(slot))}
    sched.pool.spill(slot)
    sched.pool.fetch(slot)
    after = dict(serving_engine.tree_items(sched.pool.lane_cache(slot)))
    if any(not torch.equal(before[k], after[k]) for k in before):
        raise RuntimeError(f"{tag}: a spill and fetch changed the lane's cache")
    sched.submit(Request(uid=2, prompt=reqs[2]), priority=1)
    got = {f.uid: f.tokens for f in sched.run().values()}
    plain = make()
    for uid, p in enumerate(reqs):
        plain.submit(Request(uid=uid, prompt=p))
    want = {f.uid: f.tokens for f in plain.run().values()}
    m = sched.obs.metrics
    out = dict(card=card, preempted=sched.stats["preempted"], resumed=sched.stats["resumed"],
               spills=sched.pool.spill_stats["spills"],
               bytes_to_host=sched.pool.spill_stats["bytes_to_host"],
               bytes_to_device=sched.pool.spill_stats["bytes_to_device"],
               lane_bytes=eng.cache_nbytes(clen),
               spill_ms=[x * 1e3 for x in m.histogram("pool.spill_s").samples],
               fetch_ms=[x * 1e3 for x in m.histogram("pool.fetch_s").samples],
               spill_fetch_bit_exact=True, token_identical_to_unpreempted=got == want)
    log(f"{tag}:", json.dumps(out))
    if got != want or sched.stats["preempted"] < 1 or sched.stats["resumed"] < 1:
        raise RuntimeError(f"{tag}: {out}; tokens {got} vs {want}")
    return out


def goodput_leg(path: dict, eng, card: str) -> dict:
    """The reference's `goodput_under_load` leg on the port, at full width
    (see GOODPUT): calibration, the three Poisson rates through the front
    end (each on a fresh scheduler, warmed by a closed drain and reset), and
    the front end against a direct run() on the same requests, token for
    token."""
    import asyncio

    from repro_torch.obs import Observability
    from repro_torch.serving import (FrontendConfig, LengthMix, MonotonicClock,
                                     PoissonArrivals, Request, RequestScheduler,
                                     ServingFrontend, Workload, run_open_loop)
    g = GOODPUT
    gen = GenerationConfig(max_new_tokens=g["new"])
    mix = LengthMix(prompt_min=g["prompt_min"], prompt_max=g["prompt_max"],
                    new_min=g["new"], new_max=g["new"])
    clen = g["prompt_max"] + g["new"]
    vocab = eng.cfg.vocab_size
    warm_wl = Workload(arrivals=PoissonArrivals(1.0), lengths=mix, n_requests=g["requests"],
                       vocab_size=vocab, seed=29)

    def make_sched(obs, clock):
        return RequestScheduler(eng, classes=[(g["lanes"], clen)], gen=gen,
                                chunk_size=g["chunk"], seed=0, obs=obs, clock=clock.now)

    def closed_drain(sched, uid_base):
        for i, r in enumerate(warm_wl.requests()):
            sched.submit(Request(uid=uid_base + i, prompt=list(r.prompt),
                                 max_new_tokens=r.max_new_tokens))
        return sched.run()

    obs, clock = Observability(), MonotonicClock()
    sched = make_sched(obs, clock)
    check_class_steps(f"{path['arch']} goodput", sched, expected_launches(path)[1])
    closed_drain(sched, 5000)
    obs.metrics.reset()
    t0 = time.perf_counter()
    closed_drain(sched, 6000)
    torch.cuda.synchronize()
    calib_wall = max(time.perf_counter() - t0, 1e-6)
    base_rate = g["requests"] / calib_wall
    calib = scheduler_report(sched, calib_wall)
    slo_s = max(2.0 * calib["ttft_s"].get("p50", 0.05), 0.02)
    cfg = FrontendConfig(ttft_slo_s=slo_s, slo_window_s=max(4 * calib_wall, 1.0),
                         min_slo_samples=4, guaranteed_admit=g["lanes"])
    del sched
    rates = []
    for mult in g["rate_mults"]:
        leg_obs, leg_clock = Observability(), MonotonicClock()
        leg = make_sched(leg_obs, leg_clock)
        closed_drain(leg, 7000)
        leg_obs.metrics.reset()
        frontend = ServingFrontend(leg, config=cfg, clock=leg_clock)
        workload = Workload(arrivals=PoissonArrivals(base_rate * mult), lengths=mix,
                            n_requests=g["requests"], vocab_size=vocab, seed=13)

        async def drive(frontend=frontend, workload=workload):
            async with frontend:
                return await run_open_loop(frontend, workload)

        report = leg_clock.run(drive())
        if report.goodput_rps <= 0 or report.sheds_unexplained:
            raise RuntimeError(f"goodput leg at {mult}x: {report.to_dict()}")
        rates.append(dict(rate_mult=mult, **report.to_dict(),
                          scheduler=scheduler_report(leg, report.elapsed_s)))
        log(f"goodput at {mult} x {base_rate:.3f} req/s:", json.dumps(rates[-1]))
        del leg, frontend

    fe_sched = make_sched(Observability(), MonotonicClock())
    fe_clock = MonotonicClock(fe_sched._now)
    frontend = ServingFrontend(fe_sched, config=FrontendConfig(ttft_slo_s=slo_s,
                                                               shed_action="off"),
                               clock=fe_clock)
    id_requests = Workload(arrivals=PoissonArrivals(base_rate), lengths=mix,
                           n_requests=g["requests"], vocab_size=vocab, seed=17).requests()

    async def drive_identity() -> dict:
        tokens: dict = {}

        async def consume(stream):
            tokens[stream.uid] = [tok async for tok in stream]

        async with frontend:
            tasks, t0 = [], fe_clock.now()
            for r in id_requests:
                await fe_clock.sleep(t0 + r.at_s - fe_clock.now())
                stream = frontend.submit(r.prompt, uid=r.uid, max_new_tokens=r.max_new_tokens)
                tasks.append(asyncio.ensure_future(consume(stream)))
            await asyncio.gather(*tasks)
        return tokens

    fe_tokens = fe_clock.run(drive_identity())
    direct = make_sched(Observability(), MonotonicClock())
    for r in id_requests:
        direct.submit(Request(uid=r.uid, prompt=list(r.prompt),
                              max_new_tokens=r.max_new_tokens))
    want = {u: f.tokens for u, f in direct.run().items()}
    identical = fe_tokens == want
    out = dict(arch=path["arch"], card=card, n_requests=g["requests"],
               device_lanes=g["lanes"], arrival="poisson", calibrated_service_rps=base_rate,
               ttft_slo_s=slo_s, calibration=calib, rates=rates,
               token_identical_vs_run=identical)
    log("goodput_under_load (rates above):",
        json.dumps({k: v for k, v in out.items() if k != "rates"}))
    if not identical:
        raise RuntimeError(f"goodput leg: the front end's tokens {fe_tokens} differ from "
                           f"a direct run()'s {want}")
    return out


def serve_scheduler(path: dict, eng, card: str) -> tuple[dict, dict]:
    """The scheduler phase of one main path at full width (see GOODPUT):
    retnet-1.3b serves the goodput leg and the host-spill run, each path
    one drain of mixed lengths through two classes (its per-lane kv_len
    through flash-decode on the dense paths).  Returns the drain's
    launches and the results."""
    t0 = time.perf_counter()
    arch = path["arch"]
    log(f"== scheduler: {arch}, classes {DRAIN_CLASSES}, prompts {DRAIN_LENS}, "
        f"chunks of {DRAIN_CHUNK}" + (", then the goodput leg and the host spill"
                                      if path is RETNET else ""))
    launches, drain = scheduler_drain(path, eng, card, DRAIN_CLASSES, DRAIN_LENS,
                                      DRAIN_CHUNK, seed=47)
    results = {f"{arch} scheduler drain": drain}
    if path is RETNET:
        results["goodput_under_load"] = goodput_leg(path, eng, card)
        results[f"{arch} host spill"] = host_spill_run(path, eng, card)
    log(f"{arch} scheduler phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches, results


# The prefix phase (the shared-prefix cache, `serving/paging.py`).  (a) The
# `prefix_reuse` leg of the reference's serving bench
# (benchmarks/bench_serving.py: a 96-token system prompt + 8 unique tokens,
# 8 requests, 8 new tokens, one class of 2 lanes at C 112, chunks of 8 (4
# requests in chunks of 16 here, a depth cut: PERF.md section 4); a
# disjoint warm-up stream, then one stream at each shared fraction, and at 1.0
# the same stream cold) on qwen3-8b's f32 cache; (b) warm against cold in
# every (path, cache format) cell on the reference test's shape (a 32-token
# base alone, then 3 extensions of 8; chunks of 16; one class of 2 lanes).
PREFIX_LEG = dict(shared=96, suffix=8, requests=4, new=8, lanes=2, chunk=16,
                  fractions=(0.0, 0.5, 1.0))
PREFIX_CELL = dict(base=32, ext=8, n_ext=3, chunk=16, lanes=2, new=8)


def _held(pc, node) -> dict:
    """A page's rows (or a snapshot's cache), wherever it resides."""
    if pc.mode == "paged":
        return node.rows if node.rows is not None else node.host_rows
    return node.cache if node.cache is not None else node.host_cache


def _trees_equal(a, b) -> bool:
    ia, ib = list(serving_engine.tree_items(a)), list(serving_engine.tree_items(b))
    return [p for p, _ in ia] == [p for p, _ in ib] and all(
        x.dtype == y.dtype and torch.equal(x, y) for (_, x), (_, y) in zip(ia, ib))


def _watched(pc) -> tuple[dict, dict]:
    """Wrap a `PrefixCache`'s lookup and register: every page (or snapshot)
    is copied as it is registered, and each call's host ms (between
    synchronizes) recorded.  Returns (copies, times)."""
    copies, times = {}, dict(lookup_ms=[], register_ms=[])
    lookup, register = pc.lookup, pc.register

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    def watched_register(*args, **kw):
        n = timed("register_ms", register, *args, **kw)
        for node in pc._index.nodes():
            if node not in copies:
                copies[node] = serving_engine._clone(_held(pc, node))
        return n

    pc.lookup = lambda *a, **kw: timed("lookup_ms", lookup, *a, **kw)
    pc.register = watched_register
    return copies, times


def _chunk_launches(path, sizes) -> dict:
    """Launches of chunked prefills whose chunks have ``sizes`` tokens."""
    out = dict.fromkeys(hopper.COUNTERS, 0)
    for c in sizes:
        for k, v in expected_launches(path, c)[0].items():
            out[k] += v
    return out


@torch.inference_mode()
def prefix_cell(path: dict, eng, fmt, card: str) -> tuple[dict, dict]:
    """(b) One (path, cache format) cell: the base prompt alone, then its 3
    extensions, drained cold and then warm (prefix cache on) through one
    class of 2 lanes.  Fatal: warm tokens equal cold ones; 3 adoptions of
    the 32-token base; every page's (or snapshot's) bytes after the drain
    equal its bytes at registration; no lease held; the warm drain's
    launches exact (its chunks: the base's 2 x 16 and one 8-token suffix
    per extension; its decode launches its replays'); each class step's
    launches per replay exact.  Recorded: chunks, wall, TTFT cold and warm,
    page bytes, lookup / register ms, and one page's spill and fetch ms."""
    from repro_torch.serving import Request, RequestScheduler
    c = PREFIX_CELL
    tag = f"{path['arch']} prefix" + ("" if fmt is None else f" {fmt}")
    vocab = eng.cfg.vocab_size
    g = _gen(61)
    base = torch.randint(1, vocab, (c["base"],), generator=g, device="cuda").tolist()
    reqs = [base] + [base + torch.randint(1, vocab, (c["ext"],), generator=g,
                                          device="cuda").tolist() for _ in range(c["n_ext"])]
    clen = c["base"] + c["ext"] + c["new"]
    gen = GenerationConfig(max_new_tokens=c["new"], cache_format=fmt)
    want_step = expected_launches(path)[1]

    def drain(prefix_cache: bool):
        sched = RequestScheduler(eng, classes=[(c["lanes"], clen)], gen=gen,
                                 chunk_size=c["chunk"], prefix_cache=prefix_cache, seed=0)
        check_class_steps(tag, sched, want_step)
        watch = _watched(sched.pool.prefix) if prefix_cache else ({}, {})
        for uid, p in enumerate(reqs):
            sched.submit(Request(uid=uid, prompt=p))
        hopper.reset_launches()
        t0 = time.perf_counter()
        res = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {u: f.tokens for u, f in res.items()}, sched, dict(hopper.LAUNCHES), watch, wall

    cold, cold_sched, _, _, cold_wall = drain(False)
    warm, sched, launches, (copies, times), wall = drain(True)
    pc = sched.pool.prefix
    stats = dict(pc.stats)
    step = sched.pool.steps[clen]
    sizes = chunk_schedule(c["base"], c["chunk"]) + c["n_ext"] * chunk_schedule(
        c["ext"], c["chunk"])
    want = _chunk_launches(path, sizes)
    for k in hopper.COUNTERS:
        want[k] += step.replays * step.launches.get(k, 0)
    unchanged = all(_trees_equal(_held(pc, n), copy) for n, copy in copies.items())
    held = pc.leased_slots or any(n.refs for n in pc._index.nodes())
    out = dict(card=card, mode=pc.mode, class_len=clen, chunk=c["chunk"],
               prompt_lens=[len(p) for p in reqs], stats=stats, n_pages=pc.n_pages,
               page_nbytes=sorted({n.nbytes for n in pc._index.nodes()}),
               prefix_bytes=pc.prefix_bytes, launches=launches, replays=step.replays,
               prefill_chunks=dict(cold=cold_sched.stats["prefill_chunks"],
                                   warm=sched.stats["prefill_chunks"]),
               wall_s=dict(cold=cold_wall, warm=wall),
               ttft_s=dict(cold=_summary(cold_sched.obs, "sched.ttft_s"),
                           warm=_summary(sched.obs, "sched.ttft_s")),
               **times, token_identical_vs_cold=warm == cold, pages_unchanged=unchanged,
               pages_checked=len(copies), leases_held=bool(held))
    if (warm != cold or not unchanged or held or not copies or launches != want
            or (stats["prefix_hits"], stats["prefix_hit_tokens"]) != (3, 3 * c["base"])):
        raise RuntimeError(f"{tag}: {json.dumps(out)}; launches expected {want}; "
                           f"tokens {warm} vs cold {cold}")
    # One page's (or the snapshot's) round trip through the host tier.
    node = pc._index.nodes()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = pc._spill(_held(pc, node))
    t1 = time.perf_counter()
    back = pc._fetch(host)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not _trees_equal(back, copies[node]):
        raise RuntimeError(f"{tag}: a page's spill and fetch changed its bytes")
    out.update(page_spill_ms=(t1 - t0) * 1e3, page_fetch_ms=(t2 - t1) * 1e3,
               spilled_page_nbytes=node.nbytes)
    log(f"{tag}:", json.dumps(out))
    return launches, out


@torch.inference_mode()
def prefix_reuse_leg(path: dict, eng, card: str) -> tuple[dict, dict]:
    """(a) The reference's `prefix_reuse` leg at full width (see PREFIX_LEG),
    one stream per shared fraction.  Each drain is a fresh scheduler warmed
    by one disjoint request (its pages never match; the whole disjoint
    stream before the SSM paths came: PERF.md), its registry reset after.
    Fatal: at 1.0, all admissions but the first adopt the 96 shared tokens
    (3 of 4: 288 prefill tokens skipped) and the greedy tokens equal the same stream's
    without the prefix cache; every drain's decode launches are its
    replays'.  Recorded per fraction: hit rate, tokens skipped, prefill
    chunks, COW copies, pages inserted, TTFT p50 / p99, wall; at 1.0 the
    cold TTFT and the TTFT p50 delta warm - cold."""
    from repro_torch.obs import Observability
    from repro_torch.serving import Request, RequestScheduler
    L = PREFIX_LEG
    vocab = eng.cfg.vocab_size
    clen = L["shared"] + L["suffix"] + L["new"]
    gen = GenerationConfig(max_new_tokens=L["new"])

    def prompts_for(frac: float, base: int) -> list:
        g = _gen(base)
        shared = torch.randint(1, vocab, (L["shared"],), generator=g, device="cuda").tolist()
        n_shared = round(L["requests"] * frac)
        out = []
        for uid in range(L["requests"]):
            own = torch.randint(1, vocab, (L["shared"],), generator=g, device="cuda").tolist()
            tail = torch.randint(1, vocab, (L["suffix"],), generator=g, device="cuda").tolist()
            out.append((shared if uid < n_shared else own) + tail)
        return out

    counted = dict.fromkeys(hopper.COUNTERS, 0)

    def drain(frac: float, prefix_cache: bool):
        obs = Observability()
        sched = RequestScheduler(eng, classes=[(L["lanes"], clen)], gen=gen,
                                 chunk_size=L["chunk"], prefix_cache=prefix_cache, obs=obs,
                                 seed=0)
        for uid, p in enumerate(prompts_for(1.0, base=41)[:1]):
            sched.submit(Request(uid=1000 + uid, prompt=p))
        sched.run()
        obs.metrics.reset()
        step = sched.pool.steps[clen]
        replays0 = step.replays
        for uid, p in enumerate(prompts_for(frac, base=11)):
            sched.submit(Request(uid=uid, prompt=p))
        hopper.reset_launches()
        t0 = time.perf_counter()
        res = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(hopper.LAUNCHES)
        for k in DECODE_KERNELS:
            if launches[k] != (step.replays - replays0) * step.launches.get(k, 0):
                raise RuntimeError(f"prefix_reuse at {frac}: {k} launched {launches[k]} "
                                   f"times in {step.replays - replays0} replays")
        if prefix_cache:
            for k in counted:
                counted[k] += launches[k]
        return {u: f.tokens for u, f in res.items()}, sched, obs, wall

    total = L["requests"] * (L["shared"] + L["suffix"])
    legs = {}
    for frac in L["fractions"]:
        tokens, sched, obs, wall = drain(frac, True)
        st = dict(sched.pool.prefix.stats)
        leg = dict(card=card, shared_fraction=frac, n_requests=L["requests"], reps=1,
                   wall_s=wall, prefix_lookups=st["prefix_lookups"],
                   prefix_hits=st["prefix_hits"],
                   hit_rate=st["prefix_hits"] / max(st["prefix_lookups"], 1),
                   prefill_tokens_total=total, prefill_tokens_skipped=st["prefix_hit_tokens"],
                   prefill_token_reduction=st["prefix_hit_tokens"] / total,
                   prefill_chunks=sched.stats["prefill_chunks"], cow_copies=st["cow_copies"],
                   pages_inserted=st["prefix_insert_pages"],
                   ttft_s=_summary(obs, "sched.ttft_s"),
                   inter_token_s=_summary(obs, "sched.inter_token_s"))
        if frac == 1.0:
            cold, cold_sched, cold_obs, cold_wall = drain(1.0, False)
            cold_ttft = _summary(cold_obs, "sched.ttft_s")
            leg.update(token_identical_vs_cold=tokens == cold, cold_wall_s=cold_wall,
                       cold_prefill_chunks=cold_sched.stats["prefill_chunks"],
                       cold_ttft_s=cold_ttft,
                       ttft_p50_delta_s=leg["ttft_s"]["p50"] - cold_ttft["p50"])
            if (tokens != cold or st["prefix_hits"] != L["requests"] - 1
                    or st["prefix_hit_tokens"] != (L["requests"] - 1) * L["shared"]):
                raise RuntimeError(f"prefix_reuse at 1.0: {json.dumps(leg)}")
        log(f"prefix_reuse shared {frac}:", json.dumps(leg))
        legs[f"shared_{int(frac * 100)}"] = leg
    return counted, legs


def serve_prefix(path: dict, eng, card: str) -> tuple[dict, dict]:
    """The prefix phase of one main path at full width (see PREFIX_CELL and
    PREFIX_LEG): (b) in each of the path's cache formats, then on qwen3-8b
    (a).  Returns the warm drains' launches and the results."""
    t0 = time.perf_counter()
    arch = path["arch"]
    log(f"== prefix cache: {arch}, a {PREFIX_CELL['base']}-token base then "
        f"{PREFIX_CELL['n_ext']} extensions of {PREFIX_CELL['ext']}, cache formats "
        f"{[f or 'f32' for f in phase_formats(path)]}"
        + (", then the prefix_reuse leg" if path is QWEN3 else ""))
    launches, results = dict.fromkeys(hopper.COUNTERS, 0), {}
    for fmt in phase_formats(path):
        t_cell = time.perf_counter()
        counted, out = prefix_cell(path, eng, fmt, card)
        out["cell_s"] = time.perf_counter() - t_cell
        results[f"{arch} prefix" + ("" if fmt is None else f" {fmt}")] = out
        for k in launches:
            launches[k] += counted[k]
    if path is QWEN3:
        counted, results["prefix_reuse"] = prefix_reuse_leg(path, eng, card)
        for k in launches:
            launches[k] += counted[k]
    log(f"{arch} prefix phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches, results


# The speculative phase.  (a) `generate` with speculative decode in every
# (path, cache format) cell: 2 prompts of PROMPT tokens (one seeded, one the
# reference test's [5, 9, 13] tiled), SPEC_NEW tokens, k SPEC_K, in the default
# deployment (verify reads the W8A8 weights, decode the MXINT4 ones).  (b)
# The phase-6 drain's requests through the scheduler in speculative mode,
# each class reserving k slots for the verify overrun.
SPEC_CLASSES = tuple((n, c + SPEC_K) for n, c in DRAIN_CLASSES)


def mtp_step_launches(path: dict) -> dict:
    """Launches of one MTP head step (`lm.mtp_decode_step`): every linear of
    ``path["head"]`` and the LM head through MXINT4, the routed experts'
    GEMV three times."""
    head = path["head"]
    per = dict.fromkeys(hopper.COUNTERS, 0)
    per["mxint4_matmul"] = sum(c for _, _, c in head["linears"]) + 1
    per["mxint4_expert_matmul"] = 3
    return per


def spec_step_launches(path: dict) -> dict:
    """Launches of one verify step: W8A8, those of one admission chunk
    (every linear, MLA's whole-latent re-expansion and the LM head), and a
    MoE layer's expert GEMV three times, as in decode (the verify dispatch
    never dequantizes a stack); retention runs the recurrent form with
    snapshots.  With the MTP drafter (``head``), SPEC_K head steps'
    launches besides (`mtp_step_launches`)."""
    per = dict.fromkeys(hopper.COUNTERS, 0)
    per["w8a8_matmul"] = expected_launches(path, SPEC_K + 1)[0]["w8a8_matmul"]
    per["mxint4_expert_matmul"] = expected_launches(path)[1]["mxint4_expert_matmul"]
    if "head" in path:
        for name, n in mtp_step_launches(path).items():
            per[name] += SPEC_K * n
    return per


def spec_prompts(vocab: int) -> torch.Tensor:
    """[2, PROMPT]: a seeded random prompt and the periodic one."""
    row = torch.randint(1, vocab, (PROMPT,), generator=_gen(71), device="cuda")
    periodic = torch.tensor([5, 9, 13], device="cuda").repeat(PROMPT // 3 + 1)[:PROMPT]
    return torch.stack([row, periodic])


def _spec_start(eng, prompts, gen):
    """The prefill `generate` runs before its speculative loop: (first
    pending token, encoded cache, history, the last prompt token's hidden)."""
    logits, cache, hist, hidden = eng._spec_prefill(prompts, gen)
    return sample(logits, gen.sampling), cache, hist, hidden


@torch.inference_mode()
def verify_lockstep(eng, plain, prompts, gen) -> dict:
    """One verify block, kernel path against plain path on the same weights,
    in lockstep from the kernel path's prefilled cache (cloned for each
    path: the verify writes dense rows in place): each block gets the plain
    path's input, and its output, every tensor of its verified cache (the
    RetNet snapshots included), its cache committed at the block's
    acceptance (1 for a full rejection) and the logits at all k + 1
    positions must agree within BLOCK_TOL of max|value|.  Two blocks: the
    drafter's own drafts (the ngram drafter's, or the MTP head's on the
    kernel path), and drafts chosen to miss the argmax (a forced full
    rejection, checked on the plain path's logits)."""
    from repro_torch.serving.speculative import make_drafter
    cfg, model, k = eng.cfg, eng.model, SPEC_K
    tok, cache, hist, hidden = _spec_start(eng, prompts, gen)
    drafter = make_drafter(gen.speculative, cfg, eng.hsa)
    drafts = drafter.draft(model, drafter.init(
        hist, torch.tensor(prompts.shape[1], device="cuda"), hidden.clone()), tok)
    bad = (tok[:, None] + torch.arange(1, k + 1, device="cuda")) % cfg.vocab_size
    pos = cache["pos"]
    sin, cos = lm._rope_tables(cfg, k + 1, pos.device, start=pos)
    out = {}
    for name, block in (("drafts", torch.cat([tok[:, None], drafts], 1)),
                        ("rejected", torch.cat([tok[:, None], bad], 1))):
        worst = dict(block=0.0, cache=0.0, committed=0.0, logits=0.0)
        x = lm._embed(model, block, cfg, start=pos)
        for i, (blk, cl) in enumerate(zip(model.blocks, cache["blocks"])):
            yk, ck = lm._block_chunk(blk, x, cfg, eng.hsa, _clone(cl), pos, sin, cos, True)
            yr, cr = lm._block_chunk(blk, x, cfg, plain.hsa, _clone(cl), pos, sin, cos, True)
            tag = f"verify {name} block {i}"
            worst["block"] = max(worst["block"], _rel(yk, yr, tag, BLOCK_TOL))
            worst["cache"] = max(worst["cache"], _cache_rel(tag, ck, cr, BLOCK_TOL))
            if name == "rejected":
                one = torch.ones((), dtype=torch.int32, device="cuda")
                kc, rc = (lm.commit_verified_cache({"pos": pos}, {"blocks": [c]}, one, k + 1,
                                                   cfg)["blocks"][0] for c in (ck, cr))
                worst["committed"] = max(worst["committed"],
                                         _cache_rel(f"{tag} committed", kc, rc, BLOCK_TOL))
            x = yr.to(x.dtype)
        h = layers.norm_full(model.final_norm, x)
        lk = eng.hsa.linear(model.lm_head, h, "prefill")
        lr = plain.hsa.linear(model.lm_head, h, "prefill")
        worst["logits"] = max(worst["logits"], _rel(lk, lr, f"verify {name} logits",
                                                    BLOCK_TOL))
        if name == "rejected" and bool((lr[:, 0].argmax(-1) == bad[:, 0]).any()):
            raise RuntimeError("verify lockstep: the forced rejection's draft is the argmax")
        out[name] = worst
    return dict(verify_lockstep=out, lockstep_tolerance=BLOCK_TOL)


@torch.inference_mode()
def _margin_at(eng, prompts, plain_tokens, col: int, rows) -> list:
    """The plain loop's top-two logit margin at token column ``col`` of
    ``rows`` (its logits from prefill or from the eager decode steps)."""
    logits, cache = eng.prefill(prompts, cache_len=prompts.shape[1] + NEW)
    for j in range(col):
        logits, cache = eng.decode_step(plain_tokens[:, j:j + 1], cache)
    top = logits.float().topk(2, dim=-1).values
    return [(top[r, 0] - top[r, 1]).item() for r in rows]


@torch.inference_mode()
def speculative_cell(path: dict, eng, plain, fmt, card: str) -> tuple[dict, dict]:
    """(a) One (path, cache format) cell.  Fatal: the graph's loop against
    the eager loop from the same prefill (tokens, lengths, verify steps,
    accepted drafts, history and final cache bit for bit); the captured
    verify step's launches (W8A8 only, `spec_step_launches`) and the counted
    generate's (its prefill's and its replays'); the lockstep comparison
    with the plain path (`verify_lockstep`).  Recorded: tokens per step,
    acceptance, one replay's device ms, the host read of the loop's
    condition, ms per emitted token against one plain graph loop beside the
    counted run (in turns, plain, plain, speculative, before a depth
    cut), capture seconds, and where the speculative tokens first
    part from the plain loop's with the plain loop's top-two margin there.
    The drafter is ``path["drafter"]`` (the ngram drafter by default)."""
    from repro_torch.serving.sampling import SpeculativeConfig
    tag = f"{path['arch']} speculative" + ("" if fmt is None else f" {fmt}")
    cfg = eng.cfg
    prompts = spec_prompts(cfg.vocab_size)
    gen = GenerationConfig(max_new_tokens=SPEC_NEW, cache_format=fmt,
                           speculative=SpeculativeConfig(
                               k=SPEC_K, drafter=path.get("drafter", "ngram")))
    plain_gen = dataclasses.replace(gen, speculative=None)
    want_p, want_step = expected_launches(path)[0], spec_step_launches(path)
    first = eng.generate(prompts, gen)
    tok, cache, hist, hidden = _spec_start(eng, prompts, gen)
    sg = eng._graphs[eng.spec_graph_key(cache, hist.shape[1], gen)]
    if sg.launches != want_step:
        raise RuntimeError(f"{tag}: a verify replay launches {sg.launches}, expected "
                           f"{want_step}")
    hopper.reset_launches()
    res = eng.generate(prompts, gen)
    launches = dict(hopper.LAUNCHES)
    want = {n: want_p[n] + want_step[n] * res.verify_steps for n in hopper.COUNTERS}
    if launches != want or res.capture_s or not torch.equal(res.tokens, first.tokens):
        raise RuntimeError(f"{tag}: launches {launches}, expected {want} (capture "
                           f"{res.capture_s} s)")
    st, _ = eng._spec_loop(tok, cache, hist, prompts.shape[1], hidden, gen, None, graph=False)
    g = sg.state
    same = (torch.equal(res.tokens, st.out[:, :SPEC_NEW]) and torch.equal(res.lengths, st.lengths)
            and (res.verify_steps, res.accepted_drafts) == (int(st.steps), int(st.accepted))
            and torch.equal(g.hist, st.hist) and torch.equal(g.hist_len, st.hist_len)
            and torch.equal(g.h, st.h))
    a, b = dict(serving_engine.tree_items(g.cache)), dict(serving_engine.tree_items(st.cache))
    differ = [key for key in a if not torch.equal(a[key], b[key])]
    if not same or differ:
        raise RuntimeError(f"{tag}: graph and eager loops differ ({differ[:4]})")
    del st, cache, hidden
    toks = res.tokens
    if toks.shape != (BATCH, SPEC_NEW) or not _in_vocab(cfg, toks):
        raise RuntimeError(f"{tag}: bad tokens {toks.shape}")

    # One replay between CUDA events (the state is reset by the next run),
    # and the host's read of the loop's condition after a replay.
    replay_ms, read_ms = [], []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        sg.graph.replay()
        e1.record()
        torch.cuda.synchronize()
        replay_ms.append(e0.elapsed_time(e1))
        t0 = time.perf_counter()
        bool(g.more)
        read_ms.append((time.perf_counter() - t0) * 1e3)
    runs = dict(speculative=[res], plain=[eng.generate(prompts, plain_gen)])
    # A run that captured its graph (the first plain one: SPEC_NEW tokens is
    # a new key) is timed without the capture.
    per_tok = {kind: [(r.decode_s - r.capture_s) * 1e3 / SPEC_NEW for r in rs]
               for kind, rs in runs.items()}
    plain_toks = runs["plain"][0].tokens
    col = _parting(toks, plain_toks)
    out = dict(card=card, k=SPEC_K, verify_steps=res.verify_steps,
               accepted_drafts=res.accepted_drafts, tokens_per_step=res.tokens_per_step,
               acceptance_rate=res.acceptance_rate, launches=launches,
               replay_launches=sg.launches, capture_s=first.capture_s,
               verify_step_device_ms=sorted(replay_ms)[2], verify_step_device_ms_runs=replay_ms,
               host_read_ms=sorted(read_ms)[2],
               loop_ms_per_verify_step=res.decode_s * 1e3 / res.verify_steps,
               ms_per_token_in_turns=per_tok,
               ms_per_token=sum(per_tok["speculative"]) / len(per_tok["speculative"]),
               plain_ms_per_token=sum(per_tok["plain"]) / len(per_tok["plain"]),
               graph_and_eager_bit_identical=True, first_parting_from_plain=col)
    if col is not None:
        rows = (toks[:, col] != plain_toks[:, col]).nonzero()[:, 0].tolist()
        out.update(parting_rows=rows,
                   plain_top2_margin_at_parting=_margin_at(eng, prompts, plain_toks, col, rows))
    out.update(verify_lockstep(eng, plain, prompts, gen))
    log(f"{tag}:", json.dumps(out))
    return launches, out


@torch.inference_mode()
def spec_class_step_identity(tag, step) -> dict:
    """One replay of a speculative class step against its eager body from the
    same state (blocks, counts, tokens, histories and every store tensor bit
    for bit), and lane isolation: lane 0's block, count, token, history and
    store rows bit-identical whether lane 1 holds its request or a free
    lane's garbage.  The state is put back after each run."""
    bufs = (step.tok, step.fed, step.hist, step.hist_len, step.result)
    before = serving_engine._clone(step.store), [t.clone() for t in bufs]

    def restore():
        serving_engine._write_back(step.store, before[0])
        for t, b in zip(bufs, before[1]):
            t.copy_(b)

    def lane0():
        return ([t[0].clone() for t in bufs]
                + [t[0].clone() for _, t in serving_engine.tree_items(step.store)])

    pos = step.store["pos"].tolist()
    step.graph.replay()
    got, got_bufs, got0 = serving_engine._clone(step.store), [t.clone() for t in bufs], lane0()
    restore()
    step.body()
    a, b = dict(serving_engine.tree_items(got)), dict(serving_engine.tree_items(step.store))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ or not all(torch.equal(x, y) for x, y in zip(got_bufs, bufs)):
        raise RuntimeError(f"{tag}: speculative class-step replay and eager body differ at "
                           f"{differ[:4] or 'the buffers'}")
    restore()
    g = _gen(83)
    for _, t in serving_engine.tree_items(step.store):
        t[1] = (torch.randn(t[1].shape, generator=g, device="cuda").to(t.dtype) * 7
                if t.dtype.is_floating_point else
                torch.randint(-50, 2000, t[1].shape, generator=g, device="cuda").to(t.dtype))
    step.tok[1], step.hist_len[1] = 3, 10 ** 6
    step.hist[1].random_(0, 5, generator=g)
    step.graph.replay()
    alone = lane0()
    restore()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got0, alone)):
        raise RuntimeError(f"{tag}: lane 0's outputs depend on lane 1's contents")
    return dict(lane_positions=pos, replay_and_eager_bit_identical=True,
                lane_isolation_bit_identical=True, lane0_committed=int(got0[4][-1]))


def spec_scheduler_drain(path: dict, eng, card: str) -> tuple[dict, dict]:
    """(b) The phase-6 drain's requests through the scheduler in speculative
    mode (classes `SPEC_CLASSES`, chunks of DRAIN_CHUNK).  Fatal: each class
    step's launches per replay (`spec_step_launches`); mid-drain, once two
    lanes of a class are busy, one replay against the eager body and lane
    isolation (`spec_class_step_identity`); the drain's launches exactly its
    chunks' and its replays'; every request's tokens in the vocabulary.
    Recorded: tokens per verify step and acceptance per request."""
    from repro_torch.serving import Request, RequestScheduler
    from repro_torch.serving.sampling import SpeculativeConfig
    tag = f"{path['arch']} speculative scheduler"
    cfg, new = eng.cfg, GOODPUT["new"]
    gen = GenerationConfig(max_new_tokens=new, speculative=SpeculativeConfig(k=SPEC_K))
    sched = RequestScheduler(eng, classes=list(SPEC_CLASSES), gen=gen, chunk_size=DRAIN_CHUNK,
                             seed=0)
    check_class_steps(tag, sched, spec_step_launches(path))
    reqs = _requests(cfg.vocab_size, DRAIN_LENS, 47)
    for uid, p in enumerate(reqs):
        sched.submit(Request(uid=uid, prompt=p))
    identity = None
    hopper.reset_launches()
    t0 = time.perf_counter()
    while sched.pending:
        sched.step()
        if identity is None:
            busy = [st for clen, st in sched.pool.steps.items()
                    if sum(1 for sl in sched._active if sched.pool.locate(sl)[0] == clen) == 2]
            if busy:
                launched = dict(hopper.LAUNCHES)
                identity = spec_class_step_identity(tag, busy[0])
                hopper.LAUNCHES.update(launched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(hopper.LAUNCHES)
    res = {f.uid: f for f in sched._finished}
    bad = [u for u, f in res.items() if len(f.tokens) != new
           or not _in_vocab(cfg, torch.tensor(f.tokens))]
    if len(res) != len(reqs) or bad or identity is None:
        raise RuntimeError(f"{tag}: {len(res)} of {len(reqs)} finished, bad {bad}, "
                           f"identity checked {identity is not None}")
    want = _chunk_launches(path, [c for p in reqs for c in chunk_schedule(len(p), DRAIN_CHUNK)])
    for k in ("w8a8_matmul", "mxint4_expert_matmul"):
        want[k] += sum(st.replays * st.launches[k] for st in sched.pool.steps.values())
    if launches != want:
        raise RuntimeError(f"{tag}: launches {launches}, expected {want} (chunks and replays)")
    out = dict(card=card, classes=[list(c) for c in SPEC_CLASSES], prompt_lens=list(DRAIN_LENS),
               chunk=DRAIN_CHUNK, k=SPEC_K, launches=launches,
               replays={clen: st.replays for clen, st in sched.pool.steps.items()},
               replay_launches=sched.pool.steps[SPEC_CLASSES[0][1]].launches,
               class_step=identity,
               per_request={u: dict(tokens_per_step=f.tokens_per_step,
                                    acceptance=f.accepted_drafts / (SPEC_K * f.verify_steps),
                                    verify_steps=f.verify_steps) for u, f in sorted(res.items())},
               verify_steps=sched.stats["verify_steps"],
               accepted_drafts=sched.stats["accepted_drafts"],
               **scheduler_report(sched, wall))
    log(f"{tag}:", json.dumps(out))
    return launches, out


def serve_speculative(path: dict, eng, plain, card: str) -> tuple[dict, dict]:
    """The speculative phase of one main path at full width: (a) in each of
    its cache formats, then (b).  Returns the counted launches and the
    results."""
    t0 = time.perf_counter()
    arch = path["arch"]
    log(f"== speculative decode: {arch}, k {SPEC_K}, B={BATCH}, S={PROMPT} (one seeded, one "
        f"periodic prompt), {SPEC_NEW} tokens, C {SPEC_CACHE}, cache formats "
        f"{[f or 'f32' for f in phase_formats(path)]}; then the scheduler drain in "
        f"speculative mode, classes {SPEC_CLASSES}")
    launches, results = dict.fromkeys(hopper.COUNTERS, 0), {}
    for fmt in phase_formats(path):
        t_cell = time.perf_counter()
        counted, out = speculative_cell(path, eng, plain, fmt, card)
        out["cell_s"] = time.perf_counter() - t_cell
        results[f"{arch} speculative" + ("" if fmt is None else f" {fmt}")] = out
        for k in launches:
            launches[k] += counted[k]
    counted, results[f"{arch} speculative scheduler"] = spec_scheduler_drain(path, eng, card)
    for k in launches:
        launches[k] += counted[k]
    log(f"{arch} speculative phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches, results


@torch.inference_mode()
def mtp_head_checks(path: dict, eng, plain) -> dict:
    """The MTP head on its own, from the prefill of the speculative cell's
    prompts: one `lm.mtp_decode_step` on the kernel path against the plain
    path (``kernel_impl="ref"``) on the same ``(h, tok)`` (the last prompt
    token's hidden and the first pending token), the head's hidden within
    DECODE_BLOCK_TOL and its logits within DECODE_TOL of max|value|, the
    tokens the two routers send to different experts counted; the k chained
    head steps captured alone as a graph (launches exactly SPEC_K head
    steps', its drafts equal to the eager chain's), timed between CUDA
    events beside one verify replay (the head's share of it); the drafts of
    the kernel and the plain chain compared (recorded)."""
    from repro_torch.serving.sampling import SpeculativeConfig
    from repro_torch.serving.speculative import make_drafter
    cfg, model = eng.cfg, eng.model
    prompts = spec_prompts(cfg.vocab_size)
    gen = GenerationConfig(max_new_tokens=SPEC_NEW,
                           speculative=SpeculativeConfig(k=SPEC_K, drafter="mtp"))
    tok, cache, _, h = _spec_start(eng, prompts, gen)
    del cache
    with dispatch_spy() as rk:
        lk, hk = lm.mtp_decode_step(model, h, tok, cfg, eng.hsa)
    with dispatch_spy() as rr:
        lr, hr = lm.mtp_decode_step(model, h, tok, cfg, plain.hsa)
    out = dict(head_hidden_rel_err=_rel(hk, hr, "MTP head step hidden", DECODE_BLOCK_TOL),
               head_logits_rel_err=_rel(lk, lr, "MTP head step logits", DECODE_TOL),
               head_tokens_routed_differently=_routes_differing(rk, rr),
               head_argmax_agree=bool(torch.equal(lk.argmax(-1), lr.argmax(-1))))
    drafter, ref_drafter = (make_drafter(gen.speculative, cfg, hsa)
                            for hsa in (eng.hsa, plain.hsa))
    state, t = {"h": h.clone()}, tok.clone()
    eager = drafter.draft(model, {"h": h.clone()}, t)
    out["drafts_agree_with_plain"] = (eager == ref_drafter.draft(model, {"h": h.clone()}, t)
                                      ).float().mean().item()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        drafter.draft(model, state, t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with hopper.captured_launches() as launched, torch.cuda.graph(graph):
        drafts = drafter.draft(model, state, t)
    want = {n: SPEC_K * c for n, c in mtp_step_launches(path).items()}
    if launched != want:
        raise RuntimeError(f"MTP head chain: a replay launches {launched}, expected {want}")
    times = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    if not torch.equal(drafts, eager):
        raise RuntimeError("MTP head chain: the graph's drafts differ from the eager chain's")
    out.update(head_chain_launches=launched, head_chain_device_ms=sorted(times)[2],
               head_chain_device_ms_runs=times)
    log(f"{path['arch']} MTP head: {json.dumps(out)}")
    return out


class _FirstDraftsForced:
    """The MTP drafter with the first verify block's drafts replaced by
    ``drafts``; the head chain still runs every step (a replay's launches
    are the drafter's), and later steps take its own drafts.  ``h1`` keeps
    the drafter's ``h`` after the first commit; ``calls`` counts the steps on
    the device, so a captured step reads it too."""

    def __init__(self, inner, drafts: torch.Tensor, hidden: torch.Tensor):
        self.inner, self.k, self.drafts = inner, inner.k, drafts
        self.calls = torch.zeros((), dtype=torch.long, device=drafts.device)
        self.h1 = torch.zeros_like(hidden)

    def reset(self) -> None:
        self.calls.zero_()
        self.h1.zero_()

    def init(self, hist, hist_len, hidden):
        return self.inner.init(hist, hist_len, hidden)

    def draft(self, model, state, tok):
        return torch.where(self.calls == 0, self.drafts, self.inner.draft(model, state, tok))

    def observe(self, state, block, n_commit, hidden_all, next_tok):
        self.inner.observe(state, block, n_commit, hidden_all, next_tok)
        self.h1.copy_(torch.where(self.calls == 0, state["h"], self.h1))
        self.calls += 1


@torch.inference_mode()
def mtp_deep_commit(path: dict, eng) -> dict:
    """A verify step that commits past the pending token with the MTP
    drafter, which random weights never reach on their own: the first
    block's drafts are the verify's own greedy tokens, iterated towards a
    fixed point (the block scored on its own after each pass; its one W8A8
    activation scale lets a changed draft move another position's argmax,
    so the pass whose least acceptance is highest is kept), and the step
    commits n_commit > 1 (fatal otherwise; k + 1 at a fixed point).
    Fatal: the drafter's ``h`` after that commit equals the verify's
    ``hidden_all[:, n_commit - 1]`` bit for bit, and the speculative loop
    from the same prefill (that step, then head chains from the later
    position, 2 (k + 1) tokens) gives the same tokens, lengths, steps,
    accepted drafts, history, ``h`` and cache as a graph as eagerly, its
    replay launching a verify step's launches."""
    from repro_torch.serving import speculative as spec_mod
    from repro_torch.serving.sampling import SpeculativeConfig
    cfg, model, k = eng.cfg, eng.model, SPEC_K
    prompts = spec_prompts(cfg.vocab_size)
    gen = GenerationConfig(max_new_tokens=2 * (k + 1),
                           speculative=SpeculativeConfig(k=k, drafter="mtp"))
    tok, cache, hist, hidden = _spec_start(eng, prompts, gen)
    drafts = (tok[:, None] + torch.arange(1, k + 1, device=tok.device)) % cfg.vocab_size
    best = None
    for passes in range(1, 4 * k + 5):
        block = torch.cat([tok[:, None], drafts], 1)
        cand, acc, hidden_all, _ = spec_mod.verify_block(model, block, _clone(cache), cfg=cfg,
                                                         hsa=eng.hsa, gen=gen)
        if best is None or int(acc.amin()) > int(best[1].amin()):
            best = (block, acc, hidden_all)
        if int(acc.amin()) == k:
            break
        drafts = cand[:, :k].clone()
    block, acc, hidden_all = best
    n_commit = int(acc.amin()) + 1
    if n_commit < 2:
        raise RuntimeError(f"MTP deep commit: no fixed point commits past the pending token "
                           f"(acceptance {acc.tolist()})")
    forced = _FirstDraftsForced(spec_mod.make_drafter(gen.speculative, cfg, eng.hsa),
                                block[:, 1:].contiguous(), hidden)
    key = eng.spec_graph_key(cache, hist.shape[1], gen)
    make_drafter, spec_mod.make_drafter = spec_mod.make_drafter, lambda *a: forced
    try:
        eng._spec_loop(tok, cache, hist, prompts.shape[1], hidden, gen, None, graph=True)
        sg = eng._graphs[key]
        forced.reset()
        g, _ = eng._spec_loop(tok, cache, hist, prompts.shape[1], hidden, gen, None, graph=True)
        h1_graph = forced.h1.clone()
        forced.reset()
        e, _ = eng._spec_loop(tok, _clone(cache), hist, prompts.shape[1], hidden, gen, None,
                              graph=False)
    finally:
        spec_mod.make_drafter = make_drafter
        eng._graphs.pop(key, None)
    want = spec_step_launches(path)
    if sg.launches != want:
        raise RuntimeError(f"MTP deep commit: a replay launches {sg.launches}, expected {want}")
    if not (torch.equal(forced.h1, hidden_all[:, n_commit - 1])
            and torch.equal(h1_graph, forced.h1)):
        raise RuntimeError("MTP deep commit: h after the commit is not the verify's hidden at "
                           f"position {n_commit - 1}")
    if not torch.equal(e.out[:, :n_commit], block[:, :n_commit]) or int(e.steps) < 2:
        raise RuntimeError("MTP deep commit: the first step did not emit the forced block "
                           f"({e.out[:, :n_commit].tolist()}, {int(e.steps)} steps)")
    a, b = dict(serving_engine.tree_items(g.cache)), dict(serving_engine.tree_items(e.cache))
    differ = [name for name in a if not torch.equal(a[name], b[name])]
    same = all(torch.equal(getattr(g, f), getattr(e, f))
               for f in ("out", "lengths", "steps", "accepted", "hist", "hist_len", "h", "tok"))
    if not same or differ:
        raise RuntimeError(f"MTP deep commit: graph and eager loops differ ({differ[:4]})")
    out = dict(deep_commit_n_commit=n_commit, deep_commit_fixed_point_passes=passes,
               deep_commit_acceptance=acc.tolist(), deep_commit_verify_steps=int(e.steps),
               deep_commit_accepted_drafts=int(e.accepted),
               deep_commit_graph_and_eager_bit_identical=True)
    log(f"{path['arch']} MTP deep commit: {json.dumps(out)}")
    return out


def serve_mtp(path: dict, card: str) -> tuple[dict, dict]:
    """The ds3_mtp cell (`DS3_MTP`): the ds3 cut with its MTP head at every
    published width; `speculative_cell` with the MTP drafter in the f32
    latent cache (launches exact: the block's W8A8 and SPEC_K head steps'
    MXINT4 and expert GEMV a replay; graph = eager bit for bit, ``h``
    included; the verify block in lockstep with the plain path), then
    `mtp_head_checks` and `mtp_deep_commit`.  Returns the counted generate's
    launches and the results."""
    t0 = time.perf_counter()
    arch = path["arch"]
    log(f"== MTP drafter: {arch} (the ds3 cut and its MTP head), k {SPEC_K}, B={BATCH}, "
        f"S={PROMPT}, {SPEC_NEW} tokens, C {SPEC_CACHE}, the f32 latent cache")
    eng = InferenceEngine.from_config(path["cfg"], EngineSpec(), device="cuda")
    torch.cuda.synchronize()
    log(f"init + deploy: {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident")
    cfg = eng.cfg
    if (cfg.n_layers, cfg.d_model, cfg.padded_vocab, cfg.n_experts, cfg.moe_d_ff) != (
            path["layers"], path["d"], path["vocab"], path["head"]["experts"]["e"],
            path["head"]["experts"]["f"]) or not isinstance(eng.model.mtp.block, lm.MoEBlock):
        raise RuntimeError(f"unexpected config {cfg}")
    plain = InferenceEngine(cfg, eng.model, EngineSpec(kernel_impl="ref"))
    launches, out = speculative_cell(path, eng, plain, None, card)
    out.update(mtp_head_checks(path, eng, plain))
    out.update(mtp_deep_commit(path, eng))
    out["head_share_of_verify_replay"] = (out["head_chain_device_ms"]
                                          / out["verify_step_device_ms"])
    log(f"{arch} phase: {time.perf_counter() - t0:.1f} s")
    del eng, plain
    torch.cuda.empty_cache()
    return launches, {f"{arch} speculative": out}


def resume_in_halves(tag, eng, pending, cache0, whole, whole_cache, gen) -> bool:
    """`resume_generate` of NEW // 2 tokens, then of NEW // 2 more from the
    cache it left and its ``next_token``, against one resume of NEW tokens
    from the same cache: tokens and final cache bit for bit."""
    half = dataclasses.replace(gen, max_new_tokens=NEW // 2)
    first = eng.resume_generate(pending, cache0, half)
    second = eng.resume_generate(first.next_token, cache0, half)
    halves = GenerationResult(tokens=torch.cat([first.tokens, second.tokens], dim=1),
                              lengths=first.lengths + second.lengths, prefill_s=0.0,
                              decode_s=0.0, decode_steps=NEW)
    _same_as_graph(f"{tag} resumed in halves", whole, whole_cache, halves, cache0)
    if not torch.equal(second.next_token, whole.next_token):
        raise RuntimeError(f"{tag}: resumed in halves, the next token differs")
    return True


# serve CLI subprocesses run at a time (`serve_cli`).
CLI_WORKERS = 8


def serve_cli() -> dict:
    """`python -m repro_torch.launch.serve` at full width on the card, one
    subprocess per mode: greedy and top-p generate, the scheduler, the front
    end on virtual time (its smoke contract: nonzero goodput, no unexplained
    shed), and the oversubscribed host-spill scheduler writing its trace and
    metrics, all on retnet-1.3b; then ``--prefix-cache`` on qwen3-8b (LISO at
    0.08: 5 prompts of 60 tokens opening with one 45-token prefix), whose
    hit line must report 4 of 5 admissions adopting it; then one greedy
    generate each with ``--arch falcon-mamba-7b``, ``--arch hymba-1.5b`` and
    ``--arch olmoe-1b-7b``; and ``python -m repro_torch.launch.train`` on its
    default device, the card (reduced retnet, 3 steps, a simulated failure
    at step 1 saved and restored).  Each must exit 0 and print its
    ``[serve]`` (``[train]``) lines, the last the mode's own.  CLI_WORKERS of
    them run at a time (each is host-bound; its timings are not recorded)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        trace, metrics = os.path.join(tmp, "trace.json"), os.path.join(tmp, "metrics.json")
        retnet = ["--arch", "retnet-1.3b", "--scenario", "SILO", "--scale", "0.1",
                  "--batch", "2"]
        modes = (("greedy", [], "[serve] sample output tokens"),
                 ("top_p", ["--temperature", "1", "--top-p", str(TOP_P)],
                  "[serve] sample output tokens"),
                 ("scheduler", ["--requests", "6", "--slots", "4", "--chunk-size", "8"],
                  "[serve] tokens/s"),
                 ("frontend", ["--frontend", "--virtual-clock", "--requests", "8", "--slots",
                               "2", "--chunk-size", "8"], "[serve] frontend smoke OK"),
                 ("host_spill", ["--requests", "6", "--host-spill", "--oversubscribe", "2",
                                 "--chunk-size", "8", "--trace", trace, "--metrics", metrics],
                  "[serve] metrics snapshot"),
                 ("speculative", ["--speculative"], "[serve] sample output tokens"),
                 ("speculative_scheduler", ["--speculative", "--requests", "6", "--slots", "4",
                                            "--chunk-size", "8"], "[serve] tokens/s"))
        serve, train = "repro_torch.launch.serve", "repro_torch.launch.train"
        modes = tuple((name, serve, retnet + extra, last) for name, extra, last in modes) + (
            ("prefix_cache", serve, ["--arch", "qwen3-8b", "--scenario", "LISO", "--scale",
                                     "0.08", "--requests", "5", "--slots", "2",
                                     "--chunk-size", "8", "--prefix-cache"],
             "[serve] tokens/s"),
            ("falcon_mamba", serve, ["--arch", "falcon-mamba-7b", "--scenario", "SILO",
                                     "--scale", "0.1", "--batch", "2"],
             "[serve] sample output tokens"),
            ("hymba", serve, ["--arch", "hymba-1.5b", "--scenario", "SILO", "--scale", "0.1",
                              "--batch", "2"], "[serve] sample output tokens"),
            ("olmoe", serve, ["--arch", "olmoe-1b-7b", "--scenario", "SILO", "--scale", "0.1",
                              "--batch", "2"], "[serve] sample output tokens"),
            # The train CLI on its default device, the card: reduced retnet,
            # 3 steps with a simulated failure (save, restore) at step 1.
            ("train", train, ["--arch", "retnet-1.3b", "--reduced", "--steps", "3", "--batch",
                              "2", "--seq", "64", "--fail-at", "1", "--ckpt-dir",
                              os.path.join(tmp, "ckpt")], "[train] done."))

        def run(mode):
            _, module, argv, _ = mode
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", module, *argv],
                                  cwd=ROOT, capture_output=True, text=True, timeout=600,
                                  env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
            return proc, time.perf_counter() - t0

        with ThreadPoolExecutor(CLI_WORKERS) as pool:
            runs = list(pool.map(run, modes))
        for (name, _, _, last), (proc, seconds) in zip(modes, runs):
            tag = last.split()[0]
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
            for ln in lines:
                log(f"  cli {name}: {ln}")
            if proc.returncode != 0 or not lines or not lines[-1].startswith(last):
                raise RuntimeError(f"CLI ({name}) exited {proc.returncode} with "
                                   f"{len(lines)} {tag} lines: {proc.stderr[-2000:]}")
            out[name] = dict(seconds=seconds, lines=lines)
        snap = json.load(open(metrics))["counters"]
        events = json.load(open(trace))["traceEvents"]
        if snap["sched.preempted"] < 1 or snap["sched.resumed"] != snap["sched.preempted"] \
                or not any(e["name"] == "preempt" for e in events):
            raise RuntimeError(f"serve CLI (host_spill): no preemption recorded: {snap}")
        out["host_spill"].update(metrics_counters=snap, trace_events=len(events))
        for name in ("speculative", "speculative_scheduler"):
            if not any(ln.startswith("[serve] speculative:") for ln in out[name]["lines"]):
                raise RuntimeError(f"serve CLI ({name}): no speculative line")
        hit = [ln for ln in out["prefix_cache"]["lines"]
               if ln.startswith("[serve] prefix cache")]
        if not hit or "4/5 admissions adopted a cached prefix, 180 prefill" not in hit[0]:
            raise RuntimeError(f"serve CLI (prefix_cache): hit line {hit}")
        if not any("elastic plan" in ln for ln in out["train"]["lines"]):
            raise RuntimeError(f"train CLI: no failure restore in {out['train']['lines']}")
    return out


def _device_us(prof) -> tuple[float, list]:
    """Kernel time in us (device-side events only: the CPU ops that launched
    them carry the same time again) and the top kernels in ms."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    evs.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in evs[:6]]
    return sum(e.self_device_time_total for e in evs), top


# Kernel kinds of `_device_ms_by_kind`: the port's kernels by the name of
# their CUDA function, everything else (PyTorch's own kernels) as "other".
KERNEL_KINDS = (("mxint4_expert", "mxint4_expert_gemv_kernel"),
                ("mxint4", "mxint4_gemv_kernel"), ("w8a8", "w8a8_gemm_kernel"),
                ("flash_decode_mla", "flash_decode_mla_kernel"),
                ("flash_decode", "flash_decode_kernel"), ("retention", "retention_pass"),
                ("retention_bwd", "retention_bwd_"),
                ("rmsnorm_stats", "rmsnorm_stats_kernel"))


def _device_ms_by_kind(prof, units: int = 1) -> dict:
    """Device ms per unit (a prefill, a step) by kernel kind."""
    from torch.autograd import DeviceType
    out = dict.fromkeys([k for k, _ in KERNEL_KINDS] + ["other"], 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        kind = next((k for k, mark in KERNEL_KINDS if mark in e.key), "other")
        out[kind] += e.self_device_time_total / 1e3 / units
    return {k: v for k, v in out.items() if v}


@torch.inference_mode()
def profile_shares(eng, prompts, gen, steps: int = 2, extras=None, prefill: bool = True
                   ) -> dict:
    """Device busy share of a prefill and of replays of the captured step,
    with the top kernels by device time and the device ms by kernel kind
    (torch.profiler, tracing the card's activity only; it still inflates the
    host side, so the busy shares are lower bounds), and the seconds each
    profile took.  ``prefill`` False runs the prefill unprofiled (the
    replay profile needs its cache).  Eager decode steps were profiled too
    before a depth cut (PERF.md section 4)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    out = {}
    t_prof = time.perf_counter()
    with profile(activities=acts) if prefill else contextlib.nullcontext() as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = eng.prefill(prompts, cache_len=prompts.shape[1] + gen.max_new_tokens,
                                    extras=extras)
        cache = eng._encode_cache(cache, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if prefill:
        dev, top = _device_us(prof)
        out.update(prefill_device_busy=dev / 1e6 / wall, prefill_top_ms=top,
                   prefill_device_ms_by_kind=_device_ms_by_kind(prof),
                   prefill_profile_s=time.perf_counter() - t_prof)
    tok = logits.argmax(-1)
    graph = eng._graphs[eng.graph_key(cache, gen)]
    graph.state.reset(tok, cache, gen)
    t_prof = time.perf_counter()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            graph.graph.replay()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, top = _device_us(prof)
    if not dev:
        out["decode_profile"] = "not measured: the profiler saw no device time"
        return out
    out.update(decode_device_busy=dev / 1e6 / wall, decode_device_ms_per_step=dev / 1e3 / steps,
               decode_device_ms_by_kind=_device_ms_by_kind(prof, steps),
               decode_top_ms_per_step=[(n, t / steps, c // steps) for n, t, c in top],
               decode_profile_s=time.perf_counter() - t_prof)
    return out


def _clone(tree):
    """A copy of a cache whose tensors a step may write in place (dense KV
    leaves); the rope state is never written in place and is shared."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree


def _prefill_from(model, x, cfg, hsa, enc_out=None):
    """`lm.forward_prefill` from embedded inputs ``x`` (and an
    encoder-decoder's encoder output ``enc_out``): last-token logits."""
    sin, cos = lm._rope_tables(cfg, x.shape[1], x.device)
    for blk in model.blocks:
        x = lm._block_apply(blk, x, cfg, hsa, "prefill", sin, cos,
                            enc_out=enc_out)[0].to(x.dtype)
    h = layers.norm_full(model.final_norm, x[:, -1:])
    return hsa.linear(model.lm_head, h, "prefill")[:, 0]


@torch.inference_mode()
def compare_paths(path, eng, plain, prompts, gen, plain_start, lk, first: bool = True,
                  extras=None):
    """Kernel path vs plain path on the same weights.

    * Per block, in lockstep: both paths get the plain path's input to the
      block; outputs within BLOCK_TOL of max|output|.  A wrong kernel shows
      here, at the block that runs it.  An encoder-decoder's encoder blocks
      run so on its frames (``extras``), then its decoder blocks on the
      plain path's encoder output.  The lockstep rides on the plain path's
      own prefill (`lockstep_prefill`), whose logits and cache it returns.
    * Prefill logits end to end, within PREFILL_TOL of max|logit|, beside the
      network's own sensitivity: the plain path against itself with one
      token's embedding moved by one bf16 step.  Random weights, a bf16
      residual stream and per-linear int8 activation rounding make that
      floor large, so no end-to-end bound can be tighter than it.
    * Decode the same way, each step starting both paths from the plain
      path's cache (in ``gen.cache_format``) and token, each on its own copy
      of the cache: every block in lockstep (`_decode_lockstep`: decode
      streams MXINT4 weights against f32 activations, so only f32 summation
      order differs, and each path encodes its own new K/V row), and the
      logits within DECODE_TOL beside the decode step's own one-bf16-step
      sensitivity.  Where the two paths' greedy tokens from the same cache
      differ, ``decode_argmax_flips`` lists the step, the batch lane and the
      plain path's margin between its top two logits, relative to
      max|logit|: a flip at a margin under ``decode_logit_max_rel_err`` is a
      near tie that f32 summation order decides.

    ``plain_start`` is the plain path's prefill (logits, f32 cache), which
    this reads and does not write; in the first format (``first``) it is
    None and made here.  ``lk`` is the kernel path's prefill logits.  A
    vision model's blocks take its patch embeddings spliced over the
    prompt's head (``extras``).  Returns the readings and ``plain_start``.

    A path marked ``f32_witness`` holds its decode logits to DECODE_TOL with
    the residual stream in f32 on both paths (and the same int8 codes into
    a W8A8 linear in decode: `_witness_step`) and records the bf16 reading,
    ungated, beside the gap after each block in both streams: a bf16 stream
    rounds each block's output, so an f32 gap of one part in 1e4 flips
    roundings that the next blocks carry and grow, and over 64 layers
    (falcon-mamba-7b) the logits of two correct paths part by half of
    max|logit|, above the one-bf16-step floor (PERF.md).  The decode steps
    compared are the first COMPARE_STEPS in every format; after a path's
    first format (not ``first``) the prefill (the same function in every
    format) is not compared again.
    """
    cfg, model = eng.cfg, eng.model
    out = {}
    patches = (extras or {}).get("patch_embeds")
    if first:
        plain_start, block = lockstep_prefill(eng, plain, prompts, gen, extras)
        lr = plain_start[0]
        enc_out = (lm._encode(model, extras["src_embeds"], cfg, plain.hsa)
                   if cfg.is_encdec else None)
        x = lm._embed(model, prompts, cfg, patch_embeds=patches).clone()
        mid = prompts.shape[1] // 2
        x[0, mid] = _bf16_step(x[0, mid])
        floor, plain_ms = _timed(lambda: _prefill_from(model, x, cfg, plain.hsa, enc_out))
        out.update(block_max_rel_err=max(block), block_tolerance=BLOCK_TOL,
                   prefill_logit_rel_err=_rel(lk, lr, "prefill logits", PREFILL_TOL),
                   prefill_tolerance=PREFILL_TOL,
                   prefill_sensitivity_floor=_rel(floor, lr, "sensitivity", float("inf")),
                   plain_prefill_ms=plain_ms)
    lr, cache = plain_start
    cache = plain._encode_cache(cache, gen)

    witness = path.get("f32_witness", False)
    decode, dblock, codes, same, dfloor, flips = [], [], [], [], [], []
    f32, f32_own = [], []
    gaps, routes = {}, {}
    tok = lr.argmax(-1)
    for i in range(COMPARE_STEPS):
        lk, _ = eng.decode_step(tok[:, None], _clone(cache))
        lr, nxt = plain.decode_step(tok[:, None], _clone(cache))
        decode.append(_rel(lk, lr, f"decode step {i}",
                           float("inf") if witness else DECODE_TOL))
        top2 = lr.float().topk(2, dim=-1).values
        for b in (lk.argmax(-1) != lr.argmax(-1)).nonzero()[:, 0].tolist():
            flips.append((i, b, ((top2[b, 0] - top2[b, 1]) / lr.float().abs().max()).item()))
        worst, n_codes, same_codes = _decode_lockstep(eng, plain, tok, cache, i)
        dblock.append(worst)
        codes.append(n_codes)
        same.append(same_codes)
        x = lm._embed(model, tok[:, None], cfg, start=cache["pos"]).clone()
        x[0] = _bf16_step(x[0])
        dfloor.append(_rel(_decode_from(model, x, _clone(cache), cfg, plain.hsa), lr,
                           "sensitivity", float("inf")))
        if witness:
            rel, own, step_gaps, step_routes = _witness_step(eng, plain, tok, cache, i)
            f32.append(rel)
            for name, n in step_routes.items():
                routes.setdefault(name, []).append(n)
            if own is not None:
                f32_own.append(own)
            for name, g in step_gaps.items():
                gaps[name] = [max(a, b) for a, b in zip(gaps.get(name, g), g)]
        cache, tok = nxt, lr.argmax(-1)
    out.update(decode_block_max_rel_err=max(dblock),
               decode_block_tolerance=DECODE_BLOCK_TOL,
               decode_logit_max_rel_err=max(decode),
               decode_logit_rel_err_by_step=decode,
               decode_tolerance=None if witness else DECODE_TOL,
               decode_sensitivity_floor_by_step=dfloor,
               decode_sensitivity_floor_max=max(dfloor), decode_argmax_flips=flips)
    if any(_w8_decode_linears(blk) for blk in model.blocks):
        out.update(decode_w8a8_codes_differing_by_step=codes,
                   decode_block_same_codes_max_rel_err=max(same))
    if witness:
        out.update(decode_f32_logit_rel_err_by_step=f32, decode_f32_tolerance=DECODE_TOL,
                   **{f"layer_gap_{name}": g for name, g in gaps.items()},
                   **{f"decode_tokens_routed_differently_{name}_by_step": n
                      for name, n in routes.items()})
    if f32_own:
        out.update(decode_f32_own_codes_logit_rel_err_by_step=[r for r, _ in f32_own],
                   decode_f32_codes_differing_by_step=[n for _, n in f32_own])
    return out, plain_start


def lockstep_prefill(eng, plain, prompts, gen, extras) -> tuple[tuple, list]:
    """The plain path's prefill at the generate's cache length with every
    block (an encoder's too) run again on the kernel path, on the same
    inputs and arguments, as the plain path reaches it: each output within
    BLOCK_TOL of the plain block's max|output| (`compare_paths`).  Returns
    the plain prefill (logits, f32 cache) and the readings, in block
    order."""
    real, block, seen = lm._block_apply, [], {"enc": 0, "dec": 0}

    def spy(p, x, cfg, hsa, *args, **kw):
        y, c = real(p, x, cfg, hsa, *args, **kw)
        if hsa is plain.hsa:
            side = "enc" if isinstance(p, lm.EncoderBlock) else "dec"
            tag = f"prefill {'encoder ' if side == 'enc' else ''}block {seen[side]}"
            seen[side] += 1
            block.append(_rel(real(p, x, cfg, eng.hsa, *args, **kw)[0], y, tag, BLOCK_TOL))
        return y, c

    lm._block_apply = spy
    try:
        start = plain.prefill(prompts, cache_len=prompts.shape[1] + gen.max_new_tokens,
                              extras=extras)
    finally:
        lm._block_apply = real
    if seen["dec"] != len(eng.model.blocks) or seen["enc"] != len(eng.model.enc_blocks):
        raise RuntimeError(f"lockstep prefill: {seen} blocks compared")
    return start, block


def _appends(engine, prompts, gen, extras=None, start=None):
    """The eager loop (`eager_generate`, from ``start`` when given) with
    every one-row cache write recorded: per decode step, each written leaf's
    row before encoding (f32) and as stored."""
    real, rows = layers.cache_update, []

    def spy(leaf, x, pos):
        out = real(leaf, x, pos)
        if x.shape[1] == 1:
            slot = min(int(pos), layers.cache_capacity(out) - 1)
            stored = ({k: v[:, slot].clone() for k, v in out.items()}
                      if isinstance(out, dict) else out[:, slot].clone())
            rows.append((x[:, 0].float().clone(), stored))
        return out

    layers.cache_update = spy
    try:
        res, _ = eager_generate(engine, prompts, gen, extras, start)
    finally:
        layers.cache_update = real
    per = len(rows) // res.decode_steps
    return res, [rows[i * per:(i + 1) * per] for i in range(res.decode_steps)]


def _quant_step(x: torch.Tensor, stored) -> torch.Tensor:
    """The rounding step each element of row ``x`` had when it was stored."""
    if isinstance(stored, dict) and "e" in stored:          # mxint4_blk
        return torch.exp2(stored["e"].float() - mx.MANT_SHIFT).repeat_interleave(
            mx.GROUP_SIZE, dim=-1)
    if isinstance(stored, dict):                            # int8_tok
        return stored["s"].expand_as(x)
    bits = {torch.bfloat16: 8, torch.float16: 11}.get(stored.dtype, 24)
    return torch.exp2(torch.frexp(x)[1].float() - bits)


def _row_parting(xk, sk, xr, sr) -> dict | None:
    """Where one appended row's stored bytes differ between the two paths:
    the elements whose stored value differs and the side entries (mxint4_blk
    exponents, int8_tok scales) that differ; for up to four such elements,
    both paths' values before encoding, their gap, and each one's distance
    from the nearest rounding boundary, in its own rounding steps (0: on
    the boundary, 0.5: on a code).  ``col`` indexes the row flattened per
    batch lane (a GQA row is ``[KV heads, head dim]``)."""
    vk, vr = kvq.decode(sk), kvq.decode(sr)
    side = {k: int((sk[k] != sr[k]).sum()) for k in ("e", "s")
            if isinstance(sk, dict) and k in sk}
    diff = vk != vr
    if not bool(diff.any()) and not any(side.values()):
        return None
    stk, str_ = _quant_step(xk, sk), _quant_step(xr, sr)
    vk, vr, xk, xr, stk, str_, diff = (t.reshape(t.shape[0], -1)
                                       for t in (vk, vr, xk, xr, stk, str_, diff))
    to_edge = lambda x, st: ((x / st) - torch.floor(x / st) - 0.5).abs()  # noqa: E731
    out = dict(values_differing=int(diff.sum()), side_differing=side,
               pre_encode_max_rel_gap=((xk - xr).abs().max() / xr.abs().max()).item(),
               elements=[])
    for b, j in diff.nonzero()[:4].tolist():
        out["elements"].append(dict(
            lane=b, col=j, kernel=xk[b, j].item(), plain=xr[b, j].item(),
            gap_in_steps=((xk[b, j] - xr[b, j]).abs() / str_[b, j]).item(),
            kernel_to_boundary=to_edge(xk[b, j], stk[b, j]).item(),
            plain_to_boundary=to_edge(xr[b, j], str_[b, j]).item(),
            stored=(vk[b, j].item(), vr[b, j].item())))
    return out


@torch.inference_mode()
def free_running(eng, plain, prompts, gen, extras=None, plain_start=None):
    """Both paths generating on their own through the eager loop (whose
    tokens and cache the graph's match bit for bit, `_same_as_graph`): each
    decode step appends the rows its own path computed to its own cache.
    Returns both paths' results (the times are of these recorded runs) and
    where the two part: the first token column that differs (token i + 1
    comes from decode step i, which appends the rows of token i), and the
    first decode step whose appended rows differ in their stored bytes, with
    each differing write there (``write``: the order of the step's cache
    writes, two per layer, K or latent then V or rope) as `_row_parting`
    gives it, and how many steps before the first token flip had such rows.
    Rows that part from the same tokens, from nearby values either side of
    a rounding boundary, before any token flips, are the caches drifting
    apart through their encoding; a flip with no parted row before it would
    point at the attention itself.  The plain path starts from its prefill
    ``plain_start`` (logits, f32 cache) when given."""
    gen = dataclasses.replace(gen, max_new_tokens=FREE_RUN_NEW)
    res_k, rows_k = _appends(eng, prompts, gen, extras)
    res_p, rows_p = _appends(plain, prompts, gen, extras, plain_start)
    tk, tp = res_k.tokens, res_p.tokens
    cols = (tk != tp).any(dim=0).nonzero()[:, 0].tolist()
    flip = cols[0] if cols else None
    first, steps = None, 0
    for i, (rk, rp) in enumerate(zip(rows_k, rows_p)):
        if flip is not None and i >= flip:
            break
        parted = [dict(write=w, **d) for w, ((xk, sk), (xr, sr)) in enumerate(zip(rk, rp))
                  if (d := _row_parting(xk, sk, xr, sr)) is not None]
        if parted:
            steps += 1
            first = first or dict(step=i, writes=parted)
    return res_k, res_p, dict(first_token_flip=flip, first_parted_rows=first,
                              steps_with_parted_rows_before_flip=steps)


def _bf16_step(row: torch.Tensor) -> torch.Tensor:
    """Move a bf16 row by one rounding step (relative 2^-7)."""
    return (row.float() * (1 + 2 ** -7)).to(row.dtype)


def _angles(cache) -> tuple:
    """The online RoPE unit's (sin, cos) a decode step reads (None for a
    model without RoPE)."""
    st = cache.get("rope")
    return (st.sin, st.cos) if st is not None else (None, None)


def _decode_from(model, x, cache, cfg, hsa, trace=None):
    """`lm.forward_decode` from embedded inputs ``x``, its residual stream
    kept in ``x``'s dtype: logits.  ``trace`` (a list) gets the residual
    after each block."""
    (sin, cos), pos = _angles(cache), cache["pos"]
    for blk, c in zip(model.blocks, cache["blocks"]):
        x = lm._block_decode(blk, x, cfg, hsa, c, pos, sin, cos)[0].to(x.dtype)
        if trace is not None:
            trace.append(x)
    return hsa.linear(model.lm_head, layers.norm_full(model.final_norm, x),
                      "decode")[:, 0]


def _witness_step(eng, plain, tok, cache, step):
    """One decode step on both paths from the same cache and token
    (`_decode_from`), with the model's bf16 residual stream and with it in
    f32: the same kernels, and no rounding of the stream between blocks in
    the second.  A W8A8 linear in decode (hymba's ``x_proj``) still rounds
    its input to int8 codes on each path, and one code moved by an f32 gap
    upstream moves that path as a bf16 step would: so the f32 stream also
    runs the kernel path on the plain path's inputs to those linears (the
    same codes, `_w8_inputs`).  Holds the f32 logits (with the same codes,
    where decode has a W8A8 linear) within DECODE_TOL of max|logit|.
    Returns that error; with a W8A8 linear, the f32 error with each path's
    own codes and the codes that differed (else None); per stream the two
    paths' gap after each block, relative to max|residual|; and on a MoE
    model per stream the tokens (over its layers) whose chosen experts
    differ between the paths."""
    model, cfg = eng.model, eng.cfg
    w8 = [m for blk in model.blocks for m in _w8_decode_linears(blk)]
    x, gaps, routes = lm._embed(model, tok[:, None], cfg, start=cache["pos"]), {}, {}
    gap = lambda tk, tr: [_rel(a, b, "residual", float("inf"))  # noqa: E731
                          for a, b in zip(tk, tr)]
    for name, xs in (("bf16", x), ("f32", x.float())):
        tk, tr = [], []
        with _w8_inputs(plain.hsa, w8) as xr, dispatch_spy() as rr:
            lr = _decode_from(model, xs, _clone(cache), cfg, plain.hsa, tr)
        with _w8_inputs(eng.hsa, w8) as xk, dispatch_spy() as rk:
            lk = _decode_from(model, xs, _clone(cache), cfg, eng.hsa, tk)
        gaps[name] = gap(tk, tr)
        if rk:
            routes[name] = _routes_differing(rk, rr)
    own = None
    if w8:
        own = (_rel(lk, lr, "logits", float("inf")),
               sum(_codes_differing(eng.hsa, a, b) for a, b in zip(xk, xr)))
        tk = []
        with _w8_inputs(eng.hsa, w8, feed=xr):
            lk = _decode_from(model, xs, _clone(cache), cfg, eng.hsa, tk)
        gaps["f32_same_codes"] = gap(tk, tr)
    rel = _rel(lk, lr, f"decode step {step} logits, f32 residual stream"
               + (", the same W8A8 codes" if w8 else ""), DECODE_TOL)
    return rel, own, gaps, routes


def _routes_differing(a: list, b: list) -> int:
    """Tokens, summed over the MoE layers of two `dispatch_spy` records of
    one step, whose sets of chosen experts differ."""
    return sum(int((ia.sort(-1).values != ib.sort(-1).values).any(-1).sum())
               for (ia, _, _), (ib, _, _) in zip(a, b))


def _w8_decode_linears(blk) -> list:
    """The linears of ``blk`` that decode runs as W8A8: those deployed with
    no MXINT4 copy (hymba's ``x_proj``, N 132)."""
    return [m for m in blk.modules()
            if isinstance(m, Linear) and m.mx_packed is None and m.w8_vals is not None]


@contextlib.contextmanager
def _w8_inputs(hsa, mods, feed=None):
    """Record, in call order, the input of each linear in ``mods`` that
    ``hsa`` runs; with ``feed``, run each on ``feed``'s input of the same
    place instead."""
    seen, real = [], hsa.linear

    def linear(p, x, phase, **kw):
        if any(p is m for m in mods):
            x = x if feed is None else feed[len(seen)]
            seen.append(x)
        return real(p, x, phase, **kw)

    hsa.linear = linear
    try:
        yield seen
    finally:
        del hsa.linear


def _codes_differing(hsa, xk, xr) -> int:
    """The int8 activation codes and scales that W8A8 takes differently
    from the inputs ``xk`` and ``xr``, quantized as
    `quantized_linear.apply` quantizes them."""
    quant = (mx.quantize_act_int8_lanes if hsa.config.per_lane
             else mx.quantize_act_int8)
    (qk, sk), (qr, sr) = quant(xk), quant(xr)
    return int((qk != qr).sum()) + int((sk != sr).sum())


def _decode_lockstep(eng, plain, tok, cache, step):
    """Every block of one decode step, both paths on the plain path's input
    to it, within DECODE_BLOCK_TOL of max|output|.  A W8A8 linear in decode
    (hymba's ``x_proj``) quantizes its input on each path, so the f32
    summation-order gap upstream of it can move an int8 code by one step.
    Where codes differ (counted), the block is held to BLOCK_TOL, an int8
    rounding step; every block with such a linear also runs on the kernel
    path with the plain path's inputs to it (the same codes), held to
    DECODE_BLOCK_TOL.  Returns the largest error, the codes that differed
    and the largest same-code error."""
    cfg, model = eng.cfg, eng.model
    (sin, cos), pos = _angles(cache), cache["pos"]
    x = lm._embed(model, tok[:, None], cfg, start=pos)
    worst, codes, same = 0.0, 0, 0.0
    for i, (blk, c) in enumerate(zip(model.blocks, cache["blocks"])):
        tag, w8 = f"decode step {step} block {i}", _w8_decode_linears(blk)
        with _w8_inputs(plain.hsa, w8) as xr:
            yr = lm._block_decode(blk, x, cfg, plain.hsa, _clone(c), pos, sin, cos)[0]
        with _w8_inputs(eng.hsa, w8) as xk:
            yk = lm._block_decode(blk, x, cfg, eng.hsa, _clone(c), pos, sin, cos)[0]
        n = sum(_codes_differing(eng.hsa, a, b) for a, b in zip(xk, xr))
        worst = max(worst, _rel(yk, yr, f"{tag} ({n} W8A8 codes differ)" if n else tag,
                                BLOCK_TOL if n else DECODE_BLOCK_TOL))
        if w8:
            with _w8_inputs(eng.hsa, w8, feed=xr):
                ys = lm._block_decode(blk, x, cfg, eng.hsa, _clone(c), pos, sin, cos)[0]
            same = max(same, _rel(ys, yr, f"{tag}, the same W8A8 codes", DECODE_BLOCK_TOL))
        codes += n
        x = yr.to(x.dtype)
    return worst, codes, same


def _rel(a, b, what, tol):
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise RuntimeError(f"{what}: non-finite values")
    rel = ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    if rel > tol:
        raise RuntimeError(f"{what}: kernel vs plain differ by {rel:.3e} of "
                           f"max|value| > {tol}")
    return rel


def _on_cpu(eng) -> InferenceEngine:
    return InferenceEngine(eng.cfg, copy.deepcopy(eng.model).to("cpu"), eng.spec)


@torch.inference_mode()
def cpu_lockstep(eng, cpu, prompts, arch: str) -> tuple[list, list]:
    """The card's prefill against the CPU's, stage by stage: each block of
    the card on the CPU's input to it, then the head (final norm and
    lm_head) on the CPU's last hidden state.  A stage whose linears take
    the same int8 codes on both sides differs only in f32 summation order
    and is held to DECODE_BLOCK_TOL of max|output|.  Where codes differ
    (counted: an f32 gap before a W8A8 linear moved a code by one step) the
    stage is held to BLOCK_TOL, an int8 rounding step, and run again on the
    card with the CPU's inputs to its linears (the same codes), held to
    DECODE_BLOCK_TOL.  Returns one reading a stage, with the tokens whose
    experts differ there, and the blocks whose moved codes moved their
    output past DECODE_BLOCK_TOL."""
    cfg, dev, n = eng.cfg, prompts.device, len(cpu.model.blocks)

    def stage(model, i):
        """Stage ``i`` of ``model``'s prefill and the linears it runs."""
        if i == n:
            return (lambda x, hsa: hsa.linear(
                model.lm_head, layers.norm_full(model.final_norm, x[:, -1:]), "prefill")[:, 0],
                [model.lm_head])
        blk = model.blocks[i]

        def block(x, hsa):
            sin, cos = lm._rope_tables(cfg, x.shape[1], x.device)
            return lm._block_apply(blk, x, cfg, hsa, "prefill", sin, cos)[0]
        return block, [m for m in blk.modules() if isinstance(m, Linear)]

    rows, moved = [], []
    x = lm._embed(cpu.model, prompts.cpu(), cfg)
    for i in range(n + 1):
        (fc, mc), (fg, mg) = stage(cpu.model, i), stage(eng.model, i)
        name = f"block {i}" if i < n else "head"
        tag = f"reduced {arch} prefill {name}"
        with _w8_inputs(cpu.hsa, mc) as ic, dispatch_spy() as rc:
            yc = fc(x, cpu.hsa)
        with _w8_inputs(eng.hsa, mg) as ig, dispatch_spy() as rg:
            yg = fg(x.to(dev), eng.hsa)
        codes = sum(_codes_differing(eng.hsa, a.cpu(), b) for a, b in zip(ig, ic))
        row = dict(stage=name, codes_differing=codes,
                   tokens_routed_differently=_routes_differing(
                       [(e.cpu(), p, c) for e, p, c in rg], rc),
                   rel_err=_rel(yg.cpu(), yc, f"{tag} ({codes} W8A8 codes differ)" if codes
                                else tag, BLOCK_TOL if codes else DECODE_BLOCK_TOL))
        if codes:
            with _w8_inputs(eng.hsa, mg, feed=[t.to(dev) for t in ic]):
                ys = fg(x.to(dev), eng.hsa)
            row["same_codes_rel_err"] = _rel(ys.cpu(), yc, f"{tag}, the same W8A8 codes",
                                             DECODE_BLOCK_TOL)
            if i < n and row["rel_err"] > DECODE_BLOCK_TOL:
                moved.append(i)
        rows.append(row)
        x = yc.to(x.dtype)
    return rows, moved


@torch.inference_mode()
def mtp_head_vs_cpu(eng, cpu, prompts, arch: str) -> dict:
    """One MTP head step on the card against the CPU on the CPU's inputs:
    ``h`` the CPU prefill's last hidden, ``tok`` its greedy token, and the
    CPU's inputs to the head's W8A8 linears (at the reduced widths the
    router, N 4, and ``wkv_a``, N 48, carry no MXINT4 copy).  The logits
    within LOGIT_TOL of max|logit|; with the card's own codes recorded."""
    logits, _, h = cpu.prefill(prompts.cpu(), return_hidden=True)
    tok = logits.argmax(-1)
    mc, mg = (_w8_decode_linears(e.model.mtp) for e in (cpu, eng))
    with _w8_inputs(cpu.hsa, mc) as xc:
        lc, hc = lm.mtp_decode_step(cpu.model, h, tok, cpu.cfg, cpu.hsa)
    with _w8_inputs(eng.hsa, mg) as xg:
        own, _ = lm.mtp_decode_step(eng.model, h.cuda(), tok.cuda(), eng.cfg, eng.hsa)
    with _w8_inputs(eng.hsa, mg, feed=[x.cuda() for x in xc]):
        lg, hg = lm.mtp_decode_step(eng.model, h.cuda(), tok.cuda(), eng.cfg, eng.hsa)
    tag = f"reduced {arch} MTP head step"
    return dict(logits_rel_err=_rel(lg.cpu(), lc, f"{tag}, the CPU's inputs", LOGIT_TOL),
                hidden_rel_err=_rel(hg.cpu(), hc, f"{tag} hidden", LOGIT_TOL),
                w8a8_linears_fed=len(mg),
                codes_differing_own=sum(_codes_differing(eng.hsa, a.cpu(), b)
                                        for a, b in zip(xg, xc)),
                logits_rel_err_own_codes=_rel(own.cpu(), lc, f"{tag}, own codes",
                                              float("inf")))


def reduced_vs_cpu(path: dict):
    """The reduced model: the kernel path on the card against the plain path
    on the CPU, same weights (a small-input reference check), once per cache
    format.  A path marked ``lockstep`` is held stage by stage
    (`cpu_lockstep`), and its prefill logits, from the card's own stack, to
    LOGIT_TOL with the CPU's inputs fed only to the linears of the blocks
    whose moved codes moved their output in the lockstep past
    DECODE_BLOCK_TOL (never to the head), and on fp weights; the reading with each side's own codes and the tokens whose
    experts differ there are recorded."""
    spec = EngineSpec(reduced="reduced" not in path)
    arch = path["arch"]
    eng = InferenceEngine.from_config(path.get("reduced", arch), spec, device="cuda")
    cpu = _on_cpu(eng)
    prompts = torch.randint(1, eng.cfg.vocab_size, (2, 16), generator=_gen(3),
                            device="cuda")
    extras = frame_extras(eng.cfg, 2)
    cpu_extras = extras and {k: v.cpu() for k, v in extras.items()}
    with dispatch_spy() as rg:
        lg, _ = eng.prefill(prompts, extras=extras)
    with dispatch_spy() as rc:
        lc, _ = cpu.prefill(prompts.cpu(), extras=cpu_extras)
    extra, tag = {}, f"reduced {arch} prefill"
    if path.get("lockstep"):
        extra = dict(prefill_rel_err_own_codes=_rel(lg.cpu(), lc, "own codes", float("inf")),
                     tokens_routed_differently_own_codes=_routes_differing(
                         [(i.cpu(), p, c) for i, p, c in rg], rc))
        extra["lockstep"], moved = cpu_lockstep(eng, cpu, prompts, arch)
        fed = lambda m: [x for i in moved for x in m.blocks[i].modules()  # noqa: E731
                         if isinstance(x, Linear)]
        with _w8_inputs(cpu.hsa, fed(cpu.model)) as xc:
            lc, _ = cpu.prefill(prompts.cpu())
        with _w8_inputs(eng.hsa, fed(eng.model), feed=[t.cuda() for t in xc]):
            lg, _ = eng.prefill(prompts)
        extra["blocks_fed_the_cpu_codes"] = moved
        tag += f", the CPU's codes into blocks {moved}" if moved else ""
        fp = InferenceEngine.from_config(path["reduced"], EngineSpec(quantize=False),
                                         device="cuda")
        extra["prefill_rel_err_fp"] = _rel(fp.prefill(prompts)[0].cpu(),
                                           _on_cpu(fp).prefill(prompts.cpu())[0],
                                           f"reduced {arch} prefill, fp weights", LOGIT_TOL)
        del fp
        extra["mtp_head"] = mtp_head_vs_cpu(eng, cpu, prompts, arch)
    rel = _rel(lg.cpu(), lc, tag, LOGIT_TOL)
    agree = {}
    for fmt in path["formats"]:
        gen = GenerationConfig(max_new_tokens=12, cache_format=fmt)
        tg = eng.generate(prompts, gen, extras=extras).tokens.cpu()
        tc = cpu.generate(prompts.cpu(), gen, extras=cpu_extras).tokens
        agree[fmt or "f32"] = (tg == tc).float().mean().item()
    log(f"reduced {arch}, card kernels vs CPU plain: prefill rel err {rel:.3e}, "
        f"greedy-token agreement {agree}" + (f", {json.dumps(extra)}" if extra else ""))
    return {f"reduced {arch}": dict(prefill_rel_err=rel, greedy_agreement=agree, **extra)}


# -- training (phase 4b) --------------------------------------------------------------

# The two training paths at every published width: (arch, layers, d_model,
# padded vocab).  B 2, S 512, the quickstart's AdamW; TRAIN_STEPS steps.
TRAIN_PATHS = (dict(arch="retnet-1.3b", layers=24, d=2048, vocab=32768),
               dict(arch="internlm2-1.8b", layers=24, d=2048, vocab=92672))
TRAIN_SEQ, TRAIN_STEPS = 512, 4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_GRAD_TOL = 1e-2     # kernel vs plain path, f32 stream: a bf16 step of max|grad|
TRAIN_SERVE = (128, 16)   # the trained retnet's generate: prompt, new tokens
TRAIN_REDUCED_SEQ = 200   # crosses the 128 split: the tail's state cotangent


def train_batches(cfg, s: int, n: int, b: int = BATCH) -> list:
    data = SyntheticPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b))
    return [{k: torch.from_numpy(v).long().cuda() for k, v in data.batch(i).items()}
            for i in range(n)]


def train_launches(cfg, s: int) -> dict:
    """Kernel launches of one train step (B 2, ``s`` tokens): RetNet's
    retention forward twice a layer (the forward and its rematerialization
    in backward; two parts where ``s`` has a tail) and its backward once a
    layer; nothing else on these paths is a kernel of the port."""
    want = dict.fromkeys(hopper.COUNTERS, 0)
    if cfg.family == "retnet":
        parts = retention_launches(s)
        want["retention_chunkwise"] = 2 * cfg.n_layers * parts
        want["retention_chunkwise_bwd"] = cfg.n_layers * parts
    return want


def _grad_diff(tag, got: dict, want: dict, tol: float) -> tuple[float, str]:
    """Largest error of any leaf relative to max|want leaf|, and that leaf;
    raises past ``tol`` (a leaf the plain path gives a gradient the kernel
    path must)."""
    worst, at = 0.0, ""
    for name, w in want.items():
        top = w.abs().max().item()
        err = (got[name].float() - w.float()).abs().max().item()
        if (err > tol * top) if top > 0 else err > 0:
            raise RuntimeError(f"{tag} {name}: gradient error {err:.3e} against "
                               f"max|plain| {top:.3e}")
        if top and err / top > worst:
            worst, at = err / top, name
    return worst, at


def _worst_leaves(got: dict, want: dict, n: int = 3) -> list:
    """The ``n`` leaves whose gradients differ most, relative to max|want
    leaf|, as [name, error] pairs."""
    errs = []
    for name, w in want.items():
        top = w.abs().max().item()
        if top:
            errs.append([name, (got[name].float() - w.float()).abs().max().item() / top])
    return sorted(errs, key=lambda e: -e[1])[:n]


@contextlib.contextmanager
def retention_nudged_one_ulp():
    """The control for a kernel-against-plain gap: while open, every
    `ops.retention_chunkwise` output moves one f32 ulp towards +inf in the
    forward (the same in the rematerialized forward), its gradient passing
    through unchanged.  Run on the plain path, it shows what an output
    difference of the kernel's size does to a full-width step's loss and
    gradients, with no kernel involved."""
    plain = ops.retention_chunkwise

    def nudged(*args, **kwargs):
        y, state = plain(*args, **kwargs)
        up = torch.nextafter(y, torch.full_like(y, float("inf")))
        return y + (up - y).detach(), state

    ops.retention_chunkwise = nudged
    try:
        yield
    finally:
        ops.retention_chunkwise = plain


def _nudged_control(tag, cfg, model, batch, plain, opts, loss_p, g_p) -> dict:
    """The plain path with retention nudged one ulp (`retention_nudged_one_ulp`)
    against the plain path: the loss's relative gap and the worst leaves'."""
    with retention_nudged_one_ulp():
        loss_w, _, g_w = ts.gradients(model, batch, cfg, plain, opts)
    worst, at = _grad_diff(tag, g_w, g_p, float("inf"))
    return dict(loss_rel_err=abs(loss_w.item() - loss_p.item()) / abs(loss_p.item()),
                grad_rel_err=worst, worst_leaf=at, worst_leaves=_worst_leaves(g_w, g_p))


def train_step_flops(cfg, n_params: int, b: int, s: int) -> float:
    """The FLOP one step needs: 2 a parameter a token in the forward, again
    in its rematerialization, and 4 in backward (8 in all); plus the mixer's
    own products: RetNet's chunkwise retention forward twice (as
    `kernel_phase_retention` counts it) and its backward once
    (`hopper.retention_bwd_flops`), or causal attention's QK^T and PV over
    the pairs i >= j, forward twice and backward (five such products) once."""
    h = cfg.n_heads
    if cfg.family == "retnet":
        dk, dv, c = cfg.d_model // h, 2 * cfg.d_model // h, min(128, s)
        n = s // c
        fwd = n * (c * (c + 1) * (dk + dv) + 2 * c * dk * dv) + (n - 1) * 2 * c * dk * dv
        mix = 2 * fwd * b * h + hopper.retention_bwd_flops(b, h, s, dk, dv, c, False, False,
                                                           False)
    else:
        fwd = 2 * (s * (s + 1) // 2) * 2 * cfg.head_dim_
        mix = (2 + 2.5) * fwd * b * h
    return 8 * n_params * b * s + mix * cfg.n_layers


def profile_train_step(step, state, batch) -> dict:
    """One step under torch.profiler (the card's activity): device ms by
    kernel kind, and the retention forward's and backward's shares."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    kinds = _device_ms_by_kind(prof)
    total = sum(kinds.values())
    return dict(device_ms=total, device_ms_by_kind=kinds,
                retention_fwd_share=kinds.get("retention", 0.0) / total,
                retention_bwd_share=kinds.get("retention_bwd", 0.0) / total)


def train_gate_f32(arch, cfg, model, batch, kernel, plain, opts) -> dict:
    """Step 0 in an f32 residual stream (an f32 copy of the masters, the
    same values): the kernel path's loss against the plain path's at 1e-4,
    and every gradient at TRAIN_GRAD_TOL of its leaf's max; on RetNet also
    the one-ulp control (`_nudged_control`), recorded."""
    twin = copy.deepcopy(model).to(torch.float32)
    loss_k, _, g_k = ts.gradients(twin, batch, cfg, kernel, opts)
    loss_p, _, g_p = ts.gradients(twin, batch, cfg, plain, opts)
    rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if rel > 1e-4:
        raise RuntimeError(f"{arch} step 0 (f32 stream): loss {loss_k.item()} (kernel) "
                           f"against {loss_p.item()} (plain)")
    worst, at = _grad_diff(f"{arch} step 0 (f32 stream)", g_k, g_p, TRAIN_GRAD_TOL)
    out = dict(loss_rel_err=rel, grad_rel_err=worst, worst_leaf=at,
               worst_leaves=_worst_leaves(g_k, g_p), loss=loss_k.item())
    del g_k
    if cfg.family == "retnet":
        out["nudged_control"] = _nudged_control(f"{arch} f32 control", cfg, twin, batch,
                                                plain, opts, loss_p, g_p)
    del twin, g_p
    torch.cuda.empty_cache()
    return out


def train_full_width(tp: dict, card: str) -> tuple[dict, dict]:
    """One training path at every published width on the card: init (bf16
    masters, f32 moments), step 0's loss and every gradient on the kernel
    path against the plain path (``kernel_impl="ref"``) on the same state
    in an f32 residual stream (`train_gate_f32`: loss 1e-4, each leaf
    TRAIN_GRAD_TOL of its max) and in bf16 (recorded; on RetNet each beside
    the one-ulp control, `_nudged_control`), the kernel path's gradients
    twice bit for bit (the embedding's CUDA backward sums in a fixed order;
    other leaves that differ are counted), then TRAIN_STEPS AdamW steps with
    exact launches and finite losses, timed (the first is warm-up), one
    profiled.  ``peak_gib`` is the steps' peak, the memory counters reset
    after the comparisons; ``phase_peak_gib`` the whole path's.  Returns
    the counted steps' launches and the record; on retnet-1.3b also the
    trained model's serve leg."""
    arch = tp["arch"]
    cfg = configs.get_config(arch)
    if (cfg.n_layers, cfg.d_model, cfg.padded_vocab) != (tp["layers"], tp["d"], tp["vocab"]):
        raise RuntimeError(f"unexpected config {cfg}")
    log(f"== full-width training: {arch}, B={BATCH}, S={TRAIN_SEQ}, {TRAIN_STEPS} AdamW steps")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    opt, opts = adamw.AdamWConfig(**TRAIN_OPT), ts.TrainOptions()
    state = ts.init_state(cfg, opt, opts, seed=0, device="cuda")
    torch.cuda.synchronize()
    rec = dict(card=card, init_s=time.perf_counter() - t0,
               init_gib=torch.cuda.memory_allocated() / 2**30)
    batches = train_batches(cfg, TRAIN_SEQ, TRAIN_STEPS)
    kernel, plain = HSAEngine(), HSAEngine(HSAConfig(kernel_impl="ref"))
    model, want = state["model"], train_launches(cfg, TRAIN_SEQ)

    t1 = time.perf_counter()
    hopper.reset_launches()
    loss_k, _, g_k = ts.gradients(model, batches[0], cfg, kernel, opts)
    if dict(hopper.LAUNCHES) != want:
        raise RuntimeError(f"{arch} train gradients: launches {dict(hopper.LAUNCHES)}, "
                           f"expected {want}")
    _, _, again = ts.gradients(model, batches[0], cfg, kernel, opts)
    if not torch.equal(again["embed"], g_k["embed"]):
        raise RuntimeError(f"{arch}: the embedding's gradient differs between two runs")
    rec["leaves_not_bit_equal_on_rerun"] = [n for n in g_k if not torch.equal(again[n], g_k[n])]
    del again
    # In bf16 (the path as it trains): recorded, not gated.  One f32
    # difference in a block's output moves a bf16 rounding of the residual
    # stream, and 24 layers carry it on (ROADMAP C); the one-ulp control
    # (`_nudged_control`) shows what such a difference does without a kernel.
    loss_p, _, g_p = ts.gradients(model, batches[0], cfg, plain, opts)
    worst, at = _grad_diff(f"{arch} step 0 (bf16)", g_k, g_p, float("inf"))
    rec["bf16"] = dict(loss_rel_err=abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
                       grad_rel_err=worst, worst_leaf=at, worst_leaves=_worst_leaves(g_k, g_p),
                       loss=loss_k.item(), plain_loss=loss_p.item())
    del g_k
    if cfg.family == "retnet":
        rec["bf16"]["nudged_control"] = _nudged_control(
            f"{arch} bf16 control", cfg, model, batches[0], plain, opts, loss_p, g_p)
    del g_p
    rec["f32_stream"] = train_gate_f32(arch, cfg, model, batches[0], kernel, plain, opts)
    rec.update(leaves=len(lm.train_leaves(model)), compare_s=time.perf_counter() - t1)
    # The step's own peak: from here on, without the comparisons' copies.
    rec["phase_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()

    step = ts.train_step_fn(cfg, kernel, opt, opts)
    counted = dict.fromkeys(hopper.COUNTERS, 0)
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        hopper.reset_launches()
        t = time.perf_counter()
        state, metrics = step(state, batches[i])
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t)
        if dict(hopper.LAUNCHES) != want:
            raise RuntimeError(f"{arch} step {i}: launches {dict(hopper.LAUNCHES)}, "
                               f"expected {want}")
        for k in counted:
            counted[k] += hopper.LAUNCHES[k]
    if not all(abs(x) < float("inf") for x in losses):
        raise RuntimeError(f"{arch}: losses {losses}")
    step_s = sorted(times[1:])[len(times[1:]) // 2]
    flops = train_step_flops(cfg, sum(t.numel() for t in lm.train_leaves(model).values()),
                             BATCH, TRAIN_SEQ)
    peaks = card_peaks(torch.cuda.get_device_name(0))
    rec.update(losses=losses, step_ms=step_s * 1e3, step_ms_runs=[x * 1e3 for x in times],
               tokens_per_s=BATCH * TRAIN_SEQ / step_s, step_flops=flops,
               flop_rate_share_f32=flops / step_s / peaks["f32"],
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               phase_peak_gib=max(rec["phase_peak_gib"],
                                  torch.cuda.max_memory_allocated() / 2**30),
               launches_per_step=want, lr=float(metrics["lr"]),
               grad_norm=float(metrics["grad_norm"]))
    rec.update(profile_train_step(step, state, batches[-1]))
    rec["train_s"] = time.perf_counter() - t0
    log(f"{arch} training: {json.dumps(rec)}")
    out = {f"{arch} train": rec}
    if cfg.family == "retnet":
        out[f"{arch} trained, served"] = serve_trained(cfg, state, card)
    del state, model, step
    gc.collect()
    torch.cuda.empty_cache()
    return counted, out


def serve_trained(cfg, state: dict, card: str) -> dict:
    """The trained full-width model through `from_config(model=state)`: the
    optimizer dropped from the state, the masters detached and deployed,
    then `generate` through the captured decode step with exact launches,
    against the eager loop bit for bit."""
    t0 = time.perf_counter()
    eng = InferenceEngine.from_config(cfg, EngineSpec(), model=state, device="cuda")
    if set(state) != {"model"} or any(p.requires_grad for p in eng.model.parameters()):
        raise RuntimeError("from_config kept the optimizer or a trainable master")
    s, new = TRAIN_SERVE
    prompts = torch.randint(1, cfg.vocab_size, (BATCH, s), generator=_gen(5), device="cuda")
    gen = GenerationConfig(max_new_tokens=new)
    first = eng.generate(prompts, gen)
    hopper.reset_launches()
    res = eng.generate(prompts, gen)
    launches = dict(hopper.LAUNCHES)
    want_p, want_s = expected_launches(RETNET, s)
    want = {k: want_p[k] + want_s[k] * res.decode_steps for k in hopper.COUNTERS}
    if launches != want or not torch.equal(res.tokens, first.tokens):
        raise RuntimeError(f"trained retnet: launches {launches}, expected {want}")
    got, cache = eager_generate(eng, prompts, gen)
    _same_as_graph("trained retnet", res, eng._graphs[eng.graph_key(cache, gen)].state.cache,
                   got, cache)
    rec = dict(card=card, prompt=s, new=new, launches=launches, capture_s=first.capture_s,
               prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_token=res.decode_s * 1e3 / res.decode_steps,
               graph_and_eager_bit_identical=True,
               resident_gib=torch.cuda.memory_allocated() / 2**30,
               seconds=time.perf_counter() - t0)
    log(f"trained retnet-1.3b served: {json.dumps(rec)}")
    del eng
    return rec


def train_reduced_vs_cpu(arch: str) -> dict:
    """Reduced ``arch`` on the card against the port on the CPU, same
    weights and batch (S TRAIN_REDUCED_SEQ): the loss at 1e-4 and every
    gradient at 1e-4 of its leaf's max (f32 masters), launches exact."""
    cfg = configs.get_config(arch).reduced()
    cpu = lm.init(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    batch = train_batches(cfg, TRAIN_REDUCED_SEQ, 1)[0]
    opts = ts.TrainOptions()
    for m in (cpu, card):
        lm.set_trainable(m)
    hopper.reset_launches()
    loss_c, _, g_c = ts.gradients(card, batch, cfg, HSAEngine(), opts)
    if dict(hopper.LAUNCHES) != train_launches(cfg, TRAIN_REDUCED_SEQ):
        raise RuntimeError(f"reduced {arch} train: launches {dict(hopper.LAUNCHES)}")
    loss_h, _, g_h = ts.gradients(cpu, {k: v.cpu() for k, v in batch.items()}, cfg,
                                  HSAEngine(), opts)
    rel = abs(loss_c.item() - loss_h.item()) / abs(loss_h.item())
    if rel > 1e-4:
        raise RuntimeError(f"reduced {arch} train: loss {loss_c.item()} against the CPU's "
                           f"{loss_h.item()}")
    worst, at = _grad_diff(f"reduced {arch} train", {n: g.cpu() for n, g in g_c.items()},
                           g_h, 1e-4)
    log(f"reduced {arch} training, card against CPU: loss rel err {rel:.3e}, gradients "
        f"{worst:.3e} of max")
    return {f"reduced {arch} train": dict(loss_rel_err=rel, grad_rel_err=worst, worst_leaf=at,
                                          seq=TRAIN_REDUCED_SEQ)}


def train_checkpoint_round_trip() -> dict:
    """Reduced retnet with bf16 masters on the card: two steps, a save
    (async), a third step; a fresh state restored from the save takes the
    same third step to a bit-equal loss, and its tensors equal the saved
    ones bit for bit (bf16 kept)."""
    import tempfile
    cfg = dataclasses.replace(configs.get_config("retnet-1.3b").reduced(), param_dtype="bfloat16")
    opt, opts = adamw.AdamWConfig(**TRAIN_OPT), ts.TrainOptions()
    step = ts.train_step_fn(cfg, HSAEngine(), opt, opts)
    batches = train_batches(cfg, TRAIN_REDUCED_SEQ, 3)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = ckpt_lib.CheckpointManager(tmp, keep_n=2)
        state = ts.init_state(cfg, opt, opts, seed=0, device="cuda")
        for i in range(2):
            state, _ = step(state, batches[i])
        mgr.save(1, ts.state_tensors(state), blocking=False)
        saved = {n: t.clone() for n, t in ts.state_tensors(state).items()}
        _, m3 = step(state, batches[2])
        fresh = ts.init_state(cfg, opt, opts, seed=1, device="cuda")
        _, manifest = mgr.restore(ts.state_tensors(fresh))
        same = all(torch.equal(t, saved[n]) for n, t in ts.state_tensors(fresh).items())
        _, r3 = step(fresh, batches[2])
        if manifest["step"] != 1 or not same or not torch.equal(m3["loss"], r3["loss"]):
            raise RuntimeError(f"checkpoint round trip: step {manifest['step']}, tensors "
                               f"equal {same}, losses {m3['loss']} / {r3['loss']}")
    log(f"checkpoint round trip (reduced retnet, bf16): resumed loss {r3['loss'].item()} "
        "bit-equal")
    return {"checkpoint round trip": dict(bit_equal=True, tensors=len(saved),
                                          loss=r3["loss"].item())}


def train_phase(card: str) -> tuple[dict, dict]:
    """Phase 4b: both training paths at full width, then the reduced models
    against the CPU and the checkpoint round trip."""
    t0 = time.perf_counter()
    by_path, results = {}, {}
    for tp in TRAIN_PATHS:
        counted, out = train_full_width(tp, card)
        by_path[f"{tp['arch']} train"] = counted
        results.update(out)
    for arch in ("retnet-1.3b", "internlm2-1.8b"):
        results.update(train_reduced_vs_cpu(arch))
    results.update(train_checkpoint_round_trip())
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    return by_path, results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"{name} is sm_{cap[0]}{cap[1]}; the kernels target sm_90a")
    peaks = card_peaks(name)
    torch.backends.cuda.matmul.allow_tf32 = False    # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    log("python", sys.version.split()[0], "torch", torch.__version__, "cuda",
        torch.version.cuda)

    t0 = time.perf_counter()
    reports = hopper.build()
    for kname, rep in reports.items():
        log(f"built {kname}: {json.dumps(ptxas_summary(rep))}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    log("== kernel phases (full-width shapes; times in ms, median, cold L2)")
    one = torch.zeros(1, device="cuda")
    log(f"time_ms floor (one 1-element fill per replay): {time_ms(lambda: one.fill_(1.0)):.4f}")
    ones = [torch.zeros(1, device="cuda") for _ in range(RMS_AMORTISED)]
    log(f"amortised_ms floor ({RMS_AMORTISED} 1-element fills per replay): "
        f"{amortised_ms(lambda t: t.fill_(1.0), ones):.4f}")
    entries = [
        summarize("mxint4_matmul", kernel_phase_mxint4(peaks), "per_step",
                  "rtol=atol=1e-5"),
        summarize("w8a8_matmul", kernel_phase_w8a8(peaks), "per_prefill", "exact"),
        summarize("retention_chunkwise", kernel_phase_retention(peaks), "per_prefill",
                  "rtol=atol=1e-4"),
        summarize("flash_decode", kernel_phase_flash_decode(peaks), "per_step",
                  "rtol=2e-5, atol=2e-6"),
        summarize("flash_decode_mla", kernel_phase_flash_decode_mla(peaks), "per_step",
                  "rtol=2e-5, atol=2e-6"),
        summarize("rmsnorm_stats", kernel_phase_rmsnorm_stats(peaks), "per_call",
                  "rtol=atol=1e-6"),
        summarize("mxint4_expert_matmul", kernel_phase_mxint4_expert(peaks), "per_step",
                  "rtol=atol=1e-5"),
        summarize("retention_chunkwise_bwd", kernel_phase_retention_bwd(peaks), "per_step",
                  "1e-4 of max|plain| (autograd of the plain version)"),
    ]
    for e in entries:
        for r in e["shapes"]:
            extra = "".join(f" {key} {r[key]}" for key in (
                "library_rowmajor_ms", "library_gqa_ms", "library_backend",
                "library_max_abs_err", "rate", "library_rate", "bound_share",
                "bound_f32_ms", "bound_share_f32", "plain_contiguous_ms", "flops",
                "warm_state_max_abs_err", "f64_max_abs_err", "amortised_ms", "per_lane_ms",
                "per_lane_kv_len", "per_lane_max_abs_err",
                "amortised_bound_share", "nearest_library_ms", "whole_stack_ms",
                "distinct_experts", "site", "launch_kernels", "plan")
                if key in r)
            log(f"  {e['name']} {r['path']} {r['shape']}: kernel {r['ms']:.4f} (per call "
                f"{r['call_ms']:.4f}) plain {r['plain_ms']:.4f} library "
                f"{r['library_ms']} bound {r['bound_ms']:.4f} ({r['bound_by']}) "
                f"err {r['max_abs_err']:.2e}{extra}")
    rms = next(e for e in entries if e["name"] == "rmsnorm_stats")
    rms["sigma_chain"] = sigma_chain_price()
    for r in rms["sigma_chain"]:
        log(f"  sigma^-1 price: {json.dumps(r)}")
    scan = scan_phase()
    log(f"kernel phases: {time.perf_counter() - t0:.1f} s")

    serving, by_path, admitted, scheduled, prefixed, speculated = {}, {}, {}, {}, {}, {}
    serving["selective_scan"] = scan
    trained, training = train_phase(smi)
    serving.update(training)
    for path in PATHS:
        (by_path[path["arch"]], admitted[path["arch"]], scheduled[path["arch"]],
         prefixed[path["arch"]], speculated[path["arch"]], results) = serve_full_width(path,
                                                                                       smi)
        serving.update(results)
    t0 = time.perf_counter()
    counted, results = serve_mtp(DS3_MTP, smi)
    log(f"ds3_mtp cell: {time.perf_counter() - t0:.1f} s")
    by_path[DS3_MTP["arch"]] = counted
    for phase in (admitted, scheduled, prefixed, speculated):
        phase[DS3_MTP["arch"]] = dict.fromkeys(hopper.COUNTERS, 0)
    by_path.update(trained)
    serving.update(results)
    t0 = time.perf_counter()
    for path in PATHS + (DS3_MOE,):
        serving.update(reduced_vs_cpu(path))
    log(f"reduced models against the CPU: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    serving["serve CLI"] = serve_cli()
    log(f"serve CLI: {time.perf_counter() - t0:.1f} s")
    for e in entries:
        e["launches_by_path"] = {arch: n[e["name"]] for arch, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        e["admission_launches_by_path"] = {arch: n[e["name"]]
                                           for arch, n in admitted.items()}
        e["scheduler_launches_by_path"] = {arch: n[e["name"]]
                                           for arch, n in scheduled.items()}
        e["prefix_launches_by_path"] = {arch: n[e["name"]] for arch, n in prefixed.items()}
        e["speculative_launches_by_path"] = {arch: n[e["name"]]
                                             for arch, n in speculated.items()}
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"serving": serving}))
    log(json.dumps({"selective_scan (plain PyTorch, not a kernel)": scan}))
    log(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
