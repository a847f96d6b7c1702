"""`repro_torch.serving` — the port's serving API, as the reference's
`repro.serving` exports it (the parts that are ported):

  * `InferenceEngine` / `EngineSpec` — init -> PTQ deploy -> HSA engine ->
    prefill and a decode loop captured as one CUDA graph per step on the
    card (engine.py).
  * `GenerationConfig` / `SamplingParams` — greedy, temperature, top-k,
    top-p, stop tokens, max_new_tokens, the KV-cache format (sampling.py).
  * `RequestScheduler` / `CachePool` / `Request` — continuous batching over
    slot classes with chunk-granular admissions, priorities, and a host
    spill tier with preemption; one captured decode step per class
    (scheduler.py).
  * `ChunkedPrefill` / `bucket_length` / `chunk_schedule` — the chunked and
    bucketed admission machinery (engine.py).
  * `ServingFrontend` / `FrontendConfig` / `TokenStream` — the asyncio
    open-loop front end with SLO-aware admission, on an injectable `Clock`
    (`MonotonicClock` live, `VirtualClock` for deterministic tests)
    (frontend.py, clock.py).
  * `Workload` / `PoissonArrivals` / `BurstyArrivals` / `LengthMix` /
    `run_open_loop` — seeded open-loop load and the goodput-under-load
    run (loadgen.py).

Not ported yet: the shared-prefix cache (ROADMAP A11b), speculative decode
(A10c) and serving on a device mesh (A12).
"""

from repro_torch.serving.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serving.engine import (CacheCapacityError, ChunkedPrefill, ClassStep,
                                        EngineSpec, GenerationResult, InferenceEngine,
                                        bucket_length, chunk_schedule, tree_nbytes)
from repro_torch.serving.frontend import (FrontendConfig, RequestShed, SLOAdmissionPolicy,
                                          ServingFrontend, TokenStream)
from repro_torch.serving.loadgen import (BurstyArrivals, GoodputReport, LengthMix,
                                         PoissonArrivals, Workload, run_open_loop)
from repro_torch.serving.sampling import GenerationConfig, SamplingParams, sample
from repro_torch.serving.scheduler import (CachePool, FinishedRequest, Request,
                                           RequestScheduler)

__all__ = [
    "BurstyArrivals", "CacheCapacityError", "CachePool", "ChunkedPrefill", "ClassStep",
    "Clock", "EngineSpec", "FinishedRequest", "FrontendConfig", "GenerationConfig",
    "GenerationResult", "GoodputReport", "InferenceEngine", "LengthMix",
    "MonotonicClock", "PoissonArrivals", "Request", "RequestScheduler", "RequestShed",
    "SamplingParams", "ServingFrontend", "SLOAdmissionPolicy", "TokenStream",
    "VirtualClock", "Workload", "bucket_length", "chunk_schedule", "run_open_loop",
    "sample", "tree_nbytes",
]
