"""`repro_torch.serving` — the port's serving API, as the reference's
`repro.serving` exports it (the parts that are ported):

  * `InferenceEngine` / `EngineSpec` — init -> PTQ deploy -> HSA engine ->
    prefill and a decode loop captured as one CUDA graph per step on the
    card (engine.py).
  * `GenerationConfig` / `SamplingParams` / `SpeculativeConfig` — greedy,
    temperature, top-k, top-p, stop tokens, max_new_tokens, the KV-cache
    format, speculative decode (sampling.py).
  * `NgramDrafter` / `MTPDrafter` / `Drafter` / `make_drafter` /
    `ngram_propose` — speculative decode: draft k tokens (prompt lookup, or
    deepseek-v3's MTP head chained k deep), verify them in one MMM
    dispatch, commit the accepted prefix with exact rollback, in `generate`
    and (the ngram drafter) in the scheduler's slot classes
    (speculative.py).
  * `RequestScheduler` / `CachePool` / `Request` — continuous batching over
    slot classes with chunk-granular admissions, priorities, and a host
    spill tier with preemption; one captured decode step per class
    (scheduler.py).
  * `PrefixCache` / `RadixPageIndex` / `SnapshotPrefixIndex` /
    `PageLeaseError` — shared-prefix reuse: refcounted immutable cache pages
    under a radix index, or whole-cache snapshots for recurrent archs,
    adopted at admission (paging.py; ``RequestScheduler(prefix_cache=True)``).
  * `ChunkedPrefill` / `bucket_length` / `chunk_schedule` — the chunked and
    bucketed admission machinery (engine.py).
  * `ServingFrontend` / `FrontendConfig` / `TokenStream` — the asyncio
    open-loop front end with SLO-aware admission, on an injectable `Clock`
    (`MonotonicClock` live, `VirtualClock` for deterministic tests)
    (frontend.py, clock.py).
  * `Workload` / `PoissonArrivals` / `BurstyArrivals` / `LengthMix` /
    `run_open_loop` — seeded open-loop load and the goodput-under-load
    run (loadgen.py).

Not ported yet: serving on a device mesh (ROADMAP A12).
"""

from repro_torch.serving.clock import Clock, MonotonicClock, VirtualClock
from repro_torch.serving.engine import (CacheCapacityError, ChunkedPrefill, ClassStep,
                                        EngineSpec, GenerationResult, InferenceEngine,
                                        SpecClassStep, bucket_length, chunk_schedule,
                                        tree_nbytes)
from repro_torch.serving.frontend import (FrontendConfig, RequestShed, SLOAdmissionPolicy,
                                          ServingFrontend, TokenStream)
from repro_torch.serving.loadgen import (BurstyArrivals, GoodputReport, LengthMix,
                                         PoissonArrivals, Workload, run_open_loop)
from repro_torch.serving.paging import (PageLeaseError, PrefixCache, RadixPageIndex,
                                        SnapshotPrefixIndex)
from repro_torch.serving.sampling import (GenerationConfig, SamplingParams,
                                          SpeculativeConfig, sample)
from repro_torch.serving.scheduler import (CachePool, FinishedRequest, Request,
                                           RequestScheduler)
from repro_torch.serving.speculative import (Drafter, MTPDrafter, NgramDrafter,
                                             make_drafter, ngram_propose)

__all__ = [
    "BurstyArrivals", "CacheCapacityError", "CachePool", "ChunkedPrefill", "ClassStep",
    "Clock", "Drafter", "EngineSpec", "FinishedRequest", "FrontendConfig",
    "GenerationConfig", "GenerationResult", "GoodputReport", "InferenceEngine",
    "LengthMix", "MonotonicClock", "MTPDrafter", "NgramDrafter", "PageLeaseError",
    "PoissonArrivals", "PrefixCache", "RadixPageIndex", "Request", "RequestScheduler", "RequestShed",
    "SamplingParams", "ServingFrontend", "SLOAdmissionPolicy", "SnapshotPrefixIndex",
    "SpecClassStep", "SpeculativeConfig", "TokenStream", "VirtualClock", "Workload",
    "bucket_length", "chunk_schedule", "make_drafter", "ngram_propose", "run_open_loop",
    "sample", "tree_nbytes",
]
