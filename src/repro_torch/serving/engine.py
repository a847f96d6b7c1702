"""`InferenceEngine` — the one public entry point for serving a model.

    lm.init -> deploy.deploy_quantize -> HSAEngine -> prefill
            -> (KV cache encoded to ``gen.cache_format``) -> decode loop

The reference fuses its decode loop into one jitted ``lax.while_loop``.
Here one body of that loop is `InferenceEngine._step`, in the reference's
order: ``out[:, i]`` takes the token sampled before decode step ``i`` (the
first from the prefill logits), slots after a sequence's stop token hold
``pad_token_id``, ``lengths`` counts emitted tokens including the stop
token, then `lm.forward_decode` and the next sample.  The step reads and
writes only device state (the position and ``i`` included) in place, so:

* on the card, `generate` captures the step once as a CUDA graph on static
  decode buffers, one set per cache layout and `GenerationConfig`
  (the cache is copied into them at the prefill/decode boundary),
  and replays it ``max_new_tokens`` times; a repeated key does not capture
  again.  A capture that fails raises: there is no eager fallback;
* on the CPU, `generate` runs the same step eagerly, so the CPU parity
  tests run the very code that is captured.

The graph is keyed on the decode cache's layout (every tensor's shape and
dtype: batch, capacity and format) and the `GenerationConfig`, not on the
prompt, so `generate` and `resume_generate` (decode resumed from a warm
cache, with no prefill) share a graph whenever their caches match.

Admission paths besides monolithic prefill, as the reference has them:
``prefill(bucket=True)`` pads a prompt to the power-of-two ladder
(`bucket_length`) and passes its real length as a device scalar;
`ChunkedPrefill` (`begin_chunked_prefill`, `prefill_chunked`) runs a prompt
as exact ladder-sized chunks (`chunk_schedule`) into a warm cache, optionally
adopting a prefix that is already warm (``start_offset``).

A `RequestScheduler` decodes each slot class of its pool with a
`ClassStep`: the same step body over the class's stacked store (a decode
cache whose lanes each hold their own position), captured once per class on
the card and replayed, run eagerly on the CPU.

The loop reads the device only to end early when every sequence has
stopped, and only when stop tokens were given.  Prefill and decode are
timed on the host clock around work that ends in
``torch.cuda.synchronize()``.

Usage::

    engine = InferenceEngine.from_config("qwen3-8b", EngineSpec())
    result = engine.generate(prompts, GenerationConfig(max_new_tokens=32,
                                                       cache_format="int8_tok"))
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.core.hsa import HSAConfig, HSAEngine
from repro_torch.models import deploy, lm
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.serving.sampling import GenerationConfig, sample

# Prompt-length bucket ladder: prompts pad (bucketed) or decompose (chunked)
# to powers of two >= this floor.
MIN_BUCKET = 8


class CacheCapacityError(ValueError):
    """A request needs more KV slots than its cache provides.

    Raised at admission (`ChunkedPrefill`) instead of letting the linear
    cache's decode path clamp its write slot and overwrite its own last row
    on every later step."""


def bucket_length(s: int) -> int:
    """Smallest ladder bucket (power of two >= MIN_BUCKET) holding s tokens."""
    if s < 1:
        raise ValueError(f"prompt length must be >= 1, got {s}")
    b = MIN_BUCKET
    while b < s:
        b *= 2
    return b


def chunk_schedule(s: int, chunk_size: int) -> list[int]:
    """Decompose a prompt of length s into exact ladder-sized chunks: full
    ``chunk_size`` chunks, then the remainder as its descending powers of
    two (its binary decomposition).  Nothing is padded, so the RetNet state
    continues exactly; MIN_BUCKET is not applied here, as in the
    reference."""
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    sched = [chunk_size] * (s // chunk_size)
    rem = s % chunk_size
    p = 1
    while p <= rem:
        p *= 2
    p //= 2
    while rem:
        if p <= rem:
            sched.append(p)
            rem -= p
        p //= 2
    return sched


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """How to build the serving stack around a model config.

    The default is the paper's deployment: W8A8 prefill (MMM dataflow) and
    MXINT4 decode (MVM dataflow) with the Eq. (4) fused RMSNorm and the
    online RoPE unit.  ``kernel_impl='auto'`` runs the Hopper kernels on
    CUDA tensors and their plain versions on CPU tensors.
    """

    quantize: bool = True               # PTQ-deploy master weights
    prefill_format: str = "w8a8"        # 'w8a8' | 'fp'
    decode_format: str = "mxint4"       # 'mxint4' | 'w8a8' | 'fp'
    fuse_rmsnorm: bool = True           # C3 ablation switch
    kernel_impl: str = "auto"           # 'auto' | 'kernel' | 'ref'
    reduced: bool = False               # use cfg.reduced() (CPU-scale)
    seed: int = 0                       # init seed when no model is supplied

    def hsa_config(self) -> HSAConfig:
        return HSAConfig(
            prefill_format=self.prefill_format if self.quantize else "fp",
            decode_format=self.decode_format if self.quantize else "fp",
            fuse_rmsnorm=self.fuse_rmsnorm, kernel_impl=self.kernel_impl)


@dataclasses.dataclass
class GenerationResult:
    """Output of `InferenceEngine.generate`."""

    tokens: torch.Tensor     # int64 [B, max_new_tokens]; pad after stop token
    lengths: torch.Tensor    # int32 [B] — emitted tokens incl. the stop token
    prefill_s: float         # wall-clock MMM phase (0 for a resumed decode)
    decode_s: float          # wall-clock MVM phase (a capture included)
    decode_steps: int = 0    # forward_decode calls the loop made
    capture_s: float = 0.0   # wall-clock warm-up and capture of the step graph
    next_token: torch.Tensor | None = None  # int64 [B]: sampled after the last
    #   step; the ``pending`` token that resumes the loop from its final cache


@dataclasses.dataclass
class DecodeState:
    """The decode loop's carry, as the reference's ``while_loop`` state, all
    on the device; `InferenceEngine._step` updates it in place."""

    i: torch.Tensor          # i64 scalar: the column of ``out`` written next
    tok: torch.Tensor        # i64 [B]: the token emitted and fed next
    cache: dict              # the decode cache (`lm.forward_decode`)
    done: torch.Tensor       # bool [B]: the sequence has emitted a stop token
    out: torch.Tensor        # i64 [B, max_new_tokens]
    lengths: torch.Tensor    # i32 [B]

    @classmethod
    def start(cls, tok: torch.Tensor, cache: dict, gen: GenerationConfig
              ) -> "DecodeState":
        """The loop's initial state around ``cache``, which the steps then
        update in place."""
        b, dev = tok.shape[0], tok.device
        return cls(i=torch.zeros((), dtype=torch.long, device=dev), tok=tok.clone(),
                   cache=cache, done=torch.zeros(b, dtype=torch.bool, device=dev),
                   out=torch.full((b, gen.max_new_tokens), gen.pad_token_id,
                                  dtype=torch.long, device=dev),
                   lengths=torch.zeros(b, dtype=torch.int32, device=dev))

    def reset(self, tok: torch.Tensor, cache: dict, gen: GenerationConfig) -> None:
        """Load the initial state of another run into these buffers."""
        self.i.zero_()
        self.tok.copy_(tok)
        _write_back(self.cache, cache)
        self.done.zero_()
        self.out.fill_(gen.pad_token_id)
        self.lengths.zero_()


def tree_map(fn, tree):
    """A cache tree of the same structure with ``fn`` applied to every
    tensor (dicts, lists and dataclasses such as `OnlineRopeState`)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                        for f in dataclasses.fields(tree)})


def _clone(tree):
    """A copy of a cache tree with every tensor cloned."""
    return tree_map(torch.Tensor.clone, tree)


def tree_items(tree, prefix: str = ""):
    """(path, tensor) of every tensor of a cache tree, in a fixed order
    (dict entries by name)."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}/{i}")
    else:
        for f in dataclasses.fields(tree):
            yield from tree_items(getattr(tree, f.name), f"{prefix}/{f.name}")


def tree_nbytes(tree) -> int:
    """Bytes of every tensor of a cache tree: the currency of the host-spill
    tier's transfer accounting (the reference's ``pytree_nbytes``)."""
    return sum(t.numel() * t.element_size() for _, t in tree_items(tree))


def _write_back(dst, src) -> None:
    """Copy the tensors of the cache tree ``src`` into the same places of
    ``dst`` (a leaf that a step updated in place is the same tensor in both,
    and is skipped)."""
    for (_, d), (_, s) in zip(tree_items(dst), tree_items(src)):
        if d is not s:
            d.copy_(s)


def _layout(tree) -> tuple:
    """Every tensor's path, shape and dtype in a cache tree: the key under
    which decode steps over such caches share one graph."""
    return tuple((path, tuple(t.shape), t.dtype) for path, t in tree_items(tree))


@dataclasses.dataclass
class _StepGraph:
    """One key's static decode buffers and the graph of one step on them."""

    state: DecodeState
    stop: torch.Tensor | None
    generator: torch.Generator | None   # registered with the graph
    graph: "torch.cuda.CUDAGraph"
    launches: dict                      # kernel launches one replay runs
    tickets: torch.Tensor               # the split-K counters the graph uses


class ChunkedPrefill:
    """One in-flight chunked prompt admission (MMM phase, cache-resident).

    Built by `InferenceEngine.begin_chunked_prefill`; each `advance` runs one
    chunk of `schedule` through `lm.forward_prefill_chunk`.  After the last,
    ``logits`` holds the last-token logits and ``cache`` the warm decode
    cache (equal, up to f32 summation order, to a monolithic `prefill` of
    the prompt on fp weights; on deployed weights the int8 activation scale
    of each chunk is its own).

    Prefix adoption: with ``start_offset=p`` and an ``initial_cache`` warm
    over positions [0, p), only ``tokens[:, p:]`` is scheduled.  The chunk
    reads its start from the cache's device ``pos``.  ``initial_cache`` is
    consumed (dense rows are written into it in place): hand in a private
    copy.  A fresh cache is built on the engine's device in ``cache_dtype``
    (f32, as the reference's default, or a kvq format name: rows are then
    encoded as they are appended).
    """

    def __init__(self, engine: "InferenceEngine", tokens: torch.Tensor, cache_len: int,
                 chunk_size: int, cache_dtype=torch.float32, *, initial_cache=None,
                 start_offset: int = 0):
        tokens = torch.as_tensor(tokens, device=engine.device).long()
        if tokens.ndim != 2:
            raise ValueError(f"tokens must be [B, S], got {tuple(tokens.shape)}")
        s = tokens.shape[1]
        if s < 1:
            raise ValueError("prompt must have at least one token")
        if s > cache_len:
            raise CacheCapacityError(f"prompt ({s}) exceeds cache_len ({cache_len})")
        if not 0 <= start_offset < s:
            raise ValueError(f"start_offset ({start_offset}) must be in "
                             f"[0, prompt length {s})")
        if start_offset and initial_cache is None:
            raise ValueError("start_offset > 0 requires an initial_cache "
                             "warm over the adopted prefix")
        self.engine = engine
        self.tokens = tokens
        self.schedule = chunk_schedule(s - start_offset, chunk_size)
        if initial_cache is None:
            initial_cache = lm.make_decode_cache(engine.cfg, tokens.shape[0], cache_len,
                                                 dtype=cache_dtype, device=engine.device)
        self.cache = initial_cache
        self.start_offset = start_offset
        self.logits: torch.Tensor | None = None
        self._off = start_offset
        self._next = 0

    @property
    def done(self) -> bool:
        return self._next >= len(self.schedule)

    @property
    def n_chunks(self) -> int:
        return len(self.schedule)

    @torch.inference_mode()
    def advance(self) -> torch.Tensor | None:
        """Run one chunk; returns the final logits once all chunks ran."""
        if self.done:
            return self.logits
        c = self.schedule[self._next]
        eng = self.engine
        with eng.obs.annotation("engine.prefill_chunk"):
            self.logits, self.cache = lm.forward_prefill_chunk(
                eng.model, self.tokens[:, self._off:self._off + c], self.cache, eng.cfg,
                eng.hsa)
        eng.obs.metrics.counter("engine.prefill_chunks").inc()
        eng.obs.metrics.histogram("engine.prefill_chunk_tokens").record(c)
        self._off += c
        self._next += 1
        return self.logits if self.done else None


class ClassStep:
    """The decode step of one slot class: `lm.forward_decode` over the
    class's stacked ``store`` (a decode cache of ``N`` lanes, each at its own
    position: ``lm.make_decode_cache(..., per_lane=True)``) with each lane's
    token in ``tok``, then each lane's next token sampled into ``tok``; the
    tokens fed are left in ``fed``.  Free lanes compute garbage that is
    never read (their positions clamp, so nothing overruns), as in the
    reference's vmapped pool step.

    ``store``, ``tok`` and ``fed`` are the step's static buffers, updated in
    place: a scheduler writes a lane's cache and token into them, and reads
    and spills from them, without copying the store.  On the card the step
    is captured once, here, on the cold store (after one eager warm-up step
    on a side stream), and the store is put back to its cold state after;
    `run` replays it.  On the CPU `run` runs the same body eagerly.

    Stochastic sampling draws lane l from ``generators[l]`` alone (registered
    with the graph), so a request's tokens depend on its own generator's
    state and not on its lane or its co-tenants; greedy draws nothing."""

    def __init__(self, engine: "InferenceEngine", store: dict, gen: GenerationConfig):
        self.engine, self.store, self.gen = engine, store, gen
        n, dev = store["pos"].shape[0], engine.device
        self.tok = torch.zeros(n, dtype=torch.long, device=dev)
        self.fed = torch.zeros(n, dtype=torch.long, device=dev)
        self.generators = (None if gen.sampling.greedy else
                           [torch.Generator(device=dev) for _ in range(n)])
        self.graph = self.tickets = None
        self.launches: dict = {}              # kernel launches one replay runs
        self.capture_s = 0.0
        self.replays = 0                      # steps run (replays on the card)
        if dev.type == "cuda":
            self._capture()

    @torch.inference_mode()
    def body(self) -> None:
        """One step on the static buffers, in place."""
        eng, sampling = self.engine, self.gen.sampling
        self.fed.copy_(self.tok)
        logits, cache = lm.forward_decode(eng.model, self.tok[:, None], self.store, eng.cfg,
                                          eng.hsa)
        _write_back(self.store, cache)
        if self.generators is None:
            self.tok.copy_(sample(logits, sampling))
        else:
            for lane, g in enumerate(self.generators):
                self.tok[lane:lane + 1].copy_(sample(logits[lane:lane + 1], sampling, g))

    def run(self) -> None:
        """One step: a replay on the card, the eager body on the CPU."""
        self.replays += 1
        if self.graph is None:
            self.body()
            return
        from repro_torch.kernels import hopper
        self.graph.replay()
        hopper.count_replay(self.launches)

    @torch.inference_mode()
    def _capture(self) -> None:
        from repro_torch.kernels import hopper
        t0 = time.perf_counter()
        cold = _clone(self.store)
        dev = self.engine.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators or ():
            graph.register_generator_state(g)
        with hopper.captured_launches() as launches, torch.cuda.graph(graph):
            self.body()
        _write_back(self.store, cold)
        self.tok.zero_()
        self.fed.zero_()
        self.graph, self.launches = graph, launches
        self.tickets = hopper.ticket_counters(dev)
        self.engine._sync()
        self.capture_s = time.perf_counter() - t0


class InferenceEngine:
    """Deployed model + HSA engine + prefill / decode loop.

    ``obs`` (an `Observability` bundle) receives the engine's metrics
    (``engine.prefill_chunks``, ``engine.prefill_chunk_tokens``) and wraps
    its dispatch sites in profiler ranges when profiling is on."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, spec: EngineSpec,
                 hsa: HSAEngine | None = None, *, obs: Observability | None = None):
        self.cfg = cfg
        self.model = model
        self.spec = spec
        self.hsa = hsa or HSAEngine(spec.hsa_config())
        self.device = model.embed.device
        self.obs = obs if obs is not None else Observability()
        self._graphs: dict[tuple, _StepGraph] = {}    # captured steps by key

    @classmethod
    def from_config(cls, cfg: ModelConfig | str, spec: EngineSpec = EngineSpec(),
                    *, model: lm.LM | None = None, device="cuda",
                    obs: Observability | None = None) -> "InferenceEngine":
        """Build the serving stack: init (or adopt) a model, PTQ-deploy it in
        place when ``spec.quantize`` and it still has master weights, and
        wire the HSA engine.

        ``device`` defaults to the card; the CPU runs only when asked for.
        """
        if isinstance(cfg, str):
            cfg = configs.get_config(cfg)
        if spec.reduced:
            cfg = cfg.reduced()
        lm._check_family(cfg)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch path on the CPU")
        if model is None:
            model = lm.init(cfg, seed=spec.seed, device=device)
        if spec.quantize and deploy.is_master(model):
            deploy.deploy_quantize(model)
        return cls(cfg, model, spec, obs=obs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int | None = None,
                bucket: bool = False) -> tuple[torch.Tensor, dict]:
        """MMM phase: prompts [B, S] -> (last-token logits [B, V], cache).

        ``cache_len`` (default S) is the KV slots a dense model's cache
        holds: S plus the tokens decode will append.

        ``bucket=True`` pads the prompt with zeros up to `bucket_length` and
        passes the real length as an int32 device scalar: the logits and the
        cache's position are the real prompt end's.  ``cache_len`` is rounded
        up onto the same ladder, and is at least the bucket, as the
        reference's is."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        s = tokens.shape[1]
        if not bucket:
            return lm.forward_prefill(self.model, tokens, self.cfg, self.hsa,
                                      cache_len=cache_len or s)
        b = bucket_length(s)
        if b > s:
            tokens = F.pad(tokens, (0, b - s))
        valid_len = torch.tensor(s, dtype=torch.int32, device=self.device)
        return lm.forward_prefill(self.model, tokens, self.cfg, self.hsa,
                                  cache_len=bucket_length(max(cache_len or s, b)),
                                  valid_len=valid_len)

    def begin_chunked_prefill(self, tokens: torch.Tensor, *, cache_len: int,
                              chunk_size: int = 32, cache_dtype=torch.float32,
                              initial_cache=None, start_offset: int = 0
                              ) -> ChunkedPrefill:
        """Start a chunk-granular admission; the caller paces `advance()`.
        ``initial_cache``/``start_offset`` adopt an already-warm prefix (see
        `ChunkedPrefill`)."""
        return ChunkedPrefill(self, tokens, cache_len, chunk_size, cache_dtype,
                              initial_cache=initial_cache, start_offset=start_offset)

    def prefill_chunked(self, tokens: torch.Tensor, *, cache_len: int,
                        chunk_size: int = 32, cache_dtype=torch.float32
                        ) -> tuple[torch.Tensor, dict]:
        """Drive a chunked prefill to completion: (last logits [B, V], cache)."""
        cp = self.begin_chunked_prefill(tokens, cache_len=cache_len, chunk_size=chunk_size,
                                        cache_dtype=cache_dtype)
        while not cp.done:
            cp.advance()
        return cp.logits, cp.cache

    @torch.inference_mode()
    def decode_step(self, tokens: torch.Tensor, cache: dict
                    ) -> tuple[torch.Tensor, dict]:
        """One MVM step, eagerly: tokens [B, 1] + warm cache -> (logits [B, V],
        cache)."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return lm.forward_decode(self.model, tokens, cache, self.cfg, self.hsa)

    @torch.inference_mode()
    def generate(self, prompts: torch.Tensor,
                 gen: GenerationConfig = GenerationConfig(), *,
                 generator: torch.Generator | None = None) -> GenerationResult:
        """Prefill + decode loop.  prompts [B, S] -> GenerationResult.

        ``generator`` seeds stochastic sampling (a fixed seed when absent)
        and is advanced as the eager loop would advance it; greedy decoding
        draws nothing.  On the card the decode steps are replays of one
        captured step (see the module docstring).
        """
        prompts = torch.as_tensor(prompts, device=self.device).long()
        if generator is None and not gen.sampling.greedy:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)

        self._sync()
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompts, cache_len=prompts.shape[1] + gen.max_new_tokens)
        cache = self._encode_cache(cache, gen)
        self._sync()
        t_prefill = time.perf_counter() - t0

        t0 = time.perf_counter()
        tok = sample(logits, gen.sampling, generator)
        return self._decode_from(tok, cache, gen, generator, t0, t_prefill)

    @torch.inference_mode()
    def resume_generate(self, pending: torch.Tensor, cache: dict,
                        gen: GenerationConfig = GenerationConfig(), *,
                        generator: torch.Generator | None = None) -> GenerationResult:
        """Resume the decode loop from a pending token and a warm decode
        cache (a chunked prefill's, or one fetched back from elsewhere): no
        prefill runs, and the cache is used as it is (its format is kept;
        ``gen.cache_format`` is not applied).

        ``pending`` is int ``[B]`` (or a scalar for a batch-1 cache): the
        token sampled before the interruption, which becomes the first
        emitted token.  On the card the steps are replays of the graph keyed
        on this cache's layout (shared with `generate` when the caches
        match), and the final cache is copied back into ``cache``; on the
        CPU the same `_step` runs eagerly on ``cache``.  Either way ``cache``
        leaves warm over every token fed, and the result's ``next_token``
        is the pending token of a further resume from it."""
        pending = torch.as_tensor(pending, device=self.device).long()
        if pending.ndim == 0:
            pending = pending[None]
        if generator is None and not gen.sampling.greedy:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self._sync()
        return self._decode_from(pending, cache, gen, generator, time.perf_counter(), 0.0,
                                 keep_cache=True)

    def _decode_from(self, tok: torch.Tensor, cache: dict, gen: GenerationConfig,
                     generator: torch.Generator | None, t0: float, t_prefill: float,
                     *, keep_cache: bool = False) -> GenerationResult:
        """The decode loop from the first emitted token ``tok`` and ``cache``:
        replays on the card, the eager step on the CPU.  ``keep_cache``
        copies the replays' final cache back into ``cache`` (the eager loop
        works on ``cache`` itself)."""
        if self.device.type == "cuda":
            st, steps, t_capture = self._replay(tok, cache, gen, generator)
            if keep_cache:
                _write_back(cache, st.cache)
        else:
            st, t_capture = DecodeState.start(tok, cache, gen), 0.0
            stop = (torch.tensor(gen.stop_tokens, device=self.device)
                    if gen.stop_tokens else None)
            steps = self._loop(st, gen, lambda: self._step(st, gen, stop, generator))
        out, lengths, nxt = st.out.clone(), st.lengths.clone(), st.tok.clone()
        self._sync()
        return GenerationResult(tokens=out, lengths=lengths, prefill_s=t_prefill,
                                decode_s=time.perf_counter() - t0, decode_steps=steps,
                                capture_s=t_capture, next_token=nxt)

    @staticmethod
    def _loop(st: DecodeState, gen: GenerationConfig, step) -> int:
        """Run ``step`` up to ``max_new_tokens`` times, ending early once
        every sequence has stopped (read only when stop tokens were given):
        the reference's ``cond``.  Returns the steps run."""
        for n in range(1, gen.max_new_tokens + 1):
            step()
            if gen.stop_tokens and bool(st.done.all()):
                return n
        return gen.max_new_tokens

    def _step(self, st: DecodeState, gen: GenerationConfig, stop: torch.Tensor | None,
              generator: torch.Generator | None) -> None:
        """One body of the reference's decode loop, on ``st`` in place."""
        st.out.index_copy_(1, st.i.view(1),
                           torch.where(st.done, gen.pad_token_id, st.tok)[:, None])
        st.lengths += (~st.done).to(torch.int32)
        if stop is not None:
            st.done |= (st.tok[:, None] == stop[None, :]).any(dim=-1)
        logits, cache = lm.forward_decode(self.model, st.tok[:, None], st.cache,
                                          self.cfg, self.hsa)
        st.tok.copy_(sample(logits, gen.sampling, generator))
        _write_back(st.cache, cache)
        st.i += 1

    @staticmethod
    def graph_key(cache: dict, gen: GenerationConfig) -> tuple:
        """The key of the captured step that decodes from ``cache`` under
        ``gen``: the cache's layout (batch, capacity and format) and
        ``gen``."""
        return (_layout(cache), gen)

    def _replay(self, tok: torch.Tensor, cache: dict, gen: GenerationConfig,
                generator: torch.Generator | None) -> tuple[DecodeState, int, float]:
        """The decode loop on the card: this key's captured step (captured
        now if the key is new), replayed from the given state.  Launch
        counts are those the replays run."""
        from repro_torch.kernels import hopper
        key = self.graph_key(cache, gen)
        sg = self._graphs.get(key)
        t_capture = 0.0
        if sg is None:
            t0 = time.perf_counter()
            sg = self._capture(tok, cache, gen)
            self._graphs[key] = sg
            t_capture = time.perf_counter() - t0
        sg.state.reset(tok, cache, gen)
        if sg.generator is not None:
            sg.generator.set_state(generator.get_state())

        def step():
            sg.graph.replay()
            hopper.count_replay(sg.launches)

        steps = self._loop(sg.state, gen, step)
        if sg.generator is not None:
            generator.set_state(sg.generator.get_state())
        return sg.state, steps, t_capture

    def _capture(self, tok: torch.Tensor, cache: dict, gen: GenerationConfig) -> _StepGraph:
        """Static buffers for one key and the graph of one `_step` on them,
        after one eager warm-up step on a side stream (which builds the
        kernels, their plans, the split-K tickets and the library handles
        the step needs, none of which may be created inside a capture)."""
        from repro_torch.kernels import hopper
        st = DecodeState.start(tok, _clone(cache), gen)
        stop = (torch.tensor(gen.stop_tokens, device=self.device)
                if gen.stop_tokens else None)
        g = None
        if not gen.sampling.greedy:
            g = torch.Generator(device=self.device)
            g.manual_seed(0)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step(st, gen, stop, g)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if g is not None:
            graph.register_generator_state(g)
        with hopper.captured_launches() as launches, torch.cuda.graph(graph):
            self._step(st, gen, stop, g)
        return _StepGraph(state=st, stop=stop, generator=g, graph=graph, launches=launches,
                          tickets=hopper.ticket_counters(self.device))

    def cache_nbytes(self, cache_len: int, *, batch: int = 1, dtype=torch.float32) -> int:
        """Bytes of one decode cache at ``cache_len`` — what a `CachePool`
        lane holds on the device and what one host spill moves.  Computed on
        the meta device: no cache is materialized."""
        return tree_nbytes(lm.make_decode_cache(self.cfg, batch, cache_len, dtype=dtype,
                                                device="meta"))

    @torch.inference_mode()
    def _encode_cache(self, cache: dict, gen: GenerationConfig) -> dict:
        """Apply ``gen.cache_format`` at the prefill/decode boundary: prefill
        ran f32, the decode residency streams the encoded bytes."""
        if gen.cache_format is None:
            return cache
        return lm.quantize_cache(cache, self.cfg, gen.cache_format)
