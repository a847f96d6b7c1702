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
  decode buffers, one set per batch, prompt length and `GenerationConfig`
  (prefill's cache is copied into them at the prefill/decode boundary),
  and replays it ``max_new_tokens`` times; a repeated key does not capture
  again.  A capture that fails raises: there is no eager fallback;
* on the CPU, `generate` runs the same step eagerly, so the CPU parity
  tests run the very code that is captured.

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

from repro_torch import configs
from repro_torch.core.hsa import HSAConfig, HSAEngine
from repro_torch.models import deploy, lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import GenerationConfig, sample


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
    prefill_s: float         # wall-clock MMM phase
    decode_s: float          # wall-clock MVM phase (a capture included)
    decode_steps: int = 0    # forward_decode calls the loop made
    capture_s: float = 0.0   # wall-clock warm-up and capture of the step graph


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


def _clone(tree):
    """A copy of a cache tree with every tensor cloned."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return dataclasses.replace(tree, **{f.name: _clone(getattr(tree, f.name))
                                        for f in dataclasses.fields(tree)})


def _write_back(dst, src) -> None:
    """Copy the tensors of the cache tree ``src`` into the same places of
    ``dst`` (a leaf that a step updated in place is the same tensor in both,
    and is skipped)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _write_back(dst[k], src[k])
    elif isinstance(dst, list):
        for a, b in zip(dst, src):
            _write_back(a, b)
    else:
        for f in dataclasses.fields(dst):
            _write_back(getattr(dst, f.name), getattr(src, f.name))


@dataclasses.dataclass
class _StepGraph:
    """One key's static decode buffers and the graph of one step on them."""

    state: DecodeState
    stop: torch.Tensor | None
    generator: torch.Generator | None   # registered with the graph
    graph: "torch.cuda.CUDAGraph"
    launches: dict                      # kernel launches one replay runs
    tickets: torch.Tensor               # the split-K counters the graph uses


class InferenceEngine:
    """Deployed model + HSA engine + prefill / decode loop."""

    def __init__(self, cfg: ModelConfig, model: lm.LM, spec: EngineSpec,
                 hsa: HSAEngine | None = None):
        self.cfg = cfg
        self.model = model
        self.spec = spec
        self.hsa = hsa or HSAEngine(spec.hsa_config())
        self.device = model.embed.device
        self._graphs: dict[tuple, _StepGraph] = {}    # captured steps by key

    @classmethod
    def from_config(cls, cfg: ModelConfig | str, spec: EngineSpec = EngineSpec(),
                    *, model: lm.LM | None = None, device="cuda"
                    ) -> "InferenceEngine":
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
        return cls(cfg, model, spec)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, *, cache_len: int | None = None
                ) -> tuple[torch.Tensor, dict]:
        """MMM phase: prompts [B, S] -> (last-token logits [B, V], cache).

        ``cache_len`` (default S) is the KV slots a dense model's cache
        holds: S plus the tokens decode will append."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        return lm.forward_prefill(self.model, tokens, self.cfg, self.hsa,
                                  cache_len=cache_len or tokens.shape[1])

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
        if self.device.type == "cuda":
            st, steps, t_capture = self._replay(tok, cache, gen, generator, prompts.shape)
        else:
            st, t_capture = DecodeState.start(tok, cache, gen), 0.0
            stop = (torch.tensor(gen.stop_tokens, device=self.device)
                    if gen.stop_tokens else None)
            steps = self._loop(st, gen, lambda: self._step(st, gen, stop, generator))
        out, lengths = st.out.clone(), st.lengths.clone()
        self._sync()
        return GenerationResult(tokens=out, lengths=lengths, prefill_s=t_prefill,
                                decode_s=time.perf_counter() - t0, decode_steps=steps,
                                capture_s=t_capture)

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

    def _replay(self, tok: torch.Tensor, cache: dict, gen: GenerationConfig,
                generator: torch.Generator | None, shape: torch.Size
                ) -> tuple[DecodeState, int, float]:
        """The decode loop on the card: this key's captured step (captured
        now if the key is new), replayed from the prefill state.  Launch
        counts are those the replays run."""
        from repro_torch.kernels import hopper
        key = (tuple(shape), gen)
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

    @torch.inference_mode()
    def _encode_cache(self, cache: dict, gen: GenerationConfig) -> dict:
        """Apply ``gen.cache_format`` at the prefill/decode boundary: prefill
        ran f32, the decode residency streams the encoded bytes."""
        if gen.cache_format is None:
            return cache
        return lm.quantize_cache(cache, self.cfg, gen.cache_format)
