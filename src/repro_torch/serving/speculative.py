"""Multi-token speculative decode: the decode phase turned back into MMM work.

Decode is memory-bound: every generated token re-reads the whole weight
stream.  Speculative decode amortizes one weight pass over a block: a cheap
drafter proposes ``k`` tokens, the target model scores the pending token and
the drafts in ONE chunk-shaped verify dispatch (`lm.forward_verify_chunk`,
the chunked-prefill machinery pointed at a decode-resident cache, so every
linear runs the W8A8 MMM dataflow), and the accepted prefix plus one freshly
sampled token are committed: 1..k+1 tokens per weight read.

Drafters (both deterministic, both run inside the captured step):

* `NgramDrafter`: model-free prompt lookup (the trailing n-gram of the
  history and the pending token is matched against the request's own
  history and its continuation proposed);
* `MTPDrafter`: deepseek-v3's self-speculation, its multi-token-prediction
  head chained ``k`` deep (`lm.mtp_decode_step`, greedy over the head's
  logits) from the pre-final-norm hidden at the acceptance boundary, which
  stays in device memory from one step to the next.

A MoE layer's verify dispatch never drops an assignment (``no_drop``), so
speculative and plain greedy tokens agree on MoE models too; the MTP
head's own dispatch keeps the reference's capacity drops (only the drafts'
quality is at stake there).

Acceptance is token matching, which for a deterministic drafter is exactly
rejection sampling: the target distribution is sampled once at every block
position, and a draft is accepted while the target's sample equals it.  The
emitted stream is distributed as the target's own sampling, and greedy
decoding is token-identical to the plain decode loop (on fp weights: on
deployed ones verify reads the W8A8 weights and decode the MXINT4 ones, two
different functions).  Rollback is exact (`lm.commit_verified_cache`): a
position-pointer rewind for linear KV and MLA latents, the per-position
snapshot for RetNet's state.

Everything here reads and writes device tensors only, with static shapes
and clamped indices (a free lane of a slot class holds garbage), so a step
is captured once as a CUDA graph and replayed (`InferenceEngine`'s verify
loop, the scheduler's `SpecClassStep`).
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from repro_torch.core.hsa import HSAEngine
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import GenerationConfig, SpeculativeConfig, sample


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------


def ngram_propose(hist: torch.Tensor, hist_len: torch.Tensor, tok: torch.Tensor,
                  *, k: int, m: int) -> torch.Tensor:
    """Prompt-lookup proposal: continue the most recent history match.

    ``hist`` [B, H] is each request's token history (prompt + committed
    output, zero-padded); ``hist_len`` its fill level, a device scalar
    shared by the batch or ``[B]`` per lane; ``tok`` [B] the pending token.
    The trailing ``m``-gram ending in the pending token is compared with
    every committed window (``[B, J, m]``, a static shape) and the ``k``
    tokens after the most recent match (a masked max) are the draft.  No
    match, or a continuation that runs past the committed end, falls back to
    repeating the pending token.  Every index is clamped into the buffer, as
    the reference's ``take`` / ``take_along_axis`` clamp it, so any
    ``hist_len`` is safe.  Returns int64 ``[B, k]``.
    """
    b, cap = hist.shape
    if cap < m + 1:
        # No window plus a continuation fits: the repeat-pending fallback.
        return tok[:, None].expand(b, k).clone()
    dev = hist.device
    hl = hist_len.to(torch.int64).expand(b)[:, None]                 # [B, 1]
    if m > 1:
        sidx = hl - (m - 1) + torch.arange(m - 1, device=dev)       # [B, m-1]
        sfx = hist.gather(1, sidx.clamp(0, cap - 1))
        sfx = torch.where(sidx >= 0, sfx, -1)                        # -1 never matches
        suffix = torch.cat([sfx, tok[:, None]], dim=1)              # [B, m]
    else:
        suffix = tok[:, None]
    starts = torch.arange(cap - m + 1, device=dev)
    win = hist.unfold(1, m, 1)                                       # [B, J, m]
    ok = (win == suffix[:, None, :]).all(dim=-1)
    ok &= starts + m <= hl                                           # window committed
    j = torch.where(ok, starts, -1).amax(dim=1)                      # [B]
    didx = j[:, None] + m + torch.arange(k, device=dev)             # [B, k]
    drafts = hist.gather(1, didx.clamp(0, cap - 1))
    good = (j >= 0)[:, None] & (didx < hl)
    return torch.where(good, drafts, tok[:, None])


def observe_block(hist: torch.Tensor, hist_len: torch.Tensor, block: torch.Tensor,
                  n_commit: torch.Tensor) -> None:
    """Append the committed prefix of each row's ``block`` [B, W] to its
    history at ``hist_len``, in place, and advance ``hist_len`` by
    ``n_commit`` (both a device scalar or ``[B]``).  The window's start is
    clamped into the buffer, as the reference's ``dynamic_update_slice``
    clamps it; the positions past ``n_commit`` keep what they held."""
    b, w = block.shape
    start = hist_len.to(torch.int64).clamp(0, hist.shape[1] - w).expand(b)[:, None]
    idx = start + torch.arange(w, device=hist.device)
    keep = torch.arange(w, device=hist.device) < n_commit.reshape(-1, 1)
    hist.scatter_(1, idx, torch.where(keep, block, hist.gather(1, idx)))
    hist_len += n_commit.to(hist_len.dtype)


class Drafter(Protocol):
    """A deterministic k-token proposer run inside the captured step (the
    reference's protocol).  It keeps its state in device tensors, which the
    step reads in ``draft`` and advances in place in ``observe``; ``hidden``
    [B, D] is the pre-final-norm hidden at the last committed position,
    ``hidden_all`` [B, k+1, D] the verify block's and ``next_tok`` [B] the
    pending token after the commit.  Proposals never affect correctness,
    only the acceptance rate."""

    k: int

    def init(self, hist: torch.Tensor, hist_len: torch.Tensor,
             hidden: torch.Tensor) -> dict: ...

    def draft(self, model: lm.LM, state: dict, tok: torch.Tensor) -> torch.Tensor: ...

    def observe(self, state: dict, block: torch.Tensor, n_commit: torch.Tensor,
                hidden_all: torch.Tensor, next_tok: torch.Tensor) -> None: ...


@dataclasses.dataclass(frozen=True)
class NgramDrafter:
    """Model-free prompt-lookup drafter (any architecture, no extra FLOPs)."""

    k: int
    m: int = 2

    def init(self, hist, hist_len, hidden):
        return {"hist": hist, "len": hist_len}

    def draft(self, model, state, tok):
        return ngram_propose(state["hist"], state["len"], tok, k=self.k, m=self.m)

    def observe(self, state, block, n_commit, hidden_all, next_tok):
        observe_block(state["hist"], state["len"], block, n_commit)


@dataclasses.dataclass(frozen=True)
class MTPDrafter:
    """deepseek-v3 self-speculation: the MTP head chained ``k`` deep, each
    draft the argmax of the head's logits and the next step's token."""

    k: int
    cfg: ModelConfig
    hsa: HSAEngine

    def init(self, hist, hist_len, hidden):
        return {"h": hidden}

    def draft(self, model, state, tok):
        h, drafts = state["h"], []
        for _ in range(self.k):
            logits, h = lm.mtp_decode_step(model, h, tok, self.cfg, self.hsa)
            tok = logits.argmax(dim=-1)
            drafts.append(tok)
        return torch.stack(drafts, dim=1)

    def observe(self, state, block, n_commit, hidden_all, next_tok):
        # The next chain starts from the hidden at the acceptance boundary:
        # hidden_all[:, j] is the verified position j's, and the pending
        # next_tok is the head's token there.  Each lane's own n_commit
        # (a scalar in lockstep), gathered on the device.
        b = hidden_all.shape[0]
        at = (n_commit - 1).to(torch.int64).expand(b)
        state["h"].copy_(hidden_all[torch.arange(b, device=at.device), at])


def make_drafter(spec: SpeculativeConfig, cfg: ModelConfig, hsa: HSAEngine) -> Drafter:
    """The drafter ``spec`` names; 'mtp' needs a config with an MTP head."""
    if spec.drafter == "mtp":
        if not cfg.mtp:
            raise ValueError(f"{cfg.name}: the 'mtp' drafter needs a config "
                             "with an MTP head (cfg.mtp=True)")
        return MTPDrafter(k=spec.k, cfg=cfg, hsa=hsa)
    return NgramDrafter(k=spec.k, m=spec.ngram)


# ---------------------------------------------------------------------------
# The verify / accept core (the engine's lockstep loop and the slot classes)
# ---------------------------------------------------------------------------


def verify_block(model: lm.LM, block: torch.Tensor, cache: dict, *, cfg: ModelConfig,
                 hsa: HSAEngine, gen: GenerationConfig, generator=None):
    """Score one [B, k+1] block (pending token + k drafts) in one MMM
    dispatch over the warm cache and sample the target at every position.

    ``generator`` is one `torch.Generator` for the batch, or a list of one
    per row (a slot class: each lane draws from its own).  Returns ``(cand
    [B, k+1], acc [B], hidden [B, k+1, D], verified cache)``: ``cand[:, j]``
    is the target's sample after block positions 0..j, and ``acc`` counts
    each row's leading draft matches (0..k).  The caller picks a commit
    depth and passes it to `lm.commit_verified_cache`.
    """
    k = block.shape[1] - 1
    logits, hidden, ver = lm.forward_verify_chunk(model, block, cache, cfg, hsa)
    if isinstance(generator, list):
        cand = torch.cat([sample(logits[r:r + 1], gen.sampling, g)
                          for r, g in enumerate(generator)])
    else:
        cand = sample(logits, gen.sampling, generator)
    match = (cand[:, :k] == block[:, 1:]).to(torch.int64)
    acc = torch.cumprod(match, dim=1).sum(dim=1)
    return cand, acc, hidden, ver


# ---------------------------------------------------------------------------
# The engine's speculative loop, one step at a time on device state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SpecState:
    """The speculative loop's carry, as the reference's ``while_loop`` state,
    all on the device; `speculative_step` updates it in place."""

    i: torch.Tensor          # i64 scalar: the next column of ``out``
    tok: torch.Tensor        # i64 [B]: the pending token
    cache: dict              # the decode cache, capacity S + n + k
    done: torch.Tensor       # bool [B]
    out: torch.Tensor        # i64 [B, n + k]
    lengths: torch.Tensor    # i32 [B]
    hist: torch.Tensor       # i64 [B, S + n + k + 1]: prompt + committed tokens
    hist_len: torch.Tensor   # i64 scalar
    h: torch.Tensor          # [B, D]: the hidden at the last committed position
    steps: torch.Tensor      # i64 scalar: verify steps
    accepted: torch.Tensor   # i64 scalar: accepted drafts
    more: torch.Tensor       # bool scalar: the loop's condition after a step

    @classmethod
    def start(cls, tok: torch.Tensor, cache: dict, hist: torch.Tensor, hist_len: int,
              h: torch.Tensor, gen: GenerationConfig) -> "SpecState":
        b, dev = tok.shape[0], tok.device
        zero = torch.zeros((), dtype=torch.long, device=dev)
        return cls(i=zero.clone(), tok=tok.clone(), cache=cache,
                   done=torch.zeros(b, dtype=torch.bool, device=dev),
                   out=torch.full((b, gen.max_new_tokens + gen.speculative.k),
                                  gen.pad_token_id, dtype=torch.long, device=dev),
                   lengths=torch.zeros(b, dtype=torch.int32, device=dev),
                   hist=hist.clone(), hist_len=zero + hist_len, h=h.clone(),
                   steps=zero.clone(),
                   accepted=zero.clone(),
                   more=torch.ones((), dtype=torch.bool, device=dev))

    def reset(self, tok: torch.Tensor, hist: torch.Tensor, hist_len: int, h: torch.Tensor,
              gen: GenerationConfig) -> None:
        """Load the initial state of another run into these buffers (all but
        the cache, which the caller copies in)."""
        for t in (self.i, self.steps, self.accepted, self.done, self.lengths):
            t.zero_()
        self.tok.copy_(tok)
        self.out.fill_(gen.pad_token_id)
        self.hist.copy_(hist)
        self.hist_len.fill_(hist_len)
        self.h.copy_(h)
        self.more.fill_(True)


def speculative_step(st: SpecState, model: lm.LM, cfg: ModelConfig, hsa: HSAEngine,
                     gen: GenerationConfig, stop: torch.Tensor | None,
                     generator=None) -> dict:
    """One body of the reference's ``speculative_loop``, on ``st`` in place:
    draft k tokens (the drafter ``gen.speculative`` names), verify the k+1
    block in one dispatch, commit in lockstep (the depth is the least
    acceptance over live rows, so the cache keeps one position for the
    batch; rows that accepted more re-derive those tokens next step), emit
    ``[tok, d_1..d_a]`` (a stop token inside the block pads the row's tail)
    and take the sample at the acceptance boundary as the next pending
    token; the drafter then observes the commit (the ngram drafter's
    history, the MTP drafter's ``h``).  Returns the committed cache, whose
    tensors the caller copies into ``st.cache`` (those the verify wrote in
    place are ``st.cache``'s own)."""
    spec = gen.speculative
    k, n = spec.k, gen.max_new_tokens
    drafter = make_drafter(spec, cfg, hsa)
    dstate = drafter.init(st.hist, st.hist_len, st.h)
    block = torch.cat([st.tok[:, None], drafter.draft(model, dstate, st.tok)], dim=1)
    cand, acc, hidden, ver = verify_block(model, block, st.cache, cfg=cfg, hsa=hsa, gen=gen,
                                          generator=generator)
    a = torch.where(st.done, k, acc).amin()                  # live rows set the depth
    n_commit = a + 1
    committed = lm.commit_verified_cache(st.cache, ver, n_commit, k + 1, cfg)

    cols = torch.arange(k + 1, device=block.device)
    valid = (cols <= a) & (st.i + cols < n)                  # [k+1]
    hit = (torch.zeros_like(block, dtype=torch.bool) if stop is None
           else (block[..., None] == stop).any(dim=-1))
    sh = hit & valid
    cum = torch.cumsum(sh.to(torch.int32), dim=1)
    emit = valid & ~st.done[:, None] & ((cum - sh.to(torch.int32)) == 0)
    idx = st.i.clamp(0, n - 1) + cols
    st.out.index_copy_(1, idx, torch.where(emit, block, st.out.index_select(1, idx)))
    st.lengths += emit.sum(dim=1, dtype=torch.int32)
    st.done |= (sh & emit).any(dim=1)

    st.tok.copy_(cand.gather(1, a.expand(block.shape[0])[:, None])[:, 0])
    drafter.observe(dstate, block, n_commit, hidden, st.tok)
    st.i += n_commit
    st.steps += 1
    st.accepted += a
    st.more.copy_((st.i < n) & ~st.done.all())
    return committed
