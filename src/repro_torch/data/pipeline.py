"""Deterministic synthetic token pipeline: host-sharded, packed, checkpointable.

A numpy copy of the reference's `data/pipeline.py`: for every (seed, host,
step) it gives the same bytes, so a run of the port and of the reference
train on one stream.

No external dataset ships with the repository, so the training substrate is a
synthetic stream with real-pipeline semantics:

  * **Determinism/resume** — batch content is a pure function of
    (seed, host, step): restoring a checkpoint at step k replays the exact
    stream without persisting buffers (the pipeline state IS the step).
  * **Host sharding** — each host draws only its slice of the global batch
    (disjoint per-host substreams), matching multi-host input pipelines.
  * **Packing** — documents with Zipf-ish lengths are packed back-to-back
    into fixed seq_len rows, separated by EOS, with -1 label padding after
    the final EOS (loss-masked), like production LM packing.
  * **Markov structure** — tokens follow a seeded bigram chain so the loss
    has learnable signal (integration tests assert loss decreases).
"""

from __future__ import annotations

import dataclasses

import numpy as np

EOS = 0
PAD_LABEL = -1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 17
    n_hosts: int = 1
    host_id: int = 0
    mean_doc_len: int = 96
    branching: int = 4          # markov branching factor (lower = easier)


class SyntheticPipeline:
    """Stateless-by-construction synthetic LM data."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts != 0:
            raise ValueError(f"global_batch {cfg.global_batch} not divisible "
                             f"by n_hosts {cfg.n_hosts}")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # Seeded bigram table: token t -> `branching` plausible successors.
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(
            1, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching))

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(2, int(rng.exponential(self.cfg.mean_doc_len)))
        toks = np.empty(n, np.int64)
        toks[0] = rng.integers(1, self.cfg.vocab_size)
        for i in range(1, n):
            toks[i] = self._succ[toks[i - 1], rng.integers(self.cfg.branching)]
        return toks

    def _row(self, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
        s = self.cfg.seq_len
        buf = []
        while sum(len(d) + 1 for d in buf) < s + 1:
            buf.append(self._doc(rng))
        flat = np.concatenate([np.append(d, EOS) for d in buf])[: s + 1]
        tokens = flat[:s]
        labels = flat[1: s + 1].copy()
        return tokens, labels

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """The (host-local) batch for `step` — pure function of (cfg, step)."""
        c = self.cfg
        toks = np.empty((self.local_batch, c.seq_len), np.int32)
        labs = np.empty((self.local_batch, c.seq_len), np.int32)
        for i in range(self.local_batch):
            rng = np.random.default_rng(
                (c.seed, c.host_id * 131071 + i, step))
            t, l = self._row(rng)
            toks[i], labs[i] = t, l
        return {"tokens": toks, "labels": labs}

    def state(self, step: int) -> dict:
        """Checkpointable pipeline state (the step counter is sufficient)."""
        return {"step": step, "seed": self.cfg.seed}
