"""Multi-scale retention (RetNet) in plain PyTorch.

    parallel  :  Y = (Q K^T  .*  D) V,          D[n, m] = gamma^(n-m)  (n >= m)
    recurrent :  S_n = gamma * S_{n-1} + k_n^T v_n ;   y_n = q_n S_n
    chunkwise :  cross-chunk via the state S, intra-chunk via the parallel form

Per-head decay ``gamma_h = 1 - 2^(-5-h)``.  Shapes: q, k ``[B, H, S, dk]``;
v ``[B, H, S, dv]``; state ``[B, H, dk, dv]`` in f32.  The 1/sqrt(dk) scale is
folded into q and k by the caller (models/retnet.py).  `retention_chunkwise`
is the plain version of the CUDA kernel in kernels/csrc/retention_chunkwise.cu.
"""

from __future__ import annotations

import torch


def head_decays(num_heads: int, device=None) -> torch.Tensor:
    """gamma_h = 1 - 2^(-5-h) — RetNet's multi-scale decay schedule."""
    h = torch.arange(num_heads, dtype=torch.float32, device=device)
    return 1.0 - torch.exp2(-5.0 - h)


def decay_mask(seq_len: int, gamma: torch.Tensor) -> torch.Tensor:
    """D[h, n, m] = gamma_h^(n-m) for n >= m else 0 (computed in log space)."""
    n = torch.arange(seq_len, dtype=torch.float32, device=gamma.device)
    diff = n[:, None] - n[None, :]
    log_g = torch.log(gamma)[:, None, None]
    mask = diff >= 0
    d = torch.exp(torch.where(mask, diff * log_g, -torch.inf))
    return torch.where(mask, d, 0.0)                      # [H, S, S]


def retention_parallel(q, k, v, gamma) -> torch.Tensor:
    """Parallel form: ``(QK^T .* D) V``."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    scores = torch.einsum("bhnd,bhmd->bhnm", qf, kf)
    d = decay_mask(q.shape[2], gamma)
    return torch.einsum("bhnm,bhmv->bhnv", scores * d[None], vf).to(v.dtype)


def retention_recurrent_step(q_t, k_t, v_t, state, gamma):
    """One decode step.  q_t/k_t ``[B, H, dk]``, v_t ``[B, H, dv]``, state
    ``[B, H, dk, dv]`` -> (y_t ``[B, H, dv]``, new state)."""
    qf, kf, vf = (t.to(torch.float32) for t in (q_t, k_t, v_t))
    new_state = (gamma[None, :, None, None] * state
                 + kf[..., :, None] * vf[..., None, :])
    y = torch.einsum("bhk,bhkv->bhv", qf, new_state)
    return y.to(v_t.dtype), new_state


def retention_recurrent(q, k, v, gamma, state=None, return_states: bool = False):
    """Run the recurrent form over a sequence -> (y, final state).

    ``return_states=True`` also returns the state after every position,
    ``[B, H, S, dk, dv]``: the snapshots speculative decode rolls back to
    when a draft is rejected inside a verified block (the reference stacks
    them as ``[B, S, H, dk, dv]``)."""
    b, h, s, dk = q.shape
    if state is None:
        state = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float32,
                            device=q.device)
    ys, states = [], []
    for t in range(s):
        y, state = retention_recurrent_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                            state, gamma)
        ys.append(y)
        states.append(state)
    if return_states:
        return torch.stack(ys, dim=2), state, torch.stack(states, dim=2)
    return torch.stack(ys, dim=2), state


def retention_chunkwise(q, k, v, gamma, chunk: int = 128, state=None):
    """Chunkwise form, per chunk of length c (positions m = 1..c):

        inner  = (Q K^T .* D) V
        cross  = (Q .* gamma^m) @ S_prev
        S_new  = gamma^c * S_prev + sum_m gamma^(c-m) k_m^T v_m
    """
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    if s % chunk != 0:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    st = (torch.zeros(b, h, dk, dv, dtype=torch.float32, device=q.device)
          if state is None else state.to(torch.float32))
    n = s // chunk
    qc = q.reshape(b, h, n, chunk, dk).to(torch.float32)
    kc = k.reshape(b, h, n, chunk, dk).to(torch.float32)
    vc = v.reshape(b, h, n, chunk, dv).to(torch.float32)

    m = torch.arange(1, chunk + 1, dtype=torch.float32, device=q.device)
    log_g = torch.log(gamma.to(torch.float32))
    in_decay = torch.exp(m[None, :] * log_g[:, None])             # [H, c]
    out_decay = torch.exp((chunk - m)[None, :] * log_g[:, None])  # [H, c]
    chunk_decay = torch.exp(chunk * log_g)                        # [H]
    d = decay_mask(chunk, gamma.to(torch.float32))

    ys = []
    for i in range(n):
        qi, ki, vi = qc[:, :, i], kc[:, :, i], vc[:, :, i]
        scores = torch.einsum("bhnd,bhmd->bhnm", qi, ki) * d[None]
        inner = torch.einsum("bhnm,bhmv->bhnv", scores, vi)
        cross = torch.einsum("bhnd,bhdv->bhnv",
                             qi * in_decay[None, :, :, None], st)
        kv = torch.einsum("bhmd,bhmv->bhdv",
                          ki * out_decay[None, :, :, None], vi)
        st = chunk_decay[None, :, None, None] * st + kv
        ys.append(inner + cross)
    y = torch.stack(ys, dim=2).reshape(b, h, s, dv)
    return y.to(v.dtype), st


def group_norm_heads(y: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RetNet's per-head GroupNorm (scale-free), applied after retention."""
    y32 = y.to(torch.float32)
    var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps)).to(y.dtype)
