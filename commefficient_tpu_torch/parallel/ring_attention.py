"""Ring attention: exact (causal) attention with the tokens sharded over
the grid's seq group (the reference's ``parallel/ring_attention.py``).

Each rank keeps its Q block and the K/V blocks travel round the ring, one
hop a step (``SeqShift``, the group's ``shift``: ``ppermute`` with the
ring permutation), while online-softmax accumulators (running max,
denominator and numerator, f32) fold each block in, so the result is
dense attention, not an approximation, at O(T / n) activation memory a
rank. Causality comes from the global block offsets: a K/V block wholly in
the future of a Q block contributes nothing, the diagonal block applies
the triangle. Every rank takes part in every step.

The rotation is differentiable: ``SeqShift``'s backward is the reverse
shift (the transpose of ``ppermute``), and its ``vmap`` rule shifts the
whole batched tensor once, so ring attention runs under the round's
``torch.func.grad`` and ``torch.func.vmap`` (the batched clients). The
products stay ``torch.matmul``: the reference computes them outside any
Pallas kernel.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


class SeqShift(torch.autograd.Function):
    """``group.shift(t, step)`` with the reverse shift as its gradient."""

    @staticmethod
    def forward(t, group, step):
        return group.shift(t, step)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group, ctx.step = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return SeqShift.apply(g, ctx.group, -ctx.step), None, None

    @staticmethod
    def vmap(info, in_dims, t, group, step):
        # torch.distributed ops have no batching rule: the batched tensor
        # goes round the ring whole, its batch dim where it was
        return SeqShift.apply(t, group, step), in_dims[0]


def _block_attn(q, k, v, q_off: int, k_off: int, *, causal: bool):
    """One Q block against one K/V block: ``(numerator [B, H, Tq, hd] f32,
    row max [B, H, Tq], row denominator [B, H, Tq])``, the positions
    offset for the causal mask."""
    hd = q.shape[-1]
    s = torch.matmul(q, k.transpose(-1, -2)).to(torch.float32)
    s = s / math.sqrt(hd)
    if causal:
        tq, tk = q.shape[-2], k.shape[-2]
        qpos = q_off + torch.arange(tq, device=q.device)
        kpos = k_off + torch.arange(tk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, _NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    # a fully masked row: exp(NEG_INF - NEG_INF) = 1 would pollute it
    p = torch.where(m[..., None] <= _NEG_INF / 2, 0.0, p)
    num = torch.matmul(p.to(v.dtype), v).to(torch.float32)
    return num, m, torch.sum(p, dim=-1)


def ring_attention(q, k, v, group, causal: bool = True):
    """``[B, H, T_local, hd]`` local q/k/v blocks (rank ``r`` of ``group``
    holds tokens ``[r * T_local, (r + 1) * T_local)``) -> the local output
    block. Every rank of ``group`` must call it."""
    n, me = group.size, group.rank
    t_local = q.shape[-2]
    q_off = me * t_local
    kv = torch.stack([k, v])  # one shift a step carries both
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m_run = torch.full(q.shape[:-1], _NEG_INF, dtype=torch.float32,
                       device=q.device)
    den = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    for t in range(n):
        if t:
            kv = SeqShift.apply(kv, group, 1)
        src = (me - t) % n  # whose K/V block this rank holds now
        num, m_blk, den_blk = _block_attn(q, kv[0], kv[1], q_off,
                                          src * t_local, causal=causal)
        m_new = torch.maximum(m_run, m_blk)
        scale_old = torch.exp(m_run - m_new)
        scale_blk = torch.exp(m_blk - m_new)
        acc = acc * scale_old[..., None] + num * scale_blk[..., None]
        den = den * scale_old + den_blk * scale_blk
        m_run = m_new
    out = acc / torch.clamp(den[..., None], min=1e-30)
    return out.to(v.dtype)


def ring_attention_sharded(group, q, k, v, causal: bool = True):
    """The standalone entry: full ``[B, H, T, hd]`` q/k/v on every rank of
    ``group`` (T divisible by its size) -> the full ring-computed output on
    every rank (the blocks all-gathered in rank order). Inside a model,
    pass ``functools.partial(ring_attention, group=...)`` as GPT-2's
    ``attn_fn`` instead (``parallel/sequence.py``)."""
    n, me = group.size, group.rank
    T = q.shape[-2]
    if T % n:
        raise ValueError(f"T={T} must divide by seq axis {n}")
    t_loc = T // n

    def mine(u):
        return u[..., me * t_loc:(me + 1) * t_loc, :]

    out = ring_attention(mine(q), mine(k), mine(v), group, causal=causal)
    return gather_tokens(group, out, dim=-2)


def gather_tokens(group, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block of ``t`` concatenated along ``dim`` in rank
    order (forward only: the all-gather has no gradient)."""
    if group.size == 1:
        return t
    moved = t.movedim(dim, 0).contiguous()
    return group.all_gather(moved).movedim(0, dim)
