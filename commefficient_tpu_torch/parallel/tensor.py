"""Tensor-parallel GPT-2 over the grid's model group (and its seq group):
the reference's ``parallel/tensor.py``, one process per grid position.

The layout is the reference's (Megatron's two collectives a block):

* ``c_attn``: kernel as ``[E, 3, H, hd]``, sharded on H: each rank
  computes q/k/v for its own heads, and attention is independent across
  heads;
* attention ``c_proj``: kernel as ``[H, hd, E]``, sharded on H: the
  ranks' partial outputs are summed over the model group;
* MLP ``c_fc`` (``[E, 4E]``) sharded on its output axis, ``c_proj``
  (``[4E, E]``) on its input axis: the second sum;
* LayerNorms, embeddings and both heads replicated.

With a seq group of more than one rank the tokens are sharded over it as
well, and attention over each rank's heads is ring attention
(``parallel/ring_attention.py``).

The gradient. Under ``shard_map`` JAX totals each replicated input's
per-shard cotangents itself; here the sums are explicit:

* around each sharded branch, Megatron's conjugate pair on the model
  group: ``CopyToGroup`` at its input (identity forward, all-reduce
  backward) and ``ReduceFromGroup`` at its output (all-reduce forward,
  identity backward). Every replicated leaf's gradient is then whole and
  identical on every model rank, and each head or hidden slice's gradient
  lives on its owner alone;
* over seq, each leaf's gradient is the rank's tokens' share; the token
  sums (``lm_sum``, ``lm_cnt``, the MC pick) are ``ReduceFromGroup`` on
  the seq group, so ``mc_head``, used only after the pick's sum, has its
  whole gradient on every seq rank.

``build_tp_flat_loss``'s loss carries ``grad_total``, which
``parallel/round.py::make_grad_one`` applies to the raw flat ``[D]``
gradient (before weight decay, the clip and DP noise, as the reference's
``grad_extra_axes_psum``): one all-reduce over the model group in which
the replicated leaves count from model rank 0 only, then one over the
seq group in which ``mc_head`` counts from seq rank 0 only. The result is
the whole gradient, bit-identical on every rank of both groups, so the
compression and server algebra downstream are unchanged and every
replica keeps the same ``params_vec``.

Every collective here is an ``autograd.Function`` with ``setup_context``
and a ``vmap`` rule that runs the collective once on the batched tensor:
the round differentiates with ``torch.func.grad`` and batches its clients
with ``torch.func.vmap``, and ``torch.distributed`` ops have no batching
rule of their own.
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from commefficient_tpu_torch.models.gpt2 import (
    GPT2Config,
    dense_causal_attention,
    gpt2_shapes,
    manual_layer_norm,
)
from commefficient_tpu_torch.models.losses import (
    IGNORE_INDEX,
    _cast_floats,
    _resolve_compute_dtype,
    softmax_cross_entropy_sum,
)
from commefficient_tpu_torch.ops.param_utils import (
    tree_leaves,
    tree_with_leaves,
)
from commefficient_tpu_torch.parallel.ring_attention import (
    gather_tokens,
    ring_attention,
)


class ReduceFromGroup(torch.autograd.Function):
    """All-reduce (sum) over ``group`` forward, identity backward."""

    @staticmethod
    def forward(t, group):
        return group.all_reduce_sum(t.clone())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None

    @staticmethod
    def vmap(info, in_dims, t, group):
        return ReduceFromGroup.apply(t, group), in_dims[0]


class CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce (sum) over ``group`` backward."""

    @staticmethod
    def forward(t, group):
        return t.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ReduceFromGroup.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, t, group):
        return CopyToGroup.apply(t, group), in_dims[0]


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    return t if group.size == 1 else ReduceFromGroup.apply(t, group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    return t if group.size == 1 else CopyToGroup.apply(t, group)


# --------------------------------------------------------------------------
# Param transform and the per-rank slices
# --------------------------------------------------------------------------

# each sharded leaf of a transformed block -> (its sharded axis, whether it
# is a head leaf (else MLP hidden)); the rest are replicated
TP_SHARDED = {"attn_qkv_k": (2, True), "attn_qkv_b": (1, True),
              "attn_out_k": (0, True), "fc_k": (1, False),
              "fc_b": (0, False), "proj_k": (0, False)}


def tp_transform_params(params, cfg: GPT2Config):
    """The GPT-2 tree -> the reference's transformed tree: ``wte``,
    ``wpe``, ``ln_f``, ``mc_head`` and ``blocks``, each block's kernels
    reshaped (views) so the sharded axis is its own: ``attn_qkv_k [E, 3,
    H, hd]``, ``attn_qkv_b [3, H, hd]``, ``attn_out_k [H, hd, E]``."""
    E, H = cfg.n_embd, cfg.n_head
    hd = E // H
    t = params["params"]["transformer"]
    out = {"wte": t["wte"], "wpe": t["wpe"], "ln_f": t["ln_f"],
           "mc_head": params["params"]["mc_head"], "blocks": []}
    for i in range(cfg.n_layer):
        b = t[f"h_{i}"]
        out["blocks"].append({
            "ln_1": b["ln_1"], "ln_2": b["ln_2"],
            "attn_qkv_k": b["attn"]["c_attn"]["kernel"].reshape(E, 3, H, hd),
            "attn_qkv_b": b["attn"]["c_attn"]["bias"].reshape(3, H, hd),
            "attn_out_k": b["attn"]["c_proj"]["kernel"].reshape(H, hd, E),
            "attn_out_b": b["attn"]["c_proj"]["bias"],
            "fc_k": b["mlp"]["c_fc"]["kernel"],
            "fc_b": b["mlp"]["c_fc"]["bias"],
            "proj_k": b["mlp"]["c_proj"]["kernel"],
            "proj_b": b["mlp"]["c_proj"]["bias"],
        })
    return out


def tp_untransform_params(tp, cfg: GPT2Config):
    """The inverse of ``tp_transform_params``."""
    E = cfg.n_embd
    transformer = {"wte": tp["wte"], "wpe": tp["wpe"], "ln_f": tp["ln_f"]}
    for i, b in enumerate(tp["blocks"]):
        transformer[f"h_{i}"] = {
            "ln_1": b["ln_1"], "ln_2": b["ln_2"],
            "attn": {
                "c_attn": {"kernel": b["attn_qkv_k"].reshape(E, 3 * E),
                           "bias": b["attn_qkv_b"].reshape(3 * E)},
                "c_proj": {"kernel": b["attn_out_k"].reshape(E, E),
                           "bias": b["attn_out_b"]},
            },
            "mlp": {"c_fc": {"kernel": b["fc_k"], "bias": b["fc_b"]},
                    "c_proj": {"kernel": b["proj_k"], "bias": b["proj_b"]}},
        }
    return {"params": {"transformer": transformer, "mc_head": tp["mc_head"]}}


def _local_blocks(blocks, cfg: GPT2Config, model):
    """Each block's slices of this model rank (views): its ``H / M`` heads
    and ``4E / M`` hidden units (the whole tensors at one rank)."""
    M, m = model.size, model.rank
    h_loc, f_loc = cfg.n_head // M, 4 * cfg.n_embd // M
    out = []
    for b in blocks:
        b = dict(b)
        for name, (axis, head) in TP_SHARDED.items():
            n = h_loc if head else f_loc
            b[name] = b[name].narrow(axis, m * n, n)
        out.append(b)
    return out


def _check_heads(cfg: GPT2Config, model) -> None:
    if cfg.n_head % model.size:
        raise ValueError(f"n_head={cfg.n_head} must divide by model axis "
                         f"{model.size}")


def tp_shard_params(grid, params, cfg: GPT2Config):
    """The transformed tree with this rank's slices of the sharded leaves
    (the reference's ``device_put`` of each leaf with its sharding: a rank
    holds its shard): what ``tp_gpt2_apply`` takes."""
    _check_heads(cfg, grid.model)
    tp = tp_transform_params(params, cfg)
    return {**tp, "blocks": _local_blocks(tp["blocks"], cfg, grid.model)}


# --------------------------------------------------------------------------
# The forward on this rank's shards
# --------------------------------------------------------------------------


def _block_local(x, b, cfg: GPT2Config, attn_fn, model):
    """One block with this rank's heads and hidden units. ``x [R, T_local,
    E]`` is replicated over the model group; two sums over it."""
    dt, eps = cfg.dtype, cfg.layer_norm_epsilon
    h = copy_to(manual_layer_norm(x, b["ln_1"], eps), model)
    qkv = (torch.einsum("rte,echd->crthd", h, b["attn_qkv_k"].to(dt))
           + b["attn_qkv_b"].to(dt)[:, None, None])
    q, k, v = (u.transpose(1, 2) for u in qkv)  # [R, H_local, T, hd]
    attn = attn_fn(q, k, v)
    out = torch.einsum("rhtd,hde->rte", attn.to(dt), b["attn_out_k"].to(dt))
    x = x + (reduce_from(out, model) + b["attn_out_b"].to(dt))
    h = copy_to(manual_layer_norm(x, b["ln_2"], eps), model)
    h1 = F.gelu(h @ b["fc_k"].to(dt) + b["fc_b"].to(dt), approximate="tanh")
    h2 = h1 @ b["proj_k"].to(dt)
    return x + (reduce_from(h2, model) + b["proj_b"].to(dt))


def _forward_local(tp, ids, tt, mc, cfg: GPT2Config, grid):
    """The double-heads forward on this rank's shards: ``ids``/``tt``
    ``[R, T_local]`` (this seq rank's tokens), ``mc [R]`` global token
    positions or None -> ``(h [R, T_local, E], lm_logits [R, T_local, V]
    f32, mc_logits [R] f32 | None)``."""
    seq = grid.seq
    t_local = ids.shape[-1]
    positions = seq.rank * t_local + torch.arange(t_local, device=ids.device)
    attn_fn = (partial(ring_attention, group=seq) if seq.size > 1
               else dense_causal_attention)
    wte = tp["wte"]
    h = wte[ids.long()] + tp["wpe"][positions]
    if tt is not None:
        h = h + wte[tt.long()]
    h = h.to(cfg.dtype)
    for b in tp["blocks"]:
        h = _block_local(h, b, cfg, attn_fn, grid.model)
    h = manual_layer_norm(h, tp["ln_f"], cfg.layer_norm_epsilon)
    lm_logits = (h @ wte.to(h.dtype).T).to(torch.float32)
    if mc is None:
        return h, lm_logits, None
    # each MC position lives on one seq rank: masked there, summed over
    # the group (the identity at one rank)
    off = seq.rank * t_local
    mc = mc.long()
    in_range = (mc >= off) & (mc < off + t_local)
    local_idx = torch.clamp(mc - off, 0, t_local - 1)
    rows = torch.arange(mc.shape[0], device=h.device)
    picked = torch.where(in_range[:, None], h[rows, local_idx], 0.0)
    picked = reduce_from(picked, seq)
    mh = tp["mc_head"]
    score = (picked.to(cfg.dtype) @ mh["kernel"].to(cfg.dtype)
             + mh["bias"].to(cfg.dtype))
    return h, lm_logits, score[:, 0].to(torch.float32)


def _seq_slice(u: torch.Tensor, seq) -> torch.Tensor:
    t_loc = u.shape[-1] // seq.size
    return u[..., seq.rank * t_loc:(seq.rank + 1) * t_loc]


def tp_gpt2_apply(grid, cfg: GPT2Config, tp_params, input_ids,
                  token_type_ids=None, mc_token_ids=None):
    """The tensor(-and-sequence)-parallel double-heads forward (forward
    only: the token gather has no gradient). ``tp_params`` is
    ``tp_shard_params``'s tree; ``input_ids``/``token_type_ids`` ``[B, N,
    T]`` and ``mc_token_ids [B, N]`` are the whole batch on every rank (T
    divisible by the seq group's size). Returns ``(lm_logits [B, N, T, V],
    mc_logits [B, N] | None)``, whole on every rank, as
    ``models.gpt2_apply``."""
    seq = grid.seq
    shape = input_ids.shape
    if shape[-1] % seq.size:
        raise ValueError(f"T={shape[-1]} must divide by seq axis {seq.size}")

    def flat(u):
        return None if u is None else _seq_slice(u.reshape(-1, shape[-1]),
                                                 seq)

    mc = None if mc_token_ids is None else mc_token_ids.reshape(-1)
    _, lm, mc_logits = _forward_local(tp_params, flat(input_ids),
                                      flat(token_type_ids), mc, cfg, grid)
    lm = gather_tokens(seq, lm, dim=1).reshape(*shape, cfg.vocab_size)
    if mc_token_ids is None:
        return lm, None
    return lm, mc_logits.reshape(shape[:-1])


# --------------------------------------------------------------------------
# The TP/SP loss over the round's flat params
# --------------------------------------------------------------------------


def _flat_ranges(cfg: GPT2Config):
    """``(replicated, mc_head)``: the ``(start, stop)`` ranges of the flat
    ``[D]`` layout (ravel order) that the model group does not shard, and
    ``mc_head``'s."""
    repl, mc_head, off = [], None, 0
    sharded = ("attn/c_attn/", "attn/c_proj/kernel", "mlp/c_fc/",
               "mlp/c_proj/kernel")
    for path, shape in tree_leaves(gpt2_shapes(cfg)):
        n = math.prod(shape)
        if path.startswith("params/mc_head/"):
            mc_head = (off if mc_head is None else mc_head[0], off + n)
        if not any(s in path for s in sharded):
            if repl and repl[-1][1] == off:
                repl[-1] = (repl[-1][0], off + n)
            else:
                repl.append((off, off + n))
        off += n
    return repl, mc_head


def make_grad_total(cfg: GPT2Config, grid):
    """``grad_total(g)``: this rank's raw flat ``[..., D]`` gradient ->
    the whole gradient (module docstring), the same on every rank of the
    model and seq groups. Its ``dropped`` attribute lists the flat ranges
    this rank zeroes before the sums, and ``table_total`` sums a gradient
    table over the same groups (``round.make_sketch_grad_one``)."""
    model, seq = grid.model, grid.seq
    repl, mc_head = _flat_ranges(cfg)

    def keep_from_rank0(g, group, ranges):
        if group.rank:
            g = g.clone()
            for a, b in ranges:
                g[..., a:b] = 0.0
        return ReduceFromGroup.apply(g, group)

    def grad_total(g):
        if model.size > 1:
            g = keep_from_rank0(g, model, repl)
        if seq.size > 1:
            g = keep_from_rank0(g, seq, [mc_head])
        return g

    def table_total(table):
        """The sketch-fused backward's counterpart: this rank's ``[r, c]``
        table, sketched without the ``dropped`` ranges, summed over the
        model group and then the seq group (the sketch is linear, so this
        is the table of ``grad_total``'s gradient)."""
        for group in (model, seq):
            if group.size > 1:
                table = ReduceFromGroup.apply(table, group)
        return table

    # the flat ranges whose gradient this rank leaves to rank 0 of a group
    # (grad_total zeroes them here): whole leaves, so the fused backward
    # skips their sketch instead
    grad_total.dropped = ((repl if model.rank else [])
                          + ([mc_head] if seq.rank else []))
    grad_total.table_total = table_total
    return grad_total


def build_tp_flat_loss(cfg: GPT2Config, grid, lm_coef: float = 1.0,
                       mc_coef: float = 1.0, compute_dtype=None):
    """The reference's ``build_tp_flat_loss``: ``loss_fn(params, batch) ->
    (loss, aux)`` whose compute is sharded over ``grid``'s model group
    (heads, MLP hidden) and seq group (tokens, ring attention), while the
    params stay the round's replicated flat vector; the same ``(loss,
    aux)`` contract as ``models.losses.gpt2_double_heads_loss`` (the lm
    and MC losses, ``correct``/``count``, ``lm_loss_sum``/
    ``token_count``). Every rank of the grid must call it on the same
    batch as its model and seq groups. Its ``grad_total`` attribute
    (``make_grad_total``) totals the raw gradient; the round applies it.
    Activations are sharded, the params and the round state are not."""
    _check_heads(cfg, grid.model)
    seq = grid.seq
    cd = _resolve_compute_dtype(compute_dtype)

    def loss_fn(params, batch):
        if cd is not None:
            # the whole-bf16 stream: cast before the transform, so the
            # embeddings, the residual stream and the tied head are bf16
            params = _cast_floats(params, cd)
        tp = tp_transform_params(params, cfg)
        tp = {**tp, "blocks": _local_blocks(tp["blocks"], cfg, grid.model)}
        shape = batch["input_ids"].shape  # [B, N, T]
        T = shape[-1]
        if T % seq.size:
            raise ValueError(f"T={T} must divide by seq axis {seq.size}")

        def flat(u):
            return u.reshape(-1, T)

        ids = _seq_slice(flat(batch["input_ids"]), seq)
        tt_full = batch.get("token_type_ids")
        tt = None if tt_full is None else _seq_slice(flat(tt_full), seq)
        mc = batch["mc_token_ids"].reshape(-1)
        _, lm_local, mc_logits = _forward_local(tp, ids, tt, mc, cfg, grid)
        # the next-token shift on the whole labels, then this rank's slice
        # (the last global position has no next token)
        labels = flat(batch["lm_labels"])
        labels = torch.cat([labels[:, 1:], torch.full(
            (labels.shape[0], 1), IGNORE_INDEX, dtype=labels.dtype,
            device=labels.device)], -1)
        lm_sum, lm_cnt = softmax_cross_entropy_sum(lm_local,
                                                   _seq_slice(labels, seq))
        lm_sum = reduce_from(lm_sum, seq)
        lm_cnt = reduce_from(lm_cnt, seq)
        lm_loss = lm_sum / torch.clamp(lm_cnt, min=1.0)
        mc_logits = mc_logits.reshape(shape[:-1])  # [B, N]
        mc_labels = batch["mc_labels"]
        mc_sum, mc_cnt = softmax_cross_entropy_sum(mc_logits, mc_labels)
        mc_loss = mc_sum / torch.clamp(mc_cnt, min=1.0)
        mc_mask = mc_labels != IGNORE_INDEX
        correct = torch.sum((torch.argmax(mc_logits, -1) == mc_labels)
                            & mc_mask).to(torch.float32)
        loss = lm_coef * lm_loss + mc_coef * mc_loss
        return loss, {"lm_loss": lm_loss, "mc_loss": mc_loss,
                      "correct": correct, "count": mc_cnt,
                      "lm_loss_sum": lm_sum, "token_count": lm_cnt}

    loss_fn.grad_total = make_grad_total(cfg, grid)
    return loss_fn


def build_tp_eval_fn(cfg: GPT2Config, grid, unravel, lm_coef: float = 1.0,
                     mc_coef: float = 1.0, compute_dtype=None):
    """The reference's ``build_tp_eval_fn``: an eval step whose forward is
    sharded as ``build_tp_flat_loss``'s, with ``round.build_eval_fn``'s
    contract (``eval_step(params_vec, batch-with-_valid) -> metric
    sums``). The rows shard over the workers group when they divide by
    it (partial sums, then one all-reduce), else every worker computes
    the whole batch. Every rank of the grid must call it
    (``every_rank``)."""
    from commefficient_tpu_torch.parallel.round import mask_gpt2

    loss_fn = build_tp_flat_loss(cfg, grid, lm_coef, mc_coef, compute_dtype)
    workers = grid.workers
    wk = workers.size

    @torch.no_grad()
    def eval_step(params_vec, batch):
        batch = dict(batch)
        valid = int(batch.pop("_valid"))
        n = next(iter(batch.values())).shape[0]
        row_mask = torch.arange(n, device=params_vec.device) < valid
        batch = mask_gpt2(batch, row_mask)
        shard_rows = wk > 1 and n % wk == 0
        if shard_rows:
            per = n // wk
            batch = {k: v[workers.rank * per:(workers.rank + 1) * per]
                     for k, v in batch.items()}
        _, aux = loss_fn(unravel(params_vec), batch)
        # mc_loss * count is the MC NLL sum (0 * 0 for no counted row)
        sums = torch.stack([aux["lm_loss_sum"], aux["token_count"],
                            aux["mc_loss"] * aux["count"], aux["count"],
                            aux["correct"]])
        if shard_rows:
            sums = workers.all_reduce_sum(sums)
        lm_sum, tok, mc_sum, cnt, correct = sums
        lm_loss = lm_sum / torch.clamp(tok, min=1.0)
        mc_loss = mc_sum / torch.clamp(cnt, min=1.0)
        loss = lm_coef * lm_loss + mc_coef * mc_loss
        return {"loss_sum": loss * valid, "lm_loss": lm_loss,
                "mc_loss": mc_loss, "correct": correct, "count": cnt,
                "lm_loss_sum": lm_sum, "token_count": tok}

    eval_step.every_rank = True
    return eval_step



# --------------------------------------------------------------------------
# The 3-axis training step: workers (data) x model (tensor) x seq (tokens)
# --------------------------------------------------------------------------


def build_tp3d_train_step(grid, cfg: GPT2Config, lm_coef: float = 1.0,
                          mc_coef: float = 1.0):
    """The reference's ``build_tp3d_train_step``: a plain SGD step for
    GPT-2 sharded over all three groups of ``grid``. Returns
    ``step(tp_params, batch, lr) -> (tp_params, metrics)``:

    * ``tp_params`` is this rank's ``tp_shard_params`` tree; the step
      updates its leaves in place (the reference donates them) and
      returns it;
    * ``batch`` is the whole batch on every rank of the grid
      (``input_ids``/``token_type_ids``/``lm_labels`` ``[B, N, T]``,
      ``mc_token_ids [B, N]``, ``mc_labels [B]``): the rows are split
      over the workers group (B divisible by its size), the tokens over
      the seq group (T divisible by its size), heads and MLP hidden units
      over the model group;
    * the next-token labels shift by one token across the seq shards:
      each shard's first label column goes to its left neighbour (the seq
      group's ``shift``), and the last shard's final position, which has
      no next token, is ``IGNORE_INDEX``;
    * the LM sums (NLL and count) are totaled over the workers and seq
      groups, the MC sums over the workers group (the MC pick is already
      summed over the seq group inside the forward, so every seq rank
      holds the whole MC logits), each by ``ReduceFromGroup``: every rank
      differentiates its own share against the global counts;
    * each leaf's gradient is then totaled over the groups whose ranks
      hold other shares of it: the workers group for every leaf, the seq
      group for every leaf but ``mc_head`` (whose gradient is whole on
      every seq rank). No leaf is summed over the model group: the
      conjugate pair leaves every replicated leaf's gradient whole on
      every model rank, and a sharded leaf's slice is its rank's own.

    ``metrics``: ``loss``, ``lm_loss``, ``mc_loss`` (0-d tensors, the
    same on every rank)."""
    _check_heads(cfg, grid.model)
    workers, seq = grid.workers, grid.seq

    def shifted_labels(labels):
        """This seq rank's ``[..., T_local]`` labels, each position's the
        next global token's."""
        if seq.size == 1:
            return labels[..., 1:]
        nxt = seq.shift(labels[..., :1].contiguous(), -1)
        if seq.rank == seq.size - 1:
            nxt = torch.full_like(nxt, IGNORE_INDEX)
        return torch.cat([labels[..., 1:], nxt], -1)

    def step(tp_params, batch, lr):
        B, _, T = batch["input_ids"].shape
        if T % seq.size:
            raise ValueError(f"T={T} must divide by seq axis {seq.size}")
        if B % workers.size:
            raise ValueError(f"B={B} must divide by workers axis "
                             f"{workers.size}")
        b = B // workers.size
        rows = slice(workers.rank * b, (workers.rank + 1) * b)

        def local(u):
            return _seq_slice(u[rows], seq).reshape(-1, T // seq.size)

        ids, tt = local(batch["input_ids"]), local(batch["token_type_ids"])
        labels = shifted_labels(local(batch["lm_labels"]))
        mc = batch["mc_token_ids"][rows].reshape(-1)
        mc_labels = batch["mc_labels"][rows]
        named = tree_leaves(tp_params)
        leaves = [t.detach().requires_grad_(True) for _, t in named]
        with torch.enable_grad():
            _, lm, mc_logits = _forward_local(
                tree_with_leaves(tp_params, leaves), ids, tt, mc, cfg, grid)
            if seq.size == 1:
                lm = lm[:, :-1]
            lm_sums = torch.stack(softmax_cross_entropy_sum(lm, labels))
            lm_sums = reduce_from(reduce_from(lm_sums, workers), seq)
            mc_sums = torch.stack(softmax_cross_entropy_sum(
                mc_logits.reshape(b, -1), mc_labels))
            mc_sums = reduce_from(mc_sums, workers)
            lm_loss = lm_sums[0] / torch.clamp(lm_sums[1], min=1.0)
            mc_loss = mc_sums[0] / torch.clamp(mc_sums[1], min=1.0)
            loss = lm_coef * lm_loss + mc_coef * mc_loss
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            flat = torch.cat([(torch.zeros_like(t) if g is None else g)
                              .reshape(-1).to(torch.float32)
                              for t, g in zip(leaves, grads)])
            if workers.size > 1:
                flat = workers.all_reduce_sum(flat)
            if seq.size > 1:
                if seq.rank:  # mc_head's gradient counts from seq rank 0
                    off = 0
                    for (name, t) in named:
                        if name.startswith("mc_head/"):
                            flat[off:off + t.numel()] = 0.0
                        off += t.numel()
                flat = seq.all_reduce_sum(flat)
            off = 0
            for _, t in named:
                n = t.numel()
                t.sub_(lr * flat[off:off + n].view_as(t).to(t.dtype))
                off += n
        return tp_params, {"loss": loss.detach(),
                           "lm_loss": lm_loss.detach(),
                           "mc_loss": mc_loss.detach()}

    return step
