"""The federated round (the reference's ``parallel/round.py``, the subset
the port runs).

A round over a worker group of ``Wd`` devices (``parallel/mesh.py``), one
process per device: rank ``p`` computes its clients ``[p*w_loc,
(p+1)*w_loc)`` of the W participants (``w_loc = W / Wd``, the reference's
``P(WORKERS)`` split). Per client, in client order: the compressor's
gradient rule (weight decay and the global-norm clip per gradient; fedavg
runs local SGD steps), local momentum ``u = lm * vel + g``, and the
compressor's transmit rule (local_topk: local error feedback and top-k);
the transmits are summed. Then the compressor's LINEAR ``device_encode``,
the sum over the group divided by W (the reference's psum / W), and the
server phase, replicated on every rank: the dense decode
(``server_update`` -> ``w -= delta``) or the sharded decode
(``server_update_sharded`` -> ``w[idx] -= val``).

How the sum over the group runs is the ``AggregationPlan``
(``resolve_aggregation``, from ``cfg.aggregate`` and the compressor):
dense, one ``all_reduce``; ``sparse_gather`` (local_topk), one W*k pair
all_gather and a scatter-add (``sparse_allreduce``) rebuilding the same
dense sum; ``sparse_state`` (true_topk), a reduce-scatter of the padded
transmit sum, after which each rank keeps its ``[padded_dim / W]`` slice
of momentum and error and the server phase runs
``server_update_sparse``.

Per-client state (``client_vel`` with local momentum, ``client_err`` with
local error feedback) lives in ``[num_clients, D]`` banks on the device,
the same on every rank: a round reads the cohort's rows by client id, and
the new rows of every rank are all-gathered and written back in place, so
the banks stay identical across the group (the reference's replicated
banks). With a hosted store (``--client_store host|mmap``,
``cfg.client_state_hosted``) the banks live in ``clientstore/`` instead:
``FedState`` holds none, the round takes this rank's cohort rows as
arguments and returns the cohort's all-gathered ``[W, D]`` new rows, and
the session's streamer writes them back (``build_round_fn``).

When nothing per client is configured (``fused_clients``), one gradient of
the device's flattened batch, times ``w_loc``, replaces the per-client
loop: the same sum of per-client mean gradients when the clients' batches
have equal sizes.

With ``sketch_fused_bwd`` (mode sketch, fused clients) that one gradient
is produced directly as a table (``make_sketch_grad_one``): every
parameter leaf goes through a ``SketchGradTap`` and the loss is
differentiated with respect to a zero table, so the flat ``[D]`` gradient
never exists. With ``overlap_collectives='layerwise'`` the leaves form
``OVERLAP_SEGMENTS`` contiguous groups (``leaf_groups``), each with its
own table, and each group's table is summed over the group by its own
asynchronous ``all_reduce``, started as soon as the backward has written
the group's last leaf; the round waits on them in group order and adds
the group sums.

Telemetry (``cfg.telemetry_level >= 1``): after the update is applied
the round adds the ``diag/*`` scalars (``telemetry/diagnostics.py``) to
its metrics, 0-d tensors on the device, from tensors the round already
holds (the aggregate, the update, the new error, the cohort's error rows
the write-back gathered); at level 0 none of it runs.

fedsim (``cfg.fedsim_enabled``): the round takes the cohort's ``RoundEnv``
(live and corruption masks over the W slots, the live count); each rank
applies its slice of the masks per client (corruption, then the live mask,
by ``torch.where``: a dropped client sends nothing, a corrupted live one a
NaN payload), and the server renormalizes by ``W / max(live_count, 1)``;
a round where every client drops changes nothing but the step.

Worker-side DP (``dp_noise_multiplier``): after the clip, each client's
gradient gets Gaussian noise from a ``torch.Generator`` seeded by
``dp_seed(seed, step, client id)``, so a resumed round draws what the
unbroken run drew. The draws are made before the clients run, in client
order, and go in as an argument.

The clients of a rank run batched, as the reference's ``vmap`` runs them:
``batched_client_transmits`` is one ``torch.func.vmap`` of the per-client
function (gradient by ``torch.func.grad``, local momentum, the transmit
rule, the fedsim masks) over the rank's clients, and the stack of
transmits is summed. ``client_transmits``, the same clients one after
another, is its plain version; the round does not call it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from commefficient_tpu_torch.models.losses import IGNORE_INDEX
from commefficient_tpu_torch.ops.collectives import (
    OVERLAP_SEGMENTS,
    sparse_allreduce,
)
from commefficient_tpu_torch.ops.countsketch import SketchGradTap, sketch_vec
from commefficient_tpu_torch.ops.cuda.countsketch import prepare_segments
from commefficient_tpu_torch.ops.param_utils import (
    clip_by_global_norm,
    tree_leaves,
    tree_with_leaves,
)
from commefficient_tpu_torch.telemetry.diagnostics import (
    round_diagnostics,
    round_diagnostics_sparse,
)


@dataclass
class FedState:
    """Server and client state. Absent leaves are ``None``. Every leaf is
    replicated on every rank except the SHARDED ones, of which each rank
    holds its ``[padded_dim(D, W) / W]`` slice (``padded_dim`` rounds D up
    to a multiple of the group's size W, the tail zeros): the dense
    momentum and error of true_topk under sparse aggregation, and under
    FSDP the params and every dense server leaf (``FederatedSession.
    sharded_leaves`` names them; ``full_state`` gathers them)."""

    params_vec: torch.Tensor  # [D] | [S] slice (FSDP)
    momentum: Optional[torch.Tensor] = None  # [D] | [S] | [r, c] | None
    error: Optional[torch.Tensor] = None  # [D] | [S] | [r, c] | None
    client_vel: Optional[torch.Tensor] = None  # [num_clients, D] | None
    client_err: Optional[torch.Tensor] = None  # [num_clients, D] | None
    step: int = 0
    comp: Any = None  # compressor-private warm state (powersgd's Q) | None


class AggregationPlan(NamedTuple):
    """How a round aggregates over the group and decodes at the server
    (``cfg.aggregate`` and ``cfg.sketch_decode`` resolved for the
    compressor and the group)."""

    use_sparse_agg: bool
    sparse_state: bool  # true_topk sparse: server state sharded by rank
    sparse_gather: bool  # local_topk: the W*k-pair all_gather rebuild
    sharded_decode: bool  # sketch: each rank decodes its slice
    sparse_apply: bool  # either sparse decode: (idx, val) candidate apply


def resolve_aggregation(cfg, comp, Wd: int) -> AggregationPlan:
    use_sparse_agg = comp.use_sparse_aggregate(Wd)
    sparse_state = use_sparse_agg and comp.sparse_aggregate_shards_state
    sparse_gather = (use_sparse_agg and not sparse_state
                     and not comp.needs_sketch_spec)
    sharded_decode = comp.use_sharded_decode(Wd)
    return AggregationPlan(
        use_sparse_agg=use_sparse_agg, sparse_state=sparse_state,
        sparse_gather=sparse_gather, sharded_decode=sharded_decode,
        sparse_apply=sharded_decode or sparse_state)


def padded_dim(d: int, n_shards: int) -> int:
    """``d`` rounded up to a multiple of ``n_shards``: the length of a
    sharded leaf before it is split."""
    return -(-d // n_shards) * n_shards


def fused_clients(cfg, comp) -> bool:
    """The reference's gate for the flattened-batch gradient: asked for,
    the same math for the mode, and nothing per client (no local momentum,
    no local error, no per-gradient clip, no DP noise, no fedsim
    masking)."""
    return bool(cfg.fuse_clients and comp.supports_fused_clients
                and cfg.local_momentum == 0 and cfg.error_type != "local"
                and cfg.max_grad_norm is None
                and cfg.dp_noise_multiplier == 0
                and not cfg.fedsim_enabled)


def init_state(cfg, comp, params_vec: torch.Tensor) -> FedState:
    """Allocate exactly the state the (mode, error_type, momenta)
    combination needs: server leaves from the compressor, the client banks
    from the config (velocity with local momentum, error with local error
    feedback), all on ``params_vec``'s device. A hosted store's banks are
    clientstore/'s, not the state's: none is allocated here."""
    dev = params_vec.device
    momentum, error, extra = comp.init_server_state(dev)

    def bank(needed: bool):
        return (torch.zeros(cfg.num_clients, comp.d, dtype=torch.float32,
                            device=dev)
                if needed and not cfg.client_state_hosted else None)

    return FedState(params_vec.to(torch.float32), momentum, error,
                    bank(cfg.local_momentum > 0),
                    bank(cfg.error_type == "local"),
                    0, extra)


class DeviceEnv(NamedTuple):
    """A round's fedsim environment as device tensors, the one form the
    round computes with: ``live`` and ``corrupt`` the ``[W]`` f32 masks,
    ``count`` the 0-d f32 live count. A host ``fedsim.RoundEnv`` becomes
    one where it enters the round (``device_env``); the scan engine's
    captured rounds (``pipeline/scan_engine.py``) slice theirs from the
    epoch's staged arrays, so no host value is frozen into a graph."""

    live: torch.Tensor
    corrupt: torch.Tensor
    count: torch.Tensor


def device_env(env, device) -> Optional[DeviceEnv]:
    """``env`` as a ``DeviceEnv`` on ``device``: a host ``RoundEnv``'s
    masks and live count in one copy; a ``DeviceEnv`` or None as given."""
    if env is None or isinstance(env, DeviceEnv):
        return env
    W = len(env.live)
    buf = torch.from_numpy(np.concatenate([
        np.asarray(env.live, np.float32), np.asarray(env.corrupt, np.float32),
        np.asarray([env.live_count], np.float32)]))
    if torch.device(device).type == "cuda":
        # pinned, so the copy does not wait for the stream's queued work
        buf = buf.pin_memory().to(device, non_blocking=True)
    else:
        buf = buf.to(device)
    return DeviceEnv(buf[:W], buf[W:2 * W], buf[2 * W])


DP_STREAM = 0xD9  # the DP draws' stream tag in dp_seed


def dp_seed(seed: int, *key: int) -> int:
    """The seed of one DP draw's ``torch.Generator``: the first 64-bit word
    of numpy's ``SeedSequence([seed, DP_STREAM, *key])``, ``key`` being
    ``(step, client id)`` (fedavg appends the local step). A pure function
    of the run's seed and the round, so a resumed round draws what the
    unbroken run drew."""
    # a captured round never draws: the scan engine passes the noise it
    # drew before the replay
    # lint: allow[traced-purity] a pure function of (seed, key), no state
    ss = np.random.SeedSequence([int(seed) & 0x7FFFFFFF, DP_STREAM,
                                 *map(int, key)])
    return int(ss.generate_state(1, np.uint64)[0])


def dp_noise(seed: int, key, d: int, device) -> torch.Tensor:
    """The standard normal ``[d]`` f32 draw of DP key ``key`` on
    ``device``. The card and the CPU draw differently, and neither draws
    JAX's threefry normals: parity with the reference is statistical."""
    gen = torch.Generator(device=device)
    gen.manual_seed(dp_seed(seed, *key))
    return torch.randn(d, generator=gen, device=device, dtype=torch.float32)


def make_grad_one(cfg, loss_fn: Callable, unravel: Callable,
                  batched: bool = True):
    """``(params_vec, batch, noise_key=None, noise=None) -> (flat grad
    [D], loss, aux)`` with weight decay, the global-norm clip and
    worker-side DP noise (``noise``, a standard normal ``[D]`` draw, or
    else ``dp_noise`` of ``noise_key``, times ``dp_noise_multiplier *
    max_grad_norm``), in the reference's order. The loss reads its
    parameters as views of the flat vector, and ``torch.func.grad``
    differentiates it with respect to those views, each a leaf; the
    leaves' gradients are concatenated in ravel order (the transpose of
    ``ravel_pytree``): one [D] write. Differentiating the flat vector
    through its views instead would give every view's backward a
    zero-filled [D] buffer to add (150 leaves of 498 MB at GPT-2 scale).
    Being a ``torch.func`` transform, it runs under ``torch.func.vmap``
    (the batched clients), and under ``torch.no_grad`` as well.

    ``batched=False`` differentiates the views as ``requires_grad``
    leaves with ``torch.autograd.grad`` instead: the fused
    flattened-batch gradient, one gradient under no transform. It must
    give the sketch-fused backward's cotangents bit for bit, and
    ``torch.func.grad`` cannot: it always records the backward's own
    graph, which switches group norm's backward from the fused kernel
    to a composite.

    A loss with a ``grad_total`` attribute (``parallel/tensor.py``'s
    TP/SP loss) has it applied to the raw flat gradient, before weight
    decay, the clip and the noise."""

    sigma = (cfg.dp_noise_multiplier * cfg.max_grad_norm
             if cfg.dp_noise_multiplier > 0 else 0.0)

    def loss_of_leaves(leaves, tree, batch):
        loss, aux = loss_fn(tree_with_leaves(tree, leaves), batch)
        return loss, (loss, aux)

    grad_leaves = torch.func.grad(loss_of_leaves, has_aux=True)
    grad_total = getattr(loss_fn, "grad_total", None)

    def leaf_grads(tree, batch):
        """(each leaf's gradient in ravel order, loss, aux)."""
        leaves = [t for _, t in tree_leaves(tree)]
        if batched:
            grads, (loss, aux) = grad_leaves(leaves, tree, batch)
            return grads, loss, aux
        leaves = [t.requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            loss, aux = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return ([torch.zeros_like(t) if gi is None else gi
                 for t, gi in zip(leaves, grads)], loss.detach(),
                {k: v.detach() for k, v in aux.items()})

    def grad_one(params_vec, batch, noise_key=None, noise=None):
        grads, loss, aux = leaf_grads(unravel(params_vec.detach()), batch)
        g = torch.cat([gi.reshape(-1) for gi in grads]).to(torch.float32)
        if grad_total is not None:
            g = grad_total(g)
        if cfg.weight_decay:
            g = g + cfg.weight_decay * params_vec
        g = clip_by_global_norm(g, cfg.max_grad_norm)
        if sigma:
            if noise is None:
                if noise_key is None:
                    raise ValueError("DP noise needs the draw's key (step, "
                                     "client id)")
                noise = dp_noise(cfg.seed, noise_key, g.shape[-1], g.device)
            g = g + sigma * noise
        return g, loss, aux

    return grad_one


def client_noise(cfg, comp, keys, batch, d: int, device):
    """The DP draws of a rank's clients, made before they run and stacked
    in client order: ``[w, D]`` (fedavg: ``[w, L, D]``, a draw a local
    step), each ``dp_noise`` of the client's key (``keys``, ``[w]`` of
    ``(step, client id)``) as ``make_grad_one`` draws it from the key.
    ``None`` without keys (no DP)."""
    if keys is None:
        return None

    def draw(key):
        return dp_noise(cfg.seed, key, d, device)

    return torch.stack([
        comp.client_noise(draw, key, {k: v[i] for k, v in batch.items()})
        for i, key in enumerate(keys)])


def leaf_offsets(unravel: Callable, d: int):
    """The (offset, size) of every parameter leaf in the flat ``[D]``
    layout, in ravel order (the static segments of the fused backward)."""
    out, off = [], 0
    for _, t in tree_leaves(unravel(torch.zeros(d, device="meta"))):
        out.append((off, t.numel()))
        off += t.numel()
    return out


def leaf_groups(sizes, segments):
    """Leaf indices ``[0, len(sizes))`` in up to ``segments`` CONTIGUOUS
    non-empty groups of near-equal total size (the layerwise overlap's
    buckets): ``(start, stop)`` bounds covering every leaf once (the
    reference's rule)."""
    n = len(sizes)
    g = max(1, min(int(segments), n))
    cum, total = [], 0
    for sz in sizes:
        total += sz
        cum.append(total)
    bounds, start = [], 0
    for k in range(1, g + 1):
        target = total * k / g
        stop = start + 1
        while stop < n and cum[stop - 1] < target:
            stop += 1
        stop = min(stop, n - (g - k))  # leave >= 1 leaf per later group
        bounds.append((start, stop))
        start = stop
    bounds[-1] = (bounds[-1][0], n)
    return bounds


def make_sketch_grad_one(cfg, loss_fn: Callable, unravel: Callable, spec,
                         d: int, overlap_segments: Optional[int] = None):
    """The sketch-fused twin of ``make_grad_one`` for the fused
    flattened-batch path: ``(params_vec, batch) -> (gradient table [r,
    c_actual] f32, loss, aux)``.

    Every parameter leaf goes through a ``SketchGradTap`` sharing one zero
    f32 table, and the loss is differentiated with respect to that table:
    each tap's backward adds its leaf's cotangent's sketch into the table
    where autograd produces it (K1's segment form at the leaf's ravel
    offset: one table, not one a leaf), in the fixed order of autograd's
    backward, so the table ends as the sketch of the whole flat gradient.
    The parameters are not differentiated, so the flat ``[D]`` gradient
    (``make_grad_one``'s ``torch.cat``) never exists. Weight decay joins
    by linearity as
    ``weight_decay * sketch_vec(spec_f32, params_vec)`` (K1 on the params
    vector, which exists anyway), ``spec_f32`` the spec with f32 table
    storage (the reference's ``spec._replace(table_dtype=float32)``).
    Config refuses every per-client setting (clip, DP, local momentum,
    fedsim) with it.

    ``overlap_segments`` (the layerwise overlap): the leaves form up to
    that many contiguous groups (``leaf_groups``), each tap writes into
    its group's own zero table, and the function is ``(params_vec, batch,
    on_group=None) -> (tuple of group tables, loss, aux)``. The sum of the
    group tables is the monolithic table up to f32 summation order (the
    fused backward's own tolerance). ``on_group(g, table)`` is called once
    a group, as soon as the backward has written every leaf of group
    ``g`` (each tap counts itself), so the caller can start the group's
    sum over the worker group while the backward goes on; groups whose
    count never completes (a leaf with no gradient), and group 0 when
    there is weight decay, are reported after the backward, group 0 with
    the weight-decay term added (``weight_decay * sketch_vec(spec_f32,
    params_vec)`` rides the first group's table, as in the reference).

    A loss with a ``grad_total`` attribute (``parallel/tensor.py``'s
    TP/SP loss) is the model/seq-sharded one: the taps of its ``dropped``
    ranges (the leaves whose gradient rank 0 of a model or seq group
    contributes) add nothing, and each group table is summed over the
    model and seq groups by its ``table_total`` before it is reported,
    the weight-decay term after that sum (once, not once a rank). Every
    leaf keeps its tap, so each rank of a group completes its groups at
    the same point of the backward and the sums pair up."""
    segments = leaf_offsets(unravel, d)
    offsets = [off for off, _ in segments]
    spec_f32 = replace(spec, table_dtype=torch.float32)
    # the monolithic table is the one group of every leaf
    groups = (leaf_groups([n for _, n in segments], overlap_segments)
              if overlap_segments else [(0, len(segments))])
    grad_total = getattr(loss_fn, "grad_total", None)
    dropped = grad_total.dropped if grad_total is not None else ()
    leaf_spec = [None if any(a <= off and off + n <= b for a, b in dropped)
                 else spec for off, n in segments]

    def grad_group_tables(params_vec, batch, on_group=None):
        prepare_segments(spec, segments, params_vec.device)
        tree = unravel(params_vec.detach())
        leaves = [t for _, t in tree_leaves(tree)]
        accs = [torch.zeros(spec.table_shape, dtype=torch.float32,
                            device=params_vec.device, requires_grad=True)
                for _ in groups]
        left = [b - a for a, b in groups]
        tables = [None] * len(groups)

        def finish(g):
            table = accs[g].detach()
            if grad_total is not None:
                table = grad_total.table_total(table)
            if g == 0 and cfg.weight_decay:
                table = table + cfg.weight_decay * sketch_vec(spec_f32,
                                                              params_vec)
            tables[g] = table
            if on_group is not None:
                on_group(g, table)

        def done(g):
            def tick():
                left[g] -= 1
                if left[g] == 0 and not (g == 0 and cfg.weight_decay):
                    finish(g)
            return tick

        with torch.enable_grad():
            tapped = list(leaves)
            for g, (a, b) in enumerate(groups):
                for i in range(a, b):
                    tapped[i] = SketchGradTap.apply(
                        leaves[i], accs[g], leaf_spec[i], offsets[i],
                        done(g))
            loss, aux = loss_fn(tree_with_leaves(tree, tapped), batch)
            torch.autograd.grad(loss, accs, allow_unused=True)
        for g, t in enumerate(tables):
            if t is None:
                finish(g)
        return (tuple(tables), loss.detach(),
                {k: v.detach() for k, v in aux.items()})

    if overlap_segments:
        return grad_group_tables

    def grad_one_table(params_vec, batch):
        tables, loss, aux = grad_group_tables(params_vec, batch)
        return tables[0], loss, aux

    return grad_one_table


def make_per_client(cfg, comp, grad_one):
    """``per_client(params_vec, batch, vel_row, err_row, lr, noise=None,
    live=None, corrupt=None) -> (transmit, new_vel, new_err, loss, aux)``:
    the compressor's gradient rule, local momentum, then its transmit rule.
    Rows are ``None`` where the bank is absent (and so are the new rows).
    ``lr`` is ``comp.client_lr``'s (fedavg: the local lr tensor), ``noise``
    the client's DP draw (``client_noise``'s row). ``live``/``corrupt``
    (0-d f32 tensors, fedsim): corruption first, then the live mask, both
    by ``torch.where`` (a zero mask blocks even a corrupted NaN, where a
    product would let it through); the loss and aux are multiplied by the
    mask, and a masked client's velocity and error rows carry forward
    unchanged (the reference's order)."""
    lm = cfg.local_momentum

    def per_client(params_vec, batch, vel, err, lr, noise=None, live=None,
                   corrupt=None):
        g, loss, aux = comp.client_grad(grad_one, params_vec, batch, noise,
                                        lr)
        u = lm * vel + g if lm > 0 else g
        transmit, new_vel, new_err = comp.client_transmit(u, err, lr)
        if vel is None:
            new_vel = None
        if live is not None:
            on = live > 0
            transmit = torch.where(corrupt > 0, float("nan"), transmit)
            transmit = torch.where(on, transmit, 0.0)
            loss = loss * live
            aux = {k: v * live for k, v in aux.items()}
            if vel is not None:
                new_vel = torch.where(on, new_vel, vel)
            if err is not None:
                new_err = torch.where(on, new_err, err)
        return transmit, new_vel, new_err, loss, aux

    return per_client


def _add(total, x):
    return x if total is None else total + x


def fused_grad_sum(grad_one, params_vec, batch: Dict[str, torch.Tensor]):
    """``(w * g, w * loss, aux)``: the fused clients' stand-in for the sum
    of the ``w`` per-client gradients of ``batch`` ({k: [w, B, ...]}), one
    gradient of the flattened ``[w * B, ...]`` batch."""
    w = next(iter(batch.values())).shape[0]
    flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in batch.items()}
    g, loss, aux = grad_one(params_vec, flat)
    return w * g, w * loss, aux


def client_transmits(per_client, params_vec, batch, vel_rows, err_rows, lr,
                     noise=None, live=None, corrupt=None):
    """The per-client loop, the plain version of
    ``batched_client_transmits`` (same arguments, same outputs): the
    clients one after another, summed in client order. Tests and
    ``chip_smoke.py`` hold the batched step against it; the round does
    not call it."""
    w = next(iter(batch.values())).shape[0]
    t_sum = loss_sum = aux_sum = None
    vels, errs = [], []
    for i in range(w):
        t, vel, err, loss, aux = per_client(
            params_vec, {k: v[i] for k, v in batch.items()},
            None if vel_rows is None else vel_rows[i],
            None if err_rows is None else err_rows[i], lr,
            None if noise is None else noise[i],
            None if live is None else live[i],
            None if corrupt is None else corrupt[i])
        t_sum, loss_sum = _add(t_sum, t), _add(loss_sum, loss)
        aux_sum = aux if aux_sum is None else {k: aux_sum[k] + v
                                               for k, v in aux.items()}
        if vel_rows is not None:
            vels.append(vel)
        if err_rows is not None:
            errs.append(err)
    return (t_sum, loss_sum, aux_sum,
            None if vel_rows is None else torch.stack(vels),
            None if err_rows is None else torch.stack(errs))


def batched_client_rows(per_client, params_vec, batch, vel_rows, err_rows,
                        lr, noise=None, live=None, corrupt=None):
    """The clients of ``batch`` ({k: [w, ...]}) as one batched step, the
    reference's ``vmap``: ``(transmits [w, D], new_vel_rows [w, D] | None,
    new_err_rows [w, D] | None, losses [w], aux {k: [w]})``, one row a
    client. A rows argument is ``None`` where its bank is absent; ``lr`` is
    ``comp.client_lr``'s; ``noise`` (``client_noise``'s ``[w, ...]``
    draws), ``live`` and ``corrupt`` (``[w]`` f32 masks, fedsim) go to
    each client where given. ``torch.func.vmap`` maps ``per_client`` over
    axis 0 of every per-client argument; an op it cannot batch raises
    (there is no fallback to the loop), and so does any random draw inside
    (the DP draws come in as ``noise``). The buffered-async launch keeps
    these rows; the round sums them (``batched_client_transmits``)."""

    def dim(x):
        return None if x is None else 0

    step = torch.func.vmap(
        per_client,
        in_dims=(None, 0, dim(vel_rows), dim(err_rows), None, dim(noise),
                 dim(live), dim(corrupt)),
        out_dims=(0, dim(vel_rows), dim(err_rows), 0, 0))
    return step(params_vec, batch, vel_rows, err_rows, lr, noise, live,
                corrupt)


def batched_client_transmits(per_client, params_vec, batch, vel_rows,
                             err_rows, lr, noise=None, live=None,
                             corrupt=None):
    """``batched_client_rows`` with its stacks summed over the clients:
    ``(transmit sum [D], loss sum, aux sums, new_vel_rows [w, D] | None,
    new_err_rows [w, D] | None)``."""
    t, new_vel, new_err, loss, aux = batched_client_rows(
        per_client, params_vec, batch, vel_rows, err_rows, lr, noise, live,
        corrupt)
    return (torch.sum(t, 0), torch.sum(loss, 0),
            {k: torch.sum(v, 0) for k, v in aux.items()}, new_vel, new_err)


def client_inputs(cfg, comp, state: FedState, client_ids, batch, lr: float,
                  env=None, lo: int = 0, rows=None,
                  key_step: Optional[int] = None, noise=None):
    """The client step's arguments after ``per_client``, for this rank's
    clients ``[lo, lo + w)`` of ``batch`` ({k: [w, ...]}): ``(params_vec,
    batch, vel_rows, err_rows, lr, noise, live, corrupt)``. ``rows`` is
    the pair ``(vel_rows, err_rows)`` of this rank's ``[w, D]`` rows (a
    hosted store's, gathered before the round); without it the rows are
    read from the state's banks at ``client_ids`` (the cohort's ``[W]``
    ids). The DP draws are keyed ``(key_step, client id)`` (by slot when
    no ids are given; ``key_step`` is ``state.step`` unless given: a
    buffered-async launch passes its launch version) and made here
    (``client_noise``) unless ``noise``, the draws made before the round
    (the scan engine's), is given; ``live``/``corrupt`` are the rank's
    slice of ``env``'s masks (fedsim: a ``DeviceEnv``, or a ``RoundEnv``
    made one by ``device_env``); ``lr`` is ``comp.client_lr``'s. Absent
    parts are ``None``."""
    dev = state.params_vec.device
    w = next(iter(batch.values())).shape[0]
    if rows is None:
        banks = (state.client_vel, state.client_err)
        mine = (client_ids[lo:lo + w] if any(b is not None for b in banks)
                else None)
        rows = [None if b is None else b[mine] for b in banks]
    if noise is None and cfg.dp_noise_multiplier > 0:
        # under capture the scan engine always passes the noise it drew
        # before the replay (the dp case of the block-program check in
        # tests/test_torch_scan_engine.py)
        # lint: allow[traced-purity] the per-round path's draw only
        ids = (range(cfg.num_workers) if client_ids is None
               else client_ids.tolist())
        step = state.step if key_step is None else int(key_step)
        noise = client_noise(cfg, comp,
                             dp_keys(step, ids, lo, w), batch, comp.d, dev)
    masks = (None, None)
    if env is not None:
        env = device_env(env, dev)
        masks = (env.live[lo:lo + w], env.corrupt[lo:lo + w])
    return (state.params_vec, batch, *rows, comp.client_lr(lr, dev), noise,
            *masks)


def dp_keys(step: int, ids, lo: int, w: int):
    """The DP keys ``(step, client id)`` of a rank's clients ``[lo, lo +
    w)`` of a round's ``[W]`` ids (host ints)."""
    return [(int(step), int(ids[lo + i])) for i in range(w)]


def make_aggregate_tail(cfg, comp, plan: AggregationPlan, group, d: int):
    """``aggregate_tail(local, loss_sum, aux, w_loc) -> (agg, loss_mean,
    aux_sum)``: the device's encoded transmit summed over the group and
    divided by W, the mean client loss, the summed aux, by the plan's
    branch (the reference's ``make_aggregate_tail``):

    * a tuple ``local`` (the layerwise fused backward): one pending sum a
      leaf-group table (started during the backward), waited on in group
      order and added in f32;
    * ``sparse_state``: a reduce-scatter of the transmit sum padded to
      ``padded_dim(d, Wd)``: this rank's ``[padded_dim / Wd]`` slice;
    * ``sparse_gather``: ``sparse_allreduce`` of the rank's at most
      ``w_loc * k`` nonzeros (segmented under the layerwise overlap),
      the dense sum rebuilt on every rank;
    * dense: one ``all_reduce``."""
    W, Wd = cfg.num_workers, group.size
    segs = comp.overlap_segments

    def aggregate_tail(local, loss_sum, aux, w_loc: int):
        if isinstance(local, tuple):
            summed = [p.wait() for p in local]
            agg = summed[0].to(torch.float32)
            for t in summed[1:]:
                agg = agg + t.to(torch.float32)
            agg = agg / W
        elif plan.sparse_state:
            dp = padded_dim(d, Wd)
            agg = group.reduce_scatter(
                torch.nn.functional.pad(local, (0, dp - d))) / W
        elif plan.sparse_gather:
            agg = sparse_allreduce(local, w_loc * cfg.k, group,
                                   segments=segs) / W
        else:
            agg = group.all_reduce_sum(local) / W
        keys = list(aux)
        sums = group.all_reduce_sum(torch.stack([loss_sum]
                                                + [aux[k] for k in keys]))
        return agg, sums[0] / W, dict(zip(keys, sums[1:]))

    return aggregate_tail


def live_scale(W: int, count: torch.Tensor) -> torch.Tensor:
    """``W / max(count, 1)`` in f32 for a 0-d f32 ``count``, the
    reference's live-count renormalization (the f32 division, then the
    product in f32), as a 0-d tensor: a tensor divided by a tensor, never
    by a Python scalar, which on the card is a product with its
    reciprocal and not the same bits."""
    return (torch.full((), W, dtype=torch.float32, device=count.device)
            / torch.clamp(count.to(torch.float32), min=1.0))


def hold_if_empty(alive: torch.Tensor, update, state: FedState, new_m,
                  new_e, new_c):
    """The empty-round rule: where ``alive`` (a 0-d bool tensor) is False
    the update is zeroed and the server leaves keep their values, by
    ``torch.where`` (no branch on the host, so a captured round holds
    it); where True every value passes through bit for bit."""

    def hold(new, old):
        if not torch.is_tensor(new):
            return new
        return torch.where(alive, new, old)

    kind, u = update
    if kind == "dense":
        update = (kind, torch.where(alive, u, torch.zeros_like(u)))
    else:
        update = (kind, (u[0], torch.where(alive, u[1],
                                           torch.zeros_like(u[1]))))
    return (update, hold(new_m, state.momentum), hold(new_e, state.error),
            hold(new_c, state.comp))


def server_phase(cfg, comp, plan: AggregationPlan, group, state: FedState,
                 agg, lr: float, count: Optional[torch.Tensor] = None,
                 draw: Optional[torch.Tensor] = None):
    """The server half of a round: the compressor's momentum/error algebra
    and extraction (the dense decode, the sharded decode, or under
    ``sparse_state`` the sliced ``server_update_sparse``), then, for the
    dense decode, the optional downlink top-k. Returns ``(update, new_momentum,
    new_error, new_comp, agg)``: ``update`` for ``apply_update``,
    ``("dense", delta)`` or ``("sparse", (idx, val))``, and ``agg`` the
    aggregate the server step consumed (scaled under fedsim), which the
    diagnostics read.

    ``count`` (fedsim: the live clients of the whole round, a
    ``DeviceEnv``'s 0-d f32 tensor) scales ``agg`` by ``live_scale(W,
    count)`` first (``agg`` in f32, as the reference's product promotes a
    bf16 table) — every encode is linear, so a masked round equals the
    round over its live cohort — and with ``count == 0`` zeroes the update
    and keeps momentum, error and ``comp`` as they were
    (``hold_if_empty``).

    ``draw`` is the server step's host draw, ``comp.round_draw(state.
    step)`` made before the round and passed in on the device (None for a
    mode that draws nothing)."""
    if count is not None:
        agg = agg.to(torch.float32) * live_scale(cfg.num_workers, count)
    if plan.sparse_apply:
        decode = (comp.server_update_sparse if plan.sparse_state
                  else comp.server_update_sharded)
        g_idx, g_val, new_m, new_e, new_c = decode(
            state.momentum, state.error, state.comp, agg, lr, state.step,
            group=group, d=state.params_vec.numel())
        update = ("sparse", (g_idx, g_val))
    else:
        delta, new_m, new_e, new_c = comp.server_update(
            state.momentum, state.error, state.comp, agg, lr, state.step,
            draw=draw)
        if cfg.do_topk_down and comp.dense_delta:
            delta = comp.topk(delta, cfg.k)
        update = ("dense", delta)
    if count is not None:  # nothing arrived: nothing moves
        update, new_m, new_e, new_c = hold_if_empty(
            count > 0, update, state, new_m, new_e, new_c)
    return update, new_m, new_e, new_c, agg


def apply_update(params_vec: torch.Tensor, update) -> torch.Tensor:
    """``w - delta``, or for the sharded decode's gathered candidates
    ``w`` with ``val`` subtracted at ``idx`` (a new tensor: the state it
    came from stays as it was). Candidate coordinates are distinct apart
    from pads, whose val is 0.0, so the scatter's order cannot change the
    sum."""
    kind, u = update
    if kind == "dense":
        return params_vec - u
    g_idx, g_val = u
    return params_vec.index_add(0, g_idx, -g_val)


def write_rows(group, bank, client_ids, rows):
    """Write every rank's new rows (this rank's ``rows [w_loc, D]``,
    all-gathered in rank order to the cohort's ``[W, D]``) into ``bank`` at
    ``client_ids``, in place: no round copies a ``[num_clients, D]``
    bank. Returns the gathered ``[W, D]`` rows, None when the bank is
    absent."""
    if bank is None:
        return None
    rows = group.all_gather(rows)
    bank.index_copy_(0, client_ids, rows)
    return rows


def round_diag(cfg, comp, plan: AggregationPlan, group, state: FedState,
               new_state: FedState, update, agg, loss, lr: float,
               err_rows=None) -> dict:
    """The round's ``diag/*`` scalars (``telemetry/diagnostics.py``) from
    what it holds: the pre-update ``state``, the applied ``update``, the
    ``new_state``, the aggregate and, under local error (the only
    configuration with a client error bank), the cohort's ``[W, D]`` new
    error rows (``write_rows``' gather)."""
    kind, u = update
    common = dict(agg=agg, new_params=new_state.params_vec, loss=loss, lr=lr,
                  momentum=state.momentum, error=state.error,
                  extra=state.comp, new_momentum=new_state.momentum,
                  new_error=new_state.error,
                  group=group if plan.sparse_state else None)
    if kind == "sparse":
        return round_diagnostics_sparse(cfg, comp, idx=u[0], val=u[1],
                                        **common)
    return round_diagnostics(cfg, comp, delta=u, client_err_rows=err_rows,
                             **common)


def hosts_client_rows(cfg) -> bool:
    """True when the round's client rows come from a clientstore/ bank: a
    hosted store (``cfg.client_state_hosted``) and a bank to host (local
    momentum or local error feedback)."""
    return bool(cfg.client_state_hosted and (cfg.local_momentum > 0
                                             or cfg.error_type == "local"))


def build_round_fn(cfg, loss_fn: Callable, unravel: Callable, comp, group):
    """``round_fn(state, client_ids, batch, lr, mark=None, env=None) ->
    (new_state, metrics)``; with hosted client rows
    (``hosts_client_rows(cfg)``) ``round_fn(state, client_ids, batch, lr,
    vel_rows, err_rows, mark=None, env=None) -> (new_state, metrics,
    new_vel, new_err)``: ``vel_rows``/``err_rows`` are this rank's ``[w,
    D]`` rows of the cohort (None for an absent bank), and ``new_vel``/
    ``new_err`` the whole cohort's ``[W, D]`` new rows (every rank's,
    all-gathered in rank order) for the session's streamer to write back;
    no bank is read or written here. ``client_ids`` is the cohort's ``[W]``
    int64 tensor on the state's device (required with client state, else
    may be ``None``), ``batch`` holds this rank's clients. ``env`` is the round's
    ``fedsim.RoundEnv`` (required when ``cfg.fedsim_enabled``, else
    unused): its ``[W]`` masks, of which each rank applies its slice, and the
    round's global live count; a ``DeviceEnv`` holds the same as device
    tensors. ``lr`` is a float or a 0-d f32 tensor, and ``noise`` the
    rank's DP draws made before the round (``client_noise``'s; None draws
    them here), ``draw`` the server step's host draw made before the
    round (``comp.round_draw(state.step)`` on the device; None for a mode
    that draws nothing): the scan engine's captured rounds pass tensors,
    so no host value is frozen into a graph. ``mark(i)``, when given, is called as phase
    ``i`` begins (0: the client gradients and transmits, 1: the encode and
    aggregate, 2: the server, 3: the apply, the banks' write-back and, at
    ``telemetry_level >= 1``, the ``diag/*`` scalars) and at the end
    (4)."""
    comp.resolved_dampening()  # the mode's warnings, once, at build time
    per_client = make_per_client(cfg, comp,
                                 make_grad_one(cfg, loss_fn, unravel))
    grad_flat = make_grad_one(cfg, loss_fn, unravel, batched=False)
    plan = resolve_aggregation(cfg, comp, group.size)
    fused = fused_clients(cfg, comp)
    sketch_fused = bool(cfg.sketch_fused_bwd)
    if sketch_fused and not (fused and comp.supports_fused_backward):
        raise ValueError(
            "sketch_fused_bwd requires the fused flattened-batch path and "
            f"a fused-backward-capable compressor (mode={cfg.mode!r}, "
            f"fused={fused}) — Config validation should have caught this")
    layerwise = cfg.overlap_collectives == "layerwise"
    grad_table_one = (make_sketch_grad_one(
        cfg, loss_fn, unravel, comp.spec, comp.d,
        overlap_segments=OVERLAP_SEGMENTS if layerwise else None)
        if sketch_fused else None)
    fedsim = bool(cfg.fedsim_enabled)
    W = cfg.num_workers
    w_loc = W // group.size
    lo = group.rank * w_loc
    aggregate_tail = make_aggregate_tail(cfg, comp, plan, group, comp.d)
    telemetry = cfg.telemetry_level >= 1
    hosted = hosts_client_rows(cfg)

    @torch.no_grad()
    def round_fn(state: FedState, client_ids, batch, lr: float, *rows,
                 mark=None, env=None, noise=None, draw=None):
        mark = mark or (lambda i: None)
        if fedsim and env is None:
            raise ValueError(
                "fedsim is enabled (cfg.fedsim_enabled) but no env was "
                "passed: supply the round's fedsim.RoundEnv "
                "(FederatedSession.train_round does this)")
        if len(rows) != (2 if hosted else 0):
            want = "(vel_rows, err_rows)" if hosted else "no client rows"
            raise ValueError(
                f"round_fn takes {want} after lr (client_store="
                f"{cfg.client_store!r}), got {len(rows)} positional extras")
        mark(0)
        # a host RoundEnv's masks and count go to the card in one copy
        env = device_env(env, state.params_vec.device) if fedsim else None
        banks = (state.client_vel, state.client_err)
        stateful = hosted or any(b is not None for b in banks)
        if stateful and client_ids is None:
            raise ValueError(
                f"mode={cfg.mode!r} keeps per-client state (local_momentum"
                f"={cfg.local_momentum}, error_type={cfg.error_type!r}): "
                "train_round needs the cohort's client_ids")
        if sketch_fused and layerwise:
            # each group's table, encoded, starts its sum over the group
            # as soon as the backward has finished the group
            w = next(iter(batch.values())).shape[0]
            flat = {k: v.reshape((-1,) + v.shape[2:])
                    for k, v in batch.items()}
            pending = {}

            def start_sum(g, table):
                pending[g] = group.all_reduce_sum_async(
                    comp.encode_grad_table(w * table))

            _, loss, aux = grad_table_one(state.params_vec, flat,
                                          on_group=start_sum)
            encoded = tuple(pending[g] for g in sorted(pending))
            loss_sum = w * loss
        elif sketch_fused:
            w = next(iter(batch.values())).shape[0]
            flat = {k: v.reshape((-1,) + v.shape[2:])
                    for k, v in batch.items()}
            table, loss, aux = grad_table_one(state.params_vec, flat)
            encoded, loss_sum = comp.encode_grad_table(w * table), w * loss
        elif fused:
            local, loss_sum, aux = fused_grad_sum(grad_flat, state.params_vec,
                                                  batch)
        else:
            local, loss_sum, aux, new_vel, new_err = batched_client_transmits(
                per_client, *client_inputs(cfg, comp, state, client_ids,
                                           batch, lr, env if fedsim else None,
                                           lo, rows=rows or None,
                                           noise=noise))
        mark(1)
        if not sketch_fused:
            encoded = comp.device_encode(local)
        agg, loss, aux = aggregate_tail(encoded, loss_sum, aux, w_loc)
        count = env.count if fedsim else None
        if fedsim:  # the mean over the LIVE clients
            loss = loss * live_scale(W, count)
        mark(2)
        update, new_m, new_e, new_c, agg = server_phase(
            cfg, comp, plan, group, state, agg, lr, count, draw)
        mark(3)
        new_state = replace(
            state, params_vec=apply_update(state.params_vec, update),
            momentum=new_m, error=new_e, comp=new_c, step=state.step + 1)
        err_rows = None
        if hosted:  # the cohort's rows, for the streamer to write back
            new_vel, new_err = (None if t is None else group.all_gather(t)
                                for t in (new_vel, new_err))
            err_rows = new_err
        elif stateful:  # the banks carry over, updated in place
            write_rows(group, state.client_vel, client_ids, new_vel)
            err_rows = write_rows(group, state.client_err, client_ids,
                                  new_err)
        metrics = {"loss": loss, **aux}
        if telemetry:
            metrics.update(round_diag(cfg, comp, plan, group, state,
                                      new_state, update, agg, loss, lr,
                                      err_rows))
        mark(4)
        if hosted:
            return new_state, metrics, new_vel, new_err
        return new_state, metrics

    return round_fn


def _ignore_where(keep, labels):
    return torch.where(keep, labels, torch.full_like(labels, IGNORE_INDEX))


def mask_classification(batch, row_mask):
    return {**batch, "y": _ignore_where(row_mask, batch["y"])}


def mask_gpt2(batch, row_mask):
    """The GPT-2 batch's padded rows: their MC label and every LM label to
    IGNORE_INDEX."""
    return {**batch,
            "mc_labels": _ignore_where(row_mask, batch["mc_labels"]),
            "lm_labels": _ignore_where(row_mask[:, None, None],
                                       batch["lm_labels"])}


def build_eval_fn(loss_fn: Callable, unravel: Callable,
                  mask_batch: Callable = mask_classification):
    """``eval_step(params_vec, batch-with-_valid) -> metric sums``: padded
    tail rows are masked to IGNORE_INDEX by ``mask_batch(batch,
    row_mask)``."""

    @torch.no_grad()
    def eval_step(params_vec, batch):
        batch = dict(batch)
        valid = int(batch.pop("_valid"))
        n = next(iter(batch.values())).shape[0]
        row_mask = torch.arange(n, device=params_vec.device) < valid
        loss, aux = loss_fn(unravel(params_vec), mask_batch(batch, row_mask))
        return {"loss_sum": loss * valid, **aux}

    return eval_step
