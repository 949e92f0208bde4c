"""Ring attention over a ``seq`` group (sequence parallelism), counterpart of
:mod:`mmlearn_tpu.ops.ring_attention`.

The sequence is split over the ranks of a ``seq`` group: every rank keeps its
query block, and the key and value blocks travel around the ring, so the
``(N, N)`` scores never exist anywhere and each rank holds ``O(N / P)`` of
them. Each hop computes a block-normalized attention ``(o_i, lse_i)`` of the
resident queries over the visiting keys and folds it into a running pair with
the log-sum-exp merge (:func:`_merge`, in f32). The backward rotates ``(k, v,
dk, dv)`` a full circle, so every block's gradient returns to its owner; each
hop's ``dq``, ``dk`` and ``dv`` are taken against the merged global output
and log-sum-exp. The loops are the JAX package's ``_ring_fwd_loop`` (:257)
and ``_ring_bwd`` (:309), hop for hop, in a fixed order: a run gives the same
bits as the next.

The exchange between ranks is an object with ``size``, the ``ranks`` it
computes for and ``start``/``wait``: :class:`GroupExchange`, the production
one, posts ``torch.distributed.batch_isend_irecv`` to the next rank of the
group and from the previous one before a hop's kernels and waits after them,
so the transfer overlaps the compute as ``lax.ppermute`` does;
:class:`ListExchange` rotates a list of P ranks' blocks in one process (the
tests and ``chip_smoke.py`` run P ranks' hops on one device with it). The
loops are written once, over lists of the blocks of the ranks an exchange
computes for.

The hops. On a CPU tensor each hop is the plain block math of
``_block_attn_xla`` and ``_block_attn_bwd_xla`` (:102-173), with the causal
mask over global positions. On a CUDA tensor every hop runs on K3
(:mod:`~mmlearn_tpu_torch.ops.flash_attention`): the forward hop is K3f with
its f32 output (``_block_attn_flash`` :125), the backward hop K3b fed the
merged output in the input type and the global log-sum-exp
(``_block_attn_bwd_flash`` :176), whose dq, dk and dv in the input type the
ring sums in f32. The JAX package computes causal hops in XLA because its
Pallas kernels index positions block-locally; with equal blocks the causal
diagonal hop (``src == idx``) is K3 under its block-local causal mask, which
is the global one there, earlier hops are unmasked, and later hops are
skipped while their transfer moves on. There is no length threshold
(``MMLEARN_RING_FLASH_MIN_BLOCK`` has no counterpart) and no interpret switch
(``MMLEARN_RING_FLASH_INTERPRET``); a head dim K3 does not take raises.

:func:`sequence_sharded_attention` takes the global ``(B, H, N, D)`` arrays
and returns the global output, as the JAX ``shard_map`` does (:365-409): a
rank of a ``seq`` group holds the whole sequence outside attention, takes its
own block of q, k and v, runs the ring, and gathers the output blocks of the
group. The gather's backward returns this rank's block of the gradient (each
rank of the group holds the same gradient of the gathered output: summing
them would count it P times); the block's backward gathers the group's
gradient blocks, so every rank carries the whole gradient of q, k and v on.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

#: the JAX package's ``_NEG``: the log-sum-exp of a row that has seen no key
NEG = -0.7 * float(np.finfo(np.float32).max)


class ListExchange:
    """The exchange of P ranks' blocks in one process: the blocks of every
    rank are lists in rank order, and an exchange moves rank r's block to
    rank r + 1. ``hops`` counts the hops computed (``"forward"``,
    ``"backward"``) and skipped (``"skipped"``)."""

    def __init__(self, size: int) -> None:
        if size < 1:
            raise ValueError(f"a ring needs at least one rank, got {size}")
        self.size = int(size)
        self.ranks = tuple(range(self.size))
        self.hops = {"forward": 0, "backward": 0, "skipped": 0}

    def start(self, blocks: Sequence[list]):
        return [blk[-1:] + blk[:-1] for blk in blocks]

    def wait(self, handle):
        return handle

    def scatter(self, x: torch.Tensor) -> list:
        """Every rank's block of the sequence axis (2) of a global tensor."""
        return list(x.chunk(self.size, dim=2))

    def gather(self, blocks: list) -> torch.Tensor:
        return torch.cat(blocks, dim=2)


class GroupExchange:
    """The exchange of one rank of a ``torch.distributed`` group: its block
    goes to the next rank of the group and the previous rank's arrives,
    through ``batch_isend_irecv``. ``hops`` as :class:`ListExchange`'s."""

    def __init__(self, group) -> None:
        import torch.distributed as dist

        self.group = group
        self.size = dist.get_world_size(group)
        me = dist.get_rank(group)
        self.ranks = (me,)
        self._next = dist.get_global_rank(group, (me + 1) % self.size)
        self._prev = dist.get_global_rank(group, (me - 1) % self.size)
        self.hops = {"forward": 0, "backward": 0, "skipped": 0}

    def start(self, blocks: Sequence[list]):
        import torch.distributed as dist

        if self.size == 1:
            return None, [list(blk) for blk in blocks]
        ops, received = [], []
        for blk in blocks:
            sent = blk[0].contiguous()
            recv = torch.empty_like(sent)
            ops.append(dist.P2POp(dist.isend, sent, self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, recv, self._prev, self.group))
            received.append([recv])
        return dist.batch_isend_irecv(ops), received

    def wait(self, handle):
        works, received = handle
        for work in works or ():
            work.wait()
        return received

    def scatter(self, x: torch.Tensor) -> list:
        return [_SeqBlock.apply(x, self)]

    def gather(self, blocks: list) -> torch.Tensor:
        return _SeqGather.apply(blocks[0], self)


def _all_gather_seq(x: torch.Tensor, ex: GroupExchange) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(ex.size)]
    dist.all_gather(parts, x.contiguous(), group=ex.group)
    return torch.cat(parts, dim=2)


class _SeqBlock(torch.autograd.Function):
    """This rank's block of the sequence axis; the backward gathers the
    group's gradient blocks into the whole gradient."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return x.chunk(ex.size, dim=2)[ex.ranks[0]].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _all_gather_seq(grad, ctx.ex), None


class _SeqGather(torch.autograd.Function):
    """The group's blocks gathered along the sequence axis; the backward
    returns this rank's block of the gradient (not the group's sum: every
    rank holds the same gradient of the gathered output)."""

    @staticmethod
    def forward(ctx, x, ex):
        ctx.ex = ex
        return _all_gather_seq(x, ex)

    @staticmethod
    def backward(ctx, grad):
        ex = ctx.ex
        return grad.chunk(ex.size, dim=2)[ex.ranks[0]].contiguous(), None


# ------------------------------------------------------------------ hops


def _positions(idx: int, n: int, device) -> torch.Tensor:
    return idx * n + torch.arange(n, device=device)


def _block_scores(q, k, scale: float, causal: bool, idx: int, src: int):
    """f32 scores of one (q block, kv block) pair and where they are visible
    (``None``: everywhere), masked at ``NEG`` over global positions."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    keep = None
    if causal:
        keep = (_positions(idx, q.shape[2], q.device)[:, None]
                >= _positions(src, k.shape[2], q.device)[None, :])
        s = torch.where(keep, s, NEG)
    return s, keep


def block_attention_reference(q, k, v, scale: float, causal: bool, idx: int, src: int):
    """Plain version of a forward hop (``_block_attn_xla``): the
    block-normalized ``o`` (f32) and the block's log-sum-exp ``(B, H, n, 1)``
    (``NEG`` on rows with no visible key, whose ``o`` is 0)."""
    s, keep = _block_scores(q, k, scale, causal, idx, src)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", (p / l.clamp_min(1e-37)).to(v.dtype).float(),
                     v.float())
    lse = torch.where(l > 0.0, m + torch.log(l.clamp_min(1e-37)), NEG)
    return torch.where(l > 0.0, o, 0.0), lse


def block_attention_bwd_reference(q, k, v, do, delta, lse, scale: float, causal: bool,
                                  idx: int, src: int):
    """Plain version of a backward hop (``_block_attn_bwd_xla``) against the
    global softmax ``p = exp(s - lse)``: this hop's ``(dq, dk, dv)`` in f32.
    ``do`` and ``delta = rowsum(do * out)`` are f32."""
    s, keep = _block_scores(q, k, scale, causal, idx, src)
    p = torch.exp(s - lse)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    return dq, dk, dv


def _hop_forward(q, k, v, scale: float, causal: bool, idx: int, src: int):
    if q.device.type == "cpu":
        return block_attention_reference(q, k, v, scale, causal, idx, src)
    from mmlearn_tpu_torch.ops import flash_attention as fl

    # with equal blocks only the diagonal hop is masked, by K3's own rule
    o, lse = fl._flash_fwd_cuda(q, k, v, None, scale, causal and src == idx,
                                out_dtype=torch.float32)
    fl._report(q, k, backward=False)
    return o, lse[..., None]


def _hop_backward(q, k, v, do, out, delta, lse, scale: float, causal: bool, idx: int,
                  src: int):
    if q.device.type == "cpu":
        return block_attention_bwd_reference(q, k, v, do, delta, lse, scale, causal, idx, src)
    from mmlearn_tpu_torch.ops import flash_attention as fl

    grads = fl._flash_bwd_cuda(q, k, v, None, out, lse[..., 0], do, scale,
                               causal and src == idx)
    fl._report(q, k, backward=True)
    return grads


# ------------------------------------------------------------------ the ring


def _merge(out_run, lse_run, o_i, lse_i):
    """Fold one block-normalized ``(o_i, lse_i)`` into the running pair, in
    f32; where both log-sum-exps are ``NEG``-like (no key seen yet) the row
    keeps ``NEG`` and takes nothing."""
    hi = torch.maximum(lse_run, lse_i)
    dead = hi <= NEG / 2
    lse_new = torch.where(dead, NEG, hi + torch.log1p(torch.exp(-(lse_run - lse_i).abs())))
    c_run = torch.where(dead, 0.0, torch.exp(lse_run - lse_new))
    c_i = torch.where(dead, 0.0, torch.exp(lse_i - lse_new))
    return out_run * c_run + o_i * c_i, lse_new


def _ring_forward(ex, qs, ks, vs, scale: float, causal: bool):
    """The forward loop over the blocks of ``ex.ranks``: each rank's output
    in q's type and its f32 log-sum-exp ``(B, H, n, 1)``."""
    size = ex.size
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lse = [torch.full((*q.shape[:3], 1), NEG, dtype=torch.float32, device=q.device)
           for q in qs]
    k_blk, v_blk = list(ks), list(vs)
    for step in range(size):
        pending = ex.start((k_blk, v_blk)) if step < size - 1 else None
        for j, idx in enumerate(ex.ranks):
            src = (idx - step) % size
            if causal and src > idx:  # wholly in the future: nothing to add
                ex.hops["skipped"] += 1
                continue
            o_i, lse_i = _hop_forward(qs[j], k_blk[j], v_blk[j], scale, causal, idx, src)
            acc[j], lse[j] = _merge(acc[j], lse[j], o_i, lse_i)
            ex.hops["forward"] += 1
        if pending is not None:
            k_blk, v_blk = ex.wait(pending)
    return [a.to(q.dtype) for a, q in zip(acc, qs)], lse


def _ring_backward(ex, qs, ks, vs, outs, lses, douts, scale: float, causal: bool):
    """The backward loop: ``(dq, dk, dv)`` of each rank of ``ex.ranks``, each
    summed in f32 over the hops in ring order, in its input's type."""
    size = ex.size
    dos = [d.float() for d in douts]
    deltas = [(d * o.float()).sum(-1, keepdim=True) for d, o in zip(dos, outs)]
    # the CUDA hop reads the cotangent in the input type, as the JAX flash hop
    dos_in = [d.to(q.dtype) for d, q in zip(douts, qs)]
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    k_blk, v_blk = list(ks), list(vs)
    dk_blk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dv_blk = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    for step in range(size):
        pending = ex.start((k_blk, v_blk))
        for j, idx in enumerate(ex.ranks):
            src = (idx - step) % size
            if causal and src > idx:
                ex.hops["skipped"] += 1
                continue
            cpu = qs[j].device.type == "cpu"
            dq_i, dk_i, dv_i = _hop_backward(qs[j], k_blk[j], v_blk[j],
                                             dos[j] if cpu else dos_in[j], outs[j], deltas[j],
                                             lses[j], scale, causal, idx, src)
            dq[j] += dq_i.float()
            dk_blk[j] += dk_i.float()
            dv_blk[j] += dv_i.float()
            ex.hops["backward"] += 1
        # the gradients travel with their block: after ``size`` moves both are
        # back at the owner
        pending_grads = ex.start((dk_blk, dv_blk))
        k_blk, v_blk = ex.wait(pending)
        dk_blk, dv_blk = ex.wait(pending_grads)
    return ([g.to(q.dtype) for g, q in zip(dq, qs)], [g.to(k.dtype) for g, k in zip(dk_blk, ks)],
            [g.to(v.dtype) for g, v in zip(dv_blk, vs)])


class _RingFunction(torch.autograd.Function):
    """The ``custom_vjp`` of the JAX ``ring_attention``, over the blocks of
    the ranks an exchange computes for (``q``s, then ``k``s, then ``v``s)."""

    @staticmethod
    def forward(ctx, ex, scale: float, causal: bool, *blocks):
        r = len(ex.ranks)
        qs, ks, vs = blocks[:r], blocks[r:2 * r], blocks[2 * r:]
        outs, lses = _ring_forward(ex, qs, ks, vs, scale, causal)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.ex, ctx.config = ex, (scale, causal)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        r = len(ctx.ex.ranks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * r:(i + 1) * r] for i in range(5))
        douts = [torch.zeros_like(o) if d is None else d for d, o in zip(douts, outs)]
        dq, dk, dv = _ring_backward(ctx.ex, qs, ks, vs, outs, lses, douts, *ctx.config)
        return (None, None, None, *dq, *dk, *dv)


def _check(qs, ks, vs) -> None:
    shapes = {tuple(t.shape) for t in (*qs, *ks, *vs)}
    if len(shapes) != 1 or len(next(iter(shapes))) != 4:
        raise ValueError(f"ring attention takes (B, H, n, D) blocks of one shape, got {shapes}")
    if qs[0].device.type == "cuda":
        from mmlearn_tpu_torch.ops import flash_attention as fl

        fl._check_cuda(qs[0], ks[0], vs[0], None)  # raises on a head dim K3 does not take
    elif qs[0].device.type != "cpu":
        raise ValueError(f"ring attention runs on cpu or cuda tensors, got {qs[0].device}")


def ring_attention_blocks(qs, ks, vs, scale: float, causal: bool, ex) -> list:
    """:func:`ring_attention` over the blocks of every rank in ``ex.ranks``
    (lists in that order): the outputs, a list in the same order."""
    qs, ks, vs = ([t.contiguous() for t in blocks] for blocks in (qs, ks, vs))
    _check(qs, ks, vs)
    return list(_RingFunction.apply(ex, float(scale), bool(causal), *qs, *ks, *vs))


def ring_attention(q, k, v, scale: float, causal: bool, group) -> torch.Tensor:
    """Collective attention over a ``seq`` group, per-rank form: ``q``,
    ``k``, ``v`` are this rank's ``(B, H, n, D)`` blocks of the sequence;
    ``group`` a process group (or an exchange of one rank). ``causal`` masks
    over global positions. Returns this rank's output block."""
    ex = group if hasattr(group, "start") else GroupExchange(group)
    if len(ex.ranks) != 1:
        raise ValueError("ring_attention takes one rank's blocks; see ring_attention_blocks")
    return ring_attention_blocks([q], [k], [v], scale, causal, ex)[0]


def sequence_sharded_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    exchange,
    *,
    scale: Optional[float] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Ring attention on the global ``(B, H, N, D)`` arrays of a ``seq``
    group (``exchange``: a :class:`GroupExchange` or a
    :class:`ListExchange`): each rank's block of the sequence through the
    ring, the group's output blocks gathered; global in, global out."""
    n = q.shape[2]
    if n % exchange.size:
        raise ValueError(f"seq len {n} not divisible by ring size {exchange.size}")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    outs = ring_attention_blocks(exchange.scatter(q), exchange.scatter(k), exchange.scatter(v),
                                 scale, causal, exchange)
    return exchange.gather(outs)
