"""Attention — memory-bounded plain torch implementations (port of
``repro/models/attention.py``, where the JAX model runs them in pure jnp),
and the dispatcher that sends an inference call on the card to the
hand-written flash kernel (``kernels/flash_attention``) instead.

* ``attention`` — the model blocks' self-attention: the flash kernel for
  a call that ``uses_kernel`` (no autograd, plain tensors: no mesh and no
  fake tensors, f32 scores, a CUDA device, dtypes and head dims the
  kernel takes), else one of the next two.
* ``attention_blockwise`` — a loop over KV blocks with online softmax.
* ``attention_banded`` — sliding-window attention: a loop over query
  blocks, each attending to a fixed-size (window + q_block) KV slice.
* ``attention_decode`` — single-query attention over a cache (optionally a
  ring buffer for SWA). On a mesh whose cache length is sharded, each rank
  attends its own cache block (``decode_partials``) and the blocks are
  combined across ranks (``combine_partials``, flash-decoding's combine).
* ``attention_reference`` — the naive O(S²)-memory oracle the tests hold
  the others against.

All operate on (B, S, H, D) layouts with GQA grouping handled by reshaping
q to (B, KVH, G, S, D). Score and value products take their inputs'
values exactly and accumulate in f32, as the JAX code's
``preferred_element_type=float32`` asks. Under autograd each KV block
(blockwise) or query block (banded) is recomputed in backward, as the JAX
code's ``@jax.checkpoint`` scan bodies are, so a layer's backward never
holds every block's scores.

On DTensors (a mesh) self-attention keeps q's sequence shard: each rank
computes its own query rows against K and V gathered along the sequence,
its masks at the rows' global offset (``_on_query_blocks``), as the
reference's partitioner keeps ``act_q`` sequence-sharded and gathers only
``act_kv``.
"""
from __future__ import annotations

from typing import Optional

import functools

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..kernels.flash_attention import ops as flash_ops
from ..sharding.ctx import constrain, local_block, local_call, settle
from .layers import as_torch_dtype, recomputed, rounded

NEG_INF = -1e30
_KERNEL_DEVICE = "cuda"      # the device type the flash kernel runs on


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else torch.repeat_interleave(k, n_rep, dim=2)


def _split_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, Hq, D) -> (B, KVH, G, S, D)"""
    B, S, Hq, D = q.shape
    G = Hq // n_kv
    return q.reshape(B, S, n_kv, G, D).permute(0, 2, 3, 1, 4)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, KVH, G, S, D) -> (B, S, Hq, D)"""
    B, KVH, G, S, D = x.shape
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, KVH * G, D)


def _scores(qh: torch.Tensor, kb: torch.Tensor) -> torch.Tensor:
    """einsum("bhgqd,bhkd->bhgqk") in f32."""
    return torch.matmul(qh.float(), kb.float()[:, :, None].transpose(-1, -2))


def _values(p: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """einsum("bhgqk,bhkd->bhgqd") in f32."""
    return torch.matmul(p.float(), vb.float()[:, :, None])


def _scale(q: torch.Tensor, scale: Optional[float]) -> torch.Tensor:
    """q * scale in q's dtype (the JAX code scales before the product)."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return q * rounded(s, q.dtype)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None,
                        kv_block: int = 512,
                        scale: Optional[float] = None,
                        score_dtype=torch.float32,
                        _q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, Dk); k: (B, S, KVH, Dk); v: (B, S, KVH, Dv). Sq is S
    except on a mesh, where q is a rank's block of queries starting at
    global position ``_q_offset`` (``_on_query_blocks``)."""
    B, Sq, Hq, Dk = q.shape
    S = k.shape[1]
    KVH = k.shape[2]
    Dv = v.shape[3]
    score_dtype = as_torch_dtype(score_dtype)
    kv_block = min(kv_block, S)
    while S % kv_block:
        kv_block //= 2
    nb = S // kv_block

    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,S,Dk)
    kh = k.permute(0, 2, 1, 3)                             # (B,KVH,S,Dk)
    vh = v.permute(0, 2, 1, 3)                             # (B,KVH,S,Dv)
    q_pos = _q_offset + torch.arange(Sq, device=q.device)
    G = Hq // KVH

    def body(m, l, acc, qh, kb, vb, j):
        s = _scores(qh, kb).to(score_dtype)
        kv_pos = j * kv_block + torch.arange(kv_block, device=q.device)
        mask = torch.ones((Sq, kv_block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= kv_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - kv_pos[None, :] < window
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        p = torch.exp(s - m_new[..., None].to(score_dtype))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.float().sum(dim=-1)
        acc = acc * alpha[..., None] + _values(p.to(vb.dtype), vb)
        return m_new, l, acc

    m = torch.full((B, KVH, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KVH, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, G, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for j in range(nb):
        blk = slice(j * kv_block, (j + 1) * kv_block)
        # backward recomputes the block's scores (flash-style)
        m, l, acc = recomputed(body, m, l, acc, qh, kh[:, :, blk],
                               vh[:, :, blk], j)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return _merge_heads(out).to(q.dtype)


def attention_banded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int, q_block: int = 512,
                     scale: Optional[float] = None,
                     score_dtype=torch.float32,
                     _q_offset: int = 0) -> torch.Tensor:
    """Sliding-window causal attention, O(S·window): each query block
    attends to the KV slice [start, start + window + q_block), start =
    max(0, block_end - span), and masking fixes up the overlap. q may be
    a block of Sq queries at global offset ``_q_offset``, as in
    ``attention_blockwise``."""
    B, Sq, Hq, Dk = q.shape
    S = k.shape[1]
    KVH = k.shape[2]
    Dv = v.shape[3]
    score_dtype = as_torch_dtype(score_dtype)
    q_block = min(q_block, Sq)
    while Sq % q_block:
        q_block //= 2
    nqb = Sq // q_block
    span = min(S, window + q_block)

    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,S,D)
    kh = k.permute(0, 2, 1, 3)
    vh = v.permute(0, 2, 1, 3)
    G = Hq // KVH

    def body(qb, kb, vb, q0, start):
        s = _scores(qb, kb).to(score_dtype)
        q_pos = q0 + torch.arange(q_block, device=q.device)
        kv_pos = start + torch.arange(span, device=q.device)
        mask = (q_pos[:, None] >= kv_pos[None, :]) & \
               (q_pos[:, None] - kv_pos[None, :] < window)
        s = s.masked_fill(~mask, NEG_INF)
        mx = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - mx)
        l = p.float().sum(dim=-1, keepdim=True)
        return _values((p.float() / torch.clamp(l, min=1e-30))
                       .to(vb.dtype), vb)

    outs = []
    for i in range(nqb):
        rows = slice(i * q_block, (i + 1) * q_block)
        q0 = _q_offset + rows.start
        start = max(q0 + q_block - span, 0)
        # backward recomputes the banded scores of each query block
        outs.append(recomputed(body, qh[:, :, :, rows],
                               kh[:, :, start:start + span],
                               vh[:, :, start:start + span], q0, start))
    out = torch.cat(outs, dim=3).reshape(B, KVH, G, Sq, Dv)
    return _merge_heads(out).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_positions: torch.Tensor,
                     pos: int, *, window: Optional[int] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention.

    q: (B, 1, Hq, Dk); caches: (B, C, KVH, D); cache_positions: (C,) the
    absolute position stored in each cache slot (ring-aware); pos: the
    current token's position (its K/V must already be in the cache). On
    DTensors (a mesh) each rank attends its own batch rows over its own
    block of the cache length and the blocks are combined across the
    ranks that split the length (``on_cache_blocks``); a cache whose
    length is not split is attended whole on each rank's batch rows.
    """
    if isinstance(q, DTensor):
        if not length_split(k_cache):
            return on_batch_rows(functools.partial(
                attention_decode, cache_positions=cache_positions, pos=pos,
                window=window, scale=scale), q, k_cache, v_cache)

        def partials(qb, kb, vb, cpos):
            return decode_partials(qb, kb, vb, cpos, pos, window=window,
                                   scale=scale)
        return on_cache_blocks(partials, functools.partial(
            finish_decode, dtype=q.dtype), (q,), (k_cache, v_cache),
            cache_positions)
    KVH = k_cache.shape[2]
    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,1,D)
    kh = k_cache.permute(0, 2, 1, 3)                       # (B,KVH,C,D)
    vh = v_cache.permute(0, 2, 1, 3)
    s = _scores(qh, kh)
    s = s.masked_fill(~_valid_slots(cache_positions, pos, window), NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _values(p.to(vh.dtype), vh)
    return _merge_heads(o).to(q.dtype)


def _valid_slots(cache_positions: torch.Tensor, pos: int,
                 window: Optional[int]) -> torch.Tensor:
    """The slots that a query at ``pos`` attends: written, and inside the
    window (global positions)."""
    valid = cache_positions <= pos
    if window is not None:
        valid &= pos - cache_positions < window
    return valid


def block_softmax(s: torch.Tensor, valid: torch.Tensor):
    """One cache block's softmax statistics: s (..., C) f32 scores, valid
    (C,) -> (m (...), p (..., C), l (...)): the row max, the unnormalised
    probabilities exp(s - m) and their sum. A block with no valid slot
    (or no slot: an uneven split's empty tail) gives m = -1e30, p = 0 and
    l = 0, so it adds nothing to the combine."""
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1) if s.shape[-1] else s.new_full(s.shape[:-1], NEG_INF)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    return m, p, p.sum(dim=-1)


def decode_partials(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, cache_positions: torch.Tensor,
                    pos: int, *, window: Optional[int] = None,
                    scale: Optional[float] = None):
    """One cache block's share of ``attention_decode``: the caches hold
    the block's C slots, ``cache_positions`` their (C,) global positions.
    -> (m, l, acc): (B, KVH, G) row max and sum of exponentials and the
    (B, KVH, G, Dv) unnormalised output, all f32. The G grouped heads are
    the rows of one product per KV head (no broadcast copy of the block),
    and p enters the value product in the cache's dtype, as the
    unsplit path casts its probabilities."""
    KVH = k_cache.shape[2]
    qh = _split_heads(_scale(q, scale), KVH)[:, :, :, 0]   # (B,KVH,G,D)
    kh = k_cache.permute(0, 2, 3, 1)                       # (B,KVH,D,C)
    vh = v_cache.permute(0, 2, 1, 3)                       # (B,KVH,C,Dv)
    s = torch.matmul(qh.float(), kh.float())               # (B,KVH,G,C)
    m, p, l = block_softmax(s, _valid_slots(cache_positions, pos, window))
    acc = torch.matmul(p.to(vh.dtype).float(), vh.float())
    return m, l, acc


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     reduce=None) -> torch.Tensor:
    """Flash-decoding's combine of per-block partials (``decode_partials``
    or any block's (m, l, acc) with acc's last dim the output's): the
    max of the blocks' maxima M, each block's l and acc rescaled by
    exp(m_i - M), summed, and acc over l. The blocks are stacked on dim 0;
    or, with ``reduce(t, op)`` ("max" or "sum" across the ranks that each
    hold one block), m, l and acc are this rank's own."""
    if reduce is None:
        def reduce(t, op):
            return t.amax(dim=0) if op == "max" else t.sum(dim=0)
    M = reduce(m, "max")
    w = torch.exp(m - M)
    L = reduce(l * w, "sum")
    A = reduce(acc * w[..., None], "sum")
    return A / torch.clamp(L, min=1e-30)[..., None]


def finish_decode(out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, KVH, G, Dv) combined output -> (B, 1, Hq, Dv) in ``dtype``."""
    return _merge_heads(out[:, :, :, None]).to(dtype)


def length_split(cache: torch.Tensor) -> bool:
    """A DTensor cache whose length (dim 1) is sharded over the mesh."""
    return isinstance(cache, DTensor) and any(
        isinstance(p, Shard) and p.dim == 1 for p in cache.placements)


def on_batch_rows(fn, *tensors):
    """``fn(*tensors)`` on each rank's own batch rows (dim 0), every other
    dim gathered: decode attention over a cache whose length is whole on
    every rank."""
    first = settle(tensors[0])
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in first.placements]
    run = local_call(fn, first.device_mesh, pl, [pl] * len(tensors))
    return run(*(settle(t) for t in tensors))


def on_cache_blocks(partials, finish, qs, caches,
                    cache_positions: torch.Tensor):
    """Split-cache decode on a mesh: ``finish(combine_partials(...))`` of
    ``partials(*qs, *caches, positions) -> (m, l, acc)``, each rank's
    taken on its own batch rows (dim 0) and its own block of the cache
    length (dim 1 of every cache DTensor), at the block's global slot
    positions (sliced at the offset of the rank's local block, read from
    the DTensor's own local shape, so an uneven split is right). The
    combine is reduced across the mesh dims that split the length:
    all-reduces of the statistics and of the partial outputs, the traffic
    of the reference's partitioned softmax, where gathering the cache
    would move all of it. The queries are gathered over every other dim
    (a few KB a layer)."""
    cache0 = settle(caches[0])
    mesh = cache0.device_mesh
    kv_pl = [p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate()
             for p in cache0.placements]
    q_pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in kv_pl]
    split = [i for i, p in enumerate(kv_pl)
             if isinstance(p, Shard) and p.dim == 1]
    start = local_block(cache0.shape, mesh, kv_pl)[1][1]

    def reduce(t, op):
        for dim in split:
            t = funcol.all_reduce(t, op, (mesh, dim))
        return t

    def body(*args):
        n = args[len(qs)].shape[1]              # this rank's block length
        m, l, acc = partials(*args, cache_positions[start:start + n])
        return finish(combine_partials(m, l, acc, reduce))

    run = local_call(body, mesh, q_pl,
                     [q_pl] * len(qs) + [kv_pl] * len(caches))
    return run(*(settle(t) for t in qs), *(settle(t) for t in caches))


def uses_kernel(q, k, v, *, impl="auto", score_dtype=torch.float32) -> bool:
    """Whether ``attention`` sends this call to the flash kernel
    (``flash_ops.flash_attention``). It reads the call alone: ``impl`` is
    "auto" (an explicit "blockwise" or "banded" keeps that version); q, k
    and v are plain tensors on a CUDA device, no subclass (DTensors keep
    ``_on_query_blocks``; a fake tensor, as a trace or the roofline
    counter makes, holds no data to launch on); no autograd records
    through them (the kernel has no backward): grad mode off, or none of
    them requires grad; the scores are f32, as the kernel computes them;
    and the kernel takes their dtypes and head dims (``flash_ops.takes``)."""
    ts = (q, k, v)
    return impl == "auto" \
        and all(type(t) is torch.Tensor for t in ts) \
        and all(t.device.type == _KERNEL_DEVICE for t in ts) \
        and not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in ts)) \
        and as_torch_dtype(score_dtype) == torch.float32 \
        and flash_ops.takes(q, k, v)


def plain_impl(window: Optional[int], seq_len: int) -> str:
    """The plain version "auto" picks at ``seq_len``: banded for a window
    shorter than the sequence, else blockwise."""
    return "banded" if window is not None and window < seq_len \
        else "blockwise"


def attention(q, k, v, *, causal=True, window=None, impl="auto",
              kv_block=512, q_block=512, scale=None,
              score_dtype=torch.float32):
    """Dispatcher used by model blocks (self-attention, S_q == S_kv). q:
    (B, S, Hq, Dk); k: (B, S, KVH, Dk); v: (B, S, KVH, Dv), KVH dividing
    Hq. A call that ``uses_kernel`` (an inference call on the card) runs
    the flash kernel, which groups q's heads over k's and v's own; every
    other call (training through autograd, a mesh, the CPU, bf16 scores,
    an explicit ``impl``, a head pair the kernel lacks) runs a plain
    version, with k and v repeated to q's heads as the mesh's
    ``act_kv_rep`` places them, "auto" choosing the version at the global
    sequence length (``plain_impl``). On DTensors (a mesh) each rank
    computes its own query rows (``_on_query_blocks``)."""
    if uses_kernel(q, k, v, impl=impl, score_dtype=score_dtype):
        return _on_kernel(q, k, v, causal=causal, window=window, scale=scale)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = (constrain(_repeat_kv(t, rep), "act_kv_rep") for t in (k, v))
    if impl == "auto":
        impl = plain_impl(window, q.shape[1])
    if impl == "banded":
        if window is None:
            raise ValueError("banded attention needs a window")
        fn = functools.partial(attention_banded, window=window,
                               q_block=q_block, scale=scale,
                               score_dtype=score_dtype)
    else:
        fn = functools.partial(attention_blockwise, causal=causal,
                               window=window, kv_block=kv_block, scale=scale,
                               score_dtype=score_dtype)
    if isinstance(q, DTensor):
        return _on_query_blocks(fn, q, k, v)
    return fn(q, k, v)


def _on_kernel(q, k, v, *, causal, window, scale):
    """The flash kernel on the blocks' (B, S, H, D) layout: q, k and v in
    as (B, H, S, D), the output back as (B, S, Hq, Dv)."""
    o = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window, scale=scale)
    return o.transpose(1, 2)


def _on_query_blocks(fn, q, k, v):
    """``fn(q, k, v, _q_offset=...)`` on each rank's blocks. q keeps its
    shards of batch (0), sequence (1) and heads (2); k and v keep q's
    batch and head shards and are gathered along the sequence (the
    reference's ``act_kv``). Each rank computes the attention of its own
    query rows against the whole K/V, its masks at the rows' global
    offset (read from q's local shape, so an uneven split is right);
    attention is independent per batch row, head and query, so no other
    collective is needed. The grads of q are its blocks' own; those of k
    and v are partial sums over the mesh dims that shard q's sequence
    (each rank's queries read every key). DTensor's matrix products
    cannot flatten the (batch, heads) dims when both are sharded (torch
    2.11), which is why attention runs on local blocks at all."""
    q = settle(q)
    mesh = q.device_mesh
    q_pl = [p if isinstance(p, Shard) and p.dim in (0, 1, 2) else Replicate()
            for p in q.placements]
    kv_pl = [p if isinstance(p, Shard) and p.dim != 1 else Replicate()
             for p in q_pl]
    kv_grad = [Partial() if isinstance(p, Shard) and p.dim == 1 else r
               for p, r in zip(q_pl, kv_pl)]
    offset = local_block(q.shape, mesh, q_pl)[1][1]
    run = local_call(functools.partial(fn, _q_offset=offset), mesh, q_pl,
                     [q_pl, kv_pl, kv_pl], [q_pl, kv_grad, kv_grad])
    return run(q, settle(k), settle(v))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S²)-memory oracle (tests only, small shapes). q: (B, S, Hq,
    Dk); k: (B, S, KVH, Dk); v: (B, S, KVH, Dv)."""
    S, KVH = q.shape[1], k.shape[2]
    qh = _split_heads(_scale(q, scale), KVH)               # (B,KVH,G,S,Dk)
    s = _scores(qh, k.permute(0, 2, 1, 3))                 # (B,KVH,G,S,S)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window is not None:
        mask &= pos[:, None] - pos[None, :] < window
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    o = _values(p.to(v.dtype), v.permute(0, 2, 1, 3))
    return _merge_heads(o).to(q.dtype)
