"""Mixture-of-Experts — sort-based capacity dispatch (torch port of
``repro/models/moe.py``; Switch/Mixtral style).

The dispatch is *token-local*: it routes whatever token set it is given into
an (E, C, d) capacity buffer via a stable sort, runs the expert FFNs as
batched matrix products and gathers the results back, each token's k
contributions summed left to right in ``x``'s dtype (the order of the JAX
code's scatter-add). Nothing adds through atomics, so a bf16 result is the
same from run to run. Tokens over capacity are dropped (standard
capacity-factor routing, reproduced token for token: at decode, T = batch,
the capacity is often 1); the router aux loss (load-balancing, Switch eq.
4) is returned for the train loss.

Under a mesh the block calls ``moe_ffn`` on each rank's own tokens
(``blocks._moe_local``, the reference's ``shard_map`` over the token axes)
and, where expert weights shard their hidden dim over a mesh dimension,
``psum_axis`` names it: w_down's partial outputs are summed over that
dimension's process group, the dense TP FFN's collective.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed.nn.functional as dist_fn

from ..sharding.ctx import current_mesh


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (weights (T,k), experts (T,k) int64, aux_loss scalar)."""
    logits = torch.matmul(x.float(), w_router.float())
    probs = torch.softmax(logits, dim=-1)
    # ``jax.lax.top_k``'s order: descending, ties to the lower index
    gate, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, experts = gate[:, :top_k], experts[:, :top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch load-balance aux: E * sum_e f_e * p_e
    E = w_router.shape[-1]
    me = probs.mean(dim=0)                                   # (E,)
    ce = torch.bincount(experts.reshape(-1), minlength=E).float()
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    aux = E * torch.sum(me * ce)
    return gate, experts, aux


def dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based capacity assignment.

    experts: (T, k) int -> returns (slot (T*k,), keep (T*k,), token (T*k,))
    where slot = expert * capacity + position-within-expert for kept entries.
    """
    T, k = experts.shape
    flat = experts.reshape(-1)                               # (T*k,)
    order = torch.argsort(flat, stable=True)                 # group by expert
    sorted_e = flat[order]
    # position within expert = index - start offset of that expert
    pos_in_sorted = torch.arange(T * k, device=flat.device)
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat.device,
                               dtype=sorted_e.dtype))
    pos_in_expert = pos_in_sorted - starts[sorted_e]
    keep_sorted = pos_in_expert < capacity
    slot_sorted = sorted_e * capacity + torch.clamp(pos_in_expert,
                                                    max=capacity - 1)
    inv = torch.argsort(order, stable=True)                  # undo sort
    return slot_sorted[inv], keep_sorted[inv], pos_in_sorted // k


def _act(g: torch.Tensor, u: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return torch.nn.functional.silu(g) * u
    return torch.nn.functional.gelu(g, approximate="tanh") * u


def moe_ffn(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, act: str = "swiglu",
            psum_axis: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d); expert weights: (E, d, f) / (E, f, d).

    Returns (out (T, d), aux_loss). If ``psum_axis`` is given the caller
    runs on local shards (inside ``sharding.local_call``, in an
    ``activation_ctx`` with a mesh) and w_down's output is summed over that
    mesh dimension (differentiably: the sum's backward sums the grads)."""
    T, d = x.shape
    E = w_router.shape[-1]
    capacity = max(1, int(T * top_k * capacity_factor / E))

    gate, experts, aux = route(x, w_router, top_k)
    slot, keep, token = dispatch_indices(experts, E, capacity)

    # fill the capacity buffer; dropped entries go to a spare last row that
    # is cut off, so they write nothing (kept slots are unique)
    dest = torch.where(keep, slot, E * capacity)
    buf = x.new_zeros((E * capacity + 1, d)).index_put((dest,), x[token])
    buf = buf[:-1].reshape(E, capacity, d)

    g = torch.bmm(buf, w_gate.to(x.dtype))
    u = torch.bmm(buf, w_up.to(x.dtype))
    y = torch.bmm(_act(g, u, act), w_down.to(x.dtype))
    if psum_axis is not None:
        y = psum(y, psum_axis)
    y = y.reshape(E * capacity, d)

    # gather back with routing weights
    safe_slot = torch.where(keep, slot, E * capacity - 1)
    picked = torch.where(keep[:, None], y[safe_slot], 0)
    weighted = picked * torch.where(keep, gate.reshape(-1), 0)[:, None] \
        .to(x.dtype)
    return sum_contributions(weighted.reshape(T, top_k, d)), aux


def psum(x: torch.Tensor, axis: str, mesh=None) -> torch.Tensor:
    """``jax.lax.psum`` over one mesh dimension of local tensors."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"psum over {axis!r} needs a mesh: call it inside "
                         "activation_ctx(rules, mesh)")
    return dist_fn.all_reduce(x, group=mesh.get_group(axis))


def sum_contributions(weighted: torch.Tensor) -> torch.Tensor:
    """(T, k, d) -> (T, d): each token's k contributions added left to
    right in their dtype, the order in which the JAX code's
    ``zeros.at[token].add(weighted)`` adds them."""
    out = weighted[:, 0]
    for j in range(1, weighted.shape[1]):
        out = out + weighted[:, j]
    return out


def moe_ffn_reference(x, w_router, w_gate, w_up, w_down, *, top_k,
                      act="swiglu"):
    """Dense oracle: every token through its top-k experts, no capacity
    drops. Tests compare moe_ffn against this with capacity_factor large
    enough that nothing drops."""
    gate, experts, aux = route(x, w_router, top_k)
    T, d = x.shape
    E = w_router.shape[-1]
    out = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for e in range(E):
        g = torch.matmul(x, w_gate[e].to(x.dtype))
        u = torch.matmul(x, w_up[e].to(x.dtype))
        y = torch.matmul(_act(g, u, act), w_down[e].to(x.dtype))
        w_e = torch.sum(torch.where(experts == e, gate, 0.0), dim=-1)
        out = out + y.float() * w_e[:, None]
    return out.to(x.dtype), aux
