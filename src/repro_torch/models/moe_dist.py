"""Explicit expert-parallel MoE (token shards, all-to-all over "model").

Port of ``repro.models.moe_dist``.  GSPMD cannot partition the sort-based
dispatch scatter, so the JAX package writes the distributed path as
explicit SPMD with ``shard_map``; the port has no GSPMD at all and runs the
same schedule over ``torch.distributed``: every rank routes and packs ITS
OWN tokens into a local ``[E, cap, d]`` buffer, one all-to-all over the
"model" axis re-shards the buffers from token-major to expert-major, each
rank runs its ``E/m`` experts, and a reverse all-to-all brings the results
home.  Collective volume per rank is 2 x k x cap_factor x T_rank x d
elements.

The stream a rank is given (``x``: its data group's tokens, whole on every
"model" rank) is cut over "model" into contiguous blocks, so over the mesh
the tokens are split over ``(*batch_axes, "model")``, data-major, as the
JAX ``tok_spec`` splits them.  Capacity is per rank, ``cap = ceil((T_rank)
* k / E * capacity_factor)``, with JAX's drop rule: each (token, choice)
entry's slot is its rank among the rank's entries of that expert
(stable sort), and an entry whose slot reaches ``cap`` is dropped.  That is
not ``models.moe``'s ``GROUP_TOKENS`` / ``DROPLESS_MAX`` grouping, which
the single-device path keeps.  The expert FFN computes only the slots that
hold a kept entry (empty slots are zeros and give zeros, as
``moe.moe_apply`` skips them).

Int8 leaves (``models.quant``) cross the wire as their int8 payload and
scales (``_gather``) and dequantize after: the router whole, an expert
stack one local expert at a time.

Without a mesh, or with one whose "model" and batch axes are all 1, it is
``moe.moe_apply``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import all_gather, all_reduce, \
    all_to_all, ambient_mesh
from repro_torch.launch.mesh import axis_size, batch_axes
from repro_torch.models.configs import MoEConfig
from repro_torch.models.moe import _expert, moe_apply
from repro_torch.models.quant import dequant_leaf, is_q8


def _spread(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def _aux(probs: torch.Tensor, idx: torch.Tensor, own: torch.Tensor,
         mcfg: MoEConfig, axes, mesh) -> torch.Tensor:
    """The load-balance loss (``moe.load_balance_loss``) of the whole
    stream from this rank's routed tokens: its statistics (router
    probabilities and choices summed over the tokens this rank ``own``s,
    and their count) are summed over ``axes`` first."""
    E, k = mcfg.num_experts, mcfg.top_k
    w = own.float()[:, None]
    stats = torch.cat([(probs.float() * w).sum(0),
                       (F.one_hot(idx, E).float() * w[:, :, None]).sum((0, 1)),
                       w.sum(0)])
    stats = all_reduce(stats, axes, mesh)
    p_sum, counts, n = stats[:E], stats[E:2 * E], stats[2 * E]
    f = counts / torch.clamp(n * k, min=1.0)
    p = p_sum / torch.clamp(n, min=1.0)
    return (E * torch.sum(f * p)) * mcfg.router_aux_weight


def _gather(w, axes, mesh, dim: int):
    """``all_gather`` of a weight leaf along ``dim``; an int8 leaf's
    payload, and its scales unless ``dim`` is their reduced axis (-2, of
    size 1)."""
    if not is_q8(w):
        return all_gather(w, axes, mesh, dim=dim)
    q = w["_q8"]
    d = dim % q.ndim
    return {"_q8": all_gather(q, axes, mesh, dim=d),
            "_qs": (w["_qs"] if d == q.ndim - 2
                    else all_gather(w["_qs"], axes, mesh, dim=d))}


def _route(x: torch.Tensor, router: torch.Tensor, k: int):
    probs = torch.softmax((x @ router.to(x.dtype)).float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = (gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
             ).to(x.dtype)
    return probs, gates, idx


def moe_apply_auto(x: torch.Tensor, params: Dict, mcfg: MoEConfig,
                   fsdp: bool = True, *, own: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d], this rank's stream, whole over "model".  params: this
    rank's shards as ``param_shardings`` cuts them: ``router`` [d or d/D,
    E/m], ``w_gate`` / ``w_up`` [E/m, d or d/D, f], ``w_down`` [E/m, f, d
    or d/D] (the "embed" axis over "data" when ``fsdp``).  ``own`` [T] bool:
    the tokens whose router statistics this rank's data group counts (a
    bucket whole on every data rank is counted by data rank 0 alone);
    default all.  Returns (y [T, d] whole over "model", the aux loss of the
    whole stream, fp32 scalar, the same on every rank)."""
    mesh = ambient_mesh()
    if not _spread(mesh):
        return moe_apply(x, params, mcfg)
    bx = batch_axes(mesh)
    m, mi = mesh.shape["model"], mesh.coords["model"]
    E, k = mcfg.num_experts, mcfg.top_k
    T, d = x.shape
    own = torch.ones(T, dtype=torch.bool, device=x.device) if own is None \
        else own
    dsize = axis_size(mesh, "data")
    w_embed_data = fsdp and d % dsize == 0 and dsize > 1
    router = params["router"]
    if w_embed_data:
        router = _gather(router, "data", mesh, 0)
    if (router["_q8"] if is_q8(router) else router).shape[1] != E:
        router = _gather(router, "model", mesh, 1)
    if is_q8(router):
        router = dequant_leaf(router, x.dtype)
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    # un-FSDP the weight blocks (the manual analogue of GSPMD's per-layer
    # FSDP all-gather)
    if w_embed_data:
        wg = _gather(wg, "data", mesh, 1)
        wu = _gather(wu, "data", mesh, 1)
        wd = _gather(wd, "data", mesh, 2)
    if E % m != 0 or T % m != 0:
        # JAX's own ``moe_apply`` branch when the experts or the stream do
        # not divide (``moe_dist.py:54-55``): that is the JAX semantics,
        # every rank computes its whole stream with every expert
        if (wg["_q8"] if is_q8(wg) else wg).shape[0] != E:
            wg, wu, wd = (_gather(w, "model", mesh, 0) for w in (wg, wu, wd))
        full = dict(params, router=router, w_gate=wg, w_up=wu, w_down=wd)
        y, _ = moe_apply(x, full, mcfg)
        probs, _, idx = _route(x, router, k)
        moe_apply_auto.branch = "moe_apply"
        return y, _aux(probs, idx, own, mcfg, bx, mesh)

    Tl = T // m
    xb = x[mi * Tl:(mi + 1) * Tl]
    probs, gates, idx = _route(xb, router, k)
    aux = _aux(probs, idx, own[mi * Tl:(mi + 1) * Tl], mcfg,
               (*bx, "model"), mesh)
    cap = max(int(math.ceil(Tl * k / E * mcfg.capacity_factor)), 1)
    flat_e = idx.reshape(Tl * k)
    tok_of = torch.arange(Tl * k, device=x.device) // k
    sorted_e, order = torch.sort(flat_e, stable=True)
    seg = torch.searchsorted(sorted_e, torch.arange(E, device=x.device,
                                                    dtype=sorted_e.dtype))
    pos_sorted = torch.arange(Tl * k, device=x.device) - seg[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    kept = pos < cap
    buf = x.new_zeros((E, cap, d))
    buf.index_put_((flat_e[kept], pos[kept]), xb[tok_of[kept]],
                   accumulate=True)
    # each expert's kept count, sent with the buffers: the receiving rank
    # computes only the filled slots
    counts = torch.bincount(flat_e[kept], minlength=E).to(torch.int64)
    # token-major -> expert-major: [E, cap, d] -> [E/m, m * cap, d]
    el = E // m
    got = all_to_all(buf, "model", mesh).reshape(m, el, cap, d)
    got_n = all_to_all(counts, "model", mesh).reshape(m, el).tolist()
    out = torch.zeros_like(got)
    for e in range(el):
        rows = [(j, got_n[j][e]) for j in range(m) if got_n[j][e]]
        if not rows:
            continue
        xe = torch.cat([got[j, e, :n] for j, n in rows])
        h = F.silu(xe @ _expert(wg, e, x.dtype)) \
            * (xe @ _expert(wu, e, x.dtype))
        ye = h @ _expert(wd, e, x.dtype)
        start = 0
        for j, n in rows:
            out[j, e, :n] = ye[start:start + n]
            start += n
    # expert-major -> token-major: back to [E, cap, d] on the sender
    back = all_to_all(out, "model", mesh).reshape(E, cap, d)
    y_tok = back[flat_e, torch.clamp(pos, max=cap - 1)]
    y_tok = torch.where(kept[:, None], y_tok, torch.zeros_like(y_tok))
    yb = torch.einsum("tkd,tk->td", y_tok.reshape(Tl, k, d), gates)
    moe_apply_auto.branch = "expert_parallel"
    moe_apply_auto.kept = kept
    # restore the stream whole over "model"
    return all_gather(yb, "model", mesh, dim=0), aux


# the branch of the last call, and its expert-parallel kept entries
# ([T_rank * k] bool, this rank's), for tests and the smoke
moe_apply_auto.branch = None
moe_apply_auto.kept = None
