"""Mixture-of-Experts FFN with capacity-bounded, sort-based dispatch.

Port of ``repro.models.moe`` (and of the single-device branch of
``repro.models.moe_dist.moe_apply_auto``, which is ``moe_apply``; the
expert-parallel branch across cards is ``models.moe_dist.moe_apply_auto``,
which the forward takes under a mesh).  Tokens are routed
top-k (softmax, then top-k, gates renormalised), cut into dispatch groups
of about ``GROUP_TOKENS`` (``G = max(T // GROUP_TOKENS, 1)``, lowered until
it divides T), and inside each group the (token, choice) entries are
stably sorted by expert: an entry's slot is its rank among its expert's
entries, and an entry whose slot reaches the group's capacity is dropped.
Capacity is ``S * k`` for groups of at most ``DROPLESS_MAX`` entries (they
never drop, so decode-sized groups are exact), else ``ceil(S * k / E *
capacity_factor)``.  That drop set is the semantics, and ``T`` is the
whole flat stream, padding rows included, as in the JAX model.

The JAX package packs a ``[E, cap, d]`` buffer and runs every expert over
it (``_group_dispatch``, kept here as the plain version): at full width
(128 experts of 5120 x 8192) that reads all experts' weights for an 8-token
decode tick.  ``moe_apply`` computes only the (expert, slot) pairs that
hold a kept entry, one ``torch.matmul`` chain per routed expert (empty
slots are never gathered, so the function is the same); with int8 weights
it dequantizes only those experts' slices.  The JAX package computes these
products in XLA, outside any Pallas kernel, so the library matmul is the
port of them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.configs import MoEConfig
from repro_torch.models.quant import dequant_leaf, is_q8

GROUP_TOKENS = 4096      # dispatch group size (capacity is per group)
DROPLESS_MAX = 512       # groups with <= this many routed slots never drop

EXPERT_STACKS = ("w_gate", "w_up", "w_down")


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax-then-top-k routing, gates renormalised."""
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    assign = F.one_hot(idx, n_experts).float()                   # [T, k, E]
    f = assign.sum(dim=(0, 1)) / torch.clamp(assign.sum(), min=1.0)
    p = probs.mean(dim=0)
    return n_experts * torch.sum(f * p)


def groups(T: int, k: int, mcfg: MoEConfig) -> Tuple[int, int, int]:
    """(G groups, S tokens a group, capacity a group and expert)."""
    G = max(T // GROUP_TOKENS, 1)
    while T % G:
        G -= 1
    S = T // G
    if S * k <= DROPLESS_MAX:
        cap = S * k          # worst case: every token on one expert
    else:
        cap = max(int(math.ceil(S * k / mcfg.num_experts
                                * mcfg.capacity_factor)), 1)
    return G, S, cap


def slots(idx: torch.Tensor, G: int, E: int) -> torch.Tensor:
    """Each (token, choice) entry's slot in its expert's queue of its
    group: its rank among the group's entries of that expert in
    token-major order (a stable sort by expert).  idx: [T, k]; returns
    [T * k]."""
    flat_e = idx.reshape(G, -1)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    experts = torch.arange(E, device=idx.device, dtype=sorted_e.dtype)
    seg_start = torch.searchsorted(sorted_e,
                                   experts.expand(G, E).contiguous())
    n = flat_e.shape[1]
    pos_sorted = (torch.arange(n, device=idx.device)[None, :]
                  - seg_start.gather(1, sorted_e))
    return torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted
                                                 ).reshape(-1)


def _route(x: torch.Tensor, params: Dict, mcfg: MoEConfig):
    """(gates [T, k] in x's dtype, idx [T, k], aux loss fp32 scalar)."""
    router = params["router"]
    if is_q8(router):
        router = dequant_leaf(router, x.dtype)
    logits = x @ router.to(x.dtype)                                # [T, E]
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = torch.topk(probs, mcfg.top_k, dim=-1)
    gates = (gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
             ).to(x.dtype)
    aux = load_balance_loss(probs, idx, mcfg.num_experts) \
        * mcfg.router_aux_weight
    return gates, idx, aux.float()


def _expert(w, e: int, dtype: torch.dtype) -> torch.Tensor:
    """Expert ``e``'s matrix of a stack, dequantized alone if int8."""
    if is_q8(w):
        return dequant_leaf({"_q8": w["_q8"][e], "_qs": w["_qs"][e]}, dtype)
    return w[e].to(dtype)


def _expert_ffn(xe: torch.Tensor, params: Dict, e: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Expert ``e``'s SwiGLU over its entries ``xe`` [n, d]."""
    h = F.silu(xe @ _expert(params["w_gate"], e, dtype)) \
        * (xe @ _expert(params["w_up"], e, dtype))
    return h @ _expert(params["w_down"], e, dtype)


def _stack(w, dtype: torch.dtype) -> torch.Tensor:
    return dequant_leaf(w, dtype) if is_q8(w) else w.to(dtype)


def moe_apply(x: torch.Tensor, params: Dict, mcfg: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [T, d] -> (y [T, d], aux_loss fp32 scalar).  params: router [d,
    E]; w_gate/w_up [E, d, f]; w_down [E, f, d] (each may be int8).  Only
    the kept (expert, slot) pairs are computed: one matmul chain per routed
    expert over its kept entries.  Counts on the function: ``calls``,
    ``entries`` (T * k), ``routed`` (experts that received an entry) and
    ``dropped`` (entries over capacity), each summed over calls."""
    T, d = x.shape
    E, k = mcfg.num_experts, mcfg.top_k
    gates, idx, aux = _route(x, params, mcfg)
    G, _, cap = groups(T, k, mcfg)
    kept = slots(idx, G, E) < cap                                 # [T * k]
    flat_e = idx.reshape(-1)
    # kept entries sorted by expert: each expert's entries are one run
    entry = torch.nonzero(kept).reshape(-1)
    by_e, order = torch.sort(flat_e[entry], stable=True)
    entry = entry[order]
    counts = torch.bincount(by_e, minlength=E).tolist()           # one sync
    y_tok = x.new_zeros((T * k, d))
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        rows = entry[start:start + n]
        start += n
        xe = x[rows // k]
        if xe.requires_grad and is_q8(params["w_gate"]):
            # under autograd an int8 expert's matrices are dequantized
            # again in the backward instead of held until it: every routed
            # expert's dequantized copy at once would not fit at full width
            ye = checkpoint(_expert_ffn, xe, params, e, x.dtype,
                            use_reentrant=False)
        else:
            ye = _expert_ffn(xe, params, e, x.dtype)
        y_tok.index_copy_(0, rows, ye)
    moe_apply.calls += 1
    moe_apply.entries += T * k
    moe_apply.routed += sum(1 for n in counts if n)
    moe_apply.dropped += T * k - start
    y = torch.einsum("tkd,tk->td", y_tok.reshape(T, k, d), gates)
    return y, aux


moe_apply.calls = moe_apply.entries = moe_apply.routed = 0
moe_apply.dropped = 0


def _group_dispatch(xg: torch.Tensor, idx: torch.Tensor,
                    gates: torch.Tensor, w: Dict[str, torch.Tensor],
                    cap: int, E: int, k: int) -> torch.Tensor:
    """One group's pack into ``[E, cap, d]``, every expert's einsum over
    the whole buffer, unpack (the JAX package's form).  xg: [S, d];
    idx/gates: [S, k]."""
    S, d = xg.shape
    flat_e = idx.reshape(S * k)
    tok_of = torch.arange(S * k, device=xg.device) // k
    pos = slots(idx, 1, E)
    kept = pos < cap
    buf = xg.new_zeros((E, cap, d))
    buf.index_put_((flat_e[kept], pos[kept]), xg[tok_of[kept]],
                   accumulate=True)
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", buf, w["w_up"])
    out = torch.einsum("ecf,efd->ecd", h, w["w_down"])
    y_tok = out[flat_e, torch.clamp(pos, max=cap - 1)]
    y_tok = torch.where(kept[:, None], y_tok, torch.zeros_like(y_tok))
    return torch.einsum("tkd,tk->td", y_tok.reshape(S, k, d), gates)


def moe_apply_einsum(x: torch.Tensor, params: Dict, mcfg: MoEConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``moe_apply``: the JAX package's buffer-and-
    einsum dispatch, group by group (every expert computed over its whole
    capacity)."""
    T, d = x.shape
    E, k = mcfg.num_experts, mcfg.top_k
    gates, idx, aux = _route(x, params, mcfg)
    G, S, cap = groups(T, k, mcfg)
    w = {n: _stack(params[n], x.dtype) for n in EXPERT_STACKS}
    y = torch.cat([_group_dispatch(x[g * S:(g + 1) * S],
                                   idx[g * S:(g + 1) * S],
                                   gates[g * S:(g + 1) * S], w, cap, E, k)
                   for g in range(G)])
    return y, aux


def moe_apply_dense_ref(x: torch.Tensor, params: Dict, mcfg: MoEConfig
                        ) -> torch.Tensor:
    """Capacity-free oracle: every expert computed for every token,
    combined with the routing gates."""
    T, d = x.shape
    E, k = mcfg.num_experts, mcfg.top_k
    w = {n: _stack(params[n], x.dtype) for n in EXPERT_STACKS}
    router = params["router"]
    router = dequant_leaf(router, x.dtype) if is_q8(router) else router
    gates, idx = router_topk(x @ router.to(x.dtype), k)
    h = F.silu(torch.einsum("td,edf->tef", x, w["w_gate"])) \
        * torch.einsum("td,edf->tef", x, w["w_up"])
    out = torch.einsum("tef,efd->ted", h, w["w_down"])
    comb = x.new_zeros((T, E))
    comb[torch.arange(T, device=x.device)[:, None], idx] = gates.to(x.dtype)
    return torch.einsum("ted,te->td", out, comb)
