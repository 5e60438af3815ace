"""AdamW with per-adapter-slot masking, over the port's per-layer bank.

Port of ``repro.training.optimizer``.  Every bank leaf has its adapter axis
at ``-3`` (``[n_slots, d_in, r]`` / ``[n_slots, r, d_out]``).  ``slot_mask``
gates both the moment update and the parameter step, so concurrent trainers
touch only their own slot.  The global-norm clip takes the norm over every
slot's gradient, as the JAX package does, so trainers whose gradients are
accumulated together share one clip.  The step is plain PyTorch under
``torch.no_grad()`` (never ``inference_mode``: the bank it returns is read
by the next grad step); the JAX package has no kernel here either, XLA
fuses the step.  Eager PyTorch would launch some 35 kernels a leaf (448
leaves in a full-width llama3 bank), so the step runs on the leaves
concatenated into one flat buffer each (params, grads, moments), with the
per-element slot mask and step count expanded from the leaves' slot
segments, and returns its tensors as views of the new flat buffers.
Functional like the JAX step: it returns new tensors.  Moments are fp32; a
bf16 bank is stepped in fp32 and cast back, with no fp32 master copy (the
JAX package keeps none).  The clip's norm is one fp32 sum over the flat
gradient, where the JAX package adds per-leaf sums: the same value up to
fp32 rounding.  The update itself runs over the flat buffers in chunks of
``CHUNK`` elements, each element's arithmetic as one whole-buffer pass
would do it, so its temporaries are a chunk's, not a buffer's
(qwen1.5-110b's bank is 143 M elements a card on four, 0.57 GB per fp32
temporary).  Under a mesh (the sharded train step) every tensor is a
rank's shard, the moments cut as ``distributed.sharding.opt_shardings``
says, and only the clip's norm needs the other ranks (``clip_sumsq``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 2e-5                 # the paper's fine-tuning LR
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0           # global-norm clip (0 = off)


class AdamWState(NamedTuple):
    m: Any
    v: Any
    t: torch.Tensor                  # [n_slots] int32 per-slot step counters


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nest of dicts and lists, in order (dict keys in their
    insertion order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def adamw_init(params, n_slots: int) -> AdamWState:
    with torch.no_grad():
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return AdamWState(m=tree_map(z, params), v=tree_map(z, params),
                          t=torch.zeros((n_slots,), dtype=torch.int32,
                                        device=dev))


CHUNK = 1 << 24          # elements a pass of the update (64 MB in fp32)


def _chunks(n: int):
    return (slice(i, min(i + CHUNK, n)) for i in range(0, n, CHUNK))


def _mask_like(leaf: torch.Tensor, slot_mask: torch.Tensor) -> torch.Tensor:
    """Broadcast [n_slots] over the adapter axis at -3."""
    shape = [1] * leaf.ndim
    shape[-3] = slot_mask.shape[0]
    return slot_mask.reshape(shape).float()


def _flat(leaves: List[torch.Tensor]) -> torch.Tensor:
    """The leaves, concatenated into one flat buffer (one dtype)."""
    return torch.cat([x.reshape(-1) for x in leaves])


def _unflat(flat: torch.Tensor, tree):
    """A tree shaped like ``tree`` of views of ``flat``."""
    leaves = tree_leaves(tree)
    parts = iter(p.view(x.shape) for p, x in zip(
        torch.split(flat, [x.numel() for x in leaves]), leaves))

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(parts)

    return build(tree)


def _per_element(values: torch.Tensor, leaves: List[torch.Tensor]
                 ) -> torch.Tensor:
    """[n_slots] per-slot values expanded over the flat buffer of
    ``leaves``: a leaf ``[..., n_slots, a, b]`` is, flattened, runs of
    ``a * b`` elements of slot 0, 1, ..., repeated over its leading axes."""
    slots, lens = [], []
    for x in leaves:
        n, run = x.shape[-3], x.shape[-2] * x.shape[-1]
        reps = x.numel() // (n * run)
        slots += list(range(n)) * reps
        lens += [run] * (n * reps)
    dev = values.device
    return torch.repeat_interleave(
        values[torch.tensor(slots, device=dev)],
        torch.tensor(lens, device=dev), output_size=sum(lens))


def clip_sumsq(g: torch.Tensor, leaves: List[torch.Tensor], cut, mesh
               ) -> torch.Tensor:
    """The clip's sum of squares of the whole gradient from this rank's
    flat fp32 ``g`` over its shards ``leaves``: the leaves cut over "model"
    (``cut``, per leaf) add their shards' sums over "model"; a leaf whole
    on every rank counts once.  The bank is replicated over the data axes,
    so they add nothing."""
    from repro_torch.distributed.sharding import all_reduce
    dev = g.device
    on = torch.repeat_interleave(
        torch.tensor(cut, dtype=torch.bool, device=dev),
        torch.tensor([x.numel() for x in leaves], device=dev),
        output_size=g.numel())
    zero = torch.zeros((), device=dev)
    sums = torch.zeros(2, device=dev)       # cut leaves, whole leaves
    for c in _chunks(g.numel()):
        sq = g[c].square()
        sums[0] += torch.where(on[c], sq, zero).sum()
        sums[1] += torch.where(on[c], zero, sq).sum()
    return all_reduce(sums[:1], "model", mesh)[0] + sums[1]


def adamw_apply(cfg: AdamWConfig, grads, state: AdamWState, params,
                slot_mask: torch.Tensor, mesh=None, cut=None):
    """Masked AdamW step.  Only slots with mask=1 are updated (their
    moments, their counters, their params); everything else passes through
    untouched.  Under a ``mesh`` the trees are this rank's shards and
    ``cut`` says per leaf (``tree_leaves`` order) whether it is cut over
    "model" (``sharding.cut_over_model``), for the clip's norm
    (``clip_sumsq``); with no mesh the norm is taken over the one flat
    gradient.  Returns (new_params, new_state)."""
    with torch.no_grad():
        leaves = tree_leaves(params)
        g = _flat(tree_leaves(grads)).float()
        if cfg.grad_clip > 0:
            gn = torch.sqrt(g.square().sum() if mesh is None else
                            clip_sumsq(g, leaves, cut, mesh))
            g.mul_(torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9),
                               max=1.0))
        t_new = state.t + slot_mask.to(torch.int32)
        # each element's slot, then its mask and step count a chunk at a
        # time
        n = slot_mask.shape[0]
        sid = _per_element(torch.arange(n, device=g.device, dtype=(
            torch.uint8 if n < 256 else torch.int32)), leaves)
        slot_msk = slot_mask.float()
        slot_t = torch.clamp(t_new, min=1).float()
        m, v = _flat(tree_leaves(state.m)), _flat(tree_leaves(state.v))
        p_all = _flat(leaves)
        m_new, v_new = torch.empty_like(m), torch.empty_like(v)
        p_new = torch.empty_like(p_all)
        for c in _chunks(g.numel()):
            i = sid[c].long()
            msk, t_b = slot_msk[i], slot_t[i]
            live, gc = msk > 0, g[c]
            m_new[c] = torch.where(live, cfg.b1 * m[c] + (1 - cfg.b1) * gc,
                                   m[c])
            v_new[c] = torch.where(live, cfg.b2 * v[c]
                                   + (1 - cfg.b2) * gc * gc, v[c])
            # per-slot bias correction
            mhat = m_new[c] / (1 - cfg.b1 ** t_b)
            vhat = v_new[c] / (1 - cfg.b2 ** t_b)
            step = mhat / (torch.sqrt(vhat) + cfg.eps)
            p = p_all[c].float()
            if cfg.weight_decay:
                step = step + cfg.weight_decay * p
            p_new[c] = (p - cfg.lr * step * msk).to(p_new.dtype)
    return _unflat(p_new, params), AdamWState(
        m=_unflat(m_new, state.m), v=_unflat(v_new, state.v), t=t_new)


def tree_add(a, b):
    with torch.no_grad():
        return tree_map(torch.add, a, b)


def tree_zeros_like(a):
    with torch.no_grad():
        return tree_map(torch.zeros_like, a)


def tree_mask_slots(tree, slot_mask: torch.Tensor):
    """Zero every slot not in the mask (used to retire one trainer's
    accumulated gradients after its apply)."""
    with torch.no_grad():
        return tree_map(lambda x: x * _mask_like(x, slot_mask).to(x.dtype),
                        tree)
