"""Multi-LoRA adapter algebra.

A LoRA bank holds ``n_slots`` adapters stacked on a leading axis so that one
kernel call serves every token of a mixed-adapter stream (the paper's SMLM
design).  Per-token ids select the adapter; ``-1`` (or any out-of-range id)
means base model only.  The port keeps the bank per layer::

    bank = {"layers": [{target: {"a": [n, d_in, r], "b": [n, r, d_out]}}]}

Static scaling (alpha/r) is folded into ``b``; dynamic per-request scaling
arrives as the per-slot ``scale`` vector.

Under a mesh (``dense_col`` / ``dense_row``, which the sharded forward
picks from the leaf's logical axes; a "model" axis of m ranks), the bank is
cut as ``distributed.sharding.lora_shardings`` says: ``a``'s d_in and
``b``'s d_out over "model".  The fused SMLM / BGMV calls cannot hold a
collective between their two launches, so each projection runs the split
entries (``ops.lora_shrink`` / ``ops.lora_expand``): every rank shrinks
its slice of d_in, the fp32 [T, r] shrinks are summed over "model" (32 B a
token at r = 8), and every rank expands through its slice of d_out.
Column-parallel projections (``wq``/``wk``/``wv``/``wg``/``wu``: x whole on
every rank, the output's columns split) shrink x's slice of d_in that
matches their ``a``, rather than all-gathering ``a`` for the fused call:
the shrinks of the projections that share x go in one all-reduce of a few
hundred bytes a token, where gathering ``a`` would move n_slots * d_in * r
elements a projection and call.  Row-parallel projections (``wo``/``wd``:
x split on d_in) add their expand into the base product's partial at the
rank's own columns before the base all-reduce, so the sum is exact and
the expand's output needs no all-gather.

With a gradient (the train step under a mesh) the same code runs under
autograd: the LoRA terms through ``ops.SplitLoRAFunction`` (the shrinks'
all-reduce in the forward, the ``Gs`` all-reduce in the backward), the
collectives through their ``*_grad`` forms (``distributed.sharding``).
A gradient is summed over "model" only where the ranks' consumers differ:
``x`` enters ``dense_col``'s column-parallel products and sliced shrinks
through ``sum_grad``, except the base of a sublayer every rank runs whole
and alike (``read="alike"``), whose gradient is whole already.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import LoraRoute


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    n_slots: int = 4            # resident adapter slots
    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.05       # train-time only
    targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo", "wg", "wu", "wd",
                                "wdkv", "in_x", "in_z", "out_proj")

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def lora_apply_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   ids: torch.Tensor, scale_t: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """One-hot mixed multi-LoRA matmul, exact per token (the oracle the
    dispatch is held to).  x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out];
    ids: [T]; out-of-range ids give a zero row."""
    n = a.shape[0]
    onehot = (ids.long()[:, None] == torch.arange(n, device=x.device)
              ).to(x.dtype)
    if scale_t is not None:
        onehot = onehot * scale_t[:, None].to(x.dtype)
    xa = torch.einsum("td,ndr->tnr", x, a.to(x.dtype)) * onehot[:, :, None]
    return torch.einsum("tnr,nro->to", xa, b.to(x.dtype))


def lora_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               ids: torch.Tensor, scale_t: Optional[torch.Tensor] = None, *,
               n_head: int, block_t: int, n_ft: int = 0) -> torch.Tensor:
    """Kernel dispatch: the first ``n_head`` tokens (ft+pf, tile-aligned at
    the planner's ``block_t``) through SMLM, the rest through BGMV; with
    grad mode on, the first ``n_ft`` (ft rows) carry gradient."""
    rt = ops.route(ids, scale_t, a.shape[0], n_head, block_t, n_ft)
    return ops.lora_apply(x, a, b, rt)


def dense(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
          lora: Optional[Dict[str, torch.Tensor]],
          rt: Optional[LoraRoute]) -> torch.Tensor:
    """Joint base + multi-LoRA linear over the flattened stream [T, d]: one
    base product (``torch.matmul``, which the JAX package leaves to XLA)
    plus one multi-LoRA kernel call per bucket."""
    y = x @ w
    if bias is not None:
        y = y + bias
    if lora is not None and rt is not None:
        y += ops.lora_apply(x, lora["a"], lora["b"], rt)
    return y


def dense_col(x: torch.Tensor, items, rt: Optional[LoraRoute], mesh
              ) -> list:
    """Column-parallel projections of one input under a mesh: ``x`` [T,
    d_in] whole on every rank, each item ``(w, bias, lora, read)`` holding
    this rank's output columns (``w`` [d_in, c] or an
    ``sharding.FSDPWeight``, ``bias`` [c], the bank entry's ``a`` [n, d_in
    or d_in/m, r] and ``b`` [n, r, c or d_out]), or a ``w`` whole on every
    rank (MLA's ``wdkv``, heads that do not divide the model axis), whose
    ``b`` if cut over "model" is all-gathered.  ``read`` says how the
    ranks read the item's output, which decides its adjoints: ``"cut"``
    (``w`` holds the rank's columns), ``"alike"`` (``w`` whole, every rank
    reads all of it: a sublayer every rank runs whole), ``"differ"`` (``w``
    whole, each rank reads part of it: whole ``wk`` / ``wv`` beside cut
    query heads).  The LoRA shrinks of every item whose ``a`` is split go
    in one all-reduce over "model" (and their ``Gs`` in one in the
    backward).  Returns each item's [T, c]."""
    from repro_torch.distributed.sharding import all_gather_grad, \
        all_reduce, matmul, sum_grad
    m, mi = mesh.shape["model"], mesh.coords["model"]
    # a replicated x entering work that differs between ranks: its gradient
    # is summed over "model" in the backward
    xp = sum_grad(x, "model", mesh)
    outs = []
    for w, bias, _, read in items:
        y = matmul(x if read == "alike" else xp, w)
        if bias is not None:
            y = y + bias
        outs.append(y)
    split, whole = [], []
    for i, (_, _, lora, read) in enumerate(items):
        if lora is None or rt is None:
            continue
        a, b = lora["a"], lora["b"]
        c = outs[i].shape[1]
        differ = read != "alike"
        if b.shape[-1] > c:           # b whole, the base's columns split
            b = sum_grad(b, "model", mesh)[..., mi * c:(mi + 1) * c]
        elif b.shape[-1] < c:         # b split, the base whole
            b = all_gather_grad(b, "model", mesh, dim=b.ndim - 1,
                                differ=differ)
        elif read == "differ":        # b whole, the base whole, read in part
            b = sum_grad(b, "model", mesh)
        dl = a.shape[1]
        if dl != x.shape[1] and dl * m != x.shape[1]:
            raise ValueError(f"LoRA a{tuple(a.shape)} against x "
                             f"{tuple(x.shape)} under a model axis of {m}")
        (whole if dl == x.shape[1] else split).append(
            (i, a, b.contiguous(), differ))
    reduce = lambda t: all_reduce(t, "model", mesh)
    if split:
        dl = split[0][1].shape[1]
        # x's slice of d_in that matches the rank's rows of a
        ys = ops.lora_split(xp[:, mi * dl:(mi + 1) * dl],
                            [(a, b) for _, a, b, _ in split], rt, reduce,
                            True, [d for *_, d in split])
        for (i, *_), y in zip(split, ys):
            outs[i] += y
    for i, a, b, differ in whole:     # a whole: every rank shrinks all of x
        outs[i] += ops.lora_split(x, [(a, b)], rt, reduce, False,
                                  [differ])[0]
    return outs


def dense_row(x: torch.Tensor, w, lora: Optional[Dict[str, torch.Tensor]],
              rt: Optional[LoraRoute], mesh, whole: bool = False
              ) -> torch.Tensor:
    """A row-parallel projection under a mesh: ``x`` [T, d_in/m] this rank's
    slice of the contraction, ``w`` [d_in/m, d_out] (or an
    ``sharding.FSDPWeight``).  The base partial and the LoRA expand at the
    rank's own columns (``b`` [n, r, d_out/m]; a whole ``b`` is added by
    model rank 0 alone) are summed in one all-reduce over "model", after
    the shrinks' all-reduce; the output feeds the replicated residual
    stream, so that all-reduce's adjoint is the identity.  With ``whole``
    the base is whole on every rank (a ``wo`` whose query heads do not
    divide the model axis, so every rank ran every head): ``x`` [T, d_in]
    and ``w`` [d_in, d_out] whole, no base collective, and the LoRA term is
    ``dense_col``'s "b split, the base whole" case read alike (a cut ``a``
    shrinks x's slice, all-reduced; a cut ``b`` is all-gathered).  Returns
    the whole [T, d_out] on every rank."""
    from repro_torch.distributed.sharding import all_reduce, \
        all_reduce_grad, matmul, sum_grad
    if whole:
        return dense_col(x, [(w, None, lora, "alike")], rt, mesh)[0]
    m, mi = mesh.shape["model"], mesh.coords["model"]
    y = matmul(x, w)
    if lora is not None and rt is not None:
        a, b = lora["a"], lora["b"]
        dl = x.shape[1]
        if a.shape[1] != dl:          # a whole, x split
            a = sum_grad(a, "model", mesh)[:, mi * dl:(mi + 1) * dl]
        c = b.shape[-1]
        whole_b = c == y.shape[1]
        if whole_b:
            b = sum_grad(b, "model", mesh)
        pairs = [(a.contiguous(), b)]
        reduce = lambda t: all_reduce(t, "model", mesh)
        if whole_b and mi != 0 and not ops.split_carries_grad(x, pairs, rt):
            # no gradient: the shrinks' all-reduce pairs with model rank
            # 0's, which alone expands and adds a whole b's term
            reduce(ops.lora_shrink(x, pairs[0][0], rt))
        else:
            out = ops.lora_split(x, pairs, rt, reduce, True, [True])[0]
            if not whole_b:
                y[:, mi * c:(mi + 1) * c] += out
            elif mi == 0:
                y += out
            else:
                # under a gradient every rank expands, so that every rank's
                # backward reaches the Gs all-reduce; model rank 0 alone
                # adds the term (a fill, not a product: an inf stays out)
                y += out.masked_fill(out.new_ones((), dtype=torch.bool), 0)
    return all_reduce_grad(y, "model", mesh)


def init_lora_bank(layer_targets, lcfg: LoRAConfig,
                   generator: torch.Generator, device: torch.device,
                   dtype: torch.dtype, gaussian_b: bool = False) -> Dict:
    """Random bank for ``layer_targets`` (one name -> LoraTarget dict per
    layer, ``models.schema.lora_targets``): ``a`` is normal / sqrt(d_in);
    ``b`` is zeros, or normal * 0.02 * alpha/r with ``gaussian_b`` (the
    paper's fully gaussian adapters)."""
    layers = []
    for targets in layer_targets:
        d = {}
        for name, t in targets.items():
            a = torch.randn((lcfg.n_slots, t.d_in, lcfg.r),
                            generator=generator, device=device, dtype=dtype)
            a.mul_(1.0 / t.d_in ** 0.5)
            if gaussian_b:
                b = torch.randn((lcfg.n_slots, lcfg.r, t.d_out),
                                generator=generator, device=device,
                                dtype=dtype).mul_(0.02 * lcfg.scaling)
            else:
                b = torch.zeros((lcfg.n_slots, lcfg.r, t.d_out),
                                device=device, dtype=dtype)
            d[name] = {"a": a, "b": b}
        layers.append(d)
    return {"layers": layers}
