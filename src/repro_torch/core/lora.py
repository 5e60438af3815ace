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
    d_in] whole on every rank, each item ``(w, bias, lora)`` holding this
    rank's output columns (``w`` [d_in, c], ``bias`` [c], the bank entry's
    ``a`` [n, d_in or d_in/m, r] and ``b`` [n, r, c or d_out]), or a ``w``
    whole on every rank (MLA's ``wdkv``), whose ``b`` if cut over "model"
    is all-gathered.  The LoRA shrinks of every item whose ``a`` is split
    go in one all-reduce over "model".  Returns each item's [T, c]."""
    from repro_torch.distributed.sharding import all_gather, all_reduce
    m, mi = mesh.shape["model"], mesh.coords["model"]
    outs, shrinks, split = [], [], []
    for w, bias, lora in items:
        y = x @ w
        if bias is not None:
            y = y + bias
        outs.append(y)
        if lora is None or rt is None:
            shrinks.append(None)
            split.append(False)
            continue
        a = lora["a"]
        dl = a.shape[1]
        if dl == x.shape[1]:
            shrinks.append(ops.lora_shrink(x, a, rt))
            split.append(False)
        else:
            if dl * m != x.shape[1]:
                raise ValueError(f"LoRA a{tuple(a.shape)} against x "
                                 f"{tuple(x.shape)} under a model axis of {m}")
            shrinks.append(ops.lora_shrink(x[:, mi * dl:(mi + 1) * dl], a, rt))
            split.append(True)
    parts = [s for s, sp in zip(shrinks, split) if sp]
    if parts:
        summed = all_reduce(torch.cat(parts, dim=1), "model", mesh)
        summed = iter(torch.split(summed, [p.shape[1] for p in parts], dim=1))
        shrinks = [next(summed) if sp else s for s, sp in zip(shrinks, split)]
    for i, (s, (_, _, lora)) in enumerate(zip(shrinks, items)):
        if s is None:
            continue
        b = lora["b"]
        c = outs[i].shape[1]
        if b.shape[-1] > c:           # b whole, the base's columns split
            b = b[..., mi * c:(mi + 1) * c].contiguous()
        elif b.shape[-1] < c:         # b split, the base whole
            b = all_gather(b, "model", mesh, dim=b.ndim - 1).contiguous()
        outs[i] += ops.lora_expand(s, b, rt)
    return outs


def dense_row(x: torch.Tensor, w: torch.Tensor,
              lora: Optional[Dict[str, torch.Tensor]],
              rt: Optional[LoraRoute], mesh, whole: bool = False
              ) -> torch.Tensor:
    """A row-parallel projection under a mesh: ``x`` [T, d_in/m] this rank's
    slice of the contraction, ``w`` [d_in/m, d_out].  The base partial and
    the LoRA expand at the rank's own columns (``b`` [n, r, d_out/m]; a
    whole ``b`` is added by model rank 0 alone) are summed in one
    all-reduce over "model", after the shrinks' all-reduce.  With
    ``whole`` the base is whole on every rank (a ``wo`` whose query heads
    do not divide the model axis, so every rank ran every head): ``x`` [T,
    d_in] and ``w`` [d_in, d_out] whole, no base collective, and the LoRA
    term is ``dense_col``'s "b split, the base whole" case (a cut ``a``
    shrinks x's slice, all-reduced; a cut ``b`` is all-gathered).  Returns
    the whole [T, d_out] on every rank."""
    from repro_torch.distributed.sharding import all_reduce
    if whole:
        return dense_col(x, [(w, None, lora)], rt, mesh)[0]
    m, mi = mesh.shape["model"], mesh.coords["model"]
    y = x @ w
    if lora is not None and rt is not None:
        a, b = lora["a"], lora["b"]
        dl = x.shape[1]
        if a.shape[1] != dl:          # a whole, x split
            a = a[:, mi * dl:(mi + 1) * dl].contiguous()
        s = all_reduce(ops.lora_shrink(x, a, rt), "model", mesh)
        c = b.shape[-1]
        if c == y.shape[1]:
            if mi == 0:
                y += ops.lora_expand(s, b, rt)
        else:
            y[:, mi * c:(mi + 1) * c] += ops.lora_expand(s, b, rt)
    return all_reduce(y, "model", mesh)


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
