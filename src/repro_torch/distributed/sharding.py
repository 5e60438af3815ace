"""Logical-axis -> mesh sharding rules, the shards they cut, and the
collectives of the explicit-SPMD forward.

Port of ``repro.distributed.sharding``.  A spec is the port's own tuple
with one entry per dimension: ``None`` (replicated), an axis name, or a
tuple of axis names (sharded over their product, in mesh order); it
stands where JAX writes ``PartitionSpec``.  The rules return specs in the
port's trees: the per-layer params (``param_shardings``), the per-layer
bank (``lora_shardings``), the cache dict of named leaves ``[L_kind, rows,
...]`` (``cache_shardings``) and the buckets of a ``UnifiedBatch``
(``batch_shardings``).

Cache strategies (JAX dryrun's ``cache_strategy``): "auto" cuts a KV leaf
by its KV heads when their count divides "model", else by the head dim,
else by the slots; "seq" cuts the slots first (the flash-decoding layout).
``kv_layout`` names the layout, ``shard_layout`` reads it back from a
shard and refuses a shard of the other one.

Strategies:
  "tp"      — tensor parallel over the "model" axis only; params replicated
              across data/pod.
  "fsdp_tp" — additionally shard the "embed" logical axis of every weight
              over "data" (FSDP); pods replicate (DP across pods).

Divisibility is checked per leaf: a dimension that does not divide the mesh
axis is replicated (40 attention heads or 8 KV heads on a 16-way model
axis, the 50280/51865 vocabs).  Head-count sharding is only applied when the
HEAD COUNT divides the axis, so a rank's columns are whole heads.

PyTorch has no GSPMD, so the sharded forward (``models.model``,
``models.moe_dist``) is written as explicit SPMD: ``local_shard`` cuts this
rank's block of a whole tensor by its spec, ``gather`` puts a sharded one
back together, and the forward calls only the collectives below
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``), each
over the process group of a mesh axis or tuple of axes and each recording
its operand bytes by kind (``collective_log``, read by
``roofline.analysis.collective_bytes``).  A collective over an axis of size
1 is the identity and records nothing.  JAX's two layout hints have no
counterpart as hints: ``maybe_constrain`` hinted the expert-parallel
layout, which ``models.moe_dist.moe_apply_auto`` now states itself (tokens
split over ``(*batch_axes, "model")``, experts over ``"model"``), and
``act_constraint_fn``'s sequence sharding of the training carry is two
explicit steps (``SeqShard``): a layer period ends by keeping this rank's
block of the carry's tokens (``SeqShard.cut``) and the next one starts by
all-gathering the blocks (``SeqShard.whole``), so a rematerialised period
(``models.model``, ``remat``) saves the block alone.

The train step under a mesh differentiates the same explicit SPMD forward.
Every rank computes the same scalar loss and runs the backward over its own
graph, so the adjoint of a collective depends on who reads its result.  A
tensor every rank holds alike has, on each rank, its whole gradient when
every rank's consumers of it are alike, and a partial one (each rank holds
a summand) when the consumers differ between ranks.  The collectives with
gradients state which case they serve: ``sum_grad`` feeds work that
differs (its backward sums), and ``all_reduce_grad`` and
``all_gather_grad`` take the case as their ``differ`` argument (read
alike: the identity or "take my rows"; read differently: an all-reduce or
a reduce-scatter).  The sum over "model" that
``dense_col``'s shrink all-reduce needs is made inside
``kernels.ops.SplitLoRAFunction``.  The plain collectives refuse a tensor
that carries a gradient, so no collective is ever differentiated as the
identity by mistake.
``reduce_bank_grads`` sums the bank's gradients over the batch axes, and
``FSDPWeight`` keeps a weight cut over "data" (an int8 leaf as its int8
payload and scales) out of autograd's saved tensors (``matmul`` gathers
it again in the backward).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh, axis_size, batch_axes
from repro_torch.models.configs import ModelConfig
from repro_torch.models.quant import dequant_leaf
from repro_torch.models.schema import encoder_shapes, layer_shapes, \
    top_leaves

Spec = Tuple


def _spec_for(cfg: ModelConfig, mesh: Mesh, strategy: str, shape,
              logical) -> Spec:
    msize = mesh.shape["model"]
    dsize = mesh.shape["data"]
    parts = []
    used = set()
    for dim, name in zip(shape, logical):
        ax = None
        if name == "embed":
            if strategy == "fsdp_tp" and dim % dsize == 0:
                ax = "data"
        elif name == "vocab":
            if dim % msize == 0:
                ax = "model"
        elif name == "heads":
            if cfg.n_heads % msize == 0 and dim % msize == 0:
                ax = "model"
        elif name == "kv_heads":
            if cfg.n_kv_heads % msize == 0 and dim % msize == 0:
                ax = "model"
        elif name == "heads_sep":
            if dim % msize == 0:
                ax = "model"
        elif name in ("ffn", "experts"):
            if dim % msize == 0:
                ax = "model"
        elif name in ("ssm", "ssm_heads"):
            # Mamba head-parallel TP when the SSM head count divides the
            # model axis
            if cfg.ssm is not None and cfg.n_ssm_heads % msize == 0 \
                    and dim % msize == 0:
                ax = "model"
        if ax in used:       # one mesh axis per spec (experts wins over ffn)
            ax = None
        if ax is not None:
            used.add(ax)
        parts.append(ax)
    return tuple(parts)


def param_shardings(cfg: ModelConfig, mesh: Mesh,
                    strategy: str = "fsdp_tp") -> Dict:
    """Specs in the params' tree (``schema.init_params``)."""
    def specs(leaves):
        return {k: _spec_for(cfg, mesh, strategy, leaf.shape, leaf.logical)
                for k, leaf in leaves.items()}
    out = specs(top_leaves(cfg))
    out["layers"] = [specs(layer_shapes(cfg, li))
                     for li in range(cfg.n_layers)]
    out["final_norm"] = (None,)
    if cfg.encoder is not None:
        enc = specs(encoder_shapes(cfg))
        out["encoder"] = {"layers": [dict(enc)
                                     for _ in range(cfg.encoder.n_layers)],
                          "final_norm": (None,)}
    return out


def replicated(mesh: Mesh) -> Spec:
    return ()


def tree_replicated(tree, mesh: Mesh):
    return _tree_map(lambda _: (), tree)


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of a nest of dicts, lists, tuples and
    NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _dim0_batch_spec(mesh: Mesh, b: int, extra_dims: int) -> Spec:
    bx = batch_axes(mesh)
    if b % axis_size(mesh, bx) == 0:
        return (bx, *([None] * extra_dims))
    return tuple([None] * (extra_dims + 1))


def batch_shardings(batch, mesh: Mesh):
    """Shard every bucket tensor's leading (row) dim over the batch axes
    (when it divides them), in the batch's own tree."""
    return _tree_map(lambda x: _dim0_batch_spec(mesh, x.shape[0],
                                                x.ndim - 1), batch)


def cache_shardings(cfg: ModelConfig, cache: Dict, mesh: Mesh,
                    strategy: str = "auto") -> Dict:
    """Cache leaves are ``[L_kind, rows, ...]``: rows over the batch axes
    when divisible; the widest remaining axis over "model" (``k``/``v``
    and ``xk``/``xv`` [.., S, g, hd]: the KV heads when their count divides
    the axis, else the head dim, else the sequence; MLA's ``ckv``/``kpe``:
    the sequence; Mamba's ``h``: the SSM heads, ``conv_x``: d_inner;
    ``conv_bc`` stays replicated).  ``strategy="seq"`` shards the KV
    sequence over "model" instead (the flash-decoding layout).  ``cache``:
    any dict of tensors with the cache's names and shapes (meta tensors
    do)."""
    msize = mesh.shape["model"]
    bx = batch_axes(mesh)
    bsz = axis_size(mesh, bx)

    def leaf_spec(key, x):
        dims = [None] * x.ndim
        if x.shape[1] % bsz == 0 and x.shape[1] > 1:
            dims[1] = bx
        if key in ("k", "v", "xk", "xv"):
            cut = kv_layout(cfg, x.shape[2], x.shape[4], msize, strategy)
            if cut is not None:
                dims[LAYOUT_DIM[cut]] = "model"
        elif key in ("ckv", "kpe"):
            if x.shape[2] % msize == 0:
                dims[2] = "model"
        elif key == "h":
            if x.shape[2] % msize == 0:
                dims[2] = "model"
        elif key == "conv_x":
            if x.shape[3] % msize == 0:
                dims[3] = "model"
        return tuple(dims)

    return {key: leaf_spec(key, x) for key, x in cache.items()}


# the dimension of a ``k``/``v``/``xk``/``xv`` leaf [L, rows, S, g, hd] that
# each layout cuts over "model"
LAYOUT_DIM = {"seq": 2, "heads": 3, "head_dim": 4}
CACHE_STRATEGIES = ("auto", "seq")


def kv_layout(cfg: ModelConfig, n_slots: int, hd: int, m: int,
              strategy: str = "auto") -> Optional[str]:
    """The layout ``cache_shardings`` gives a ``k``/``v``/``xk``/``xv`` leaf
    of ``n_slots`` slots under a model axis of ``m``: ``"seq"`` (the
    slots; first under ``strategy="seq"``), ``"heads"`` (the KV heads, when
    their count divides the axis), ``"head_dim"``, or None (nothing
    divides: the leaf stays whole)."""
    if strategy not in CACHE_STRATEGIES:
        raise ValueError(f"cache_strategy {strategy!r}: one of "
                         f"{CACHE_STRATEGIES}")
    if strategy == "seq" and n_slots % m == 0:
        return "seq"
    if cfg.n_kv_heads % m == 0:
        return "heads"
    if hd % m == 0:
        return "head_dim"
    if n_slots % m == 0:
        return "seq"
    return None


def shard_layout(cfg: ModelConfig, key: str, dims, mesh: Mesh,
                 strategy: str = "auto") -> str:
    """The layout of this rank's shard of a ``k``/``v``/``xk``/``xv`` leaf,
    read from its trailing dims ``(S, g, hd)`` (a cut KV-head or head-dim
    axis, else the slots), checked against the layout ``strategy`` gives
    the whole leaf: a shard of the other layout raises a ``ValueError``
    that names both, so it is never read as the wrong one.  On a model axis
    of 1 every layout is the whole row, and the strategy's is taken."""
    m = mesh.shape["model"]
    S, g, hd = (int(d) for d in dims[-3:])
    if m == 1:
        return kv_layout(cfg, S, hd, 1, strategy)
    if g < cfg.n_kv_heads:
        got, whole = "heads", S
    elif hd < cfg.hd:
        got, whole = "head_dim", S
    else:
        got, whole = "seq", S * m
    want = kv_layout(cfg, whole, cfg.hd, m, strategy)
    if got != want:
        raise ValueError(
            f"a {key} shard [.., {S}, {g}, {hd}] in the {got!r} layout given "
            f"to cache_strategy {strategy!r}, whose layout is {want!r} "
            f"(model axis {m}): shard the cache with the step's "
            "cache_strategy")
    return got


def lora_shardings(bank, mesh: Mesh):
    """Shard each adapter's wide dim over "model": ``a``'s d_in (the
    contraction: a rank's shrink is a partial sum, all-reduced as a small
    fp32 [T, r]) and ``b``'s d_out (the base linear's output columns)."""
    msize = mesh.shape["model"]

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, key) for v in node)
        dims = [None] * node.ndim
        if key == "a" and node.ndim >= 2 and node.shape[-2] % msize == 0:
            dims[-2] = "model"
        elif key == "b" and node.ndim >= 1 and node.shape[-1] % msize == 0:
            dims[-1] = "model"
        return tuple(dims)

    return walk(bank)


def bank_shardings(cfg: ModelConfig, bank, mesh: Mesh):
    """``lora_shardings`` of the whole bank of which ``bank`` holds this
    rank's shards (or the whole leaves): the whole shapes come from the
    config (``schema.lora_targets``), so a shard gets its whole leaf's
    spec."""
    from repro_torch.models.schema import lora_targets
    names = tuple({leaf.lora for li in range(cfg.n_layers)
                   for leaf in layer_shapes(cfg, li).values() if leaf.lora})
    targets = lora_targets(cfg, names)

    def whole(li, k, ab):
        n, r = ab["a"].shape[0], ab["a"].shape[-1]
        t = targets[li][k]
        return {"a": torch.empty((n, t.d_in, r), device="meta"),
                "b": torch.empty((n, r, t.d_out), device="meta")}

    return lora_shardings({"layers": [
        {k: whole(li, k, ab) for k, ab in layer.items()}
        for li, layer in enumerate(bank["layers"])]}, mesh)


def cut_over_model(specs) -> List[bool]:
    """Per leaf of a bank's spec tree (``bank_shardings``), in
    ``training.optimizer.tree_leaves`` order: is it cut over "model"?"""
    if isinstance(specs, dict):
        return [c for v in specs.values() for c in cut_over_model(v)]
    if isinstance(specs, list):
        return [c for v in specs for c in cut_over_model(v)]
    return [any("model" in _entry_axes(e) for e in specs)]


def opt_shardings(opt, mesh: Mesh):
    """AdamW moments follow the bank; the per-slot step counters
    replicate.  ``opt``: ``training.optimizer.AdamWState`` (its ``m`` and
    ``v`` are bank-shaped trees, concatenated into flat buffers only
    inside ``adamw_apply``)."""
    return type(opt)(m=lora_shardings(opt.m, mesh),
                     v=lora_shardings(opt.v, mesh), t=replicated(mesh))


# ---------------------------------------------------------------------------
# the ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT: list = []


@contextlib.contextmanager
def mesh_context(mesh: Mesh, strategy: str = "fsdp_tp",
                 cache_strategy: str = "auto"):
    """Install ``mesh`` (with the params' ``strategy``, which says which
    leaves the forward finds sharded over "data", and the cache's
    ``cache_strategy``, which says how ``shard_cache`` cut its KV rows) as
    the ambient mesh."""
    if cache_strategy not in CACHE_STRATEGIES:
        raise ValueError(f"cache_strategy {cache_strategy!r}: one of "
                         f"{CACHE_STRATEGIES}")
    _AMBIENT.append((mesh, strategy, cache_strategy))
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def ambient_mesh() -> Optional[Mesh]:
    """The mesh currently in scope, or None."""
    return _AMBIENT[-1][0] if _AMBIENT else None


def ambient_strategy() -> Optional[str]:
    return _AMBIENT[-1][1] if _AMBIENT else None


def ambient_cache_strategy() -> str:
    return _AMBIENT[-1][2] if _AMBIENT else "auto"


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``x``: along each dimension
    sharded over axes ``A``, the ``mesh.index(A)``-th of ``axis_size(A)``
    equal blocks (data-major for a tuple).  A new tensor of its own
    storage (a view would keep the whole alive), or ``x`` itself when
    nothing is cut (every axis of its spec of size 1 too)."""
    out = x
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        n = axis_size(mesh, axes) if axes else 1
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"divide {axes} = {n}")
        size = x.shape[dim] // n
        out = out.narrow(dim, mesh.index(axes) * size, size)
    return out.clone(memory_format=torch.contiguous_format) \
        if out is not x else x


def gather(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every rank's block ``x`` (``local_shard``'s
    inverse), by an all-gather along each sharded dimension."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if axes:
            x = all_gather(x, axes, mesh, dim=dim)
    return x


def gather_tree(tree, specs, mesh: Mesh):
    """``gather`` over a tree of shards and its tree of specs
    (``shard_tree``'s inverse)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_tree(v, s, mesh) for v, s in zip(tree, specs)]
    return gather(tree, specs, mesh)


def shard_tree(tree, specs, mesh: Mesh):
    """``local_shard`` over a tree and its same-shaped tree of specs."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return local_shard(tree, specs, mesh)


# ---------------------------------------------------------------------------
# collectives over mesh axes, with their operand bytes recorded by kind
# ---------------------------------------------------------------------------

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_LOG: Dict[str, int] = {k: 0 for k in KINDS}


def reset_collective_log() -> None:
    for k in KINDS:
        _LOG[k] = 0


def collective_log() -> Dict[str, int]:
    """Operand bytes by kind since the last reset (a rank's own)."""
    return dict(_LOG)


def _record(kind: str, x: torch.Tensor) -> None:
    _LOG[kind] += x.numel() * x.element_size()


def _group(mesh: Mesh, axes):
    axes = mesh.axes(axes)
    return axes, axis_size(mesh, axes)


def _carries_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _no_grad(x: torch.Tensor, kind: str) -> None:
    """A plain collective is invisible to autograd: refuse a tensor that
    carries a gradient (the ``*_grad`` collectives take it)."""
    if _carries_grad(x):
        raise ValueError(f"a plain {kind} of a tensor that carries a "
                         "gradient: use the collective's *_grad form")


def all_reduce(x: torch.Tensor, axes, mesh: Mesh,
               op: str = "sum") -> torch.Tensor:
    """In place: ``x`` summed (``op="max"``: maxed) over ``axes``."""
    import torch.distributed as dist
    axes, n = _group(mesh, axes)
    if n == 1:
        return x
    _no_grad(x, "all-reduce")
    _record("all-reduce", x)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(x, op=red, group=mesh.group(axes))
    return x


def all_gather(x: torch.Tensor, axes, mesh: Mesh,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` over ``axes``, concatenated along ``dim`` in
    mesh order."""
    import torch.distributed as dist
    axes, n = _group(mesh, axes)
    if n == 1:
        return x
    _no_grad(x, "all-gather")
    _record("all-gather", x)
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0], *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, xm, group=mesh.group(axes))
    return out.movedim(0, dim) if dim else out


def reduce_scatter(x: torch.Tensor, axes, mesh: Mesh,
                   dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axes``; this rank keeps its block along
    ``dim``."""
    import torch.distributed as dist
    axes, n = _group(mesh, axes)
    if n == 1:
        return x
    _no_grad(x, "reduce-scatter")
    _record("reduce-scatter", x)
    xm = x.movedim(dim, 0).contiguous()
    if xm.shape[0] % n:
        raise ValueError(f"reduce_scatter: {xm.shape[0]} rows over {n}")
    out = torch.empty((xm.shape[0] // n, *xm.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.reduce_scatter_tensor(out, xm, group=mesh.group(axes))
    return out.movedim(0, dim) if dim else out


def all_to_all(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """Block ``i`` of ``x``'s leading dim to rank ``i`` of ``axes``; the
    result's block ``i`` came from rank ``i``."""
    import torch.distributed as dist
    axes, n = _group(mesh, axes)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: {x.shape[0]} rows over {n}")
    _no_grad(x, "all-to-all")
    _record("all-to-all", x)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


# ---------------------------------------------------------------------------
# collectives with gradients: the train step under a mesh
# ---------------------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    """``y = sum_r x_r`` over ``axes``, the same on every rank.  Where every
    rank reads ``y`` alike (``dense_row``'s output into the residual
    stream, the vocab-parallel CE's ``sumexp`` / ``picked``) the adjoint is
    ``dx_r = dy``: each rank's ``dy`` is already the whole gradient, and
    summing it again would multiply it by the axis size.  Where the ranks
    read ``y`` differently (``differ``: Mamba2's gated-norm sum of squares,
    which each rank applies to its own slice of d_inner) each rank's ``dy``
    is a summand of the whole gradient, and the adjoint is ``dx_r = sum_r'
    dy_r'``, one all-reduce in the backward."""

    @staticmethod
    def forward(ctx, x, axes, mesh, differ):
        ctx.axes, ctx.mesh, ctx.differ = axes, mesh, differ
        return all_reduce(x.clone(), axes, mesh)

    @staticmethod
    def backward(ctx, dy):
        if ctx.differ:
            dy = all_reduce(dy.clone(), ctx.axes, ctx.mesh)
        return dy, None, None, None


class _SumGrad(torch.autograd.Function):
    """``y = x`` (a tensor every rank holds alike entering work that
    differs between ranks: column-parallel products, a rank's slice of a
    whole leaf).  Adjoint: ``dx = sum_r dy_r`` over ``axes``."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.clone(), ctx.axes, ctx.mesh), None, None


class _AllGather(torch.autograd.Function):
    """``y`` = every rank's ``x`` over ``axes``, concatenated along ``dim``.
    Adjoint: ``dx_r`` = block ``r`` of ``dy`` along ``dim`` where every rank
    reads ``y`` alike ("take my rows": the batch-axis gather of the ft loss
    sums, a cut ``b`` gathered for a sublayer every rank runs alike); block
    ``r`` of ``sum_r' dy_r'`` (a reduce-scatter) where the ranks read ``y``
    differently (a cut ``b`` gathered for whole ``wk`` / ``wv`` whose heads
    each rank's query heads read in part)."""

    @staticmethod
    def forward(ctx, x, axes, mesh, dim, differ):
        ctx.axes, ctx.mesh, ctx.dim, ctx.differ = axes, mesh, dim, differ
        return all_gather(x, axes, mesh, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        axes, mesh, dim = ctx.axes, ctx.mesh, ctx.dim
        if ctx.differ:
            dx = reduce_scatter(dy, axes, mesh, dim=dim)
        else:
            n = axis_size(mesh, axes)
            dx = dy.narrow(dim, mesh.index(axes) * (dy.shape[dim] // n),
                           dy.shape[dim] // n)
        return dx.contiguous(), None, None, None, None


def all_reduce_grad(x: torch.Tensor, axes, mesh: Mesh,
                    differ: bool = False) -> torch.Tensor:
    """``all_reduce`` (sum) with its gradient (``_AllReduce``): the
    identity where every rank reads the result alike, the sum of every
    rank's gradient where they read it differently (``differ``).  Without
    a gradient to carry it is the plain in-place ``all_reduce``."""
    if axis_size(mesh, mesh.axes(axes)) == 1:
        return x
    if not _carries_grad(x):
        return all_reduce(x, axes, mesh)
    return _AllReduce.apply(x, axes, mesh, differ)


def sum_grad(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """``x`` itself, its gradient summed over ``axes`` (``_SumGrad``)."""
    if axis_size(mesh, mesh.axes(axes)) == 1 or not _carries_grad(x):
        return x
    return _SumGrad.apply(x, axes, mesh)


def all_gather_grad(x: torch.Tensor, axes, mesh: Mesh, dim: int = 0,
                    differ: bool = False) -> torch.Tensor:
    """``all_gather`` with its gradient (``_AllGather``; ``differ``: the
    ranks read the gathered tensor differently)."""
    if axis_size(mesh, mesh.axes(axes)) == 1:
        return x
    if not _carries_grad(x):
        return all_gather(x, axes, mesh, dim=dim)
    return _AllGather.apply(x, axes, mesh, dim % x.ndim, differ)


# ---------------------------------------------------------------------------
# the sequence-parallel carry of the train step (JAX's ``act_constraint_fn``)
# ---------------------------------------------------------------------------

def _block(x: torch.Tensor, axes, mesh: Mesh) -> torch.Tensor:
    """This rank's block of the rows of ``x`` over ``axes``, the row count
    padded with zero rows to a multiple of their size: a tensor of its own
    storage (a view would keep the whole alive)."""
    n = axis_size(mesh, mesh.axes(axes))
    rows = -(-x.shape[0] // n)
    i = mesh.index(axes)
    y = x.new_zeros((rows, *x.shape[1:]))
    part = x[i * rows:(i + 1) * rows]
    y[:part.shape[0]] = part
    return y


def cut_grad(dy: torch.Tensor, axes, mesh: Mesh,
             n_tokens: int) -> torch.Tensor:
    """``_SeqCut``'s adjoint: every rank's block gradient, all-gathered
    over ``axes`` and unpadded to ``n_tokens`` rows."""
    return all_gather(dy.contiguous(), axes, mesh, dim=0)[:n_tokens]


class _SeqCut(torch.autograd.Function):
    """``y`` = this rank's block of the rows of ``x`` [T, d] over ``axes``
    (``_block``).  ``x`` is held alike by every rank, and each rank's work
    after the cut reads only its own block (the next period's
    ``_SeqGather`` takes it as this rank's part), so rank ``r``'s ``dy`` is
    the whole gradient of block ``r`` and nothing of the others.  Adjoint:
    ``dx`` = every rank's ``dy`` all-gathered over ``axes`` and unpadded
    (``cut_grad``): the whole gradient of ``x`` on every rank, as the layer
    before the cut expects of a tensor read alike."""

    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh, ctx.n_tokens = axes, mesh, x.shape[0]
        return _block(x, axes, mesh)

    @staticmethod
    def backward(ctx, dy):
        return cut_grad(dy, ctx.axes, ctx.mesh, ctx.n_tokens), None, None


class _SeqGather(torch.autograd.Function):
    """``y`` [T, d] = every rank's block over ``axes``, concatenated in
    mesh order and unpadded to ``n_tokens`` rows.  Every rank reads ``y``
    alike, and the period's layers give it its whole gradient on every
    rank (``rms_norm`` and the residual are read alike, and
    ``core.lora.dense_col``'s ``sum_grad`` sums the column-parallel
    products' parts over "model").  Adjoint: ``dx_r`` = block ``r`` of
    ``dy`` ("take my rows"; a padding row takes zeros)."""

    @staticmethod
    def forward(ctx, xb, axes, mesh, n_tokens):
        ctx.axes, ctx.mesh = axes, mesh
        return all_gather(xb, axes, mesh, dim=0)[:n_tokens]

    @staticmethod
    def backward(ctx, dy):
        return _block(dy, ctx.axes, ctx.mesh), None, None, None


class SeqShard(NamedTuple):
    """``act_constraint_fn(mesh)``: the sequence-parallel carry of a layer
    stack under ``mesh``.  ``axes(split)``: the axes the carry's tokens are
    cut over: "model" always, and the batch axes too where no bucket was
    split over them (``models.model.local_batch``), since the carry is
    then whole, and alike, on every rank of them.  ``cut`` keeps this
    rank's block of the tokens (``_SeqCut``), ``whole`` gathers the blocks
    back (``_SeqGather``); a token count that the axes do not divide is
    padded with zero rows.  Neither changes a value: only what a rank
    holds between periods shrinks.  Over axes of size 1 both are the
    identity."""
    mesh: Mesh

    def axes(self, split: bool) -> tuple:
        return ("model",) if split else (*batch_axes(self.mesh), "model")

    def _one(self, axes) -> bool:
        return axis_size(self.mesh, self.mesh.axes(axes)) == 1

    def cut(self, x: torch.Tensor, axes) -> torch.Tensor:
        if self._one(axes):
            return x
        if _carries_grad(x):
            return _SeqCut.apply(x, axes, self.mesh)
        return _block(x, axes, self.mesh)

    def whole(self, xb: torch.Tensor, axes, n_tokens: int) -> torch.Tensor:
        if self._one(axes):
            return xb
        if _carries_grad(xb):
            return _SeqGather.apply(xb, axes, self.mesh, n_tokens)
        return all_gather(xb, axes, self.mesh, dim=0)[:n_tokens]


def act_constraint_fn(mesh: Mesh) -> SeqShard:
    """The counterpart of JAX's ``act_constraint_fn`` (the sequence
    sharding of the train step's carry over ``(*batch_axes, "model")``):
    hand it to ``core.unified.make_train_step(..., act_constraint=)``."""
    return SeqShard(mesh)


def reduce_bank_grads(grads, mesh: Mesh, split: bool):
    """The bank's gradients of one rank made the whole step's: summed over
    the batch axes when the ft bucket was split over them (each data rank
    ran its own rows), left as they are when every data rank ran the whole
    bucket.  One all-reduce of the leaves in one flat buffer.  The "model"
    axis needs no sum here: a leaf ``lora_shardings`` cuts gets its own
    slice's gradient, and a whole leaf that ranks use differently (a whole
    ``b`` each rank slices to its own columns, a whole ``b`` added by model
    rank 0 alone, a whole ``a`` sliced to a rank's rows) goes through
    ``sum_grad`` where it is used (``core.lora``), so its gradient arrives
    summed over "model" on every rank."""
    from repro_torch.training.optimizer import tree_leaves, tree_map
    bx = batch_axes(mesh)
    if not split or axis_size(mesh, bx) == 1:
        return grads
    leaves = tree_leaves(grads)
    flat = all_reduce(torch.cat([g.reshape(-1) for g in leaves]), bx, mesh)
    parts = iter(torch.split(flat, [g.numel() for g in leaves]))
    return tree_map(lambda g: next(parts).view(g.shape), grads)


class FSDPWeight(NamedTuple):
    """A weight leaf cut over "data" (``fsdp_tp``) in a step with a
    gradient: ``shard`` this rank's block, cut along ``dim``.  A gathered
    leaf a product saved for its backward would stay alive until the
    backward (qwen1.5-110b at ``(2, 2)``: ~1.36 GB a layer a card, ~109 GB
    over 80 layers), so ``matmul`` gathers it for the product, keeps only
    the shard, and gathers it again in the backward.  An int8 leaf
    (``models.quant``) is its int8 payload ``shard`` with its fp32
    ``scale`` (cut over "data" along ``scale_dim``, or None where the
    scales span the cut axis, which then holds one scale row), dequantized
    to ``dtype`` after each gather: the saved tensors are the int8 shard
    and its scales."""
    shard: torch.Tensor
    dim: int
    mesh: Mesh
    scale: Optional[torch.Tensor] = None
    scale_dim: Optional[int] = None
    dtype: Optional[torch.dtype] = None

    @property
    def shape(self) -> torch.Size:
        s = list(self.shard.shape)
        s[self.dim] *= self.mesh.shape["data"]
        return torch.Size(s)

    @property
    def T(self) -> "FSDPWeight":
        flip = lambda d: None if d is None else 1 - d
        return self._replace(
            shard=self.shard.T, dim=1 - self.dim,
            scale=None if self.scale is None else self.scale.T,
            scale_dim=flip(self.scale_dim))

    def whole(self) -> torch.Tensor:
        w = all_gather(self.shard, "data", self.mesh, dim=self.dim)
        if self.scale is None:
            return w
        s = self.scale if self.scale_dim is None else all_gather(
            self.scale, "data", self.mesh, dim=self.scale_dim)
        return dequant_leaf({"_q8": w, "_qs": s}, self.dtype)


class _FSDPMatmul(torch.autograd.Function):
    """``y = x @ W``, ``W`` gathered over "data" from ``shard`` (an int8
    leaf's ``scale`` gathered beside it and the two dequantized); saves the
    shard and its scales alone.  Adjoint: ``dx = dy @ W^T`` with ``W``
    gathered (and dequantized) again (the weight takes no gradient).  Every
    rank builds the same graph, so the ranks of a data group reach their
    backward gathers in the same order and the gathers pair up."""

    @staticmethod
    def forward(ctx, x, shard, scale, layout):
        ctx.layout = layout
        ctx.save_for_backward(shard, scale)
        return x @ layout._replace(shard=shard, scale=scale).whole()

    @staticmethod
    def backward(ctx, dy):
        shard, scale = ctx.saved_tensors
        w = ctx.layout._replace(shard=shard, scale=scale).whole()
        return dy @ w.mT, None, None, None


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a weight tensor or an ``FSDPWeight``."""
    if not isinstance(w, FSDPWeight):
        return x @ w
    if not _carries_grad(x):
        return x @ w.whole()
    return _FSDPMatmul.apply(x, w.shard, w.scale,
                             w._replace(shard=None, scale=None))


# ---------------------------------------------------------------------------
# the cache's rows under a data axis
# ---------------------------------------------------------------------------

def cache_rows(n_rows: int, segments, mesh: Mesh) -> list:
    """The global cache rows this rank holds, in local order.  ``segments``:
    the buckets' row counts in the cache's order (dense rows: the decode
    bucket's ``Bd`` rows, then the prefill bucket's ``Bp``); the rows past
    them are one more segment.  A segment that divides the batch axes
    gives this rank its block of it, as the forward splits that bucket;
    any other is held whole by every data rank.  With one segment (a
    cache whose rows are one bucket's, as when a prefill's rows then
    decode) this is the contiguous block of ``cache_shardings``."""
    bx = batch_axes(mesh)
    n, i = axis_size(mesh, bx), mesh.index(bx)
    segs = [int(s) for s in segments or ()]
    if sum(segs) < n_rows:
        segs.append(n_rows - sum(segs))
    rows, o = [], 0
    for s in segs:
        if s % n == 0:
            rows.extend(range(o + i * (s // n), o + (i + 1) * (s // n)))
        else:
            rows.extend(range(o, o + s))
        o += s
    return rows


def _model_spec(cfg: ModelConfig, cache: Dict, mesh: Mesh,
                strategy: str = "auto") -> Dict:
    """``cache_shardings`` under ``strategy`` with the rows left to
    ``cache_rows``."""
    specs = cache_shardings(cfg, cache, mesh, strategy)
    return {k: tuple(None if d == 1 else e for d, e in enumerate(sp))
            for k, sp in specs.items()}


def shard_cache(cfg: ModelConfig, cache: Dict, mesh: Mesh,
                segments=None, strategy: str = "auto") -> Dict:
    """This rank's shard of a whole dense-row cache: its ``cache_rows`` and
    its block of the "model" axis as ``cache_shardings(..., strategy)``
    says: ``k``/``v``/``xk``/``xv`` by ``kv_layout`` (the KV heads, else
    the head dim, else the slots; under ``strategy="seq"`` the slots
    first), MLA's latent ``ckv`` / ``kpe`` by the slots under both.  A
    leaf the rule would leave whole under a model axis > 1 (MLA's slots, or
    a GQA leaf whose heads, head dim and slots all fail to divide it)
    raises a ``ValueError``: the sharded forward reads every such leaf
    cut."""
    m = mesh.shape["model"]
    for k in ("ckv", "kpe"):
        if k in cache and cache[k].shape[2] % m:
            raise ValueError(f"MLA's latent rows of {cache[k].shape[2]} "
                             f"slots do not divide the model axis {m}")
    for k in ("k", "v", "xk", "xv"):
        if k in cache and kv_layout(cfg, cache[k].shape[2],
                                    cache[k].shape[4], m, strategy) is None:
            raise ValueError(
                f"{k} rows [.., {cache[k].shape[2]}, {cfg.n_kv_heads}, "
                f"{cache[k].shape[4]}]: neither the KV heads, the head dim "
                f"nor the slots divide the model axis {m}")
    specs = _model_spec(cfg, cache, mesh, strategy)
    out = {}
    for k, x in cache.items():
        rows = torch.tensor(cache_rows(x.shape[1], segments, mesh),
                            device=x.device)
        out[k] = local_shard(x.index_select(1, rows), specs[k], mesh)
    return out


def _shard_spec(cfg: ModelConfig, key: str, x: torch.Tensor, mesh: Mesh,
                strategy: str) -> Spec:
    """The "model" part of the spec of this rank's shard ``x`` of leaf
    ``key``, read from the shard (``shard_layout``; MLA's latent: the
    slots; Mamba's ``h`` / ``conv_x``: cut where the shard holds fewer SSM
    heads / d_inner channels than the model, ``conv_bc`` whole), the rows
    left to ``cache_rows``."""
    dims = [None] * x.ndim
    if mesh.shape["model"] > 1:
        if key in ("k", "v", "xk", "xv"):
            dims[LAYOUT_DIM[shard_layout(cfg, key, x.shape, mesh,
                                         strategy)]] = "model"
        elif key in ("ckv", "kpe"):
            dims[2] = "model"
        elif key == "h" and x.shape[2] < cfg.n_ssm_heads:
            dims[2] = "model"
        elif key == "conv_x" and x.shape[3] < cfg.d_inner:
            dims[3] = "model"
    return tuple(dims)


def gather_cache(cfg: ModelConfig, cache: Dict, mesh: Mesh, n_rows: int,
                 segments=None, strategy: str = "auto") -> Dict:
    """The whole cache from every rank's ``shard_cache(..., strategy)``
    block; a block of the other layout raises (``shard_layout``)."""
    bx = batch_axes(mesh)
    n = axis_size(mesh, bx)
    specs = {k: _shard_spec(cfg, k, x, mesh, strategy)
             for k, x in cache.items()}
    out = {}
    for k, x in cache.items():
        x = gather(x, specs[k], mesh)
        per = x.shape[1]
        x = all_gather(x, bx, mesh, dim=1)          # [L, n * per, ...]
        held = {}
        for d in range(n):
            probe = Mesh(mesh.devices_shape, mesh.axis_names,
                         _rank_with(mesh, bx, d))
            for j, r in enumerate(cache_rows(n_rows, segments, probe)):
                held.setdefault(r, d * per + j)
        idx = torch.tensor([held[r] for r in range(n_rows)],
                           device=x.device)
        out[k] = x.index_select(1, idx)
    return out


def _rank_with(mesh: Mesh, axes, index: int) -> int:
    """A rank whose index along ``axes`` is ``index`` (the others' at this
    rank's)."""
    for r in range(mesh.size):
        probe = Mesh(mesh.devices_shape, mesh.axis_names, r)
        if probe.index(axes) == index and all(
                probe.coords[a] == mesh.coords[a]
                for a in mesh.axis_names if a not in axes):
            return r
    raise ValueError(f"no rank at {axes} = {index}")
