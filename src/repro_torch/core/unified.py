"""Step builders: the unit the runtime executes each tick.

All steps share the same unified forward (paper Section 3.3); the training
steps differentiate it with respect to the LoRA bank only. PyTorch runs
eagerly, so the JAX package's jitted step cache has no counterpart: each
``make_*_step`` returns a plain closure over the config and the planner's
SMLM tile. The forward step runs under ``torch.inference_mode``; the grad
step makes detached copies of the bank's tensors its autograd leaves and
calls ``torch.autograd.grad``, so nothing it builds outlives the tick. The
scalar loss reads only fine-tune rows, so the prefill and decode rows'
gradients are zero, and the model runs their attention and cache writes
outside the graph (what XLA prunes in the JAX package). Nothing keys on
``kernels.autotune.table_version()``: the model asks for its split choice on
every forward.

The grad and train steps take a mesh as the forward step does (JAX's
``make_grad_step`` / ``make_train_step`` under the dryrun's mesh): the same
sharded forward under autograd (``distributed.sharding``'s collectives with
gradients), the bank's gradients summed over the batch axes where the ft
bucket was split (``sharding.reduce_bank_grads``), and AdamW on this rank's
shards.  Every step takes ``remat`` as JAX's does: with a gradient each
layer period is recomputed in the backward (``models.model._run_periods``;
the forward step has none, so there it changes nothing).  The train step
also takes ``act_constraint`` (``sharding.act_constraint_fn(mesh)``): under
its mesh the carry between periods is cut by tokens, so a rematerialised
period saves a rank's block of it; without a mesh it is the identity.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models.configs import ModelConfig
from repro_torch.models.model import unified_forward
from repro_torch.models.stream import ModelOut, UnifiedBatch
from repro_torch.training.optimizer import AdamWConfig, AdamWState, \
    adamw_apply, tree_leaves, tree_map


def scalar_loss(out: ModelOut, batch: UnifiedBatch) -> torch.Tensor:
    """Algorithm 2: per-row mean CE, scaled by the row weight (which encodes
    1/accumulation-steps per trainer), summed: one shared backward."""
    loss = out.aux_loss
    if out.ft_loss_sum is not None:
        per_row = out.ft_loss_sum / torch.clamp(out.ft_tok_count, min=1.0)
        loss = loss + torch.sum(per_row * batch.ft.weight)
    return loss


class StepOut(NamedTuple):
    out: ModelOut
    loss: torch.Tensor
    grads: Optional[Any]


def make_forward_step(cfg: ModelConfig, *, block_t: int, mesh=None,
                      strategy: str = "tp", cache_strategy: str = "auto",
                      remat: bool = False, attn_chunk: int = 0,
                      return_ft_logits: bool = False) -> Callable:
    """Inference-only unified step (serve/prefill/decode/eval).  With a
    ``mesh`` (``launch.mesh.init_mesh``) the step runs on one rank of it:
    ``base`` and ``bank`` are this rank's shards (``checkpoint.io.
    shard_params(..., strategy)`` / ``shard_bank``), ``batch`` the whole
    ``UnifiedBatch`` and ``cache`` this rank's shard
    (``distributed.sharding.shard_cache(..., strategy=cache_strategy)``:
    ``"auto"`` or ``"seq"``, the layouts of JAX dryrun's
    ``cache_strategy``; a shard of the other layout raises); it returns the
    single-device step's logits, ft loss sums and aux loss on every rank,
    and the local cache.  Any mesh takes that sharded path; on a mesh whose
    axes are all 1 every collective is the identity.  ``remat`` is taken
    as JAX's step takes it; under ``inference_mode`` it changes nothing."""
    _check(cache_strategy)

    def step(base, bank, scale, batch: UnifiedBatch, cache) -> ModelOut:
        with torch.inference_mode(), _scope(mesh, strategy, cache_strategy):
            return unified_forward(cfg, base, batch, cache, loras=bank,
                                   lora_scale=scale, block_t=block_t,
                                   attn_chunk=attn_chunk,
                                   return_ft_logits=return_ft_logits,
                                   remat=remat)

    return step


def _detached(out: ModelOut) -> ModelOut:
    return ModelOut(*(v.detach() if isinstance(v, torch.Tensor) else v
                      for v in out))


def _check(cache_strategy: str) -> None:
    from repro_torch.distributed.sharding import CACHE_STRATEGIES
    if cache_strategy not in CACHE_STRATEGIES:
        raise ValueError(f"cache_strategy {cache_strategy!r}: one of "
                         f"{CACHE_STRATEGIES}")


def _scope(mesh, strategy: str, cache_strategy: str):
    """The step's ambient mesh (``sharding.mesh_context``), if any."""
    from repro_torch.distributed.sharding import mesh_context
    return (contextlib.nullcontext() if mesh is None
            else mesh_context(mesh, strategy, cache_strategy))


def _value_and_grad(cfg: ModelConfig, block_t: int, attn_chunk: int,
                    base, bank, scale, batch: UnifiedBatch, cache,
                    mesh=None, strategy: str = "tp",
                    cache_strategy: str = "auto", remat: bool = False,
                    act_constraint=None):
    """Forward under autograd with the bank's tensors as leaves, then the
    loss's gradient with respect to every leaf (zeros where a leaf is not
    reached), in the bank's tree shape; under a ``mesh`` this rank's
    shards of the whole step's gradients.  ``remat`` and
    ``act_constraint`` go to ``unified_forward``."""
    with torch.enable_grad(), _scope(mesh, strategy, cache_strategy):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), bank)
        out = unified_forward(cfg, base, batch, cache, loras=leaves,
                              lora_scale=scale, block_t=block_t,
                              attn_chunk=attn_chunk, remat=remat,
                              act_constraint=act_constraint)
        loss = scalar_loss(out, batch)
        got = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                       allow_unused=True))

    def grad_of(p):
        g = next(got)
        return torch.zeros_like(p) if g is None else g

    grads = tree_map(grad_of, leaves)
    if mesh is not None:
        from repro_torch.distributed import sharding as SH
        from repro_torch.models.model import local_batch
        split = local_batch(UnifiedBatch(ft=batch.ft), mesh)[1].get("ft")
        grads = SH.reduce_bank_grads(grads, mesh, bool(split))
    return _detached(out), loss.detach(), grads


def make_grad_step(cfg: ModelConfig, *, block_t: int, remat: bool = False,
                   attn_chunk: int = 0, mesh=None, strategy: str = "tp",
                   cache_strategy: str = "auto") -> Callable:
    """Unified step with gradients with respect to the LoRA bank (no
    update): the engine's accumulation loop.  With a ``mesh``, as
    ``make_forward_step``: ``base``, ``bank`` and ``cache`` are this rank's
    shards, ``batch`` the whole batch; it returns the single-device step's
    loss and outputs on every rank and this rank's shards of the grads.
    ``remat``: each layer period recomputed in the backward."""
    _check(cache_strategy)

    def step(base, bank, scale, batch: UnifiedBatch, cache) -> StepOut:
        out, loss, grads = _value_and_grad(cfg, block_t, attn_chunk, base,
                                           bank, scale, batch, cache, mesh,
                                           strategy, cache_strategy, remat)
        return StepOut(out=out, loss=loss, grads=grads)

    return step


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, *, block_t: int,
                    remat: bool = False, attn_chunk: int = 0,
                    act_constraint=None, mesh=None, strategy: str = "tp",
                    cache_strategy: str = "auto") -> Callable:
    """Fused fine-tuning step: unified forward + backward + masked AdamW.
    Returns ``(loss, new_bank, new_state, aux_loss)`` as the JAX step
    does.  With a ``mesh`` (``make_grad_step``'s), ``bank`` and
    ``opt_state`` are this rank's shards (``checkpoint.io.shard_bank`` /
    ``shard_opt_state``), and so are the new bank and state; the loss and
    aux loss are the single-device step's, on every rank.  ``remat`` as
    ``make_grad_step``'s; ``act_constraint``
    (``distributed.sharding.act_constraint_fn(mesh)``) cuts the carry
    between periods by tokens under ``mesh``, the identity without a
    mesh."""
    _check(cache_strategy)

    def step(base, bank, scale, opt_state: AdamWState, batch: UnifiedBatch,
             slot_mask, cache=None):
        out, loss, grads = _value_and_grad(cfg, block_t, attn_chunk, base,
                                           bank, scale, batch, cache, mesh,
                                           strategy, cache_strategy, remat,
                                           act_constraint)
        cut = None
        if mesh is not None:
            from repro_torch.distributed import sharding as SH
            cut = SH.cut_over_model(SH.bank_shardings(cfg, bank, mesh))
        new_bank, new_state = adamw_apply(opt, grads, opt_state, bank,
                                          slot_mask, mesh, cut)
        return loss, new_bank, new_state, out.aux_loss

    return step


def make_apply_step(opt: AdamWConfig) -> Callable:
    """Masked optimizer apply for accumulated gradients (engine path)."""

    def apply(grads, opt_state: AdamWState, bank, slot_mask):
        return adamw_apply(opt, grads, opt_state, bank, slot_mask)

    return apply
