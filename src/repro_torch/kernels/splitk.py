"""Split-K (flash-decoding) paged attention: CUDA partial and merge kernels
and the decode / verify wrappers.

Replaces the Pallas kernel ``repro/kernels/splitk.py:107``
(``paged_verify_attention_splitk``; body ``_splitk_kernel`` :64,
``pallas_call`` :166; ``paged_decode_attention_splitk`` :180) and its jnp
epilogue ``lse_merge`` (:40).  Same contracts: the block walk of every
request is cut into ``num_splits`` independent runs of ``npb = ceil(nbt /
num_splits)`` table entries (the table padded with null entries), each
giving an un-normalized fp32 partial ``(acc, m, l)``, which the merge
combines with log-sum-exp weights.  ``num_splits`` comes from
``kernels.autotune.choose``.

Bound on an H100 SXM: the same bytes as the sequential walk (K/V rows of
keys ``0 .. pos + lens - 1``), so memory bandwidth; the split only buys
parallelism when ``B * g`` thread blocks cannot fill the 132 SMs (long
context, small batch).  The fp32 partials are the kernel's choice, not the
function's need.

Design (``csrc/splitk.cu``): grid (request, KV head, split), B * g * ns
thread blocks (the model keys its split choice on that count, ``Bd *
n_kv_heads``, and on the card takes it from ``autotune``'s measured table),
each walking its run as the verify kernel walks the whole table: every
query row of the group (h/g heads x Sq) in one thread block, so each K/V
block is read once, streaming through a ring of 16-byte ``cp.async``
copies; bf16 on the tensor-core walk of ``csrc/tile_walk.cuh``, fp32 on the
CUDA-core walk of ``csrc/paged_walk.cuh``.  Runs past the block holding key
``pos + lens - 1`` stop at once and write ``(0, NEG_INF, 0)``.  A second launch merges,
one warp per (request, chunk row, query head): folding it into the last run
would need a counter reset per call for a pass of a few microseconds.  The
merge could be plain tensor code, as in the JAX package, but the decode
tick is host-bound and six eager ops per layer would add to it.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P, require
from repro_torch.kernels.ref import lse_merge as lse_merge_plain
from repro_torch.kernels.ref import \
    splitk_partials_ref as splitk_partials_plain
from repro_torch.kernels.verify_attn import check_chunk_args

_PART_ARGS = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]
_MERGE_ARGS = [P, P, P, P, I, I, I, I, I, P]


def splitk_partials(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_tables: torch.Tensor,
                    pos: torch.Tensor, lens: torch.Tensor, num_splits: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q: [B, Sq, h, hd]; pools [n_blocks, bs, g, hd]; tables [B, nbt]
    int32; pos/lens [B] int32.  Returns fp32 ``(acc [B, ns, Sq, h, hd],
    m [B, ns, Sq, h], l [B, ns, Sq, h])``.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    ns = max(1, int(num_splits))
    if q.device.type == "cpu":
        return splitk_partials_plain(q, k_pool, v_pool, block_tables, pos,
                                     lens, ns)
    require(q.device.type == "cuda", f"no split-K kernel for {q.device}")
    check_chunk_args(q, k_pool, v_pool, block_tables, pos, lens)
    B, Sq, h, hd = q.shape
    _, bs, g, _ = k_pool.shape
    o = torch.empty((B, ns, Sq, h, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, ns, Sq, h), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = build.function("splitk", "splitk_partials_launch", _PART_ARGS)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), pos.data_ptr(), lens.data_ptr(),
             o.data_ptr(), m.data_ptr(), l.data_ptr(), B, Sq, h, g, hd, bs,
             block_tables.shape[1], ns, hd ** -0.5, build.dtype_code(q),
             build.stream_of(q))
    build.check(err, "splitk")
    splitk_partials.launches += 1
    splitk_partials.shapes[(Sq, ns)] += 1
    return o, m, l


def lse_merge(o_part: torch.Tensor, m_part: torch.Tensor,
              l_part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Combine split-K partials (fp32, layouts of ``splitk_partials``) into
    ``[B, Sq, h, hd]`` of ``dtype``.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if o_part.device.type == "cpu":
        return lse_merge_plain(o_part, m_part, l_part).to(dtype)
    require(o_part.device.type == "cuda",
            f"no merge kernel for {o_part.device}")
    B, ns, Sq, h, hd = o_part.shape
    for t in (o_part, m_part, l_part):
        require(t.dtype == torch.float32, "partials must be fp32")
    require(m_part.shape == (B, ns, Sq, h) and l_part.shape == m_part.shape,
            "m/l partials must be [B, ns, Sq, h]")
    require(hd % 32 == 0 and hd <= 256, "head dim must be 32k <= 256")
    build.check_cuda(o_part, m_part, l_part)
    out = torch.empty((B, Sq, h, hd), dtype=dtype, device=o_part.device)
    code = build.DTYPE_CODE.get(dtype)
    require(code is not None, f"merge writes float32 or bfloat16, not {dtype}")
    fn = build.function("splitk", "lse_merge_launch", _MERGE_ARGS)
    err = fn(o_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
             out.data_ptr(), B, ns, Sq * h, hd, code,
             build.stream_of(o_part))
    build.check(err, "splitk")
    lse_merge.launches += 1
    return out


def _splitk(q, k_pool, v_pool, block_tables, pos, lens, num_splits):
    o, m, l = splitk_partials(q, k_pool, v_pool, block_tables, pos, lens,
                              num_splits)
    return lse_merge(o, m, l, q.dtype)


def paged_verify_attention_splitk(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  pos: torch.Tensor, lens: torch.Tensor, *,
                                  num_splits: int = 4) -> torch.Tensor:
    """Split-K verify attention, the contract of
    ``verify_attn.paged_verify_attention``: q [B, Sq, h, hd] -> [B, Sq, h,
    hd].  ``num_splits`` may exceed ``nbt``: surplus runs read only null
    entries and give empty partials."""
    return _splitk(q, k_pool, v_pool, block_tables, pos, lens, num_splits)


def paged_decode_attention_splitk(q: torch.Tensor, k_pool: torch.Tensor,
                                  v_pool: torch.Tensor,
                                  block_tables: torch.Tensor,
                                  pos: torch.Tensor, *,
                                  num_splits: int = 4,
                                  lens: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Split-K decode attention: the ``Sq = 1, lens = 1`` verify case, the
    contract of ``decode_attn.paged_decode_attention``: q [B, h, hd] ->
    [B, h, hd].  ``lens`` [B] int32 (1 for a live row) spares the model a
    fresh tensor per layer; ones when omitted."""
    if lens is None:
        lens = torch.ones_like(pos)
    return _splitk(q[:, None], k_pool, v_pool, block_tables, pos, lens,
                   num_splits)[:, 0]


splitk_partials.launches = 0
# launches by (Sq, num_splits): Sq == 1 is a decode walk, Sq > 1 a verify one
splitk_partials.shapes = Counter()
lse_merge.launches = 0
