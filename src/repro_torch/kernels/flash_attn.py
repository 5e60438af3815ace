"""Flash attention, CUDA kernel and wrapper (every cold prefill).

Replaces the Pallas kernel ``repro/kernels/flash_attn.py:67``
(``flash_attention``; body ``_flash_kernel`` :21, ``pallas_call`` :109):
GQA attention of q [B, S, h, hd] over contiguous k/v [B, T, g, hd], keys
valid for ``j < lengths[b]`` and, when causal, ``j <= i``; ``window > 0``
(causal only) adds ``i - j < window``, the sliding window that the JAX model
computes in plain ``L.attention(..., window=W)`` (its Pallas kernel has
none).  Rows at or past ``lengths[b]`` are computed as the Pallas kernel
computes them; a row with no valid key gives 0.

Bound on an H100 SXM: a causal prompt of n tokens needs about 4 * h * hd *
n^2 / 2 FLOPs over 2 * n * g * hd K/V elements, so from a few hundred
tokens on the operations (989 TFLOP/s in bf16 on the tensor cores) bound it,
not the bytes; with a window W < n, 4 * h * hd * W * (n - W / 2).

Design (``csrc/flash_attn.cu`` over ``csrc/tile_walk.cuh``, the walk of the
paged prefill kernel): one thread block per (KV head, request, query tile)
serves the group's h/g query heads x 64/(h/g) positions (rounded down;
rows past them are padding) from one read of each K/V tile.  The element
type picks the walk at compile time.  bf16 runs on the tensor cores: four
warps of 16 query rows, S = Q K^T and O += P V as ``mma.sync.m16n8k16``
products with fp32 accumulators fed by ``ldmatrix``,
64-key tiles (32 above hd 128) through a two-stage ring of 16-byte
``cp.async`` copies so that the copy of the next tile overlaps the math of
this one; the online softmax stays in fp32 registers and P is rounded to
bf16 only as the operand of P V.  fp32 keeps the CUDA-core walk (32-key
tiles staged as fp32), which holds the fp32 parity runs at 1e-4.  The
causal walk stops at the last tile the query tile can see, a windowed walk
starts at the first tile its first position can see (key tiles wholly below
every row's window are skipped), and only the tiles that straddle a limit
are masked; the longest query tiles launch first.
``wgmma`` (the card's full tensor-core rate) is later work.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import F, I, P, require
from repro_torch.kernels.prefill_attn import TILE_ROWS
from repro_torch.kernels.ref import flash_attention_ref as flash_plain

_ARGS = [P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    lengths: torch.Tensor, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q: [B, S, h, hd]; k/v: [B, T, g, hd]; lengths: [B] int32; ``window``
    > 0 (causal only): query ``i`` sees keys ``i - j < window``.  Returns
    [B, S, h, hd].  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    require(window >= 0 and (causal or window == 0),
            "a window needs causal attention")
    if q.device.type == "cpu":
        return flash_plain(q, k, v, lengths, causal, window)
    require(q.device.type == "cuda", f"no flash kernel for {q.device}")
    B, S, h, hd = q.shape
    _, T, g, hd_k = k.shape
    require(k.shape[0] == B and hd_k == hd and v.shape == k.shape,
            "k/v must be [B, T, g, hd]")
    require(k.dtype == q.dtype and v.dtype == q.dtype,
            "q, k and v must share a dtype")
    require(h % g == 0 and h // g <= TILE_ROWS,
            f"need h % g == 0 and h / g <= {TILE_ROWS}")
    require(hd % 32 == 0 and hd <= 256, "head dim must be 32k <= 256")
    require(lengths.dtype == torch.int32 and lengths.shape == (B,),
            "lengths must be int32 [B]")
    build.check_cuda(q, k, v, lengths)
    build.check_vectors(q, k, v)
    out = torch.empty_like(q)
    fn = build.function("flash_attn", "flash_attention_launch", _ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), B, S, T, h, g, hd, int(bool(causal)),
             int(window), hd ** -0.5, build.dtype_code(q),
             build.stream_of(q))
    build.check(err, "flash_attn")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
