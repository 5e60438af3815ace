"""BGMV — per-token gathered multi-LoRA multiplication, CUDA kernel and
wrapper (the decode bucket of every projection).

Replaces the Pallas kernel ``repro/kernels/bgmv.py:30`` (``bgmv``; body
``_bgmv_kernel`` :20, ``pallas_call`` :51)::

    y[t] = scale[t] * (x[t] @ A[ids[t]]) @ B[ids[t]]

Bound on an H100 SXM: every token may name its own adapter, so each reads
x[t], an A [d_in, r] and a B [r, d_out] and writes y[t]; at decode batch
sizes that is ~2 FLOPs per weight byte, so memory bandwidth (3.35 TB/s)
bounds it.

Design (``csrc/bgmv.cu``): the TPU grid (T, d_out / bo) recomputes the shrink
once per output tile; here it is computed once per token.  A shrink launch
splits d_in over ``n_split`` blocks per token (enough blocks to keep the SMs
busy at T = 8), each writing fp32 partials [T, n_split, r] (no atomics, a
fixed sum order); an expand launch sums the partials, scales, and writes one
output column per thread, masked at the d_out edge.  Tokens with scale 0
write zeros.  Both launches count as one BGMV launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P, require
from repro_torch.kernels.ref import bgmv_ref as bgmv_plain

_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
MAX_RANK = 64
SPLIT_CHUNK = 1024      # d_in elements per shrink block


def n_split(d_in: int) -> int:
    return max(1, min(32, -(-d_in // SPLIT_CHUNK)))


def bgmv(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         ids: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x: [T, d_in]; a: [n, d_in, r]; b: [n, r, d_out] (same dtype as x);
    ids: [T] int32; scale: [T] float32 (0 disables a token).  Returns
    [T, d_out] in x's dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return bgmv_plain(x, a, b, ids, scale)
    require(x.device.type == "cuda", f"no BGMV kernel for {x.device}")
    T, d_in = x.shape
    n, d_in_a, r = a.shape
    d_out = b.shape[-1]
    require(d_in_a == d_in and b.shape == (n, r, d_out),
            f"bgmv shapes x{tuple(x.shape)} a{tuple(a.shape)} "
            f"b{tuple(b.shape)}")
    require(a.dtype == x.dtype and b.dtype == x.dtype,
            "bgmv takes x, a and b in one dtype")
    require(0 < r <= MAX_RANK, f"rank {r} outside [1, {MAX_RANK}]")
    require(ids.dtype == torch.int32 and ids.shape == (T,),
            "ids must be int32 [T]")
    require(scale.dtype == torch.float32 and scale.shape == (T,),
            "scale must be float32 [T]")
    build.check_cuda(x, a, b, ids, scale)
    ns = n_split(d_in)
    part = torch.empty((T, ns, r), dtype=torch.float32, device=x.device)
    out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    fn = build.function("bgmv", "bgmv_launch", _ARGS)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
             scale.data_ptr(), part.data_ptr(), out.data_ptr(), T, n, d_in,
             r, d_out, ns, build.dtype_code(x), build.stream_of(x))
    build.check(err, "bgmv")
    bgmv.launches += 1
    return out


bgmv.launches = 0
