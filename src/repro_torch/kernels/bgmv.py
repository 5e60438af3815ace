"""BGMV — per-token gathered multi-LoRA multiplication, CUDA kernel and
wrapper (the decode and verify tail of every projection).

Replaces the Pallas kernel ``repro/kernels/bgmv.py:30`` (``bgmv``; body
``_bgmv_kernel`` :20, ``pallas_call`` :51)::

    y[t] = scale[t] * (x[t] @ A[ids[t]]) @ B[ids[t]]

Bound on an H100 SXM: latency.  A decode tick's call (T = 8 tokens over a
few adapters) moves about 1.5 MB, under half a microsecond of the card's
bytes, so the launches and the chain of dependent loads set its time.

Design (``csrc/bgmv.cu``), two launches.  The shrink splits d_in over ns
blocks a group of 8 tokens (one warp a token, 16-byte loads of x and A)
into fp32 partials [ns, T, RP]; above 16 tokens clusters of 8 blocks sum theirs on
chip first, since every expand block reads every token's partials.  The
expand, a programmatic dependent of the shrink, gives each block 64
columns of d_out for all tokens: it lists the adapters its tokens use (a
token with scale 0 or an id outside ``[0, n)`` writes exact zeros), copies
each one's B slice into shared memory once while the shrink still runs,
then sums each token's partials in order, scales them (x @ A stays fp32)
and applies the slice to every token that names the adapter, with 16-byte
stores.  No atomics, so two calls give the same bits.  Both launches count
as one BGMV launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import I, P, require
from repro_torch.kernels.ref import bgmv_ref as bgmv_plain

_ARGS = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
MAX_RANK = 64
MAX_SLOTS = 1024        # adapters the kernel lists per block
SPLIT_CHUNK = 128       # d_in a shrink block reduces for few tokens
MAX_SPLITS = 32         # most shrink blocks a group of 8 tokens
CLUSTER = 8             # shrink blocks whose partials are summed on chip
CLUSTER_T = 16          # ... above this many tokens


def n_split(d_in: int, T: int) -> int:
    """The shrink's slices of d_in.  Up to ``CLUSTER_T`` tokens: slices of
    ``SPLIT_CHUNK`` elements, at most ``MAX_SPLITS``.  Above, the slices
    form clusters of ``CLUSTER`` whose partials are summed on chip: one
    cluster, or two from d_in 2048 (``chip_smoke.py --bgmv-splits`` times
    8, 16 and 32 slices at the serving shapes on a card)."""
    if T > CLUSTER_T:
        return CLUSTER * max(1, min(2, -(-d_in // 2048)))
    return max(1, min(MAX_SPLITS, -(-d_in // SPLIT_CHUNK)))


def padded_rank(r: int) -> int:
    """The rank the kernel computes with: r rounded up to 4, 8, 16, 32 or
    64."""
    return next(p for p in (4, 8, 16, 32, 64) if p >= r)


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
    require(0 < n <= MAX_SLOTS, f"{n} adapter slots outside [1, {MAX_SLOTS}]")
    require(ids.dtype == torch.int32 and ids.shape == (T,),
            "ids must be int32 [T]")
    require(scale.dtype == torch.float32 and scale.shape == (T,),
            "scale must be float32 [T]")
    build.check_cuda(x, a, b, ids, scale)
    ns = n_split(d_in, T)
    part = torch.empty(ns * T * padded_rank(r),
                       dtype=torch.float32, device=x.device)
    out = torch.empty((T, d_out), dtype=x.dtype, device=x.device)
    fn = build.function("bgmv", "bgmv_launch", _ARGS)
    err = fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
             scale.data_ptr(), part.data_ptr(), out.data_ptr(), T, n, d_in,
             r, d_out, ns, build.dtype_code(x), build.stream_of(x))
    build.check(err, "bgmv")
    bgmv.launches += 1
    return out


bgmv.launches = 0
