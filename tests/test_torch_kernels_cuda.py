"""The port's CUDA kernels vs their plain PyTorch versions on the card
(``cuda`` marker; each test skips without an NVIDIA GPU, since a CUDA kernel
has no CPU mode).  Imports no JAX, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerance: fp32 within 1e-4 and bf16 within 2e-2 of max(1, largest plain
output): bf16 rounds the output once; fp32 sums in another order.  The SMLM
and paged decode cases hold each row (last axis) to its own max |plain|
instead, with the same factors (``_close_rows``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.bgmv import bgmv, bgmv_expand, bgmv_shrink
from repro_torch.kernels.decode_attn import (decode_attention,
                                             paged_decode_attention)
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.prefill_attn import paged_prefill_attention
from repro_torch.kernels.smlm import SMLMFunction, smlm, smlm_expand, \
    smlm_shrink, smlm_wgrad
from repro_torch.kernels.splitk import (lse_merge,
                                        paged_decode_attention_splitk,
                                        paged_verify_attention_splitk,
                                        splitk_partials)
from repro_torch.kernels.verify_attn import paged_verify_attention


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# the crossover of the bf16 verify and prefill kernels (query columns)
SPLIT_COLS = int(re.search(
    r"SW_SPLIT_COLS = (\d+);",
    (Path(ref.__file__).parent / "csrc" / "split_walk.cuh").read_text())[1])
# paged prefill suffixes (Sq, h/g): the longest of the split walk, one
# position more, and groups of the split walk that begin inside a position;
# at h/g = 5 (llama4-maverick: 12 positions and 4 padding rows a query
# tile) the same crossover and a suffix of several ragged tiles
PREFILL_CASES = [(SPLIT_COLS, 1), (SPLIT_COLS + 1, 1), (SPLIT_COLS // 4, 4),
                 (SPLIT_COLS // 4 + 1, 4), (25, 4), (SPLIT_COLS // 5, 5),
                 (SPLIT_COLS // 5 + 1, 5), (97, 5)]


def _lora_inputs(rng, T, d, r, n, o):
    x = rng.standard_normal((T, d), dtype=np.float32)
    a = rng.standard_normal((n, d, r), dtype=np.float32) * 0.3
    b = rng.standard_normal((n, r, o), dtype=np.float32) * 0.3
    return x, a, b


def _paged_inputs(rng, B, g, hd, bs, nbt, need):
    n_blocks = nbt * B + 2
    kp = rng.standard_normal((n_blocks, bs, g, hd), dtype=np.float32)
    vp = rng.standard_normal((n_blocks, bs, g, hd), dtype=np.float32)
    tables = np.zeros((B, nbt), np.int32)
    for b in range(B):
        k = min(need[b], nbt)
        tables[b, :k] = rng.choice(np.arange(1, n_blocks), size=k,
                                   replace=False)
    return kp, vp, tables


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _close(y, plain, dtype):
    y, plain = y.float().cpu(), plain.float().cpu()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(y).all()
    err = float((y - plain).abs().max())
    assert err <= tol * max(1.0, float(plain.abs().max()))


def _close_rows(y, plain, dtype):
    """Each row (last axis) within 1e-4 (fp32) / 2e-2 (bf16) of its own max
    |plain|: an all-zero plain row must come out exactly 0."""
    y = y.float().cpu().reshape(-1, y.shape[-1])
    plain = plain.float().cpu().reshape(-1, plain.shape[-1])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.isfinite(y).all()
    err = (y - plain).abs().amax(-1)
    lim = tol * plain.abs().amax(-1)
    bad = torch.nonzero(err > lim).flatten()
    assert bad.numel() == 0, (
        f"{bad.numel()} rows over the limit, first {int(bad[0])}: "
        f"{float(err[bad[0]]):.3e} > {float(lim[bad[0]]):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_smlm_and_bgmv_match_plain(dtype):
    dev = _card()
    rng = np.random.default_rng(3)
    n, d, r, o, bt = 4, 512, 8, 300, 16        # ragged d_out edge
    x, a, b = (v.to(dev, dtype) for v in map(t, _lora_inputs(rng, 64, d, r,
                                                             n, o)))
    tile_ids = t(rng.integers(-1, n + 1, 64 // bt).astype(np.int32)).to(dev)
    rt = ops.route(torch.repeat_interleave(tile_ids, bt)[:56].contiguous(),
                   None, n, n_head=48, block_t=bt)
    y = smlm(x[:48], a, b, rt.tile_ids, rt.tile_scale, block_t=bt)
    _close(y, ref.smlm_ref(x[:48], a, b, rt.tile_ids, rt.tile_scale, bt),
           dtype)
    y = bgmv(x[48:56], a, b, rt.tail_ids, rt.tail_scale)
    _close(y, ref.bgmv_ref(x[48:56], a, b, rt.tail_ids, rt.tail_scale),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [300, 1024])
def test_cuda_split_shrink_and_expand_match_plain_and_fused(dtype, o):
    """SMLM's and BGMV's split entries against their plain versions and the
    fused calls: the split shrink within the table's tolerance of the plain
    fp32 shrink; the shrink over two halves of d_in, summed (what the
    model-axis all-reduce does), then expanded over two halves of d_out,
    within the tolerance of the plain whole call; SMLM's split expand of
    the whole shrink bit-equal to the fused call (the same device code);
    BGMV's within the tolerance (its split shrink sums its slices in
    another grouping than the fused call)."""
    dev = _card()
    rng = np.random.default_rng(5)
    n, d, r, bt, T = 4, 512, 8, 16, 64
    x, a, b = (v.to(dev, dtype) for v in map(t, _lora_inputs(rng, T, d, r,
                                                             n, o)))
    tile_ids = t(rng.integers(-1, n + 1, T // bt).astype(np.int32)).to(dev)
    ids = torch.repeat_interleave(tile_ids, bt)[:56].contiguous()
    rt = ops.route(ids, None, n, n_head=48, block_t=bt)
    h, c = d // 2, o // 2
    halves = lambda v: (v[..., :h].contiguous(), v[..., h:].contiguous())
    x0, x1 = halves(x)
    a0, a1 = (a[:, :h].contiguous(), a[:, h:].contiguous())
    b0, b1 = (b[..., :c].contiguous(), b[..., c:].contiguous())
    # SMLM on the head
    args = (rt.tile_ids, rt.tile_scale)
    s = smlm_shrink(x[:48], a, *args, block_t=bt)
    _close_rows(s, ref.smlm_shrink_ref(x[:48], a, *args, bt), dtype)
    fused = smlm(x[:48], a, b, *args, block_t=bt)
    assert torch.equal(smlm_expand(s, b, *args, block_t=bt), fused)
    s2 = smlm_shrink(x0[:48], a0, *args, block_t=bt) \
        + smlm_shrink(x1[:48], a1, *args, block_t=bt)
    y = torch.cat([smlm_expand(s2, b0, *args, block_t=bt),
                   smlm_expand(s2, b1, *args, block_t=bt)], 1)
    _close(y, ref.smlm_ref(x[:48], a, b, *args, bt), dtype)
    # BGMV on the tail
    args = (rt.tail_ids, rt.tail_scale)
    s = bgmv_shrink(x[48:56].contiguous(), a, *args)
    _close_rows(s, ref.bgmv_shrink_ref(x[48:56], a, *args), dtype)
    plain = ref.bgmv_ref(x[48:56], a, b, *args)
    _close(bgmv_expand(s, b, *args), plain, dtype)
    _close(bgmv(x[48:56].contiguous(), a, b, *args), plain, dtype)
    s2 = bgmv_shrink(x0[48:56].contiguous(), a0, *args) \
        + bgmv_shrink(x1[48:56].contiguous(), a1, *args)
    y = torch.cat([bgmv_expand(s2, b0, *args), bgmv_expand(s2, b1, *args)],
                  1)
    _close(y, plain, dtype)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_matches_plain(dtype):
    dev = _card()
    rng = np.random.default_rng(4)
    B, h, g, hd, bs, nbt, Sq = 4, 8, 2, 64, 32, 4, 20
    pos = np.array([0, 31, 64, 100], np.int32)
    kp, vp, tables = _paged_inputs(rng, B, g, hd, bs, nbt, pos // bs + 1)
    tables[0] = 0
    cuda = lambda x: t(x).to(dev)
    kpd, vpd = cuda(kp).to(dtype), cuda(vp).to(dtype)
    q = cuda(rng.standard_normal((B, h, hd), dtype=np.float32)).to(dtype)
    args = (q, kpd, vpd, cuda(tables), cuda(pos))
    _close(paged_decode_attention(*args), ref.paged_decode_ref(*args), dtype)
    cached = np.array([0, 0, 32, 60], np.int32)
    seg = np.array([0, 20, 7, 20], np.int32)
    qp = cuda(rng.standard_normal((B, Sq, h, hd), dtype=np.float32)
              ).to(dtype)
    args = (qp, kpd, vpd, cuda(tables), cuda(cached), cuda(seg))
    _close(paged_prefill_attention(*args), ref.paged_prefill_ref(*args),
           dtype)


def _chunk_case(rng, dev, dtype, B, Sq, h, g, hd, bs, nbt, pos, lens):
    """Pools and tables naming the blocks of keys 0 .. pos + lens - 1."""
    n_blocks = nbt * B + 2
    kp = rng.standard_normal((n_blocks, bs, g, hd), dtype=np.float32)
    vp = rng.standard_normal((n_blocks, bs, g, hd), dtype=np.float32)
    tables = np.zeros((B, nbt), np.int32)
    for b in range(B):
        need = -(-int(pos[b] + lens[b]) // bs)
        tables[b, :need] = rng.choice(np.arange(1, n_blocks), size=need,
                                      replace=False)
    q = rng.standard_normal((B, Sq, h, hd), dtype=np.float32)
    cuda = lambda x: t(x).to(dev)
    return (cuda(q).to(dtype), cuda(kp).to(dtype), cuda(vp).to(dtype),
            cuda(tables), cuda(pos.astype(np.int32)),
            cuda(lens.astype(np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_verify_matches_plain(dtype):
    """The serving verify shape (B=8, Sq=5, h=32, g=8, hd=128, bs=32,
    nbt=16): chunks straddling block edges, a partial chunk, a lens == 0
    row with a real table and an inactive row (both pos 0: exact 0)."""
    dev = _card()
    rng = np.random.default_rng(5)
    pos = np.array([0, 0, 30, 61, 100, 200, 300, 506])
    lens = np.array([0, 0, 5, 5, 2, 5, 1, 5])
    args = _chunk_case(rng, dev, dtype, 8, 5, 32, 8, 128, 32, 16, pos, lens)
    args[3][0] = 0
    args[3][1, 0] = 7                       # a real block, but lens 0
    y = paged_verify_attention(*args)
    _close(y, ref.paged_verify_ref(*args), dtype)
    assert float(y[:2].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [1, 2, 4, 8, 200])
def test_cuda_splitk_matches_plain(dtype, ns):
    """Long context (B=2, nbt=128, bs=32): split-K verify and decode, the
    partials and the merge each against their plain versions, ns above nbt
    included."""
    dev = _card()
    rng = np.random.default_rng(ns)
    pos, lens = np.array([3001, 2900]), np.array([5, 3])
    args = _chunk_case(rng, dev, dtype, 2, 5, 32, 8, 128, 32, 128, pos, lens)
    o, m, l = splitk_partials(*args, ns)
    po, pm, pl = ref.splitk_partials_ref(*args, ns)
    _close(o, po, dtype)
    _close(torch.exp(m - m.amax(1, keepdim=True)) * l,
           torch.exp(pm - pm.amax(1, keepdim=True)) * pl, dtype)
    _close(lse_merge(o, m, l, dtype), ref.lse_merge(o, m, l), dtype)
    _close(paged_verify_attention_splitk(*args, num_splits=ns),
           ref.paged_verify_ref(*args), dtype)
    q, kp, vp, tables, p, _ = args
    _close(paged_decode_attention_splitk(q[:, 0].contiguous(), kp, vp,
                                         tables, p, num_splits=ns),
           ref.paged_decode_ref(q[:, 0], kp, vp, tables, p), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_matches_plain(dtype, causal):
    """GQA h=32 over g=8, hd=128: ragged lengths with a 0 (exact zeros),
    rows past their length, S != T, a ragged last query and key tile."""
    dev = _card()
    rng = np.random.default_rng(6)
    B, S, T, h, g, hd = 4, 100, 77, 32, 8, 128
    q = rng.standard_normal((B, S, h, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    lens = np.array([0, 77, 40, 1], np.int32)
    cuda = lambda x: t(x).to(dev)
    args = (cuda(q).to(dtype), cuda(k).to(dtype), cuda(v).to(dtype),
            cuda(lens))
    y = flash_attention(*args, causal=causal)
    _close(y, ref.flash_attention_ref(*args, causal=causal), dtype)
    assert float(y[0].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 50, 200, 260])
@pytest.mark.parametrize("m,hd", [(1, 64), (1, 128), (4, 64), (4, 128),
                                  (8, 64), (8, 128)])
def test_cuda_windowed_flash_matches_plain(dtype, window, m, hd):
    """Sliding-window flash (causal, g = 2, h = 2m) against its plain
    version over S = T = 200, W = 0, < S, = S and > S: lengths 200, 77
    and 0; row 1's positions from 77 + W - 1 on see no key in their
    window and must be exact zeros, as the length-0 row is; with W = 50
    whole key tiles below a query tile's window are skipped."""
    dev = _card()
    rng = np.random.default_rng(200 + window + m + hd)
    B, S, g = 3, 200, 2
    h = m * g
    q = rng.standard_normal((B, S, h, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, g, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, g, hd), dtype=np.float32)
    lens = np.array([200, 77, 0], np.int32)
    cuda = lambda x: t(x).to(dev)
    args = (cuda(q).to(dtype), cuda(k).to(dtype), cuda(v).to(dtype),
            cuda(lens))
    y = flash_attention(*args, causal=True, window=window)
    _close(y, ref.flash_attention_ref(*args, causal=True, window=window),
           dtype)
    assert float(y[2].abs().max()) == 0.0
    if window:
        assert float(y[1, 77 + window - 1:].abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_windowed_flash_long_prompt(dtype):
    """One 1700-token prompt in a 2048 bucket at h = 32 over g = 8, hd =
    128, window 300: most query tiles start their walk past key tile 0,
    and the padding rows from 1999 on give exact zeros."""
    dev = _card()
    rng = np.random.default_rng(9)
    S, h, g, hd, window = 2048, 32, 8, 128, 300
    q = rng.standard_normal((1, S, h, hd), dtype=np.float32)
    k = rng.standard_normal((1, S, g, hd), dtype=np.float32)
    v = rng.standard_normal((1, S, g, hd), dtype=np.float32)
    cuda = lambda x: t(x).to(dev).to(dtype)
    args = (cuda(q), cuda(k), cuda(v),
            torch.tensor([1700], dtype=torch.int32, device=dev))
    y = flash_attention(*args, causal=True, window=window)
    _close(y, ref.flash_attention_ref(*args, causal=True, window=window,
                                      chunk=256), dtype)
    assert float(y[0, 1700 + window - 1:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,S", [(0, 512), (64, 64), (0, 40), (40, 40)])
def test_cuda_dense_decode_matches_plain(dtype, window, S):
    """Dense rows, linear (pos 0, tile edges, the last slot, and past the
    row once it would have wrapped) and rolling (pos below and far above
    S); S=40 leaves a ragged last 32-slot tile."""
    dev = _card()
    rng = np.random.default_rng(7 + window + S)
    B, h, g, hd = 6, 32, 8, 128
    pos = np.array([0, 1, 31, 32, S - 1, 5 * S + 3], np.int32)
    q = rng.standard_normal((B, h, hd), dtype=np.float32)
    k = rng.standard_normal((B, S, g, hd), dtype=np.float32)
    v = rng.standard_normal((B, S, g, hd), dtype=np.float32)
    cuda = lambda x: t(x).to(dev)
    args = (cuda(q).to(dtype), cuda(k).to(dtype), cuda(v).to(dtype),
            cuda(pos))
    _close(decode_attention(*args, window=window),
           ref.decode_attention_ref(*args, window=window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("m,hd", [(1, 64), (1, 128), (2, 128), (4, 64),
                                  (4, 128), (5, 64), (5, 128), (8, 64),
                                  (8, 128), (64, 64)])
def test_cuda_flash_attention_tiles(dtype, causal, m, hd):
    """The query tile (64 / m positions x m heads of a group, rounded down:
    at m = 5 rows 60-63 are padding) at every group size, hd 64 and 128:
    lengths that end inside a key tile (of 32 or 64 keys), a length 0 (exact zeros), S != T and a ragged last tile of
    both queries and keys."""
    dev = _card()
    rng = np.random.default_rng(100 + m + hd)
    B, S, T, g = 4, 97, 130, 2
    h = m * g
    q = rng.standard_normal((B, S, h, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    lens = np.array([130, 0, 65, 33], np.int32)
    cuda = lambda x: t(x).to(dev)
    args = (cuda(q).to(dtype), cuda(k).to(dtype), cuda(v).to(dtype),
            cuda(lens))
    y = flash_attention(*args, causal=causal)
    _close(y, ref.flash_attention_ref(*args, causal=causal), dtype)
    assert float(y[1].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ns", [4, 8, 16])
def test_cuda_splitk_empty_splits_and_decode_lens(dtype, ns):
    """Short walks under a wide table (nbt 16): most of the ns runs hold no
    valid block and write empty partials; decode with ``lens`` given (an
    inactive row: pos 0, lens 0, exact zeros)."""
    dev = _card()
    rng = np.random.default_rng(200 + ns)
    pos, lens = np.array([40, 5, 0]), np.array([5, 3, 0])
    args = _chunk_case(rng, dev, dtype, 3, 5, 32, 8, 128, 32, 16, pos, lens)
    o, m, l = splitk_partials(*args, ns)
    po, pm, pl = ref.splitk_partials_ref(*args, ns)
    _close(o, po, dtype)
    _close(lse_merge(o, m, l, dtype), ref.lse_merge(o, m, l), dtype)
    y = paged_verify_attention_splitk(*args, num_splits=ns)
    _close(y, ref.paged_verify_ref(*args), dtype)
    assert float(y[2].abs().max()) == 0.0
    q, kp, vp, tables, p, _ = args
    dlens = t(np.array([1, 1, 0], np.int32)).to(dev)
    y = paged_decode_attention_splitk(q[:, 0].contiguous(), kp, vp, tables,
                                      p, num_splits=ns, lens=dlens)
    _close(y[:2], ref.paged_decode_ref(q[:2, 0], kp, vp, tables[:2], p[:2]),
           dtype)
    assert float(y[2].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,Sq", [(4, 2), (8, 2), (4, 5), (4, 8), (4, 9),
                                  (16, 5), (8, 9), (16, 9), (1, 5), (5, 5),
                                  (5, 9), (5, 30), (1, 130)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_verify_and_splitk_whole_groups(dtype, m, Sq, hd):
    """Groups of m * Sq query columns through the verify kernel and
    split-K at ns 1 and 4.  bf16: 8, 16, 20 and 32 columns take the
    split-key walk in one block with 1, 2, 3 and 4 column tiles, 36, 72
    and 80 in two or three blocks of at most 32 columns (36 cut inside a
    position; above hd 128 a block holds 16), 144 (past ``SPLIT_COLS``)
    the query-tile walk; fp32: 8 to 36 rows one thread block, 72 to 144
    several row groups; m = 1 and 5 (deepseek-7b, llama4-maverick) at 5,
    25, 45, 130 and 150 columns, the last two on the query-tile walk.
    Rows with lens 0 and pos 0 are exact zeros."""
    dev = _card()
    rng = np.random.default_rng(300 + m * Sq + (hd != 64) * hd)
    g = 2
    pos, lens = np.array([0, 61, 200]), np.array([0, Sq, Sq - 2])
    nbt = max(8, -(-int((pos + lens).max()) // 32))
    args = _chunk_case(rng, dev, dtype, 3, Sq, m * g, g, hd, 32, nbt, pos,
                       lens)
    plain = ref.paged_verify_ref(*args)
    y = paged_verify_attention(*args)
    _close_rows(y, plain, dtype)
    assert float(y[0].abs().max()) == 0.0
    for ns in (1, 4):
        _close(paged_verify_attention_splitk(*args, num_splits=ns), plain,
               dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_cuda_verify_chunks_straddle_tile_and_block_edges(dtype, hd):
    """Serving chunks (Sq 5, 4 heads a KV head) whose keys cross a 16-key
    tile edge inside a pool block (13..17, 41..45), a pool-block edge
    (30..34, 62..66), both at the table's end (507..511), a chunk that
    ends on an edge (11..15) and a lens-0 row whose keys end on one
    (pos 64); each row within its own tolerance."""
    dev = _card()
    rng = np.random.default_rng(350 + hd)
    pos = np.array([13, 41, 30, 62, 507, 11, 64])
    lens = np.array([5, 5, 5, 3, 5, 5, 0])
    args = _chunk_case(rng, dev, dtype, len(pos), 5, 8, 2, hd, 32, 16, pos,
                       lens)
    y = paged_verify_attention(*args)
    _close_rows(y, ref.paged_verify_ref(*args), dtype)


def _prefill_case(rng, dev, dtype, Sq, m, hd, g=2, bs=32):
    """Suffix-prefill rows whose keys span 1, 2 and 9 16-key tiles, a cold
    row (cached 0) of the whole suffix, a ragged row and a seg-0 padding
    row (cached 0, must be exact 0)."""
    cached = np.array([0, 12, 128, 0, 40, 0], np.int32)
    seg = np.array([min(Sq, 10), 12, 16, Sq, max(1, Sq - 3), 0], np.int32)
    seg = np.minimum(seg, Sq)
    nbt = -(-int((cached + Sq).max()) // bs)
    B = len(cached)
    kp, vp, tables = _paged_inputs(rng, B, g, hd, bs, nbt,
                                   -(-(cached + seg) // bs))
    q = rng.standard_normal((B, Sq, m * g, hd), dtype=np.float32)
    cuda = lambda x: t(x).to(dev)
    return (cuda(q).to(dtype), cuda(kp).to(dtype), cuda(vp).to(dtype),
            cuda(tables), cuda(cached), cuda(seg))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,m", PREFILL_CASES)
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_paged_prefill_walks_match_plain(dtype, Sq, m, hd):
    """Paged prefill on both sides of the bf16 crossover (``SPLIT_COLS``
    columns: the longest suffix of the split-key walk, and one position
    more on the query-tile walk) and at 25 x 4 columns, whose groups of the
    split walk begin inside a position, each row within its own tolerance,
    the seg-0 row exact 0, two calls the same bits."""
    dev = _card()
    rng = np.random.default_rng(800 + m + hd + Sq)
    args = _prefill_case(rng, dev, dtype, Sq, m, hd)
    y = paged_prefill_attention(*args)
    _close_rows(y, ref.paged_prefill_ref(*args), dtype)
    assert float(y[-1].abs().max()) == 0.0
    assert torch.equal(paged_prefill_attention(*args), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d_in,d_out,T,bt", [
    (8, 4096, 14336, 64, 8),      # the suffix-prefill shape
    (8, 4096, 1024, 3000, 8),     # long context, a narrow output
    (8, 14336, 4096, 8, 8),       # one tile
    (4, 1000, 300, 64, 8),        # d_in and d_out not multiples of 8
    (16, 4096, 4100, 64, 8),      # a ragged d_out edge only
    (64, 1004, 4096, 64, 16),     # a ragged d_in, two tokens a warp
    (5, 512, 512, 48, 4),         # a rank that is no vector width
    (8, 4096, 4096, 72, 24),      # three token groups per tile
    (8, 5120, 17920, 64, 8),      # phi3-medium-14b's up projection
    (8, 8192, 22528, 64, 8),      # command-r-35b's up projection
    (8, 4096, 11008, 64, 8),      # deepseek-7b's up projection
    (8, 5120, 576, 64, 8),        # deepseek-v2's wdkv (576: 4.5 x 128)
    (8, 16384, 5120, 64, 8),      # deepseek-v2's wo, the widest d_in
    (8, 8192, 28672, 64, 8),      # llama-3.2-vision-90b's up projection
    (8, 28672, 8192, 64, 8),      # its down projection
    (8, 8192, 8192, 64, 8),       # its xwq / xwo (and wq / wo)
    (8, 512, 2048, 64, 8),        # whisper-base's up projection
    (8, 2048, 512, 64, 8),        # whisper-base's down projection
])
def test_cuda_smlm_shapes_match_plain(dtype, r, d_in, d_out, T, bt):
    """SMLM against its plain version, each token row within its own
    tolerance: adjacent tiles of different adapters and scales, tiles of
    scale 0 and of out-of-range ids (exact zeros), vector and scalar edges;
    two calls on the same inputs give the same bits (the shrink's partials
    are summed in a fixed order)."""
    dev = _card()
    rng = np.random.default_rng(400 + r + d_in % 97 + T)
    n = 4
    x, a, b = (v.to(dev, dtype)
               for v in map(t, _lora_inputs(rng, T, d_in, r, n, d_out)))
    nt = T // bt
    pattern = np.array([0, -1, 1, n, 2, 3, 1, 0], np.int32)
    tiles = np.resize(pattern, nt)
    tiles[8:] = rng.integers(-1, n + 1, max(0, nt - 8))
    tok_scale = np.repeat(rng.choice([0.5, 1.0, 2.0], nt), bt)
    ids = t(np.repeat(tiles, bt).astype(np.int32)).to(dev)
    rt = ops.route(ids, t(tok_scale.astype(np.float32)).to(dev), n,
                   n_head=T, block_t=bt)
    args = (x, a, b, rt.tile_ids, rt.tile_scale)
    y = smlm(*args, block_t=bt)
    plain = ref.smlm_ref(*args, bt)
    _close_rows(y, plain, dtype)
    dead = torch.repeat_interleave(rt.tile_scale == 0, bt)
    if dead.any():
        assert float(y[dead].abs().max()) == 0.0
    assert torch.equal(smlm(*args, block_t=bt), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 32])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_paged_decode_groups_match_plain(dtype, m, hd):
    """Paged decode at every group size and head dim the walks split on:
    an inactive row (pos 0, null table: block 0 only), pos 0 with a real
    table, pos 31 / 32 (a tile edge), 95 (warps that get no unit), 511 and
    the table's last slot, each row within its own tolerance."""
    dev = _card()
    rng = np.random.default_rng(500 + m + hd)
    g, bs, nbt = 2, 32, 20
    pos = np.array([0, 0, 31, 32, 95, 511, nbt * bs - 1], np.int32)
    B = len(pos)
    kp, vp, tables = _paged_inputs(rng, B, g, hd, bs, nbt, pos // bs + 1)
    tables[0] = 0
    cuda = lambda x: t(x).to(dev)
    q = rng.standard_normal((B, m * g, hd), dtype=np.float32)
    args = (cuda(q).to(dtype), cuda(kp).to(dtype), cuda(vp).to(dtype),
            cuda(tables), cuda(pos))
    y = paged_decode_attention(*args)
    _close_rows(y, ref.paged_decode_ref(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 4, 5, 8, 32])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_dense_decode_groups_match_plain(dtype, m, hd):
    """Dense-row decode at every group size and head dim the walks split
    on, linear (window 0) and rolling (the whole row, and an arc that
    wraps past the row's end), S 40 (a ragged last 16-slot tile), 64 and
    512: pos 0, 15 / 16 (a tile edge), 31 / 32, S - 1 and past S; each row
    within its own tolerance, two calls on the same inputs the same bits."""
    dev = _card()
    g = 2
    for S in (40, 64, 512):
        rng = np.random.default_rng(600 + m + hd + S)
        pos = np.array([0, 15, 16, 31, 32, S - 1, 3 * S - 1, 5 * S + 3],
                       np.int32)
        B = len(pos)
        q = rng.standard_normal((B, m * g, hd), dtype=np.float32)
        k = rng.standard_normal((B, S, g, hd), dtype=np.float32)
        v = rng.standard_normal((B, S, g, hd), dtype=np.float32)
        cuda = lambda x: t(x).to(dev)
        args = (cuda(q).to(dtype), cuda(k).to(dtype), cuda(v).to(dtype),
                cuda(pos))
        for window in (0, S, S // 2 + 3):
            y = decode_attention(*args, window=window)
            _close_rows(y, ref.decode_attention_ref(*args, window=window),
                        dtype)
            assert torch.equal(decode_attention(*args, window=window), y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,r,d_in,d_out,n", [
    (1, 4, 512, 300, 4),          # one token, a ragged d_out
    (8, 8, 4096, 14336, 4),       # the decode tick's widest projection
    (8, 8, 14336, 4096, 4),       # the down projection
    (40, 16, 300, 4096, 6),       # the verify bucket, a ragged d_in
    (40, 8, 4096, 14336, 4),      # the verify bucket's widest projection
    (64, 64, 1004, 300, 6),       # the widest rank, both edges ragged
    (64, 64, 512, 14336, 16),     # more adapters than one B batch holds
    (100, 8, 4096, 1024, 6),      # two token groups
    (8, 8, 5120, 17920, 4),       # phi3-medium-14b's up projection
    (8, 8, 8192, 22528, 4),       # command-r-35b's up projection
    (8, 8, 4096, 11008, 4),       # deepseek-7b's up projection
    (8, 8, 5120, 576, 4),         # deepseek-v2's wdkv
    (8, 8, 16384, 5120, 4),       # deepseek-v2's wo
    (8, 8, 8192, 28672, 4),       # llama-3.2-vision-90b's up projection
    (8, 8, 28672, 8192, 4),       # its down projection
    (40, 8, 8192, 8192, 4),       # its xwq / xwo in a verify bucket
    (8, 8, 512, 2048, 4),         # whisper-base's up projection
    (8, 8, 2048, 512, 4),         # whisper-base's down projection
])
def test_cuda_bgmv_shapes_match_plain(dtype, T, r, d_in, d_out, n):
    """BGMV against its plain version, each token row within its own
    tolerance: several tokens naming one adapter, tokens of scale 0 and of
    ids outside [0, n) (exact zeros), vector and element edges; two calls
    on the same inputs give the same bits (no atomics)."""
    dev = _card()
    rng = np.random.default_rng(700 + T + r + d_in % 97 + d_out % 89)
    x, a, b = (v.to(dev, dtype)
               for v in map(t, _lora_inputs(rng, T, d_in, r, n, d_out)))
    ids = rng.integers(0, n, T).astype(np.int32)
    ids[::5] = ids[0]                       # one adapter, many tokens
    scale = rng.choice([0.5, 1.0, 2.0], T).astype(np.float32)
    if T > 1:
        scale[1] = 0.0                      # a disabled token
        ids[-1] = n if T % 2 else -1        # an id outside the bank
    args = (x, a, b, t(ids).to(dev), t(scale).to(dev))
    y = bgmv(*args)
    plain = ref.bgmv_ref(*args)
    _close_rows(y, plain, dtype)
    if T > 1:
        assert float(y[1].abs().max()) == 0.0
        assert float(y[-1].abs().max()) == 0.0
    assert torch.equal(bgmv(*args), y)


# tile patterns of the weight-gradient cases (ids; -1: a base-only tile of
# scale 0): "mixed" two adapters and a base-only tile; "interleaved" the
# slots alternate, so a slot's tiles are not contiguous and outnumber the
# block's warps; "single" one live tile, so three warps of its block idle;
# "dead" no live tile at all ("single": one live tile of slot 2 mid-stream;
# "offset" and "range" take "mixed")
WGRAD_TILES = {"mixed": [0, 2, 0, -1, 2],
               "interleaved": [1, 3, 1, -1, 3, 1, 0], "dead": [-1]}


def _wgrad_inputs(rng, dev, dtype, T, r, d_in, d_out, kind):
    """x, dy (off a 16-byte boundary for "offset": views one element into
    a flat buffer) and the fp32 shrinks s, gs (for "range" spread over
    eight decades)."""
    def rows(w):
        v = t(rng.standard_normal((T * w + 1,), dtype=np.float32)
              ).to(dev, dtype)
        return v[1:].view(T, w) if kind == "offset" else v[1:].clone(
            ).view(T, w)
    x, dy = rows(d_in), rows(d_out)
    s, gs = (t(rng.standard_normal((T, r), dtype=np.float32)) for _ in "ab")
    if kind == "range":
        s, gs = (v * t(10.0 ** rng.uniform(-4, 4, (T, r))).float()
                 for v in (s, gs))
    return x, dy, s.to(dev), gs.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,r,d_in,d_out,n,bt,kind", [
    (64, 8, 512, 300, 4, 8, "mixed"),         # a ragged d_out
    (48, 4, 96, 40, 4, 12, "mixed"),          # a tile that is not 8 tokens
    (256, 8, 4096, 14336, 4, 8, "mixed"),     # the widest projection
    (96, 64, 300, 1004, 6, 8, "mixed"),       # the widest rank, ragged both
    (512, 8, 512, 1024, 4, 8, "interleaved"),
    (64, 8, 512, 1024, 4, 8, "single"),
    (64, 8, 512, 1024, 4, 8, "dead"),
    (192, 8, 256, 512, 4, 16, "mixed"),       # two groups a tile
    (144, 8, 264, 520, 4, 12, "interleaved"),  # an odd K step a tile
    (64, 4, 256, 512, 4, 8, "mixed"),
    (128, 16, 512, 768, 4, 8, "interleaved"),
    (128, 64, 512, 1024, 4, 8, "interleaved"),
    (64, 8, 1000, 2052, 4, 8, "offset"),      # ragged, off 16 bytes
    (256, 8, 4096, 1024, 4, 8, "offset"),     # off 16 bytes only
    (256, 8, 512, 1024, 4, 8, "range"),
    (8256, 8, 64, 136, 4, 8, "interleaved"),  # 1032 tiles: two windows
    (256, 8, 5120, 576, 4, 8, "mixed"),       # deepseek-v2's wdkv: an
                                              # edge chunk of 64 columns
    (256, 8, 16384, 5120, 4, 8, "mixed"),     # deepseek-v2's wo
])
def test_cuda_smlm_wgrad_matches_plain(dtype, T, r, d_in, d_out, n, bt,
                                       kind):
    """The SMLM weight gradient against its plain version over the tile
    patterns of ``WGRAD_TILES``: dead tiles' shrinks (scale 0) left as NaN,
    which the kernel must not read; slot 1 ("mixed") or every slot
    ("dead") that no live tile uses comes out exactly 0; the "range"
    shrinks also row by row; two calls give the same bits (no atomics)."""
    dev = _card()
    rng = np.random.default_rng(900 + T + r)
    x, dy, s, gs = _wgrad_inputs(rng, dev, dtype, T, r, d_in, d_out, kind)
    nt = T // bt
    tiles = np.resize(np.array(WGRAD_TILES.get(kind, WGRAD_TILES["mixed"]),
                               np.int32), nt)
    if kind == "single":
        tiles[:] = -1
        tiles[nt // 2] = 2
    scale = np.where(tiles >= 0, 1.0, 0.0).astype(np.float32)
    ids, sc = t(np.clip(tiles, 0, n - 1)).to(dev), t(scale).to(dev)
    sb, gb = ref.pack_shrink(s, bt), ref.pack_shrink(gs, bt)
    dead = torch.repeat_interleave(sc == 0, bt)
    s_dead = s.masked_fill(dead[:, None], float("nan"))
    g_dead = gs.masked_fill(dead[:, None], float("nan"))
    sb_dead, gb_dead = ref.pack_shrink(s_dead, bt), ref.pack_shrink(g_dead,
                                                                     bt)
    da, db = smlm_wgrad(x, dy, sb_dead, gb_dead, ids, sc, r=r, block_t=bt,
                        n_slots=n)
    pa, pb = ref.smlm_wgrad_ref(x, dy, s, gs, ids, sc, bt, n)
    _close(da, pa, dtype)
    _close(db, pb, dtype)
    if kind == "range":
        _close_rows(da, pa, dtype)
        _close_rows(db, pb, dtype)
    unused = [k for k in range(n) if not ((tiles == k).any())]
    assert unused and all(float(da[k].abs().max()) == 0.0
                          and float(db[k].abs().max()) == 0.0
                          for k in unused)
    da2, db2 = smlm_wgrad(x, dy, sb, gb, ids, sc, r=r, block_t=bt,
                          n_slots=n)
    assert torch.equal(da, da2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_smlm_function_backward_matches_plain_autograd(dtype):
    """``SMLMFunction`` on the card (SMLM forward, SMLM for dX and
    ``smlm_wgrad`` for dA/dB) against autograd through the plain SMLM, with
    fine-tune rows at the head and prefill tiles (zero cotangent) after
    them; the weight-gradient kernel launches once."""
    dev = _card()
    rng = np.random.default_rng(11)
    T, n_ft, d_in, d_out, n, r, bt = 96, 64, 512, 1024, 4, 8, 8
    x, a, b = (v.to(dev, dtype) for v in map(t, _lora_inputs(
        rng, T, d_in, r, n, d_out)))
    tiles = np.resize(np.array([1, 1, 3, -1, 0], np.int32), T // bt)
    ids = t(np.clip(tiles, 0, n - 1)).to(dev)
    sc = t(np.where(tiles >= 0, 1.5, 0.0).astype(np.float32)).to(dev)
    g = torch.zeros((T, d_out), device=dev, dtype=dtype)
    g[:n_ft] = t(rng.standard_normal((n_ft, d_out), dtype=np.float32)
                 ).to(dev, dtype)
    leaves = [v.clone().requires_grad_() for v in (x, a, b)]
    plain = [v.clone().requires_grad_() for v in (x, a, b)]
    n0 = smlm_wgrad.launches
    y = SMLMFunction.apply(*leaves, ids, sc, bt, n_ft)
    (y.float() * g.float()).sum().backward()
    assert smlm_wgrad.launches == n0 + 1
    y_ref = ref.smlm_ref(*plain, ids, sc, bt)
    (y_ref.float() * g.float()).sum().backward()
    _close(y.detach(), y_ref.detach(), dtype)
    for got, want in zip(leaves, plain):
        _close(got.grad, want.grad, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_lora_function_backward_matches_smlm_function(dtype):
    """``ops.SplitLoRAFunction`` (the sharded step's LoRA term) at one
    rank's slice of a 4-way split of llama3-8b's gate projection (d_in 4096
    / 4, d_out 14336 / 4), its collective the identity: fine-tune tiles
    (one of scale 0), prefill tiles of zero cotangent and a BGMV decode
    tail.  y against the plain SMLM and BGMV; dX, dA and dB against
    ``SMLMFunction`` on the same head and against autograd through the
    plain versions (the prefill and decode rows' dX exactly 0); the split
    entries launch in both passes, ``smlm_wgrad`` once, the fused SMLM
    never."""
    from repro_torch.kernels import bgmv as BG
    from repro_torch.kernels import smlm as SM
    dev = _card()
    rng = np.random.default_rng(12)
    n_ft, n_pf, d, o, n, r, bt = 64, 32, 1024, 3584, 4, 8, 8
    dec = np.array([0, 1, -1, 3, 2, 0, 1, 1], np.int32)
    ft_tiles = np.array([1, 1, 3, -1, 0, 2, 1, 3], np.int32)
    pf_tiles = np.array([2, -1, 0, 1], np.int32)
    ids = np.concatenate([np.repeat(ft_tiles, bt), np.repeat(pf_tiles, bt),
                          dec])
    T, n_head = ids.shape[0], n_ft + n_pf
    x, a, b = (v.to(dev, dtype) for v in map(t, _lora_inputs(
        rng, T, d, r, n, o)))
    rt = ops.route(t(ids).to(dev), torch.full((T,), 1.5, device=dev), n,
                   n_head, bt, n_ft=n_ft)
    g = torch.zeros((T, o), device=dev, dtype=dtype)
    g[:n_ft] = t(rng.standard_normal((n_ft, o), dtype=np.float32)
                 ).to(dev, dtype)
    counts = lambda: (SM.smlm_shrink.launches, SM.smlm_expand.launches,
                      SM.smlm_wgrad.launches, SM.smlm.launches,
                      BG.bgmv_shrink.launches, BG.bgmv_expand.launches)
    split = [v.clone().requires_grad_() for v in (x, a, b)]
    n0 = counts()
    y, = ops.SplitLoRAFunction.apply(split[0], rt, lambda s: s, True,
                                     (True,), split[1], split[2])
    (y.float() * g.float()).sum().backward()
    assert [c - c0 for c, c0 in zip(counts(), n0)] == [2, 2, 1, 0, 1, 1]
    fused = [v.clone().requires_grad_() for v in (x, a, b)]
    yf = SMLMFunction.apply(fused[0][:n_head], fused[1], fused[2],
                            rt.tile_ids, rt.tile_scale, bt, n_ft)
    (yf.float() * g[:n_head].float()).sum().backward()
    plain = [v.clone().requires_grad_() for v in (x, a, b)]
    yp = torch.cat([ref.smlm_ref(plain[0][:n_head], plain[1], plain[2],
                                 rt.tile_ids, rt.tile_scale, bt),
                    ref.bgmv_ref(x[n_head:], a, b, rt.tail_ids,
                                 rt.tail_scale)])
    (yp.float() * g.float()).sum().backward()
    _close_rows(y.detach(), yp.detach(), dtype)
    assert float(split[0].grad[n_ft:].abs().max()) == 0.0
    for got, want in zip(split, plain):
        _close(got.grad, want.grad, dtype)
    for got, want in zip(split[1:], fused[1:]):
        _close(got.grad, want.grad, dtype)
    _close(split[0].grad[:n_head], fused[0].grad[:n_head], dtype)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_cuda_mamba_layers_match_cpu(arch):
    """Reduced ``arch`` in fp32 with two adapters on the card (SMLM, BGMV,
    and jamba's flash and paged decode kernels; the Mamba mixer in plain
    PyTorch) against the same forward on the CPU: a cold paged prefill of
    two ragged rows, then two decode steps beside an inactive row; logits
    and every cache leaf (state rows and K/V blocks), then the ft grad
    step's loss and bank gradients."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.unified import make_grad_step
    from repro_torch.core.virtualization import AdapterStore
    from repro_torch.models import model as TM
    from repro_torch.models.schema import init_params
    from repro_torch.models.stream import (DECBatch, FTBatch, PFBatch,
                                           UnifiedBatch)
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    params = init_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), device=cpu,
                         dtype=torch.float32)
    for i in range(2):
        gen = torch.Generator().manual_seed(100 + i)
        store.load_random(f"a{i}", gen, gaussian_b=True)
    rng = np.random.default_rng(4)
    toks = t(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))
    tables = t(np.array([[1, 2, 0], [3, 4, 5]], np.int32))
    dtables = t(np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32))
    ids = t(np.array([0, 1], np.int32))
    runs = {}
    for d in (dev, cpu):
        p, bank, scale = (_tree_to(v, d) for v in (params, store.bank,
                                                   store.scale))
        cache = TM.init_paged_cache(cfg, 6, 8, d, torch.float32, n_rows=3)
        kw = dict(loras=bank, lora_scale=scale, block_t=8)
        n0 = (smlm.launches, bgmv.launches)
        with torch.no_grad():
            pf = PFBatch(tokens=toks.to(d), length=t(np.array(
                [12, 16], np.int32)).to(d), adapter=ids.to(d),
                block_tables=tables.to(d))
            out = TM.unified_forward(cfg, p, UnifiedBatch(pf=pf), cache,
                                     **kw)
            logits = [out.pf_logits.cpu()]
            nxt = out.pf_logits.argmax(-1).to(torch.int32)
            for step in range(2):
                dec = DECBatch(
                    tokens=torch.cat([nxt, nxt.new_zeros(1)]),
                    pos=t(np.array([12 + step, 16 + step, 0],
                                   np.int32)).to(d),
                    adapter=t(np.array([0, 1, -1], np.int32)).to(d),
                    block_tables=dtables.to(d))
                out = TM.unified_forward(cfg, p, UnifiedBatch(dec=dec),
                                         cache, **kw)
                logits.append(out.dec_logits.cpu())
                nxt = out.dec_logits[:2].argmax(-1).to(torch.int32)
        mask = torch.ones((2, 16), dtype=torch.bool)
        ft = FTBatch(tokens=toks.to(d), mask=mask.to(d),
                     labels=toks.to(d), adapter=ids.to(d),
                     weight=torch.ones(2, device=d))
        res = make_grad_step(cfg, block_t=8)(p, bank, scale,
                                             UnifiedBatch(ft=ft), None)
        runs[d.type] = (logits, {k: v.cpu() for k, v in cache.items()},
                        res.loss.cpu(), _tree_to(res.grads, cpu))
        if d.type == "cuda":
            assert smlm.launches > n0[0] and bgmv.launches > n0[1]
    (gl, gc, gloss, gg), (cl, cc, closs, cg) = runs["cuda"], runs["cpu"]
    for a, b in zip(gl, cl):
        _close(a, b, torch.float32)
    assert list(gc) == list(cc) == list(TM.cache_leaves(cfg))
    for name in gc:
        lo = 0 if name in TM.STATE_KEYS else 1      # block 0: the null block
        _close(gc[name][:, lo:], cc[name][:, lo:], torch.float32)
    assert abs(float(gloss) - float(closs)) <= 1e-5 * abs(float(closs))
    for lg, lc in zip(gg["layers"], cg["layers"]):
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lc[name][ab]
                assert float((g - w).abs().max()) \
                    <= 1e-4 * max(float(w.abs().max()), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-base"])
def test_cuda_cross_layers_match_cpu(arch):
    """Reduced ``arch`` in fp32 with its gates open (0.5) and two adapters
    over the default targets and ``xwq`` / ``xwo``, on the card (SMLM,
    BGMV, flash and paged decode; the cross sublayer and Whisper's encoder
    in plain PyTorch) against the same forward on the CPU: a cold paged
    prefill of two ragged rows with a source each, then two decode steps
    reading the ``xk`` / ``xv`` rows beside an inactive row; logits and
    every cache leaf, then the ft grad step's loss and bank gradients."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.unified import make_grad_step
    from repro_torch.core.virtualization import AdapterStore
    from repro_torch.models import model as TM
    from repro_torch.models.schema import cross_len, init_params
    from repro_torch.models.stream import (DECBatch, FTBatch, PFBatch,
                                           UnifiedBatch)
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    cpu = torch.device("cpu")
    params = init_params(cfg, device="cpu", dtype=torch.float32, seed=0)
    for layer in params["layers"]:
        if "xgate" in layer:
            layer["xgate"].fill_(0.5)
    lcfg = LoRAConfig(n_slots=4, r=8,
                      targets=LoRAConfig().targets + ("xwq", "xwo"))
    store = AdapterStore(cfg, lcfg, device=cpu, dtype=torch.float32)
    for i in range(2):
        gen = torch.Generator().manual_seed(100 + i)
        store.load_random(f"a{i}", gen, gaussian_b=True)
    rng = np.random.default_rng(4)
    toks = t(rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32))
    aux = t(rng.standard_normal((2, cross_len(cfg), cfg.d_model),
                                dtype=np.float32))
    tables = t(np.array([[1, 2, 0], [3, 4, 5]], np.int32))
    dtables = t(np.array([[1, 2, 0], [3, 4, 5], [0, 0, 0]], np.int32))
    ids = t(np.array([0, 1], np.int32))
    runs = {}
    for d in (dev, cpu):
        p, bank, scale = (_tree_to(v, d) for v in (params, store.bank,
                                                   store.scale))
        cache = TM.init_paged_cache(cfg, 6, 8, d, torch.float32, n_rows=3)
        kw = dict(loras=bank, lora_scale=scale, block_t=8)
        n0 = (smlm.launches, bgmv.launches)
        with torch.no_grad():
            pf = PFBatch(tokens=toks.to(d), length=t(np.array(
                [12, 16], np.int32)).to(d), adapter=ids.to(d),
                aux_embed=aux.to(d), block_tables=tables.to(d))
            out = TM.unified_forward(cfg, p, UnifiedBatch(pf=pf), cache,
                                     **kw)
            logits = [out.pf_logits.cpu()]
            nxt = out.pf_logits.argmax(-1).to(torch.int32)
            for step in range(2):
                dec = DECBatch(
                    tokens=torch.cat([nxt, nxt.new_zeros(1)]),
                    pos=t(np.array([12 + step, 16 + step, 0],
                                   np.int32)).to(d),
                    adapter=t(np.array([0, 1, -1], np.int32)).to(d),
                    block_tables=dtables.to(d))
                out = TM.unified_forward(cfg, p, UnifiedBatch(dec=dec),
                                         cache, **kw)
                logits.append(out.dec_logits[:2].cpu())
                nxt = out.dec_logits[:2].argmax(-1).to(torch.int32)
        mask = torch.ones((2, 16), dtype=torch.bool)
        ft = FTBatch(tokens=toks.to(d), mask=mask.to(d),
                     labels=toks.to(d), adapter=ids.to(d),
                     weight=torch.ones(2, device=d), aux_embed=aux.to(d))
        res = make_grad_step(cfg, block_t=8)(p, bank, scale,
                                             UnifiedBatch(ft=ft), None)
        runs[d.type] = (logits, {k: v.cpu() for k, v in cache.items()},
                        res.loss.cpu(), _tree_to(res.grads, cpu))
        if d.type == "cuda":
            assert smlm.launches > n0[0] and bgmv.launches > n0[1]
    (gl, gc, gloss, gg), (cl, cc, closs, cg) = runs["cuda"], runs["cpu"]
    for a, b in zip(gl, cl):
        _close(a, b, torch.float32)
    assert list(gc) == list(cc) == list(TM.cache_leaves(cfg))
    for name in gc:
        lo = 0 if name in TM.STATE_KEYS else 1      # block 0: the null block
        _close(gc[name][:, lo:], cc[name][:, lo:], torch.float32)
    assert abs(float(gloss) - float(closs)) <= 1e-5 * abs(float(closs))
    for lg, lc in zip(gg["layers"], cg["layers"]):
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lc[name][ab]
                assert float((g - w).abs().max()) \
                    <= 1e-4 * max(float(w.abs().max()), 1e-12)
    assert float(gg["layers"][cfg.n_layers - 1]["xwq"]["b"].abs().max()) > 0
