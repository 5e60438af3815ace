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
from repro_torch.kernels.bgmv import bgmv
from repro_torch.kernels.decode_attn import (decode_attention,
                                             paged_decode_attention)
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.prefill_attn import paged_prefill_attention
from repro_torch.kernels.smlm import smlm
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
# position more, and groups of the split walk that begin inside a position
PREFILL_CASES = [(SPLIT_COLS, 1), (SPLIT_COLS + 1, 1), (SPLIT_COLS // 4, 4),
                 (SPLIT_COLS // 4 + 1, 4), (25, 4)]


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
@pytest.mark.parametrize("m,hd", [(1, 64), (2, 128), (4, 64), (4, 128),
                                  (8, 64), (8, 128), (64, 64)])
def test_cuda_flash_attention_tiles(dtype, causal, m, hd):
    """The query tile (64 / m positions x m heads of a group) at every
    group size, hd 64 and 128: lengths that end inside a key tile (of 32 or
    64 keys), a length 0 (exact zeros), S != T and a ragged last tile of
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
                                  (16, 5), (8, 9), (16, 9)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_verify_and_splitk_whole_groups(dtype, m, Sq, hd):
    """Groups of m * Sq query columns through the verify kernel and
    split-K at ns 1 and 4.  bf16: 8, 16, 20 and 32 columns take the
    split-key walk in one block with 1, 2, 3 and 4 column tiles, 36, 72
    and 80 in two or three blocks of at most 32 columns (36 cut inside a
    position; above hd 128 a block holds 16), 144 (past ``SPLIT_COLS``)
    the query-tile walk; fp32: 8 to 36 rows one thread block, 72 to 144
    several row groups.  Rows with lens 0 and pos 0 are exact zeros."""
    dev = _card()
    rng = np.random.default_rng(300 + m * Sq + (hd != 64) * hd)
    g = 2
    pos, lens = np.array([0, 61, 200]), np.array([0, Sq, Sq - 2])
    args = _chunk_case(rng, dev, dtype, 3, Sq, m * g, g, hd, 32, 8, pos,
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
@pytest.mark.parametrize("m", [1, 4, 8, 32])
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
@pytest.mark.parametrize("m", [1, 4, 8, 32])
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
