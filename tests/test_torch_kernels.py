"""The port's four serving kernels.

On the CPU: each plain PyTorch version vs the JAX Pallas kernel in
interpret mode and vs ``repro.kernels.ref`` on the same numpy inputs (fp32,
tolerance 1e-5: same arithmetic, other summation order); the LoRA dispatch
vs ``repro.core.lora.lora_apply_ref`` (exact per token), including invalid
ids and the two faults of the JAX ``ops.smlm`` dispatch.

The CUDA kernels against these plain versions are in
``test_torch_kernels_cuda.py``, which imports no JAX so it runs on the GPU
machine.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t
from repro.core.lora import lora_apply_ref as j_lora_apply_ref
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.bgmv import bgmv as j_bgmv
from repro.kernels.decode_attn import paged_decode_attention as j_decode
from repro.kernels.prefill_attn import paged_prefill_attention as j_prefill
from repro.kernels.smlm import smlm as j_smlm
from repro_torch.core.lora import lora_apply, lora_apply_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bgmv import bgmv
from repro_torch.kernels.decode_attn import paged_decode_attention
from repro_torch.kernels.prefill_attn import paged_prefill_attention
from repro_torch.kernels.smlm import smlm

TOL = 1e-5
# the crossover of the bf16 verify and prefill kernels (query columns)
SPLIT_COLS = int(re.search(
    r"SW_SPLIT_COLS = (\d+);",
    (Path(ref.__file__).parent / "csrc" / "split_walk.cuh").read_text())[1])
# the CUDA tests' suffixes (Sq, h/g): the longest of the split walk, one
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


# ------------------------------------------------------ plain vs Pallas
@pytest.mark.parametrize("T,d,r,n,o,bt", [(16, 32, 4, 3, 24, 8),
                                          (32, 64, 8, 4, 40, 16)])
def test_smlm_plain_matches_pallas_and_ref(T, d, r, n, o, bt):
    rng = np.random.default_rng(T + d)
    x, a, b = _lora_inputs(rng, T, d, r, n, o)
    tile_ids = rng.integers(0, n, T // bt).astype(np.int32)
    tile_scale = rng.uniform(0.5, 2.0, T // bt).astype(np.float32)
    tile_scale[0] = 0.0                            # a disabled tile
    y_pl = j_smlm(j(x), j(a), j(b), j(tile_ids), j(tile_scale), block_t=bt,
                  block_o=8, interpret=True)
    y_ref = j_ref.smlm_ref(j(x), j(a), j(b), j(tile_ids), j(tile_scale), bt)
    y = smlm(t(x), t(a), t(b), t(tile_ids), t(tile_scale), block_t=bt)
    assert max_err(y, y_pl) < TOL and max_err(y, y_ref) < TOL
    assert float(y[:bt].abs().max()) == 0.0


@pytest.mark.parametrize("T,d,r,n,o", [(8, 32, 4, 4, 24), (5, 64, 8, 3, 16),
                                       (40, 64, 8, 4, 48)])   # verify bucket
def test_bgmv_plain_matches_pallas_and_ref(T, d, r, n, o):
    rng = np.random.default_rng(T * d)
    x, a, b = _lora_inputs(rng, T, d, r, n, o)
    ids = rng.integers(0, n, T).astype(np.int32)
    scale = rng.uniform(0.5, 2.0, T).astype(np.float32)
    scale[-1] = 0.0
    y_pl = j_bgmv(j(x), j(a), j(b), j(ids), j(scale), block_o=8,
                  interpret=True)
    y_ref = j_ref.bgmv_ref(j(x), j(a), j(b), j(ids), j(scale))
    y = bgmv(t(x), t(a), t(b), t(ids), t(scale))
    assert max_err(y, y_pl) < TOL and max_err(y, y_ref) < TOL


@pytest.mark.parametrize("B,h,g,hd,bs,nbt", [(3, 4, 4, 16, 8, 4),
                                             (4, 8, 2, 32, 16, 3)])
def test_paged_decode_plain_matches_pallas_and_ref(B, h, g, hd, bs, nbt):
    """Null-padded tables, and an inactive row (pos 0, null table) that must
    stay finite."""
    rng = np.random.default_rng(B * h + hd)
    pos = rng.integers(0, nbt * bs, B).astype(np.int32)
    pos[0] = 0
    kp, vp, tables = _paged_inputs(rng, B, g, hd, bs, nbt, pos // bs + 1)
    tables[0] = 0
    q = rng.standard_normal((B, h, hd), dtype=np.float32)
    y_pl = j_decode(j(q), j(kp), j(vp), j(tables), j(pos), interpret=True)
    y_ref = j_ref.paged_decode_ref(j(q), j(kp), j(vp), j(tables), j(pos))
    y = paged_decode_attention(t(q), t(kp), t(vp), t(tables), t(pos))
    assert torch.isfinite(y).all()
    assert max_err(y, y_pl) < TOL and max_err(y, y_ref) < TOL


@pytest.mark.parametrize("B,h,g,hd,bs,nbt,Sq", [(3, 4, 4, 16, 8, 5, 12),
                                                (4, 8, 2, 32, 16, 4, 16)])
def test_paged_prefill_plain_matches_pallas_and_ref(B, h, g, hd, bs, nbt,
                                                    Sq):
    """Per-row cached prefixes (one cold row with cached 0 in the
    positional bucket), ragged suffix lengths and a padding row (seg 0)
    that must be 0."""
    rng = np.random.default_rng(B * Sq + hd)
    cached = rng.integers(1, nbt * bs - Sq, B).astype(np.int32)
    cached[1] = 0
    seg = rng.integers(1, Sq + 1, B).astype(np.int32)
    seg[0], cached[0] = 0, 0
    kp, vp, tables = _paged_inputs(rng, B, g, hd, bs, nbt,
                                   (cached + Sq - 1) // bs + 1)
    q = rng.standard_normal((B, Sq, h, hd), dtype=np.float32)
    args = (j(q), j(kp), j(vp), j(tables), j(cached), j(seg))
    y_pl = np.asarray(j_prefill(*args, block_q=8, interpret=True))
    y_ref = j_ref.paged_prefill_ref(*args)
    y = paged_prefill_attention(t(q), t(kp), t(vp), t(tables), t(cached),
                                t(seg))
    assert max_err(y, y_ref) < TOL
    for b in range(B):   # Pallas rows past seg are padding it never reads
        assert max_err(y[b, :seg[b]], y_pl[b, :seg[b]]) < TOL
    assert float(y[0].abs().max()) == 0.0


@pytest.mark.parametrize("Sq,m", PREFILL_CASES)
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_paged_prefill_plain_matches_pallas_at_the_crossover(Sq, m, hd):
    """The CUDA tests' prefill shapes on both sides of the bf16 crossover
    (``SPLIT_COLS`` query columns, and one position more) and at 25 x 4
    columns: rows whose keys span 1, 2 and 9 16-key tiles, a cold row, a
    ragged row and a seg-0 row (exact 0); plain vs Pallas on each row's
    live positions, and vs the oracle."""
    g, bs = 2, 32
    rng = np.random.default_rng(800 + m + hd + Sq)
    cached = np.array([0, 12, 128, 0, 40, 0], np.int32)
    seg = np.minimum(np.array([min(Sq, 10), 12, 16, Sq, max(1, Sq - 3), 0],
                              np.int32), Sq)
    nbt = -(-int((cached + Sq).max()) // bs)
    B = len(cached)
    kp, vp, tables = _paged_inputs(rng, B, g, hd, bs, nbt,
                                   -(-(cached + seg) // bs))
    q = rng.standard_normal((B, Sq, m * g, hd), dtype=np.float32)
    args = (j(q), j(kp), j(vp), j(tables), j(cached), j(seg))
    y_pl = np.asarray(j_prefill(*args, block_q=64, interpret=True))
    y = paged_prefill_attention(t(q), t(kp), t(vp), t(tables), t(cached),
                                t(seg))
    assert max_err(y, j_ref.paged_prefill_ref(*args)) < TOL
    for b in range(B):
        assert max_err(y[b, :seg[b]], y_pl[b, :seg[b]]) < TOL
    assert float(y[-1].abs().max()) == 0.0


# ------------------------------------------------ dispatch vs the oracle
def test_dispatch_matches_lora_apply_ref_with_invalid_ids():
    """Head of 3 tile-aligned rows (one base-only row with id -1, one with
    an out-of-range id), decode tail of 5 mixed rows; per-slot dynamic
    scales gathered per token, as the model does."""
    rng = np.random.default_rng(7)
    n, bt, Sp = 4, 8, 16
    x, a, b = _lora_inputs(rng, 3 * Sp + 5, 32, 4, n, 40)
    ids = np.concatenate([np.repeat([2, -1, n + 3], Sp),
                          [0, 3, -1, 1, 3]]).astype(np.int32)
    slot_scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    scale_t = slot_scale[np.clip(ids, 0, n - 1)]
    expect = j_lora_apply_ref(j(x), j(a), j(b), j(ids), j(scale_t))
    y = lora_apply(t(x), t(a), t(b), t(ids), t(scale_t), n_head=3 * Sp,
                   block_t=bt)
    assert max_err(y, expect) < TOL
    assert max_err(lora_apply_ref(t(x), t(a), t(b), t(ids), t(scale_t)),
                   expect) < TOL


def test_dispatch_rejects_unaligned_head():
    with pytest.raises(ValueError):
        ops.route(torch.zeros(12, dtype=torch.int32), None, 4, n_head=12,
                  block_t=8)


@pytest.mark.parametrize("case", ["straddling_tiles", "mixed_decode_tail"])
def test_jax_ops_smlm_faults_and_port_exactness(case):
    """The two faults of the JAX ``ops.smlm`` dispatch, shown on the JAX
    package's own functions, and the port's dispatch exact on the same
    inputs.  (a) ``lora_apply`` calls it with its default ``block_t=128``
    while the planner aligns segments to 8: a 128-token tile straddles
    prefill rows of different adapters.  (b) With ``T % block_t == 0`` the
    decode tail is not routed to BGMV and its mixed adapters collapse to
    one per tile."""
    rng = np.random.default_rng(11)
    n, d, r, o = 4, 32, 4, 128
    if case == "straddling_tiles":
        Bp, Sp = 4, 64
        ids = np.repeat(np.arange(Bp), Sp).astype(np.int32)
        n_head, j_block_t = Bp * Sp, 128
    else:
        ids = np.array([0, 1, 2, 3, 3, 2, 1, 0], np.int32)
        n_head, j_block_t = 0, 8
    x, a, b = _lora_inputs(rng, len(ids), d, r, n, o)
    x *= 4.0
    expect = np.asarray(j_lora_apply_ref(j(x), j(a), j(b), j(ids)))
    jax_err = max_err(j_ops.smlm(j(x), j(a), j(b), j(ids), block_t=j_block_t,
                                 interpret=True), expect)
    assert jax_err > 1.0          # the fault is real in the JAX dispatch
    y = lora_apply(t(x), t(a), t(b), t(ids), n_head=n_head, block_t=8)
    assert max_err(y, expect) < 1e-4
