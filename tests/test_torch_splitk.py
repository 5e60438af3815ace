"""The port's verify and split-K paged attention and its split chooser.

On the CPU: the plain versions (``kernels.ref.paged_verify_ref``,
``splitk_partials_ref`` and ``lse_merge``, reached through the wrappers on
CPU tensors) vs the JAX Pallas kernels in interpret mode and vs
``repro.kernels.ref`` on the same numpy inputs, fp32, tolerance 1e-5 (same
arithmetic, other summation order); the split chooser vs
``repro.kernels.autotune`` for the same lane count.  Tables are built within
``nbt`` (each request names the blocks holding keys ``0 .. pos + lens -
1``), null-padded past them.

The CUDA kernels against these plain versions are in
``test_torch_kernels_cuda.py``.
"""
import json

import numpy as np
import pytest
import torch

from _hyputil import given, hyp, settings, st
from _torch_bridge import j, max_err, t
from repro.kernels import autotune as j_autotune
from repro.kernels import ref as j_ref
from repro.kernels.decode_attn import paged_verify_attention as j_verify
from repro.kernels.splitk import lse_merge as j_lse_merge
from repro.kernels.splitk import \
    paged_decode_attention_splitk as j_decode_splitk
from repro.kernels.splitk import \
    paged_verify_attention_splitk as j_verify_splitk
from repro_torch.kernels import autotune, ref
from repro_torch.kernels.splitk import (lse_merge,
                                        paged_decode_attention_splitk,
                                        paged_verify_attention_splitk,
                                        splitk_partials)
from repro_torch.kernels.verify_attn import paged_verify_attention

TOL = 1e-5
NEG = -1e30


def _chunk_inputs(rng, B, Sq, h, g, hd, bs, nbt, pos, lens):
    """Pools, tables naming the blocks of keys 0 .. pos + lens - 1 (at least
    one block for an active row; none for a row with pos = lens = 0) and
    queries, all from ``rng``."""
    n_blocks = nbt * B + 2
    kp = rng.standard_normal((n_blocks, bs, g, hd), dtype=np.float32)
    vp = rng.standard_normal((n_blocks, bs, g, hd), dtype=np.float32)
    tables = np.zeros((B, nbt), np.int32)
    for b in range(B):
        kend = int(pos[b] + lens[b])
        need = -(-kend // bs)
        assert need <= nbt
        tables[b, :need] = rng.choice(np.arange(1, n_blocks), size=need,
                                      replace=False)
    q = rng.standard_normal((B, Sq, h, hd), dtype=np.float32)
    return q, kp, vp, tables


def _verify_case(seed, B, Sq, h, g, hd, bs, nbt):
    """Ragged chunks: a full chunk ending a block, a partial one straddling
    a block edge, a lens == 0 row over real keys (pos > 0), and an inactive
    row (pos = lens = 0, null table) that must be exactly 0."""
    rng = np.random.default_rng(seed)
    pos = np.array([bs - Sq, bs - 1, 2 * bs + 3, 0][:B], np.int32)
    lens = np.array([Sq, 2, 0, 0][:B], np.int32)
    return (*_chunk_inputs(rng, B, Sq, h, g, hd, bs, nbt, pos, lens), pos,
            lens)


@pytest.mark.parametrize("B,Sq,h,g,hd,bs,nbt", [(4, 5, 8, 2, 32, 8, 5),
                                                (4, 3, 4, 4, 16, 16, 4)])
def test_verify_plain_matches_pallas_and_ref(B, Sq, h, g, hd, bs, nbt):
    q, kp, vp, tables, pos, lens = _verify_case(B * Sq + hd, B, Sq, h, g, hd,
                                                bs, nbt)
    args = (j(q), j(kp), j(vp), j(tables), j(pos), j(lens))
    y_pl = j_verify(*args, interpret=True)
    y_ref = j_ref.paged_verify_ref(*args)
    y = paged_verify_attention(t(q), t(kp), t(vp), t(tables), t(pos),
                               t(lens))
    assert torch.isfinite(y).all()
    assert max_err(y, y_ref) < TOL and max_err(y, y_pl) < TOL
    assert float(y[3].abs().max()) == 0.0          # no valid key: exact 0
    assert float(y[2].abs().max()) > 0.0           # lens 0 still sees j < pos


@pytest.mark.parametrize("m,Sq", [(4, 2), (8, 2), (4, 5), (4, 8), (4, 9),
                                  (16, 9)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_verify_plain_matches_pallas_at_split_walk_groups(m, Sq, hd):
    """The shapes of the CUDA tests' whole groups (8, 16, 20, 32 and 36
    query columns: the split-key walk's 1-4 column tiles and two groups cut
    inside a position; 144: past the crossover) at hd 64, 128 and 256: the
    plain version those tests hold the kernel to vs the Pallas kernel; the
    lens-0 row at pos 0 is exactly 0."""
    rng = np.random.default_rng(300 + m * Sq + (hd != 64) * hd)
    g = 2
    pos, lens = np.array([0, 61, 200], np.int32), np.array([0, Sq, Sq - 2],
                                                           np.int32)
    q, kp, vp, tables = _chunk_inputs(rng, 3, Sq, m * g, g, hd, 32, 8, pos,
                                      lens)
    args = (j(q), j(kp), j(vp), j(tables), j(pos), j(lens))
    y_pl = j_verify(*args, interpret=True)
    y = paged_verify_attention(t(q), t(kp), t(vp), t(tables), t(pos),
                               t(lens))
    assert max_err(y, y_pl) < TOL and max_err(y, j_ref.paged_verify_ref(
        *args)) < TOL
    assert float(y[0].abs().max()) == 0.0


@pytest.mark.parametrize("hd", [64, 128])
def test_verify_plain_matches_pallas_across_tile_edges(hd):
    """Chunks across a 16-key tile edge, a pool-block edge and the table's
    end (the CUDA edge test's shapes): plain vs Pallas."""
    rng = np.random.default_rng(350 + hd)
    pos = np.array([13, 41, 30, 62, 507, 11, 64], np.int32)
    lens = np.array([5, 5, 5, 3, 5, 5, 0], np.int32)
    q, kp, vp, tables = _chunk_inputs(rng, len(pos), 5, 8, 2, hd, 32, 16,
                                      pos, lens)
    args = (j(q), j(kp), j(vp), j(tables), j(pos), j(lens))
    y = paged_verify_attention(t(q), t(kp), t(vp), t(tables), t(pos),
                               t(lens))
    assert max_err(y, j_verify(*args, interpret=True)) < TOL


@pytest.mark.parametrize("ns", [1, 2, 3, 4, 7])
def test_splitk_verify_plain_matches_pallas(ns):
    """Split-K verify (partials + merge) vs the Pallas split-K kernel and
    the oracle, for divisor, non-divisor and ns > nbt fan-outs."""
    B, Sq, h, g, hd, bs, nbt = 4, 4, 8, 2, 16, 8, 5
    q, kp, vp, tables, pos, lens = _verify_case(ns, B, Sq, h, g, hd, bs, nbt)
    args = (j(q), j(kp), j(vp), j(tables), j(pos), j(lens))
    y_pl = j_verify_splitk(*args, num_splits=ns, interpret=True)
    y_ref = j_ref.paged_verify_ref(*args)
    y = paged_verify_attention_splitk(t(q), t(kp), t(vp), t(tables), t(pos),
                                      t(lens), num_splits=ns)
    assert max_err(y, y_ref) < TOL and max_err(y, y_pl) < TOL
    assert float(y[3].abs().max()) == 0.0


@pytest.mark.parametrize("ns", [1, 2, 4, 9])
def test_splitk_decode_plain_matches_pallas(ns):
    """Split-K decode (the Sq = 1, lens = 1 case), an inactive row
    included; ns = 9 exceeds nbt."""
    B, h, g, hd, bs, nbt = 3, 8, 2, 16, 8, 6
    rng = np.random.default_rng(40 + ns)
    pos = np.array([0, 13, 47], np.int32)
    q, kp, vp, tables = _chunk_inputs(rng, B, 1, h, g, hd, bs, nbt, pos,
                                      np.ones(B, np.int32))
    tables[0] = 0
    q = q[:, 0]
    args = (j(q), j(kp), j(vp), j(tables), j(pos))
    y_pl = j_decode_splitk(*args, num_splits=ns, interpret=True)
    y_ref = j_ref.paged_decode_ref(*args)
    y = paged_decode_attention_splitk(t(q), t(kp), t(vp), t(tables), t(pos),
                                      num_splits=ns)
    assert y.shape == (B, h, hd)
    assert max_err(y, y_ref) < TOL and max_err(y, y_pl) < TOL
    # the model passes its per-row lengths (ones for live rows) as ``lens``
    y_lens = paged_decode_attention_splitk(
        t(q), t(kp), t(vp), t(tables), t(pos), num_splits=ns,
        lens=torch.ones(B, dtype=torch.int32))
    assert torch.equal(y_lens, y)


def test_splitk_partials_have_the_kernel_contract():
    """Per-split partials: an empty split (past the walk) is exactly (0,
    NEG_INF, 0); merging the partials with the JAX ``lse_merge`` gives the
    oracle."""
    B, Sq, h, g, hd, bs, nbt, ns = 4, 4, 8, 2, 16, 8, 8, 4
    q, kp, vp, tables, pos, lens = _verify_case(5, B, Sq, h, g, hd, bs, nbt)
    o, m, l = splitk_partials(t(q), t(kp), t(vp), t(tables), t(pos),
                              t(lens), ns)
    assert o.shape == (B, ns, Sq, h, hd) and m.shape == l.shape \
        == (B, ns, Sq, h)
    # row 0 keys end at bs (block 0 only): splits 1.. are empty
    assert float(o[0, 1:].abs().max()) == 0.0
    assert bool((m[0, 1:] == NEG).all()) and float(l[0, 1:].abs().max()) == 0
    merged = j_lse_merge(j(o.numpy()), j(m.numpy()), j(l.numpy()))
    y_ref = j_ref.paged_verify_ref(j(q), j(kp), j(vp), j(tables), j(pos),
                                   j(lens))
    assert max_err(merged, y_ref) < TOL
    assert max_err(lse_merge(o, m, l, torch.float32), merged) < TOL


@pytest.mark.parametrize("case", ["random", "empty_split", "all_empty"])
def test_lse_merge_plain_matches_jax(case):
    rng = np.random.default_rng(9)
    B, ns, Sq, h, hd = 2, 3, 2, 4, 8
    o = rng.standard_normal((B, ns, Sq, h, hd)).astype(np.float32)
    m = (rng.standard_normal((B, ns, Sq, h)) * 4).astype(np.float32)
    l = rng.uniform(0.5, 3.0, (B, ns, Sq, h)).astype(np.float32)
    if case == "empty_split":
        o[:, 1], m[:, 1], l[:, 1] = 0.0, NEG, 0.0
    elif case == "all_empty":
        o[:], m[:], l[:] = 0.0, NEG, 0.0
    expect = np.asarray(j_lse_merge(j(o), j(m), j(l)))
    y = ref.lse_merge(t(o), t(m), t(l))
    assert max_err(y, expect) < TOL
    assert max_err(lse_merge(t(o), t(m), t(l), torch.float32), expect) < TOL
    if case == "all_empty":
        assert float(y.abs().max()) == 0.0 and torch.isfinite(y).all()


# ----------------------------------------------------------- split chooser
@hyp(lambda: [settings(max_examples=60, deadline=None),
              given(hd=st.sampled_from([64, 128]),
                    bs=st.sampled_from([16, 32]),
                    nbt=st.integers(1, 300), bh=st.integers(1, 600),
                    lanes=st.integers(1, 264))])
def test_heuristic_matches_jax_for_the_same_lanes(hd, bs, nbt, bh, lanes):
    """PROPERTY: the port's heuristic and modeled times equal the JAX
    package's for every shape and lane count."""
    assert tuple(autotune.heuristic(hd, bs, nbt, bh, lanes=lanes)) \
        == tuple(j_autotune.heuristic(hd, bs, nbt, bh, lanes=lanes))
    assert autotune.candidate_splits(nbt) == j_autotune.candidate_splits(nbt)
    for ns in autotune.candidate_splits(nbt):
        assert autotune.modeled_grid_time(bh, nbt, ns, lanes) \
            == j_autotune.modeled_grid_time(bh, nbt, ns, lanes)


def test_choose_uses_the_card_lane_prior():
    """Off the card the lanes are the H100 SXM's 132 SMs.  Keyed on the
    port's grid (Bd x 8 KV heads), the long-context shape (hd 128, bs 32,
    nbt 128, Bd 2) splits in eight (128 thread blocks) and the serving shape
    (nbt 16, Bd 8) in two; keyed as the JAX model keys it (Bd x 32 heads)
    the same shapes split in two and not at all.  Every choice is the JAX
    heuristic's for the same arguments, at 132 lanes and at JAX's own 16."""
    assert autotune.effective_lanes() == 132
    assert autotune.effective_lanes(torch.device("cpu")) == 132
    for key, ns in (((128, 32, 128, 16), 8), ((128, 32, 16, 64), 2),
                    ((128, 32, 128, 64), 2), ((128, 32, 16, 256), 1)):
        assert autotune.choose(*key).num_splits == ns
        assert j_autotune.heuristic(*key, lanes=132).num_splits == ns
        assert autotune.choose(*key, lanes=16) \
            == j_autotune.heuristic(*key, lanes=16)


@pytest.mark.parametrize("Bd,nbt,ns", [(2, 128, 8), (8, 16, 2),
                                        (1, 4, 1)])
def test_unified_forward_keys_the_split_on_kv_heads(monkeypatch, Bd, nbt,
                                                    ns):
    """The model asks ``choose`` once per forward with ``bh = Bd *
    n_kv_heads`` (one thread block per request and KV head), and walks with
    the split it answers: at llama3-8b's head shapes (32 heads over 8 KV
    heads, hd 128, bs 32) the long-context decode bucket (Bd 2, nbt 128)
    splits in eight at 132 lanes, a short table (nbt 4) not at all."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import model as TM
    from repro_torch.models.schema import init_params
    from repro_torch.models.stream import DECBatch, UnifiedBatch
    cfg = dataclasses.replace(get_reduced("llama3-8b"), n_heads=32,
                              n_kv_heads=8, head_dim=128, n_layers=1)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu", dtype=torch.float32)
    bs = 32
    cache = TM.init_paged_cache(cfg, nbt * Bd + 1, bs, torch.device("cpu"),
                                torch.float32)
    asked, walked = [], []
    real_choose = autotune.choose
    monkeypatch.setattr(autotune, "choose", lambda *a, **k: asked.append(
        (a, k)) or real_choose(*a, **k))
    monkeypatch.setattr(TM, "paged_decode_attention_splitk",
                        lambda *a, num_splits, **k: walked.append(num_splits)
                        or torch.zeros_like(a[0]))
    tables = torch.arange(Bd * nbt, dtype=torch.int32).reshape(Bd, nbt) + 1
    pos = torch.full((Bd,), nbt * bs - 2, dtype=torch.int32)
    dec = DECBatch(tokens=torch.zeros((Bd,), dtype=torch.int32), pos=pos,
                   adapter=torch.full((Bd,), -1, dtype=torch.int32),
                   block_tables=tables,
                   length=torch.ones((Bd,), dtype=torch.int32))
    out = TM.unified_forward(cfg, params, UnifiedBatch(dec=dec), cache,
                             block_t=8)
    assert len(asked) == 1
    (hd, bsz, width, bh), kw = asked[0]
    assert (hd, bsz, width, bh) == (cfg.hd, bs, nbt, Bd * cfg.n_kv_heads)
    assert kw["lanes"] == 132
    assert real_choose(*asked[0][0], **kw).num_splits == ns
    assert walked == ([ns] * cfg.n_layers if ns > 1 else [])
    assert torch.isfinite(out.dec_logits).all()


def test_table_round_trip_with_jax_and_memo_follows_version(tmp_path):
    """The port writes and reads the JAX package's JSON layout; a table
    entry overrides the (memoized) heuristic and clearing restores it."""
    key = (128, 32, 128, 64)
    p_port, p_jax = tmp_path / "port.json", tmp_path / "jax.json"
    try:
        assert autotune.choose(*key, lanes=132).num_splits == 2
        v0 = autotune.table_version()
        autotune.put_config(key, autotune.AttnConfig(256, 8))
        assert autotune.table_version() == v0 + 1
        assert autotune.choose(*key, lanes=132).num_splits == 8
        assert autotune.save_table(str(p_port)) == 1
        assert j_autotune.load_table(str(p_port)) == 1
        assert tuple(j_autotune.get_config(key)) == (256, 8)
        j_autotune.put_config((64, 16, 32, 4), j_autotune.AttnConfig(512, 4))
        j_autotune.save_table(str(p_jax))
        autotune.clear_table()
        assert autotune.choose(*key, lanes=132).num_splits == 2
        assert autotune.load_table(str(p_jax)) == 2
        assert autotune.get_config((64, 16, 32, 4)) == (512, 4)
        assert autotune.get_config(key) == (256, 8)
        doc = json.loads(p_port.read_text())
        assert doc == {"entries": {"128,32,128,64": [256, 8]}, "lanes": 132}
    finally:
        autotune.clear_table()
        j_autotune.clear_table()


def test_sweep_picks_the_measured_best():
    shapes = [(128, 32, 128, 64), (128, 32, 16, 256)]
    try:
        got = autotune.sweep(shapes, measure=lambda key, cfg: abs(
            cfg.num_splits - 4))
        assert [c.num_splits for c in got.values()] == [4, 4]
        assert autotune.choose(*shapes[0]).num_splits == 4
        modeled = autotune.sweep(shapes, lanes=132)
        assert {k: tuple(v) for k, v in modeled.items()} == {
            k: tuple(v) for k, v in j_autotune.sweep(shapes, lanes=132)
            .items()}
    finally:
        autotune.clear_table()
        j_autotune.clear_table()
