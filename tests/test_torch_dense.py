"""The port's dense-row KV layout and cold prefill against the JAX package,
on the CPU in fp32.

* ``flash_attention`` / ``decode_attention`` (``kernels.ops``; on CPU tensors
  their plain versions ``flash_attention_ref`` / ``decode_attention_ref``)
  against the Pallas kernels in interpret mode, tolerance 3e-5 (fp32 on both
  sides, another summation order).  The Pallas decode kernel is held only
  where ``window == 0`` or ``S % block_k == 0``: elsewhere it lets a padded
  zero key into a rolling row's softmax (shown below, ROADMAP Queue 3).
* ``init_cache``, ``CacheManager`` and the dense model path (prefill, decode
  and a mixed tick) against the JAX model on the reduced llama3 (2 layers,
  d_model 256) with JAX weights crossed over through the bridge, logits
  within 1e-4.
* The dense engine under the virtual clock: the same greedy tokens as the
  JAX dense engine and as the port's paged engine.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.kernels import decode_attn as jdecode
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, PFBatch as JPF, \
    UnifiedBatch as JUB
from repro.serving import kvcache as jkv
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request

TOL_KERNEL = 3e-5
TOL_MODEL = 1e-4
BT = 8
CPU = torch.device("cpu")


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- kernels
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,T,h,g,hd,bq,bk", [
    (1, 8, 8, 2, 2, 8, 8, 8),
    (2, 20, 20, 4, 2, 16, 8, 8),
    (2, 17, 33, 8, 8, 32, 8, 16),   # MHA, S != T, ragged -> padding paths
    (3, 40, 40, 8, 2, 16, 16, 8),
])
def test_flash_attention_matches_pallas(causal, B, S, T, h, g, hd, bq, bk):
    """The shapes of ``test_kernels.py::test_flash_attention_sweep``, causal
    and not, ragged lengths with a 0 (that row is exactly 0)."""
    rng = np.random.default_rng(B * S + T)
    q, k, v = (_normal(rng, s) for s in ((B, S, h, hd), (B, T, g, hd),
                                         (B, T, g, hd)))
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = 0
    want = jops.flash_attention(j(q), j(k), j(v), j(lens), causal=causal,
                                block_q=bq, block_k=bk, interpret=True)
    got = ops.flash_attention(t(q), t(k), t(v), t(lens), causal=causal,
                              block_q=bq, block_k=bk)
    assert max_err(got, want) < TOL_KERNEL
    assert float(got[0].abs().max()) == 0.0
    assert max_err(got, jref.flash_attention_ref(j(q), j(k), j(v), j(lens),
                                                 causal=causal)) < TOL_KERNEL


@pytest.mark.parametrize("B,h,g,hd,S,bk", [
    (2, 4, 4, 8, 16, 8),       # MHA
    (3, 8, 2, 16, 40, 8),      # GQA, S % block_k == 0
    (1, 8, 8, 32, 64, 16),
    (2, 8, 2, 32, 48, 32),     # ragged length -> padding path (window 0)
])
def test_decode_attention_linear_matches_pallas(B, h, g, hd, S, bk):
    rng = np.random.default_rng(B * S)
    q, k, v = (_normal(rng, s) for s in ((B, h, hd), (B, S, g, hd),
                                         (B, S, g, hd)))
    pos = rng.integers(0, S, B).astype(np.int32)
    want = jdecode.decode_attention(j(q), j(k), j(v), j(pos), block_k=bk,
                                    interpret=True)
    got = ops.decode_attention(t(q), t(k), t(v), t(pos), block_k=bk)
    assert max_err(got, want) < TOL_KERNEL


@pytest.mark.parametrize("window", [0, 8, 16])
@pytest.mark.parametrize("pos_val", [3, 15, 16, 47, 1000])
def test_decode_attention_rolling_matches_pallas(window, pos_val):
    """The rolling cases of ``test_decode_kernel.py::
    test_decode_rolling_window`` (W=16, block_k=8), the same wrapped rows
    with window 0 (every slot valid once pos >= S), and a window narrower
    than the row (W=8 over 16 slots)."""
    B, h, g, hd, S = 2, 4, 2, 16, 16
    rng = np.random.default_rng(pos_val)
    q, k, v = (_normal(rng, s) for s in ((B, h, hd), (B, S, g, hd),
                                         (B, S, g, hd)))
    pos = np.array([pos_val, max(pos_val - 2, 0)], np.int32)
    want = jdecode.decode_attention(j(q), j(k), j(v), j(pos), block_k=8,
                                    window=window, interpret=True)
    got = ops.decode_attention(t(q), t(k), t(v), t(pos), window=window)
    assert max_err(got, want) < TOL_KERNEL
    if window in (0, S):      # the JAX oracle has no narrower window
        assert max_err(got, jref.decode_attention_ref(
            j(q), j(k), j(v), j(pos))) < TOL_KERNEL


def test_pallas_decode_padding_fault_and_port_follows_the_function():
    """The Pallas kernel pads the row to a multiple of block_k with zeros
    but rebuilds rolling positions with the unpadded S: at S=48, block_k=32,
    window=48, pos=100 padded slot 50 maps to position 98 and its zero key
    enters the softmax.  The port computes the function (the JAX oracle);
    with block_k=16 (no padding) the kernel agrees with it."""
    B, h, g, hd, S, W = 1, 4, 2, 32, 48, 48
    rng = np.random.default_rng(7)
    q, k, v = (_normal(rng, s) for s in ((B, h, hd), (B, S, g, hd),
                                         (B, S, g, hd)))
    pos = np.array([100], np.int32)
    oracle = jref.decode_attention_ref(j(q), j(k), j(v), j(pos))
    padded = jdecode.decode_attention(j(q), j(k), j(v), j(pos), block_k=32,
                                      window=W, interpret=True)
    exact = jdecode.decode_attention(j(q), j(k), j(v), j(pos), block_k=16,
                                     window=W, interpret=True)
    got = ops.decode_attention(t(q), t(k), t(v), t(pos), window=W)
    assert max_err(padded, oracle) > 1e-2
    assert max_err(got, padded) > 1e-2
    assert max_err(got, oracle) < TOL_KERNEL
    assert max_err(exact, oracle) < TOL_KERNEL


def test_paged_decode_plain_matches_dense_decode_plain():
    """The twin of ``test_decode_kernel.py::
    test_paged_kernel_matches_dense_kernel``: the paged and the dense decode
    are the same attention once each request's blocks are laid out
    contiguously."""
    B, h, g, hd, bs, nbt, n_blocks = 2, 4, 2, 16, 8, 4, 16
    rng = np.random.default_rng(0)
    kp, vp = (_normal(rng, (n_blocks, bs, g, hd)) for _ in range(2))
    tables = np.stack([rng.choice(np.arange(1, n_blocks), nbt, replace=False)
                       for _ in range(B)]).astype(np.int32)
    q = _normal(rng, (B, h, hd))
    pos = np.array([13, 30], np.int32)
    paged = ref.paged_decode_ref(t(q), t(kp), t(vp), t(tables), t(pos))
    kd = kp[tables].reshape(B, nbt * bs, g, hd)
    vd = vp[tables].reshape(B, nbt * bs, g, hd)
    dense = ref.decode_attention_ref(t(q), t(kd), t(vd), t(pos))
    assert max_err(paged, dense) < 2e-5


@pytest.mark.parametrize("sc", [8, 16])
def test_dec_cache_pos_matches_jax(sc):
    pos = np.array([0, 3, 7, 8, 15, 16, 47, 1000], np.int32)
    kp, kv = TL.dec_cache_pos(t(pos), sc)
    jkp, jkv = JM._dec_cache_pos(j(pos), sc)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jkp))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_planner_matches_jax(seed):
    """Dense-row buckets carry no tables and no ``cached_len``: the port's
    planner builds the JAX planner's prefill and decode buckets."""
    from repro.core import flow as jflow
    from repro_torch.core import flow as tflow
    rng = np.random.default_rng(seed)
    reqs = [dict(tokens=rng.integers(0, 512, int(rng.integers(1, 70))
                                     ).astype(np.int32),
                 slot=int(rng.integers(-1, 4)))
            for _ in range(int(rng.integers(1, 5)))]
    dec = (rng.integers(0, 512, 4), rng.integers(0, 90, 4),
           rng.integers(-1, 4, 4))
    jb = jflow.assemble([], [jflow.PFReq(**r) for r in reqs], *dec,
                        jflow.FlowConfig(block_t=BT))
    tb = tflow.assemble([tflow.PFReq(**r) for r in reqs], *dec,
                        tflow.FlowConfig(block_t=BT), CPU)
    assert tb.pf.block_tables is None and tb.pf.cached_len is None
    assert tb.dec.block_tables is None and jb.dec.block_tables is None
    for f in ("tokens", "length", "adapter"):
        np.testing.assert_array_equal(getattr(tb.pf, f).numpy(),
                                      np.asarray(getattr(jb.pf, f)))
    for f in ("tokens", "pos", "adapter"):
        np.testing.assert_array_equal(getattr(tb.dec, f).numpy(),
                                      np.asarray(getattr(jb.dec, f)))


# ------------------------------------------------------------- cache
@pytest.mark.parametrize("window,s_max", [(0, 32), (8, 32), (64, 32)])
def test_init_cache_layout_matches_jax(window, s_max):
    """JAX ``[n_periods, rows, sc, g, hd]`` per pattern position is the
    port's ``[L, rows, sc, g, hd]`` (attention-only pattern, period axis
    unrolled); ``cache_seq_len`` clips rolling rows to the window."""
    jcfg = j_get_reduced("llama3-8b").replace(sliding_window=window)
    cfg = get_reduced("llama3-8b").replace(sliding_window=window)
    assert TM.cache_seq_len(cfg, s_max) == JM.cache_seq_len(jcfg, s_max)
    if window:
        with pytest.raises(NotImplementedError):
            TM.init_cache(cfg, 3, s_max, CPU, torch.float32)
        return
    jc = JM.init_cache(jcfg, 3, s_max)["layers"]
    tc = TM.init_cache(cfg, 3, s_max, CPU, torch.float32)
    assert len(jc) == 1 and jcfg.n_periods == cfg.n_layers
    for kv in ("k", "v"):
        assert tuple(tc[kv].shape) == tuple(jc[0][kv].shape)
        assert str(tc[kv].dtype)[6:] == str(jc[0][kv].dtype)
        assert not tc[kv].any()


def _managers(capacity=3, pf_capacity=2, s_max=8):
    jcfg, cfg = j_get_reduced("llama3-8b"), get_reduced("llama3-8b")
    jm = jkv.CacheManager(jcfg, capacity, pf_capacity, s_max)
    tm = tkv.CacheManager(cfg, capacity, pf_capacity, s_max, device=CPU,
                          dtype=torch.float32)
    rng = np.random.default_rng(1)
    full = {kv: _normal(rng, tuple(tm.cache[kv].shape)) for kv in "kv"}
    jm.cache = {"layers": ({kv: j(full[kv]) for kv in "kv"},)}
    for kv in "kv":
        tm.cache[kv].copy_(t(full[kv]))
    return jm, tm


def _same_cache(jm, tm):
    for kv in "kv":
        np.testing.assert_array_equal(tm.cache[kv].numpy(),
                                      np.asarray(jm.cache["layers"][0][kv]))
    np.testing.assert_array_equal(tm.lens, jm.lens)
    assert tm.n_free == jm.n_free


def test_cache_manager_lifecycle_matches_jax():
    """alloc/free order, lengths, ``truncate``, ``commit_tokens`` and
    ``commit_prefill`` (both bases) step by step against the JAX manager."""
    jm, tm = _managers()
    got = [(jm.alloc(), tm.alloc()) for _ in range(4)]
    assert [a for a, _ in got] == [b for _, b in got] == [0, 1, 2, None]
    for m in (jm, tm):
        m.free(1)
        m.commit_prefill([(0, 1), (1, 0)], [5, 3], src_base=3)
        m.commit_tokens(1, [7])
        m.commit_tokens(0, [1, 2])
        m.truncate(0, 4)
    _same_cache(jm, tm)
    assert list(tm.lens) == [4, 6, 0]
    for m in (jm, tm):
        m.free(0)
        m.free(2)
    assert [jm.alloc() for _ in range(3)] == [tm.alloc() for _ in range(3)]
    _same_cache(jm, tm)
    assert not tm.pristine
    for m in (jm, tm):
        for s in range(3):
            m.free(s)
    assert tm.pristine


def test_commit_prefill_with_overlapping_rows_matches_jax():
    """A prefill-only tick: sources are rows 0..n-1 and overlap the
    destination slots (here a swap and a chain); every source row is read
    before any destination row is written."""
    jm, tm = _managers(capacity=3, pf_capacity=3)
    before = tm.cache["k"].clone()
    for m in (jm, tm):
        m.commit_prefill([(0, 1), (1, 0), (2, 2)], [2, 4, 6], src_base=0)
    _same_cache(jm, tm)
    assert torch.equal(tm.cache["k"][:, 0], before[:, 1])
    assert torch.equal(tm.cache["k"][:, 1], before[:, 0])


# ------------------------------------------------------------- model
@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bridge")
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    jstore.load_random("a0", jax.random.PRNGKey(2))
    jstore.load_random("a1", jax.random.PRNGKey(3))
    return dict(jcfg=jcfg, jparams=jparams, jbank=jstore.bank,
                jscale=jstore.scale, cfg=get_reduced("llama3-8b"),
                params=to_port_params(jparams, tmp / "params.npz"),
                bank=to_port_bank(jstore.bank, tmp / "bank.npz"),
                scale=t(np.asarray(jstore.scale)))


def _forward(w, cache, pf=None, dec=None, loras=True):
    """One forward on both sides: ``pf``/``dec`` are dicts of numpy
    arrays, dense rows (no tables).  Returns (JAX out, port out)."""
    jb, tb = {}, {}
    if pf is not None:
        jb["pf"] = JPF(tokens=j(pf["tokens"]), length=j(pf["length"]),
                       adapter=j(pf["adapter"]))
        tb["pf"] = PFBatch(tokens=t(pf["tokens"]), length=t(pf["length"]),
                           adapter=t(pf["adapter"]))
    if dec is not None:
        jb["dec"] = JDEC(tokens=j(dec["tokens"]), pos=j(dec["pos"]),
                         adapter=j(dec["adapter"]))
        tb["dec"] = DECBatch(tokens=t(dec["tokens"]), pos=t(dec["pos"]),
                             adapter=t(dec["adapter"]))
    jout = JM.unified_forward(w["jcfg"], w["jparams"], JUB(**jb), cache["j"],
                              loras=w["jbank"] if loras else None,
                              lora_scale=w["jscale"] if loras else None)
    tout = TM.unified_forward(w["cfg"], w["params"], UnifiedBatch(**tb),
                              cache["t"], loras=w["bank"] if loras else None,
                              lora_scale=w["scale"] if loras else None,
                              block_t=BT)
    cache["j"] = jout.cache
    for name in ("pf_logits", "dec_logits"):
        a, b = getattr(tout, name), getattr(jout, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert max_err(a, b) < TOL_MODEL, name
    for kv in "kv":
        assert max_err(tout.cache[kv],
                       np.asarray(jout.cache["layers"][0][kv])) < TOL_MODEL
    return jout, tout


def _caches(w, rows, s_max):
    return {"j": JM.init_cache(w["jcfg"], rows, s_max),
            "t": TM.init_cache(w["cfg"], rows, s_max, CPU, torch.float32)}


def _i32(x):
    return np.asarray(x, np.int32)


def test_prefill_then_decode_matches_full_and_jax(weights):
    """The twin of ``test_cache_equivalence.py::
    test_prefill_then_decode_matches_full[llama3-8b]``: prefill 10 tokens
    into dense rows, decode 3 one at a time (logits and rows against JAX at
    every step), and the last decode logits equal a full prefill of all 13
    tokens."""
    w = weights
    B, S, extra = 2, 10, 3
    toks = np.random.default_rng(1).integers(0, w["cfg"].vocab,
                                             (B, S + extra)).astype(np.int32)
    base = _i32([-1, -1])
    cache = _caches(w, B, 32)
    _forward(w, cache, pf=dict(tokens=toks[:, :S], length=_i32([S, S]),
                               adapter=base), loras=False)
    for i in range(extra):
        _, out = _forward(w, cache, dec=dict(tokens=toks[:, S + i],
                                             pos=_i32([S + i] * B),
                                             adapter=base), loras=False)
    full = _caches(w, B, 32)
    _, ref_out = _forward(w, full, pf=dict(tokens=toks,
                                           length=_i32([S + extra] * B),
                                           adapter=base), loras=False)
    assert max_err(out.dec_logits, ref_out.pf_logits) < TOL_MODEL


def test_padded_prefill_rows_do_not_corrupt(weights):
    """The twin of ``test_cache_equivalence.py::
    test_padded_prefill_rows_do_not_corrupt``: right padding (here a second
    bucket width) leaves the logits of the valid tokens unchanged."""
    w = weights
    toks = np.random.default_rng(3).integers(0, w["cfg"].vocab,
                                             (1, 8)).astype(np.int32)
    base = _i32([-1])
    _, tight = _forward(w, _caches(w, 1, 32), pf=dict(
        tokens=toks, length=_i32([8]), adapter=base), loras=False)
    padded = np.concatenate([toks, np.full((1, 8), 7, np.int32)], 1)
    _, pad = _forward(w, _caches(w, 1, 32), pf=dict(
        tokens=padded, length=_i32([8]), adapter=base), loras=False)
    assert max_err(tight.pf_logits, pad.pf_logits) < 2e-5


def test_mixed_tick_on_dense_rows_matches_jax(weights):
    """Adapters with nonzero B, a cold prefill into rows [0, 2), their rows
    committed to slots, then one tick holding decode rows (one inactive)
    and a new prefill written at rows [Bd, Bd + Bp)."""
    w = weights
    rng = np.random.default_rng(4)
    V = w["cfg"].vocab
    cap, pf_cap = 3, 2
    cache = _caches(w, cap + pf_cap, 32)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :13], toks[1, :9] = rng.integers(0, V, 13), rng.integers(0, V, 9)
    jout, _ = _forward(w, cache, pf=dict(tokens=toks, length=_i32([13, 9]),
                                         adapter=_i32([0, 1])))
    nxt = np.asarray(jout.pf_logits).argmax(-1)
    # commit prefill rows 0, 1 to slots 2, 0 (JAX's row copy on both sides)
    jrows = jkv._commit(cache["j"], jnp.asarray([0, 1]), jnp.asarray([2, 0]))
    cache["j"] = jrows
    for kv in "kv":
        c = cache["t"][kv]
        c[:, torch.tensor([2, 0])] = c[:, torch.tensor([0, 1])]
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = rng.integers(0, V, 11)
    _forward(w, cache, pf=dict(tokens=toks, length=_i32([11]),
                               adapter=_i32([0])),
             dec=dict(tokens=_i32([nxt[1], 0, nxt[0]]),
                      pos=_i32([9, 0, 13]), adapter=_i32([1, -1, 0])))


def test_dense_buckets_the_port_does_not_serve(weights):
    """Verify chunks on dense rows (the JAX engine runs speculation on the
    paged layout only) raise; so does a sliding-window model."""
    w = weights
    cache = TM.init_cache(w["cfg"], 2, 16, CPU, torch.float32)
    batch = UnifiedBatch(dec=DECBatch(tokens=torch.zeros((2, 3),
                                                         dtype=torch.int32),
                                      pos=torch.zeros(2, dtype=torch.int32),
                                      adapter=torch.full((2,), -1,
                                                         dtype=torch.int32)))
    with pytest.raises(NotImplementedError):
        TM.unified_forward(w["cfg"], w["params"], batch, cache, block_t=BT)
    with pytest.raises(NotImplementedError):
        TM.unified_forward(w["cfg"].replace(sliding_window=8), w["params"],
                           batch, cache, block_t=BT)


def test_bucket_longer_than_row_takes_jax_rolling_write(weights):
    """A 34-token prompt pads to a 64-token bucket, longer than a 40-slot
    row: the JAX model keeps the bucket's last 40 positions at slots p % 40,
    so padding positions 40..63 overwrite the prompt's slots 0..23.  The
    port mirrors it (same rows and logits as JAX), and a decode over those
    rows differs from one over a tight 40-token bucket (ROADMAP Queue 3)."""
    w = weights
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, w["cfg"].vocab, 34).astype(np.int32)
    base = _i32([-1])
    logits = {}
    for width in (64, 40):
        toks = np.zeros((1, width), np.int32)
        toks[0, :34] = prompt
        cache = _caches(w, 1, 40)
        jout, _ = _forward(w, cache, pf=dict(tokens=toks, length=_i32([34]),
                                             adapter=base), loras=False)
        nxt = np.asarray(jout.pf_logits).argmax(-1)
        _, out = _forward(w, cache, dec=dict(tokens=_i32(nxt), pos=_i32([34]),
                                             adapter=base), loras=False)
        logits[width] = out.dec_logits
    assert max_err(logits[64], logits[40]) > 1e-3


# ------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engines_pair(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    w = weights
    jstore = JAdapterStore(w["jcfg"], JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    jstore.load_random("serve", jax.random.PRNGKey(2))
    store = AdapterStore(w["cfg"], LoRAConfig(n_slots=4, r=4), device="cpu")
    store.load("serve", to_port_bank(jstore.get_adapter("serve"),
                                     tmp / "serve.npz"))
    return jstore, store


def _serve(w, stores, trace, jax_side=True, **ecfg):
    jstore, store = stores
    kw = dict(dict(capacity=4, pf_capacity=2, s_max=64, virtual_time=True),
              **ecfg)
    eng = UnifiedEngine(MixedLoraModel(w["cfg"], w["params"], store),
                        EngineConfig(**kw))
    for rid, prompt, max_new, arrival in trace:
        eng.submit(Request(rid=rid, prompt=prompt, adapter="serve",
                           max_new_tokens=max_new, arrival=arrival))
    eng.run(max_ticks=5000)
    out = {r.rid: list(r.output) for r in eng.finished}
    jout = None
    if jax_side:
        jeng = JUnifiedEngine(JMixedLoraModel(w["jcfg"], w["jparams"],
                                              jstore), JEngineConfig(**kw))
        for rid, prompt, max_new, arrival in trace:
            jeng.submit(JRequest(rid=rid, prompt=prompt, adapter="serve",
                                 max_new_tokens=max_new, arrival=arrival))
        jeng.run(max_ticks=5000)
        jout = {r.rid: list(r.output) for r in jeng.finished}
        assert eng.metrics.steps == jeng.metrics.steps
    assert eng.cachemgr.pristine
    return eng, out, jout


def _paged_cache_trace(vocab, n=6, seed=3):
    """The stream of ``test_paged_cache.py::
    test_engine_paged_matches_dense_outputs``."""
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, rng.integers(4, 20)).astype(np.int32),
             5, 0.2 * i) for i in range(n)]


def test_dense_engine_matches_jax_dense_and_port_paged(weights,
                                                       engines_pair):
    w = weights
    trace = _paged_cache_trace(w["cfg"].vocab)
    eng, dense, jdense = _serve(w, engines_pair, trace, paged=False)
    assert isinstance(eng.cachemgr, tkv.CacheManager)
    assert len(dense) == 6 and all(len(v) == 5 for v in dense.values())
    assert dense == jdense
    _, paged, _ = _serve(w, engines_pair, trace, jax_side=False, paged=True,
                         block_size=16)
    assert dense == paged


def test_dense_engine_turns_speculation_off_as_jax_does(weights,
                                                        engines_pair):
    """``spec`` on dense rows is ignored (JAX ``engine.py:171-173``): plain
    decode ticks, the same tokens as without it."""
    from repro.spec import SpecConfig as JSpecConfig
    from repro_torch.spec import SpecConfig
    w = weights
    trace = _paged_cache_trace(w["cfg"].vocab, n=4, seed=6)
    eng, out, _ = _serve(w, engines_pair, trace, jax_side=False, paged=False,
                         spec=SpecConfig(k_max=3))
    assert eng.spec is None and eng.metrics.spec_steps == 0
    jeng = JUnifiedEngine(JMixedLoraModel(w["jcfg"], w["jparams"],
                                          engines_pair[0]),
                          JEngineConfig(capacity=4, pf_capacity=2, s_max=64,
                                        virtual_time=True, paged=False,
                                        spec=JSpecConfig(k_max=3)))
    assert jeng.spec is None
    _, plain, _ = _serve(w, engines_pair, trace, jax_side=False, paged=False)
    assert out == plain


def test_dense_engine_long_bucket_matches_jax(weights, engines_pair):
    """The JAX dense engine reaches the rolling write: prompts of 34-40
    tokens pad to a 64-token bucket over 48-slot rows (admission checks
    only a free slot), so the bucket's padding overwrites each prompt's
    first 16 slots (ROADMAP Queue 3).  The port's dense engine emits the
    JAX dense engine's tokens there too."""
    w = weights
    rng = np.random.default_rng(8)
    trace = [(i, rng.integers(0, w["cfg"].vocab, 34 + 2 * i).astype(
        np.int32), 4, 0.1 * i) for i in range(4)]
    with pytest.warns(RuntimeWarning, match="48 slots.*64-token bucket"):
        _, dense, jdense = _serve(w, engines_pair, trace, paged=False,
                                  s_max=48)
    assert dense == jdense and len(dense) == 4
    # the fault, mirrored: first tokens come from the prefill logits and
    # agree with the paged engine; decode then reads the overwritten slots
    _, paged, _ = _serve(w, engines_pair, trace, jax_side=False, s_max=48)
    assert all(dense[i][0] == paged[i][0] for i in dense)
    assert dense != paged


@pytest.mark.parametrize("s_max,warns", [(48, True), (64, False),
                                         (512, False)])
def test_dense_engine_warns_when_a_bucket_outgrows_the_row(weights,
                                                           engines_pair,
                                                           s_max, warns):
    """Dense rows whose length is not a padded prompt bucket warn at
    construction (the rolling write of the test above); the paged layout
    and dense rows of a bucket's length do not."""
    import warnings
    store = engines_pair[1]
    model = MixedLoraModel(weights["cfg"], weights["params"], store)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        UnifiedEngine(model, EngineConfig(capacity=2, pf_capacity=1,
                                          s_max=s_max, paged=False))
        UnifiedEngine(model, EngineConfig(capacity=2, pf_capacity=1,
                                          s_max=s_max))
    hits = [w for w in seen if issubclass(w.category, RuntimeWarning)
            and "padded prompt bucket" in str(w.message)]
    assert len(hits) == int(warns)
