"""The port's Mamba2 family (``mamba2-1.3b``, attention-free, and the hybrid
``jamba-1.5-large-398b``: Mamba2 and attention layers, MoE on every other
layer) against the JAX package, in fp32 on the CPU at reduced size
(``mamba2``: 2 layers, d_model 256, 16 heads of 32, d_state 16, chunk 16;
``jamba``: 4 layers, the attention layer at position 1, 4 experts top-2).

JAX weights and LoRA banks cross over through the bridge; other inputs are
made from numpy seeds and handed to both packages.

* ``models.mamba`` (``causal_conv``, ``ssd_chunked``, ``ssd_step``) against
  the JAX functions on the same inputs, to 1e-5 of max(1, max |y|), and
  twins of ``tests/test_mamba_moe.py``'s four SSD/conv properties with
  their tolerances; the chunk loop under ``torch.utils.checkpoint`` has the
  plain loop's gradient.
* Twins of ``test_cache_equivalence.py::test_prefill_then_decode_matches_
  full``, ``test_paged_cache.py::test_paged_forward_matches_dense`` and
  ``::test_cow_leaves_state_rows_untouched``, each held to its own property
  with the JAX test's tolerance and to the JAX package (logits and cache
  leaves within 1e-4 of max(1, max |JAX|)).
* The mixed ``unified_forward`` (ft rows beside a cold paged prefill, then
  paged decode with an inactive row, then a prefill beside decode) against
  JAX's, every cache leaf included; the ft grad step (loss 1e-5 relative,
  bank grads 1e-4 of a leaf's max |JAX|).
* The engine's greedy tokens equal the JAX engine's: dedup on (hits
  counted, prompts recomputed whole), speculation requested and turned
  off, lending with preemptions, dense rows, and a 2-replica ``jamba``
  fleet with ``import_block`` (k/v copied, state rows untouched).
* The JAX conv-state fault: a prompt prefilled tight and padded to its
  bucket gives the same prefill logits but different decode logits in
  JAX, and the port gives JAX's numbers in both cases.
* int8 weights: the twin of ``test_quant.py::test_int8_forward_close_to_
  bf16[mamba2-1.3b]``, and at 64 SSM heads (d_model 2048, 2 layers) where
  ``in_dt`` is eligible, ``quantize_params`` bit-equal to JAX's and the
  int8 forward equal to JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_make_grad_step
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.data import datasets, workload
from repro.fleet import FleetConfig as JFleetConfig, \
    RouterConfig as JRouterConfig, build_fleet as j_build_fleet
from repro.models import mamba as JMB, model as JM, quant as jquant
from repro.models.configs import SSMConfig as JSSMConfig
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.serving import kvcache as JK
from repro.serving.clock import CostModel as JCostModel
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_grad_step
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
from repro_torch.models import mamba as TMB, model as TM, quant
from repro_torch.models.configs import SSMConfig
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.serving import kvcache as TK
from repro_torch.serving.clock import CostModel
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request
from repro_torch.spec import SpecConfig

MAMBA, JAMBA = "mamba2-1.3b", "jamba-1.5-large-398b"
ARCHS = [MAMBA, JAMBA]
TOL, LOSS_REL, GRAD_REL, SSD_REL = 1e-4, 1e-5, 1e-4, 1e-5
BT, BS, NB, NBT = 8, 8, 24, 6
LCFG = dict(n_slots=4, r=4)
CPU = torch.device("cpu")
TBL4 = np.array([[3, 1, 7, 5], [2, 6, 4, 8]], np.int32)   # interleaved

_SETUPS = {}


def _setup(arch, tmp):
    """JAX weights, a JAX store with two nonzero-B adapters, and their
    bridged port copies (made once per arch)."""
    if arch not in _SETUPS:
        jcfg = j_get_reduced(arch)
        jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
        jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG),
                               jax.random.PRNGKey(1))
        jstore.load_random("a0", jax.random.PRNGKey(2))
        jstore.load_random("a1", jax.random.PRNGKey(3))
        name = arch.replace(".", "_")
        _SETUPS[arch] = dict(
            jcfg=jcfg, jparams=jparams, jbank=jstore.bank,
            jscale=jstore.scale, cfg=get_reduced(arch), tmp=tmp,
            params=to_port_params(jparams, tmp / f"{name}_p.npz"),
            bank=to_port_bank(jstore.bank, tmp / f"{name}_b.npz"),
            scale=t(np.asarray(jstore.scale)))
    return _SETUPS[arch]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("mamba")


@pytest.fixture(params=ARCHS, scope="module")
def s(request, tmp):
    return _setup(request.param, tmp)


@pytest.fixture(scope="module")
def sj(tmp):
    return _setup(JAMBA, tmp)


def _i32(x):
    return np.asarray(x, np.int32)


def _close(a, b, rel=TOL):
    b = np.asarray(b)
    assert a is not None and torch.isfinite(a).all()
    return max_err(a, b) <= rel * max(1.0, float(np.abs(b).max()))


def _jax_leaf(cfg, jcache, name):
    """JAX's ``name`` leaves in the port's layout: the layers that carry
    it, in layer order (pattern position ``li % P``, period ``li // P``)."""
    P = len(cfg.pattern)
    return np.stack([np.asarray(jcache["layers"][li % P][name][li // P])
                     for li in range(cfg.n_layers)
                     if name in jcache["layers"][li % P]])


def _same_cache(cfg, tcache, jcache, skip_null=True):
    """Every port leaf equals JAX's; block 0 of a block leaf is the null
    block (garbage) unless ``skip_null`` is off."""
    assert list(tcache) == list(TM.cache_leaves(cfg))
    for name, leaf in tcache.items():
        lo = 1 if skip_null and name not in TM.STATE_KEYS else 0
        assert _close(leaf[:, lo:], _jax_leaf(cfg, jcache, name)[:, lo:]), \
            name


# ------------------------------------------------------------ SSD / conv
def _ssd_inputs(seed, B, S, nh, hd, ds):
    """``test_mamba_moe.py``'s input distribution, from a numpy seed."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x = f(B, S, nh, hd) * 0.5
    dt = np.logaddexp(f(B, S, nh), 0.0).astype(np.float32)
    A = -np.exp(f(nh) * 0.3)
    return x, dt, A, f(B, S, nh, ds) * 0.3, f(B, S, nh, ds) * 0.3


def _ssd_close(got, want):
    want = np.asarray(want)
    return max_err(got, want) <= SSD_REL * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("S,chunk,seed", [(1, 4, 0), (13, 4, 1),
                                          (40, 16, 2), (17, 8, 3)])
def test_ssd_chunked_matches_jax_and_stepwise(S, chunk, seed):
    """``ssd_chunked`` and a loop of ``ssd_step`` each equal JAX's on the
    same inputs (1e-5 of max |y|), and each other (2e-4, the JAX test's
    tolerance); under ``torch.utils.checkpoint`` the chunk loop gives the
    same values and gradients as the plain loop."""
    B, nh, hd, ds = 2, 3, 8, 8
    x, dt, A, Bm, Cm = _ssd_inputs(seed, B, S, nh, hd, ds)
    jy, jh = JMB.ssd_chunked(j(x), j(dt), j(A), j(Bm), j(Cm), chunk)
    ins = [t(v).requires_grad_() for v in (x, dt, Bm, Cm)]
    y, h = TMB.ssd_chunked(ins[0], ins[1], t(A), ins[2], ins[3], chunk,
                           remat=True)
    assert _ssd_close(y.detach(), jy) and _ssd_close(h.detach(), jh)
    hs = torch.zeros((B, nh, hd, ds))
    jhs = jnp.zeros((B, nh, hd, ds))
    ys = []
    for i in range(S):
        yt, hs = TMB.ssd_step(hs, t(x[:, i]), t(dt[:, i]), t(A),
                              t(Bm[:, i]), t(Cm[:, i]))
        jyt, jhs = JMB.ssd_step(jhs, j(x[:, i]), j(dt[:, i]), j(A),
                                j(Bm[:, i]), j(Cm[:, i]))
        assert _ssd_close(yt, jyt)
        ys.append(yt)
    assert _ssd_close(hs, jhs)
    np.testing.assert_allclose(y.detach().numpy(),
                               torch.stack(ys, 1).numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(h.detach().numpy(), hs.numpy(), rtol=2e-4,
                               atol=2e-4)
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(y.shape)).astype(np.float32))
    g = torch.autograd.grad((y * w).sum() + h.sum(), ins)
    ref = [v.detach().requires_grad_() for v in ins]
    y2, h2 = TMB.ssd_chunked(ref[0], ref[1], t(A), ref[2], ref[3], chunk)
    g2 = torch.autograd.grad((y2 * w).sum() + h2.sum(), ref)
    for a, b in zip(g, g2):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_ssd_initial_state_continuation():
    """Splitting a sequence and carrying state equals processing it whole
    (2e-4), and the carried half equals JAX's."""
    B, S, nh, hd, ds, Q = 1, 24, 2, 4, 8, 8
    x, dt, A, Bm, Cm = map(t, _ssd_inputs(7, B, S, nh, hd, ds))
    y_all, h_all = TMB.ssd_chunked(x, dt, A, Bm, Cm, Q)
    cut = 16
    y1, h1 = TMB.ssd_chunked(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                             Cm[:, :cut], Q)
    y2, h2 = TMB.ssd_chunked(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                             Cm[:, cut:], Q, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_all.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h2.numpy(), h_all.numpy(), rtol=2e-4,
                               atol=2e-4)
    jy2, jh2 = JMB.ssd_chunked(*(j(v[:, cut:]) if v.dim() > 1 else j(v)
                                 for v in (x, dt, A, Bm, Cm)), Q, h0=j(h1))
    assert _ssd_close(y2, jy2) and _ssd_close(h2, jh2)


def test_ssd_pad_tokens_are_noops():
    """dt = 0 on pad tokens leaves the state untouched (2e-4), as in
    JAX."""
    B, S, nh, hd, ds, Q = 1, 16, 2, 4, 8, 8
    x, dt, A, Bm, Cm = map(t, _ssd_inputs(9, B, S, nh, hd, ds))
    valid = torch.arange(S) < 10
    dt_m = dt * valid[None, :, None]
    _, h_m = TMB.ssd_chunked(x, dt_m, A, Bm, Cm, Q)
    _, h_trunc = TMB.ssd_chunked(x[:, :10], dt[:, :10], A, Bm[:, :10],
                                 Cm[:, :10], Q)
    np.testing.assert_allclose(h_m.numpy(), h_trunc.numpy(), rtol=2e-4,
                               atol=2e-4)
    _, jh = JMB.ssd_chunked(j(x), j(dt_m), j(A), j(Bm), j(Cm), Q)
    assert _ssd_close(h_m, jh)


def test_causal_conv_step_equals_seq():
    """One-token steps carrying the state equal the whole sequence (1e-5,
    the JAX test's tolerance); both forms equal JAX's."""
    B, S, C, K = 2, 12, 6, 4
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((K, C)).astype(np.float32)
    b = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    y_seq, st_seq = TMB.causal_conv(t(x), t(w), t(b), None)
    jy, jst = JMB.causal_conv(j(x), j(w), j(b), None)
    assert _ssd_close(y_seq, jy) and _ssd_close(st_seq, jst)
    state = torch.zeros((B, K - 1, C))
    ys = []
    for i in range(S):
        y_t, state = TMB.causal_conv(t(x[:, i:i + 1]), t(w), t(b), state)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_seq.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.numpy(), st_seq.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_split_and_expand_match_jax():
    """``split_zxbcdt`` and ``expand_groups`` against JAX's at a 2-group
    width."""
    cfg = get_reduced(MAMBA).replace(ssm=SSMConfig(
        d_state=16, head_dim=32, expand=2, chunk=16, n_groups=2))
    jcfg = j_get_reduced(MAMBA).replace(ssm=JSSMConfig(
        d_state=16, head_dim=32, expand=2, chunk=16, n_groups=2))
    width = 2 * cfg.d_inner + 4 * 16 + cfg.n_ssm_heads
    zx = np.random.default_rng(4).standard_normal((3, width)).astype(
        np.float32)
    for a, b in zip(TMB.split_zxbcdt(cfg, t(zx)),
                    JMB.split_zxbcdt(jcfg, j(zx))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    g = zx[:, :32].reshape(3, 2, 16)
    np.testing.assert_array_equal(
        TMB.expand_groups(t(g), cfg.n_ssm_heads).numpy(),
        np.asarray(JMB.expand_groups(j(g), jcfg.n_ssm_heads)))


@pytest.mark.parametrize("h0,nh", [(0, 16), (4, 4), (8, 8), (12, 4)])
def test_rank_heads_take_their_groups(h0, nh):
    """A rank's SSM heads ``[h0, h0 + nh)`` under a mesh take the B / C of
    their global head's group (``model._expand_bc``): its slice of JAX's
    ``expand_groups`` over every head, at 2 groups of 8 heads (not
    ``expand_groups`` over the rank's own ``nh`` heads, which would give
    heads 6-7 of rank 1 at (4, 4) the second group)."""
    cfg = get_reduced(MAMBA).replace(ssm=SSMConfig(
        d_state=16, head_dim=32, expand=2, chunk=16, n_groups=2))
    y = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    b, c = TM._expand_bc(cfg, t(y), (3,), h0, nh)
    for got, half in ((b, y[:, :32]), (c, y[:, 32:])):
        want = JMB.expand_groups(j(half.reshape(3, 2, 16)),
                                 cfg.n_ssm_heads)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want)[:, h0:h0 + nh])


# ----------------------------------------------------- model-level twins
def _fwd(s, batch, cache, loras=False):
    kw = dict(loras=s["bank"], lora_scale=s["scale"]) if loras else {}
    with torch.no_grad():
        return TM.unified_forward(s["cfg"], s["params"], batch, cache,
                                  block_t=BT, **kw)


def _jfwd(s, batch, cache, loras=False):
    kw = dict(loras=s["jbank"], lora_scale=s["jscale"]) if loras else {}
    return JM.unified_forward(s["jcfg"], s["jparams"], batch, cache, **kw)


def _base(B):
    return np.full((B,), -1, np.int32)


def _toks(s, B, n, seed=1):
    return np.random.default_rng(seed).integers(
        0, s["cfg"].vocab, (B, n)).astype(np.int32)


def _pf(toks, length, tables=None, adapter=None):
    B = toks.shape[0]
    adapter = _base(B) if adapter is None else adapter
    length = np.broadcast_to(_i32(length), (B,)).copy()
    return (JPF(tokens=j(toks), length=j(length), adapter=j(adapter),
                block_tables=None if tables is None else j(tables)),
            PFBatch(tokens=t(toks), length=t(length), adapter=t(adapter),
                    block_tables=None if tables is None else t(tables)))


def _dec(toks, pos, tables=None, adapter=None):
    B = toks.shape[0]
    adapter = _base(B) if adapter is None else adapter
    pos = np.broadcast_to(_i32(pos), (B,)).copy()
    return (JDEC(tokens=j(toks), pos=j(pos), adapter=j(adapter),
                 block_tables=None if tables is None else j(tables)),
            DECBatch(tokens=t(toks), pos=t(pos), adapter=t(adapter),
                     block_tables=None if tables is None else t(tables)))


def _both(s, pf=None, dec=None, state=None, loras=False):
    """One step on both packages; ``state`` holds each side's cache."""
    jb = JUB(pf=pf and pf[0], dec=dec and dec[0])
    tb = UnifiedBatch(pf=pf and pf[1], dec=dec and dec[1])
    jout = _jfwd(s, jb, state["j"], loras)
    tout = _fwd(s, tb, state["t"], loras)
    state["j"] = jout.cache
    return tout, jout


def _caches(s, paged=True, B=2, n_blocks=9, bs=8, rows_len=32):
    if paged:
        return {"j": JM.init_paged_cache(s["jcfg"], n_blocks, bs, B),
                "t": TM.init_paged_cache(s["cfg"], n_blocks, bs, CPU,
                                         torch.float32, n_rows=B)}
    return {"j": JM.init_cache(s["jcfg"], B, rows_len),
            "t": TM.init_cache(s["cfg"], B, rows_len, CPU, torch.float32)}


def test_cache_layout_matches_jax(s):
    """A leaf exists only on the layers that carry it: jamba's ``k``/``v``
    over its one attention layer, the state rows over the Mamba layers;
    mamba2 has no block leaf.  Shapes and key order equal JAX's, per kind
    of layer stacked in layer order."""
    cfg = s["cfg"]
    tc = TM.init_paged_cache(cfg, 9, 8, CPU, torch.float32, n_rows=5)
    jc = JM.init_paged_cache(s["jcfg"], 9, 8, 5)
    names = list(tc)
    assert names == (["h", "conv_x", "conv_bc"]
                     + (["k", "v"] if cfg.name.startswith("jamba") else []))
    for name in names:
        assert tuple(tc[name].shape) == _jax_leaf(cfg, jc, name).shape
    dense = TM.init_cache(cfg, 3, 16, CPU, torch.float32)
    jd = JM.init_cache(s["jcfg"], 3, 16)
    for name in names:
        assert tuple(dense[name].shape) == _jax_leaf(cfg, jd, name).shape


def test_prefill_then_decode_matches_full(s):
    """Dense rows: prefill 10 tokens, decode 3 one at a time, against one
    prefill of all 13 (2e-4, that test's tolerance) and against JAX's
    decode logits and every cache leaf."""
    B, S, extra = 2, 10, 3
    toks = _toks(s, B, S + extra)
    st = _caches(s, paged=False)
    out, jout = _both(s, pf=_pf(toks[:, :S], S), state=st)
    assert _close(out.pf_logits, jout.pf_logits)
    for i in range(extra):
        out, jout = _both(s, dec=_dec(toks[:, S + i], S + i), state=st)
        assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(s["cfg"], st["t"], st["j"], skip_null=False)
    ref = _fwd(s, UnifiedBatch(pf=_pf(toks, S + extra)[1]),
               TM.init_cache(s["cfg"], B, 32, CPU, torch.float32))
    np.testing.assert_allclose(out.dec_logits.numpy(), ref.pf_logits.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_paged_forward_matches_dense(s):
    """Prefill + 3 decode steps through interleaved blocks (jamba's K/V)
    and state rows equal the dense rows (2e-4) and JAX's paged run."""
    B, S, extra = 2, 10, 3
    toks = _toks(s, B, S + extra)

    def drive(st, tables):
        out, jout = _both(s, pf=_pf(toks[:, :S], S, tables), state=st)
        logits = [(out.pf_logits, jout.pf_logits)]
        for i in range(extra):
            out, jout = _both(s, dec=_dec(toks[:, S + i], S + i, tables),
                              state=st)
            logits.append((out.dec_logits, jout.dec_logits))
        return logits

    dense = drive(_caches(s, paged=False), None)
    st = _caches(s)
    paged = drive(st, TBL4)
    for (a, _), (b, jb) in zip(dense, paged):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)
        assert _close(b, jb)
    _same_cache(s["cfg"], st["t"], st["j"])


def test_cow_leaves_state_rows_untouched():
    """Copy-on-write copies pool blocks: jamba's state rows (indexed by
    request slot, not block id) are not rewritten, and the K/V block is
    copied."""
    cfg = get_reduced(JAMBA)
    m = TK.PagedCacheManager(cfg, 2, 2, 64, device=CPU, dtype=torch.float32,
                             block_size=16, n_blocks=8)
    assert set(m.block_leaves) == {"k", "v"}
    s1, _ = m.try_admit(np.arange(20, dtype=np.int32), 8)
    m.lens[s1] = 20
    m._publish_upto(s1)
    gen = torch.Generator().manual_seed(0)
    for leaf in m.cache.values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = {k: v.clone() for k, v in m.cache.items()}
    s2, _ = m.try_admit(np.arange(20, dtype=np.int32), 8)
    old = m.tables[s1][0]
    new_bid = m.ensure_writable(s2, pos=0)
    assert new_bid != old
    for k in TM.STATE_KEYS & m.cache.keys():
        assert torch.equal(m.cache[k], before[k]), k
    for k in ("k", "v"):
        assert torch.equal(m.cache[k][:, new_bid], before[k][:, old])


def test_commit_prefill_copies_state_rows_like_jax(s):
    """The paged ``commit_prefill`` copies state rows ``src_base + i`` into
    the decode slots (on a prefill-only tick, rows that overlap their
    destinations), as the JAX manager does; the block leaves stay."""
    kw = dict(block_size=8, n_blocks=12)
    jm = JK.PagedCacheManager(s["jcfg"], 3, 2, 64, **kw)
    tm = TK.PagedCacheManager(s["cfg"], 3, 2, 64, device=CPU,
                              dtype=torch.float32, **kw)
    rng = np.random.default_rng(2)
    pay = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
           for k, v in tm.cache.items()}
    for k, v in tm.cache.items():
        v.copy_(t(pay[k]))
    cfg = s["cfg"]
    P, index = len(cfg.pattern), TM.layer_index(cfg)
    layers = [dict(d) for d in jm.cache["layers"]]
    for pos, d in enumerate(layers):     # the port's layout back to JAX's
        rows = [index[li][1] for li in range(pos, cfg.n_layers, P)]
        for name in d:
            d[name] = jnp.asarray(pay[name][rows])
    jm.cache = {"layers": tuple(layers)}
    slots = []
    for m in (jm, tm):
        a, _ = m.try_admit(np.arange(9, dtype=np.int32), 4)
        b, _ = m.try_admit(np.arange(20, 30, dtype=np.int32), 4)
        slots.append((a, b))
    assert slots[0] == slots[1]
    a, b = slots[0]
    for base in (0, 3):
        for m in (jm, tm):
            m.commit_prefill([(0, b), (1, a)], [10, 9], src_base=base)
        _same_cache(s["cfg"], tm.cache, jm.cache, skip_null=False)
    assert int(tm.lens[a]) == 9 and int(tm.lens[b]) == 10


def _table(*bids):
    row = np.zeros((NBT,), np.int32)
    row[:len(bids)] = bids
    return row


def _ft_rows(rng, V, lens=(13, 21), adapters=(0, 1), Sf=24):
    toks = np.zeros((len(lens), Sf), np.int32)
    mask = np.zeros((len(lens), Sf), bool)
    labels = np.full((len(lens), Sf), -100, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, V, n)
        mask[i, :n] = True
        labels[i, :n] = toks[i, :n]
    return dict(tokens=toks, mask=mask, labels=labels,
                adapter=_i32(adapters),
                weight=np.array([0.5, 1.0], np.float32)[:len(lens)])


def test_unified_forward_matches_jax(s):
    """The mixed stream with two nonzero-B adapters: ft rows beside a cold
    paged prefill (state rows 0-1), then paged decode over rows 0-2 with
    an inactive row, then a prefill (rows 3-4) beside decode; each step's
    logits, ft losses, aux loss and every cache leaf."""
    cfg = s["cfg"]
    rng = np.random.default_rng(0)
    V = cfg.vocab
    st = {"j": JM.init_paged_cache(s["jcfg"], NB, BS, 5),
          "t": TM.init_paged_cache(cfg, NB, BS, CPU, torch.float32,
                                   n_rows=5)}
    ft = _ft_rows(rng, V)
    toks = np.zeros((2, 24), np.int32)
    toks[0, :13], toks[1, :20] = rng.integers(0, V, 13), rng.integers(0, V,
                                                                       20)
    pf = _pf(toks, [13, 20], np.stack([_table(1, 2), _table(3, 4, 5)]),
             adapter=_i32([0, 1]))
    jb = JUB(ft=JFT(**{k: j(v) for k, v in ft.items()}), pf=pf[0])
    tb = UnifiedBatch(ft=FTBatch(**{k: t(v) for k, v in ft.items()}),
                      pf=pf[1])
    jout = _jfwd(s, jb, st["j"], loras=True)
    out = _fwd(s, tb, st["t"], loras=True)
    st["j"] = jout.cache
    assert _close(out.pf_logits, jout.pf_logits)
    want = np.asarray(jout.ft_loss_sum)
    assert max_err(out.ft_loss_sum, want) <= LOSS_REL * np.abs(want).max()
    assert abs(float(out.aux_loss) - float(jout.aux_loss)) \
        <= LOSS_REL * max(abs(float(jout.aux_loss)), 1e-12)
    _same_cache(cfg, st["t"], st["j"])
    tables = np.stack([_table(1, 2), _table(3, 4, 5), _table()])
    nxt = out.pf_logits.argmax(-1).numpy()
    out, jout = _both(s, dec=_dec(_i32([nxt[0], nxt[1], 0]), [13, 20, 0],
                                  tables, adapter=_i32([0, 1, -1])),
                      state=st, loras=True)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(cfg, st["t"], st["j"])
    nxt = out.dec_logits.argmax(-1).numpy()
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1, :11] = rng.integers(0, V, 9), rng.integers(0, V, 11)
    out, jout = _both(
        s, pf=_pf(toks, [9, 11], np.stack([_table(6, 7), _table(8, 9)]),
                  adapter=_i32([1, 0])),
        dec=_dec(_i32([nxt[0], nxt[1], 0]), [14, 21, 0], tables,
                 adapter=_i32([0, 1, -1])), state=st, loras=True)
    assert _close(out.pf_logits, jout.pf_logits)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(cfg, st["t"], st["j"])
    with pytest.raises(NotImplementedError):
        chunk = np.zeros((3, 2), np.int32)
        _fwd(s, UnifiedBatch(dec=DECBatch(
            tokens=t(chunk), pos=t(_i32([15, 22, 0])), adapter=t(_base(3)),
            block_tables=t(tables), length=t(_i32([2, 2, 1])))), st["t"])


def test_grad_step_matches_jax(s):
    """The ft bucket's grad step against ``repro.core.unified``'s: loss
    (jamba's router aux loss included) and every bank leaf, ``in_z`` /
    ``in_x`` / ``out_proj`` included, through the chunked SSD under
    ``torch.utils.checkpoint``."""
    ft = _ft_rows(np.random.default_rng(1), s["cfg"].vocab)
    jb = JUB(ft=JFT(**{k: j(v) for k, v in ft.items()}))
    tb = UnifiedBatch(ft=FTBatch(**{k: t(v) for k, v in ft.items()}))
    jres = j_make_grad_step(s["jcfg"])(s["jparams"], s["jbank"], s["jscale"],
                                       jb, None)
    tres = make_grad_step(s["cfg"], block_t=BT)(s["params"], s["bank"],
                                                 s["scale"], tb, None)
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= LOSS_REL * abs(float(jres.loss))
    want = to_port_bank(jres.grads,
                        s["tmp"] / f"g_{s['cfg'].name}.npz")
    for lg, lw in zip(tres.grads["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lw[name][ab]
                lim = GRAD_REL * max(float(w.abs().max()), 1e-12)
                assert max_err(g, w) <= lim, (name, ab)
    for name in ("in_z", "in_x", "out_proj"):
        assert float(tres.grads["layers"][0][name]["b"].abs().max()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_conv_state_fault_is_mirrored(arch, tmp):
    """The JAX prefill takes a row's conv state from the last K-1 inputs of
    its padded bucket row: an 8-token prompt prefilled alone and padded to
    16 gives the same prefill logits but decode logits that differ (the
    reference side's fault, ROADMAP Queue 3).  The port gives JAX's numbers
    in both cases, so it emits JAX's tokens."""
    s = _setup(arch, tmp)
    toks = _toks(s, 1, 9, seed=6)
    got = {}
    for Sp in (8, 16):
        row = np.zeros((1, Sp), np.int32)
        row[0, :8] = toks[0, :8]
        st = _caches(s, paged=False, B=1)
        out, jout = _both(s, pf=_pf(row, 8), state=st)
        assert _close(out.pf_logits, jout.pf_logits)
        d, jd = _both(s, dec=_dec(toks[:, 8], 8), state=st)
        assert _close(d.dec_logits, jd.dec_logits)
        got[Sp] = (np.asarray(jout.pf_logits), np.asarray(jd.dec_logits))
    np.testing.assert_allclose(got[8][0], got[16][0], rtol=2e-4, atol=2e-4)
    assert np.abs(got[8][1] - got[16][1]).max() > 0.1


# ------------------------------------------------------------- engines
def _stores(s, names=("serve",)):
    """(JAX store, port store) with JAX-drawn adapters under ``names``."""
    jstore = JAdapterStore(s["jcfg"], JLoRAConfig(**LCFG),
                           jax.random.PRNGKey(1))
    store = AdapterStore(s["cfg"], LoRAConfig(**LCFG), device="cpu")
    for i, name in enumerate(names):
        jstore.load_random(name, jax.random.PRNGKey(2 + i))
        store.load(name, to_port_bank(
            jstore.get_adapter(name),
            s["tmp"] / f"e_{s['cfg'].name}_{name}.npz"))
    return jstore, store


def _shared_reqs(R, vocab, n=5, max_new=6, seed=0):
    """A 32-token shared head, tails of 4-11 tokens (``test_hash_dedup``'s
    trace)."""
    head = np.arange(32, dtype=np.int32) % vocab
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, vocab, rng.integers(4, 12))
                 .astype(np.int32)]),
              adapter="serve", max_new_tokens=max_new, arrival=0.25 * i)
            for i in range(n)]


def _runtime_reqs(R, vocab, n=8, max_new=24, rps=4.0):
    """``test_runtime.py``'s trace (two adapters, Poisson arrivals)."""
    prompts = datasets.sharegpt_prompts(n, vocab=vocab, len_lo=6,
                                        len_hi=20)
    arr = workload.poisson_arrivals(rps, n, seed=1)
    return [R(rid=i, prompt=p, adapter=("serve", "other")[i % 2],
              max_new_tokens=max_new, arrival=float(a))
            for i, (p, a) in enumerate(zip(prompts, arr))]


ECFG = dict(capacity=4, pf_capacity=2, s_max=96, block_size=16,
            virtual_time=True)
LEND = dict(over_admit=2.0, n_blocks=6, block_size=16)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=8000)
    return {r.rid: list(r.output) for r in eng.finished}


def _pair(s, ecfg, reqs, names=("serve",)):
    """The JAX and the port engine on one trace."""
    jstore, store = _stores(s, names)
    jeng = JUnifiedEngine(JMixedLoraModel(s["jcfg"], s["jparams"], jstore),
                          JEngineConfig(**ecfg))
    eng = UnifiedEngine(MixedLoraModel(s["cfg"], s["params"], store),
                        EngineConfig(**ecfg))
    return (_run(jeng, reqs(JRequest, s["cfg"].vocab)),
            _run(eng, reqs(Request, s["cfg"].vocab)), jeng, eng)


def test_engine_dedup_and_spec_off_match_jax(s):
    """Dedup on: later requests adopt the shared head's blocks (hits
    counted, as JAX counts them) but prefill whole prompts (no reused
    tokens); a spec config is accepted and turned off, so the tokens are
    the plain ones.  Tokens, steps and counters equal the JAX engine's."""
    spec = SpecConfig(k_max=3, drafter="ngram")
    jout, out, jeng, eng = _pair(s, dict(ECFG, spec=spec), _shared_reqs)
    assert eng.spec is None and jeng.spec is None
    assert not eng.suffix_prefill and eng.chunk_budget == 0
    assert len(out) == 5 and out == jout
    m, jm = eng.metrics, jeng.metrics
    assert m.hash_hits == jm.hash_hits and m.hash_hits >= 2 * 4
    assert m.reused_prefix_tokens == jm.reused_prefix_tokens == 0
    assert m.steps == jm.steps and m.spec_drafted == 0
    assert eng.cachemgr.pristine
    _, plain, _, _ = _pair(s, dict(ECFG, hash_dedup=False), _shared_reqs)
    assert plain == out


@pytest.mark.parametrize("ecfg", [dict(LEND, kv_host_blocks=4),
                                  dict(paged=False, s_max=64)],
                         ids=["lending", "dense_rows"])
def test_engine_memory_paths_match_jax(s, ecfg):
    """Lending on a tight pool (preemption recomputes: the host tier is
    requested and stays off for Mamba patterns), and dense rows: tokens,
    steps and preemptions equal the JAX engine's, and the pool drains
    pristine."""
    jout, out, jeng, eng = _pair(
        s, {**dict(capacity=4, pf_capacity=2, s_max=96, virtual_time=True),
            **ecfg}, _runtime_reqs, names=("serve", "other"))
    assert len(out) == 8 and out == jout
    for f in ("steps", "preemptions", "kv_swap_outs", "lent_blocks_peak"):
        assert getattr(eng.metrics, f) == getattr(jeng.metrics, f), f
    assert eng.cachemgr.pristine
    if "over_admit" in ecfg:
        assert jeng.cachemgr.pristine
        assert not eng.kv_tiering and eng.metrics.preemptions > 0
        assert eng.metrics.kv_swap_outs == 0


def _fleet_trace(R, vocab, n=6, seed=0, head_len=48):
    """``test_fleet.py``'s trace: a 48-token head, tails of 4-11 tokens."""
    head = np.arange(head_len, dtype=np.int32) % vocab
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, vocab, rng.integers(4, 12))
                 .astype(np.int32)]),
              adapter="serve", max_new_tokens=6, arrival=0.05 * i)
            for i in range(n)]


def test_fleet_matches_jax(sj):
    """A 2-replica round-robin jamba fleet with remote fetch gives the JAX
    fleet's tokens, fetched blocks and steps, and one engine's tokens;
    ``import_block`` copies a block's K/V and leaves both pools' state rows
    untouched; every pool drains pristine."""
    s = sj
    vocab = s["cfg"].vocab
    cost = dict(fixed=1e-3, prefill_per_tok=1e-4)
    jstore, store = _stores(s)
    jfleet = j_build_fleet(
        JMixedLoraModel(s["jcfg"], s["jparams"], jstore),
        JEngineConfig(**ECFG, cost=JCostModel(**cost)),
        JFleetConfig(replicas=2, router=JRouterConfig(policy="round-robin")))
    fleet = build_fleet(
        MixedLoraModel(s["cfg"], s["params"], store),
        EngineConfig(**ECFG, cost=CostModel(**cost)),
        FleetConfig(replicas=2, router=RouterConfig(policy="round-robin")))
    for f, R in ((jfleet, JRequest), (fleet, Request)):
        for r in _fleet_trace(R, vocab):
            f.submit(r)
    jm, fm = jfleet.run(), fleet.run()
    got = {r.rid: list(r.output) for e in fleet.engines for r in e.finished}
    want = {r.rid: list(r.output) for e in jfleet.engines
            for r in e.finished}
    assert len(got) == 6 and got == want
    assert fm.remote_fetch_blocks == jm.remote_fetch_blocks > 0
    assert [e.metrics.steps for e in fleet.engines] \
        == [e.metrics.steps for e in jfleet.engines]
    assert all(e.cachemgr.pristine for e in fleet.engines)
    fleet.index.check_bijection()
    _, one_store = _stores(s)
    one = _run(UnifiedEngine(MixedLoraModel(s["cfg"], s["params"],
                                            one_store), EngineConfig(**ECFG)),
               _fleet_trace(Request, vocab))
    assert one == got
    a, b = (e.cachemgr for e in fleet.engines)
    slot, _ = a.try_admit(np.arange(100, 140, dtype=np.int32), 4)
    gen = torch.Generator().manual_seed(1)
    for leaf in list(a.cache.values()) + list(b.cache.values()):
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    a.lens[slot] = 40
    a._publish_upto(slot)
    key = a._chains[slot][0]
    src_bid = a._index[key]
    assert key not in b._index
    before = {k: v.clone() for k, v in b.cache.items()}
    bid = b.import_block(key, a, src_bid)
    assert bid is not None
    for k in ("k", "v"):
        assert torch.equal(b.cache[k][:, bid], a.cache[k][:, src_bid])
    for k in TM.STATE_KEYS & b.cache.keys():
        assert torch.equal(b.cache[k], before[k]), k


@pytest.mark.parametrize("host_quant", [False, True])
def test_block_bytes_match_jax(s, host_quant):
    """The static footprints skip the state rows, as JAX's do: jamba's
    are its one attention layer's K/V; mamba2 has no block leaf and its
    footprint is ``max(0, 1) = 1`` byte."""
    kw = dict(block_size=8, n_blocks=12, host_blocks=4,
              host_quant=host_quant)
    jm = JK.PagedCacheManager(s["jcfg"], 4, 2, 64, **kw)
    tm = TK.PagedCacheManager(s["cfg"], 4, 2, 64, device=CPU,
                              dtype=torch.float32, **kw)
    assert tm.adapter_block_bytes == jm.adapter_block_bytes
    assert tm.host_block_bytes == jm.host_block_bytes
    if s["cfg"].name.startswith("mamba"):
        assert tm.adapter_block_bytes == 1 and not tm.block_leaves
    else:
        assert tm.adapter_block_bytes == 2 * 8 * 2 * 32 * 4


# ------------------------------------------------------------ int8 weights
def test_int8_forward_close_to_bf16(tmp):
    """Twin of ``test_quant.py::test_int8_forward_close_to_bf16[mamba2-
    1.3b]``: per-channel symmetric int8 gives a small logit drift and the
    same argmax mostly (0.2 and 0.5, the JAX test's bounds)."""
    s = _setup(MAMBA, tmp)
    cfg = s["cfg"]
    qparams = quant.quantize_params(cfg, s["params"])
    assert quant.has_q8(qparams)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    pf = PFBatch(tokens=toks, length=torch.full((2,), 12, dtype=torch.int32),
                 adapter=torch.full((2,), -1, dtype=torch.int32))
    outs = []
    for p in (s["params"], qparams):
        with torch.no_grad():
            outs.append(TM.unified_forward(
                cfg, p, UnifiedBatch(pf=pf),
                TM.init_cache(cfg, 2, 16, CPU, torch.float32), block_t=BT))
    a, b = outs
    assert float((a.pf_logits - b.pf_logits).abs().max()) < 0.2
    agree = (a.pf_logits.argmax(-1) == b.pf_logits.argmax(-1)).float()
    assert float(agree.mean()) >= 0.5


def test_int8_at_an_eligible_in_dt_matches_jax(tmp):
    """At d_model 2048 (2 layers, the published SSM widths: 64 heads of 64,
    d_state 128) ``in_dt`` [P, 2048, 64] is eligible and the conv weights
    (``shape[-2] = 4``) are not: ``quantize_params`` is bit-equal to JAX's,
    and the int8 paged prefill and a decode step with adapters equal
    JAX's."""
    ssm = dict(d_state=128, head_dim=64, expand=2, chunk=128, conv_width=4)
    jcfg = j_get_reduced(MAMBA).replace(d_model=2048, ssm=JSSMConfig(**ssm))
    cfg = get_reduced(MAMBA).replace(d_model=2048, ssm=SSMConfig(**ssm))
    assert cfg.n_ssm_heads == 64
    jparams = j_init_params(jcfg, jax.random.PRNGKey(5))
    jq = jquant.quantize_params(jcfg, jparams)
    assert jquant.is_q8(jq["blocks"][0]["in_dt"])
    assert not jquant.is_q8(jq["blocks"][0]["conv_x"])
    mine = quant.quantize_params(cfg, to_port_params(jparams,
                                                     tmp / "q_p.npz"))
    del jparams
    theirs = to_port_params(jq, tmp / "q_q.npz")
    for li in range(cfg.n_layers):
        assert mine["layers"][li].keys() == theirs["layers"][li].keys()
        for k, v in mine["layers"][li].items():
            if quant.is_q8(v):
                for part in ("_q8", "_qs"):
                    assert torch.equal(v[part], theirs["layers"][li][k][part])
            else:
                assert torch.equal(v, theirs["layers"][li][k]), k
        assert quant.is_q8(mine["layers"][li]["in_dt"])
        assert quant.is_q8(mine["layers"][li]["in_bc"])
    del theirs
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(6))
    jstore.load_random("a0", jax.random.PRNGKey(7))
    bank = to_port_bank(jstore.bank, tmp / "q_bank.npz")
    scale = t(np.asarray(jstore.scale))
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    jc = JM.init_paged_cache(jcfg, 6, 8, 2)
    tc = TM.init_paged_cache(cfg, 6, 8, CPU, torch.float32, n_rows=2)
    ad = _i32([0, -1])
    pf = _pf(toks, [12, 9], tables, adapter=ad)
    jout = JM.unified_forward(jcfg, jq, JUB(pf=pf[0]), jc, loras=jstore.bank,
                              lora_scale=jstore.scale)
    with torch.no_grad():
        out = TM.unified_forward(cfg, mine, UnifiedBatch(pf=pf[1]), tc,
                                 loras=bank, lora_scale=scale, block_t=BT)
    assert _close(out.pf_logits, jout.pf_logits)
    nxt = out.pf_logits.argmax(-1).numpy().astype(np.int32)
    dec = _dec(nxt, [12, 9], tables, adapter=ad)
    jout = JM.unified_forward(jcfg, jq, JUB(dec=dec[0]), jout.cache,
                              loras=jstore.bank, lora_scale=jstore.scale)
    with torch.no_grad():
        out = TM.unified_forward(cfg, mine, UnifiedBatch(dec=dec[1]), tc,
                                 loras=bank, lora_scale=scale, block_t=BT)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(cfg, tc, jout.cache)
