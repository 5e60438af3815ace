"""The port's MLA (``deepseek-v2-236b``: absorbed-form attention over a
compressed latent cache, with MoE FFNs) against the JAX package, in fp32 on
the CPU at reduced size (2 layers, d_model 256, 8 heads, latent c = 64,
rope dr = 16, 4 experts top-2 with a shared expert).

JAX weights and LoRA banks cross over through the bridge; other inputs are
made from numpy seeds and handed to both packages.

* ``layers.mla_attention`` plain and chunked against JAX's (1e-5), and the
  chunked form against the plain one (2e-4, ``test_layers.py``'s bound).
* Twins of ``test_cache_equivalence.py::test_prefill_then_decode_matches_
  full``, ``test_prefix_prefill.py::test_chunked_suffix_prefill_matches_
  full`` and ``::test_engine_suffix_prefill_matches_no_dedup``,
  ``test_spec.py::test_verify_chunk_matches_sequential_decode``,
  ``test_paged_cache.py::test_paged_forward_matches_dense`` and
  ``test_hash_dedup.py::test_hash_adoption_matches_explicit_reuse_span``:
  each holds the port to its own property with the JAX test's tolerance,
  and to the JAX package (logits and latent pools within 1e-4 of max(1,
  max |JAX|), engine tokens and counters exactly).
* The mixed ``unified_forward`` (ft rows beside a cold paged prefill, then
  paged decode, then a suffix prefill beside verify chunks) against JAX's,
  the ``ckv`` and ``kpe`` pools included; the ft grad step with
  ``attn_chunk`` 0 and 16 (loss 1e-5 relative, bank grads 1e-4 of a leaf's
  max |JAX|).
* The engine's greedy tokens equal the JAX engine's, and a 2-replica
  round-robin fleet with remote fetch (``import_block`` of latent blocks)
  equals one engine.
* The host tier: latent blocks swapped out and restored bit-exact, the int8
  payload bit-equal to JAX ``quantize_leaf`` on ``ckv``/``kpe``, and
  ``adapter_block_bytes`` / ``host_block_bytes`` equal to JAX's.
* int8 weights at an MLA shape where ``wuk``/``wuv`` are eligible (64 heads,
  dn = dv = 64): ``quantize_params`` bit-equal to JAX's, and the int8
  forward against JAX's.
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
from repro.models import layers as JL, model as JM, quant as jquant
from repro.models.configs import MLAConfig as JMLAConfig
from repro.models.quant import quantize_leaf as j_quantize_leaf
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.serving import kvcache as JK
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_grad_step
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
from repro_torch.models import layers as TL, model as TM, quant
from repro_torch.models.configs import MLAConfig
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.serving import kvcache as TK
from repro_torch.serving.clock import CostModel
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request

ARCH = "deepseek-v2-236b"
TOL, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-4
BT, BS, NB, NBT = 8, 8, 24, 6
LCFG = dict(n_slots=4, r=4)
CPU = torch.device("cpu")
LEAVES = ("ckv", "kpe")
TBL4 = np.array([[3, 1, 7, 5], [2, 6, 4, 8]], np.int32)   # interleaved


@pytest.fixture(scope="module")
def s(tmp_path_factory):
    """JAX weights, a JAX store with two nonzero-B adapters, and their
    bridged port copies."""
    tmp = tmp_path_factory.mktemp("mla")
    jcfg = j_get_reduced(ARCH)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    jstore.load_random("a0", jax.random.PRNGKey(2))
    jstore.load_random("a1", jax.random.PRNGKey(3))
    return dict(jcfg=jcfg, jparams=jparams, jbank=jstore.bank,
                jscale=jstore.scale, jstore=jstore, cfg=get_reduced(ARCH),
                params=to_port_params(jparams, tmp / "params.npz"),
                bank=to_port_bank(jstore.bank, tmp / "bank.npz"),
                scale=t(np.asarray(jstore.scale)), tmp=tmp)


def _i32(x):
    return np.asarray(x, np.int32)


def _close(a, b, rel=TOL):
    b = np.asarray(b)
    assert a is not None and torch.isfinite(a).all()
    return max_err(a, b) <= rel * max(1.0, float(np.abs(b).max()))


def _jax_leaf(jcache, name):
    """A JAX cache leaf ``[P=L, rows|blocks, ...]`` (one pattern position,
    so period = layer)."""
    return np.asarray(jcache["layers"][0][name])


def _same_cache(tcache, jcache, skip_null=True):
    assert list(tcache) == list(LEAVES)
    lo = 1 if skip_null else 0    # block 0 is the null block: garbage
    for name in LEAVES:
        assert _close(tcache[name][:, lo:], _jax_leaf(jcache, name)[:, lo:]), \
            name


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("chunk", [0, 8])
def test_mla_attention_matches_jax(chunk):
    """``test_layers.py::test_mla_chunked_vs_absorbed``'s inputs (from a
    numpy seed): each form against JAX's same form at 1e-5, and the chunked
    against the plain at 2e-4; the chunked form's gradient under
    ``torch.utils.checkpoint`` equals the plain form's."""
    rng = np.random.default_rng(3)
    B, S, T, h, c, dn, dr, dv = 2, 19, 29, 4, 24, 16, 8, 16
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    qn, qp, ckv, kpe = f(B, S, h, dn), f(B, S, h, dr), f(B, T, c), f(B, T, dr)
    wuk, wuv = f(c, h, dn) * 0.2, f(c, h, dv) * 0.2
    q_pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32) + 10
    k_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    k_valid = k_pos < np.array([[29], [20]])
    args = (qn, qp, ckv, kpe, wuk, wuv)
    kw = dict(q_pos=q_pos, k_pos=k_pos, k_valid=k_valid)
    want = np.asarray(JL.mla_attention(*map(j, args), causal=True,
                                       chunk=chunk,
                                       **{k: j(v) for k, v in kw.items()}))
    targs = [t(x).requires_grad_() for x in args]
    tkw = {k: t(v) for k, v in kw.items()}
    got = TL.mla_attention(*targs, causal=True, chunk=chunk, **tkw)
    assert max_err(got.detach(), want) <= 1e-5 * max(1.0, np.abs(want).max())
    plain = TL.mla_attention(*[x.detach() for x in targs], causal=True,
                             **tkw)
    np.testing.assert_allclose(got.detach().numpy(), plain.numpy(),
                               rtol=2e-4, atol=2e-4)
    if chunk:
        w = torch.from_numpy(f(B, S, h, dv))
        grads = torch.autograd.grad((got * w).sum(), targs)
        ref_args = [x.detach().requires_grad_() for x in targs]
        ref = torch.autograd.grad(
            (TL.mla_attention(*ref_args, causal=True, **tkw) * w).sum(),
            ref_args)
        for g, r in zip(grads, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=2e-4,
                                       atol=2e-4)


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


def _pf(toks, length, tables=None, cached=None, adapter=None):
    B = toks.shape[0]
    adapter = _base(B) if adapter is None else adapter
    length = np.broadcast_to(_i32(length), (B,)).copy()
    c = None if cached is None else np.broadcast_to(_i32(cached), (B,)).copy()
    return (JPF(tokens=j(toks), length=j(length), adapter=j(adapter),
                block_tables=None if tables is None else j(tables),
                cached_len=None if c is None else j(c)),
            PFBatch(tokens=t(toks), length=t(length), adapter=t(adapter),
                    block_tables=None if tables is None else t(tables),
                    cached_len=None if c is None else t(c)))


def _dec(toks, pos, tables=None, length=None, adapter=None):
    B = toks.shape[0]
    adapter = _base(B) if adapter is None else adapter
    pos = np.broadcast_to(_i32(pos), (B,)).copy()
    ln = None if length is None else _i32(length)
    return (JDEC(tokens=j(toks), pos=j(pos), adapter=j(adapter),
                 block_tables=None if tables is None else j(tables),
                 length=None if ln is None else j(ln)),
            DECBatch(tokens=t(toks), pos=t(pos), adapter=t(adapter),
                     block_tables=None if tables is None else t(tables),
                     length=None if ln is None else t(ln)))


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
                                         torch.float32)}
    return {"j": JM.init_cache(s["jcfg"], B, rows_len),
            "t": TM.init_cache(s["cfg"], B, rows_len, CPU, torch.float32)}


def test_prefill_then_decode_matches_full(s):
    """Dense rows: prefill 10 tokens, decode 3 one at a time, against one
    prefill of all 13 (2e-4, that test's tolerance) and against JAX's
    decode logits and latent rows."""
    B, S, extra = 2, 10, 3
    toks = _toks(s, B, S + extra)
    st = _caches(s, paged=False)
    out, jout = _both(s, pf=_pf(toks[:, :S], S), state=st)
    for i in range(extra):
        out, jout = _both(s, dec=_dec(toks[:, S + i], S + i), state=st)
        assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(st["t"], st["j"], skip_null=False)
    ref = _fwd(s, UnifiedBatch(pf=_pf(toks, S + extra)[1]),
               TM.init_cache(s["cfg"], B, 32, CPU, torch.float32))
    np.testing.assert_allclose(out.dec_logits.numpy(), ref.pf_logits.numpy(),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n_chunks", [2, 3])
def test_chunked_suffix_prefill_matches_full(s, n_chunks):
    """A 23-token prompt through ``n_chunks`` suffix-only prefill calls
    (non-aligned cuts) gives the full prefill's logits and latent pool (2e-5,
    that test's tolerance), and each call's logits and pool equal JAX's."""
    B, S = 2, 23
    rng = np.random.default_rng(n_chunks)
    toks = _toks(s, B, S)
    full = _fwd(s, UnifiedBatch(pf=_pf(toks, S, TBL4)[1]),
                TM.init_paged_cache(s["cfg"], 9, 8, CPU, torch.float32))
    cuts = sorted(rng.choice(np.arange(1, S), size=n_chunks - 1,
                             replace=False))
    pts = [0] + [int(c) for c in cuts] + [S]
    st = _caches(s)
    for lo, hi in zip(pts, pts[1:]):
        out, jout = _both(s, pf=_pf(toks[:, lo:hi], hi - lo, TBL4, lo),
                          state=st)
        assert _close(out.pf_logits, jout.pf_logits)
        _same_cache(st["t"], st["j"])
    a, b = full.pf_logits.numpy(), out.pf_logits.numpy()
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=2e-5)
    for name in LEAVES:
        np.testing.assert_allclose(full.cache[name].numpy(),
                                   st["t"][name].numpy(), rtol=2e-5,
                                   atol=2e-5)


def test_verify_chunk_matches_sequential_decode(s):
    """A (1 + k)-token verify chunk over interleaved blocks, with a padded
    slot in row 1, gives sequential decode's logits at every valid position
    (2e-4) and JAX's chunk logits and pool."""
    B, S, k = 2, 10, 3
    toks = _toks(s, B, S + k + 1)
    st = _caches(s)
    _both(s, pf=_pf(toks[:, :S], S, TBL4), state=st)
    seq = []
    for i in range(k + 1):
        out, jout = _both(s, dec=_dec(toks[:, S + i], S + i, TBL4), state=st)
        assert _close(out.dec_logits, jout.dec_logits)
        seq.append(out.dec_logits.numpy())
    seq = np.stack(seq, axis=1)
    st = _caches(s)
    _both(s, pf=_pf(toks[:, :S], S, TBL4), state=st)
    out, jout = _both(s, dec=_dec(toks[:, S:S + k + 1], S, TBL4,
                                  length=[k + 1, k]), state=st)
    chunk = out.dec_logits.numpy()
    assert chunk.shape[:2] == (B, k + 1)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(st["t"], st["j"])
    np.testing.assert_allclose(chunk[0], seq[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(chunk[1, :k], seq[1, :k], rtol=2e-4,
                               atol=2e-4)


def test_paged_forward_matches_dense(s):
    """Prefill + 3 decode steps through interleaved blocks equal the dense
    rows (2e-4) and JAX's paged run."""
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
    _same_cache(st["t"], st["j"])


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
    paged prefill, then paged decode with an inactive row, then a suffix
    prefill over an adopted block beside verify chunks of ragged lengths;
    each step's logits, ft losses, aux loss and both latent pools."""
    cfg = s["cfg"]
    rng = np.random.default_rng(0)
    V = cfg.vocab
    st = {"j": JM.init_paged_cache(s["jcfg"], NB, BS, 4),
          "t": TM.init_paged_cache(cfg, NB, BS, CPU, torch.float32)}
    ft = _ft_rows(rng, V)
    p0, p1 = rng.integers(0, V, 13), rng.integers(0, V, 20)
    toks = np.zeros((2, 24), np.int32)
    toks[0, :13], toks[1, :20] = p0, p1
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
    assert float(out.aux_loss) > 0
    assert abs(float(out.aux_loss) - float(jout.aux_loss)) \
        <= LOSS_REL * abs(float(jout.aux_loss))
    _same_cache(st["t"], st["j"])
    tables = np.stack([_table(1, 2), _table(3, 4, 5), _table()])
    nxt = out.pf_logits.argmax(-1).numpy()
    out, jout = _both(s, dec=_dec(_i32([nxt[0], nxt[1], 0]), [13, 20, 0],
                                  tables, adapter=_i32([0, 1, -1])),
                      state=st, loras=True)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(st["t"], st["j"])
    nxt = out.dec_logits.argmax(-1).numpy()
    chunk = np.zeros((3, 3), np.int32)
    chunk[:2, 0] = nxt[:2]
    chunk[:2, 1:] = rng.integers(0, V, (2, 2))
    p2 = np.concatenate([p0[:8], rng.integers(0, V, 9)])
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1, :11] = p2[8:], rng.integers(0, V, 11)
    out, jout = _both(
        s, pf=_pf(toks, [9, 11], np.stack([_table(1, 6, 7), _table(8, 9)]),
                  cached=[8, 0], adapter=_i32([0, 1])),
        dec=_dec(chunk, [14, 21, 0], tables, length=[3, 2, 1],
                 adapter=_i32([0, 1, -1])), state=st, loras=True)
    assert out.dec_logits.shape == (3, 3, V)
    assert _close(out.pf_logits, jout.pf_logits)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(st["t"], st["j"])


@pytest.mark.parametrize("attn_chunk", [0, 16])
def test_grad_step_matches_jax(s, attn_chunk):
    """The ft bucket's grad step against ``repro.core.unified``'s: loss (the
    router aux loss included) and every bank leaf, ``wdkv``'s included; with
    ``attn_chunk=16`` the 24-token rows take the chunked MLA."""
    ft = _ft_rows(np.random.default_rng(1), s["cfg"].vocab)
    jb = JUB(ft=JFT(**{k: j(v) for k, v in ft.items()}))
    tb = UnifiedBatch(ft=FTBatch(**{k: t(v) for k, v in ft.items()}))
    jres = j_make_grad_step(s["jcfg"], attn_chunk=attn_chunk)(
        s["jparams"], s["jbank"], s["jscale"], jb, None)
    tres = make_grad_step(s["cfg"], block_t=BT, attn_chunk=attn_chunk)(
        s["params"], s["bank"], s["scale"], tb, None)
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= LOSS_REL * abs(float(jres.loss))
    want = to_port_bank(jres.grads, s["tmp"] / f"g{attn_chunk}.npz")
    for lg, lw in zip(tres.grads["layers"], want["layers"]):
        assert lg.keys() == lw.keys() and "wdkv" in lg
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lw[name][ab]
                lim = GRAD_REL * max(float(w.abs().max()), 1e-12)
                assert max_err(g, w) <= lim, (name, ab)
    assert float(tres.grads["layers"][0]["wdkv"]["b"].abs().max()) > 0


# ------------------------------------------------------------- engines
_JAX_RUNS = {}


def _stores(s, names=("serve",)):
    """(JAX store, port store) with JAX-drawn adapters under ``names``."""
    jstore = JAdapterStore(s["jcfg"], JLoRAConfig(**LCFG),
                           jax.random.PRNGKey(1))
    store = AdapterStore(s["cfg"], LoRAConfig(**LCFG), device="cpu")
    for i, name in enumerate(names):
        jstore.load_random(name, jax.random.PRNGKey(2 + i))
        store.load(name, to_port_bank(jstore.get_adapter(name),
                                      s["tmp"] / f"e_{name}.npz"))
    return jstore, store


def _shared_reqs(R, vocab, n=5, max_new=6, seed=0):
    """``test_hash_dedup.py``'s (and ``test_prefix_prefill.py``'s) trace: a
    32-token shared head, tails of 4-11 tokens."""
    head = np.arange(32, dtype=np.int32) % vocab
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, vocab, rng.integers(4, 12))
                 .astype(np.int32)]),
              adapter="serve", max_new_tokens=max_new, arrival=0.25 * i)
            for i in range(n)]


ECFG = dict(capacity=4, pf_capacity=2, s_max=96, block_size=16,
            virtual_time=True)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=8000)
    return {r.rid: list(r.output) for r in eng.finished}


def _jax_shared(s):
    """The JAX engine on the shared-head trace (dedup on), run once."""
    if "shared" not in _JAX_RUNS:
        jstore, _ = _stores(s)
        eng = JUnifiedEngine(JMixedLoraModel(s["jcfg"], s["jparams"], jstore),
                             JEngineConfig(**ECFG))
        out = _run(eng, _shared_reqs(JRequest, s["cfg"].vocab))
        _JAX_RUNS["shared"] = (out, eng.metrics.reused_prefix_tokens,
                               eng.metrics.hash_hits, eng.metrics.steps)
    return _JAX_RUNS["shared"]


def _port_engine(s, **kw):
    _, store = _stores(s)
    return UnifiedEngine(MixedLoraModel(s["cfg"], s["params"], store),
                         EngineConfig(**{**ECFG, **kw}))


def test_engine_suffix_prefill_matches_no_dedup(s):
    """Suffix-only prefill over hash-adopted latent blocks emits the
    no-dedup engine's tokens and skips work, and both equal the JAX
    engine's."""
    vocab = s["cfg"].vocab
    plain = _run(_port_engine(s, hash_dedup=False),
                 _shared_reqs(Request, vocab))
    eng = _port_engine(s)
    shared = _run(eng, _shared_reqs(Request, vocab))
    assert len(shared) == 5 and shared == plain
    m = eng.metrics
    assert m.reused_prefix_tokens >= 32 * 4
    assert m.hash_hits >= 2 * 4
    assert m.starved_ticks == 0
    jout, _, _, jsteps = _jax_shared(s)
    assert shared == jout and m.steps == jsteps
    assert eng.cachemgr.pristine


def test_hash_adoption_matches_explicit_reuse_span(s):
    """Every request after the first adopts exactly the 32-token head (2
    blocks of 16), as the JAX engine does: tokens, reused tokens and hash
    hits equal JAX's."""
    n = 5
    eng = _port_engine(s)
    out = _run(eng, _shared_reqs(Request, s["cfg"].vocab, n=n))
    assert len(out) == n
    assert eng.metrics.reused_prefix_tokens == 32 * (n - 1)
    assert eng.metrics.hash_hits == 2 * (n - 1)
    jout, jreused, jhits, _ = _jax_shared(s)
    assert out == jout
    assert (eng.metrics.reused_prefix_tokens, eng.metrics.hash_hits) \
        == (jreused, jhits)


def _fleet_trace(R, vocab, n=6, seed=0, head_len=48):
    """``test_fleet.py``'s trace: a 48-token head, tails of 4-11 tokens."""
    head = np.arange(head_len, dtype=np.int32) % vocab
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, vocab, rng.integers(4, 12))
                 .astype(np.int32)]),
              adapter="serve", max_new_tokens=6, arrival=0.05 * i)
            for i in range(n)]


def test_engine_and_fleet_match_jax(s):
    """The engine with speculation off gives the JAX engine's greedy tokens
    and steps on the fleet trace; a 2-replica round-robin fleet with remote
    fetch (latent blocks copied between pools by ``import_block``) gives
    the same tokens, with every pool pristine."""
    vocab = s["cfg"].vocab
    cost = dict(fixed=1e-3, prefill_per_tok=1e-4)
    jstore, _ = _stores(s)
    jeng = JUnifiedEngine(JMixedLoraModel(s["jcfg"], s["jparams"], jstore),
                          JEngineConfig(**ECFG))
    jout = _run(jeng, _fleet_trace(JRequest, vocab))
    eng = _port_engine(s)
    out = _run(eng, _fleet_trace(Request, vocab))
    assert len(out) == 6 and out == jout
    assert eng.metrics.steps == jeng.metrics.steps
    _, store = _stores(s)
    fleet = build_fleet(
        MixedLoraModel(s["cfg"], s["params"], store),
        EngineConfig(**ECFG, cost=CostModel(**cost)),
        FleetConfig(replicas=2, router=RouterConfig(policy="round-robin")))
    for r in _fleet_trace(Request, vocab):
        fleet.submit(r)
    fm = fleet.run()
    got = {r.rid: list(r.output) for e in fleet.engines for r in e.finished}
    assert got == out
    assert fm.remote_fetch_blocks > 0
    assert all(e.cachemgr.pristine for e in fleet.engines)
    fleet.index.check_bijection()


# ------------------------------------------------------------ host tier
def _mgrs(s, **kw):
    kw = dict(block_size=8, n_blocks=12, **kw)
    return (JK.PagedCacheManager(s["jcfg"], 4, 2, 64, **kw),
            TK.PagedCacheManager(s["cfg"], 4, 2, 64, device=CPU,
                                 dtype=torch.float32, **kw))


def _scribble(jm, tm, bids, seed=0):
    """The same random latent in ``bids`` of both pools (numpy, by leaf)."""
    rng = np.random.default_rng(seed)
    pay = {k: rng.standard_normal((tm.cache[k].shape[0], len(bids))
                                  + tuple(tm.cache[k].shape[2:]))
           .astype(np.float32) for k in LEAVES}
    jm.cache = JK._blocks_write(jm.cache, jnp.asarray(bids, jnp.int32),
                                ({k: jnp.asarray(v) for k, v in pay.items()},))
    for k, v in pay.items():
        tm.cache[k][:, torch.tensor(bids)] = torch.from_numpy(v)
    return pay


@pytest.mark.parametrize("host_quant", [False, True])
def test_host_tier_swap_restore_like_jax(s, host_quant):
    """The static footprints equal JAX's (raw: 2 layers x 8 positions x
    (64 + 16) fp32; int8: payload plus an fp32 scale per (layer, column),
    ``quantize_leaf``'s axis -2 being the block's positions); a swap-out
    stores JAX's payload (int8: ``_q8``/``_qs`` bit-equal to JAX
    ``quantize_leaf`` of ``ckv`` and ``kpe``), and the restore writes JAX's
    blocks back (raw: bit-exact to the victim's)."""
    jm, tm = _mgrs(s, host_blocks=4, host_quant=host_quant)
    assert tm.adapter_block_bytes == jm.adapter_block_bytes == 2 * 8 * 80 * 4
    want_host = 2 * (8 * 80 + 80 * 4) if host_quant else 2 * 8 * 80 * 4
    assert tm.host_block_bytes == jm.host_block_bytes == want_host
    prompt = np.arange(20, dtype=np.int32)
    for m in (jm, tm):
        slot, _ = m.try_admit(prompt, max_new=4)
        m.commit_prefill([(0, slot)], [20])
    bids = list(tm.tables[slot])
    assert bids == list(jm.tables[slot]) and len(bids) == 3
    before = _scribble(jm, tm, bids, seed=3)
    sids = [m.swap_out(slot) for m in (jm, tm)]
    jent = jm.host_pool._swap_sets[sids[0]]["layers"][0]
    tent = tm.host_payload(tm.host_pool._swap_sets[sids[1]])
    assert list(tent) == list(LEAVES)
    for k in LEAVES:
        if host_quant:
            mine = quant.quantize_leaf(torch.from_numpy(before[k]))
            theirs = j_quantize_leaf(jnp.asarray(before[k]))
            for part in ("_q8", "_qs"):
                np.testing.assert_array_equal(tent[k][part].numpy(),
                                              jent[k][part])
                np.testing.assert_array_equal(mine[part].numpy(),
                                              np.asarray(theirs[part]))
        else:
            np.testing.assert_array_equal(tent[k].numpy(), before[k])
            np.testing.assert_array_equal(np.asarray(jent[k]), before[k])
    assert tm.kv_swap_out_bytes == jm.kv_swap_out_bytes \
        == 3 * tm.host_block_bytes
    for m in (jm, tm):
        m.free(slot)
        slot2, _ = m.try_admit(prompt, max_new=4)
    assert [m.restore_swap(slot2, sid) for m, sid in zip((jm, tm), sids)] \
        == [19, 19]
    idx = list(tm.tables[slot2][:3])
    for k in LEAVES:
        mine = tm.cache[k][:, torch.tensor(idx)].numpy()
        np.testing.assert_array_equal(
            mine, np.asarray(_jax_leaf(jm.cache, k)[:, np.asarray(idx)]))
        if not host_quant:
            np.testing.assert_array_equal(mine, before[k])


# ------------------------------------------------------------ int8 weights
def test_int8_at_an_eligible_mla_shape_matches_jax(s):
    """At 64 heads with dn = dv = 64 the up projections ``wuk``/``wuv``
    [P, 64, 64, 64] are eligible: ``quantize_params`` (walking ``c``,
    grouping over ``h``) is bit-equal to JAX's, and the int8 forward (a
    paged prefill with adapters, then a decode step) equals JAX's."""
    mla = dict(kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=64,
               v_head_dim=64)
    jcfg = s["jcfg"].replace(n_heads=64, n_kv_heads=64,
                             mla=JMLAConfig(**mla))
    cfg = s["cfg"].replace(n_heads=64, n_kv_heads=64, mla=MLAConfig(**mla))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(5))
    jq = jquant.quantize_params(jcfg, jparams)
    assert jquant.is_q8(jq["blocks"][0]["wuk"])
    mine = quant.quantize_params(cfg, to_port_params(jparams,
                                                     s["tmp"] / "q_p.npz"))
    theirs = to_port_params(jq, s["tmp"] / "q_q.npz")
    for li in range(cfg.n_layers):
        assert mine["layers"][li].keys() == theirs["layers"][li].keys()
        for k, v in mine["layers"][li].items():
            if quant.is_q8(v):
                for part in ("_q8", "_qs"):
                    assert torch.equal(v[part], theirs["layers"][li][k][part])
            else:
                assert torch.equal(v, theirs["layers"][li][k]), k
        assert quant.is_q8(mine["layers"][li]["wuv"])
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(6))
    jstore.load_random("a0", jax.random.PRNGKey(7))
    bank = to_port_bank(jstore.bank, s["tmp"] / "q_bank.npz")
    scale = t(np.asarray(jstore.scale))
    toks = _toks(s, 2, 16, seed=8)      # rows of whole SMLM tiles
    tables = np.array([[1, 2], [3, 4]], np.int32)
    jc = JM.init_paged_cache(jcfg, 6, 8, 2)
    tc = TM.init_paged_cache(cfg, 6, 8, CPU, torch.float32)
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
    for name in LEAVES:
        assert _close(tc[name][:, 1:], _jax_leaf(jout.cache, name)[:, 1:])
