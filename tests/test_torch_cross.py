"""The port's cross-attention family (``llama-3.2-vision-90b``: a cross layer
every fifth, image patches as the source; ``whisper-base``: every decoder
layer cross-attends to a bidirectional encoder's output) against the JAX
package, in fp32 on the CPU at reduced size (the VLM: 5 layers, d_model
256, 16 image tokens; Whisper: 2 + 2 layers, d_model 128, 32 frames).

JAX weights cross over through the bridge with ``xgate`` set nonzero (0.5
on the first period, +0.25 a period): the schema draws it as zeros, and
``tanh(0) = 0`` would hide a broken cross path.  The LoRA banks target
``xwq`` / ``xwo`` beside the defaults.  Every ``aux_embed`` is drawn from a
numpy seed and handed to both packages.

* The registry, the schema (``param_shapes`` against the JAX npz keys,
  LoRA targets) and the cache layout; block footprints skip the ``xk`` /
  ``xv`` rows.
* ``_cross_apply`` (ft, prefill and decode buckets in one plan, with and
  without ``attn_chunk``) and ``encoder_forward`` within 1e-5 of max(1,
  max |JAX|).
* Prefill-then-decode equals one full forward (2e-4, the twin of
  ``test_cache_equivalence.py``); paged equals dense rows; the mixed ft +
  prefill + decode stream, suffix and chunked prefill and verify chunks
  equal JAX's (1e-4 of max(1, max |JAX|), every cache leaf); the ft grad
  step (loss 1e-5 relative, grads 1e-4 of a leaf's max |JAX|).
* ``quantize_params`` is bit-equal to JAX's (encoder included), the q8
  bridge carries the encoder, and the int8 forward equals JAX's.

The engines, the fleet and the CLIs are held to JAX's in
``test_torch_cross_serving.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import get_config as j_get_config, \
    get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_make_grad_step
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM, quant as jquant, schema as jschema
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.serving import kvcache as JK
from repro_torch.checkpoint.io import load_npz
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_grad_step
from repro_torch.models import model as TM, quant
from repro_torch.models.schema import layer_shapes, lora_targets, \
    param_shapes
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.serving import kvcache as TK

VLM, WHISPER = "llama-3.2-vision-90b", "whisper-base"
ARCHS = [VLM, WHISPER]
TOL, LOSS_REL, GRAD_REL, FN_REL = 1e-4, 1e-5, 1e-4, 1e-5
BT, BS, NB, NBT = 8, 8, 24, 6
TARGETS = JLoRAConfig().targets + ("xwq", "xwo")
LCFG = dict(n_slots=4, r=4, targets=TARGETS)
CPU = torch.device("cpu")
TBL4 = np.array([[3, 1, 7, 5], [2, 6, 4, 8]], np.int32)   # interleaved


def _gated(jcfg, jparams):
    """JAX params with every ``xgate`` set nonzero (0.5 + 0.25 a period)."""
    blocks = []
    for blk in jparams["blocks"]:
        if "xgate" in blk:
            blk = dict(blk, xgate=(0.5 + 0.25 * jnp.arange(
                jcfg.n_periods, dtype=jnp.float32)).astype(
                    blk["xgate"].dtype))
        blocks.append(blk)
    return dict(jparams, blocks=tuple(blocks))


_SETUPS = {}


def _setup(arch, tmp):
    """Gated JAX weights, a JAX store with two nonzero-B adapters over the
    cross targets too, and their bridged port copies (once per arch)."""
    if arch not in _SETUPS:
        jcfg = j_get_reduced(arch)
        jparams = _gated(jcfg, jschema.init_params(jcfg,
                                                   jax.random.PRNGKey(0)))
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
    return tmp_path_factory.mktemp("cross")


@pytest.fixture(params=ARCHS, scope="module")
def s(request, tmp):
    return _setup(request.param, tmp)


def _i32(x):
    return np.asarray(x, np.int32)


def _F(cfg):
    return cfg.encoder.n_frames if cfg.encoder else cfg.n_img_tokens


def _aux(cfg, B, seed=9, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, _F(cfg), cfg.d_model))
            * scale).astype(np.float32)


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


# ------------------------------------------------------- registry, schema
@pytest.mark.parametrize("arch", ARCHS)
def test_registry_and_schema_match_jax(arch, tmp):
    """Full and reduced configs equal JAX's; ``param_shapes`` is the key
    set and the shapes of the npz the JAX package writes (the encoder's
    ``encoder/blocks/<leaf>`` [ne, ...] included); the LoRA targets cover
    ``xwq`` / ``xwo`` on the cross layers only, as JAX's do; the bridge
    gives every layer the schema's leaves and shapes."""
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    s = _setup(arch, tmp)
    cfg, jcfg = s["cfg"], s["jcfg"]
    flat = load_npz(str(tmp / f"{arch.replace('.', '_')}_p.npz"))
    shapes = param_shapes(cfg)
    assert set(shapes) == set(flat)
    for k, v in flat.items():
        assert shapes[k] == v.shape, k
    P = len(cfg.pattern)
    jt = jschema.lora_targets(jcfg, TARGETS)["blocks"]
    mine = lora_targets(cfg, TARGETS)
    for li in range(cfg.n_layers):
        want = {k: (v.d_in, v.d_out) for k, v in jt[li % P].items()}
        assert {k: (v.d_in, v.d_out) for k, v in mine[li].items()} == want
        cross = cfg.is_cross_layer(li % P)
        assert ("xwq" in mine[li]) == ("xwo" in mine[li]) == cross
        leaves = layer_shapes(cfg, li)
        assert ("xgate" in leaves) == cross
        p = s["params"]["layers"][li]
        assert set(p) == set(leaves)
        for k, leaf in leaves.items():
            assert tuple(p[k].shape) == leaf.shape, (li, k)
    assert not any("xwq" in lt for lt in lora_targets(cfg,
                                                      LoRAConfig().targets))
    if cfg.encoder is not None:
        enc = s["params"]["encoder"]
        assert len(enc["layers"]) == cfg.encoder.n_layers
        for i, layer in enumerate(enc["layers"]):
            np.testing.assert_array_equal(
                layer["wq"].numpy(),
                np.asarray(s["jparams"]["encoder"]["blocks"]["wq"][i]))
    else:
        assert "encoder" not in s["params"]


def test_cache_layout_and_block_bytes_match_jax(s):
    """``xk`` / ``xv`` exist only over the cross layers ([L_cross, rows, F,
    g, hd], after ``k`` / ``v``), in both layouts; the paged manager's
    block footprints (device and int8 host) are JAX's and count ``k`` /
    ``v`` alone: state rows are not blocks."""
    cfg = s["cfg"]
    tc = TM.init_paged_cache(cfg, 9, 8, CPU, torch.float32, n_rows=5)
    jc = JM.init_paged_cache(s["jcfg"], 9, 8, 5)
    assert list(tc) == ["k", "v", "xk", "xv"]
    n_cross = sum(cfg.is_cross_layer(li % len(cfg.pattern))
                  for li in range(cfg.n_layers))
    assert tuple(tc["xk"].shape) == (n_cross, 5, _F(cfg), cfg.n_kv_heads,
                                     cfg.hd)
    for name in tc:
        assert tuple(tc[name].shape) == _jax_leaf(cfg, jc, name).shape
    dense = TM.init_cache(cfg, 3, 16, CPU, torch.float32)
    jd = JM.init_cache(s["jcfg"], 3, 16)
    for name in dense:
        assert tuple(dense[name].shape) == _jax_leaf(cfg, jd, name).shape
    for host_quant in (False, True):
        kw = dict(block_size=8, n_blocks=12, host_blocks=4,
                  host_quant=host_quant)
        jm = JK.PagedCacheManager(s["jcfg"], 4, 2, 64, **kw)
        tm = TK.PagedCacheManager(cfg, 4, 2, 64, device=CPU,
                                  dtype=torch.float32, **kw)
        assert set(tm.block_leaves) == {"k", "v"}
        assert tm.adapter_block_bytes == jm.adapter_block_bytes \
            == 2 * cfg.n_layers * 8 * cfg.n_kv_heads * cfg.hd * 4
        assert tm.host_block_bytes == jm.host_block_bytes


# ------------------------------------------------- the sublayer, encoder
def _layer(s, li):
    """Layer ``li``'s params and LoRA leaves on both sides."""
    P = len(s["cfg"].pattern)
    pos, per = li % P, li // P
    jp = {k: v[per] for k, v in s["jparams"]["blocks"][pos].items()}
    jl = jax.tree_util.tree_map(lambda v: v[per], s["jbank"]["blocks"][pos])
    return jp, jl, s["params"]["layers"][li], s["bank"]["layers"][li]


@pytest.mark.parametrize("chunk", [0, 8])
def test_cross_apply_matches_jax(s, chunk):
    """One plan of ft rows (2 x 8), prefill rows (2 x 8, lengths 8 / 5) and
    decode rows (3, one inactive) through the first cross layer with
    adapters on ``xwq`` / ``xwo``: the sublayer's output and the prefill
    rows it writes into ``xk`` / ``xv`` equal JAX's (1e-5), the decode
    rows read what sits in rows ``[0, Bd)``, and the sublayer moves the
    residual (the gate is open)."""
    cfg, jcfg = s["cfg"], s["jcfg"]
    li = next(i for i in range(cfg.n_layers)
              if cfg.is_cross_layer(i % len(cfg.pattern)))
    jp, jl, tp, tl = _layer(s, li)
    assert "xwq" in tl and "xwo" in tl
    rng = np.random.default_rng(3)
    V, d, F = cfg.vocab, cfg.d_model, _F(cfg)
    toks = rng.integers(0, V, (2, 8)).astype(np.int32)
    ft = dict(tokens=toks, mask=np.ones((2, 8), bool), labels=toks,
              adapter=_i32([0, 1]), weight=np.ones(2, np.float32),
              aux_embed=_aux(cfg, 2, seed=4))
    pf = dict(tokens=toks[::-1].copy(), length=_i32([8, 5]),
              adapter=_i32([1, -1]), aux_embed=_aux(cfg, 2, seed=5))
    dec = dict(tokens=_i32([3, 4, 0]), pos=_i32([9, 4, 0]),
               adapter=_i32([0, 1, -1]))
    jb = JUB(ft=JFT(**{k: j(v) for k, v in ft.items()}),
             pf=JPF(**{k: j(v) for k, v in pf.items()}),
             dec=JDEC(**{k: j(v) for k, v in dec.items()}))
    tb = UnifiedBatch(ft=FTBatch(**{k: t(v) for k, v in ft.items()}),
                      pf=PFBatch(**{k: t(v) for k, v in pf.items()}),
                      dec=DECBatch(**{k: t(v) for k, v in dec.items()}))
    T = 16 + 16 + 3
    x = rng.standard_normal((T, d)).astype(np.float32)
    rows = (rng.standard_normal((5, F, cfg.n_kv_heads, cfg.hd))
            .astype(np.float32))
    jcache = {"xk": j(rows), "xv": j(rows * 0.5)}
    jnew = dict(jcache)
    jplan = JM._Plan(jcfg, jb, s["jscale"])
    want = JM._cross_apply(jcfg, jp, jl, jplan, j(x), jcache, jnew, chunk)
    tcache = {"xk": t(rows), "xv": t(rows * 0.5)}
    plan = TM._Plan(cfg, tb, s["scale"], BT)
    with torch.no_grad():
        got = TM._cross_apply(cfg, tp, tl, plan, t(x), tcache, chunk)
    assert _close(got, want, FN_REL)
    for name in ("xk", "xv"):
        assert _close(tcache[name], jnew[name], FN_REL), name
        np.testing.assert_array_equal(tcache[name][:3].numpy(),
                                      np.asarray(jcache[name])[:3])
    assert float((got - t(x)).abs().max()) > 1e-2


def test_encoder_forward_matches_jax(tmp):
    """Whisper's bidirectional encoder over 2 x 32 frames equals JAX's
    (1e-5 of max |JAX|); a frame moves every output frame (no causal
    mask)."""
    s = _setup(WHISPER, tmp)
    frames = _aux(s["cfg"], 2, seed=7)
    want = JM.encoder_forward(s["jcfg"], s["jparams"]["encoder"], j(frames))
    with torch.no_grad():
        got = TM.encoder_forward(s["cfg"], s["params"]["encoder"],
                                 t(frames))
        assert _close(got, want, FN_REL)
        moved = frames.copy()
        moved[:, -1] += 1.0
        diff = (TM.encoder_forward(s["cfg"], s["params"]["encoder"],
                                   t(moved)) - got)[:, 0].abs().max()
    assert float(diff) > 1e-4


# ----------------------------------------------------- model-level twins
def _fwd(s, batch, cache, loras=False, **kw):
    if loras:
        kw.update(loras=s["bank"], lora_scale=s["scale"])
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


def _pf(toks, length, aux, tables=None, adapter=None, cached=None):
    B = toks.shape[0]
    adapter = _base(B) if adapter is None else adapter
    length = np.broadcast_to(_i32(length), (B,)).copy()
    opt = lambda f, x: None if x is None else f(x)
    return (JPF(tokens=j(toks), length=j(length), adapter=j(adapter),
                aux_embed=j(aux), block_tables=opt(j, tables),
                cached_len=opt(j, cached)),
            PFBatch(tokens=t(toks), length=t(length), adapter=t(adapter),
                    aux_embed=t(aux), block_tables=opt(t, tables),
                    cached_len=opt(t, cached)))


def _dec(toks, pos, tables=None, adapter=None, length=None):
    B = toks.shape[0]
    adapter = _base(B) if adapter is None else adapter
    pos = np.broadcast_to(_i32(pos), (B,)).copy()
    opt = lambda f, x: None if x is None else f(x)
    return (JDEC(tokens=j(toks), pos=j(pos), adapter=j(adapter),
                 block_tables=opt(j, tables), length=opt(j, length)),
            DECBatch(tokens=t(toks), pos=t(pos), adapter=t(adapter),
                     block_tables=opt(t, tables), length=opt(t, length)))


def _both(s, pf=None, dec=None, ft=None, state=None, loras=False):
    """One step on both packages; ``state`` holds each side's cache."""
    jb = JUB(ft=ft and ft[0], pf=pf and pf[0], dec=dec and dec[0])
    tb = UnifiedBatch(ft=ft and ft[1], pf=pf and pf[1], dec=dec and dec[1])
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


def test_prefill_then_decode_matches_full(s):
    """Dense rows: prefill 10 tokens with an image / audio source, decode 3
    one at a time (reading the ``xk`` / ``xv`` rows), against one prefill
    of all 13 (2e-4, that test's tolerance) and against JAX's logits and
    every cache leaf; another source changes the logits."""
    B, S, extra = 2, 10, 3
    toks = _toks(s, B, S + extra)
    aux = _aux(s["cfg"], B)
    st = _caches(s, paged=False)
    out, jout = _both(s, pf=_pf(toks[:, :S], S, aux), state=st)
    assert _close(out.pf_logits, jout.pf_logits)
    for i in range(extra):
        out, jout = _both(s, dec=_dec(toks[:, S + i], S + i), state=st)
        assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(s["cfg"], st["t"], st["j"], skip_null=False)
    ref = _fwd(s, UnifiedBatch(pf=_pf(toks, S + extra, aux)[1]),
               TM.init_cache(s["cfg"], B, 32, CPU, torch.float32))
    np.testing.assert_allclose(out.dec_logits.numpy(), ref.pf_logits.numpy(),
                               rtol=2e-4, atol=2e-4)
    other = _fwd(s, UnifiedBatch(pf=_pf(toks, S + extra, aux * 3)[1]),
                 TM.init_cache(s["cfg"], B, 32, CPU, torch.float32))
    assert float((other.pf_logits - ref.pf_logits).abs().max()) > 1e-3


def test_paged_forward_matches_dense(s):
    """Prefill + 3 decode steps through interleaved blocks and state rows
    equal the dense rows (2e-4) and JAX's paged run."""
    B, S, extra = 2, 10, 3
    toks = _toks(s, B, S + extra)
    aux = _aux(s["cfg"], B, seed=2)

    def drive(st, tables):
        out, jout = _both(s, pf=_pf(toks[:, :S], S, aux, tables), state=st)
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


def _table(*bids):
    row = np.zeros((NBT,), np.int32)
    row[:len(bids)] = bids
    return row


def _ft(rng, cfg, lens=(13, 21), adapters=(0, 1), Sf=24, seed=11):
    B = len(lens)
    toks = np.zeros((B, Sf), np.int32)
    mask = np.zeros((B, Sf), bool)
    labels = np.full((B, Sf), -100, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
        mask[i, :n] = True
        labels[i, :n] = toks[i, :n]
    ft = dict(tokens=toks, mask=mask, labels=labels, adapter=_i32(adapters),
              weight=np.array([0.5, 1.0], np.float32)[:B],
              aux_embed=_aux(cfg, B, seed=seed))
    return (JFT(**{k: j(v) for k, v in ft.items()}),
            FTBatch(**{k: t(v) for k, v in ft.items()}))


def test_unified_forward_matches_jax(s):
    """The mixed stream with two nonzero-B adapters on every target,
    ``xwq`` / ``xwo`` included: ft rows beside a cold paged prefill (rows
    0-1), paged decode over rows 0-2 with an inactive row, then a suffix
    prefill over an adopted block and a cold row in the same positional
    bucket beside decode; each step's logits, ft losses and every cache
    leaf."""
    cfg = s["cfg"]
    rng = np.random.default_rng(0)
    V = cfg.vocab
    st = {"j": JM.init_paged_cache(s["jcfg"], NB, BS, 5),
          "t": TM.init_paged_cache(cfg, NB, BS, CPU, torch.float32,
                                   n_rows=5)}
    toks = np.zeros((2, 24), np.int32)
    p0, p1 = rng.integers(0, V, 13), rng.integers(0, V, 20)
    toks[0, :13], toks[1, :20] = p0, p1
    aux = _aux(cfg, 2, seed=12)
    out, jout = _both(
        s, ft=_ft(rng, cfg),
        pf=_pf(toks, [13, 20], aux, np.stack([_table(1, 2),
                                              _table(3, 4, 5)]),
               adapter=_i32([0, 1])), state=st, loras=True)
    assert _close(out.pf_logits, jout.pf_logits)
    want = np.asarray(jout.ft_loss_sum)
    assert max_err(out.ft_loss_sum, want) <= LOSS_REL * np.abs(want).max()
    _same_cache(cfg, st["t"], st["j"])
    tables = np.stack([_table(1, 2), _table(3, 4, 5), _table()])
    nxt = out.pf_logits.argmax(-1).numpy()
    out, jout = _both(s, dec=_dec(_i32([nxt[0], nxt[1], 0]), [13, 20, 0],
                                  tables, adapter=_i32([0, 1, -1])),
                      state=st, loras=True)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(cfg, st["t"], st["j"])
    nxt = out.dec_logits.argmax(-1).numpy()
    p2 = np.concatenate([p0[:8], rng.integers(0, V, 9)])
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1, :11] = p2[8:], rng.integers(0, V, 11)
    out, jout = _both(
        s, pf=_pf(toks, [9, 11], _aux(cfg, 2, seed=13),
                  np.stack([_table(1, 6, 7), _table(8, 9)]),
                  adapter=_i32([1, 0]), cached=_i32([8, 0])),
        dec=_dec(_i32([nxt[0], nxt[1], 0]), [14, 21, 0], tables,
                 adapter=_i32([0, 1, -1])), state=st, loras=True)
    assert _close(out.pf_logits, jout.pf_logits)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(cfg, st["t"], st["j"])


def test_verify_chunks_and_chunked_prefill_match_jax(s):
    """A prompt prefilled in two chunks (a cold chunk, then a suffix chunk
    at ``cached_len`` 8 that projects the source again and rewrites the
    row) gives the whole prompt's logits (2e-4) and JAX's; then a verify
    chunk of 3 (lengths 3 and 2, an inactive row) attends over the
    blocks and the cached ``xk`` / ``xv`` rows as JAX does."""
    cfg = s["cfg"]
    toks = _toks(s, 2, 14, seed=4)
    aux = _aux(cfg, 2, seed=14)
    tables = np.stack([_table(1, 2), _table(3, 4)])
    st = _caches(s, n_blocks=NB, B=3)
    _both(s, pf=_pf(toks[:, :8], 8, aux, tables, adapter=_i32([0, 1])),
          state=st, loras=True)
    tail = np.zeros((2, 8), np.int32)
    tail[:, :6] = toks[:, 8:]
    out, jout = _both(s, pf=_pf(tail, 6, aux, tables, adapter=_i32([0, 1]),
                                cached=_i32([8, 8])), state=st, loras=True)
    assert _close(out.pf_logits, jout.pf_logits)
    full = np.zeros((2, 16), np.int32)
    full[:, :14] = toks
    whole = _fwd(s, UnifiedBatch(pf=_pf(full, 14, aux, tables,
                                        adapter=_i32([0, 1]))[1]),
                 _caches(s, n_blocks=NB)["t"], loras=True)
    np.testing.assert_allclose(out.pf_logits.numpy(),
                               whole.pf_logits.numpy(), rtol=2e-4,
                               atol=2e-4)
    _same_cache(cfg, st["t"], st["j"])
    # the prefill rows sat at [0, 2); the decode bucket reads rows [0, Bd)
    chunk = _toks(s, 3, 3, seed=5)
    out, jout = _both(s, dec=_dec(chunk, [14, 14, 0],
                                  np.stack([tables[0], tables[1],
                                            _table()]),
                                  adapter=_i32([0, 1, -1]),
                                  length=_i32([3, 2, 0])),
                      state=st, loras=True)
    assert tuple(out.dec_logits.shape) == (3, 3, cfg.vocab)
    assert _close(out.dec_logits[:2], np.asarray(jout.dec_logits)[:2])
    _same_cache(cfg, st["t"], st["j"])


def test_grad_step_matches_jax(s):
    """The ft bucket's grad step with sources against ``repro.core.
    unified``'s: the loss and every bank leaf, ``xwq`` / ``xwo`` included
    (cross attention under autograd, Whisper's encoder in the graph but
    not trained)."""
    jft, tft = _ft(np.random.default_rng(1), s["cfg"], seed=15)
    jres = j_make_grad_step(s["jcfg"])(s["jparams"], s["jbank"],
                                       s["jscale"], JUB(ft=jft), None)
    tres = make_grad_step(s["cfg"], block_t=BT)(
        s["params"], s["bank"], s["scale"], UnifiedBatch(ft=tft), None)
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= LOSS_REL * abs(float(jres.loss))
    want = to_port_bank(jres.grads, s["tmp"] / f"g_{s['cfg'].name}.npz")
    seen = set()
    for lg, lw in zip(tres.grads["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lw[name][ab]
                lim = GRAD_REL * max(float(w.abs().max()), 1e-12)
                assert max_err(g, w) <= lim, (name, ab)
            if float(lg[name]["b"].abs().max()) > 0:
                seen.add(name)
    assert {"xwq", "xwo"} <= seen
    assert "encoder" not in tres.grads


@pytest.mark.parametrize("bucket", ["ft", "pf"])
def test_missing_aux_embed_raises(s, bucket):
    """A cross model's ft or prefill bucket without ``aux_embed`` raises a
    ``ValueError`` naming it (JAX fails inside its sublayer on None); a
    decode-only batch needs none."""
    cfg = s["cfg"]
    toks = _toks(s, 1, 8)
    if bucket == "ft":
        b = UnifiedBatch(ft=FTBatch(
            tokens=t(toks), mask=t(toks >= 0), labels=t(toks),
            adapter=t(_base(1)), weight=torch.ones(1)))
    else:
        b = UnifiedBatch(pf=PFBatch(tokens=t(toks), length=t(_i32([8])),
                                    adapter=t(_base(1))))
    cache = TM.init_cache(cfg, 1, 16, CPU, torch.float32)
    with pytest.raises(ValueError, match="aux_embed"):
        _fwd(s, b, cache)
    out = _fwd(s, UnifiedBatch(dec=_dec(toks[:, 0], 0)[1]), cache)
    assert torch.isfinite(out.dec_logits).all()


def test_commit_prefill_copies_cross_rows_like_jax(s):
    """The paged ``commit_prefill`` copies ``xk`` / ``xv`` rows ``src_base
    + i`` into the decode slots (on a prefill-only tick, rows that overlap
    their destinations), as the JAX manager does; ``k`` / ``v`` stay."""
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
        for name in d:
            col = 2 if name in ("xk", "xv") else 1
            rows = [index[li][col] for li in range(pos, cfg.n_layers, P)]
            d[name] = jnp.asarray(pay[name][rows])
    jm.cache = {"layers": tuple(layers)}
    slots = []
    for m in (jm, tm):
        a, _ = m.try_admit(np.arange(9, dtype=np.int32), 4, shareable=False)
        b, _ = m.try_admit(np.arange(20, 30, dtype=np.int32), 4,
                           shareable=False)
        slots.append((a, b))
    assert slots[0] == slots[1]
    a, b = slots[0]
    for base in (0, 3):
        for m in (jm, tm):
            m.commit_prefill([(0, b), (1, a)], [10, 9], src_base=base)
        _same_cache(cfg, tm.cache, jm.cache, skip_null=False)


# ------------------------------------------------------------ int8 weights
def test_int8_matches_jax(s):
    """``quantize_params`` is bit-equal to JAX's (``xwq`` / ``xwk`` /
    ``xwv`` / ``xwo`` and the encoder's matrices quantized, ``xln`` /
    ``xgate`` not); the q8 npz bridge carries the encoder; an int8 paged
    prefill and decode step with adapters equal JAX's."""
    cfg, jcfg = s["cfg"], s["jcfg"]
    jq = jquant.quantize_params(jcfg, s["jparams"])
    mine = quant.quantize_params(cfg, s["params"])
    theirs = to_port_params(jq, s["tmp"] / f"q8_{cfg.name}.npz")

    def same(a, b):
        assert quant.is_q8(a) == quant.is_q8(b)
        if quant.is_q8(a):
            for part in ("_q8", "_qs"):
                assert a[part].dtype == b[part].dtype
                assert torch.equal(a[part], b[part])
        else:
            assert torch.equal(a, b)

    for li in range(cfg.n_layers):
        assert mine["layers"][li].keys() == theirs["layers"][li].keys()
        for k, v in mine["layers"][li].items():
            same(v, theirs["layers"][li][k])
        if "xwq" in mine["layers"][li]:
            for k in ("xwq", "xwk", "xwv", "xwo"):
                assert quant.is_q8(mine["layers"][li][k]), k
            assert not quant.is_q8(mine["layers"][li]["xgate"])
            assert not quant.is_q8(mine["layers"][li]["xln"])
    if cfg.encoder is not None:
        for a, b in zip(mine["encoder"]["layers"],
                        theirs["encoder"]["layers"]):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
            assert quant.is_q8(a["wq"]) and not quant.is_q8(a["ln1"])
        same(mine["encoder"]["final_norm"], theirs["encoder"]["final_norm"])
    toks = _toks(s, 2, 16, seed=8)
    tables = np.array([[1, 2], [3, 4]], np.int32)
    aux = _aux(cfg, 2, seed=16)
    jc = JM.init_paged_cache(jcfg, 6, 8, 2)
    tc = TM.init_paged_cache(cfg, 6, 8, CPU, torch.float32, n_rows=2)
    ad = _i32([0, -1])
    pf = _pf(toks, [12, 9], aux, tables, adapter=ad)
    jout = JM.unified_forward(jcfg, jq, JUB(pf=pf[0]), jc,
                              loras=s["jbank"], lora_scale=s["jscale"])
    with torch.no_grad():
        out = TM.unified_forward(cfg, mine, UnifiedBatch(pf=pf[1]), tc,
                                 loras=s["bank"], lora_scale=s["scale"],
                                 block_t=BT)
    assert _close(out.pf_logits, jout.pf_logits)
    nxt = out.pf_logits.argmax(-1).numpy().astype(np.int32)
    dec = _dec(nxt, [12, 9], tables, adapter=ad)
    jout = JM.unified_forward(jcfg, jq, JUB(dec=dec[0]), jout.cache,
                              loras=s["jbank"], lora_scale=s["jscale"])
    with torch.no_grad():
        out = TM.unified_forward(cfg, mine, UnifiedBatch(dec=dec[1]), tc,
                                 loras=s["bank"], lora_scale=s["scale"],
                                 block_t=BT)
    assert _close(out.dec_logits, jout.dec_logits)
    _same_cache(cfg, tc, jout.cache)


