"""Remat of a layer period in the port's grad and train steps, one process,
reduced configs in fp32, against the JAX package's ``make_grad_step(...,
remat=True)`` / ``make_train_step(..., remat=True)`` on the same npz
weights, bank and batch, and against the port's own ``remat=False`` steps.

* Every family: llama3-8b, llama4-maverick (MoE), deepseek-v2 (MLA + MoE),
  mamba2, jamba (Mamba2 + attention + MoE, one 4-layer period), the VLM
  (one 5-layer period with a cross layer) and whisper (an encoder), and
  llama3-8b with int8 leaves (dequantized inside the period, again in the
  recompute): loss, every grad leaf, and one train step's new bank and
  moments.
* Mixed batches: llama3-8b with a paged suffix prefill and paged decode
  rows, llama3-8b at W = 8 with decode on rolling rows past the window,
  and jamba with Mamba decode rows beside MoE.  The cache after the step
  equals JAX's, and the grads equal the port's ``remat=False`` step's.  A
  planted fault, the recompute running the Mamba decode step again
  (``models.model._Tape.once`` bypassed), must break the cache's
  tolerance.
* ``saved_tensors_hooks``: each added period adds one saved tensor to a
  remat step, its input carry [T, d].
* ``make_forward_step(remat=True)`` gives the same outputs and cache as
  without.

Tolerances (fp32; the port's kernels' plain versions sum in another order
than XLA): each grad / bank / moment leaf within ``TOL`` = 2e-4 of that
leaf's max abs, the loss within 1e-4 of max(1, |loss|); logits and cache
leaves within 2e-4 of max(1, max |JAX|).  The train step runs AdamW with
eps 1e-5 and a clip that engages (``_torch_mesh_worker.TRAIN_OPT``).  In a
mixed tick with MoE layers JAX's router aux loss also sends gradient
through the serving rows' LoRA products, which carry none in the port
(ROADMAP Queue 3, by design), so jamba's mixed grads are held to the
port's ``remat=False`` step and its ft-only grads to JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointError

import _torch_mesh_worker as W
from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_grad_step, \
    make_train_step as j_train_step
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM, quant as jquant
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.training.optimizer import AdamWConfig as JAdamW, \
    adamw_init as j_adamw_init
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_forward_step, make_grad_step, \
    make_train_step
from repro_torch.core.virtualization import AdapterStore
from repro_torch.models import model as TM
from repro_torch.models.schema import init_params
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.training import optimizer as topt

CPU = torch.device("cpu")
BT = 8
TOL = W.TRAIN_TOL
LOSS_TOL = 1e-4
LCFG = dict(n_slots=4, r=4)
FAMILIES = ["llama3-8b", "llama4-maverick-400b-a17b", "deepseek-v2-236b",
            "mamba2-1.3b", "jamba-1.5-large-398b", "llama-3.2-vision-90b",
            "whisper-base", "llama3-8b:int8"]
BS, NB, NBT = 8, 16, 4            # the paged case's pool
WINDOW = 8
_SETUPS = {}


def _i32(x):
    return np.asarray(x, np.int32)


def _setup(key, tmp):
    """JAX weights (cross gates opened to 0.5 + 0.25 a period, as
    ``tests/test_torch_cross.py`` does), two nonzero-B adapters, bridged
    once per key (``arch``, ``arch:int8`` or ``arch:w8``)."""
    if key in _SETUPS:
        return _SETUPS[key]
    arch, _, kind = key.partition(":")
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    if kind == "w8":
        jcfg = jcfg.replace(sliding_window=WINDOW)
        cfg = cfg.replace(sliding_window=WINDOW)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    blocks = []
    for blk in jparams["blocks"]:
        if "xgate" in blk:
            n = blk["xgate"].shape[0]
            blk = dict(blk, xgate=0.5 + 0.25 * jnp.arange(
                n, dtype=jnp.float32))
        blocks.append(blk)
    jparams = dict(jparams, blocks=tuple(blocks))
    if kind == "int8":
        jparams = jquant.quantize_params(jcfg, jparams)
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    jstore.load_random("a0", jax.random.PRNGKey(2))
    jstore.load_random("a1", jax.random.PRNGKey(3))
    name = key.replace(".", "_").replace(":", "_")
    _SETUPS[key] = s = dict(
        jcfg=jcfg, jparams=jparams, jbank=jstore.bank, jscale=jstore.scale,
        cfg=cfg, params=to_port_params(jparams, tmp / f"{name}_p.npz"),
        bank=to_port_bank(jstore.bank, tmp / f"{name}_b.npz"),
        scale=t(np.asarray(jstore.scale)), tmp=tmp, name=name)
    return s


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("remat")


def _aux(cfg, B, seed):
    """A cross model's ``[B, F, d]`` sources (None otherwise)."""
    if not (cfg.encoder or cfg.cross_attn_every):
        return None
    F = cfg.encoder.n_frames if cfg.encoder else cfg.n_img_tokens
    return np.random.default_rng(seed).standard_normal(
        (B, F, cfg.d_model)).astype(np.float32)


def _opt(f, x):
    return None if x is None else f(x)


def _ft(cfg, rng, lens=(13, 16, 9), Sf=16):
    """ft rows (adapters 0, 1 and the base), an ignored target each."""
    B = len(lens)
    toks = np.zeros((B, Sf), np.int32)
    mask = np.zeros((B, Sf), bool)
    labels = np.full((B, Sf), -100, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
        mask[i, :n] = True
        labels[i, :n] = toks[i, :n]
        labels[i, 2] = -100
    aux = _aux(cfg, B, seed=11)
    ft = dict(tokens=toks, mask=mask, labels=labels,
              adapter=_i32([0, 1, -1][:B]),
              weight=np.asarray([0.5, 1.0, 0.75][:B], np.float32))
    return (JFT(aux_embed=_opt(j, aux), **{k: j(v) for k, v in ft.items()}),
            FTBatch(aux_embed=_opt(t, aux),
                    **{k: t(v) for k, v in ft.items()}))


def _pf(toks, lens, adapter, tables=None, cached=None):
    kw = dict(tokens=toks, length=_i32(lens), adapter=_i32(adapter))
    if tables is not None:
        kw["block_tables"] = _i32(tables)
    if cached is not None:
        kw["cached_len"] = _i32(cached)
    return (JPF(**{k: j(v) for k, v in kw.items()}),
            PFBatch(**{k: t(v) for k, v in kw.items()}))


def _dec(toks, pos, adapter, tables=None):
    kw = dict(tokens=_i32(toks), pos=_i32(pos), adapter=_i32(adapter))
    if tables is not None:
        kw["block_tables"] = _i32(tables)
    return (JDEC(**{k: j(v) for k, v in kw.items()}),
            DECBatch(**{k: t(v) for k, v in kw.items()}))


def _tree_err(got, want) -> float:
    """The worst leaf's max abs error over that leaf's max abs."""
    return max(W._tree_errs("", got, want).values())


def _close(a, b) -> bool:
    b = np.asarray(b)
    return a is not None and bool(torch.isfinite(a).all()) and \
        max_err(a, b) <= TOL * max(1.0, float(np.abs(b).max()))


def _jax_leaf(cfg, jcache, name):
    """JAX's ``name`` leaves in the port's layout (the layers that carry
    it, in layer order)."""
    P = len(cfg.pattern)
    return np.stack([np.asarray(jcache["layers"][li % P][name][li // P])
                     for li in range(cfg.n_layers)
                     if name in jcache["layers"][li % P]])


def _cache_err(cfg, tcache, jcache) -> float:
    """The worst cache leaf's max abs error over max(1, its max abs)."""
    return max(max_err(v, _jax_leaf(cfg, jcache, k)) / max(1.0, float(
        np.abs(_jax_leaf(cfg, jcache, k)).max())) for k, v in tcache.items())


def _train(s, remat, jb, tb):
    """JAX's and the port's train steps from the same bank and fresh
    moments, ``W.TRAIN_OPT`` with slot 1 masked."""
    jopt = JAdamW(lr=W.TRAIN_OPT["lr"], eps=W.TRAIN_OPT["eps"],
                  grad_clip=W.TRAIN_OPT["grad_clip"])
    jl, jnb, jns, _ = j_train_step(s["jcfg"], jopt, remat=True)(
        s["jparams"], s["jbank"], s["jscale"], j_adamw_init(s["jbank"], 4),
        jb, j(np.asarray(W.TRAIN_SLOTS, np.int32)), None)
    tl, tnb, tns, _ = make_train_step(
        s["cfg"], topt.AdamWConfig(**W.TRAIN_OPT), block_t=BT,
        remat=remat)(s["params"], s["bank"], s["scale"],
                     topt.adamw_init(s["bank"], 4), tb,
                     torch.tensor(W.TRAIN_SLOTS, dtype=torch.int32))
    d = s["tmp"]
    n = s["name"]
    return {"loss": abs(float(tl) - float(jl)) / max(1.0, abs(float(jl))),
            "bank": _tree_err(tnb, to_port_bank(jnb, d / f"{n}_nb.npz")),
            "m": _tree_err(tns.m, to_port_bank(jns.m, d / f"{n}_m.npz")),
            "v": _tree_err(tns.v, to_port_bank(jns.v, d / f"{n}_v.npz"))}


@pytest.mark.parametrize("key", FAMILIES)
def test_remat_steps_match_jax(key, tmp):
    """ft rows alone: the port's remat grad step against JAX's remat grad
    step and against the port's plain grad step; the remat train step's
    loss, new bank and moments against JAX's remat train step."""
    s = _setup(key, tmp)
    jb, tb = _ft(s["cfg"], np.random.default_rng(4))
    jb = JUB(ft=jb)
    tb = UnifiedBatch(ft=tb)
    jres = j_grad_step(s["jcfg"], remat=True)(s["jparams"], s["jbank"],
                                              s["jscale"], jb, None)
    got = {r: make_grad_step(s["cfg"], block_t=BT, remat=r)(
        s["params"], s["bank"], s["scale"], tb, None) for r in (True, False)}
    want = to_port_bank(jres.grads, tmp / f"{s['name']}_g.npz")
    assert abs(float(got[True].loss) - float(jres.loss)) \
        <= LOSS_TOL * max(1.0, abs(float(jres.loss)))
    assert _tree_err(got[True].grads, want) < TOL
    assert _tree_err(got[True].grads, got[False].grads) < TOL
    assert float(got[True].loss) == pytest.approx(float(got[False].loss),
                                                  rel=1e-6)
    assert max(float(g.abs().max()) for g in topt.tree_leaves(
        got[True].grads)) > 0
    errs = _train(s, True, jb, tb)
    assert errs["loss"] < LOSS_TOL and max(
        errs[k] for k in ("bank", "m", "v")) < TOL, errs


def _paged_mixed(s):
    """Two 16-token prompts prefilled cold into blocks (1, 2) and (3, 4)
    on both sides (no gradient); then the mixed tick: the ft rows, a
    5-token suffix of prompt 0 (cached 16, block 5) and a decode of prompt
    1 at position 16 (block 6)."""
    cfg, rng = s["cfg"], np.random.default_rng(6)
    jcache = JM.init_paged_cache(s["jcfg"], NB, BS, 4)
    tcache = TM.init_paged_cache(cfg, NB, BS, CPU, torch.float32)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    jpf, tpf = _pf(toks, [16, 16], [0, 1], tables=[[1, 2, 0, 0],
                                                    [3, 4, 0, 0]])
    jout = JM.unified_forward(s["jcfg"], s["jparams"], JUB(pf=jpf), jcache,
                              loras=s["jbank"], lora_scale=s["jscale"])
    with torch.no_grad():
        TM.unified_forward(cfg, s["params"], UnifiedBatch(pf=tpf), tcache,
                           loras=s["bank"], lora_scale=s["scale"],
                           block_t=BT)
    suf = np.zeros((1, 8), np.int32)
    suf[0, :5] = rng.integers(0, cfg.vocab, 5)
    jpf, tpf = _pf(suf, [5], [1], tables=[[1, 2, 5, 0]], cached=[16])
    jdec, tdec = _dec(rng.integers(0, cfg.vocab, 1), [16], [0],
                      tables=[[3, 4, 6, 0]])
    jft, tft = _ft(cfg, rng)
    return (JUB(ft=jft, pf=jpf, dec=jdec), jout.cache,
            UnifiedBatch(ft=tft, pf=tpf, dec=tdec), tcache)


def _dense_mixed(s):
    """Dense rows: two 24-token prompts prefilled cold into rows 0-1 (no
    gradient); then the mixed tick: the ft rows, a cold 13-token prefill
    into row 2 and a decode of rows 0-1 at position 24 (past a window of
    8: rolling rows)."""
    cfg, rng = s["cfg"], np.random.default_rng(5)
    jcache = JM.init_cache(s["jcfg"], 3, 32)
    tcache = TM.init_cache(cfg, 3, 32, CPU, torch.float32)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jpf, tpf = _pf(toks, [24, 24], [0, 1])
    jout = JM.unified_forward(s["jcfg"], s["jparams"], JUB(pf=jpf), jcache,
                              loras=s["jbank"], lora_scale=s["jscale"])
    with torch.no_grad():
        TM.unified_forward(cfg, s["params"], UnifiedBatch(pf=tpf), tcache,
                           loras=s["bank"], lora_scale=s["scale"],
                           block_t=BT)
    ptoks = np.zeros((1, 16), np.int32)
    ptoks[0, :13] = rng.integers(0, cfg.vocab, 13)
    jpf, tpf = _pf(ptoks, [13], [0])
    nxt = rng.integers(0, cfg.vocab, 2)
    jdec, tdec = _dec(nxt, [24, 24], [1, 0])
    jft, tft = _ft(cfg, rng)
    return (JUB(ft=jft, pf=jpf, dec=jdec), jout.cache,
            UnifiedBatch(ft=tft, pf=tpf, dec=tdec), tcache)


MIXED = {"paged": ("llama3-8b", _paged_mixed),
         "window": ("llama3-8b:w8", _dense_mixed),
         "jamba": ("jamba-1.5-large-398b", _dense_mixed)}


def _mixed_run(case, tmp, remat=True):
    """JAX's remat grad step and the port's (``remat``) on case ``case``'s
    mixed tick, each from its own copy of the same cache."""
    key, make = MIXED[case]
    s = _setup(key, tmp)
    jb, jcache, tb, tcache = make(s)
    jres = j_grad_step(s["jcfg"], remat=True)(s["jparams"], s["jbank"],
                                              s["jscale"], jb, jcache)
    tres = make_grad_step(s["cfg"], block_t=BT, remat=remat)(
        s["params"], s["bank"], s["scale"], tb, tcache)
    return s, jres, tres, tcache


@pytest.mark.parametrize("case", list(MIXED))
def test_remat_mixed_tick_matches_jax(case, tmp):
    """A mixed tick under remat: serving logits and the cache after the
    step equal JAX's remat step's; the grads equal JAX's (llama) and the
    port's plain step's on the same tick (every case)."""
    s, jres, tres, tcache = _mixed_run(case, tmp)
    _, _, plain, pcache = _mixed_run(case, tmp, remat=False)
    assert _close(tres.out.pf_logits, jres.out.pf_logits)
    assert _close(tres.out.dec_logits, jres.out.dec_logits)
    assert _cache_err(s["cfg"], tcache, jres.out.cache) < TOL
    assert all(torch.equal(v, pcache[k]) for k, v in tcache.items())
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= LOSS_TOL * max(1.0, abs(float(jres.loss)))
    assert _tree_err(tres.grads, plain.grads) < TOL
    if s["cfg"].moe is None:
        want = to_port_bank(jres.grads, tmp / f"{case}_mixed_g.npz")
        assert _tree_err(tres.grads, want) < TOL


def test_planted_double_state_write_is_caught(tmp, monkeypatch):
    """The recompute running jamba's Mamba decode step again (the tape
    bypassed) advances the decode rows' state twice: the cache after the
    step leaves JAX's by far more than the tolerance.  The later layers of
    the period then see other serving-row states, and the MoE router
    other entries, so the recompute may also fail ``torch.utils.
    checkpoint``'s own check of the saved tensors' shapes."""
    monkeypatch.setattr(TM._Tape, "once", lambda self, run: run())
    key, make = MIXED["jamba"]
    s = _setup(key, tmp)
    jb, jcache, tb, tcache = make(s)
    jres = j_grad_step(s["jcfg"], remat=True)(s["jparams"], s["jbank"],
                                              s["jscale"], jb, jcache)
    try:
        make_grad_step(s["cfg"], block_t=BT, remat=True)(
            s["params"], s["bank"], s["scale"], tb, tcache)
    except CheckpointError:
        pass
    err = _cache_err(s["cfg"], tcache, jres.out.cache)
    assert err > 10 * TOL, err


def _saved(cfg, params, bank, scale, batch, remat):
    shapes = []

    def pack(x):
        shapes.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        make_grad_step(cfg, block_t=BT, remat=remat)(params, bank, scale,
                                                     batch, None)
    return shapes


@pytest.mark.parametrize("arch,periods", [("llama3-8b", (2, 4)),
                                          ("jamba-1.5-large-398b", (1, 2))])
def test_remat_saves_one_carry_a_period(arch, periods):
    """The tensors autograd keeps for the backward of a remat grad step:
    each period added to the stack adds exactly one, its input carry [T,
    d] (the stream's tokens by the model width); without remat a period
    adds many."""
    got = {}
    for n_periods in periods:
        cfg = get_reduced(arch)
        cfg = cfg.replace(n_layers=n_periods * len(cfg.pattern))
        params = init_params(cfg, device=CPU, dtype=torch.float32, seed=0)
        store = AdapterStore(cfg, LoRAConfig(**LCFG), device=CPU)
        g = torch.Generator().manual_seed(1)
        store.load_random("a0", g)
        _, tb = _ft(cfg, np.random.default_rng(2))
        batch = UnifiedBatch(ft=tb)
        got[n_periods] = {r: _saved(cfg, params, store.bank, store.scale,
                                    batch, r) for r in (True, False)}
    lo, hi = periods
    T = batch.ft.tokens.numel()
    extra = list(got[hi][True])
    for shape in got[lo][True]:
        extra.remove(shape)
    assert extra == [(T, cfg.d_model)] * (hi - lo), extra
    assert len(got[hi][False]) - len(got[lo][False]) > 4 * (hi - lo)


@pytest.mark.parametrize("case", ["paged", "jamba"])
def test_forward_step_remat_changes_nothing(case, tmp):
    """``make_forward_step(remat=True)`` (inference mode) gives the plain
    step's outputs and cache, bit for bit."""
    key, make = MIXED[case]
    s = _setup(key, tmp)
    outs = {}
    for remat in (False, True):
        _, _, tb, tcache = make(s)
        out = make_forward_step(s["cfg"], block_t=BT, remat=remat)(
            s["params"], s["bank"], s["scale"], tb, tcache)
        outs[remat] = (out, tcache)
    (a, ca), (b, cb) = outs[False], outs[True]
    for name in ("ft_loss_sum", "pf_logits", "dec_logits"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert all(torch.equal(v, cb[k]) for k, v in ca.items())
