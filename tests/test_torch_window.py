"""Sliding-window attention in the port against the JAX package, on the CPU
in fp32.

* ``flash_attention_ref(window=W)`` and ``ops.flash_attention(window=W)``
  (on CPU tensors the plain version) against JAX ``L.attention(window=W)``
  and, at W = 0, against the Pallas flash kernel in interpret mode:
  tolerance 3e-5 (``test_torch_dense.py``'s kernel tolerance); padded rows,
  and rows whose window holds no valid key, which are exactly 0.
* The windowed model (reduced configs with ``sliding_window``) against the
  JAX model with JAX weights crossed over through the bridge: the twin of
  ``test_cache_equivalence.py::test_windowed_decode_matches_full_within_window``
  (logits within 1e-4, ``test_torch_dense.py``'s model tolerance), and a
  mixed tick (ft rows longer than the window + a cold prefill + dense
  decode past the window) through ``make_grad_step`` for GQA, MLA, the
  hybrid and the cross-attention family, with and without ``attn_chunk``:
  logits within 1e-4 of max(1, max |JAX|), the loss within 1e-5 relative,
  every bank gradient within 1e-4 of its leaf's max |JAX|.
* The dense engine on a windowed reduced llama3 against the JAX engine's
  greedy tokens (prompts shorter than W decoding past it, bucket-exact
  prompts longer than W, padded prompts whose bucket exceeds W: the JAX
  model's rolling write, mirrored and shown), its warning, and serving
  beside a trainer (tokens, losses and steps).
* ``launch.shapes``: ``SHAPES`` and ``adapt_config`` equal JAX's.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import ARCH_IDS as J_ARCH_IDS, \
    get_config as j_get_config, get_reduced as j_get_reduced
from repro.core.flow import FlowConfig as JFlowConfig
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_make_grad_step
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.data import datasets
from repro.kernels import ops as jops
from repro.launch import shapes as jshapes
from repro.models import layers as JL, model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro.training.trainer import MixedLoraTrainer as JTrainer, \
    TrainerConfig as JTrainerConfig
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.flow import FlowConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_grad_step
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.kernels import ops, ref
from repro_torch.launch import shapes
from repro_torch.models import model as TM
from repro_torch.models.schema import check_supported
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.serving import kvcache as tkv
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig

TOL_KERNEL = 3e-5
TOL_MODEL = 1e-4
LOSS_REL, GRAD_REL = 1e-5, 1e-4
BT = 8
W = 8                       # the JAX package's windowed test's window
CPU = torch.device("cpu")
LCFG = dict(n_slots=4, r=4)
ARCHS = ["llama3-8b", "deepseek-v2-236b", "jamba-1.5-large-398b",
         "llama-3.2-vision-90b"]


def _i32(x):
    return np.asarray(x, np.int32)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- flash
@pytest.mark.parametrize("window", [0, 3, 19, 20, 25])
def test_windowed_flash_matches_jax_attention(window):
    """B = 3 rows of S = T = 20 (lengths 20, 7 and 0; h = 4 over g = 2):
    the plain version, ``ops.flash_attention`` on CPU tensors and the
    chunked form against JAX ``L.attention`` with the same window (W in
    {0, 3, S-1, S, S+5}), and at W = 0 against the Pallas kernel.  Rows
    whose window holds no valid key (the length-0 row; row 1 from position
    7 + W - 1 on) are exactly 0."""
    B, S, h, g, hd = 3, 20, 4, 2, 16
    rng = np.random.default_rng(window)
    q, k, v = (_normal(rng, s) for s in ((B, S, h, hd), (B, S, g, hd),
                                         (B, S, g, hd)))
    lens = _i32([20, 7, 0])
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    want = JL.attention(j(q), j(k), j(v), q_pos=pos, k_pos=pos,
                        k_valid=pos < j(lens)[:, None], causal=True,
                        window=window)
    got = ref.flash_attention_ref(t(q), t(k), t(v), t(lens), True, window)
    assert max_err(got, want) < TOL_KERNEL
    assert torch.equal(ops.flash_attention(t(q), t(k), t(v), t(lens),
                                           causal=True, window=window), got)
    chunked = ref.flash_attention_ref(t(q), t(k), t(v), t(lens), True,
                                      window, chunk=8)
    assert max_err(chunked, got) < TOL_KERNEL
    assert float(got[2].abs().max()) == 0.0
    if window:
        edge = 7 + window - 1        # row 1's first position with no key
        assert float(got[1, edge:].abs().sum()) == 0.0
        assert float(got[1, :edge].abs().amax((-1, -2)).min()) > 0
    else:
        pallas = jops.flash_attention(j(q), j(k), j(v), j(lens), causal=True,
                                      block_q=8, block_k=8, interpret=True)
        assert max_err(got, pallas) < TOL_KERNEL


def test_flash_window_needs_causal():
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(ValueError, match="causal"):
        ops.flash_attention(x, x, x, torch.tensor([4], dtype=torch.int32),
                            causal=False, window=2)


# ------------------------------------------------------------- model
_SETUPS = {}


def _gated(jparams):
    """JAX params with every ``xgate`` opened (0.5 + 0.25 a period), as
    ``test_torch_cross.py`` does: a fresh cross layer adds nothing."""
    blocks = []
    for blk in jparams["blocks"]:
        if "xgate" in blk:
            n = blk["xgate"].shape[0]
            blk = dict(blk, xgate=0.5 + 0.25 * jnp.arange(n,
                                                         dtype=jnp.float32))
        blocks.append(blk)
    return dict(jparams, blocks=tuple(blocks))


def _setup(arch, tmp):
    """Windowed (W = 8) reduced configs on both sides, JAX weights (cross
    gates opened) and two nonzero-B adapters, bridged once per arch."""
    if arch not in _SETUPS:
        jcfg = j_get_reduced(arch).replace(sliding_window=W)
        jparams = _gated(j_init_params(jcfg, jax.random.PRNGKey(0)))
        jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG),
                               jax.random.PRNGKey(1))
        jstore.load_random("a0", jax.random.PRNGKey(2))
        jstore.load_random("a1", jax.random.PRNGKey(3))
        name = arch.replace(".", "_")
        _SETUPS[arch] = dict(
            jcfg=jcfg, jparams=jparams, jbank=jstore.bank,
            jscale=jstore.scale, tmp=tmp,
            cfg=get_reduced(arch).replace(sliding_window=W),
            params=to_port_params(jparams, tmp / f"{name}_p.npz"),
            bank=to_port_bank(jstore.bank, tmp / f"{name}_b.npz"),
            scale=t(np.asarray(jstore.scale)))
    return _SETUPS[arch]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("window")


def _aux(cfg, B, seed):
    """A cross model's ``[B, F, d]`` sources (None otherwise)."""
    if not (cfg.encoder or cfg.cross_attn_every):
        return None
    F = cfg.encoder.n_frames if cfg.encoder else cfg.n_img_tokens
    return _normal(np.random.default_rng(seed), (B, F, cfg.d_model))


def _opt(f, x):
    return None if x is None else f(x)


def _pf(toks, lens, adapter, aux):
    return (JPF(tokens=j(toks), length=j(_i32(lens)), adapter=j(adapter),
                aux_embed=_opt(j, aux)),
            PFBatch(tokens=t(toks), length=t(_i32(lens)), adapter=t(adapter),
                    aux_embed=_opt(t, aux)))


def _dec(toks, pos, adapter):
    return (JDEC(tokens=j(_i32(toks)), pos=j(_i32(pos)), adapter=j(adapter)),
            DECBatch(tokens=t(_i32(toks)), pos=t(_i32(pos)),
                     adapter=t(adapter)))


def _ft(rng, cfg, lens=(13, 21), Sf=24):
    """Two ft rows longer than the window, adapters 0 and 1."""
    B = len(lens)
    toks = np.zeros((B, Sf), np.int32)
    mask = np.zeros((B, Sf), bool)
    labels = np.full((B, Sf), -100, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
        mask[i, :n] = True
        labels[i, :n] = toks[i, :n]
    aux = _aux(cfg, B, seed=11)
    ft = dict(tokens=toks, mask=mask, labels=labels, adapter=_i32([0, 1]),
              weight=np.array([0.5, 1.0], np.float32))
    return (JFT(aux_embed=_opt(j, aux), **{k: j(v) for k, v in ft.items()}),
            FTBatch(aux_embed=_opt(t, aux),
                    **{k: t(v) for k, v in ft.items()}))


def _close(a, b, rel=TOL_MODEL):
    b = np.asarray(b)
    assert a is not None and torch.isfinite(a).all()
    return max_err(a, b) <= rel * max(1.0, float(np.abs(b).max()))


def _jax_leaf(cfg, jcache, name):
    """JAX's ``name`` leaves in the port's layout (the layers that carry
    it, in layer order)."""
    P = len(cfg.pattern)
    return np.stack([np.asarray(jcache["layers"][li % P][name][li // P])
                     for li in range(cfg.n_layers)
                     if name in jcache["layers"][li % P]])


def _same_cache(cfg, tcache, jcache):
    for name, leaf in tcache.items():
        assert _close(leaf, _jax_leaf(cfg, jcache, name)), name


def test_check_supported_takes_windows():
    """Every family's windowed config passes, and ``cache_seq_len`` gives
    the rolling row min(s_max, W)."""
    for arch in ARCH_IDS:
        cfg = get_reduced(arch).replace(sliding_window=W)
        check_supported(cfg)
        assert TM.cache_seq_len(cfg, 32) == W
        assert TM.cache_seq_len(cfg, 4) == 4


def test_windowed_decode_matches_full_within_window(tmp):
    """The twin of ``test_cache_equivalence.py::
    test_windowed_decode_matches_full_within_window`` (reduced llama3, W =
    8, S = 20): path A prefills 20 tokens into a rolling 8-slot row and
    decodes token 20; path B prefills all 21.  Each path's logits and rows
    equal JAX's, and A's decode logits equal B's."""
    s = _setup("llama3-8b", tmp)
    B, S = 1, 20
    toks = np.random.default_rng(2).integers(0, s["cfg"].vocab,
                                             (B, S + 1)).astype(np.int32)
    base = _i32([-1])
    outs = {}
    for path, n in (("A", S), ("B", S + 1)):
        jcache = JM.init_cache(s["jcfg"], B, W)
        tcache = TM.init_cache(s["cfg"], B, W, CPU, torch.float32)
        jb, tb = _pf(toks[:, :n], [n], base, None)
        jout = JM.unified_forward(s["jcfg"], s["jparams"], JUB(pf=jb),
                                  jcache)
        with torch.no_grad():
            tout = TM.unified_forward(s["cfg"], s["params"],
                                      UnifiedBatch(pf=tb), tcache,
                                      block_t=BT)
        assert _close(tout.pf_logits, jout.pf_logits)
        _same_cache(s["cfg"], tcache, jout.cache)
        if path == "A":
            jb, tb = _dec(toks[:, S], [S], base)
            jout = JM.unified_forward(s["jcfg"], s["jparams"], JUB(dec=jb),
                                      jout.cache)
            with torch.no_grad():
                tout = TM.unified_forward(s["cfg"], s["params"],
                                          UnifiedBatch(dec=tb), tcache,
                                          block_t=BT)
            assert _close(tout.dec_logits, jout.dec_logits)
            outs[path] = tout.dec_logits
        else:
            outs[path] = tout.pf_logits
    assert max_err(outs["A"], outs["B"]) < 2e-4


@pytest.mark.parametrize("attn_chunk", [0, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_mixed_tick_matches_jax(arch, attn_chunk, tmp):
    """W = 8: a cold prefill of two 24-token prompts into dense rows 0-1
    (rolling 8-slot rows), then one grad step over a mixed tick: two ft
    rows of 13 and 21 tokens, a cold prefill of a 13-token prompt in a
    16-token bucket at row 2, and dense decode of rows 0-1 at position 24,
    past the window.  Logits, every cache leaf, the loss and every bank
    gradient against ``repro.core.unified.make_grad_step``'s (a cross
    model's buckets carry sources; its gates are open).  With MoE layers
    (deepseek-v2, jamba) the gradients are held on the ft rows alone: the
    router aux loss reads the whole stream, and in a mixed tick JAX's
    gradient of it also flows through the serving rows' LoRA products,
    which carry none in the port (ROADMAP Queue 3, by design)."""
    s = _setup(arch, tmp)
    cfg = s["cfg"]
    rng = np.random.default_rng(5)
    jcache = JM.init_cache(s["jcfg"], 3, 32)
    tcache = TM.init_cache(cfg, 3, 32, CPU, torch.float32)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    jb, tb = _pf(toks, [24, 24], _i32([0, 1]), _aux(cfg, 2, seed=12))
    jout = JM.unified_forward(s["jcfg"], s["jparams"], JUB(pf=jb), jcache,
                              loras=s["jbank"], lora_scale=s["jscale"])
    with torch.no_grad():
        tout = TM.unified_forward(cfg, s["params"], UnifiedBatch(pf=tb),
                                  tcache, loras=s["bank"],
                                  lora_scale=s["scale"], block_t=BT)
    assert _close(tout.pf_logits, jout.pf_logits)
    nxt = np.asarray(jout.pf_logits).argmax(-1)
    ptoks = np.zeros((1, 16), np.int32)
    ptoks[0, :13] = rng.integers(0, cfg.vocab, 13)
    jpf, tpf = _pf(ptoks, [13], _i32([0]), _aux(cfg, 1, seed=13))
    jdec, tdec = _dec(nxt, [24, 24], _i32([1, 0]))
    jft, tft = _ft(rng, cfg)
    jres = j_make_grad_step(s["jcfg"], attn_chunk=attn_chunk)(
        s["jparams"], s["jbank"], s["jscale"],
        JUB(ft=jft, pf=jpf, dec=jdec), jout.cache)
    tres = make_grad_step(cfg, block_t=BT, attn_chunk=attn_chunk)(
        s["params"], s["bank"], s["scale"],
        UnifiedBatch(ft=tft, pf=tpf, dec=tdec), tcache)
    assert _close(tres.out.pf_logits.detach(), jres.out.pf_logits)
    assert _close(tres.out.dec_logits.detach(), jres.out.dec_logits)
    _same_cache(cfg, tcache, jres.out.cache)
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= LOSS_REL * abs(float(jres.loss))
    if cfg.moe is not None:
        jres = j_make_grad_step(s["jcfg"], attn_chunk=attn_chunk)(
            s["jparams"], s["jbank"], s["jscale"], JUB(ft=jft), None)
        tres = make_grad_step(cfg, block_t=BT, attn_chunk=attn_chunk)(
            s["params"], s["bank"], s["scale"], UnifiedBatch(ft=tft), None)
        assert abs(float(tres.loss) - float(jres.loss)) \
            <= LOSS_REL * abs(float(jres.loss))
    want = to_port_bank(jres.grads, tmp / f"g_{arch}_{attn_chunk}.npz")
    moved = 0
    for lg, lw in zip(tres.grads["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lw[name][ab]
                lim = GRAD_REL * max(float(w.abs().max()), 1e-12)
                assert max_err(g, w) <= lim, (name, ab)
                moved += int(float(w.abs().max()) > 0)
    assert moved > 0


def test_windowed_verify_chunk_raises_as_jax(tmp):
    """A verify chunk on rolling rows raises in both packages (rolled-back
    drafts would alias live window slots)."""
    s = _setup("llama3-8b", tmp)
    toks = np.zeros((2, 3), np.int32)
    pos, base = _i32([4, 4]), _i32([-1, -1])
    with pytest.raises(NotImplementedError):
        JM.unified_forward(s["jcfg"], s["jparams"], JUB(dec=JDEC(
            tokens=j(toks), pos=j(pos), adapter=j(base))),
            JM.init_cache(s["jcfg"], 2, 32))
    with pytest.raises(NotImplementedError):
        TM.unified_forward(s["cfg"], s["params"], UnifiedBatch(
            dec=DECBatch(tokens=t(toks), pos=t(pos), adapter=t(base))),
            TM.init_cache(s["cfg"], 2, 32, CPU, torch.float32),
            block_t=BT)


# ------------------------------------------------------------- engine
EW = 32                     # the engine tests' window
S_MAX = 128


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """Reduced llama3 with window 32 on both sides, one ``serve`` adapter
    and two trainer adapters, bridged."""
    tmp = tmp_path_factory.mktemp("window_engine")
    jcfg = j_get_reduced("llama3-8b").replace(sliding_window=EW)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-8b").replace(sliding_window=EW)
    params = to_port_params(jparams, tmp / "params.npz")

    def make(window=EW, buckets=None):
        """Both engines; ``buckets``: the flow's prompt buckets."""
        jc, c = jcfg.replace(sliding_window=window), \
            cfg.replace(sliding_window=window)
        jstore = JAdapterStore(jc, JLoRAConfig(**LCFG),
                               jax.random.PRNGKey(1))
        store = AdapterStore(c, LoRAConfig(**LCFG), device="cpu")
        for name, seed in (("serve", 2), ("tr0", 10)):
            jstore.load_random(name, jax.random.PRNGKey(seed))
            store.load(name, to_port_bank(jstore.get_adapter(name),
                                          tmp / f"{name}.npz"))
        kw = dict(capacity=4, pf_capacity=2, s_max=S_MAX, virtual_time=True)
        tkw, jkw = dict(kw), dict(kw)
        if buckets is not None:
            tkw["flow"] = FlowConfig(seq_buckets=buckets)
            jkw["flow"] = JFlowConfig(seq_buckets=buckets)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            eng = UnifiedEngine(MixedLoraModel(c, params, store),
                                EngineConfig(**tkw))
        jeng = JUnifiedEngine(JMixedLoraModel(jc, jparams, jstore),
                              JEngineConfig(**jkw))
        return jeng, eng

    return cfg, make, params


def _run(jeng, eng, prompts, max_new):
    for i, p in enumerate(prompts):
        for e, cls in ((jeng, JRequest), (eng, Request)):
            e.submit(cls(rid=i, prompt=p, adapter="serve",
                         max_new_tokens=max_new, arrival=0.1 * i))
    jeng.run(max_ticks=5000)
    eng.run(max_ticks=5000)
    assert isinstance(eng.cachemgr, tkv.CacheManager)
    assert eng.cachemgr.pristine
    assert eng.metrics.steps == jeng.metrics.steps
    return ({r.rid: list(r.output) for r in eng.finished},
            {r.rid: list(r.output) for r in jeng.finished})


@pytest.mark.parametrize("kind,lens,max_new", [
    ("shorter_than_window", (9, 20, 31), 24),   # buckets 16 / 32 <= W
    ("bucket_exact_past_window", (64, 64), 8),   # bucket 64 > W, filled
])
def test_windowed_dense_engine_matches_jax(serving, kind, lens, max_new):
    """The dense engine on rolling 32-slot rows emits the JAX dense
    engine's greedy tokens: prompts shorter than W whose decode runs past
    W, and prompts longer than W that fill their bucket."""
    cfg, make, _ = serving
    rng = np.random.default_rng(len(kind))
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    got, want = _run(*make(), prompts, max_new)
    assert got == want and len(got) == len(lens)
    assert all(len(v) == max_new for v in got.values())
    assert max(lens) + max_new > EW


def test_padded_bucket_past_window_takes_jax_rolling_write(serving):
    """Prompts of 40, 48 and 56 tokens pad to the 64-token bucket, longer
    than the 32-slot row: the JAX model keeps the bucket's last 32
    positions, padding included, so decode reads padding as keys.  The
    port emits the JAX engine's tokens there; a flow with buckets of 40,
    48 and 56 (each prompt fills its bucket; the JAX engine agrees) gives
    the same first tokens (from the prefill logits) and other tokens
    after them: the mirrored fault stays visible (ROADMAP Queue 3)."""
    cfg, make, _ = serving
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (40, 48, 56)]
    padded, jpadded = _run(*make(), prompts, 6)
    assert padded == jpadded
    exact, jexact = _run(*make(buckets=(16, 32, 40, 48, 56, 64, 128)),
                         prompts, 6)
    assert exact == jexact
    assert all(padded[i][0] == exact[i][0] for i in padded)
    assert padded != exact


@pytest.mark.parametrize("window,s_max,warns", [(EW, S_MAX, True),
                                                (0, 64, False),
                                                (EW, EW, False)])
def test_dense_warning_compares_the_bucket_with_the_row(serving, window,
                                                        s_max, warns):
    """The dense engine warns when the padded bucket of ``s_max`` is longer
    than the row's real ``cache_seq_len``: a windowed config whose window
    is shorter than s_max warns of the rolling write; W = 0 with a
    bucket-sized s_max, and a window no shorter than s_max, stay
    silent."""
    cfg, _, params = serving
    c = cfg.replace(sliding_window=window)
    store = AdapterStore(c, LoRAConfig(**LCFG), device="cpu")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        UnifiedEngine(MixedLoraModel(c, params, store),
                      EngineConfig(capacity=2, pf_capacity=1, s_max=s_max))
    hits = [w for w in seen if issubclass(w.category, RuntimeWarning)
            and "padded prompt bucket" in str(w.message)]
    assert len(hits) == int(warns)
    if warns:
        assert f"{EW} slots (sliding window {EW})" in str(hits[0].message)
        assert "does not fill that bucket" in str(hits[0].message)


def test_windowed_engine_serves_beside_a_trainer_like_jax(serving):
    """One trainer (ft rows longer than the 16-token window) and four
    served requests decoding past it, on both engines (virtual clock):
    served tokens, steps, optimizer steps and per-row losses (1e-4
    relative) equal."""
    cfg, make, _ = serving
    jeng, eng = make(window=16)
    rows, ev = datasets.split_eval(datasets.alpaca_like(8, vocab=cfg.vocab,
                                                        seed=0))
    assert min(len(toks) for toks, _ in rows) > 16
    kw = dict(rows_per_micro=2, accum_steps=2, epochs=1)
    eng.add_trainer(MixedLoraTrainer("tr0", eng.model.store.slot_of("tr0"),
                                     rows, ev, TrainerConfig(**kw)))
    jeng.add_trainer(JTrainer("tr0", jeng.model.store.slot_of("tr0"), rows,
                              ev, JTrainerConfig(**kw)))
    prompts = datasets.sharegpt_prompts(4, vocab=cfg.vocab, len_lo=6,
                                        len_hi=16)
    got, want = _run(jeng, eng, prompts, 12)
    assert got == want and len(got) == 4
    tr, jtr = eng.trainers["tr0"], jeng.trainers["tr0"]
    assert tr.optimizer_steps == jtr.optimizer_steps >= 1
    for a, b in ((tr.train_losses, jtr.train_losses),
                 (tr.eval_losses, jtr.eval_losses)):
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=1e-4)


# ------------------------------------------------------------- shapes
def test_shapes_match_jax():
    assert list(shapes.SHAPES) == list(jshapes.SHAPES)
    for name, shp in shapes.SHAPES.items():
        assert dataclasses.asdict(shp) == dataclasses.asdict(
            jshapes.SHAPES[name])
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW == 8192
    assert dataclasses.asdict(shapes.DRYRUN_LORA) == dataclasses.asdict(
        jshapes.DRYRUN_LORA)


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_adapt_config_matches_jax(arch):
    """``adapt_config`` gives JAX's config field for field at every shape
    (full and reduced), and ``has_attention`` agrees."""
    assert arch in ARCH_IDS
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        assert shapes.has_attention(mine) == jshapes.has_attention(theirs)
        for name in jshapes.SHAPES:
            a = shapes.adapt_config(mine, shapes.SHAPES[name])
            b = jshapes.adapt_config(theirs, jshapes.SHAPES[name])
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            check_supported(a)
