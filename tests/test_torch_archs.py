"""The port's model registry and its four dense decoders and MoE family vs the
JAX package, in fp32 on the CPU at reduced size (2 layers, d_model 256).

* The registry: every port id's full and reduced config equals the JAX
  package's field by field (the port's rows of ``test_smoke_archs.py``).
* Per arch (``phi3-medium-14b``, ``deepseek-7b`` with 32 KV heads of 32
  heads, ``command-r-35b`` with a tied head, ``qwen1.5-110b`` with QKV
  bias, and ``llama4-maverick-400b-a17b``: one dense and one MoE layer of
  4 experts with a shared expert): JAX weights and two nonzero-B adapters
  crossed over through the bridge; a cold paged prefill beside ft rows,
  then paged decode, then a suffix prefill over an adopted block beside
  decode rows, each step's logits, ft losses and pool blocks compared;
  and a grad step on ft rows (loss and every bank gradient).
* Prefill-then-decode equals one full forward (the port's twin of
  ``test_cache_equivalence.py``) for ``qwen1.5-110b`` and maverick.
* The engine gives JAX's greedy tokens for ``qwen1.5-110b`` (bias),
  ``command-r-35b`` (tied head) and maverick.

Tolerances (fp32 both sides, sums in another order over two layers and a
512-way head): logits and pools within 1e-4 of max(1, max |JAX|), ft
losses within 1e-5 relative, grads within 1e-4 of the leaf's max |JAX|.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import ARCH_IDS as J_ARCH_IDS, \
    get_config as j_get_config, get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_make_grad_step
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_grad_step
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.models import model as TM
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request

NEW = ["phi3-medium-14b", "deepseek-7b", "command-r-35b", "qwen1.5-110b",
       "llama4-maverick-400b-a17b"]
TOL, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-4
BT, BS, NB, NBT = 8, 8, 24, 6
LCFG = dict(n_slots=4, r=4)
CPU = torch.device("cpu")


def test_registry_matches_jax():
    """The port's ids are the JAX registry's eleven, in its order
    (``deepseek-v2-236b``'s MLA is held to JAX in ``test_torch_mla.py``,
    the Mamba2 family in ``test_torch_mamba.py``, the cross-attention
    family in ``test_torch_cross.py``), and each, full and reduced, equals
    the JAX config; ``llama-3.2-vision-90b`` resolves, and an unknown id
    still raises."""
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 11
    assert set(ARCH_IDS) == set(NEW) | {
        "llama3-8b", "deepseek-v2-236b", "mamba2-1.3b",
        "jamba-1.5-large-398b", "llama-3.2-vision-90b", "whisper-base"}
    for arch in ARCH_IDS:
        for mine, theirs in ((get_config(arch), j_get_config(arch)),
                             (get_reduced(arch), j_get_reduced(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert get_config("llama-3.2-vision-90b").cross_attn_every == 5
    with pytest.raises(KeyError):
        get_config("llama-3.2-vision-9b")


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
            jscale=jstore.scale, cfg=get_reduced(arch),
            params=to_port_params(jparams, tmp / f"{name}_params.npz"),
            bank=to_port_bank(jstore.bank, tmp / f"{name}_bank.npz"),
            scale=t(np.asarray(jstore.scale)), tmp=tmp)
    return _SETUPS[arch]


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("archs")


def _i32(x):
    return np.asarray(x, np.int32)


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


def _batches(ft=None, pf=None, dec=None):
    jb, tb = {}, {}
    if ft is not None:
        jb["ft"] = JFT(**{k: j(v) for k, v in ft.items()})
        tb["ft"] = FTBatch(**{k: t(v) for k, v in ft.items()})
    if pf is not None:
        cached = pf.get("cached")
        jb["pf"] = JPF(tokens=j(pf["tokens"]), length=j(pf["length"]),
                       adapter=j(pf["adapter"]),
                       block_tables=j(pf["tables"]),
                       cached_len=None if cached is None else j(cached))
        tb["pf"] = PFBatch(tokens=t(pf["tokens"]), length=t(pf["length"]),
                           adapter=t(pf["adapter"]),
                           block_tables=t(pf["tables"]),
                           cached_len=None if cached is None else t(cached))
    if dec is not None:
        jb["dec"] = JDEC(tokens=j(dec["tokens"]), pos=j(dec["pos"]),
                         adapter=j(dec["adapter"]),
                         block_tables=j(dec["tables"]))
        tb["dec"] = DECBatch(tokens=t(dec["tokens"]), pos=t(dec["pos"]),
                             adapter=t(dec["adapter"]),
                             block_tables=t(dec["tables"]))
    return JUB(**jb), UnifiedBatch(**tb)


def _close(a, b, rel=TOL):
    b = np.asarray(b)
    assert a is not None and torch.isfinite(a).all()
    return max_err(a, b) <= rel * max(1.0, float(np.abs(b).max()))


def _jax_pool(cfg, jcache, kv):
    """The JAX pool (a stack per pattern position) in port layer order
    (layer ``period * P + pos``), ``[L, n_blocks, bs, g, hd]``."""
    per_pos = [np.asarray(c[kv]) for c in jcache["layers"]]
    P = len(per_pos)
    return np.stack([per_pos[li % P][li // P] for li in range(cfg.n_layers)])


def _step(s, state, ft=None, pf=None, dec=None):
    jb, tb = _batches(ft, pf, dec)
    jout = JM.unified_forward(s["jcfg"], s["jparams"], jb, state["j"],
                              loras=s["jbank"], lora_scale=s["jscale"])
    with torch.no_grad():
        tout = TM.unified_forward(s["cfg"], s["params"], tb, state["t"],
                                  loras=s["bank"], lora_scale=s["scale"],
                                  block_t=BT)
    state["j"] = jout.cache
    for name in ("pf_logits", "dec_logits"):
        a, b = getattr(tout, name), getattr(jout, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert _close(a, b), name
    if ft is not None:
        a, b = tout.ft_loss_sum, np.asarray(jout.ft_loss_sum)
        assert max_err(a, b) <= LOSS_REL * float(np.abs(b).max())
        np.testing.assert_array_equal(tout.ft_tok_count.numpy(),
                                      np.asarray(jout.ft_tok_count))
    assert abs(float(tout.aux_loss) - float(jout.aux_loss)) \
        <= LOSS_REL * max(1.0, abs(float(jout.aux_loss)))
    for kv in ("k", "v"):     # block 0 is the null block: garbage by design
        want = _jax_pool(s["cfg"], jout.cache, kv)[:, 1:]
        assert _close(tout.cache[kv][:, 1:], want), kv
    return tout, jout


@pytest.mark.parametrize("arch", NEW)
def test_unified_forward_matches_jax(arch, tmp):
    """Cold paged prefill beside ft rows, paged decode with an inactive
    row, then a suffix prefill over an adopted block beside decode."""
    s = _setup(arch, tmp)
    cfg = s["cfg"]
    rng = np.random.default_rng(0)
    V = cfg.vocab
    state = {"j": JM.init_paged_cache(s["jcfg"], NB, BS, 4),
             "t": TM.init_paged_cache(cfg, NB, BS, CPU, torch.float32)}
    p0, p1 = rng.integers(0, V, 13), rng.integers(0, V, 20)
    toks = np.zeros((2, 24), np.int32)
    toks[0, :13], toks[1, :20] = p0, p1
    out, jout = _step(s, state, ft=_ft_rows(rng, V), pf=dict(
        tokens=toks, length=_i32([13, 20]), adapter=_i32([0, 1]),
        tables=np.stack([_table(1, 2), _table(3, 4, 5)])))
    if cfg.moe is not None:
        assert float(out.aux_loss) > 0
    nxt = out.pf_logits.argmax(-1).numpy()
    dec = dict(tokens=_i32([nxt[0], nxt[1], 0]), pos=_i32([13, 20, 0]),
               adapter=_i32([0, 1, -1]),
               tables=np.stack([_table(1, 2), _table(3, 4, 5), _table()]))
    out, _ = _step(s, state, dec=dec)
    nxt = out.dec_logits.argmax(-1).numpy()
    p2 = np.concatenate([p0[:8], rng.integers(0, V, 9)])
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1, :11] = p2[8:], rng.integers(0, V, 11)
    dec = dict(tokens=_i32([nxt[0], nxt[1], 0]), pos=_i32([14, 21, 0]),
               adapter=_i32([0, 1, -1]),
               tables=np.stack([_table(1, 2), _table(3, 4, 5), _table()]))
    _step(s, state, pf=dict(
        tokens=toks, length=_i32([9, 11]), adapter=_i32([0, 1]),
        cached=_i32([8, 0]),
        tables=np.stack([_table(1, 6, 7), _table(8, 9)])), dec=dec)


def _assert_grads_close(got, want):
    for lg, lw in zip(got["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lw[name][ab]
                assert g.shape == w.shape
                lim = GRAD_REL * max(float(w.abs().max()), 1e-12)
                assert max_err(g, w) <= lim, (name, ab)


@pytest.mark.parametrize("arch", NEW)
def test_grad_step_matches_jax(arch, tmp):
    """The ft bucket's grad step against ``repro.core.unified``'s: loss
    (the router aux loss included for maverick) and every bank leaf."""
    s = _setup(arch, tmp)
    ft = _ft_rows(np.random.default_rng(1), s["cfg"].vocab)
    jb, tb = _batches(ft)
    jres = j_make_grad_step(s["jcfg"])(s["jparams"], s["jbank"],
                                       s["jscale"], jb, None)
    tres = make_grad_step(s["cfg"], block_t=BT)(s["params"], s["bank"],
                                                s["scale"], tb, None)
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= LOSS_REL * abs(float(jres.loss))
    want = to_port_bank(jres.grads, tmp / f"g_{arch.replace('.', '_')}.npz")
    _assert_grads_close(tres.grads, want)
    if s["cfg"].moe is not None:
        moe_layer = tres.grads["layers"][1]
        assert "shared_wg" in moe_layer and "wg" not in moe_layer
        assert float(moe_layer["shared_wg"]["b"].abs().max()) > 0


@pytest.mark.parametrize("arch", ["qwen1.5-110b",
                                  "llama4-maverick-400b-a17b"])
def test_prefill_then_decode_matches_full(arch, tmp):
    """The port's twin of ``test_cache_equivalence.py`` on dense rows:
    prefill 10 tokens, decode 3 one at a time, against one prefill of all
    13 (rtol/atol 2e-4, that test's tolerance)."""
    s = _setup(arch, tmp)
    cfg, params = s["cfg"], s["params"]
    rng = np.random.default_rng(1)
    B, S, extra = 2, 10, 3
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + extra))
                            .astype(np.int32))
    base = torch.full((B,), -1, dtype=torch.int32)

    def fwd(batch, cache):
        with torch.no_grad():
            return TM.unified_forward(cfg, params, batch, cache, block_t=BT)

    cache = TM.init_cache(cfg, B, 32, CPU, torch.float32)
    out = fwd(UnifiedBatch(pf=PFBatch(
        tokens=toks[:, :S], length=torch.full((B,), S, dtype=torch.int32),
        adapter=base)), cache)
    for i in range(extra):
        out = fwd(UnifiedBatch(dec=DECBatch(
            tokens=toks[:, S + i], pos=torch.full((B,), S + i,
                                                  dtype=torch.int32),
            adapter=base)), out.cache)
    ref = fwd(UnifiedBatch(pf=PFBatch(
        tokens=toks, length=torch.full((B,), S + extra, dtype=torch.int32),
        adapter=base)), TM.init_cache(cfg, B, 32, CPU, torch.float32))
    np.testing.assert_allclose(out.dec_logits.numpy(),
                               ref.pf_logits.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "command-r-35b",
                                  "llama4-maverick-400b-a17b"])
def test_engine_matches_jax(arch, tmp):
    """Both engines on one virtual-clock trace over the same weights and
    adapters (a shared 32-token head, so later prompts adopt its blocks):
    identical greedy tokens and steps, pools drain pristine."""
    s = _setup(arch, tmp)
    jcfg, cfg = s["jcfg"], s["cfg"]
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    store = AdapterStore(cfg, LoRAConfig(**LCFG), device="cpu")
    for i, name in enumerate(("a0", "a1")):
        jstore.load_random(name, jax.random.PRNGKey(2 + i))
        store.load(name, to_port_bank(
            jstore.get_adapter(name),
            tmp / f"e_{arch.replace('.', '_')}_{name}.npz"))
    kw = dict(capacity=4, pf_capacity=2, s_max=96, virtual_time=True)
    jeng = JUnifiedEngine(JMixedLoraModel(jcfg, s["jparams"], jstore),
                          JEngineConfig(**kw))
    eng = UnifiedEngine(MixedLoraModel(cfg, s["params"], store),
                        EngineConfig(**kw))
    rng = np.random.default_rng(7)
    head = rng.integers(0, cfg.vocab, 32).astype(np.int32)
    for i in range(6):
        prompt = np.concatenate(
            [head, rng.integers(0, cfg.vocab, 3 + 4 * i).astype(np.int32)])
        arrival = 0.0 if i < 2 else 0.3 + 0.1 * i
        for e, R in ((jeng, JRequest), (eng, Request)):
            e.submit(R(rid=i, prompt=prompt, adapter=f"a{i % 2}",
                       max_new_tokens=5, arrival=arrival))
    jeng.run(max_ticks=10000)
    eng.run(max_ticks=10000)
    out = {r.rid: list(r.output) for r in eng.finished}
    assert len(out) == 6
    assert out == {r.rid: list(r.output) for r in jeng.finished}
    assert eng.metrics.steps == jeng.metrics.steps
    assert eng.metrics.reused_prefix_tokens > 0
    assert eng.cachemgr.pristine and jeng.cachemgr.pristine
