"""The port's unified adapter paging and void/unvoid migration against the
JAX package, on the reduced llama3 (2 layers, d_model 256) on the CPU.
Adapters are made in JAX and cross over through the bridge; traces are
made from numpy seeds and handed to both packages.

* the byte image: a bank slot -> ``_flatten`` -> pool -> ``adapter_gather``
  -> bank round trip is bit-exact at true ranks 1-8 in fp32 and bf16, with
  the columns beyond the rank zero, and its byte count (and so the block
  count) is the JAX package's;
* shed order: pinned adapters are never shed under KV pressure, redundant
  copies go first, a trained (dirty) adapter is written back before its
  pool copy is shed;
* the engine (virtual clock, fp32): the same requests with paging off and
  on give the same tokens, equal to the JAX engine's, with the JAX
  engine's swap-ins, resident hits, adapter blocks and steps;
* ``VirtualModel.void`` / ``unvoid`` against JAX's, and
  ``MigrationInvariantError`` on a config mismatch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel, VirtualModel as JVirtualModel
from repro.models.schema import init_params as j_init_params
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.kvcache import PagedCacheManager as JPagedCacheManager
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel, \
    VirtualModel, VoidedModel
from repro_torch.errors import MigrationInvariantError
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.kvcache import PagedCacheManager
from repro_torch.serving.request import Request

CFG = get_reduced("llama3-8b")
JCFG = j_get_reduced("llama3-8b")
CPU = torch.device("cpu")
RANKS = [1, 2, 4]


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """JAX params and six rank-8 JAX adapters, and the port's copies."""
    tmp = tmp_path_factory.mktemp("paging")
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    src = JAdapterStore(JCFG, JLoRAConfig(n_slots=6, r=8),
                        jax.random.PRNGKey(1))
    jads, ads = {}, {}
    for i in range(6):
        name = f"ad{i}"
        src.load_random(name, jax.random.PRNGKey(10 + i))
        jads[name] = jax.tree_util.tree_map(np.asarray,
                                            src.get_adapter(name))
        ads[name] = to_port_bank(src.get_adapter(name), tmp / f"{name}.npz")
    return jparams, jads, to_port_params(jparams, tmp / "p.npz"), ads


def _mgr(n_blocks=32, bs=16, capacity=4, s_max=64):
    return PagedCacheManager(CFG, capacity, 2, s_max, device=CPU,
                             dtype=torch.float32, block_size=bs,
                             n_blocks=n_blocks)


def _leaves(store, slot):
    return [ab[k][slot].clone() for layer in store.bank["layers"]
            for ab in layer.values() for k in ("a", "b")]


# ------------------------------------------------------------ byte image
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_true_rank_round_trip_bit_exact(bridged, dtype):
    """slot -> byte image -> pool blocks -> gather -> another slot gives
    the slot back bit for bit at every true rank, columns beyond the rank
    zero; the image's byte count is the JAX package's."""
    ads = bridged[3]
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=8),
                           jax.random.PRNGKey(1))
    for rank in (1, 3, 4, 8):
        store = AdapterStore(CFG, LoRAConfig(n_slots=4, r=8), device="cpu",
                             dtype=dtype)
        store.load("x", ads["ad0"], rank=rank)
        m = _mgr(n_blocks=64)
        store.attach_pager(m)
        image = store._flatten(store.slot_of("x"), rank)
        # the JAX store is fp32: scale its count to this dtype
        assert image.numel() == store.adapter_nbytes("x") \
            == jstore.adapter_nbytes(rank=rank) * store._itemsize // 4
        got = m.adapter_gather("x")
        assert torch.equal(got, image)
        store._write_image(1, got, rank)
        for src, dst in zip(_leaves(store, store.slot_of("x")),
                            _leaves(store, 1)):
            assert torch.equal(src, dst)
        for layer in store.bank["layers"]:
            for ab in layer.values():
                assert not ab["a"][1][:, rank:].any()
                assert not ab["b"][1][rank:].any()


def test_block_counts_by_rank_match_jax(bridged):
    """Heterogeneous true ranks cost proportionally many pool blocks: the
    same tables as the JAX pager's."""
    jparams, jads, _, ads = bridged
    pairs = [("ad0", 2), ("ad1", 4), ("ad2", 8)]
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=8),
                           jax.random.PRNGKey(1))
    store = AdapterStore(CFG, LoRAConfig(n_slots=4, r=8), device="cpu")
    for name, rk in pairs:
        jstore.load(name, jads[name], rank=rk)
        store.load(name, ads[name], rank=rk)
    jm = JPagedCacheManager(JCFG, 4, 2, 64, block_size=16, n_blocks=64)
    m = _mgr(n_blocks=64)
    jstore.attach_pager(jm)
    store.attach_pager(m)
    assert m.adapter_tables == jm.adapter_tables
    for name, _ in pairs:
        assert store.adapter_nbytes(name) == jstore.adapter_nbytes(name)
    assert store.adapter_nbytes("ad1") == 2 * store.adapter_nbytes("ad0")
    assert m.adapter_blocks_resident == jm.adapter_blocks_resident
    assert m.reclaimable_adapter_blocks == m.adapter_blocks_resident


# ------------------------------------------------------------ shed order
def test_pinned_adapter_never_shed_under_kv_pressure():
    m = _mgr(n_blocks=12)
    pay = torch.arange(3 * m.adapter_block_bytes).to(torch.uint8)
    assert m.adapter_admit("pinned", pay)
    assert m.adapter_admit("cold", pay[:m.adapter_block_bytes])
    m.adapter_pin("pinned")
    admitted = 0
    while m.try_admit(np.zeros((16,), np.int32), max_new=48,
                      adapter=str(admitted)) is not None:
        admitted += 1
    assert admitted >= 1
    assert m.adapter_resident("pinned") and not m.adapter_resident("cold")
    assert torch.equal(m.adapter_gather("pinned"), pay)


def test_redundant_pool_copies_shed_first():
    m = _mgr()
    pay = torch.arange(m.adapter_block_bytes).to(torch.uint8)
    m.adapter_admit("older", pay)
    m.adapter_admit("newer", pay)
    m.adapter_redundant_fn = lambda n: n == "newer"
    assert m._shed_adapter(frozenset())
    assert m.adapter_resident("older") and not m.adapter_resident("newer")


def test_trained_adapter_syncs_before_shed(bridged, tmp_path):
    """A training write into the bank slot (in place), ``mark_dirty``,
    then a pool shed and a bank unload: the next ``acquire`` swaps the
    trained weights back in, as the JAX store does."""
    jparams, jads, _, ads = bridged
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=2, r=4),
                           jax.random.PRNGKey(1))
    store = AdapterStore(CFG, LoRAConfig(n_slots=2, r=4), device="cpu")
    jad4 = jax.tree_util.tree_map(lambda x: x[..., :4] if x.shape[-1] == 8
                                  else x[..., :4, :], jads["ad0"])
    jstore.load("tr", jad4)
    store.load("tr", {"layers": [{t: {"a": ab["a"][:, :4],
                                      "b": ab["b"][:4]}
                                  for t, ab in layer.items()}
                                 for layer in ads["ad0"]["layers"]]})
    jm = JPagedCacheManager(JCFG, 4, 2, 64, block_size=16, n_blocks=32)
    m = _mgr()
    jstore.attach_pager(jm)
    store.attach_pager(m)
    slot = store.slot_of("tr")
    jslot = jstore.slot_of("tr")
    jstore.bank = jax.tree_util.tree_map(
        lambda x: x.at[..., jslot, :, :].add(1.0), jstore.bank)
    with torch.no_grad():
        for layer in store.bank["layers"]:
            for ab in layer.values():
                ab["a"][slot] += 1.0
                ab["b"][slot] += 1.0
    trained = _leaves(store, slot)
    for s_, m_ in ((jstore, jm), (store, m)):
        s_.mark_dirty("tr")
        while m_.adapter_resident("tr"):
            assert m_._shed_adapter(frozenset())
        s_.unload("tr")
        s_.acquire("tr")
    for a, b in zip(trained, _leaves(store, store.slot_of("tr"))):
        assert torch.equal(a, b)
    jback = to_port_bank(jstore.get_adapter("tr"), tmp_path / "tr.npz")
    for layer, jl in zip(store.bank["layers"], jback["layers"]):
        for t in layer:
            s = store.slot_of("tr")
            assert torch.equal(layer[t]["a"][s], jl[t]["a"])
            assert torch.equal(layer[t]["b"][s], jl[t]["b"])


# ------------------------------------------------------------ the engine
def _engines(bridged, paging, n_adapters=6, n_slots=3, **kw):
    jparams, jads, params, ads = bridged
    kw = dict(capacity=4, pf_capacity=2, s_max=64, virtual_time=True,
              block_size=16, adapter_paging=paging,
              **{"n_blocks": 48, **kw})
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=n_slots, r=4),
                           jax.random.PRNGKey(1))
    store = AdapterStore(CFG, LoRAConfig(n_slots=n_slots, r=4),
                         device="cpu")
    jeng = JUnifiedEngine(JMixedLoraModel(JCFG, jparams, jstore),
                          JEngineConfig(**kw))
    eng = UnifiedEngine(MixedLoraModel(CFG, params, store),
                        EngineConfig(**kw))
    for i in range(n_adapters):
        name, rk = f"ad{i}", RANKS[i % 3]
        jad = jax.tree_util.tree_map(
            lambda x: x[..., :4] if x.shape[-1] == 8 else x[..., :4, :],
            jads[name])
        jstore.load(name, jad, rank=rk, evict=True)
        store.load(name, {"layers": [
            {t: {"a": ab["a"][:, :4], "b": ab["b"][:4]}
             for t, ab in layer.items()}
            for layer in ads[name]["layers"]]}, rank=rk, evict=True)
    return jeng, eng


def _submit(jeng, eng, n=12, n_adapters=6, plen=8, max_new=6, seed=7):
    rng = np.random.default_rng(seed)
    for i in range(n):
        p = rng.integers(0, CFG.vocab, plen).astype(np.int32)
        for e, R in ((jeng, JRequest), (eng, Request)):
            e.submit(R(rid=i, prompt=p, adapter=f"ad{i % n_adapters}",
                       max_new_tokens=max_new, arrival=0.02 * i))


FIELDS = ("steps", "adapter_swap_ins", "adapter_swap_in_bytes",
          "adapter_resident_hits", "adapter_peak_coresident",
          "adapter_blocks_resident", "decode_tokens", "prefill_tokens")


def test_e2e_tokens_equal_paging_on_off_and_jax(bridged):
    """Paging changes where adapter bytes live and when requests run, never
    what they compute: tokens equal with paging off and on, and equal to
    the JAX engine's in both arms, with the JAX engine's swap-ins, resident
    hits, adapter blocks and steps; no pin leaks; pools drain pristine."""
    outs = {}
    for paging in (False, True):
        jeng, eng = _engines(bridged, paging)
        _submit(jeng, eng)
        jeng.run(max_ticks=4000)
        eng.run(max_ticks=4000)
        out = {r.rid: list(r.output) for r in eng.finished}
        assert len(out) == 12 and all(r.state.name == "DONE"
                                      for r in eng.finished)
        assert out == {r.rid: list(r.output) for r in jeng.finished}
        for f in FIELDS:
            assert getattr(eng.metrics, f) == getattr(jeng.metrics, f), f
        assert eng.model.store.swap_ins == jeng.model.store.swap_ins
        cm = eng.cachemgr
        assert all(v == 0 for v in cm._adapter_pins.values())
        assert cm.pristine and jeng.cachemgr.pristine
        if paging:
            assert cm.adapter_tables == jeng.cachemgr.adapter_tables
            assert eng.metrics.adapter_blocks_resident > 0
            assert eng.metrics.adapter_resident_hits > 0
        outs[paging] = out
    assert outs[False] == outs[True]


def test_swap_ins_and_preemption_under_paging_match_jax(bridged):
    """A cold adapter is swapped in once for a co-batch of three requests;
    then lending preemption over a paged adapter keeps the victim's
    adapter resident (no swap-in).  Swap-ins, preemptions and tokens equal
    the JAX engine's."""
    rng = np.random.default_rng(3)
    for kw, max_new, cold, want_swaps in (
            (dict(n_adapters=3, n_slots=2), 4, True, 1),
            (dict(n_adapters=2, n_slots=2, n_blocks=8, over_admit=2.0), 40,
             False, 0)):
        jeng, eng = _engines(bridged, True, **kw)
        for e in (jeng, eng) if cold else ():
            store = e.model.store
            if "ad0" in store._slots:
                store.unload("ad0")
            while e.cachemgr.adapter_resident("ad0"):
                assert e.cachemgr._shed_adapter(frozenset())
            assert not store.is_resident("ad0")
        base = (jeng.model.store.swap_ins, eng.model.store.swap_ins)
        for i in range(3):
            p = rng.integers(0, CFG.vocab, 8).astype(np.int32)
            for e, R in ((jeng, JRequest), (eng, Request)):
                e.submit(R(rid=i, prompt=p, adapter="ad0",
                           max_new_tokens=max_new,
                           arrival=0.0 if cold else 0.1 * i))
        jeng.run(max_ticks=5000)
        eng.run(max_ticks=5000)
        assert eng.model.store.swap_ins - base[1] \
            == jeng.model.store.swap_ins - base[0] == want_swaps
        assert eng.metrics.preemptions == jeng.metrics.preemptions
        assert (eng.metrics.preemptions >= 1) == (not cold)
        assert {r.rid: r.output for r in eng.finished} \
            == {r.rid: r.output for r in jeng.finished}
        assert len(eng.finished) == 3 and eng.cachemgr.pristine
        assert all(not r.adapter_retained for r in eng.finished)


# ------------------------------------------------------------- migration
def test_void_unvoid_matches_jax(bridged):
    """``void`` detaches the adapter to host (as JAX's does, same values);
    ``unvoid`` binds it into a fresh store on the given device, where it
    equals the JAX store's unvoided slot; a config mismatch raises."""
    jparams, jads, params, ads = bridged
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=8),
                           jax.random.PRNGKey(1))
    jstore.load("ad1", jads["ad1"], scale=0.5)
    store = AdapterStore(CFG, LoRAConfig(n_slots=4, r=8), device="cpu")
    store.load("ad1", ads["ad1"], scale=0.5)
    jv = JMixedLoraModel(JCFG, jparams, jstore).virtual("ad1").void()
    v = MixedLoraModel(CFG, params, store).virtual("ad1").void()
    assert (v.name, v.cfg_name, v.scale) == (jv.name, jv.cfg_name, jv.scale)
    for layer in v.adapter["layers"]:
        for ab in layer.values():
            assert ab["a"].device.type == "cpu"
    jfresh = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=8),
                           jax.random.PRNGKey(2))
    fresh = AdapterStore(CFG, LoRAConfig(n_slots=4, r=8), device="cpu")
    jvm = JVirtualModel.unvoid(jv, jparams, jfresh)
    vm = VirtualModel.unvoid(v, params, fresh, "cpu", mode="train")
    assert (vm.name, vm.mode, vm.slot) == ("ad1", "train", jvm.slot)
    assert float(fresh.scale[vm.slot]) == 0.5
    for a, b in zip(_leaves(store, store.slot_of("ad1")),
                    _leaves(fresh, vm.slot)):
        assert torch.equal(a, b)
    jback = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(np.asarray, jfresh.get_adapter("ad1")))
    assert sum(x.size for x in jback) == sum(
        x.numel() for x in _leaves(fresh, vm.slot))
    bad = dataclasses.replace(v, cfg_name="other-model")
    with pytest.raises(MigrationInvariantError):
        VirtualModel.unvoid(bad, params, AdapterStore(
            CFG, LoRAConfig(n_slots=4, r=8), device="cpu"), "cpu")
    assert isinstance(v, VoidedModel)


def test_paging_at_the_smokes_adapter_to_block_ratio_matches_jax(tmp_path):
    """Phase 10's trace of ``chip_smoke.py`` (24 requests of 64 + 32 tokens
    over 12 adapters, weights 1/(i+1), 3 waves, a 4-slot bank, a 65-block
    pool) at the reduced size with true ranks 10 and 5, which take 10 and 5
    blocks as full-width ranks 8 and 4 do there: the port's adapter
    swap-ins, pool admits and sheds equal the JAX engine's with paging off
    and on, and with paging on the pool sheds adapters that later requests
    swap back in (more swap-ins than the static bank's)."""
    from repro.serving.request import State as JState
    from repro_torch.serving.request import State as TState
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    params = to_port_params(jparams, tmp_path / "p.npz")
    rng = np.random.default_rng(3)
    w = 1.0 / np.arange(1, 13)
    pick = rng.choice(12, size=24, p=w / w.sum())
    trace = [(i, rng.integers(0, CFG.vocab, 64).astype(np.int32),
              f"pg{pick[i]}") for i in range(24)]
    got = {}
    for paging in (False, True):
        kw = dict(capacity=8, pf_capacity=4, s_max=512, n_blocks=65,
                  virtual_time=True, adapter_paging=paging)
        jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=10),
                               jax.random.PRNGKey(1))
        store = AdapterStore(CFG, LoRAConfig(n_slots=4, r=10), device="cpu")
        for i in range(12):
            jstore.load_random(f"pg{i}", jax.random.PRNGKey(300 + i),
                               evict=True, rank=(10, 5)[i % 2])
            g = torch.Generator()
            g.manual_seed(300 + i)
            store.load_random(f"pg{i}", g, evict=True, rank=(10, 5)[i % 2])
        engs = (JUnifiedEngine(JMixedLoraModel(JCFG, jparams, jstore),
                               JEngineConfig(**kw)),
                UnifiedEngine(MixedLoraModel(CFG, params, store),
                              EngineConfig(**kw)))
        for e, R, S in zip(engs, (JRequest, Request), (JState, TState)):
            for k in range(0, 24, 8):
                rs = [R(rid=i, prompt=p, adapter=a, max_new_tokens=32,
                        arrival=e.clock.now()) for i, p, a in trace[k:k + 8]]
                for r in rs:
                    e.submit(r)
                while k < 16 and not all(r.state in (S.DECODE, S.DONE)
                                         for r in rs):
                    e.tick()
            e.run(max_ticks=100000)
        counts = [(e.metrics.adapter_swap_ins, e.cachemgr.adapter_swap_ins,
                   e.cachemgr.adapter_sheds, e.metrics.steps,
                   len(e.finished)) for e in engs]
        assert counts[0] == counts[1]
        got[paging] = counts[1]
    assert got[True][0] > got[False][0] and got[True][2] > 0
