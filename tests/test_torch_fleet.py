"""The port's in-process fleet against the JAX package's, on the reduced
llama3 (2 layers, d_model 256) in fp32 on the CPU, with the virtual clock.
Weights and adapters are made in JAX and cross over through the bridge;
traces and payloads are made from numpy seeds and handed to both packages.
Each test is a twin of one in ``tests/test_fleet.py``:

* the fleet index mirrors publication and retraction (plain, under
  truncate / copy-on-write churn, under swap-out / rehydrate) exactly as
  the JAX index does;
* ``import_block`` copies the payload (the JAX copy's bytes) and refuses a
  committed pool, and the cross-pool copy refuses unlike pools;
* the router picks the JAX router's engine under every policy, with the
  same scores;
* the fetch-vs-recompute rule and its clock charge;
* three replicas emit one engine's tokens and the JAX fleet's tokens,
  ``routed`` and ``remote_fetch_blocks``, also under preemption churn;
* the 2-replica block-conservation property, each operation applied to the
  JAX and the port managers with their state compared;
* ``replicate_model`` shares the base and gives each replica adapter copies
  that own their storage;
* the serve CLI with ``--replicas 3 --finetune --attn-tune-file``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyputil import given, hyp as _hyp, settings, st
from _torch_bridge import to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.fleet import FleetConfig as JFleetConfig, \
    FleetIndex as JFleetIndex, Router as JRouter, \
    RouterConfig as JRouterConfig, build_fleet as j_build_fleet
from repro.models.schema import init_params as j_init_params
from repro.serving import kvcache as JK
from repro.serving.clock import CostModel as JCostModel, \
    VirtualClock as JVirtualClock
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.fleet import FleetConfig, FleetIndex, Router, \
    RouterConfig, build_fleet, replicate_model
from repro_torch.kernels import autotune
from repro_torch.launch import serve
from repro_torch.serving import kvcache as TK
from repro_torch.serving.clock import CostModel, VirtualClock
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.kvcache import PagedCacheManager, \
    request_chain_keys
from repro_torch.serving.request import Request

CFG = get_reduced("llama3-8b")
JCFG = j_get_reduced("llama3-8b")
CPU = torch.device("cpu")
# prefill-bound regime (the JAX tests' and bench's): a block's recompute
# costs 16 tokens x 1e-4 s, a remote copy fixed 1e-3 + 1e-4 per block, so
# fetching wins from the second block on
FETCH = dict(fixed=1e-3, prefill_per_tok=1e-4)


# --------------------------------------------------------------- managers
def _mgrs(capacity=4, n_blocks=16, s_max=64, bs=8, **kw):
    """(JAX manager, port manager) of one geometry."""
    jm = JK.PagedCacheManager(JCFG, capacity, 2, s_max, block_size=bs,
                              n_blocks=n_blocks, **kw)
    tm = TK.PagedCacheManager(CFG, capacity, 2, s_max, device=CPU,
                              dtype=torch.float32, block_size=bs,
                              n_blocks=n_blocks, **kw)
    return jm, tm


def _publish(m, prompt, adapter="", max_new=4):
    """Admit + commit + free: leaves the prompt's full blocks index-only."""
    s, _ = m.try_admit(np.asarray(prompt, np.int32), max_new=max_new,
                       adapter=adapter)
    m.commit_prefill([(0, s)], [m._seq_len[s]])
    m.free(s)


def _scribble(jm, tm, bids, seed=0):
    """The same random K/V in ``bids`` of both pools."""
    rng = np.random.default_rng(seed)
    shape = (tm.cache["k"].shape[0], len(bids)) \
        + tuple(tm.cache["k"].shape[2:])
    pay = {k: rng.standard_normal(shape).astype(np.float32)
           for k in ("k", "v")}
    jm.cache = JK._blocks_write(jm.cache, jnp.asarray(bids, jnp.int32),
                                ({k: jnp.asarray(v) for k, v in pay.items()},))
    for k, v in pay.items():
        tm.cache[k][:, torch.tensor(bids)] = torch.from_numpy(v)


def _block(jm, tm, jbid, tbid):
    """One block's K and V from each pool, in numpy."""
    return ({k: np.asarray(jm.cache["layers"][0][k][:, jbid])
             for k in ("k", "v")},
            {k: tm.cache[k][:, tbid].numpy() for k in ("k", "v")})


def _same_index(jfi, tfi, jms, tms):
    """Both fleet indexes hold the same entries and both are exact."""
    assert jfi._where == tfi._where
    assert (len(jfi), jfi.entries) == (len(tfi), tfi.entries)
    for jm, tm in zip(jms, tms):
        assert list(jm._index.items()) == list(tm._index.items())
    jfi.check_bijection()
    tfi.check_bijection()


def _indexed(n=2, **kw):
    """n (JAX, port) manager pairs, each side's attached to its own index."""
    pairs = [_mgrs(**kw) for _ in range(n)]
    jfi, tfi = JFleetIndex(), FleetIndex()
    for i, (jm, tm) in enumerate(pairs):
        jfi.attach(i, jm)
        tfi.attach(i, tm)
    return jfi, tfi, [p[0] for p in pairs], [p[1] for p in pairs]


# ---------------------------------------------------------------- FleetIndex
def test_fleet_index_mirrors_publish_and_retract():
    jfi, tfi, (ja, jb), (ta, tb) = _indexed()
    p = np.arange(20, dtype=np.int32)          # 2 full blocks at bs=8
    for a in (ja, ta):
        _publish(a, p)
    keys = ta.chain_keys(p)
    assert keys == ja.chain_keys(p)
    assert len(tfi) == 2 and tfi.entries == 2
    for k in keys:
        assert tfi.locate(k) == jfi.locate(k) == (0, ta._index[k])
    assert tfi.resident_run(keys) == jfi.resident_run(keys) == 2
    _same_index(jfi, tfi, [ja, jb], [ta, tb])
    for b in (jb, tb):                         # replicated on both
        _publish(b, p)
    assert len(tfi) == 2 and tfi.entries == 4
    assert tfi.holders(keys[0]) == jfi.holders(keys[0]) \
        == [(0, ta._index[keys[0]]), (1, tb._index[keys[0]])]
    assert tfi.locate(keys[0], prefer=1) == jfi.locate(keys[0], prefer=1) \
        == (1, tb._index[keys[0]])
    _same_index(jfi, tfi, [ja, jb], [ta, tb])
    for a in (ja, ta):                         # retraction via _depublish
        a.flush_index()
    assert tfi.entries == 2
    assert all(tfi.locate(k)[0] == 1 for k in keys)
    _same_index(jfi, tfi, [ja, jb], [ta, tb])
    for b in (jb, tb):
        b.flush_index()
    assert len(tfi) == 0 and tfi.entries == 0
    _same_index(jfi, tfi, [ja, jb], [ta, tb])


def test_fleet_index_attach_ingests_and_guards():
    ja, ta = _mgrs()
    p = np.arange(17, dtype=np.int32)
    _publish(ja, p)
    _publish(ta, p)
    jfi, tfi = JFleetIndex(), FleetIndex()
    jfi.attach(0, ja)                          # attach after warm-up ingests
    tfi.attach(0, ta)
    assert len(tfi) == len(jfi) == 2
    _same_index(jfi, tfi, [ja], [ta])
    with pytest.raises(ValueError):
        tfi.attach(0, _mgrs()[1])              # engine id taken
    with pytest.raises(ValueError):
        FleetIndex().attach(1, ta)             # manager already subscribed


def test_fleet_index_stale_free_under_truncate_and_cow_churn():
    """Decode commits publish, truncate rolls back, copy-on-write rewrites
    shared blocks: through all of it both fleet views match their local
    indexes and each other."""
    jfi, tfi, jms, tms = _indexed(n=1, n_blocks=12)
    rng = np.random.default_rng(3)
    lives = ([], [])
    for i in range(8):
        prompt = rng.integers(0, 3, 9 + i).astype(np.int32)
        got = [m.try_admit(prompt, max_new=16) for m in (jms[0], tms[0])]
        assert (got[0] is None) == (got[1] is None)
        if got[0] is None:
            continue
        for m, g, live in zip((jms[0], tms[0]), got, lives):
            live.append(g[0])
            m.commit_prefill([(0, g[0])], [m._seq_len[g[0]]])
        _same_index(jfi, tfi, jms, tms)
    assert lives[0] == lives[1]
    for s in lives[1]:
        toks = None
        for m in (jms[0], tms[0]):
            cap = m.grow(s, int(m.lens[s]) + 6)
            n = min(cap, int(m.lens[s]) + 6) - m._seq_len[s]
            if toks is None:
                toks = rng.integers(0, 3, max(n, 0))
            if n > 0:
                m.commit_tokens(s, toks)
        _same_index(jfi, tfi, jms, tms)
        for m in (jms[0], tms[0]):
            m.truncate(s, max(int(m.lens[s]) - 3, 0))
        _same_index(jfi, tfi, jms, tms)
    for s in lives[1]:
        jms[0].free(s)
        tms[0].free(s)
    _same_index(jfi, tfi, jms, tms)
    assert tms[0].pristine and jms[0].pristine
    assert len(tfi) == len(tms[0]._index)


def test_fleet_index_tracks_swap_out_and_rehydrate():
    """Swap-out de-publishes a victim's blocks (retract), the restore's
    commit re-publishes, shedding demotes to host (retract) and the
    admission's rehydration re-announces: the same steps on both sides."""
    jfi, tfi, jms, tms = _indexed(n=1, n_blocks=16, host_blocks=8)
    jm, tm = jms[0], tms[0]
    p = np.arange(20, dtype=np.int32)              # 2 full blocks at bs=8
    keys = tm.chain_keys(p)
    s = [m.try_admit(p, max_new=4)[0] for m in (jm, tm)]
    for m, slot in zip((jm, tm), s):
        m.commit_prefill([(0, slot)], [20])
    assert tfi.entries == 2
    sid = [m.swap_out(slot) for m, slot in zip((jm, tm), s)]
    assert sid[0] == sid[1] is not None
    assert tfi.entries == 0                         # retracted
    _same_index(jfi, tfi, jms, tms)
    for m, slot in zip((jm, tm), s):
        m.free(slot)
    for m in (jm, tm):
        s2, reused = m.try_admit(p, max_new=4)
        assert reused == 0
        m.restore_swap(s2, sid[1])
        m.commit_prefill([(0, s2)], [20])           # re-publish on commit
        m.free(s2)
    assert tfi.entries == 2
    assert all(tfi.locate(k) == (0, tm._index[k]) for k in keys)
    _same_index(jfi, tfi, jms, tms)
    for m in (jm, tm):
        while m._shed_any():                        # demote both to host
            pass
    assert tfi.entries == 0 and tm.host_pool.n_demoted == 2
    _same_index(jfi, tfi, jms, tms)
    for m in (jm, tm):
        s3, reused = m.try_admit(p, max_new=4)      # rehydration
        assert reused == 16
        m.free(s3)
    assert tfi.entries == 2
    assert all(tfi.locate(k) == (0, tm._index[k]) for k in keys)
    _same_index(jfi, tfi, jms, tms)
    for m in (jm, tm):
        assert m.pristine
        m.flush_index()
        m.flush_host()
    assert len(tfi) == 0 and tfi.entries == 0


# -------------------------------------------------------------- import_block
def test_import_block_copies_payload_and_adopts():
    (ja, ta), (jb, tb) = _mgrs(), _mgrs()
    p = np.arange(20, dtype=np.int32)
    _publish(ja, p)
    _publish(ta, p)
    keys = ta.chain_keys(p)
    bids = [ta._index[k] for k in keys]
    assert bids == [ja._index[k] for k in keys]
    _scribble(ja, ta, bids, seed=5)
    for k in keys:
        jbid = jb.import_block(k, ja, ja._index[k])
        bid = tb.import_block(k, ta, ta._index[k])
        assert bid == jbid is not None
        # the copy is the published payload, every layer, and the JAX
        # copy's bytes
        jgot, got = _block(jb, tb, bid, bid)
        _, src = _block(ja, ta, ta._index[k], ta._index[k])
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name], src[name])
            np.testing.assert_array_equal(got[name], jgot[name])
        assert int(tb.allocator.ref[bid]) == 1           # index-only cache
        assert tb._index[k] == bid and tb._hashed[bid] == k
    assert tb.remote_imports == jb.remote_imports == 2
    # a second import of a resident key returns the local block
    assert tb.import_block(keys[0], ta, ta._index[keys[0]]) \
        == tb._index[keys[0]]
    assert tb.remote_imports == 2
    # admission adopts the imported run like a local publication
    for m in (jb, tb):
        s, reused = m.try_admit(p, max_new=4)
        assert reused == 16 and m.hash_hits == 2
        m.free(s)
        assert m.pristine
    # a pool of another dtype is refused, never converted in silence
    other = TK.PagedCacheManager(CFG, 4, 2, 64, device=CPU,
                                 dtype=torch.bfloat16, block_size=8,
                                 n_blocks=16)
    with pytest.raises(ValueError):
        other._copy_block_from(ta, bids[0], 1)


def test_import_block_refuses_when_pool_is_committed():
    (jb, tb), (ja, ta) = _mgrs(n_blocks=4), _mgrs()   # b: 3 usable blocks
    p = np.arange(20, dtype=np.int32)
    _publish(ja, p)
    _publish(ta, p)
    key = ta.chain_keys(p)[0]
    for b, a in ((jb, ja), (tb, ta)):
        # 16 prompt tokens + 8 new = 3 projected blocks: 2 in the table, 1
        # of reservation debt -> free_blocks == 0, nothing sheddable
        s, _ = b.try_admit(np.arange(16, dtype=np.int32), max_new=8)
        assert b.free_blocks <= 0 and b.reclaimable_blocks == 0
        assert b.import_block(key, a, a._index[key]) is None
        b.free(s)
        # with room back the same import succeeds
        assert b.import_block(key, a, a._index[key]) is not None
    assert tb._index == jb._index and tb.remote_imports == jb.remote_imports


# ---------------------------------------------------------------- engines
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX base params and the port's copy, and three JAX adapters (drawn
    as ``test_fleet.py``'s ``_model`` draws them) with the port's copies."""
    tmp = tmp_path_factory.mktemp("fleet")
    jparams = j_init_params(JCFG, jax.random.PRNGKey(0))
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    jads, ads = [], []
    for i in range(3):
        jstore.load_random(f"x{i}", jax.random.PRNGKey(2 + i))
        jads.append(jstore.get_adapter(f"x{i}"))
        ads.append(to_port_bank(jads[-1], tmp / f"ad{i}.npz"))
    return jparams, to_port_params(jparams, tmp / "params.npz"), jads, ads


def _models(world, adapters=("serve",)):
    """(JAX model, port model) over the shared bases with ``adapters``
    loaded in order (the i-th gets adapter i's weights, as ``_model``
    draws them)."""
    jparams, params, jads, ads = world
    jstore = JAdapterStore(JCFG, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    store = AdapterStore(CFG, LoRAConfig(n_slots=4, r=4), device="cpu")
    for i, name in enumerate(adapters):
        jstore.load(name, jads[i])
        store.load(name, ads[i])
    return (JMixedLoraModel(JCFG, jparams, jstore),
            MixedLoraModel(CFG, params, store))


def _ecfgs(cost=None, **kw):
    kw = {"capacity": 4, "pf_capacity": 2, "s_max": 96, "block_size": 16,
          "virtual_time": True, **kw}
    return (JEngineConfig(cost=None if cost is None else JCostModel(**cost),
                          **kw),
            EngineConfig(cost=None if cost is None else CostModel(**cost),
                         **kw))


def _req(rid, prompt, adapter="serve", max_new=6, arrival=0.0):
    return [R(rid=rid, prompt=np.asarray(prompt, np.int32), adapter=adapter,
              max_new_tokens=max_new, arrival=arrival)
            for R in (JRequest, Request)]


def _trace(n=6, max_new=6, seed=0, head_len=48):
    """``test_fleet.py``'s trace: (JAX requests, port requests)."""
    head = np.arange(head_len, dtype=np.int32) % CFG.vocab
    rng = np.random.default_rng(seed)
    reqs = [_req(i, np.concatenate([head, rng.integers(
                 0, CFG.vocab, rng.integers(4, 12)).astype(np.int32)]),
                 arrival=0.05 * i, max_new=max_new) for i in range(n)]
    return [r[0] for r in reqs], [r[1] for r in reqs]


def _outputs(finished):
    return {r.rid: list(r.output) for r in finished}


def _replica_engines(world, n, **kw):
    jm, tm = _models(world)
    jecfg, ecfg = _ecfgs(**kw)
    from repro.fleet import replicate_model as j_replicate_model
    return ([JUnifiedEngine(m, jecfg) for m in j_replicate_model(jm, n)],
            [UnifiedEngine(m, ecfg) for m in replicate_model(tm, n)])


# ------------------------------------------------------------------- routing
def test_router_round_robin_and_least_loaded(world):
    jengs, engs = _replica_engines(world, 3)
    rr = (JRouter(jengs, JRouterConfig(policy="round-robin")),
          Router(engs, RouterConfig(policy="round-robin")))
    got = [[r.route(q) for r, q in zip(rr, _req(i, np.arange(8)))]
           for i in range(5)]
    assert [g[1] for g in got] == [g[0] for g in got] == [0, 1, 2, 0, 1]
    ll = (JRouter(jengs, JRouterConfig(policy="least-loaded")),
          Router(engs, RouterConfig(policy="least-loaded")))
    for es, side in ((jengs, 0), (engs, 1)):
        es[0].waiting.append(_req(90, np.arange(8))[side])
        es[1].waiting.append(_req(91, np.arange(8))[side])
    q = _req(92, np.arange(8))
    assert ll[1].route(q[1]) == ll[0].route(q[0]) == 2
    with pytest.raises(ValueError):
        RouterConfig(policy="fastest")


def test_router_affinity_prefers_residency_but_not_forever(world):
    jengs, engs = _replica_engines(world, 2)
    p = np.arange(48, dtype=np.int32)
    _publish(jengs[1].cachemgr, p, adapter="serve")
    _publish(engs[1].cachemgr, p, adapter="serve")
    q = _req(0, p)
    af = (JRouter(jengs, JRouterConfig(policy="affinity")),
          Router(engs, RouterConfig(policy="affinity")))
    np.testing.assert_allclose(af[1].scores(q[1]), af[0].scores(q[0]),
                               rtol=0, atol=1e-6)
    assert af[1].route(q[1]) == af[0].route(q[0]) == 1
    # the load penalty is unbounded: a deep enough backlog on the resident
    # replica flips the argmax
    c = af[1].cfg
    depth = int((1.0 + c.adapter_bonus) / c.load_penalty) + 1
    for es, side in ((jengs, 0), (engs, 1)):
        es[1].waiting.extend(_req(100 + i, np.arange(8))[side]
                             for i in range(depth))
    np.testing.assert_allclose(af[1].scores(q[1]), af[0].scores(q[0]),
                               rtol=0, atol=1e-6)
    assert af[1].route(q[1]) == af[0].route(q[0]) == 0


def test_router_affinity_adapter_residency_bonus(world):
    (jha, tha), (jco, tco) = (_models(world, ("hot",)),
                              _models(world, ("cold",)))
    jecfg, ecfg = _ecfgs()
    jaf = JRouter([JUnifiedEngine(jha, jecfg), JUnifiedEngine(jco, jecfg)],
                  JRouterConfig(policy="affinity"))
    af = Router([UnifiedEngine(tha, ecfg), UnifiedEngine(tco, ecfg)],
                RouterConfig(policy="affinity"))
    for rid, name, want in ((0, "hot", 0), (1, "cold", 1)):
        jq, q = _req(rid, np.arange(8), adapter=name)
        np.testing.assert_allclose(af.scores(q), jaf.scores(jq), rtol=0,
                                   atol=1e-6)
        assert af.route(q) == jaf.route(jq) == want


# --------------------------------------------------- fetch-vs-recompute rule
def test_fetch_rule_weighs_launch_overhead_against_prefill(world):
    jm, tm = _models(world)
    jecfg, ecfg = _ecfgs()
    fleets = (j_build_fleet(jm, jecfg, JFleetConfig(replicas=2)),
              build_fleet(tm, ecfg, FleetConfig(replicas=2)))
    p = np.arange(48, dtype=np.int32)          # 3 full blocks at bs=16
    q = _req(0, p)
    for f in fleets:
        _publish(f.engines[0].cachemgr, p, adapter="serve")
    # the admission chain covers 2 of the 3 published blocks (one prompt
    # token stays computable)
    assert len(request_chain_keys(q[1], 16)) == 2
    # default cost model: fixed 35 ms dwarfs 2 blocks' prefill: recompute
    assert [f._fetch_prefix(1, r) for f, r in zip(fleets, q)] == [0, 0]
    assert fleets[1].engines[1].cachemgr.remote_imports == 0
    # prefill-bound: the same 2 blocks are worth one transfer
    fleets[0].engines[1].clock = JVirtualClock(JCostModel(**FETCH))
    fleets[1].engines[1].clock = VirtualClock(CostModel(**FETCH))
    t0 = fleets[1].engines[1].clock.now()
    assert [f._fetch_prefix(1, r) for f, r in zip(fleets, q)] == [2, 2]
    cold = fleets[1].engines[1]
    assert cold.cachemgr.remote_imports == 2
    assert cold.metrics.remote_fetch_time > 0
    assert cold.clock.now() == pytest.approx(
        t0 + FETCH["fixed"] + 2 * CostModel().remote_per_block)
    assert cold.clock.now() == fleets[0].engines[1].clock.now()
    assert cold.metrics.remote_fetch_time \
        == fleets[0].engines[1].metrics.remote_fetch_time
    # idempotent: everything is local now
    assert [f._fetch_prefix(1, r) for f, r in zip(fleets, q)] == [0, 0]
    fleets[1].index.check_bijection()
    assert fleets[1].index._where == fleets[0].index._where


# ------------------------------------------------------- end to end
def _fleet_runs(world, policy, trace, **kw):
    """The port's single engine and 3-replica fleet and the JAX fleet on
    ``trace``: (single tokens, fleet, fleet metrics, JAX fleet, JAX
    metrics)."""
    jm, tm = _models(world)
    jecfg, ecfg = _ecfgs(cost=FETCH, **kw)
    ref = UnifiedEngine(tm, ecfg)
    for r in trace()[1]:
        ref.submit(r)
    ref.run(max_ticks=8000)
    jm, tm = _models(world)
    jf = j_build_fleet(jm, jecfg, JFleetConfig(
        replicas=3, router=JRouterConfig(policy=policy)))
    tf = build_fleet(tm, ecfg, FleetConfig(
        replicas=3, router=RouterConfig(policy=policy)))
    jr, tr = trace()
    for f, rs in ((jf, jr), (tf, tr)):
        for r in rs:
            f.submit(r)
    jfm, fm = jf.run(), tf.run()
    return _outputs(ref.finished), tf, fm, jf, jfm


def _same_fleet(tf, fm, jf, jfm):
    got = _outputs(r for e in tf.engines for r in e.finished)
    assert got == _outputs(r for e in jf.engines for r in e.finished)
    assert tf.routed == jf.routed
    for f in ("remote_fetch_blocks", "hash_hits", "steps", "decode_tokens",
              "prefill_tokens", "reused_prefix_tokens", "preemptions"):
        assert getattr(fm, f) == getattr(jfm, f), f
    assert fm.elapsed == pytest.approx(jfm.elapsed, rel=1e-12)
    assert tf.index._where == jf.index._where
    tf.index.check_bijection()
    assert all(e.cachemgr.pristine for e in tf.engines)
    assert fm.elapsed == pytest.approx(max(e.clock.now()
                                           for e in tf.engines))
    return got


@pytest.mark.parametrize("policy", ["affinity", "round-robin"])
def test_fleet_of_three_byte_identical_to_single_engine(world, policy):
    """N=3 replicas behind either router emit one engine's tokens and the
    JAX fleet's, with its placement and fetch counts: remote fetch copies
    published K/V, replicas share the base and carry equal adapters."""
    ref, tf, fm, jf, jfm = _fleet_runs(world, policy, _trace)
    assert len(ref) == 6
    assert _same_fleet(tf, fm, jf, jfm) == ref
    if policy == "round-robin":
        # spreading a shared-prefix trace forces cross-replica fetches
        assert sum(tf.routed.values()) == 6
        assert min(tf.routed.values()) >= 1
        assert fm.remote_fetch_blocks > 0 and fm.remote_fetch_time > 0
    assert len(tf.all_requests) == 6


def test_fleet_exact_under_preemption_churn(world):
    """Lending preemption inside replicas leaks nothing into the fleet
    index and changes no token."""
    ref, tf, fm, jf, jfm = _fleet_runs(
        world, "round-robin",
        lambda: _trace(n=4, max_new=24, head_len=16),
        n_blocks=12, over_admit=2.0)
    assert len(ref) == 4
    assert _same_fleet(tf, fm, jf, jfm) == ref


# ------------------------------------------- fleet conservation (hypothesis)
def _check_conservation(m: PagedCacheManager, over_admit: float):
    """The port copy of ``test_preempt.py``'s checker: refcounts are the
    table + index + adapter-table holds, the free list mirrors them, the
    index is a bijection naming only live blocks, the debt is exact."""
    a = m.allocator
    held: dict = {}
    for t in m.tables.values():
        for b in t:
            held[b] = held.get(b, 0) + 1
    for b in m._hashed:
        held[b] = held.get(b, 0) + 1
    for t in m.adapter_tables.values():
        for b in t:
            held[b] = held.get(b, 0) + 1
    free = set(a._free)
    assert len(free) == len(a._free), "free list holds duplicates"
    for bid in range(1, a.n_blocks):
        assert int(a.ref[bid]) == held.get(bid, 0), \
            f"refcount drift on block {bid}"
        assert (int(a.ref[bid]) == 0) == (bid in free), \
            f"free-list drift on block {bid}"
    assert a.n_used == sum(1 for bid in range(1, a.n_blocks)
                           if held.get(bid, 0) > 0)
    assert len(m._index) == len(m._hashed)
    for key, bid in m._index.items():
        assert m._hashed.get(bid) == key, "index/inverse drift"
        assert int(a.ref[bid]) >= 1 and bid not in free, \
            f"stale index entry for block {bid}"
    for slot, chain in m._chains.items():
        assert len(chain) <= len(m.tables[slot]), "chain outran its table"
    assert m.reserved_debt == sum(m._debt_of(s) for s in m.tables)
    assert m.reserved_debt >= 0
    if over_admit <= 1.0:
        assert a.n_free >= m.reserved_debt, "conservative invariant broken"
    assert len(m.tables) + len(m._free_slots) == m.capacity, "slot leak"
    assert sum(m._class_debt) == m.reserved_debt, "class-debt drift"
    assert all(d >= 0 for d in m._class_debt)
    assert 0 <= m.charged_debt <= m.reserved_debt


def _fleet_op(ms, who, live, pins, op, toks, prompt, pay, jax_side):
    """One operation of ``test_fleet.py``'s op mix on one side's pair of
    managers, with its data drawn beforehand."""
    kind, pick, amount = op
    m = ms[who]
    if kind == 0:                                     # admit (+ adopt)
        got = m.try_admit(prompt, max_new=amount % 48)
        if got is not None:
            live.append(got[0])
    elif kind == 1 and live:                          # decode advance
        slot = live[pick % len(live)]
        cap = m.grow(slot, int(m.lens[slot]) + 1 + amount % 24)
        n = min(cap, int(m.lens[slot]) + 1 + amount % 24) - m._seq_len[slot]
        if n > 0:
            m.commit_tokens(slot, toks[:n])
    elif kind == 2 and live:                          # truncate (spec)
        slot = live[pick % len(live)]
        m.truncate(slot, max(int(m.lens[slot]) - amount % 16, 0))
    elif kind == 3 and live:                          # preempt / finish
        m.free(live.pop(pick % len(live)))
    elif kind == 4 and live:                          # commit the prompt
        slot = live[pick % len(live)]
        n = min(m._seq_len[slot], len(m.tables[slot]) * m.block_size)
        m.commit_prefill([(0, slot)], [n])
    elif kind == 5 and live:                          # grow to capacity
        slot = live[pick % len(live)]
        m.grow(slot, m.reserved.get(slot, 1) * m.block_size)
    elif kind == 6:                                   # remote import
        src = ms[1 - who]
        if src._index:
            key = sorted(src._index)[pick % len(src._index)]
            m.import_block(key, src, src._index[key])
    elif kind == 7:                                   # adapter admit
        name = f"A{pick % 3}"
        if name not in m.adapter_tables:
            m.adapter_admit(name, pay if jax_side
                            else torch.from_numpy(pay))
    elif kind == 8:                                   # pin / unpin cycle
        name = f"A{pick % 3}"
        if pins.get(name, 0) and amount % 2:
            m.adapter_unpin(name)
            pins[name] -= 1
        else:
            m.adapter_pin(name)
            pins[name] = pins.get(name, 0) + 1


@_hyp(lambda: [settings(max_examples=15, deadline=None),
               given(ops=st.lists(st.tuples(st.integers(0, 1),
                                            st.integers(0, 8),
                                            st.integers(0, 7),
                                            st.integers(0, 80)),
                                  min_size=1, max_size=50),
                     over_admit=st.sampled_from([1.0, 1.75]))])
def test_fleet_block_conservation_property(ops, over_admit):
    """``test_fleet.py``'s 2-replica property with cross-pool imports and
    adapter paging in the op mix, each operation applied to the JAX and
    the port managers: after every operation each port manager conserves
    its blocks, both fleet indexes are bijections and equal, refcounts and
    counters equal the JAX ones, pinned adapters are never shed; a full
    drain leaves every pool pristine and flush reclaims everything."""
    kw = dict(capacity=4, n_blocks=13, s_max=96, bs=8,
              over_admit=over_admit)
    jfi, tfi, jms, tms = _indexed(**kw)
    sides = {"jax": (jms, [[], []], [{}, {}]),
             "port": (tms, [[], []], [{}, {}])}
    rng = np.random.default_rng(0)
    for who, kind, pick, amount in ops:
        prompt = rng.integers(0, 3, 1 + amount % 40).astype(np.int32)
        toks = rng.integers(0, 3, 24)
        nb = 1 + (amount * 211) % (2 * tms[0].adapter_block_bytes - 1)
        pay = rng.integers(0, 256, nb).astype(np.uint8)
        pinned = {n for n, c in sides["port"][2][who].items()
                  if c > 0 and n in tms[who].adapter_tables}
        for name, (ms, lives, pins) in sides.items():
            _fleet_op(ms, who, lives[who], pins[who], (kind, pick, amount),
                      toks, prompt, pay, name == "jax")
        assert pinned <= set(tms[who].adapter_tables), \
            "a pinned adapter was shed"
        assert sides["jax"][1] == sides["port"][1]
        for jm, tm in zip(jms, tms):
            _check_conservation(tm, over_admit)
            assert np.array_equal(np.asarray(jm.allocator.ref),
                                  tm.allocator.ref)
            assert jm.tables == tm.tables
            assert jm.adapter_tables == tm.adapter_tables
            assert jm.remote_imports == tm.remote_imports
        _same_index(jfi, tfi, jms, tms)
    for name, (ms, lives, pins) in sides.items():       # full fleet drain
        for who, m in enumerate(ms):
            for slot in lives[who]:
                m.free(slot)
            for aname, c in list(pins[who].items()):
                for _ in range(c):
                    m.adapter_unpin(aname)
            assert m.pristine
    for tm in tms:
        _check_conservation(tm, over_admit)
    _same_index(jfi, tfi, jms, tms)
    assert tfi.entries == sum(len(m._index) for m in tms)
    for m in jms + tms:
        m.flush_adapters()
        m.flush_index()
        assert m.allocator.n_free == m.allocator.usable
        assert not m.adapter_tables and not m._adapter_pins
    assert len(tfi) == 0 and tfi.entries == 0
    assert len(jfi) == 0


# ------------------------------------------------------------- replication
def test_replicate_model_shares_base_and_clones_adapters(world):
    jm, tm = _models(world, ("a", "b"))
    tm.store.load(
        "c", tm.store.get_adapter("a"), scale=0.5, rank=2)
    from repro.fleet import replicate_model as j_replicate_model
    jm.store.load("c", jm.store.get_adapter("a"), scale=0.5, rank=2)
    tm.store._evict_lru()                     # "a" voided to host
    jm.store._evict_lru()
    reps, jreps = replicate_model(tm, 3), j_replicate_model(jm, 3)
    assert reps[0] is tm
    for rep, jrep in zip(reps[1:], jreps[1:]):
        assert rep.base is tm.base            # no second copy of the base
        assert rep.store is not tm.store
        assert rep.store.device == tm.store.device
        assert rep.store.dtype == tm.store.dtype
        assert rep.store.resident == jrep.store.resident
        assert sorted(rep.store.resident + rep.store.voided) \
            == ["a", "b", "c"]
        for name in ("b", "c"):
            got, want = rep.store.get_adapter(name), tm.store.get_adapter(name)
            for lg, lw in zip(got["layers"], want["layers"]):
                for t in lg:
                    for ab in ("a", "b"):
                        assert torch.equal(lg[t][ab], lw[t][ab])
            assert float(rep.store.scale[rep.store.slot_of(name)]) \
                == float(tm.store.scale[tm.store.slot_of(name)]) \
                == float(jrep.store.scale[jrep.store.slot_of(name)])
            assert rep.store.slot_of(name) == jrep.store.slot_of(name)
        # every adapter, the voided one too, with its true rank
        assert rep.store._ranks == tm.store._ranks == jrep.store._ranks
        # each store owns its bank: training one replica leaves the others
        for la, lb in zip(rep.store.bank["layers"], tm.store.bank["layers"]):
            for t in la:
                assert la[t]["a"].data_ptr() != lb[t]["a"].data_ptr()
    with torch.no_grad():
        for layer in reps[1].store.bank["layers"]:
            for ab in layer.values():
                ab["a"].add_(1.0)
    for layer, other in zip(tm.store.bank["layers"],
                            reps[2].store.bank["layers"]):
        for t in layer:
            slot = tm.store.slot_of("b")
            assert torch.equal(layer[t]["a"][slot],
                               other[t]["a"][reps[2].store.slot_of("b")])


# ------------------------------------------------------------------ the CLI
def test_serve_cli_fleet_with_finetune(capsys, tmp_path):
    table = tmp_path / "splits.json"
    table.write_text('{"lanes": 132, "entries": {"128,32,128,16": [32, 4]}}')
    try:
        serve.main(["--reduced", "--device", "cpu", "--replicas", "3",
                    "--router", "round-robin", "--finetune", "--requests",
                    "12", "--rps", "8", "--attn-tune-file", str(table)])
        assert autotune.get_config((128, 32, 128, 16)) \
            == autotune.AttnConfig(block_k=32, num_splits=4)
    finally:
        autotune.clear_table()
    out = capsys.readouterr().out
    assert f"attn autotune: loaded 1 entries from {table}" in out
    lines = {ln.split(":")[0]: ln for ln in out.splitlines() if ":" in ln}
    assert "finished=12 " in out
    for field in ("replicas=3", "router=round-robin", "routed=",
                  "remote_fetch_blocks=", "remote_fetch_time=",
                  "fleet_index_keys="):
        assert field in lines["fleet"], field
    for field in ("tokens=", "opt_steps="):
        assert field in lines["finetune"], field
    assert int(lines["finetune"].split("tokens=")[1].split()[0]) > 0
