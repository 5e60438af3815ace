"""The port's lending, preemption and host KV tier against the JAX package,
on the reduced llama3 (2 layers, d_model 256) in fp32 on the CPU, with the
virtual clock.  Weights and the adapter are made in JAX and cross over
through the bridge; traces and payloads are made from numpy seeds and
handed to both packages.

* manager level: lending arithmetic (``charged_debt``, the class-debt
  lending order, short growth), the host pool's pinned/LRU rules, swap
  round trips (bit-exact; the restore skips adopted blocks), demote ->
  rehydrate, the int8 payload against ``repro.models.quant.quantize_leaf``,
  and a block-conservation replay per (over_admit, host_blocks) pair of
  ``tests/test_preempt.py``'s property test, the same seeded operations on
  both managers with their state compared after every operation;
* engine level: forced and double preemption, the suffix drafter across a
  preemption, and swap preemption against recompute: tokens, steps,
  preemptions, ``swap_decisions`` and the ``kv_*`` counters equal to the
  JAX engine's (tokens exactly; both sides are fp32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.models.quant import quantize_leaf as j_quantize_leaf
from repro.models.schema import init_params as j_init_params
from repro.serving import kvcache as JK
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro.spec import SpecConfig as JSpecConfig
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.errors import ConfigInvariantError
from repro_torch.models.quant import dequant_leaf, quantize_leaf
from repro_torch.serving import kvcache as TK
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request, State
from repro_torch.spec import SpecConfig

CPU = torch.device("cpu")
KV_FIELDS = ("kv_swap_outs", "kv_swap_out_bytes", "kv_restores",
             "kv_restore_bytes", "kv_swap_drops", "kv_demotions",
             "kv_demote_bytes", "kv_rehydrations", "kv_rehydrate_bytes")
METRIC_FIELDS = ("steps", "preemptions", "preempted_tokens_recomputed",
                 "lent_blocks_peak", "kv_swap_outs", "kv_restores",
                 "kv_restored_tokens", "kv_swap_skips", "kv_demotions",
                 "kv_rehydrated_blocks", "host_bytes_peak", "hash_hits",
                 "reused_prefix_tokens", "decode_tokens")


# --------------------------------------------------------------- managers
def _mgrs(capacity=4, n_blocks=12, s_max=64, bs=8, **kw):
    """(JAX manager, port manager) of one geometry."""
    jm = JK.PagedCacheManager(j_get_reduced("llama3-8b"), capacity, 2, s_max,
                              block_size=bs, n_blocks=n_blocks, **kw)
    tm = TK.PagedCacheManager(get_reduced("llama3-8b"), capacity, 2, s_max,
                              device=CPU, dtype=torch.float32,
                              block_size=bs, n_blocks=n_blocks, **kw)
    return jm, tm


def _scribble(jm, tm, bids, seed=0):
    """The same non-zero K/V in ``bids`` of both pools; returns it
    ``{"k": [L, n, bs, g, hd], "v": ...}`` in numpy."""
    rng = np.random.default_rng(seed)
    shape = (tm.cache["k"].shape[0], len(bids)) + tuple(tm.cache["k"].shape[2:])
    pay = {k: rng.standard_normal(shape).astype(np.float32)
           for k in ("k", "v")}
    jm.cache = JK._blocks_write(jm.cache, jnp.asarray(bids, jnp.int32),
                                ({k: jnp.asarray(v) for k, v in pay.items()},))
    idx = torch.tensor(bids)
    for k, v in pay.items():
        tm.cache[k][:, idx] = torch.from_numpy(v)
    return pay


def _raw(jm, tm, bids):
    idx = list(bids)
    jraw = {k: np.asarray(jm.cache["layers"][0][k][:, jnp.asarray(idx)])
            for k in ("k", "v")}
    traw = {k: tm.cache[k][:, torch.tensor(idx)].numpy() for k in ("k", "v")}
    return jraw, traw


def _same_state(jm, tm):
    """Block-level state of the two managers is equal."""
    assert np.array_equal(np.asarray(jm.allocator.ref), tm.allocator.ref)
    assert list(jm.allocator._free) == list(tm.allocator._free)
    assert jm.tables == tm.tables and jm.reserved == tm.reserved
    assert dict(jm._index) == dict(tm._index)
    assert list(jm._index) == list(tm._index)
    assert jm._class_debt == tm._class_debt
    assert jm.adapter_tables == tm.adapter_tables
    for f in KV_FIELDS + ("lent_blocks_peak", "hash_hits",
                          "adapter_swap_ins", "adapter_sheds"):
        assert getattr(jm, f) == getattr(tm, f), f
    for p in ("charged_debt", "free_blocks", "reclaimable_blocks",
              "pristine"):
        assert getattr(jm, p) == getattr(tm, p), p
    if jm.host_pool is not None:
        for f in ("used_bytes", "peak_used_bytes", "evictions"):
            assert getattr(jm.host_pool, f) == getattr(tm.host_pool, f), f
        assert list(jm.host_pool._demoted) == list(tm.host_pool._demoted)
        assert list(jm.host_pool._swap_sets) \
            == list(tm.host_pool._swap_sets)


def test_over_admit_rejects_sub_one_factor():
    with pytest.raises(ValueError):
        _mgrs(over_admit=0.5)


@pytest.mark.parametrize("case", ["slice", "classes", "interactive",
                                  "standard"])
def test_lending_arithmetic_matches_jax(case):
    """``charged_debt`` is a ``1 / over_admit`` slice of the debt, lent
    from batch debt first, then standard, never interactive; retiring a
    slot retires its class's debt."""
    prios = {"slice": ["standard"], "classes": ["interactive", "batch"],
             "interactive": ["interactive", "interactive"],
             "standard": ["standard", "standard"]}[case]
    jm, tm = _mgrs(n_blocks=32, bs=16, over_admit=2.0)
    prompt = np.zeros((8,), np.int32)
    slots = []
    for pr in prios:
        got = [m.try_admit(prompt, max_new=56, priority=pr)
               for m in (jm, tm)]
        assert got[0] == got[1]
        slots.append(got[0][0])
    _same_state(jm, tm)
    want = {"slice": 2, "classes": 3, "interactive": 6, "standard": 3}
    assert tm.charged_debt == want[case]
    jm.free(slots[0])
    tm.free(slots[0])
    _same_state(jm, tm)


def test_lent_growth_comes_up_short_like_jax():
    """Over-admission admits what the conservative gate refuses; a lent
    reservation's growth returns a short capacity (no exception) until a
    resident is freed."""
    prompt = np.zeros((8,), np.int32)
    for over in (1.0, 2.0):
        jm, tm = _mgrs(n_blocks=8, bs=16, over_admit=over)
        got = [[m.try_admit(prompt, max_new=40) for _ in range(3)]
               for m in (jm, tm)]
        assert got[0] == got[1]
        _same_state(jm, tm)
        if over == 1.0:
            assert got[1][2] is None
            continue
        slots = [g[0] for g in got[1]]
        caps = [[m.grow(s, 48) for s in slots] for m in (jm, tm)]
        assert caps[0] == caps[1] and caps[1][2] < 48
        assert tm.lent_blocks > 0 and tm.lent_blocks_peak > 0
        for m in (jm, tm):
            m.free(slots[0])
        assert [m.grow(slots[2], 48) for m in (jm, tm)] == [48, 48]
        _same_state(jm, tm)


def test_conservative_grow_violation_raises():
    _, tm = _mgrs(n_blocks=8, bs=16)
    s, _ = tm.try_admit(np.zeros((8,), np.int32), max_new=40)
    while tm.allocator.alloc() is not None:
        pass
    with pytest.raises(TK.KVAccountingError):
        tm.grow(s, 48)


# ------------------------------------------------------------ host pool
def test_host_pool_swap_sets_are_pinned_demoted_are_lru():
    """The JAX package's host-pool sequence, run on both pools."""
    with pytest.raises(ConfigInvariantError):
        TK.HostBlockPool(0)
    pools = (JK.HostBlockPool(100), TK.HostBlockPool(100))
    log = []
    for hp in pools:
        out = []
        sid = hp.put_swap({"layers": {}, "n": 2, "tokens": 16, "bytes": 60})
        out.append((sid, hp.used_bytes))
        for key in "abc":
            out.append(hp.put_demoted(key, {"n": 1, "bytes": 20}))
        out.append((hp.evictions, hp.has_demoted("a"),
                    sorted(hp.demoted_keys())))
        out.append(hp.put_swap({"n": 2, "bytes": 80}))
        out.append((hp.n_swap_sets, sorted(hp.demoted_keys()),
                    hp.evictions))
        out.append([hp.put_demoted("d", {"n": 1, "bytes": 20})
                    for _ in range(2)])
        out.append((hp.used_bytes, hp.n_demoted,
                    hp.pop_swap(sid)["bytes"],
                    hp.pop_swap(sid, missing_ok=True)))
        with pytest.raises(Exception):
            hp.pop_swap(sid)
        out.append((hp.flush_demoted(), hp.used_bytes, hp.peak_used_bytes))
        log.append(out)
    assert log[0] == log[1]
    assert log[1][-1] == (1, 0, 100) and log[1][5] is None


def test_swap_rule_matches_jax():
    from repro.serving.clock import CostModel as JCost
    from repro_torch.serving.clock import CostModel
    rng = np.random.default_rng(0)
    for _ in range(50):
        nbytes, toks = int(rng.integers(1, 1 << 24)), int(rng.integers(0, 99))
        assert TK.swap_beats_recompute(nbytes, toks, CostModel()) \
            == JK.swap_beats_recompute(nbytes, toks, JCost())
    assert not TK.swap_beats_recompute(1, 1, CostModel(
        d2h_per_byte=1.0, h2d_per_byte=1.0, prefill_per_tok=2.0))


# ----------------------------------------------------- swap / restore
def test_swap_roundtrip_bit_exact_and_depublishes_like_jax():
    jm, tm = _mgrs(host_blocks=8)
    prompt = np.arange(20, dtype=np.int32)
    for m in (jm, tm):
        s, _ = m.try_admit(prompt, max_new=4)
        m.commit_prefill([(0, s)], [20])
    before = _scribble(jm, tm, list(tm.tables[s]))
    sids = [m.swap_out(s) for m in (jm, tm)]
    assert sids[0] == sids[1] is not None
    assert tm.hash_blocks_resident == 0
    for m in (jm, tm):
        m.free(s)
    assert not tm.pristine
    _same_state(jm, tm)
    adm = [m.try_admit(prompt, max_new=4) for m in (jm, tm)]
    assert adm[0] == adm[1] and adm[1][1] == 0
    s2 = adm[1][0]
    assert [m.restore_swap(s2, sids[1]) for m in (jm, tm)] == [19, 19]
    _same_state(jm, tm)
    jraw, traw = _raw(jm, tm, tm.tables[s2][:3])
    for k in ("k", "v"):
        np.testing.assert_array_equal(traw[k], before[k])
        np.testing.assert_array_equal(traw[k], jraw[k])
    for m in (jm, tm):
        m.free(s2)
    assert tm.pristine
    tm.flush_index()
    assert tm.allocator.n_free == tm.allocator.usable


def test_restore_skips_adopted_shared_blocks_like_jax():
    """A restore never writes the adopted run (it may be shared with a
    live sibling): only the blocks beyond it are written, and the
    sibling's payload stays bit-for-bit."""
    jm, tm = _mgrs(host_blocks=8, n_blocks=16)
    prompt = np.arange(20, dtype=np.int32)
    rolled = np.arange(28, dtype=np.int32)
    for m in (jm, tm):
        sa, _ = m.try_admit(prompt, max_new=4)
        m.commit_prefill([(0, sa)], [20])
    _scribble(jm, tm, tm.tables[sa][:2], seed=1)
    for m in (jm, tm):
        sb, reused = m.try_admit(prompt, max_new=12)
        assert reused == 16
        m.grow(sb, 28)
        m.commit_tokens(sb, np.arange(8, dtype=np.int32))
    _scribble(jm, tm, tm.tables[sb][2:], seed=2)
    shared = tm.tables[sb][:2]
    sids = [m.swap_out(sb) for m in (jm, tm)]
    for m in (jm, tm):
        m.free(sb)
    adm = [m.try_admit(rolled, max_new=4) for m in (jm, tm)]
    assert adm[0] == adm[1] and adm[1][1] == 16
    sc = adm[1][0]
    sibling = _raw(jm, tm, shared)[1]
    b0 = tm.kv_restore_bytes
    assert [m.restore_swap(sc, sid) for m, sid in zip((jm, tm), sids)] \
        == [27, 27]
    assert tm.kv_restore_bytes - b0 == 2 * tm.host_block_bytes
    _same_state(jm, tm)
    after = _raw(jm, tm, shared)[1]
    for k in ("k", "v"):
        np.testing.assert_array_equal(after[k], sibling[k])
    jraw, traw = _raw(jm, tm, tm.tables[sc])
    for k in ("k", "v"):
        np.testing.assert_array_equal(traw[k], jraw[k])
    for m in (jm, tm):
        m.free(sc)
        m.free(sa)
    assert tm.pristine


def test_drop_swap_is_idempotent():
    _, tm = _mgrs(host_blocks=4)
    s, _ = tm.try_admit(np.arange(10, dtype=np.int32), max_new=4)
    tm.commit_prefill([(0, s)], [10])
    sid = tm.swap_out(s)
    tm.free(s)
    assert tm.drop_swap(sid) and tm.kv_swap_drops == 1
    assert not tm.drop_swap(sid) and not tm.drop_swap(None)
    assert tm.pristine and tm.host_pool.used_bytes == 0


def test_demote_rehydrate_byte_identical_like_jax():
    jm, tm = _mgrs(host_blocks=8)
    prompt = np.arange(20, dtype=np.int32)
    for m in (jm, tm):
        s, _ = m.try_admit(prompt, max_new=4)
        m.commit_prefill([(0, s)], [m._seq_len[s]])
    payload = _scribble(jm, tm, tm.tables[s][:2], seed=7)
    for m in (jm, tm):
        m.free(s)
        while m._shed_any():
            pass
    _same_state(jm, tm)
    assert tm.hash_blocks_resident == 0 and tm.kv_demotions == 2
    assert not (set(tm._index) & tm.host_pool.demoted_keys())
    adm = [m.try_admit(prompt, max_new=4) for m in (jm, tm)]
    assert adm[0] == adm[1] and adm[1][1] == 16
    assert tm.kv_rehydrations == 2 and tm.host_pool.n_demoted == 0
    _same_state(jm, tm)
    traw = _raw(jm, tm, tm.tables[adm[1][0]][:2])[1]
    for k in ("k", "v"):
        np.testing.assert_array_equal(traw[k], payload[k])
    for m in (jm, tm):
        m.free(adm[1][0])
        m.flush_index()
        m.flush_host()
    assert tm.pristine and tm.allocator.n_free == tm.allocator.usable


def test_import_block_drops_stale_demoted_twin():
    """A key arriving on the device through any publish path evicts its
    demoted host copy (one key, one tier): a fleet import here, with the
    imported payload the source's and the state the JAX managers'."""
    (jsrc, tsrc), (jdst, tdst) = _mgrs(), _mgrs(host_blocks=8)
    prompt = np.arange(20, dtype=np.int32)
    for m in (jsrc, tsrc, jdst, tdst):
        s, _ = m.try_admit(prompt, max_new=4)
        m.commit_prefill([(0, s)], [m._seq_len[s]])
        m.free(s)
    payload = _scribble(jsrc, tsrc, [tsrc._index[k]
                                     for k in tsrc.chain_keys(prompt)][:1],
                        seed=9)
    for m in (jdst, tdst):
        while m._shed_any():
            pass
    key = tsrc.chain_keys(prompt)[0]
    assert tdst.host_pool.has_demoted(key)
    bids = [d.import_block(key, s, s._index[key])
            for d, s in ((jdst, jsrc), (tdst, tsrc))]
    assert bids[0] == bids[1] is not None
    assert not tdst.host_pool.has_demoted(key)
    assert not (set(tdst._index) & tdst.host_pool.demoted_keys())
    _same_state(jdst, tdst)
    assert tdst.remote_imports == jdst.remote_imports == 1
    jraw, traw = _raw(jdst, tdst, [bids[1]])
    for k in ("k", "v"):
        np.testing.assert_array_equal(traw[k], payload[k])
        np.testing.assert_array_equal(traw[k], jraw[k])


# ------------------------------------------------------------ int8 tier
def test_int8_leaf_equals_jax_quantize_leaf():
    """``quantize_leaf`` gives JAX's int8 payload and f32 scales exactly
    (fp32 input; ties round half to even), and ``dequant_leaf`` JAX's
    values."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 8, 2, 32)).astype(np.float32)
    x[0, 0, 0, :, 0] = [1.0, 127.0 / 2]        # ties: 0.5 and 63.5 steps
    x[0, 0, 1] = 0.0                           # an all-zero group
    jq = j_quantize_leaf(jnp.asarray(x))
    tq = quantize_leaf(torch.from_numpy(x))
    np.testing.assert_array_equal(tq["_q8"].numpy(), np.asarray(jq["_q8"]))
    np.testing.assert_array_equal(tq["_qs"].numpy(), np.asarray(jq["_qs"]))
    from repro.models.quant import dequant_leaf as j_dequant_leaf
    np.testing.assert_array_equal(
        dequant_leaf(tq, torch.float32).numpy(),
        np.asarray(j_dequant_leaf(jq, jnp.float32)))


def test_int8_host_tier_payload_and_round_trip_like_jax():
    """With ``host_quant`` the stored payload and scales equal JAX's, the
    footprint is JAX's, and the restore is within half a step of each
    element's scale."""
    jm, tm = _mgrs(host_blocks=4, host_quant=True)
    raw = _mgrs(host_blocks=4)[1]
    assert tm.host_block_bytes == jm.host_block_bytes < raw.host_block_bytes
    assert tm.host_pool.capacity_bytes == raw.host_pool.capacity_bytes
    prompt = np.arange(20, dtype=np.int32)
    for m in (jm, tm):
        s, _ = m.try_admit(prompt, max_new=4)
        m.commit_prefill([(0, s)], [20])
    before = _scribble(jm, tm, list(tm.tables[s]), seed=3)
    sids = [m.swap_out(s) for m in (jm, tm)]
    jent = jm.host_pool._swap_sets[sids[0]]["layers"][0]
    tent = tm.host_payload(tm.host_pool._swap_sets[sids[1]])
    for k in ("k", "v"):
        for part in ("_q8", "_qs"):
            np.testing.assert_array_equal(tent[k][part].numpy(),
                                          jent[k][part])
    assert tm.kv_swap_out_bytes == 3 * tm.host_block_bytes \
        == jm.kv_swap_out_bytes
    for m in (jm, tm):
        m.free(s)
        s2, _ = m.try_admit(prompt, max_new=4)
    assert [m.restore_swap(s2, sid) for m, sid in zip((jm, tm), sids)] \
        == [19, 19]
    jraw, traw = _raw(jm, tm, tm.tables[s2][:3])
    for k in ("k", "v"):
        np.testing.assert_array_equal(traw[k], jraw[k])
        # half a step, plus the fp32 rounding of x / s and q * s
        half = tent[k]["_qs"].numpy() * (0.5 + 2e-5)
        assert (np.abs(traw[k] - before[k]) <= half).all()


# ------------------------------------------- block-conservation replay
def _ops(seed, n=60):
    """Seeded operations of ``test_preempt.py``'s property test, each with
    its concrete data so both managers get the same."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind, pick, amount = (int(rng.integers(0, 12)), int(rng.integers(0, 8)),
                              int(rng.integers(0, 81)))
        out.append((kind, pick, amount,
                    rng.integers(0, 3, 1 + amount % 40).astype(np.int32),
                    rng.integers(0, 3, 24).astype(np.int64),
                    rng.integers(0, 256, 1 + (amount * 211) % 3000)
                    .astype(np.uint8)))
    return out


def _apply(m, op, live, sids, pins, payloads):
    kind, pick, amount, prompt, toks, pay = op
    if kind == 0:
        got = m.try_admit(prompt, max_new=amount % 48,
                          priority=("interactive", "standard",
                                    "batch")[amount % 3])
        if got is not None:
            live.append(got[0])
    elif kind == 1 and live:
        slot = live[pick % len(live)]
        cap = m.grow(slot, int(m.lens[slot]) + 1 + amount % 24)
        n = min(cap, int(m.lens[slot]) + 1 + amount % 24) - m._seq_len[slot]
        if n > 0:
            m.commit_tokens(slot, toks[:n])
    elif kind == 2 and live:
        slot = live[pick % len(live)]
        m.truncate(slot, max(int(m.lens[slot]) - amount % 16, 0))
    elif kind == 3 and live:
        m.free(live.pop(pick % len(live)))
    elif kind == 4 and live:
        slot = live[pick % len(live)]
        n = min(m._seq_len[slot], len(m.tables[slot]) * m.block_size)
        m.commit_prefill([(0, slot)], [n])
    elif kind == 5 and live:
        slot = live[pick % len(live)]
        m.grow(slot, m.reserved.get(slot, 1) * m.block_size)
    elif kind == 6:
        name = f"A{pick % 4}"
        if name not in m.adapter_tables:
            if m.adapter_admit(name, pay if isinstance(
                    m, JK.PagedCacheManager) else torch.from_numpy(pay)):
                payloads[name] = pay
    elif kind == 7:
        m.adapter_pin(f"A{pick % 4}")
        pins[f"A{pick % 4}"] = pins.get(f"A{pick % 4}", 0) + 1
    elif kind == 8 and pins.get(f"A{pick % 4}", 0):
        m.adapter_unpin(f"A{pick % 4}")
        pins[f"A{pick % 4}"] -= 1
    elif kind == 9:
        m._shed_any()
    elif kind == 10 and live:
        slot = live.pop(pick % len(live))
        sid = m.swap_out(slot)
        m.free(slot)
        if sid is not None:
            sids.append(sid)
    elif kind == 11 and sids:
        sid = sids.pop(pick % len(sids))
        got = (m.try_admit(prompt, max_new=amount % 48) if amount % 2
               else None)
        if got is not None:
            live.append(got[0])
            m.restore_swap(got[0], sid)
        else:
            m.drop_swap(sid)


@pytest.mark.parametrize("over_admit,host_blocks",
                         [(1.0, 0), (1.0, 6), (1.75, 0), (1.75, 6)])
def test_block_conservation_replay_matches_jax(over_admit, host_blocks):
    """Admit/commit/grow/truncate/free, adapter admit/pin/unpin/shed and
    swap-out/restore/drop on both managers: after every operation the
    refcounts, free list, tables, index, debt split, adapter tables,
    counters and host pool are equal, the refcounts are exactly the table +
    index + adapter holds, adapter payloads gather back byte-identical, and
    a drain + flush returns the pool to pristine."""
    from test_preempt import _check_conservation
    jm, tm = _mgrs(capacity=6, n_blocks=13, s_max=96, bs=8,
                   over_admit=over_admit, host_blocks=host_blocks)
    state = {id(m): ([], [], {}, {}) for m in (jm, tm)}
    for op in _ops(seed=int(over_admit * 4) + host_blocks):
        for m in (jm, tm):
            _apply(m, op, *state[id(m)])
        _same_state(jm, tm)
        _check_conservation(tm, over_admit)
        payloads = state[id(tm)][3]
        for name in tm.adapter_tables:
            np.testing.assert_array_equal(
                tm.adapter_gather(name).numpy(), payloads[name])
    for m in (jm, tm):
        live, sids, pins, _ = state[id(m)]
        for slot in live:
            m.free(slot)
        for sid in sids:
            m.drop_swap(sid)
        for name, c in pins.items():
            for _ in range(c):
                m.adapter_unpin(name)
        assert m.pristine
        m.flush_adapters()
        m.flush_index()
        m.flush_host()
    _same_state(jm, tm)
    assert tm.allocator.n_free == tm.allocator.usable
    assert not tm._index and not tm.adapter_tables


# --------------------------------------------------------- engine level
@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX weights + adapter "serve", and the port's copies."""
    tmp = tmp_path_factory.mktemp("tiers")
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    jstore.load_random("serve", jax.random.PRNGKey(2))
    adapter = to_port_bank(jstore.get_adapter("serve"), tmp / "serve.npz")
    params = to_port_params(jparams, tmp / "params.npz")
    return jcfg, jparams, jstore.get_adapter("serve"), params, adapter


def _engines(pair, **kw):
    jcfg, jparams, jad, params, adapter = pair
    kw = {"capacity": 4, "pf_capacity": 2, "s_max": 64,
          "virtual_time": True, "block_size": 16, **kw}
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    jstore.load("serve", jad)
    cfg = get_reduced("llama3-8b")
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=4), device="cpu")
    store.load("serve", adapter)
    jkw = dict(kw)
    if "spec" in jkw:
        jkw["spec"] = JSpecConfig(k_max=kw["spec"].k_max,
                                  drafter=kw["spec"].drafter)
    return (JUnifiedEngine(JMixedLoraModel(jcfg, jparams, jstore),
                           JEngineConfig(**jkw)),
            UnifiedEngine(MixedLoraModel(cfg, params, store),
                          EngineConfig(**kw)))


def _reqs(n=3, prompt_len=8, max_new=40):
    rng = np.random.default_rng(11)
    vocab = get_reduced("llama3-8b").vocab
    prompts = [rng.integers(0, vocab, prompt_len).astype(np.int32)
               for _ in range(n)]
    return [[R(rid=i, prompt=p, adapter="serve", max_new_tokens=max_new,
               arrival=0.1 * i) for i, p in enumerate(prompts)]
            for R in (JRequest, Request)]


def _same_run(jeng, eng, n):
    out = {r.rid: list(r.output) for r in eng.finished}
    assert len(out) == n and all(r.state is State.DONE
                                 for r in eng.finished)
    assert out == {r.rid: list(r.output) for r in jeng.finished}
    for f in METRIC_FIELDS:
        assert getattr(eng.metrics, f) == getattr(jeng.metrics, f), f
    assert eng.swap_decisions == jeng.swap_decisions
    for f in KV_FIELDS:
        assert getattr(eng.cachemgr, f) == getattr(jeng.cachemgr, f), f
    assert eng.cachemgr.pristine and jeng.cachemgr.pristine
    return out


def _run_both(pair, reqs=None, **kw):
    jeng, eng = _engines(pair, **kw)
    jr, tr = reqs or _reqs()
    for e, rs in ((jeng, jr), (eng, tr)):
        for r in rs:
            e.submit(r)
        e.run(max_ticks=5000)
    return jeng, eng, _same_run(jeng, eng, len(tr))


def test_forced_preemption_and_swap_match_jax(pair):
    """Three 3-block-life requests in a 7-block pool: conservative, lending
    with recompute preemption, and lending with the host tier (raw and
    int8).  Every arm's tokens, steps, preemptions, swap decisions and
    kv counters equal the JAX engine's; the exact arms agree with each
    other, the swap arm restores what it swapped out and recomputes
    fewer tokens."""
    arms = {"conservative": dict(n_blocks=8),
            "recompute": dict(n_blocks=8, over_admit=2.0),
            "swap": dict(n_blocks=8, over_admit=2.0, kv_host_blocks=8),
            "int8": dict(n_blocks=8, over_admit=2.0, kv_host_blocks=8,
                         kv_host_quant=True)}
    outs, engs = {}, {}
    for name, kw in arms.items():
        _, engs[name], outs[name] = _run_both(pair, **kw)
    assert outs["conservative"] == outs["recompute"] == outs["swap"]
    rec, swp, q8 = engs["recompute"], engs["swap"], engs["int8"]
    assert engs["conservative"].metrics.preemptions == 0
    assert rec.metrics.preemptions >= 1 and rec.metrics.lent_blocks_peak
    assert swp.metrics.kv_swap_outs >= 1
    assert swp.metrics.kv_restores == swp.metrics.kv_swap_outs
    assert swp.metrics.preempted_tokens_recomputed \
        < rec.metrics.preempted_tokens_recomputed
    assert q8.metrics.kv_swap_outs >= 1 and q8.metrics.host_bytes_peak \
        < swp.metrics.host_bytes_peak


def test_double_preemption_matches_jax(pair):
    """A request preempted twice rolls only its new output tail into its
    prompt each time; tokens equal the JAX engine's and a clean run's."""
    _, clean, expect = _run_both(pair, _reqs(n=2, max_new=24), n_blocks=40)
    jeng, eng = _engines(pair, n_blocks=40)
    jr, tr = _reqs(n=2, max_new=24)
    for e, rs in ((jeng, jr), (eng, tr)):
        for r in rs:
            e.submit(r)
        victim, orig, hits = rs[1], rs[1].prompt_len, 0
        for _ in range(2000):
            e.tick()
            if (hits < 2 and victim.state.name == "DECODE"
                    and len(victim.output) >= 2 + hits * 3):
                e._preempt(victim.dec_slot)
                hits += 1
                assert victim.prompt_len == orig + victim.rolled
            if all(r.done for r in rs):
                break
        assert hits == 2 and victim.preemptions == 2
    assert _same_run(jeng, eng, 2) == expect


def test_suffix_drafter_survives_preemption_like_jax(pair):
    """Speculation across a preemption: the drafter's context stays
    aligned, acceptance stays high, tokens equal a clean run's and the JAX
    engine's."""
    _, _, expect = _run_both(pair, _reqs(n=1, max_new=24), n_blocks=40)
    jeng, eng = _engines(pair, n_blocks=40,
                         spec=SpecConfig(k_max=3, drafter="suffix"))
    jr, tr = _reqs(n=1, max_new=24)
    for e, rs in ((jeng, jr), (eng, tr)):
        rs[0].draft_suffix = np.concatenate(
            [rs[0].prompt, np.asarray(expect[0], np.int64)])
        e.submit(rs[0])
        preempted = False
        for _ in range(2000):
            e.tick()
            if (not preempted and rs[0].state.name == "DECODE"
                    and len(rs[0].output) >= 4):
                e._preempt(rs[0].dec_slot)
                preempted = True
            if rs[0].done:
                break
        assert preempted
    assert _same_run(jeng, eng, 1) == expect
    assert eng.metrics.spec_drafted == jeng.metrics.spec_drafted > 0
    assert eng.metrics.acceptance_rate > 0.9


def test_pick_victim_prefers_batch_class_like_jax(pair):
    jeng, eng = _engines(pair, pf_capacity=4, n_blocks=40)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, 8).astype(np.int32) for _ in range(3)]
    for e, R in ((jeng, JRequest), (eng, Request)):
        rs = [R(rid=i, prompt=p, adapter="serve", max_new_tokens=20,
                arrival=0.1 * i, priority_class=pc)
              for i, (p, pc) in enumerate(zip(
                  prompts, ("batch", "standard", "interactive")))]
        for r in rs:
            e.submit(r)
        for _ in range(200):
            e.tick()
            if all(r.state.name == "DECODE" for r in rs):
                break
        v0 = e.active[e._pick_victim(frozenset())].priority_class
        v1 = e.active[e._pick_victim(frozenset([rs[0].dec_slot]))]
        assert (v0, v1.priority_class) == ("batch", "standard")


def test_demote_and_rehydrate_in_the_engine_like_jax(pair):
    """Two shared heads under pool pressure: index blocks demote to host
    when shed and later requests rehydrate them; the run equals the JAX
    engine's."""
    rng = np.random.default_rng(5)
    heads = [rng.integers(0, 512, 48).astype(np.int32) for _ in range(2)]
    trace = []
    for i in range(8):
        tail = rng.integers(0, 512, 4 + i).astype(np.int32)
        trace.append((i, np.concatenate([heads[(i // 2) % 2], tail]),
                      0.3 * i))
    reqs = [[R(rid=i, prompt=p, adapter="serve", max_new_tokens=6,
               arrival=a) for i, p, a in trace]
            for R in (JRequest, Request)]
    jeng, eng, _ = _run_both(pair, reqs, capacity=2, n_blocks=7,
                             kv_host_blocks=8)
    assert eng.metrics.kv_demotions > 0
    assert eng.metrics.kv_rehydrated_blocks > 0
