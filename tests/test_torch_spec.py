"""Speculative decoding in the port vs the JAX package, on the CPU.

* ``repro_torch.spec`` (drafters, ``AdaptiveK``, ``accept_greedy``) against
  ``repro.spec`` on the same seeded histories and logits: identical output.
* ``unified_forward`` with a ``[Bd, Sd]`` verify bucket against the JAX
  ``unified_forward`` on the reduced llama3 (2 layers, d_model 256), fp32,
  JAX weights through the bridge: verify logits and every written pool block
  within 1e-4 (fp32 on both sides, other summation order over two layers and
  a 512-way head), over a table that takes the sequential verify kernel's
  plain version and one that takes the split-K plain version; the JAX side
  also in its split-K Pallas mode (interpret) at the same lane count.
* ``PagedCacheManager.truncate`` against the JAX manager over the same op
  sequences: lens, tables, refcounts, reservations, debt and the dedup
  index equal after every op, and the pool pristine after ``free``.
* The spec engine (``ngram`` and ``suffix`` drafters, virtual clock)
  against the JAX spec engine and against plain greedy: identical tokens per
  request, the same spec counters and step counts, EOS / max_new cuts, SLO
  accounting, draft headroom at admission, and no stranded request.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro import spec as jspec
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.kernels import autotune as j_autotune
from repro.models import model as JM
from repro.models.stream import DECBatch as JDEC, PFBatch as JPF, \
    UnifiedBatch as JUB
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.kvcache import PagedCacheManager as JPagedCacheManager
from repro.serving.request import Request as JRequest
from repro_torch import spec as tspec
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.kernels import autotune
from repro_torch.models import model as TM
from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.kvcache import PagedCacheManager
from repro_torch.serving.request import Request
from repro_torch.serving.slo import SLOConfig, slo_attainment

LOGIT_TOL = 1e-4


# ------------------------------------------------------------ spec package
@pytest.mark.parametrize("seed", range(4))
def test_drafters_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        ctx = rng.integers(0, 6, int(rng.integers(0, 30)))
        k = int(rng.integers(0, 6))
        for n in (1, 2, 3):
            a = tspec.NgramDrafter(max_n=n).draft(ctx, k)
            b = jspec.NgramDrafter(max_n=n).draft(ctx, k)
            np.testing.assert_array_equal(a, b)
        seq = rng.integers(0, 50, 40)
        at = seq[:int(rng.integers(0, 42))]
        np.testing.assert_array_equal(
            tspec.make_drafter("suffix", suffix=seq).draft(at, k),
            jspec.make_drafter("suffix", suffix=seq).draft(at, k))
    assert isinstance(tspec.make_drafter("ngram", ngram_n=2),
                      tspec.NgramDrafter)
    for kind, kw in (("suffix", {}), ("bogus", {})):
        with pytest.raises(ValueError):
            tspec.make_drafter(kind, **kw)


def test_adaptive_k_and_acceptance_match_jax():
    rng = np.random.default_rng(1)
    for cfg_kw in (dict(k_max=4, k_min=1), dict(k_max=6, adaptive=False),
                   dict(k_max=3, ewma=0.8, raise_at=0.9, lower_at=0.2)):
        a = tspec.AdaptiveK(tspec.SpecConfig(**cfg_kw))
        b = jspec.AdaptiveK(jspec.SpecConfig(**cfg_kw))
        for _ in range(60):
            nd = int(rng.integers(0, 5))
            na = int(rng.integers(0, nd + 1))
            a.update(nd, na)
            b.update(nd, na)
            assert (a.k, a.rate, a.drafted, a.accepted) \
                == (b.k, b.rate, b.drafted, b.accepted)
    for _ in range(100):
        k = int(rng.integers(0, 5))
        logits = rng.standard_normal((k + 1 + int(rng.integers(0, 2)), 7))
        draft = np.argmax(logits[:k], -1)
        cut = int(rng.integers(0, k + 1))
        draft[cut:] = rng.integers(0, 7, k - cut)
        expect = jspec.accept_greedy(draft, logits)
        assert tspec.accept_greedy(draft, logits) == expect
        assert tspec.accept_greedy_ids(draft, logits.argmax(-1)) == expect


def test_verify_planner_matches_jax():
    """``[Bd, Sd]`` chunks with per-row lengths plan as in JAX, and their
    per-token adapter ids repeat ``Sd`` times."""
    from repro.core import flow as jflow
    from repro_torch.core import flow as tflow
    rng = np.random.default_rng(0)
    toks, pos = rng.integers(0, 512, (4, 5)), rng.integers(0, 90, 4)
    slots, lens = rng.integers(-1, 4, 4), np.array([5, 1, 0, 3])
    tables = rng.integers(0, 30, (4, 6))
    jb = jflow.assemble([], [], toks, pos, slots, jflow.FlowConfig(),
                        dec_tables=tables, dec_lens=lens)
    tb = tflow.assemble([], toks, pos, slots, tflow.FlowConfig(),
                        torch.device("cpu"), dec_tables=tables,
                        dec_lens=lens)
    for f in ("tokens", "pos", "adapter", "block_tables", "length"):
        np.testing.assert_array_equal(getattr(tb.dec, f).numpy(),
                                      np.asarray(getattr(jb.dec, f)))
    np.testing.assert_array_equal(tflow.token_adapter_ids(tb),
                                  jflow.token_adapter_ids(jb))
    assert len(tflow.token_adapter_ids(tb)) == 20


# ------------------------------------------------- model: verify bucket
BS, NB = 8, 40


@pytest.fixture(scope="module")
def model_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bridge")
    from repro.models.schema import init_params as j_init_params
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


def _forward(s, state, pf=None, dec=None):
    jb, tb = {}, {}
    if pf is not None:
        jb["pf"] = JPF(tokens=j(pf["tokens"]), length=j(pf["length"]),
                       adapter=j(pf["adapter"]), block_tables=j(pf["tables"]))
        tb["pf"] = PFBatch(tokens=t(pf["tokens"]), length=t(pf["length"]),
                           adapter=t(pf["adapter"]),
                           block_tables=t(pf["tables"]))
    if dec is not None:
        jb["dec"] = JDEC(tokens=j(dec["tokens"]), pos=j(dec["pos"]),
                         adapter=j(dec["adapter"]),
                         block_tables=j(dec["tables"]),
                         length=j(dec["length"]))
        tb["dec"] = DECBatch(tokens=t(dec["tokens"]), pos=t(dec["pos"]),
                             adapter=t(dec["adapter"]),
                             block_tables=t(dec["tables"]),
                             length=t(dec["length"]))
    jout = JM.unified_forward(s["jcfg"], s["jparams"], JUB(**jb), state["j"],
                              loras=s["jbank"], lora_scale=s["jscale"])
    tout = TM.unified_forward(s["cfg"], s["params"], UnifiedBatch(**tb),
                              state["t"], loras=s["bank"],
                              lora_scale=s["scale"], block_t=8)
    state["j"] = jout.cache
    return jout, tout


@pytest.mark.parametrize("nbt,mode,ns", [(6, "", 1), (8, "", 2),
                                         (8, "splitk-interpret", 2)])
def test_verify_bucket_matches_jax(model_pair, monkeypatch, nbt, mode, ns):
    """Prefill two requests, then one verify bucket of three rows: a full
    5-token chunk straddling a block edge, a 2-token chunk (trailing
    padding slots), and an inactive row (pos 0, lens 0, null table).  At
    132 lanes a 6-entry table walks sequentially and an 8-entry one splits
    in two on both sides: the port keys on its grid (Bd 3 x 2 KV heads),
    the JAX model on its own (Bd 3 x 8 heads)."""
    s = model_pair
    monkeypatch.setenv("REPRO_PAGED_ATTN_KERNEL", mode)
    # the JAX chooser at the card's lane count, which the port uses here
    monkeypatch.setenv("REPRO_ATTN_LANES", "132")
    hd = s["cfg"].hd
    assert autotune.choose(hd, BS, nbt, 3 * s["cfg"].n_kv_heads
                           ).num_splits == ns
    assert j_autotune.choose(hd, BS, nbt, 3 * s["cfg"].n_heads
                             ).num_splits == ns
    rng = np.random.default_rng(nbt)
    V = s["cfg"].vocab
    state = {"j": JM.init_paged_cache(s["jcfg"], NB, BS, 3),
             "t": TM.init_paged_cache(s["cfg"], NB, BS, torch.device("cpu"),
                                      torch.float32)}

    def table(*bids):
        row = np.zeros((nbt,), np.int32)
        row[:len(bids)] = bids
        return row

    tables = np.stack([table(3, 1, 7, 5, 9, 11), table(2, 6, 4, 8),
                       table()])
    toks = np.zeros((2, 32), np.int32)
    toks[0, :14], toks[1, :29] = rng.integers(0, V, 14), rng.integers(0, V,
                                                                      29)
    jout, tout = _forward(s, state, pf=dict(
        tokens=toks, length=np.array([14, 29], np.int32),
        adapter=np.array([0, 1], np.int32), tables=tables[:2]))
    assert max_err(tout.pf_logits, jout.pf_logits) < LOGIT_TOL
    nxt = tout.pf_logits.argmax(-1).numpy()
    chunk = rng.integers(0, V, (3, 5)).astype(np.int32)
    chunk[:2, 0] = nxt
    jout, tout = _forward(s, state, dec=dict(
        tokens=chunk, pos=np.array([14, 29, 0], np.int32),
        adapter=np.array([0, 1, -1], np.int32), tables=tables,
        length=np.array([5, 2, 0], np.int32)))
    assert tout.dec_logits.shape == (3, 5, V)
    assert torch.isfinite(tout.dec_logits).all()
    assert max_err(tout.dec_logits, jout.dec_logits) < LOGIT_TOL
    for kv in ("k", "v"):     # block 0 is the null block: garbage by design
        jpool = np.asarray(jout.cache["layers"][0][kv])[:, 1:]
        assert max_err(tout.cache[kv][:, 1:], jpool) < LOGIT_TOL, kv


# -------------------------------------------------- cache rollback parity
def _managers(capacity, n_blocks, bs, s_max=64):
    jm = JPagedCacheManager(j_get_reduced("llama3-8b"), capacity, 2, s_max,
                            block_size=bs, n_blocks=n_blocks)
    tm = PagedCacheManager(get_reduced("llama3-8b"), capacity, 2, s_max,
                           device=torch.device("cpu"), dtype=torch.float32,
                           block_size=bs, n_blocks=n_blocks)
    return jm, tm


def _same_state(jm, tm):
    assert tm.tables == jm.tables
    np.testing.assert_array_equal(tm.lens, jm.lens)
    np.testing.assert_array_equal(tm.allocator.ref, jm.allocator.ref)
    assert list(tm.allocator._free) == list(jm.allocator._free)
    assert tm.reserved == jm.reserved
    assert tm.reserved_debt == jm.reserved_debt
    assert tm.shared_count == jm.shared_count
    assert dict(tm._index) == dict(jm._index)
    assert tm._chains == jm._chains
    assert tm._seq_len == jm._seq_len


# op sequences of tests/test_paged_cache.py's truncate cases, on both
# managers: (method, args, kwargs); "commit" lands a slot's whole prompt
_SEQS = {
    "reservation": (dict(capacity=4, n_blocks=9, bs=16), [
        ("try_admit", (np.zeros((20,), np.int32), 24), dict(headroom=8)),
        ("grow", (0, 52), {}), ("truncate", (0, 22), {}),
        ("grow", (0, 52), {}), ("truncate", (0, 0), {})]),
    "shared_prefix": (dict(capacity=4, n_blocks=16, bs=8), [
        ("try_admit", (np.arange(17, dtype=np.int32), 8), {}),
        ("commit", (0,), {}),
        ("try_admit", (np.arange(17, dtype=np.int32), 8), {}),
        ("grow", (1, 24), {}), ("truncate", (1, 4), {}),
        ("try_admit", (np.arange(17, dtype=np.int32), 8), {})]),
    "full_pool": (dict(capacity=8, n_blocks=8, bs=8), [
        ("try_admit", (np.arange(17, dtype=np.int32), 7), {}),
        ("commit", (0,), {}),
        ("try_admit", (np.arange(17, dtype=np.int32), 7), {}),
        ("try_admit", (np.arange(8, dtype=np.int32), 16), {}),
        ("truncate", (1, 4), {}), ("grow", (0, 24), {}),
        ("grow", (2, 24), {})]),
    "adopted_index": (dict(capacity=4, n_blocks=16, bs=8), [
        ("try_admit", (np.arange(17, dtype=np.int32), 8), {}),
        ("commit", (0,), {}), ("free", (0,), {}),
        ("try_admit", (np.arange(17, dtype=np.int32), 8), {}),
        ("grow", (1, 24), {}), ("truncate", (1, 20), {}),
        ("grow", (1, 24), {}), ("truncate", (1, 18), {}),
        ("grow", (1, 24), {}), ("truncate", (1, 4), {}),
        ("commit_tokens", (1, [5, 6, 7, 8, 9, 10, 11, 12, 13, 14]), {}),
        ("truncate", (1, 9), {})]),
}


@pytest.mark.parametrize("name", sorted(_SEQS))
def test_truncate_matches_jax_manager(name):
    kw, ops = _SEQS[name]
    jm, tm = _managers(**kw)
    for op, args, okw in ops:
        if op == "commit":
            for m in (jm, tm):
                m.commit_prefill([(0, args[0])], [m._seq_len[args[0]]])
        else:
            a = getattr(jm, op)(*args, **okw)
            b = getattr(tm, op)(*args, **okw)
            assert a == b, op
        _same_state(jm, tm)
        assert tm.allocator.n_free >= tm.reserved_debt
    for slot in list(tm.tables):
        jm.free(slot)
        tm.free(slot)
    _same_state(jm, tm)
    assert tm.pristine and jm.pristine


# ---------------------------------------------------------- spec engine
ADAPTER = "serve"


@pytest.fixture(scope="module")
def engine_pair(tmp_path_factory):
    from repro.models.schema import init_params as j_init_params
    tmp = tmp_path_factory.mktemp("bridge")
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    jstore.load_random(ADAPTER, jax.random.PRNGKey(2))
    cfg = get_reduced("llama3-8b")
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=4), device="cpu")
    store.load(ADAPTER, to_port_bank(jstore.get_adapter(ADAPTER),
                                     tmp / "adapter.npz"))
    return (jcfg, jparams, jstore, cfg,
            to_port_params(jparams, tmp / "params.npz"), store)


def _engines(pair, spec_kw, **kw):
    jcfg, jparams, jstore, cfg, params, store = pair
    kw = {"capacity": 4, "pf_capacity": 2, "s_max": 96, "block_size": 16,
          "virtual_time": True, **kw}
    jeng = JUnifiedEngine(JMixedLoraModel(jcfg, jparams, jstore),
                          JEngineConfig(spec=(jspec.SpecConfig(**spec_kw)
                                              if spec_kw else None), **kw))
    eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                        EngineConfig(spec=(tspec.SpecConfig(**spec_kw)
                                           if spec_kw else None), **kw))
    return jeng, eng


def _trace(vocab, n=6, seed=3, max_new=10):
    rng = np.random.default_rng(seed)
    return [dict(rid=i, prompt=rng.integers(0, vocab, rng.integers(
                6, 24)).astype(np.int32), adapter=ADAPTER,
                 max_new_tokens=max_new, arrival=0.2 * i) for i in range(n)]


def _serve(pair, trace, spec_kw, **kw):
    """Both engines over ``trace``; their outputs must be equal.  Returns
    (jax engine, port engine, outputs)."""
    jeng, eng = _engines(pair, spec_kw, **kw)
    for r in trace:
        jeng.submit(JRequest(**r))
        eng.submit(Request(**r))
    jeng.run(max_ticks=5000)
    eng.run(max_ticks=5000)
    out = {r.rid: list(r.output) for r in eng.finished}
    assert out == {r.rid: list(r.output) for r in jeng.finished}
    assert len(out) == len(trace)
    for f in ("steps", "decode_tokens", "spec_drafted", "spec_accepted",
              "spec_steps"):
        assert getattr(eng.metrics, f) == getattr(jeng.metrics, f), f
    assert eng.cachemgr.pristine
    return jeng, eng, out


@pytest.fixture(scope="module")
def plain_outputs(engine_pair):
    """Plain greedy decode of the default trace (port == JAX)."""
    trace = _trace(engine_pair[3].vocab)
    return _serve(engine_pair, trace, None)[2]


@pytest.mark.parametrize("k_max", [2, 4])
def test_ngram_spec_engine_matches_jax_and_greedy(engine_pair, plain_outputs,
                                                  k_max):
    trace = _trace(engine_pair[3].vocab)
    _, eng, out = _serve(engine_pair, trace,
                         dict(k_max=k_max, drafter="ngram"))
    assert out == plain_outputs
    assert eng.metrics.spec_drafted > 0
    assert slo_attainment(eng.finished, SLOConfig()) == 1.0
    for r in eng.finished:    # per-token SLO accounting in lockstep
        assert len(r.token_times) == len(r.output)
        lat = r.decode_latencies()
        assert lat.size == len(r.output) - 1 and (lat >= 0).all()


def test_suffix_replay_accepts_all_and_saves_steps(engine_pair,
                                                   plain_outputs):
    trace = _trace(engine_pair[3].vocab)
    for r in trace:
        r["draft_suffix"] = np.concatenate(
            [r["prompt"], np.asarray(plain_outputs[r["rid"]], np.int64)])
    _, eng, out = _serve(engine_pair, trace,
                         dict(k_max=4, drafter="suffix", adaptive=False))
    m = eng.metrics
    assert out == plain_outputs
    assert m.acceptance_rate == 1.0 and m.spec_accepted > 0
    assert m.decode_tokens == sum(len(v) - 1 for v in out.values())
    plain_steps = _serve(engine_pair, trace, None)[1].metrics.steps
    assert m.steps < plain_steps


def test_spec_respects_eos_and_max_new(engine_pair, plain_outputs):
    """Each request's 3rd greedy token is its eos, and max_new is 6: the
    chunk tail is cut exactly where plain greedy stops."""
    outs = {}
    for name, spec_kw in (("plain", None),
                          ("spec", dict(k_max=4, drafter="ngram"))):
        trace = _trace(engine_pair[3].vocab, n=4, max_new=6)
        for r in trace:
            r["eos_token"] = int(plain_outputs[r["rid"]][2])
        outs[name] = _serve(engine_pair, trace, spec_kw)[2]
    assert outs["spec"] == outs["plain"]
    for rid, out in outs["spec"].items():
        assert len(out) <= 6 and out[-1] == plain_outputs[rid][2]


def test_spec_over_adopted_prefix_matches_jax_and_greedy(engine_pair):
    """Spec decoding over adopted index blocks (a shared 32-token head):
    rollback releases only draft blocks, outputs equal plain greedy."""
    vocab = engine_pair[3].vocab
    head = np.arange(32, dtype=np.int32)
    rng = np.random.default_rng(7)
    trace = [dict(rid=i, prompt=np.concatenate([head, rng.integers(
        0, vocab, 5 + i).astype(np.int32)]), adapter=ADAPTER,
        max_new_tokens=8, arrival=0.3 * i) for i in range(4)]
    plain = _serve(engine_pair, trace, None, s_max=64)[2]
    _, eng, out = _serve(engine_pair, trace,
                         dict(k_max=3, drafter="ngram"), s_max=64)
    assert out == plain and eng.metrics.hash_hits >= 2


def test_spec_admission_accounts_draft_headroom(engine_pair):
    """A pool sized for the plain projection admits fewer requests once
    the +k draft headroom is charged; as in the JAX engine."""
    prompt = np.arange(20, dtype=np.int32)
    jeng, eng = _engines(engine_pair, dict(k_max=4), n_blocks=9)
    assert eng.spec_headroom == jeng.spec_headroom == 4
    h = eng.spec_headroom
    for m in (jeng.cachemgr, eng.cachemgr):
        assert m.fresh_need(20, 12, prompt, headroom=h) \
            == m.fresh_need(20, 12, prompt) + 1
        got = [m.try_admit(prompt, 12, headroom=h) for _ in range(3)]
        assert got[0] is not None and got[1] is not None and got[2] is None


def test_headroom_never_strands_a_servable_request(engine_pair):
    """Fits its plain projection but not projection + k_max: admitted with
    no draft room, and decodes to the plain greedy output."""
    vocab = engine_pair[3].vocab
    trace = [dict(rid=0, prompt=(np.arange(20) % vocab).astype(np.int32),
                  adapter=ADAPTER, max_new_tokens=8)]
    plain = _serve(engine_pair, trace, None, n_blocks=3, s_max=32)[2]
    jeng, eng, out = _serve(engine_pair, trace,
                            dict(k_max=4, drafter="ngram"), n_blocks=3,
                            s_max=32)
    assert out == plain and not eng.waiting
