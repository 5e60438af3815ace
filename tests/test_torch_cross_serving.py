"""The port's cross-attention family served and trained through its entry
points against the JAX package's, in fp32 on the CPU at reduced size (the
models and weights of ``test_torch_cross.py``: ``xgate`` open, the LoRA
banks on ``xwq`` / ``xwo`` too, one source ``aux_embed`` per request drawn
from a numpy seed).

* The engine gives the JAX engine's greedy tokens, steps and counters:
  dedup on with no hash hit (an aux request neither adopts nor publishes),
  speculation (verify chunks over the ``xk`` / ``xv`` rows), chunked
  prefill (every chunk projects the source again), lending with a host
  tier (swap-outs and restores), dense rows, and adapter paging (byte
  images over ``xwq`` / ``xwo``); a 2-replica fleet fetches
  no block for aux requests and gives the JAX fleet's tokens; the twin of
  ``test_hash_dedup.py::test_aux_embed_requests_never_share``.
* ``launch.serve`` and ``launch.train`` with ``--arch`` on both ids give
  the JAX CLIs' tokens and losses (both CLIs drawing their weights from the
  same gated JAX params and JAX-drawn adapters).
"""
import sys

import jax
import numpy as np
import pytest

from _torch_bridge import to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.data import datasets, workload
from repro.fleet import FleetConfig as JFleetConfig, \
    RouterConfig as JRouterConfig, build_fleet as j_build_fleet
from repro.launch import serve as j_serve, train as j_train
from repro.models import schema as jschema
from repro.serving.clock import CostModel as JCostModel
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro.spec import SpecConfig as JSpecConfig
from repro_torch.configs import get_reduced
from repro_torch.core import virtualization as tvirt
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
from repro_torch.launch import serve as t_serve, train as t_train
from repro_torch.serving.clock import CostModel
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request
from repro_torch.spec import SpecConfig
from test_torch_cross import ARCHS, LCFG, VLM, _F, _aux, _gated, _setup


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("cross_serving")


@pytest.fixture(params=ARCHS, scope="module")
def s(request, tmp):
    return _setup(request.param, tmp)


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


def _req_aux(cfg, i):
    return _aux(cfg, 1, seed=100 + i, scale=0.5)[0]


def _shared_reqs(R, cfg, n=5, max_new=6, seed=0):
    """A 32-token shared head, tails of 4-11 tokens, a source each."""
    head = np.arange(32, dtype=np.int32) % cfg.vocab
    rng = np.random.default_rng(seed)
    return [R(rid=i, prompt=np.concatenate(
                [head, rng.integers(0, cfg.vocab, rng.integers(4, 12))
                 .astype(np.int32)]),
              adapter="serve", max_new_tokens=max_new, arrival=0.25 * i,
              aux_embed=_req_aux(cfg, i))
            for i in range(n)]


def _repeat_reqs(R, cfg, n=4, max_new=10):
    """Prompts that repeat an 8-token motif (the n-gram drafter finds
    drafts), a source each."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        motif = rng.integers(0, cfg.vocab, 8).astype(np.int32)
        out.append(R(rid=i, prompt=np.tile(motif, 3 + i % 2),
                     adapter="serve", max_new_tokens=max_new,
                     arrival=0.1 * i, aux_embed=_req_aux(cfg, i)))
    return out


def _runtime_reqs(R, cfg, n=8, max_new=24, rps=4.0):
    """``test_runtime.py``'s trace (two adapters, Poisson arrivals), a
    source each."""
    prompts = datasets.sharegpt_prompts(n, vocab=cfg.vocab, len_lo=6,
                                        len_hi=20)
    arr = workload.poisson_arrivals(rps, n, seed=1)
    return [R(rid=i, prompt=p, adapter=("serve", "other")[i % 2],
              max_new_tokens=max_new, arrival=float(a),
              aux_embed=_req_aux(cfg, i))
            for i, (p, a) in enumerate(zip(prompts, arr))]


ECFG = dict(capacity=4, pf_capacity=2, s_max=96, block_size=16,
            virtual_time=True)


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run(max_ticks=8000)
    return {r.rid: list(r.output) for r in eng.finished}


def _pair(s, ecfg, reqs, names=("serve",), jecfg=None):
    """The JAX and the port engine on one trace."""
    jstore, store = _stores(s, names)
    jeng = JUnifiedEngine(JMixedLoraModel(s["jcfg"], s["jparams"], jstore),
                          JEngineConfig(**(jecfg or ecfg)))
    eng = UnifiedEngine(MixedLoraModel(s["cfg"], s["params"], store),
                        EngineConfig(**ecfg))
    return (_run(jeng, reqs(JRequest, s["cfg"])),
            _run(eng, reqs(Request, s["cfg"])), jeng, eng)


def test_engine_dedup_never_shares_sources(s):
    """Dedup on, a shared 32-token head: aux requests neither adopt nor
    publish (0 hash hits, no reused tokens) and suffix prefill stays on;
    tokens, steps and counters equal the JAX engine's, and equal the run
    with dedup off."""
    jout, out, jeng, eng = _pair(s, ECFG, _shared_reqs)
    assert eng.suffix_prefill and eng.hash_dedup
    assert len(out) == 5 and out == jout
    m, jm = eng.metrics, jeng.metrics
    assert m.hash_hits == jm.hash_hits == 0
    assert m.reused_prefix_tokens == jm.reused_prefix_tokens == 0
    assert m.steps == jm.steps and eng.cachemgr.pristine
    _, plain, _, _ = _pair(s, dict(ECFG, hash_dedup=False), _shared_reqs)
    assert plain == out


def test_engine_speculation_matches_jax(s):
    """Speculation stays on for a cross model (its pattern has no Mamba
    layer): verify chunks read the ``xk`` / ``xv`` rows; drafts, accepted
    tokens, steps and tokens equal the JAX engine's, and the tokens equal
    plain decode's."""
    spec = dict(k_max=3, drafter="ngram")
    jout, out, jeng, eng = _pair(
        s, dict(ECFG, spec=SpecConfig(**spec)), _repeat_reqs,
        jecfg=dict(ECFG, spec=JSpecConfig(**spec)))
    assert eng.spec is not None and len(out) == 4 and out == jout
    m, jm = eng.metrics, jeng.metrics
    assert m.spec_drafted == jm.spec_drafted > 0
    assert m.spec_accepted == jm.spec_accepted and m.steps == jm.steps
    assert eng.cachemgr.pristine
    _, plain, _, _ = _pair(s, ECFG, _repeat_reqs)
    assert plain == out


LEND = dict(over_admit=2.0, n_blocks=6, block_size=16)


@pytest.mark.parametrize("ecfg", [
    dict(prefill_chunk=16), dict(LEND, kv_host_blocks=4),
    dict(paged=False, s_max=64), dict(adapter_paging=True)],
    ids=["chunked", "host_tier", "dense_rows", "adapter_paging"])
def test_engine_memory_paths_match_jax(s, ecfg):
    """Chunked prefill (16 tokens a tick: every chunk re-projects the
    source), lending on a tight pool with a host tier (preemptions swap
    out and restore; the restored request's suffix prefill rewrites its
    row), dense rows, and adapter paging (byte images over ``xwq`` /
    ``xwo`` too, the JAX store's size): tokens, steps and the memory counters equal the
    JAX engine's, and the pool drains pristine."""
    jout, out, jeng, eng = _pair(
        s, {**dict(capacity=4, pf_capacity=2, s_max=96, virtual_time=True),
            **ecfg}, _runtime_reqs, names=("serve", "other"))
    assert len(out) == 8 and out == jout
    for f in ("steps", "preemptions", "kv_swap_outs", "kv_restores",
              "lent_blocks_peak", "max_pf_tokens_step", "adapter_swap_ins",
              "adapter_swap_in_bytes"):
        assert getattr(eng.metrics, f) == getattr(jeng.metrics, f), f
    assert eng.cachemgr.pristine
    if "kv_host_blocks" in ecfg:
        assert eng.kv_tiering and eng.metrics.preemptions > 0
        assert eng.metrics.kv_swap_outs > 0 and eng.metrics.kv_restores > 0
    if "prefill_chunk" in ecfg:
        assert eng.metrics.max_pf_tokens_step <= 16
    if "adapter_paging" in ecfg:     # the byte images hold xwq / xwo too
        assert eng.model.store.adapter_nbytes("serve") \
            == jeng.model.store.adapter_nbytes("serve")


def test_fleet_fetches_nothing_for_sources(s):
    """A 2-replica round-robin fleet with remote fetch over a shared head:
    aux requests are never fetched for (0 blocks), and the tokens and steps
    equal the JAX fleet's and one engine's; every pool drains pristine."""
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
        for r in _shared_reqs(R, s["cfg"], n=6, seed=1):
            f.submit(r)
    jm, fm = jfleet.run(), fleet.run()
    got = {r.rid: list(r.output) for e in fleet.engines for r in e.finished}
    want = {r.rid: list(r.output) for e in jfleet.engines
            for r in e.finished}
    assert len(got) == 6 and got == want
    assert fm.remote_fetch_blocks == jm.remote_fetch_blocks == 0
    assert [e.metrics.steps for e in fleet.engines] \
        == [e.metrics.steps for e in jfleet.engines]
    assert all(e.cachemgr.pristine for e in fleet.engines)
    _, one_store = _stores(s)
    one = _run(UnifiedEngine(MixedLoraModel(s["cfg"], s["params"],
                                            one_store), EngineConfig(**ECFG)),
               _shared_reqs(Request, s["cfg"], n=6, seed=1))
    assert one == got


def test_aux_embed_requests_never_share(tmp):
    """Twin of ``test_hash_dedup.py::test_aux_embed_requests_never_share``
    on the port's engine (the VLM): an aux request has no key chain and no
    resident tokens, and at the manager an unshareable admission neither
    adopts a published run of the same tokens nor publishes its own."""
    s = _setup(VLM, tmp)
    _, store = _stores(s)
    eng = UnifiedEngine(MixedLoraModel(s["cfg"], s["params"], store),
                        EngineConfig(**ECFG))
    p = np.arange(40, dtype=np.int32)
    b = Request(rid=1, prompt=p.copy(), adapter="serve", max_new_tokens=2,
                aux_embed=_req_aux(s["cfg"], 1))
    assert eng._keys_of(b) is None
    assert eng._resident_tokens(b) == 0
    m = eng.cachemgr
    s1, _ = m.try_admit(p, max_new=2)
    m.commit_prefill([(0, s1)], [m._seq_len[s1]])
    assert m.probe(p) == 32
    s2, reused = m.try_admit(p, max_new=2, shareable=False)
    assert reused == 0 and m.shared_count[s2] == 0
    before = m.hash_blocks_resident
    m.commit_prefill([(0, s2)], [len(p)])
    assert m.hash_blocks_resident == before


# ------------------------------------------------------------- the CLIs
def _cli_weights(monkeypatch, arch, tmp, n_adapters=2, r=8):
    """Both CLIs draw their weights from gated JAX params and JAX-drawn
    adapters (the JAX CLI's keys): JAX's ``init_params`` is wrapped to
    open the gates, the port's ``init_params`` and ``load_random`` load
    the bridged copies.  Returns the recorded JAX engines."""
    jcfg = j_get_reduced(arch)
    orig = jschema.init_params
    monkeypatch.setattr(jschema, "init_params",
                        lambda cfg, key, dtype=None: _gated(
                            cfg, orig(cfg, key, dtype)))
    jparams = jschema.init_params(jcfg, jax.random.PRNGKey(0))
    params = to_port_params(jparams, tmp / f"cli_{arch}_p.npz")
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=r),
                           jax.random.PRNGKey(1))
    adapters = {}
    for i in range(n_adapters):
        for name in (f"lora{i}", f"adapter{i}"):
            jstore.load_random(name, jax.random.PRNGKey(100 + i))
            adapters[name] = to_port_bank(jstore.get_adapter(name),
                                          tmp / f"cli_{arch}_{name}.npz")
            jstore.unload(name)
    for mod in (t_serve, t_train):
        monkeypatch.setattr(mod, "init_params",
                            lambda cfg, **kw: params)
    monkeypatch.setattr(
        tvirt.AdapterStore, "load_random",
        lambda self, name, gen, *a, **kw: self.load(name, adapters[name]))
    engines = []
    run = JUnifiedEngine.run

    def recording_run(self, *a, **kw):
        engines.append(self)
        return run(self, *a, **kw)

    monkeypatch.setattr(JUnifiedEngine, "run", recording_run)
    return engines


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_emits_jax_tokens(arch, tmp, monkeypatch, capsys):
    """``launch.serve --reduced --device cpu --arch <id>`` serves every
    request with a source drawn as the JAX CLI draws it, and emits the JAX
    CLI's tokens."""
    jengs = _cli_weights(monkeypatch, arch, tmp)
    argv = ["--arch", arch, "--reduced", "--requests", "6", "--rps", "4",
            "--max-new", "6"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    j_serve.main()
    engines = t_serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "finished=6 " in out
    got = {r.rid: list(r.output) for r in engines[0].finished}
    want = {r.rid: list(r.output) for r in jengs[0].finished}
    assert len(got) == 6 and got == want
    aux = engines[0].finished[0].aux_embed
    assert aux.shape == (_F(get_reduced(arch)), get_reduced(arch).d_model)
    np.testing.assert_array_equal(aux, jengs[0].finished[0].aux_embed)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_emits_jax_losses(arch, tmp, monkeypatch, capsys):
    """``launch.train --reduced --device cpu --arch <id>``: both trainers
    finish with the JAX CLI's per-microbatch losses (1e-4 relative: AdamW
    steps in fp32) and optimizer steps."""
    jengs = _cli_weights(monkeypatch, arch, tmp)
    argv = ["--arch", arch, "--reduced", "--rows", "8", "--epochs", "1",
            "--accum", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    j_train.main()
    eng = t_train.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    assert eng.trainers.keys() == jengs[0].trainers.keys()
    for name, tr in eng.trainers.items():
        jt = jengs[0].trainers[name]
        assert tr.optimizer_steps == jt.optimizer_steps >= 1
        assert tr.aux_embed is not None
        np.testing.assert_allclose(tr.train_losses, jt.train_losses,
                                   rtol=1e-4)
        np.testing.assert_allclose(tr.eval_losses, jt.eval_losses,
                                   rtol=1e-4)
