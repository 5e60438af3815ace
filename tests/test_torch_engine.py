"""The port's engine vs the JAX engine under the virtual clock, on the
reduced llama3 in fp32 on the CPU: the same weights (through the bridge),
the same adapter and the same trace must give identical greedy tokens per
request, SLO attainment 1.0, and pools that drain pristine.

Traces: the one of ``tests/test_runtime.py::test_engine_serves_all_requests_
with_slo``, and a shared-prefix trace whose later requests adopt resident
prefix blocks, so suffix prefill (with cold rows in the same bucket) and
decode over adopted blocks both run."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core import flow as jflow
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.data import datasets, workload
from repro.models.schema import init_params as j_init_params
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro_torch.configs import get_reduced
from repro_torch.core import flow as tflow
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request
from repro_torch.serving.slo import SLOConfig, slo_attainment

ADAPTERS = ("serve", "other")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, port model) sharing weights and adapters."""
    tmp = tmp_path_factory.mktemp("bridge")
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=4),
                           jax.random.PRNGKey(1))
    cfg = get_reduced("llama3-8b")
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=4), device="cpu")
    for i, name in enumerate(ADAPTERS):
        jstore.load_random(name, jax.random.PRNGKey(2 + i))
        adapter = to_port_bank(jstore.get_adapter(name), tmp / f"{name}.npz")
        store.load(name, adapter)
    params = to_port_params(jparams, tmp / "params.npz")
    return jcfg, jparams, jstore, cfg, params, store


def _run(pair, trace, **ecfg):
    jcfg, jparams, jstore, cfg, params, store = pair
    kw = dict(capacity=4, pf_capacity=2, s_max=96, virtual_time=True, **ecfg)
    jeng = JUnifiedEngine(JMixedLoraModel(jcfg, jparams, jstore),
                          JEngineConfig(**kw))
    eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                        EngineConfig(**kw))
    for rid, prompt, adapter, max_new, arrival in trace:
        jeng.submit(JRequest(rid=rid, prompt=prompt, adapter=adapter,
                             max_new_tokens=max_new, arrival=arrival))
        eng.submit(Request(rid=rid, prompt=prompt, adapter=adapter,
                           max_new_tokens=max_new, arrival=arrival))
    jeng.run(max_ticks=10000)
    eng.run(max_ticks=10000)
    return jeng, eng


def _check(jeng, eng, n, max_new):
    assert len(eng.finished) == n == len(jeng.finished)
    jout = {r.rid: list(r.output) for r in jeng.finished}
    out = {r.rid: list(r.output) for r in eng.finished}
    assert out == jout
    assert all(len(v) == max_new for v in out.values())
    assert slo_attainment(eng.finished, SLOConfig()) == 1.0
    assert eng.cachemgr.pristine and jeng.cachemgr.pristine
    assert eng.metrics.steps == jeng.metrics.steps


def test_engine_matches_jax_on_runtime_trace(pair):
    cfg = pair[3]
    prompts = datasets.sharegpt_prompts(8, vocab=cfg.vocab, len_lo=6,
                                        len_hi=20)
    arr = workload.poisson_arrivals(2.0, 8, seed=1)
    trace = [(i, p, "serve", 6, float(a))
             for i, (p, a) in enumerate(zip(prompts, arr))]
    jeng, eng = _run(pair, trace)
    _check(jeng, eng, 8, 6)


@pytest.mark.parametrize("prefill_chunk", [0, 24])
def test_engine_matches_jax_on_shared_prefix_trace(pair, prefill_chunk):
    """Two 64-token heads (one per adapter); later requests reuse them with
    new tails, so their prefill rows carry cached_len and adopt blocks.
    With a per-tick prefill budget, long prompts prefill in chunks that
    resume through cached_len."""
    cfg = pair[3]
    rng = np.random.default_rng(5)
    heads = [rng.integers(0, cfg.vocab, 64).astype(np.int32)
             for _ in ADAPTERS]
    trace = []
    for i in range(8):
        k = i % 2
        tail = rng.integers(0, cfg.vocab, 5 + 3 * i).astype(np.int32)
        trace.append((i, np.concatenate([heads[k], tail]), ADAPTERS[k], 5,
                      0.0 if i < 2 else 0.4 + 0.1 * i))
    jeng, eng = _run(pair, trace, prefill_chunk=prefill_chunk)
    _check(jeng, eng, 8, 5)
    assert eng.metrics.reused_prefix_tokens > 0
    assert eng.metrics.reused_prefix_tokens \
        == jeng.metrics.reused_prefix_tokens
    assert eng.metrics.hash_hits == jeng.metrics.hash_hits


def test_default_planner_pads_like_jax():
    """Both engines' default flow configs are the same, and their planners
    pad every prefill length to the same bucket shape (the SMLM tile and
    the padding rows it implies are part of what the parity tests hold)."""
    jf, tf = JEngineConfig().flow, EngineConfig().flow
    assert dataclasses.asdict(tf) == dataclasses.asdict(jf)
    for n in range(1, 130):
        toks = np.arange(n, dtype=np.int32)
        jpf = jflow.plan_pf([jflow.PFReq(tokens=toks, slot=0)] * 3, jf)
        tpf = tflow.plan_pf([tflow.PFReq(tokens=toks, slot=0)] * 3, tf,
                            torch.device("cpu"))
        assert tuple(tpf.tokens.shape) == tuple(jpf.tokens.shape), n


def test_engine_raises_for_later_slices(pair):
    cfg, params, store = pair[3:]
    model = MixedLoraModel(cfg, params, store)
    for kw in (dict(kv_host_blocks=4),
               dict(adapter_paging=True), dict(over_admit=2.0)):
        with pytest.raises(NotImplementedError):
            UnifiedEngine(model, EngineConfig(**kw))
    with pytest.raises(NotImplementedError):
        UnifiedEngine(model, EngineConfig()).add_trainer(None)
