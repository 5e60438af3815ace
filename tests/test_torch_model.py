"""The port's ``unified_forward`` vs ``repro.models.model.unified_forward`` on
the reduced llama3 (2 layers, d_model 256), fp32 on the CPU, with JAX weights
and two nonzero-B adapters crossed over through the weight bridge.

One paged pool per side is carried through three steps: cold prefill,
paged decode (with an inactive padding row), then one batch holding a
suffix prefill over an adopted prefix block, a cold row in the same
positional bucket, and decode rows.  Each step compares ``pf_logits``,
``dec_logits`` and every written pool block.  Tolerance 2e-4: fp32 on both
sides, summation order differs across two layers and a 512-way head.
"""
import jax
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, PFBatch as JPF, \
    UnifiedBatch as JUB
from repro_torch.configs import get_reduced
from repro_torch.models import model as TM
from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch

TOL = 2e-4
BS, NB, NBT, BT = 8, 24, 6, 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bridge")
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


def _batches(pf=None, dec=None):
    jb, tb = {}, {}
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


def _i32(x):
    return np.asarray(x, np.int32)


def _table(*bids):
    row = np.zeros((NBT,), np.int32)
    row[:len(bids)] = bids
    return row


def _step(s, state, pf=None, dec=None):
    jb, tb = _batches(pf, dec)
    jout = JM.unified_forward(s["jcfg"], s["jparams"], jb, state["j"],
                              loras=s["jbank"], lora_scale=s["jscale"])
    tout = TM.unified_forward(s["cfg"], s["params"], tb, state["t"],
                              loras=s["bank"], lora_scale=s["scale"],
                              block_t=BT)
    state["j"] = jout.cache
    for name in ("pf_logits", "dec_logits"):
        a, b = getattr(tout, name), getattr(jout, name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.isfinite(a).all()
            assert max_err(a, b) < TOL, name
    for kv in ("k", "v"):     # block 0 is the null block: garbage by design
        jpool = np.asarray(jout.cache["layers"][0][kv])[:, 1:]
        assert max_err(tout.cache[kv][:, 1:], jpool) < TOL, kv
    return tout


def test_unified_forward_matches_jax_over_prefill_decode_and_suffix(setup):
    s = setup
    rng = np.random.default_rng(0)
    V = s["cfg"].vocab
    state = {"j": JM.init_paged_cache(s["jcfg"], NB, BS, 4),
             "t": TM.init_paged_cache(s["cfg"], NB, BS, torch.device("cpu"),
                                      torch.float32)}
    p0, p1 = rng.integers(0, V, 13), rng.integers(0, V, 20)
    # 1) cold prefill, adapters 0 and 1 (nonzero B)
    toks = np.zeros((2, 24), np.int32)
    toks[0, :13], toks[1, :20] = p0, p1
    out = _step(s, state, pf=dict(
        tokens=toks, length=_i32([13, 20]), adapter=_i32([0, 1]),
        tables=np.stack([_table(1, 2), _table(3, 4, 5)])))
    nxt = out.pf_logits.argmax(-1).numpy()
    # 2) paged decode, plus an inactive row (pos 0, null table, base only)
    dec = dict(tokens=_i32([nxt[0], nxt[1], 0]), pos=_i32([13, 20, 0]),
               adapter=_i32([0, 1, -1]),
               tables=np.stack([_table(1, 2), _table(3, 4, 5), _table()]))
    out = _step(s, state, dec=dec)
    nxt = out.dec_logits.argmax(-1).numpy()
    # 3) suffix prefill over request 0's first block (adopted, cached 8),
    #    a cold row (cached 0) in the same positional bucket, and decode
    p2 = np.concatenate([p0[:8], rng.integers(0, V, 9)])
    p3 = rng.integers(0, V, 11)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9], toks[1, :11] = p2[8:], p3
    dec = dict(tokens=_i32([nxt[0], nxt[1], 0]), pos=_i32([14, 21, 0]),
               adapter=_i32([0, 1, -1]),
               tables=np.stack([_table(1, 2), _table(3, 4, 5), _table()]))
    _step(s, state, pf=dict(
        tokens=toks, length=_i32([9, 11]), adapter=_i32([0, 1]),
        cached=_i32([8, 0]),
        tables=np.stack([_table(1, 6, 7), _table(8, 9)])), dec=dec)


def test_unified_forward_rejects_unported_buckets(setup):
    """The fine-tune bucket comes with the training slice (verify chunks
    are served since the speculation slice: ``test_torch_spec.py``)."""
    s = setup
    _, tb = _batches(dec=dict(tokens=_i32([[1, 2]]), pos=_i32([0]),
                              adapter=_i32([0]), tables=_table()[None]))
    tb = tb._replace(ft=(torch.zeros((1, 8), dtype=torch.int32),))
    cache = TM.init_paged_cache(s["cfg"], NB, BS, torch.device("cpu"),
                                torch.float32)
    with pytest.raises(NotImplementedError):
        TM.unified_forward(s["cfg"], s["params"], tb, cache, block_t=BT)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planner_matches_jax_and_keeps_smlm_tiles_aligned(seed):
    """The port's prefill/decode planner builds the JAX planner's buckets
    (same padding, tables, positional cached_len) and keeps every SMLM tile
    of the prefill head adapter-uniform at the planner's tile."""
    from repro.core import flow as jflow
    from repro_torch.core import flow as tflow
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6))
    reqs = []
    for i in range(n):
        cached = int(rng.integers(0, 40)) if rng.random() < 0.5 else None
        reqs.append(dict(tokens=rng.integers(0, 512, int(rng.integers(
            1, 70))).astype(np.int32), slot=int(rng.integers(-1, 4)),
            block_table=rng.integers(0, 30, NBT).astype(np.int32),
            cached_len=cached))
    dec = (rng.integers(0, 512, 4), rng.integers(0, 90, 4),
           rng.integers(-1, 4, 4), rng.integers(0, 30, (4, NBT)))
    jb = jflow.assemble([], [jflow.PFReq(**r) for r in reqs], *dec[:3],
                        jflow.FlowConfig(block_t=BT), dec_tables=dec[3])
    tb = tflow.assemble([tflow.PFReq(**r) for r in reqs], *dec[:3],
                        tflow.FlowConfig(block_t=BT), torch.device("cpu"),
                        dec_tables=dec[3])
    for f in ("tokens", "length", "adapter", "block_tables", "cached_len"):
        a, b = getattr(tb.pf, f), getattr(jb.pf, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("tokens", "pos", "adapter", "block_tables"):
        np.testing.assert_array_equal(getattr(tb.dec, f).numpy(),
                                      np.asarray(getattr(jb.dec, f)))
    np.testing.assert_array_equal(tflow.token_adapter_ids(tb),
                                  jflow.token_adapter_ids(jb))
    assert tflow.smlm_tile_aligned(tb, BT)
