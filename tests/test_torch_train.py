"""The port's fine-tuning path against the JAX package, on the reduced
llama3 (2 layers, d_model 256) in fp32 on the CPU.  Weights and adapters
are made in JAX and cross over through the bridge; other inputs are made
from numpy seeds and handed to both packages.

* ``SMLMFunction`` (its plain path: the wrappers take the plain versions
  for CPU tensors) against ``jax.grad`` of ``repro.core.lora.lora_apply_ref``
  with respect to x, a and b;
* ``unified_forward`` with ft + pf + dec buckets on the paged layout: the
  per-row losses, token counts, ft logits and pf/dec logits;
* ``make_grad_step`` grads, ft-only and mixed, and the masked AdamW with a
  clip shared by two slots;
* torch twins of the JAX package's training tests (``test_runtime.py``,
  ``test_lora_unified.py::test_grad_only_on_ft_rows``);
* the engine's trace against the JAX engine's on one virtual-clock run;
  serve-only and mixed ticks in turns; ``launch/train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyputil import given, hyp as _hyp, settings, st

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.checkpoint.io import save_pytree
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig, \
    lora_apply_ref as j_lora_apply_ref
from repro.core.unified import make_grad_step as j_make_grad_step
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel
from repro.data import datasets
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.serving.engine import EngineConfig as JEngineConfig, \
    UnifiedEngine as JUnifiedEngine
from repro.serving.request import Request as JRequest
from repro.training import optimizer as jopt
from repro.training.trainer import MixedLoraTrainer as JTrainer, \
    TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.io import bank_from_numpy, load_npz
from repro_torch.configs import get_reduced
from repro_torch.core import flow
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.unified import make_grad_step
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.kernels import ref
from repro_torch.kernels.smlm import SMLMFunction, smlm, smlm_wgrad
from repro_torch.launch import train as train_cli
from repro_torch.models import model as TM
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request
from repro_torch.training import optimizer as topt
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig

CPU = torch.device("cpu")
BT, BS, NB, NBT = 8, 8, 24, 6
TOL = 5e-4          # fp32 both sides, summation order differs (2 layers)
LCFG = dict(n_slots=4, r=4)


# ------------------------------------------------------------ SMLM gradient
def _smlm_case(seed, T=48, d_in=24, d_out=40, n=4, r=4, bt=BT):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    a = (rng.standard_normal((n, d_in, r)) / d_in ** 0.5).astype(np.float32)
    b = (rng.standard_normal((n, r, d_out)) * 0.3).astype(np.float32)
    tiles = np.array([0, 2, -1, 1, 2, 0][:T // bt], np.int32)
    slot_scale = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
    ids = np.repeat(tiles, bt)
    scale_t = np.where(ids >= 0, slot_scale[np.clip(ids, 0, n - 1)], 0.0
                       ).astype(np.float32)
    g = rng.standard_normal((T, d_out)).astype(np.float32)
    return x, a, b, ids, scale_t, g


@pytest.mark.parametrize("n_ft", [48, 24])
def test_smlm_function_grad_matches_jax_grad(n_ft):
    """SMLMFunction's dX, dA, dB against ``jax.grad`` of the JAX oracle, on
    mixed adapters with a base-only (-1) tile and per-slot scales.  Only the
    first ``n_ft`` tokens carry gradient: the cotangent of the rest is 0,
    as it is for prefill rows in the model.  fp32, 1e-5 of each leaf's
    max."""
    x, a, b, ids, scale_t, g = _smlm_case(0)
    g[n_ft:] = 0.0

    def f(xx, aa, bb):
        return jnp.sum(j_lora_apply_ref(xx, aa, bb, j(ids), j(scale_t))
                       * j(g))

    jg = jax.grad(f, argnums=(0, 1, 2))(j(x), j(a), j(b))
    tx, ta, tb = (t(v).requires_grad_() for v in (x, a, b))
    tile_ids = t(np.clip(ids[::BT], 0, 3))
    tile_scale = t(scale_t[::BT])
    y = SMLMFunction.apply(tx, ta, tb, tile_ids, tile_scale, BT, n_ft)
    y_ref = ref.smlm_ref(t(x), t(a), t(b), tile_ids, tile_scale, BT)
    assert max_err(y.detach(), y_ref) == 0.0
    (y * t(g)).sum().backward()
    for got, want in zip((tx.grad, ta.grad, tb.grad), jg):
        want = np.asarray(want)
        assert max_err(got, want) <= 1e-5 * np.abs(want).max()


def test_smlm_wgrad_plain_matches_autograd_and_packs_shrinks():
    """``smlm_wgrad`` (plain path, packed shrinks) against autograd of the
    plain SMLM, and the shrink buffer's pack/unpack round trip, at a tile
    that is not a multiple of 8 tokens."""
    bt = 12
    x, a, b, ids, scale_t, g = _smlm_case(1, T=48, bt=bt)
    tile_ids = t(np.clip(ids[::bt], 0, 3))
    tile_scale = t(scale_t[::bt])
    s = ref.smlm_shrink_ref(t(x), t(a), tile_ids, tile_scale, bt)
    buf = ref.pack_shrink(s, bt)
    assert torch.equal(ref.unpack_shrink(buf, 48, 4, bt), s)
    _, kept = smlm(t(x), t(a), t(b), tile_ids, tile_scale, block_t=bt,
                   keep_shrink=True)
    assert torch.equal(kept, buf)
    gs = ref.smlm_shrink_ref(t(g), t(b).transpose(1, 2), tile_ids,
                             tile_scale, bt)
    da, db = smlm_wgrad(t(x), t(g), buf, ref.pack_shrink(gs, bt), tile_ids,
                        tile_scale, r=4, block_t=bt, n_slots=4)
    ta, tb = t(a).requires_grad_(), t(b).requires_grad_()
    (ref.smlm_ref(t(x), ta, tb, tile_ids, tile_scale, bt) * t(g)
     ).sum().backward()
    assert max_err(da, ta.grad) <= 1e-5 * float(ta.grad.abs().max())
    assert max_err(db, tb.grad) <= 1e-5 * float(tb.grad.abs().max())
    assert float(da[3].abs().max()) == 0.0      # slot 3: no tile


@pytest.mark.parametrize("n_ft", [48, 24])
def test_smlm_function_dx_in_place_matches_plain(n_ft):
    """SMLMFunction's dX, written into the fine-tune rows of one [T, d_in]
    result (``smlm(..., out=)``) with the rows after them zeroed, against
    autograd through the plain SMLM with the same cotangent (0 after
    ``n_ft``), for n_ft == T and n_ft < T; dA and dB beside it.  ``smlm``'s
    ``out`` receives the result and is what it returns."""
    x, a, b, ids, scale_t, g = _smlm_case(2)
    g[n_ft:] = 0.0
    tile_ids, tile_scale = t(np.clip(ids[::BT], 0, 3)), t(scale_t[::BT])
    got = [t(v).requires_grad_() for v in (x, a, b)]
    want = [t(v).requires_grad_() for v in (x, a, b)]
    (SMLMFunction.apply(*got, tile_ids, tile_scale, BT, n_ft) * t(g)
     ).sum().backward()
    (ref.smlm_ref(*want, tile_ids, tile_scale, BT) * t(g)).sum().backward()
    for k, p in zip(got, want):
        assert max_err(k.grad, p.grad) <= 1e-5 * float(p.grad.abs().max())
    assert int(torch.count_nonzero(got[0].grad[n_ft:])) == 0
    buf = torch.full((x.shape[0], b.shape[-1]), float("nan"))
    y = smlm(t(x), t(a), t(b), tile_ids, tile_scale, block_t=BT, out=buf)
    assert y.data_ptr() == buf.data_ptr()
    assert torch.equal(y, ref.smlm_ref(t(x), t(a), t(b), tile_ids,
                                       tile_scale, BT))


# ------------------------------------------------------------ model buckets
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bridge")
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    jstore.load_random("a0", jax.random.PRNGKey(2))
    jstore.load_random("a1", jax.random.PRNGKey(3))
    return dict(jcfg=jcfg, jparams=jparams, jbank=jstore.bank,
                jscale=jstore.scale, cfg=get_reduced("llama3-8b"),
                params=to_port_params(jparams, tmp / "params.npz"),
                bank=to_port_bank(jstore.bank, tmp / "bank.npz"),
                scale=t(np.asarray(jstore.scale)), tmp=tmp)


def _i32(x):
    return np.asarray(x, np.int32)


def _table(*bids):
    row = np.zeros((NBT,), np.int32)
    row[:len(bids)] = bids
    return row


def _ft_rows(rng, V, lens=(13, 21, 6), adapters=(0, 1, -1), Sf=24):
    toks = np.zeros((len(lens), Sf), np.int32)
    mask = np.zeros((len(lens), Sf), bool)
    labels = np.full((len(lens), Sf), -100, np.int32)
    for i, L in enumerate(lens):
        toks[i, :L] = rng.integers(0, V, L)
        mask[i, :L] = True
        labels[i, :L] = toks[i, :L]
        labels[i, 2] = -100                    # an ignored target
    return dict(tokens=toks, mask=mask, labels=labels,
                adapter=_i32(adapters),
                weight=np.array([0.5, 1.0, 0.0], np.float32)[:len(lens)])


def _batches(ft=None, pf=None, dec=None):
    jb, tb = {}, {}
    if ft is not None:
        jb["ft"] = JFT(**{k: j(v) for k, v in ft.items()})
        tb["ft"] = FTBatch(**{k: t(v) for k, v in ft.items()})
    if pf is not None:
        jb["pf"] = JPF(tokens=j(pf["tokens"]), length=j(pf["length"]),
                       adapter=j(pf["adapter"]),
                       block_tables=j(pf["tables"]))
        tb["pf"] = PFBatch(tokens=t(pf["tokens"]), length=t(pf["length"]),
                           adapter=t(pf["adapter"]),
                           block_tables=t(pf["tables"]))
    if dec is not None:
        jb["dec"] = JDEC(tokens=j(dec["tokens"]), pos=j(dec["pos"]),
                         adapter=j(dec["adapter"]),
                         block_tables=j(dec["tables"]))
        tb["dec"] = DECBatch(tokens=t(dec["tokens"]), pos=t(dec["pos"]),
                             adapter=t(dec["adapter"]),
                             block_tables=t(dec["tables"]))
    return JUB(**jb), UnifiedBatch(**tb)


def _mixed(s, rng):
    """ft rows (adapters 0, 1 and a base-only row), a cold prefill bucket
    and a decode bucket over blocks the prefill already wrote."""
    V = s["cfg"].vocab
    ft = _ft_rows(rng, V)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :11], toks[1, :16] = rng.integers(0, V, 11), \
        rng.integers(0, V, 16)
    pf = dict(tokens=toks, length=_i32([11, 16]), adapter=_i32([1, 0]),
              tables=np.stack([_table(1, 2), _table(3, 4)]))
    dec = dict(tokens=_i32(rng.integers(0, V, 2)), pos=_i32([9, 4]),
               adapter=_i32([0, 1]),
               tables=np.stack([_table(5, 6), _table(7)]))
    return ft, pf, dec


def _caches(s):
    return (JM.init_paged_cache(s["jcfg"], NB, BS, 4),
            TM.init_paged_cache(s["cfg"], NB, BS, CPU, torch.float32))


def test_unified_forward_ft_pf_dec_matches_jax(setup):
    s = setup
    ft, pf, dec = _mixed(s, np.random.default_rng(0))
    jb, tb = _batches(ft, pf, dec)
    jcache, tcache = _caches(s)
    jout = JM.unified_forward(s["jcfg"], s["jparams"], jb, jcache,
                              loras=s["jbank"], lora_scale=s["jscale"],
                              return_ft_logits=True)
    with torch.no_grad():
        tout = TM.unified_forward(s["cfg"], s["params"], tb, tcache,
                                  loras=s["bank"], lora_scale=s["scale"],
                                  block_t=BT, return_ft_logits=True)
    for name in ("ft_loss_sum", "ft_tok_count", "ft_logits", "pf_logits",
                 "dec_logits"):
        a, b = getattr(tout, name), np.asarray(getattr(jout, name))
        assert a is not None and torch.isfinite(a).all()
        assert max_err(a, b) < TOL * max(1.0, np.abs(b).max()), name
    np.testing.assert_array_equal(tout.ft_tok_count.numpy(),
                                  [11.0, 19.0, 4.0])
    for kv in ("k", "v"):     # the ft bucket writes no cache
        jpool = np.asarray(jout.cache["layers"][0][kv])[:, 1:]
        assert max_err(tcache[kv][:, 1:], jpool) < TOL, kv


def _port_grads(jgrads, path):
    save_pytree(str(path), jgrads)
    return bank_from_numpy(load_npz(str(path)), device="cpu")


def _assert_tree_close(got, want, rel):
    for lg, lw in zip(got["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            for ab in ("a", "b"):
                g, w = lg[name][ab], lw[name][ab]
                assert g.shape == w.shape
                lim = rel * max(float(w.abs().max()), 1e-12)
                assert max_err(g, w) <= lim, (name, ab)


@pytest.mark.parametrize("buckets", ["ft_only", "mixed"])
def test_grad_step_matches_jax(setup, buckets):
    """The port's grad step against ``repro.core.unified.make_grad_step`` on
    the same batch: loss within TOL, every grad leaf within 2e-4 of the
    leaf's max, zeros in the slots no row uses (2 and 3)."""
    s = setup
    ft, pf, dec = _mixed(s, np.random.default_rng(1))
    if buckets == "ft_only":
        pf = dec = None
    jb, tb = _batches(ft, pf, dec)
    jcache, tcache = _caches(s) if pf is not None else (None, None)
    jres = j_make_grad_step(s["jcfg"])(s["jparams"], s["jbank"],
                                       s["jscale"], jb, jcache)
    tres = make_grad_step(s["cfg"], block_t=BT)(s["params"], s["bank"],
                                                s["scale"], tb, tcache)
    assert abs(float(tres.loss) - float(jres.loss)) < TOL
    want = _port_grads(jres.grads, s["tmp"] / f"g_{buckets}.npz")
    _assert_tree_close(tres.grads, want, 2e-4)
    for layer in tres.grads["layers"]:
        for ab in layer.values():
            assert float(ab["a"][2:].abs().max()) == 0.0
            assert float(ab["b"][2:].abs().max()) == 0.0
            assert not ab["a"].requires_grad
    assert tres.out.pf_logits is None or not tres.out.pf_logits.requires_grad


def test_grad_only_on_ft_rows(setup):
    """Inference rows contribute nothing to the LoRA gradient: grads with and
    without pf/dec buckets are identical (twin of the JAX test of this
    name, with the port's detached serving rows in place of XLA's
    pruning)."""
    s = setup
    ft, pf, dec = _mixed(s, np.random.default_rng(2))
    step = make_grad_step(s["cfg"], block_t=BT)
    g1 = step(s["params"], s["bank"], s["scale"], _batches(ft)[1], None)
    g2 = step(s["params"], s["bank"], s["scale"], _batches(ft, pf, dec)[1],
              _caches(s)[1])
    _assert_tree_close(g2.grads, g1.grads, 5e-4)
    assert abs(float(g1.loss) - float(g2.loss)) < 5e-4


# ----------------------------------------------------------------- planner
@_hyp(lambda: [settings(max_examples=30, deadline=None),
               given(lens=st.lists(st.integers(1, 60), min_size=1,
                                   max_size=9),
                     block_t=st.sampled_from([4, 8, 16]),
                     seed=st.integers(0, 99))])
def test_flow_planner_alignment_property(lens, block_t, seed):
    """Twin of the JAX property: the port's planner keeps every SMLM tile of
    the ft+pf head adapter-uniform, pads inertly, keeps the payload, and
    builds the JAX planner's ft bucket."""
    from repro.core import flow as jflow
    rng = np.random.default_rng(seed)
    fcfg = flow.FlowConfig(block_t=block_t)
    rows = [flow.FTRow(tokens=rng.integers(0, 50, L),
                       labels=rng.integers(0, 50, L),
                       slot=int(rng.integers(-1, 4)),
                       is_eval=bool(rng.random() < 0.2))
            for L in lens]
    pfs = [flow.PFReq(tokens=rng.integers(0, 50, L),
                      slot=int(rng.integers(-1, 4))) for L in lens[:3]]
    batch = flow.assemble(rows, pfs, np.array([1, 2]), np.array([0, 5]),
                          np.array([0, -1]), fcfg, CPU)
    assert flow.smlm_tile_aligned(batch, block_t)
    Bf = batch.ft.tokens.shape[0]
    for i in range(len(rows), Bf):
        assert float(batch.ft.weight[i]) == 0.0
        assert int(batch.ft.adapter[i]) == -1
    for i, r in enumerate(rows):
        L = len(r.tokens)
        np.testing.assert_array_equal(batch.ft.tokens[i, :L].numpy(),
                                      r.tokens)
        assert bool(batch.ft.mask[i, :L].all())
        assert not bool(batch.ft.mask[i, L:].any())
    jrows = [jflow.FTRow(tokens=r.tokens, labels=r.labels, slot=r.slot,
                         is_eval=r.is_eval) for r in rows]
    jb = jflow.assemble(jrows, [jflow.PFReq(tokens=p.tokens, slot=p.slot)
                                for p in pfs],
                        np.array([1, 2]), np.array([0, 5]),
                        np.array([0, -1]), jflow.FlowConfig(block_t=block_t))
    for f in ("tokens", "mask", "labels", "adapter", "weight"):
        np.testing.assert_array_equal(getattr(batch.ft, f).numpy(),
                                      np.asarray(getattr(jb.ft, f)))
    np.testing.assert_array_equal(flow.token_adapter_ids(batch),
                                  jflow.token_adapter_ids(jb))


# --------------------------------------------------------------- optimizer
def test_masked_adamw_isolation_and_correctness():
    rng = np.random.default_rng(0)
    params = {"w": {"a": t(rng.standard_normal((2, 3, 8, 4)
                                               ).astype(np.float32))}}
    grads = topt.tree_map(torch.ones_like, params)
    state = topt.adamw_init(params, 3)
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip=0.0)
    mask = torch.tensor([1.0, 0.0, 1.0])
    new_p, new_s = topt.adamw_apply(cfg, grads, state, params, mask)
    dp = (new_p["w"]["a"] - params["w"]["a"]).numpy()
    assert np.abs(dp[:, 1]).max() == 0.0          # masked slot frozen
    np.testing.assert_allclose(np.abs(dp[:, 0]), 0.1, rtol=1e-3)
    assert new_s.t.tolist() == [1, 0, 1]


@_hyp(lambda: [settings(max_examples=15, deadline=None),
               given(seed=st.integers(0, 100))])
def test_adamw_sequential_masks_commute(seed):
    """Updating slot A then slot B == updating both at once, when gradients
    are identical (per-slot moments are independent)."""
    rng = np.random.default_rng(seed)
    params = {"a": t(rng.standard_normal((4, 6, 2)).astype(np.float32))}
    grads = {"a": t(rng.standard_normal((4, 6, 2)).astype(np.float32))}
    cfg = topt.AdamWConfig(lr=0.01, grad_clip=0.0)
    s0 = topt.adamw_init(params, 4)
    pA, sA = topt.adamw_apply(cfg, grads, s0, params,
                              torch.tensor([1., 0, 0, 0]))
    pAB, _ = topt.adamw_apply(cfg, grads, sA, pA,
                              torch.tensor([0., 1, 0, 0]))
    pBoth, _ = topt.adamw_apply(cfg, grads, s0, params,
                                torch.tensor([1., 1, 0, 0]))
    np.testing.assert_allclose(pAB["a"].numpy(), pBoth["a"].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask", [[1, 0, 0, 0], [0, 1, 1, 0]])
def test_adamw_matches_jax_with_a_clip_shared_by_slots(mask):
    """Two steps of the port's AdamW against ``repro.training.optimizer`` on
    gradients large enough to clip: the norm is taken over every slot's
    gradient (trainers accumulated together share one clip), so a port
    that clipped per slot would differ.  fp32, 1e-6 absolute."""
    rng = np.random.default_rng(3)
    shapes = {"x": (4, 6, 3), "y": (4, 3, 5)}
    p = {k: rng.standard_normal(v).astype(np.float32)
         for k, v in shapes.items()}
    gs = [{k: (rng.standard_normal(v) * 3).astype(np.float32)
           for k, v in shapes.items()} for _ in range(2)]
    cfg = dict(lr=0.01, weight_decay=0.01, grad_clip=1.0)
    m = np.asarray(mask, np.float32)
    jp, tp = {k: j(v) for k, v in p.items()}, {k: t(v) for k, v in p.items()}
    js, ts = jopt.adamw_init(jp, 4), topt.adamw_init(tp, 4)
    for g in gs:
        jp, js = jopt.adamw_apply(jopt.AdamWConfig(**cfg),
                                  {k: j(v) for k, v in g.items()}, js, jp,
                                  j(m))
        tp, ts = topt.adamw_apply(topt.AdamWConfig(**cfg),
                                  {k: t(v) for k, v in g.items()}, ts, tp,
                                  t(m))
    for k in shapes:
        assert max_err(tp[k], jp[k]) < 1e-6
        assert max_err(ts.m[k], js.m[k]) < 1e-6
    assert ts.t.tolist() == np.asarray(js.t).tolist()


def test_trainer_interruptibility():
    """A trainer given zero budget for arbitrarily many ticks resumes exactly
    where it stopped (cursor/accumulation preserved)."""
    rows = datasets.alpaca_like(8, vocab=64, seed=0)
    tr = MixedLoraTrainer("t", 0, rows, [],
                          TrainerConfig(rows_per_micro=2, accum_steps=2,
                                        epochs=1, eval_each_epoch=False))
    got = tr.next_rows(2)
    assert len(got) == 2 and tr.cursor == 2
    assert all(isinstance(r, flow.FTRow) for r in got)
    for _ in range(50):
        assert tr.next_rows(0) == []                 # interrupted
    assert tr.cursor == 2
    tr.record(got, [1.0, 1.0], [10, 10])
    got2 = tr.next_rows(2)
    np.testing.assert_array_equal(got2[0].tokens, rows[2][0])


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX and port models sharing weights and the serve/tr0/tr1 adapters,
    made as ``tests/test_runtime.py::_mk_engine`` makes them."""
    tmp = tmp_path_factory.mktemp("engine")
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_reduced("llama3-8b")
    params = to_port_params(jparams, tmp / "params.npz")
    names = {"serve": 2, "tr0": 10, "tr1": 11}

    def make(lr=None, **extra):
        jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG),
                               jax.random.PRNGKey(1))
        store = AdapterStore(cfg, LoRAConfig(**LCFG), device="cpu")
        for name, seed in names.items():
            jstore.load_random(name, jax.random.PRNGKey(seed))
            store.load(name, to_port_bank(jstore.get_adapter(name),
                                          tmp / f"{name}.npz"))
        ecfg = dict(capacity=4, pf_capacity=2, s_max=96, virtual_time=True,
                    **extra)
        jeng = JUnifiedEngine(JMixedLoraModel(jcfg, jparams, jstore),
                              JEngineConfig(**ecfg, **(
                                  {} if lr is None
                                  else {"opt": jopt.AdamWConfig(lr=lr)})))
        eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                            EngineConfig(**ecfg, **(
                                {} if lr is None
                                else {"opt": topt.AdamWConfig(lr=lr)})))
        return jeng, eng

    return cfg, make, tmp


def _add_trainers(eng, vocab, jeng=None):
    """The trainers of ``test_runtime.py::_mk_engine`` on the port's engine
    (and the JAX engine's, if given)."""
    for i in range(2):
        name = f"tr{i}"
        rows, ev = datasets.split_eval(
            datasets.alpaca_like(16, vocab=vocab, seed=i))
        kw = dict(rows_per_micro=2, accum_steps=2, epochs=1)
        eng.add_trainer(MixedLoraTrainer(name, eng.model.store.slot_of(name),
                                         rows, ev, TrainerConfig(**kw)))
        if jeng is not None:
            jeng.add_trainer(JTrainer(name, jeng.model.store.slot_of(name),
                                      rows, ev, JTrainerConfig(**kw)))


def _submit(eng, cls, prompts, max_new=4):
    for i, p in enumerate(prompts):
        eng.submit(cls(rid=i, prompt=p, adapter="serve",
                       max_new_tokens=max_new, arrival=0.3 * i))


def test_engine_unified_trains_and_serves(engines):
    """Twin of the JAX engine test: two trainers and four served requests
    in one run; every request finishes, both trainers finish with at least
    one optimizer step."""
    cfg, make, _ = engines
    _, eng = make()
    _add_trainers(eng, cfg.vocab)
    _submit(eng, Request, datasets.sharegpt_prompts(
        4, vocab=cfg.vocab, len_lo=6, len_hi=16))
    m = eng.run(max_ticks=20000)
    assert len(eng.finished) == 4
    for tr in eng.trainers.values():
        assert not tr.pending()
        assert tr.optimizer_steps >= 1
        assert tr.tokens_trained > 0
    assert m.finetune_tokens > 0 and m.decode_tokens > 0
    assert m.eval_tokens > 0


def _bank_flat(store, slots, bank=None):
    """The ``slots`` of every leaf of ``bank`` (default: the store's), in
    the store's target order."""
    bank = store.bank if bank is None else bank
    return torch.cat([layer[name][k][slots].reshape(-1)
                      for layer, targets in zip(bank["layers"],
                                                store.layer_targets)
                      for name in targets for k in ("a", "b")])


def test_engine_trace_matches_jax(engines):
    """The same virtual-clock run of two trainers and four served requests
    through both engines: served tokens equal, per-row losses within 1e-4
    relative, optimizer steps and tokens equal, and the trained slots
    within 2 * lr * steps + 1e-6 per element (an AdamW step moves an
    element by at most lr, so a near-zero gradient whose sign differs moves
    it by at most 2 lr; here lr = 1e-3 so the slots move visibly), with
    all but a few elements within 1e-6 of JAX's and the other slots
    untouched."""
    cfg, make, tmp = engines
    lr = 1e-3
    jeng, eng = make(lr=lr)
    before = tree_clone(eng.model.store.bank)
    _add_trainers(eng, cfg.vocab, jeng)
    prompts = datasets.sharegpt_prompts(4, vocab=cfg.vocab, len_lo=6,
                                        len_hi=16)
    _submit(jeng, JRequest, prompts)
    _submit(eng, Request, prompts)
    jm, m = jeng.run(max_ticks=20000), eng.run(max_ticks=20000)
    assert {r.rid: list(r.output) for r in eng.finished} \
        == {r.rid: list(r.output) for r in jeng.finished}
    assert m.steps == jm.steps and m.finetune_tokens == jm.finetune_tokens
    assert m.eval_tokens == jm.eval_tokens
    steps = 0
    for name, tr in eng.trainers.items():
        jtr = jeng.trainers[name]
        assert tr.optimizer_steps == jtr.optimizer_steps >= 1
        steps = max(steps, tr.optimizer_steps)
        for got, want in ((tr.train_losses, jtr.train_losses),
                          (tr.eval_losses, jtr.eval_losses)):
            assert len(got) == len(want) > 0
            np.testing.assert_allclose(got, want, rtol=1e-4)
    jbank = to_port_bank(jeng.model.store.bank, tmp / "jbank_after.npz")
    st = eng.model.store
    trained = [st.slot_of("tr0"), st.slot_of("tr1")]
    got = _bank_flat(st, trained)
    diff = (got - _bank_flat(st, trained, jbank)).abs()
    assert float(diff.max()) <= 2 * lr * steps + 1e-6
    assert float((diff > 1e-6).float().mean()) < 1e-3
    assert float((got - _bank_flat(st, trained, before)).abs().max()) \
        > 0.5 * lr
    frozen = [st.slot_of("serve"), 3]
    assert torch.equal(_bank_flat(st, frozen),
                       _bank_flat(st, frozen, before))


def test_engine_trains_with_attn_chunk_like_jax(engines):
    """Two trainers and four served requests with ``attn_chunk=16``: the
    ft attention takes the chunked online softmax (query blocks recomputed
    in the backward).  Served tokens, steps and optimizer steps equal the
    JAX engine's at the same chunk, per-row losses within 1e-4
    relative."""
    cfg, make, _ = engines
    jeng, eng = make(lr=1e-3, attn_chunk=16)
    _add_trainers(eng, cfg.vocab, jeng)
    prompts = datasets.sharegpt_prompts(4, vocab=cfg.vocab, len_lo=6,
                                        len_hi=16)
    _submit(jeng, JRequest, prompts)
    _submit(eng, Request, prompts)
    jm, m = jeng.run(max_ticks=20000), eng.run(max_ticks=20000)
    assert {r.rid: list(r.output) for r in eng.finished} \
        == {r.rid: list(r.output) for r in jeng.finished}
    assert m.steps == jm.steps and m.finetune_tokens == jm.finetune_tokens
    for name, tr in eng.trainers.items():
        jtr = jeng.trainers[name]
        assert tr.optimizer_steps == jtr.optimizer_steps >= 1
        for got, want in ((tr.train_losses, jtr.train_losses),
                          (tr.eval_losses, jtr.eval_losses)):
            assert len(got) == len(want) > 0
            np.testing.assert_allclose(got, want, rtol=1e-4)


def tree_clone(bank):
    return topt.tree_map(torch.clone, bank)


def test_serve_only_and_mixed_ticks_in_turns(engines):
    """Serve-only ticks (the inference-mode forward step), then mixed ticks
    (grad step and optimizer applies), then serve-only again, on one
    engine: no tensor made under inference mode reaches a grad step, the
    served tokens equal a serve-only engine's, the trained slot moves and
    the others keep their bits."""
    cfg, make, _ = engines
    prompts = datasets.sharegpt_prompts(3, vocab=cfg.vocab, len_lo=6,
                                        len_hi=12, seed=5)
    _, ref_eng = make()
    _submit(ref_eng, Request, prompts, max_new=24)
    ref_eng.run(max_ticks=1000)
    _, eng = make()
    st = eng.model.store
    before = tree_clone(st.bank)
    _submit(eng, Request, prompts, max_new=24)
    kinds = []

    def tick():
        f0, d0 = eng.metrics.finetune_tokens, eng.metrics.decode_tokens
        eng.tick()
        kinds.append((eng.metrics.finetune_tokens > f0,
                      eng.metrics.decode_tokens > d0))

    for _ in range(4):
        tick()
    rows = datasets.alpaca_like(4, vocab=cfg.vocab, seed=7, len_lo=8,
                                len_hi=20)
    eng.add_trainer(MixedLoraTrainer(
        "tr0", st.slot_of("tr0"), rows, [],
        TrainerConfig(rows_per_micro=2, accum_steps=1, epochs=1,
                      eval_each_epoch=False)))
    while eng.trainers_pending():
        tick()
    while eng.waiting or eng.active or eng.prefilling or eng.future:
        tick()
    assert kinds[:4] == [(False, k[1]) for k in kinds[:4]]
    assert any(f and d for f, d in kinds)            # mixed ticks ran
    assert kinds[-1] == (False, True)                # serve-only after
    assert eng.trainers["tr0"].optimizer_steps == 2
    assert {r.rid: r.output for r in eng.finished} \
        == {r.rid: r.output for r in ref_eng.finished}
    tr_slot = [st.slot_of("tr0")]
    assert not torch.equal(_bank_flat(st, tr_slot),
                           _bank_flat(st, tr_slot, before))
    others = [i for i in range(4) if i != tr_slot[0]]
    assert torch.equal(_bank_flat(st, others),
                       _bank_flat(st, others, before))


def test_train_cli_runs_on_cpu(capsys):
    eng = train_cli.main(["--reduced", "--device", "cpu", "--rows", "16",
                          "--epochs", "1", "--accum", "2"])
    assert len(eng.trainers) == 2
    for tr in eng.trainers.values():
        assert not tr.pending() and tr.optimizer_steps >= 1
        assert np.isfinite(tr.train_losses).all()
    out = capsys.readouterr().out
    assert "adapter0: loss" in out and "adapter1: loss" in out


def test_train_cli_needs_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--reduced"])
