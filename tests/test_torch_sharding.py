"""The port's sharding rules, mesh and abstract shapes against the JAX
package's, spec for spec, on abstract meshes (no processes, no devices).

JAX's rules run on ``jax.sharding.AbstractMesh`` of the production shapes
(``(16, 16)`` and ``(2, 16, 16)``; ``NamedSharding`` takes an abstract mesh
and ``.spec`` gives its ``PartitionSpec``); the port's on its abstract
``launch.mesh.Mesh`` of the same shape.  A ``PartitionSpec`` writes a
one-axis tuple as the axis name, so the port's specs are compared with that
normalisation.  The JAX trees stack a pattern position's layers on a
leading periods axis (spec entry ``None``), the port's are per layer: port
layer ``li`` is JAX position ``li % P``, its spec JAX's without the periods
entry.  Cache leaves are ``[L_kind, ...]`` in the port and ``[n_periods,
...]`` per position in JAX: the rules read only the trailing dims, so each
port leaf's spec equals every JAX position's spec of that leaf.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS, get_config as j_get_config
from repro.core.lora import LoRAConfig as JLoRAConfig, abstract_lora_bank
from repro.distributed import sharding as JS
from repro.launch import shapes as JSH
from repro.models.schema import lora_targets as j_lora_targets, \
    param_logical_axes as j_logical
from repro.training.optimizer import adamw_init as j_adamw_init
from repro_torch.configs import get_config, get_reduced
from repro_torch.distributed import sharding as S
from repro_torch.launch import shapes as SH
from repro_torch.launch.mesh import Mesh, batch_axes, make_local_mesh, \
    make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models.schema import SHARED, param_logical_axes
from repro_torch.roofline.analysis import flop_count
from repro_torch.training.optimizer import adamw_init

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STRATEGIES = ("tp", "fsdp_tp")


def _norm(spec):
    """A spec with each one-axis tuple written as the axis name (what
    ``PartitionSpec`` stores)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jspec(s):
    return tuple(s.spec)


@functools.lru_cache(maxsize=None)
def _meshes(key):
    shape, names = MESHES[key]
    return AbstractMesh(shape, names), Mesh(shape, names)


def _jax_leaf(tree, li, P, name):
    blk = tree["blocks"][li % P]
    if name in SHARED:
        return blk["shared"][SHARED[name].split("/")[1]]
    return blk[name]


# --------------------------------------------------------------------- mesh
def test_production_and_local_meshes():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.abstract
    assert batch_axes(m) == ("data",)
    pod = make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model") and pod.size == 512
    assert batch_axes(pod) == ("pod", "data")
    assert make_local_mesh().size == 1


@pytest.mark.parametrize("rank", range(8))
def test_mesh_coordinates_are_row_major(rank):
    m = Mesh((2, 2, 2), ("pod", "data", "model"), rank)
    assert m.coords == {"pod": rank // 4, "data": (rank // 2) % 2,
                        "model": rank % 2}
    assert m.index(("pod", "data")) == rank // 2
    assert rank in m.ranks("model") and len(m.ranks(("data", "model"))) == 4
    assert m.ranks(("pod", "data", "model")) == tuple(range(8))


# ----------------------------------------------------------- logical axes
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_match_jax(arch):
    cfg, jl = get_config(arch), j_logical(j_get_config(arch))
    got = param_logical_axes(cfg)
    P = len(cfg.pattern)
    for li, layer in enumerate(got["layers"]):
        for name, axes in layer.items():
            want = _jax_leaf(jl, li, P, name)
            assert want[0] == "periods" and axes == tuple(want[1:]), \
                (li, name, axes, want)
    for name in ("embed", "final_norm", "lm_head"):
        if name in jl:
            assert got[name] == tuple(jl[name]), name
    if cfg.encoder is not None:
        for name, axes in got["encoder"]["layers"][0].items():
            assert axes == tuple(jl["encoder"]["blocks"][name][1:])


# ------------------------------------------------------------ param rules
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_jax(arch, mesh, strategy):
    jm, tm = _meshes(mesh)
    cfg = get_config(arch)
    want = JS.param_shardings(j_get_config(arch), jm, strategy)
    got = S.param_shardings(cfg, tm, strategy)
    P = len(cfg.pattern)
    n = 0
    for li, layer in enumerate(got["layers"]):
        for name, spec in layer.items():
            w = _jspec(_jax_leaf(want, li, P, name))
            assert w[0] is None and _norm(spec) == w[1:], (li, name, spec, w)
            n += 1
    for name in ("embed", "lm_head", "final_norm"):
        if name in want:
            assert _norm(got[name]) == _jspec(want[name]), name
    if cfg.encoder is not None:
        for name, spec in got["encoder"]["layers"][0].items():
            assert _norm(spec) == _jspec(
                want["encoder"]["blocks"][name])[1:], name
    assert n > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lora_shardings_match_jax(arch, mesh):
    jm, tm = _meshes(mesh)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    lc = JLoRAConfig(n_slots=4, r=8)
    jbank = abstract_lora_bank(j_lora_targets(jcfg, lc.targets), lc)
    want = JS.lora_shardings(jbank, jm)
    _, bank, _ = SH.abstract_model_state(cfg, SH.DRYRUN_LORA)
    got = S.lora_shardings(bank, tm)
    P = len(cfg.pattern)
    n = 0
    for li, layer in enumerate(got["layers"]):
        for name, ab in layer.items():
            w = _jax_leaf(want, li, P, name)
            for k in ("a", "b"):
                ws = _jspec(w[k])
                assert ws[0] is None and _norm(ab[k]) == ws[1:], \
                    (li, name, k, ab[k], ws)
                n += 1
    assert n > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_shardings_match_jax(arch, mesh):
    """The AdamW state of a bank: the moments follow ``lora_shardings``,
    the per-slot step counters replicate."""
    jm, tm = _meshes(mesh)
    jcfg, cfg = j_get_config(arch), get_config(arch)
    lc = JLoRAConfig(n_slots=4, r=8)
    jbank = abstract_lora_bank(j_lora_targets(jcfg, lc.targets), lc)
    want = JS.opt_shardings(jax.eval_shape(
        lambda b: j_adamw_init(b, lc.n_slots), jbank), jm)
    _, bank, _ = SH.abstract_model_state(cfg, SH.DRYRUN_LORA)
    got = S.opt_shardings(adamw_init(bank, lc.n_slots), tm)
    assert _norm(got.t) == _jspec(want.t) == ()
    P = len(cfg.pattern)
    n = 0
    for moment in ("m", "v"):
        for li, layer in enumerate(getattr(got, moment)["layers"]):
            for name, ab in layer.items():
                w = _jax_leaf(getattr(want, moment), li, P, name)
                for k in ("a", "b"):
                    ws = _jspec(w[k])
                    assert ws[0] is None and _norm(ab[k]) == ws[1:], \
                        (moment, li, name, k, ab[k], ws)
                    n += 1
    assert n > 0


@functools.lru_cache(maxsize=None)
def _specs(arch, shape):
    """(JAX input specs, port input specs) at ``shape``."""
    jcfg = JSH.adapt_config(j_get_config(arch), JSH.SHAPES[shape])
    cfg = SH.adapt_config(get_config(arch), SH.SHAPES[shape])
    return (JSH.input_specs(jcfg, JSH.SHAPES[shape]),
            SH.input_specs(cfg, SH.SHAPES[shape]), jcfg)


@pytest.mark.parametrize("strategy", ("auto", "seq"))
@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k", "long_500k"))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_jax(arch, mesh, shape, strategy):
    jm, tm = _meshes(mesh)
    jspec, tspec, jcfg = _specs(arch, shape)
    want = JS.cache_shardings(jcfg, jspec["cache"], jm, strategy)
    got = S.cache_shardings(get_config(arch), tspec["cache"], tm, strategy)
    seen = set()
    for pos, leaves in enumerate(want["layers"]):
        for name, s in leaves.items():
            assert _norm(got[name]) == _jspec(s), (pos, name, got[name], s)
            seen.add(name)
    assert seen == set(got)


@pytest.mark.parametrize("shape", list(SH.SHAPES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_match_jax(arch, mesh, shape):
    jm, tm = _meshes(mesh)
    jspec, tspec, _ = _specs(arch, shape)
    want = JS.batch_shardings(jspec["batch"], jm)
    got = S.batch_shardings(tspec["batch"], tm)
    for bucket in ("ft", "pf", "dec"):
        wb, gb = getattr(want, bucket), getattr(got, bucket)
        assert (wb is None) == (gb is None), bucket
        if wb is None:
            continue
        for field in gb._fields:
            w, g = getattr(wb, field), getattr(gb, field)
            assert (w is None) == (g is None), (bucket, field)
            if g is not None:
                assert _norm(g) == _jspec(w), (bucket, field, g, w)


# ---------------------------------------------------- abstract shapes
def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("shape", list(SH.SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch, shape):
    jspec, tspec, _ = _specs(arch, shape)
    for bucket in ("ft", "pf", "dec"):
        wb, gb = getattr(jspec["batch"], bucket), getattr(tspec["batch"],
                                                          bucket)
        assert (wb is None) == (gb is None), bucket
        if wb is None:
            continue
        for field in gb._fields:
            w, g = getattr(wb, field), getattr(gb, field)
            assert (w is None) == (g is None), (bucket, field)
            if g is not None:
                assert g.device.type == "meta"
                assert _shape_dtype(g) == (tuple(w.shape), str(w.dtype)), \
                    (bucket, field)
    if jspec["cache"] is None:
        assert tspec["cache"] is None
        return
    count = {}
    for leaves in jspec["cache"]["layers"]:
        for name, w in leaves.items():
            g = tspec["cache"][name]
            assert _shape_dtype(g)[0][1:] == tuple(w.shape)[1:], name
            assert _shape_dtype(g)[1] == str(w.dtype), name
            count[name] = count.get(name, 0) + w.shape[0]
    assert {k: v.shape[0] for k, v in tspec["cache"].items()} == count


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_model_state_matches_jax(arch):
    jcfg = JSH.adapt_config(j_get_config(arch), JSH.SHAPES["decode_32k"])
    cfg = SH.adapt_config(get_config(arch), SH.SHAPES["decode_32k"])
    jp, jb, js = JSH.abstract_model_state(jcfg)
    tp, tb, ts = SH.abstract_model_state(cfg)
    P = len(cfg.pattern)
    for li, layer in enumerate(tp["layers"]):
        for name, g in layer.items():
            w = _jax_leaf(jp, li, P, name)
            assert g.device.type == "meta"
            assert _shape_dtype(g) == (tuple(w.shape)[1:], str(w.dtype))
        for name, ab in tb["layers"][li].items():
            w = _jax_leaf(jb, li, P, name)
            for k in ("a", "b"):
                assert _shape_dtype(ab[k]) == (tuple(w[k].shape)[1:],
                                               str(w[k].dtype))
    assert _shape_dtype(ts) == (tuple(js.shape), str(js.dtype))
    assert _shape_dtype(tp["embed"]) == (tuple(jp["embed"].shape),
                                         str(jp["embed"].dtype))


# ------------------------------------------------------------ FLOP counter
def test_flop_count_of_a_reduced_dense_forward_is_the_hand_count():
    """FlopCounterMode over the reduced llama3-8b's plain forward (prefill
    of B x S tokens, no LoRA, meta tensors): each layer's q/k/v/o and
    SwiGLU products, the attention's two score products, and the head on
    the B last positions, 2 FLOPs a multiply-add."""
    cfg = get_reduced("llama3-8b")
    B, S = 2, 16
    params, _, _ = SH.abstract_model_state(cfg)
    from repro_torch.models.stream import PFBatch, UnifiedBatch
    batch = UnifiedBatch(pf=PFBatch(
        tokens=torch.zeros((B, S), dtype=torch.int32),
        length=torch.full((B,), S, dtype=torch.int32),
        adapter=torch.full((B,), -1, dtype=torch.int32)))
    d, h, g, hd, f, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         cfg.d_ff, cfg.vocab)
    T = B * S
    proj = 2 * T * (d * h * hd + 2 * d * g * hd + h * hd * d + 3 * d * f)
    attn = 2 * 2 * B * h * S * S * hd
    head = 2 * B * d * V
    want = cfg.n_layers * (proj + attn) + head
    cache = TM.init_cache(cfg, B, S, torch.device("cpu"), torch.float32)
    got = flop_count(lambda: TM.unified_forward(
        cfg, _cpu_like(params), batch, cache, block_t=8))
    assert got["bytes_accessed"] is None
    assert got["flops"] == want, (got["by_op"], want)


def _cpu_like(tree):
    """``abstract_model_state``'s meta leaves as CPU zeros (the counter
    counts shapes; the forward's cache writes need storage)."""
    if isinstance(tree, dict):
        return {k: _cpu_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cpu_like(v) for v in tree]
    return torch.zeros(tree.shape, dtype=torch.float32)


def test_flop_count_on_meta_tensors():
    """The counter reads shapes only: a projection of the abstract state
    (meta tensors, nothing allocated) counts 2 T d_in d_out."""
    cfg = get_reduced("llama3-8b")
    params, _, _ = SH.abstract_model_state(cfg)
    w = params["layers"][0]["wg"]
    x = torch.empty((24, cfg.d_model), dtype=w.dtype, device="meta")
    got = flop_count(lambda: x @ w)
    assert got["out"].device.type == "meta"
    assert got["flops"] == 2 * 24 * cfg.d_model * cfg.d_ff


# ----------------------------------------------------- a mesh of one rank
def test_a_local_mesh_runs_the_sharded_forward(monkeypatch):
    """``make_forward_step(..., mesh=make_local_mesh())`` takes the sharded
    path (every collective the identity; the LoRA terms through the split
    shrink and expand entries, whose plain versions the CPU runs) and gives
    the plain step's outputs on reduced llama3-8b in fp32, on a mixed ft +
    prefill + decode batch over dense rows: logits, ft loss sums and the
    cache within 1e-5 abs."""
    from repro_torch.core.flow import FlowConfig
    from repro_torch.core.lora import LoRAConfig, init_lora_bank
    from repro_torch.core.unified import make_forward_step
    from repro_torch.kernels import ops
    from repro_torch.models.schema import init_params, lora_targets
    from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
        UnifiedBatch
    cfg = get_reduced("llama3-8b")
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=dev, dtype=torch.float32)
    lc = LoRAConfig(n_slots=4, r=4)
    bank = init_lora_bank(lora_targets(cfg, lc.targets), lc, gen, dev,
                          torch.float32, gaussian_b=True)
    scale = torch.tensor([1.0, 0.5, 2.0, 1.0])
    tok = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=gen,
                                       dtype=torch.int32)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    ft_tok = tok(2, 16)
    labels = ft_tok.clone()
    labels[0, 3] = -100
    mask = torch.ones((2, 16), dtype=torch.bool)
    mask[1, 11:] = False
    batch = UnifiedBatch(
        ft=FTBatch(tokens=ft_tok, mask=mask, labels=labels,
                   adapter=i32(0, 1), weight=torch.tensor([1.0, 0.5])),
        pf=PFBatch(tokens=tok(2, 16), length=i32(13, 9), adapter=i32(1, -1)),
        dec=DECBatch(tokens=tok(2), pos=i32(5, 7), adapter=i32(2, 0)))
    cache0 = TM.init_cache(cfg, 4, 24, dev, torch.float32)
    for leaf in cache0.values():
        leaf.normal_(generator=gen)
    calls = []
    shrink = ops.lora_shrink
    monkeypatch.setattr(ops, "lora_shrink",
                        lambda *a: calls.append(1) or shrink(*a))
    bt = FlowConfig().block_t
    want = make_forward_step(cfg, block_t=bt)(
        params, bank, scale, batch, {k: v.clone() for k, v in cache0.items()})
    assert not calls
    got = make_forward_step(cfg, block_t=bt, mesh=make_local_mesh())(
        params, bank, scale, batch, {k: v.clone() for k, v in cache0.items()})
    assert len(calls) == 7 * cfg.n_layers   # q, k, v, o, g, u, d
    for k in ("pf_logits", "dec_logits", "ft_loss_sum", "ft_tok_count"):
        err = float((getattr(got, k) - getattr(want, k)).abs().max())
        assert err < 1e-5, (k, err)
    for k in cache0:
        assert float((got.cache[k] - want.cache[k]).abs().max()) < 1e-5, k
