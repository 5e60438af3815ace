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
def _local_case():
    """Reduced llama3-8b in fp32 with a gaussian-B bank, a mixed ft +
    prefill + decode batch over dense rows and a random cache."""
    from repro_torch.core.lora import LoRAConfig, init_lora_bank
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
    return cfg, params, bank, scale, batch, cache0


def test_a_local_mesh_runs_the_sharded_forward(monkeypatch):
    """``make_forward_step(..., mesh=make_local_mesh())`` takes the sharded
    path (every collective the identity; the LoRA terms through the split
    shrink and expand entries, whose plain versions the CPU runs) and gives
    the plain step's outputs on reduced llama3-8b in fp32, on a mixed ft +
    prefill + decode batch over dense rows: logits, ft loss sums and the
    cache within 1e-5 abs."""
    from repro_torch.core.flow import FlowConfig
    from repro_torch.core.unified import make_forward_step
    from repro_torch.kernels import ops
    cfg, params, bank, scale, batch, cache0 = _local_case()
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


def test_a_local_mesh_runs_the_sharded_train_step(monkeypatch):
    """``make_train_step(..., mesh=make_local_mesh())`` (the split LoRA
    term's backward, ``ops.SplitLoRAFunction``, once a projection; the
    sharded clip with every collective the identity) gives the plain
    train step's loss, new bank and moments on the same mixed batch, and
    ``make_grad_step`` its grads: within 1e-5 of each leaf's max (fp32)."""
    from repro_torch.core.flow import FlowConfig
    from repro_torch.core.unified import make_grad_step, make_train_step
    from repro_torch.kernels import ops
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
        tree_leaves
    cfg, params, bank, scale, batch, cache0 = _local_case()
    calls = []
    wgrad = ops.smlm_wgrad_split
    monkeypatch.setattr(ops, "smlm_wgrad_split",
                        lambda *a, **k: calls.append(1) or wgrad(*a, **k))
    bt, mesh = FlowConfig().block_t, make_local_mesh()
    opt = AdamWConfig(lr=1e-3, eps=1e-5, grad_clip=1e-3)
    mask = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    fresh = lambda: {k: v.clone() for k, v in cache0.items()}
    got, want = [], []
    for m, out in ((None, want), (mesh, got)):
        g = make_grad_step(cfg, block_t=bt, mesh=m)(params, bank, scale,
                                                    batch, fresh())
        loss, nb, ns, _ = make_train_step(cfg, opt, block_t=bt, mesh=m)(
            params, bank, scale, adamw_init(bank, 4), batch, mask, fresh())
        out += [g.loss, loss, *tree_leaves([g.grads, nb, ns.m, ns.v])]
        assert len(calls) == (0 if m is None else 2 * 7 * cfg.n_layers)
    for a, b in zip(got, want):
        err = float((a - b).abs().max())
        assert err <= 1e-5 * max(float(b.abs().max()), 1.0), err


# ------------------------------------------------------------- int8 leaves
def _qnorm(spec):
    """A port spec, or an int8 leaf's pair of them, normalised."""
    if isinstance(spec, dict):
        return {k: _norm(v) for k, v in spec.items()}
    return _norm(spec)


def _jqspec(s, drop=0):
    """A JAX sharding, or an int8 leaf's pair of them, as spec tuples
    without the first ``drop`` entries (the periods axis: None)."""
    if isinstance(s, dict):
        return {k: _jqspec(v, drop) for k, v in s.items()}
    spec = _jspec(s)
    assert all(e is None for e in spec[:drop]), spec
    return spec[drop:]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quant_shardings_match_jax(arch, mesh, strategy):
    """``quant.quant_shardings`` against JAX's spec for spec: the payload
    of an int8 leaf takes the float leaf's spec, its scales that spec
    with the reduced input axis replicated; the other leaves keep
    ``param_shardings``'."""
    from repro.models import quant as JQ
    from repro_torch.models import quant
    jm, tm = _meshes(mesh)
    cfg = get_config(arch)
    want = JQ.quant_shardings(j_get_config(arch), jm, strategy)
    got = quant.quant_shardings(cfg, tm, strategy)
    P = len(cfg.pattern)
    n_q8 = 0
    for li, layer in enumerate(got["layers"]):
        for name, spec in layer.items():
            w = _jqspec(_jax_leaf(want, li, P, name), drop=1)
            assert _qnorm(spec) == w, (li, name, spec, w)
            n_q8 += isinstance(spec, dict)
    for name in ("embed", "lm_head", "final_norm"):
        if name in want:
            assert _qnorm(got[name]) == _jqspec(want[name]), name
    if cfg.encoder is not None:
        for name, spec in got["encoder"]["layers"][0].items():
            assert _qnorm(spec) == _jqspec(
                want["encoder"]["blocks"][name], drop=1), name
    assert n_q8 > 0


@pytest.mark.parametrize("strategy,leaf", [("tp", "wo"), ("fsdp_tp", "wq"),
                                           ("fsdp_tp", "wo")])
def test_init_sharded_params_int8_is_the_cut_of_the_whole_leaf(strategy,
                                                                leaf):
    """``init_sharded_params(..., quantized=True)`` on every rank of a
    ``(2, 2)`` mesh: each ``_q8`` / ``_qs`` shard equals the cut of
    ``quantize_params`` of the whole model drawn from the same seed, on a
    row-parallel leaf (``wo``: its input rows over "model", the scales
    whole) and on leaves cut over "data" by FSDP (``wq``'s input rows,
    ``wo``'s output columns with their scales).  A rank that quantized its
    own cut would get other scales."""
    from repro_torch.checkpoint.io import init_sharded_params
    from repro_torch.models import quant
    from repro_torch.models.schema import init_params
    cfg = get_reduced("llama3-8b")
    cpu = torch.device("cpu")
    gen = lambda: torch.Generator().manual_seed(3)
    plain = init_params(cfg, gen(), device=cpu, dtype=torch.float32)
    whole = quant.quantize_params(cfg, plain)
    specs = quant.quant_shardings(cfg, Mesh((2, 2), ("data", "model")),
                                  strategy)
    own_scales_differ = False
    for rank in range(4):
        mesh = Mesh((2, 2), ("data", "model"), rank)
        got = init_sharded_params(cfg, mesh, strategy, gen(), cpu,
                                  torch.float32, quantized=True)
        for li in range(cfg.n_layers):
            spec = specs["layers"][li][leaf]
            for k in ("_q8", "_qs"):
                want = S.local_shard(whole["layers"][li][leaf][k], spec[k],
                                     mesh)
                assert torch.equal(got["layers"][li][leaf][k], want), \
                    (rank, li, k)
            own = quant.quantize_leaf(S.local_shard(
                plain["layers"][li][leaf], spec["_q8"], mesh))
            own_scales_differ |= not torch.equal(
                own["_qs"], got["layers"][li][leaf]["_qs"])
    assert own_scales_differ


# ------------------------------------------------ collective bytes by hand
def _fake_collectives(monkeypatch):
    """``torch.distributed``'s collectives as shape-true stand-ins on one
    process (the values are not the mesh's; only the recorded operand
    bytes are read)."""
    import torch.distributed as dist

    def gather(out, x, group=None):
        out.view(-1, *x.shape).copy_(x.expand(out.numel() // x.numel(),
                                              *x.shape))

    monkeypatch.setattr(dist, "all_reduce", lambda x, op=None, group=None:
                        None)
    monkeypatch.setattr(dist, "all_gather_into_tensor", gather)
    monkeypatch.setattr(dist, "reduce_scatter_tensor",
                        lambda out, x, group=None: out.copy_(
                            x[:out.shape[0]]))
    monkeypatch.setattr(dist, "all_to_all_single",
                        lambda out, x, group=None: out.copy_(x))


def _fake_mesh(m):
    """Rank 0 of a ``(1, m)`` mesh with stand-in groups."""
    return Mesh((1, m), ("data", "model"), 0,
                {("data",): None, ("model",): "model",
                 ("data", "model"): "model"})


def _collective_run(monkeypatch, cfg, m, aux):
    """The sharded step of ``cfg`` (fp32, LoRA r 4 over every target and
    ``xwq`` / ``xwo``) on rank 0 of a ``(1, m)`` ``tp`` mesh over a mixed
    batch: ft 2 x 16, prefill 2 x 16, 3 decode rows on 24-slot rows.
    Returns the recorded bytes and the bucket sizes."""
    from repro_torch.checkpoint.io import shard_bank, shard_params
    from repro_torch.core.lora import LoRAConfig, init_lora_bank
    from repro_torch.core.unified import make_forward_step
    from repro_torch.models.schema import init_params, lora_targets
    from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
        UnifiedBatch
    _fake_collectives(monkeypatch)
    mesh = _fake_mesh(m)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device=cpu, dtype=torch.float32)
    lc = LoRAConfig(n_slots=4, r=4, targets=LoRAConfig().targets
                    + ("xwq", "xwo"))
    bank = init_lora_bank(lora_targets(cfg, lc.targets), lc, gen, cpu,
                          torch.float32, gaussian_b=True)
    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)
    tok = lambda *s: torch.randint(0, cfg.vocab, s, generator=gen,
                                   dtype=torch.int32)
    src = (lambda: torch.randn(2, aux, cfg.d_model, generator=gen)) \
        if aux else (lambda: None)
    Bf, Sf, Bp, Sp, Bd = 2, 16, 2, 16, 3
    batch = UnifiedBatch(
        ft=FTBatch(tokens=tok(Bf, Sf), mask=torch.ones(Bf, Sf,
                                                       dtype=torch.bool),
                   labels=tok(Bf, Sf), adapter=i32(0, 1),
                   weight=torch.ones(Bf), aux_embed=src()),
        pf=PFBatch(tokens=tok(Bp, Sp), length=i32(13, 9),
                   adapter=i32(1, -1), aux_embed=src()),
        dec=DECBatch(tokens=tok(Bd), pos=i32(5, 11, 0), adapter=i32(0, 1,
                                                                    -1)))
    cache = S.shard_cache(cfg, TM.init_cache(cfg, Bd + Bp, 24, cpu,
                                             torch.float32), mesh)
    S.reset_collective_log()
    make_forward_step(cfg, block_t=8, mesh=mesh, strategy="tp")(
        shard_params(params, cfg, mesh, "tp"), shard_bank(bank, mesh),
        torch.ones(4), batch, cache)
    return S.collective_log(), (Bf, Sf, Bp, Sp, Bd), lc.r


def _head_bytes(cfg, m, Bf, Sf, Bp, Bd):
    """The head's collectives (vocab over "model"), fp32: the decode and
    prefill logits all-gathered; the ft CE's max, then its sum and label
    pick all-reduced."""
    ag = (Bd + Bp) * cfg.vocab // m * 4
    ar = Bf * (Sf - 1) * 4 + 2 * Bf * (Sf - 1) * 4
    return ar, ag


def test_collective_bytes_of_a_cross_model_equal_the_hand_count(
        monkeypatch):
    """Reduced llama-3.2-vision-90b (5 layers, the fifth a cross layer) at
    ``(1, 2)`` ``tp``: per layer the q/k/v shrinks in one all-reduce, ``wo``'s
    shrink and base partial, the FFN's; on the cross layer ``xwq``'s shrink
    and ``xwo``'s shrink and base partial (``xwk`` / ``xwv`` are plain
    products over each rank's KV heads: no collective)."""
    cfg = get_reduced("llama-3.2-vision-90b")
    m = 2
    got, (Bf, Sf, Bp, Sp, Bd), r = _collective_run(monkeypatch, cfg, m,
                                                   cfg.n_img_tokens)
    T, d, L = Bf * Sf + Bp * Sp + Bd, cfg.d_model, cfg.n_layers
    ar = T * d                                       # embed
    ar += L * (T * 3 * r + T * r + T * d + T * 2 * r + T * r + T * d)
    ar += T * r + T * r + T * d                      # the cross sublayer
    head_ar, head_ag = _head_bytes(cfg, m, Bf, Sf, Bp, Bd)
    assert got == {"all-reduce": ar * 4 + head_ar, "all-gather": head_ag,
                   "reduce-scatter": 0, "all-to-all": 0}


def test_collective_bytes_of_mla_equal_the_hand_count(monkeypatch):
    """Reduced deepseek-v2-236b with a dense FFN at ``(1, 4)`` ``tp``: per
    layer ``wq`` / ``wdkv``'s shrinks in one all-reduce and ``wdkv``'s
    LoRA B (its base is whole on every rank) all-gathered; decode's
    absorbed queries all-gathered ([Bd, h/m, c + dr]) and every head's
    partials sent to its rank in one all-to-all ([m, Bd, h/m, c + 2],
    fp32); ``wo``'s shrink and base partial; the FFN's."""
    cfg = get_reduced("deepseek-v2-236b").replace(moe=None, d_ff=512)
    m = 4
    got, (Bf, Sf, Bp, Sp, Bd), r = _collective_run(monkeypatch, cfg, m, 0)
    T, d, L, h = Bf * Sf + Bp * Sp + Bd, cfg.d_model, cfg.n_layers, \
        cfg.n_heads
    c, dr = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_dim
    ar = T * d + L * (T * 2 * r + T * r + T * d + T * 2 * r + T * r + T * d)
    ag = L * (4 * r * (c + dr) // m + Bd * h // m * (c + dr))
    a2a = L * Bd * h * (c + 2)
    head_ar, head_ag = _head_bytes(cfg, m, Bf, Sf, Bp, Bd)
    assert got == {"all-reduce": ar * 4 + head_ar,
                   "all-gather": ag * 4 + head_ag, "reduce-scatter": 0,
                   "all-to-all": a2a * 4}
