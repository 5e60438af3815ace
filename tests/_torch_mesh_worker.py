"""Worker side of ``tests/test_torch_mesh.py``: one rank of a CPU mesh over
``torch.distributed`` with the ``gloo`` backend.  Imports only torch and the
port, never JAX: the parent test process computes the JAX references and
hands them over in an npz (``case.npz``) beside the weights it wrote with
``save_pytree``; each rank writes its findings to ``result_<rank>.json``,
and any failed check raises, which fails the spawn."""
import dataclasses
import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.io import bank_from_numpy, gather_bank, \
    gather_opt_state, load_npz, params_from_numpy, shard_bank, \
    shard_opt_state, shard_params
from repro_torch.configs import get_reduced
from repro_torch.core.flow import FlowConfig
from repro_torch.core.lora import LoRAConfig, init_lora_bank
from repro_torch.core.unified import make_forward_step, make_grad_step, \
    make_train_step
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import axis_size as mesh_size, init_mesh
from repro_torch.models import model as TM
from repro_torch.models.configs import MoEConfig
from repro_torch.models.moe_dist import moe_apply_auto
from repro_torch.models.schema import cross_len, init_params, \
    lora_targets
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch
from repro_torch.kernels import ops
from repro_torch.roofline.analysis import collective_bytes
from repro_torch.training import optimizer as topt

BT = FlowConfig().block_t
TOL = 2e-4          # fp32, sums over ranks in another order than one device
TIMEOUT_S = 60


def _t(a):
    return torch.from_numpy(np.array(a))


def mixed_batch(z, prefix=""):
    """The ft + prefill + decode batch of ``case.npz`` (dense rows)."""
    g = lambda k: _t(z[prefix + k])
    return UnifiedBatch(
        ft=FTBatch(tokens=g("ft_tokens"), mask=g("ft_mask"),
                   labels=g("ft_labels"), adapter=g("ft_adapter"),
                   weight=g("ft_weight")),
        pf=PFBatch(tokens=g("pf_tokens"), length=g("pf_length"),
                   adapter=g("pf_adapter")),
        dec=DECBatch(tokens=g("dec_tokens"), pos=g("dec_pos"),
                     adapter=g("dec_adapter")))


def err(a, b) -> float:
    return float((a.double() - torch.as_tensor(np.asarray(b)).double()
                  ).abs().max())


def forward_case(tmp, name, mesh, strategy, z):
    """The sharded step of case ``name`` against JAX's single-device
    ``unified_forward`` (``case.npz``) and the port's one-process step on
    the same weights.  Returns the case's errors and collective log."""
    cfg = get_reduced(z[f"{name}/arch"].item())
    if f"{name}/cf" in z:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(z[f"{name}/cf"])))
    params = params_from_numpy(load_npz(os.path.join(tmp, f"{name}_params.npz")),
                               device="cpu")
    bank = bank_from_numpy(load_npz(os.path.join(tmp, f"{name}_bank.npz")),
                           device="cpu")
    scale = _t(z[f"{name}/scale"])
    batch = mixed_batch(z, f"{name}/")
    segs = (batch.dec.tokens.shape[0], batch.pf.tokens.shape[0])
    cache0 = {k: _t(z[f"{name}/cache0_{k}"]) for k in ("k", "v")}
    n_rows = cache0["k"].shape[1]

    one = make_forward_step(cfg, block_t=BT)(
        params, bank, scale, batch, {k: v.clone() for k, v in cache0.items()})
    step = make_forward_step(cfg, block_t=BT, mesh=mesh, strategy=strategy)
    local = SH.shard_cache(cfg, cache0, mesh, segs)
    SH.reset_collective_log()
    out = step(shard_params(params, cfg, mesh, strategy),
               shard_bank(bank, mesh), scale, batch, local)
    coll = collective_bytes()
    cache = SH.gather_cache(cfg, out.cache, mesh, n_rows, segs)
    got = {"pf_logits": out.pf_logits, "dec_logits": out.dec_logits,
           "ft_loss_sum": out.ft_loss_sum, "ft_tok_count": out.ft_tok_count,
           "aux_loss": out.aux_loss, "cache_k": cache["k"],
           "cache_v": cache["v"]}
    ref_one = {"pf_logits": one.pf_logits, "dec_logits": one.dec_logits,
               "ft_loss_sum": one.ft_loss_sum,
               "ft_tok_count": one.ft_tok_count, "aux_loss": one.aux_loss,
               "cache_k": one.cache["k"], "cache_v": one.cache["v"]}
    errs = {}
    for k, v in got.items():
        e_jax, e_one = err(v, z[f"{name}/ref_{k}"]), err(v, ref_one[k])
        errs[k] = (e_jax, e_one)
        assert e_jax < TOL and e_one < TOL, (name, strategy, k, e_jax, e_one)
    if cfg.moe is not None:
        assert moe_apply_auto.branch == z[f"{name}/branch"].item(), \
            moe_apply_auto.branch
    return {"errs": errs, "coll": coll["raw"], "scaled": coll["scaled"],
            "branch": moe_apply_auto.branch if cfg.moe else None}


def hand_count(cfg, mesh, z, name, lcfg_r):
    """The collective bytes of case ``name``'s step under ``tp`` by hand,
    from its shapes: fp32, every bucket split over "data", vocab over
    "model", every projection a LoRA target whose ``a`` splits."""
    D, m = mesh.shape["data"], mesh.shape["model"]
    Bf, Sf = z[f"{name}/ft_tokens"].shape
    Bp, Sp = z[f"{name}/pf_tokens"].shape
    Bd = z[f"{name}/dec_tokens"].shape[0]
    T = (Bf * Sf + Bp * Sp + Bd) // D
    d, V, r, L = cfg.d_model, cfg.vocab, lcfg_r, cfg.n_layers
    f4 = 4
    ar = T * d * f4                               # embed
    # per layer: q/k/v shrinks, wo shrink + base, g/u shrinks, wd shrink +
    # base
    ar += L * (T * 3 * r + T * r + T * d + T * 2 * r + T * r + T * d) * f4
    bf, bp, bd = Bf // D, Bp // D, Bd // D
    ar += bf * (Sf - 1) * f4 + 2 * bf * (Sf - 1) * f4   # max, then sum/pick
    ag = (bd * V // m + bd * V + bp * V // m + bp * V) * f4 + 2 * bf * f4
    return {"all-reduce": ar, "all-gather": ag, "reduce-scatter": 0,
            "all-to-all": 0}


def moe_case(tmp, z, mesh, fsdp):
    """``moe_apply_auto`` at capacity factor 1.0 (drops happen) against
    JAX's ``moe_apply_auto`` under a 4-device host mesh of this shape."""
    key = f"moe_{mesh.devices_shape[0]}x{mesh.devices_shape[1]}_{int(fsdp)}"
    E, k, f = (int(v) for v in z["moe_dims"])
    mcfg = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f,
                     capacity_factor=1.0)
    x = _t(z["moe_x"])
    whole = {n: _t(z[f"moe_{n}"]) for n in ("router", "w_gate", "w_up",
                                             "w_down")}
    strategy = "fsdp_tp" if fsdp else "tp"
    spec = {n: SH._spec_for(None, mesh, strategy, whole[n].shape, ax)
            for n, ax in (("router", ("embed", "experts")),
                          ("w_gate", ("experts", "embed", "ffn")),
                          ("w_up", ("experts", "embed", "ffn")),
                          ("w_down", ("experts", "ffn", "embed")))}
    local = {n: SH.local_shard(w, spec[n], mesh) for n, w in whole.items()}
    D = mesh.shape["data"]
    T = x.shape[0] // D
    xd = x[mesh.coords["data"] * T:(mesh.coords["data"] + 1) * T]
    with SH.mesh_context(mesh, strategy):
        y, aux = moe_apply_auto(xd, local, mcfg, fsdp=fsdp)
    assert moe_apply_auto.branch == "expert_parallel"
    y_all = SH.all_gather(y.contiguous(), "data", mesh, dim=0)
    kept = SH.all_gather(moe_apply_auto.kept.to(torch.int32), ("data",
                                                                 "model"),
                         mesh, dim=0)
    e_y = err(y_all, z[f"{key}/y"])
    e_aux = abs(float(aux) - float(z[f"{key}/aux"]))
    same_drops = bool((kept.numpy() == z[f"{key}/kept"]).all())
    assert e_y < 1e-5 and e_aux < 1e-6 and same_drops, (key, e_y, e_aux)
    return {"err": e_y, "aux_err": e_aux, "dropped": int((kept == 0).sum())}


def raises(fn, *words):
    try:
        fn()
    except ValueError as e:
        text = str(e)
        assert all(w in text for w in words), (text, words)
        return text
    raise AssertionError(f"no ValueError naming {words}")


def value_errors(tmp, z, mesh):
    """Every case the sharded forward refuses, each a ValueError naming
    it; and the grad steps that ran refused before 5b-iii-a, now run."""
    cfg = get_reduced("llama3-8b")
    params = params_from_numpy(load_npz(os.path.join(tmp, "llama_tp_params.npz")),
                               device="cpu")
    batch = mixed_batch(z, "llama_tp/")
    step = lambda c, p=params, b=batch: make_forward_step(
        c, block_t=BT, mesh=mesh)(p, None, None, b, {})
    out = {"mla_heads": raises(lambda: step(get_reduced(
        "deepseek-v2-236b").replace(n_heads=3, n_kv_heads=3)), "MLA",
        "heads", "5c-ii-b-ii")}
    paged = batch._replace(pf=batch.pf._replace(
        block_tables=torch.zeros((batch.pf.tokens.shape[0], 2),
                                 dtype=torch.int32)))
    out["paged"] = raises(lambda: step(cfg, params, paged), "paged", "pf",
                          "5c-ii-b-ii")
    verify = UnifiedBatch(dec=DECBatch(
        tokens=torch.zeros((2, 3), dtype=torch.int32),
        pos=torch.zeros(2, dtype=torch.int32),
        adapter=torch.full((2,), -1, dtype=torch.int32)))
    out["verify"] = raises(lambda: step(cfg, params, verify), "verify",
                           "5c-ii-b-ii")
    def grad_step(name, arch=None):
        """A grad step under the mesh on case ``name``'s weights, or on a
        reduced ``arch`` drawn here."""
        if arch is None:
            cfg = get_reduced(z[f"{name}/arch"].item())
            p = params_from_numpy(load_npz(os.path.join(
                tmp, f"{name}_params.npz")), device="cpu")
            bank = bank_from_numpy(load_npz(os.path.join(
                tmp, f"{name}_bank.npz")), device="cpu")
        else:
            cfg = get_reduced(arch)
            gen = torch.Generator().manual_seed(0)
            p = init_params(cfg, gen, device="cpu", dtype=torch.float32)
            bank = init_lora_bank(lora_targets(cfg, LoRAConfig().targets
                                               + ("xwq", "xwo")),
                                  LoRAConfig(), gen, torch.device("cpu"),
                                  torch.float32)
        ft = batch.ft._replace(tokens=batch.ft.tokens % cfg.vocab)
        if cfg.encoder is not None or cfg.cross_attn_every:
            ft = ft._replace(aux_embed=torch.zeros(
                (ft.tokens.shape[0], cross_len(cfg), cfg.d_model)))
        return lambda: make_grad_step(cfg, block_t=BT, mesh=mesh)(
            shard_params(p, cfg, mesh, "tp"), shard_bank(bank, mesh),
            torch.ones(4), UnifiedBatch(ft=ft), None)

    out["grad"] = raises(grad_step("maverick"), "gradient", "MoE",
                         "5b-iii-b")
    out["grad_mla"] = raises(grad_step(None, "deepseek-v2-236b"),
                             "gradient", "MLA", "5b-iii-b")
    # Mamba2 and cross-attention layers take a gradient under a mesh
    # (ROADMAP 5b-iii-a): the same steps run, every grad leaf finite
    for key, arch in (("grad_mamba", "mamba2-1.3b"),
                      ("grad_cross", "llama-3.2-vision-90b")):
        grads = topt.tree_leaves(grad_step(None, arch)().grads)
        assert grads and all(bool(torch.isfinite(g).all()) for g in grads), \
            key
        out[key] = f"{len(grads)} grad leaves, all finite"
    return out


def _cache_of(z, prefix):
    return {k[len(prefix):]: _t(z[k]) for k in z.files
            if k.startswith(prefix)}


def _family_batch(z, name):
    """Case ``name``'s mixed batch of ``case.npz``, with its ft and prefill
    buckets' ``aux_embed`` when the case has them, and its second step's
    decode bucket (every row: the decode rows one further, the prefill
    rows at their next position)."""
    batch = mixed_batch(z, f"{name}/")
    if f"{name}/ft_aux" in z:
        batch = batch._replace(
            ft=batch.ft._replace(aux_embed=_t(z[f"{name}/ft_aux"])),
            pf=batch.pf._replace(aux_embed=_t(z[f"{name}/pf_aux"])))
    g = lambda k: _t(z[f"{name}/{k}"])
    dec2 = UnifiedBatch(dec=DECBatch(tokens=g("dec2_tokens"),
                                     pos=g("dec2_pos"),
                                     adapter=g("dec2_adapter")))
    return batch, dec2


def _planted(fault, mesh):
    """A sharding fault on model ranks 1-3, as (module attribute, its
    original, its replacement): ``"mla"`` drops their MLA decode partials,
    ``"seq"`` their GQA slot partials (``model.seq_partials``), ``"hd"``
    their share of the head-dim layout's partial scores, so the all-reduce
    sums rank 0's slice of the head dim alone (``model.hd_partial_scores``);
    ``"norm"`` skips the all-reduce of Mamba2's gated-norm sum of squares,
    taking their own d_inner slice's sum for the whole d_inner's
    (``model.gated_sum_sq``, still called so that the collectives pair);
    ``"roll"`` writes their slots of a rolling row unrolled, slot ``s0 +
    j`` given prompt position ``s0 + j`` (``model._dense_write_prompt``
    told the row is at least as long as the bucket)."""
    mine = mesh.coords["model"] == 0
    name = {"mla": "mla_partials", "seq": "seq_partials",
            "hd": "hd_partial_scores", "norm": "gated_sum_sq",
            "roll": "_dense_write_prompt"}[fault]
    orig = getattr(TM, name)

    def unrolled(rows, xh, r0, s0=0, sc=None):
        if not mine:
            sc = max(sc or rows.shape[1], xh.shape[1])
        return orig(rows, xh, r0, s0, sc)

    def dropped(*a):
        out = orig(*a)
        if mine:
            return out
        if fault == "norm":
            return a[0].float().pow(2).sum(-1)
        if fault == "hd":
            return torch.zeros_like(out)
        o, m, l = out
        return (torch.zeros_like(o), torch.full_like(m, -1e30),
                torch.zeros_like(l))
    return name, orig, unrolled if fault == "roll" else dropped


def case_config(z, name):
    """Case ``name``'s reduced config with its changes (a window, a
    capacity factor, head counts and head dim, d_model and the SSM head
    dim)."""
    cfg = get_reduced(z[f"{name}/arch"].item())
    if f"{name}/window" in z:
        cfg = cfg.replace(sliding_window=int(z[f"{name}/window"]))
    if f"{name}/cf" in z:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(z[f"{name}/cf"])))
    if f"{name}/heads" in z:
        h, kv, hd = (int(v) for v in z[f"{name}/heads"])
        cfg = cfg.replace(n_heads=h, n_kv_heads=kv, head_dim=hd)
    if f"{name}/ssm" in z:
        d, hd = (int(v) for v in z[f"{name}/ssm"])
        cfg = cfg.replace(d_model=d, ssm=dataclasses.replace(cfg.ssm,
                                                             head_dim=hd))
    return cfg


def family_case(tmp, name, mesh, strategy, z, fault=None,
                cache_strategy="auto", keep=False):
    """Two steps of case ``name`` (``tests/test_torch_mesh_families.py``)
    on this rank's shards, the cache cut under ``cache_strategy``: the
    mixed step, then a decode of every row (the cache gathered whole and
    cut again for the new rows' split), each against JAX's single-device
    ``unified_forward`` (``case.npz``) and the port's one-process step on
    the same weights.  With a ``fault`` (``_planted``) the errors come back
    unchecked.  Returns the errors, the collective log of the first step,
    the MoE branch and the layouts of the KV and cross rows' shards (with
    ``keep``, the outputs themselves under ``"got"``)."""
    cfg = case_config(z, name)
    params = params_from_numpy(load_npz(os.path.join(tmp, f"{name}_params.npz")),
                               device="cpu")
    bank = bank_from_numpy(load_npz(os.path.join(tmp, f"{name}_bank.npz")),
                           device="cpu")
    scale = _t(z[f"{name}/scale"])
    batch, dec2 = _family_batch(z, name)
    cache0 = _cache_of(z, f"{name}/cache0_")
    n_rows = next(iter(cache0.values())).shape[1]
    segs = (batch.dec.tokens.shape[0], batch.pf.tokens.shape[0])

    plain = make_forward_step(cfg, block_t=BT)
    one1 = plain(params, bank, scale, batch,
                 {k: v.clone() for k, v in cache0.items()})
    one2 = plain(params, bank, scale, dec2,
                 {k: v.clone() for k, v in one1.cache.items()})
    step = make_forward_step(cfg, block_t=BT, mesh=mesh, strategy=strategy,
                             cache_strategy=cache_strategy)
    local_p = shard_params(params, cfg, mesh, strategy)
    local_b = shard_bank(bank, mesh)
    cs = cache_strategy
    if fault:
        attr, orig, dropped = _planted(fault, mesh)
        setattr(TM, attr, dropped)
    try:
        SH.reset_collective_log()
        local = SH.shard_cache(cfg, cache0, mesh, segs, cs)
        layouts = {k: SH.shard_layout(cfg, k, local[k].shape, mesh, cs)
                   for k in ("k", "xk") if k in local}
        out1 = step(local_p, local_b, scale, batch, local)
        coll = collective_bytes()["raw"]
        branch = moe_apply_auto.branch if cfg.moe is not None else None
        whole1 = SH.gather_cache(cfg, out1.cache, mesh, n_rows, segs, cs)
        out2 = step(local_p, local_b, scale, dec2,
                    SH.shard_cache(cfg, whole1, mesh, strategy=cs))
        whole2 = SH.gather_cache(cfg, out2.cache, mesh, n_rows, strategy=cs)
    finally:
        if fault:
            setattr(TM, attr, orig)
    got = {"pf_logits": out1.pf_logits, "dec_logits": out1.dec_logits,
           "ft_loss_sum": out1.ft_loss_sum,
           "ft_tok_count": out1.ft_tok_count, "aux_loss": out1.aux_loss,
           "dec2_logits": out2.dec_logits}
    ref_one = {"pf_logits": one1.pf_logits, "dec_logits": one1.dec_logits,
               "ft_loss_sum": one1.ft_loss_sum,
               "ft_tok_count": one1.ft_tok_count, "aux_loss": one1.aux_loss,
               "dec2_logits": one2.dec_logits}
    for k in cache0:
        got[f"cache1_{k}"], ref_one[f"cache1_{k}"] = whole1[k], one1.cache[k]
        got[f"cache2_{k}"], ref_one[f"cache2_{k}"] = whole2[k], one2.cache[k]
    errs = {}
    for k, v in got.items():
        e_jax, e_one = err(v, z[f"{name}/ref_{k}"]), err(v, ref_one[k])
        errs[k] = (e_jax, e_one)
        assert fault or (e_jax < TOL and e_one < TOL), \
            (name, strategy, cs, k, e_jax, e_one)
    res = {"errs": errs, "coll": coll, "branch": branch, "layouts": layouts}
    if keep:
        res["got"] = got
    return res


def round_trips(tmp, z, mesh, names):
    """``gather_cache(shard_cache(c)) == c`` bit for bit under both
    strategies for the first cache of each case in ``names`` (every leaf
    kind: ``k``/``v``, ``xk``/``xv``, ``ckv``/``kpe``), and a shard of one
    layout refused by ``gather_cache`` and by the step of the other where
    the two layouts differ.  Returns {case/strategy: same?} and {case:
    the refusal's text}."""
    same, refused = {}, {}
    for name in names:
        cfg = case_config(z, name)
        cache0 = _cache_of(z, f"{name}/cache0_")
        n_rows = next(iter(cache0.values())).shape[1]
        segs = (z[f"{name}/dec_tokens"].shape[0],
                z[f"{name}/pf_tokens"].shape[0])
        for cs in ("auto", "seq"):
            local = SH.shard_cache(cfg, cache0, mesh, segs, cs)
            back = SH.gather_cache(cfg, local, mesh, n_rows, segs, cs)
            same[f"{name}/{cs}"] = all(torch.equal(back[k], cache0[k])
                                       for k in cache0)
        if "k" not in cache0:
            continue
        auto = SH.shard_cache(cfg, cache0, mesh, segs, "auto")
        if SH.shard_layout(cfg, "k", auto["k"].shape, mesh) == \
                SH.kv_layout(cfg, cache0["k"].shape[2], cfg.hd,
                             mesh.shape["model"], "seq"):
            continue
        lay = SH.shard_layout(cfg, "k", auto["k"].shape, mesh)
        text = raises(lambda: SH.gather_cache(cfg, auto, mesh, n_rows, segs,
                                              "seq"), f"'{lay}'", "'seq'")
        batch, _ = _family_batch(z, name)
        step = make_forward_step(cfg, block_t=BT, mesh=mesh,
                                 cache_strategy="seq")
        params = shard_params(params_from_numpy(load_npz(os.path.join(
            tmp, f"{name}_params.npz")), device="cpu"), cfg, mesh, "tp")
        raises(lambda: step(params, None, None, batch, auto), f"'{lay}'",
               "'seq'")
        refused[name] = text
    return same, refused


def whole_row(mesh, seed=5):
    """``core.lora.dense_row(..., whole=True)``: ``wo`` whole on every rank
    with its LoRA ``a`` cut on d_in and ``b`` on d_out
    (``lora_shardings``), against the one-device ``dense`` on the whole
    leaves.  Returns the max abs error."""
    from repro_torch.core.lora import dense, dense_row
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    T, din, dout, n, r = 12, 192, 64, 4, 4
    x = _t(rng.standard_normal((T, din)).astype(np.float32))
    w = _t(rng.standard_normal((din, dout)).astype(np.float32) * 0.1)
    lora = {"a": _t(rng.standard_normal((n, din, r)).astype(np.float32)
                    / din ** 0.5),
            "b": _t(rng.standard_normal((n, r, dout)).astype(np.float32))}
    ids = torch.tensor([0, 1, -1, 2] * 3, dtype=torch.int32)
    rt = ops.route(ids, torch.ones(T), n, 8, BT)
    spec = SH.lora_shardings(lora, mesh)
    assert spec["a"][1] == "model" and spec["b"][2] == "model", spec
    local = SH.shard_tree(lora, spec, mesh)
    got = dense_row(x, w, local, rt, mesh, whole=True)
    return err(got, dense(x, w, None, lora, rt).numpy())


# the train step under a mesh (tests/test_torch_mesh_train.py): fp32
# tolerances, each leaf's max abs error as a share of the leaf's max abs
TRAIN_TOL = 2e-4
TRAIN_LOSS_TOL = 1e-4
# AdamW with eps 1e-5 (its first step's slope 1 / eps bounds what a
# rounding difference of a near-zero gradient moves) and a clip far below
# the gradient norm, so that it engages; slot 1 masked
TRAIN_OPT = dict(lr=1e-3, eps=1e-5, grad_clip=1e-3)
TRAIN_SLOTS = (1, 0, 1, 1)


def _train_batch(z, name):
    """Case ``name``'s ft bucket, and its prefill and decode buckets where
    it has them (dense rows), with a cross model's ``aux_embed``."""
    g = lambda k: _t(z[f"{name}/{k}"])
    aux = lambda k: g(k) if f"{name}/{k}" in z else None
    ft = FTBatch(tokens=g("ft_tokens"), mask=g("ft_mask"),
                 labels=g("ft_labels"), adapter=g("ft_adapter"),
                 weight=g("ft_weight"), aux_embed=aux("ft_aux"))
    if f"{name}/pf_tokens" not in z:
        return UnifiedBatch(ft=ft)
    return UnifiedBatch(
        ft=ft, pf=PFBatch(tokens=g("pf_tokens"), length=g("pf_length"),
                          adapter=g("pf_adapter"), aux_embed=aux("pf_aux")),
        dec=DECBatch(tokens=g("dec_tokens"), pos=g("dec_pos"),
                     adapter=g("dec_adapter")))


def _tree_errs(prefix, got, want) -> dict:
    """Each leaf's max abs error over the leaf's max abs."""
    out = {}
    for li, (lg, lw) in enumerate(zip(got["layers"], want["layers"])):
        for n in lw:
            for ab in ("a", "b"):
                w = lw[n][ab].double()
                out[f"{prefix}/{li}/{n}/{ab}"] = float(
                    (lg[n][ab].double() - w).abs().max()
                    / max(float(w.abs().max()), 1e-30))
    return out


def _planted_train(fault, mesh):
    """A fault of the train step under a mesh, as (module, attribute, its
    replacement): ``"shrink"`` model ranks 1-3 take their own ``Gs`` for
    the backward's shrink all-reduce (still called, so that the
    collectives pair); ``"batch"`` the bank's gradients not summed over
    the batch axes; ``"clip"`` the clip's sum of squares of this rank's
    shards alone, without the sum over "model"; ``"cut"`` the
    sequence-sharded carry's cut giving back only this rank's block of
    the gradient (zeros elsewhere) where the others' blocks belong;
    ``"gsq"`` Mamba2's gated-norm sum of squares with the identity as its
    adjoint (``model.gated_sum_sq`` read alike); ``"ssm"`` the ``in_bc`` /
    ``in_dt`` products' input gradient not summed over "model"
    (``model._ssm_reads`` always "alike").  Each is planted on every
    rank, so every collective still pairs."""
    if fault == "gsq":
        return TM, "gated_sum_sq", lambda g, mesh: SH.all_reduce_grad(
            g.float().pow(2).sum(-1), "model", mesh)
    if fault == "ssm":
        return TM, "_ssm_reads", lambda cut: ("alike", "alike")
    if fault == "cut":
        def local_only(dy, axes, mesh, n_tokens):
            n = dy.shape[0]
            i = mesh.index(axes)
            dx = dy.new_zeros((n * mesh_size(mesh, axes), *dy.shape[1:]))
            dx[i * n:(i + 1) * n] = dy
            return dx[:n_tokens]
        return SH, "cut_grad", local_only
    if fault == "shrink":
        orig = ops.reduce_gs

        def own(reduce, gs):
            out = orig(reduce, gs.clone())
            return out if mesh.coords["model"] == 0 else gs
        return ops, "reduce_gs", own
    if fault == "batch":
        return SH, "reduce_bank_grads", lambda grads, mesh, split: grads
    return topt, "clip_sumsq", lambda g, leaves, cut, mesh: g.square().sum()


def train_case(tmp, name, mesh, strategy, z, cache_strategy="auto",
               train=False, fault=None):
    """Case ``name``'s grad step (and with ``train`` its train step) on
    this rank's shards against JAX's single-device steps (the npz files
    ``tests/test_torch_mesh_train.py`` wrote): the loss, every grad leaf
    gathered whole, and the new bank and moments gathered whole.  With a
    ``fault`` (``_planted_train``) the errors come back unchecked."""
    cfg = case_config(z, name)
    rd = lambda f: load_npz(os.path.join(tmp, f"{name}_{f}.npz"))
    params = params_from_numpy(rd("params"), device="cpu")
    bank = bank_from_numpy(rd("bank"), device="cpu")
    scale = _t(z[f"{name}/scale"])
    batch = _train_batch(z, name)
    chunk = int(z[f"{name}/chunk"])
    cache0 = _cache_of(z, f"{name}/cache0_")
    segs = None if batch.pf is None else (batch.dec.tokens.shape[0],
                                          batch.pf.tokens.shape[0])
    cache = lambda: SH.shard_cache(cfg, cache0, mesh, segs,
                                   cache_strategy) if cache0 else None
    lp, lb = shard_params(params, cfg, mesh, strategy), shard_bank(bank,
                                                                   mesh)
    remat = bool(z[f"{name}/remat"]) if f"{name}/remat" in z else False
    kw = dict(block_t=BT, attn_chunk=chunk, mesh=mesh, strategy=strategy,
              cache_strategy=cache_strategy, remat=remat)
    # a remat case's train step cuts the carry between periods by tokens
    tkw = dict(kw, act_constraint=SH.act_constraint_fn(mesh)) if remat \
        else kw
    if fault:
        mod, attr, bad = _planted_train(fault, mesh)
        orig = getattr(mod, attr)
        setattr(mod, attr, bad)
    try:
        local = cache()
        res = make_grad_step(cfg, **kw)(lp, lb, scale, batch, local)
        if train:
            opt = topt.AdamWConfig(**TRAIN_OPT)
            st0 = shard_opt_state(topt.adamw_init(bank, 4), mesh)
            mask = torch.tensor(TRAIN_SLOTS, dtype=torch.int32)
            tloss, nb, ns, _ = make_train_step(cfg, opt, **tkw)(
                lp, lb, scale, st0, batch, mask, cache())
    finally:
        if fault:
            setattr(mod, attr, orig)
    grads = gather_bank(cfg, res.grads, mesh)
    errs = _tree_errs("grad", grads, bank_from_numpy(rd("grads"),
                                                     device="cpu"))
    if local is not None and f"{name}/ref_cache_h" in z:
        # the state rows after the grad step: prefill's final states and
        # the decode rows' one step, against JAX's
        whole = SH.gather_cache(cfg, res.out.cache, mesh,
                                cache0["h"].shape[1], segs, cache_strategy)
        for k, v in whole.items():
            w = torch.as_tensor(z[f"{name}/ref_cache_{k}"]).double()
            errs[f"cache/{k}"] = float((v.double() - w).abs().max()
                                       / max(float(w.abs().max()), 1e-30))
    out = {"loss": abs(float(res.loss) - float(z[f"{name}/ref_loss"])),
           "split": TM.local_batch(batch, mesh)[1]["ft"],
           "layout": None if local is None or "k" not in local else
           SH.shard_layout(cfg, "k", local["k"].shape, mesh,
                           cache_strategy)}
    if train:
        nb, ns = gather_bank(cfg, nb, mesh), gather_opt_state(cfg, ns, mesh)
        errs.update(_tree_errs("bank", nb, bank_from_numpy(
            rd("newbank"), device="cpu")))
        errs.update(_tree_errs("m", ns.m, bank_from_numpy(rd("m"),
                                                          device="cpu")))
        errs.update(_tree_errs("v", ns.v, bank_from_numpy(rd("v"),
                                                          device="cpu")))
        out["loss"] = max(out["loss"], abs(float(tloss) - float(
            z[f"{name}/ref_tloss"])))
        out["t_same"] = bool((ns.t.numpy() == z[f"{name}/ref_t"]).all())
        out["norm"] = float(torch.sqrt(sum(
            g.double().square().sum() for g in topt.tree_leaves(grads))))
        out["masked_same"] = all(
            torch.equal(nl[n][ab][1], ol[n][ab][1])
            for nl, ol in zip(nb["layers"], bank["layers"]) for n in ol
            for ab in ("a", "b"))
        assert fault or out["t_same"], (name, ns.t, z[f"{name}/ref_t"])
    out["errs"] = errs
    assert fault or (out["loss"] < TRAIN_LOSS_TOL
                     and max(errs.values()) < TRAIN_TOL), \
        (name, strategy, cache_strategy, out["loss"],
         max(errs.items(), key=lambda kv: kv[1]))
    return out


def hooks_case(tmp, name, mesh, strategy, z):
    """The tensors autograd saves in a ``strategy`` grad step on this
    rank's shards (``saved_tensors_hooks``): none may have the shape of a
    leaf gathered whole over "data" (a saved tensor that is itself a
    rank's shard, the same storage, is not one), and the shards
    themselves must be among them.  An int8 leaf's payload is held so,
    and its scales are counted apart: a dequantized leaf, gathered or
    not, has the payload's shape, so the int8 shards and scales saved
    and no dequantized whole leaf say that only the shards were kept."""
    from repro_torch.models import quant
    cfg = case_config(z, name)
    params = params_from_numpy(load_npz(os.path.join(
        tmp, f"{name}_params.npz")), device="cpu")
    bank = bank_from_numpy(load_npz(os.path.join(tmp, f"{name}_bank.npz")),
                           device="cpu")
    lp = shard_params(params, cfg, mesh, strategy)
    specs = (quant.quant_shardings(cfg, mesh, strategy)
             if quant.has_q8(lp) else SH.param_shardings(cfg, mesh, strategy))
    gathered, shards, scales = set(), set(), set()
    pairs = [(lp[k], specs[k]) for k in ("embed", "lm_head") if k in lp]
    pairs += [(v, sp[k]) for layer, sp in zip(lp["layers"], specs["layers"])
              for k, v in layer.items()]
    for leaf, spec in pairs:
        if quant.is_q8(leaf):
            scales.add(leaf["_qs"].data_ptr())
            leaf, spec = leaf["_q8"], spec["_q8"]
        for dim, ax in enumerate(spec):
            if ax == "data":
                shape = list(leaf.shape)
                shape[dim] *= mesh.shape["data"]
                gathered.add(tuple(shape))
                shards.add(leaf.data_ptr())
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.data_ptr(), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        make_grad_step(cfg, block_t=BT, mesh=mesh, strategy=strategy)(
            lp, shard_bank(bank, mesh), _t(z[f"{name}/scale"]),
            _train_batch(z, name), None)
    return {"n_saved": len(saved),
            "shards_saved": sum(p in shards for _, p, _ in saved),
            "int8_shards_saved": sum(p in shards and d == torch.int8
                                     for _, p, d in saved),
            "scales_saved": sum(p in scales for _, p, _ in saved),
            "gathered_saved": sorted({s for s, p, _ in saved
                                      if s in gathered and p not in shards})}


def encoder_case(tmp, name, mesh, strategy, z):
    """The collectives of a ``strategy`` grad step's encoder on this
    rank's shards: ``model.encoder_forward`` wrapped to record, for each
    collective it makes (``sharding._record``), whether a gradient could
    reach it (grad mode on and the tensor requiring it, or grad mode off:
    inside a ``*_grad`` collective's autograd function).  Returns the
    records, whether the encoder's output requires a gradient, and the
    grad step's loss error against JAX's."""
    cfg = case_config(z, name)
    rd = lambda f: load_npz(os.path.join(tmp, f"{name}_{f}.npz"))
    lp = shard_params(params_from_numpy(rd("params"), device="cpu"), cfg,
                      mesh, strategy)
    bank = bank_from_numpy(rd("bank"), device="cpu")
    inside, seen, outs = [False], [], []
    record, enc = SH._record, TM.encoder_forward

    def watched(kind, x):
        if inside[0]:
            seen.append((kind, not torch.is_grad_enabled()
                         or bool(x.requires_grad)))
        return record(kind, x)

    def encoder(*a, **kw):
        inside[0] = True
        try:
            out = enc(*a, **kw)
        finally:
            inside[0] = False
        outs.append(bool(out.requires_grad))
        return out
    SH._record, TM.encoder_forward = watched, encoder
    try:
        res = make_grad_step(cfg, block_t=BT, mesh=mesh, strategy=strategy)(
            lp, shard_bank(bank, mesh), _t(z[f"{name}/scale"]),
            _train_batch(z, name), None)
    finally:
        SH._record, TM.encoder_forward = record, enc
    return {"collectives": len(seen),
            "with_grad": sorted({k for k, g in seen if g}),
            "kinds": sorted({k for k, _ in seen}),
            "out_requires_grad": outs,
            "loss": abs(float(res.loss) - float(z[f"{name}/ref_loss"]))}


def remat_hooks_case(tmp, name, mesh, strategy, z):
    """The shapes of the tensors autograd saves in a remat train step on
    this rank's shards, with the sequence-sharded carry
    (``act_constraint_fn``) and without it: [T, d] the stream, [ceil(T /
    n), d] a rank's block of it over the cut's axes (``n`` their size).
    Returns each shape's count in both steps, and the layer count."""
    cfg = case_config(z, name)
    rd = lambda f: load_npz(os.path.join(tmp, f"{name}_{f}.npz"))
    lp = shard_params(params_from_numpy(rd("params"), device="cpu"), cfg,
                      mesh, strategy)
    bank = bank_from_numpy(rd("bank"), device="cpu")
    batch = _train_batch(z, name)
    seq = SH.act_constraint_fn(mesh)
    axes = seq.axes(TM.local_batch(batch, mesh)[1]["ft"])
    T = TM.local_batch(batch, mesh)[0].ft.tokens.numel()
    n = mesh_size(mesh, mesh.axes(axes))
    whole, block = (T, cfg.d_model), (-(-T // n), cfg.d_model)
    out = {"layers": cfg.n_layers, "n": n}
    for key, ac in (("cut", seq), ("alone", None)):
        saved = []

        def pack(x):
            saved.append(tuple(x.shape))
            return x

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            make_train_step(cfg, topt.AdamWConfig(**TRAIN_OPT), block_t=BT,
                            remat=True, act_constraint=ac, mesh=mesh,
                            strategy=strategy)(
                lp, shard_bank(bank, mesh), _t(z[f"{name}/scale"]),
                shard_opt_state(topt.adamw_init(bank, 4), mesh), batch,
                torch.tensor(TRAIN_SLOTS, dtype=torch.int32))
        out[key] = {"whole": saved.count(whole), "block": saved.count(block)}
    return out


def run(rank, world, tmp, shape, cases):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'init_' + 'x'.join(map(str, shape)))}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = init_mesh(shape, ("data", "model"), timeout_s=TIMEOUT_S)
        z = np.load(os.path.join(tmp, "case.npz"))
        res = {}
        for case in cases:
            kind, rest = case.split(":", 1)
            if kind == "fwd":
                name, strategy = rest.split(",")
                res[case] = forward_case(tmp, name, mesh, strategy, z)
                if name == "llama_tp" and strategy == "tp":
                    cfg = get_reduced("llama3-8b")
                    res["hand_count"] = hand_count(
                        cfg, mesh, z, name, int(z["lora_r"]))
            elif kind == "moe":
                res[case] = moe_case(tmp, z, mesh, rest == "1")
            elif kind in ("fam", "fault"):
                name, strategy = rest.split(",")
                res[case] = family_case(tmp, name, mesh, strategy, z,
                                        fault="mla" if kind == "fault"
                                        else None)
            elif kind in ("fault_norm", "fault_roll"):
                name, strategy = rest.split(",")
                res[case] = family_case(tmp, name, mesh, strategy, z,
                                        fault=kind[6:])
            elif kind in ("seq", "fault_seq", "fault_hd"):
                name, strategy = rest.split(",")
                cs = "auto" if kind == "fault_hd" else "seq"
                fault = kind[6:] if kind.startswith("fault") else None
                res[case] = family_case(tmp, name, mesh, strategy, z,
                                        fault=fault, cache_strategy=cs,
                                        keep=name.startswith("dsv2"))
                if kind == "seq" and name.startswith("dsv2"):
                    # MLA's latent is cut by slots under both strategies
                    auto = family_case(tmp, name, mesh, strategy, z,
                                       keep=True)
                    res[case]["same_as_auto"] = all(
                        torch.equal(v, auto["got"][k])
                        for k, v in res[case]["got"].items())
                res[case].pop("got", None)
            elif kind == "rt":
                res[case] = round_trips(tmp, z, mesh, rest.split(","))
            elif kind == "row":
                res[case] = whole_row(mesh)
            elif kind == "errors":
                res[case] = value_errors(tmp, z, mesh)
            elif kind in ("grad", "train", "remat"):
                name, strategy, *cs = rest.split(",")
                res[case] = train_case(tmp, name, mesh, strategy, z,
                                       *cs, train=kind != "grad")
            elif kind.startswith("fault_") and kind[6:] in (
                    "shrink", "batch", "clip", "cut", "gsq", "ssm"):
                name, strategy = rest.split(",")
                res[case] = train_case(tmp, name, mesh, strategy, z,
                                       train=kind in ("fault_clip",
                                                      "fault_cut"),
                                       fault=kind[6:])
            elif kind == "remat_hooks":
                name, strategy = rest.split(",")
                res[case] = remat_hooks_case(tmp, name, mesh, strategy, z)
            elif kind == "hooks":
                name, strategy = rest.split(",")
                res[case] = hooks_case(tmp, name, mesh, strategy, z)
            elif kind == "encoder":
                name, strategy = rest.split(",")
                res[case] = encoder_case(tmp, name, mesh, strategy, z)
        with open(os.path.join(tmp, f"result_{'x'.join(map(str, shape))}_"
                                    f"{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()
