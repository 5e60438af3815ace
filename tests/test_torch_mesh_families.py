"""The sharded forward's other families on a CPU mesh of 4 ``gloo`` ranks
against the JAX package's single-device ``unified_forward`` on the same npz
weights: MLA (reduced deepseek-v2-236b, with its MoE), cross-attention
layers (reduced llama-3.2-vision-90b) and an encoder (reduced whisper-base),
int8 leaves (reduced llama3-8b and deepseek-v2 through JAX's
``quantize_params``), a GQA sliding window (reduced llama3-8b, W = 8),
Mamba2 (reduced mamba2-1.3b: 16 SSM heads, 4 a rank at ``(1, 4)``; and at
d_model 192 with an SSM head dim of 64, 6 heads that do not divide 4, so
the mixer runs whole on every rank over ``conv_x`` rows cut by d_inner),
the hybrid stack (reduced jamba: Mamba2, GQA and MoE layers in one stack,
also under "seq") and MLA's rolling rows (reduced deepseek-v2, W = 8).

One spawn per mesh shape holds all its cases (``_torch_mesh_worker.
family_case``); each case is two steps on dense rows: the mixed ft +
prefill + decode batch of ``tests/test_torch_mesh.py`` (cross models with
an ``aux_embed`` on the ft and prefill buckets, ``xgate`` opened to 0.5:
JAX draws it as zero), then a decode of every row, the prefill rows at
their next position (so MLA's decode reads a latent that prefill wrote
into every rank's slots, and the window's rows roll past W).  At ``(1,
4)`` the VLM's and llama3's 2 KV heads do not divide the model axis, so
their KV rows (and the VLM's ``xk``/``xv``) are cut by the head dim; the
``seq:`` cases cut every KV row by its slots (``cache_strategy="seq"``),
against the same JAX references, and deepseek-v2's MLA, whose latent is
cut by slots under both strategies, must give its ``"auto"`` result bit
for bit.  MoE capacity factor 8.0, as in ``tests/test_torch_mesh.py``.

Tolerance ``W.TOL`` = 2e-4 abs (fp32) for the logits, ft loss sums, aux
loss and the gathered cache of both steps, against JAX and against the
port's one-process step.  Three planted faults at ``(1, 4)``, each of
which must break that tolerance: model ranks 1-3 drop their MLA decode
partials; skip the all-reduce of Mamba2's gated-norm sum of squares; write
their slots of the window's rolling latent rows unrolled.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_bridge import j
from test_torch_mesh import LORA_R, _batch, _spawn
from repro.checkpoint.io import save_pytree
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM
from repro.models import quant as JQ
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB

TARGETS = JLoRAConfig().targets + ("xwq", "xwo")
# name: (arch, seed, int8, window, capacity factor)
CASES = {"dsv2": ("deepseek-v2-236b", 20, False, 0, 8.0),
         "vlm": ("llama-3.2-vision-90b", 21, False, 0, None),
         "whisper": ("whisper-base", 22, False, 0, None),
         "llama_q8": ("llama3-8b", 23, True, 0, None),
         "dsv2_q8": ("deepseek-v2-236b", 24, True, 0, 8.0),
         "window": ("llama3-8b", 25, False, 8, None),
         "mamba2": ("mamba2-1.3b", 40, False, 0, None),
         "jamba": ("jamba-1.5-large-398b", 41, False, 0, 8.0),
         "mamba_whole": ("mamba2-1.3b", 42, False, 0, None),
         "dsv2_window": ("deepseek-v2-236b", 43, False, 8, 8.0)}
# (d_model, SSM head dim): 6 SSM heads of 64, which do not divide a model
# axis of 4, over a d_inner of 384, which does
SSM = {"mamba_whole": (192, 64)}
N_ROWS, S_MAX = 6, 32
RUN_1X4 = ["fam:dsv2,tp", "fam:whisper,tp", "fam:dsv2_q8,tp",
           # the head-dim layout
           "fam:vlm,tp", "fam:llama_q8,tp", "fam:window,tp",
           # the sequence layout
           "seq:vlm,tp", "seq:window,tp", "seq:dsv2,tp",
           # Mamba2, the hybrid stack and MLA's rolling rows
           "fam:mamba2,tp", "fam:jamba,tp", "fam:mamba_whole,tp",
           "fam:dsv2_window,tp", "seq:jamba,tp"]
RUN_2X2 = ["fam:dsv2,fsdp_tp", "fam:vlm,tp", "fam:vlm,fsdp_tp",
           "fam:whisper,fsdp_tp", "fam:llama_q8,tp", "fam:llama_q8,fsdp_tp",
           "fam:window,tp", "seq:vlm,fsdp_tp", "seq:window,tp",
           "seq:dsv2,fsdp_tp", "fam:mamba2,fsdp_tp", "fam:jamba,fsdp_tp"]
FAULT = "fault:dsv2,tp"
# model ranks 1-3 skip the all-reduce of Mamba2's gated-norm squares; they
# write their slots of the window's rolling latent rows unrolled
FAULTS = ["fault_norm:mamba2,tp", "fault_roll:dsv2_window,tp"]
# shard/gather round trips of every leaf kind: MLA's ckv/kpe, the VLM's
# k/v and xk/xv, the window's rolling rows, jamba's k/v beside the state
# rows h/conv_x/conv_bc cut by the SSM heads, and the whole mixer's h
# whole beside its conv_x cut by d_inner
RT = "rt:dsv2,vlm,window,jamba,mamba_whole"
SPAWN_TIMEOUT_S = 150
# the layout each case's KV rows (and cross rows) take: (1, 4) / (2, 2)
LAYOUT = {("vlm", "fam"): ("head_dim", "heads"),
          ("llama_q8", "fam"): ("head_dim", "heads"),
          ("window", "fam"): ("head_dim", "heads"),
          ("jamba", "fam"): ("head_dim", "heads"),
          ("vlm", "seq"): ("seq", "seq"), ("window", "seq"): ("seq", "seq"),
          ("jamba", "seq"): ("seq", "seq")}


def _jcfg(arch, window, cf, heads=None, ssm=None):
    jcfg = j_get_reduced(arch)
    if ssm:
        jcfg = jcfg.replace(d_model=ssm[0], ssm=dataclasses.replace(
            jcfg.ssm, head_dim=ssm[1]))
    if heads:
        jcfg = jcfg.replace(n_heads=heads[0], n_kv_heads=heads[1],
                            head_dim=heads[2])
    if window:
        jcfg = jcfg.replace(sliding_window=window)
    if cf is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cf))
    return jcfg


def _gated(jparams):
    """Every ``xgate`` opened to 0.5."""
    return dict(jparams, blocks=tuple(
        dict(b, xgate=jnp.full_like(b["xgate"], 0.5)) if "xgate" in b else b
        for b in jparams["blocks"]))


def _port_leaves(jcfg, layers, name):
    """JAX's per-position ``name`` leaves in the port's layout: the layers
    that carry it, in layer order."""
    P = len(jcfg.pattern)
    return np.stack([np.asarray(layers[li % P][name][li // P])
                     for li in range(jcfg.n_layers)
                     if name in layers[li % P]])


def _jax_case(tmp, name, arch, seed, int8, window, cf, z, heads=None,
              ssm=None):
    jcfg = _jcfg(arch, window, cf, heads, ssm)
    jparams = _gated(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    if int8:
        jparams = JQ.quantize_params(jcfg, jparams)
    store = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=LORA_R,
                                            targets=TARGETS),
                          jax.random.PRNGKey(seed + 10))
    store.load_random("a0", jax.random.PRNGKey(seed + 11))
    store.load_random("a1", jax.random.PRNGKey(seed + 12))
    save_pytree(str(tmp / f"{name}_params.npz"), jparams)
    save_pytree(str(tmp / f"{name}_bank.npz"), store.bank)
    rng = np.random.default_rng(seed)
    b = _batch(rng, jcfg.vocab)
    cross = jcfg.cross_attn_every > 0 or jcfg.encoder is not None
    if cross:
        F = jcfg.encoder.n_frames if jcfg.encoder else jcfg.n_img_tokens
        for k in ("ft_aux", "pf_aux"):
            b[k] = rng.standard_normal((2, F, jcfg.d_model)).astype(
                np.float32)
    jcache = JM.init_cache(jcfg, N_ROWS, S_MAX)
    layers = tuple({k: jnp.asarray(rng.standard_normal(v.shape).astype(
        np.float32) * 0.5) for k, v in c.items()} for c in jcache["layers"])
    names = sorted({k for c in layers for k in c})
    for k in names:
        z[f"{name}/cache0_{k}"] = _port_leaves(jcfg, layers, k)
    aux = (lambda k: j(b[k])) if cross else (lambda k: None)
    jb = JUB(ft=JFT(tokens=j(b["ft_tokens"]), mask=j(b["ft_mask"]),
                    labels=j(b["ft_labels"]), adapter=j(b["ft_adapter"]),
                    weight=j(b["ft_weight"]), aux_embed=aux("ft_aux")),
             pf=JPF(tokens=j(b["pf_tokens"]), length=j(b["pf_length"]),
                    adapter=j(b["pf_adapter"]), aux_embed=aux("pf_aux")),
             dec=JDEC(tokens=j(b["dec_tokens"]), pos=j(b["dec_pos"]),
                      adapter=j(b["dec_adapter"])))
    out = JM.unified_forward(jcfg, jparams, jb, {"layers": layers},
                             loras=store.bank, lora_scale=store.scale)
    # the second step: every row decodes, the prefill rows at their next
    # position
    b["dec2_tokens"] = rng.integers(0, jcfg.vocab, (N_ROWS,)).astype(
        np.int32)
    b["dec2_pos"] = np.concatenate([b["dec_pos"] + 1,
                                    b["pf_length"]]).astype(np.int32)
    b["dec2_adapter"] = np.concatenate([b["dec_adapter"],
                                        b["pf_adapter"]]).astype(np.int32)
    out2 = JM.unified_forward(
        jcfg, jparams, JUB(dec=JDEC(tokens=j(b["dec2_tokens"]),
                                    pos=j(b["dec2_pos"]),
                                    adapter=j(b["dec2_adapter"]))),
        out.cache, loras=store.bank, lora_scale=store.scale)
    for k, v in b.items():
        z[f"{name}/{k}"] = v
    z[f"{name}/arch"] = np.asarray(arch)
    if window:
        z[f"{name}/window"] = np.asarray(window)
    if heads:
        z[f"{name}/heads"] = np.asarray(heads)
    if ssm:
        z[f"{name}/ssm"] = np.asarray(ssm)
    if cf is not None:
        z[f"{name}/cf"] = np.asarray(cf)
    z[f"{name}/scale"] = np.asarray(store.scale, np.float32)
    for k in ("pf_logits", "dec_logits", "ft_loss_sum", "ft_tok_count",
              "aux_loss"):
        z[f"{name}/ref_{k}"] = np.asarray(getattr(out, k))
    z[f"{name}/ref_dec2_logits"] = np.asarray(out2.dec_logits)
    for k in names:
        z[f"{name}/ref_cache1_{k}"] = _port_leaves(jcfg, out.cache["layers"],
                                                   k)
        z[f"{name}/ref_cache2_{k}"] = _port_leaves(jcfg,
                                                   out2.cache["layers"], k)


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_families")
    z = {"lora_r": np.asarray(LORA_R)}
    for name, case in CASES.items():
        _jax_case(tmp, name, *case, z, ssm=SSM.get(name))
    np.savez(tmp / "case.npz", **z)
    return tmp


@pytest.fixture(scope="module")
def run_1x4(case_dir):
    return _spawn(case_dir, (1, 4), RUN_1X4 + [FAULT, RT] + FAULTS,
                  SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def run_2x2(case_dir):
    return _spawn(case_dir, (2, 2), RUN_2X2 + [RT], SPAWN_TIMEOUT_S)


def _within(res):
    for k, (e_jax, e_one) in res["errs"].items():
        assert e_jax < W.TOL and e_one < W.TOL, (k, e_jax, e_one)


def _layout(res, case, i):
    kind, rest = case.split(":")
    want = LAYOUT.get((rest.split(",")[0], kind))
    if want is not None:
        assert set(res["layouts"].values()) == {want[i]}, res["layouts"]
    if kind == "seq" and rest.startswith("dsv2"):
        assert res["same_as_auto"]


@pytest.mark.parametrize("case", RUN_1X4)
def test_sharded_families_1x4_match_jax(run_1x4, case):
    res = run_1x4[case]
    _within(res)
    _layout(res, case, 0)
    if case.startswith("fam:dsv2"):
        # the expert-parallel MoE, and the latent merge's all-to-all
        assert res["branch"] == "expert_parallel"
        assert res["coll"]["all-to-all"] > 0
    if case.startswith("seq:"):
        # every head's partials to its rank
        assert res["coll"]["all-to-all"] > 0


@pytest.mark.parametrize("case", RUN_2X2)
def test_sharded_families_2x2_match_jax(run_2x2, case):
    res = run_2x2[case]
    _within(res)
    _layout(res, case, 1)
    if case.endswith("fsdp_tp"):
        # the layer weights come whole over "data" just before each layer
        tp = run_2x2.get(case.replace("fsdp_tp", "tp"))
        if tp is not None:
            assert res["coll"]["all-gather"] > tp["coll"]["all-gather"]


def test_planted_mla_fault_is_caught(run_1x4):
    """Model ranks 1-3 drop their MLA decode partials: the decode logits
    of both steps leave the tolerance; the ft and prefill rows, which
    attend over their own fresh latent, do not."""
    errs = run_1x4[FAULT]["errs"]
    for k in ("dec_logits", "dec2_logits"):
        e_jax, e_one = errs[k]
        assert e_jax > W.TOL and e_one > W.TOL, (k, e_jax, e_one)
    for k in ("pf_logits", "ft_loss_sum"):
        assert max(errs[k]) < W.TOL, (k, errs[k])


# each planted fault: the outputs that must leave the tolerance, and those
# that must stay within it
FAULT_EFFECTS = {
    # every row's gated norm is off on 3/4 of its channels (by 2x: a
    # quarter of the squares taken for the whole d_inner's)
    "fault_norm:mamba2,tp": (("pf_logits", "dec_logits", "ft_loss_sum",
                              "dec2_logits"), ()),
    # the prefill rows' latent lands in the wrong slots: their cache and
    # their next decode, not the rows that attend over their fresh latent
    # nor the decode rows, which prefill never writes
    "fault_roll:dsv2_window,tp": (("cache1_ckv", "cache1_kpe",
                                   "dec2_logits"),
                                  ("pf_logits", "ft_loss_sum",
                                   "dec_logits"))}


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_ssm_and_window_faults_are_caught(run_1x4, fault):
    """Model ranks 1-3 skip the all-reduce of the gated norm's sum of
    squares (each takes its own d_inner slice's), or write their slots of
    the window's rolling latent rows unrolled (slot ``s0 + j`` given
    position ``s0 + j``, not the last one the row's roll leaves there)."""
    errs = run_1x4[fault]["errs"]
    broken, kept = FAULT_EFFECTS[fault]
    for k in broken:
        e_jax, e_one = errs[k]
        assert e_jax > W.TOL and e_one > W.TOL, (k, e_jax, e_one)
    for k in kept:
        assert max(errs[k]) < W.TOL, (k, errs[k])


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_cache_round_trips_every_leaf_kind(run_1x4, run_2x2, shape):
    """``gather_cache(shard_cache(c)) == c`` bit for bit under both
    strategies; a k/v shard of the "auto" layout (the head dim at (1, 4),
    the KV heads at (2, 2)) is refused by the "seq" gather and step."""
    same, refused = (run_1x4 if shape == "1x4" else run_2x2)[RT]
    assert len(same) == 10 and all(same.values()), same
    assert set(refused) == {"vlm", "window", "jamba"}, refused
