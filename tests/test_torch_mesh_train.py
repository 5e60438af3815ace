"""The port's grad and train steps under a mesh on 4 ``gloo`` ranks against
the JAX package's single-device ``make_grad_step`` / ``make_train_step`` on
the same npz weights, bank and batch, in fp32.

One spawn per mesh shape holds all its cases (``_torch_mesh_worker.
train_case``).  At ``(1, 4)`` ``tp``: reduced llama3-8b (8 query / 2 KV
heads: ``wq`` cut, ``wk`` / ``wv`` whole, so each rank's query heads read
part of K and V, and the cut LoRA ``b`` of ``wk`` / ``wv`` is all-gathered),
the 6-head llama of ``tests/test_torch_mesh_layouts.py`` (``wq`` / ``wo``
whole: every rank runs every head), reduced deepseek-7b (every count
divides), a mixed ft + prefill + decode batch on dense rows under
``cache_strategy`` "auto" (KV rows cut by the head dim) and "seq", the ft
attention in chunks of 8 (``torch.utils.checkpoint``) and a sliding window
of 8.  At ``(2, 2)``: llama under ``tp`` and ``fsdp_tp`` with its 4 ft rows
split over "data", a 3-row bucket that every data rank runs whole, the
mixed batch under ``fsdp_tp`` "auto" and ``tp`` "seq", reduced
command-r-35b under ``fsdp_tp`` (its head is the tied embedding, cut over
"data" and gathered again in the backward), and the saved tensors of an
``fsdp_tp`` grad step.  Each ``train:`` case also takes one
``make_train_step``: one slot masked, ``grad_clip`` far below the gradient
norm so that the clip engages (asserted), the new bank and moments gathered
whole.

Tolerances (fp32; the ranks sum their partial products in another order
than one device, and the port's kernels' plain versions in another order
than XLA): the loss within ``W.TRAIN_LOSS_TOL`` = 1e-4 abs; each grad
leaf, each moment leaf and each new bank leaf within ``W.TRAIN_TOL`` = 2e-4
of that leaf's max abs (the tolerance ``tests/test_torch_train.py`` holds
the one-device grad step to).  AdamW's first step per element is ``g /
(|g| + eps)``, whose slope ``1 / eps`` turns a rounding difference of a
near-zero gradient into a step difference of order ``lr``; the cases take
``eps`` = 1e-5, so a gradient difference of 1e-7 moves a weight by at most
``lr * 1e-2`` = 1e-5, under 2e-4 of a leaf's max (~0.1).  Four planted
faults, each at least 10x its tolerance: model ranks 1-3 take the identity
for the backward's shrink all-reduce (``ops.reduce_gs``), the bank's
gradients not summed over the batch axes (``sharding.reduce_bank_grads``),
the clip's sum of squares without its sum over "model"
(``optimizer.clip_sumsq``, seen on the moments), and the sequence-sharded
carry's cut giving back only a rank's own block of the gradient
(``sharding.cut_grad``, seen on the train step's moments).

Remat (``REMAT``, references from JAX's ``remat=True`` steps): the grad
step with ``remat`` and the train step with ``remat`` and
``act_constraint_fn(mesh)``, whose carry between periods is a rank's block
of the tokens: over "model" at ``(1, 4)`` (4 ft rows, and a mixed batch of
67 tokens, which the cut pads), over "model" at ``(2, 2)`` where the ft
rows are split over "data" (4 rows; the mixed batch's 35 local tokens
over 2), over ("data", "model") where no bucket is (3 rows).  The saved
tensors of a remat train step at ``(1, 4)`` show the carry's block [T/4,
d] saved once a period in place of the whole [T, d] (``REMAT_HOOKS``).

The other families (ROADMAP 5b-iii-a), against JAX's steps on weights
that ``tests/test_torch_mesh_families.py`` would draw (a cross layer's
gate opened to 0.5, the bank over ``xwq`` / ``xwo`` too, int8 through
JAX's ``quantize_params``): reduced mamba2-1.3b (16 SSM heads, 4 a rank at
``(1, 4)``) on ft rows and on a mixed batch whose cache after the step
(prefill's final states, the decode rows advanced once) is held to JAX's
as well; at d_model 192 with 6 SSM heads of 64 (every rank runs the whole
mixer); ``mamba_live``, the SSM path awake (``_live``); reduced whisper-base
(encoder and cross layers), llama-3.2-vision-90b and int8 llama3-8b; remat
with ``act_constraint`` for mamba2 (ft and mixed) and the VLM; at ``(2,
2)`` ``fsdp_tp`` with the 4 ft rows split over "data".  Two more planted
faults: Mamba2's gated-norm sum of squares with the identity as its
adjoint (``gsq``), and the ``in_bc`` / ``in_dt`` products' input gradient
not summed over "model" (``ssm``, on ``mamba_live``).  An int8 ``fsdp_tp``
grad step saves int8 shards and scales and no whole leaf (``HOOKS_Q8``);
the encoder's collectives carry no gradient (``ENCODER``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_mesh_worker as W
from _torch_bridge import j
from test_torch_mesh import LORA_R, _spawn
from test_torch_mesh_families import TARGETS, _gated, _jcfg, _port_leaves
from repro.checkpoint.io import save_pytree
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_grad_step, \
    make_train_step as j_train_step
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM
from repro.models import quant as JQ
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro.training.optimizer import AdamWConfig as JAdamW, \
    adamw_init as j_adamw_init

# name: (arch, seed, ft rows, (h, g, hd), window, attn_chunk, mixed, train)
CASES = {"llama": ("llama3-8b", 50, 4, None, 0, 0, False, True),
         "llama3": ("llama3-8b", 51, 3, None, 0, 0, False, True),
         "llama6": ("llama3-8b", 52, 4, (6, 2, 32), 0, 0, False, True),
         "deepseek": ("deepseek-7b", 53, 4, None, 0, 0, False, True),
         "mixed": ("llama3-8b", 54, 2, None, 0, 0, True, False),
         "chunk": ("llama3-8b", 55, 4, None, 0, 8, False, False),
         "window": ("llama3-8b", 56, 4, None, 8, 0, False, False),
         "cmdr": ("command-r-35b", 57, 4, None, 0, 0, False, False),
         # the other families (ROADMAP 5b-iii-a)
         "mamba2": ("mamba2-1.3b", 61, 4, None, 0, 0, False, True),
         "mamba_mixed": ("mamba2-1.3b", 62, 2, None, 0, 0, True, False),
         "mamba_whole": ("mamba2-1.3b", 63, 4, None, 0, 0, False, False),
         "whisper": ("whisper-base", 64, 4, None, 0, 0, False, True),
         "vlm": ("llama-3.2-vision-90b", 65, 4, None, 0, 0, False, True),
         "llama_q8": ("llama3-8b", 66, 4, None, 0, 0, False, True),
         "mamba_live": ("mamba2-1.3b", 70, 4, None, 0, 0, False, True)}
# a case's other changes: int8 weights (JAX's ``quantize_params``);
# (d_model, SSM head dim): 6 SSM heads of 64 that do not divide a model
# axis of 4, so every rank runs the whole mixer; ``live``: the SSM path
# awake (``_live``)
OPTS = {"llama_q8": dict(int8=True), "mamba_whole": dict(ssm=(192, 64)),
        "mamba_live": dict(live=True)}
# remat cases (JAX's references with ``remat=True``; the port's grad step
# with ``remat``, its train step with ``remat`` and ``act_constraint_fn``):
# name: (a CASES tuple, decode rows of the mixed batch).  "rmixed" has 2 ft
# rows of 16, 2 prompts of 16 and 3 decode rows: 67 tokens, which neither
# 4 nor (at (2, 2), its 3 decode rows run whole) 35 over 2 divides
REMAT = {"rllama": (("llama3-8b", 58, 4, None, 0, 0, False, True), 4),
         "rllama3": (("llama3-8b", 59, 3, None, 0, 0, False, True), 4),
         "rmixed": (("llama3-8b", 60, 2, None, 0, 0, True, True), 3),
         "rmamba2": (("mamba2-1.3b", 67, 4, None, 0, 0, False, True), 4),
         "rmamba_mixed": (("mamba2-1.3b", 68, 2, None, 0, 0, True, True),
                          3),
         "rvlm": (("llama-3.2-vision-90b", 69, 4, None, 0, 0, False, True),
                  4)}
RUN_1X4 = ["train:llama,tp", "train:llama6,tp", "train:deepseek,tp",
           "grad:mixed,tp,auto", "grad:mixed,tp,seq", "grad:chunk,tp",
           "grad:window,tp", "remat:rllama,tp", "remat:rmixed,tp",
           # the other families (ROADMAP 5b-iii-a)
           "train:mamba2,tp", "train:mamba_live,tp", "grad:mamba_mixed,tp",
           "grad:mamba_whole,tp",
           "train:whisper,tp", "train:vlm,tp", "train:llama_q8,tp",
           "remat:rmamba2,tp", "remat:rmamba_mixed,tp", "remat:rvlm,tp"]
RUN_2X2 = ["train:llama,tp", "train:llama,fsdp_tp", "train:llama3,tp",
           "grad:mixed,fsdp_tp,auto", "grad:mixed,tp,seq",
           "grad:cmdr,fsdp_tp", "remat:rllama,fsdp_tp", "remat:rllama3,tp",
           "remat:rmixed,fsdp_tp",
           "train:mamba2,fsdp_tp", "train:mamba_live,fsdp_tp",
           "grad:mamba_mixed,fsdp_tp",
           "train:whisper,fsdp_tp", "train:vlm,fsdp_tp",
           "train:llama_q8,fsdp_tp", "remat:rvlm,fsdp_tp"]
FAULTS_1X4 = ["fault_shrink:llama,tp", "fault_clip:llama,tp",
              "fault_cut:rllama,tp", "fault_gsq:mamba2,tp",
              "fault_ssm:mamba_live,tp"]
FAULTS_2X2 = ["fault_batch:llama,tp"]
HOOKS = "hooks:llama,fsdp_tp"
HOOKS_Q8 = "hooks:llama_q8,fsdp_tp"
ENCODER = "encoder:whisper,fsdp_tp"
REMAT_HOOKS = "remat_hooks:rllama,tp"
SPAWN_TIMEOUT_S = 150
SF, N_ROWS, S_MAX = 16, 6, 32


def _ft(rng, V, rows):
    toks = rng.integers(0, V, (rows, SF)).astype(np.int32)
    mask = np.ones((rows, SF), bool)
    mask[1, 11:] = False
    labels = toks.copy()
    labels[0, 3] = -100
    return {"ft_tokens": toks, "ft_mask": mask,
            "ft_labels": labels.astype(np.int32),
            "ft_adapter": np.asarray([0, 1, -1, 0][:rows], np.int32),
            "ft_weight": np.asarray([1.0, 0.5, 0.25, 0.75][:rows],
                                    np.float32)}


def _live(jparams):
    """Mamba2's SSM path awake.  The schema draws the convs' weights at
    its std cap of 0.02, so B, C and the state are ~1e-4 of the skip path
    and the gradient that reaches the input through ``in_bc`` / ``in_dt``
    is ~1e-5 of the rest, under the tolerance: a fault there would not
    show.  Here the convs take std 0.5 (1 / sqrt(conv_width)) and every
    head dt = 0.25 (``dt_bias`` = log(expm1(0.25))): that gradient is ~2 %
    of the input's.  (A larger dt overflows the chunked scan's fp32
    decays: A * dt over a chunk of 16 reaches -88 at dt = 0.34.)"""
    return dict(jparams, blocks=tuple(
        dict(b, conv_x=b["conv_x"] * 25.0, conv_bc=b["conv_bc"] * 25.0,
             dt_bias=jnp.full_like(b["dt_bias"], np.log(np.expm1(0.25))))
        if "conv_x" in b else b for b in jparams["blocks"]))


def _jax_case(tmp, name, arch, seed, rows, heads, window, chunk, mixed,
              train, z, remat=False, n_dec=4, int8=False, ssm=None,
              live=False):
    jcfg = _jcfg(arch, window, None, heads, ssm)
    cross = jcfg.cross_attn_every > 0 or jcfg.encoder is not None
    # a cross layer's gate opened to 0.5 (JAX draws it as zero), and the
    # bank over xwq / xwo too
    jparams = _gated(j_init_params(jcfg, jax.random.PRNGKey(seed)))
    if live:
        jparams = _live(jparams)
    if int8:
        jparams = JQ.quantize_params(jcfg, jparams)
    lcfg = JLoRAConfig(n_slots=4, r=LORA_R,
                       **(dict(targets=TARGETS) if cross else {}))
    store = JAdapterStore(jcfg, lcfg, jax.random.PRNGKey(seed + 10))
    store.load_random("a0", jax.random.PRNGKey(seed + 11))
    store.load_random("a1", jax.random.PRNGKey(seed + 12))
    save_pytree(str(tmp / f"{name}_params.npz"), jparams)
    save_pytree(str(tmp / f"{name}_bank.npz"), store.bank)
    rng = np.random.default_rng(seed)
    b = _ft(rng, jcfg.vocab, rows)
    if cross:
        F = jcfg.encoder.n_frames if jcfg.encoder else jcfg.n_img_tokens
        b["ft_aux"] = rng.standard_normal((rows, F, jcfg.d_model)).astype(
            np.float32)
        if mixed:
            b["pf_aux"] = rng.standard_normal((2, F, jcfg.d_model)).astype(
                np.float32)
    aux = (lambda k: j(b[k])) if cross else (lambda k: None)
    ft = JFT(tokens=j(b["ft_tokens"]), mask=j(b["ft_mask"]),
             labels=j(b["ft_labels"]), adapter=j(b["ft_adapter"]),
             weight=j(b["ft_weight"]), aux_embed=aux("ft_aux"))
    jb, cache, names = JUB(ft=ft), None, ()
    if mixed:
        b.update(pf_tokens=rng.integers(0, jcfg.vocab, (2, 16)).astype(
                     np.int32), pf_length=np.asarray([13, 9], np.int32),
                 pf_adapter=np.asarray([1, -1], np.int32),
                 dec_tokens=rng.integers(0, jcfg.vocab, (n_dec,)).astype(
                     np.int32),
                 dec_pos=np.asarray([9, 13, 5, 0][:n_dec], np.int32),
                 dec_adapter=np.asarray([0, -1, 1, 0][:n_dec], np.int32))
        jb = JUB(ft=ft, pf=JPF(tokens=j(b["pf_tokens"]),
                               length=j(b["pf_length"]),
                               adapter=j(b["pf_adapter"]),
                               aux_embed=aux("pf_aux")),
                 dec=JDEC(tokens=j(b["dec_tokens"]), pos=j(b["dec_pos"]),
                          adapter=j(b["dec_adapter"])))
        layers = tuple({k: jnp.asarray(rng.standard_normal(v.shape).astype(
            np.float32) * 0.5) for k, v in c.items()}
            for c in JM.init_cache(jcfg, N_ROWS, S_MAX)["layers"])
        names = sorted({k for c in layers for k in c})
        for k in names:
            z[f"{name}/cache0_{k}"] = _port_leaves(jcfg, layers, k)
        cache = {"layers": layers}
    res = j_grad_step(jcfg, attn_chunk=chunk, remat=remat)(
        jparams, store.bank, store.scale, jb, cache)
    save_pytree(str(tmp / f"{name}_grads.npz"), res.grads)
    z[f"{name}/ref_loss"] = np.asarray(res.loss)
    if jcfg.ssm is not None:
        # the cache after the step: the state rows' prefill writes and
        # the decode rows' one step
        for k in names:
            z[f"{name}/ref_cache_{k}"] = _port_leaves(
                jcfg, res.out.cache["layers"], k)
    if train:
        opt = JAdamW(lr=W.TRAIN_OPT["lr"], eps=W.TRAIN_OPT["eps"],
                     grad_clip=W.TRAIN_OPT["grad_clip"])
        mask = j(np.asarray(W.TRAIN_SLOTS, np.int32))
        loss, nb, ns, _ = j_train_step(jcfg, opt, attn_chunk=chunk,
                                       remat=remat)(
            jparams, store.bank, store.scale, j_adamw_init(store.bank, 4),
            jb, mask, cache)
        save_pytree(str(tmp / f"{name}_newbank.npz"), nb)
        save_pytree(str(tmp / f"{name}_m.npz"), ns.m)
        save_pytree(str(tmp / f"{name}_v.npz"), ns.v)
        z[f"{name}/ref_tloss"] = np.asarray(loss)
        z[f"{name}/ref_t"] = np.asarray(ns.t)
    for k, v in b.items():
        z[f"{name}/{k}"] = v
    z[f"{name}/arch"] = np.asarray(arch)
    if heads:
        z[f"{name}/heads"] = np.asarray(heads)
    if window:
        z[f"{name}/window"] = np.asarray(window)
    if ssm:
        z[f"{name}/ssm"] = np.asarray(ssm)
    z[f"{name}/chunk"] = np.asarray(chunk)
    z[f"{name}/remat"] = np.asarray(remat)
    z[f"{name}/scale"] = np.asarray(store.scale, np.float32)


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    z = {"lora_r": np.asarray(LORA_R)}
    for name, case in CASES.items():
        _jax_case(tmp, name, *case, z, **OPTS.get(name, {}))
    for name, (case, n_dec) in REMAT.items():
        _jax_case(tmp, name, *case, z, remat=True, n_dec=n_dec)
    np.savez(tmp / "case.npz", **z)
    return tmp


@pytest.fixture(scope="module")
def run_1x4(case_dir):
    return _spawn(case_dir, (1, 4), RUN_1X4 + FAULTS_1X4 + [REMAT_HOOKS],
                  timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def run_2x2(case_dir):
    return _spawn(case_dir, (2, 2), RUN_2X2 + FAULTS_2X2 + [HOOKS, HOOKS_Q8,
                                                             ENCODER],
                  timeout_s=SPAWN_TIMEOUT_S)


def _check(res):
    assert res["loss"] < W.TRAIN_LOSS_TOL, res["loss"]
    for k, e in res["errs"].items():
        assert e < W.TRAIN_TOL, (k, e)


@pytest.mark.parametrize("case", RUN_1X4)
def test_train_step_1x4_matches_jax(run_1x4, case):
    res = run_1x4[case]
    _check(res)
    if case.startswith(("train:", "remat:")):
        # the clip engaged, and the masked slot kept its weights
        assert res["norm"] > 10 * W.TRAIN_OPT["grad_clip"], res["norm"]
        assert res["masked_same"]
        assert {"bank", "m", "v"} <= {k.split("/")[0] for k in res["errs"]}


@pytest.mark.parametrize("case", RUN_2X2)
def test_train_step_2x2_matches_jax(run_2x2, case):
    res = run_2x2[case]
    _check(res)
    if case.startswith(("train:llama,", "train:mamba2,", "train:whisper,",
                        "train:vlm,", "train:llama_q8,", "remat:rvlm,")):
        assert res["split"]             # 4 rows: each data rank runs 2
    if case.startswith(("train:llama3,", "remat:rllama3,")):
        assert not res["split"]         # 3 rows: every data rank runs 3
    if case.startswith("remat:"):
        assert {"bank", "m", "v"} <= {k.split("/")[0] for k in res["errs"]}


def test_layouts_of_the_mixed_cases(run_1x4, run_2x2):
    # llama's 2 KV heads at (1, 4): rows cut by the head dim under "auto"
    assert run_1x4["grad:mixed,tp,auto"]["layout"] == "head_dim"
    assert run_1x4["grad:mixed,tp,seq"]["layout"] == "seq"
    assert run_2x2["grad:mixed,fsdp_tp,auto"]["layout"] == "heads"


@pytest.mark.parametrize("case", FAULTS_1X4 + FAULTS_2X2)
def test_planted_faults_break_the_tolerance(run_1x4, run_2x2, case):
    res = (run_2x2 if case in FAULTS_2X2 else run_1x4)[case]
    worst = max(res["errs"].values())
    assert worst > 10 * W.TRAIN_TOL, (case, worst)


def test_fsdp_saves_no_gathered_leaf(run_2x2):
    res = run_2x2[HOOKS]
    assert res["n_saved"] > 0 and res["shards_saved"] > 0
    assert res["gathered_saved"] == [], res["gathered_saved"]
    # int8 leaves: their int8 shards and scales saved, no dequantized or
    # gathered whole leaf
    q8 = run_2x2[HOOKS_Q8]
    assert q8["int8_shards_saved"] > 0 and q8["scales_saved"] > 0, q8
    assert q8["gathered_saved"] == [], q8["gathered_saved"]


def test_the_encoders_collectives_carry_no_gradient(run_2x2):
    """Whisper's encoder under an ``fsdp_tp`` grad step at ``(2, 2)``: its
    gathers over "data" and all-reduces over "model" are all plain ones on
    tensors that carry no gradient, and its output carries none (neither
    the sources nor the encoder are trained)."""
    res = run_2x2[ENCODER]
    assert res["kinds"] == ["all-gather", "all-reduce"], res
    assert res["collectives"] > 0 and res["with_grad"] == [], res
    assert res["out_requires_grad"] == [False], res
    assert res["loss"] < W.TRAIN_LOSS_TOL, res


def test_the_mixed_mamba_cases_state_rows_match_jax(run_1x4, run_2x2):
    """The state rows after a mixed grad step (prefill's final states, the
    decode rows advanced once, with remat too) are among the leaves held
    to JAX's."""
    for run, case in ((run_1x4, "grad:mamba_mixed,tp"),
                      (run_1x4, "remat:rmamba_mixed,tp"),
                      (run_2x2, "grad:mamba_mixed,fsdp_tp")):
        errs = run[case]["errs"]
        assert {"cache/h", "cache/conv_x", "cache/conv_bc"} <= set(errs)


def test_remat_saves_the_carrys_block(run_1x4):
    """A remat train step at ``(1, 4)`` saves one carry a period: with
    ``act_constraint_fn`` this rank's block of the tokens [T/4, d] in place
    of the whole stream [T, d] that remat alone saves; nothing else moves
    (the head's tensors are the same in both)."""
    res = run_1x4[REMAT_HOOKS]
    cut, alone, n = res["cut"], res["alone"], res["layers"]
    assert res["n"] == 4
    assert cut["block"] - alone["block"] == n, res
    assert alone["whole"] - cut["whole"] == n, res
