"""The port's sharded forward on a CPU mesh of 4 ``gloo`` ranks against the
JAX package's single-device ``unified_forward`` on the same npz weights.

One spawn per mesh shape holds all its cases (``_torch_mesh_worker.run``):
``(2, 2)`` runs reduced llama3-8b and llama4-maverick under ``tp`` and
``fsdp_tp`` on a mixed ft + prefill + decode batch over dense rows, plus
``moe_apply_auto`` with drops and every ``ValueError`` case; ``(1, 4)`` runs
reduced deepseek-7b (8 KV heads) and ``moe_apply_auto``.  The ranks start
with ``init_method="file://..."`` (no fixed port: the suite runs under
xdist), one intra-op thread each, and every group and join has a timeout,
so a mismatched collective fails the test instead of hanging it.

Tolerances: the forward's gathered logits, ft loss sums, aux loss and cache
within 2e-4 abs of JAX's and of the port's one-process step (fp32; the
ranks sum their partial products in another order than one device does).
Maverick's capacity factor is 8.0, as JAX's own mesh test sets it, since an
expert-parallel rank packs its own tokens; its flat stream (68 tokens) is a
multiple of 4, so the expert-parallel branch runs, which the worker
asserts.  ``moe_apply_auto`` at capacity factor 1.0 is held to JAX's
``moe_apply_auto`` under a 4-device host mesh of the same shape (run in a
subprocess, as ``tests/test_distributed.py`` runs it): outputs within
1e-5, aux within 1e-6, and the same kept entries (JAX's drop rule,
``moe_dist.py:100-109``, evaluated per chip beside it).
"""
import json
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_mesh_worker as W
from _torch_bridge import j
from repro.checkpoint.io import save_pytree
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LORA_R = 4
# name: (arch, capacity factor, seed, decode rows, the MoE branch); 3
# decode rows do not divide the data axis, so every data rank runs that
# bucket whole (and maverick's flat stream, 35 tokens a data rank, takes
# JAX's moe_apply branch)
CASES = {"llama_tp": ("llama3-8b", None, 0, 4, None),
         "maverick": ("llama4-maverick-400b-a17b", 8.0, 1, 4,
                      "expert_parallel"),
         "deepseek": ("deepseek-7b", None, 2, 4, None),
         "llama_odd": ("llama3-8b", None, 3, 3, None),
         "maverick_odd": ("llama4-maverick-400b-a17b", 8.0, 4, 3,
                          "moe_apply")}
# moe_apply_auto at capacity factor 1.0: T tokens, d, E experts, top-k, f
MOE = dict(T=64, d=32, E=8, k=2, f=48)


def _batch(rng, V, Bf=2, Sf=16, Bp=2, Sp=16, Bd=4):
    ft_tok = rng.integers(0, V, (Bf, Sf)).astype(np.int32)
    ft_mask = np.ones((Bf, Sf), bool)
    ft_mask[1, 11:] = False
    labels = ft_tok.copy()
    labels[0, 3] = -100
    pf_tok = rng.integers(0, V, (Bp, Sp)).astype(np.int32)
    return {"ft_tokens": ft_tok, "ft_mask": ft_mask,
            "ft_labels": labels.astype(np.int32),
            "ft_adapter": np.asarray([0, 1], np.int32),
            "ft_weight": np.asarray([1.0, 0.5], np.float32),
            "pf_tokens": pf_tok, "pf_length": np.asarray([13, 9], np.int32),
            "pf_adapter": np.asarray([1, -1], np.int32),
            "dec_tokens": rng.integers(0, V, (Bd,)).astype(np.int32),
            "dec_pos": np.asarray([9, 13, 5, 0][:Bd], np.int32),
            "dec_adapter": np.asarray([0, -1, 1, 0][:Bd], np.int32)}


def _jax_case(tmp, name, arch, cf, seed, bd, branch, z):
    jcfg = j_get_reduced(arch)
    if cf is not None:
        import dataclasses
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe,
                                                    capacity_factor=cf))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(seed))
    store = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=LORA_R),
                          jax.random.PRNGKey(seed + 10))
    store.load_random("a0", jax.random.PRNGKey(seed + 11))
    store.load_random("a1", jax.random.PRNGKey(seed + 12))
    save_pytree(str(tmp / f"{name}_params.npz"), jparams)
    save_pytree(str(tmp / f"{name}_bank.npz"), store.bank)
    rng = np.random.default_rng(seed)
    b = _batch(rng, jcfg.vocab, Bd=bd)
    n_rows, s_max = 6, 32
    jcache = JM.init_cache(jcfg, n_rows, s_max)
    P = len(jcfg.pattern)
    layers = []
    for pos, c in enumerate(jcache["layers"]):
        c = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)
                            * 0.5) for k, v in c.items()}
        layers.append(c)
    jcache = {"layers": tuple(layers)}
    for kv in ("k", "v"):   # the port's layout: layer li = period * P + pos
        z[f"{name}/cache0_{kv}"] = np.stack([
            np.asarray(layers[li % P][kv][li // P])
            for li in range(jcfg.n_layers)])
    jb = JUB(ft=JFT(tokens=j(b["ft_tokens"]), mask=j(b["ft_mask"]),
                    labels=j(b["ft_labels"]), adapter=j(b["ft_adapter"]),
                    weight=j(b["ft_weight"])),
             pf=JPF(tokens=j(b["pf_tokens"]), length=j(b["pf_length"]),
                    adapter=j(b["pf_adapter"])),
             dec=JDEC(tokens=j(b["dec_tokens"]), pos=j(b["dec_pos"]),
                      adapter=j(b["dec_adapter"])))
    out = JM.unified_forward(jcfg, jparams, jb, jcache, loras=store.bank,
                             lora_scale=store.scale)
    for k, v in b.items():
        z[f"{name}/{k}"] = v
    z[f"{name}/arch"] = np.asarray(arch)
    if cf is not None:
        z[f"{name}/cf"] = np.asarray(cf)
    if branch is not None:
        z[f"{name}/branch"] = np.asarray(branch)
    z[f"{name}/scale"] = np.asarray(store.scale, np.float32)
    for k in ("pf_logits", "dec_logits", "ft_loss_sum", "ft_tok_count",
              "aux_loss"):
        z[f"{name}/ref_{k}"] = np.asarray(getattr(out, k))
    for kv in ("k", "v"):
        z[f"{name}/ref_cache_{kv}"] = np.stack([
            np.asarray(out.cache["layers"][li % P][kv][li // P])
            for li in range(jcfg.n_layers)])


_JAX_MOE = """
import json, math, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.distributed.sharding import mesh_context
from repro.models.configs import MoEConfig
from repro.models.moe_dist import moe_apply_auto
z = np.load(sys.argv[1])
E, k, f = (int(v) for v in z["moe_dims"])
m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=1.0)
x = jnp.asarray(z["moe_x"])
p = {n: jnp.asarray(z["moe_" + n]) for n in ("router", "w_gate", "w_up",
                                           "w_down")}
out = {}
for shape in ((1, 4), (2, 2)):
    mesh = jax.make_mesh(shape, ("data", "model"))
    for fsdp in (False, True):
        with mesh_context(mesh):
            y, aux = jax.jit(lambda a, b: moe_apply_auto(a, b, m, fsdp=fsdp))(
                x, p)
        # JAX's drop rule (moe_dist.py:100-109), per chip, data-major
        chips = shape[0] * shape[1]
        Tc = x.shape[0] // chips
        cap = max(int(math.ceil(Tc * k / E * m.capacity_factor)), 1)
        kept = []
        for c in range(chips):
            xb = x[c * Tc:(c + 1) * Tc]
            pr = jax.nn.softmax((xb @ p["router"]).astype(jnp.float32), -1)
            _, idx = jax.lax.top_k(pr, k)
            flat_e = idx.reshape(-1)
            order = jnp.argsort(flat_e)
            sorted_e = flat_e[order]
            seg = jnp.searchsorted(sorted_e, jnp.arange(E, dtype=sorted_e.dtype))
            pos_sorted = jnp.arange(Tc * k, dtype=jnp.int32) - seg[sorted_e]
            pos = jnp.zeros((Tc * k,), jnp.int32).at[order].set(pos_sorted)
            kept.append(np.asarray(pos < cap))
        key = f"moe_{shape[0]}x{shape[1]}_{int(fsdp)}"
        np.save(sys.argv[2] + key + "_y.npy", np.asarray(y))
        np.save(sys.argv[2] + key + "_kept.npy",
                np.concatenate(kept).astype(np.int32))
        out[key] = float(aux)
print(json.dumps(out))
"""


def _jax_moe(tmp, z):
    rng = np.random.default_rng(7)
    T, d, E, k, f = (MOE[n] for n in ("T", "d", "E", "k", "f"))
    z["moe_dims"] = np.asarray([E, k, f])
    z["moe_x"] = rng.standard_normal((T, d)).astype(np.float32)
    z["moe_router"] = rng.standard_normal((d, E)).astype(np.float32) * 0.5
    for n, shp in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                   ("w_down", (E, f, d))):
        z[f"moe_{n}"] = rng.standard_normal(shp).astype(np.float32) * 0.05
    np.savez(tmp / "moe_in.npz", **{k_: v for k_, v in z.items()
                                    if k_.startswith("moe_")})
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4")
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_MOE),
                          str(tmp / "moe_in.npz"), str(tmp) + os.sep],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    aux = json.loads(out.stdout.strip().splitlines()[-1])
    for key, a in aux.items():
        z[f"{key}/y"] = np.load(tmp / f"{key}_y.npy")
        z[f"{key}/kept"] = np.load(tmp / f"{key}_kept.npy")
        z[f"{key}/aux"] = np.asarray(a)


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    z = {"lora_r": np.asarray(LORA_R)}
    for name, case in CASES.items():
        _jax_case(tmp, name, *case, z)
    _jax_moe(tmp, z)
    np.savez(tmp / "case.npz", **z)
    return tmp


def _spawn(tmp, shape, cases, timeout_s=240):
    """Run ``_torch_mesh_worker.run`` on 4 gloo ranks; returns rank 0's
    results.  A rank that raises fails the spawn with its traceback; a
    spawn that outlives ``timeout_s`` is killed and fails."""
    ctx = mp.start_processes(W.run, args=(4, str(tmp), shape, cases),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the {shape} spawn outlived {timeout_s} s")
    with open(tmp / f"result_{shape[0]}x{shape[1]}_0.json") as fh:
        return json.load(fh)


FWD_2X2 = [f"fwd:{n},{s}" for n in ("llama_tp", "maverick")
           for s in ("tp", "fsdp_tp")] + ["fwd:llama_odd,tp",
                                          "fwd:maverick_odd,fsdp_tp"]


@pytest.fixture(scope="module")
def run_2x2(case_dir):
    return _spawn(case_dir, (2, 2), FWD_2X2 + ["moe:0", "moe:1", "errors:"])


@pytest.fixture(scope="module")
def run_1x4(case_dir):
    return _spawn(case_dir, (1, 4), ["fwd:deepseek,tp", "moe:0", "moe:1"])


@pytest.mark.parametrize("case", FWD_2X2)
def test_sharded_forward_2x2_matches_jax(run_2x2, case):
    res = run_2x2[case]
    for k, (e_jax, e_one) in res["errs"].items():
        assert e_jax < W.TOL and e_one < W.TOL, (k, e_jax, e_one)
    if case.startswith("fwd:maverick,"):
        assert res["branch"] == "expert_parallel"
        assert res["coll"]["all-to-all"] > 0
    if case.startswith("fwd:maverick_odd"):
        assert res["branch"] == "moe_apply"
    if case.endswith("fsdp_tp") and "_odd" not in case:
        # the layer weights come whole over "data" just before each layer
        assert res["coll"]["all-gather"] > run_2x2[
            case.replace("fsdp_tp", "tp")]["coll"]["all-gather"]


def test_sharded_forward_1x4_deepseek_matches_jax(run_1x4):
    for k, (e_jax, e_one) in run_1x4["fwd:deepseek,tp"]["errs"].items():
        assert e_jax < W.TOL and e_one < W.TOL, (k, e_jax, e_one)


@pytest.mark.parametrize("shape,fsdp", [((2, 2), 0), ((2, 2), 1),
                                        ((1, 4), 0), ((1, 4), 1)])
def test_moe_apply_auto_matches_jax_with_drops(run_2x2, run_1x4, shape,
                                               fsdp):
    res = (run_2x2 if shape == (2, 2) else run_1x4)[f"moe:{fsdp}"]
    assert res["err"] < 1e-5 and res["aux_err"] < 1e-6
    assert res["dropped"] > 0          # capacity factor 1.0 drops entries


def test_collective_bytes_equal_the_hand_count(run_2x2):
    got = run_2x2["fwd:llama_tp,tp"]
    assert got["coll"] == run_2x2["hand_count"]
    assert got["scaled"] == got["coll"]    # eager: raw equals scaled


@pytest.mark.parametrize("case", ["mla_heads", "paged", "verify", "grad",
                                  "grad_mla", "grad_mamba", "grad_cross"])
def test_unsharded_cases_raise(run_2x2, case):
    """Each case's ``ValueError`` names it (the worker checks the words);
    MoE and MLA with a gradient still raise, naming 5b-iii-b, while
    Mamba2 and cross-attention layers with a gradient (``grad_mamba``,
    ``grad_cross``) now run with every grad leaf finite."""
    got = run_2x2["errors:"][case]
    if case in ("grad_mamba", "grad_cross"):
        assert got.endswith("grad leaves, all finite"), got
    else:
        assert got

