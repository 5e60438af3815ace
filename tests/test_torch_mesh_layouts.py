"""The head-dim and sequence cache layouts of the port's sharded forward on a
CPU mesh of 4 ``gloo`` ranks, against the JAX package's single-device
``unified_forward`` on the same npz weights.

Configs whose heads do not divide the model axis of 4, cut from the
reduced ones (JAX's schema takes ``n_heads * head_dim != d_model``):
phi3 with 12 query / 3 KV heads of 32 (wq cut, 3 query heads a rank, so a
rank's heads straddle KV groups of 4; wk/wv whole; KV rows cut by the head
dim), llama3 with 6 / 2 heads (wq/wo whole too: every rank runs every
head) and whisper-base with 2 / 2 heads (its encoder and cross heads
whole, ``xk``/``xv`` cut by the head dim); reduced llama3 (8 / 2 heads)
under ``cache_strategy="seq"`` at ``(1, 4)`` (KV heads whole) and ``(2,
2)`` (KV heads cut, so prefill's K/V reach their slots' ranks in one
all-to-all).  Each case is two steps on dense rows, as in
``tests/test_torch_mesh_families.py`` (``_torch_mesh_worker.family_case``).

Tolerance ``W.TOL`` = 2e-4 abs (fp32) on the logits, ft loss sums, aux loss
and the gathered cache of both steps.  Two planted faults must break it:
model ranks 1-3 hand zeros to the partial-score all-reduce of the head-dim
layout, and drop their slot partials under the sequence layout.  Also:
``gather_cache(shard_cache(c)) == c`` bit for bit under both strategies; a
shard of one layout refused (``ValueError`` naming both) by
``gather_cache`` and the step of the other; ``core.lora.dense_row`` with
``wo`` whole and its LoRA ``a`` cut against the one-device ``dense``.
"""
import numpy as np
import pytest

import _torch_mesh_worker as W
from test_torch_mesh import LORA_R, _spawn
from test_torch_mesh_families import _jax_case

# name: (arch, seed, int8, window, capacity factor, (h, g, hd))
CASES = {"llama": ("llama3-8b", 26, False, 0, None, None),
         "phi3h": ("phi3-medium-14b", 27, False, 0, None, (12, 3, 32)),
         "llama6": ("llama3-8b", 28, False, 0, None, (6, 2, 32)),
         "whisper2": ("whisper-base", 29, False, 0, None, (2, 2, 32))}
RT = "rt:llama,phi3h,llama6,whisper2"
RUN_1X4 = ["fam:phi3h,tp", "fam:llama6,tp", "fam:whisper2,tp",
           "seq:llama,tp", "seq:llama6,tp"]
RUN_2X2 = ["fam:phi3h,fsdp_tp", "seq:llama,tp", "seq:llama,fsdp_tp"]
FAULTS = ["fault_hd:phi3h,tp", "fault_seq:llama,tp"]
# the layout of each case's KV (and cross) rows
LAYOUT = {"fam:phi3h": "head_dim", "fam:llama6": "head_dim",
          "fam:whisper2": "head_dim", "seq:llama": "seq",
          "seq:llama6": "seq"}
SPAWN_TIMEOUT_S = 150


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_layouts")
    z = {"lora_r": np.asarray(LORA_R)}
    for name, (*case, heads) in CASES.items():
        _jax_case(tmp, name, *case, z, heads=heads)
    np.savez(tmp / "case.npz", **z)
    return tmp


@pytest.fixture(scope="module")
def run_1x4(case_dir):
    return _spawn(case_dir, (1, 4), RUN_1X4 + FAULTS + [RT, "row:"],
                  SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def run_2x2(case_dir):
    return _spawn(case_dir, (2, 2), RUN_2X2 + [RT], SPAWN_TIMEOUT_S)


def _checked(res, case):
    for k, (e_jax, e_one) in res["errs"].items():
        assert e_jax < W.TOL and e_one < W.TOL, (k, e_jax, e_one)
    assert set(res["layouts"].values()) == {LAYOUT[case.split(",")[0]]}, \
        res["layouts"]


@pytest.mark.parametrize("case", RUN_1X4)
def test_layouts_1x4_match_jax(run_1x4, case):
    res = run_1x4[case]
    _checked(res, case)
    coll = res["coll"]
    if case.startswith("seq:llama,"):
        # query heads cut: every head's partials to its rank
        assert coll["all-to-all"] > 0
    if case.startswith("seq:llama6"):
        # query heads whole: every rank merges every head, no all-to-all
        assert coll["all-to-all"] == 0 and coll["all-gather"] > 0


@pytest.mark.parametrize("case", RUN_2X2)
def test_layouts_2x2_match_jax(run_2x2, case):
    res = run_2x2[case]
    if case.startswith("fam:phi3h"):
        # 3 KV heads do not divide 2: the head dim again
        assert set(res["layouts"].values()) == {"head_dim"}
        for k, (e_jax, e_one) in res["errs"].items():
            assert e_jax < W.TOL and e_one < W.TOL, (k, e_jax, e_one)
        return
    _checked(res, case)
    # 2 KV heads a model rank of 1: prefill's K/V go to their slots' ranks
    assert res["coll"]["all-to-all"] > 0


@pytest.mark.parametrize("case", FAULTS)
def test_planted_layout_faults_are_caught(run_1x4, case):
    """The decode logits of both steps leave the tolerance; the ft and
    prefill rows, which attend over their own fresh K/V, do not."""
    errs = run_1x4[case]["errs"]
    for k in ("dec_logits", "dec2_logits"):
        e_jax, e_one = errs[k]
        assert e_jax > W.TOL and e_one > W.TOL, (k, e_jax, e_one)
    for k in ("pf_logits", "ft_loss_sum"):
        assert max(errs[k]) < W.TOL, (k, errs[k])


@pytest.mark.parametrize("shape", ["1x4", "2x2"])
def test_cache_round_trips_both_strategies(run_1x4, run_2x2, shape):
    same, refused = (run_1x4 if shape == "1x4" else run_2x2)[RT]
    assert len(same) == 2 * len(CASES) and all(same.values()), same
    # every case's "auto" layout (the head dim at (1, 4); at (2, 2) the KV
    # heads, phi3h's head dim) differs from "seq"
    assert set(refused) == set(CASES), refused


def test_dense_row_whole_base_matches_dense(run_1x4):
    assert run_1x4["row:"] < W.TOL
