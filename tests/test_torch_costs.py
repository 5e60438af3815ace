"""The port's analytical step cost (``repro_torch.models.costs``) and its
roofline (``repro_torch.roofline.analysis``) against the JAX package's.

* ``step_cost`` on every registry id at every ``SHAPES`` entry (through
  ``adapt_config``), on meshes (dp, tp) of (1, 1), (16, 16) and (32, 16),
  under both strategies: FLOPs, HBM bytes, collective bytes and every
  ``detail`` key within 1e-9 relative of JAX's;
* ``_lora_bytes`` counted through the port's per-layer targets equals JAX's
  count over its stacked leaves on every id, full and reduced;
* ``Roofline`` on the H100's constants: each term is JAX's term scaled by
  the ratio of the two chips' constants, ``dominant`` the largest scaled
  term and ``useful_flops_ratio`` JAX's.
"""
import math

import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS, get_config as j_get_config, \
    get_reduced as j_get_reduced
from repro.launch.shapes import SHAPES as J_SHAPES, \
    adapt_config as j_adapt_config
from repro.models import costs as jcosts
from repro.roofline import analysis as jra
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch.shapes import SHAPES, adapt_config
from repro_torch.models import costs
from repro_torch.roofline import analysis as ra

REL = 1e-9
MESHES = ((1, 1), (16, 16), (32, 16))
STRATEGIES = ("tp", "fsdp_tp")


def _close(got: float, want: float, what: str):
    assert math.isclose(got, want, rel_tol=REL, abs_tol=0.0), \
        (what, got, want)


def test_registry_and_shapes_match_jax():
    assert ARCH_IDS == J_ARCH_IDS and len(ARCH_IDS) == 11
    assert list(SHAPES) == list(J_SHAPES)
    for name, shape in SHAPES.items():
        j = J_SHAPES[name]
        assert (shape.kind, shape.seq_len, shape.global_batch) \
            == (j.kind, j.seq_len, j.global_batch)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"dp{m[0]}tp{m[1]}")
@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_step_cost_matches_jax(arch, shape, mesh, strategy):
    dp, tp = mesh
    s = SHAPES[shape]
    cfg = adapt_config(get_config(arch), s)
    jcfg = j_adapt_config(j_get_config(arch), J_SHAPES[shape])
    got = costs.step_cost(cfg, s.kind, s.seq_len, s.global_batch, dp=dp,
                          tp=tp, strategy=strategy)
    want = jcosts.step_cost(jcfg, s.kind, s.seq_len, s.global_batch, dp=dp,
                            tp=tp, strategy=strategy)
    _close(got.flops, want.flops, "flops")
    _close(got.hbm_bytes, want.hbm_bytes, "hbm_bytes")
    _close(got.coll_bytes, want.coll_bytes, "coll_bytes")
    assert got.detail.keys() == want.detail.keys()
    for k, v in want.detail.items():
        _close(got.detail[k], v, k)
    assert got.flops > 0 and got.hbm_bytes > 0


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_lora_bytes_match_jax(arch, reduced):
    """The grad all-reduce's LoRA bytes: MoE experts and the cross
    projections outside the default targets count on neither side, a
    shared expert's and every period's leaves on both."""
    cfg = (get_reduced if reduced else get_config)(arch)
    jcfg = (j_get_reduced if reduced else j_get_config)(arch)
    assert costs._lora_bytes(cfg) == jcosts._lora_bytes(jcfg) > 0
    assert costs._lora_bytes(cfg, n_slots=2, r=8) \
        == jcosts._lora_bytes(jcfg, n_slots=2, r=8)


def test_helpers_match_jax():
    for arch in J_ARCH_IDS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        assert costs._has_attn(cfg) == jcosts._has_attn(jcfg)
        for tp in (1, 3, 16):
            assert costs._tp_shardable_heads(cfg, tp) \
                == jcosts._tp_shardable_heads(jcfg, tp)
        for b, s_kv, dp, tp in ((4, 512, 1, 1), (128, 32768, 16, 16),
                                (3, 1000, 2, 7)):
            _close(costs._cache_bytes_local(cfg, b, s_kv, dp, tp),
                   jcosts._cache_bytes_local(jcfg, b, s_kv, dp, tp), arch)


def test_h100_constants():
    assert ra.PEAK_FLOPS == 989e12
    assert ra.PEAK_FLOPS_FP32 == 67e12
    assert ra.HBM_BW == 3.35e12
    assert ra.LINK_BW == 450e9


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b",
                                  "jamba-1.5-large-398b", "whisper-base"])
@pytest.mark.parametrize("shape", list(J_SHAPES))
def test_roofline_arithmetic_matches_jax(arch, shape):
    s = SHAPES[shape]
    cfg = adapt_config(get_config(arch), s)
    c = costs.step_cost(cfg, s.kind, s.seq_len, s.global_batch, dp=16,
                        tp=16)
    model_flops = (6.0 if s.kind == "train" else 2.0) \
        * cfg.param_count(active_only=True) \
        * s.global_batch * (1 if s.kind == "decode" else s.seq_len)
    got = ra.Roofline(c.flops, c.hbm_bytes, c.coll_bytes, 256, model_flops)
    want = jra.Roofline(c.flops, c.hbm_bytes, c.coll_bytes, 256, model_flops)
    scaled = {"compute": want.compute_s * jra.PEAK_FLOPS / ra.PEAK_FLOPS,
              "memory": want.memory_s * jra.HBM_BW / ra.HBM_BW,
              "collective": want.collective_s * jra.LINK_BW / ra.LINK_BW}
    _close(got.compute_s, scaled["compute"], "compute_s")
    _close(got.memory_s, scaled["memory"], "memory_s")
    _close(got.collective_s, scaled["collective"], "collective_s")
    assert got.dominant == max(scaled, key=scaled.get)
    _close(got.useful_flops_ratio, want.useful_flops_ratio, "useful")
    d, jd = got.as_dict(), want.as_dict()
    assert d.keys() == jd.keys()
    for k in ("flops_per_device", "hbm_bytes_per_device",
              "collective_bytes_per_device", "chips", "model_flops_global",
              "useful_flops_ratio"):
        assert d[k] == jd[k]
    assert ra.Roofline(0.0, 0.0, 0.0, 1).useful_flops_ratio == 0.0
