"""The port's MoE FFN (``repro_torch.models.moe``) vs ``repro.models.moe`` in
fp32 on the CPU, on numpy-seeded inputs handed to both.

The drop set is the semantics: the routed experts (``idx``), the group
count, the capacity (dropless up to ``DROPLESS_MAX`` routed slots, then
``ceil(S*k/E*cf)``) and the stable sort by expert must give the same kept
entries, so the same rows come out exactly zero (a dropped top-1 token) on
both sides.  Values are held within 1e-5 (fp32, sums in another order);
the aux loss within 1e-6 relative.  The twins of ``tests/test_mamba_moe.py``
hold the port to its dense oracle as the JAX tests hold the JAX package,
with their tolerance (1e-4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jmoe
import repro_torch.models.moe as tmoe
from _torch_bridge import t
from repro.models.configs import MoEConfig as JMoEConfig
from repro_torch.models.configs import MoEConfig
from repro_torch.models.quant import quantize_weight

TOL = 1e-5


def _params(seed, d, E, f):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, E)).astype(np.float32) * 0.02,
            "w_gate": rng.standard_normal((E, d, f)).astype(np.float32)
            * 0.05,
            "w_up": rng.standard_normal((E, d, f)).astype(np.float32) * 0.05,
            "w_down": rng.standard_normal((E, f, d)).astype(np.float32)
            * 0.05}


def _x(seed, T, d, scale=1.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((T, d)).astype(np.float32) * scale


def _both(x, params, E, k, f, cf):
    """(port y, port aux, JAX y, JAX aux, port idx, JAX idx)."""
    tp = {n: t(v) for n, v in params.items()}
    y, aux = tmoe.moe_apply(t(x), tp, MoEConfig(num_experts=E, top_k=k,
                                                d_ff_expert=f,
                                                capacity_factor=cf))
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jy, jaux = jmoe.moe_apply(jnp.asarray(x), jp, JMoEConfig(
        num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=cf))
    _, idx = tmoe.router_topk(t(x) @ tp["router"], k)
    _, jidx = jmoe.router_topk(jnp.asarray(x) @ jp["router"], k)
    return y, aux, np.asarray(jy), float(jaux), idx.numpy(), np.asarray(jidx)


# ------------------------------------------- twins of tests/test_mamba_moe.py
def test_moe_matches_dense_oracle_with_headroom():
    T, d, E, f = 128, 16, 4, 32
    m = MoEConfig(num_experts=E, top_k=2, d_ff_expert=f, capacity_factor=8.0)
    p = {n: t(v) for n, v in _params(0, d, E, f).items()}
    x = t(_x(9, T, d))
    y, aux = tmoe.moe_apply(x, p, m)
    yr = tmoe.moe_apply_dense_ref(x, p, m)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=1e-4, atol=1e-4)
    assert float(aux) > 0


def test_moe_capacity_drops_bounded():
    """cf=1.0: outputs stay finite (and equal JAX's)."""
    T, d, E, f = 256, 16, 8, 32
    y, _, jy, _, _, _ = _both(_x(10, T, d), _params(1, d, E, f), E, 2, f, 1.0)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y.numpy(), jy, rtol=TOL, atol=TOL)


def test_moe_grouping_invariance(monkeypatch):
    """Grouped dispatch with generous capacity == dense oracle regardless of
    group count (GROUP_TOKENS boundary behaviour)."""
    T, d, E, f = 96, 8, 4, 16
    m = MoEConfig(num_experts=E, top_k=1, d_ff_expert=f, capacity_factor=8.0)
    p = {n: t(v) for n, v in _params(2, d, E, f).items()}
    x = t(_x(11, T, d))
    monkeypatch.setattr(tmoe, "GROUP_TOKENS", 32)
    assert tmoe.groups(T, 1, m)[0] == 3
    y_g, _ = tmoe.moe_apply(x, p, m)
    yr = tmoe.moe_apply_dense_ref(x, p, m)
    np.testing.assert_allclose(y_g.numpy(), yr.numpy(), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------- drop sets against JAX
@pytest.mark.parametrize("T,k,E,group_tokens", [
    (512, 1, 4, None),      # S*k = 512: the last dropless group
    (513, 1, 4, None),      # S*k = 513: capacity ceil(513/4) = 129, drops
    (12288, 1, 4, None),    # three groups of GROUP_TOKENS = 4096, drops
    (600, 2, 8, 256),       # two groups of 300 tokens, top-2, drops
])
def test_moe_apply_matches_jax_with_drops(monkeypatch, T, k, E,
                                          group_tokens):
    d, f = 8, 16
    if group_tokens is not None:
        monkeypatch.setattr(tmoe, "GROUP_TOKENS", group_tokens)
        monkeypatch.setattr(jmoe, "GROUP_TOKENS", group_tokens)
    # a skewed router (large logits) so that capacity binds
    x = _x(20 + T, T, d, scale=3.0)
    params = _params(T, d, E, f)
    params["router"] *= 50.0
    monkeypatch.setattr(tmoe.moe_apply, "dropped", 0)
    y, aux, jy, jaux, idx, jidx = _both(x, params, E, k, f, 1.0)
    n_drop = tmoe.moe_apply.dropped
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(y.numpy(), jy, rtol=TOL, atol=TOL)
    assert abs(float(aux) - jaux) <= 1e-6 * max(1.0, abs(jaux))
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=1.0)
    _, S, _ = tmoe.groups(T, k, m)
    if k == 1:
        # a dropped top-1 token's output is exactly zero on both sides
        zero, jzero = (y.abs().sum(-1) == 0).numpy(), np.abs(jy).sum(-1) == 0
        np.testing.assert_array_equal(zero, jzero)
        assert int(zero.sum()) == n_drop
    if S * k <= tmoe.DROPLESS_MAX:
        assert n_drop == 0
    else:
        assert n_drop > 0


@pytest.mark.parametrize("T,k,cf", [(40, 2, 1.25), (700, 1, 1.0),
                                    (700, 2, 1.5)])
def test_per_expert_path_equals_einsum_plain(T, k, cf):
    """The main path (only the kept (expert, slot) pairs, one matmul chain
    per routed expert) equals the plain buffer-and-einsum dispatch, in fp32
    and with int8 expert stacks (only the routed experts dequantized)."""
    d, E, f = 16, 8, 32
    m = MoEConfig(num_experts=E, top_k=k, d_ff_expert=f, capacity_factor=cf)
    params = _params(30 + T, d, E, f)
    params["router"] *= 20.0
    p = {n: t(v) for n, v in params.items()}
    x = t(_x(31 + T, T, d, 2.0))
    y, aux = tmoe.moe_apply(x, p, m)
    yp, auxp = tmoe.moe_apply_einsum(x, p, m)
    np.testing.assert_allclose(y.numpy(), yp.numpy(), rtol=1e-6, atol=1e-6)
    assert float(aux) == float(auxp)
    q = dict(p, **{n: quantize_weight(p[n]) for n in tmoe.EXPERT_STACKS})
    yq, _ = tmoe.moe_apply(x, q, m)
    yqp, _ = tmoe.moe_apply_einsum(x, q, m)
    np.testing.assert_allclose(yq.numpy(), yqp.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert float((yq - y).abs().max()) > 0       # the weights did change


def test_slots_are_a_stable_rank_per_expert():
    """An entry's slot is the count of earlier entries of its group with
    the same expert (the stable sort's rank)."""
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 6, (60, 2)))
    pos = tmoe.slots(idx, 3, 6).reshape(3, 40)
    flat = idx.reshape(3, 40)
    for g in range(3):
        for n in range(40):
            e = int(flat[g, n])
            assert int(pos[g, n]) == int((flat[g, :n] == e).sum())
