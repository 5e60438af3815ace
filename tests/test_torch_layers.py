"""Port layer math vs ``repro.models.layers`` on the same numpy inputs (fp32,
CPU).  Tolerance 1e-5: both sides compute in float32 with a different
summation order."""
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t
from repro.models import layers as JL
from repro_torch.models import layers as TL

TOL = 1e-5


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7, 64), dtype=np.float32)
    w = rng.standard_normal((64,), dtype=np.float32)
    ref = JL.rms_norm(j(x), j(w), 1e-5)
    assert max_err(TL.rms_norm(t(x), t(w), 1e-5), ref) < TOL


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 9, 4, 32), dtype=np.float32)
    pos = rng.integers(0, 600, size=(3, 9)).astype(np.int32)
    ref = JL.rope(j(x), j(pos), theta)
    assert max_err(TL.rope(t(x), t(pos), theta), ref) < 1e-4


def test_swiglu_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 32), dtype=np.float32)
    wg, wu = (rng.standard_normal((32, 48), dtype=np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((48, 32), dtype=np.float32) * 0.2
    ref = JL.swiglu(j(x), j(wg), j(wu), j(wd))
    assert max_err(TL.swiglu(t(x), t(wg), t(wu), t(wd)), ref) < TOL


@pytest.mark.parametrize("h,g,window,causal", [
    (4, 4, 0, True), (8, 2, 0, True), (8, 2, 6, True), (8, 1, 0, False)])
def test_attention_matches_jax_with_fully_masked_rows(h, g, window, causal):
    """Masked GQA attention; row 0 has no valid key (length 0) and must be
    exactly 0, as the JAX package defines it."""
    rng = np.random.default_rng(h * 10 + g + window)
    B, S, T, hd = 3, 7, 11, 16
    q = rng.standard_normal((B, S, h, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    q_pos = np.broadcast_to(np.arange(S) + 4, (B, S)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    lens = np.array([0, 5, 11])
    k_valid = k_pos < lens[:, None]
    kw = dict(causal=causal, window=window)
    ref = JL.attention(j(q), j(k), j(v), q_pos=j(q_pos), k_pos=j(k_pos),
                       k_valid=j(k_valid), **kw)
    out = TL.attention(t(q), t(k), t(v), q_pos=t(q_pos), k_pos=t(k_pos),
                       k_valid=t(k_valid), **kw)
    assert max_err(out, ref) < TOL
    assert torch.isfinite(out).all()
    assert float(out[0].abs().max()) == 0.0


def test_chunked_attention_is_not_ported():
    """The name dates from before chunked attention was ported: ``chunk``
    now runs the online-softmax path, which on this tiny case (keys
    longer than the chunk) equals the unchunked attention."""
    rng = np.random.default_rng(7)
    x = t(rng.standard_normal((1, 6, 2, 8), dtype=np.float32))
    pos = torch.arange(6, dtype=torch.int32)[None]
    kw = dict(q_pos=pos, k_pos=pos, k_valid=torch.ones(1, 6, dtype=torch.bool))
    assert max_err(TL.attention(x, x, x, chunk=4, **kw),
                   TL.attention(x, x, x, **kw)) < TOL


def _chunk_case(seed, S, T, h=8, g=2, hd=16, B=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, h, hd), dtype=np.float32)
    k = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    v = rng.standard_normal((B, T, g, hd), dtype=np.float32)
    q_pos = np.broadcast_to(np.arange(S) + (T - S), (B, S)).astype(np.int32)
    k_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    k_valid = k_pos < np.array([0, T // 2 + 1, T])[:, None]
    return q, k, v, q_pos, k_pos, k_valid


@pytest.mark.parametrize("chunk,S,T", [(16, 9, 40), (16, 40, 40),
                                       (32, 24, 70), (32, 70, 70),
                                       (16, 33, 50)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 12),
                                           (False, 0)])
def test_chunked_attention_matches_jax(chunk, S, T, causal, window):
    """The online-softmax path (query below and above the chunk, keys not
    a multiple of it) against the JAX package's chunked attention, with a
    row of no valid key (exactly 0)."""
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(chunk + S + T, S, T)
    kw = dict(causal=causal, window=window, chunk=chunk)
    ref = JL.attention(j(q), j(k), j(v), q_pos=j(q_pos), k_pos=j(k_pos),
                       k_valid=j(k_valid), **kw)
    out = TL.attention(t(q), t(k), t(v), q_pos=t(q_pos), k_pos=t(k_pos),
                       k_valid=t(k_valid), **kw)
    assert tuple(out.shape) == tuple(ref.shape)
    assert max_err(out, ref) < TOL
    assert float(out[0].abs().max()) == 0.0


@pytest.mark.parametrize("chunk,S", [(16, 40), (32, 24)])
def test_chunked_attention_grad_matches_jax(chunk, S):
    """The gradient of a weighted sum of the chunked attention (query
    blocks recomputed in the backward) against ``jax.grad``."""
    import jax
    T = 40
    q, k, v, q_pos, k_pos, k_valid = _chunk_case(S, S, T)
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    kw = dict(causal=True, window=0, chunk=chunk)

    def jloss(q_, k_, v_):
        o = JL.attention(q_, k_, v_, q_pos=j(q_pos), k_pos=j(k_pos),
                         k_valid=j(k_valid), **kw)
        return (o * j(w)).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(j(q), j(k), j(v))
    tq, tk, tv = (t(x).requires_grad_() for x in (q, k, v))
    out = TL.attention(tq, tk, tv, q_pos=t(q_pos), k_pos=t(k_pos),
                       k_valid=t(k_valid), **kw)
    tg = torch.autograd.grad((out * t(w)).sum(), (tq, tk, tv))
    for a, b in zip(tg, jg):
        assert max_err(a, b) < 1e-4
