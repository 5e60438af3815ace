"""The port's int8 weight-only serving (``repro_torch.models.quant`` and the
model's dequant path) vs ``repro.models.quant``, in fp32 on the CPU.

* ``quantize_params`` is bit-equal to the JAX package's (payloads and
  scales) on every reduced port arch, and the eligibility rule picks the
  same leaves at full width, checked on shapes alone (nothing is
  materialised): maverick's router ``[5120, 128]`` is quantized there, not
  at reduced width (E = 4).
* Twins of ``tests/test_quant.py`` with its tolerances.
* The q8 npz bridge: JAX's int8 tree crosses over with int8 payloads and
  fp32 scales intact, and the port's forward over it equals JAX's int8
  forward (logits within 1e-4 of max(1, max |JAX|)); one grad step over an
  int8 base equals JAX's (loss 1e-5 relative, grads 1e-4 of a leaf's
  max).
"""
import jax
import numpy as np
import pytest
import torch

from _torch_bridge import j, max_err, t, to_port_bank, to_port_params
from repro.configs import get_config as j_get_config, \
    get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.unified import make_grad_step as j_make_grad_step
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models import model as JM, quant as jquant
from repro.models.schema import _is_p, build_schema, \
    init_params as j_init_params
from repro.models.stream import FTBatch as JFT, PFBatch as JPF, \
    UnifiedBatch as JUB
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.unified import make_grad_step
from repro_torch.models import model as TM, quant
from repro_torch.models.schema import encoder_shapes, jax_key, layer_shapes, \
    top_leaves
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch

BT = 8
CPU = torch.device("cpu")
FAMILIES = ["llama3-8b", "llama4-maverick-400b-a17b"]


def _name(arch):
    return arch.replace(".", "_")


def _flat(tree, prefix=""):
    """{path: tensor} of a port tree (layers as ``layers/i``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_quantize_params_bit_equal_to_jax(arch, tmp_path):
    jcfg = j_get_reduced(arch)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = to_port_params(jparams, tmp_path / "p.npz")
    mine = _flat(quant.quantize_params(get_reduced(arch), params))
    theirs = _flat(to_port_params(jquant.quantize_params(jcfg, jparams),
                                  tmp_path / "q.npz"))
    assert mine.keys() == theirs.keys()
    n_q8 = 0
    for k, v in mine.items():
        assert v.dtype == theirs[k].dtype, k
        assert torch.equal(v, theirs[k]), k
        n_q8 += k.endswith("/_q8")
    assert n_q8 > 0 and quant.has_q8(quant.quantize_params(
        get_reduced(arch), params))


def _jax_eligible(cfg):
    paths = set()
    leaves = jax.tree_util.tree_flatten_with_path(build_schema(cfg),
                                                  is_leaf=_is_p)[0]
    for path, p in leaves:
        if jquant._eligible(p):
            paths.add("/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                               for q in path))
    return paths


def _port_eligible(cfg):
    paths = {k for k, leaf in top_leaves(cfg).items()
             if quant._eligible(leaf, leaf.shape)}
    for pos in range(len(cfg.pattern)):
        for k, leaf in layer_shapes(cfg, pos).items():
            if quant._eligible(leaf, (cfg.n_periods, *leaf.shape)):
                paths.add(jax_key(cfg, pos, k))
    if cfg.encoder is not None:     # whisper-base: encoder/blocks [ne, ...]
        for k, leaf in encoder_shapes(cfg).items():
            if quant._eligible(leaf, (cfg.encoder.n_layers, *leaf.shape)):
                paths.add(f"encoder/blocks/{k}")
    return paths


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_eligibility_matches_jax_at_full_and_reduced_width(arch):
    for mine, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        assert _port_eligible(mine) == _jax_eligible(theirs)
    if arch == "llama4-maverick-400b-a17b":
        assert "blocks/1/router" in _port_eligible(get_config(arch))
        assert "blocks/1/router" not in _port_eligible(get_reduced(arch))
        assert "blocks/1/w_gate" in _port_eligible(get_reduced(arch))
    if arch == "deepseek-v2-236b":
        # MLA's up projections [P, c, h, dn]: eligible at full width (h =
        # dn = 128), not at reduced (h = 8)
        full = _port_eligible(get_config(arch))
        assert {"blocks/0/wuk", "blocks/0/wuv", "blocks/0/wdkv"} <= full
        assert "blocks/0/wuk" not in _port_eligible(get_reduced(arch))
    if get_config(arch).ssm is not None:
        # Mamba's in_dt [P, d, nh] is eligible at nh >= 64 (64 heads for
        # mamba2, 256 for jamba), in_bc [P, d, 256] too; the depthwise conv
        # weights [P, 4, C] never are
        full = _port_eligible(get_config(arch))
        assert {"blocks/0/in_dt", "blocks/0/in_bc", "blocks/0/in_z",
                "blocks/0/in_x", "blocks/0/out_proj"} <= full
        assert not any("/conv_" in k for k in full)
        assert "blocks/0/in_dt" not in _port_eligible(get_reduced(arch))


# ------------------------------------------------ twins of test_quant.py
def _prefill(cfg, params, toks, cache):
    B, S = toks.shape
    pf = PFBatch(tokens=toks, length=torch.full((B,), S, dtype=torch.int32),
                 adapter=torch.full((B,), -1, dtype=torch.int32))
    with torch.no_grad():
        return TM.unified_forward(cfg, params, UnifiedBatch(pf=pf), cache,
                                  block_t=BT)


@pytest.mark.parametrize("arch", FAMILIES)
def test_int8_forward_close_to_bf16(arch, tmp_path):
    """Per-channel symmetric int8: small logit drift, same argmax mostly
    (0.2 and 0.5, the JAX test's bounds)."""
    cfg = get_reduced(arch)
    params = to_port_params(j_init_params(j_get_reduced(arch),
                                          jax.random.PRNGKey(0)),
                            tmp_path / "p.npz")
    qparams = quant.quantize_params(cfg, params)
    assert quant.has_q8(qparams)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)).astype(np.int32))
    a = _prefill(cfg, params, toks, TM.init_cache(cfg, 2, 16, CPU,
                                                  torch.float32))
    b = _prefill(cfg, qparams, toks, TM.init_cache(cfg, 2, 16, CPU,
                                                   torch.float32))
    assert float((a.pf_logits - b.pf_logits).abs().max()) < 0.2
    agree = (a.pf_logits.argmax(-1) == b.pf_logits.argmax(-1)).float()
    assert float(agree.mean()) >= 0.5


def test_quant_roundtrip_error_bound():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 128)).astype(np.float32) * 0.05)
    q = quant.quantize_leaf(w)
    w2 = quant.dequant_leaf(q, torch.float32)
    # per-channel absmax/127 quantization error bound: scale/2 per element
    bound = q["_qs"][0] / 2 + 1e-6
    assert bool(((w - w2).abs() <= bound).all())


def test_column_blocks_and_expert_slices_are_bit_equal(monkeypatch):
    """A large matrix quantizes one column block at a time and a stack one
    matrix at a time (bounded fp32 transients): the same payloads and
    scales as one whole conversion; the one-pass dequant equals the JAX
    formula (f32 product, then rounded) in bf16 and fp32."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32))
    stack = torch.from_numpy(rng.standard_normal((3, 64, 300))
                             .astype(np.float32))
    whole, whole3 = quant.quantize_leaf(w), quant.quantize_leaf(stack)
    monkeypatch.setattr(quant, "_CHUNK", 1000)      # 15 columns a block
    assert len(quant._columns(w.shape)) == 20
    for mine, want in ((quant.quantize_weight(w), whole),
                       (quant.quantize_weight(stack), whole3)):
        assert torch.equal(mine["_q8"], want["_q8"])
        assert torch.equal(mine["_qs"], want["_qs"])
    for dt in (torch.bfloat16, torch.float32):
        want = (whole["_q8"].float() * whole["_qs"]).to(dt)
        assert torch.equal(quant.dequant_leaf(whole, dt), want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_with_quantized_weights_matches_full_forward(arch, tmp_path):
    """Prefill + decode through the cache still matches one full forward
    under int8 weights (rtol/atol 2e-4, the JAX test's)."""
    cfg = get_reduced(arch)
    params = quant.quantize_params(cfg, to_port_params(
        j_init_params(j_get_reduced(arch), jax.random.PRNGKey(0)),
        tmp_path / "p.npz"))
    B, S = 1, 8
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1)).astype(np.int32))
    out = _prefill(cfg, params, toks[:, :S],
                   TM.init_cache(cfg, B, 16, CPU, torch.float32))
    with torch.no_grad():
        out2 = TM.unified_forward(cfg, params, UnifiedBatch(dec=DECBatch(
            tokens=toks[:, S], pos=torch.full((B,), S, dtype=torch.int32),
            adapter=torch.full((B,), -1, dtype=torch.int32))), out.cache,
            block_t=BT)
    ref = _prefill(cfg, params, toks,
                   TM.init_cache(cfg, B, 16, CPU, torch.float32))
    np.testing.assert_allclose(out2.dec_logits.numpy(),
                               ref.pf_logits.numpy(), rtol=2e-4, atol=2e-4)


# ------------------------------------------- the q8 bridge against JAX
@pytest.fixture(scope="module")
def q8(tmp_path_factory):
    """Per family: JAX fp32 and int8 params, a JAX bank with two
    adapters, and the port's bridged int8 params and bank."""
    tmp = tmp_path_factory.mktemp("q8")
    out = {}
    for arch in FAMILIES:
        jcfg = j_get_reduced(arch)
        jq = jquant.quantize_params(jcfg, j_init_params(
            jcfg, jax.random.PRNGKey(0)))
        jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=4),
                               jax.random.PRNGKey(1))
        jstore.load_random("a0", jax.random.PRNGKey(2))
        jstore.load_random("a1", jax.random.PRNGKey(3))
        out[arch] = dict(
            jcfg=jcfg, jq=jq, jbank=jstore.bank, jscale=jstore.scale,
            cfg=get_reduced(arch),
            q=to_port_params(jq, tmp / f"{_name(arch)}_q.npz"),
            bank=to_port_bank(jstore.bank, tmp / f"{_name(arch)}_b.npz"),
            scale=t(np.asarray(jstore.scale)), tmp=tmp)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_q8_bridge_keeps_payloads_and_matches_jax_forward(q8, arch):
    s = q8[arch]
    wq = s["q"]["layers"][0]["wq"]
    assert wq["_q8"].dtype == torch.int8 and wq["_qs"].dtype == torch.float32
    np.testing.assert_array_equal(wq["_q8"].numpy(),
                                  np.asarray(s["jq"]["blocks"][0]["wq"]
                                             ["_q8"])[0])
    assert quant.is_q8(s["q"]["embed"])
    rng = np.random.default_rng(3)
    toks = np.zeros((2, 16), np.int32)
    toks[0, :11], toks[1, :16] = rng.integers(0, s["cfg"].vocab, 11), \
        rng.integers(0, s["cfg"].vocab, 16)
    length, adapter = np.asarray([11, 16], np.int32), \
        np.asarray([0, 1], np.int32)
    jout = JM.unified_forward(s["jcfg"], s["jq"], JUB(pf=JPF(
        tokens=j(toks), length=j(length), adapter=j(adapter))),
        JM.init_cache(s["jcfg"], 2, 32), loras=s["jbank"],
        lora_scale=s["jscale"])
    with torch.no_grad():
        tout = TM.unified_forward(s["cfg"], s["q"], UnifiedBatch(pf=PFBatch(
            tokens=t(toks), length=t(length), adapter=t(adapter))),
            TM.init_cache(s["cfg"], 2, 32, CPU, torch.float32),
            loras=s["bank"], lora_scale=s["scale"], block_t=BT)
    want = np.asarray(jout.pf_logits)
    assert max_err(tout.pf_logits, want) <= 1e-4 * max(1.0,
                                                        np.abs(want).max())


@pytest.mark.parametrize("arch", FAMILIES)
def test_int8_grad_step_matches_jax(q8, arch):
    s = q8[arch]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, s["cfg"].vocab, (2, 16)).astype(np.int32)
    ft = dict(tokens=toks, mask=np.ones((2, 16), bool), labels=toks,
              adapter=np.asarray([0, 1], np.int32),
              weight=np.asarray([1.0, 0.5], np.float32))
    jres = j_make_grad_step(s["jcfg"])(
        s["jq"], s["jbank"], s["jscale"],
        JUB(ft=JFT(**{k: j(v) for k, v in ft.items()})), None)
    tres = make_grad_step(s["cfg"], block_t=BT)(
        s["q"], s["bank"], s["scale"],
        UnifiedBatch(ft=FTBatch(**{k: t(v) for k, v in ft.items()})), None)
    assert abs(float(tres.loss) - float(jres.loss)) \
        <= 1e-5 * abs(float(jres.loss))
    want = to_port_bank(jres.grads, s["tmp"] / f"g_{_name(arch)}.npz")
    for lg, lw in zip(tres.grads["layers"], want["layers"]):
        assert lg.keys() == lw.keys()
        for name in lg:
            for ab in ("a", "b"):
                w = lw[name][ab]
                assert max_err(lg[name][ab], w) \
                    <= 1e-4 * max(float(w.abs().max()), 1e-12), (name, ab)
