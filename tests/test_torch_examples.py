"""The port's example twins against the JAX examples, on the reduced llama3
(2 layers, d_model 256) in fp32 on the CPU: ``examples/quickstart_torch.py``
and ``examples/migration_torch.py`` (the serving and fine-tuning twins are
in ``test_torch_examples_serving.py``), and ``MixedLoraModel.forward``.

Each JAX example runs once (imported by path, its stdout captured); its
weights are rebuilt in JAX from the example's own keys and handed to the
twin's ``run(..., weights=...)`` as the flat arrays ``save_pytree`` writes.
Tokens, slots, resident lists, counts and the payload's MiB equal what the
JAX example prints; a loss parsed from its 3-decimal print is held within
``LOSS_TOL`` (``_torch_bridge``) of the twin's value.
"""
import ast
import re

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import close_to_print, example_stdout, j, \
    jax_weights, load_example, max_err, t, to_port_bank, to_port_params
from repro.checkpoint import io as jio
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    MixedLoraModel as JMixedLoraModel, VirtualModel as JVirtualModel
from repro.models import model as JM
from repro.models.schema import init_params as j_init_params
from repro.models.stream import DECBatch as JDEC, FTBatch as JFT, \
    PFBatch as JPF, UnifiedBatch as JUB
from repro_torch.configs import get_reduced
from repro_torch.core.flow import FlowConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.models import model as TM
from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
    UnifiedBatch

TOL = 5e-4          # fp32 both sides, summation order differs (2 layers)
LCFG = dict(n_slots=4, r=8)
TWINS = ("quickstart", "migration", "multi_finetune", "unified_serving")


# ------------------------------------------------------------ quickstart
@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quickstart")
    out = example_stdout("quickstart")
    weights = jax_weights(tmp, {"chat": 2, "math": 3, "code": 4})
    return out, load_example("quickstart_torch").run(
        get_reduced("llama3-8b"), "cpu", torch.float32, weights=weights)


def test_quickstart_twin_prints_what_jax_prints(quickstart):
    """Resident adapters, the next token of each row (chat, math, base),
    the resident list after the hot-swap and the migrated slot."""
    text, got = quickstart
    lines = dict(line.split(": ", 1) for line in text.splitlines())
    assert got["resident"] == ast.literal_eval(lines["resident adapters"])
    want = np.array(lines["next tokens per adapter"].strip("[]").split(),
                    np.int64)
    np.testing.assert_array_equal(got["next_tokens"], want)
    assert got["after_hot_swap"] \
        == ast.literal_eval(lines["after hot-swap"]) == ["math", "code"]
    assert got["migrated_slot"] == int(lines["migrated adapter slot"])


# ------------------------------------------------------------- migration
@pytest.fixture(scope="module")
def migration(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("migration")
    out = example_stdout("migration")
    weights = jax_weights(tmp, {"job": 2})
    got = load_example("migration_torch").run(
        get_reduced("llama3-8b"), "cpu", torch.float32, weights=weights)
    return out, got, tmp


def test_migration_twin_prints_what_jax_prints(migration):
    """Runtime A's trained tokens and last loss, the payload's MiB and
    runtime B's first and last losses; both runtimes take the same
    optimizer steps."""
    text, got, _ = migration
    a = re.search(r"runtime A: trained (\d+) tokens, loss ([\d.]+)", text)
    assert got["tokens_A"] == int(a.group(1)) > 0
    close_to_print(a.group(2), got["loss_A"])
    mib = re.search(r"migration payload: ([\d.]+) MiB", text).group(1)
    assert f"{got['payload_bytes'] / 2**20:.2f}" == mib
    b = re.search(r"runtime B: continued, loss ([\d.]+) -> ([\d.]+)", text)
    close_to_print(b.group(1), got["loss_B_first"])
    close_to_print(b.group(2), got["loss_B_last"])
    assert got["tokens_B"] == got["tokens_A"]
    assert got["opt_steps_A"] == got["opt_steps_B"] >= 1
    assert np.isfinite(got["losses_A"] + got["losses_B"]).all()


def test_migration_payload_is_the_jax_payload_byte_for_byte(migration):
    """The twin's payload (``bank_to_numpy`` + ``serialize_npz``) has the
    length of JAX's ``serialize_pytree`` of the voided adapter: the same
    keys, shapes and dtypes."""
    _, got, tmp = migration
    jcfg = j_get_reduced("llama3-8b")
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    jstore.load_random("job", jax.random.PRNGKey(2))
    voided = JVirtualModel("job", None, jstore).void()
    assert got["payload_bytes"] == len(jio.serialize_pytree(voided.adapter))


# ------------------------------------------- MixedLoraModel.forward
@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """Both packages' models over the same weights and a 4-slot bank with
    two adapters (slots 2-3 empty)."""
    tmp = tmp_path_factory.mktemp("forward")
    jcfg = j_get_reduced("llama3-8b")
    cfg = get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = to_port_params(jparams, tmp / "params.npz")
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    store = AdapterStore(cfg, LoRAConfig(**LCFG), device="cpu")
    for name, key in (("chat", 2), ("math", 3)):
        jstore.load_random(name, jax.random.PRNGKey(key))
        store.load(name, to_port_bank(jstore.get_adapter(name),
                                      tmp / f"{name}.npz"))
    jbank = to_port_bank(jstore.bank, tmp / "bank.npz")
    return (cfg, JMixedLoraModel(jcfg, jparams, jstore),
            MixedLoraModel(cfg, params, store), jbank)


def test_store_bank_and_empty_slots_match_jax(mixed):
    """The port's bank equals JAX's slot for slot, the two empty slots
    zeros on both sides."""
    _, _, model, jbank = mixed
    for got, want in zip(model.store.bank["layers"], jbank["layers"]):
        assert got.keys() == want.keys()
        for name in got:
            for ab in ("a", "b"):
                assert torch.equal(got[name][ab], want[name][ab])
                assert not got[name][ab][2:].any()


def _batches(vocab, seed=0):
    """A mixed ft + prefill batch (two ft rows, three prefill rows of
    lengths 12, 16 and 9, base and both adapters), then a decode batch."""
    rng = np.random.default_rng(seed)
    S = 16
    ft_tok = rng.integers(0, vocab, (2, S)).astype(np.int32)
    ft_mask = np.arange(S)[None] < np.array([[16], [11]])
    labels = np.where(ft_mask, ft_tok, -100).astype(np.int32)
    pf_len = np.array([12, 16, 9], np.int32)
    pf_tok = rng.integers(0, vocab, (3, S)).astype(np.int32)
    pf_tok[np.arange(S)[None] >= pf_len[:, None]] = 0
    dec_tok = rng.integers(0, vocab, 3).astype(np.int32)
    ft = dict(tokens=ft_tok, mask=ft_mask, labels=labels,
              adapter=np.array([1, -1], np.int32),
              weight=np.array([0.5, 1.0], np.float32))
    pf = dict(tokens=pf_tok, length=pf_len,
              adapter=np.array([0, 1, -1], np.int32))
    dec = dict(tokens=dec_tok, pos=pf_len, adapter=np.array([-1, 0, 1],
                                                            np.int32))
    return ft, pf, dec


def test_mixed_lora_model_forward_matches_unified_forward_and_jax(mixed):
    """``forward`` on ft + prefill rows over a dense cache, then a decode
    step on that cache: bit-equal to ``unified_forward`` over the store's
    bank and scale at the planner's tile, and within ``TOL`` of JAX's
    ``MixedLoraModel.forward``."""
    cfg, jmodel, model, _ = mixed
    ft, pf, dec = _batches(cfg.vocab)
    ub = UnifiedBatch(ft=FTBatch(**{k: t(v) for k, v in ft.items()}),
                      pf=PFBatch(**{k: t(v) for k, v in pf.items()}))
    jub = JUB(ft=JFT(**{k: j(v) for k, v in ft.items()}),
              pf=JPF(**{k: j(v) for k, v in pf.items()}))
    caches = [TM.init_cache(cfg, 3, 64, torch.device("cpu"), torch.float32)
              for _ in range(2)]
    with torch.no_grad():
        got = model.forward(ub, cache=caches[0])
        ref = TM.unified_forward(cfg, model.base, ub, caches[1],
                                 loras=model.store.bank,
                                 lora_scale=model.store.scale,
                                 block_t=FlowConfig().block_t)
    want = jmodel.forward(jub, cache=JM.init_cache(jmodel.cfg, 3, 64))
    for f in ("ft_loss_sum", "ft_tok_count", "pf_logits"):
        assert torch.equal(getattr(got, f), getattr(ref, f))
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert max_err(a, b) <= TOL * max(1.0, np.abs(b).max()), f
    for leaf in caches[0]:
        assert torch.equal(caches[0][leaf], caches[1][leaf])

    dub = UnifiedBatch(dec=DECBatch(**{k: t(v) for k, v in dec.items()}))
    jdub = JUB(dec=JDEC(**{k: j(v) for k, v in dec.items()}))
    with torch.no_grad():
        got = model.forward(dub, cache=got.cache)
        ref = TM.unified_forward(cfg, model.base, dub, ref.cache,
                                 loras=model.store.bank,
                                 lora_scale=model.store.scale,
                                 block_t=FlowConfig().block_t)
    want = jmodel.forward(jdub, cache=want.cache)
    assert torch.equal(got.dec_logits, ref.dec_logits)
    b = np.asarray(want.dec_logits)
    assert max_err(got.dec_logits.numpy(), b) <= TOL * np.abs(b).max()


# ------------------------------------------------------------- the CLIs
@pytest.mark.parametrize("twin", TWINS)
def test_twin_main_needs_cuda_unless_cpu_is_asked(twin):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_example(f"{twin}_torch").main([])


def test_quickstart_twin_main_runs_on_cpu(capsys):
    out = load_example("quickstart_torch").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.splitlines() == [
        f"resident adapters: {out['resident']}",
        f"next tokens per adapter: {out['next_tokens']}",
        f"after hot-swap: {out['after_hot_swap']}",
        f"migrated adapter slot: {out['migrated_slot']}"]
    assert out["after_hot_swap"] == ["math", "code"]
