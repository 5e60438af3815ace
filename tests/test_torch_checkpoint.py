"""The port's checkpoint writer (``repro_torch.checkpoint.io``) against the
JAX package's ``save_pytree`` / ``load_pytree`` / ``serialize_pytree`` /
``deserialize_pytree``, on the CPU.  Every comparison is bit-equal: the
same keys in the same order, shapes, dtypes and bytes.

* base parameters of every reduced registry id, fp32 and int8 (as JAX's
  ``quantize_params`` writes them), and a LoRA bank: a file the port
  writes loads in JAX's ``load_pytree``, and a file JAX writes loads in the
  port and writes back the same arrays;
* parameters the port draws itself load in JAX's ``load_pytree``;
* twins of ``tests/test_runtime.py::test_void_unvoid_roundtrip_and_blob``
  and ``::test_checkpoint_roundtrip``; bf16 leaves round-trip in the port;
* a voided adapter's blob crosses JAX -> port -> JAX unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import ARCH_IDS, get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore, \
    VirtualModel as JVirtualModel
from repro.models.quant import quantize_params as j_quantize_params
from repro.models.schema import init_params as j_init_params
from repro_torch.checkpoint import io
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, VirtualModel, \
    VoidedModel
from repro_torch.models.schema import init_params

LCFG = dict(n_slots=4, r=4)


def _same_flat(got, want):
    """Equal keys in equal order, and every array bit-equal with its dtype
    and shape."""
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _jax_params(arch, int8):
    cfg = j_get_reduced(arch)
    params = j_init_params(cfg, jax.random.PRNGKey(0))
    return j_quantize_params(cfg, params) if int8 else params


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_cross_both_ways(arch, int8, tmp_path):
    """JAX writes, the port reads and writes again, JAX reads: each file
    holds exactly the arrays ``save_pytree`` wrote for the JAX tree."""
    jparams = _jax_params(arch, int8)
    jio.save_pytree(str(tmp_path / "jax.npz"), jparams)
    want = io.load_npz(str(tmp_path / "jax.npz"))
    params = io.params_from_numpy(want, device="cpu")
    flat = io.params_to_numpy(get_reduced(arch), params)
    _same_flat(flat, want)
    n = io.save_npz(str(tmp_path / "port.npz"), flat)
    assert n > 0
    _same_flat(io.load_npz(str(tmp_path / "port.npz")), want)
    back = jio.load_pytree(str(tmp_path / "port.npz"), jparams)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.asarray(a).tobytes() \
            == np.asarray(b).tobytes(), path


@pytest.mark.parametrize("arch", ["llama3-8b", "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_bank_crosses_both_ways(arch, tmp_path):
    """A JAX LoRA bank (``n_slots`` after the periods axis) and one adapter
    out of it, through the port and back, bit-equal."""
    jcfg = j_get_reduced(arch)
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    jstore.load_random("a0", jax.random.PRNGKey(2))
    jstore.load_random("a1", jax.random.PRNGKey(3))
    for tree in (jstore.bank, jstore.get_adapter("a1")):
        want = io.deserialize_npz(jio.serialize_pytree(tree))
        bank = io.bank_from_numpy(want, device="cpu")
        flat = io.bank_to_numpy(get_reduced(arch), bank)
        _same_flat(flat, want)
        back = jio.deserialize_pytree(io.serialize_npz(flat), tree)
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(back)):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b",
                                  "whisper-base"])
def test_port_drawn_params_load_in_jax(arch, tmp_path):
    """Weights the port draws (torch generator) written by the port load
    in JAX's ``load_pytree`` into the JAX schema's tree, leaf for leaf."""
    cfg = get_reduced(arch)
    gen = torch.Generator().manual_seed(4)
    params = init_params(cfg, gen, device="cpu")
    flat = io.params_to_numpy(cfg, params)
    io.save_npz(str(tmp_path / "port.npz"), flat)
    like = j_init_params(j_get_reduced(arch), jax.random.PRNGKey(0))
    back = jio.load_pytree(str(tmp_path / "port.npz"), like)
    got = {"/".join(jio._path_str(p) for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]}
    _same_flat(got, flat)
    again = io.params_from_numpy(io.load_npz(str(tmp_path / "port.npz")),
                                 device="cpu")
    assert torch.equal(again["embed"], params["embed"])
    assert all(torch.equal(again["layers"][i][k], v)
               for i, layer in enumerate(params["layers"])
               for k, v in layer.items())


def test_checkpoint_roundtrip(tmp_path):
    """Twin of ``tests/test_runtime.py::test_checkpoint_roundtrip``
    (reduced phi3): save, load, every leaf bit-equal."""
    cfg = get_reduced("phi3-medium-14b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    path = str(tmp_path / "ckpt.npz")
    assert io.save_npz(path, io.params_to_numpy(cfg, params)) > 0
    loaded = io.params_from_numpy(io.load_npz(path), device="cpu")
    assert loaded.keys() == params.keys()
    for key in ("embed", "final_norm", "lm_head"):
        assert torch.equal(loaded[key], params[key])
    for a, b in zip(loaded["layers"], params["layers"]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_bf16_leaves_round_trip_in_the_port(tmp_path):
    """bf16 leaves are written as numpy holds a JAX bf16 array (raw 2-byte
    words, ``|V2``) and read back as bf16, bit-equal."""
    cfg = get_reduced("llama3-8b")
    params = init_params(cfg, torch.Generator().manual_seed(1),
                         device="cpu", dtype=torch.bfloat16)
    flat = io.params_to_numpy(cfg, params)
    assert flat["embed"].dtype == np.dtype("V2")
    jflat = {"embed": np.asarray(jnp.asarray(
        params["embed"].float().numpy(), jnp.bfloat16))}
    assert jflat["embed"].tobytes() == flat["embed"].tobytes()
    assert np.dtype(jflat["embed"].dtype.str) == flat["embed"].dtype
    back = io.params_from_numpy(io.deserialize_npz(io.serialize_npz(flat)),
                                device="cpu")
    assert back["embed"].dtype == torch.bfloat16
    assert torch.equal(back["embed"], params["embed"])
    assert all(torch.equal(back["layers"][i][k], v)
               for i, layer in enumerate(params["layers"])
               for k, v in layer.items())


def _port_store(cfg):
    return AdapterStore(cfg, LoRAConfig(**LCFG), device="cpu")


def test_void_unvoid_roundtrip_and_blob():
    """Twin of ``tests/test_runtime.py::test_void_unvoid_roundtrip_and_blob``:
    void, serialize, deserialize, unvoid into a fresh store: the adapter
    bit-equal and the scale kept."""
    cfg = get_reduced("llama3-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    store = _port_store(cfg)
    store.load_random("m", torch.Generator().manual_seed(2), scale=1.5)
    voided = VirtualModel("m", params, store).void()
    blob = io.serialize_npz(io.bank_to_numpy(cfg, voided.adapter))
    voided.adapter = io.bank_from_numpy(io.deserialize_npz(blob),
                                        device="cpu")
    store2 = _port_store(cfg)
    vm2 = VirtualModel.unvoid(voided, params, store2, device="cpu")
    a1, a2 = store.get_adapter("m"), store2.get_adapter("m")
    for l1, l2 in zip(a1["layers"], a2["layers"]):
        assert l1.keys() == l2.keys()
        for t in l1:
            assert all(torch.equal(l1[t][k], l2[t][k]) for k in ("a", "b"))
    assert float(store2.scale[vm2.slot]) == 1.5


def test_voided_adapter_blob_crosses_jax_port_jax():
    """A JAX voided adapter's blob unvoids into a port store, is voided
    there and serialized by the port: the blob holds JAX's keys in JAX's
    order and its arrays bit-equal, and JAX unvoids it to the same adapter
    and scale."""
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(1))
    jstore.load_random("m", jax.random.PRNGKey(2), scale=1.5)
    jvoided = JVirtualModel("m", jparams, jstore).void()
    jblob = jio.serialize_pytree(jvoided.adapter)

    cfg = get_reduced("llama3-8b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    arrived = VoidedModel(name="m", cfg_name=cfg.name, scale=jvoided.scale,
                          adapter=io.bank_from_numpy(io.deserialize_npz(
                              jblob), device="cpu"))
    vm = VirtualModel.unvoid(arrived, params, _port_store(cfg), device="cpu")
    out = vm.void()
    blob = io.serialize_npz(io.bank_to_numpy(cfg, out.adapter))
    _same_flat(io.deserialize_npz(blob), io.deserialize_npz(jblob))
    assert out.scale == jvoided.scale == 1.5

    jvoided.adapter = jio.deserialize_pytree(blob, jvoided.adapter)
    jstore2 = JAdapterStore(jcfg, JLoRAConfig(**LCFG), jax.random.PRNGKey(3))
    vm2 = JVirtualModel.unvoid(jvoided, jparams, jstore2)
    for a, b in zip(jax.tree_util.tree_leaves(jstore.get_adapter("m")),
                    jax.tree_util.tree_leaves(jstore2.get_adapter("m"))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert float(jstore2.scale[vm2.slot]) == 1.5
