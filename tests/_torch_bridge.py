"""Shared set-up of the PyTorch port's parity tests: weights are made in JAX,
written with ``repro.checkpoint.io.save_pytree`` and read into the port
through its bridge (``repro_torch.checkpoint.io``); other inputs are made
from numpy seeds and handed to both packages."""
import contextlib
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.io import save_pytree
from repro.configs import get_reduced as j_get_reduced
from repro.core.lora import LoRAConfig as JLoRAConfig
from repro.core.virtualization import AdapterStore as JAdapterStore
from repro.models.schema import init_params as j_init_params
from repro_torch.checkpoint.io import bank_from_numpy, load_npz, \
    params_from_numpy

# small CPU tests: few intra-op threads so parallel test workers do not
# oversubscribe the machine
torch.set_num_threads(2)


def to_port_params(jparams, path):
    """JAX params -> npz at ``path`` -> port params (fp32, CPU)."""
    save_pytree(str(path), jparams)
    return params_from_numpy(load_npz(str(path)), device="cpu")


def to_port_bank(jbank, path):
    """A JAX LoRA bank or one adapter -> npz -> the port's per-layer form."""
    save_pytree(str(path), jbank)
    return bank_from_numpy(load_npz(str(path)), device="cpu")


def to_flat(jtree, path):
    """A JAX pytree -> the flat numpy arrays ``save_pytree`` writes."""
    save_pytree(str(path), jtree)
    return load_npz(str(path))


EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def load_example(name):
    """The module ``examples/<name>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_stdout(name) -> str:
    """What the JAX example ``examples/<name>.py`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load_example(name).main()
    return buf.getvalue()


# a loss printed with 3 decimals against the twin's value: half a printed
# unit plus 1e-4
LOSS_TOL = 6e-4


def close_to_print(printed: str, got: float):
    assert abs(float(printed) - got) <= LOSS_TOL, (printed, got)


def jax_weights(tmp, adapter_keys):
    """A JAX example's weights on the reduced llama3 as the twin's ``run``
    takes them: ``init_params`` at key 0 and each adapter drawn by
    ``load_random`` at its key in the example's store (4 slots of rank 8,
    key 1; the slot count shapes the draw)."""
    jcfg = j_get_reduced("llama3-8b")
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    jstore = JAdapterStore(jcfg, JLoRAConfig(n_slots=4, r=8),
                           jax.random.PRNGKey(1))
    adapters = {}
    for name, key in adapter_keys.items():
        jstore.load_random(name, jax.random.PRNGKey(key))
        adapters[name] = to_flat(jstore.get_adapter(name),
                                 tmp / f"{name}.npz")
        jstore.unload(name)
    return {"params": to_flat(jparams, tmp / "params.npz"),
            "adapters": adapters}


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))          # a writable copy
    return out if dtype is None else out.to(dtype)


def j(x):
    return jnp.asarray(np.asarray(x))


def max_err(a, b) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0

