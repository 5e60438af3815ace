"""Shared set-up of the PyTorch port's parity tests: weights are made in JAX,
written with ``repro.checkpoint.io.save_pytree`` and read into the port
through its bridge (``repro_torch.checkpoint.io``); other inputs are made
from numpy seeds and handed to both packages."""
import jax.numpy as jnp
import numpy as np
import torch

from repro.checkpoint.io import save_pytree
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


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor."""
    out = torch.from_numpy(np.array(x))          # a writable copy
    return out if dtype is None else out.to(dtype)


def j(x):
    return jnp.asarray(np.asarray(x))


def max_err(a, b) -> float:
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return float(d.max()) if d.size else 0.0

