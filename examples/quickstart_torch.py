"""Quickstart on the PyTorch port: load a base model, attach two virtual
LoRA models, and run a mixed batch (two adapters + base) through the
unified flow in one step.  The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  ``run`` takes numpy
weights (``weights={"params": flat, "adapters": {name: flat}}``, the flat
arrays JAX's ``save_pytree`` writes) or, without them, draws the base from
a torch generator seeded 0 and the k-th adapter from one seeded 100 + k.
"""
import argparse

import numpy as np
import torch

from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
from repro_torch.configs import get_reduced
from repro_torch.core.flow import FlowConfig
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.model import init_cache
from repro_torch.models.schema import init_params
from repro_torch.models.stream import PFBatch, UnifiedBatch

ADAPTERS = ("chat", "math", "code")      # in load order


def run(cfg, device, dtype, weights=None) -> dict:
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, cfg.dtype)
    params = (params_from_numpy(weights["params"], dev, dtype) if weights
              else init_params(cfg, device=dev, dtype=dtype, seed=0))

    def load(store, name):
        if weights:
            store.load(name, bank_from_numpy(weights["adapters"][name], dev,
                                             dtype))
        else:
            seed = 100 + ADAPTERS.index(name)
            store.load_random(name, torch.Generator(dev).manual_seed(seed))

    # one shared base model, two isolated virtual LoRA models ("0 B" extra)
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), dev, dtype)
    load(store, "chat")
    load(store, "math")
    model = MixedLoraModel(cfg, params, store)
    out = {"resident": list(store.resident)}

    # one unified prefill step: row 0 -> chat, row 1 -> math, row 2 -> base;
    # the rows are padded to the planner's tile, the logits read at 12
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (3, 12))
    bt = FlowConfig().block_t
    padded = np.zeros((3, -(-12 // bt) * bt), np.int32)
    padded[:, :12] = toks
    pf = PFBatch(tokens=torch.from_numpy(padded).to(dev),
                 length=torch.tensor([12, 12, 12], dtype=torch.int32,
                                     device=dev),
                 adapter=torch.tensor([store.slot_of("chat"),
                                       store.slot_of("math"), -1],
                                      dtype=torch.int32, device=dev))
    cache = init_cache(cfg, 3, 64, dev, dtype)
    with torch.inference_mode():
        res = model.forward(UnifiedBatch(pf=pf), cache=cache)
    out["next_tokens"] = res.pf_logits.argmax(-1).cpu().numpy()

    # hot-swap: unload "chat", load a new adapter into the freed slot
    store.unload("chat")
    load(store, "code")
    out["after_hot_swap"] = list(store.resident)

    # migration: void "math" (base excluded), unvoid into a fresh store
    vm = model.virtual("math")
    blob = vm.void()
    store2 = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), dev, dtype)
    vm2 = vm.unvoid(blob, params, store2, dev)
    out["migrated_slot"] = vm2.slot
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("llama3-8b")
    out = run(cfg, dev, cfg.dtype)
    print("resident adapters:", out["resident"])
    print("next tokens per adapter:", out["next_tokens"])
    print("after hot-swap:", out["after_hot_swap"])
    print("migrated adapter slot:", out["migrated_slot"])
    return out


if __name__ == "__main__":
    main()
