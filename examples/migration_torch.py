"""Instance-to-instance migration on the PyTorch port: void a fine-tuning
adapter mid-run, serialize it (base model NOT included), unvoid it on a
second runtime, and keep training.  The twin of ``examples/migration.py``;
the payload is the npz JAX's ``serialize_pytree`` writes for the adapter.

    PYTHONPATH=src python examples/migration_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given.  ``run`` takes numpy
weights (``weights={"params": flat, "adapters": {"job": flat}}``, the flat
arrays JAX's ``save_pytree`` writes) or, without them, draws the base from
a torch generator seeded 0 and the adapter from one seeded 100.
"""
import argparse

import numpy as np
import torch

from repro_torch.checkpoint.io import bank_from_numpy, bank_to_numpy, \
    deserialize_npz, params_from_numpy, serialize_npz
from repro_torch.configs import get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel, \
    VirtualModel
from repro_torch.data import datasets
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig

ADAPTERS = ("job",)


def _train(cfg, params, store, rows, ev):
    eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                        EngineConfig(capacity=2, pf_capacity=2, s_max=64))
    tr = MixedLoraTrainer("job", store.slot_of("job"), rows, ev,
                          TrainerConfig(rows_per_micro=2, accum_steps=2,
                                        epochs=1))
    eng.add_trainer(tr)
    eng.run(max_ticks=100000)
    return eng, tr


def run(cfg, device, dtype, weights=None) -> dict:
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, cfg.dtype)
    params = (params_from_numpy(weights["params"], dev, dtype) if weights
              else init_params(cfg, device=dev, dtype=dtype, seed=0))
    lcfg = LoRAConfig(n_slots=4, r=8)

    # runtime A: train for half the epochs
    storeA = AdapterStore(cfg, lcfg, dev, dtype)
    if weights:
        storeA.load("job", bank_from_numpy(weights["adapters"]["job"], dev,
                                           dtype))
    else:
        storeA.load_random("job", torch.Generator(dev).manual_seed(100))
    rows, ev = datasets.split_eval(datasets.alpaca_like(32, vocab=cfg.vocab))
    engA, trA = _train(cfg, params, storeA, rows, ev)
    out = {"tokens_A": trA.tokens_trained, "losses_A": list(trA.train_losses),
           "opt_steps_A": trA.optimizer_steps,
           "loss_A": float(np.mean(trA.train_losses[-4:])),
           "rates_A": engA.metrics.rates()}

    # void + serialize (adapter only: the paper's "0 B" base sharing)
    voided = VirtualModel("job", params, storeA).void()
    blob = serialize_npz(bank_to_numpy(cfg, voided.adapter))
    out["payload_bytes"] = len(blob)

    # runtime B: unvoid and continue training where A stopped
    storeB = AdapterStore(cfg, lcfg, dev, dtype)
    voided.adapter = bank_from_numpy(deserialize_npz(blob), "cpu", dtype)
    VirtualModel.unvoid(voided, params, storeB, dev)
    engB, trB = _train(cfg, params, storeB, rows, ev)
    out.update(tokens_B=trB.tokens_trained, losses_B=list(trB.train_losses),
               opt_steps_B=trB.optimizer_steps,
               loss_B_first=float(np.mean(trB.train_losses[:4])),
               loss_B_last=float(np.mean(trB.train_losses[-4:])),
               rates_B=engB.metrics.rates())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("llama3-8b")
    out = run(cfg, dev, cfg.dtype)
    print(f"runtime A: trained {out['tokens_A']} tokens, "
          f"loss {out['loss_A']:.3f}")
    print(f"migration payload: {out['payload_bytes'] / 2**20:.2f} MiB "
          f"(base excluded)")
    print(f"runtime B: continued, loss {out['loss_B_first']:.3f} "
          f"-> {out['loss_B_last']:.3f}")
    return out


if __name__ == "__main__":
    main()
