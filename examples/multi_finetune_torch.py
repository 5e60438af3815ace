"""Concurrent multi-LoRA fine-tuning on the PyTorch port: two trainers, one
shared backward pass per unified step, isolated masked optimizer updates.
The twin of ``examples/multi_finetune.py``.

    PYTHONPATH=src python examples/multi_finetune_torch.py [--device cpu]

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
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.data import datasets
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig

ADAPTERS = ("alpaca", "gsm8k")


def run(cfg, device, dtype, weights=None) -> dict:
    dev = resolve_device(device)
    dtype = resolve_dtype(dtype, cfg.dtype)
    params = (params_from_numpy(weights["params"], dev, dtype) if weights
              else init_params(cfg, device=dev, dtype=dtype, seed=0))
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), dev, dtype)
    for k, name in enumerate(ADAPTERS):
        if weights:
            store.load(name, bank_from_numpy(weights["adapters"][name], dev,
                                             dtype))
        else:
            store.load_random(name, torch.Generator(dev).manual_seed(100 + k))
    eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                        EngineConfig(capacity=2, pf_capacity=2, s_max=64))

    a_rows, a_ev = datasets.split_eval(datasets.alpaca_like(48,
                                                            vocab=cfg.vocab))
    g_rows, g_ev = datasets.split_eval(datasets.gsm8k_like(48,
                                                           vocab=cfg.vocab))
    tcfg = TrainerConfig(rows_per_micro=2, accum_steps=4, epochs=2)
    eng.add_trainer(MixedLoraTrainer("alpaca", store.slot_of("alpaca"),
                                     a_rows, a_ev, tcfg))
    eng.add_trainer(MixedLoraTrainer("gsm8k", store.slot_of("gsm8k"),
                                     g_rows, g_ev, tcfg))

    m = eng.run(max_ticks=200000)
    out = {"rates": m.rates(), "steps": m.steps, "trainers": {}}
    for name, tr in eng.trainers.items():
        out["trainers"][name] = {
            "loss_first": float(np.mean(tr.train_losses[:6])),
            "loss_last": float(np.mean(tr.train_losses[-6:])),
            "eval": float(np.mean(tr.eval_losses[-6:])),
            "opt_steps": tr.optimizer_steps,
            "tokens_trained": tr.tokens_trained,
            "train_losses": list(tr.train_losses),
            "eval_losses": list(tr.eval_losses)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("llama3-8b")
    out = run(cfg, dev, cfg.dtype)
    print(f"throughput: {out['rates']}")
    for name, tr in out["trainers"].items():
        print(f"{name}: loss {tr['loss_first']:.3f} -> "
              f"{tr['loss_last']:.3f}, eval {tr['eval']:.3f}, "
              f"opt_steps={tr['opt_steps']}")
    return out


if __name__ == "__main__":
    main()
