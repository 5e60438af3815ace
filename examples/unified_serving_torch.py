"""End-to-end example on the PyTorch port: serve batched multi-LoRA inference
requests while a fine-tuning job trains a third adapter in the SAME unified
runtime.  The twin of ``examples/unified_serving.py``.

    PYTHONPATH=src python examples/unified_serving_torch.py [--device cpu]

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
from repro_torch.data import datasets, workload
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import Request
from repro_torch.serving.slo import SLOConfig, slo_attainment
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig

ADAPTERS = ("chat", "math", "student")
N_REQUESTS = 30


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
                        EngineConfig(capacity=6, pf_capacity=2, s_max=192,
                                     virtual_time=True))

    # inference load: 30 requests at ~2 RPS across two serving adapters
    prompts = datasets.sharegpt_prompts(N_REQUESTS, vocab=cfg.vocab, seed=7)
    arrivals = workload.poisson_arrivals(2.0, N_REQUESTS, seed=7)
    for i, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(Request(rid=i, prompt=p,
                           adapter=("chat", "math")[i % 2],
                           max_new_tokens=12, arrival=float(t)))

    # concurrent fine-tuning of "student" (its own grad accumulation)
    rows = datasets.gsm8k_like(40, vocab=cfg.vocab, seed=11)
    tr_rows, ev_rows = datasets.split_eval(rows)
    eng.add_trainer(MixedLoraTrainer("student", store.slot_of("student"),
                                     tr_rows, ev_rows,
                                     TrainerConfig(rows_per_micro=2,
                                                   accum_steps=4, epochs=1)))

    m = eng.run(max_ticks=200000)
    tr = eng.trainers["student"]
    return {"slo": slo_attainment(eng.finished, SLOConfig()),
            "finished": len(eng.finished),
            "tokens": {r.rid: list(r.output) for r in eng.finished},
            "rates": m.rates(), "steps": m.steps,
            "tokens_trained": tr.tokens_trained,
            "opt_steps": tr.optimizer_steps,
            "train_losses": list(tr.train_losses),
            "loss_first": float(np.mean(tr.train_losses[:4])),
            "loss_last": float(np.mean(tr.train_losses[-4:]))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("llama3-8b")
    out = run(cfg, dev, cfg.dtype)
    print(f"SLO attainment: {out['slo']:.3f} "
          f"({out['finished']}/{N_REQUESTS} finished)")
    print(f"throughput: {out['rates']}")
    print(f"student: {out['tokens_trained']} tokens trained, "
          f"{out['opt_steps']} optimizer steps, "
          f"loss {out['loss_first']:.3f} -> {out['loss_last']:.3f}")
    return out


if __name__ == "__main__":
    main()
