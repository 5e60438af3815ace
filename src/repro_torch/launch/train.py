"""Fine-tuning CLI: concurrent multi-LoRA training through the port's
unified engine.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      [--reduced] [--device cuda|cpu] [--dtype bfloat16|float32] \\
      --adapters 2 --epochs 2

Runs on ``cuda`` unless ``--device cpu`` is given; weights and adapters are
random, drawn from ``--seed``, and the rows are the synthetic
``alpaca_like`` / ``gsm8k_like`` sets; a cross-attention model's rows carry
one ``aux_embed`` (``make_aux``, drawn as the JAX CLI draws it).  Prints
what the JAX CLI prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.data import datasets
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig


def make_aux(cfg, rng: np.random.Generator):
    """A cross model's ``aux_embed`` [F, d] float32 (``0.1 *`` a standard
    normal from ``rng``, the JAX CLI's ``make_aux``); None otherwise."""
    if cfg.encoder is not None:
        return rng.standard_normal((cfg.encoder.n_frames, cfg.d_model),
                                   dtype=np.float32) * 0.1
    if cfg.cross_attn_every:
        return rng.standard_normal((cfg.n_img_tokens, cfg.d_model),
                                   dtype=np.float32) * 0.1
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b",
                    help="one of the eleven model ids: "
                         + ", ".join(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="parameter and activation dtype (default: the "
                         "config's)")
    ap.add_argument("--adapters", type=int, default=2)
    ap.add_argument("--rows", type=int, default=48)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--accum", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dtype = resolve_dtype(args.dtype, cfg.dtype)
    params = init_params(cfg, device=device, dtype=dtype, seed=args.seed)
    lcfg = LoRAConfig(n_slots=max(4, args.adapters), r=8)
    store = AdapterStore(cfg, lcfg, device=device, dtype=dtype)
    model = MixedLoraModel(cfg, params, store)
    eng = UnifiedEngine(model, EngineConfig(capacity=2, pf_capacity=2,
                                            s_max=256))
    aux = make_aux(cfg, np.random.default_rng(args.seed))

    gens = [datasets.alpaca_like, datasets.gsm8k_like]
    for i in range(args.adapters):
        name = f"adapter{i}"
        gen = torch.Generator(device=device)
        gen.manual_seed(100 + i)
        store.load_random(name, gen)
        rows = gens[i % 2](args.rows, vocab=cfg.vocab, seed=args.seed + i)
        tr_rows, ev_rows = datasets.split_eval(rows)
        eng.add_trainer(MixedLoraTrainer(
            name, store.slot_of(name), tr_rows, ev_rows,
            TrainerConfig(rows_per_micro=2, accum_steps=args.accum,
                          epochs=args.epochs), aux_embed=aux))

    t0 = time.time()
    metrics = eng.run(max_ticks=100000)
    dt = time.time() - t0
    print(f"arch={cfg.name} device={device.type} dtype={str(dtype)[6:]} "
          f"adapters={args.adapters} wall={dt:.1f}s rates={metrics.rates()}")
    nan = float("nan")
    for name, tr in eng.trainers.items():
        first = np.mean(tr.train_losses[:4]) if tr.train_losses else nan
        last = np.mean(tr.train_losses[-4:]) if tr.train_losses else nan
        ev = np.mean(tr.eval_losses[-4:]) if tr.eval_losses else nan
        print(f"  {name}: loss {first:.3f} -> {last:.3f}  "
              f"opt_steps={tr.optimizer_steps} eval={ev:.3f} "
              f"tokens={tr.tokens_trained}")
    return eng


if __name__ == "__main__":
    main()
