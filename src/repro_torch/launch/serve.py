"""Serving driver: multi-LoRA inference through the port's unified engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      [--reduced] [--device cuda|cpu] [--dtype bfloat16|float32] \\
      [--spec K] [--over-admit F] [--kv-host-blocks N [--kv-host-quant]] \
      [--adapter-paging] --rps 2 --requests 40 --adapters 2

Runs on ``cuda`` unless ``--device cpu`` is given; weights and adapters are
random, drawn from ``--seed``.  Prints what the JAX CLI prints for the
features this slice has.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.data import datasets, workload
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import PRIORITY_CLASSES, Request
from repro_torch.serving.slo import SLOConfig, slo_attainment
from repro_torch.spec import SpecConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="parameter and activation dtype (default: the "
                         "config's)")
    ap.add_argument("--adapters", type=int, default=2)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--rps", type=float, default=2.0)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--wall-clock", action="store_true",
                    help="real time instead of the calibrated virtual clock")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="T",
                    help="per-tick prefill-token budget (0 = unchunked)")
    ap.add_argument("--no-hash-dedup", action="store_true",
                    help="disable content-hash KV block dedup")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative decoding with up to K drafted tokens "
                         "(n-gram prompt-lookup drafter)")
    ap.add_argument("--over-admit", type=float, default=1.0, metavar="F",
                    help="KV reservation lending factor >= 1.0: the gate "
                         "charges 1/F of the outstanding reservation debt "
                         "and preempts when a lent reservation comes due "
                         "(1.0 = conservative gate)")
    ap.add_argument("--kv-host-blocks", type=int, default=0, metavar="N",
                    help="host KV tier of N device blocks' worth of host "
                         "RAM: preemption victims swap out and restore "
                         "when the modeled transfer beats recompute, and "
                         "shed index blocks demote to host (0 = "
                         "recompute-only preemption)")
    ap.add_argument("--kv-host-quant", action="store_true",
                    help="int8 host-tier residency (not bit-exact: "
                         "restored K/V is dequantized)")
    ap.add_argument("--adapter-paging", default=False,
                    action=argparse.BooleanOptionalAction,
                    help="page adapter weights through the KV block pool "
                         "(a small LRU bank, heterogeneous true ranks; "
                         "default off = static bank partition)")
    ap.add_argument("--priority", default="standard",
                    choices=["interactive", "standard", "batch", "mixed"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    dtype = resolve_dtype(args.dtype, cfg.dtype)
    params = init_params(cfg, device=device, dtype=dtype, seed=args.seed)
    # under paging the bank is a small staging tier and adapters have
    # heterogeneous true ranks; the static baseline holds every adapter
    n_slots = (max(4, min(args.adapters, 16)) if args.adapter_paging
               else max(4, args.adapters))
    lcfg = LoRAConfig(n_slots=n_slots, r=8)
    store = AdapterStore(cfg, lcfg, device=device, dtype=dtype)
    names = []
    ranks = [2, 4, 8]
    for i in range(args.adapters):
        gen = torch.Generator(device=device)
        gen.manual_seed(100 + i)
        store.load_random(f"lora{i}", gen, evict=args.adapter_paging,
                          rank=ranks[i % 3] if args.adapter_paging else None)
        names.append(f"lora{i}")
    model = MixedLoraModel(cfg, params, store)
    eng = UnifiedEngine(model, EngineConfig(
        capacity=8, pf_capacity=4, s_max=256,
        virtual_time=not args.wall_clock, prefill_chunk=args.prefill_chunk,
        hash_dedup=not args.no_hash_dedup, over_admit=args.over_admit,
        adapter_paging=args.adapter_paging,
        kv_host_blocks=args.kv_host_blocks,
        kv_host_quant=args.kv_host_quant,
        spec=(SpecConfig(k_max=args.spec, drafter="ngram") if args.spec > 0
              else None)))

    prompts = datasets.sharegpt_prompts(args.requests, vocab=cfg.vocab,
                                        seed=args.seed)
    arrivals = workload.poisson_arrivals(args.rps, args.requests, args.seed)
    classes = (PRIORITY_CLASSES if args.priority == "mixed"
               else (args.priority,))
    for i, (p, t) in enumerate(zip(prompts, arrivals)):
        eng.submit(Request(rid=i, prompt=p, adapter=names[i % len(names)],
                           max_new_tokens=args.max_new, arrival=float(t),
                           priority_class=classes[i % len(classes)]))

    m = eng.run(max_ticks=500000)
    att = slo_attainment(eng.finished, SLOConfig())
    print(f"arch={cfg.name} device={device.type} dtype={str(dtype)[6:]} "
          f"requests={args.requests} rps={args.rps} "
          f"finished={len(eng.finished)} SLO={att:.3f}")
    print(f"rates={m.rates()}")
    if args.over_admit > 1.0 or m.preemptions:
        print(f"over-admit: factor={args.over_admit} "
              f"preemptions={m.preemptions} "
              f"recomputed={m.preempted_tokens_recomputed} "
              f"lent_peak={m.lent_blocks_peak}")
    if m.reused_prefix_tokens or args.prefill_chunk:
        print(f"prefix: reused={m.reused_prefix_tokens} "
              f"computed={m.prefill_tokens} "
              f"max_pf_step={m.max_pf_tokens_step}")
    if args.adapter_paging or m.adapter_swap_ins:
        print(f"adapters: swap_ins={m.adapter_swap_ins} "
              f"swap_in_bytes={m.adapter_swap_in_bytes} "
              f"resident_hits={m.adapter_resident_hits} "
              f"blocks_resident={m.adapter_blocks_resident} "
              f"peak_coresident={m.adapter_peak_coresident}")
    if args.kv_host_blocks > 0:
        print(f"kv-tiers: host_blocks={args.kv_host_blocks} "
              f"quant={args.kv_host_quant} swap_outs={m.kv_swap_outs} "
              f"restores={m.kv_restores} skips={m.kv_swap_skips} "
              f"demotions={m.kv_demotions} "
              f"rehydrated={m.kv_rehydrated_blocks} "
              f"host_peak_bytes={m.host_bytes_peak}")
    if args.spec > 0:
        print(f"spec: drafted={m.spec_drafted} accepted={m.spec_accepted} "
              f"acceptance={m.spec_accepted / max(m.spec_drafted, 1):.2f} "
              f"steps={m.steps}")
    if eng.hash_dedup:
        print(f"dedup: hash_hits={m.hash_hits} "
              f"resident_blocks={m.hash_blocks_resident} "
              f"probe_admissions={m.probe_admissions}")


if __name__ == "__main__":
    main()
