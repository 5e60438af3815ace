"""Serving driver: multi-LoRA inference through the port's unified engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      [--reduced] [--device cuda|cpu] [--dtype bfloat16|float32] \\
      [--spec K] [--over-admit F] [--kv-host-blocks N [--kv-host-quant]] \
      [--adapter-paging] [--replicas N [--router POLICY] \
      [--no-remote-fetch]] [--finetune] [--attn-tune-file PATH] \
      --rps 2 --requests 40 --adapters 2

``--arch`` takes the eleven ids of ``repro_torch.configs.ARCH_IDS``.  Runs
on ``cuda`` unless ``--device cpu`` is given; weights and adapters are
random, drawn from ``--seed``, and a cross-attention model's requests carry
one ``aux_embed`` (the image patches or audio frames, ``0.1 *`` a standard
normal) drawn from a numpy generator of ``--seed``, as the JAX CLI draws
it.  Prints what the JAX CLI prints for the features the port has; with
``--replicas`` > 1 every summary line adds up the replicas.  Returns the
engines.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.core.lora import LoRAConfig
from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
from repro_torch.data import datasets, workload
from repro_torch.device import resolve_device, resolve_dtype
from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
from repro_torch.launch.train import make_aux
from repro_torch.models.schema import init_params
from repro_torch.serving.engine import EngineConfig, UnifiedEngine
from repro_torch.serving.request import PRIORITY_CLASSES, Request
from repro_torch.serving.slo import SLOConfig, slo_attainment
from repro_torch.spec import SpecConfig
from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig


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
    ap.add_argument("--finetune", action="store_true",
                    help="co-run an alpaca_like fine-tune of lora0 with the "
                         "served traffic (on engine 0 of a fleet)")
    ap.add_argument("--attn-tune-file", default=None, metavar="PATH",
                    help="JSON split table for the split-K attention "
                         "kernels (kernels/autotune.py); shapes it misses "
                         "take the heuristic")
    ap.add_argument("--replicas", type=int, default=1, metavar="N",
                    help="in-process engine replicas behind one router "
                         "(shared base weights, per-replica KV pools and "
                         "adapter banks, fleet-wide block index with "
                         "remote prefix fetch); 1 = single engine")
    ap.add_argument("--router", default="affinity",
                    choices=["affinity", "round-robin", "least-loaded"],
                    help="replica placement policy (--replicas > 1)")
    ap.add_argument("--no-remote-fetch", action="store_true",
                    help="never copy prefix blocks between replica pools")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.attn_tune_file:
        from repro_torch.kernels import autotune
        # the card's own table first (the model merges it at its first
        # call otherwise), so the file's entries win
        autotune.load_card_table(device)
        n = autotune.load_table(args.attn_tune_file)
        print(f"attn autotune: loaded {n} entries from {args.attn_tune_file}")
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
    ecfg = EngineConfig(
        capacity=8, pf_capacity=4, s_max=256,
        virtual_time=not args.wall_clock, prefill_chunk=args.prefill_chunk,
        hash_dedup=not args.no_hash_dedup, over_admit=args.over_admit,
        adapter_paging=args.adapter_paging,
        kv_host_blocks=args.kv_host_blocks,
        kv_host_quant=args.kv_host_quant,
        spec=(SpecConfig(k_max=args.spec, drafter="ngram") if args.spec > 0
              else None))
    fleet = None
    if args.replicas > 1:
        fleet = build_fleet(model, ecfg, FleetConfig(
            replicas=args.replicas,
            router=RouterConfig(policy=args.router),
            remote_fetch=not args.no_remote_fetch))
        engines = fleet.engines
    else:
        engines = [UnifiedEngine(model, ecfg)]
    eng = engines[0]
    front = fleet if fleet is not None else eng
    if args.prefill_chunk and not eng.chunk_budget:
        print("note: --prefill-chunk is inactive for this model "
              "(needs the paged cache and an attention-only pattern)")
    if eng.hash_dedup and not eng.suffix_prefill:
        print("note: hash dedup shares block storage for this model but "
              "suffix-only prefill is inactive (needs the paged cache and "
              "an attention-only pattern)")
    if args.spec > 0 and eng.spec is None:
        print("note: --spec is inactive for this model (Mamba state "
              "cannot roll back drafts)")

    aux = make_aux(cfg, np.random.default_rng(args.seed))
    prompts = datasets.sharegpt_prompts(args.requests, vocab=cfg.vocab,
                                        seed=args.seed)
    arrivals = workload.poisson_arrivals(args.rps, args.requests, args.seed)
    classes = (PRIORITY_CLASSES if args.priority == "mixed"
               else (args.priority,))
    for i, (p, t) in enumerate(zip(prompts, arrivals)):
        front.submit(Request(rid=i, prompt=p,
                             adapter=names[i % len(names)],
                             max_new_tokens=args.max_new, arrival=float(t),
                             aux_embed=aux,
                             priority_class=classes[i % len(classes)]))

    if args.finetune:
        rows = datasets.alpaca_like(32, vocab=cfg.vocab, seed=args.seed)
        tr_rows, ev_rows = datasets.split_eval(rows)
        eng.add_trainer(MixedLoraTrainer(
            names[0], eng.model.store.slot_of(names[0]), tr_rows, ev_rows,
            TrainerConfig(rows_per_micro=2, accum_steps=4, epochs=1),
            aux_embed=aux))

    m = front.run(max_ticks=500000)
    finished = [r for e in engines for r in e.finished]
    att = slo_attainment(finished, SLOConfig())
    print(f"arch={cfg.name} device={device.type} dtype={str(dtype)[6:]} "
          f"requests={args.requests} rps={args.rps} "
          f"finished={len(finished)} SLO={att:.3f}")
    print(f"rates={m.rates()}")

    def tot(field, agg=sum):
        # the fleet rollup carries the headline counters; the per-engine
        # metrics hold the rest
        if fleet is not None:
            return agg(getattr(e, field) for e in m.per_engine)
        return getattr(m, field)

    if fleet is not None:
        print(f"fleet: replicas={args.replicas} router={args.router} "
              f"routed={fleet.routed} "
              f"remote_fetch_blocks={m.remote_fetch_blocks} "
              f"remote_fetch_time={m.remote_fetch_time:.4f} "
              f"fleet_index_keys={len(fleet.index)}")
    if args.over_admit > 1.0 or tot("preemptions"):
        print(f"over-admit: factor={args.over_admit} "
              f"preemptions={tot('preemptions')} "
              f"recomputed={tot('preempted_tokens_recomputed')} "
              f"lent_peak={tot('lent_blocks_peak', max)}")
    if m.reused_prefix_tokens or args.prefill_chunk:
        print(f"prefix: reused={m.reused_prefix_tokens} "
              f"computed={m.prefill_tokens} "
              f"max_pf_step={tot('max_pf_tokens_step', max)}")
    if args.adapter_paging or tot("adapter_swap_ins"):
        print(f"adapters: swap_ins={tot('adapter_swap_ins')} "
              f"swap_in_bytes={tot('adapter_swap_in_bytes')} "
              f"resident_hits={tot('adapter_resident_hits')} "
              f"blocks_resident={tot('adapter_blocks_resident')} "
              f"peak_coresident={tot('adapter_peak_coresident', max)}")
    if args.kv_host_blocks > 0:
        print(f"kv-tiers: host_blocks={args.kv_host_blocks} "
              f"quant={args.kv_host_quant} "
              f"swap_outs={tot('kv_swap_outs')} "
              f"restores={tot('kv_restores')} "
              f"skips={tot('kv_swap_skips')} "
              f"demotions={tot('kv_demotions')} "
              f"rehydrated={tot('kv_rehydrated_blocks')} "
              f"host_peak_bytes={tot('host_bytes_peak', max)}")
    if args.spec > 0:
        drafted, accepted = tot("spec_drafted"), tot("spec_accepted")
        print(f"spec: drafted={drafted} accepted={accepted} "
              f"acceptance={accepted / max(drafted, 1):.2f} "
              f"steps={m.steps}")
    if eng.hash_dedup:
        print(f"dedup: hash_hits={m.hash_hits} "
              f"resident_blocks={tot('hash_blocks_resident')} "
              f"probe_admissions={tot('probe_admissions')}")
    if args.finetune:
        tr = eng.trainers[names[0]]
        print(f"finetune: tokens={tr.tokens_trained} "
              f"opt_steps={tr.optimizer_steps}")
    return engines


if __name__ == "__main__":
    main()
