#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU

Imports only the port (``src/repro_torch``), never JAX.  Phases, each
printing its lines; any failure raises and exits non-zero:

1. build   — compile the four CUDA kernels from ``src/repro_torch/kernels/
             csrc`` (one nvcc per source, in parallel).
2. kernels — each kernel vs its plain PyTorch version on the card at the
             main path's shapes, bf16 and fp32, with the stated tolerance;
             then, in bf16 at one main-path shape each, kernel, plain and
             library times (CUDA events after warm-up) beside the bound.
3. parity  — reduced llama3-8b in fp32 (TF32 off), the same numpy-seeded
             weights and trace through the engine on ``cuda`` (kernels) and
             on ``cpu`` (plain versions): greedy tokens equal, first-step
             logits within tolerance.
4. full    — full-width llama3-8b in bf16 (32 layers, d_model 4096, vocab
             128256, random weights), 2 gaussian-B adapters, two waves of 4
             requests (wave 2 reuses wave 1's 128-token heads, so its
             prefill rows carry cached_len), 16 new tokens each; every
             kernel's launch counter must be > 0 for that run.

Then one JSON line of per-kernel numbers, the card's name and power limit,
and the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # x max|plain| per row


def _import_port():
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.flow import FlowConfig
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.bgmv import bgmv
    from repro_torch.kernels.decode_attn import paged_decode_attention
    from repro_torch.kernels.ops import route
    from repro_torch.kernels.prefill_attn import paged_prefill_attention
    from repro_torch.kernels.smlm import smlm
    return dict(build=build, ref=ref, smlm=smlm, bgmv=bgmv, route=route,
                block_t=FlowConfig().block_t,
                decode=paged_decode_attention,
                prefill=paged_prefill_attention)


# ---------------------------------------------------------------- helpers
def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def compare(out, plain, dtype) -> float:
    """Check ``out`` against ``plain`` row by row (a row is the last axis: a
    token's projection, a query head's attention output): each row's max
    abs error must be within ``TOL[dtype]`` times that row's max |plain|, so
    rows of small values are held to their own scale (an all-zero row must
    be exactly 0).  Returns the max abs error over the tensor."""
    o = out.float().reshape(-1, out.shape[-1])
    p = plain.float().reshape(-1, plain.shape[-1])
    err_row = (o - p).abs().amax(-1)
    lim_row = TOL[dtype] * p.abs().amax(-1)
    bad = int((err_row > lim_row).sum())
    if bad or not torch.isfinite(o).all():
        worst = int(torch.argmax(err_row - lim_row))
        raise AssertionError(
            f"{bad} of {len(err_row)} rows over the limit; worst row {worst}:"
            f" err {float(err_row[worst]):.3e} > {float(lim_row[worst]):.3e}")
    return float(err_row.max())


# -------------------------------------------------- phase 2: kernel checks
def lora_case(T, d_in, d_out, dtype, dev, gen, block_t, n=4, r=8):
    """Main-path LoRA inputs: per-token ids over 4 slots plus base-only
    (-1) rows, grouped into tiles of the planner's block_t for the SMLM
    head."""
    x = torch.randn(T, d_in, generator=gen, device=dev).to(dtype)
    a = (torch.randn(n, d_in, r, generator=gen, device=dev)
         / d_in ** 0.5).to(dtype)
    b = (torch.randn(n, r, d_out, generator=gen, device=dev) * 0.1).to(dtype)
    tiles = torch.randint(-1, n, (T // block_t,), generator=gen, device=dev)
    ids = torch.repeat_interleave(tiles, block_t).to(torch.int32)
    scale = torch.ones(n, device=dev)
    return x, a, b, ids, scale


def check_lora(K, dtype, dev, gen, timing: bool):
    rows = {}
    bt = K["block_t"]
    for name, T in (("smlm", 1024), ("bgmv", 8)):
        errs = []
        for d_in, d_out in ((4096, 4096), (4096, 1024), (4096, 14336),
                            (14336, 4096)):
            x, a, b, ids, scale = lora_case(T, d_in, d_out, dtype, dev,
                                            gen, bt)
            if name == "bgmv":
                ids = torch.tensor([0, 1, 2, 3, 3, -1, 1, 5], device=dev,
                                   dtype=torch.int32)
            n_head = T if name == "smlm" else 0
            rt = K["route"](ids, scale[ids.long().clamp(0, 3)], 4, n_head,
                            bt)
            if name == "smlm":
                args = (x, a, b, rt.tile_ids, rt.tile_scale)
                run = lambda: K["smlm"](*args, block_t=bt)
                plain = lambda: K["ref"].smlm_ref(*args, bt)
                live_ids, live_scale = rt.tile_ids, rt.tile_scale
                t_live = int((rt.tile_scale != 0).sum()) * bt
            else:
                args = (x, a, b, rt.tail_ids, rt.tail_scale)
                run = lambda: K["bgmv"](*args)
                plain = lambda: K["ref"].bgmv_ref(*args)
                live_ids, live_scale = rt.tail_ids, rt.tail_scale
                t_live = int((rt.tail_scale != 0).sum())
            err = compare(run(), plain(), dtype)
            errs.append(err)
            if timing and (d_in, d_out) == (4096, 14336):
                used = torch.unique(live_ids[live_scale != 0]).numel()
                it = x.element_size()
                # X rows of live tokens only (a disabled tile or token
                # needs none), every output row, each used adapter once
                nbytes = (t_live * d_in + T * d_out) * it \
                    + used * 8 * (d_in + d_out) * it
                flops = 2 * t_live * 8 * (d_in + d_out)
                bms, by = bound(nbytes, flops, dtype)
                # library yardstick: torch.bmm shrink + expand on A/B
                # gathered per tile (SMLM) or per token (BGMV) in advance
                sel = live_ids.long()
                xa = x.view(-1, bt if name == "smlm" else 1, d_in)
                ag, bg = a[sel], b[sel]
                lib = lambda: torch.bmm(torch.bmm(xa, ag), bg)
                rows[name] = dict(
                    max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain),
                    library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
                    shape=f"T={T} d_in={d_in} d_out={d_out} r=8 n=4"
                          + (f" block_t={bt}" if name == "smlm" else ""))
        print(f"kernels: {name:<13} {str(dtype)[6:]:<8} "
              f"max_abs_err={max(errs):.3e} tol={TOL[dtype]:g}x"
              f"max|plain| per row block_t={bt} shapes=(4096,4096),"
              "(4096,1024),(4096,14336),(14336,4096) ok")
    return rows


def paged_case(dev, gen, dtype, B, nbt, need, n_blocks=129, bs=32, g=8,
               hd=128):
    kp = torch.randn(n_blocks, bs, g, hd, generator=gen, device=dev
                     ).to(dtype)
    vp = torch.randn(n_blocks, bs, g, hd, generator=gen, device=dev
                     ).to(dtype)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = torch.zeros(B, nbt, dtype=torch.int32, device=dev)
    off = 0
    for i, k in enumerate(need):
        tables[i, :k] = perm[off:off + k].to(torch.int32)
        off += k
    return kp, vp, tables


def check_attention(K, dtype, dev, gen, timing: bool):
    rows = {}
    h, g, hd, bs, nbt = 32, 8, 128, 32, 16
    it = torch.empty((), dtype=dtype).element_size()
    # decode: 8 rows, row 0 inactive (pos 0, null table)
    pos = torch.tensor([0, 143, 150, 200, 37, 255, 300, 511], device=dev,
                       dtype=torch.int32)
    need = [0] + [int(p) // bs + 1 for p in pos[1:]]
    kp, vp, tables = paged_case(dev, gen, dtype, 8, nbt, need)
    q = torch.randn(8, h, hd, generator=gen, device=dev).to(dtype)
    args = (q, kp, vp, tables, pos)
    err = compare(K["decode"](*args), K["ref"].paged_decode_ref(*args),
                  dtype)
    print(f"kernels: paged_decode  {str(dtype)[6:]:<8} max_abs_err={err:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row B=8 h=32 g=8 hd=128 bs=32 "
          "nbt=16 null-padded, inactive row ok")
    if timing:
        # K/V rows the function needs: keys 0..pos of each request (each
        # row of a KV head is contiguous in the pool, so a whole block is
        # the kernel's choice, not the function's need)
        keys = sum(int(p) + 1 for p in pos)
        nbytes = (2 * q.numel() + 2 * keys * g * hd) * it
        flops = sum(4 * h * hd * (int(p) + 1) for p in pos)
        bms, by = bound(nbytes, flops, dtype)
        lib = sdpa_yardstick(q[:, None], kp, vp, tables,
                             q_pos=pos[:, None].long(),
                             kend=pos.long() + 1)
        rows["paged_decode"] = dict(
            max_abs_err=err, ms=time_ms(lambda: K["decode"](*args)),
            plain_ms=time_ms(lambda: K["ref"].paged_decode_ref(*args)),
            library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
            shape="B=8 h=32 g=8 hd=128 bs=32 pos up to 511")
    # prefill: 16-token suffixes over 128 cached tokens, one cold row
    # (cached 0) in the positional bucket, one all-masked padding row
    cached = torch.tensor([128, 128, 128, 0, 0], device=dev,
                          dtype=torch.int32)
    seg = torch.tensor([16, 12, 9, 16, 0], device=dev, dtype=torch.int32)
    Sq = 16
    need = [(int(c) + Sq - 1) // bs + 1 for c in cached]
    kp, vp, tables = paged_case(dev, gen, dtype, 5, nbt, need)
    qp = torch.randn(5, Sq, h, hd, generator=gen, device=dev).to(dtype)
    args = (qp, kp, vp, tables, cached, seg)
    out = K["prefill"](*args)
    if float(out[4].float().abs().max()) != 0.0:
        raise AssertionError("all-masked prefill row is not 0")
    err = compare(out, K["ref"].paged_prefill_ref(*args), dtype)
    print(f"kernels: paged_prefill {str(dtype)[6:]:<8} max_abs_err={err:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row B=5 Sq=16 cached=128/0 "
          "h=32 g=8 hd=128 all-masked row=0 ok")
    if timing:
        ar = torch.arange(Sq, device=dev)
        qpos = cached[:, None].long() + ar[None, :]
        kend = (cached + seg).long()
        live = (seg > 0).long()[:, None]          # seg 0 rows are zeros
        valid_keys = torch.minimum(qpos + 1, kend[:, None]).clamp(min=0) \
            * live
        # K/V rows the function needs: those the last query row sees
        keys = int(valid_keys[:, -1].sum())
        nbytes = (2 * qp.numel() + 2 * keys * g * hd) * it
        flops = int(4 * h * hd * valid_keys.sum())
        bms, by = bound(nbytes, flops, dtype)
        lib = sdpa_yardstick(qp, kp, vp, tables, q_pos=qpos, kend=kend)
        rows["paged_prefill"] = dict(
            max_abs_err=err, ms=time_ms(lambda: K["prefill"](*args)),
            plain_ms=time_ms(lambda: K["ref"].paged_prefill_ref(*args)),
            library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
            shape="B=5 Sq=16 cached 128 h=32 g=8 hd=128 bs=32")
    return rows


def sdpa_yardstick(q, kp, vp, tables, q_pos, kend):
    """One ``scaled_dot_product_attention`` call on the gathered K/V view
    (gathered in advance): the library yardstick, timed only."""
    B, S, h, hd = q.shape
    tbl = tables.long()
    nbt, bs = tbl.shape[1], kp.shape[1]
    k = kp[tbl].reshape(B, nbt * bs, -1, hd).transpose(1, 2).contiguous()
    v = vp[tbl].reshape(B, nbt * bs, -1, hd).transpose(1, 2).contiguous()
    j = torch.arange(nbt * bs, device=q.device)
    mask = (j[None, None, :] <= q_pos[:, :, None]) \
        & (j[None, None, :] < kend[:, None, None])
    qt = q.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qt, k, v, attn_mask=mask[:, None], enable_gqa=True)


# ------------------------------------------------- phase 3: reduced parity
def numpy_weights(cfg, seed):
    from repro_torch.models.schema import param_shapes
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith(("ln1", "ln2", "final_norm")):
            flat[key] = np.ones(shape, np.float32)
        else:
            std = min(0.02, shape[-2] ** -0.5 if len(shape) > 1 else 1.0)
            flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return flat


def numpy_adapter(cfg, lcfg, seed):
    from repro_torch.models.schema import lora_targets
    rng = np.random.default_rng(seed)
    flat = {}
    for name, tg in lora_targets(cfg, lcfg.targets).items():
        L = cfg.n_layers
        flat[f"blocks/0/{name}/a"] = (rng.standard_normal(
            (L, tg.d_in, lcfg.r)) / tg.d_in ** 0.5).astype(np.float32)
        flat[f"blocks/0/{name}/b"] = (rng.standard_normal(
            (L, lcfg.r, tg.d_out)) * 0.02 * lcfg.scaling).astype(np.float32)
    return flat


def build_engine(cfg, params, adapters, lcfg, dev, dtype, ecfg):
    from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
    from repro_torch.serving.engine import UnifiedEngine
    store = AdapterStore(cfg, lcfg, device=dev, dtype=dtype)
    for name, adapter in adapters.items():
        store.load(name, adapter)
    return UnifiedEngine(MixedLoraModel(cfg, params, store), ecfg)


def record_logits(eng, keep: bool):
    """Wrap the engine's step to record every tick's logits (``keep``:
    copies on the host) or only whether they are finite (a flag left on the
    device, so the timed run gains no transfer); the step is unchanged."""
    seen = []
    step = eng.forward_step

    def wrapped(*a):
        out = step(*a)
        got = [(k, getattr(out, k)) for k in ("pf_logits", "dec_logits")
               if getattr(out, k) is not None]
        seen.append({k: v.float().cpu() for k, v in got} if keep
                    else torch.stack([torch.isfinite(v).all()
                                      for _, v in got]).all())
        return out

    eng.forward_step = wrapped
    return seen


def shared_prefix_trace(vocab, adapters, seed, n=8, head=64):
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, head).astype(np.int32) for _ in adapters]
    reqs = []
    for i in range(n):
        k = i % len(adapters)
        tail = rng.integers(0, vocab, 5 + 3 * i).astype(np.int32)
        reqs.append(Request(rid=i, prompt=np.concatenate([heads[k], tail]),
                            adapter=adapters[k], max_new_tokens=6,
                            arrival=0.0 if i < 2 else 0.4 + 0.1 * i))
    return reqs


def parity(K, devices=("cuda", "cpu")):
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.serving.engine import EngineConfig
    cfg = get_reduced("llama3-8b")
    lcfg = LoRAConfig(n_slots=4, r=8)
    flat = numpy_weights(cfg, seed=0)
    ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
          for i in range(2)}
    results = {}
    for dev in devices:
        params = params_from_numpy(flat, device=dev)
        adapters = {}
        for name, f in ad.items():
            layers = bank_from_numpy(f, device=dev)["layers"]
            adapters[name] = {"layers": layers}
        eng = build_engine(cfg, params, adapters, lcfg, torch.device(dev),
                           torch.float32,
                           EngineConfig(capacity=4, pf_capacity=2, s_max=128,
                                        virtual_time=True))
        seen = record_logits(eng, keep=True)
        for k in ("smlm", "bgmv", "decode", "prefill"):
            K[k].launches = 0
        for r in shared_prefix_trace(cfg.vocab, list(ad), seed=3):
            eng.submit(r)
        eng.run(max_ticks=10000)
        launches = {k: K[k].launches for k in ("smlm", "bgmv", "decode",
                                                "prefill")}
        results[dev] = (eng, seen, launches)
    (ge, gs, gl), (ce, cs, _) = (results[d] for d in devices)
    gtok = {r.rid: r.output for r in ge.finished}
    ctok = {r.rid: r.output for r in ce.finished}
    if len(gtok) != 8 or gtok != ctok:
        raise AssertionError(f"greedy tokens differ: cuda {gtok} cpu {ctok}")
    err = max(float((gs[0][k] - cs[0][k]).abs().max()) for k in gs[0])
    if err > 1e-3:
        raise AssertionError(f"first-step logits differ by {err:.3e}")
    if min(gl.values()) == 0:
        raise AssertionError(f"a kernel did not launch at reduced size: {gl}")
    print(f"parity: reduced llama3-8b fp32 cuda==cpu greedy tokens for 8 "
          f"requests (48 tokens), first-step logits max_abs_err={err:.3e} "
          f"tol=1e-3, reused_prefix_tokens={ge.metrics.reused_prefix_tokens}"
          f", cuda launches={gl} ok")


# ------------------------------------------------ phase 4: full width run
def full_width(K, cfg, dev, dtype, head=128, tail=16, max_new=16, seed=0):
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models.schema import init_params
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
    from repro_torch.serving.request import Request, State
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=dev, dtype=dtype)
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), device=dev,
                         dtype=dtype)
    for i in range(2):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + i)
        store.load_random(f"lora{i}", g, gaussian_b=True)
    eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                        EngineConfig(capacity=8, pf_capacity=4, s_max=512))
    seen = record_logits(eng, keep=False)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, cfg.vocab, head).astype(np.int32)
             for _ in range(4)]

    def wave(base_rid):
        return [Request(rid=base_rid + i,
                        prompt=np.concatenate([heads[i], rng.integers(
                            0, cfg.vocab, tail).astype(np.int32)]),
                        adapter=f"lora{i % 2}", max_new_tokens=max_new,
                        arrival=eng.clock.now()) for i in range(4)]

    m = eng.metrics
    ticks = []          # (seconds, prefill tokens, decode tokens) per tick

    def tick():
        p0, d0 = m.prefill_tokens, m.decode_tokens
        t = time.perf_counter()
        eng.tick()      # ends in the host reading the sampled tokens
        ticks.append((time.perf_counter() - t, m.prefill_tokens - p0,
                      m.decode_tokens - d0))

    for k in ("smlm", "bgmv", "decode", "prefill"):
        K[k].launches = 0
    w1 = wave(0)
    for r in w1:
        eng.submit(r)
    while not all(r.state in (State.DECODE, State.DONE) for r in w1):
        tick()
    w2 = wave(4)
    for r in w2:
        eng.submit(r)
    while eng.waiting or eng.active or eng.prefilling or eng.future:
        tick()
    launches = {k: K[k].launches for k in ("smlm", "bgmv", "decode",
                                            "prefill")}
    done = list(eng.finished)
    if len(done) != 8 or any(len(r.output) != max_new for r in done):
        raise AssertionError("not every request finished with "
                             f"{max_new} tokens")
    if not bool(torch.stack(seen).all()):
        raise AssertionError("non-finite logits")
    if not eng.cachemgr.pristine:
        raise AssertionError("the KV pool did not drain pristine")
    if m.reused_prefix_tokens != 4 * head:
        raise AssertionError(f"wave 2 reused {m.reused_prefix_tokens} "
                             f"prefix tokens, expected {4 * head}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    ttft = {r.rid: r.t_first_token - r.arrival for r in done}
    pf_ms = [t * 1e3 for t, p, _ in ticks if p]
    dec = [(t, d) for t, p, d in ticks if not p]
    dec_ms = [t * 1e3 for t, _ in dec]
    print(f"full: {cfg.name} {str(dtype)[6:]} L={cfg.n_layers} "
          f"d={cfg.d_model} V={cfg.vocab} setup_s={setup_s:.3f} "
          f"requests=8 tokens_each={max_new} steps={len(ticks)} "
          f"run_s={sum(t for t, _, _ in ticks):.4f} "
          f"prefill_tick_ms={[round(x, 3) for x in pf_ms]} "
          f"decode_ticks={len(dec)} "
          f"decode_tick_ms_mean={np.mean(dec_ms):.3f} "
          f"decode_tick_ms_p50={np.median(dec_ms):.3f} "
          f"decode_tok_per_s="
          f"{sum(d for _, d in dec) / sum(t for t, _ in dec):.3f} "
          f"ttft_wave1_s={np.mean([ttft[i] for i in range(4)]):.4f} "
          f"ttft_wave2_s={np.mean([ttft[i] for i in range(4, 8)]):.4f} "
          f"reused_prefix_tokens={m.reused_prefix_tokens} "
          f"hash_hits={m.hash_hits} launches={launches} "
          f"finite=True pristine=True ok")
    profile_wave(eng, wave(8), dev)
    return launches


def profile_wave(eng, reqs, dev):
    """Profile one more wave (after the main path's counters were read):
    the device's busy share of the window and the kernels that fill it."""
    if dev.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival = eng.clock.now()
            eng.submit(r)
        steps0 = eng.metrics.steps
        eng.run(max_ticks=10000)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_t(e) for e in kern) / 1e3
    top = sorted(kern, key=dev_t, reverse=True)[:8]
    names = "; ".join(f"{e.key[:48]}={dev_t(e) / 1e3:.3f}ms/{e.count}"
                      for e in top)
    print(f"profile: wave of {len(reqs)} requests, "
          f"{eng.metrics.steps - steps0} steps, wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} "
          f"busy_share={busy_ms / wall_ms:.4f} top: {names}")


SOURCES = {
    "smlm": ("src/repro_torch/kernels/csrc/smlm.cu",
             "src/repro/kernels/smlm.py:39"),
    "bgmv": ("src/repro_torch/kernels/csrc/bgmv.cu",
             "src/repro/kernels/bgmv.py:30"),
    "paged_prefill": ("src/repro_torch/kernels/csrc/prefill_attn.cu",
                      "src/repro/kernels/prefill_attn.py:78"),
    "paged_decode": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:154"),
}
COUNTER = {"smlm": "smlm", "bgmv": "bgmv", "paged_prefill": "prefill",
           "paged_decode": "decode"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    K = _import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    verbose = "--verbose-build" in sys.argv[1:]
    t0 = time.perf_counter()
    K["build"].build(verbose=verbose)
    print(f"build: {len(K['build'].KERNELS)} kernels (nvcc sm_90a, parallel)"
          f" in {time.perf_counter() - t0:.3f} s -> "
          f"{os.path.relpath(K['build'].build_dir(), ROOT)}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        timing = dtype == torch.bfloat16
        rows.update(check_lora(K, dtype, dev, gen, timing))
        rows.update(check_attention(K, dtype, dev, gen, timing))
    for name, r in rows.items():
        print(f"timing: {name:<13} bf16 {r['shape']}: ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f}"
              f" bound_ms={r['bound_ms']:.5f} ({r['bound_by']})")

    parity(K)

    from repro_torch.configs import get_config
    launches = full_width(K, get_config("llama3-8b"), dev, torch.bfloat16)

    kernels = []
    for name in ("smlm", "bgmv", "paged_prefill", "paged_decode"):
        r = rows[name]
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[COUNTER[name]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
