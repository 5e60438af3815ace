#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --kernel-timing [--root TREE] [--iters N]
    python3 chip_smoke.py --tune-splits PATH
    python3 chip_smoke.py --bgmv-splits [--root TREE]
    python3 chip_smoke.py --chunk-routes [--root TREE]
    python3 chip_smoke.py --divergence [--root TREE]

The second form only checks and times the eight kernels of ``PERF.md``
(SMLM at its main-path shape and at ``SMLM_SHAPES``, BGMV at
``BGMV_SHAPES``, paged prefill,
decode, verify, split-K, flash at both of its main-path shapes, dense
decode) of the port in ``TREE`` (default: this checkout), at the shapes
below: run it over two checkouts in turns (A, B, B, A) within one call to
compare a kernel change with its parent.  The
third fills the split table (``kernels/autotune.py``) with
``sweep(measure=...)``: for each key the model asks at the smoke's serving
and long-context buckets, every candidate split timed on the card (decode
plus verify at that bucket's positions); it writes the table as JSON to
PATH, the file the model loads at its first call on the card
(``src/repro_torch/kernels/splits_h100.json``).  The fourth times BGMV at
the decode and verify ticks' projections as its wrapper ships, beside its
library call, and for 8, 16 and 32 slices of d_in beside the slices that
wrapper picks.  The fifth times bf16 paged verify at 20 to 256 query
columns and paged prefill at 64 to 512 as their wrappers ship and on each
walk (the split-key walk, the query-tile walk): the data behind the
crossover ``SW_SPLIT_COLS`` of ``csrc/split_walk.cuh``.  The sixth serves
phase 4's waves plain, speculative and on dense rows without timing, with
every tick's logits kept, and prints each request's first divergence from
the plain run (the lines phases 5 and 7 print), for the port in ``TREE``.

Imports only the port (``src/repro_torch``), never JAX.  Phases, each
printing its lines; any failure raises and exits non-zero:

1. build   — compile the seven CUDA kernel libraries (eight kernels: the
             decode library holds the paged and the dense-row decode) from
             ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
             parallel).
2. kernels — each kernel vs its plain PyTorch version on the card at the
             main path's shapes, bf16 and fp32, with the stated tolerance
             (verify at B=8 Sq=5 with a lens 0 row and an inactive row, both
             exactly 0, and verify and prefill past the crossover of their
             bf16 walks at Sq=33 and 48; split-K decode and verify, partials and merge at the
             long-context shape B=2 nbt=128 for ns in 1, 2, 4, 8 and one
             ns > nbt; flash attention causal and not, ragged lengths with a
             0 and S != T; dense-row decode linear and rolling); then, in
             bf16 at one main-path shape each (flash at both of its), the
             kernel's and the library call's device time (SMLM also at
             ``SMLM_SHAPES``; ``time_ms``: the
             calls captured in a CUDA graph and replayed between CUDA
             events) and the plain version's eager time, beside the bound;
             and at the serving and long-context decode buckets the time of
             every candidate split beside the model's pick (the split table
             it loads on the card, else ``autotune.choose``).
3. parity  — reduced llama3-8b in fp32 (TF32 off), the same numpy-seeded
             weights and trace through the engine on ``cuda`` (kernels) and
             on ``cpu`` (plain versions): greedy tokens equal, first-step
             logits within tolerance; then the same with speculation (suffix
             drafter fed the plain outputs): tokens equal on both devices
             and to the plain run's, drafts accepted, verify kernel used;
             then the dense-row engine (``paged=False``): tokens equal on
             both devices and to the paged run's, the flash and dense-decode
             kernels used.
4. full    — full-width llama3-8b in bf16 (32 layers, d_model 4096, vocab
             128256, random weights), 2 gaussian-B adapters, two waves of 4
             requests (wave 2 reuses wave 1's 128-token heads, so its
             prefill rows carry cached_len; wave 1's cold prefills take the
             flash kernel), 16 new tokens each; every kernel's launch
             counter must be > 0 for that run.
5. spec    — the same weights and requests with ``SpecConfig(k_max=4,
             drafter="suffix")`` fed each prompt plus the plain run's output:
             all finish, logits finite, the pool drains pristine, the verify
             kernel launched; acceptance, verify-tick latency, decode tokens
             per second and the tokens equal to the plain run's are printed;
             then untimed copies of the plain and the speculative run, every
             tick's logits kept on the host, give each differing request's
             first divergence: the two tokens, the top-1 minus top-2 logit
             gap and each run's margin of its token over the other's, in
             both runs, beside the bf16 spacing at the top logit.
6. long    — the same weights at capacity 2, s_max 4096: 2 requests with
             ~3000-token prompts, 16 new tokens, without and with
             speculation; the split-K decode and verify kernels launched,
             and the flash kernel for the cold 3000-token prefills; then
             the prefill tick of one more 3000-token request profiled
             (``profile: long prefill`` line: wall, device busy, SMLM's
             device time and share of it, the top device operations).
7. dense   — the waves of phase 4 through ``EngineConfig(paged=False)``
             (dense rows, every prompt prefilled whole): all finish, logits
             finite, the flash and dense-decode kernels launched, and each
             request's first divergence from the paged run as in phase 5;
             then both layouts in turns (paged, dense, dense, paged, twice),
             their decode ticks side by side.

Then one JSON line of per-kernel numbers (``launches`` from the kernel's
main-path run, named in ``launches_path``; ``launches_by_path`` from every
run of phases 4-7 that launched it), the card's name and power limit, and
the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
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


def _import_port(root: str = ROOT):
    """The port's kernel wrappers from ``root``."""
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.core.flow import FlowConfig
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.bgmv import bgmv
    from repro_torch.kernels.decode_attn import paged_decode_attention
    from repro_torch.kernels.ops import route
    from repro_torch.kernels.prefill_attn import paged_prefill_attention
    from repro_torch.kernels.smlm import smlm
    from repro_torch.kernels import autotune, splitk
    from repro_torch.kernels.verify_attn import paged_verify_attention
    K = dict(build=build, ref=ref, smlm=smlm, bgmv=bgmv, route=route,
             block_t=FlowConfig().block_t, decode=paged_decode_attention,
             prefill=paged_prefill_attention, verify=paged_verify_attention,
             decode_splitk=splitk.paged_decode_attention_splitk,
             verify_splitk=splitk.paged_verify_attention_splitk,
             partials=splitk.splitk_partials, merge=splitk.lse_merge,
             autotune=autotune)
    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.flash_attn import flash_attention
    K.update(dense_decode=decode_attention, flash=flash_attention)
    return K


# launch counters of the main path, by wrapper
COUNTERS = ("smlm", "bgmv", "decode", "prefill", "verify", "partials",
            "merge", "flash", "dense_decode")


def reset_counts(K):
    for k in COUNTERS:
        K[k].launches = 0
    K["partials"].shapes.clear()


def read_counts(K, names=COUNTERS):
    return {k: K[k].launches for k in names}


# ---------------------------------------------------------------- helpers
ITERS = 20          # timed calls per measurement (--iters)


def time_ms(fn, iters: int = 0, warmup: int = 3, eager: bool = False
            ) -> float:
    """Device time of one call of ``fn``, in ms: ``iters`` calls captured in
    one CUDA graph after a warm-up, replayed once between CUDA events, so
    the host's cost of issuing a call (which bounds an eager loop of small
    kernels) is not counted.  ``eager`` times an eager loop of calls
    instead: the plain versions, whose host reads a graph cannot hold."""
    iters = iters or ITERS
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if eager:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    else:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start.record()
        graph.replay()
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


def worst_row(out, plain) -> float:
    """The largest ratio of a row's max abs error to its max |plain|."""
    o = out.float().reshape(-1, out.shape[-1])
    p = plain.float().reshape(-1, plain.shape[-1])
    return float(((o - p).abs().amax(-1)
                  / p.abs().amax(-1).clamp_min(1e-30)).max())


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


def lora_library_ms(x, a, b, ids, bt):
    """The library yardstick of SMLM (``bt``: its tile) or BGMV (``bt``
    None): torch.bmm shrink + expand on A/B gathered per tile or per token
    in advance."""
    sel = ids.long()
    xa = x.view(-1, bt or 1, x.shape[1])
    ag, bg = a[sel], b[sel]
    return time_ms(lambda: torch.bmm(torch.bmm(xa, ag), bg))


def lora_row(K, x, a, b, ids, scale, bt, err):
    """Timing row of one SMLM (``bt``: the planner's tile) or BGMV (``bt``
    None) call: kernel, plain and library device times beside the bound."""
    T, d_in = x.shape
    d_out, r = b.shape[-1], a.shape[-1]
    args = (x, a, b, ids, scale)
    if bt:
        run = lambda: K["smlm"](*args, block_t=bt)
        plain = lambda: K["ref"].smlm_ref(*args, bt)
        t_live = int((scale != 0).sum()) * bt
    else:
        run = lambda: K["bgmv"](*args)
        plain = lambda: K["ref"].bgmv_ref(*args)
        t_live = int((scale != 0).sum())
    used = torch.unique(ids[scale != 0]).numel()
    it = x.element_size()
    # X rows of live tokens only (a disabled tile or token needs none),
    # every output row, each used adapter once
    nbytes = (t_live * d_in + T * d_out) * it \
        + used * r * (d_in + d_out) * it
    flops = 2 * t_live * r * (d_in + d_out)
    bms, by = bound(nbytes, flops, x.dtype)
    return dict(
        max_abs_err=err, ms=time_ms(run),
        plain_ms=time_ms(plain, eager=True),
        library_ms=lora_library_ms(x, a, b, ids, bt), bound_ms=bms,
        bound_by=by,
        shape=f"T={T} d_in={d_in} d_out={d_out} r={r} n={a.shape[0]}"
              + (f" block_t={bt}" if bt else ""))


# SMLM's timed shapes beyond the main one: (T, d_in, d_out) — the
# suffix-prefill, cold serving and long-context token counts at the widest
# projection, and the other projection shapes at T=1024
SMLM_SHAPES = ((64, 4096, 14336), (576, 4096, 14336), (3000, 4096, 14336),
               (1024, 4096, 4096), (1024, 4096, 1024), (1024, 14336, 4096))
# BGMV's timed shapes: the four projections of a decode tick (T=8) and the
# widest one of a verify tick (8 requests x (k_max + 1) = 40 tokens); the
# decode tick's 8 ids (4 slots, a repeated one, a base-only row and one
# outside the bank), each request's id repeated over its verify chunk
BGMV_SHAPES = ((8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
               (8, 14336, 4096), (40, 4096, 14336))
BGMV_IDS = (0, 1, 2, 3, 3, -1, 1, 5)


def bgmv_splits(K, dev):
    """BGMV's device time at the decode (T=8) and verify (T=40) ticks' four
    projections as the wrapper ships, beside its library yardstick's, and,
    where its ``n_split(d_in, T)`` picks the slices of d_in, for 8, 16 and
    32 slices beside its pick: the data behind that choice (``--root``
    times another checkout's wrapper as shipped)."""
    import inspect
    mod = sys.modules[K["bgmv"].__module__]
    pick = mod.n_split
    sweep = len(inspect.signature(pick).parameters) == 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    try:
        for T in (8, 40):
            for d_in, d_out in ((4096, 4096), (4096, 1024), (14336, 4096),
                                (4096, 14336)):
                x, a, b, ids, scale = lora_case(T, d_in, d_out,
                                                torch.bfloat16, dev, gen, 8)
                ids = torch.tensor(BGMV_IDS, device=dev, dtype=torch.int32
                                   ).repeat_interleave(T // len(BGMV_IDS))
                rt = K["route"](ids, scale[ids.long().clamp(0, 3)], 4, 0, 8)
                args = (x, a, b, rt.tail_ids, rt.tail_scale)
                plain = K["ref"].bgmv_ref(*args)
                run = lambda: K["bgmv"](*args)
                compare(run(), plain, torch.bfloat16)
                line = (f"shipped={time_ms(run):.5f} library="
                        f"{lora_library_ms(*args[:4], None):.5f}")
                if sweep:
                    got = {}
                    for ns in (8, 16, 32):
                        mod.n_split = lambda d, t, ns=ns: ns
                        compare(run(), plain, torch.bfloat16)
                        got[ns] = round(time_ms(run), 5)
                    mod.n_split = pick
                    line += f" by_slices={got} pick={pick(d_in, T)}"
                print(f"bgmv-splits: T={T} {d_in}x{d_out} ms {line}")
    finally:
        mod.n_split = pick


# Chunk lengths on each side of the bf16 crossover of the chunk kernels
# (``SW_SPLIT_COLS`` in ``csrc/split_walk.cuh``), at h/g = 4: verify from
# the serving chunk (Sq 5: 20 query columns) to 256 columns, prefill from
# the main path's suffix (Sq 16: 64 columns) to 512
ROUTE_SQ = {"verify": (5, 9, 16, 32, 64), "prefill": (16, 32, 64, 128)}


def walk_launcher(K, lib, args):
    """``walk -> call`` for a bf16 chunk kernel (``lib`` verify_attn or
    prefill_attn) forced onto one walk (0 split-key, 1 query-tile) through
    its library's ``*_walk_launch`` entry, or None where the library has
    none (a parent checkout)."""
    b = K["build"]
    P, I, F = b.P, b.I, b.F
    try:
        fn = b.function(lib, f"paged_{lib[:-5]}_walk_launch",
                        [P] * 7 + [I] * 7 + [F, I, P])
    except AttributeError:
        return None
    q, kp, tables = args[0], args[1], args[3]
    B, Sq, h, hd = q.shape
    _, bs, g, _ = kp.shape
    out = torch.empty_like(q)

    def on(walk):
        def call():
            b.check(fn(*(t.data_ptr() for t in args), out.data_ptr(), B, Sq,
                       h, g, hd, bs, tables.shape[1], hd ** -0.5, walk,
                       b.stream_of(q)), lib)
            return out
        return call
    return on


def chunk_routes(K, dev):
    """The bf16 verify and prefill kernels' device time at ``ROUTE_SQ`` as
    their wrappers ship and, where the libraries can force a walk, on the
    split-key walk and on the query-tile walk: the data behind the
    crossover (``--root`` times another checkout's wrappers as shipped).
    Each output is first held, with the bf16 limit, to the plain version
    evaluated in float64 on the same bf16 inputs, since the bf16 plain
    version rounds its scores to bf16 and at these widths is itself up to
    2e-2 of a row's max from that; the ``err`` line gives each one's worst
    row (``worst_row``).  h=32 g=8 hd=128 bs=32.  Verify: 8 requests at
    positions 0-440, lens Sq.  Prefill as on the main path: three rows over
    128 cached tokens (seg Sq, 3/4 and 9/16 of it), a cold one and a seg-0
    padding row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    h, g, hd, bs, dt = 32, 8, 128, 32, torch.bfloat16
    cached = torch.tensor([128, 128, 128, 0, 0], device=dev,
                          dtype=torch.int32)
    for name in ("verify", "prefill"):
        for Sq in ROUTE_SQ[name]:
            if name == "verify":
                pos = [0, 30, 61, 100, 148, 200, 300, 440]
                args = chunk_case(dev, gen, dt, pos, [Sq] * 8, Sq, 16)
                shape = "B=8 pos 0-440 nbt=16"
            else:
                seg = torch.tensor([Sq, Sq * 3 // 4, Sq * 9 // 16, Sq, 0],
                                   device=dev, dtype=torch.int32)
                need = [-(-(int(c) + int(n)) // bs)
                        for c, n in zip(cached, seg)]
                kp, vp, tables = paged_case(dev, gen, dt, 5, max(need), need,
                                            bs=bs, g=g, hd=hd)
                q = torch.randn(5, Sq, h, hd, generator=gen, device=dev
                                ).to(dt)
                args = (q, kp, vp, tables, cached, seg)
                shape = "B=5 cached=128/0"
            plain_fn = K["ref"].paged_verify_ref if name == "verify" \
                else K["ref"].paged_prefill_ref
            exact = plain_fn(*(a.double() for a in args[:3]), *args[3:])
            errs = f"plain={worst_row(plain_fn(*args), exact):.3e}"
            run = lambda: K[name](*args)
            compare(run(), exact, dt)
            line = f"shipped={time_ms(run):.5f}"
            on = walk_launcher(K, f"{name}_attn", args)
            if on is not None:
                for walk, label in ((0, "split"), (1, "tile")):
                    errs += f" {label}={worst_row(on(walk)(), exact):.3e}"
                    compare(on(walk)(), exact, dt)
                    line += f" {label}={time_ms(on(walk)):.5f}"
            print(f"chunk-routes: {name} Sq={Sq} cols={Sq * h // g} {shape} "
                  f"h=32 g=8 hd=128 bs=32 ms {line}; err (worst row / its "
                  f"max |float64 plain|) {errs}")


def check_lora(K, dtype, dev, gen, timing: bool):
    rows = {}
    bt = K["block_t"]
    for name, T in (("smlm", 1024), ("bgmv", 8)):
        errs = []
        if name == "smlm":
            shapes = [(T, 4096, 4096), (T, 4096, 1024), (T, 4096, 14336),
                      (T, 14336, 4096)]
            shapes += [s for s in SMLM_SHAPES if s[0] != T]
            timed = SMLM_SHAPES
        else:
            shapes = timed = list(BGMV_SHAPES)
        for T_, d_in, d_out in shapes:
            x, a, b, ids, scale = lora_case(T_, d_in, d_out, dtype, dev,
                                            gen, bt)
            if name == "bgmv":
                ids = torch.tensor(BGMV_IDS, device=dev, dtype=torch.int32
                                   ).repeat_interleave(T_ // len(BGMV_IDS))
            n_head = T_ if name == "smlm" else 0
            rt = K["route"](ids, scale[ids.long().clamp(0, 3)], 4, n_head,
                            bt)
            if name == "smlm":
                args = (x, a, b, rt.tile_ids, rt.tile_scale)
                err = compare(K["smlm"](*args, block_t=bt),
                              K["ref"].smlm_ref(*args, bt), dtype)
            else:
                args = (x, a, b, rt.tail_ids, rt.tail_scale)
                err = compare(K["bgmv"](*args), K["ref"].bgmv_ref(*args),
                              dtype)
            errs.append(err)
            main = (T_, d_in, d_out) == (T, 4096, 14336)
            if timing and (main or (T_, d_in, d_out) in timed):
                key = name if main else f"{name} T={T_} {d_in}x{d_out}"
                rows[key] = lora_row(K, *args,
                                     bt if name == "smlm" else None, err)
        print(f"kernels: {name:<13} {str(dtype)[6:]:<8} "
              f"max_abs_err={max(errs):.3e} tol={TOL[dtype]:g}x"
              f"max|plain| per row block_t={bt} shapes(T,d_in,d_out)="
              f"{','.join(f'({a},{b},{c})' for a, b, c in shapes)} ok")
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
            plain_ms=time_ms(lambda: K["ref"].paged_decode_ref(*args),
                             eager=True),
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
    # a suffix past the crossover of the bf16 chunk kernels (48 x 4 = 192
    # query columns: the query-tile walk)
    Sq2 = 48
    seg2 = torch.tensor([48, 36, 27, 48, 0], device=dev, dtype=torch.int32)
    need = [(int(c) + Sq2 - 1) // bs + 1 for c in cached]
    kp2, vp2, tables2 = paged_case(dev, gen, dtype, 5, nbt, need)
    q2 = torch.randn(5, Sq2, h, hd, generator=gen, device=dev).to(dtype)
    args2 = (q2, kp2, vp2, tables2, cached, seg2)
    out2 = K["prefill"](*args2)
    if float(out2[4].float().abs().max()) != 0.0:
        raise AssertionError("all-masked prefill row is not 0")
    err2 = compare(out2, K["ref"].paged_prefill_ref(*args2), dtype)
    print(f"kernels: paged_prefill {str(dtype)[6:]:<8} max_abs_err={err2:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row B=5 Sq=48 cached=128/0 "
          "h=32 g=8 hd=128 (past the crossover) all-masked row=0 ok")
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
            plain_ms=time_ms(lambda: K["ref"].paged_prefill_ref(*args),
                             eager=True),
            library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
            shape="B=5 Sq=16 cached 128 h=32 g=8 hd=128 bs=32")
    return rows


def chunk_case(dev, gen, dtype, pos, lens, Sq, nbt, h=32, bs=32, g=8,
               hd=128):
    """Verify-chunk inputs: tables naming the blocks of keys 0 .. pos +
    lens - 1 of each request, null-padded."""
    B = len(pos)
    need = [-(-(int(p) + int(n)) // bs) for p, n in zip(pos, lens)]
    kp, vp, tables = paged_case(dev, gen, dtype, B, nbt, need,
                                n_blocks=sum(need) + 2, bs=bs, g=g, hd=hd)
    q = torch.randn(B, Sq, h, hd, generator=gen, device=dev).to(dtype)
    as32 = lambda x: torch.tensor(x, device=dev, dtype=torch.int32)
    return q, kp, vp, tables, as32(pos), as32(lens)


def chunk_work(q, pos, lens, g, it):
    """Bytes and FLOPs a verify chunk needs: q read and the output written
    once, the K/V rows of keys 0 .. pos + lens - 1 of each request read once
    (fp32 partials are the split kernel's choice, not the function's need);
    row i of a request scores min(pos + i + 1, pos + lens) keys."""
    B, Sq, h, hd = q.shape
    kend = (pos + lens).long()
    qi = pos.long()[:, None] + torch.arange(Sq, device=q.device)[None, :]
    keys = torch.minimum(qi + 1, kend[:, None]).clamp(min=0)
    nbytes = (2 * q.numel() + 2 * int(kend.sum()) * g * hd) * it
    flops = int(4 * h * hd * keys.sum())
    return nbytes, flops, qi, kend


def check_verify(K, dtype, dev, gen, timing: bool):
    """Serving verify shape: B=8 chunks of Sq=5 over nbt=16 blocks of 32:
    an inactive row (pos 0, lens 0, null table) and a lens 0 row over a
    real block (both exactly 0), chunks that straddle block edges, a
    partial chunk and a one-token row."""
    rows = {}
    Sq, g = 5, 8
    pos = [0, 0, 30, 61, 100, 200, 300, 506]
    lens = [0, 0, 5, 5, 2, 5, 1, 5]
    q, kp, vp, tables, p, n = chunk_case(dev, gen, dtype, pos, lens, Sq, 16)
    tables[1, 0] = tables[2, 0]            # a real block behind lens 0
    args = (q, kp, vp, tables, p, n)
    out = K["verify"](*args)
    if float(out[:2].float().abs().max()) != 0.0:
        raise AssertionError("verify rows with no valid key are not 0")
    err = compare(out, K["ref"].paged_verify_ref(*args), dtype)
    print(f"kernels: paged_verify  {str(dtype)[6:]:<8} max_abs_err={err:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row B=8 Sq=5 h=32 g=8 hd=128 "
          "bs=32 nbt=16 lens-0 and inactive rows=0, block-edge chunks ok")
    # a chunk past the crossover of the bf16 chunk kernels (33 x 4 = 132
    # query columns: the query-tile walk), the inactive row still 0
    pos2, lens2 = [0, 30, 100, 200, 300, 440], [0, 33, 33, 20, 1, 33]
    args2 = chunk_case(dev, gen, dtype, pos2, lens2, 33, 16)
    out2 = K["verify"](*args2)
    if float(out2[0].float().abs().max()) != 0.0:
        raise AssertionError("verify rows with no valid key are not 0")
    err2 = compare(out2, K["ref"].paged_verify_ref(*args2), dtype)
    print(f"kernels: paged_verify  {str(dtype)[6:]:<8} max_abs_err={err2:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row B=6 Sq=33 h=32 g=8 hd=128 "
          "bs=32 nbt=16 (past the crossover) inactive row=0 ok")
    if timing:
        nbytes, flops, qi, kend = chunk_work(q, p, n, g, q.element_size())
        bms, by = bound(nbytes, flops, dtype)
        lib = sdpa_yardstick(q, kp, vp, tables, q_pos=qi, kend=kend)
        rows["paged_verify"] = dict(
            max_abs_err=err, ms=time_ms(lambda: K["verify"](*args)),
            plain_ms=time_ms(lambda: K["ref"].paged_verify_ref(*args),
                             eager=True),
            library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
            shape="B=8 Sq=5 h=32 g=8 hd=128 bs=32 nbt=16 pos up to 506")
    return rows


LONG = dict(pos=[3001, 2900], lens=[5, 3], dpos=[3005, 2950], nbt=128)
# the decode buckets whose split the model chooses in the full-width runs:
# serving (capacity 8, nbt 16, decode positions mid-run: 144-token prompts
# plus 8 tokens) and long context (capacity 2, nbt 128); verify chunks of 5
SPLIT_BUCKETS = {
    "serving": dict(nbt=16, dpos=[152] * 8, pos=[148] * 8, lens=[5] * 8),
    "long": dict(nbt=128, dpos=LONG["dpos"], pos=LONG["pos"],
                 lens=LONG["lens"]),
}


def split_key(at, dev, bucket, g=8, hd=128, bs=32):
    """The model's split key for a bucket and the split it picks: the table
    the model loads on the card, else the heuristic (a parent checkout
    without a card table takes the heuristic)."""
    if hasattr(at, "load_card_table"):
        at.load_card_table(dev)
    key = (hd, bs, bucket["nbt"], len(bucket["dpos"]) * g)
    return key, at.choose(*key, lanes=at.effective_lanes(dev)).num_splits


def bucket_case(K, dev, gen, dtype, bucket):
    """Decode and verify inputs at a bucket's positions (one pool)."""
    q, kp, vp, tables, p, n = chunk_case(dev, gen, dtype, bucket["pos"],
                                         bucket["lens"], 5, bucket["nbt"])
    dp = torch.tensor(bucket["dpos"], device=dev, dtype=torch.int32)
    return (q[:, 0].contiguous(), kp, vp, tables, dp), (q, kp, vp, tables,
                                                        p, n)


def bucket_ms(K, ns, dargs, vargs, which=("decode", "verify")):
    """Times of a bucket's decode and verify attention at split ns, as the
    model runs it (the sequential kernels at ns = 1)."""
    out = {}
    if "decode" in which:
        out["decode"] = time_ms(lambda: K["decode"](*dargs)) if ns == 1 \
            else time_ms(lambda: K["decode_splitk"](*dargs, num_splits=ns))
    if "verify" in which:
        out["verify"] = time_ms(lambda: K["verify"](*vargs)) if ns == 1 \
            else time_ms(lambda: K["verify_splitk"](*vargs, num_splits=ns))
    return out


def check_splitk(K, dtype, dev, gen, timing: bool):
    """Long context, B=2 over nbt=128 blocks of 32: split-K verify (Sq=5,
    ragged lens) and decode, and the partial and merge kernels alone, for
    ns in 1, 2, 4, 8 and 200 (> nbt)."""
    rows = {}
    ref, g = K["ref"], 8
    q, kp, vp, tables, p, n = chunk_case(dev, gen, dtype, LONG["pos"],
                                         LONG["lens"], 5, LONG["nbt"])
    args = (q, kp, vp, tables, p, n)
    dq = q[:, 0].contiguous()
    dp = torch.tensor(LONG["dpos"], device=dev, dtype=torch.int32)
    dargs = (dq, kp, vp, tables, dp)
    plain_v = ref.paged_verify_ref(*args)
    plain_d = ref.paged_decode_ref(*dargs)
    errs = {"verify": 0.0, "decode": 0.0, "partials": 0.0, "merge": 0.0}
    for ns in (1, 2, 4, 8, 200):
        o, m, l = K["partials"](*args, ns)
        po, pm, pl = ref.splitk_partials_ref(*args, ns)
        errs["partials"] = max(errs["partials"], compare(o, po, dtype))
        # m and l hold against the plain ones up to each split's own max
        compare(torch.exp(m - m.amax(1, keepdim=True)) * l,
                torch.exp(pm - pm.amax(1, keepdim=True)) * pl, dtype)
        errs["merge"] = max(errs["merge"], compare(
            K["merge"](o, m, l, dtype), ref.lse_merge(o, m, l), dtype))
        errs["verify"] = max(errs["verify"], compare(
            K["verify_splitk"](*args, num_splits=ns), plain_v, dtype))
        errs["decode"] = max(errs["decode"], compare(
            K["decode_splitk"](*dargs, num_splits=ns), plain_d, dtype))
    err = max(errs.values())
    print(f"kernels: paged_splitk  {str(dtype)[6:]:<8} max_abs_err={err:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row B=2 nbt=128 bs=32 h=32 "
          f"g=8 hd=128 verify Sq=5 lens=5/3 and decode, ns=1,2,4,8,200: "
          + " ".join(f"{k}={v:.3e}" for k, v in errs.items()) + " ok")
    if not timing:
        return rows
    at = K["autotune"]
    _, pick = split_key(at, dev, SPLIT_BUCKETS["long"])
    nbytes, flops, qi, kend = chunk_work(q, p, n, g, q.element_size())
    bms, by = bound(nbytes, flops, dtype)
    lib = sdpa_yardstick(q, kp, vp, tables, q_pos=qi, kend=kend)

    def plain():
        return ref.lse_merge(*ref.splitk_partials_ref(*args, pick))

    rows["paged_splitk"] = dict(
        max_abs_err=compare(K["verify_splitk"](*args, num_splits=pick),
                            plain_v, dtype),
        ms=time_ms(lambda: K["verify_splitk"](*args, num_splits=pick)),
        plain_ms=time_ms(plain, eager=True), library_ms=time_ms(lib),
        bound_ms=bms, bound_by=by,
        shape=f"verify B=2 Sq=5 nbt=128 pos~3000 ns={pick} "
              "(partials + merge)")
    # every candidate split beside the model's pick, at each bucket whose
    # split the model chooses (ns1 is the sequential kernel); the JAX
    # model's key (Bd x 32 query heads) picks jax_key_choose
    for label, bucket in SPLIT_BUCKETS.items():
        key, pick = split_key(at, dev, bucket)
        jax_pick = at.heuristic(*key[:3], key[3] * 4,
                                lanes=at.effective_lanes(dev)).num_splits
        dargs, vargs = bucket_case(K, dev, gen, dtype, bucket)
        ts = {ns: bucket_ms(K, ns, dargs, vargs)
              for ns in at.candidate_splits(bucket["nbt"])}
        for name in ("verify", "decode"):
            t = {ns: v[name] for ns, v in ts.items()}
            best = min(t, key=t.get)
            print(f"splits: {name} bf16 {label} B={len(bucket['dpos'])} "
                  f"nbt={bucket['nbt']} " + " ".join(
                      f"ns{k}_ms={v:.5f}" for k, v in t.items())
                  + f" choose={pick} jax_key_choose={jax_pick} "
                  f"fastest={best} pick_over_fastest="
                  f"{t[pick] / t[best]:.4f}")
    return rows


def tune_splits(K, dev, path):
    """Fill the split table with ``autotune.sweep(measure=...)`` at the
    model's keys of ``SPLIT_BUCKETS`` (bf16 decode plus verify time at the
    bucket's positions, per candidate split) and write it to ``path``."""
    at = K["autotune"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    at.clear_table()
    cases, seen = {}, {}
    for bucket in SPLIT_BUCKETS.values():
        key, _ = split_key(at, dev, bucket)
        cases[key] = bucket_case(K, dev, gen, torch.bfloat16, bucket)
    at.clear_table()      # time every candidate, not the loaded table

    def measure(key, cfg):
        ms = sum(bucket_ms(K, cfg.num_splits, *cases[key]).values())
        seen.setdefault(key, {})[cfg.num_splits] = ms
        return ms

    chosen = at.sweep(list(cases), measure=measure,
                      lanes=at.effective_lanes(dev))
    for key, cfg in chosen.items():
        print(f"tune: key={key} " + " ".join(
            f"ns{k}_ms={v:.5f}" for k, v in seen[key].items())
              + f" heuristic={at.heuristic(*key).num_splits} "
              f"chosen={cfg.num_splits}")
    print(f"tune: wrote {at.save_table(path)} entries to {path}")


FLASH_SERVE = dict(B=4, S=256, length=144)     # wave 1: 144-token prompts
FLASH_LONG = dict(B=1, S=4096, length=3000)     # one long prompt, 4096 bucket
DENSE_POS = [0, 143, 150, 200, 37, 255, 300, 511]   # B=8, S=s_max=512


def flash_case(dev, gen, dtype, B, S, T, h=32, g=8, hd=128):
    qkv = [torch.randn(B, n, m, hd, generator=gen, device=dev).to(dtype)
           for n, m in ((S, h), (T, g), (T, g))]
    return qkv


def flash_work(S, lengths, h, g, hd, it):
    """Bytes and FLOPs causal flash attention needs: q read and the output
    written once (all S rows), the K/V rows < length read once; FLOPs of the
    live query rows (row i < length scores i + 1 keys), as the rows past the
    length are padding of the prompt bucket."""
    keys = sum(int(n) for n in lengths)
    nbytes = (2 * len(lengths) * S * h * hd + 2 * keys * g * hd) * it
    flops = sum(4 * h * hd * int(n) * (int(n) + 1) // 2 for n in lengths)
    return nbytes, flops


def check_dense_kernels(K, dtype, dev, gen, timing: bool):
    """Flash attention (causal and not, ragged lengths with a 0 whose rows
    are exactly 0, rows past their length, S != T) and the dense-row decode
    (linear rows at the serving positions, a rolling 64-slot row with pos
    far past it, S % 32 == 0)."""
    rows = {}
    ref, h, g, hd = K["ref"], 32, 8, 128
    it = torch.empty((), dtype=dtype).element_size()
    errs = []
    for causal, S, T, lens in ((True, 256, 256, [144, 0, 100, 256]),
                               (False, 200, 300, [300, 0, 17, 250])):
        q, k, v = flash_case(dev, gen, dtype, 4, S, T)
        ln = torch.tensor(lens, device=dev, dtype=torch.int32)
        out = K["flash"](q, k, v, ln, causal)
        if float(out[1].float().abs().max()) != 0.0:
            raise AssertionError("flash rows with length 0 are not 0")
        errs.append(compare(out, ref.flash_attention_ref(q, k, v, ln, causal),
                            dtype))
    print(f"kernels: flash_attn    {str(dtype)[6:]:<8} max_abs_err="
          f"{max(errs):.3e} tol={TOL[dtype]:g}xmax|plain| per row h=32 g=8 "
          "hd=128 causal B=4 S=T=256 lens=144/0/100/256, non-causal S=200 "
          "T=300 lens=300/0/17/250, length-0 rows=0 ok")
    # the main path's shapes, causal with every row at the prompt's length,
    # held against the plain version in fp32 on the same inputs: in bf16
    # the plain version rounds its scores and probabilities to bf16, an
    # error of its own that grows with the keys a row sees (printed beside)
    for name, c in (("flash_attention_serve", FLASH_SERVE),
                    ("flash_attention", FLASH_LONG)):
        q, k, v = flash_case(dev, gen, dtype, c["B"], c["S"], c["S"])
        ln = torch.full((c["B"],), c["length"], device=dev,
                        dtype=torch.int32)
        shape = (f"causal B={c['B']} S=T={c['S']} length={c['length']} h=32"
                 " g=8 hd=128")
        out = K["flash"](q, k, v, ln, True)
        exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), ln,
                                        True)
        err = compare(out, exact, dtype)
        note = ""
        if dtype != torch.float32:
            plain = ref.flash_attention_ref(q, k, v, ln, True)
            note = (f"; worst row err/max|plain| against the fp32 plain "
                    f"{worst_row(out, exact):.4f}, against the {str(dtype)[6:]}"
                    f" plain {worst_row(out, plain):.4f}, that plain against "
                    f"the fp32 plain {worst_row(plain, exact):.4f}")
            del plain
        print(f"kernels: flash_attn    {str(dtype)[6:]:<8} max_abs_err="
              f"{err:.3e} tol={TOL[dtype]:g}xmax|plain| per row against the "
              f"fp32 plain, main-path shape {shape}{note} ok")
        del out, exact
        if not timing:
            continue
        nbytes, flops = flash_work(c["S"], ln.tolist(), h, g, hd, it)
        bms, by = bound(nbytes, flops, dtype)
        j = torch.arange(c["S"], device=dev)
        mask = (j[None, :] <= j[:, None]) & (j[None, :] < c["length"])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows[name] = dict(
            max_abs_err=err,
            ms=time_ms(lambda: K["flash"](q, k, v, ln, True)),
            plain_ms=time_ms(
                lambda: ref.flash_attention_ref(q, k, v, ln, True), iters=5,
                eager=True),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                            enable_gqa=True)),
            bound_ms=bms, bound_by=by, shape=shape)
        del q, k, v, qt, kt, vt
    # dense decode: linear rows (window 0) and a rolling row (window 64)
    errs, cases = [], {}
    for window, S, pos in ((0, 512, DENSE_POS),
                           (64, 64, [0, 5, 63, 64, 100, 1000, 2047, 31])):
        q = torch.randn(8, h, hd, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(8, S, g, hd, generator=gen, device=dev
                            ).to(dtype) for _ in range(2))
        cases[window] = (q, k, v, torch.tensor(pos, device=dev,
                                                dtype=torch.int32))
        errs.append(compare(
            K["dense_decode"](*cases[window], window=window),
            ref.decode_attention_ref(*cases[window], window=window), dtype))
    print(f"kernels: dense_decode  {str(dtype)[6:]:<8} max_abs_err="
          f"{max(errs):.3e} tol={TOL[dtype]:g}xmax|plain| per row B=8 h=32 "
          "g=8 hd=128 linear S=512 pos 0..511, rolling S=window=64 pos "
          "0..2047 ok")
    if timing:
        q, k, v, p = args = cases[0]
        # K/V rows the function needs: slots 0..pos of each row
        keys = sum(x + 1 for x in DENSE_POS)
        nbytes = (2 * q.numel() + 2 * keys * g * hd) * it
        bms, by = bound(nbytes, 4 * h * hd * keys, dtype)
        mask = (torch.arange(512, device=dev)[None, :]
                <= p.long()[:, None])[:, None, None, :]
        qt = q[:, :, None].contiguous()
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        rows["dense_decode"] = dict(
            max_abs_err=errs[0],
            ms=time_ms(lambda: K["dense_decode"](*args)),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(*args),
                             eager=True),
            library_ms=time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                            enable_gqa=True)),
            bound_ms=bms, bound_by=by,
            shape="B=8 S=512 h=32 g=8 hd=128 window=0 pos up to 511")
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


def logit_run(cfg, weights, waves, **ecfg):
    """An untimed copy of a run: the requests of ``waves`` on a fresh
    engine over the shared weights, every tick's logits kept on the host
    (``record_logits(keep=True)``), and each emitted token matched to the
    logits row that chose it (a prefill row by the tick's prefill order, a
    decode or verify row by the request's slot and the token's place in
    the tick's emission).  Returns {rid: [(token, fp32 logits [V]), ...]}
    and how many of the tokens are their row's argmax."""
    from repro_torch.core.virtualization import MixedLoraModel
    from repro_torch.serving import engine as E
    params, store, _ = weights
    eng = E.UnifiedEngine(MixedLoraModel(cfg, params, store),
                          E.EngineConfig(**ecfg))
    seen = record_logits(eng, keep=True)
    reqs = [r for wave in waves for r in wave]
    rows = {r.rid: [] for r in reqs}
    pf_rids = []
    assemble = E.flow.assemble

    def recorded_assemble(pf_reqs, *a, **kw):
        pf_rids[:] = [p.rid for p in pf_reqs]
        return assemble(pf_reqs, *a, **kw)

    def tick():
        before = {r.rid: len(r.output) for r in reqs}
        n_seen = len(seen)
        pf_rids.clear()
        eng.tick()
        if len(seen) == n_seen:
            return
        got = seen[-1]
        for r in reqs:
            n0, new = before[r.rid], len(r.output) - before[r.rid]
            if not new:
                continue
            if n0 == 0 and r.rid in pf_rids:
                emitted = [got["pf_logits"][pf_rids.index(r.rid)]]
            else:
                d = got["dec_logits"][r.dec_slot]
                emitted = [d] if d.dim() == 1 else list(d[:new])
            rows[r.rid] += list(zip(r.output[n0:], emitted))

    E.flow.assemble = recorded_assemble
    try:
        run_waves(eng, tick, waves)
    finally:
        E.flow.assemble = assemble
    argmax_ok = sum(int(int(row.argmax()) == tok)
                    for got in rows.values() for tok, row in got)
    return rows, argmax_ok


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def divergences(label, ref_name, ref, name, got, n_tokens):
    """One line for each request whose tokens differ from the reference
    run's, at its first differing token: the two tokens; in both runs the
    top-1 minus top-2 logit gap and the margin of the run's own token over
    the other run's; and the bf16 spacing at the top logit's magnitude, the
    scale of a near tie.  Then a summary line.  Returns the gaps in ulps."""
    worst = []
    for rid in sorted(ref):
        a, b = ref[rid], got[rid]
        i = next((i for i, (x, y) in enumerate(zip(a, b)) if x[0] != y[0]),
                 None)
        if i is None:
            continue
        (ta, ra), (tb, rb) = a[i], b[i]
        va, vb = torch.topk(ra, 2).values, torch.topk(rb, 2).values
        ulp = bf16_ulp(max(float(va[0]), float(vb[0]), key=abs))
        gap_a, gap_b = float(va[0] - va[1]), float(vb[0] - vb[1])
        mar_a, mar_b = float(ra[ta] - ra[tb]), float(rb[tb] - rb[ta])
        worst.append(max(gap_a, gap_b, mar_a, mar_b) / ulp)
        print(f"{label}: first divergence rid={rid} token={i} {ref_name}="
              f"{ta} {name}={tb} top1-top2 gap {ref_name}={gap_a:.6g} "
              f"{name}={gap_b:.6g} own-token margin {ref_name}={mar_a:.6g} "
              f"{name}={mar_b:.6g} bf16_ulp_at_top1={ulp:.6g} "
              f"(|top1|={abs(float(va[0])):.6g}) in ulps: gap "
              f"{gap_a / ulp:.3g}/{gap_b / ulp:.3g} margin "
              f"{mar_a / ulp:.3g}/{mar_b / ulp:.3g}")
    same = sum(int(x[0] == y[0]) for rid in ref
               for x, y in zip(ref[rid], got[rid]))
    print(f"{label}: divergence summary requests_differing={len(worst)}/"
          f"{len(ref)} tokens_equal={same}/{n_tokens} max_gap_or_margin_"
          f"ulps={max(worst, default=0.0):.3g} (untimed copies, logits on "
          f"the host)")
    return worst


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
    from repro_torch.spec import SpecConfig
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.serving.engine import EngineConfig
    cfg = get_reduced("llama3-8b")
    lcfg = LoRAConfig(n_slots=4, r=8)
    flat = numpy_weights(cfg, seed=0)
    ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
          for i in range(2)}
    engines = {}
    for dev in devices:
        params = params_from_numpy(flat, device=dev)
        adapters = {}
        for name, f in ad.items():
            layers = bank_from_numpy(f, device=dev)["layers"]
            adapters[name] = {"layers": layers}
        engines[dev] = lambda spec, paged, p=params, a=adapters, d=dev: \
            build_engine(cfg, p, a, lcfg, torch.device(d), torch.float32,
                         EngineConfig(capacity=4, pf_capacity=2, s_max=128,
                                      virtual_time=True, spec=spec,
                                      paged=paged))

    def run(dev, spec, suffix=None, paged=True):
        eng = engines[dev](spec, paged)
        seen = record_logits(eng, keep=True)
        reset_counts(K)
        for r in shared_prefix_trace(cfg.vocab, list(ad), seed=3):
            if suffix is not None:
                r.draft_suffix = np.concatenate(
                    [r.prompt, np.asarray(suffix[r.rid], np.int64)])
            eng.submit(r)
        eng.run(max_ticks=10000)
        return eng, seen, read_counts(K), {r.rid: r.output
                                            for r in eng.finished}

    (ge, gs, gl, gtok), (ce, cs, _, ctok) = (run(d, None) for d in devices)
    if len(gtok) != 8 or gtok != ctok:
        raise AssertionError(f"greedy tokens differ: cuda {gtok} cpu {ctok}")
    err = max(float((gs[0][k] - cs[0][k]).abs().max()) for k in gs[0])
    if err > 1e-3:
        raise AssertionError(f"first-step logits differ by {err:.3e}")
    plain_kernels = ("smlm", "bgmv", "decode", "prefill", "flash")
    if min(gl[k] for k in plain_kernels) == 0:
        raise AssertionError(f"a kernel did not launch at reduced size: {gl}")
    print(f"parity: reduced llama3-8b fp32 cuda==cpu greedy tokens for 8 "
          f"requests (48 tokens), first-step logits max_abs_err={err:.3e} "
          f"tol=1e-3, reused_prefix_tokens={ge.metrics.reused_prefix_tokens}"
          f", cuda launches={ {k: gl[k] for k in plain_kernels} } ok")
    spec = SpecConfig(k_max=4, drafter="suffix")
    (se, _, sl, stok), (sc, _, _, sctok) = (run(d, spec, gtok)
                                            for d in devices)
    if stok != sctok or stok != gtok:
        raise AssertionError(f"spec tokens differ: cuda {stok} cpu {sctok} "
                             f"plain {gtok}")
    if se.metrics.spec_accepted == 0 or sl["verify"] == 0:
        raise AssertionError(f"no draft accepted ({se.metrics.spec_accepted})"
                             f" or verify kernel unused: {sl}")
    m = se.metrics
    print(f"parity: spec k_max=4 suffix drafter, cuda==cpu==plain greedy "
          f"tokens for 8 requests, drafted={m.spec_drafted} "
          f"accepted={m.spec_accepted} steps={m.steps} (plain "
          f"{ge.metrics.steps}), cuda verify launches={sl['verify']} ok")
    (de, _, dl, dtok), (_, _, _, dctok) = (run(d, None, paged=False)
                                           for d in devices)
    if dtok != dctok or dtok != gtok:
        raise AssertionError(f"dense tokens differ: cuda {dtok} cpu {dctok} "
                             f"paged {gtok}")
    dense_kernels = ("smlm", "bgmv", "flash", "dense_decode")
    if min(dl[k] for k in dense_kernels) == 0 or dl["decode"] \
            or dl["prefill"]:
        raise AssertionError(f"dense rows did not run their kernels: {dl}")
    print(f"parity: dense rows (paged=False), cuda==cpu==paged greedy tokens "
          f"for 8 requests, steps={de.metrics.steps}, cuda launches="
          f"{ {k: dl[k] for k in dense_kernels} } ok")


# ------------------------------------- phases 4-6: full width, one weight set
def full_weights(cfg, dev, dtype, seed=0):
    """Random full-width weights and two gaussian-B adapters, made on the
    card from seeds once and shared by the full, spec and long phases."""
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.virtualization import AdapterStore
    from repro_torch.models.schema import init_params
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
    torch.cuda.synchronize()
    return params, store, time.perf_counter() - t0


def timed_engine(cfg, weights, **ecfg):
    """An engine on the shared weights, its logits' finiteness recorded on
    the device and its ticks timed: (engine, finite flags, tick records,
    tick()).  A tick record is (seconds, prefill tokens, decode tokens,
    forward enqueue seconds, device wait seconds): the host time spent
    issuing the forward step, then the wait for the device to finish it (a
    synchronize the tick's token read would do a moment later anyway); the
    rest of the tick is the engine's host work."""
    from repro_torch.core.virtualization import MixedLoraModel
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    params, store, _ = weights
    eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                        EngineConfig(**ecfg))
    seen = record_logits(eng, keep=False)
    m, ticks, step, split = eng.metrics, [], eng.forward_step, []

    def timed_step(*a):
        t0 = time.perf_counter()
        out = step(*a)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        split.append((t1 - t0, time.perf_counter() - t1))
        return out

    eng.forward_step = timed_step

    def tick():
        p0, d0 = m.prefill_tokens, m.decode_tokens
        split.clear()
        t = time.perf_counter()
        eng.tick()      # ends in the host reading the sampled tokens
        enq, wait = split[0] if split else (0.0, 0.0)
        ticks.append((time.perf_counter() - t, m.prefill_tokens - p0,
                      m.decode_tokens - d0, enq, wait))

    return eng, seen, ticks, tick


def run_waves(eng, tick, waves):
    """Submit each wave once the previous one is decoding, then drain."""
    from repro_torch.serving.request import State
    for i, wave in enumerate(waves):
        for r in wave:
            r.arrival = eng.clock.now()
            eng.submit(r)
        if i + 1 < len(waves):
            while not all(r.state in (State.DECODE, State.DONE)
                          for r in wave):
                tick()
    while eng.waiting or eng.active or eng.prefilling or eng.future:
        tick()


def check_drained(eng, seen, n, max_new):
    done = list(eng.finished)
    if len(done) != n or any(len(r.output) != max_new for r in done):
        raise AssertionError("not every request finished with "
                             f"{max_new} tokens")
    if not bool(torch.stack(seen).all()):
        raise AssertionError("non-finite logits")
    if not eng.cachemgr.pristine:
        raise AssertionError("the KV pool did not drain pristine")
    return {r.rid: list(r.output) for r in done}


def tick_stats(ticks, label="decode"):
    """Decode-only ticks (no prefill rows; verify ticks under speculation):
    their ms and the decode tokens per second they emit."""
    dec = [(t, d, e, w) for t, p, d, e, w in ticks if not p]
    ms = [t * 1e3 for t, *_ in dec]
    tps = sum(d for _, d, *_ in dec) / sum(t for t, *_ in dec)
    enq = np.mean([e for *_, e, _ in dec]) * 1e3
    wait = np.mean([w for *_, w in dec]) * 1e3
    return (f"{label}_ticks={len(dec)} {label}_tick_ms_mean={np.mean(ms):.3f}"
            f" {label}_tick_ms_p50={np.median(ms):.3f} "
            f"(forward enqueue {enq:.3f} + device wait {wait:.3f} + engine "
            f"{np.mean(ms) - enq - wait:.3f}) decode_tok_per_s={tps:.3f}")


def request_waves(cfg, rng, head=128, tail=16, max_new=16):
    """Two waves of 4: wave 2 reuses wave 1's 128-token heads."""
    from repro_torch.serving.request import Request
    heads = [rng.integers(0, cfg.vocab, head).astype(np.int32)
             for _ in range(4)]
    return [[Request(rid=base + i, prompt=np.concatenate(
        [heads[i], rng.integers(0, cfg.vocab, tail).astype(np.int32)]),
        adapter=f"lora{i % 2}", max_new_tokens=max_new)
        for i in range(4)] for base in (0, 4, 8)]


def copies(waves):
    """Fresh copies of the requests (same rid, prompt, adapter, length)."""
    from repro_torch.serving.request import Request
    return [[Request(rid=r.rid, prompt=r.prompt, adapter=r.adapter,
                     max_new_tokens=r.max_new_tokens) for r in wave]
            for wave in waves]


def with_suffix(waves, outputs):
    """Fresh copies of the requests with the static-suffix drafter's
    reference stream: prompt + the plain run's output."""
    from repro_torch.serving.request import Request
    return [[Request(rid=r.rid, prompt=r.prompt, adapter=r.adapter,
                     max_new_tokens=r.max_new_tokens,
                     draft_suffix=np.concatenate(
                         [r.prompt, np.asarray(outputs[r.rid], np.int64)]))
             for r in wave] for wave in waves]


def full_width(K, cfg, weights, dev, head=128, max_new=16, seed=0):
    """Phase 4: the plain serving path; returns its counts and outputs."""
    eng, seen, ticks, tick = timed_engine(cfg, weights, capacity=8,
                                          pf_capacity=4, s_max=512)
    waves = request_waves(cfg, np.random.default_rng(seed), head,
                          max_new=max_new)
    reset_counts(K)
    run_waves(eng, tick, waves[:2])
    counts = read_counts(K)
    launches = {k: counts[k] for k in ("smlm", "bgmv", "decode", "prefill",
                                       "flash")}
    out = check_drained(eng, seen, 8, max_new)
    m = eng.metrics
    if m.reused_prefix_tokens != 4 * head:
        raise AssertionError(f"wave 2 reused {m.reused_prefix_tokens} "
                             f"prefix tokens, expected {4 * head}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    done = {r.rid: r for r in eng.finished}
    ttft = {i: r.t_first_token - r.arrival for i, r in done.items()}
    pf_ms = [t * 1e3 for t, p, *_ in ticks if p]
    print(f"full: {cfg.name} bf16 L={cfg.n_layers} d={cfg.d_model} "
          f"V={cfg.vocab} setup_s={weights[2]:.3f} requests=8 "
          f"tokens_each={max_new} steps={len(ticks)} "
          f"run_s={sum(t for t, *_ in ticks):.4f} "
          f"prefill_tick_ms={[round(x, 3) for x in pf_ms]} "
          f"{tick_stats(ticks)} "
          f"ttft_wave1_s={np.mean([ttft[i] for i in range(4)]):.4f} "
          f"ttft_wave2_s={np.mean([ttft[i] for i in range(4, 8)]):.4f} "
          f"reused_prefix_tokens={m.reused_prefix_tokens} "
          f"hash_hits={m.hash_hits} launches={launches} "
          f"finite=True pristine=True ok")
    profile_wave(eng, waves[2], dev, "plain")
    out.update({r.rid: list(r.output) for r in waves[2]})
    return counts, waves, out


def logged_copy(label, cfg, weights, waves, timed, **ecfg):
    """``logit_run`` of ``waves``, printing whether the copy emitted the
    timed run's tokens (``timed``: {rid: tokens}, or None)."""
    rows, argmax_ok = logit_run(cfg, weights, waves, **ecfg)
    n = sum(len(v) for v in rows.values())
    same = "not compared" if timed is None else sum(
        int(tok == t) for rid, got in rows.items()
        for (tok, _), t in zip(got, timed[rid]))
    print(f"{label}: untimed copy with logits kept: tokens_equal_to_timed_"
          f"run={same}/{n} tokens_that_are_their_row's_argmax={argmax_ok}/"
          f"{n}")
    return rows


def plain_logits(cfg, weights, waves, plain):
    """The reference of phases 5 and 7: an untimed copy of phase 4's plain
    paged run of waves 1-2, with its logits."""
    return logged_copy("full", cfg, weights, copies(waves[:2]), plain,
                       capacity=8, pf_capacity=4, s_max=512)


def spec_divergence(cfg, weights, waves, plain, ref_rows, timed=None,
                    max_new=16):
    from repro_torch.spec import SpecConfig
    rows = logged_copy("spec", cfg, weights, with_suffix(waves[:2], plain),
                       timed, capacity=8, pf_capacity=4, s_max=512,
                       spec=SpecConfig(k_max=4, drafter="suffix"))
    return divergences("spec", "plain", ref_rows, "spec", rows, 8 * max_new)


def dense_divergence(cfg, weights, waves, ref_rows, timed=None, max_new=16):
    rows = logged_copy("dense", cfg, weights, copies(waves[:2]), timed,
                       capacity=8, pf_capacity=4, s_max=512, paged=False)
    return divergences("dense", "paged", ref_rows, "dense", rows,
                       8 * max_new)


def full_spec(K, cfg, weights, dev, waves, plain, ref_rows, max_new=16):
    """Phase 5: the same requests with speculation, the suffix drafter fed
    each prompt plus the plain run's output; then, for each request whose
    tokens differ from the plain run's, its first divergence (untimed
    copies of both runs)."""
    from repro_torch.spec import SpecConfig
    eng, seen, ticks, tick = timed_engine(
        cfg, weights, capacity=8, pf_capacity=4, s_max=512,
        spec=SpecConfig(k_max=4, drafter="suffix"))
    reset_counts(K)
    run_waves(eng, tick, with_suffix(waves[:2], plain))
    counts = read_counts(K)
    launches = {k: counts[k] for k in ("smlm", "bgmv", "prefill", "verify")}
    out = check_drained(eng, seen, 8, max_new)
    if launches["verify"] == 0:
        raise AssertionError(f"the verify kernel never launched: {launches}")
    m = eng.metrics
    same = sum(int(a == b) for rid in out
               for a, b in zip(out[rid], plain[rid]))
    print(f"spec: {cfg.name} bf16 k_max=4 suffix drafter requests=8 "
          f"steps={len(ticks)} drafted={m.spec_drafted} "
          f"accepted={m.spec_accepted} acceptance={m.acceptance_rate:.4f} "
          f"{tick_stats(ticks, 'verify')} "
          f"tokens_equal_to_plain={same}/{8 * max_new} launches={launches} "
          f"finite=True pristine=True ok")
    profile_wave(eng, with_suffix(waves[2:], plain)[0], dev, "spec")
    del eng
    spec_divergence(cfg, weights, waves, plain, ref_rows, out, max_new)
    return counts


def full_dense(K, cfg, weights, dev, waves, plain, ref_rows, max_new=16):
    """Phase 7: the waves of phase 4 on dense rows: a slot per request,
    every prompt prefilled whole through the flash kernel, decode through
    the dense-row kernel; then, for each request whose tokens differ from
    the paged run's, its first divergence (untimed copies of both runs)."""
    eng, seen, ticks, tick = timed_engine(cfg, weights, capacity=8,
                                          pf_capacity=4, s_max=512,
                                          paged=False)
    fresh = copies(waves)
    reset_counts(K)
    run_waves(eng, tick, fresh[:2])
    counts = read_counts(K)
    launches = {k: counts[k] for k in ("smlm", "bgmv", "flash",
                                       "dense_decode", "decode", "prefill")}
    out = check_drained(eng, seen, 8, max_new)
    if min(launches[k] for k in ("smlm", "bgmv", "flash", "dense_decode")) \
            == 0 or launches["decode"] or launches["prefill"]:
        raise AssertionError(f"dense rows did not run their kernels: "
                             f"{launches}")
    done = {r.rid: r for r in eng.finished}
    ttft = {i: r.t_first_token - r.arrival for i, r in done.items()}
    same = sum(int(a == b) for rid in out
               for a, b in zip(out[rid], plain[rid]))
    print(f"dense: {cfg.name} bf16 paged=False capacity=8 pf_capacity=4 "
          f"s_max=512 requests=8 tokens_each={max_new} steps={len(ticks)} "
          f"run_s={sum(t for t, *_ in ticks):.4f} prefill_tick_ms="
          f"{[round(t * 1e3, 3) for t, p, *_ in ticks if p]} "
          f"{tick_stats(ticks)} "
          f"ttft_wave1_s={np.mean([ttft[i] for i in range(4)]):.4f} "
          f"ttft_wave2_s={np.mean([ttft[i] for i in range(4, 8)]):.4f} "
          f"tokens_equal_to_paged={same}/{8 * max_new} launches={launches} "
          f"finite=True pristine=True ok")
    profile_wave(eng, fresh[2], dev, "dense")
    del eng
    dense_divergence(cfg, weights, waves, ref_rows, out, max_new)
    return counts


def layouts_in_turns(cfg, weights, waves, rounds=2):
    """Phase 7, after the dense run's counts were read: the waves of phase
    4 served paged, dense, dense, paged per round, so a drift of the
    host's speed over the run falls on both layouts alike; prints each
    run's decode ticks."""
    got = {True: [], False: []}
    for _ in range(rounds):
        for paged in (True, False, False, True):
            eng, seen, ticks, tick = timed_engine(
                cfg, weights, capacity=8, pf_capacity=4, s_max=512,
                paged=paged)
            run_waves(eng, tick, copies(waves[:2]))
            check_drained(eng, seen, 8, waves[0][0].max_new_tokens)
            got[paged].append(round(float(np.mean(
                [t for t, p, *_ in ticks if not p])) * 1e3, 3))
            del eng
    wins = sum(int(d < p) for d, p in zip(got[False], got[True]))
    print(f"turns: paged, dense, dense, paged x{rounds}: decode_tick_ms_mean"
          f" paged={got[True]} dense={got[False]} dense_faster_in="
          f"{wins}/{2 * rounds} ok")


def long_context(K, cfg, weights, dev, prompt=3000, max_new=16, seed=1):
    """Phase 6: capacity 2, s_max 4096, two ~3000-token prompts, without
    and with speculation: the shape where ``choose`` splits the walk."""
    from repro_torch.serving.request import Request
    from repro_torch.spec import SpecConfig
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, prompt - 50 * i).astype(np.int32),
        adapter=f"lora{i}", max_new_tokens=max_new) for i in range(2)]
    counts, outs = {}, {}
    for spec in (None, SpecConfig(k_max=4, drafter="suffix")):
        eng, seen, ticks, tick = timed_engine(cfg, weights, capacity=2,
                                              pf_capacity=2, s_max=4096,
                                              spec=spec)
        batch = reqs if spec is None else with_suffix([reqs], outs[None])[0]
        reset_counts(K)
        run_waves(eng, tick, [batch])
        counts[spec is not None] = c = read_counts(K)
        # split-K launches of this run by (chunk length, splits), as the
        # partial kernel's wrapper counted them
        shapes = dict(K["partials"].shapes)
        outs[spec] = check_drained(eng, seen, 2, max_new)
        walks = [n for (sq, _), n in shapes.items()
                 if (sq > 1 if spec else sq == 1)]
        if sum(walks) == 0 or c["partials"] != c["merge"] or not c["flash"]:
            raise AssertionError(
                f"split-K {'verify' if spec else 'decode'} or flash did not "
                f"launch: "
                f"{c} by (Sq, ns): {shapes}")
        ns = sorted({k for (_, k) in shapes})
        m = eng.metrics
        same = sum(int(a == b) for rid in outs[spec]
                   for a, b in zip(outs[spec][rid], outs[None][rid]))
        print(f"long: {cfg.name} bf16 capacity=2 s_max=4096 prompts="
              f"{[len(r.prompt) for r in reqs]} spec="
              f"{'k_max=4 suffix' if spec else 'off'} ns_used={ns} "
              f"steps={len(ticks)} prefill_tick_ms="
              f"{[round(t * 1e3, 3) for t, p, *_ in ticks if p]} "
              f"{tick_stats(ticks, 'verify' if spec else 'decode')} "
              f"drafted={m.spec_drafted} "
              f"accepted={m.spec_accepted} tokens_equal_to_plain={same}/"
              f"{2 * max_new} launches={ {k: v for k, v in c.items() if v} } "
              f"splitk_by_sq_ns={shapes} "
              f"finite=True pristine=True ok")
        if spec is None:
            profile_prefill(eng, tick, Request(
                rid=9, prompt=rng.integers(0, cfg.vocab, prompt).astype(
                    np.int32), adapter="lora0", max_new_tokens=2), "long")
        del eng
    return counts


def device_top(prof, n=8):
    """(device busy ms, the top ``n`` device operations as text, device ms
    by kernel-name substring) of a finished profile.  The profiles record
    device activity only: host operator events, which nothing here reads,
    took tens of seconds a profiled wave to aggregate."""
    kern = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    dev_t = lambda e: getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_t(e) for e in kern) / 1e3
    top = sorted(kern, key=dev_t, reverse=True)[:n]
    names = "; ".join(f"{e.key[:48]}={dev_t(e) / 1e3:.3f}ms/{e.count}"
                      for e in top)
    by = lambda sub: sum(dev_t(e) for e in kern if sub in e.key) / 1e3
    return busy_ms, names, by


def profile_wave(eng, reqs, dev, label):
    """Profile one more wave (after the main path's counters were read):
    the device's busy share of the window and the kernels that fill it."""
    if dev.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in reqs:
            r.arrival = eng.clock.now()
            eng.submit(r)
        steps0 = eng.metrics.steps
        eng.run(max_ticks=10000)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, names, _ = device_top(prof)
    print(f"profile: {label} wave of {len(reqs)} requests, "
          f"{eng.metrics.steps - steps0} steps, wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} "
          f"busy_share={busy_ms / wall_ms:.4f} top: {names}")


def profile_prefill(eng, tick, req, label):
    """Profile the prefill tick(s) of one more request (after the main
    path's counters were read), then drain it unprofiled: the tick's wall
    time, the device's busy time in it, SMLM's share of that, and the top
    device operations."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.request import State
    torch.cuda.synchronize()
    req.arrival = eng.clock.now()
    eng.submit(req)
    n = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while req.state not in (State.DECODE, State.DONE):
            tick()
            n += 1
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, names, by = device_top(prof)
    smlm_ms = by("::smlm_")     # its shrink and expand launches
    print(f"profile: {label} prefill of {len(req.prompt)} tokens, {n} "
          f"tick(s), wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"busy_share={busy_ms / wall_ms:.4f} smlm_ms={smlm_ms:.3f} "
          f"smlm_share_of_busy={smlm_ms / max(busy_ms, 1e-9):.4f} "
          f"top: {names}")
    while eng.waiting or eng.active or eng.prefilling or eng.future:
        tick()


SOURCES = {
    "smlm": ("src/repro_torch/kernels/csrc/smlm.cu",
             "src/repro/kernels/smlm.py:39"),
    "bgmv": ("src/repro_torch/kernels/csrc/bgmv.cu",
             "src/repro/kernels/bgmv.py:30"),
    "paged_prefill": ("src/repro_torch/kernels/csrc/prefill_attn.cu",
                      "src/repro/kernels/prefill_attn.py:78"),
    "paged_decode": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:154"),
    "paged_verify": ("src/repro_torch/kernels/csrc/verify_attn.cu",
                     "src/repro/kernels/decode_attn.py:254"),
    "paged_splitk": ("src/repro_torch/kernels/csrc/splitk.cu",
                     "src/repro/kernels/splitk.py:107"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn.py:67"),
    "dense_decode": ("src/repro_torch/kernels/csrc/decode_attn.cu",
                     "src/repro/kernels/decode_attn.py:67"),
}
# each kernel's launch counter and the run of its main path: the plain
# paged serving run for kernels 1-4, speculation for verify, plain long
# context for split-K (its decode walks), dense rows for kernels 7-8 (each
# split-K call launches the partial and the merge kernel once)
COUNTER = {"smlm": ("smlm", "full"), "bgmv": ("bgmv", "full"),
           "paged_prefill": ("prefill", "full"),
           "paged_decode": ("decode", "full"),
           "paged_verify": ("verify", "spec"),
           "paged_splitk": ("partials", "long"),
           "flash_attention": ("flash", "dense"),
           "dense_decode": ("dense_decode", "dense")}


def check_kernels(K, dev):
    """Phase 2: every kernel against its plain version in bf16 and fp32,
    timed in bf16; prints the
    ``timing:`` lines, each with the kernel's share of its bound (bound_ms /
    ms), and returns their rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        timing = dtype == torch.bfloat16
        rows.update(check_lora(K, dtype, dev, gen, timing))
        rows.update(check_attention(K, dtype, dev, gen, timing))
        rows.update(check_verify(K, dtype, dev, gen, timing))
        rows.update(check_splitk(K, dtype, dev, gen, timing))
        rows.update(check_dense_kernels(K, dtype, dev, gen, timing))
    for name, r in rows.items():
        print(f"timing: {name:<15} bf16 {r['shape']}: ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} library_ms={r['library_ms']:.5f}"
              f" bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"bound_share={r['bound_ms'] / r['ms']:.4f}")
    return rows


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    global ITERS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel-timing", action="store_true",
                    help="only check and time the kernels")
    ap.add_argument("--bgmv-splits", action="store_true",
                    help="only time BGMV at its serving shapes for 8, 16 "
                         "and 32 slices of d_in")
    ap.add_argument("--chunk-routes", action="store_true",
                    help="only time bf16 paged verify and prefill on each "
                         "walk on both sides of their crossover")
    ap.add_argument("--divergence", action="store_true",
                    help="only serve the full-width waves plain, "
                         "speculative and on dense rows, untimed, and print "
                         "each request's first divergence from the plain "
                         "run with the logit margins")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose port --kernel-timing, "
                         "--bgmv-splits, --chunk-routes or --divergence "
                         "imports")
    ap.add_argument("--tune-splits", metavar="PATH",
                    help="time every split at the model's split keys and "
                         "write the table to PATH")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="timed calls per measurement")
    ap.add_argument("--verbose-build", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    ITERS = a.iters
    root = os.path.abspath(a.root) if (a.kernel_timing or a.divergence
                                       or a.bgmv_splits
                                       or a.chunk_routes) else ROOT
    K = _import_port(root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    K["build"].build(verbose=a.verbose_build)
    print(f"build: {len(K['build'].KERNELS)} kernels (nvcc sm_90a, parallel)"
          f" in {time.perf_counter() - t0:.3f} s -> "
          f"{os.path.relpath(K['build'].build_dir(), ROOT)}")
    dev = torch.device("cuda")
    if a.tune_splits:
        tune_splits(K, dev, a.tune_splits)
        print(card())
        return 0
    if a.bgmv_splits:
        bgmv_splits(K, dev)
        print(card())
        return 0
    if a.chunk_routes:
        chunk_routes(K, dev)
        print(card())
        return 0
    if a.divergence:
        from repro_torch.configs import get_config
        cfg = get_config("llama3-8b")
        weights = full_weights(cfg, dev, torch.bfloat16)
        waves = request_waves(cfg, np.random.default_rng(0), 128)
        ref_rows = plain_logits(cfg, weights, waves, None)
        plain = {rid: [tok for tok, _ in got]
                 for rid, got in ref_rows.items()}
        spec_divergence(cfg, weights, waves, plain, ref_rows)
        dense_divergence(cfg, weights, waves, ref_rows)
        print(f"divergence: root={os.path.relpath(root, ROOT)}")
        print(card())
        return 0
    rows = check_kernels(K, dev)
    if a.kernel_timing:
        print(json.dumps({"root": os.path.relpath(root, ROOT), "iters": ITERS,
                          "ms": {k: r["ms"] for k, r in rows.items()},
                          "library_ms": {k: r["library_ms"]
                                         for k, r in rows.items()}}))
        print(card())
        return 0

    parity(K)

    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    weights = full_weights(cfg, dev, torch.bfloat16)
    by_path = {}
    by_path["full"], waves, plain = full_width(K, cfg, weights, dev)
    ref_rows = plain_logits(cfg, weights, waves, plain)
    by_path["spec"] = full_spec(K, cfg, weights, dev, waves, plain,
                                ref_rows)
    long_counts = long_context(K, cfg, weights, dev)
    by_path["long"], by_path["long_spec"] = long_counts[False], \
        long_counts[True]
    by_path["dense"] = full_dense(K, cfg, weights, dev, waves, plain,
                                  ref_rows)
    del ref_rows
    layouts_in_turns(cfg, weights, waves)

    kernels = []
    for name in SOURCES:
        r = rows[name]
        src, replaces = SOURCES[name]
        counter, path = COUNTER[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": by_path[path][counter],
            "launches_path": path,
            "launches_by_path": {p: c[counter] for p, c in by_path.items()
                                 if c[counter]},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
