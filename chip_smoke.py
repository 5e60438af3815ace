#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one GPU
    python3 chip_smoke.py --kernel-timing [--root TREE] [--iters N]
    python3 chip_smoke.py --tune-splits PATH
    python3 chip_smoke.py --bgmv-splits [--root TREE]
    python3 chip_smoke.py --chunk-routes [--root TREE]
    python3 chip_smoke.py --divergence [--root TREE]
    python3 chip_smoke.py --memory
    python3 chip_smoke.py --fleet
    python3 chip_smoke.py --archs
    python3 chip_smoke.py --window
    python3 chip_smoke.py --examples
    python3 chip_smoke.py --mesh-local
    python3 chip_smoke.py --mesh [--mesh-arms llama,qwen,...]   # 4 cards

The second form only checks and times the nine kernels of ``PERF.md``
(SMLM at its main-path shape and at ``SMLM_SHAPES``, BGMV at
``BGMV_SHAPES``, paged prefill, decode, verify, split-K, flash at both of
its main-path shapes, dense decode, SMLM's weight gradient at
``WGRAD_SHAPES``, and each at the other configs' shapes of
``check_arch_shapes``) of the port in ``TREE`` (default: this checkout), at
the shapes below: run it over two checkouts in turns (A, B, B, A) within one
call to compare a kernel change with its parent.  The
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
The seventh runs only the memory features: phase 3's lending, paging and
chunked-training parity, then phases 9 and 10.  The eighth runs only the
fleet: phase 3's fleet case, then phase 11.  The ninth runs only the other
configs: the ``mla:``, ``ssd:`` and ``xattn:`` lines, phase 3's arch, MLA,
Mamba and cross-attention parity, then phase 12.  The tenth runs only
sliding windows: phase 2's windowed flash rows, then phase 13.  The
eleventh runs only the example twins: phase 14, whose ``costs:`` lines
then have no measured ticks beside them.  The twelfth runs only phase 15's
``(1, 1)`` mesh on one card; the thirteenth only phase 15's 4-rank arms,
and exits non-zero unless four cards are visible (``--mesh-arms`` picks
some of them).

Imports only the port (``src/repro_torch``), never JAX.  Phases, each
printing its lines; any failure raises and exits non-zero:

1. build   — compile the eight CUDA kernel libraries (nine kernels: the
             decode library holds the paged and the dense-row decode; the
             SMLM weight gradient has its own) from
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
             it loads on the card, else ``autotune.choose``).  SMLM's
             weight gradient (``smlm_wgrad``) at the mixed tick's ft head
             (T=1024: two adapters and a base-only tile) for the four
             projection shapes, timed at each beside ``torch.bmm`` over the
             tokens gathered per adapter (the JSON row: 4096->14336), with
             the transposed bank slices of ``SMLMFunction``'s dX; then
             ``SMLMFunction``'s backward against autograd through the
             plain SMLM.  Then the other configs' shapes
             (``check_arch_shapes``): paged and dense decode at m = h/g =
             1 (32 KV heads), verify, split-K and decode at m = 1 and 5,
             flash and paged prefill (16- and 48-token suffixes) at m = 5
             and 8 (and prefill's 48 at m = 4), SMLM (T=576) and BGMV
             (T=8) at 5120->17920, 8192->22528 and 4096->11008 and at
             deepseek-v2-236b's 5120->24576, 5120->576, 16384->5120,
             5120->3072 and 3072->5120 (``smlm_wgrad`` at the last five
             too, ``MLA_WGRAD_SHAPES``); timed in bf16 like the rest.
             Then the ``mla:`` lines (``mla_record``): the plain MLA
             attention sublayer at full width in bf16 at decode (B=8,
             pos <= 511) and at wave 2's suffix prefill (B=4, Sq=16),
             timed in a CUDA graph and eagerly beside its bound and an
             SDPA call on the equivalent MQA form: a record, since MLA
             has no Pallas kernel.  Then the ``ssd:`` lines
             (``ssd_record``): the plain Mamba2 mixer between its
             projections at mamba2-1.3b's width in bf16, at decode (B=8:
             the convs over the conv state, ``ssd_step`` over 16.8 MB of
             state ``h``, the gated norm, the state written back) and at a
             prefill of B=4 x 144 tokens (two SSD chunks of 128), timed
             in a CUDA graph and eagerly beside its bound: a record, as
             the JAX package computes the mixer in jnp, outside Pallas.
             Phase 2's arch shapes include the cross configs': paged
             decode, verify and split-K at m = 8 (llama-3.2-vision-90b,
             h 64 g 8 hd 128), every attention kernel at hd 64 and m = 1
             (whisper-base, h = g = 8), SMLM and BGMV at 8192->8192,
             8192->1024, 8192->28672, 28672->8192, 512->512, 512->2048
             and 2048->512.  Then the ``xattn:`` lines (``xattn_record``):
             the plain cross-attention sublayer at the VLM's width in bf16
             at decode (B=8, each over F=1600 cached ``xk``/``xv`` rows)
             and at a prefill of B=4 x 144 tokens that projects its 1600
             fp32 sources through ``xwk``/``xwv``, and whisper-base's
             encoder over 4 x 1500 frames, timed in a CUDA graph and
             eagerly beside the bound (and for the sublayer SDPA on its
             attention alone): a record, as the JAX package computes both
             in jnp, outside Pallas.
3. parity  — reduced llama3-8b in fp32 (TF32 off), the same numpy-seeded
             weights and trace through the engine on ``cuda`` (kernels) and
             on ``cpu`` (plain versions): greedy tokens equal, first-step
             logits within tolerance; then the same with speculation (suffix
             drafter fed the plain outputs): tokens equal on both devices
             and to the plain run's, drafts accepted, verify kernel used;
             then the dense-row engine (``paged=False``): tokens equal on
             both devices and to the paged run's, the flash and dense-decode
             kernels used; then training: two trainers and four served
             requests on both devices (lr 1e-3): served tokens equal,
             per-row losses within 1e-4 relative, optimizer steps equal,
             the trained slots within 2 * lr * steps + 1e-6; then the memory
             features on both devices: (a) lending (``over_admit=2.0``) in
             a 7-block pool with a host tier, (b) adapter paging, 6
             adapters of true ranks 4 and 8 on a 4-slot bank, each with
             tokens, ``swap_decisions``, preemptions, ``kv_*`` counters,
             adapter swap-ins and steps equal; (c) training again with
             ``attn_chunk=16`` (chunked ft attention), losses within 1e-4
             relative; then the fleet: ``tests/test_fleet.py``'s trace
             (6 requests on a 48-token shared head, ``CostModel(fixed=1e-3,
             prefill_per_tok=1e-4)``) through one engine and 3 replicas
             under ``affinity`` and ``round-robin`` on both devices:
             tokens equal to the single engine's on each device and across
             devices, ``routed``, ``remote_fetch_blocks``, ``hash_hits``
             and steps equal across devices, round-robin fetches, the
             fleet index a bijection and every pool pristine.  Then
             the other configs (``ARCH_PARITY``): each new reduced config
             (phi3-medium-14b, deepseek-7b, command-r-35b with its tied
             head, qwen1.5-110b with QKV bias, llama4-maverick with a MoE
             layer) and int8 llama3-8b and maverick (quantized on the
             host) through the engine on both devices: greedy tokens and
             steps equal, every serving kernel launched.  Then MLA
             (``parity_mla``): reduced deepseek-v2-236b through the paged
             engine with dedup and with speculation (verify chunks over
             the latent pool), lending with a raw host tier (latent
             blocks restored bit-equal) and 2 replicas round-robin with
             one more ``import_block``: tokens equal on both devices,
             SMLM and BGMV launched and no GQA attention kernel.  Then
             Mamba2 (``parity_mamba``): reduced mamba2-1.3b and jamba
             through the paged engine with dedup (blocks adopted, prompts
             recomputed whole), an engine built with speculation (which a
             Mamba pattern turns off: the plain tokens), lending with a
             preemption (recompute; the host tier takes no swap-out), and
             for jamba 2 replicas round-robin with one more
             ``import_block`` (K/V equal, state rows untouched): tokens
             equal on both devices; mamba2 launches no attention kernel,
             jamba flash and paged decode but no paged prefill or verify.
             Then cross-attention (``parity_cross``): reduced
             llama-3.2-vision-90b and whisper-base with ``xgate`` open
             (``XGATE``), adapters over ``xwq``/``xwo`` too and a seeded
             source per request, with dedup (0 hash hits), speculation,
             chunked prefill, lending with a raw host tier (swap-out and
             restore) and 2 replicas (0 blocks fetched): tokens equal on
             both devices and to the plain run's.
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
8. train   — two trainers (``alpaca_like`` and ``gsm8k_like`` rows, 16
             each, lengths 24-96 and 48-160, full vocab; new adapters in the
             bank's free slots, lr 2e-5) co-run with phase 4's two waves,
             between two serve-only runs of the same waves: the mixed
             ticks, decode tick latency (mean, p50) of each run, fine-tune
             tokens/s, per-step losses, optimizer steps, the share of the
             trained slots' bf16 elements that the optimizer changed, and
             ``smlm_wgrad``'s launches (> 0); then one grad step through
             the kernels against the same step through the plain versions
             on the card, in fp32 (weights cast on the card), each grad
             leaf within 1e-4 of its max; the bf16 step's differences are
             printed, not gated, beside those of a path with the SMLM
             kernel's forward and the plain backward (the forward's
             rounding alone); one bf16 grad step is profiled
             (``profile: grad step`` line, with its device-to-device copy
             time).
9. tiers   — 8 requests of distinct 128-token prompts, 96 new tokens each,
             at t=0 (virtual clock): (A) the default pool; (B) 49 blocks
             with ``over_admit=2.0`` (recompute preemption); (C) as B with a
             32-block host tier; (D) as C in int8.  C and D take a
             ``CostModel`` of this card's pinned copy rates for one block
             and A's prefill seconds per token, and print what the default
             constants would have decided.  Each run: admitted peak, lent
             peak, preemptions, swap decisions, swap-outs, restores, bytes,
             host peak, decode ticks, tokens equal to A (first divergences
             with their logit margins); ``transfer:`` lines time each swap
             set beside a pinned copy of its bytes.  A restored block is
             bit-equal to the victim's original (raw) or within half a
             step and equal to the plain dequant of the stored payload
             (int8).  A demote trace (two shared heads, an 11-block pool)
             demotes and rehydrates.  Kernels 1-4 and 7 launch.
10. paging — 24 requests over 12 adapters (true ranks 8 and 4, weights
             1/(i+1), 3 waves) on a 4-slot bank and a 65-block pool, with
             ``adapter_paging`` off and on: swap-ins (> 0 when on), bytes,
             reloads, sheds, adapter blocks at peak, decode ticks, each
             swap-in beside a pinned copy, tokens off vs on; the bf16 byte
             image round trip at ranks 8 and 4 (bit-exact); one adapter
             voided and unvoided into a fresh store on the card serves 4
             requests with bit-identical tokens.
11. fleet  — ``benchmarks/bench_fleet.py``'s trace (3 templates with
             adapters lora0..2 picked by Zipf s=1.1; 18 requests of 1024
             tokens, an 832-token head plus a random tail; seeders at t=0,
             the burst at t=0.2) with 16 new tokens, over phase 4's base
             weights shared by every replica, virtual clock
             ``CostModel(fixed=1e-3, prefill_per_tok=1e-4)``: one engine,
             then 3 replicas round-robin without fetch, affinity, and
             round-robin with fetch (``rr_fetch``).  Each arm: host-clock
             wall seconds, prefill and decode tick ms, computed, reused
             and fetched blocks, ``hash_hits``, ``routed``, tokens equal to
             the single engine (bf16: printed, with each first divergence's
             logit margins, not gated).  Gates: every request finishes,
             logits finite, bijection, every pool pristine, ``rr_fetch``
             fetches exactly the analytic count, SMLM, BGMV, paged prefill,
             paged decode and flash launch in the fleet arms, and one
             ``import_block`` between two replicas copies the block
             ``torch.equal`` in K and V; that copy is timed between CUDA
             events beside a contiguous ``copy_`` of its bytes and its
             bound, and the fetch rule is evaluated at the measured copy
             and prefill times.

12. archs  — each arm of ``ARCH_ARMS`` at full width, built on the card
             leaf by leaf from a seed (int8: each leaf drawn in bf16,
             quantized, freed) and freed before the next: deepseek-7b
             bf16 (30 layers), phi3-medium-14b bf16 and int8 (40),
             command-r-35b int8 (40), qwen1.5-110b int8 (40 of 80),
             llama4-maverick bf16 (2 layers: one dense, one 128-expert
             MoE) and int8 (4), deepseek-v2-236b (MLA + MoE) bf16 (4 of
             60 layers) and int8 (8), mamba2-1.3b bf16 (all 48 layers)
             and jamba-1.5-large-398b int8 (8 of 72 layers: one period,
             attention at position 4, MoE at 1, 3, 5 and 7),
             llama-3.2-vision-90b bf16 (10 of 100 layers: 2 cross layers)
             and int8 (20), whisper-base bf16 (6 + 6 layers; the cross
             arms with a seeded source per request and ``xgate``
             ``XGATE``), each serving
             phase 4's two waves with two gaussian-B adapters: ``archs:``
             lines with prefill and decode tick latency (enqueue / device
             wait), resident weight bytes, ``max_memory_allocated``,
             tokens/s and, for MoE, the experts routed per tick and the
             entries dropped; for MLA the latent pool's bytes a token and
             layer; for Mamba the state bytes a request row; for
             cross-attention the ``xk``/``xv`` bytes a request row and
             the sources' host-to-card copy inside the prefill ticks.
             Gates:
             every request finishes, logits finite, the pool pristine;
             SMLM, BGMV, flash, paged prefill and paged decode (either
             form) launched; for MLA and mamba2 SMLM and BGMV launched and
             every GQA attention kernel at 0, for jamba paged prefill and
             verify at 0 (``check_routes``), for a cross arm SMLM, BGMV,
             flash and paged decode launched and paged prefill and verify
             at 0 (no aux request shares a prefix); each bf16 MoE, Mamba
             and cross arm also takes one fused train step on ft rows
             (loss finite, aux loss > 0 for MoE, only lora0's slot
             changed, for cross rows with sources and lora0's ``xwq``
             changed, ``smlm_wgrad`` launched).
13. window — sliding windows (phase 2 adds the windowed flash rows:
             S = 256 at W = 0, 64, 256 and 300 in bf16 and fp32 against the
             full plain version, rows with no key in their window exact
             zeros; in bf16 the long_500k shape B = 1, S = 16384, W = 8192
             against the chunked fp32 plain version, timed beside the
             chunked plain and SDPA with the same boolean mask).  Then
             ``parity_window``: reduced llama3-8b, deepseek-v2-236b,
             jamba-1.5-large-398b and llama-3.2-vision-90b with
             ``sliding_window`` 16 on ``cuda`` and ``cpu``, the dense engine
             (decode past the window) and a grad step over a mixed tick
             with ft rows longer than the window: tokens equal, logits,
             loss and gradients within the stated limits.  Then full-width
             llama3-8b under ``adapt_config(..., SHAPES["long_500k"])``
             (window 8192, bf16; phase 4's weights) through the engine
             (capacity 2, pf_capacity 2, s_max 32768: dense rows of 8192
             slots): a 16384-token prompt, then a 4096-token one, 32 new
             tokens each (``window:`` line: prefill ticks, decode ticks with
             their spread, peak memory, launches; gates: windowed flash and
             dense decode launched, no paged kernel).  Then the window's
             identity at full width: 16384 tokens prefilled into a rolling
             row and token 16384 decoded, against a cold prefill of 16385:
             equal argmax, logits within ``WINDOW_LOGIT_TOL``.
14. examples — the four example twins ``examples/*_torch.py``
             (quickstart, migration, multi_finetune, unified_serving),
             each through its ``run``: (a) on the reduced llama3-8b in
             fp32 on ``cuda`` and on ``cpu`` with the same numpy weights:
             tokens, slots, resident lists, counts and the payload's bytes
             equal, losses within ``EXAMPLE_LOSS_RTOL`` relative; (b) at
             full width (llama3-8b bf16, ``EXAMPLE_LAYERS`` deep, weights
             drawn on the card from phase 4's seeds), its engine's ticks
             timed (``examples:`` lines: depth, ticks, wall, tick mean and
             p50 with the step's enqueue and device wait, tokens trained,
             optimizer steps, losses, the payload's bytes, SLO attainment,
             peak allocated memory).  Gates: every request finishes with
             its tokens, every trainer takes optimizer steps with finite
             losses, every pool drains pristine, and the kernels of
             ``EXAMPLE_KERNELS`` launch (``check_routes``; paged prefill
             and split-K are counted, not gated); (c) ``costs:`` lines:
             the port's ``step_cost`` (dp 1, tp 1, ``strategy="tp"``) and
             ``Roofline`` bound on the H100's constants for phase 4's
             decode tick (4 rows over 512 slots) and cold prefill tick (4
             x 144 tokens), phase 6's profiled 3000-token prefill and
             phase 8's profiled grad step, beside the ticks measured in
             this run and the share bound / measured.
15. mesh   — (run after phase 13, on phase 4's weights) the sharded
             step (``make_forward_step(..., mesh=...)``) on a ``(1, 1)``
             mesh over an NCCL process group of one rank: (a) reduced
             llama3-8b fp32, CUDA == CPU greedy tokens, logits within
             1e-3; (b) full-width llama3-8b bf16, 4 x 256 prompts and 8
             greedy decode steps on dense rows, through the sharded step
             (every collective the identity) against the plain step:
             first-step logits within the bf16 tolerance, divergences
             near ties (``NEAR_TIE_ULPS``), the split SMLM / BGMV
             entries, flash and dense decode launched and the fused
             SMLM / BGMV calls not; then the same for the other families
             (``FAMILY_LOCAL``, against the plain step on the same card,
             first-step worst row <= ``MESH_LIMIT`` of its dtype):
             llama-3.2-vision-90b bf16 5 layers (one cross layer),
             deepseek-v2-236b int8 2 layers (MLA: split-K's merge kernel
             launched, no GQA kernel), whisper-base, llama3-8b 2 layers
             with an 8192 window and 2 x 9000-token prompts.  Phase 2 adds SMLM's and BGMV's split entries
             (``check_split``: shrink and expand apart, as a model axis
             > 1 runs them) against their plain versions and the fused
             calls, timed at one rank's slice of a 4-way split.  The
             4-rank arms run only with ``--mesh`` on a host with four
             cards: one NCCL rank a card, spawned after
             the kernels are built here once, every group and the join
             under ``MESH_TIMEOUT_S``; (a) llama3-8b bf16 32 layers at
             ``(1, 4)`` ``tp`` and ``(2, 2)`` ``fsdp_tp``, 8 x 1024
             prompts and 16 greedy decode steps, against the same weights
             on one card; (b) qwen1.5-110b bf16 at all 80 layers at both
             layouts, 4 x 2048 and 32 steps, the layouts against each
             other, and at 8 layers at ``(1, 4)`` against one card; (c)
             llama4-maverick's first 2 layers at ``(1, 4)`` (expert
             parallel, 32 of 128 experts a card, capacity factor 128 so
             that no side drops) against one card, with the all-to-all
             bytes beside ``step_cost``'s ``moe_a2a``; (d) ``vlm``:
             llama-3.2-vision-90b bf16 at all 100 layers at ``(1, 4)``
             ``tp`` and ``(2, 2)`` ``fsdp_tp``, 4 x 512 prompts with their
             1600 image patches and 8 steps, the layouts against each
             other, and 10 layers at ``(1, 4)`` against one card; (e)
             ``dsv2``: deepseek-v2-236b int8 at all 60 layers at ``(1, 4)``
             (40 of 160 experts and 32 of 128 heads a card, the latent's
             slots cut over the cards), 4 x 128 and 8 steps, every logit
             finite, and 8 layers (capacity factor 160) against one card;
             (f) ``whisper``: whisper-base at ``(1, 4)`` against one card;
             (g) ``window``: llama3-8b with an 8192 window and one
             16384-token prompt at ``(1, 4)`` against one card.  Per card: resident
             and peak bytes, prefill and decode ms (enqueue and device
             wait), launches (the split entries, flash and dense decode
             on every rank, gated); per arm the collective operand bytes
             a step by kind beside ``step_cost``'s ``coll/*`` and the
             ``costs:`` share; tokens equal or each near tie printed with
             its margins in bf16 ulps (``divergences``), every first
             divergence within ``NEAR_TIE_ULPS``, first-step logits
             within ``MESH_LOGIT_LIMIT`` of a row's max |logit| (llama,
             qwen) or the bf16 tolerance (maverick); and a planted fault
             (llama ``(1, 4)``, model ranks 1-3 drop their LoRA shrink
             partials, 4 decode steps) that those gates must catch.
             The cache layouts (``make_forward_step(...,
             cache_strategy=)``): phase 15 adds ``LAYOUTS_LOCAL``, the
             ``(1, 1)`` arms where both layouts are the whole row
             (phi3-medium-14b 2 layers, "auto"; llama3-8b 2 layers,
             "seq": its decode through split-K's partial and merge
             kernels on one rank), against the plain step; ``--mesh``
             adds (h) ``phi3``: phi3-medium-14b bf16 40 layers at ``(1,
             4)`` tp, 10 query heads a card and its 10 KV heads cut by the
             head dim, 8 x 1024 and 16 steps, against one card; (i)
             ``seq``: llama3-8b at ``(1, 4)`` tp and ``(2, 2)`` fsdp_tp
             with ``cache_strategy="seq"``, 4 x 8192 and 16 steps,
             against one card and against the "auto" layout at ``(1,
             4)`` on the same prompts, and a planted fault (model ranks
             1-3 drop their decode partials, ``model.seq_partials``);
             (j) ``seq_window``: (g) under "seq"; (k) ``seq_vlm``: the
             VLM at 10 layers at ``(1, 4)`` under "seq" (``xk``/``xv``'s
             1600 patches 400 a card), against one card.  These print
             the layouts' collective operand bytes a step beside their
             hand count (``layout_terms``), and gate flash on every rank
             and, on a "seq" decode, split-K's merge once a layer a step.
             Mamba2, jamba and MLA's window: phase 15 adds ``SSM_LOCAL``
             (key ``mesh_ssm``), the ``(1, 1)`` arms mamba2-1.3b 2
             layers, jamba int8 8 layers (fp32) and deepseek-v2 bf16 2
             layers with an 8192 window and one 9000-token prompt (MLA's
             prefill in blocks of 1024), against the plain step;
             ``--mesh`` adds
             (l) ``mamba2``: mamba2-1.3b bf16 at all 48 layers at ``(1,
             4)`` tp and ``(2, 2)`` fsdp_tp (16 / 32 of its 64 SSM heads
             a card), 8 x 1024 and 16 steps, against one card in bf16
             (within ``MAMBA_BF16_LIMIT`` and ``MAMBA_BF16_ULPS``) and in
             fp32 (``MESH_FP32_LIMIT``, the limit of every arm computed in
             fp32), and a planted fault in both (model ranks 1-3 skip the
             all-reduce of the gated norm's sum of squares,
             ``model.gated_sum_sq``); (m)
             ``jamba``: jamba-1.5-large-398b int8 (fp32 compute) at 8
             layers at ``(1, 4)`` (4 of 16 experts a card, capacity
             factor 16), 4 x 512 and 8 steps, against one card, no entry
             dropped on either side; (n) ``jamba_deep``: the same in bf16
             at 40 layers (221 B parameters), every logit finite; (o)
             ``dsv2_window``:
             deepseek-v2-236b at long_500k (window 8192: rolling latent
             rows of 2048 slots a card), int8 dequantized to fp32, 8
             layers, capacity factor 4, one 16384-token prompt and 16
             steps, against one card, the same entries dropped on both
             sides (a card's tokens are one of the one-card dispatch
             groups).
             The train step under a mesh: phase 15 adds ``TRAIN_LOCAL``
             (key ``mesh_train``), llama3-8b bf16 2 layers through the
             sharded grad and train steps at ``(1, 1)`` against the plain
             steps, the split entries' and ``smlm_wgrad``'s launches gated
             exactly and the fused SMLM's at 0; ``--mesh`` adds (p)
             ``train``: llama3-8b fp32 8 layers at ``(1, 4)`` tp and
             ``(2, 2)`` fsdp_tp on ft rows and on a mixed batch against
             one card (``TRAIN_LIMIT``), the two planted faults of
             ``planted_train``, and bf16 32 layers at ``(2, 2)`` against
             one card, with the batch fault planted in bf16 and both bf16
             steps read against the fp32 grad step; (q) ``train_qwen``:
             qwen1.5-110b bf16 at all 80 layers, two train steps at both
             meshes, a falling finite loss and the peak per card.
             The other families' train step under a mesh: phase 15 adds
             ``TRAIN_FAMILIES_LOCAL`` (key ``mesh_train_families``):
             mamba2-1.3b 2 layers, the VLM 5 layers (one cross layer over
             1600-patch sources), whisper-base and llama3-8b int8 2
             layers, bf16, each through the sharded steps at ``(1, 1)``
             against the plain steps, launches gated by
             ``split_launches``; ``--mesh`` adds (r) ``train_families``:
             the ``TRAIN_FAMILIES`` arms in fp32 at both meshes on ft rows
             and a mixed batch against one card, remat and
             ``act_constraint_fn`` on mamba2 and the VLM, the gated norm's
             identity-adjoint fault planted on mamba2; (s) ``train_vlm``:
             the VLM bf16 at all 100 layers at ``(1, 4)``, three remat +
             ``act_constraint_fn`` train steps; (t) ``train_qwen_int8``:
             qwen1.5-110b int8 at all 80 layers at ``(2, 2)`` fsdp_tp,
             three train steps (``big_train_arm``: a falling finite loss
             and the peak per card); a ``--mesh`` run ends with the train
             arms' launches on card 0 as one JSON line
             (``mesh_launches_by_path``).

Then one JSON line of per-kernel numbers (``launches`` from the kernel's
main-path run, named in ``launches_path``; ``launches_by_path`` from every
run of phases 4-15 that launched it: full, spec, long, long_spec, dense,
train, tiers, paging, fleet, window, mesh, mesh_families, mesh_layouts,
mesh_ssm, mesh_train, mesh_train_remat, mesh_train_families, archs,
archs_mla, archs_mamba,
archs_cross (the MLA, Mamba and cross arms with their grad steps) and
examples (the four twins at full width);
``shapes`` its other timed rows, flash's windowed ones among them), the
card's name and power
limit, and the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def _load_file(name: str, *parts):
    """The module at ``ROOT/<parts>`` under ``name``, imported by path: the
    port's H100 constants and the example twins, whichever tree ``--root``
    imports the kernels from."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, *parts))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod         # dataclasses resolve their module
    spec.loader.exec_module(mod)
    return mod


# the H100 SXM's peaks and memory rate (NVIDIA data sheet), as the port's
# roofline states them
RA = _load_file("_smoke_roofline", "src", "repro_torch", "roofline",
                "analysis.py")
HBM_BYTES_PER_S = RA.HBM_BW
PEAK_FLOPS = {torch.bfloat16: RA.PEAK_FLOPS, torch.float32: RA.PEAK_FLOPS_FP32}
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
    from repro_torch.kernels import ops
    from repro_torch.kernels.smlm import SMLMFunction, smlm_wgrad
    K.update(ops=ops, smlm_wgrad=smlm_wgrad, SMLMFunction=SMLMFunction)
    try:                # a parent checkout may lack the split backward
        from repro_torch.kernels.smlm import smlm_wgrad_split
        K.update(smlm_wgrad_split=smlm_wgrad_split)
    except ImportError:
        pass
    try:                # a parent checkout may lack the split entries
        K.update(_split_entries())
    except ImportError:
        pass
    return K


# launch counters of the main path, by wrapper
COUNTERS = ("smlm", "bgmv", "decode", "prefill", "verify", "partials",
            "merge", "flash", "dense_decode", "smlm_wgrad")


def reset_counts(K):
    for k in COUNTERS:
        K[k].launches = 0
    K["partials"].shapes.clear()


def read_counts(K, names=COUNTERS):
    return {k: K[k].launches for k in names}


# the GQA attention kernels' counters: an MLA run launches none of them (its
# attention is plain PyTorch, as in the JAX package), nor does an
# attention-free Mamba2 run
GQA_COUNTERS = ("decode", "prefill", "verify", "partials", "merge", "flash",
                "dense_decode")
# what a hybrid Mamba pattern never takes: suffix prefill and speculation
MAMBA_NEVER = ("prefill", "verify")


def check_routes(label, cfg, launches, need):
    """A run's launches (``read_counts``) against its route: an MLA config,
    or one with no attention layer (``mamba2-1.3b``), must launch SMLM and
    BGMV and no GQA attention kernel (a GQA route taken by mistake); any
    other must launch every kernel of ``need``, and a hybrid with Mamba
    layers (``jamba``) no paged prefill and no verify kernel (its engine
    recomputes whole prompts and never speculates)."""
    if cfg.mla is not None or "attn" not in cfg.pattern:
        wrong = {k: launches[k] for k in GQA_COUNTERS if launches[k]}
        if wrong or not (launches["smlm"] and launches["bgmv"]):
            raise AssertionError(f"{label}: the {cfg.name} run launched GQA"
                                 f" kernels {wrong} or not SMLM and BGMV: "
                                 f"{launches}")
        return
    if min(launches[k] for k in need) == 0:
        raise AssertionError(f"{label}: a kernel did not launch: "
                             f"{launches}")
    wrong = {k: launches[k] for k in MAMBA_NEVER if launches[k]}
    if "mamba" in cfg.pattern and wrong:
        raise AssertionError(f"{label}: the hybrid run launched {wrong}, "
                             f"which a Mamba pattern never takes")


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


# the split entries' timed shape: a 4-way column-parallel slice of the
# widest llama3-8b projection (4096 -> 14336: a rank's 1024 of d_in and
# 3584 of d_out), at SMLM's and BGMV's main-path token counts
SPLIT_WAYS = 4


def check_split(K, name, x, a, b, ids, scale, bt, dtype, timing):
    """SMLM's (``bt``) or BGMV's (``bt`` None) split entries: the shrink
    against its plain version; the expand of the whole shrink against the
    fused call (bit-equal for SMLM: the same device code; within the
    tolerance for BGMV, whose split shrink groups its slices of d_in
    otherwise); and the ``SPLIT_WAYS``-way split of the mesh (shrinks over
    slices of d_in summed, expands over slices of d_out concatenated)
    against the plain whole call.  With ``timing``, the timing row of one
    rank's shrink + expand at its slice (``SPLIT_WAYS`` of d_in and
    d_out), and a ``timing:`` line of each entry's time beside its own
    bound.  Returns (max abs error, row or None)."""
    shrink, expand = K[f"{name}_shrink"], K[f"{name}_expand"]
    kw = {"block_t": bt} if bt else {}
    fused = K[name](x, a, b, ids, scale, **kw)
    if bt:
        plain_s = K["ref"].smlm_shrink_ref(x, a, ids, scale, bt)
        plain = K["ref"].smlm_ref(x, a, b, ids, scale, bt)
    else:
        plain_s = K["ref"].bgmv_shrink_ref(x, a, ids, scale)
        plain = K["ref"].bgmv_ref(x, a, b, ids, scale)
    s = shrink(x, a, ids, scale, **kw)
    err = compare(s, plain_s, dtype)
    y = expand(s, b, ids, scale, **kw)
    if bt and not torch.equal(y, fused):
        raise AssertionError(f"{name} split expand != the fused call")
    err = max(err, compare(y, plain, dtype))
    n = SPLIT_WAYS
    di, do = x.shape[1] // n, b.shape[-1] // n
    parts = [shrink(x[:, i * di:(i + 1) * di].contiguous(),
                    a[:, i * di:(i + 1) * di].contiguous(), ids, scale, **kw)
             for i in range(n)]
    s = torch.stack(parts).sum(0)
    y = torch.cat([expand(s, b[..., i * do:(i + 1) * do].contiguous(), ids,
                          scale, **kw) for i in range(n)], dim=1)
    err = max(err, compare(y, plain, dtype))
    if not timing:
        return err, None
    T = x.shape[0]
    xl, al = x[:, :di].contiguous(), a[:, :di].contiguous()
    bl = b[..., :do].contiguous()
    run = lambda: expand(shrink(xl, al, ids, scale, **kw), bl, ids, scale,
                         **kw)
    if bt:
        plain_fn = lambda: K["ref"].smlm_expand_ref(
            K["ref"].smlm_shrink_ref(xl, al, ids, scale, bt), bl, ids, scale,
            bt)
        t_live = int((scale != 0).sum()) * bt
    else:
        plain_fn = lambda: K["ref"].bgmv_expand_ref(
            K["ref"].bgmv_shrink_ref(xl, al, ids, scale), bl, ids, scale)
        t_live = int((scale != 0).sum())
    used = torch.unique(ids[scale != 0]).numel()
    it, r = x.element_size(), a.shape[-1]
    nbytes = (t_live * di + T * do) * it + used * r * (di + do) * it \
        + 2 * T * r * 4
    bms, by = bound(nbytes, 2 * t_live * r * (di + do), x.dtype)
    # each entry apart: the shrink reads the live rows' slice of x and the
    # used adapters' A and writes the fp32 [T, r]; the expand reads that
    # and the used adapters' B and writes y
    b_s = bound((t_live * di + used * r * di) * it + T * r * 4,
                2 * t_live * r * di, x.dtype)
    b_e = bound(T * r * 4 + (used * r * do + T * do) * it,
                2 * t_live * r * do, x.dtype)
    s_l = shrink(xl, al, ids, scale, **kw)
    ms_s = time_ms(lambda: shrink(xl, al, ids, scale, **kw))
    ms_e = time_ms(lambda: expand(s_l, bl, ids, scale, **kw))
    print(f"timing: {name} split entries bf16 T={T} d_in={di} d_out={do} "
          f"r={r}, one of {n} ranks: shrink ms={ms_s:.5f} bound_ms="
          f"{b_s[0]:.5f} ({b_s[1]}) bound_share={b_s[0] / ms_s:.4f}; expand "
          f"ms={ms_e:.5f} bound_ms={b_e[0]:.5f} ({b_e[1]}) bound_share="
          f"{b_e[0] / ms_e:.4f}")
    sel = ids.long()
    xa = xl.view(-1, bt or 1, di)
    ag, bg = al[sel], bl[sel]
    return err, dict(
        max_abs_err=err, ms=time_ms(run), plain_ms=time_ms(plain_fn,
                                                          eager=True),
        library_ms=time_ms(lambda: torch.bmm(torch.bmm(xa, ag), bg)),
        bound_ms=bms, bound_by=by,
        shape=f"split shrink+expand, one of {n} ranks: T={T} d_in={di} "
              f"d_out={do} r={r} n={a.shape[0]}"
              + (f" block_t={bt}" if bt else ""))


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
            if main and f"{name}_shrink" in K:
                err_s, row = check_split(K, name, *args,
                                         bt if name == "smlm" else None,
                                         dtype, timing)
                errs.append(err_s)
                if row is not None:
                    rows[f"{name} split T={T_} {d_in // SPLIT_WAYS}x"
                         f"{d_out // SPLIT_WAYS}"] = row
            if timing and (main or (T_, d_in, d_out) in timed):
                key = name if main else f"{name} T={T_} {d_in}x{d_out}"
                rows[key] = lora_row(K, *args,
                                     bt if name == "smlm" else None, err)
        print(f"kernels: {name:<13} {str(dtype)[6:]:<8} "
              f"max_abs_err={max(errs):.3e} tol={TOL[dtype]:g}x"
              f"max|plain| per row block_t={bt} shapes(T,d_in,d_out)="
              f"{','.join(f'({a},{b},{c})' for a, b, c in shapes)} ok")
    return rows


# the weight gradient's shapes: the mixed tick's ft head (4 rows of a
# 256-token bucket: two of one trainer's slot, one of the other's, one
# base-only padding row of scale 0) at each projection shape of a grad step
# (q/o, k/v, gate/up, down)
WGRAD_T = 1024
WGRAD_SHAPES = ((WGRAD_T, 4096, 4096), (WGRAD_T, 4096, 1024),
                (WGRAD_T, 4096, 14336), (WGRAD_T, 14336, 4096))
WGRAD_PER_LAYER = (2, 2, 2, 1)     # projections of a layer at each shape
# deepseek-v2-236b's LoRA projections (wq, wdkv, wo, the shared expert's up
# and down), checked and timed beside them
MLA_WGRAD_SHAPES = ((WGRAD_T, 5120, 24576), (WGRAD_T, 5120, 576),
                    (WGRAD_T, 16384, 5120), (WGRAD_T, 5120, 3072),
                    (WGRAD_T, 3072, 5120))
# the sharded train step's weight gradient: one rank's slices of the gate
# projection under a model axis of 4 (d_in 4096 / 4, d_out 14336 / 4), its
# shrinks in the split entries' plain [T, r] layout, packed first
SPLIT_WGRAD_SHAPE = (WGRAD_T, 4096 // SPLIT_WAYS, 14336 // SPLIT_WAYS)


def wgrad_case(T, d_in, d_out, dtype, dev, gen, bt, r=8):
    x = torch.randn(T, d_in, generator=gen, device=dev).to(dtype)
    dy = (torch.randn(T, d_out, generator=gen, device=dev) * 0.1).to(dtype)
    s = torch.randn(T, r, generator=gen, device=dev) * 0.5
    gs = torch.randn(T, r, generator=gen, device=dev) * 0.05
    per_row = T // 4 // bt
    ids = torch.tensor([2, 2, 3, 0], device=dev, dtype=torch.int32
                       ).repeat_interleave(per_row)
    scale = torch.tensor([1.0, 1.0, 1.0, 0.0], device=dev
                         ).repeat_interleave(per_row)
    return x, dy, s, gs, ids, scale


def wgrad_library_ms(x, dy, s, gs, ids, scale, bt):
    """The weight gradient's library yardstick: torch.bmm over the live
    tokens gathered per adapter in advance (zero-padded to the largest
    group), one bmm for dA and one for dB."""
    tok = ids.repeat_interleave(bt)
    live = scale.repeat_interleave(bt) != 0
    groups = [torch.nonzero(live & (tok == k)).flatten()
              for k in torch.unique(tok[live]).tolist()]
    L = max(len(g) for g in groups)

    def gather(v):
        out = torch.zeros((len(groups), L, v.shape[1]), dtype=x.dtype,
                          device=v.device)
        for i, g in enumerate(groups):
            out[i, :len(g)] = v[g].to(x.dtype)
        return out

    xg, dyg, sg, gsg = (gather(v) for v in (x, dy, s, gs))
    return time_ms(lambda: (torch.bmm(xg.transpose(1, 2), gsg),
                            torch.bmm(sg.transpose(1, 2), dyg)))


def wgrad_bound(x, dy, scale, bt, r=8, n=4):
    """(bound ms, by): X and dY of the live tokens, both fp32 shrinks of
    them, dA and dB written; 2 r FLOPs a live token and column."""
    live = int((scale != 0).sum()) * bt
    it, width = x.element_size(), x.shape[1] + dy.shape[1]
    nbytes = live * width * it + 2 * live * r * 4 + n * r * width * it
    return bound(nbytes, 2 * live * r * width, x.dtype)


def check_wgrad(K, dtype, dev, gen, timing: bool):
    """SMLM's weight gradient against its plain version at the mixed
    tick's ft head for the four projection shapes (each dA and dB row
    within the tolerance; the unused slots exactly 0), timed at each (the
    JSON row: 4096->14336) beside the two copies of transposed bank slices
    that SMLMFunction's dX makes (the grad step's sum: 32 layers of q, k,
    v, o, gate, up, down); then SMLMFunction's backward against autograd
    through the plain SMLM."""
    rows, errs, bt = {}, [], K["block_t"]
    ref = K["ref"]
    slices = {}
    for T, d_in, d_out in WGRAD_SHAPES + MLA_WGRAD_SHAPES + (
            SPLIT_WGRAD_SHAPE,):
        x, dy, s, gs, ids, scale = wgrad_case(T, d_in, d_out, dtype, dev,
                                              gen, bt)
        sb, gb = ref.pack_shrink(s, bt), ref.pack_shrink(gs, bt)
        args = (x, dy, sb, gb, ids, scale)
        da, db = K["smlm_wgrad"](*args, r=8, block_t=bt, n_slots=4)
        pa, pb = ref.smlm_wgrad_ref(x, dy, s, gs, ids, scale, bt, 4)
        err = max(compare(da, pa, dtype), compare(db, pb, dtype))
        if float(da[:2].abs().max()) or float(db[:2].abs().max()):
            raise AssertionError("smlm_wgrad wrote a slot no live tile uses")
        errs.append(err)
        if timing:
            main = (d_in, d_out) == (4096, 14336)
            key = "smlm_wgrad" if main else f"smlm_wgrad T={T} {d_in}x{d_out}"
            bms, by = wgrad_bound(x, dy, scale, bt)
            rows[key] = dict(
                max_abs_err=err,
                ms=time_ms(lambda: K["smlm_wgrad"](*args, r=8, block_t=bt,
                                                   n_slots=4)),
                plain_ms=time_ms(lambda: ref.smlm_wgrad_ref(
                    x, dy, s, gs, ids, scale, bt, 4), eager=True),
                library_ms=wgrad_library_ms(x, dy, s, gs, ids, scale, bt),
                bound_ms=bms, bound_by=by,
                shape=f"T={T} d_in={d_in} d_out={d_out} r=8 n=4 "
                      f"block_t={bt} live={int((scale != 0).sum()) * bt}")
        if timing and (T, d_in, d_out) in WGRAD_SHAPES:
            a = torch.randn(4, d_in, 8, generator=gen, device=dev).to(dtype)
            b = torch.randn(4, 8, d_out, generator=gen, device=dev).to(dtype)
            slices[(T, d_in, d_out)] = time_ms(lambda: (
                b.transpose(1, 2).contiguous(),
                a.transpose(1, 2).contiguous()))
    if timing and "smlm_wgrad_split" in K:
        # the sharded step's form: the plain shrinks packed, then the kernel
        T, d_in, d_out = SPLIT_WGRAD_SHAPE
        x, dy, s, gs, ids, scale = wgrad_case(T, d_in, d_out, dtype, dev,
                                              gen, bt)
        pack_ms = time_ms(lambda: (ref.pack_shrink(s, bt),
                                   ref.pack_shrink(gs, bt)))
        split_ms = time_ms(lambda: K["smlm_wgrad_split"](
            x, dy, s, gs, ids, scale, block_t=bt, n_slots=4))
        bms = rows[f"smlm_wgrad T={T} {d_in}x{d_out}"]["bound_ms"]
        print(f"kernels: smlm_wgrad split T={T} {d_in}x{d_out} (one rank of "
              f"{SPLIT_WAYS}) bf16: packed shrinks + kernel ms="
              f"{split_ms:.5f}, the two pack_shrink copies alone ms="
              f"{pack_ms:.5f}, bound_ms={bms:.5f}")
    if timing:
        per_step = 32 * sum(slices[k] * m
                            for k, m in zip(WGRAD_SHAPES, WGRAD_PER_LAYER))
        print("kernels: smlm_backward bf16 transposed bank slices (B^T, "
              "A^T; n=4 r=8) ms a call: " + " ".join(
                  f"{i}x{o}={v:.5f}" for (_, i, o), v in slices.items())
              + f"; a grad step of 32 layers: {per_step:.3f} ms")
    print(f"kernels: smlm_wgrad    {str(dtype)[6:]:<8} max_abs_err="
          f"{max(errs):.3e} tol={TOL[dtype]:g}xmax|plain| per row shapes("
          f"T,d_in,d_out)="
          f"{','.join(str(v) for v in WGRAD_SHAPES + MLA_WGRAD_SHAPES)}"
          f",{SPLIT_WGRAD_SHAPE} ok")
    # SMLMFunction: ft rows (with a base-only tile) then prefill tiles of
    # zero cotangent, at the widest projection
    T, n_ft, d_in, d_out = WGRAD_T + 256, WGRAD_T, 4096, 14336
    x, a, b, _, _ = lora_case(T, d_in, d_out, dtype, dev, gen, bt)
    ids = torch.tensor([2, 3, 0, 1], device=dev, dtype=torch.int32
                       ).repeat_interleave(T // 4 // bt)
    scale = (ids != 0).float() * 1.5
    g = torch.zeros(T, d_out, device=dev, dtype=dtype)
    g[:n_ft] = torch.randn(n_ft, d_out, generator=gen, device=dev).to(dtype)
    kern = [v.clone().requires_grad_() for v in (x, a, b)]
    plain = [v.clone().requires_grad_() for v in (x, a, b)]
    n0 = K["smlm_wgrad"].launches
    (K["SMLMFunction"].apply(*kern, ids, scale, bt, n_ft).float()
     * g.float()).sum().backward()
    (ref.smlm_ref(*plain, ids, scale, bt).float() * g.float()
     ).sum().backward()
    if K["smlm_wgrad"].launches != n0 + 1:
        raise AssertionError("SMLMFunction's backward did not launch "
                             "smlm_wgrad once")
    errs = [compare(k.grad, p.grad, dtype) for k, p in zip(kern, plain)]
    print(f"kernels: smlm_backward {str(dtype)[6:]:<8} SMLMFunction vs "
          f"autograd through the plain SMLM, T={T} n_ft={n_ft} {d_in}->"
          f"{d_out}: max_abs_err dx={errs[0]:.3e} da={errs[1]:.3e} "
          f"db={errs[2]:.3e} ok")
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


def visible_keys(n: int, window: int = 0) -> int:
    """Keys the n live rows of a causal prompt score: row i sees i + 1, or
    min(i + 1, window) with a window."""
    if window <= 0 or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def flash_work(S, lengths, h, g, hd, it, window=0):
    """Bytes and FLOPs causal flash attention needs: q read and the output
    written once (all S rows), the K/V rows < length read once; FLOPs of the
    live query rows (row i < length scores i + 1 keys, at most ``window``),
    as the rows past the length are padding of the prompt bucket."""
    keys = sum(int(n) for n in lengths)
    nbytes = (2 * len(lengths) * S * h * hd + 2 * keys * g * hd) * it
    flops = sum(4 * h * hd * visible_keys(int(n), window) for n in lengths)
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


# the shapes of the other configs the port serves (phase 12), timed beside
# the main path's: the group sizes m = h/g the walks had not run at (1:
# deepseek-7b's 32 KV heads; 5: llama4-maverick's 40 heads over 8; 8:
# command-r-35b and qwen1.5-110b) and the up projections (d_in, d_out) of
# phi3-medium-14b, command-r-35b and deepseek-7b, SMLM at a serving wave's
# 576 tokens and BGMV at a decode tick's 8
ARCH_LORA = ((5120, 17920), (8192, 22528), (4096, 11008),
             # deepseek-v2-236b: wq, wdkv (576 columns: 4.5 x 128), wo
             # (the widest d_in), the shared expert's up and down
             (5120, 24576), (5120, 576), (16384, 5120), (5120, 3072),
             (3072, 5120),
             # llama-3.2-vision-90b: wq / wo / xwq / xwo, wk / wv, wg / wu,
             # wd; whisper-base: wq, wg / wu, wd
             (8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192),
             (512, 512), (512, 2048), (2048, 512))


def attn_row(run, plain, lib, nbytes, flops, dtype, err, shape):
    bms, by = bound(nbytes, flops, dtype)
    return dict(max_abs_err=err, ms=time_ms(run),
                plain_ms=time_ms(plain, iters=5, eager=True),
                library_ms=time_ms(lib), bound_ms=bms, bound_by=by,
                shape=shape)


def supports_m5(K) -> bool:
    """Whether the port in use runs a group size that does not divide the
    query tile's 64 rows (the parent of that change refuses it)."""
    import inspect
    return "TILE_ROWS % (h // g)" not in inspect.getsource(K["flash"])


def check_arch_shapes(K, dtype, dev, gen, timing: bool):
    """Each attention kernel at the new group sizes against its plain
    version (paged and dense decode, verify and split-K at m = 1 and 5;
    flash and paged prefill at m = 5 and 8, prefill on both walks), SMLM
    and BGMV at the new widths; in bf16 the timing rows.  A port that
    refuses m = 5 (``--root`` at the parent) skips those rows."""
    rows, ref = {}, K["ref"]
    it = torch.empty((), dtype=dtype).element_size()
    m5 = supports_m5(K)
    hd, bs, nbt = 128, 32, 16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    # m = 1 (h = g = 32): paged and dense decode at the serving positions
    pos = torch.tensor([0, 143, 150, 200, 37, 255, 300, 511], device=dev,
                       dtype=torch.int32)
    need = [0] + [int(p) // bs + 1 for p in pos[1:]]
    kp, vp, tables = paged_case(dev, gen, dtype, 8, nbt, need, g=32)
    q = torch.randn(8, 32, hd, generator=gen, device=dev).to(dtype)
    args = (q, kp, vp, tables, pos)
    err = compare(K["decode"](*args), ref.paged_decode_ref(*args), dtype)
    keys = sum(int(p) + 1 for p in pos)
    work = ((2 * q.numel() + 2 * keys * 32 * hd) * it, 4 * 32 * hd * keys)
    if timing:
        rows["paged_decode m=1"] = attn_row(
            lambda: K["decode"](*args), lambda: ref.paged_decode_ref(*args),
            sdpa_yardstick(q[:, None], kp, vp, tables,
                           q_pos=pos[:, None].long(), kend=pos.long() + 1),
            *work, dtype, err,
            "B=8 h=32 g=32 hd=128 bs=32 pos up to 511 (deepseek-7b)")
    kd, vd = (torch.randn(8, 512, 32, hd, generator=gen, device=dev
                          ).to(dtype) for _ in range(2))
    dargs = (q, kd, vd, pos)
    derr = compare(K["dense_decode"](*dargs),
                   ref.decode_attention_ref(*dargs), dtype)
    if timing:
        mask = (torch.arange(512, device=dev)[None, :]
                <= pos.long()[:, None])[:, None, None, :]
        qt = q[:, :, None].contiguous()
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kd, vd))
        rows["dense_decode m=1"] = attn_row(
            lambda: K["dense_decode"](*dargs),
            lambda: ref.decode_attention_ref(*dargs),
            lambda: sdpa(qt, kt, vt, attn_mask=mask), *work, dtype, derr,
            "B=8 S=512 h=32 g=32 hd=128 window=0 pos up to 511 "
            "(deepseek-7b)")
    checked = [f"paged_decode m=1 {err:.3e}", f"dense_decode m=1 {derr:.3e}"]
    # verify and split-K (chunks of 5 positions) and decode at m = 1 and 5
    vpos, vlens = [0, 30, 61, 200, 300, 506], [0, 5, 5, 2, 1, 5]
    for m, h in ((1, 32), (5, 40)):
        if m == 5 and not m5:
            continue
        cargs = chunk_case(dev, gen, dtype, vpos, vlens, 5, nbt, h=h,
                           g=h // m)
        plain = ref.paged_verify_ref(*cargs)
        e1 = compare(K["verify"](*cargs), plain, dtype)
        e2 = compare(K["verify_splitk"](*cargs, num_splits=4), plain, dtype)
        qc, kc, vc, tc, pc, _ = cargs
        e3 = compare(K["decode"](qc[:, 0].contiguous(), kc, vc, tc, pc),
                     ref.paged_decode_ref(qc[:, 0], kc, vc, tc, pc), dtype)
        checked.append(f"m={m}: verify {e1:.3e} split-K(4) {e2:.3e} "
                       f"decode {e3:.3e}")
    # flash at the serving wave's shape, m = 5 and 8
    c = FLASH_SERVE
    for m, h, g in ((5, 40, 8), (8, 64, 8)):
        if m == 5 and not m5:
            continue
        q, k, v = flash_case(dev, gen, dtype, c["B"], c["S"], c["S"], h=h,
                             g=g)
        ln = torch.full((c["B"],), c["length"], device=dev,
                        dtype=torch.int32)
        exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), ln,
                                        True)
        err = compare(K["flash"](q, k, v, ln, True), exact, dtype)
        checked.append(f"flash m={m} {err:.3e}")
        del exact
        if timing:
            j = torch.arange(c["S"], device=dev)
            mask = (j[None, :] <= j[:, None]) & (j[None, :] < c["length"])
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            rows[f"flash_attention m={m}"] = attn_row(
                lambda: K["flash"](q, k, v, ln, True),
                lambda: ref.flash_attention_ref(q, k, v, ln, True),
                lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                *flash_work(c["S"], ln.tolist(), h, g, hd, it), dtype, err,
                f"causal B=4 S=T=256 length=144 h={h} g={g} hd=128")
    # paged prefill over 128 cached tokens: 16-token suffixes (the split
    # walk at these m) and 48-token ones (the query-tile walk)
    cached = torch.tensor([128, 128, 128, 0, 0], device=dev,
                          dtype=torch.int32)
    for m, h, g, Sq in ((5, 40, 8, 16), (5, 40, 8, 48), (4, 32, 8, 48),
                        (8, 64, 8, 48)):
        if m == 5 and not m5:
            continue
        seg = torch.tensor([Sq, Sq * 3 // 4, Sq // 2, Sq, 0], device=dev,
                           dtype=torch.int32)
        need = [(int(cl) + Sq - 1) // bs + 1 for cl in cached]
        kp, vp, tables = paged_case(dev, gen, dtype, 5, nbt, need, g=g)
        qp = torch.randn(5, Sq, h, hd, generator=gen, device=dev).to(dtype)
        pargs = (qp, kp, vp, tables, cached, seg)
        out = K["prefill"](*pargs)
        if float(out[4].float().abs().max()) != 0.0:
            raise AssertionError("all-masked prefill row is not 0")
        err = compare(out, ref.paged_prefill_ref(*pargs), dtype)
        checked.append(f"prefill m={m} Sq={Sq} {err:.3e}")
        if timing:
            qpos = cached[:, None].long() + torch.arange(Sq, device=dev)
            kend = (cached + seg).long()
            live = (seg > 0).long()[:, None]
            vk = torch.minimum(qpos + 1, kend[:, None]).clamp(min=0) * live
            rows[f"paged_prefill m={m} Sq={Sq}"] = attn_row(
                lambda: K["prefill"](*pargs),
                lambda: ref.paged_prefill_ref(*pargs),
                sdpa_yardstick(qp, kp, vp, tables, q_pos=qpos, kend=kend),
                (2 * qp.numel() + 2 * int(vk[:, -1].sum()) * g * hd) * it,
                int(4 * h * hd * vk.sum()), dtype, err,
                f"B=5 Sq={Sq} cached 128 h={h} g={g} hd=128 bs=32 "
                f"({Sq * m} columns)")
    # the cross configs' attention: llama-3.2-vision-90b at m = 8 (h 64,
    # g 8, hd 128) in decode and verify (flash and prefill at m = 8 are
    # above), whisper-base at m = 1 and hd 64 (h = g = 8) in every kernel
    dneed = [0] + [int(p) // bs + 1 for p in pos[1:]]
    for m, h, g, hdx, tag in ((8, 64, 8, 128, "m=8"),
                              (1, 8, 8, 64, "hd=64 m=1")):
        kp, vp, tables = paged_case(dev, gen, dtype, 8, nbt, dneed, g=g,
                                    hd=hdx)
        q = torch.randn(8, h, hdx, generator=gen, device=dev).to(dtype)
        args = (q, kp, vp, tables, pos)
        err = compare(K["decode"](*args), ref.paged_decode_ref(*args), dtype)
        work = ((2 * q.numel() + 2 * keys * g * hdx) * it,
                4 * h * hdx * keys)
        if timing:
            rows[f"paged_decode {tag}"] = attn_row(
                lambda: K["decode"](*args),
                lambda: ref.paged_decode_ref(*args),
                sdpa_yardstick(q[:, None], kp, vp, tables,
                               q_pos=pos[:, None].long(),
                               kend=pos.long() + 1),
                *work, dtype, err, f"B=8 h={h} g={g} hd={hdx} bs=32 pos up "
                f"to 511 ({'llama-3.2-vision-90b' if m == 8 else 'whisper-base'})")
        cargs = chunk_case(dev, gen, dtype, vpos, vlens, 5, nbt, h=h, g=g,
                           hd=hdx)
        plain = ref.paged_verify_ref(*cargs)
        e1 = compare(K["verify"](*cargs), plain, dtype)
        e2 = compare(K["verify_splitk"](*cargs, num_splits=4), plain, dtype)
        checked.append(f"{tag}: decode {err:.3e} verify {e1:.3e} split-K(4)"
                       f" {e2:.3e}")
        if m != 1:
            continue
        kd, vd = (torch.randn(8, 512, g, hdx, generator=gen, device=dev
                              ).to(dtype) for _ in range(2))
        dargs = (q, kd, vd, pos)
        derr = compare(K["dense_decode"](*dargs),
                       ref.decode_attention_ref(*dargs), dtype)
        c = FLASH_SERVE
        fq, fk, fv = flash_case(dev, gen, dtype, c["B"], c["S"], c["S"],
                                h=h, g=g, hd=hdx)
        ln = torch.full((c["B"],), c["length"], device=dev,
                        dtype=torch.int32)
        exact = ref.flash_attention_ref(fq.float(), fk.float(), fv.float(),
                                        ln, True)
        ferr = compare(K["flash"](fq, fk, fv, ln, True), exact, dtype)
        Sq = 16
        seg = torch.tensor([Sq, 12, 8, Sq, 0], device=dev, dtype=torch.int32)
        pneed = [(int(cl) + Sq - 1) // bs + 1 for cl in cached]
        pk, pv, ptab = paged_case(dev, gen, dtype, 5, nbt, pneed, g=g,
                                  hd=hdx)
        qp = torch.randn(5, Sq, h, hdx, generator=gen, device=dev).to(dtype)
        pargs = (qp, pk, pv, ptab, cached, seg)
        perr = compare(K["prefill"](*pargs), ref.paged_prefill_ref(*pargs),
                       dtype)
        checked.append(f"{tag}: dense_decode {derr:.3e} flash {ferr:.3e} "
                       f"prefill Sq=16 {perr:.3e}")
        if timing:
            dmask = (torch.arange(512, device=dev)[None, :]
                     <= pos.long()[:, None])[:, None, None, :]
            dq = q[:, :, None].contiguous()
            dk, dv = (x.transpose(1, 2).contiguous() for x in (kd, vd))
            rows[f"dense_decode {tag}"] = attn_row(
                lambda: K["dense_decode"](*dargs),
                lambda: ref.decode_attention_ref(*dargs),
                lambda: sdpa(dq, dk, dv, attn_mask=dmask), *work, dtype,
                derr, f"B=8 S=512 h={h} g={g} hd={hdx} window=0 pos up to "
                f"511 (whisper-base)")
            j = torch.arange(c["S"], device=dev)
            fmask = (j[None, :] <= j[:, None]) & (j[None, :] < c["length"])
            qt, kt, vt = (x.transpose(1, 2).contiguous()
                          for x in (fq, fk, fv))
            rows[f"flash_attention {tag}"] = attn_row(
                lambda: K["flash"](fq, fk, fv, ln, True),
                lambda: ref.flash_attention_ref(fq, fk, fv, ln, True),
                lambda: sdpa(qt, kt, vt, attn_mask=fmask, enable_gqa=True),
                *flash_work(c["S"], ln.tolist(), h, g, hdx, it), dtype,
                ferr, f"causal B=4 S=T=256 length=144 h={h} g={g} hd={hdx} "
                f"(whisper-base)")
    # SMLM and BGMV at the new widths
    bt = K["block_t"]
    for d_in, d_out in ARCH_LORA:
        for name, T in (("smlm", 576), ("bgmv", 8)):
            x, a, b, ids, scale = lora_case(T, d_in, d_out, dtype, dev, gen,
                                            bt)
            if name == "bgmv":
                ids = torch.tensor(BGMV_IDS, device=dev, dtype=torch.int32)
            rt = K["route"](ids, scale[ids.long().clamp(0, 3)], 4,
                            T if name == "smlm" else 0, bt)
            if name == "smlm":
                largs = (x, a, b, rt.tile_ids, rt.tile_scale)
                err = compare(K["smlm"](*largs, block_t=bt),
                              ref.smlm_ref(*largs, bt), dtype)
            else:
                largs = (x, a, b, rt.tail_ids, rt.tail_scale)
                err = compare(K["bgmv"](*largs), ref.bgmv_ref(*largs), dtype)
            checked.append(f"{name} {d_in}x{d_out} {err:.3e}")
            if timing:
                rows[f"{name} T={T} {d_in}x{d_out}"] = lora_row(
                    K, *largs, bt if name == "smlm" else None, err)
    print(f"kernels: arch shapes   {str(dtype)[6:]:<8} max_abs_err: "
          f"{'; '.join(checked)} tol={TOL[dtype]:g}xmax|plain| per row"
          + ("" if m5 else " (m=5 skipped: this port refuses h/g=5)")
          + " ok")
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


# MLA's attention sublayer at full width (deepseek-v2-236b: h=128, c=512,
# dr=64, dn=dv=128; 16-entry tables of 32-token blocks): the decode bucket
# of phase 12 (B=8 at DENSE_POS) and wave 2's suffix prefill (B=4, 16
# tokens over a 128-token cached head)
MLA_CASES = {"decode": dict(pos=DENSE_POS, Sq=1),
             "suffix_prefill": dict(pos=[128] * 4, Sq=16)}


def mla_record(dev, gen):
    """The ``mla:`` lines: the plain MLA attention sublayer of the port
    (``_paged_write_chunk`` of the new latent, ``_paged_view`` gathers and
    ``_paged_chunk_mask``, ``layers.mla_attention`` in the absorbed form)
    at ``MLA_CASES``, in bf16: device time in a CUDA graph (``time_ms``)
    and eager, beside its bound (``wuk``/``wuv`` read once, the latent of
    the keys each row can see, q in, out; the four absorbed products'
    operations) and a yardstick, one ``scaled_dot_product_attention`` call
    on the equivalent MQA form over views gathered in advance (query
    ``q_lat || q_pe``, one key head ``ckv || kpe`` of c + dr, one value
    head ``ckv``: no absorption products).  A record, not a kernel: the
    JAX package computes MLA in jnp, outside Pallas, and the port keeps it
    plain PyTorch; its output is held finite and printed against the same
    function in fp32 on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L, model as TM
    cfg = get_config("deepseek-v2-236b")
    m, h, dtype = cfg.mla, cfg.n_heads, torch.bfloat16
    c, dr, dn, dv = m.kv_lora_rank, m.qk_rope_dim, m.qk_nope_dim, \
        m.v_head_dim
    bs, nbt = 32, 16
    it = torch.empty((), dtype=dtype).element_size()
    # the up projections drawn as the schema draws them: fan-in h
    wuk, wuv = ((torch.randn(c, h, d, generator=gen, device=dev)
                 * min(0.02, h ** -0.5)).to(dtype) for d in (dn, dv))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for label, case in MLA_CASES.items():
        B, Sq = len(case["pos"]), case["Sq"]
        pos = torch.tensor(case["pos"], device=dev, dtype=torch.int32)
        length = torch.full((B,), Sq, device=dev, dtype=torch.int32)
        tables = (1 + torch.arange(B * nbt, device=dev, dtype=torch.int32)
                  ).view(B, nbt)
        ckv_pool, kpe_pool = (torch.randn(1 + B * nbt, bs, w, generator=gen,
                                          device=dev).to(dtype)
                              for w in (c, dr))
        qn = torch.randn(B, Sq, h, dn, generator=gen, device=dev).to(dtype)
        qp = torch.randn(B, Sq, h, dr, generator=gen, device=dev).to(dtype)
        ckv, kpe = (torch.randn(B, Sq, w, generator=gen, device=dev
                                ).to(dtype) for w in (c, dr))
        q_pos = pos[:, None].long() + torch.arange(Sq, device=dev)

        def run(t=lambda x: x):
            cp, kp = t(ckv_pool), t(kpe_pool)
            TM._paged_write_chunk(cp, t(ckv), tables, pos, length)
            TM._paged_write_chunk(kp, t(kpe), tables, pos, length)
            k_pos, k_valid = TM._paged_chunk_mask(tables, bs, pos, length)
            return L.mla_attention(
                t(qn), t(qp), TM._paged_view(cp, tables),
                TM._paged_view(kp, tables), t(wuk), t(wuv), q_pos=q_pos,
                k_pos=k_pos, k_valid=k_valid, causal=True)

        out = run()
        exact = run(lambda x: x.float())
        if not torch.isfinite(out).all():
            raise AssertionError(f"mla {label}: non-finite output")
        err, ratio = float((out.float() - exact).abs().max()), \
            worst_row(out, exact)
        ms, eager_ms = time_ms(run), time_ms(run, eager=True)
        # the yardstick: the MQA form over views gathered in advance
        k_pos, k_valid = TM._paged_chunk_mask(tables, bs, pos + Sq - 1,
                                              torch.ones_like(length))
        mask = ((k_pos[:, None, :] <= q_pos[:, :, None])
                & k_valid[:, None, :])[:, None]
        q_lat = torch.einsum("bshd,chd->bshc", qn, wuk)
        qm = torch.cat([q_lat, qp], -1).transpose(1, 2).contiguous()
        view = torch.cat([TM._paged_view(ckv_pool, tables),
                          TM._paged_view(kpe_pool, tables)], -1)
        km, vm = view[:, None].contiguous(), view[:, None, :, :c].contiguous()
        yard_ms = time_ms(lambda: sdpa(qm, km, vm, attn_mask=mask,
                                       scale=(dn + dr) ** -0.5,
                                       enable_gqa=True))
        keys = int((q_pos + 1).sum())           # keys each query can see
        seen = int((pos.long() + Sq).sum())     # latent rows read
        nbytes = (c * h * (dn + dv) + seen * (c + dr)
                  + B * Sq * (h * (dn + dr) + c + dr + h * dv)) * it
        flops = 2 * h * (B * Sq * dn * c + keys * (c + dr) + keys * c
                         + B * Sq * c * dv)
        bms, by = bound(nbytes, flops, dtype)
        rows[label] = dict(ms=ms, bound_ms=bms)
        print(f"mla: {label} {cfg.name} bf16 B={B} Sq={Sq} h={h} c={c} "
              f"dr={dr} dn={dn} dv={dv} bs={bs} nbt={nbt} positions "
              f"{case['pos'][0]}..{max(case['pos'])} (plain PyTorch, no "
              f"Pallas counterpart): ms={ms:.5f} (CUDA graph) eager_ms="
              f"{eager_ms:.5f} sdpa_mqa_yardstick_ms={yard_ms:.5f} bound_ms="
              f"{bms:.5f} ({by}: {nbytes} bytes, {flops} operations) "
              f"bound_share={bms / ms:.4f}; a {cfg.n_layers}-layer tick "
              f"{ms * cfg.n_layers:.4f} ms vs bound "
              f"{bms * cfg.n_layers:.4f} ms; vs fp32 max_abs_err={err:.3e} "
              f"worst_row_ratio={ratio:.3e} finite=True")
    return rows


# the Mamba2 mixer at mamba2-1.3b's width: phase 12's decode bucket (B=8)
# and a prefill of 4 rows of 144 tokens (two SSD chunks of 128)
SSD_CASES = {"decode": dict(B=8, S=1), "prefill": dict(B=4, S=144)}


def ssd_record(dev, gen):
    """The ``ssd:`` lines: the plain Mamba2 mixer of the port between its
    projections, at ``SSD_CASES`` in bf16: at decode ``model.mamba_step``
    (the causal convs over the conv state rows, ``ssd_step`` over the
    state ``h``, the gated norm, the state rows written back in place), at
    prefill ``model.mamba_seq`` (the convs, the chunked SSD, the gated
    norm).  Device time in a CUDA graph (``time_ms``) and eager, beside
    its bound: each input and state row read once and each output and
    state row written once (the mixer's weights too), and the operations
    of the recurrence (about 6 a state element a token: decay, the rank-1
    update, the read-out; the conv's 2 a tap), the least the tokens need
    (the chunked form does more).  A record, not a kernel: the JAX package
    computes the mixer in jnp, outside Pallas, and the port keeps it plain
    PyTorch.  The output is held finite and printed against the same
    function in fp32 on the same inputs.  Returns {case: (ms, bound_ms)}."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models.schema import init_leaf, layer_shapes
    cfg = get_config("mamba2-1.3b")
    s, dtype = cfg.ssm, torch.bfloat16
    di, nh, hd, ds, K = (cfg.d_inner, cfg.n_ssm_heads, s.head_dim,
                         s.d_state, s.conv_width)
    gbc = 2 * s.n_groups * ds
    it = torch.empty((), dtype=dtype).element_size()
    p = {k: init_leaf(leaf, gen, dev, dtype)
         for k, leaf in layer_shapes(cfg, 0).items()
         if k in ("conv_x", "conv_bx", "conv_bc", "conv_bbc", "a_log",
                  "dt_bias", "d_skip", "mnorm")}
    p_bytes = sum(v.numel() for v in p.values()) * it
    rows = {}
    for label, case in SSD_CASES.items():
        B, S = case["B"], case["S"]

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen, device=dev)
                    * scale).to(dtype)

        xb, zb, bcb, dtb = (rnd(B, S, di), rnd(B, S, di), rnd(B, S, gbc),
                            rnd(B, S, nh))
        state = {"h": rnd(B, nh, hd, ds, scale=0.1),
                 "conv_x": rnd(B, K - 1, di), "conv_bc": rnd(B, K - 1, gbc)}
        valid = torch.ones((B, S), dtype=torch.bool, device=dev)
        p32 = {k: v.float() for k, v in p.items()}

        def run(prm=p, cast=lambda x: x, st=state):
            if S == 1:
                y = TM.mamba_step(cfg, prm, cast(xb), cast(bcb), cast(dtb),
                                  st)
            else:
                y = TM.mamba_seq(cfg, prm, cast(xb), cast(bcb), cast(dtb),
                                 valid)[0]
            return TM._gated_out(y, cast(zb), prm)

        out = run(st={k: v.clone() for k, v in state.items()})
        exact = run(p32, lambda x: x.float(),
                    {k: v.float() for k, v in state.items()})
        if not torch.isfinite(out).all():
            raise AssertionError(f"ssd {label}: non-finite output")
        err, ratio = float((out.float() - exact).abs().max()), \
            worst_row(out, exact)
        ms, eager_ms = time_ms(run), time_ms(run, eager=True)
        h_bytes = B * nh * hd * ds * it
        conv_bytes = B * (K - 1) * (di + gbc) * it
        io_bytes = B * S * (3 * di + gbc + nh) * it      # x, z, bc, dt; out
        # decode reads and writes the state rows; prefill writes them
        nbytes = (p_bytes + io_bytes + (2 if S == 1 else 1)
                  * (h_bytes + conv_bytes))
        flops = B * S * (6 * nh * hd * ds + 2 * K * (di + gbc) + 10 * di)
        bms, by = bound(nbytes, flops, dtype)
        h_rw = h_bytes * (2 if S == 1 else 1)
        rows[label] = (ms, bms)
        print(f"ssd: {label} {cfg.name} bf16 B={B} S={S} nh={nh} hd={hd} "
              f"ds={ds} di={di} chunk={s.chunk} (plain PyTorch mixer between "
              f"the projections, no Pallas counterpart): ms={ms:.5f} (CUDA "
              f"graph) eager_ms={eager_ms:.5f} bound_ms={bms:.5f} ({by}: "
              f"{nbytes} bytes of which state h {h_rw}, {flops} "
              f"operations) bound_share={bms / ms:.4f}; a "
              f"{cfg.n_layers}-layer tick {ms * cfg.n_layers:.4f} ms vs "
              f"bound {bms * cfg.n_layers:.4f} ms; vs fp32 max_abs_err="
              f"{err:.3e} worst_row_ratio={ratio:.3e} finite=True")
    return rows


# the cross sublayer at llama-3.2-vision-90b's width: phase 12's decode
# bucket (B=8, each over its request's F=1600 cached rows) and a prefill
# bucket of 4 x 144 tokens that projects its 1600 image tokens through
# xwk / xwv; then whisper-base's encoder over 4 x 1500 frames
XATTN_CASES = {"decode": dict(B=8, S=1), "prefill": dict(B=4, S=144)}
ENCODER_CASE = dict(B=4)


def xattn_record(dev, gen):
    """The ``xattn:`` lines: the plain cross-attention sublayer of the port
    (``model._cross_apply``: the norm, ``xwq``, at prefill the projection
    of the bucket's fp32 sources through ``xwk`` / ``xwv`` and the row
    write, non-causal ``layers.attention`` over the F keys, ``xwo`` and
    the gate; no adapter) at ``XATTN_CASES`` in bf16, and whisper-base's
    ``model.encoder_forward`` over ``ENCODER_CASE``: device time in a CUDA
    graph (``time_ms``) and eager, beside the bound (weights, sources and
    rows read once, outputs and rows written once; the products' and the
    attention's operations) and, for the sublayer, one
    ``scaled_dot_product_attention`` call on its attention alone (the
    library call the port does not make).  A record, not a kernel: the JAX
    package computes both in jnp, outside Pallas.  Outputs are held finite
    and printed against the same function in fp32 on the same inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as TM
    from repro_torch.models.schema import cross_len, encoder_shapes, \
        init_leaf, layer_shapes
    from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch
    cfg = get_config("llama-3.2-vision-90b")
    h, g, hd, d, nf = (cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model,
                       cross_len(cfg))
    dtype = torch.bfloat16
    it = torch.empty((), dtype=dtype).element_size()
    li = next(i for i in range(cfg.n_layers) if cfg.is_cross_layer(i))
    n_cross = cfg.n_layers // cfg.cross_attn_every
    p = {k: init_leaf(leaf, gen, dev, dtype)
         for k, leaf in layer_shapes(cfg, li).items() if k.startswith("x")}
    p["xgate"].fill_(XGATE)
    p32 = {k: v.float() for k, v in p.items()}
    w_bytes = sum(p[k].numel() for k in ("xwq", "xwk", "xwv", "xwo")) * it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for label, case in XATTN_CASES.items():
        B, S = case["B"], case["S"]
        i32 = lambda *shape, v=0: torch.full(shape, v, device=dev,
                                             dtype=torch.int32)
        x = torch.randn(B * S, d, generator=gen, device=dev).to(dtype)
        cache = {k: torch.randn(B, nf, g, hd, generator=gen, device=dev
                                ).to(dtype) for k in ("xk", "xv")}
        if S == 1:
            batch = UnifiedBatch(dec=DECBatch(tokens=i32(B), pos=i32(B, v=200),
                                              adapter=i32(B, v=-1)))
        else:
            src = torch.randn(B, nf, d, generator=gen, device=dev)
            batch = UnifiedBatch(pf=PFBatch(
                tokens=i32(B, S), length=i32(B, v=S), adapter=i32(B, v=-1),
                aux_embed=src))
        plan = TM._Plan(cfg, batch, None, 8)

        def run(prm=p, xx=x, rw=cache):
            return TM._cross_apply(cfg, prm, {}, plan, xx, rw)

        with torch.no_grad():
            out = run(rw={k: v.clone() for k, v in cache.items()})
            exact = run(p32, x.float(), {k: v.float()
                                         for k, v in cache.items()})
            if not torch.isfinite(out).all():
                raise AssertionError(f"xattn {label}: non-finite output")
            err, ratio = float((out.float() - exact).abs().max()), \
                worst_row(out, exact)
            ms, eager_ms = time_ms(run), time_ms(run, eager=True)
            qt = torch.randn(B, h, S, hd, generator=gen, device=dev
                             ).to(dtype)
            kt, vt = (v.transpose(1, 2).contiguous()
                      for v in cache.values())
            sdpa_ms = time_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True))
        kv_rows = 2 * B * nf * g * hd * it
        if S == 1:     # xwq, xwo; the rows read
            nbytes = 2 * d * h * hd * it + kv_rows + 2 * B * d * it
            flops = 4 * B * d * h * hd + 4 * B * h * hd * nf
        else:          # every weight; the fp32 sources read, the rows written
            nbytes = w_bytes + B * nf * d * 4 + kv_rows + 2 * B * S * d * it
            flops = (4 * B * nf * d * g * hd + 4 * B * S * d * h * hd
                     + 4 * B * S * h * hd * nf)
        bms, by = bound(nbytes, flops, dtype)
        rows[label] = (ms, bms)
        print(f"xattn: {label} {cfg.name} bf16 B={B} S={S} F={nf} h={h} "
              f"g={g} hd={hd} d={d} (plain PyTorch cross sublayer, no Pallas"
              f" counterpart): ms={ms:.5f} (CUDA graph) eager_ms="
              f"{eager_ms:.5f} sdpa_attention_only_ms={sdpa_ms:.5f} "
              f"bound_ms={bms:.5f} ({by}: {nbytes} bytes, {flops} "
              f"operations) bound_share={bms / ms:.4f}; "
              f"{n_cross} cross layers a full-depth tick {ms * n_cross:.4f} ms;"
              f" vs fp32 max_abs_err={err:.3e} worst_row_ratio="
              f"{ratio:.3e} finite=True")
    wcfg = get_config("whisper-base")
    ne, d, B = wcfg.encoder.n_layers, wcfg.d_model, ENCODER_CASE["B"]
    nf, h, f = wcfg.encoder.n_frames, wcfg.n_heads, wcfg.d_ff
    enc = {"layers": [{k: init_leaf(leaf, gen, dev, dtype)
                       for k, leaf in encoder_shapes(wcfg).items()}
                      for _ in range(ne)],
           "final_norm": torch.ones(d, device=dev, dtype=dtype)}
    enc32 = {"layers": [{k: v.float() for k, v in layer.items()}
                        for layer in enc["layers"]],
             "final_norm": enc["final_norm"].float()}
    frames = torch.randn(B, nf, d, generator=gen, device=dev).to(dtype)
    with torch.no_grad():
        out = TM.encoder_forward(wcfg, enc, frames)
        exact = TM.encoder_forward(wcfg, enc32, frames.float())
        if not torch.isfinite(out).all():
            raise AssertionError("xattn encoder: non-finite output")
        err, ratio = float((out.float() - exact).abs().max()), \
            worst_row(out, exact)
        del exact
        run = lambda: TM.encoder_forward(wcfg, enc, frames)
        ms, eager_ms = time_ms(run), time_ms(run, eager=True)
    w = sum(v.numel() for layer in enc["layers"] for v in layer.values())
    nbytes = (w + d + 2 * B * nf * d) * it
    flops = ne * (2 * B * nf * d * (4 * d + 3 * f)
                  + 4 * B * h * wcfg.hd * nf * nf)
    bms, by = bound(nbytes, flops, dtype)
    rows["encoder"] = (ms, bms)
    print(f"xattn: encoder {wcfg.name} bf16 B={B} frames={nf} layers={ne} "
          f"d={d} h={h} hd={wcfg.hd} d_ff={f} (plain PyTorch, "
          f"bidirectional, no Pallas counterpart): ms={ms:.5f} (CUDA graph) "
          f"eager_ms={eager_ms:.5f} bound_ms={bms:.5f} ({by}: {nbytes} "
          f"bytes, {flops} operations) bound_share={bms / ms:.4f}; vs fp32 "
          f"max_abs_err={err:.3e} worst_row_ratio={ratio:.3e} finite=True")
    return rows


# ------------------------------------------------- phase 3: reduced parity
# a cross layer's gate: the schema draws it as zeros (tanh(0) = 0, so a
# fresh cross layer adds nothing); every cross run here opens it
XGATE = 0.5


def numpy_weights(cfg, seed):
    """Weights in the JAX package's layout from a numpy seed: norms ones,
    a cross layer's ``xgate`` ``XGATE``, every other leaf normal(0,
    min(scale, fan_in^-1/2)) (the router's scale 0.006, 0.02 otherwise;
    biases too, so the bias path carries values)."""
    from repro_torch.models.schema import param_shapes
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in param_shapes(cfg).items():
        if key.endswith(("ln1", "ln2", "final_norm", "mnorm", "d_skip",
                         "xln")):
            flat[key] = np.ones(shape, np.float32)
        elif key.endswith("xgate"):            # open: tanh(0.5) = 0.46
            flat[key] = np.full(shape, XGATE, np.float32)
        elif key.endswith("a_log"):            # Mamba's schema initialisers
            flat[key] = np.broadcast_to(np.log(np.linspace(
                1.0, 16.0, shape[-1])), shape).astype(np.float32)
        elif key.endswith("dt_bias"):
            dt = np.exp(np.linspace(np.log(1e-3), np.log(0.1), shape[-1]))
            flat[key] = np.broadcast_to(np.log(np.expm1(dt)),
                                        shape).astype(np.float32)
        else:
            cap = 0.006 if key.endswith("router") else 0.02
            std = min(cap, shape[-2] ** -0.5 if len(shape) > 1 else 1.0)
            flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return flat


def numpy_adapter(cfg, lcfg, seed):
    """One adapter in the JAX package's layout (``blocks/{pos}/<t>/a``,
    periods axis first) from a numpy seed, gaussian B."""
    from repro_torch.models.schema import jax_key, lora_targets
    rng = np.random.default_rng(seed)
    flat, P = {}, len(cfg.pattern)
    for pos, targets in enumerate(lora_targets(cfg, lcfg.targets)[:P]):
        for name, tg in targets.items():
            key = jax_key(cfg, pos, name)
            flat[f"{key}/a"] = (rng.standard_normal(
                (cfg.n_periods, tg.d_in, lcfg.r)) / tg.d_in ** 0.5
                                ).astype(np.float32)
            flat[f"{key}/b"] = (rng.standard_normal(
                (cfg.n_periods, lcfg.r, tg.d_out)) * 0.02 * lcfg.scaling
                                ).astype(np.float32)
    return flat


def mixed_model(cfg, params, adapters, lcfg, dev, dtype):
    from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
    store = AdapterStore(cfg, lcfg, device=dev, dtype=dtype)
    for name, adapter in adapters.items():
        store.load(name, adapter)
    return MixedLoraModel(cfg, params, store)


def build_engine(cfg, params, adapters, lcfg, dev, dtype, ecfg):
    from repro_torch.serving.engine import UnifiedEngine
    return UnifiedEngine(mixed_model(cfg, params, adapters, lcfg, dev,
                                     dtype), ecfg)


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


def logit_rows(engines, reqs):
    """Keep every tick's logits of ``engines`` on the host
    (``record_logits(keep=True)``) and match each token of ``reqs`` to the
    logits row that chose it (a prefill row by the tick's prefill order, a
    decode or verify row by the request's slot and the token's place in
    the tick's emission).  Each engine's ``tick`` is wrapped in place, so
    a fleet that ticks its replicas records them too.  Returns {rid:
    [(token, fp32 logits [V]), ...]} (filled as the engines tick) and a
    function that undoes the patch of ``flow.assemble``."""
    from repro_torch.serving import engine as E
    rows = {r.rid: [] for r in reqs}
    pf_rids = []
    assemble = E.flow.assemble

    def recorded_assemble(ft_rows, pf_reqs, *a, **kw):
        pf_rids[:] = [p.rid for p in pf_reqs]
        return assemble(ft_rows, pf_reqs, *a, **kw)

    def wrap(eng):
        seen = record_logits(eng, keep=True)
        step = eng.tick

        def tick():
            before = {r.rid: len(r.output) for r in reqs}
            n_seen = len(seen)
            pf_rids.clear()
            busy = step()
            if len(seen) == n_seen:
                return busy
            got = seen.pop()
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
            return busy

        eng.tick = tick

    for eng in engines:
        wrap(eng)
    E.flow.assemble = recorded_assemble

    def restore():
        E.flow.assemble = assemble

    return rows, restore


def argmax_share(rows):
    return sum(int(int(row.argmax()) == tok)
               for got in rows.values() for tok, row in got)


def logit_run(cfg, weights, waves, **ecfg):
    """An untimed copy of a run: the requests of ``waves`` on a fresh
    engine over the shared weights, with ``logit_rows``.  Returns {rid:
    [(token, fp32 logits [V]), ...]} and how many of the tokens are their
    row's argmax."""
    from repro_torch.core.virtualization import MixedLoraModel
    from repro_torch.serving import engine as E
    params, store, _ = weights
    eng = E.UnifiedEngine(MixedLoraModel(cfg, params, store),
                          E.EngineConfig(**ecfg))
    rows, restore = logit_rows([eng], [r for wave in waves for r in wave])
    try:
        run_waves(eng, eng.tick, waves)
    finally:
        restore()
    return rows, argmax_share(rows)


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
    parity_train(K, cfg, flat, lcfg, devices)
    parity_memory(K, cfg, flat, lcfg, devices)
    parity_train(K, cfg, flat, lcfg, devices, attn_chunk=16)
    parity_fleet(K, cfg, flat, lcfg, devices)
    parity_archs(K, devices)


def add_trainers(eng, vocab, n_rows=16, accum=2, sets=None):
    """Two trainers on the port's synthetic sets (``alpaca_like`` for tr0,
    ``gsm8k_like`` for tr1), one epoch each, 2 rows a micro-batch."""
    from repro_torch.data import datasets
    from repro_torch.training.trainer import MixedLoraTrainer, TrainerConfig
    sets = sets or (datasets.alpaca_like, datasets.gsm8k_like)
    for i, make in enumerate(sets):
        name = f"tr{i}"
        rows, ev = datasets.split_eval(make(n_rows, vocab=vocab, seed=i))
        eng.add_trainer(MixedLoraTrainer(
            name, eng.model.store.slot_of(name), rows, ev,
            TrainerConfig(rows_per_micro=2, accum_steps=accum, epochs=1)))


def trainer_slots(store):
    return [store.slot_of("tr0"), store.slot_of("tr1")]


def slot_leaves(store, slots):
    """Every bank leaf's ``slots``, flattened in the store's target order."""
    return torch.cat([layer[t][k][slots].reshape(-1).float()
                      for layer, targets in zip(store.bank["layers"],
                                                store.layer_targets)
                      for t in targets for k in ("a", "b")])


def parity_train(K, cfg, flat, lcfg, devices, lr=1e-3, attn_chunk=0):
    """Phase 3, training: two trainers and four served requests through the
    engine on ``cuda`` and on ``cpu`` (virtual clock, fp32): served tokens
    equal, per-row losses within 1e-4 relative, optimizer steps equal, and
    the trained slots within 2 * lr * steps + 1e-6 per element (an AdamW
    step moves an element by at most lr, so a near-zero gradient whose sign
    differs moves it by at most 2 lr).  ``attn_chunk`` > 0 runs the ft
    attention chunked (online softmax, query blocks recomputed in the
    backward)."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.data import datasets
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.request import Request
    from repro_torch.training.optimizer import AdamWConfig
    ad = {name: numpy_adapter(cfg, lcfg, seed=seed)
          for name, seed in (("lora0", 10), ("tr0", 20), ("tr1", 21))}
    prompts = datasets.sharegpt_prompts(4, vocab=cfg.vocab, len_lo=6,
                                        len_hi=16)
    runs = {}
    for dev in devices:
        params = params_from_numpy(flat, device=dev)
        adapters = {n: {"layers": bank_from_numpy(f, device=dev)["layers"]}
                    for n, f in ad.items()}
        eng = build_engine(cfg, params, adapters, lcfg, torch.device(dev),
                           torch.float32, EngineConfig(
                               capacity=4, pf_capacity=2, s_max=96,
                               virtual_time=True, opt=AdamWConfig(lr=lr),
                               attn_chunk=attn_chunk))
        add_trainers(eng, cfg.vocab)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, adapter="lora0",
                               max_new_tokens=4, arrival=0.3 * i))
        reset_counts(K)
        eng.run(max_ticks=20000)
        runs[dev] = (eng, read_counts(K))
    (ge, gl), (ce, _) = runs[devices[0]], runs[devices[1]]
    gtok = {r.rid: list(r.output) for r in ge.finished}
    if len(gtok) != 4 or gtok != {r.rid: list(r.output)
                                  for r in ce.finished}:
        raise AssertionError("served tokens differ between cuda and cpu")
    steps, worst = 0, 0.0
    for name, tr in ge.trainers.items():
        ctr = ce.trainers[name]
        if tr.optimizer_steps != ctr.optimizer_steps or \
                tr.optimizer_steps < 1:
            raise AssertionError(f"{name}: optimizer steps "
                                 f"{tr.optimizer_steps} != "
                                 f"{ctr.optimizer_steps}")
        steps = max(steps, tr.optimizer_steps)
        for got, want in ((tr.train_losses, ctr.train_losses),
                          (tr.eval_losses, ctr.eval_losses)):
            g_, w_ = np.asarray(got), np.asarray(want)
            if len(g_) != len(w_) or not len(g_):
                raise AssertionError(f"{name}: {len(g_)} != {len(w_)} "
                                     f"losses")
            worst = max(worst, float(np.max(np.abs(g_ - w_) / np.abs(w_))))
    if worst > 1e-4:
        raise AssertionError(f"per-row losses differ by {worst:.3e} "
                             f"relative")
    diff = (slot_leaves(ge.model.store, trainer_slots(ge.model.store)).cpu()
            - slot_leaves(ce.model.store, trainer_slots(ce.model.store)))
    diff = diff.abs()
    if float(diff.max()) > 2 * lr * steps + 1e-6:
        raise AssertionError(f"banks differ by {float(diff.max()):.3e}")
    if gl["smlm_wgrad"] == 0:
        raise AssertionError(f"smlm_wgrad never launched: {gl}")
    m = ge.metrics
    print(f"parity: training, 2 trainers + 4 served requests, lr={lr:g}, "
          f"attn_chunk={attn_chunk}, "
          f"cuda==cpu served tokens, optimizer_steps="
          f"{[t.optimizer_steps for t in ge.trainers.values()]}, per-row "
          f"losses max_rel_err={worst:.3e} tol=1e-4 ("
          f"{sum(len(t.train_losses) + len(t.eval_losses) for t in ge.trainers.values())}"
          f" rows), bank max_abs_err={float(diff.max()):.3e} tol="
          f"{2 * lr * steps + 1e-6:.3e} share_over_1e-6="
          f"{float((diff > 1e-6).float().mean()):.3e}, finetune_tokens="
          f"{m.finetune_tokens} steps={m.steps}, cuda launches smlm="
          f"{gl['smlm']} smlm_wgrad={gl['smlm_wgrad']} ok")


MEMORY_COUNTERS = ("smlm", "bgmv", "decode", "prefill", "flash")
KV_COUNTERS = ("kv_swap_outs", "kv_swap_out_bytes", "kv_restores",
               "kv_restore_bytes", "kv_swap_drops", "kv_demotions",
               "kv_demote_bytes", "kv_rehydrations", "kv_rehydrate_bytes")


def watch_restores(cm):
    """Wrap a manager's ``swap_out`` / ``restore_swap`` (raw host tier) so
    every restored block is checked ``torch.equal`` to the victim's
    original in every cache leaf (the restore skips blocks adopted from a
    sibling, as ``watch_tiers`` does).  Returns a list that gains the count
    of blocks checked at each restore."""
    swap_out, restore, kept, checked = cm.swap_out, cm.restore_swap, {}, []

    def watched_swap_out(slot):
        idx = torch.tensor(cm.tables[slot][:cm.swap_payload_blocks(slot)],
                           dtype=torch.long, device=cm.device)
        orig = {k: v.index_select(1, idx)
                for k, v in cm.block_leaves.items()}
        sid = swap_out(slot)
        if sid is not None:
            kept[sid] = orig
        return sid

    def watched_restore(slot, sid):
        orig = kept.pop(sid)
        b0 = cm.kv_restore_bytes
        covered = restore(slot, sid)
        nw = (cm.kv_restore_bytes - b0) // cm.host_block_bytes
        shared = min(cm.shared_count.get(slot, 0), len(cm.tables[slot]))
        idx = torch.tensor(cm.tables[slot][shared:shared + nw],
                           dtype=torch.long, device=cm.device)
        for k, v in cm.block_leaves.items():
            if not torch.equal(v.index_select(1, idx),
                               orig[k][:, shared:shared + nw]):
                raise AssertionError(f"a restored block differs from the "
                                     f"victim's original in {k}")
        checked.append(nw)
        return covered

    cm.swap_out, cm.restore_swap = watched_swap_out, watched_restore
    return checked


def parity_memory(K, cfg, flat, lcfg, devices, arms=("lending", "paging")):
    """Phase 3, the memory features, on ``cuda`` and on ``cpu`` (virtual
    clock, fp32), the ``arms`` of: (a) lending (``over_admit=2.0``) in a
    7-block pool with a raw host tier, every restored block checked
    bit-equal to the victim's (``watch_restores``), (b) adapter paging, 6
    adapters of true ranks 4 and 8 on a 4-slot bank.  Tokens,
    ``swap_decisions``, preemptions, the ``kv_*`` counters, adapter
    swap-ins and steps must be equal on the two devices."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    from repro_torch.serving.request import Request
    ad = {f"ad{i}": numpy_adapter(cfg, lcfg, seed=30 + i) for i in range(6)}
    rng = np.random.default_rng(11)
    lend_prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
                    for _ in range(3)]
    page_prompts = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
                    for _ in range(12)]
    arms = {arm: setup for arm, setup in {
        "lending": (dict(capacity=4, pf_capacity=2, s_max=64,
                         block_size=16, n_blocks=8, over_admit=2.0,
                         kv_host_blocks=8),
                    [("ad0", p, 40, 0.1 * i)
                     for i, p in enumerate(lend_prompts)], 1),
        "paging": (dict(capacity=4, pf_capacity=2, s_max=64, block_size=16,
                        n_blocks=48, adapter_paging=True),
                   [(f"ad{i % 6}", p, 6, 0.02 * i)
                    for i, p in enumerate(page_prompts)], 6)}.items()
        if arm in arms}
    for arm, (ecfg, trace, n_ad) in arms.items():
        runs = {}
        for dev in devices:
            params = params_from_numpy(flat, device=dev)
            store = AdapterStore(cfg, lcfg, device=dev, dtype=torch.float32)
            eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                                EngineConfig(virtual_time=True, **ecfg))
            for i in range(n_ad):
                name = f"ad{i}"
                store.load(name, {"layers": bank_from_numpy(
                    ad[name], device=dev)["layers"]}, evict=True,
                    rank=(4, 8)[i % 2])
            for rid, (name, p, max_new, at) in enumerate(trace):
                eng.submit(Request(rid=rid, prompt=p, adapter=name,
                                   max_new_tokens=max_new, arrival=at))
            restored = watch_restores(eng.cachemgr)
            reset_counts(K)
            eng.run(max_ticks=10000)
            m = eng.metrics
            runs[dev] = dict(
                tokens={r.rid: list(r.output) for r in eng.finished},
                swap_decisions=eng.swap_decisions, steps=m.steps,
                preemptions=m.preemptions, swap_ins=m.adapter_swap_ins,
                kv={k: getattr(eng.cachemgr, k) for k in KV_COUNTERS},
                pristine=eng.cachemgr.pristine, launches=read_counts(K),
                restored=sum(restored), tiering=eng.kv_tiering)
        got, want = runs[devices[0]], runs[devices[1]]
        for key in ("tokens", "swap_decisions", "steps", "preemptions",
                    "swap_ins", "kv", "pristine"):
            if got[key] != want[key]:
                raise AssertionError(f"parity {arm}: {key} differs: cuda "
                                     f"{got[key]} cpu {want[key]}")
        if len(got["tokens"]) != len(trace) or not got["pristine"]:
            raise AssertionError(f"parity {arm}: not every request finished"
                                 f" or the pool is not pristine")
        # a Mamba pattern's engine keeps recompute-only preemption: its
        # host tier takes no swap-out
        swapped = (got["kv"]["kv_swap_outs"] and got["kv"]["kv_restores"]
                   and got["restored"]) if got["tiering"] \
            else not got["kv"]["kv_swap_outs"]
        if arm == "lending" and not (got["preemptions"] and swapped):
            raise AssertionError(f"parity lending: no preemption, or the "
                                 f"swap-outs and restores are not as the "
                                 f"host tier's gate says: {got}")
        if arm == "paging" and not got["swap_ins"]:
            raise AssertionError("parity paging: no adapter swap-in")
        if devices[0] == "cuda":
            check_routes(f"parity {arm} {cfg.name}", cfg, got["launches"],
                         ("smlm", "bgmv", "decode"))
        print(f"parity: {arm} {cfg.name} {ecfg}, cuda==cpu tokens for "
              f"{len(trace)} requests, steps={got['steps']} preemptions="
              f"{got['preemptions']} swap_decisions="
              f"{len(got['swap_decisions'])} kv={got['kv']} "
              f"host_tier_swaps={got['tiering']} "
              f"blocks_restored_bit_equal={got['restored']} "
              f"adapter_swap_ins={got['swap_ins']} cuda launches="
              f"{ {k: got['launches'][k] for k in MEMORY_COUNTERS} } ok")


FLEET_COST = dict(fixed=1e-3, prefill_per_tok=1e-4)   # prefill-bound regime


def check_fleet(fleet):
    """The fleet index is a bijection with the replicas' local indexes and
    every replica's pool drained pristine."""
    fleet.index.check_bijection()
    if not all(e.cachemgr.pristine for e in fleet.engines):
        raise AssertionError("fleet: a replica's pool did not drain "
                             "pristine")


def parity_fleet(K, cfg, flat, lcfg, devices, replicas=3,
                 policies=("affinity", "round-robin")):
    """Phase 3, the fleet, on ``cuda`` and on ``cpu`` (virtual clock,
    fp32): ``tests/test_fleet.py``'s trace (6 requests on a 48-token shared
    head, ``CostModel(fixed=1e-3, prefill_per_tok=1e-4)``) through one
    engine and through ``replicas`` replicas under each of ``policies``.
    Tokens equal the single engine's on each device and are equal across
    devices, as are ``routed``, ``remote_fetch_blocks``, ``hash_hits`` and
    steps; round-robin fetches; the fleet index is a bijection and every
    pool drains pristine; then one more block imported between two
    replicas is equal to its source in every leaf
    (``import_one_block``)."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
    from repro_torch.models.model import STATE_KEYS, cache_leaves
    from repro_torch.serving.clock import CostModel
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    from repro_torch.serving.request import Request
    ad = numpy_adapter(cfg, lcfg, seed=40)
    head = np.arange(48, dtype=np.int32) % cfg.vocab

    def trace():
        rng = np.random.default_rng(0)
        return [Request(rid=i, prompt=np.concatenate([head, rng.integers(
            0, cfg.vocab, rng.integers(4, 12)).astype(np.int32)]),
            adapter="serve", max_new_tokens=6, arrival=0.05 * i)
            for i in range(6)]

    ecfg = EngineConfig(capacity=4, pf_capacity=2, s_max=96, block_size=16,
                        virtual_time=True, cost=CostModel(**FLEET_COST))
    runs = {}
    for dev in devices:
        params = params_from_numpy(flat, device=dev)
        adapters = {"serve": {"layers": bank_from_numpy(
            ad, device=dev)["layers"]}}

        def model():
            return mixed_model(cfg, params, adapters, lcfg,
                               torch.device(dev), torch.float32)

        eng = UnifiedEngine(model(), ecfg)
        for r in trace():
            eng.submit(r)
        eng.run(max_ticks=8000)
        single = {r.rid: list(r.output) for r in eng.finished}
        if len(single) != 6 or not eng.cachemgr.pristine:
            raise AssertionError(f"parity fleet {dev}: the single engine "
                                 f"did not finish pristine")
        for policy in policies:
            fleet = build_fleet(model(), ecfg, FleetConfig(
                replicas=replicas, router=RouterConfig(policy=policy)))
            for r in trace():
                fleet.submit(r)
            reset_counts(K)
            fm = fleet.run()
            launches = read_counts(K)
            check_fleet(fleet)
            tokens = {r.rid: list(r.output) for e in fleet.engines
                      for r in e.finished}
            if tokens != single:
                raise AssertionError(f"parity fleet {policy} {dev}: tokens "
                                     f"differ from one engine's: {tokens} "
                                     f"vs {single}")
            runs[dev, policy] = dict(
                tokens=tokens, routed=dict(fleet.routed),
                remote_fetch_blocks=fm.remote_fetch_blocks,
                hash_hits=fm.hash_hits, steps=fm.steps,
                remote_fetch_time=fm.remote_fetch_time, launches=launches,
                imported=import_one_block(fleet))
    blocks = "/".join(k for k in cache_leaves(cfg) if k not in STATE_KEYS)
    state = "/".join(k for k in cache_leaves(cfg) if k in STATE_KEYS)
    kept = f" (state rows {state} untouched)" if state else ""
    for policy in policies:
        got, want = runs[devices[0], policy], runs[devices[1], policy]
        for key in ("tokens", "routed", "remote_fetch_blocks", "hash_hits",
                    "steps"):
            if got[key] != want[key]:
                raise AssertionError(f"parity fleet {policy}: {key} "
                                     f"differs: {devices[0]} {got[key]} "
                                     f"{devices[1]} {want[key]}")
        if policy == "round-robin" and not got["remote_fetch_blocks"]:
            raise AssertionError("parity fleet round-robin: no block was "
                                 "fetched")
        if devices[0] == "cuda":
            check_routes(f"parity fleet {policy} {cfg.name}", cfg,
                         got["launches"], ("smlm", "bgmv", "decode"))
        print(f"parity: fleet {cfg.name} {policy} replicas={replicas} (6 "
              f"requests, 48-token shared head, CostModel fixed=1e-3 "
              f"prefill_per_tok=1e-4), "
              f"cuda==cpu==single-engine tokens, routed={got['routed']} "
              f"remote_fetch_blocks={got['remote_fetch_blocks']} "
              f"hash_hits={got['hash_hits']} steps={got['steps']} "
              f"remote_fetch_time_virtual_s={got['remote_fetch_time']:.6g} "
              f"bijection=True pristine=True, import_block {got['imported']}"
              f" equal in {blocks}{kept}, cuda launches="
              f"{ {k: got['launches'][k] for k in MEMORY_COUNTERS} } ok")


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


def full_width(K, cfg, weights, dev, measured, head=128, max_new=16,
               seed=0):
    """Phase 4: the plain serving path; returns its counts and outputs.
    Keeps wave 1's cold prefill tick and the decode-only ticks by their
    rows in ``measured`` (phase 14's ``costs:`` lines): (seconds, enqueue
    seconds, device wait seconds) each."""
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
    cold = sum(len(r.prompt) for r in waves[0])
    measured["prefill"] = [(t, e, w) for t, p, _, e, w in ticks
                           if p == cold]
    measured["decode"] = {}
    for t, p, d, e, w in ticks:
        if d and not p:
            measured["decode"].setdefault(d, []).append((t, e, w))
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


def ms_stats(ts):
    ms = [t * 1e3 for t in ts]
    return (f"n={len(ms)} mean={np.mean(ms):.3f} p50={np.median(ms):.3f}"
            if ms else "n=0")


def full_train(K, cfg, weights, dev, waves, plain, measured, n_rows=16,
               max_new=16, repeats=3):
    """Phase 8: two trainers (``tr0`` on ``alpaca_like``, ``tr1`` on
    ``gsm8k_like`` rows, full vocab) co-run with phase 4's two waves at
    full width, beside serve-only runs of the same waves (before and
    after); then one grad step through the kernels against the same step
    through the plain versions on the card.  Returns the mixed run's
    launch counts; the profiled grad step and ``repeats`` more, timed, go
    into ``measured["grad_step"]``."""
    from repro_torch.core import flow
    from repro_torch.core.unified import make_grad_step
    from repro_torch.core.virtualization import MixedLoraModel
    from repro_torch.models.stream import UnifiedBatch
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    params, store, _ = weights
    for i in range(2):
        g = torch.Generator(device=dev)
        g.manual_seed(200 + i)
        store.load_random(f"tr{i}", g, gaussian_b=True)
    slots = trainer_slots(store)
    bank0 = slot_leaves(store, slots)

    def run(train):
        eng = UnifiedEngine(MixedLoraModel(cfg, params, store),
                            EngineConfig(capacity=8, pf_capacity=4,
                                         s_max=512))
        if train:
            add_trainers(eng, cfg.vocab, n_rows)
        flags = []
        for name in ("forward_step", "grad_step"):
            def wrapped(*a, _step=getattr(eng, name)):
                out = _step(*a)
                res = out.out if hasattr(out, "grads") else out
                flags.append(torch.stack([
                    torch.isfinite(v).all()
                    for v in (res.pf_logits, res.dec_logits,
                              res.ft_loss_sum) if v is not None]).all())
                return out
            setattr(eng, name, wrapped)
        # host time of each grad step and optimizer apply, each ending in
        # a synchronize (the tick's loss read would sync a moment later)
        spent = {"grad_step": [], "apply_step": []}
        for name in spent:
            def timed(*a, _f=getattr(eng, name), _k=name):
                t0 = time.perf_counter()
                out = _f(*a)
                torch.cuda.synchronize()
                spent[_k].append(time.perf_counter() - t0)
                return out
            setattr(eng, name, timed)
        m, ticks = eng.metrics, []

        def tick():
            p0, d0 = m.prefill_tokens, m.decode_tokens
            f0 = m.finetune_tokens + m.eval_tokens
            t = time.perf_counter()
            eng.tick()
            torch.cuda.synchronize()
            ticks.append((time.perf_counter() - t, m.prefill_tokens - p0,
                          m.decode_tokens - d0,
                          m.finetune_tokens + m.eval_tokens - f0))

        run_waves(eng, tick, copies(waves[:2]))
        while eng.trainers_pending():
            tick()
        eng.run(max_ticks=1)      # flushes partial accumulation windows
        out = check_drained(eng, flags, 8, max_new)
        return eng, ticks, out, spent

    _, serve_a, _, _ = run(False)
    reset_counts(K)
    eng, ticks, out, spent = run(True)
    counts = read_counts(K)
    _, serve_b, _, _ = run(False)
    if counts["smlm_wgrad"] == 0:
        raise AssertionError(f"smlm_wgrad never launched: {counts}")
    mixed = [t for t in ticks if t[3] and (t[1] or t[2])]
    if not mixed:
        raise AssertionError("no tick carried ft rows beside serving rows")
    dec = lambda ts: [t for t, p, d, *_ in ts if d and not p]
    ft_ticks = [t for t in ticks if t[3]]
    m = eng.metrics
    changed = float((slot_leaves(store, slots) != bank0).float().mean())
    same = sum(int(a == b) for rid in out
               for a, b in zip(out[rid], plain[rid]))
    lr = eng.ecfg.opt.lr
    print(f"train: {cfg.name} bf16 2 trainers (alpaca_like, gsm8k_like, "
          f"{n_rows} rows each, 2 rows a micro-batch, accum 2, 1 epoch, "
          f"lr={lr:g}) with phase 4's waves: ticks={len(ticks)} "
          f"mixed_ticks={len(mixed)} ft_only_ticks="
          f"{sum(1 for t in ticks if t[3] and not (t[1] or t[2]))} "
          f"decode_tick_ms serve_only_before: {ms_stats(dec(serve_a))}; "
          f"mixed_run: {ms_stats(dec(ticks))}; its ticks with ft rows: "
          f"{ms_stats([t for t, p, d, f in ticks if d and not p and f])}; "
          f"serve_only_after: {ms_stats(dec(serve_b))} "
          f"mixed_tick_ms: {ms_stats([t[0] for t in mixed])} "
          f"finetune_tokens={m.finetune_tokens} eval_tokens={m.eval_tokens}"
          f" ft_tokens_per_s="
          f"{m.finetune_tokens / sum(t[0] for t in ft_ticks):.3f} "
          f"(train tokens over the ticks with ft rows) ft_tick_ms: "
          f"{ms_stats([t[0] for t in ft_ticks])} of which grad_step_ms: "
          f"{ms_stats(spent['grad_step'])}; optimizer apply_ms: "
          f"{ms_stats(spent['apply_step'])} optimizer_steps="
          f"{[t.optimizer_steps for t in eng.trainers.values()]} "
          f"bank_elements_changed_share={changed:.4f} (trained slots) "
          f"tokens_equal_to_plain={same}/{8 * max_new} launches="
          f"{ {k: counts[k] for k in ('smlm', 'bgmv', 'smlm_wgrad')} } "
          f"finite=True pristine=True ok")
    for name, tr in eng.trainers.items():
        print(f"train: {name} train_losses="
              f"{[round(x, 4) for x in tr.train_losses]} eval_losses="
              f"{[round(x, 4) for x in tr.eval_losses]}")
    # one grad step (ft rows only), profiled; then through the kernels and
    # through the plain versions on the card, in fp32 (params and bank cast
    # on the card), each grad leaf within TOL[fp32] of the leaf's max.  The
    # bf16 step's differences are printed beside it, not gated: the two
    # paths round the forward differently, and a third path (the SMLM
    # kernel's forward, the plain backward) shows what that rounding alone
    # does to the grads
    rows = [flow.FTRow(tokens=tok, labels=lab, slot=tr.slot, trainer=name)
            for name, tr in eng.trainers.items()
            for tok, lab in tr.train_data[:2]]
    del eng
    batch = UnifiedBatch(ft=flow.plan_ft(rows, flow.FlowConfig(), dev))
    step = make_grad_step(cfg, block_t=K["block_t"])
    ref, ops = K["ref"], K["ops"]

    class Plain:
        @staticmethod
        def apply(x, a, b, ids, scale, bt, n_ft):
            return ref.smlm_ref(x, a, b, ids, scale, bt)

    class KernelForward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, a, b, ids, scale, bt, n_ft):
            ctx.save_for_backward(x, a, b, ids, scale)
            ctx.bt = bt
            return K["smlm"](x, a, b, ids, scale, block_t=bt)

        @staticmethod
        def backward(ctx, dy):
            x, a, b, ids, scale = ctx.saved_tensors
            with torch.enable_grad():
                leaves = [v.detach().requires_grad_() for v in (x, a, b)]
                got = torch.autograd.grad(
                    ref.smlm_ref(*leaves, ids, scale, ctx.bt), leaves, dy)
            return (*got, None, None, None, None)

    def grads(fn, prm, bank):
        """The step's loss and grads with ``ops.SMLMFunction`` replaced by
        ``fn`` (None: the kernels'), checking who launched smlm_wgrad."""
        saved, n0 = ops.SMLMFunction, K["smlm_wgrad"].launches
        ops.SMLMFunction = fn or saved
        try:
            res = step(prm, bank, store.scale, batch, None)
        finally:
            ops.SMLMFunction = saved
        if (K["smlm_wgrad"].launches > n0) != (fn is None):
            raise AssertionError("smlm_wgrad launched by the wrong path")
        return res.loss, res.grads

    def diff(g1, g2):
        """Worst leaf max|g1 - g2| / max|g2| and relative Frobenius."""
        worst = fro = 0.0
        for l1, l2 in zip(g1["layers"], g2["layers"]):
            for t_ in l1:
                for ab in ("a", "b"):
                    a_, b_ = l1[t_][ab].float(), l2[t_][ab].float()
                    if not torch.isfinite(a_).all():
                        raise AssertionError(f"grad {t_}/{ab} not finite")
                    worst = max(worst, float((a_ - b_).abs().max())
                                / max(float(b_.abs().max()), 1e-30))
                    fro = max(fro, float((a_ - b_).norm())
                              / max(float(b_.norm()), 1e-30))
        return worst, fro

    from torch.profiler import ProfilerActivity, profile
    grads(None, params, store.bank)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lk, gk = grads(None, params, store.bank)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, names, by = device_top(prof)
    wg, d2d = by("smlm_wgrad"), by("Memcpy DtoD")
    again = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        grads(None, params, store.bank)
        torch.cuda.synchronize()
        again.append(time.perf_counter() - t0)
    measured["grad_step"] = dict(rows=len(rows),
                                 tokens=int(batch.ft.mask.sum()),
                                 wall_ms=wall_ms, busy_ms=busy_ms,
                                 again=again)
    print(f"profile: grad step of {len(rows)} ft rows "
          f"({batch.ft.tokens.numel()} tokens), wall_ms={wall_ms:.3f} "
          f"device_busy_ms={busy_ms:.3f} busy_share="
          f"{busy_ms / wall_ms:.4f} smlm_wgrad_ms={wg:.3f} "
          f"smlm_wgrad_share_of_busy={wg / max(busy_ms, 1e-9):.4f} "
          f"d2d_copy_ms={d2d:.3f} top: {names}")
    lp, gp = grads(Plain, params, store.bank)
    lm, gm = grads(KernelForward, params, store.bank)
    w16, f16 = diff(gk, gp)
    wfw, ffw = diff(gm, gp)
    del gk, gp, gm
    torch.cuda.empty_cache()
    from repro_torch.training.optimizer import tree_map
    f32 = lambda v: v.float()
    p32, b32 = tree_map(f32, params), tree_map(f32, store.bank)
    lk32, gk = grads(None, p32, b32)
    lp32, gp = grads(Plain, p32, b32)
    worst, fro = diff(gk, gp)
    del p32, b32, gk, gp
    torch.cuda.empty_cache()
    if worst > TOL[torch.float32]:
        raise AssertionError(f"fp32 grads: worst leaf max_abs_err / leaf "
                             f"max {worst:.3e} > {TOL[torch.float32]:g}")
    print(f"train: one grad step ({len(rows)} ft rows, "
          f"{batch.ft.tokens.numel()} tokens, {cfg.n_layers} layers), "
          f"kernels vs plain versions on the card: fp32 loss "
          f"{float(lk32):.6f} vs {float(lp32):.6f}, worst leaf "
          f"max_abs_err / leaf max {worst:.3e} tol={TOL[torch.float32]:g} "
          f"(worst relative Frobenius {fro:.3e}); bf16, not gated: loss "
          f"{float(lk):.5f} vs {float(lp):.5f}, worst leaf max_abs_err / "
          f"leaf max {w16:.3e} (relative Frobenius {f16:.3e}); bf16 with "
          f"the SMLM kernel's forward and the plain backward vs plain, the "
          f"forward's rounding alone: loss {float(lm):.5f}, {wfw:.3e} "
          f"({ffw:.3e}) ok")
    return counts


def long_context(K, cfg, weights, dev, measured, prompt=3000, max_new=16,
                 seed=1):
    """Phase 6: capacity 2, s_max 4096, two ~3000-token prompts, without
    and with speculation: the shape where ``choose`` splits the walk.  The
    profiled prefill of one more ``prompt``-token request goes into
    ``measured["long_prefill"]``."""
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
            extra = Request(rid=9, prompt=rng.integers(
                0, cfg.vocab, prompt).astype(np.int32), adapter="lora0",
                max_new_tokens=2)
            measured["long_prefill"] = profile_prefill(eng, tick, ticks,
                                                       extra, "long")
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


def profile_prefill(eng, tick, ticks, req, label):
    """Profile the prefill tick(s) of one more request (after the main
    path's counters were read), then drain it unprofiled: the tick's wall
    time, the device's busy time in it, SMLM's share of that, and the top
    device operations.  Returns (wall ms, device busy ms, the prefill
    ticks' records of ``timed_engine``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.request import State
    torch.cuda.synchronize()
    req.arrival = eng.clock.now()
    eng.submit(req)
    n, first = 0, len(ticks)
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
    recs = [(t, e, w) for t, _, _, e, w in ticks[first:first + n]]
    while eng.waiting or eng.active or eng.prefilling or eng.future:
        tick()
    return wall_ms, busy_ms, recs


# ------------------------------------------- phases 9-10: memory features
def pinned_copy_ms(nbytes, dev, iters=5):
    """Host-clock ms of a pinned copy of ``nbytes`` each way, D2H and H2D,
    ending in a synchronize (mean of ``iters`` after a warm-up)."""
    host = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
    card = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    out = []
    for src, dst in ((card, host), (host, card)):
        dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            dst.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / iters * 1e3)
    return tuple(out)


def watch_tiers(eng, log):
    """Wrap the manager's swap-out and restore: each transfer's host-clock
    ms (synchronized before and after) and bytes go into ``log``, the
    victim's blocks are kept on the card at the swap-out, and the restore
    is checked against them: bit-equal for the raw tier; for the int8
    tier within half a step of each element's scale before the cast and
    equal to the plain dequant of the stored payload."""
    cm = eng.cachemgr
    swap_out, restore = cm.swap_out, cm.restore_swap
    kept = {}

    def timed_swap_out(slot):
        nb = cm.swap_payload_blocks(slot)
        idx = torch.tensor(cm.tables[slot][:nb], device=cm.device)
        orig = {k: v.index_select(1, idx) for k, v in cm.cache.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sid = swap_out(slot)
        torch.cuda.synchronize()
        if sid is not None:
            log["d2h"].append(((time.perf_counter() - t0) * 1e3,
                               nb * cm.host_block_bytes, nb))
            entry = cm.host_pool._swap_sets[sid]
            kept[sid] = (orig, cm.host_payload(entry) if cm.host_quant
                         else None)
        return sid

    def timed_restore(slot, sid):
        orig, stored = kept.pop(sid)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b0 = cm.kv_restore_bytes
        covered = restore(slot, sid)
        torch.cuda.synchronize()
        nbytes = cm.kv_restore_bytes - b0
        if not nbytes:
            return covered
        nw = nbytes // cm.host_block_bytes
        shared = min(cm.shared_count.get(slot, 0), len(cm.tables[slot]))
        log["h2d"].append(((time.perf_counter() - t0) * 1e3, nbytes, nw))
        idx = torch.tensor(cm.tables[slot][shared:shared + nw],
                           device=cm.device)
        for k in cm.cache:
            got = cm.cache[k].index_select(1, idx)
            want = orig[k][:, shared:shared + nw]
            if not cm.host_quant:
                if not torch.equal(got, want):
                    raise AssertionError("a restored block differs from "
                                         "the victim's original")
                continue
            q = stored[k]["_q8"][:, shared:shared + nw].to(cm.device)
            sc = stored[k]["_qs"][:, shared:shared + nw].to(cm.device)
            deq = q.float() * sc
            # half a step, plus the fp32 rounding of x / s and q * s
            err = (deq - want.float()).abs() - sc * (0.5 + 2e-5)
            if float(err.max()) > 0:
                raise AssertionError("int8 round trip beyond half a step")
            if not torch.equal(got, deq.to(got.dtype)):
                raise AssertionError("restore differs from the plain "
                                     "dequant of the stored payload")
            log["q8_err_steps"] = max(log.get("q8_err_steps", 0.0), float(
                ((deq - want.float()).abs() / sc).max()))
        log["checked"] += nw
        return covered

    cm.swap_out, cm.restore_swap = timed_swap_out, timed_restore


def tier_requests(cfg, rng, n=8, prompt=128, max_new=96):
    from repro_torch.serving.request import Request
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt)
                    .astype(np.int32), adapter=f"lora{i % 2}",
                    max_new_tokens=max_new) for i in range(n)]


def measured_cost(dev, block_bytes, prefill_per_tok):
    """``CostModel`` with this card's pinned copy rates for one block and
    the reference run's prefill seconds per token."""
    from repro_torch.serving.clock import CostModel
    d2h, h2d = pinned_copy_ms(block_bytes, dev)
    return CostModel(d2h_per_byte=d2h * 1e-3 / block_bytes,
                     h2d_per_byte=h2d * 1e-3 / block_bytes,
                     prefill_per_tok=prefill_per_tok), (d2h, h2d)


def full_tiers(K, cfg, weights, dev, n_blocks=49, max_new=96, seed=2):
    """Phase 9: 8 requests of distinct 128-token prompts and 96 new tokens
    at t=0 through (A) the default pool, (B) ``n_blocks`` with
    ``over_admit=2.0`` (recompute preemption), (C) as B with a 32-block host
    tier and (D) as C in int8; C and D with a cost model of this card's
    copy rates and A's prefill time; then a demote/rehydrate trace with
    C's tier.  Returns the launch counts of the phase and A's outputs."""
    from repro_torch.serving.clock import CostModel
    from repro_torch.serving.kvcache import swap_beats_recompute
    from repro_torch.serving.request import Request, State
    base = dict(capacity=8, pf_capacity=4, s_max=512, virtual_time=True)
    lend = dict(base, n_blocks=n_blocks, over_admit=2.0)
    arms = {"A": dict(base), "B": dict(lend),
            "C": dict(lend, kv_host_blocks=32),
            "D": dict(lend, kv_host_blocks=32, kv_host_quant=True)}
    rng = np.random.default_rng(seed)
    reqs = tier_requests(cfg, rng, max_new=max_new)
    outs, counts, engs = {}, {k: 0 for k in COUNTERS}, {}
    cost = None
    for arm, ecfg in arms.items():
        if arm in ("C", "D"):
            ecfg = dict(ecfg, cost=cost)
        eng, seen, ticks, tick = timed_engine(cfg, weights, **ecfg)
        log = {"d2h": [], "h2d": [], "checked": 0}
        if arm in ("C", "D"):
            watch_tiers(eng, log)
        peak = [0]
        fresh = copies([reqs])

        def watched():
            tick()
            peak[0] = max(peak[0], len(eng.active) + len(eng.prefilling))

        reset_counts(K)
        run_waves(eng, watched, fresh)
        for k, v in read_counts(K).items():
            counts[k] += v
        outs[arm] = check_drained(eng, seen, 8, max_new)
        m, cm = eng.metrics, eng.cachemgr
        if arm == "A":
            pf = ([(t, p) for t, p, d, *_ in ticks if p and not d]
                  or [(t, p) for t, p, *_ in ticks if p])
            per_tok = sum(t for t, _ in pf) / sum(p for _, p in pf)
            cost, rates = measured_cost(dev, cm.adapter_block_bytes, per_tok)
            print(f"tiers: cost model from this run: prefill_per_tok="
                  f"{per_tok:.6e} s ({len(pf)} prefill ticks), "
                  f"pinned copy of one {cm.adapter_block_bytes}-byte block "
                  f"d2h_ms={rates[0]:.4f} h2d_ms={rates[1]:.4f} -> "
                  f"d2h_per_byte={cost.d2h_per_byte:.4e} h2d_per_byte="
                  f"{cost.h2d_per_byte:.4e} (default: d2h "
                  f"{CostModel().d2h_per_byte:.1e} h2d "
                  f"{CostModel().h2d_per_byte:.1e} prefill_per_tok "
                  f"{CostModel().prefill_per_tok:.1e})")
        elif m.preemptions == 0:
            raise AssertionError(f"tiers {arm}: no preemption")
        dec = eng.swap_decisions
        default = sum(int(d["blocks"] > 0 and swap_beats_recompute(
            d["stored_bytes"], d["recompute_tokens"], CostModel()))
            for d in dec)
        if arm in ("C", "D") and not (m.kv_swap_outs and m.kv_restores
                                      and log["checked"]):
            raise AssertionError(f"tiers {arm}: no swap-out or restore "
                                 f"checked ({m.kv_swap_outs}, "
                                 f"{m.kv_restores}, {log['checked']})")
        same, same_b = (sum(int(a == b) for rid in outs[arm]
                            for a, b in zip(outs[arm][rid], outs[ref][rid]))
                        for ref in ("A", "B" if "B" in outs else "A"))
        print(f"tiers: {arm} {cfg.name} bf16 n_blocks={cm.allocator.n_blocks}"
              f" over_admit={cm.over_admit} host_blocks="
              f"{ecfg.get('kv_host_blocks', 0)} quant={cm.host_quant} "
              f"host_block_bytes={cm.host_block_bytes} requests=8 "
              f"tokens_each={max_new} steps={m.steps} admitted_peak="
              f"{peak[0]} lent_blocks_peak={m.lent_blocks_peak} "
              f"preemptions={m.preemptions} recomputed_tokens="
              f"{m.preempted_tokens_recomputed} swap_decisions taken="
              f"{sum(int(d['chose_swap']) for d in dec)} skipped="
              f"{sum(int(not d['chose_swap']) for d in dec)} "
              f"default_constants_would_take={default}/{len(dec)} "
              f"swap_outs={m.kv_swap_outs} swap_out_bytes="
              f"{m.kv_swap_out_bytes} restores={m.kv_restores} "
              f"restore_bytes={m.kv_restore_bytes} restored_tokens="
              f"{m.kv_restored_tokens} host_bytes_peak={m.host_bytes_peak} "
              f"blocks_checked={log['checked']} "
              f"{tick_stats(ticks)} tokens_equal_to_A={same}/{8 * max_new} "
              f"tokens_equal_to_B={same_b}/{8 * max_new} "
              f"finite=True pristine=True ok")
        for way in ("d2h", "h2d"):
            for ms, nbytes, nb in log[way]:
                ref = pinned_copy_ms(nbytes, dev)[way == "h2d"]
                print(f"transfer: {arm} {way} blocks={nb} bytes={nbytes} "
                      f"ms={ms:.4f} GB/s={nbytes / ms / 1e6:.3f} "
                      f"pinned_copy_ms={ref:.4f} pinned_GB/s="
                      f"{nbytes / ref / 1e6:.3f}")
        if "q8_err_steps" in log:
            print(f"tiers: {arm} int8 round trip max |err| = "
                  f"{log['q8_err_steps']:.4f} steps (<= 0.5) over "
                  f"{log['checked']} blocks, restore == plain dequant ok")
        engs[arm] = ecfg
        del eng
    # demote/rehydrate: two shared heads under pool pressure with C's tier
    eng, seen, ticks, tick = timed_engine(
        cfg, weights, **dict(base, n_blocks=11, over_admit=2.0,
                             kv_host_blocks=32, cost=cost))
    heads = [rng.integers(0, cfg.vocab, 128).astype(np.int32)
             for _ in range(2)]
    waves = [[Request(rid=100 + 2 * w + i, prompt=np.concatenate(
        [heads[w % 2], rng.integers(0, cfg.vocab, 16).astype(np.int32)]),
        adapter="lora0", max_new_tokens=16) for i in range(2)]
        for w in range(4)]
    reset_counts(K)
    for wave in waves:
        run_waves(eng, tick, [wave])
    for k, v in read_counts(K).items():
        counts[k] += v
    check_drained(eng, seen, 8, 16)
    m = eng.metrics
    if not (m.kv_demotions and m.kv_rehydrated_blocks):
        raise AssertionError(f"demote trace: demotions={m.kv_demotions} "
                             f"rehydrated={m.kv_rehydrated_blocks}")
    print(f"tiers: demote trace, two 128-token heads in 4 waves of 2 "
          f"(n_blocks=11, host_blocks=32): demotions={m.kv_demotions} "
          f"rehydrated_blocks={m.kv_rehydrated_blocks} hash_hits="
          f"{m.hash_hits} reused_prefix_tokens={m.reused_prefix_tokens} "
          f"steps={m.steps} pristine=True ok")
    del eng
    need = ("smlm", "bgmv", "prefill", "decode", "flash")
    if min(counts[k] for k in need) == 0:
        raise AssertionError(f"tiers: a kernel never launched: {counts}")
    differ = [a for a in "BCD" if outs[a] != outs["A"]]
    if differ:
        ref = logged_copy("tiers", cfg, weights, copies([reqs]), outs["A"],
                          **arms["A"])
        for a in differ:
            rows = logged_copy(f"tiers {a}", cfg, weights, copies([reqs]),
                               outs[a], **engs[a])
            divergences(f"tiers {a}", "A", ref, a, rows, 8 * max_new)
    return counts


def paging_store(cfg, dev, dtype, n=12):
    """A 4-slot r=8 bank with ``n`` gaussian-B adapters of alternating true
    ranks 8 and 4, made on the card from seeds (8 of them evicted to host
    by the bank's LRU)."""
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.virtualization import AdapterStore
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), device=dev,
                         dtype=dtype)
    for i in range(n):
        g = torch.Generator(device=dev)
        g.manual_seed(300 + i)
        store.load_random(f"pg{i}", g, gaussian_b=True, evict=True,
                          rank=(8, 4)[i % 2])
    return store


def paging_waves(cfg, rng, n=24, n_ad=12, prompt=64, max_new=32):
    from repro_torch.serving.request import Request
    w = 1.0 / np.arange(1, n_ad + 1)
    pick = rng.choice(n_ad, size=n, p=w / w.sum())
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, prompt)
                    .astype(np.int32), adapter=f"pg{pick[i]}",
                    max_new_tokens=max_new) for i in range(n)]
    return [reqs[i:i + n // 3] for i in range(0, n, n // 3)]


def check_image_round_trip(store, cm):
    """bank slot -> byte image -> pool -> gather -> another bank slot, in
    bf16 at true ranks 4 and 8: bit-exact, columns beyond the rank zero."""
    done = []
    for rank in (8, 4):
        name = f"pg{(8, 4).index(rank)}"
        slot = store.acquire(name)
        if len(store.resident) == store.lcfg.n_slots:
            store.unload(next(n for n in store.resident if n != name))
        image = store._flatten(slot, rank)
        key = f"roundtrip{rank}"
        if not cm.adapter_admit(key, image):
            raise AssertionError("no pool room for the round-trip check")
        got = cm.adapter_gather(key)
        free = next(i for i in range(store.lcfg.n_slots)
                    if i not in store._slots.values())
        store._write_image(free, got, rank)
        for layer in store.bank["layers"]:
            for ab in layer.values():
                if not (torch.equal(ab["a"][free], ab["a"][slot])
                        and torch.equal(ab["b"][free], ab["b"][slot])
                        and not ab["a"][free][:, rank:].any()
                        and not ab["b"][free][rank:].any()):
                    raise AssertionError(f"rank {rank} image round trip "
                                         f"is not bit-exact")
        with torch.no_grad():
            for layer in store.bank["layers"]:
                for ab in layer.values():
                    ab["a"][free].zero_()
                    ab["b"][free].zero_()
        cm.adapter_free(key)
        done.append(f"r{rank}:{image.numel()}B/"
                    f"{cm.adapter_blocks_of(image.numel())}blocks")
    return done


def full_paging(K, cfg, weights, dev, seed=3, max_new=32):
    """Phase 10: 24 requests over 12 adapters (weights 1/(i+1)) in 3 waves
    on a 4-slot bank, with ``adapter_paging`` off (the bank's LRU voids to
    host) and on (adapters page through the KV pool); then the byte-image
    round trip and void/unvoid on the card.  Returns the launch counts."""
    from repro_torch.core.virtualization import MixedLoraModel, VirtualModel
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    params = weights[0]
    dtype = params["embed"].dtype
    ecfg = dict(capacity=8, pf_capacity=4, s_max=512, n_blocks=65,
                virtual_time=True)
    waves = paging_waves(cfg, np.random.default_rng(seed), max_new=max_new)
    outs, counts, stores = {}, {k: 0 for k in COUNTERS}, {}
    for paging in (False, True):
        store = paging_store(cfg, dev, dtype)
        eng, seen, ticks, tick = timed_engine(
            cfg, (params, store, 0), adapter_paging=paging, **ecfg)
        cm = eng.cachemgr
        admits, peak = [], [0]
        if paging:
            admit = cm.adapter_admit

            def timed_admit(name, payload, shed=True):
                fresh = name not in cm.adapter_tables
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ok = admit(name, payload, shed=shed)
                torch.cuda.synchronize()
                if ok and fresh:
                    admits.append(((time.perf_counter() - t0) * 1e3,
                                   int(payload.numel())))
                return ok

            cm.adapter_admit = timed_admit

        def watched():
            tick()
            peak[0] = max(peak[0], cm.adapter_blocks_resident)

        reset_counts(K)
        run_waves(eng, watched, copies(waves))
        for k, v in read_counts(K).items():
            counts[k] += v
        outs[paging] = check_drained(eng, seen, 24, max_new)
        m = eng.metrics
        if paging and not m.adapter_swap_ins:
            raise AssertionError("paging: no adapter swap-in")
        print(f"paging: {'on' if paging else 'off'} {cfg.name} bf16 "
              f"adapters=12 (ranks 8/4) bank_slots=4 n_blocks=65 "
              f"requests=24 tokens_each={max_new} steps={m.steps} "
              f"swap_ins={m.adapter_swap_ins} swap_in_bytes="
              f"{m.adapter_swap_in_bytes} bank_reloads={store.reloads} "
              f"bank_evictions={store.evictions} pool_admits="
              f"{cm.adapter_swap_ins} pool_sheds={cm.adapter_sheds} "
              f"adapter_blocks_resident_peak={peak[0]} resident_hits="
              f"{m.adapter_resident_hits} peak_coresident="
              f"{m.adapter_peak_coresident} {tick_stats(ticks)} "
              f"finite=True pristine=True ok")
        for ms, nbytes in admits:
            ref = pinned_copy_ms(nbytes, dev)[1]
            print(f"transfer: paging swap-in bytes={nbytes} ms={ms:.4f} "
                  f"GB/s={nbytes / ms / 1e6:.3f} pinned_copy_ms={ref:.4f} "
                  f"pinned_GB/s={nbytes / ref / 1e6:.3f}")
        if paging:
            print(f"paging: image round trip bit-exact in bf16 "
                  f"{check_image_round_trip(store, cm)} ok")
        stores[paging] = store
        del eng
    same = sum(int(a == b) for rid in outs[True]
               for a, b in zip(outs[True][rid], outs[False][rid]))
    print(f"paging: tokens_equal_off_vs_on={same}/{24 * max_new}")
    if outs[True] != outs[False]:
        rows = {}
        for paging in (False, True):
            store = paging_store(cfg, dev, dtype)
            rows[paging] = logged_copy(
                f"paging {'on' if paging else 'off'}", cfg,
                (params, store, 0), copies(waves), outs[paging],
                adapter_paging=paging, **ecfg)
        divergences("paging", "off", rows[False], "on", rows[True],
                    24 * max_new)
    # void/unvoid: an adapter voided from the paged run's store and bound
    # into a fresh store on the card serves 4 requests in one batch with
    # bit-identical tokens
    src = stores[False]
    name = src.resident[0]
    voided = MixedLoraModel(cfg, params, src).virtual(name).void()
    fresh = paging_store(cfg, dev, dtype, n=0)
    VirtualModel.unvoid(voided, params, fresh, dev)
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab, 64).astype(np.int32)
               for _ in range(4)]
    toks = []
    reset_counts(K)
    for st in (src, fresh):
        eng = UnifiedEngine(MixedLoraModel(cfg, params, st),
                            EngineConfig(**ecfg))
        from repro_torch.serving.request import Request
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, adapter=name,
                               max_new_tokens=16))
        eng.run(max_ticks=10000)
        toks.append({r.rid: list(r.output) for r in eng.finished})
    for k, v in read_counts(K).items():
        counts[k] += v
    if toks[0] != toks[1] or len(toks[0]) != 4:
        raise AssertionError(f"void/unvoid tokens differ: {toks}")
    print(f"paging: void/unvoid {name} (rank {src._ranks[name]}) into a "
          f"fresh store on {dev}: 4 requests in one batch, 64 tokens "
          f"bit-identical ok")
    if counts["smlm"] == 0 or counts["bgmv"] == 0:
        raise AssertionError(f"paging: SMLM or BGMV never launched: {counts}")
    return counts


# ------------------------------------------------------ phase 11: the fleet
# the smoke's copy of benchmarks/bench_fleet.py's trace (the port imports
# nothing of ``benchmarks``), with 16 new tokens in place of 1
FLEET_REPLICAS = 3
FLEET_TEMPLATES = 3
FLEET_HEAD = 832                    # 26 blocks of 32
FLEET_PROMPT = 1024
FLEET_BLOCK = 32
FLEET_REQUESTS = 18
FLEET_ZIPF = 1.1
FLEET_BURST_AT = 0.2                # seeders publish, then the burst
FLEET_LOAD_PENALTY = 0.25
# arm -> (router policy, remote fetch); "single" is one engine
FLEET_ARMS = {"single": None, "round_robin": ("round-robin", False),
              "affinity": ("affinity", True),
              "rr_fetch": ("round-robin", True)}


def fleet_trace(vocab, seed=0, max_new=16):
    """A seeder per template at t=0 (the router's depth penalty spreads
    them one per replica), then Zipf-drawn template picks arriving at once
    at ``FLEET_BURST_AT``.  Returns the requests and the rid-ordered
    templates."""
    from repro_torch.serving.request import Request
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, FLEET_HEAD).astype(np.int32)
             for _ in range(FLEET_TEMPLATES)]
    w = 1.0 / np.arange(1, FLEET_TEMPLATES + 1) ** FLEET_ZIPF
    picks = rng.choice(FLEET_TEMPLATES, size=FLEET_REQUESTS - FLEET_TEMPLATES,
                       p=w / w.sum())
    templates = list(range(FLEET_TEMPLATES)) + picks.tolist()
    reqs = []
    for rid, t in enumerate(templates):
        tail = rng.integers(0, vocab, FLEET_PROMPT - FLEET_HEAD).astype(
            np.int32)
        reqs.append(Request(rid=rid, prompt=np.concatenate([heads[t], tail]),
                            adapter=f"lora{t}", max_new_tokens=max_new,
                            arrival=0.0 if rid < FLEET_TEMPLATES
                            else FLEET_BURST_AT))
    return reqs, templates


def expected_rr_fetches(templates) -> int:
    """Round-robin with fetch: the first time a replica meets a template
    whose head an earlier request published anywhere, it imports all the
    head's blocks; later meetings adopt locally."""
    seen, seen_on = set(), [set() for _ in range(FLEET_REPLICAS)]
    n = 0
    for rid, t in enumerate(templates):
        rep = rid % FLEET_REPLICAS
        if t in seen and t not in seen_on[rep]:
            n += FLEET_HEAD // FLEET_BLOCK
        seen.add(t)
        seen_on[rep].add(t)
    return n


def fleet_front(cfg, params, dev, dtype, arm):
    """One engine (arm "single") or a fleet of ``FLEET_REPLICAS`` over
    ``params``, with a fresh store of adapters lora0..2 (gaussian B, seeds
    100-102: phase 4's lora0 and lora1 and one more): (front, engines)."""
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.virtualization import AdapterStore, MixedLoraModel
    from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
    from repro_torch.serving.clock import CostModel
    from repro_torch.serving.engine import EngineConfig, UnifiedEngine
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8), device=dev,
                         dtype=dtype)
    for i in range(FLEET_TEMPLATES):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + i)
        store.load_random(f"lora{i}", g, gaussian_b=True)
    model = MixedLoraModel(cfg, params, store)
    ecfg = EngineConfig(capacity=6, pf_capacity=4,
                        s_max=FLEET_PROMPT + FLEET_BLOCK,
                        block_size=FLEET_BLOCK, virtual_time=True,
                        cost=CostModel(**FLEET_COST))
    if FLEET_ARMS[arm] is None:
        eng = UnifiedEngine(model, ecfg)
        return eng, [eng]
    policy, fetch = FLEET_ARMS[arm]
    fleet = build_fleet(model, ecfg, FleetConfig(
        replicas=FLEET_REPLICAS,
        router=RouterConfig(policy=policy, load_penalty=FLEET_LOAD_PENALTY),
        remote_fetch=fetch))
    return fleet, fleet.engines


def fleet_run(K, cfg, params, dev, dtype, arm, max_new=16):
    """One arm: every engine's ticks timed on the host clock (a tick ends
    in the host reading its sampled tokens) and its logits' finiteness
    recorded on the device.  Gates: every request finishes with
    ``max_new`` tokens, every logit is finite, every pool drains pristine,
    the fleet index is a bijection."""
    front, engines = fleet_front(cfg, params, dev, dtype, arm)
    reqs, templates = fleet_trace(cfg.vocab, max_new=max_new)
    seen, ticks = [], []
    for eng in engines:
        seen += [record_logits(eng, keep=False)]
        step, m = eng.tick, eng.metrics

        def tick(step=step, m=m):
            p0, d0 = m.prefill_tokens, m.decode_tokens
            t = time.perf_counter()
            busy = step()
            ticks.append((time.perf_counter() - t, m.prefill_tokens - p0,
                          m.decode_tokens - d0))
            return busy

        eng.tick = tick
    for r in reqs:
        front.submit(r)
    reset_counts(K)
    t0 = time.perf_counter()
    fm = front.run(max_ticks=200000)
    wall = time.perf_counter() - t0
    counts = read_counts(K)
    done = [r for e in engines for r in e.finished]
    if len(done) != FLEET_REQUESTS or any(len(r.output) != max_new
                                          for r in done):
        raise AssertionError(f"fleet {arm}: not every request finished "
                             f"with {max_new} tokens")
    if not bool(torch.stack([f for s in seen for f in s]).all()):
        raise AssertionError(f"fleet {arm}: non-finite logits")
    if front is engines[0]:
        if not front.cachemgr.pristine:
            raise AssertionError("fleet single: the pool did not drain "
                                 "pristine")
    else:
        check_fleet(front)
    return dict(front=front, metrics=fm, wall=wall, ticks=ticks,
                counts=counts, templates=templates,
                out={r.rid: list(r.output) for r in done})


def import_one_block(fleet):
    """One ``import_block`` from replica 0 into replica 1 of ``fleet`` (a
    block of replica 0's index that replica 1 does not hold; replica 1's
    index is flushed if it holds them all): every cache leaf of the target
    block must equal the source block's (``torch.equal``) and the fleet
    index stay a bijection.  Returns (source block, target block)."""
    a, b = fleet.engines[0].cachemgr, fleet.engines[1].cachemgr
    missing = [k for k in a._index if k not in b._index]
    if not missing:
        b.flush_index()
        missing = list(a._index)
    key = missing[0]
    src = a._index[key]
    rows = {k: v.clone() for k, v in b.cache.items()
            if k not in b.block_leaves}
    dst = b.import_block(key, a, src)
    if dst is None:
        raise AssertionError("fleet: import_block found no room")
    for name in a.block_leaves:
        if not torch.equal(b.cache[name][:, dst], a.cache[name][:, src]):
            raise AssertionError(f"fleet: imported block differs from its "
                                 f"source in {name}")
    for name, before in rows.items():
        if not torch.equal(b.cache[name], before):
            raise AssertionError(f"fleet: import_block wrote the state "
                                 f"rows {name}")
    fleet.index.check_bijection()
    return src, dst


def cross_pool_copy(fleet, dev, iters=200):
    """One ``import_block`` between two replicas of ``fleet`` (a head block
    of replica 0 that replica 1 does not hold; replica 1's index is flushed
    if it holds them all) must leave the target block ``torch.equal`` to
    the source block in K and V and the index a bijection.  Then the copy
    of that block (``_copy_block_from``, rewriting the same bytes) timed
    eagerly between CUDA events over ``iters`` calls, beside a ``copy_``
    of a contiguous tensor of the same bytes and the bound (bytes read and
    written over HBM's rate); and the same copy's device time with the
    host's issue cost removed (``time_ms``: the calls captured in a CUDA
    graph).  Returns (per-copy device ms in the graph, per-copy host ms of
    the eager loop, block bytes)."""
    a, b = fleet.engines[0].cachemgr, fleet.engines[1].cachemgr
    src, dst = import_one_block(fleet)
    nbytes = sum(v[:, src].numel() * v.element_size()
                 for v in a.cache.values())

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return (e0.elapsed_time(e1) / iters,
                (time.perf_counter() - t0) * 1e3 / iters)

    ms, host_ms = timed(lambda: b._copy_block_from(a, src, dst))
    graph_ms = time_ms(lambda: b._copy_block_from(a, src, dst), iters)
    x = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    y = torch.empty_like(x)
    flat_ms, _ = timed(lambda: y.copy_(x))
    flat_graph_ms = time_ms(lambda: y.copy_(x), iters)
    for name in a.cache:
        if not torch.equal(b.cache[name][:, dst], a.cache[name][:, src]):
            raise AssertionError("fleet: the timed copies changed the block")
    bound_ms = 2 * nbytes / HBM_BYTES_PER_S * 1e3
    names = "/".join(a.cache)
    layers = next(iter(a.cache.values())).shape[0]
    print(f"fleet: import_block engine 0 block {src} -> engine 1 block {dst}"
          f" {names} torch.equal to the source, bijection=True ok; "
          f"cross-pool copy of one block ({nbytes} bytes: {names}, "
          f"{layers} layers x {nbytes // len(a.cache) // layers} bytes a "
          f"leaf) eager "
          f"between CUDA events over {iters} calls: "
          f"ms={ms:.5f} host_ms={host_ms:.5f} contiguous copy_ of the same "
          f"bytes ms={flat_ms:.5f}; in a CUDA graph (device time, no host "
          f"issue cost) ms={graph_ms:.5f} contiguous {flat_graph_ms:.5f}; "
          f"bound_ms={bound_ms:.5f} (bytes read and written / "
          f"{HBM_BYTES_PER_S:.3g} B/s) bound_share eager="
          f"{bound_ms / ms:.4f} graph={bound_ms / graph_ms:.4f}")
    return graph_ms, host_ms, nbytes


def full_fleet(K, cfg, weights, dev, max_new=16):
    """Phase 11: ``bench_fleet.py``'s trace (3 templates with adapters
    lora0..2 picked by Zipf s=1.1, 18 requests of 1024 tokens: an 832-token
    head plus a random tail, seeders at t=0, the burst at t=0.2) with 16
    new tokens, through one engine and three arms of 3 replicas over
    phase 4's base weights: round_robin without fetch, affinity and
    rr_fetch (round-robin with fetch).  Virtual clock with
    ``CostModel(fixed=1e-3, prefill_per_tok=1e-4)``: at the default
    ``fixed`` of 35 ms fetching needs n >= 187 blocks, so no fetch would
    happen.  Returns the fleet arms' summed launch counts."""
    import gc
    from repro_torch.serving.clock import CostModel
    gc.collect()
    torch.cuda.empty_cache()
    params = weights[0]
    dtype = params["embed"].dtype
    print(f"fleet: {cfg.name} bf16 replicas={FLEET_REPLICAS} requests="
          f"{FLEET_REQUESTS} prompt={FLEET_PROMPT} (head {FLEET_HEAD}) "
          f"templates={FLEET_TEMPLATES} zipf_s={FLEET_ZIPF} tokens_each="
          f"{max_new} capacity=6 pf_capacity=4 block_size={FLEET_BLOCK} "
          f"load_penalty={FLEET_LOAD_PENALTY}; the virtual clock is "
          f"CostModel(fixed=1e-3, prefill_per_tok=1e-4), modeled seconds, "
          f"not the card's (the default fixed=0.035 would fetch only from "
          f"n >= 187 blocks)")
    runs, counts = {}, {k: 0 for k in COUNTERS}
    copy = None
    for arm in FLEET_ARMS:
        run = fleet_run(K, cfg, params, dev, dtype, arm, max_new)
        fm, front = run["metrics"], run["front"]
        if arm != "single":
            for k, v in run["counts"].items():
                counts[k] += v
        pf = [t for t, p, d in run["ticks"] if p]
        dec = [t for t, p, d in run["ticks"] if d and not p]
        routed = getattr(front, "routed", {0: FLEET_REQUESTS})
        same = (sum(int(a == b) for rid in run["out"] for a, b in zip(
            run["out"][rid], runs["single"]["out"][rid]))
            if runs else FLEET_REQUESTS * max_new)
        fetched = fm.remote_fetch_blocks
        if arm == "rr_fetch":
            want = expected_rr_fetches(run["templates"])
            if fetched != want:
                raise AssertionError(f"fleet rr_fetch fetched {fetched} "
                                     f"blocks, the analytic count is {want}")
        elif arm == "round_robin" and fetched:
            raise AssertionError("fleet round_robin fetched with fetch off")
        print(f"fleet: {arm} wall_s={run['wall']:.4f} (host clock) "
              f"prefill_ticks {ms_stats(pf)} ms decode_ticks {ms_stats(dec)}"
              f" ms "
              f"computed_tokens={fm.prefill_tokens} (blocks "
              f"{fm.prefill_tokens / FLEET_BLOCK:.2f}) reused_blocks="
              f"{fm.reused_prefix_tokens // FLEET_BLOCK} fetched_blocks="
              f"{fetched}"
              + (f" (analytic {expected_rr_fetches(run['templates'])})"
                 if arm == "rr_fetch" else "")
              + f" hash_hits={fm.hash_hits} routed={routed} steps={fm.steps}"
              f" virtual_elapsed_s={fm.elapsed:.6g} (modeled) "
              f"tokens_equal_to_single={same}/{FLEET_REQUESTS * max_new} "
              f"launches={ {k: run['counts'][k] for k in MEMORY_COUNTERS} } "
              f"finite=True pristine=True"
              + (" bijection=True" if arm != "single" else "") + " ok")
        if arm == "rr_fetch":
            copy = cross_pool_copy(front, dev)
        run.pop("front")
        runs[arm] = run
        del front, fm
        gc.collect()
        torch.cuda.empty_cache()
    # paged decode runs as itself or, where the split table picks ns > 1
    # at the fleet's table width (nbt 33), as its split-K form: partials
    # and the merge
    need = ("smlm", "bgmv", "prefill", "flash")
    decode = counts["decode"] + counts["partials"]
    if min(counts[k] for k in need) == 0 or decode == 0 \
            or counts["partials"] != counts["merge"]:
        raise AssertionError(f"fleet: a kernel never launched on the fleet "
                             f"path: {counts}")
    print(f"fleet: launches over the three fleet arms "
          f"{ {k: counts[k] for k in need} } paged decode "
          f"{counts['decode']} + its split-K form {counts['partials']} "
          f"(partials, each with a merge) ok")
    # the fetch rule at this card's numbers: the single engine's prefill
    # seconds per token against the measured copy of one block
    pf = [(t, p) for t, p, d in runs["single"]["ticks"] if p and not d]
    per_tok = sum(t for t, _ in pf) / sum(p for _, p in pf)
    n = FLEET_HEAD // FLEET_BLOCK
    for label, per_block in (("device (graph)", copy[0] * 1e-3),
                             ("eager host", copy[1] * 1e-3)):
        recompute = n * FLEET_BLOCK * per_tok
        picks = " ".join(
            f"fixed={fixed:g}: {fixed + n * per_block:.6g} s -> "
            f"{'fetch' if fixed + n * per_block < recompute else 'recompute'};"
            for fixed in (CostModel().fixed, FLEET_COST["fixed"], 0.0))
        print(f"fleet: fetch rule at this card's numbers ({label} copy ms "
              f"per block {per_block * 1e3:.5f}, prefill_per_tok "
              f"{per_tok:.6e} s from {len(pf)} prefill ticks) for the "
              f"head's {n} blocks: recompute {recompute:.6g} s against a "
              f"fetch at {picks}")
    differ = [a for a in FLEET_ARMS if a != "single"
              and runs[a]["out"] != runs["single"]["out"]]
    if differ:
        ref = fleet_logits(K, cfg, params, dev, dtype, "single", max_new)
        for a in differ:
            rows = fleet_logits(K, cfg, params, dev, dtype, a, max_new)
            divergences(f"fleet {a}", "single", ref, a, rows,
                        FLEET_REQUESTS * max_new)
    return counts


def fleet_logits(K, cfg, params, dev, dtype, arm, max_new):
    """An untimed copy of an arm with every tick's logits on the host
    (``logit_rows``)."""
    import gc
    front, engines = fleet_front(cfg, params, dev, dtype, arm)
    reqs, _ = fleet_trace(cfg.vocab, max_new=max_new)
    rows, restore = logit_rows(engines, reqs)
    try:
        for r in reqs:
            front.submit(r)
        front.run(max_ticks=200000)
    finally:
        restore()
    n = sum(len(v) for v in rows.values())
    print(f"fleet {arm}: untimed copy with logits kept: tokens_that_are_"
          f"their_row's_argmax={argmax_share(rows)}/{n}")
    del front, engines
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# the reduced configs of phase 3's arch parity: (arch, int8 weights)
ARCH_PARITY = (("phi3-medium-14b", False), ("deepseek-7b", False),
               ("command-r-35b", False), ("qwen1.5-110b", False),
               ("llama4-maverick-400b-a17b", False), ("llama3-8b", True),
               ("llama4-maverick-400b-a17b", True))
ARCH_KERNELS = ("smlm", "bgmv", "decode", "prefill", "flash")


def parity_archs(K, devices=("cuda", "cpu")):
    """Phase 3, the other configs: each reduced config of ``ARCH_PARITY``
    (numpy-seeded fp32 weights, int8 where named, quantized on the host so
    both devices hold the same payloads) serves ``shared_prefix_trace``
    through the engine on ``cuda`` (kernels) and ``cpu`` (plain versions):
    greedy tokens and steps equal, and every kernel of the serving path
    launched on the card."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.models import moe
    from repro_torch.models.quant import quantize_params
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.training.optimizer import tree_map
    lcfg = LoRAConfig(n_slots=4, r=8)
    for arch, int8 in ARCH_PARITY:
        cfg = get_reduced(arch)
        flat = numpy_weights(cfg, seed=0)
        ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
              for i in range(2)}
        host = params_from_numpy(flat, device="cpu")
        if int8:
            host = quantize_params(cfg, host)
        got = {}
        for dev in devices:
            params = tree_map(lambda v: v.to(dev), host)
            adapters = {n: bank_from_numpy(f, device=dev)
                        for n, f in ad.items()}
            eng = build_engine(cfg, params, adapters, lcfg, torch.device(dev),
                               torch.float32, EngineConfig(
                                   capacity=4, pf_capacity=2, s_max=128,
                                   virtual_time=True))
            reset_counts(K)
            moe.moe_apply.calls = 0
            for r in shared_prefix_trace(cfg.vocab, list(ad), seed=3):
                eng.submit(r)
            eng.run(max_ticks=10000)
            got[dev] = ({r.rid: list(r.output) for r in eng.finished},
                        eng.metrics.steps, read_counts(K),
                        moe.moe_apply.calls)
        (gtok, gsteps, gl, gmoe), (ctok, csteps, _, _) = \
            got[devices[0]], got[devices[1]]
        if len(gtok) != 8 or gtok != ctok or gsteps != csteps:
            raise AssertionError(f"{arch} int8={int8}: tokens or steps "
                                 f"differ: cuda {gtok} cpu {ctok}")
        if min(gl[k] for k in ARCH_KERNELS) == 0 or \
                (cfg.moe is not None) != (gmoe > 0):
            raise AssertionError(f"{arch}: a kernel did not launch: {gl}, "
                                 f"moe calls {gmoe}")
        print(f"parity: {arch} reduced {'int8' if int8 else 'fp32'} "
              f"(L={cfg.n_layers} d={cfg.d_model} h={cfg.n_heads} "
              f"g={cfg.n_kv_heads} bias={cfg.qkv_bias} "
              f"tied={cfg.tie_embeddings} moe={cfg.moe is not None}) "
              f"cuda==cpu greedy tokens for 8 requests (48 tokens), "
              f"steps={gsteps}, cuda launches="
              f"{ {k: gl[k] for k in ARCH_KERNELS} } moe_calls={gmoe} ok")
    parity_mla(K, devices)
    for arch in MAMBA_ARCHS:
        parity_mamba(K, arch, devices)
    parity_cross(K, devices)


def parity_mla(K, devices=("cuda", "cpu")):
    """Phase 3, MLA: reduced deepseek-v2-236b (latent c = 64, rope dr = 16,
    4 experts top-2 and a shared one; numpy-seeded fp32 weights and two
    adapters) on ``cuda`` and ``cpu``: (a) the paged engine with dedup on
    ``shared_prefix_trace``, then with speculation (the suffix drafter fed
    the plain outputs, so verify chunks run over the latent pool): tokens
    equal on both devices and to the plain run's, prefix tokens reused,
    drafts accepted; (b) lending with a raw host tier (``parity_memory``'s
    lending arm: latent blocks swapped out and restored bit-exact); (c) one
    engine and 2 replicas round-robin with remote fetch (``parity_fleet``,
    one explicit ``import_block``).  On the card every run launches SMLM
    and BGMV and no GQA attention kernel (``check_routes``)."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.spec import SpecConfig
    cfg = get_reduced("deepseek-v2-236b")
    lcfg = LoRAConfig(n_slots=4, r=8)
    flat = numpy_weights(cfg, seed=0)
    ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
          for i in range(2)}

    def run(dev, spec=None, suffix=None):
        params = params_from_numpy(flat, device=dev)
        adapters = {n: bank_from_numpy(f, device=dev) for n, f in ad.items()}
        eng = build_engine(cfg, params, adapters, lcfg, torch.device(dev),
                           torch.float32, EngineConfig(
                               capacity=4, pf_capacity=2, s_max=128,
                               virtual_time=True, spec=spec))
        for r in shared_prefix_trace(cfg.vocab, list(ad), seed=3):
            if suffix is not None:
                r.draft_suffix = np.concatenate(
                    [r.prompt, np.asarray(suffix[r.rid], np.int64)])
            eng.submit(r)
        reset_counts(K)
        eng.run(max_ticks=10000)
        if not eng.cachemgr.pristine:
            raise AssertionError(f"parity mla {dev}: pool not pristine")
        return eng, read_counts(K), {r.rid: list(r.output)
                                     for r in eng.finished}

    (ge, gl, gtok), (ce, _, ctok) = (run(d) for d in devices)
    if len(gtok) != 8 or gtok != ctok or ge.metrics.steps != ce.metrics.steps:
        raise AssertionError(f"parity mla: tokens or steps differ: "
                             f"{devices[0]} {gtok} {devices[1]} {ctok}")
    if not ge.metrics.reused_prefix_tokens:
        raise AssertionError("parity mla: no prefix block was adopted")
    spec = SpecConfig(k_max=4, drafter="suffix")
    (se, sl, stok), (_, _, sctok) = (run(d, spec, gtok) for d in devices)
    if stok != sctok or stok != gtok:
        raise AssertionError(f"parity mla spec: tokens differ: {devices[0]} "
                             f"{stok} {devices[1]} {sctok} plain {gtok}")
    if not se.metrics.spec_accepted:
        raise AssertionError("parity mla spec: no draft accepted")
    if devices[0] == "cuda":
        for label, launches in (("plain", gl), ("spec", sl)):
            check_routes(f"parity mla {label}", cfg, launches, ())
    m = se.metrics
    print(f"parity: {cfg.name} reduced fp32 MLA (L={cfg.n_layers} d="
          f"{cfg.d_model} h={cfg.n_heads} c={cfg.mla.kv_lora_rank} dr="
          f"{cfg.mla.qk_rope_dim} moe={cfg.moe.num_experts}e top-"
          f"{cfg.moe.top_k}) paged with dedup, cuda==cpu greedy tokens for 8"
          f" requests (48 tokens), steps={ge.metrics.steps}, "
          f"reused_prefix_tokens={ge.metrics.reused_prefix_tokens}; spec "
          f"k_max=4 suffix drafter cuda==cpu==plain, drafted="
          f"{m.spec_drafted} accepted={m.spec_accepted} steps={m.steps}; "
          f"cuda launches plain={ {k: gl[k] for k in ARCH_KERNELS} } spec="
          f"{ {k: sl[k] for k in ARCH_KERNELS + ('verify',)} } (GQA "
          f"attention kernels 0: MLA attends in plain PyTorch) ok")
    parity_memory(K, cfg, flat, lcfg, devices, arms=("lending",))
    parity_fleet(K, cfg, flat, lcfg, devices, replicas=2,
                 policies=("round-robin",))


MAMBA_ARCHS = ("mamba2-1.3b", "jamba-1.5-large-398b")


def parity_mamba(K, arch, devices=("cuda", "cpu")):
    """Phase 3, the Mamba2 family: reduced ``arch`` (numpy-seeded fp32
    weights and two adapters) on ``cuda`` and ``cpu``: (a) the paged
    engine with dedup on ``shared_prefix_trace`` (blocks adopted and
    counted, every prompt recomputed whole: no reused prefix tokens), then
    an engine built with speculation, which a Mamba pattern turns off, so
    it decodes plainly and emits the plain tokens; (b) lending with one
    preemption or more (recompute: the host tier takes no swap-out for a
    Mamba pattern); (c) for a hybrid, 2 replicas round-robin with one more
    ``import_block`` (K/V equal, the state rows untouched).  Tokens and
    steps equal on both devices; on the card SMLM and BGMV launch, and no
    GQA attention kernel for mamba2, flash and paged decode and no paged
    prefill or verify for jamba (``check_routes``)."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.spec import SpecConfig
    cfg = get_reduced(arch)
    lcfg = LoRAConfig(n_slots=4, r=8)
    flat = numpy_weights(cfg, seed=0)
    ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
          for i in range(2)}

    def run(dev, spec=None):
        params = params_from_numpy(flat, device=dev)
        adapters = {n: bank_from_numpy(f, device=dev) for n, f in ad.items()}
        eng = build_engine(cfg, params, adapters, lcfg, torch.device(dev),
                           torch.float32, EngineConfig(
                               capacity=4, pf_capacity=2, s_max=128,
                               virtual_time=True, spec=spec))
        for r in shared_prefix_trace(cfg.vocab, list(ad), seed=3):
            eng.submit(r)
        reset_counts(K)
        eng.run(max_ticks=10000)
        if not eng.cachemgr.pristine:
            raise AssertionError(f"parity {arch} {dev}: pool not pristine")
        return eng, read_counts(K), {r.rid: list(r.output)
                                     for r in eng.finished}

    (ge, gl, gtok), (ce, _, ctok) = (run(d) for d in devices)
    if len(gtok) != 8 or gtok != ctok or ge.metrics.steps != ce.metrics.steps:
        raise AssertionError(f"parity {arch}: tokens or steps differ: "
                             f"{devices[0]} {gtok} {devices[1]} {ctok}")
    m = ge.metrics
    if not m.hash_hits or m.reused_prefix_tokens or ge.suffix_prefill:
        raise AssertionError(f"parity {arch}: dedup should adopt blocks "
                             f"and recompute whole prompts: hash_hits="
                             f"{m.hash_hits} reused="
                             f"{m.reused_prefix_tokens}")
    spec = SpecConfig(k_max=4, drafter="ngram")
    (se, sl, stok), (_, _, sctok) = (run(d, spec) for d in devices)
    if se.spec is not None or stok != sctok or stok != gtok \
            or se.metrics.spec_drafted:
        raise AssertionError(f"parity {arch} spec requested: the engine "
                             f"should decode plainly: {devices[0]} {stok} "
                             f"{devices[1]} {sctok} plain {gtok}")
    need = ("smlm", "bgmv", "flash", "decode")
    if devices[0] == "cuda":
        for label, launches in (("plain", gl), ("spec", sl)):
            check_routes(f"parity {arch} {label}", cfg, launches, need)
    print(f"parity: {cfg.name} reduced fp32 (L={cfg.n_layers} d="
          f"{cfg.d_model} pattern={'/'.join(cfg.pattern)} ssm heads="
          f"{cfg.n_ssm_heads}x{cfg.ssm.head_dim} d_state={cfg.ssm.d_state} "
          f"chunk={cfg.ssm.chunk} moe={cfg.moe is not None}) paged with "
          f"dedup, cuda==cpu greedy tokens for 8 requests (48 tokens), "
          f"steps={m.steps} hash_hits={m.hash_hits} reused_prefix_tokens="
          f"{m.reused_prefix_tokens} (whole prompts recomputed); spec "
          f"requested and off: tokens == plain on both devices; cuda "
          f"launches={ {k: gl[k] for k in ARCH_KERNELS + ('verify',)} } ok")
    parity_memory(K, cfg, flat, lcfg, devices, arms=("lending",))
    if "attn" in cfg.pattern:
        parity_fleet(K, cfg, flat, lcfg, devices, replicas=2,
                     policies=("round-robin",))


CROSS_ARCHS = ("llama-3.2-vision-90b", "whisper-base")


def is_cross(cfg) -> bool:
    return cfg.encoder is not None or cfg.cross_attn_every > 0


def cross_targets():
    """The default LoRA targets and a cross layer's ``xwq`` / ``xwo``."""
    from repro_torch.core.lora import LoRAConfig
    return LoRAConfig().targets + ("xwq", "xwo")


def add_aux(reqs, cfg, seed, scale=1.0):
    """Give each request its own cross source ``aux_embed`` [F, d] float32
    (image patches or audio frames: ``scale`` times a standard normal from
    ``seed``); returns the requests."""
    from repro_torch.models.schema import cross_len
    rng = np.random.default_rng(seed)
    for r in reqs:
        r.aux_embed = rng.standard_normal((cross_len(cfg), cfg.d_model),
                                          dtype=np.float32) * scale
    return reqs


def parity_cross(K, devices=("cuda", "cpu")):
    """Phase 3, cross-attention: reduced llama-3.2-vision-90b (5 layers, a
    cross layer at position 4, 16 image tokens) and whisper-base (2 + 2
    layers, 32 frames) with numpy-seeded fp32 weights, ``xgate`` open
    (``XGATE``), two adapters over the default targets and ``xwq`` /
    ``xwo``, and a seeded source per request, on ``cuda`` and ``cpu``: (a)
    the paged engine with dedup on ``shared_prefix_trace`` (aux requests
    never share: 0 hash hits, 0 reused tokens); (b) speculation, the suffix
    drafter fed the plain outputs (verify chunks over the ``xk`` / ``xv``
    rows): the plain tokens; (c) chunked prefill of 16 tokens a tick (every
    chunk projects the source again): the plain tokens, paged prefill
    launched; (d) lending in an 8-block pool with a raw host tier:
    preemptions swap out and restore (restored blocks bit-equal, the
    suffix prefill rewrites the row); (e) 2 replicas round-robin with
    remote fetch: 0 blocks fetched, the plain tokens.  Tokens and steps
    equal on both devices; on the card SMLM, BGMV, flash and paged decode
    launch, and paged prefill and verify only where (b)-(d) take them."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.fleet import FleetConfig, RouterConfig, build_fleet
    from repro_torch.models.schema import cross_len
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.request import Request
    from repro_torch.spec import SpecConfig
    for arch in CROSS_ARCHS:
        cfg = get_reduced(arch)
        lcfg = LoRAConfig(n_slots=4, r=8, targets=cross_targets())
        flat = numpy_weights(cfg, seed=0)
        ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
              for i in range(2)}
        rng = np.random.default_rng(11)
        lend = [rng.integers(0, cfg.vocab, 8).astype(np.int32)
                for _ in range(3)]

        def shared():
            return add_aux(shared_prefix_trace(cfg.vocab, list(ad), seed=3),
                           cfg, seed=21)

        def lending():
            return add_aux([Request(rid=i, prompt=p, adapter="lora0",
                                    max_new_tokens=40, arrival=0.1 * i)
                            for i, p in enumerate(lend)], cfg, seed=22)

        def run(dev, trace, replicas=1, suffix=None, **kw):
            params = params_from_numpy(flat, device=dev)
            adapters = {n: bank_from_numpy(f, device=dev)
                        for n, f in ad.items()}
            ecfg = EngineConfig(**{**dict(capacity=4, pf_capacity=2,
                                          s_max=128, virtual_time=True),
                                   **kw})
            model = mixed_model(cfg, params, adapters, lcfg,
                                torch.device(dev), torch.float32)
            front = (build_fleet(model, ecfg, FleetConfig(
                replicas=replicas, router=RouterConfig(
                    policy="round-robin"))) if replicas > 1
                else build_engine(cfg, params, adapters, lcfg,
                                  torch.device(dev), torch.float32, ecfg))
            engines = front.engines if replicas > 1 else [front]
            restored = [watch_restores(e.cachemgr) for e in engines]
            for r in trace():
                if suffix is not None:
                    r.draft_suffix = np.concatenate(
                        [r.prompt, np.asarray(suffix[r.rid], np.int64)])
                front.submit(r)
            reset_counts(K)
            m = front.run(max_ticks=10000)
            if not all(e.cachemgr.pristine for e in engines):
                raise AssertionError(f"parity {arch} {dev}: a pool is not "
                                     f"pristine")
            return dict(tokens={r.rid: list(r.output) for e in engines
                                for r in e.finished},
                        steps=m.steps, m=m, launches=read_counts(K),
                        restored=sum(sum(x) for x in restored))

        arms = {"dedup": (shared, {}), "lending": (lending, dict(
            block_size=16, n_blocks=8, s_max=64, over_admit=2.0,
            kv_host_blocks=8))}
        got = {}
        for arm, (trace, kw) in arms.items():
            got[arm] = [run(d, trace, **kw) for d in devices]
        plain = got["dedup"][0]["tokens"]
        got["spec"] = [run(d, shared, suffix=plain, spec=SpecConfig(
            k_max=4, drafter="suffix")) for d in devices]
        got["chunked"] = [run(d, shared, prefill_chunk=16) for d in devices]
        got["fleet"] = [run(d, shared, replicas=2, block_size=16)
                        for d in devices]
        single = [run(d, shared, block_size=16)["tokens"] for d in devices]
        notes = []
        for arm, (a, b) in got.items():
            if a["tokens"] != b["tokens"] or a["steps"] != b["steps"]:
                raise AssertionError(f"parity {arch} {arm}: tokens or steps "
                                     f"differ: {devices[0]} {a['tokens']} "
                                     f"{devices[1]} {b['tokens']}")
            m, n = a["m"], len(a["tokens"])
            if n != (3 if arm == "lending" else 8):
                raise AssertionError(f"parity {arch} {arm}: {n} finished")
            if arm in ("spec", "chunked") and a["tokens"] != plain:
                raise AssertionError(f"parity {arch} {arm}: tokens differ "
                                     f"from the plain run's")
            if arm == "fleet" and (a["tokens"] != single[0]
                                   or m.remote_fetch_blocks):
                raise AssertionError(f"parity {arch} fleet: tokens differ "
                                     f"from one engine's, or "
                                     f"{m.remote_fetch_blocks} blocks were "
                                     f"fetched for aux requests")
            if arm == "dedup" and (m.hash_hits or m.reused_prefix_tokens):
                raise AssertionError(f"parity {arch}: aux requests shared "
                                     f"blocks: hash_hits={m.hash_hits}")
            if arm == "spec" and not m.spec_accepted:
                raise AssertionError(f"parity {arch} spec: no draft "
                                     f"accepted")
            if arm == "lending":
                cm_kv = (m.preemptions, m.kv_swap_outs, m.kv_restores)
                if not (all(cm_kv) and a["restored"]):
                    raise AssertionError(f"parity {arch} lending: no "
                                         f"preemption, swap-out or restore:"
                                         f" {cm_kv}")
            if devices[0] == "cuda":
                # a split-K walk counts as the decode (or, under
                # speculation, the verify) it replaces
                launches = dict(a["launches"])
                walk = "verify" if arm == "spec" else "decode"
                launches[walk] += launches["partials"]
                # speculation verifies every decode step: no plain decode
                need = {"dedup": ("decode",), "lending": ("decode",
                                                          "prefill"),
                        "spec": ("verify",), "chunked": ("decode",
                                                         "prefill"),
                        "fleet": ("decode",)}[arm]
                check_routes(f"parity {arch} {arm}", cfg, launches,
                             ("smlm", "bgmv", "flash") + need)
                if arm == "dedup" and (launches["prefill"]
                                       or launches["verify"]):
                    raise AssertionError(f"parity {arch} dedup: paged "
                                         f"prefill or verify launched: "
                                         f"{launches}")
            notes.append(
                f"{arm}: steps={a['steps']}"
                + (f" drafted={m.spec_drafted} accepted={m.spec_accepted}"
                   if arm == "spec" else "")
                + (f" max_pf_tokens_step={m.max_pf_tokens_step}"
                   if arm == "chunked" else "")
                + (f" preemptions={m.preemptions} swap_outs="
                   f"{m.kv_swap_outs} restores={m.kv_restores} "
                   f"blocks_restored_bit_equal={a['restored']}"
                   if arm == "lending" else "")
                + (f" remote_fetch_blocks={m.remote_fetch_blocks}"
                   if arm == "fleet" else "")
                + (f" hash_hits={m.hash_hits}" if arm == "dedup" else "")
                + f" launches={ {k: a['launches'][k] for k in ARCH_KERNELS + ('verify',)} }")
        print(f"parity: {cfg.name} reduced fp32 cross-attention (L="
              f"{cfg.n_layers} d={cfg.d_model} h={cfg.n_heads} g="
              f"{cfg.n_kv_heads} F={cross_len(cfg)} encoder="
              f"{cfg.encoder.n_layers if cfg.encoder else 0} xgate={XGATE}, "
              f"a source per request, xwq/xwo adapters), cuda==cpu tokens "
              f"and steps: " + "; ".join(notes) + " ok")


# ---------------------------------------------- phase 12: the other configs
# (arch, layers kept (None: all), int8 weights)
ARCH_ARMS = (("deepseek-7b", None, False), ("phi3-medium-14b", None, False),
             ("phi3-medium-14b", None, True), ("command-r-35b", None, True),
             ("qwen1.5-110b", 40, True),
             ("llama4-maverick-400b-a17b", 2, False),
             ("llama4-maverick-400b-a17b", 4, True),
             ("deepseek-v2-236b", 4, False), ("deepseek-v2-236b", 8, True),
             ("mamba2-1.3b", None, False),
             ("jamba-1.5-large-398b", 8, True),
             ("llama-3.2-vision-90b", 10, False),
             ("llama-3.2-vision-90b", 20, True),
             ("whisper-base", None, False))


def arch_weights(cfg, dev, int8, seed=0):
    """Random full-width bf16 weights made on the card from a seed, leaf by
    leaf; with ``int8`` each eligible leaf is drawn in bf16, quantized and
    freed before the next is drawn (a bf16 copy of a whole model, or an fp32
    one of a whole leaf stack, would not fit), then two gaussian-B
    adapters (for a cross config over ``xwq`` / ``xwo`` too, its gates
    ``XGATE`` and its encoder drawn as the rest).  Returns (params, store,
    setup seconds)."""
    import gc
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.virtualization import AdapterStore
    from repro_torch.models.quant import _eligible, quantize_weight
    from repro_torch.models.schema import encoder_shapes, init_leaf, \
        layer_shapes, top_leaves
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def make(leaf, shape):
        w = init_leaf(leaf, gen, dev, torch.bfloat16)
        if int8 and _eligible(leaf, shape):
            w = quantize_weight(w)
        return w

    top = top_leaves(cfg)
    params = {"embed": make(top["embed"], top["embed"].shape), "layers": []}
    for li in range(cfg.n_layers):
        params["layers"].append(
            {k: make(leaf, (cfg.n_periods, *leaf.shape))
             for k, leaf in layer_shapes(cfg, li).items()})
        if "xgate" in params["layers"][-1]:
            params["layers"][-1]["xgate"].fill_(XGATE)
        gc.collect()
    params["final_norm"] = torch.ones(cfg.d_model, device=dev,
                                      dtype=torch.bfloat16)
    if "lm_head" in top:
        params["lm_head"] = make(top["lm_head"], top["lm_head"].shape)
    if cfg.encoder is not None:
        ne = cfg.encoder.n_layers
        params["encoder"] = {
            "layers": [{k: make(leaf, (ne, *leaf.shape))
                        for k, leaf in encoder_shapes(cfg).items()}
                       for _ in range(ne)],
            "final_norm": torch.ones(cfg.d_model, device=dev,
                                     dtype=torch.bfloat16)}
    targets = cross_targets() if is_cross(cfg) else LoRAConfig().targets
    store = AdapterStore(cfg, LoRAConfig(n_slots=4, r=8, targets=targets),
                         device=dev, dtype=torch.bfloat16)
    for i in range(2):
        g = torch.Generator(device=dev)
        g.manual_seed(100 + i)
        store.load_random(f"lora{i}", g, gaussian_b=True)
    torch.cuda.synchronize()
    return params, store, time.perf_counter() - t0


def tree_bytes(tree) -> int:
    from repro_torch.training.optimizer import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def prefill_stats(ticks) -> str:
    pf = [(t, e, w) for t, p, _, e, w in ticks if p]
    return (f"prefill_ticks={len(pf)} prefill_tick_ms_mean="
            f"{np.mean([t for t, _, _ in pf]) * 1e3:.3f} (forward enqueue "
            f"{np.mean([e for _, e, _ in pf]) * 1e3:.3f} + device wait "
            f"{np.mean([w for *_, w in pf]) * 1e3:.3f})")


def arch_grad_step(K, cfg, weights, dev, n_rows=2, seq=64, lr=1e-3):
    """A config's fine-tuning path on the card: one fused train step
    (forward over ft rows, a MoE config's router aux loss, backward through
    the kernels and a Mamba layer's chunked SSD, masked AdamW) for lora0's
    slot; loss finite, aux loss > 0 for MoE, the slot's bank elements
    changed and no other slot's.  A cross config's rows carry a seeded
    source each, and lora0's ``xwq`` factors must change."""
    from repro_torch.core.unified import make_train_step
    from repro_torch.models.stream import FTBatch, UnifiedBatch
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    params, store, _ = weights
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (n_rows, seq))
                            .astype(np.int32)).to(dev)
    slot = store.slot_of("lora0")
    ft = FTBatch(tokens=toks, mask=torch.ones_like(toks, dtype=torch.bool),
                 labels=toks, adapter=torch.full((n_rows,), slot,
                                                 dtype=torch.int32,
                                                 device=dev),
                 weight=torch.ones(n_rows, device=dev))
    if is_cross(cfg):
        from repro_torch.models.schema import cross_len
        ft = ft._replace(aux_embed=torch.from_numpy(rng.standard_normal(
            (n_rows, cross_len(cfg), cfg.d_model), dtype=np.float32)
        ).to(dev))
    step = make_train_step(cfg, AdamWConfig(lr=lr), block_t=K["block_t"])
    n0 = K["smlm_wgrad"].launches
    mask = store.slot_mask(["lora0"])
    t0 = time.perf_counter()
    loss, bank, state, aux = step(params, store.bank, store.scale,
                                  adamw_init(store.bank, store.lcfg.n_slots),
                                  UnifiedBatch(ft=ft), mask)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launched = K["smlm_wgrad"].launches - n0
    # a second step from the first one's bank, warm and profiled (device
    # activity only): its wall and device busy time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(params, bank, store.scale, state, UnifiedBatch(ft=ft), mask)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t1) * 1e3
    busy, top, _ = device_top(prof, n=6)
    others = [s for s in range(store.lcfg.n_slots) if s != slot]
    changed = torch.cat([(nb[ab][slot] != ob[ab][slot]).reshape(-1)
                         for nl, ol in zip(bank["layers"],
                                           store.bank["layers"])
                         for (nb, ob) in ((nl[t], ol[t]) for t in nl)
                         for ab in ("a", "b")]).float().mean()
    still = all(torch.equal(nl[t][ab][others], ol[t][ab][others])
                for nl, ol in zip(bank["layers"], store.bank["layers"])
                for t in nl for ab in ("a", "b"))
    xwq = [not torch.equal(nl["xwq"][ab][slot], ol["xwq"][ab][slot])
           for nl, ol in zip(bank["layers"], store.bank["layers"])
           if "xwq" in nl for ab in ("a", "b")]
    if not (torch.isfinite(loss) and (float(aux) > 0 or cfg.moe is None)
            and float(changed) > 0 and still and launched
            and (any(xwq) or not is_cross(cfg))):
        raise AssertionError(f"{cfg.name} grad step: loss {float(loss)} aux "
                             f"{float(aux)} changed {float(changed)} "
                             f"others unchanged {still} xwq changed {xwq}")
    print(f"archs: {cfg.name} grad step of {n_rows} ft rows x {seq} "
          f"tokens on the card: wall_ms={wall:.3f} (a second, warm step "
          f"{warm:.3f}, device busy {busy:.3f} ms; top: {top}) "
          f"loss={float(loss):.5f} "
          f"aux_loss={float(aux):.6f} share_of_slot_elements_changed="
          f"{float(changed):.4f} other slots unchanged, smlm_wgrad "
          f"launches={launched} (a step)"
          + (f", rows with sources, lora0's xwq factors changed on "
             f"{sum(xwq)} of {len(xwq)} (layer, a|b)" if xwq else "")
          + " ok")


def arch_arm(K, arch, layers, int8, dev, max_new=16, seed=0):
    """One arm of phase 12: build, serve phase 4's two waves timed, print
    the ``archs:`` line (for MLA with the latent pool's bytes a token and
    layer beside expanded K/V's; for Mamba the state bytes a request row;
    for cross-attention the ``xk`` / ``xv`` bytes a request row and the
    host-to-card copy of the sources inside each prefill tick), and for a
    bf16 MoE, Mamba or cross config take one grad step; returns the launch
    counts of the serving run and the step."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.core import flow
    from repro_torch.models import moe
    full = get_config(arch)
    cfg = full if layers is None else full.replace(n_layers=layers)
    torch.cuda.empty_cache()
    weights = arch_weights(cfg, dev, int8)
    w_bytes = tree_bytes(weights[0])
    torch.cuda.reset_peak_memory_stats()
    eng, seen, ticks, tick = timed_engine(cfg, weights, capacity=8,
                                          pf_capacity=4, s_max=512)
    waves = request_waves(cfg, np.random.default_rng(seed), 128,
                          max_new=max_new)
    copies_s = []
    if is_cross(cfg):
        for i, wave in enumerate(waves[:2]):
            add_aux(wave, cfg, seed=50 + i)
        plan_pf = flow.plan_pf

        def timed_plan_pf(reqs, *a, **kw):
            # the bucket's host-to-card copy, sources included (a pageable
            # copy: the host waits for it)
            t0 = time.perf_counter()
            out = plan_pf(reqs, *a, **kw)
            torch.cuda.synchronize()
            if out is not None:
                copies_s.append((time.perf_counter() - t0,
                                 out.aux_embed.numel() * 4))
            return out

        flow.plan_pf = timed_plan_pf
    reset_counts(K)
    mo = moe.moe_apply
    mo.calls = mo.entries = mo.routed = mo.dropped = 0
    try:
        run_waves(eng, tick, waves[:2])
    finally:
        if is_cross(cfg):
            flow.plan_pf = plan_pf
    counts = read_counts(K)
    check_drained(eng, seen, 8, max_new)
    peak = torch.cuda.max_memory_allocated()
    if is_cross(cfg):
        # no aux request shares a prefix: every prompt is a cold prefill
        # (flash), and the plain waves never speculate
        need = dict(smlm=counts["smlm"], bgmv=counts["bgmv"],
                    flash=counts["flash"],
                    decode=counts["decode"] + counts["partials"])
        if counts["prefill"] or counts["verify"]:
            raise AssertionError(f"archs {arch}: paged prefill or verify "
                                 f"launched in the plain waves: {counts}")
    elif cfg.mla is not None or "attn" not in cfg.pattern:
        need = {k: counts[k] for k in ("smlm", "bgmv") + GQA_COUNTERS}
    elif "mamba" in cfg.pattern:       # whole prompts: no suffix prefill
        need = dict(smlm=counts["smlm"], bgmv=counts["bgmv"],
                    flash=counts["flash"],
                    decode=counts["decode"] + counts["partials"])
    else:
        need = dict(smlm=counts["smlm"], bgmv=counts["bgmv"],
                    flash=counts["flash"], prefill=counts["prefill"],
                    decode=counts["decode"] + counts["partials"])
    check_routes(f"archs {arch}", cfg, dict(counts, **need), need)
    moe_note = ""
    if cfg.moe is not None:
        n_moe = sum(cfg.is_moe_layer(li % len(cfg.pattern))
                    for li in range(cfg.n_layers))
        if mo.calls != n_moe * len(ticks):
            raise AssertionError(f"{mo.calls} MoE calls for {len(ticks)} "
                                 f"ticks of {n_moe} MoE layers")
        moe_note = (f" moe: {n_moe} MoE layer(s) of {cfg.moe.num_experts} "
                    f"experts top-{cfg.moe.top_k}, experts_routed_per_tick="
                    f"{mo.routed / len(ticks):.2f} (per MoE layer call "
                    f"{mo.routed / mo.calls:.2f}), entries_dropped="
                    f"{mo.dropped} of {mo.entries} (padding rows included)")
    if cfg.mla is not None:
        cm, m = eng.cachemgr, cfg.mla
        per_tok = cm.adapter_block_bytes // (cm.block_size * cfg.n_layers)
        expanded = cfg.n_heads * (m.qk_nope_dim + m.qk_rope_dim
                                  + m.v_head_dim) * 2
        moe_note += (f" mla: latent pool (ckv c={m.kv_lora_rank} + kpe dr="
                     f"{m.qk_rope_dim}) bytes_per_block="
                     f"{cm.adapter_block_bytes} ({cm.block_size} tokens x "
                     f"{cfg.n_layers} layers) = {per_tok} B a token and "
                     f"layer vs expanded K/V of {cfg.n_heads} heads "
                     f"{expanded} B ({expanded / per_tok:.2f}x)")
    if cfg.ssm is not None:
        from repro_torch.models.model import STATE_KEYS
        cm = eng.cachemgr
        rows = cm.capacity + cm.pf_capacity
        state = sum(v.numel() // v.shape[1] * v.element_size()
                    for k, v in cm.cache.items() if k in STATE_KEYS)
        n_m = sum(k == "mamba" for k in cfg.pattern) * cfg.n_periods
        moe_note += (f" mamba: {n_m} Mamba layer(s) of {cfg.n_ssm_heads} "
                     f"heads x {cfg.ssm.head_dim} x d_state "
                     f"{cfg.ssm.d_state}, state_bytes_per_row={state} "
                     f"({state / 2 ** 20:.3f} MiB: h, conv_x, conv_bc over "
                     f"every Mamba layer; {rows} rows resident "
                     f"{state * rows / 1e9:.3f} GB) block_leaves="
                     f"{list(cm.block_leaves)} bytes_per_block="
                     f"{cm.adapter_block_bytes}")
    if is_cross(cfg):
        from repro_torch.models.schema import cross_len
        cm = eng.cachemgr
        row = sum(v[:, 0].numel() * v.element_size()
                  for k, v in cm.cache.items() if k in ("xk", "xv"))
        n_x = cm.cache["xk"].shape[0]
        ms = [c * 1e3 for c, _ in copies_s]
        moe_note += (f" cross: {n_x} cross layer(s) F={cross_len(cfg)} "
                     f"encoder_layers="
                     f"{cfg.encoder.n_layers if cfg.encoder else 0} xgate="
                     f"{XGATE}, xk_xv_bytes_per_row={row} "
                     f"({row / 2 ** 20:.3f} MiB; "
                     f"{cm.capacity + cm.pf_capacity} rows resident) "
                     f"block_leaves={list(cm.block_leaves)} bytes_per_block="
                     f"{cm.adapter_block_bytes}; sources copied to the card "
                     f"in the prefill buckets: {len(ms)} buckets, "
                     f"{sum(b for _, b in copies_s)} bytes, plan_pf_ms_mean="
                     f"{np.mean(ms):.3f} (host-to-card, inside the prefill "
                     f"tick) max={max(ms):.3f}")
    dec = [(t, d) for t, p, d, *_ in ticks if not p]
    print(f"archs: {arch} {'int8' if int8 else 'bf16'} L={cfg.n_layers}/"
          f"{full.n_layers} d={cfg.d_model} h={cfg.n_heads} g="
          f"{cfg.n_kv_heads} V={cfg.vocab} setup_s={weights[2]:.3f} "
          f"resident_weight_gb={w_bytes / 1e9:.3f} "
          f"max_memory_allocated_gb={peak / 1e9:.3f} requests=8 "
          f"tokens_each={max_new} ticks={len(ticks)} "
          f"run_s={sum(t for t, *_ in ticks):.4f} {prefill_stats(ticks)} "
          f"{tick_stats(ticks)} decode_ticks_tok_per_s_incl_padding="
          f"{8 * len(dec) / sum(t for t, _ in dec):.3f} launches={need}"
          f"{moe_note} finite=True pristine=True ok")
    if ((cfg.moe is not None or is_cross(cfg)) and not int8) \
            or cfg.ssm is not None:
        arch_grad_step(K, cfg, weights, dev)
        counts["smlm_wgrad"] = K["smlm_wgrad"].launches
    del eng, weights
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def full_archs(K, dev):
    """Phase 12: each arm of ``ARCH_ARMS`` in turn, each model freed before
    the next is built; returns the launch counts summed over the GQA arms
    (``archs``), the MLA arms (``archs_mla``), the Mamba arms
    (``archs_mamba``) and the cross-attention arms (``archs_cross``)."""
    from repro_torch.configs import get_config
    total = {p: {k: 0 for k in COUNTERS}
             for p in ("archs", "archs_mla", "archs_mamba", "archs_cross")}
    for arch, layers, int8 in ARCH_ARMS:
        cfg = get_config(arch)
        path = ("archs_mla" if cfg.mla is not None
                else "archs_mamba" if cfg.ssm is not None
                else "archs_cross" if is_cross(cfg) else "archs")
        for k, v in arch_arm(K, arch, layers, int8, dev).items():
            total[path][k] += v
    return total


# ------------------------------------------ phase 13: sliding windows
WINDOW_SMALL = dict(S=256, lengths=[200, 90], windows=(0, 64, 256, 300))
WINDOW_LONG = dict(S=16384, window=8192)     # long_500k's window, a 16k bucket
WINDOW_ARCHS = ("llama3-8b", "deepseek-v2-236b", "jamba-1.5-large-398b",
                "llama-3.2-vision-90b")
WINDOW_REDUCED = 16                 # the reduced configs' window (phase 13)
WINDOW_LOGIT_TOL = 5e-2             # bf16 identity: x max |path B| logit


def takes_window(K) -> bool:
    """Whether the checkout's flash wrapper has a window (a ``--root``
    from before it does not)."""
    import inspect
    return "window" in inspect.signature(K["flash"]).parameters


def check_window_kernels(K, dtype, dev, gen, timing: bool):
    """Windowed flash: S = 256 (lengths 200 and 90) at W = 0, 64, 256 and
    300 against the full plain version, row 1's positions from 90 + W - 1
    on (no key in their window) exact zeros; in bf16 also the long_500k
    shape, B = 1, S = length = 16384, W = 8192, against the plain version
    in its chunked form in fp32 (full scores would take 34 GB), timed
    beside the chunked plain and SDPA with the same boolean mask."""
    rows = {}
    if not takes_window(K):
        return rows
    ref, h, g, hd = K["ref"], 32, 8, 128
    it = torch.empty((), dtype=dtype).element_size()
    c = WINDOW_SMALL
    q, k, v = flash_case(dev, gen, dtype, 2, c["S"], c["S"])
    ln = torch.tensor(c["lengths"], device=dev, dtype=torch.int32)
    errs = []
    for w in c["windows"]:
        out = K["flash"](q, k, v, ln, True, w)
        errs.append(compare(out, ref.flash_attention_ref(q, k, v, ln, True,
                                                         w), dtype))
        edge = c["lengths"][1] + w - 1
        if w and float(out[1, edge:].float().abs().sum()) != 0.0:
            raise AssertionError(f"flash W={w}: rows past the window are "
                                 f"not 0")
    print(f"kernels: flash_window  {str(dtype)[6:]:<8} max_abs_err="
          f"{max(errs):.3e} tol={TOL[dtype]:g}xmax|plain| per row h=32 g=8 "
          f"hd=128 causal B=2 S=T={c['S']} lengths={c['lengths']} W="
          f"{'/'.join(map(str, c['windows']))}, empty-window rows=0 ok")
    del q, k, v
    if dtype != torch.bfloat16:
        return rows
    S, w = WINDOW_LONG["S"], WINDOW_LONG["window"]
    q, k, v = flash_case(dev, gen, dtype, 1, S, S)
    ln = torch.full((1,), S, device=dev, dtype=torch.int32)
    shape = (f"causal window={w} B=1 S=T={S} length={S} h=32 g=8 hd=128 "
             f"(plain: chunked, chunk 2048)")
    out = K["flash"](q, k, v, ln, True, w)
    exact = ref.flash_attention_ref(q.float(), k.float(), v.float(), ln,
                                    True, w, chunk=1024)
    err = compare(out, exact, dtype)
    print(f"kernels: flash_window  {str(dtype)[6:]:<8} max_abs_err={err:.3e}"
          f" tol={TOL[dtype]:g}xmax|plain| per row against the chunked fp32"
          f" plain, long_500k shape {shape}; worst row err/max|plain| "
          f"{worst_row(out, exact):.4f} ok")
    del out, exact
    if not timing:
        return rows
    nbytes, flops = flash_work(S, [S], h, g, hd, it, w)
    bms, by = bound(nbytes, flops, dtype)
    j = torch.arange(S, device=dev)
    mask = (j[None, :] <= j[:, None]) & (j[:, None] - j[None, :] < w)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        lib = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                   enable_gqa=True), warmup=1)
    except torch.OutOfMemoryError:
        lib = None          # no SDPA backend held the masked 16k call
    rows[f"flash_attention window={w}"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: K["flash"](q, k, v, ln, True, w)),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(
            q, k, v, ln, True, w, chunk=2048), iters=2, warmup=1,
            eager=True),
        library_ms=lib, bound_ms=bms, bound_by=by, shape=shape)
    print(f"window: flash_attention bf16 {shape}: visible keys a head "
          f"{visible_keys(S, w)} of {visible_keys(S)} without the window, "
          f"flops={flops} bytes={nbytes}")
    del q, k, v, qt, kt, vt, mask
    return rows


def window_batches(cfg, dev, seed=7):
    """Phase 13's mixed tick, from numpy seeds: a cold prefill of two
    24-token prompts (rows 0-1), then ft rows of 40 and 29 tokens (past
    the window), a cold 13-token prompt in a 16-token bucket (row 2) and
    decode of rows 0-1 at position 24; a cross model's ft and prefill
    rows carry sources."""
    from repro_torch.models.schema import cross_len
    from repro_torch.models.stream import DECBatch, FTBatch, PFBatch
    rng = np.random.default_rng(seed)
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    i32 = lambda x: on(np.asarray(x, np.int32))

    def aux(B):
        if not is_cross(cfg):
            return None
        return on(rng.standard_normal((B, cross_len(cfg), cfg.d_model),
                                      dtype=np.float32))

    pf1 = PFBatch(tokens=i32(rng.integers(0, cfg.vocab, (2, 24))),
                  length=i32([24, 24]), adapter=i32([0, 1]), aux_embed=aux(2))
    Sf, lens = 40, (40, 29)
    toks = np.zeros((2, Sf), np.int32)
    mask = np.zeros((2, Sf), bool)
    labels = np.full((2, Sf), -100, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab, n)
        mask[i, :n], labels[i, :n] = True, toks[i, :n]
    ft = FTBatch(tokens=i32(toks), mask=on(mask), labels=i32(labels),
                 adapter=i32([0, 1]), weight=on(np.array([0.5, 1.0],
                                                         np.float32)),
                 aux_embed=aux(2))
    ptoks = np.zeros((1, 16), np.int32)
    ptoks[0, :13] = rng.integers(0, cfg.vocab, 13)
    pf2 = PFBatch(tokens=i32(ptoks), length=i32([13]), adapter=i32([0]),
                  aux_embed=aux(1))
    dec = DECBatch(tokens=i32(rng.integers(0, cfg.vocab, 2)),
                   pos=i32([24, 24]), adapter=i32([1, 0]))
    return pf1, ft, pf2, dec


def parity_window(K, devices=("cuda", "cpu")):
    """Phase 13 at reduced size: each of ``WINDOW_ARCHS`` (numpy-seeded
    fp32 weights, two adapters) with ``sliding_window`` 16, on ``cuda``
    and ``cpu``: (a) the dense engine (a windowed model never pages) on
    prompts of 9, 14, 16 and 32 tokens (each fills or fits its bucket),
    24 new tokens each, so decode runs past the window: greedy tokens and
    steps equal; (b) ``window_batches``' prefill, then one grad step over
    its mixed tick (ft rows longer than the window): pf and dec logits
    within 1e-3 of max(1, max |cpu|), the loss within 1e-4 relative, every
    bank gradient within 1e-3 of its leaf's max |cpu|.  On the card a GQA
    config launches SMLM, BGMV, flash and dense decode and no paged
    kernel; MLA no GQA attention kernel."""
    from repro_torch.checkpoint.io import bank_from_numpy, params_from_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    from repro_torch.core.unified import make_grad_step
    from repro_torch.models.model import init_cache, unified_forward
    from repro_torch.models.stream import UnifiedBatch
    from repro_torch.serving.engine import EngineConfig
    from repro_torch.serving.kvcache import CacheManager
    from repro_torch.serving.request import Request
    for arch in WINDOW_ARCHS:
        cfg = get_reduced(arch).replace(sliding_window=WINDOW_REDUCED)
        lcfg = LoRAConfig(n_slots=4, r=8, **(
            dict(targets=cross_targets()) if is_cross(cfg) else {}))
        flat = numpy_weights(cfg, seed=0)
        ad = {f"lora{i}": numpy_adapter(cfg, lcfg, seed=10 + i)
              for i in range(2)}
        rng = np.random.default_rng(12)
        prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
                   for n in (9, 14, 16, 32)]
        got = {}
        for dev in devices:
            d = torch.device(dev)
            params = params_from_numpy(flat, device=dev)
            adapters = {n: bank_from_numpy(f, device=dev)
                        for n, f in ad.items()}
            eng = build_engine(cfg, params, adapters, lcfg, d,
                               torch.float32, EngineConfig(
                                   capacity=4, pf_capacity=2, s_max=64,
                                   virtual_time=True))
            if eng.paged or not isinstance(eng.cachemgr, CacheManager):
                raise AssertionError(f"{arch}: a windowed model paged")
            reqs = [Request(rid=i, prompt=p, adapter=f"lora{i % 2}",
                            max_new_tokens=24, arrival=0.1 * i)
                    for i, p in enumerate(prompts)]
            if is_cross(cfg):
                add_aux(reqs, cfg, seed=23)
            reset_counts(K)
            for r in reqs:
                eng.submit(r)
            eng.run(max_ticks=10000)
            served = read_counts(K)
            if not eng.cachemgr.pristine:
                raise AssertionError(f"{arch} {dev}: rows not pristine")
            store = eng.model.store
            pf1, ft, pf2, dec = window_batches(cfg, d)
            cache = init_cache(cfg, 3, 64, d, torch.float32)
            kw = dict(loras=store.bank, lora_scale=store.scale, block_t=8)
            with torch.inference_mode():
                unified_forward(cfg, params, UnifiedBatch(pf=pf1), cache,
                                **kw)
            reset_counts(K)
            res = make_grad_step(cfg, block_t=8)(
                params, store.bank, store.scale,
                UnifiedBatch(ft=ft, pf=pf2, dec=dec), cache)
            got[dev] = dict(
                tokens={r.rid: list(r.output) for r in eng.finished},
                steps=eng.metrics.steps, served=served,
                stepped=read_counts(K), loss=float(res.loss),
                pf=res.out.pf_logits.float().cpu(),
                dec=res.out.dec_logits.float().cpu(),
                grads=[{t: {ab: x.float().cpu() for ab, x in g.items()}
                        for t, g in layer.items()}
                       for layer in res.grads["layers"]])
            del eng, store, cache, res
        a, b = got[devices[0]], got[devices[1]]
        if a["tokens"] != b["tokens"] or a["steps"] != b["steps"] \
                or len(a["tokens"]) != 4:
            raise AssertionError(f"parity window {arch}: tokens or steps "
                                 f"differ: {a['tokens']} {b['tokens']}")
        errs = {k: float((a[k] - b[k]).abs().max())
                / max(1.0, float(b[k].abs().max())) for k in ("pf", "dec")}
        loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        grad_rel = max(float((la[t][ab] - lb[t][ab]).abs().max())
                       / max(float(lb[t][ab].abs().max()), 1e-12)
                       for la, lb in zip(a["grads"], b["grads"])
                       for t in la for ab in ("a", "b"))
        if max(errs.values()) > 1e-3 or loss_rel > 1e-4 or grad_rel > 1e-3:
            raise AssertionError(f"parity window {arch}: logits {errs}, "
                                 f"loss {loss_rel:.3e}, grads "
                                 f"{grad_rel:.3e}")
        if devices[0] == "cuda":
            check_routes(f"parity window {arch} served", cfg, a["served"],
                         ("smlm", "bgmv", "flash", "dense_decode"))
            check_routes(f"parity window {arch} grad step", cfg,
                         a["stepped"], ("smlm", "bgmv", "flash",
                                        "dense_decode", "smlm_wgrad"))
            paged = {k: a["served"][k] + a["stepped"][k]
                     for k in ("decode", "prefill", "verify", "partials")}
            if any(paged.values()) or not a["stepped"]["smlm_wgrad"]:
                raise AssertionError(f"parity window {arch}: paged kernels "
                                     f"{paged} or no smlm_wgrad")
        print(f"parity: window {arch} reduced fp32 sliding_window="
              f"{WINDOW_REDUCED} dense rows of {WINDOW_REDUCED} slots "
              f"(L={cfg.n_layers} d={cfg.d_model} mla={cfg.mla is not None}"
              f" mamba={'mamba' in cfg.pattern} cross={is_cross(cfg)}), "
              f"cuda==cpu greedy tokens for 4 requests (96 tokens, decode "
              f"past the window), steps={a['steps']}; mixed-tick grad step "
              f"(ft rows of 40 and 29 tokens): pf/dec logits max_rel_err="
              f"{errs['pf']:.3e}/{errs['dec']:.3e} tol=1e-3, loss "
              f"max_rel_err={loss_rel:.3e} tol=1e-4, grads max_rel_err="
              f"{grad_rel:.3e} tol=1e-3, cuda launches served="
              f"{ {k: v for k, v in a['served'].items() if v} } grad step="
              f"{ {k: v for k, v in a['stepped'].items() if v} } ok")


def window_config():
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import SHAPES, adapt_config
    return adapt_config(get_config("llama3-8b"), SHAPES["long_500k"])


def full_window(K, cfg, weights, dev, prompts=(16384, 4096), max_new=32,
                seed=5):
    """Phase 13 at full width: llama3-8b under ``adapt_config(...,
    SHAPES["long_500k"])`` (window 8192, bf16) through the engine with
    capacity 2, pf_capacity 2 and s_max 32768, which serves it on dense
    rolling rows of 8192 slots: a 16384-token prompt (exactly its bucket),
    then, once it decodes, a 4096-token prompt (its own bucket: in one
    bucket with the first it would pad to 16384, past the row, and take the
    mirrored rolling write), 32 new tokens each.  Windowed flash and dense
    decode must launch, and no paged kernel."""
    from repro_torch.serving.kvcache import CacheManager
    from repro_torch.serving.request import Request
    W = cfg.sliding_window
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng, seen, ticks, tick = timed_engine(cfg, weights, capacity=2,
                                          pf_capacity=2, s_max=32768)
    slots = eng.cachemgr.cache["k"].shape[2]
    if eng.paged or not isinstance(eng.cachemgr, CacheManager) \
            or slots != W:
        raise AssertionError(f"the windowed engine is not on dense rows of "
                             f"{W} slots: paged={eng.paged} slots={slots}")
    rows_bytes = sum(x.numel() * x.element_size()
                     for x in eng.cachemgr.cache.values())
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), adapter=f"lora{i}", max_new_tokens=max_new)
        for i, n in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    # the caching allocator's state as the arm finds it (earlier phases
    # leave their segments cached) and what the arm asks of the device
    reserved = torch.cuda.memory_reserved()
    stats0 = torch.cuda.memory_stats()
    reset_counts(K)
    run_waves(eng, tick, [[r] for r in reqs])
    counts = read_counts(K)
    peak = torch.cuda.max_memory_allocated()
    stats1 = torch.cuda.memory_stats()
    alloc = {k: stats1.get(k, 0) - stats0.get(k, 0)
             for k in ("num_alloc_retries", "num_device_alloc",
                       "num_device_free")}
    check_drained(eng, seen, len(reqs), max_new)
    never = ("decode", "prefill", "verify", "partials", "merge")
    if min(counts[k] for k in ("smlm", "bgmv", "flash", "dense_decode")) \
            == 0 or any(counts[k] for k in never):
        raise AssertionError(f"the windowed arm did not run windowed flash "
                             f"and dense decode alone: {counts}")
    dec = [t * 1e3 for t, p, *_ in ticks if not p]
    q = np.percentile(dec, [0, 10, 50, 90, 100])
    split = [(round(e * 1e3, 3), round(w * 1e3, 3))
             for _, p, _, e, w in ticks if p]
    print(f"window: {cfg.name} bf16 sliding_window={W} (adapt_config "
          f"long_500k) paged=False dense rows of {slots} slots capacity=2 "
          f"pf_capacity=2 s_max=32768 prompts={list(prompts)} (the second "
          f"submitted once the first decodes) tokens_each={max_new} steps="
          f"{len(ticks)} prefill_tick_ms="
          f"{[round(t * 1e3, 3) for t, p, *_ in ticks if p]} (forward "
          f"enqueue + device wait {split}; prefill tokens "
          f"{[p for _, p, *_ in ticks if p]}) "
          f"{tick_stats(ticks)} "
          f"decode_tick_ms min/p10/p50/p90/max="
          f"{'/'.join(f'{x:.3f}' for x in q)} rows_bytes={rows_bytes} "
          f"weights_and_rows_gb={base / 1e9 + rows_bytes / 1e9:.3f} "
          f"peak_gb={peak / 1e9:.3f} reserved_before_gb={reserved / 1e9:.3f}"
          f" allocator={alloc} launches="
          f"{ {k: v for k, v in counts.items() if v} } finite=True "
          f"pristine=True ok")
    del eng
    return counts


def window_identity(cfg, weights, dev, n=16384, seed=6):
    """Phase 13, the window's identity at full width (the JAX package's
    ``test_cache_equivalence.py`` windowed test): path A prefills n tokens
    into a rolling row of W slots and decodes token n through
    ``unified_forward``; path B prefills all n + 1 tokens cold (a bucket
    of n + 8, the rows past n + 1 padding) and reads no cache, so the
    padded-bucket write cannot reach its logits.  bf16, adapter lora0:
    equal argmax, and max |A - B| within ``WINDOW_LOGIT_TOL`` x max
    |B|."""
    from repro_torch.models.model import init_cache, unified_forward
    from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch
    params, store, _ = weights
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, n + 8).astype(
        np.int32)).to(dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    adapter = i32([store.slot_of("lora0")])
    kw = dict(loras=store.bank, lora_scale=store.scale, block_t=8)
    dt = params["final_norm"].dtype
    with torch.inference_mode():
        cache = init_cache(cfg, 1, n + 8, dev, dt)
        unified_forward(cfg, params, UnifiedBatch(pf=PFBatch(
            tokens=toks[None, :n], length=i32([n]), adapter=adapter)),
            cache, **kw)
        a = unified_forward(cfg, params, UnifiedBatch(dec=DECBatch(
            tokens=toks[n:n + 1], pos=i32([n]), adapter=adapter)), cache,
            **kw).dec_logits.float()
        cache = init_cache(cfg, 1, n + 8, dev, dt)
        b = unified_forward(cfg, params, UnifiedBatch(pf=PFBatch(
            tokens=toks[None], length=i32([n + 1]), adapter=adapter)),
            cache, **kw).pf_logits.float()
        del cache
    err = float((a - b).abs().max())
    lim = WINDOW_LOGIT_TOL * float(b.abs().max())
    top = torch.topk(b[0], 2).values
    if int(a.argmax()) != int(b.argmax()) or err > lim:
        raise AssertionError(f"window identity: argmax A {int(a.argmax())} "
                             f"B {int(b.argmax())}, max err {err:.4f} > "
                             f"{lim:.4f}?")
    print(f"window: identity at full width, W={cfg.sliding_window}: path A "
          f"(prefill {n} into a rolling row, decode token {n}) vs path B "
          f"(cold prefill of {n + 1}): argmax equal ({int(b.argmax())}), "
          f"max_abs_err={err:.4f} tol={WINDOW_LOGIT_TOL:g}xmax|B|="
          f"{lim:.4f}, B's top1-top2 gap={float(top[0] - top[1]):.4f} ok")


def window_phase(K, weights, dev):
    """Phase 13: the reduced parity, the full-width arm and the identity;
    returns the arm's counts."""
    parity_window(K)
    cfg = window_config()
    counts = full_window(K, cfg, weights, dev)
    window_identity(cfg, weights, dev)
    return counts


# ------------------------------------------------- phase 14: the examples
EXAMPLES = ("quickstart", "migration", "multi_finetune", "unified_serving")
# the kernels each twin's path must launch at full width (PERF.md's table);
# paged prefill (dedup hits) and split-K (the split chooser) are counted,
# not gated
EXAMPLE_KERNELS = {"quickstart": ("smlm", "flash"),
                   "migration": ("smlm", "smlm_wgrad"),
                   "multi_finetune": ("smlm", "smlm_wgrad"),
                   "unified_serving": ("smlm", "bgmv", "decode", "flash",
                                       "smlm_wgrad")}
# full-width depth of each twin (llama3-8b has 32 layers): the two longest
# runs at 16 keep phase 14 near 90 s (at 32, on an H100, their runs took
# 21.7 and 35.6 s)
EXAMPLE_LAYERS = {"quickstart": 32, "migration": 32, "multi_finetune": 16,
                  "unified_serving": 16}
EXAMPLE_LOSS_RTOL = 1e-5        # fp32 CUDA vs CPU losses, relative


def twin(name):
    """The example twin ``examples/<name>_torch.py``."""
    return _load_file(f"_smoke_{name}_torch", "examples", f"{name}_torch.py")


def same_outputs(label, got, want, key=""):
    """A twin's ``run`` on ``cuda`` against ``cpu``: floats (losses, SLO
    attainment) within ``EXAMPLE_LOSS_RTOL`` relative, everything else
    (tokens, slots, resident lists, counts, payload bytes) equal; the
    wall-clock rates are skipped.  Returns the worst relative float
    difference."""
    if isinstance(want, dict):
        if got.keys() != want.keys():
            raise AssertionError(f"{label}{key}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        return max([same_outputs(label, got[k], want[k], f"{key}/{k}")
                    for k in want if not str(k).startswith("rates")],
                   default=0.0)
    if isinstance(want, float) or (isinstance(want, list) and want
                                   and isinstance(want[0], float)):
        g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if g.shape != w.shape:
            raise AssertionError(f"{label}{key}: {g.shape} != {w.shape}")
        rel = float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30),
                           initial=0.0))
        if not rel <= EXAMPLE_LOSS_RTOL:
            raise AssertionError(f"{label}{key}: cuda {got} vs cpu {want}, "
                                 f"{rel:.3e} relative > "
                                 f"{EXAMPLE_LOSS_RTOL:g}")
        return rel
    equal = (np.array_equal(got, want) if isinstance(want, np.ndarray)
             else got == want)
    if not equal:
        raise AssertionError(f"{label}{key}: cuda {got} != cpu {want}")
    return 0.0


def parity_examples():
    """Phase 14, part 1: each twin's ``run`` on the reduced llama3-8b in
    fp32 on ``cuda`` and on ``cpu`` with the same numpy weights."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.lora import LoRAConfig
    small = get_reduced("llama3-8b")
    lcfg = LoRAConfig(n_slots=4, r=8)
    flat = numpy_weights(small, seed=0)
    for name in EXAMPLES:
        mod = twin(name)
        weights = {"params": flat, "adapters": {
            a: numpy_adapter(small, lcfg, seed=10 + i)
            for i, a in enumerate(mod.ADAPTERS)}}
        secs, outs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            outs[dev] = mod.run(small, dev, torch.float32, weights=weights)
            secs[dev] = time.perf_counter() - t0
        worst = same_outputs(f"parity {name}", outs["cuda"], outs["cpu"])
        print(f"examples: parity {name} {small.name} fp32 cuda==cpu "
              f"(tokens, slots, resident lists, counts and payload bytes "
              f"equal; losses max_rel_err={worst:.3e} "
              f"tol={EXAMPLE_LOSS_RTOL:g}) cuda_s={secs['cuda']:.3f} "
              f"cpu_s={secs['cpu']:.3f} ok")


def timed_engine_class(engines, ticks):
    """A ``UnifiedEngine`` that keeps itself in ``engines`` and times its
    ticks into ``ticks``: (seconds, forward or grad step enqueue seconds,
    device wait seconds, prefill tokens, decode tokens, ft and eval tokens)
    of each tick that ran a step, the wait being a synchronize right after
    the step (the tick's token or loss read would wait a moment later
    anyway)."""
    from repro_torch.serving.engine import UnifiedEngine

    class TimedEngine(UnifiedEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)
            self.split = []
            for name in ("forward_step", "grad_step"):
                def timed(*args, _step=getattr(self, name)):
                    t0 = time.perf_counter()
                    out = _step(*args)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    self.split.append((t1 - t0, time.perf_counter() - t1))
                    return out
                setattr(self, name, timed)

        def tick(self):
            m = self.metrics
            self.split.clear()
            before = (m.prefill_tokens, m.decode_tokens,
                      m.finetune_tokens + m.eval_tokens)
            t0 = time.perf_counter()
            busy = super().tick()
            torch.cuda.synchronize()
            if self.split:
                after = (m.prefill_tokens, m.decode_tokens,
                         m.finetune_tokens + m.eval_tokens)
                ticks.append((time.perf_counter() - t0,
                              sum(e for e, _ in self.split),
                              sum(w for _, w in self.split),
                              *(b - a for a, b in zip(before, after))))
            return busy

    return TimedEngine


def example_summary(name, out) -> str:
    """A twin's results for its ``examples:`` line, after its gates: every
    request finished with its tokens, every trainer took optimizer steps
    with finite losses."""
    if name == "quickstart":
        if out["after_hot_swap"] != ["math", "code"] or \
                out["next_tokens"].shape != (3,):
            raise AssertionError(f"quickstart: {out}")
        return (f"next_tokens={out['next_tokens'].tolist()} resident="
                f"{out['resident']} after_hot_swap={out['after_hot_swap']} "
                f"migrated_slot={out['migrated_slot']}")
    if name == "migration":
        losses = out["losses_A"] + out["losses_B"]
        if not (out["opt_steps_A"] == out["opt_steps_B"] >= 1
                and np.isfinite(losses).all()):
            raise AssertionError(f"migration: {out}")
        return (f"tokens_trained A={out['tokens_A']} B={out['tokens_B']} "
                f"opt_steps={out['opt_steps_A']} loss A={out['loss_A']:.4f}"
                f" B={out['loss_B_first']:.4f}->{out['loss_B_last']:.4f} "
                f"payload_bytes={out['payload_bytes']}")
    if name == "multi_finetune":
        parts = []
        for tname, tr in out["trainers"].items():
            if tr["opt_steps"] < 1 or not np.isfinite(
                    tr["train_losses"] + tr["eval_losses"]).all():
                raise AssertionError(f"multi_finetune {tname}: {tr}")
            parts.append(f"{tname}: tokens_trained={tr['tokens_trained']} "
                         f"opt_steps={tr['opt_steps']} loss "
                         f"{tr['loss_first']:.4f}->{tr['loss_last']:.4f} "
                         f"eval {tr['eval']:.4f}")
        return "; ".join(parts)
    if out["finished"] != 30 or any(len(t) != 12
                                    for t in out["tokens"].values()) \
            or out["opt_steps"] < 1 or not np.isfinite(
                out["train_losses"]).all():
        raise AssertionError(f"unified_serving: {out}")
    return (f"slo_attainment={out['slo']:.3f} finished={out['finished']}/30"
            f" student tokens_trained={out['tokens_trained']} opt_steps="
            f"{out['opt_steps']} loss {out['loss_first']:.4f}->"
            f"{out['loss_last']:.4f}")


def tick_ms(recs) -> str:
    """Count, mean and p50 ms of tick records (seconds, enqueue seconds,
    device wait seconds, ...), with the mean enqueue and device wait."""
    if not recs:
        return "n=0"
    return (f"{ms_stats([r[0] for r in recs])} (enqueue "
            f"{np.mean([r[1] for r in recs]) * 1e3:.3f} + device wait "
            f"{np.mean([r[2] for r in recs]) * 1e3:.3f})")


def example_ticks(ticks) -> str:
    """Every timed tick, then the decode-only ticks, the ticks with prefill
    rows and the ticks with ft or eval rows: count, mean and p50 ms, and
    the step's enqueue and device wait."""
    if not ticks:
        return "ticks=0 (one forward, no engine)"
    parts = [("ticks", ticks),
             ("decode_only", [t for t in ticks if not t[3] and not t[5]]),
             ("with_prefill", [t for t in ticks if t[3]]),
             ("with_ft", [t for t in ticks if t[5]])]
    return " ".join(f"{label}: {tick_ms(ts)}" for label, ts in parts)


def full_examples(K, dev):
    """Phase 14, part 2: each twin at full width (llama3-8b in bf16, at
    ``EXAMPLE_LAYERS``), its weights drawn on the card from phase 4's
    seeds; one ``examples:`` line each.  Returns the launch counts summed
    over the four runs."""
    from repro_torch.configs import get_config
    full = get_config("llama3-8b")
    total = {k: 0 for k in COUNTERS}
    for name in EXAMPLES:
        mod = twin(name)
        cfg = full.replace(n_layers=EXAMPLE_LAYERS[name])
        engines, ticks = [], []
        if hasattr(mod, "UnifiedEngine"):
            mod.UnifiedEngine = timed_engine_class(engines, ticks)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(K)
        t0 = time.perf_counter()
        out = mod.run(cfg, dev, torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(K)
        check_routes(f"examples {name}", cfg, counts, EXAMPLE_KERNELS[name])
        if not all(e.cachemgr.pristine for e in engines):
            raise AssertionError(f"examples {name}: a pool is not pristine")
        print(f"examples: {name} {cfg.name} bf16 L={cfg.n_layers} of "
              f"{full.n_layers} wall_s={wall:.3f} {example_ticks(ticks)} "
              f"{example_summary(name, out)} peak_alloc_gib="
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} launches="
              f"{ {k: v for k, v in counts.items() if v} } ok")
        for k in total:
            total[k] += counts[k]
        # the engine class holds ``engines``, and they the weights
        engines.clear()
        sys.modules.pop(mod.__name__)
        del mod, out
        gc.collect()
        torch.cuda.empty_cache()
    return total


def costs_lines(measured):
    """Phase 14, part 3: the port's ``step_cost`` (one card: dp 1, tp 1,
    whole weights) and its ``Roofline`` bound for phase 4's decode ticks
    over 512 slots (4 rows, and each other row count its decode-only ticks
    had) and its 144-token cold prefill tick (4 rows), phase 6's
    3000-token prefill and phase 8's grad step, each beside the ticks
    measured in this run (``measured``; empty under ``--examples``).  One
    card sends no collective, so the bound is the larger of the compute
    and the memory term."""
    from repro_torch.configs import get_config
    from repro_torch.models.costs import step_cost
    cfg = get_config("llama3-8b")
    grad, decode = measured.get("grad_step"), measured.get("decode", {})
    cases = [("decode", "decode", 512, rows, decode.get(rows))
             for rows in sorted({4, *decode})]
    cases += [("prefill", "prefill", 144, 4, measured.get("prefill")),
              ("long_prefill", "prefill", 3000, 1,
               measured.get("long_prefill"))]
    if grad:
        cases.append(("grad_step", "train",
                      -(-grad["tokens"] // grad["rows"]), grad["rows"],
                      grad))
    for label, kind, seq, batch, got in cases:
        c = step_cost(cfg, kind, seq, batch, dp=1, tp=1, strategy="tp")
        r = RA.Roofline(c.flops, c.hbm_bytes, c.coll_bytes, chips=1)
        bound_ms = max(r.compute_s, r.memory_s) * 1e3
        head = (f"costs: {label} {cfg.name} bf16 step_cost(kind={kind}, "
                f"seq_len={seq}, batch={batch}, dp=1, tp=1, strategy=tp): "
                f"flops={c.flops:.6e} hbm_bytes={c.hbm_bytes:.6e} "
                f"compute_ms={r.compute_s * 1e3:.4f} memory_ms="
                f"{r.memory_s * 1e3:.4f} bound_ms={bound_ms:.4f} "
                f"({'compute' if r.compute_s >= r.memory_s else 'memory'})")
        if not got:
            print(f"{head}; measured: not run in this call (phases 4, 6 "
                  f"and 8 run in the whole smoke)")
            continue
        if label in ("decode", "prefill"):
            mean = np.mean([t for t, _, _ in got]) * 1e3
            print(f"{head}; measured {tick_ms(got)} bound_share_of_mean="
                  f"{bound_ms / mean:.4f}")
        elif label == "long_prefill":
            wall, busy, recs = got
            print(f"{head}; measured (profiled tick) wall_ms={wall:.3f} "
                  f"device_busy_ms={busy:.3f} {tick_ms(recs)} "
                  f"bound_share_of_wall={bound_ms / wall:.4f} "
                  f"bound_share_of_busy={bound_ms / busy:.4f}")
        else:
            print(f"{head}; measured {got['tokens']} tokens in "
                  f"{got['rows']} rows: profiled wall_ms={got['wall_ms']:.3f}"
                  f" device_busy_ms={got['busy_ms']:.3f}, unprofiled "
                  f"{ms_stats(got['again'])} bound_share_of_mean="
                  f"{bound_ms / (np.mean(got['again']) * 1e3):.4f} "
                  f"bound_share_of_busy={bound_ms / got['busy_ms']:.4f}")


def examples_phase(K, dev, measured):
    """Phase 14: the twins' reduced parity, their full-width runs and the
    ``costs:`` lines; returns the full-width runs' launch counts."""
    parity_examples()
    counts = full_examples(K, dev)
    costs_lines(measured)
    return counts


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
    # the gradient of kernel 1: the JAX package has no Pallas backward
    "smlm_wgrad": ("src/repro_torch/kernels/csrc/smlm_grad.cu",
                   "src/repro/kernels/smlm.py:39"),
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
           "dense_decode": ("dense_decode", "dense"),
           "smlm_wgrad": ("smlm_wgrad", "train")}


# ------------------------------------------------------- phase 15: the mesh
MESH_TIMEOUT_S = 300     # every process group's collectives, and the join
# the launch counters of the split SMLM / BGMV entries (every sharded step)
SPLIT_COUNTERS = ("smlm_shrink", "smlm_expand", "bgmv_shrink",
                  "bgmv_expand")
# what every rank of a sharded step must launch: the split LoRA entries,
# flash (cold prefill) and dense decode; an MLA model the split entries
# and split-K's merge kernel (its decode merges every head's partials
# across the model axis), no GQA attention kernel
MESH_NEED = SPLIT_COUNTERS + ("flash", "dense_decode")
MLA_NEED = SPLIT_COUNTERS + ("merge",)
# KV rows cut by the head dim: decode is plain PyTorch over the partial
# scores' all-reduce (no single-rank kernel computes a score cut over
# ranks); by the slots: split-K's partial and merge kernels
HD_NEED = SPLIT_COUNTERS + ("flash",)
SEQ_NEED = SPLIT_COUNTERS + ("flash", "partials", "merge")
# a stack of Mamba2 layers alone (mamba2-1.3b): the split entries (its mixer
# is plain PyTorch, as the JAX model's is jnp); jamba's attention layer
# adds flash and dense decode (MESH_NEED)
SSM_NEED = SPLIT_COUNTERS


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_group(rank: int, world: int, port: int) -> None:
    """NCCL over ``world`` local ranks, each on its own card, at
    ``tcp://127.0.0.1:port``; collectives time out after
    ``MESH_TIMEOUT_S``."""
    import datetime
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))


def mesh_prompts(cfg, B, S, seed):
    """B prompts of S tokens from a numpy seed, adapters 0, 1, base, 0,
    ..., and for a cross model each prompt's cross source [F, d] float32
    (image patches or audio frames, a standard normal; else None)."""
    from repro_torch.models.schema import cross_len
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    ad = np.asarray([(0, 1, -1, 0)[i % 4] for i in range(B)], np.int32)
    aux = (rng.standard_normal((B, cross_len(cfg), cfg.d_model),
                               dtype=np.float32) if is_cross(cfg) else None)
    return toks, np.full((B,), S, np.int32), ad, aux


def mesh_weights(cfg, mesh, strategy, dev, dtype=torch.bfloat16, seed=0,
                 int8=False):
    """This rank's shards of the weights one card draws from ``seed``
    (params leaf by leaf, ``checkpoint.io.init_sharded_params``; with
    ``int8`` each eligible leaf quantized whole before it is cut; a cross
    layer's gate ``XGATE``) and of a bank of two gaussian-B adapters (r 8;
    a cross model's over ``xwq`` / ``xwo`` too) drawn whole from ``seed +
    100``; whole on one card (``mesh`` None or of one rank)."""
    from repro_torch.checkpoint.io import init_sharded_params, shard_bank
    from repro_torch.core.lora import LoRAConfig, init_lora_bank
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.schema import init_params, lora_targets
    lcfg = LoRAConfig(n_slots=4, r=8, targets=cross_targets()
                      if is_cross(cfg) else LoRAConfig().targets)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    spread = mesh is not None and mesh.size > 1
    if spread or int8:
        params = init_sharded_params(
            cfg, mesh if spread else make_local_mesh(), strategy or "tp",
            gen, dev, dtype, quantized=int8)
    else:
        params = init_params(cfg, gen, device=dev, dtype=dtype)
    for layer in params["layers"]:
        if "xgate" in layer:
            layer["xgate"].fill_(XGATE)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 100)
    bank = init_lora_bank(lora_targets(cfg, lcfg.targets), lcfg, g, dev,
                          dtype, gaussian_b=True)
    for layer in bank["layers"]:        # slots 2 and 3 stay empty
        for ab in layer.values():
            ab["a"][2:].zero_()
            ab["b"][2:].zero_()
    if spread:
        bank = shard_bank(bank, mesh)
    scale = torch.ones(lcfg.n_slots, device=dev)
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    return params, bank, scale


def mesh_generate(cfg, step, weights, mesh, prompts, n_decode, dev,
                  dtype=torch.bfloat16, profile=False, cache_strategy="auto",
                  s_max=None):
    """A cold prefill of the prompt rows into dense rows (this rank's shard
    of them under a mesh: ``sharding.shard_cache``), then ``n_decode``
    greedy decode steps, every logit row on the host.  Returns the rows
    ({rid: [(token, logits)]}), the step records (seconds, enqueue, device
    wait), the collective bytes of the prefill and of the last decode step,
    and on a card this rank's resident (weights, bank, cache) and peak
    bytes over the whole run (``roofline.analysis.memory_summary``).  With
    ``profile`` one more decode step (the last one's inputs again, its
    logits unused) runs under ``torch.profiler``, whose host and device
    top operations come back as ``profile``.  The rows hold ``s_max``
    slots (default: the prompt and its decode steps), cut under
    ``cache_strategy``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models.model import init_cache
    from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch
    toks, lens, ad, aux = prompts
    B, S = toks.shape
    cache = init_cache(cfg, B, s_max or S + n_decode, dev, dtype)
    if mesh is not None:
        cache = SH.shard_cache(cfg, cache, mesh, strategy=cache_strategy)
    params, bank, scale = weights
    length = torch.tensor(lens, device=dev)
    adapter = torch.tensor(ad, device=dev)
    rows = {r: [] for r in range(B)}
    recs, coll = [], {}
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    def run(batch, cache, label):
        SH.reset_collective_log()
        t0 = time.perf_counter()
        out = step(params, bank, scale, batch, cache)
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        coll[label] = SH.collective_log()
        recs.append((t2 - t0, t1 - t0, t2 - t1))
        return out

    def generate():
        out = run(UnifiedBatch(pf=PFBatch(
            tokens=torch.tensor(toks, device=dev), length=length,
            adapter=adapter, aux_embed=None if aux is None else
            torch.tensor(aux, device=dev))), cache, "prefill")
        logits, last = out.pf_logits, None
        for i in range(n_decode + 1):
            lg = logits.float().cpu()
            tok = lg.argmax(-1)
            for r in range(B):
                rows[r].append((int(tok[r]), lg[r]))
            if i == n_decode:
                break
            last = UnifiedBatch(dec=DECBatch(
                tokens=tok.to(dev, torch.int32), pos=length + i,
                adapter=adapter))
            out = run(last, out.cache, "decode")
            logits = out.dec_logits
        return out, last

    resident = peak = None
    if dev.type == "cuda":
        mem = RA.memory_summary(generate, state=[params, bank, cache],
                                device=dev)
        out, last = mem["out"]
        resident, peak = mem["argument_size_in_bytes"], mem["peak_bytes"]
    else:
        out, last = generate()
    prof = None
    if profile and n_decode:
        from torch.profiler import ProfilerActivity, profile as trace
        with trace(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            step(params, bank, scale, last, out.cache)
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        busy, names, _ = device_top(p)
        host = sorted((e for e in p.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:10]
        prof = (wall, busy, names, "; ".join(
            f"{e.key[:40]}={e.self_cpu_time_total / 1e3:.3f}ms/{e.count}"
            for e in host))
    return dict(rows=rows, prefill=recs[0], decode=recs[1:], coll=coll,
                resident=resident, peak=peak, profile=prof)


# the first-step logits of a many-layer bf16 arm against another layout:
# each row's max abs error within this share of its max |logit|.  The sound
# 4-card arms read 0.014-0.026 (NVIDIA H100 80GB HBM3, 700 W); every
# ``--mesh`` run also plants a sharding fault (``planted_fault``) and fails
# unless the gates below see it
MESH_LOGIT_LIMIT = 0.05
# the same share for an arm computed in fp32 (int8 weights dequantized to
# fp32): the sound fp32 arms read 3.8e-06 to 4.9e-05, mamba2's planted
# norm fault 1.142 (NVIDIA H100 80GB HBM3, 700 W)
MESH_FP32_LIMIT = 1e-3
MESH_LIMIT = {torch.bfloat16: MESH_LOGIT_LIMIT,
              torch.float32: MESH_FP32_LIMIT}
# a first divergence between two runs must be a near tie: both runs'
# top-1 minus top-2 gaps and own-token margins within this many bf16 ulps
# at the top logit (the sound 4-card arms read at most 3)
NEAR_TIE_ULPS = 8
# mamba2-1.3b's 48 layers in bf16 against one card: the bf16 mixer is
# itself ~1 % of a row off fp32 a layer (the ``ssd:`` record), so another
# rounding order (row-parallel out_proj partials summed in bf16, the SSD's
# products over a rank's heads) read worst rows of 0.0787 at (1, 4) and
# 0.0612 at (2, 2), first divergences up to 10 ulps apart; the planted
# norm fault read 1.142 (NVIDIA H100 80GB HBM3, 700 W)
MAMBA_BF16_LIMIT = 0.2
MAMBA_BF16_ULPS = 16
# the weights' and activations' name in the ``mesh:`` lines
DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "fp32"}


def compare_rows(label, ref_name, ref, name, got, n_tokens):
    """The first step's logits of ``got`` against ``ref`` (every later
    step's input depends on the tokens): the worst row's max abs error as a
    share of that row's max |logit| (``worst_row``); the max abs logit
    difference over every step where both runs had fed the same tokens;
    and each request's first divergence in bf16 ulps (``divergences``).
    Prints them; returns (worst row, max abs difference, max ulps)."""
    first = torch.stack([got[r][0][1] for r in sorted(got)])
    want = torch.stack([ref[r][0][1] for r in sorted(ref)])
    err0 = float((first - want).abs().max())
    worst = worst_row(first, want)
    if not torch.isfinite(first).all():
        worst = float("inf")
    err = 0.0
    for r in ref:
        for (ta, la), (tb, lb) in zip(ref[r], got[r]):
            err = max(err, float((la - lb).abs().max()))
            if ta != tb:
                break
    print(f"{label}: first-step logits max_abs_err={err0:.4g}, worst row "
          f"{worst:.4g} of its max|{ref_name}|, max_abs_logit_diff over the "
          f"steps fed the same tokens={err:.4g}")
    ulps = max(divergences(label, ref_name, ref, name, got, n_tokens),
               default=0.0)
    return worst, err, ulps


def same_rows(label, ref_name, ref, name, got, dtype, n_tokens, limit=None,
              max_ulps=NEAR_TIE_ULPS):
    """``compare_rows``, gated: the worst first-step row within ``limit``
    (default ``TOL[dtype]``) and every first divergence a near tie (within
    ``max_ulps``).  Returns the max abs logit difference."""
    limit = TOL[dtype] if limit is None else limit
    worst, err, ulps = compare_rows(label, ref_name, ref, name, got,
                                    n_tokens)
    if worst > limit or ulps > max_ulps:
        raise AssertionError(
            f"{label}: worst first-step row {worst:.4g} of its max "
            f"|{ref_name}| (limit {limit:g}), a first divergence {ulps:.3g} "
            f"bf16 ulps apart (limit {max_ulps})")
    print(f"{label}: ok (worst row {worst:.4g} <= {limit:g}, divergences "
          f"<= {ulps:.3g} ulps <= {max_ulps})")
    return err


def mesh_counts(K, names=MESH_NEED):
    return {k: K[k].launches for k in names}


def mesh_reset(K):
    reset_counts(K)
    for k in SPLIT_COUNTERS:
        K[k].launches = 0


def step_cost_coll(cfg, kind, seq, batch, dp, tp, strategy):
    """``models.costs.step_cost``'s collective detail and Roofline bound."""
    from repro_torch.models.costs import step_cost
    c = step_cost(cfg, kind, seq, batch, dp=dp, tp=tp, strategy=strategy)
    r = RA.Roofline(c.flops, c.hbm_bytes, c.coll_bytes, chips=dp * tp)
    coll = {k[5:]: v for k, v in c.detail.items() if k.startswith("coll/")}
    return coll, max(r.compute_s, r.memory_s, r.collective_s) * 1e3, r


def gather_stats(obj):
    """Every rank's ``obj``, in rank order (on every rank)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def mesh_arm(K, label, cfg, mesh, strategy, prompts, n_decode, dev,
             seed=0, profile=False, int8=False, need=MESH_NEED,
             dtype=torch.bfloat16, cache_strategy="auto", s_max=None,
             attn_chunk=0):
    """One sharded arm on this rank: weights drawn and cut, prefill and
    greedy decode with the rows cut under ``cache_strategy``, the kernels
    of ``need`` (the split LoRA entries, flash and dense decode; MLA's: the
    split entries and the merge; ``HD_NEED`` / ``SEQ_NEED`` for rows cut by
    the head dim / the slots) launched on this rank (raises otherwise),
    and on rows cut by the slots split-K's merge once a layer (and a cross
    layer) a decode step.  ``attn_chunk``: the step's (MLA's long
    prefill).  Rank 0 prints the per-card lines.  Returns rank 0's result
    (None elsewhere)."""
    import torch.distributed as dist
    from repro_torch.core.unified import make_forward_step
    t0 = time.perf_counter()
    weights = mesh_weights(cfg, mesh, strategy, dev, dtype, seed=seed,
                           int8=int8)
    setup = time.perf_counter() - t0
    step = make_forward_step(cfg, block_t=K["block_t"], mesh=mesh,
                             strategy=strategy, cache_strategy=cache_strategy,
                             attn_chunk=attn_chunk)
    mesh_reset(K)
    res = mesh_generate(cfg, step, weights, mesh, prompts, n_decode, dev,
                        dtype, profile=profile, cache_strategy=cache_strategy,
                        s_max=s_max)
    counts = mesh_counts(K, need)
    del weights, step
    gc.collect()
    torch.cuda.empty_cache()
    if dev.type == "cuda" and min(counts.values()) == 0:
        raise AssertionError(f"{label} rank {dist.get_rank()}: a kernel of "
                             f"the sharded path did not launch: {counts}")
    terms = layout_terms(cfg, mesh, cache_strategy, prompts[0].shape[0],
                         s_max or prompts[0].shape[1] + n_decode, dtype, dev)
    steps = n_decode + (1 if profile and n_decode else 0)   # + profiled
    if dev.type == "cuda" and "seq" in terms["layouts"].values() and \
            counts["merge"] != steps * terms["seq_layers"]:
        raise AssertionError(f"{label} rank {dist.get_rank()}: split-K's "
                             f"merge launched {counts['merge']} times, not "
                             f"once a layer a decode step "
                             f"({steps} x {terms['seq_layers']})")
    stats = gather_stats(dict(resident=res["resident"], peak=res["peak"],
                              prefill=res["prefill"],
                              decode=res["decode"], coll=res["coll"],
                              counts=counts, setup=setup))
    if dist.get_rank() != 0:
        return None
    B, S = prompts[0].shape
    shape = "x".join(map(str, mesh.devices_shape))
    if res["profile"]:
        wall, busy, names, host = res["profile"]
        print(f"profile: mesh {label} {shape} {strategy} card 0, one decode "
              f"step: wall_ms={wall:.3f} device_busy_ms={busy:.3f}; device "
              f"top: {names}; host self-time top: {host}")
    for rank, st in enumerate(stats):
        pf, dec = st["prefill"], st["decode"]
        print(f"mesh: {label} {cfg.name} {'int8/' if int8 else ''}"
              f"{DTYPE_NAME[dtype]} {cfg.n_layers} layers "
              f"({shape}) {strategy} card {rank}: resident_bytes="
              f"{st['resident']} peak_bytes={st['peak']} prefill "
              f"B={B}x{S} ms={pf[0] * 1e3:.3f} (enqueue {pf[1] * 1e3:.3f} "
              f"+ device wait {pf[2] * 1e3:.3f}) decode {tick_ms(dec)} "
              f"setup_s={st['setup']:.2f} launches={st['counts']}")
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    for kind, seq in (("prefill", S), ("decode", S + n_decode)):
        coll, bound_ms, r = step_cost_coll(cfg, kind, seq, B, dp, tp,
                                           strategy)
        got = stats[0]["coll"][kind]
        if kind == "prefill":
            meas = stats[0]["prefill"][0] * 1e3
        else:
            meas = np.mean([d[0] for d in stats[0]["decode"]]) * 1e3
        print(f"mesh: {label} {shape} {strategy} {kind} collective operand "
              f"bytes a step (card 0, sharding.collective_log) {got}; "
              f"step_cost(kind={kind}, seq_len={seq}, batch={B}, dp={dp}, "
              f"tp={tp}, strategy={strategy}) coll detail (bytes sent a "
              f"card) { {k: float(v) for k, v in coll.items()} }")
        print(f"mesh: {label} {shape} {strategy} cache_strategy="
              f"{cache_strategy} layouts {terms['layouts']} {kind}: the "
              f"layouts' own collective operand bytes a step by hand (card "
              f"0, beside the recorded totals above) {terms[kind]}")
        print(f"costs: mesh {label} {cfg.name} {shape} {strategy} {kind} "
              f"step_cost flops={r.flops:.6e} hbm_bytes={r.hbm_bytes:.6e} "
              f"coll_bytes={r.coll_bytes:.6e} compute_ms="
              f"{r.compute_s * 1e3:.4f} memory_ms={r.memory_s * 1e3:.4f} "
              f"collective_ms={r.collective_s * 1e3:.4f} bound_ms="
              f"{bound_ms:.4f} ({r.dominant}); measured mean ms={meas:.3f} "
              f"bound_share={bound_ms / meas:.4f}")
    return res


def layout_terms(cfg, mesh, cache_strategy, B, s_max, dtype, dev):
    """The collective operand bytes a step that the head-dim and sequence
    layouts add on card 0 (its rows of ``B``), by hand from the shapes, by
    kind: a decode step's query all-gather where ``wq`` is cut, and on rows
    cut by the head dim the partial scores' fp32 all-reduce [B, h, S] and
    the outputs' all-gather [B, h, hd/m]; on rows cut by the slots the new
    token's K/V all-gather where ``wk`` is cut and the fp32 partials [B,
    ns, h, hd + 2] in an all-to-all (an all-gather where ``wq`` is whole);
    a prefill's K/V all-to-all to the slots' ranks where ``wk`` is cut
    (the rows' ``s_max`` slots; a cross layer's source).  Also the layouts
    of the KV and cross rows and the count of layers whose decode merges
    partials (``seq_layers``)."""
    from repro_torch.distributed.sharding import KINDS, kv_layout
    from repro_torch.kernels import autotune
    from repro_torch.launch.mesh import axis_size, batch_axes
    from repro_torch.models import model as TM
    from repro_torch.models.schema import cross_len
    m = mesh.shape["model"]
    D = axis_size(mesh, batch_axes(mesh))
    b = B // D if B % D == 0 else B
    e = torch.empty((), dtype=dtype).element_size()
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    hl = h // m if h % m == 0 else h
    gl = g // m if g % m == 0 else g
    idx = TM.layer_index(cfg)
    out = {"prefill": dict.fromkeys(KINDS, 0),
           "decode": dict.fromkeys(KINDS, 0), "layouts": {}, "seq_layers": 0}
    dec, pf = out["decode"], out["prefill"]
    for name, n, slots in (
            ("k", sum(1 for i in idx if i[0] == "attn"),
             TM.cache_seq_len(cfg, s_max)),
            ("xk", sum(1 for i in idx if i[2] is not None),
             cross_len(cfg) if is_cross(cfg) else 0)):
        if not n or cfg.mla is not None:
            continue
        lay = kv_layout(cfg, slots, hd, m, cache_strategy)
        out["layouts"][name] = lay
        if lay == "seq":
            out["seq_layers"] += n
        if m == 1 or lay == "heads":
            continue
        if hl < h:
            dec["all-gather"] += n * b * hl * hd * e
        if lay == "head_dim":
            dec["all-reduce"] += n * b * h * slots * 4
            dec["all-gather"] += n * b * h * (hd // m) * e
            continue
        sl = slots // m
        bs = TM._rows_block(sl)
        ns = autotune.choose(hd, bs, sl // bs, b * g,
                             lanes=autotune.effective_lanes(dev)).num_splits
        part = n * b * ns * h * (hd + 2) * 4
        dec["all-to-all" if hl < h else "all-gather"] += part
        if gl < g:
            pf["all-to-all"] += n * 2 * b * slots * gl * hd * e
            if name == "k":
                dec["all-gather"] += n * 2 * b * gl * hd * e
    return out


def planted_fault(K, cfg, mesh, prompts, n_decode, dev, kind="lora",
                  s_max=None, dtype=torch.bfloat16):
    """An arm once more at ``(1, 4)`` ``tp`` with a planted sharding fault:
    ``"lora"``, model ranks 1-3 hand zeros to the shrinks' all-reduce
    (``ops.lora_shrink`` wrapped here), so every projection expands rank
    0's partial shrink alone; ``"seq"``, rows cut by the slots
    (``cache_strategy="seq"``) and model ranks 1-3 drop their decode
    partials (``model.seq_partials`` wrapped: empty partials), so every
    head attends over rank 0's slots alone; ``"norm"``, model ranks 1-3
    skip the all-reduce of Mamba2's gated-norm sum of squares
    (``model.gated_sum_sq`` wrapped: their own slice's sum, taken as the
    whole d_inner's; the all-reduce is still called, so that the
    collectives pair).  Returns rank 0's rows (None elsewhere)."""
    import torch.distributed as dist
    from repro_torch.core.unified import make_forward_step
    from repro_torch.models import model as TM
    host, attr = {"lora": (K["ops"], "lora_shrink"),
                  "seq": (TM, "seq_partials"),
                  "norm": (TM, "gated_sum_sq")}[kind]
    orig = getattr(host, attr)
    mine = mesh.coords["model"] == 0

    def dropped(*a):
        out = orig(*a)
        if mine:
            return out
        if kind == "lora":
            return torch.zeros_like(out)
        if kind == "norm":
            return a[0].float().pow(2).sum(-1)
        o, mx, l = out
        return (torch.zeros_like(o), torch.full_like(mx, -1e30),
                torch.zeros_like(l))
    setattr(host, attr, dropped)
    cs = "seq" if kind == "seq" else "auto"
    try:
        weights = mesh_weights(cfg, mesh, "tp", dev, dtype)
        step = make_forward_step(cfg, block_t=K["block_t"], mesh=mesh,
                                 strategy="tp", cache_strategy=cs)
        res = mesh_generate(cfg, step, weights, mesh, prompts, n_decode, dev,
                            dtype, cache_strategy=cs, s_max=s_max)
    finally:
        setattr(host, attr, orig)
    del weights, step
    gc.collect()
    torch.cuda.empty_cache()
    return res if dist.get_rank() == 0 else None


def fault_seen(label, ref, bad, n_tokens, limit=MESH_LOGIT_LIMIT,
               max_ulps=NEAR_TIE_ULPS):
    """A planted fault's rows ``bad`` against the sound one-card run
    ``ref``: raises unless the first-step gate (``limit``) or the
    divergence rule (``max_ulps``) sees the fault."""
    worst, _, ulps = compare_rows(label, "one_card", ref["rows"], "fault",
                                  bad["rows"], n_tokens)
    if worst <= limit and ulps <= max_ulps:
        raise AssertionError(f"{label}: the gates do not see it (worst row "
                             f"{worst:.4g}, divergences {ulps:.3g} ulps)")
    print(f"{label}: caught (worst row {worst:.4g} > {limit:g} or "
          f"divergences {ulps:.3g} ulps > {max_ulps})")


def with_drops(run):
    """``run()`` and the MoE entries it dropped over capacity, summed over
    the ranks: ``moe.moe_apply``'s own count, and on the expert-parallel
    branch each call's ``~moe_apply_auto.kept`` (``model.moe_apply_auto``
    wrapped here: the forward keeps no count of its own)."""
    from repro_torch.models import model as TM
    from repro_torch.models.moe import moe_apply
    orig, ep = TM.moe_apply_auto, []

    def counted(*a, **kw):
        out = orig(*a, **kw)
        if orig.branch == "expert_parallel":
            ep.append((~orig.kept).sum())
        return out
    moe_apply.dropped = 0
    TM.moe_apply_auto = counted
    try:
        res = run()
    finally:
        TM.moe_apply_auto = orig
    return res, sum(gather_stats(int(sum(ep)) + moe_apply.dropped))


def finite_rows(label, rows):
    """Every logit row of an arm with no reference on fewer cards finite;
    prints the tokens' count."""
    bad = [r for r, v in rows.items()
           if not all(torch.isfinite(lg).all() for _, lg in v)]
    if bad:
        raise AssertionError(f"{label}: non-finite logits in rows {bad}")
    print(f"{label}: {sum(len(v) for v in rows.values())} tokens, every "
          f"logit row finite ok")


def one_card_arm(K, label, cfg, prompts, n_decode, dev, seed=0,
                 int8=False, dtype=torch.bfloat16, s_max=None, attn_chunk=0):
    """The same weights whole on this rank's card, the plain step."""
    from repro_torch.core.unified import make_forward_step
    weights = mesh_weights(cfg, None, None, dev, dtype, seed=seed,
                           int8=int8)
    step = make_forward_step(cfg, block_t=K["block_t"],
                             attn_chunk=attn_chunk)
    res = mesh_generate(cfg, step, weights, None, prompts, n_decode, dev,
                        dtype, s_max=s_max)
    del weights, step
    gc.collect()
    torch.cuda.empty_cache()
    B, S = prompts[0].shape
    pf = res["prefill"]
    print(f"mesh: {label} {cfg.name} {'int8/' if int8 else ''}"
          f"{DTYPE_NAME[dtype]} {cfg.n_layers} layers one card: "
          f"resident_bytes={res['resident']} peak_bytes={res['peak']} "
          f"prefill B={B}x{S} ms={pf[0] * 1e3:.3f} decode "
          f"{tick_ms(res['decode'])}")
    return res


# ------------------------------------------ phase 15: the train step sharded
# AdamW for the train arms: eps 1e-5 (its first step per element is g / (|g|
# + eps), whose slope 1 / eps bounds what a rounding difference of a
# near-zero gradient moves a weight by) and a clip far below the gradient
# norm, so that it engages; slot 1 masked (its rows still carry gradient)
TRAIN_OPT = dict(lr=1e-3, eps=1e-5, grad_clip=1e-3)
TRAIN_SLOTS = (1, 0, 1, 1)
# the sharded train step against one card, each grad / moment / new bank
# leaf's max abs error as a share of the leaf's max abs, and the loss's abs
# error, by dtype.  The 4-card arms (NVIDIA H100 80GB HBM3, 700 W) read
# fp32 llama3-8b 8 L <= 2.6e-05 (loss 1.9e-06) and its two planted faults
# 1.392 / 1.101; bf16 32 L 0.0977 (loss 0.00136)
TRAIN_LIMIT = {torch.float32: 1e-3, torch.bfloat16: 0.2}
TRAIN_LOSS_LIMIT = {torch.float32: 1e-3, torch.bfloat16: 0.01}
# phase 15's (1, 1) train arm: llama3-8b at full width, 2 layers, bf16,
# 2 ft rows of 512 tokens, gated at (grads, loss): it read 0.008675 (dX's
# projections summed in another bf16 order than autograd's) and a loss
# equal to the plain step's
TRAIN_LOCAL = dict(arch="llama3-8b", layers=2, rows=2, seq=512)
TRAIN_LOCAL_LIMITS = (0.03, 1e-3)


def train_batch(cfg, rows, S, dev, seed, mixed=False, dtype=torch.bfloat16):
    """``rows`` ft rows of ``S`` tokens from a numpy seed (adapters 0, 1,
    base, 0, ...; row 1 cut short by its mask, one label ignored; weights
    1, 0.5, 0.25, 0.75), and with ``mixed`` a cold prefill of 2 prompts of
    S/4 tokens and a decode of 4 rows over dense rows; a cross model's
    ft and prefill rows with their sources.  Returns (the batch, the whole
    cache or None, its segments)."""
    from repro_torch.models.model import init_cache
    from repro_torch.models.schema import cross_len
    from repro_torch.models.stream import DECBatch, FTBatch, PFBatch, \
        UnifiedBatch
    rng = np.random.default_rng(seed)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    toks = rng.integers(0, cfg.vocab, (rows, S)).astype(np.int32)
    mask = np.ones((rows, S), bool)
    mask[min(1, rows - 1), S * 3 // 4:] = False
    labels = toks.copy()
    labels[0, 3] = -100
    ad = np.asarray([(0, 1, -1, 0)[i % 4] for i in range(rows)], np.int32)
    w = np.asarray([(1.0, 0.5, 0.25, 0.75)[i % 4] for i in range(rows)],
                   np.float32)
    ft = FTBatch(tokens=tt(toks), mask=tt(mask), labels=tt(labels),
                 adapter=tt(ad), weight=tt(w))
    # a cross model's rows carry their sources [F, d] float32 (a standard
    # normal: image patches or audio frames)
    aux = (lambda n: tt(rng.standard_normal(
        (n, cross_len(cfg), cfg.d_model), dtype=np.float32))) \
        if is_cross(cfg) else (lambda n: None)
    ft = ft._replace(aux_embed=aux(rows))
    if not mixed:
        return UnifiedBatch(ft=ft), None, None
    Sp = S // 4
    pf = PFBatch(tokens=tt(rng.integers(0, cfg.vocab, (2, Sp)).astype(
        np.int32)), length=tt(np.asarray([Sp, Sp - 9], np.int32)),
        adapter=tt(np.asarray([1, -1], np.int32)), aux_embed=aux(2))
    dec = DECBatch(tokens=tt(rng.integers(0, cfg.vocab, (4,)).astype(
        np.int32)), pos=tt(np.asarray([9, Sp, 5, 0], np.int32)),
        adapter=tt(np.asarray([0, -1, 1, 0], np.int32)))
    cache = init_cache(cfg, 6, Sp + 8, dev, dtype)
    return UnifiedBatch(ft=ft, pf=pf, dec=dec), cache, (4, 2)


def train_steps(K, cfg, weights, batch, cache, segs, dev, mesh=None,
                strategy="tp", cache_strategy="auto", grads_only=False,
                remat=False, act_constraint=False, attn_chunk=0):
    """One grad step and one train step (``TRAIN_OPT``, ``TRAIN_SLOTS``)
    from the same bank, on this rank's shards under ``mesh`` (the cache
    cut under ``cache_strategy``) or whole on the card; both with
    ``remat`` and ``attn_chunk``, the train step with
    ``act_constraint_fn(mesh)`` where ``act_constraint`` is set (JAX's grad
    step takes none).  Returns the loss, the grads, and the train step's
    loss, new bank and state, whole (the shards gathered) on the host, with
    the train step's ms, collective bytes by kind, resident and peak
    bytes, and the launches of both steps."""
    from repro_torch.checkpoint.io import gather_bank, gather_opt_state
    from repro_torch.core.unified import make_grad_step, make_train_step
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
        tree_leaves, tree_map
    params, bank, scale = weights
    kw = dict(block_t=K["block_t"], mesh=mesh, strategy=strategy,
              cache_strategy=cache_strategy, remat=remat,
              attn_chunk=attn_chunk)
    seq = SH.act_constraint_fn(mesh) if act_constraint and mesh is not None \
        else None
    cut = (lambda c: None if c is None else
           SH.shard_cache(cfg, c, mesh, segs, cache_strategy)
           if mesh is not None else {k: v.clone() for k, v in c.items()})
    host = lambda t: tree_map(lambda x: x.float().cpu(), t)
    whole = (lambda t: host(gather_bank(cfg, t, mesh))) if mesh is not None \
        else host
    mesh_reset(K)
    res = make_grad_step(cfg, **kw)(params, bank, scale, batch, cut(cache))
    out = dict(loss=float(res.loss), grads=whole(res.grads))
    del res
    if grads_only:
        return out
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                           act_constraint=seq, **kw)
    st0 = adamw_init(bank, len(TRAIN_SLOTS))
    mask = torch.tensor(TRAIN_SLOTS, dtype=torch.int32, device=dev)
    local = cut(cache)
    SH.reset_collective_log()
    t0 = time.perf_counter()
    mem = RA.memory_summary(step, params, bank, scale, st0, batch, mask,
                            local, state=[params, bank, st0, local],
                            device=dev)
    ms = (time.perf_counter() - t0) * 1e3
    loss, nb, ns, _ = mem["out"]
    out.update(tloss=float(loss), bank=whole(nb), ms=ms,
               coll=SH.collective_log(), resident=mem[
                   "argument_size_in_bytes"], peak=mem["peak_bytes"],
               counts={**read_counts(K), **mesh_counts(K, SPLIT_COUNTERS)})
    st = gather_opt_state(cfg, ns, mesh) if mesh is not None else ns
    out.update(m=host(st.m), v=host(st.v))
    out["norm"] = float(torch.sqrt(sum(g.double().square().sum() for g in
                                       tree_leaves(out["grads"]))))
    return out


def train_errs(got, ref) -> dict:
    """The loss's abs error and, per kind (grad, m, v, bank), the worst
    leaf's max abs error over that leaf's max abs, with the leaf's name."""
    out = {"loss": abs(got["loss"] - ref["loss"])}
    if "tloss" in got:
        out["loss"] = max(out["loss"], abs(got["tloss"] - ref["tloss"]))
    for kind in ("grads", "m", "v", "bank"):
        if kind not in got:
            continue
        worst = (0.0, "")
        for li, (lg, lw) in enumerate(zip(got[kind]["layers"],
                                          ref[kind]["layers"])):
            for n in lw:
                for ab in ("a", "b"):
                    w = lw[n][ab]
                    e = float((lg[n][ab] - w).abs().max()) / max(
                        float(w.abs().max()), 1e-30)
                    worst = max(worst, (e, f"{li}/{n}/{ab}"))
        out[kind] = worst
    return out


def train_gate(label, got, ref, dtype, expect_ok=True, limits=None):
    """``train_errs`` printed and gated at ``TRAIN_LIMIT`` /
    ``TRAIN_LOSS_LIMIT`` (or ``limits``, (leaf, loss)): a sound arm must
    stay within them, a planted fault (``expect_ok`` False) must break
    them."""
    e = train_errs(got, ref)
    lim, llim = limits or (TRAIN_LIMIT[dtype], TRAIN_LOSS_LIMIT[dtype])
    worst = max(v[0] for k, v in e.items() if k != "loss")
    print(f"{label}: loss {got['loss']:.6f} vs {ref['loss']:.6f} abs_err="
          f"{e['loss']:.4g} (limit {llim:g}); worst leaf max_abs_err / "
          f"max|leaf| " + " ".join(f"{k}={v[0]:.4g}@{v[1]}" for k, v in
                                   e.items() if k != "loss")
          + f" (limit {lim:g})"
          + (f"; grad norm {got['norm']:.6g} > clip "
             f"{TRAIN_OPT['grad_clip']:g}" if "norm" in got else ""))
    ok = e["loss"] <= llim and worst <= lim
    if expect_ok and not ok:
        raise AssertionError(f"{label}: over the limits: {e}")
    if not expect_ok and ok:
        raise AssertionError(f"{label}: the gates do not see the planted "
                             f"fault: {e}")
    if "norm" in got and not got["norm"] > 10 * TRAIN_OPT["grad_clip"]:
        raise AssertionError(f"{label}: the clip did not engage "
                             f"(norm {got['norm']})")
    print(f"{label}: {'ok' if expect_ok else 'caught'}")


def planted_train(K, mesh, kind):
    """A planted fault of the sharded train step, as (module, attribute,
    replacement): ``"shrink"``, model ranks 1-3 take their own ``Gs`` for
    the backward's shrink all-reduce (``ops.reduce_gs``; still called, so
    that the collectives pair); ``"batch"``, the bank's gradients not
    summed over the batch axes (``sharding.reduce_bank_grads``); ``"cut"``,
    the sequence-sharded carry's cut giving back only this rank's block of
    the gradient, zeros where the other ranks' blocks belong
    (``sharding.cut_grad``, on every rank: no collective goes unpaired);
    ``"gsq"``, Mamba2's gated-norm sum of squares with the identity as its
    adjoint where each rank reads the sum for its own slice of d_inner
    (``model.gated_sum_sq``, on every rank)."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import axis_size
    from repro_torch.models import model as M
    if kind == "batch":
        return SH, "reduce_bank_grads", lambda grads, mesh, split: grads
    if kind == "gsq":
        return M, "gated_sum_sq", lambda g, mesh: SH.all_reduce_grad(
            g.float().pow(2).sum(-1), "model", mesh)
    if kind == "cut":
        def local_only(dy, axes, mesh, n_tokens):
            n, i = dy.shape[0], mesh.index(axes)
            dx = dy.new_zeros((n * axis_size(mesh, mesh.axes(axes)),
                               *dy.shape[1:]))
            dx[i * n:(i + 1) * n] = dy
            return dx[:n_tokens]
        return SH, "cut_grad", local_only
    orig = K["ops"].reduce_gs

    def own(reduce, gs):
        out = orig(reduce, gs.clone())
        return out if mesh.coords["model"] == 0 else gs
    return K["ops"], "reduce_gs", own


def mesh_train_local(K, mesh, dev):
    """Phase 15's ``TRAIN_LOCAL`` arm on the ``(1, 1)`` mesh: llama3-8b at
    full width, 2 layers, bf16, whole on the card; a forward-only step,
    then ``train_steps`` through the sharded step and through the plain
    step on the same weights and batch: the loss and the grads within
    ``TRAIN_LOCAL_LIMITS``, the split shrink and expand, ``smlm_wgrad``
    and the fused SMLM launched exactly as often as the projections ask
    for (the fused SMLM never).  Returns the sharded steps' launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.unified import make_forward_step
    t = TRAIN_LOCAL
    cfg = get_config(t["arch"]).replace(n_layers=t["layers"])
    bf16 = torch.bfloat16
    w = mesh_weights(cfg, None, None, dev, bf16, seed=3)
    batch, _, _ = train_batch(cfg, t["rows"], t["seq"], dev, seed=30)
    mesh_reset(K)
    make_forward_step(cfg, block_t=K["block_t"], mesh=mesh)(
        *w, batch, None)
    fwd = mesh_counts(K, ("smlm_shrink", "smlm_expand"))
    got = train_steps(K, cfg, w, batch, None, None, dev, mesh)
    ref = train_steps(K, cfg, w, batch, None, None, dev)
    rem = train_steps(K, cfg, w, batch, None, None, dev, mesh, remat=True,
                      act_constraint=True)
    del w
    gc.collect()
    torch.cuda.empty_cache()
    label = (f"mesh: (1, 1) train {cfg.name} bf16 {cfg.n_layers} layers "
             f"{t['rows']}x{t['seq']} ft rows, the sharded steps vs the "
             f"plain steps")
    train_gate(label, {k: v for k, v in got.items()
                       if k in ("loss", "tloss", "grads", "norm")},
               ref, bf16, limits=TRAIN_LOCAL_LIMITS)
    c = got["counts"]
    n_lora = sum(len(layer) for layer in got["grads"]["layers"])
    # layer 0's q / k / v read the embedding, which takes no gradient, so
    # they take no dX expand
    no_dx = sum(n in ("wq", "wk", "wv") for n in got["grads"]["layers"][0])
    bwd = {k: c[k] - 2 * fwd[k] for k in ("smlm_shrink", "smlm_expand")}
    # over the grad and the train step: a forward's shrink and expand once
    # a projection; a backward's Gs shrink and smlm_wgrad once a
    # projection, its dX expand once a projection whose input carries a
    # gradient
    want = dict(fwd={"smlm_shrink": n_lora, "smlm_expand": n_lora},
                bwd={"smlm_shrink": 2 * n_lora,
                     "smlm_expand": 2 * (n_lora - no_dx)},
                smlm_wgrad=2 * n_lora, smlm=0)
    seen = dict(fwd=fwd, bwd=bwd, smlm_wgrad=c["smlm_wgrad"],
                smlm=c["smlm"])
    if dev.type == "cuda" and seen != want:
        raise AssertionError(f"{label}: launches {seen}, want {want} "
                             f"(all {c})")
    train_errs_all = train_errs(got, ref)
    print(f"{label}: train step ms={got['ms']:.3f} (plain {ref['ms']:.3f}) "
          f"peak_bytes={got['peak']} (plain {ref['peak']}); new bank / "
          f"moments " + " ".join(f"{k}={train_errs_all[k][0]:.4g}"
                                 for k in ("m", "v", "bank"))
          + f"; launches over the grad and train steps {c} (a forward "
            f"alone {fwd}) ok")
    # the same steps with remat (and the train step's act_constraint, the
    # identity on one rank): each period's forward runs again in the
    # backward, so every forward entry launches twice a step; the
    # backward's launches are unchanged
    rlabel = (f"mesh: (1, 1) train {cfg.name} bf16 {cfg.n_layers} layers "
              f"remat, the sharded steps vs the plain steps")
    train_gate(rlabel, {k: v for k, v in rem.items()
                        if k in ("loss", "tloss", "grads", "norm")},
               ref, bf16, limits=TRAIN_LOCAL_LIMITS)
    cr = rem["counts"]
    want_r = split_launches(n_lora, no_dx, remat=True)
    seen_r = {k: cr[k] for k in want_r}
    if dev.type == "cuda" and seen_r != want_r:
        raise AssertionError(f"{rlabel}: launches {seen_r}, want {want_r} "
                             f"(all {cr})")
    e = train_errs(rem, ref)
    print(f"{rlabel}: train step ms={rem['ms']:.3f} peak_bytes="
          f"{rem['peak']} (without remat {got['peak']}); new bank / moments "
          + " ".join(f"{k}={e[k][0]:.4g}" for k in ("m", "v", "bank"))
          + f"; launches over the grad and train steps {seen_r} "
            f"(predicted {want_r}) ok")
    return c, cr


# phase 15's (1, 1) train arms of the other families (ROADMAP 5b-iii-a),
# bf16 at full width, each through the sharded grad and train steps against
# the plain ones on the same weights and batch (``TRAIN_LOCAL``'s rows),
# gated at ``TRAIN_LOCAL_LIMITS``: (label, arch, config changes, int8).
# The VLM's 5 layers hold one cross layer over 1600-patch sources
TRAIN_FAMILIES_LOCAL = (
    ("mamba2", "mamba2-1.3b", dict(n_layers=2), False),
    ("vlm", "llama-3.2-vision-90b", dict(n_layers=5), False),
    ("whisper", "whisper-base", {}, False),
    ("llama_q8", "llama3-8b", dict(n_layers=2), True))
# the projections whose input is the embedding, so whose backward makes no
# dX expand (layer 0's)
NO_DX = ("wq", "wk", "wv", "in_z", "in_x")


def split_launches(n_lora: int, no_dx: int, remat: bool = False) -> dict:
    """The launches a grad step and a train step make on ft rows through
    the split SMLM entries: a forward's shrink and expand once a projection
    (twice under remat: the recompute); a backward's ``Gs`` shrink and
    ``smlm_wgrad`` once a projection, its dX expand once a projection whose
    input carries a gradient; the fused SMLM never."""
    f = 2 if remat else 1
    return {"smlm_shrink": 2 * (f * n_lora + n_lora),
            "smlm_expand": 2 * (f * n_lora + n_lora - no_dx),
            "smlm_wgrad": 2 * n_lora, "smlm": 0}


def mesh_train_families_local(K, mesh, dev):
    """Phase 15's ``TRAIN_FAMILIES_LOCAL`` arms on the ``(1, 1)`` mesh:
    each config's weights whole on the card (int8 quantized leaf by leaf),
    ``train_steps`` through the sharded steps and through the plain steps
    on the same weights and batch: the loss and the grads within
    ``TRAIN_LOCAL_LIMITS``, the split entries and ``smlm_wgrad`` launched
    as ``split_launches`` predicts.  Returns the arms' launches summed."""
    from repro_torch.configs import get_config
    t = TRAIN_LOCAL
    bf16 = torch.bfloat16
    total = {}
    for label, arch, change, int8 in TRAIN_FAMILIES_LOCAL:
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(**change)
        w = mesh_weights(cfg, None, None, dev, bf16, seed=3, int8=int8)
        batch, _, _ = train_batch(cfg, t["rows"], t["seq"], dev, seed=31)
        got = train_steps(K, cfg, w, batch, None, None, dev, mesh)
        ref = train_steps(K, cfg, w, batch, None, None, dev)
        del w
        gc.collect()
        torch.cuda.empty_cache()
        name = (f"mesh: (1, 1) train {label} {cfg.name} "
                f"{'int8/' if int8 else ''}bf16 {cfg.n_layers} layers "
                f"{t['rows']}x{t['seq']} ft rows")
        train_gate(f"{name}, the sharded steps vs the plain steps",
                   {k: v for k, v in got.items()
                    if k in ("loss", "tloss", "grads", "norm")},
                   ref, bf16, limits=TRAIN_LOCAL_LIMITS)
        layers = got["grads"]["layers"]
        want = split_launches(sum(len(x) for x in layers),
                              sum(n in NO_DX for n in layers[0]))
        c = got["counts"]
        seen = {k: c[k] for k in want}
        if dev.type == "cuda" and seen != want:
            raise AssertionError(f"{name}: launches {seen}, want {want} "
                                 f"(all {c})")
        e = train_errs(got, ref)
        print(f"{name}: train step ms={got['ms']:.3f} (plain "
              f"{ref['ms']:.3f}) peak_bytes={got['peak']} (plain "
              f"{ref['peak']}); new bank / moments "
              + " ".join(f"{k}={e[k][0]:.4g}" for k in ("m", "v", "bank"))
              + f"; launches over the grad and train steps {seen} "
                f"(predicted {want}); wall_s={time.perf_counter() - t0:.1f}"
                f" ok")
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def mesh_rank(rank, world, port, only):
    """One rank of ``chip_smoke.py --mesh`` (spawned once per card): the
    arms of phase 15 on a ``(1, 4)`` and a ``(2, 2)`` mesh of 4 NCCL
    ranks."""
    import dataclasses
    import torch.distributed as dist
    sys.stdout.reconfigure(line_buffering=True)   # lines survive a crash
    start_group(rank, world, port)
    try:
        K = _import_port()
        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import init_mesh
        dev = torch.device("cuda", rank)
        m14 = init_mesh((1, 4), ("data", "model"), timeout_s=MESH_TIMEOUT_S)
        m22 = init_mesh((2, 2), ("data", "model"), timeout_s=MESH_TIMEOUT_S)
        lead = rank == 0
        by_path = {}          # the train arms' launches on card 0, by arm
        # every group's NCCL communicator is made at its first collective,
        # and its all-to-all connections at its first all-to-all: make
        # them all before anything is timed
        for mesh in (m14, m22):
            for g in mesh.groups.values():
                if g is not None:
                    dist.all_reduce(torch.zeros(1, device=dev), group=g)
                    n = dist.get_world_size(g)
                    if n > 1:
                        x = torch.zeros(n, device=dev)
                        dist.all_to_all_single(torch.empty_like(x), x,
                                               group=g)
        torch.cuda.synchronize(dev)

        def one_card(label, cfg, prompts, n_decode, **kw):
            res = one_card_arm(K, label, cfg, prompts, n_decode, dev,
                               **kw) if lead else None
            dist.barrier()
            return res

        def verdict(check):
            """Rank 0's gates (``check`` raises), their verdict shared:
            every rank raises together, so none waits on a collective the
            others never reach."""
            err = None
            if lead:
                try:
                    check()
                except AssertionError as e:
                    err = str(e)
            err = gather_stats(err)[0]
            if err:
                raise AssertionError(err)

        def gate(label, ref_name, ref, name, got, n_tokens,
                 dtype=torch.bfloat16):
            verdict(lambda: same_rows(label, ref_name, ref["rows"], name,
                                      got["rows"], dtype, n_tokens,
                                      MESH_LIMIT[dtype]))

        n_tok = lambda p, n: p[0].shape[0] * (n + 1)
        if "llama" in only:
            cfg = get_config("llama3-8b")
            p = mesh_prompts(cfg, 8, 1024, seed=1)
            got = {key: mesh_arm(K, "llama", cfg, mesh, st, p, 16, dev,
                                 profile=True)
                   for key, mesh, st in (("1x4 tp", m14, "tp"),
                                         ("2x2 fsdp_tp", m22, "fsdp_tp"))}
            ref = one_card("llama", cfg, p, 16)
            for key, res in got.items():
                gate(f"mesh: llama {key} vs one card", "one_card", ref,
                     "mesh", res, n_tok(p, 16))
            bad = planted_fault(K, cfg, m14, p, 4, dev)
            verdict(lambda: fault_seen(
                "mesh: llama 1x4 tp with a planted fault (model ranks 1-3 "
                "drop their LoRA shrink partials) vs one card", ref, bad,
                n_tok(p, 4)))
        if "qwen" in only:
            cfg = get_config("qwen1.5-110b")
            p = mesh_prompts(cfg, 4, 2048, seed=2)
            got = {key: mesh_arm(K, "qwen", cfg, mesh, st, p, 32, dev)
                   for key, mesh, st in (("1x4 tp", m14, "tp"),
                                         ("2x2 fsdp_tp", m22, "fsdp_tp"))}
            gate("mesh: qwen 2x2 fsdp_tp vs 1x4 tp", "1x4_tp",
                 got["1x4 tp"], "2x2_fsdp_tp", got["2x2 fsdp_tp"],
                 n_tok(p, 32))
            del got
            c8 = cfg.replace(n_layers=8)
            res = mesh_arm(K, "qwen8", c8, m14, "tp", p, 32, dev)
            ref = one_card("qwen8", c8, p, 32)
            gate("mesh: qwen 8 layers 1x4 tp vs one card", "one_card", ref,
                 "mesh", res, n_tok(p, 32))
        if "maverick" in only:
            cfg = get_config("llama4-maverick-400b-a17b")
            # two layers (one MoE), capacity factor E: neither the one-card
            # groups nor a rank's buffer can drop an entry, so the two runs
            # compute one function
            cfg = cfg.replace(n_layers=2, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
            p = mesh_prompts(cfg, 4, 512, seed=3)
            res = mesh_arm(K, "maverick", cfg, m14, "tp", p, 8, dev)
            from repro_torch.models.moe_dist import moe_apply_auto
            branch = moe_apply_auto.branch
            ref = one_card("maverick", cfg, p, 8)

            def maverick():
                if branch != "expert_parallel":
                    raise AssertionError(f"maverick took {branch}")
                same_rows("mesh: maverick 2 layers 1x4 tp (expert-parallel,"
                          " 32 of 128 experts a card) vs one card",
                          "one_card", ref["rows"], "mesh", res["rows"],
                          torch.bfloat16, n_tok(p, 8))
                S = p[0].shape[1]
                for kind, seq in (("prefill", S), ("decode", S + 8)):
                    coll, _, _ = step_cost_coll(cfg, kind, seq, 4, 1, 4,
                                                "tp")
                    print(f"mesh: maverick {kind} all-to-all operand bytes "
                          f"(card 0) {res['coll'][kind]['all-to-all']} "
                          f"beside step_cost moe_a2a "
                          f"{coll.get('moe_a2a', 0.0):.6g} (sent each way: "
                          f"2 x T/chips x k x cf x d x 2 B a layer)")
            verdict(maverick)
        if "vlm" in only:
            # llama-3.2-vision-90b, 181 GB in bf16: 45 GB a card
            cfg = get_config("llama-3.2-vision-90b")
            p = mesh_prompts(cfg, 4, 512, seed=6)
            got = {key: mesh_arm(K, "vlm", cfg, mesh, st, p, 8, dev)
                   for key, mesh, st in (("1x4 tp", m14, "tp"),
                                         ("2x2 fsdp_tp", m22, "fsdp_tp"))}
            gate("mesh: vlm 2x2 fsdp_tp vs 1x4 tp", "1x4_tp", got["1x4 tp"],
                 "2x2_fsdp_tp", got["2x2 fsdp_tp"], n_tok(p, 8))
            del got
            c10 = cfg.replace(n_layers=10)
            res = mesh_arm(K, "vlm10", c10, m14, "tp", p, 8, dev)
            ref = one_card("vlm10", c10, p, 8)
            gate("mesh: vlm 10 layers 1x4 tp vs one card", "one_card", ref,
                 "mesh", res, n_tok(p, 8))
            del res, ref
        if "dsv2" in only:
            # deepseek-v2-236b in int8, 244 GB: 61 GB a card, 40 of 160
            # experts and 32 of 128 heads a card, the latent's slots cut
            # over the cards
            cfg = get_config("deepseek-v2-236b")
            p = mesh_prompts(cfg, 4, 128, seed=7)
            res = mesh_arm(K, "dsv2", cfg, m14, "tp", p, 8, dev, int8=True,
                           need=MLA_NEED)
            verdict(lambda: finite_rows("mesh: dsv2 60 layers 1x4 tp",
                                        res["rows"]))
            del res
            # 8 layers against one card, capacity factor E (neither side
            # drops an entry), int8 weights dequantized to fp32: in bf16
            # the two layouts' rounding, through 8 layers of near-uniform
            # random routers over 160 experts, moved the first-step logits
            # by 0.105-0.143 of a row's max (NVIDIA H100 80GB HBM3, 700 W),
            # more than a sharding fault must be told from
            c8 = cfg.replace(n_layers=8, moe=dataclasses.replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
            res = mesh_arm(K, "dsv2_8", c8, m14, "tp", p, 8, dev, int8=True,
                           need=MLA_NEED, dtype=torch.float32)
            ref = one_card("dsv2_8", c8, p, 8, int8=True,
                           dtype=torch.float32)
            gate("mesh: dsv2 int8/fp32 8 layers 1x4 tp vs one card",
                 "one_card", ref, "mesh", res, n_tok(p, 8), torch.float32)
            del res, ref
        if "whisper" in only:
            cfg = get_config("whisper-base")
            p = mesh_prompts(cfg, 4, 256, seed=8)
            res = mesh_arm(K, "whisper", cfg, m14, "tp", p, 16, dev)
            ref = one_card("whisper", cfg, p, 16)
            gate("mesh: whisper 1x4 tp vs one card", "one_card", ref, "mesh",
                 res, n_tok(p, 16))
            del res, ref
        if "window" in only:
            # llama3-8b with an 8192-token window, one 16384-token prompt
            cfg = get_config("llama3-8b").replace(sliding_window=8192)
            p = mesh_prompts(cfg, 1, 16384, seed=9)
            res = mesh_arm(K, "window", cfg, m14, "tp", p, 16, dev)
            ref = one_card("window", cfg, p, 16)
            gate("mesh: window 8192, 16384-token prompt, 1x4 tp vs one card",
                 "one_card", ref, "mesh", res, n_tok(p, 16))
            del res, ref
        if "phi3" in only:
            # phi3-medium-14b, 29.3 GB in bf16: its 40 query heads divide
            # 4, its 10 KV heads do not, so wk / wv are whole on every card
            # and the KV rows are cut by the head dim
            cfg = get_config("phi3-medium-14b")
            p = mesh_prompts(cfg, 8, 1024, seed=11)
            res = mesh_arm(K, "phi3", cfg, m14, "tp", p, 16, dev,
                           need=HD_NEED)
            ref = one_card("phi3", cfg, p, 16)
            gate("mesh: phi3 40 layers 1x4 tp (KV rows cut by the head dim) "
                 "vs one card", "one_card", ref, "mesh", res, n_tok(p, 16))
            del res, ref
        if "seq" in only:
            # llama3-8b, 4 x 8192 prompts, rows cut by the slots: 2048 a
            # card of 8192 + 64 slots (a multiple of 64 a card, split-K's
            # block)
            cfg = get_config("llama3-8b")
            p = mesh_prompts(cfg, 4, 8192, seed=12)
            sm = 8192 + 64 * 4
            got = {key: mesh_arm(K, "seq", cfg, mesh, st, p, 16, dev,
                                 need=SEQ_NEED, cache_strategy="seq",
                                 s_max=sm, profile=key == "1x4 tp")
                   for key, mesh, st in (("1x4 tp", m14, "tp"),
                                         ("2x2 fsdp_tp", m22, "fsdp_tp"))}
            auto = mesh_arm(K, "seq_auto", cfg, m14, "tp", p, 16, dev,
                            s_max=sm, profile=True)
            ref = one_card("seq", cfg, p, 16, s_max=sm)
            for key, res in got.items():
                gate(f"mesh: seq {key} (rows cut by the slots) vs one card",
                     "one_card", ref, "mesh", res, n_tok(p, 16))
            gate("mesh: seq_auto 1x4 tp (rows cut by the KV heads) vs one "
                 "card", "one_card", ref, "mesh", auto, n_tok(p, 16))

            def side_by_side():
                for name, r in (("seq", got["1x4 tp"]), ("auto", auto)):
                    print(f"mesh: seq vs auto, llama3-8b 1x4 tp 4 x 8192, "
                          f"{name} layout card 0: decode "
                          f"{tick_ms(r['decode'])} collective operand "
                          f"bytes a decode step {r['coll']['decode']}, a "
                          f"prefill {r['coll']['prefill']}")
            verdict(side_by_side)
            del got, auto
            bad = planted_fault(K, cfg, m14, p, 4, dev, kind="seq", s_max=sm)

            def caught_seq():
                label = ("mesh: seq 1x4 tp with a planted fault (model ranks "
                         "1-3 drop their decode partials) vs one card")
                worst, _, ulps = compare_rows(label, "one_card", ref["rows"],
                                              "fault", bad["rows"],
                                              n_tok(p, 4))
                # the first step is the prefill, which reads no rows: the
                # fault shows from the first decode step on
                err = max(float((a[1] - b[1]).abs().max())
                          for r in ref["rows"] for a, b in
                          zip(ref["rows"][r][1:2], bad["rows"][r][1:2]))
                top = max(float(ref["rows"][r][1][1].abs().max())
                          for r in ref["rows"])
                if err / top <= MESH_LOGIT_LIMIT and ulps <= NEAR_TIE_ULPS:
                    raise AssertionError(
                        f"{label}: the gates do not see it (first decode "
                        f"step {err / top:.4g} of the max |logit|, "
                        f"divergences {ulps:.3g} ulps)")
                print(f"{label}: caught (first decode step {err / top:.4g} "
                      f"of the max |logit| > {MESH_LOGIT_LIMIT:g} or "
                      f"divergences {ulps:.3g} ulps > {NEAR_TIE_ULPS})")
            verdict(caught_seq)
            del ref, bad
        if "seq_window" in only:
            cfg = get_config("llama3-8b").replace(sliding_window=8192)
            p = mesh_prompts(cfg, 1, 16384, seed=9)
            res = mesh_arm(K, "seq_window", cfg, m14, "tp", p, 16, dev,
                           need=SEQ_NEED, cache_strategy="seq", profile=True)
            ref = one_card("seq_window", cfg, p, 16)
            gate("mesh: seq_window 8192, 16384-token prompt, 1x4 tp (rolling "
                 "rows cut by the slots) vs one card", "one_card", ref,
                 "mesh", res, n_tok(p, 16))
            del res, ref
        if "seq_vlm" in only:
            cfg = get_config("llama-3.2-vision-90b").replace(n_layers=10)
            p = mesh_prompts(cfg, 4, 512, seed=6)
            res = mesh_arm(K, "seq_vlm", cfg, m14, "tp", p, 8, dev,
                           need=SEQ_NEED, cache_strategy="seq",
                           s_max=512 + 64 * 4)
            ref = one_card("seq_vlm", cfg, p, 8, s_max=512 + 64 * 4)
            gate("mesh: seq_vlm 10 layers 1x4 tp (KV and cross rows cut by "
                 "the slots) vs one card", "one_card", ref, "mesh", res,
                 n_tok(p, 8))
            del res, ref
        if "mamba2" in only:
            # mamba2-1.3b whole: its 64 SSM heads 16 a card at (1, 4), 32
            # at (2, 2), the gated norm's squares summed over the cards;
            # in bf16 at ``MAMBA_BF16_LIMIT`` / ``MAMBA_BF16_ULPS``, in fp32
            # at ``MESH_FP32_LIMIT``, the norm fault planted in both
            cfg = get_config("mamba2-1.3b")
            p = mesh_prompts(cfg, 8, 1024, seed=13)
            got = {key: mesh_arm(K, "mamba2", cfg, mesh, st, p, 16, dev,
                                 need=SSM_NEED, profile=key == "1x4 tp")
                   for key, mesh, st in (("1x4 tp", m14, "tp"),
                                         ("2x2 fsdp_tp", m22, "fsdp_tp"))}
            ref = one_card("mamba2", cfg, p, 16)
            for key, res in got.items():
                verdict(lambda: same_rows(
                    f"mesh: mamba2 48 layers bf16 {key} vs one card",
                    "one_card", ref["rows"], "mesh", res["rows"],
                    torch.bfloat16, n_tok(p, 16), MAMBA_BF16_LIMIT,
                    MAMBA_BF16_ULPS))
            del got
            bad = planted_fault(K, cfg, m14, p, 4, dev, kind="norm")
            verdict(lambda: fault_seen(
                "mesh: mamba2 bf16 1x4 tp with a planted fault (model ranks "
                "1-3 skip the gated norm's all-reduce) vs one card", ref, bad,
                n_tok(p, 4), MAMBA_BF16_LIMIT, MAMBA_BF16_ULPS))
            del ref, bad
            f32 = torch.float32
            got = {key: mesh_arm(K, "mamba2_fp32", cfg, mesh, st, p, 16, dev,
                                 need=SSM_NEED, dtype=f32)
                   for key, mesh, st in (("1x4 tp", m14, "tp"),
                                         ("2x2 fsdp_tp", m22, "fsdp_tp"))}
            ref = one_card("mamba2_fp32", cfg, p, 16, dtype=f32)
            for key, res in got.items():
                gate(f"mesh: mamba2 48 layers fp32 {key} vs one card",
                     "one_card", ref, "mesh", res, n_tok(p, 16), f32)
            del got
            bad = planted_fault(K, cfg, m14, p, 4, dev, kind="norm",
                                dtype=f32)
            verdict(lambda: fault_seen(
                "mesh: mamba2 fp32 1x4 tp with a planted fault (model ranks "
                "1-3 skip the gated norm's all-reduce) vs one card", ref, bad,
                n_tok(p, 4), MESH_FP32_LIMIT))
            del ref, bad
        if "jamba" in only or "jamba_deep" in only:
            from repro_torch.models.moe_dist import moe_apply_auto
            # jamba-1.5-large-398b in int8, capacity factor E: neither the
            # one-card groups nor a card's buffer can drop an entry
            jam = get_config("jamba-1.5-large-398b")
            jam = jam.replace(moe=dataclasses.replace(
                jam.moe, capacity_factor=float(jam.moe.num_experts)))
            pj = mesh_prompts(jam, 4, 512, seed=14)
        if "jamba" in only:
            # one period of 8 layers (7 Mamba2, 1 attention, 4 MoE of 16
            # experts, 4 a card), int8 dequantized to fp32: random routers'
            # near-tied top-2 choices flip on bf16 rounding (SSM_LOCAL)
            c8 = jam.replace(n_layers=8)
            f32 = torch.float32
            res, d_mesh = with_drops(lambda: mesh_arm(
                K, "jamba", c8, m14, "tp", pj, 8, dev, int8=True,
                profile=True, dtype=f32))
            branch = moe_apply_auto.branch
            ref, d_one = with_drops(lambda: one_card(
                "jamba", c8, pj, 8, int8=True, dtype=f32))

            def jamba():
                print(f"mesh: jamba 8 layers int8/fp32 1x4 tp: MoE branch "
                      f"{branch}, entries dropped {d_mesh} on the 4 cards, "
                      f"{d_one} on one card (capacity factor "
                      f"{c8.moe.capacity_factor:g})")
                if d_mesh or d_one or branch != "expert_parallel":
                    raise AssertionError(f"jamba: {d_mesh} / {d_one} entries "
                                         f"dropped, branch {branch}")
                same_rows("mesh: jamba 8 layers int8/fp32 1x4 tp (experts "
                          "over the cards) vs one card", "one_card",
                          ref["rows"], "mesh", res["rows"], f32,
                          n_tok(pj, 8), MESH_FP32_LIMIT)
            verdict(jamba)
            del res, ref
        if "jamba_deep" in only:
            # 5 periods, 221 B parameters: about 55 GB of int8 a card
            cd = jam.replace(n_layers=40)
            res, d_mesh = with_drops(lambda: mesh_arm(
                K, "jamba_deep", cd, m14, "tp", pj, 8, dev, int8=True))

            def deep():
                finite_rows("mesh: jamba_deep 40 layers int8 1x4 tp",
                            res["rows"])
                print(f"mesh: jamba_deep 40 layers int8 1x4 tp: entries "
                      f"dropped {d_mesh} on the 4 cards (capacity factor "
                      f"{cd.moe.capacity_factor:g})")
            verdict(deep)
            del res
        if "dsv2_window" in only:
            # deepseek-v2-236b at long_500k (window 8192: rolling latent rows
            # of 8192 slots, 2048 a card), int8 weights dequantized to fp32
            # as the dsv2 arm's check, 8 layers; MLA's prefill in key and
            # query blocks of 1024 (an unchunked 16384 x 16384 score block
            # of 128 heads would take 137 GB); capacity factor 4: at E
            # (160) a card's [E, cap, d] buffer for 4096 tokens would take
            # 80 GB. Its random routers drop entries at any factor a card
            # can hold (37 % here, ROADMAP Queue 3), so the gate is the
            # same drops on both sides: a card's 4096 tokens are one of the
            # one-card run's dispatch groups (``moe.GROUP_TOKENS``), with
            # the same capacity, so the two drop the same entries
            from repro_torch.launch.shapes import SHAPES, adapt_config
            cfg = adapt_config(get_config("deepseek-v2-236b"),
                               SHAPES["long_500k"])
            cfg = cfg.replace(n_layers=8, moe=dataclasses.replace(
                cfg.moe, capacity_factor=4.0))
            p = mesh_prompts(cfg, 1, 16384, seed=15)
            res, d_mesh = with_drops(lambda: mesh_arm(
                K, "dsv2_window", cfg, m14, "tp", p, 16, dev, int8=True,
                need=MLA_NEED, dtype=torch.float32, attn_chunk=1024))
            ref, d_one = with_drops(lambda: one_card(
                "dsv2_window", cfg, p, 16, int8=True, dtype=torch.float32,
                attn_chunk=1024))

            def dsv2_window():
                print(f"mesh: dsv2_window: entries dropped {d_mesh} on the 4 "
                      f"cards, {d_one} on one card (capacity factor "
                      f"{cfg.moe.capacity_factor:g})")
                if d_mesh != d_one:
                    raise AssertionError(f"dsv2_window: {d_mesh} entries "
                                         f"dropped on the 4 cards, {d_one} "
                                         "on one card")
                same_rows("mesh: dsv2_window 8192, int8/fp32 8 layers, "
                          "16384-token prompt, 1x4 tp (rolling latent rows "
                          "cut by the slots) vs one card", "one_card",
                          ref["rows"], "mesh", res["rows"], torch.float32,
                          n_tok(p, 16), MESH_FP32_LIMIT)
            verdict(dsv2_window)
            del res, ref
        if "train" in only:
            train_arms(K, get_config, m14, m22, dev, lead, verdict)
        if "train_qwen" in only:
            cfg = get_config("qwen1.5-110b")
            batch, _, _ = train_batch(cfg, 2, 256, dev, seed=40)
            for key, mesh, st in (("2x2 fsdp_tp", m22, "fsdp_tp"),
                                  ("1x4 tp", m14, "tp")):
                res = qwen_train_arm(K, cfg, mesh, st, dev, batch)
                verdict(lambda: qwen_gate(f"mesh: train qwen {key}", res))
                del res
        if "train_remat" in only:
            train_remat_arms(K, get_config, m14, m22, dev, lead, verdict)
        if "train_qwen_4k" in only:
            cfg = get_config("qwen1.5-110b")
            batch, _, _ = train_batch(cfg, 1, QWEN_4K["seq"], dev, seed=41)
            res = big_train_arm(K, cfg, m14, "tp", dev, batch,
                                ("remat + act_constraint",) * 2
                                + ("remat alone",), chunk=QWEN_4K["chunk"])
            verdict(lambda: big_train_gate("mesh: train qwen 4k 1x4 tp",
                                           res))
            del res
        if "train_families" in only:
            by_path.update(train_family_arms(K, get_config, m14, m22, dev,
                                             lead, verdict))
        for arm, (arch, int8, shape, st, S, kinds) in TRAIN_BIG.items():
            if arm not in only:
                continue
            cfg = get_config(arch)
            batch, _, _ = train_batch(cfg, 2, S, dev, seed=42)
            res = big_train_arm(K, cfg, m14 if shape == "1x4" else m22, st,
                                dev, batch, kinds, int8=int8)
            verdict(lambda: big_train_gate(f"mesh: {arm} {shape} {st}", res))
            by_path[arm] = res[0]["counts"]
            del res, batch
        if lead and by_path:
            print(json.dumps({"mesh_launches_by_path": by_path}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def train_arms(K, get_config, m14, m22, dev, lead, verdict):
    """``--mesh-arms train``: llama3-8b at full width, fp32, 8 layers, at
    ``(1, 4)`` tp and ``(2, 2)`` fsdp_tp, on 4 x 512 ft rows and on a mixed
    ft + prefill + decode batch over dense rows: each arm's grad step and
    train step against one card's plain steps on the same weights (rank
    0), gated at ``TRAIN_LIMIT``; the two planted faults (``planted_train``)
    must break it; then bf16 at 32 layers, ``(2, 2)`` fsdp_tp against one
    card, gated at the bf16 limit, which the batch fault planted in bf16
    must break, and both bf16 steps read against the fp32 grad step on
    the same weights (a record of bf16's own rounding)."""
    import torch.distributed as dist
    from repro_torch.training.optimizer import tree_map
    f32, bf16 = torch.float32, torch.bfloat16
    cfg = get_config("llama3-8b").replace(n_layers=8)
    batches = {"ft": train_batch(cfg, 4, 512, dev, seed=20, dtype=f32),
               "mixed": train_batch(cfg, 2, 512, dev, seed=21, mixed=True,
                                    dtype=f32)}
    got, bad = {}, {}
    for key, mesh, st, fault in (("1x4 tp", m14, "tp", "shrink"),
                                 ("2x2 fsdp_tp", m22, "fsdp_tp", "batch")):
        w = mesh_weights(cfg, mesh, st, dev, f32)
        for name, (batch, cache, segs) in batches.items():
            got[key, name] = train_steps(K, cfg, w, batch, cache, segs, dev,
                                         mesh, st)
            need = SPLIT_COUNTERS[:2] + ("smlm_wgrad",) + (
                ("bgmv_shrink", "bgmv_expand", "flash", "dense_decode")
                if cache is not None else ())
            c = got[key, name]["counts"]
            if dev.type == "cuda" and (c["smlm"] or c["bgmv"]
                                       or not min(c[k] for k in need)):
                raise AssertionError(f"mesh: train {key} {name} rank "
                                     f"{dist.get_rank()}: launches {c}")
        mod, attr, planted = planted_train(K, mesh, fault)
        orig = getattr(mod, attr)
        setattr(mod, attr, planted)
        try:
            batch, cache, segs = batches["ft"]
            bad[key] = train_steps(K, cfg, w, batch, cache, segs, dev, mesh,
                                   st, grads_only=True)
        finally:
            setattr(mod, attr, orig)
        del w
        gc.collect()
        torch.cuda.empty_cache()
    stats = gather_stats({k: {f: v[f] for f in ("ms", "coll", "resident",
                                                "peak", "counts")}
                          for k, v in got.items()})
    ref = {}
    if lead:
        w = mesh_weights(cfg, None, None, dev, f32)
        for name, (batch, cache, segs) in batches.items():
            ref[name] = train_steps(K, cfg, w, batch, cache, segs, dev)
        del w
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    def fp32():
        for name, r in ref.items():
            print(f"mesh: train {cfg.name} fp32 {cfg.n_layers} layers {name} "
                  f"one card: train step ms={r['ms']:.3f} peak_bytes="
                  f"{r['peak']}")
        for (key, name), res in got.items():
            for rank, st in enumerate(stats):
                x = st[key, name]
                print(f"mesh: train {cfg.name} fp32 {cfg.n_layers} layers "
                      f"{key} {name} card {rank}: train step ms="
                      f"{x['ms']:.3f} resident_bytes={x['resident']} "
                      f"peak_bytes={x['peak']} collective operand bytes "
                      f"{x['coll']} launches={x['counts']}")
            train_gate(f"mesh: train {cfg.name} fp32 {cfg.n_layers} layers "
                       f"{key} {name} vs one card", res, ref[name], f32)
        for key, what in (("1x4 tp", "model ranks 1-3 take the identity "
                                     "for the shrink all-reduce's backward"),
                          ("2x2 fsdp_tp", "the bank's gradients not summed "
                                          "over the batch axes")):
            train_gate(f"mesh: train {key} with a planted fault ({what}) "
                       f"vs one card", bad[key], ref["ft"], f32,
                       expect_ok=False)
    verdict(fp32)
    del got, bad, ref
    # bf16, every layer, against one card; the batch fault planted in bf16
    # too, and both bf16 steps held to the fp32 grad step on the same
    # weights (the bf16 shards upcast, sharded at (2, 2)), which says how
    # far bf16's own rounding moves a leaf
    c32 = get_config("llama3-8b")
    batch, _, _ = train_batch(c32, 4, 512, dev, seed=22)
    w = mesh_weights(c32, m22, "fsdp_tp", dev, bf16)
    res = train_steps(K, c32, w, batch, None, None, dev, m22, "fsdp_tp")
    mod, attr, planted = planted_train(K, m22, "batch")
    orig = getattr(mod, attr)
    setattr(mod, attr, planted)
    try:
        bad = train_steps(K, c32, w, batch, None, None, dev, m22, "fsdp_tp",
                          grads_only=True)
    finally:
        setattr(mod, attr, orig)
    w = tree_map(lambda x: x.float() if x.is_floating_point() else x, w)
    truth = train_steps(K, c32, w, batch, None, None, dev, m22, "fsdp_tp",
                        grads_only=True)
    del w
    gc.collect()
    torch.cuda.empty_cache()
    ref = None
    if lead:
        w = mesh_weights(c32, None, None, dev, bf16)
        ref = train_steps(K, c32, w, batch, None, None, dev)
        del w
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    def bf16_arm():
        print(f"mesh: train {c32.name} bf16 {c32.n_layers} layers 2x2 "
              f"fsdp_tp card 0: "
              f"train step ms={res['ms']:.3f} peak_bytes={res['peak']} "
              f"collective operand bytes {res['coll']}; one card ms="
              f"{ref['ms']:.3f} peak_bytes={ref['peak']}")
        label = f"mesh: train {c32.name} bf16 {c32.n_layers} layers 2x2"
        for who, x in (("fsdp_tp", res), ("one card", ref)):
            e = train_errs({k: x[k] for k in ("loss", "grads")}, truth)
            print(f"{label} {who} vs the fp32 grad step (record): loss "
                  f"abs_err={e['loss']:.4g} grads={e['grads'][0]:.4g}@"
                  f"{e['grads'][1]}")
        train_gate(f"{label} fsdp_tp vs one card", res, ref, bf16)
        train_gate(f"{label} fsdp_tp with a planted fault (the bank's "
                   f"gradients not summed over the batch axes) vs one card",
                   bad, ref, bf16, expect_ok=False)
    verdict(bf16_arm)


def qwen_train_arm(K, cfg, mesh, strategy, dev, batch):
    """qwen1.5-110b bf16 at every layer on this rank's shards: the
    forward-only step's loss, a grad step (every grad finite), then two
    train steps on the same batch, the first under
    ``roofline.analysis.memory_summary`` with its collective bytes.
    Returns every rank's readings (on every rank)."""
    import torch.distributed as dist
    from repro_torch.core.unified import make_forward_step, \
        make_grad_step, make_train_step, scalar_loss
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
        tree_leaves
    t0 = time.perf_counter()
    params, bank, scale = mesh_weights(cfg, mesh, strategy, dev,
                                       torch.bfloat16, seed=4)
    setup = time.perf_counter() - t0
    kw = dict(block_t=K["block_t"], mesh=mesh, strategy=strategy)
    out = make_forward_step(cfg, **kw)(params, bank, scale, batch, None)
    fwd = float(scalar_loss(out, batch))
    del out
    mesh_reset(K)
    res = make_grad_step(cfg, **kw)(params, bank, scale, batch, None)
    finite = all(bool(torch.isfinite(g).all())
                 for g in tree_leaves(res.grads))
    gloss = float(res.loss)
    del res
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), **kw)
    st0 = adamw_init(bank, len(TRAIN_SLOTS))
    mask = torch.tensor(TRAIN_SLOTS, dtype=torch.int32, device=dev)
    SH.reset_collective_log()
    t1 = time.perf_counter()
    mem = RA.memory_summary(step, params, bank, scale, st0, batch, mask,
                            state=[params, bank, st0], device=dev)
    ms1 = (time.perf_counter() - t1) * 1e3
    coll = SH.collective_log()
    loss1, nb, ns, _ = mem["out"]
    del mem["out"], st0, bank
    t2 = time.perf_counter()
    loss2, _, _, _ = step(params, nb, scale, ns, batch, mask)
    torch.cuda.synchronize(dev)
    ms2 = (time.perf_counter() - t2) * 1e3
    counts = {**read_counts(K), **mesh_counts(K, SPLIT_COUNTERS)}
    peak2 = torch.cuda.max_memory_allocated(dev)
    del params, nb, ns, step
    gc.collect()
    torch.cuda.empty_cache()
    return gather_stats(dict(
        fwd=fwd, gloss=gloss, loss1=float(loss1), loss2=float(loss2),
        finite=finite, resident=mem["argument_size_in_bytes"],
        peak=max(mem["peak_bytes"], peak2), ms1=ms1, ms2=ms2, coll=coll,
        counts=counts, setup=setup, cuda=dev.type == "cuda",
        shape="x".join(map(
            str, mesh.devices_shape)), strategy=strategy,
        rows=tuple(batch.ft.tokens.shape), layers=cfg.n_layers,
        rank=dist.get_rank()))


def qwen_gate(label, stats):
    """qwen1.5-110b's train arm: the first step's loss equal to the
    forward-only step's to bf16 rounding (one bf16 ulp of it, 2^-8 of its
    size), the second step's below the first, every grad finite, each
    card's peak under 80 GB, the fused SMLM never launched; prints every
    card's readings."""
    for st in stats:
        print(f"{label} qwen1.5-110b bf16 {st['layers']} layers ft rows "
              f"{st['rows'][0]}x{st['rows'][1]} card {st['rank']}: "
              f"resident_GB={st['resident'] / 1e9:.3f} peak_GB="
              f"{st['peak'] / 1e9:.3f} setup_s={st['setup']:.2f} train step"
              f" 1 ms={st['ms1']:.3f} step 2 ms={st['ms2']:.3f} collective "
              f"operand bytes of step 1 (all-reduce / all-gather / "
              f"reduce-scatter / all-to-all) {st['coll']} launches="
              f"{st['counts']}")
    st = stats[0]
    print(f"{label}: forward-only loss {st['fwd']:.6f}, grad step loss "
          f"{st['gloss']:.6f}, train step 1 loss {st['loss1']:.6f}, step 2 "
          f"loss {st['loss2']:.6f}, grads finite {st['finite']}")
    ulp = abs(st["fwd"]) * 2.0 ** -8
    bad = [s["rank"] for s in stats if not s["finite"]
           or s["peak"] >= 80e9 or s["cuda"] and (
               s["counts"]["smlm"] or not s["counts"]["smlm_wgrad"])]
    if bad or abs(st["loss1"] - st["fwd"]) > ulp or \
            abs(st["gloss"] - st["fwd"]) > ulp or \
            not st["loss2"] < st["loss1"]:
        raise AssertionError(f"{label}: cards {bad}; losses forward "
                             f"{st['fwd']} grad {st['gloss']} step 1 "
                             f"{st['loss1']} step 2 {st['loss2']} (bf16 ulp "
                             f"{ulp:.4g})")
    print(f"{label}: ok (step 1 within {ulp:.4g} of the forward's loss, "
          f"step 2 below step 1, every grad finite, peak under 80 GB)")


# remat (``remat:``, one card, and the ``--mesh`` arms ``train_remat`` /
# ``train_qwen_4k``): llama3-8b bf16 at all 32 layers on 4096-token ft rows
# in chunks of 1024 (JAX dryrun's ``DEFAULT_CHUNK``), one train step with
# remat off and one with it on at ``rows``, then remat alone at ``wide``
# rows; jamba at 8 layers (one period, int8) in a mixed tick; qwen1.5-110b
# bf16 at 80 layers on one 4096-token row.  Gated at (leaf, loss): remat
# on against off on the same weights and batch
REMAT_LLAMA = dict(rows=1, wide=2, seq=4096, chunk=1024)
REMAT_JAMBA = dict(layers=8, rows=2, seq=256, prompt=128)
REMAT_LIMITS = (0.03, 1e-3)
REMAT_CACHE_LIMIT = 1e-3        # x max |leaf| of the remat-off tick's cache
QWEN_4K = dict(seq=4096, chunk=1024)


def remat_phase(K, cfg, weights, dev):
    """``remat:`` on one card, llama3-8b bf16 (phase 4's weights): one grad
    and one train step over ``REMAT_LLAMA["rows"]`` ft rows of 4096 tokens
    with remat off, the same with it on; each step's ms, resident and peak
    bytes and loss; the remat steps' grads, new bank and moments against
    the plain steps' (``REMAT_LIMITS``); the fused SMLM launched once more
    a projection and step with remat (each period's forward runs again in
    the backward), and ``smlm_wgrad`` once a projection and step, exactly.
    Then the same at ``REMAT_LLAMA["wide"]`` rows
    with remat alone.  Returns the remat steps' launches."""
    bf16 = torch.bfloat16
    r = REMAT_LLAMA
    w = (weights[0], weights[1].bank, weights[1].scale)
    batch, _, _ = train_batch(cfg, r["rows"], r["seq"], dev, seed=60)
    arms = {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        arms[remat] = train_steps(K, cfg, w, batch, None, None, dev,
                                  remat=remat, attn_chunk=r["chunk"])
    label = (f"remat: {cfg.name} bf16 {cfg.n_layers} layers {r['rows']}x"
             f"{r['seq']} ft rows attn_chunk={r['chunk']}")
    for remat, a in arms.items():
        print(f"{label} remat={remat}: train step ms={a['ms']:.3f} "
              f"resident_bytes={a['resident']} peak_bytes={a['peak']} loss "
              f"{a['tloss']:.6f} launches over the grad and train steps "
              f"{a['counts']}")
    train_gate(f"{label} remat on vs off", arms[True], arms[False], bf16,
               limits=REMAT_LIMITS)
    on, off = arms[True]["counts"], arms[False]["counts"]
    # over the grad and the train step: the recompute runs each
    # projection's forward once more a step; the backward is unchanged
    n_lora = sum(len(layer) for layer in arms[True]["grads"]["layers"])
    want = {"smlm": off["smlm"] + 2 * n_lora, "smlm_wgrad": 2 * n_lora}
    seen = {k: on[k] for k in want}
    if dev.type == "cuda" and seen != want:
        raise AssertionError(f"{label}: launches remat {seen}, want {want} "
                             f"(plain {off})")
    print(f"{label}: launches with remat {seen} (predicted {want}) ok")
    del arms
    gc.collect()
    torch.cuda.empty_cache()
    wide, _, _ = train_batch(cfg, r["wide"], r["seq"], dev, seed=61)
    a = train_steps(K, cfg, w, wide, None, None, dev, remat=True,
                    attn_chunk=r["chunk"])
    if not (np.isfinite(a["tloss"]) and np.isfinite(a["norm"])):
        raise AssertionError(f"remat: {r['wide']}x{r['seq']}: loss "
                             f"{a['tloss']} grad norm {a['norm']}")
    print(f"remat: {cfg.name} bf16 {cfg.n_layers} layers {r['wide']}x"
          f"{r['seq']} ft rows remat=True: train step ms={a['ms']:.3f} "
          f"resident_bytes={a['resident']} peak_bytes={a['peak']} loss "
          f"{a['tloss']:.6f} grad norm {a['norm']:.6g} finite ok")
    return on


def remat_jamba(K, dev):
    """``remat:`` on one card, jamba-1.5-large-398b int8 at 8 layers (one
    period: Mamba2 layers, an attention layer, MoE on every other layer):
    two prompts prefilled into dense rows 0-1, then one mixed grad tick
    (``REMAT_JAMBA["rows"]`` ft rows, a cold prefill at row 2, decode of
    rows 0-1: the Mamba state read and written in place) with remat off
    and on, each from its own copy of the same cache.  Gates: the cache
    after the tick within ``REMAT_CACHE_LIMIT``, the loss and grads
    within ``REMAT_LIMITS`` (the
    MoE router reads the serving rows beside the ft rows, so a decode step
    run twice would move the ft rows' routing too); flash, dense decode,
    SMLM, BGMV and ``smlm_wgrad`` launched.  Returns the remat tick's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.core.unified import make_forward_step, make_grad_step
    from repro_torch.models.model import init_cache
    from repro_torch.models.stream import DECBatch, PFBatch, UnifiedBatch
    from repro_torch.training.optimizer import tree_map
    r = REMAT_JAMBA
    cfg = get_config("jamba-1.5-large-398b").replace(n_layers=r["layers"])
    torch.cuda.empty_cache()
    params, store, setup = arch_weights(cfg, dev, True)
    rng = np.random.default_rng(61)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    P = r["prompt"]
    cache = init_cache(cfg, 3, 2 * P, dev, torch.bfloat16)
    make_forward_step(cfg, block_t=K["block_t"])(
        params, store.bank, store.scale, UnifiedBatch(pf=PFBatch(
            tokens=tt(rng.integers(0, cfg.vocab, (2, P)).astype(np.int32)),
            length=tt(np.asarray([P, P - 17], np.int32)),
            adapter=tt(np.asarray([0, 1], np.int32)))), cache)
    ft = train_batch(cfg, r["rows"], r["seq"], dev, seed=62)[0].ft
    batch = UnifiedBatch(
        ft=ft, pf=PFBatch(
            tokens=tt(rng.integers(0, cfg.vocab, (1, P)).astype(np.int32)),
            length=tt(np.asarray([P - 5], np.int32)),
            adapter=tt(np.asarray([1], np.int32))),
        dec=DECBatch(tokens=tt(rng.integers(0, cfg.vocab, (2,)).astype(
            np.int32)), pos=tt(np.asarray([P, P - 17], np.int32)),
            adapter=tt(np.asarray([1, 0], np.int32))))
    res = {}
    # remat off twice: the floor two plain ticks differ by (the bf16
    # backward's atomic accumulations run in any order)
    for key, remat in (("off", False), ("off again", False), ("on", True)):
        c = {k: v.clone() for k, v in cache.items()}
        reset_counts(K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = make_grad_step(cfg, block_t=K["block_t"], remat=remat)(
            params, store.bank, store.scale, batch, c)
        torch.cuda.synchronize()
        res[key] = dict(ms=(time.perf_counter() - t0) * 1e3,
                        peak=torch.cuda.max_memory_allocated(),
                        loss=float(out.loss), counts=read_counts(K),
                        grads=tree_map(lambda x: x.float().cpu(),
                                       out.grads), cache=c)
        del out
    label = (f"remat: {cfg.name} int8 {cfg.n_layers} layers mixed tick "
             f"({r['rows']}x{r['seq']} ft rows, a {P}-token prefill, 2 "
             f"decode rows)")
    cache_err = max(
        float((a.float() - res["off"]["cache"][k].float()).abs().max())
        / max(float(res["off"]["cache"][k].float().abs().max()), 1e-30)
        for k, a in res["on"]["cache"].items())
    for key, x in res.items():
        print(f"{label} remat {key}: grad step ms={x['ms']:.3f} "
              f"peak_bytes={x['peak']} loss {x['loss']:.6f} launches "
              f"{x['counts']}")
    print(f"{label}: cache after the tick, remat on vs off, worst leaf "
          f"max_abs_err / max|leaf| = {cache_err:.4g} (limit "
          f"{REMAT_CACHE_LIMIT:g})")
    floor = train_errs(res["off again"], res["off"])
    print(f"{label}: two remat-off ticks (record): loss abs_err="
          f"{floor['loss']:.4g} grads={floor['grads'][0]:.4g}@"
          f"{floor['grads'][1]}")
    train_gate(f"{label} remat on vs off", res["on"], res["off"],
               torch.bfloat16, limits=REMAT_LIMITS)
    c = res["on"]["counts"]
    need = ("smlm", "bgmv", "flash", "dense_decode", "smlm_wgrad")
    if not cache_err <= REMAT_CACHE_LIMIT or not np.isfinite(
            res["on"]["loss"]) or (
            dev.type == "cuda" and not min(c[k] for k in need)):
        raise AssertionError(f"{label}: cache {cache_err}, loss "
                             f"{res['on']['loss']}, launches {c}")
    del params, store, cache, res
    gc.collect()
    torch.cuda.empty_cache()
    return c


def train_remat_arms(K, get_config, m14, m22, dev, lead, verdict):
    """``--mesh-arms train_remat``: llama3-8b at full width, fp32, 8
    layers, at ``(1, 4)`` tp and ``(2, 2)`` fsdp_tp, on 4 x 512 ft rows and
    the mixed batch: the grad step with remat and the train step with
    remat and ``act_constraint_fn`` (the carry between periods a rank's
    block of the tokens) against one card's plain steps and against the
    same mesh's steps without remat, both at ``TRAIN_LIMIT``; the cut's
    adjoint giving back only a rank's own block (``planted_train``
    "cut") must break the first."""
    import torch.distributed as dist
    f32 = torch.float32
    cfg = get_config("llama3-8b").replace(n_layers=8)
    batches = {"ft": train_batch(cfg, 4, 512, dev, seed=20, dtype=f32),
               "mixed": train_batch(cfg, 2, 512, dev, seed=21, mixed=True,
                                    dtype=f32)}
    got, plain, bad = {}, {}, {}
    for key, mesh, st in (("1x4 tp", m14, "tp"),
                          ("2x2 fsdp_tp", m22, "fsdp_tp")):
        w = mesh_weights(cfg, mesh, st, dev, f32)
        for name, (batch, cache, segs) in batches.items():
            got[key, name] = train_steps(K, cfg, w, batch, cache, segs, dev,
                                         mesh, st, remat=True,
                                         act_constraint=True)
            c = got[key, name]["counts"]
            if dev.type == "cuda" and (c["smlm"] or c["bgmv"] or not min(
                    c[k] for k in SPLIT_COUNTERS[:2] + ("smlm_wgrad",))):
                raise AssertionError(f"mesh: train_remat {key} {name} rank "
                                     f"{dist.get_rank()}: launches {c}")
            plain[key, name] = train_steps(K, cfg, w, batch, cache, segs,
                                           dev, mesh, st)
        mod, attr, planted = planted_train(K, mesh, "cut")
        orig = getattr(mod, attr)
        setattr(mod, attr, planted)
        try:
            batch, cache, segs = batches["ft"]
            bad[key] = train_steps(K, cfg, w, batch, cache, segs, dev, mesh,
                                   st, remat=True, act_constraint=True)
        finally:
            setattr(mod, attr, orig)
        del w
        gc.collect()
        torch.cuda.empty_cache()
    stats = gather_stats({k: {f: v[f] for f in ("ms", "coll", "resident",
                                                "peak", "counts")}
                          for k, v in got.items()})
    plain_stats = gather_stats({k: {f: v[f] for f in ("ms", "coll", "peak")}
                                for k, v in plain.items()})
    ref = {}
    if lead:
        w = mesh_weights(cfg, None, None, dev, f32)
        for name, (batch, cache, segs) in batches.items():
            ref[name] = train_steps(K, cfg, w, batch, cache, segs, dev)
        del w
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()

    def check():
        label = f"mesh: train_remat {cfg.name} fp32 {cfg.n_layers} layers"
        for (key, name), res in got.items():
            for rank, st in enumerate(stats):
                x, y = st[key, name], plain_stats[rank][key, name]
                print(f"{label} {key} {name} card {rank}: remat + "
                      f"act_constraint train step ms={x['ms']:.3f} "
                      f"resident_bytes={x['resident']} peak_bytes="
                      f"{x['peak']} collective operand bytes {x['coll']} "
                      f"launches={x['counts']}; without remat ms="
                      f"{y['ms']:.3f} peak_bytes={y['peak']} collective "
                      f"operand bytes {y['coll']}")
            train_gate(f"{label} {key} {name} remat vs one card", res,
                       ref[name], f32)
            train_gate(f"{label} {key} {name} remat vs the same mesh "
                       f"without remat", res, plain[key, name], f32)
        for key, res in bad.items():
            train_gate(f"{label} {key} ft with a planted fault (the "
                       f"carry's cut gives back only a rank's own block of "
                       f"the gradient) vs one card", res, ref["ft"], f32,
                       expect_ok=False)
    verdict(check)


def big_train_arm(K, cfg, mesh, strategy, dev, batch, kinds, int8=False,
                  chunk=0):
    """``cfg`` bf16 at every layer on this rank's shards (with ``int8``
    each eligible leaf quantized whole, then cut), ``attn_chunk`` ``chunk``:
    one train step of each of ``kinds`` in turn ("remat +
    act_constraint": remat and ``act_constraint_fn``; "remat alone";
    "plain"), each from the last one's bank and moments, under
    ``roofline.analysis.memory_summary``, each with its collective bytes.
    Returns every rank's readings (on every rank)."""
    import torch.distributed as dist
    from repro_torch.core.unified import make_train_step
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.optimizer import AdamWConfig, adamw_init, \
        tree_leaves
    t0 = time.perf_counter()
    params, bank, scale = mesh_weights(cfg, mesh, strategy, dev,
                                       torch.bfloat16, seed=4, int8=int8)
    setup = time.perf_counter() - t0
    kw = dict(block_t=K["block_t"], mesh=mesh, strategy=strategy,
              attn_chunk=chunk)
    opt = AdamWConfig(**TRAIN_OPT)
    steps = {"remat + act_constraint": make_train_step(
        cfg, opt, remat=True, act_constraint=SH.act_constraint_fn(mesh),
        **kw), "remat alone": make_train_step(cfg, opt, remat=True, **kw),
        "plain": make_train_step(cfg, opt, **kw)}
    st = adamw_init(bank, len(TRAIN_SLOTS))
    mask = torch.tensor(TRAIN_SLOTS, dtype=torch.int32, device=dev)
    mesh_reset(K)
    out = []
    for kind in kinds:
        SH.reset_collective_log()
        t1 = time.perf_counter()
        mem = RA.memory_summary(steps[kind], params, bank, scale, st, batch,
                                mask, state=[params, bank, st], device=dev)
        ms = (time.perf_counter() - t1) * 1e3
        loss, bank, st, _ = mem.pop("out")
        out.append(dict(kind=kind, loss=float(loss), ms=ms,
                        resident=mem["argument_size_in_bytes"],
                        peak=mem["peak_bytes"], coll=SH.collective_log(),
                        finite=bool(torch.isfinite(loss)) and all(
                            bool(torch.isfinite(x).all())
                            for x in tree_leaves(bank))))
    counts = {**read_counts(K), **mesh_counts(K, SPLIT_COUNTERS)}
    rows, S = batch.ft.tokens.shape
    _, bound_ms, _ = step_cost_coll(cfg, "train", S, rows,
                                    mesh.shape["data"], mesh.shape["model"],
                                    strategy)
    del params, bank, st, steps
    gc.collect()
    torch.cuda.empty_cache()
    return gather_stats(dict(
        steps=out, counts=counts, setup=setup, bound_ms=bound_ms,
        cuda=dev.type == "cuda", layers=cfg.n_layers, name=cfg.name,
        dtype="int8/bf16" if int8 else "bf16", strategy=strategy,
        shape="x".join(map(str, mesh.devices_shape)), rows=(rows, S),
        rank=dist.get_rank()))


def big_train_gate(label, stats):
    """A ``big_train_arm``: every step's loss finite and below the last,
    every card's bank finite and peak under 80 GB, the fused SMLM never
    launched and ``smlm_wgrad`` launched; prints every card's readings and
    the ``costs:`` share (``step_cost``'s bound over the step's ms; its
    train flops count a remat forward)."""
    for sx in stats:
        for i, x in enumerate(sx["steps"]):
            print(f"{label} {sx['name']} {sx['dtype']} {sx['layers']} layers "
                  f"ft rows {sx['rows'][0]}x{sx['rows'][1]} card "
                  f"{sx['rank']} step {i + 1} ({x['kind']}): ms="
                  f"{x['ms']:.3f} resident_GB={x['resident'] / 1e9:.3f} "
                  f"peak_GB={x['peak'] / 1e9:.3f} all-reduce_bytes="
                  f"{x['coll']['all-reduce']} all-gather_bytes="
                  f"{x['coll']['all-gather']} collective operand bytes "
                  f"{x['coll']} loss {x['loss']:.6f}")
        print(f"{label} card {sx['rank']}: setup_s={sx['setup']:.2f} "
              f"launches={sx['counts']}")
    st = stats[0]
    dp, tp = (int(v) for v in st["shape"].split("x"))
    for i, x in enumerate(st["steps"]):
        print(f"costs: {label} step {i + 1} ({x['kind']}) step_cost(kind="
              f"train, seq_len={st['rows'][1]}, batch={st['rows'][0]}, "
              f"dp={dp}, tp={tp}, strategy={st['strategy']}) bound_ms="
              f"{st['bound_ms']:.3f} measured_ms={x['ms']:.3f} share="
              f"{st['bound_ms'] / x['ms']:.4f}")
    losses = [x["loss"] for x in st["steps"]]
    bad = [s["rank"] for s in stats if not all(
        x["finite"] and x["peak"] < 80e9 for x in s["steps"])
        or s["cuda"] and (s["counts"]["smlm"]
                          or not s["counts"]["smlm_wgrad"])]
    if bad or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{label}: cards {bad}; losses {losses}")
    print(f"{label}: ok (losses {', '.join(f'{v:.6f}' for v in losses)} "
          f"falling, every bank finite, peak under 80 GB)")


# the other families' train steps on four cards (``--mesh-arms
# train_families``, ROADMAP 5b-iii-a), fp32 at published widths, cut in
# depth: (label, arch, config changes, int8, remat + act_constraint)
TRAIN_FAMILIES = (
    ("mamba2", "mamba2-1.3b", dict(n_layers=8), False, True),
    ("whisper", "whisper-base", {}, False, False),
    ("vlm", "llama-3.2-vision-90b", dict(n_layers=5), False, True),
    ("llama_q8", "llama3-8b", dict(n_layers=8), True, False))
# ``--mesh-arms train_vlm`` / ``train_qwen_int8``: every layer on four
# cards, 2 ft rows (the VLM's with 1600-patch sources), three train steps:
# (arch, int8, mesh, strategy, row length, the steps' kinds)
TRAIN_BIG = {
    "train_vlm": ("llama-3.2-vision-90b", False, "1x4", "tp", 512,
                  ("remat + act_constraint",) * 3),
    "train_qwen_int8": ("qwen1.5-110b", True, "2x2", "fsdp_tp", 256,
                        ("plain",) * 3)}


def train_family_arms(K, get_config, m14, m22, dev, lead, verdict):
    """``--mesh-arms train_families``: each ``TRAIN_FAMILIES`` arm at
    ``(1, 4)`` tp and ``(2, 2)`` fsdp_tp, on 4 x 512 ft rows and on the
    mixed ft + prefill + decode batch over dense rows (a cross arm's rows
    with their sources; a Mamba arm's decode rows advance its state once):
    the grad step (with remat where the arm says) and the train step (with
    remat and ``act_constraint_fn`` there) against one card's plain steps
    on the same weights and batch (rank 0), gated at ``TRAIN_LIMIT``; on
    mamba2 at ``(1, 4)`` the gated norm's sum with the identity as its
    adjoint (``planted_train`` "gsq") must break it.  Returns card 0's
    launches of each arm."""
    import torch.distributed as dist
    f32 = torch.float32
    by_path = {}
    for label, arch, change, int8, remat in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_config(arch).replace(**change)
        batches = {"ft": train_batch(cfg, 4, 512, dev, seed=50, dtype=f32),
                   "mixed": train_batch(cfg, 2, 512, dev, seed=51,
                                        mixed=True, dtype=f32)}
        got, bad = {}, {}
        for key, mesh, st in (("1x4 tp", m14, "tp"),
                              ("2x2 fsdp_tp", m22, "fsdp_tp")):
            w = mesh_weights(cfg, mesh, st, dev, f32, int8=int8)
            for name, (batch, cache, segs) in batches.items():
                got[key, name] = train_steps(
                    K, cfg, w, batch, cache, segs, dev, mesh, st,
                    remat=remat, act_constraint=remat)
                c = got[key, name]["counts"]
                if dev.type == "cuda" and (c["smlm"] or c["bgmv"] or not min(
                        c[k] for k in SPLIT_COUNTERS[:2] + ("smlm_wgrad",))):
                    raise AssertionError(f"mesh: train {label} {key} {name} "
                                         f"rank {dist.get_rank()}: launches "
                                         f"{c}")
            if label == "mamba2" and key == "1x4 tp":
                mod, attr, planted = planted_train(K, mesh, "gsq")
                orig = getattr(mod, attr)
                setattr(mod, attr, planted)
                try:
                    batch, cache, segs = batches["ft"]
                    bad[key] = train_steps(K, cfg, w, batch, cache, segs,
                                           dev, mesh, st, grads_only=True,
                                           remat=remat)
                finally:
                    setattr(mod, attr, orig)
            del w
            gc.collect()
            torch.cuda.empty_cache()
        stats = gather_stats({k: {f: v[f] for f in ("ms", "coll",
                                                    "resident", "peak",
                                                    "counts")}
                              for k, v in got.items()})
        ref = {}
        if lead:
            w = mesh_weights(cfg, None, None, dev, f32, int8=int8)
            for name, (batch, cache, segs) in batches.items():
                ref[name] = train_steps(K, cfg, w, batch, cache, segs, dev)
            del w
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
        tag = (f"mesh: train {label} {cfg.name} {'int8/' if int8 else ''}"
               f"fp32 {cfg.n_layers} layers"
               + (" remat + act_constraint" if remat else ""))

        def check():
            for name, r in ref.items():
                print(f"{tag} {name} one card: train step ms={r['ms']:.3f} "
                      f"peak_bytes={r['peak']}")
            for (key, name), res in got.items():
                for rank, sx in enumerate(stats):
                    x = sx[key, name]
                    print(f"{tag} {key} {name} card {rank}: train step ms="
                          f"{x['ms']:.3f} resident_bytes={x['resident']} "
                          f"peak_bytes={x['peak']} collective operand bytes "
                          f"{x['coll']} launches={x['counts']}")
                train_gate(f"{tag} {key} {name} vs one card", res,
                           ref[name], f32)
            for key, res in bad.items():
                train_gate(f"{tag} {key} ft with a planted fault (the gated "
                           f"norm's sum of squares with the identity as its "
                           f"adjoint) vs one card", res, ref["ft"], f32,
                           expect_ok=False)
            print(f"{tag}: wall_s={time.perf_counter() - t0:.1f}")
        verdict(check)
        total = {}
        for sx in stats[0].values():
            for k, v in sx["counts"].items():
                total[k] = total.get(k, 0) + v
        by_path[f"train_families_{label}"] = total
        del got, bad, ref
    return by_path


def _split_entries():
    from repro_torch.kernels.bgmv import bgmv_expand, bgmv_shrink
    from repro_torch.kernels.smlm import smlm_expand, smlm_shrink
    return dict(smlm_shrink=smlm_shrink, smlm_expand=smlm_expand,
                bgmv_shrink=bgmv_shrink, bgmv_expand=bgmv_expand)


MESH_ARMS = ("llama", "qwen", "maverick", "vlm", "dsv2", "whisper",
             "window", "phi3", "seq", "seq_window", "seq_vlm", "mamba2",
             "jamba", "jamba_deep", "dsv2_window", "train", "train_qwen",
             "train_remat", "train_qwen_4k", "train_families", "train_vlm",
             "train_qwen_int8")


def mesh_main(K, only=MESH_ARMS) -> int:
    """``--mesh``: the 4-rank arms, one process a card, NCCL; the kernels
    are built here first so that four ranks never build at once."""
    import torch.multiprocessing as mp
    n = torch.cuda.device_count()
    if n < 4:
        print(f"chip_smoke --mesh: needs 4 cards, {n} visible",
              file=sys.stderr)
        return 2
    port = free_port()
    ctx = mp.start_processes(mesh_rank, args=(4, port, tuple(only)),
                             nprocs=4, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S * 8
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("the mesh ranks did not finish in "
                                   f"{MESH_TIMEOUT_S * 8} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        raise
    return 0


def mesh_phase(K, cfg, weights, dev):
    """Phase 15 of the default run, one card: (a) reduced llama3-8b fp32,
    the sharded step on a ``(1, 1)`` mesh over an NCCL process group of one
    rank on the card against the same step on the CPU (tokens equal,
    logits within 1e-3); (b) full-width llama3-8b bf16 (phase 4's weights)
    through the sharded step on that mesh (every collective the identity,
    the LoRA terms through the split shrink and expand entries) against the
    plain step: first-step logits within the bf16 tolerance, divergences
    near ties, the split entries, flash and dense decode launched and the
    fused SMLM and BGMV calls not; then the other (1, 1) arms on that
    mesh: the families, the cache layouts, Mamba2 / jamba / MLA's window,
    the train step of llama3-8b (with remat) and of the other families.
    Returns (b)'s launches and each of those arms'."""
    import torch.distributed as dist
    from repro_torch.core.unified import make_forward_step
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import init_mesh
    start_group(0, 1, free_port())
    try:
        mesh = init_mesh((1, 1), ("data", "model"), timeout_s=MESH_TIMEOUT_S)
        small = get_reduced("llama3-8b")
        p = mesh_prompts(small, 4, 32, seed=4)
        got = {}
        for d in ("cuda", "cpu"):
            dv = torch.device(d)
            w = mesh_weights(small, None, None, torch.device("cpu"),
                             dtype=torch.float32)
            w = (to_device(w[0], dv), to_device(w[1], dv), w[2].to(dv))
            step = make_forward_step(small, block_t=K["block_t"], mesh=mesh,
                                     strategy="tp")
            got[d] = mesh_generate(small, step, w, mesh, p, 4, dv,
                                   torch.float32)["rows"]
        tc = {r: [t for t, _ in v] for r, v in got["cuda"].items()}
        tp_ = {r: [t for t, _ in v] for r, v in got["cpu"].items()}
        err = max(float((a[1] - b[1]).abs().max())
                  for r in got["cuda"] for a, b in zip(got["cuda"][r],
                                                       got["cpu"][r]))
        if tc != tp_ or err > 1e-3:
            raise AssertionError(f"mesh (1, 1) cuda {tc} cpu {tp_} logits "
                                 f"{err:.3e}")
        print(f"mesh: (1, 1) NCCL mesh of one rank, reduced llama3-8b fp32 "
              f"cuda==cpu greedy tokens for 4 requests (20 tokens), logits "
              f"max_abs_err={err:.3e} tol=1e-3 ok")
        params, store = weights[0], weights[1]
        w = (params, store.bank, store.scale)
        p = mesh_prompts(cfg, 4, 256, seed=5)
        plain = mesh_generate(cfg, make_forward_step(cfg, block_t=K[
            "block_t"]), w, None, p, 8, dev)
        mesh_reset(K)
        res = mesh_generate(cfg, make_forward_step(
            cfg, block_t=K["block_t"], mesh=mesh, strategy="tp"), w, mesh,
            p, 8, dev)
        counts = read_counts(K)
        counts.update(mesh_counts(K, SPLIT_COUNTERS))
        same_rows("mesh: (1, 1) llama3-8b bf16 full width, the sharded step "
                  "vs the plain step", "plain", plain["rows"], "mesh",
                  res["rows"], torch.bfloat16, 4 * 9)
        fused = {k: counts[k] for k in ("smlm", "bgmv") if counts[k]}
        missing = [k for k in MESH_NEED if not counts[k]]
        if fused or missing:
            raise AssertionError(f"the (1, 1) mesh step launched the fused "
                                 f"LoRA calls {fused} or not {missing}: "
                                 f"{counts}")
        print(f"mesh: (1, 1) llama3-8b bf16 B=4x256 + 8 decode steps: "
              f"prefill {tick_ms([res['prefill']])} decode "
              f"{tick_ms(res['decode'])} launches={counts} ok")
        fam = mesh_families_local(K, mesh, dev)
        lay = mesh_families_local(K, mesh, dev, LAYOUTS_LOCAL)
        ssm = mesh_families_local(K, mesh, dev, SSM_LOCAL)
        train, train_remat = mesh_train_local(K, mesh, dev)
        train_fam = mesh_train_families_local(K, mesh, dev)
        print("mesh: the 4-rank arms ((1, 4) tp and (2, 2) fsdp_tp: "
              "llama3-8b, qwen1.5-110b at 80 layers, maverick's 2 layers "
              "expert-parallel, llama-3.2-vision-90b at 100 layers, "
              "deepseek-v2-236b int8 at 60 layers, whisper-base, a windowed "
              "llama3-8b; the cache layouts: phi3-medium-14b, llama3-8b, "
              "the windowed llama3-8b and the VLM under cache_strategy "
              "'seq'; mamba2-1.3b, jamba-1.5-large-398b int8 at 8 and 40 "
              "layers, deepseek-v2-236b at long_500k's window; the train "
              "step: llama3-8b fp32 8 layers and bf16 32 layers, "
              "qwen1.5-110b bf16 at 80 layers; the other families' train "
              "steps: mamba2-1.3b, whisper-base, the VLM and llama3-8b "
              "int8 in fp32, the VLM bf16 at 100 layers, qwen1.5-110b int8 "
              "at 80 layers) need --mesh on a host with "
              "four cards: python3 chip_smoke.py --mesh")
        return counts, fam, lay, ssm, train, train_remat, train_fam
    finally:
        dist.destroy_process_group()


# phase 15's one-card arms of the other families, each through the sharded
# step on the (1, 1) mesh against the plain step: (label, arch, config
# changes, int8, prompts B x S, decode steps, cache strategy)
FAMILY_LOCAL = (
    ("vlm", "llama-3.2-vision-90b", dict(n_layers=5), False, 4, 256, 8,
     "auto"),
    ("dsv2", "deepseek-v2-236b", dict(n_layers=2), True, 4, 256, 8, "auto"),
    ("whisper", "whisper-base", {}, False, 4, 256, 8, "auto"),
    ("window", "llama3-8b", dict(n_layers=2, sliding_window=8192), False, 2,
     9000, 8, "auto"))
# and of the cache layouts: on one rank both are the whole row; "seq" still
# decodes through split-K's partial and merge kernels (256 slots: 64-slot
# blocks)
LAYOUTS_LOCAL = (
    ("phi3", "phi3-medium-14b", dict(n_layers=2), False, 4, 256, 8, "auto"),
    ("seq", "llama3-8b", dict(n_layers=2), False, 4, 240, 16, "seq"))
# and of Mamba2, the hybrid stack and MLA's rolling rows (key ``mesh_ssm``;
# ``attn_chunk`` is the step's: MLA's 9000-token prefill in blocks of 1024;
# ``fp32``: int8 weights dequantized to fp32, for jamba's random routers:
# in bf16 the split LoRA entries' rounding (BGMV's shrink sums its slices
# of d_in in another order than the fused call) flipped near-tied top-2
# choices at decode and moved a row's logits by up to 1.15 (NVIDIA H100
# 80GB HBM3, 700 W), as deepseek-v2's 8 layers did across cards (PR 30))
SSM_LOCAL = (
    ("mamba2", "mamba2-1.3b", dict(n_layers=2), False, 4, 256, 8, "auto"),
    ("jamba", "jamba-1.5-large-398b", dict(n_layers=8, fp32=True), True,
     4, 256, 8, "auto"),
    ("dsv2_window", "deepseek-v2-236b",
     dict(n_layers=2, sliding_window=8192, attn_chunk=1024), False, 1, 9000,
     8, "auto"))


def mesh_families_local(K, mesh, dev, arms=FAMILY_LOCAL):
    """Phase 15's ``FAMILY_LOCAL`` (or ``LAYOUTS_LOCAL``, ``SSM_LOCAL``)
    arms on the ``(1, 1)`` ``mesh``, the rows cut under each arm's cache
    strategy: each config's weights whole on the card (an int8 one quantized leaf by
    leaf), prefill and greedy decode through the plain step and through
    the sharded step; the sharded run's first-step logits within
    ``MESH_LIMIT`` of a row's max and its divergences near ties, the
    split SMLM / BGMV entries launched and the fused calls not, flash and
    dense decode launched (MLA: split-K's merge kernel, its decode's merge
    over the model axis; "seq": split-K's partial and merge kernels, not
    dense decode; a stack with no attention layer: the split entries
    alone).  Returns the arms' launches summed."""
    from repro_torch.configs import get_config
    from repro_torch.core.unified import make_forward_step
    total = {}
    for label, arch, change, int8, B, S, n, cs in arms:
        change = dict(change)
        chunk = change.pop("attn_chunk", 0)
        dtype = torch.float32 if change.pop("fp32", False) else \
            torch.bfloat16
        cfg = get_config(arch).replace(**change)
        t0 = time.perf_counter()
        w = mesh_weights(cfg, None, None, dev, dtype, int8=int8)
        setup = time.perf_counter() - t0
        p = mesh_prompts(cfg, B, S, seed=10)
        plain = mesh_generate(cfg, make_forward_step(
            cfg, block_t=K["block_t"], attn_chunk=chunk), w, None, p, n, dev,
            dtype)
        mesh_reset(K)
        res = mesh_generate(cfg, make_forward_step(
            cfg, block_t=K["block_t"], mesh=mesh, strategy="tp",
            cache_strategy=cs, attn_chunk=chunk), w, mesh, p, n, dev, dtype,
            cache_strategy=cs)
        counts = read_counts(K)
        counts.update(mesh_counts(K, SPLIT_COUNTERS))
        del w
        gc.collect()
        torch.cuda.empty_cache()
        name = (f"mesh: (1, 1) {label} {cfg.name} "
                f"{'int8/' if int8 else ''}{DTYPE_NAME[dtype]} "
                f"{cfg.n_layers} layers cache_strategy={cs}")
        same_rows(f"{name}, the sharded step vs the plain step", "plain",
                  plain["rows"], "mesh", res["rows"], dtype, B * (n + 1),
                  MESH_LIMIT[dtype])
        need = (MLA_NEED if cfg.mla is not None else
                SSM_NEED if "attn" not in cfg.pattern else
                SEQ_NEED if cs == "seq" else MESH_NEED)
        fused = {k: counts[k] for k in ("smlm", "bgmv") if counts[k]}
        missing = [k for k in need if not counts[k]]
        if cs == "seq" and counts["dense_decode"]:
            missing.append("dense_decode 0")
        if fused or missing:
            raise AssertionError(f"{name}: the sharded step launched the "
                                 f"fused LoRA calls {fused} or not "
                                 f"{missing}: {counts}")
        print(f"{name} B={B}x{S} + {n} decode steps: setup_s={setup:.2f} "
              f"resident_bytes={res['resident']} peak_bytes={res['peak']}; "
              f"sharded prefill {tick_ms([res['prefill']])} decode "
              f"{tick_ms(res['decode'])}; plain prefill "
              f"{tick_ms([plain['prefill']])} decode "
              f"{tick_ms(plain['decode'])} launches={counts} ok")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


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
        rows.update(check_wgrad(K, dtype, dev, gen, timing))
        rows.update(check_attention(K, dtype, dev, gen, timing))
        rows.update(check_verify(K, dtype, dev, gen, timing))
        rows.update(check_splitk(K, dtype, dev, gen, timing))
        rows.update(check_dense_kernels(K, dtype, dev, gen, timing))
        rows.update(check_arch_shapes(K, dtype, dev, gen, timing))
        rows.update(check_window_kernels(K, dtype, dev, gen, timing))
    for name, r in rows.items():
        lib = r["library_ms"]
        print(f"timing: {name:<15} bf16 {r['shape']}: ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} library_ms="
              f"{'none' if lib is None else f'{lib:.5f}'}"
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
    ap.add_argument("--memory", action="store_true",
                    help="only the memory features: phase 3's lending, "
                         "paging and chunked-training parity, phases 9-10")
    ap.add_argument("--fleet", action="store_true",
                    help="only the fleet: phase 3's fleet case, phase 11")
    ap.add_argument("--archs", action="store_true",
                    help="only the other configs: the mla/ssd/xattn "
                         "records, phase 3's arch parity, phase 12")
    ap.add_argument("--window", action="store_true",
                    help="only sliding windows: the windowed flash rows and "
                         "phase 13")
    ap.add_argument("--examples", action="store_true",
                    help="only the example twins: phase 14 (the costs: "
                         "lines without the ticks of phases 4, 6 and 8)")
    ap.add_argument("--mesh", action="store_true",
                    help="only the 4-rank arms of phase 15, one NCCL rank "
                         "a card: needs 4 cards")
    ap.add_argument("--mesh-arms", default=",".join(MESH_ARMS),
                    help="with --mesh: the arms to run, of "
                         f"{','.join(MESH_ARMS)}")
    ap.add_argument("--mesh-local", action="store_true",
                    help="only phase 15's (1, 1) mesh on one card")
    ap.add_argument("--remat", action="store_true",
                    help="only the remat: phase (llama3-8b at 32 layers on "
                         "4096-token rows, jamba's mixed tick) and phase "
                         "15's (1, 1) train arm with its remat case")
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
    if a.memory:
        from repro_torch.configs import get_config, get_reduced
        from repro_torch.core.lora import LoRAConfig
        small = get_reduced("llama3-8b")
        lcfg = LoRAConfig(n_slots=4, r=8)
        flat = numpy_weights(small, seed=0)
        parity_memory(K, small, flat, lcfg, ("cuda", "cpu"))
        parity_train(K, small, flat, lcfg, ("cuda", "cpu"), attn_chunk=16)
        cfg = get_config("llama3-8b")
        weights = full_weights(cfg, dev, torch.bfloat16)
        full_tiers(K, cfg, weights, dev)
        full_paging(K, cfg, weights, dev)
        print(card())
        return 0
    if a.fleet:
        from repro_torch.configs import get_config, get_reduced
        from repro_torch.core.lora import LoRAConfig
        small = get_reduced("llama3-8b")
        parity_fleet(K, small, numpy_weights(small, seed=0),
                     LoRAConfig(n_slots=4, r=8), ("cuda", "cpu"))
        cfg = get_config("llama3-8b")
        full_fleet(K, cfg, full_weights(cfg, dev, torch.bfloat16), dev)
        print(card())
        return 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    if a.archs:
        mla_record(dev, gen)
        ssd_record(dev, gen)
        xattn_record(dev, gen)
        parity_archs(K)
        full_archs(K, dev)
        print(card())
        return 0
    if a.window:
        rows = {}
        for dtype in (torch.bfloat16, torch.float32):
            rows.update(check_window_kernels(K, dtype, dev, gen,
                                             dtype == torch.bfloat16))
        for name, r in rows.items():
            print(f"timing: {name} bf16 {r['shape']}: ms={r['ms']:.5f} "
                  f"plain_ms={r['plain_ms']:.5f} library_ms="
                  f"{r['library_ms']} bound_ms={r['bound_ms']:.5f} "
                  f"({r['bound_by']}) bound_share="
                  f"{r['bound_ms'] / r['ms']:.4f}")
        cfg = window_config()
        window_phase(K, full_weights(cfg, dev, torch.bfloat16), dev)
        print(card())
        return 0
    if a.examples:
        examples_phase(K, dev, {})
        print(card())
        return 0
    if a.mesh:
        rc = mesh_main(K, tuple(a.mesh_arms.split(",")))
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60)
        for i, line in enumerate(smi.stdout.strip().splitlines()):
            print(f"mesh: card {i}: {line}")
        if rc:
            return rc
        print(card())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if a.remat:
        import torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import init_mesh
        cfg = get_config("llama3-8b")
        weights = full_weights(cfg, dev, torch.bfloat16)
        remat = remat_phase(K, cfg, weights, dev)
        del weights
        jamba = remat_jamba(K, dev)
        start_group(0, 1, free_port())
        try:
            mesh = init_mesh((1, 1), ("data", "model"),
                             timeout_s=MESH_TIMEOUT_S)
            _, train_remat = mesh_train_local(K, mesh, dev)
        finally:
            dist.destroy_process_group()
        print(f"remat: launches of llama3-8b's remat steps {remat}; of "
              f"jamba's remat tick {jamba}; of the (1, 1) remat steps "
              f"{train_remat}")
        print(card())
        return 0
    if a.mesh_local:
        from repro_torch.configs import get_config
        cfg = get_config("llama3-8b")
        _, fam, lay, ssm, train, train_remat, train_fam = mesh_phase(
            K, cfg, full_weights(cfg, dev, torch.bfloat16), dev)
        print(f"mesh: (1, 1) family arms' launches summed: {fam}")
        print(f"mesh: (1, 1) layout arms' launches summed: {lay}")
        print(f"mesh: (1, 1) Mamba2 / jamba / MLA-window arms' launches "
              f"summed: {ssm}")
        print(f"mesh: (1, 1) train arm's launches: {train}; with remat: "
              f"{train_remat}; the other families' train arms: {train_fam}")
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
    # each phase's wall time, so that the run's share of its time limit
    # can be read by phase
    clock = [time.perf_counter()]

    def mark(phase):
        now = time.perf_counter()
        print(f"phase: {phase} wall_s={now - clock[0]:.1f}")
        clock[0] = now

    mark("kernels")
    mla_record(dev, gen)
    ssd_record(dev, gen)
    xattn_record(dev, gen)

    parity(K)
    mark("records and parity")

    from repro_torch.configs import get_config
    cfg = get_config("llama3-8b")
    weights = full_weights(cfg, dev, torch.bfloat16)
    by_path = {}
    measured = {}
    by_path["full"], waves, plain = full_width(K, cfg, weights, dev,
                                               measured)
    ref_rows = plain_logits(cfg, weights, waves, plain)
    mark("full")
    by_path["spec"] = full_spec(K, cfg, weights, dev, waves, plain,
                                ref_rows)
    long_counts = long_context(K, cfg, weights, dev, measured)
    by_path["long"], by_path["long_spec"] = long_counts[False], \
        long_counts[True]
    by_path["dense"] = full_dense(K, cfg, weights, dev, waves, plain,
                                  ref_rows)
    del ref_rows
    layouts_in_turns(cfg, weights, waves)
    mark("spec, long, dense, layouts")
    by_path["train"] = full_train(K, cfg, weights, dev, waves, plain,
                                  measured)
    mark("train")
    by_path["remat"] = remat_phase(K, cfg, weights, dev)
    mark("remat")
    by_path["tiers"] = full_tiers(K, cfg, weights, dev)
    by_path["paging"] = full_paging(K, cfg, weights, dev)
    by_path["fleet"] = full_fleet(K, cfg, weights, dev)
    mark("tiers, paging, fleet")
    by_path["window"] = window_phase(K, weights, dev)
    mark("window")
    (by_path["mesh"], by_path["mesh_families"], by_path["mesh_layouts"],
     by_path["mesh_ssm"], by_path["mesh_train"],
     by_path["mesh_train_remat"],
     by_path["mesh_train_families"]) = mesh_phase(K, cfg, weights, dev)
    del weights
    mark("mesh")
    by_path["remat_jamba"] = remat_jamba(K, dev)
    mark("remat_jamba")
    by_path.update(full_archs(K, dev))
    mark("archs")
    by_path["examples"] = examples_phase(K, dev, measured)
    mark("examples")

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
            # the split shrink and expand entries of the sharded step
            **({"split_launches_by_path": {
                p: {k: by_path[p][k] for k in SPLIT_COUNTERS
                    if k.startswith(name + "_")}
                for p in ("mesh", "mesh_families", "mesh_layouts",
                          "mesh_ssm", "mesh_train", "mesh_train_remat",
                          "mesh_train_families")}}
               if name in ("smlm", "bgmv") else {}),
            # the merge kernel alone: MLA's decode under a mesh, and a GQA
            # decode over rows cut by the slots (mesh_layouts)
            **({"merge_launches_by_path": {
                p: c["merge"] for p, c in by_path.items() if c["merge"]}}
               if name == "paged_splitk" else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            # the kernel's other timed shapes (phase 2), by row name
            "shapes": {k: {f: v[f] for f in ("shape", "max_abs_err", "ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}
                       for k, v in rows.items()
                       if k.startswith(f"{name} ")}})
        if name == "smlm_wgrad":
            kernels[-1]["note"] = ("SMLM's weight gradient (dA, dB); the "
                                   "JAX package has no Pallas backward")
    print(json.dumps({"kernels": kernels}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
