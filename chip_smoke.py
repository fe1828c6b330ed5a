#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

1. Prints the card's name and power limit, builds the twelve CUDA kernel
   sources from src/repro_torch/csrc (one nvcc each, in parallel) and
   prints the build time.
2. Kernel phases: hold each of the thirty kernel forms against its plain
   PyTorch version on the card at the shapes the serving paths give it,
   and time both (plus a PyTorch library call of the same work as a
   yardstick: bf16 matmul / bmm at decode, torch._int_mm at M = 192, bf16
   bmm at C = 8): the act-quant ternary matmul (falcon3-1b's projections,
   and its expert form at DeepSeek-V3's E = 256, C = 1 / 8), the fused-RoPE GQA
   decode (o and k_rot bit-identical in f32 and bf16, masked rows
   NaN-filled; timed with SDPA and its bound at lengths 80 and 127), the
   fresh flash prefill (GQA at falcon3-1b's heads: o, k_cast
   and v_cast bit-identical, timed with SDPA and its bound at s = 32 and
   128; its chunked form over a hot 32 / cold 96 cache: o, k_cast and
   v_cast bit-identical on 48 cases (rep 1/2/4/8 x d 128/256 x C 16/32/48
   x f32/bf16, offsets 0-96, valid 0 / 1 / C-5 / C, NaN past each length)
   and 16 at falcon3-1b's wave shape (h 8, g 4, d 256, C 32, 6 or 4 slots
   at offsets 0 / 32 / 64 / 96) and at the timed case; three f32 chunks over a hot-32 cache equal to one fresh launch over
   s = 96, timed with SDPA over the materialised keys and its bound at
   C = 32, offset 96; and its MLA form at q/k (6, s, 128, 192), v (6, s,
   128, 128): bit-identical at s = 1 to 128, timed likewise),
   the MLA latent decode (b = 6,
   h = 128, rows of 576, values of 512; f32 and bf16 tiers bit-identical,
   masked rows NaN-filled; timed with SDPA and its bound at lengths 80 and
   128), the known-scale ternary matmul (also equal to the
   act-quant kernel on the same x, and the int32 kernel equal to its plain
   version on the same codes, at falcon3-1b's and deepseek-v3-671b-l5's
   projections in pack2 and pack243 and qwen3-32b's down projection,
   K = 25600, in pack2) and its expert form, the int32
   ternary matmul (also equal to ref.ternary_matmul_ref, quickstart's
   shape included) and the post-append GQA decode (f32 and bf16, length 0,
   kernel_bench's case, and after the append equal to the fused decode bit
   for bit; timed at lengths 80 and 128); the LoRA kernel (the adapter delta in a sum order
   fixed per row: bit-identical to its plain version at falcon3-1b's three
   adapter shapes, M = 1 / 6 / 192 / 576, f32 and bf16, and row i of an
   M = 576 launch equal to the row launched alone; one decode step's 54
   launches timed with the torch.matmul pair); the rms_norm kernel (the
   same per-row fixed order; bit-identical to its plain version at
   falcon3-1b's and DeepSeek-V3's widths, M = 1 / 6 / 192 / 576, x and w in
   f32 and bf16; one decode step's 37 norms timed with F.rms_norm), after a
   report of which float ops change a row with M on the card (the f32
   lm_head GEMM, the LoRA product, PyTorch's rms_norm reduction) and a check
   that the two kernels' rows do not; and the paged forms of the
   fused and post-append decode and of the chunked prefill (each
   bit-identical to its plain version and to its contiguous kernel on the
   same content, f32 and bf16, identity and shuffled page tables, page
   size 32 and 48; timed beside the contiguous form in the same call); and
   the sliding-window forms of mixtral-8x22b (A1d, A3c): the ring form of
   the fused decode, the fresh window prefill and the chunked prefill over
   the ring, each bit-identical to its plain version at mixtral-8x22b's
   heads (rep 6, d 128) and falcon3-1b's, rings of 64 and 4096 rows,
   lengths and chunk offsets before, at and past the wrap, inactive slots,
   valid 0 / partial / full, f32 and bf16, and chunks over a ring equal to
   the fresh window kernel; timed with SDPA under an explicit window mask
   and their bounds at b 4 over a wrapped 4096-row ring, one 4200-token
   prompt and a 4-slot chunk wave of 256; and the eleven fp8-tier forms
   (A1c: kernel 2 over contiguous, paged and ring fp8 tiers; kernel 6
   contiguous and paged; A4a: kernel 8; A3d: kernel 3's fresh, window,
   chunked, paged and ring forms with an fp8 emit), each bit-identical to
   its plain version (fp8 outputs by their bytes) with f32 and bf16
   activations at its f32 form's cases, each emitting form's v_cast
   byte-equal to kv_cache.to_tier on v rows carrying the cast's boundary
   values (448, 449, 464, 464.01, 480, +-inf, NaN, 2^-10, -0.0), each
   timed at its f32 form's case beside SDPA over the upcast keys and its
   bound with 1-byte tiers. Then decode = prefill: the GQA decode folds
   absolute 32-key tiles as the chunked prefill does, so at falcon3-1b's
   heads (lengths 1-127 across tile edges, f32 and bf16 activations, tiers
   in that dtype or fp8, hot 32 and hot 4, contiguous and paged) the fused
   decode kernel equals its plain version and the one-row chunk kernel,
   and with f32 tiers the fresh prefill's row p and the post-append kernel
   after the append, bit for bit. Then the speculative forms: the verify
   chunk (kernel 3's chunked form with its emit, no append) at C = K 1 /
   2 / 4 / 8, contiguous and paged, f32 / bf16 / fp8 tiers, offsets on
   both sides of hot_cap and of a page boundary: bit-identical to its
   plain version, the cache unchanged; each verify row equal to the fused
   decode's row for the same token (f32 tiers, hot 32 / 4); kernel 2 at
   the falcon3-draft's shape (d 128, rep 2), kernels 2 and 3 at the
   derived draft's (d 16, rep 1). The ring decode (A1d and its fp8 form)
   folds absolute tiles too: its row equals the one-row ring chunk
   kernel's (A3c / A3d at C = 1) in every ring case, window starts
   aligned and unaligned to 32.
3. falcon3-1b: full width and depth from a seeded generator (LoRA B
   factors filled with small seeded values), packed, serving 6 prompts x
   32 tokens with max_new_tokens=96 through Engine.generate (hot_cap=32,
   max_len=128, 6 slots). Checks that every kernel of its path launched,
   no weight was reloaded, each sequence's DR-traffic ledger equals the
   closed form for S=128 / 32 hot tokens, the prefill logits and
   first-step logits equal those of the same run on the plain versions,
   and the greedy tokens too at the depth cut to 4 layers, and one GQA
   decode launch per layer per decode step; prints
   the GQA prefill's launches per admission and the fused decode
   wrapper's own glue (casts, RoPE table, copies) per decode step. Then
   the entry-point path: ternary_matmul on every layer's projections and flash_decode_attention(q, cache) on every layer's
   post-append cache, each against its oracle. Then the same requests
   under fuse_act_quant=False (the carried-scale path): tokens equal on
   6/6 rows, ledger, no act-quant kernel launch, one known-scale launch
   per projection. Then chunked admission (prefill_chunk=32): generate
   6 x (96 + 32), tokens equal to grouped admission of the same prompts on
   6/6 rows (and to the plain chunked run at the depth cut to 4 layers), 18
   chunk launches per wave and no fresh launch; serve six requests of
   prompt lengths 5 / 31 / 32 / 33 / 77 / 100 through 4 slots, each
   request's tokens equal to grouped admission's (and at 4 layers to the
   plain chunked run's) and its ledger at its closed form; a traced
   breakdown of the chunked generate. Then paged serving with prefix sharing (hot 32,
   max_len 192, prefill_chunk 32, page size 32, 4 slots): eight requests,
   five sharing a 96-token prefix (one of them copy-on-write inside a
   page, one growing its pages mid-decode), served shared, unshared,
   contiguous, grouped and by the plain versions: tokens equal on 8/8
   requests (plain at the depth cut to 4 layers, against the shared run
   at that depth), prefix reuse as the prefix tree's rule gives, the
   ledger deltas equal to the skipped prompt work, 18 paged chunk launches
   per wave and 18 paged decode launches per step and no contiguous one; a
   traced shared serve. Then sessions (the same geometry and requests, 18
   layers): replica A drains its four decoding slots with KV handoffs,
   which cross a LocalTransport and seed replica B's prefix tree (a
   second engine over the same weights); the resumed serve's tokens equal
   the uninterrupted serve's on 8/8 and spare chunk waves against a cold
   resume; the same payloads corrupted in flight raise HandoffError and
   resume cold, 8/8; a Router over two replicas under FleetChaosInjector
   (a kill, a corrupted handoff every tick) and a stale heartbeat on an
   injected clock, two seeds, 8/8 with the fleet invariants after every
   tick; over fp8 tiers a payload equal to its device rows byte for byte,
   its bodies a quarter of f32's, the migrated fp8 serve against the
   unmigrated one printed. Then the overload control plane (paged, 4 slots,
   eight requests of 40-104 prompt tokens + 64): the default pool, then a
   6-page pool with the invariant checker after every iteration (19
   preemptions with recompute-from-prefix): tokens equal on 8/8 requests,
   the counters the reference engine gives the same geometry; at 1 layer
   the pressured serve against its plain run, a priority request
   preempting a weaker one, deadlines expiring a queued and an active
   request, cancels mid-decode and mid-prefill, a bounded queue shedding,
   and the pressured serve over fp8 tiers against its plain run. Then
   speculative decoding with the falcon3-draft model (seed 2), K = 4: a
   verify chunk's logits equal four decode steps' at full depth; the
   chunked serve's six requests over 6 slots with the seeded draft, with
   draft = target (full accept: accepted = drafted = 24 - rounds) and
   with spec_force="reject", each equal to the non-speculative serve on
   6/6, 18 chunk launches per round and 4 x K draft decodes; the paged
   requests with the invariant checker (check 7) every iteration, 8/8;
   at 1 layer the overload requests on 6 pages, 8/8 against the
   unpressured speculative and the non-speculative serves, and over fp8
   tiers the speculative serve equal to its plain run; acceptance rates, tokens/s against the
   non-speculative serve and a verify's device ms against K decode
   steps' printed. The entry-point path also drives the paged
   post-append decode on the 18 layers' caches. Then the same model over
   fp8 tiers (kv_fp8): grouped generate 6 x (32 + 96) with tokens, prefill
   and first-step logits and the cache bytes equal to the plain fp8 run,
   18 fp8 decodes per step and no f32-tier form; the fp8 post-append forms
   on its 18 layer caches, contiguous and paged; chunked (prefill_chunk
   32) and paged with prefix sharing (the eight requests), each equal to
   its plain fp8 run with 18 fp8 launches per wave and step; fp8 against
   f32 tiers, chunked against grouped and shared against unshared under
   fp8 printed (fp8 rounds cached keys, not a chunk's own); the grouped
   run's plain comparison and the fp8 chunked and paged serves at the
   depth cut to 4 layers.
4. deepseek-v3-671b-l5: DeepSeek-V3 at full width, 3 dense + 2 MoE layers
   (the routed experts drawn and packed one at a time from seed 0), serving
   6 prompts x (32 + 32) tokens (hot_cap=32, max_len=128, 6 slots: rows
   33-64 come from the cold tier), on an engine built with
   prefill_chunk=32 that keeps grouped admission (MLA cannot chunk, as in
   the reference). Same checks against its plain run: the
   four kernels of its path launched, greedy tokens equal on 6/6 rows,
   every row's ledger equal to the closed form for S=64 / 32 hot tokens,
   no weight reloaded, one MLA prefill launch per layer per admission and
   one latent decode launch per layer per decode step;
   then its carried-scale run with the same checks;
   then the same model over fp8 latent tiers (kv_fp8): tokens equal to
   the plain fp8 run, 5 fp8 latent decodes per step, ledgers;
   then the same model packed in pack243 (wo K = 16384, dense down
   K = 18432), served with the same checks and the pack2 run's tokens on
   6/6 rows; prints peak device memory, each phase's time and, for each
   model, the ternary, prefill and latent kernels' device time per traced
   generate.
5. The dense families at full width, from seed 0, packed layer by layer,
   each serving 6 prompts x (32 + 32) tokens (hot_cap=32, max_len=128, 6
   slots) after a warm-up: qwen3-32b cut to 16 of its 64 layers (qk-norm,
   64 / 8 heads of 128: rep 8, h * hd = 8192 against d_model 5120, d_ff
   25600), gemma-7b at full depth (28 layers, GeGLU, MHA 16 x 256, tied
   embeddings scaled by sqrt(3072), vocab 256000) and deepseek-coder-33b
   cut to 8 layers (56 / 8 heads: rep 7, d_model 7168, d_ff 19200). Each:
   launches per decode step and admission exactly (ternary 4 per layer,
   GQA decode 1 per layer per step, fresh prefill 1 per layer per
   admission, rms_norm 2 per layer, 4 with the qk-norm, + 1, no LoRA),
   ledgers at the closed form, no weight reloaded, and at 2 layers the
   kernel run's tokens equal to the plain run's. qwen3-32b: chunked
   admission (prefill_chunk 32) at 4 layers equal to grouped, and a traced
   6 x (32 + 8) generate; deepseek-coder-33b: a paged serve (page size 32)
   equal to the contiguous one, 8 paged decodes per step at rep 7.
6. The SSM and hybrid families at full width and depth, from seed 0,
   packed layer by layer, f32, hot_cap 32, max_len 128, 6 slots, grouped
   admission: mamba2-130m (24 Mamba2 blocks, attention-free) and zamba2-7b
   (81 Mamba2 blocks in 13 groups of 6 and a tail of 3, one shared
   attention + MLP block after each group: MHA 32 x 112 through kernel 2's
   d 112 form, with a per-group v adapter). Each: generate 6 x (96 + 32)
   after a warm-up (a 96-token prompt scans in 3 SSD chunks of 32 and
   fills the shared block's cold tier), memory and tokens/s, launches per
   decode step and admission exactly, the ledger (0 bytes a token without
   attention; the closed form for zamba2) and no weight reloaded; greedy
   tokens equal to the plain run (mamba2-130m at full depth, zamba2-7b at
   13 layers: 2 groups and a tail of 1). mamba2-130m: a mixed-length serve
   of prompts 96 / 64 / 33 / 17 / 5 / 3 equal to its plain run, and each
   request served alone against the batched serve, printed. zamba2-7b: a
   traced 6 x (96 + 8) generate.
7. The frontend families at full width and depth, from seed 0, packed
   layer by layer: llava-next-34b (60 layers, GQA rep 7 behind a
   two-layer projector of 1024-wide image-patch features) serving 6
   requests of 576 seeded patch rows + 32 text tokens + 32 new (hot_cap
   32, max_len 640: S = 640) after a warm-up: memory and tokens/s,
   launches per decode step and admission exactly (ternary 240, kernel 2
   60 / 0, kernel 3 0 / 60 at s 608, rms_norm 121, no LoRA), the ledger
   at the closed form, no weight reloaded; at 2 layers the kernel run's
   tokens equal to the plain run's and each request served alone against
   the batched serve, printed; a traced 6 x (576 + 32 + 8) generate.
   hubert-xlarge (48 layers, encoder-only, bidirectional MHA 16 x 80, the
   non-gated GELU MLP): the packed forward over 6 x 512 seeded frames of
   512, its launches (ternary 192, rms_norm 97, no attention kernel), its
   logits' argmax equal to the plain run's on every frame at full depth
   (the largest difference printed), and Engine.generate refused with a
   ValueError naming the audio family. The kernel phases hold kernel 1 at
   llava's admission (M 3648: wqkv, wo, gate‖up, down at K 20480) and
   kernel 3's fresh form at s 608, h 56, g 8 bit for bit, timed beside
   torch._int_mm and causal SDPA.
8. mixtral-8x22b at full width and depth (56 layers, 8 experts top-2,
   sliding window 4096 over a ring cold tier, the published capacity
   1.25), drawn from seed 0 and packed layer by layer, served over 4 slots
   (max_len 4352): prompts of 1000 and 3000 tokens inside the window,
   4050 + 64 crossing it during decode, 4200 + 32 past it at admission,
   by grouped admission (window prefill, ring realign): 56 ring decode
   launches per step, one window prefill per layer per admission, ledgers
   at the reference's rule, no weight reloaded; a traced decode; dropless
   (capacity E / k) at the depth cut to 8 layers, grouped and by chunk
   waves of 256 (the ring continuation, one ring-chunk prefill per layer
   per wave): tokens equal on every request; at that cut, speculative
   decoding over the ring (K 4, the derived draft make_draft_config from
   seed 7; forced reject, an oracle draft proposing the grouped serve's
   tokens, and the oracle with a seeded third of its proposals corrupted):
   tokens equal to the grouped serve on 4/4 in each mix, one ring-chunk
   verify per layer per round and no ring decode, ledgers per round, a
   verify's device ms against four ring decode steps', and at 2 layers
   over fp8 tiers the speculative serve of 4200 + 16 equal to its plain
   run; the grouped serve again over fp8 tiers (56 fp8 ring decodes and
   window prefills per step and admission, ledgers; its tokens/s and peak
   memory beside the f32-tier serve's); at the depth cut to 2 layers each
   request served alone equals the batched serve and the kernel run
   equals its plain run, and over fp8 tiers grouped and chunked admission
   each equal their plain runs.
9. Prints {"kernels": [...]} (each form's launches on its own path and on
   every path that counted it) and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero. Run from the
repository root with no arguments: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
import types
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s,
# f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model logits, kernel vs plain run
TERNARY = "ternary_"  # in the names of the ternary matmul's kernels (profiler keys)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# wall seconds spent in torch.profiler traces: the warm-up step, the traced
# run and the trace's processing (stopping the trace and its averages)
TRACE_SECONDS = {"warm": 0.0, "run": 0.0, "processing": 0.0}


def device_totals(results):
    """Per-name count and device microseconds of the device events (kernels,
    copies, sets) in a profiler's raw results: what ``key_averages()``
    reports for them (a device event's self time is its duration), without
    building its per-event Python objects and trees, which took 174 s of an
    863 s run of this script (NVIDIA H100 80GB HBM3, 700.00 W)."""
    import torch

    totals = {}
    for e in results.events():
        if (e.device_type() != torch.autograd.DeviceType.CUDA or e.is_async()
                or e.start_thread_id() != e.end_thread_id()):
            continue
        t = totals.setdefault(e.name(), [0, 0.0])
        t[0] += 1
        t[1] += (e.end_ns() - e.start_ns()) / 1e3
    return [types.SimpleNamespace(key=name, count=n, self_device_time_total=us)
            for name, (n, us) in totals.items()]


def trace_events(fn, warm=None):
    """torch.profiler totals of the device events that ``fn()`` launches
    (``device_totals``), traced in the active step of a schedule whose
    warm-up step runs ``warm()``: collection is then running when ``fn``
    starts (a trace started right before ``fn`` lost its first kernel
    records on the H100's machine, every time, late in a long run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    out = {}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: out.setdefault(
                     "events", device_totals(p.profiler.kineto_results))) as prof:
        if warm is not None:
            warm()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prof.step()
        fn()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        prof.step()
    t3 = time.perf_counter()
    for key, dt in (("warm", t1 - t0), ("run", t2 - t1), ("processing", t3 - t2)):
        TRACE_SECONDS[key] += dt
    return list(out.get("events", []))


def trace_line(before):
    """The profiler's wall seconds since the snapshot ``before`` of
    TRACE_SECONDS, as printed beside a phase's time."""
    return ", ".join(f"{k} {TRACE_SECONDS[k] - before[k]:.2f} s" for k in TRACE_SECONDS)


def profiled_kernels(fn, iters=20, only=None, attempts=3):
    """The kernels ``fn`` launches (only those whose name contains
    ``only``, when given), as torch.profiler's averages over ``iters``
    calls. A trace counts only when every kernel in it ran a whole
    multiple of ``iters`` times (traces were seen to lose records: none,
    or 17 of 20 launches); after ``attempts`` incomplete traces, None."""

    def calls():
        for _ in range(iters):
            fn()

    for _ in range(attempts):
        events = [e for e in trace_events(calls, warm=fn)
                  if _device_us(e) > 0 and (only is None or only in e.key)]
        if events and all(e.count % iters == 0 for e in events):
            return events
    return None


def device_ms(fn, iters=20, only=None):
    """Device time per call from a complete torch.profiler trace (see
    ``profiled_kernels``); None without one, and the callers then keep the
    CUDA-event time."""
    events = profiled_kernels(fn, iters, only)
    return None if events is None else sum(_device_us(e) for e in events) / iters / 1e3


def _device_us(event):
    return event.self_device_time_total


def timed(label, fn, only=None, iters=20):
    """(device ms, CUDA-event ms) of ``fn``; prints both. The event time
    spans the host's launch work too; the device time is kernels only."""
    evt = time_ms(fn, iters=iters)
    dev = device_ms(fn, iters=iters, only=only)
    shown = "not measured" if dev is None else f"{dev:.5f} ms"
    print(f"  {label}: device {shown}, CUDA events {evt:.5f} ms per call")
    return (dev if dev is not None else evt), evt


def bound_ms(n_bytes, ops, peak_ops):
    by_bytes, by_ops = n_bytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def max_err(a, b):
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
# kernel 1: act-quant-prologue ternary matmul
# ---------------------------------------------------------------------------

DECODE_SHAPES = ((2048, 4096), (2048, 2048), (2048, 16384), (8192, 2048))  # wqkv wo wgu down
# deepseek-v3-671b-l5's 2-D packed projections (K, N): w_dq‖w_dkv, w_uq, wo,
# the dense layers' gate‖up and down, the shared expert's gate‖up and down
DEEPSEEK_SHAPES = ((7168, 2112), (1536, 24576), (16384, 7168), (7168, 36864), (18432, 7168),
                   (7168, 4096), (2048, 7168))
# qwen3-32b's down projection (K, N): K/4 = 6400 groups in pack2, past the
# 5888 that the first kernel's shared-memory tile held
QWEN_DOWN = (25600, 5120)
# mixtral-8x22b's packed projections (K, N): wqkv, wo; the experts' w_gate‖w_up
# and w_down (E 8). Its decode step has 4 slots (M 4; expert capacity 2 at
# the published capacity factor 1.25, 5 when every expert takes every
# token); its longest admission is a 4200-token prompt (M 4200; capacity
# 1313 at 1.25, 4200 when dropless)
MIXTRAL_2D = ((6144, 8192), (6144, 6144))
MIXTRAL_EXPERT = ((6144, 32768), (16384, 6144))


def projection_operands(torch, gen, m, k, n, codec="pack2", dtype=None, copies=1):
    """Raw x (m, k), ``copies`` packed copies of one random trit matrix
    (k, n) and a per-column scale (n,)."""
    from repro_torch.core import packing

    trits = torch.randint(-1, 2, (k, n), generator=gen, device="cuda", dtype=torch.int8)
    packed = [packing.pack(trits, codec)]
    for _ in range(copies - 1):
        packed.append(packed[0].clone())
    x = (torch.randn((m, k), generator=gen, device="cuda") * 3).to(dtype or torch.float32)
    col = torch.rand((n,), generator=gen, device="cuda") + 0.01
    return x, packed, col


def layer_runner(layer, fn, copies=8, shapes=DECODE_SHAPES):
    """A callable that runs ``fn(x, packed, col, k)`` over one decode
    layer's projections (``shapes``), cycling over ``copies`` packed copies
    that together exceed the 50 MB L2, as the layers of a real step do."""
    it = {"i": 0}

    def go():
        i = it["i"] = (it["i"] + 1) % copies
        for (k, n), (x, ps, col) in zip(shapes, layer):
            fn(x, ps[i], col, k)
    return go


def int_mm_ms(torch, xq, p, k, codec="pack2"):
    """torch._int_mm of int8 codes (M, K) by the unpacked trits (int32 out,
    no rescale): the library yardstick of the M = 192 shapes. None when
    the call is refused (a yardstick only: reported, never a failure)."""
    from repro_torch.core import packing

    trits = packing.unpack(p, codec, k).contiguous()
    try:
        return time_ms(lambda: torch._int_mm(xq, trits))
    except RuntimeError as err:
        print(f"  torch._int_mm not measured ({str(err).splitlines()[0][:80]})")
        return None


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.5f} ms"


def dense_layer_matmul(torch, layer):
    """bf16 ``torch.matmul`` over one decode layer's projections, on the
    unpacked trits of its packed weights: the library yardstick."""
    from repro_torch.core import packing

    dense = [(x.to(torch.bfloat16), packing.unpack(ps[0], "pack2", k).to(torch.bfloat16))
             for (k, _), (x, ps, _) in zip(DECODE_SHAPES, layer)]
    return lambda: [torch.matmul(xb, w) for xb, w in dense]


def kernel1_phase(torch, gen):
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import ternary_matmul as tm

    worst = 0.0
    for codec in ("pack2", "pack243"):
        for dtype in (torch.float32, torch.bfloat16):
            for m in (6, 192):
                for k, n in DECODE_SHAPES:
                    for bits in ((8, 4) if (m, k, n) == (6, 2048, 4096) else (8,)):
                        x, (p,), col = projection_operands(torch, gen, m, k, n, codec, dtype)
                        got = tm.ternary_matmul_actq(x, p, col, k=k, codec=codec, act_bits=bits)
                        ref = tm.ternary_matmul_actq_plain(x, p, col, k, codec, bits)
                        torch.cuda.synchronize()
                        worst = max(worst, max_err(got, ref))
                        check(torch.equal(got, ref),
                              f"ternary_matmul_actq not bit-identical: {codec} {dtype} "
                              f"M={m} K={k} N={n} A{bits}")
    print(f"ternary_matmul_actq: bit-identical to plain on {2 * 2 * 2 * 4 + 4} cases "
          "(pack2/pack243, f32/bf16, M=6/192, A8 + A4)")

    # timing: one decode layer's four projections (M = 6, f32, pack2); the
    # packed weights cycle over copies that exceed the 50 MB L2, as the 18
    # layers of a real step do
    layer = [projection_operands(torch, gen, 6, k, n, copies=8) for k, n in DECODE_SHAPES]
    ms, _ = timed("kernel", layer_runner(layer, lambda x, p, col, k: tm.ternary_matmul_actq(
        x, p, col, k=k)), only=TERNARY)
    plain_ms, _ = timed("plain", layer_runner(layer, lambda x, p, col, k: (
        tm.ternary_matmul_actq_plain(x, p, col, k))), iters=5)
    library_ms, _ = timed("bf16 torch.matmul", dense_layer_matmul(torch, layer))
    n_bytes = sum(6 * k * 4 + (k // 4) * n + n * 4 + 6 * n * 4 for k, n in DECODE_SHAPES)
    ops = sum(2 * 6 * k * n for k, n in DECODE_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"ternary_matmul_actq decode layer (4 launches, M=6, pack2, f32 x): kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, bf16 matmul {library_ms:.5f} ms, bound {b_ms:.5f} ms "
          f"({n_bytes} B / 3.35 TB/s)")
    # prefill shapes for PERF.md: M = 192 (6 prompts x 32 tokens)
    for k, n in DECODE_SHAPES:
        x, (p,), col = projection_operands(torch, gen, 192, k, n)
        t = device_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k), only=TERNARY)
        t = time_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k)) if t is None else t
        nb = 192 * k * 4 + k // 4 * n + n * 4 + 192 * n * 4
        print(f"ternary_matmul_actq prefill M=192 K={k} N={n}: kernel {t:.5f} ms, torch._int_mm "
              f"{fmt(int_mm_ms(torch, act_quant(x).xq, p, k))}, bound "
              f"{bound_ms(nb, 2 * 192 * k * n, INT8_OPS)[0]:.5f} ms")
    worst = max(worst, mixtral_2d(torch, gen))
    llava, worst_llava = kernel1_llava(torch, gen)
    return dict(name="ternary_matmul_actq", route="cuda",
                source="src/repro_torch/csrc/ternary_matmul.cu",
                replaces="src/repro/kernels/ternary_matmul.py:381",
                max_abs_err=max(worst, worst_llava), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, llava_admission=llava)


# llava-next-34b's packed projections (K, N): wqkv, wo, gate‖up, down; its
# admission runs them at M = 6 x (576 + 32) = 3648
LLAVA_SHAPES = ((7168, 9216), (7168, 7168), (7168, 40960), (20480, 7168))
LLAVA_M = 3648


def kernel1_llava(torch, gen):
    """Kernel 1 at llava-next-34b's admission (M 3648, f32, pack2): each
    projection bit-identical to plain (down at K 20480, where the plain
    float32 product is still exact), timed beside ``torch._int_mm`` and its
    bound (operations)."""
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import ternary_matmul as tm

    worst, rows = 0.0, {}
    for k, n in LLAVA_SHAPES:
        x, (p,), col = projection_operands(torch, gen, LLAVA_M, k, n)
        got = tm.ternary_matmul_actq(x, p, col, k=k)
        ref = tm.ternary_matmul_actq_plain(x, p, col, k)
        torch.cuda.synchronize()
        worst = max(worst, max_err(got, ref))
        check(torch.equal(got, ref), f"ternary_matmul_actq not bit-identical at llava's "
                                     f"admission: M={LLAVA_M} K={k} N={n}")
        del got, ref
        t = device_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k), only=TERNARY, iters=5)
        t = time_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k), iters=5) if t is None else t
        lib = int_mm_ms(torch, act_quant(x).xq, p, k)
        nb = LLAVA_M * k * 4 + k // 4 * n + n * 4 + LLAVA_M * n * 4
        b_ms, b_by = bound_ms(nb, 2 * LLAVA_M * k * n, INT8_OPS)
        print(f"ternary_matmul_actq at llava's admission M={LLAVA_M} K={k} N={n}: bit-identical "
              f"to plain; kernel {t:.5f} ms, torch._int_mm {fmt(lib)}, bound {b_ms:.5f} ms "
              f"({b_by})")
        rows[f"{k}x{n}"] = dict(ms=t, library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        del x, p
    return rows, worst


def mixtral_2d(torch, gen):
    """Kernel 1 at mixtral-8x22b's wqkv and wo: bit-identical to plain at a
    decode step's M 4 and the 4200-token admission's M, f32 pack2; timed
    per layer at decode (the two launches over copies past the L2) and per
    shape at admission, beside the byte / operation bound. Returns the
    largest |kernel - plain|."""
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import ternary_matmul as tm

    worst = 0.0
    for m in (4, 4200):
        for k, n in MIXTRAL_2D:
            x, (p,), col = projection_operands(torch, gen, m, k, n)
            got = tm.ternary_matmul_actq(x, p, col, k=k)
            ref = tm.ternary_matmul_actq_plain(x, p, col, k)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            check(torch.equal(got, ref), f"ternary_matmul_actq not bit-identical at "
                                         f"mixtral-8x22b's M={m} K={k} N={n}")
            if m == 4200:
                t = device_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k), only=TERNARY)
                t = time_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k)) if t is None else t
                nb = m * k * 4 + k // 4 * n + n * 4 + m * n * 4
                print(f"ternary_matmul_actq mixtral-8x22b admission M={m} K={k} N={n}: kernel "
                      f"{t:.5f} ms, torch._int_mm {fmt(int_mm_ms(torch, act_quant(x).xq, p, k))}"
                      f", bound {bound_ms(nb, 2 * m * k * n, INT8_OPS)[0]:.5f} ms")
    print("ternary_matmul_actq: bit-identical to plain at mixtral-8x22b's wqkv / wo, M 4 and "
          "4200 (f32, pack2)")
    layer = [projection_operands(torch, gen, 4, k, n, copies=4) for k, n in MIXTRAL_2D]
    ms, _ = timed("kernel", layer_runner(layer, lambda x, p, col, k: tm.ternary_matmul_actq(
        x, p, col, k=k), copies=4, shapes=MIXTRAL_2D), only=TERNARY)
    nb = sum(4 * k * 4 + k // 4 * n + n * 4 + 4 * n * 4 for k, n in MIXTRAL_2D)
    b_ms, b_by = bound_ms(nb, sum(2 * 4 * k * n for k, n in MIXTRAL_2D), INT8_OPS)
    print(f"ternary_matmul_actq mixtral-8x22b decode layer (2 launches, M=4, pack2, f32 x): "
          f"kernel {ms:.5f} ms, bound {b_ms:.5f} ms by {b_by} ({nb} B / 3.35 TB/s)")
    return worst


# ---------------------------------------------------------------------------
# kernel 2: fused-RoPE flash decode
# ---------------------------------------------------------------------------


def decode_case(torch, gen, lengths, dtype, b=6, h=8, g=4, d=256, hot=32, cold=96,
                tier_dtype=None):
    """q, the tiered cache (tiers in ``tier_dtype``, default ``dtype``; NaN
    past each slot's length), k_new and v_new of a GQA decode case."""
    from repro_torch.core import kv_cache as kvc

    def tier(cap):
        t = torch.randn((b, cap, g, d), generator=gen, device="cuda")
        return t

    cache = kvc.TieredKVCache(tier(hot), tier(hot), tier(cold), tier(cold),
                              torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    # rows at or past each slot's length hold NaN: neither version may read them
    hot_valid, cold_valid = kvc.valid_masks(cache)
    nan = float("nan")
    cache = kvc.TieredKVCache(
        *(kvc.to_tier(torch.where(ok[:, :, None, None], t, nan).to(dtype), tier_dtype or dtype)
          for t, ok in zip(cache[:4], (hot_valid, hot_valid, cold_valid, cold_valid))),
        cache.lengths)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    k_new = torch.randn((b, g, d), generator=gen, device="cuda").to(dtype)
    v_new = torch.randn((b, g, d), generator=gen, device="cuda").to(dtype)
    return q, cache, k_new, v_new


GQA_DECODE = "gqa_decode_kernel"  # the GQA decode kernel's name (profiler key)


def decode_timing(torch, gen, theta, length, fused, smi):
    """Kernel, plain, SDPA and bound of one GQA decode form at falcon3-1b's
    shape (b 6, h 8, g 4, d 256, f32), every slot at ``length`` (the
    cache's valid rows; the fused form adds the pending token)."""
    from repro_torch.kernels import flash_decode as fd

    b, h, g, d = 6, 8, 4, 256
    q, cache, k_new, v_new = decode_case(torch, gen, [length] * b, torch.float32)
    kw = dict(k_new=k_new, v_new=v_new, active=torch.ones(b, dtype=torch.bool, device="cuda"),
              rope_theta=theta) if fused else {}
    name = "flash_decode_gqa_fused" if fused else "flash_decode_gqa"
    print(f"{name} at length {length}:")
    ms, _ = timed("kernel", lambda: fd.flash_decode_attention(q, cache, **kw), only=GQA_DECODE)
    plain_ms, _ = timed("plain", lambda: fd.flash_decode_attention(q, cache, impl="plain", **kw))
    # SDPA over the valid rows (and the pending token), k / v expanded to the h heads
    pend_k, pend_v = ([k_new[:, None]], [v_new[:, None]]) if fused else ([], [])
    kk = torch.cat([cache.hot_k, cache.cold_k[:, : length - 32]] + pend_k, 1)
    vv = torch.cat([cache.hot_v, cache.cold_v[:, : length - 32]] + pend_v, 1)
    kh = kk.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    vh = vv.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    library_ms, _ = timed("SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], kh, vh))
    # q, the valid rows, lengths and the output; fused also k_new, v_new,
    # active, the cos / sin tables and k_rot
    n_bytes = b * h * d * 4 + b * length * g * d * 4 * 2 + 4 * b + b * h * d * 4
    if fused:
        n_bytes += 2 * b * g * d * 4 + 4 * b + b * d * 4 + b * g * d * 4
    ops = 4 * b * h * (length + int(fused)) * d
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"{name} (b=6, length {length}, f32): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} ({n_bytes} B, {ops} FLOP) "
          f"on {smi}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def kernel2_phase(torch, gen, theta, smi):
    from repro_torch.kernels import flash_decode as fd

    worst = 0.0
    lengths = [0, 1, 31, 32, 33, 127]
    active = torch.tensor([False, True, True, True, True, True], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype)
        o, k_rot = fd.flash_decode_attention(q, cache, k_new=k_new, v_new=v_new, active=active,
                                             rope_theta=theta)
        o_p, k_rot_p = fd.flash_decode_attention(q, cache, k_new=k_new, v_new=v_new,
                                                 active=active, rope_theta=theta, impl="plain")
        torch.cuda.synchronize()
        check(torch.isfinite(o).all(), "flash_decode output not finite (read a masked row?)")
        check(torch.equal(k_rot, k_rot_p), f"flash_decode k_rot not bit-identical ({dtype})")
        check(torch.equal(o[0], torch.zeros_like(o[0])), "length-0 inactive slot not zero")
        worst = max(worst, max_err(o, o_p))
        check(torch.equal(o, o_p),
              f"flash_decode output not bit-identical to plain ({dtype}): {max_err(o, o_p)}")
    print("flash_decode_gqa_fused: o and k_rot bit-identical to plain in f32 and bf16 "
          f"(lengths {lengths}, NaN past each, slot 0 inactive)")
    # the main path's middle state (every slot at length 80, active) and its
    # longest pre-append length
    t80, t127 = (decode_timing(torch, gen, theta, n, True, smi) for n in (80, 127))
    return dict(name="flash_decode_gqa_fused", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cuh",
                replaces="src/repro/kernels/flash_decode.py:481", max_abs_err=worst,
                **t80, len127=t127)


ZAMBA_HEADS = (32, 32, 112)  # zamba2-7b's shared block: (h, g, d), MHA


def d112_timing(torch, gen, theta, length, smi):
    """Kernel, plain, SDPA and bound of kernel 2's d 112 form at zamba2-7b's
    decode shape (b 6, h 32, g 32, d 112, f32), every slot at ``length``
    plus its pending token."""
    from repro_torch.kernels import flash_decode as fd

    (h, g, d), b = ZAMBA_HEADS, 6
    q, cache, k_new, v_new = decode_case(torch, gen, [length] * b, torch.float32, b=b, h=h,
                                         g=g, d=d)
    kw = dict(k_new=k_new, v_new=v_new, active=torch.ones(b, dtype=torch.bool, device="cuda"),
              rope_theta=theta)
    print(f"flash_decode_gqa_fused d 112 at length {length}:")
    ms, _ = timed("kernel", lambda: fd.flash_decode_attention(q, cache, **kw), only=GQA_DECODE)
    plain_ms, _ = timed("plain", lambda: fd.flash_decode_attention(q, cache, impl="plain", **kw))
    library_ms, _ = timed("SDPA", decode_sdpa(torch, q, cache, length, (k_new, v_new)))
    # as decode_timing's: q, the valid rows, lengths, out, k_new, v_new,
    # active, the cos / sin tables and k_rot
    n_bytes = (b * h * d * 4 + b * length * g * d * 4 * 2 + 4 * b + b * h * d * 4
               + 2 * b * g * d * 4 + 4 * b + b * d * 4 + b * g * d * 4)
    ops = 4 * b * h * (length + 1) * d
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"flash_decode_gqa_fused d 112 (b=6, h=g=32, length {length}, f32): kernel {ms:.5f} "
          f"ms, plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms by "
          f"{b_by} ({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def kernel2_d112_phase(torch, gen, theta, smi):
    """Kernel 2's fused contiguous form at d 112 (zamba2-7b's shared block,
    rep 1): o and k_rot bit-identical to the plain version in f32 and bf16
    at lengths 1 / 31 / 32 / 33 / 80 / 127 (NaN past each, slot 2
    inactive), then timed at the served run's middle length."""
    from repro_torch.kernels import flash_decode as fd

    (h, g, d), worst = ZAMBA_HEADS, 0.0
    lengths = [1, 31, 32, 33, 80, 127]
    active = torch.tensor([True, True, False, True, True, True], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype, h=h, g=g, d=d)
        kw = dict(k_new=k_new, v_new=v_new, active=active, rope_theta=theta)
        o, k_rot = fd.flash_decode_attention(q, cache, **kw)
        o_p, k_rot_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
        torch.cuda.synchronize()
        check(torch.isfinite(o).all(), "flash_decode d 112 output not finite")
        check(torch.equal(k_rot, k_rot_p), f"flash_decode d 112 k_rot not bit-identical ({dtype})")
        worst = max(worst, max_err(o, o_p))
        check(torch.equal(o, o_p), f"flash_decode d 112 output not bit-identical to plain "
                                   f"({dtype}): {max_err(o, o_p)}")
    print(f"flash_decode_gqa_fused d 112: o and k_rot bit-identical to plain in f32 and bf16 "
          f"(h = g = 32, lengths {lengths}, NaN past each, slot 2 inactive)")
    # the served run's decode lengths are 96 .. 127
    return dict(name="flash_decode_gqa_fused (d 112)", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cuh",
                replaces="src/repro/kernels/flash_decode.py:481", max_abs_err=worst,
                **d112_timing(torch, gen, theta, 111, smi))


# ---------------------------------------------------------------------------
# kernel 3: fresh causal flash prefill
# ---------------------------------------------------------------------------


def kernel3_phase(torch, gen, theta):
    from repro_torch.kernels import flash_prefill as fp

    def case(s, dtype, b=6, h=8, g=4, d=256):
        q = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, g, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, g, d), generator=gen, device="cuda").to(dtype)
        return q, k, v

    worst = 0.0
    for s, dtype in ((32, torch.float32), (128, torch.float32), (77, torch.float32),
                     (32, torch.bfloat16)):
        q, k, v = case(s, dtype)
        valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device="cuda")
        got = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=theta)
        ref = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=theta, impl="plain")
        torch.cuda.synchronize()
        worst = max(worst, max_err(got[0], ref[0]))
        for name, a, b_ in zip(("o", "k_cast", "v_cast"), got, ref):
            check(torch.equal(a, b_), f"flash_prefill {name} not bit-identical to plain "
                                      f"(s={s}, {dtype}): {max_err(a, b_)}")
    print("flash_prefill: o, k_cast and v_cast bit-identical to plain at s=32/128/77 (f32) "
          "and 32 (bf16)")

    b, h, g, d = 6, 8, 4, 256
    out = {}
    for s in (32, 128):
        q, k, v = case(s, torch.float32)
        ms, _ = timed(f"kernel s={s}", lambda: fp.flash_prefill_attention(
            q, k, v, rope_theta=theta), only="prefill_kernel")
        plain_ms, _ = timed(f"plain s={s}", lambda: fp.flash_prefill_attention(
            q, k, v, rope_theta=theta, impl="plain"), iters=5 if s > 32 else 20)
        qh = q.permute(0, 2, 1, 3).contiguous()
        kh = k.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
        vh = v.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
        library_ms, _ = timed(f"SDPA s={s}", lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
        n_bytes = 4 * (2 * b * s * h * d + 4 * b * s * g * d) + 4 * b
        ops = 4 * b * h * d * s * (s + 1) // 2
        b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
        print(f"flash_prefill (b=6, s={s}, h=8, g=4, d=256, f32): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms "
              f"({n_bytes} B / 3.35 TB/s; {b_by})")
        out[s] = (ms, plain_ms, library_ms, b_ms, b_by)
    llava, worst_llava = kernel3_llava(torch, gen)
    ms, plain_ms, library_ms, b_ms, b_by = out[32]
    return dict(name="flash_prefill_fresh", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cuh",
                replaces="src/repro/kernels/flash_prefill.py:258",
                max_abs_err=max(worst, worst_llava),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                s128={"ms": out[128][0], "plain_ms": out[128][1], "library_ms": out[128][2],
                      "bound_ms": out[128][3]}, llava=llava)


VLM_PREFILL = (6, 608, 56, 8, 128)  # llava-next-34b's admission: (b, s = 576 + 32, h, g, d)


def kernel3_llava(torch, gen):
    """Kernel 3's fresh form at llava-next-34b's admission (b 6, s 608, h
    56, g 8: rep 7, d 128, f32, its theta): o and the emitted k / v
    bit-identical to plain (valid s, s - 5, 1 and 0 too), timed beside
    causal SDPA and its bound."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_prefill as fp

    theta = get_config("llava-next-34b").rope_theta
    b, s, h, g, d = VLM_PREFILL
    q = torch.randn((b, s, h, d), generator=gen, device="cuda")
    k = torch.randn((b, s, g, d), generator=gen, device="cuda")
    v = torch.randn((b, s, g, d), generator=gen, device="cuda")
    valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device="cuda")
    got = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=theta)
    ref = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=theta, impl="plain")
    torch.cuda.synchronize()
    worst = max_err(got[0], ref[0])
    for name, a, b_ in zip(("o", "k_cast", "v_cast"), got, ref):
        check(torch.equal(a, b_), f"flash_prefill {name} not bit-identical to plain at "
                                  f"llava's admission: {max_err(a, b_)}")
    ms, _ = timed("kernel, llava admission", lambda: fp.flash_prefill_attention(
        q, k, v, rope_theta=theta), only="prefill_kernel")
    plain_ms, _ = timed("plain, llava admission", lambda: fp.flash_prefill_attention(
        q, k, v, rope_theta=theta, impl="plain"), iters=3)
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = k.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    library_ms, _ = timed("causal SDPA, llava admission",
                          lambda: torch.nn.functional.scaled_dot_product_attention(
                              qh, kh, vh, is_causal=True))
    n_bytes = 4 * (2 * b * s * h * d + 4 * b * s * g * d) + 4 * b
    ops = 4 * b * h * d * s * (s + 1) // 2
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"flash_prefill at llava-next-34b's admission (b=6, s=608, h=56, g=8, d=128, f32): "
          f"bit-identical to plain (valid s / s-5 / 0 / 1); kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, causal SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms ({ops} FLOP "
          f"/ 67 TFLOP/s, {n_bytes} B / 3.35 TB/s; {b_by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by), worst


# ---------------------------------------------------------------------------
# kernel 3, chunked form: a prompt chunk over the live tiered cache
# ---------------------------------------------------------------------------

CHUNK_OFFSETS = [0, 5, 31, 32, 33, 64, 96]


def chunk_case(torch, gen, c, dtype, lengths, b=None, h=8, g=4, d=256, hot=32, cold=96,
               tier=None):
    """q / k / v (b, c, ·, d) and a hot / cold cache at ``lengths`` whose
    rows at or past each slot's length hold NaN, its tiers in ``tier``
    (default ``dtype``)."""
    from repro_torch.core import kv_cache as kvc

    b = b or len(lengths)
    cache = kvc.init_cache(b, hot, cold, (g, d), device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    hot_ok, cold_ok = kvc.valid_masks(cache._replace(lengths=lens))
    tiers = [kvc.to_tier(torch.where(ok[:, :, None, None],
                                     torch.randn(t.shape, generator=gen, device="cuda"),
                                     float("nan")).to(dtype), tier or dtype)
             for t, ok in zip(cache[:4], (hot_ok, hot_ok, cold_ok, cold_ok))]
    cache = kvc.TieredKVCache(*tiers, lens)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, c, h, d), (b, c, g, d), (b, c, g, d)))
    return q, k, v, cache


def chunk_matches_plain(torch, fp, q, k, v, cache, valid, theta, case):
    """One ``flash_prefill_chunk`` launch (and no fresh one) whose o,
    k_cast and v_cast equal the plain version's bit for bit; returns the
    max |diff| of o."""
    before = (fp.KERNEL.launches, fp.CHUNK_KERNEL.launches)
    got = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=theta)
    torch.cuda.synchronize()
    check((fp.KERNEL.launches, fp.CHUNK_KERNEL.launches) == (before[0], before[1] + 1),
          f"flash_prefill_chunk: not one chunk launch ({case})")
    ref = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=theta, impl="plain")
    for name, a, b_ in zip(("o", "k_cast", "v_cast"), got, ref):
        check(torch.equal(a, b_), f"flash_prefill_chunk {name} not bit-identical to plain "
                                  f"({case}): {max_err(a, b_)}")
    return max_err(got[0], ref[0])


def kernel3_chunk_phase(torch, gen, theta, smi):
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_prefill as fp

    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (128, 256):
            for rep in (1, 2, 4, 8):
                for c in (16, 32, 48):
                    q, k, v, cache = chunk_case(torch, gen, c, dtype, CHUNK_OFFSETS, h=2 * rep,
                                                g=2, d=d)
                    valid = torch.tensor([0, 1, c - 5, c, c, 1, c - 5], dtype=torch.int32,
                                         device="cuda")
                    worst = max(worst, chunk_matches_plain(
                        torch, fp, q, k, v, cache, valid, theta,
                        f"rep {rep}, d {d}, C {c}, {dtype}"))
                    n += 1
    print(f"flash_prefill_chunk: o (every row), k_cast and v_cast bit-identical to plain on {n} "
          f"cases (rep 1/2/4/8 x d 128/256 x C 16/32/48 x f32/bf16; hot 32 / cold 96, offsets "
          f"{CHUNK_OFFSETS}, valid 0 / 1 / C-5 / C, NaN past each length), one launch each")

    # falcon3-1b's chunk waves: h 8, g 4, d 256, C 32, 6 slots (generate)
    # or 4 (serve), each slot at a wave boundary with every valid count
    c, n = 32, 0
    for dtype in (torch.float32, torch.bfloat16):
        for b in (6, 4):
            for shift in range(4):
                offs = [(32 * (i + shift)) % 128 for i in range(b)]
                valid = torch.tensor([(0, 1, c - 5, c)[i % 4] for i in range(b)],
                                     dtype=torch.int32, device="cuda")
                q, k, v, cache = chunk_case(torch, gen, c, dtype, offs)
                chunk_matches_plain(torch, fp, q, k, v, cache, valid, theta,
                                    f"falcon shape, b {b}, offsets {offs}, {dtype}")
                n += 1
    print(f"flash_prefill_chunk at falcon3-1b's wave shape (h 8, g 4, d 256, C 32, b 6 / 4, "
          f"offsets 0 / 32 / 64 / 96, valid 0 / 1 / C-5 / C, f32 / bf16): {n} cases "
          f"bit-identical to plain, one launch each")

    # aligned identity: falcon3-1b's shape in f32, three chunks of 32 over a
    # hot-32 cache against one fresh launch over the whole 96-token prompt
    b, h, g, d = 6, 8, 4, 256
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for shape in ((b, 96, h, d), (b, 96, g, d), (b, 96, g, d)))
    fresh, _, _ = fp.flash_prefill_attention(q, k, v, rope_theta=theta)
    cache = kvc.init_cache(b, 32, 96, (g, d), device="cuda")
    full = torch.full((b,), 32, dtype=torch.int32, device="cuda")
    outs = []
    for c0 in range(0, 96, 32):
        o, k_c, v_c = fp.flash_prefill_attention(q[:, c0:c0 + 32], k[:, c0:c0 + 32],
                                                 v[:, c0:c0 + 32], cache, full, rope_theta=theta)
        kvc.append(cache, k_c, v_c, valid=full)
        outs.append(o)
    torch.cuda.synchronize()
    check(torch.equal(torch.cat(outs, 1), fresh),
          f"aligned chunks != the fresh launch: {max_err(torch.cat(outs, 1), fresh)}")
    print("flash_prefill_chunk aligned identity (b 6, h 8, g 4, d 256, f32): three chunk "
          "launches over a hot-32 cache equal one fresh launch over s = 96 bit for bit")

    # one falcon3-1b chunk wave late in a 128-token admission: C 32 at offset 96
    c, off = 32, 96
    q, k, v, cache = chunk_case(torch, gen, c, torch.float32, [off] * b)
    full = torch.full((b,), c, dtype=torch.int32, device="cuda")
    worst = max(worst, chunk_matches_plain(torch, fp, q, k, v, cache, full, theta,
                                           f"timing case, C {c}, offset {off}"))
    print(f"flash_prefill_chunk at C {c}, offset {off}: bit-identical to plain")
    ms, _ = timed("kernel", lambda: fp.flash_prefill_attention(q, k, v, cache, rope_theta=theta),
                  only="chunk_kernel")
    plain_ms, _ = timed("plain", lambda: fp.flash_prefill_attention(
        q, k, v, cache, rope_theta=theta, impl="plain"), iters=5)
    # SDPA over the materialised [prefix ‖ chunk] keys (rotated) with an
    # explicit causal mask, k / v expanded to the h heads
    from repro_torch.models.layers import apply_rope

    pos = off + torch.arange(c, device="cuda")[None].expand(b, -1)
    qh = apply_rope(q, pos, theta).permute(0, 2, 1, 3).contiguous()
    kk = torch.cat([cache.hot_k, cache.cold_k[:, : off - 32], apply_rope(k, pos, theta)], 1)
    vv = torch.cat([cache.hot_v, cache.cold_v[:, : off - 32], v], 1)
    kh = kk.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    vh = vv.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    mask = (off + torch.arange(c, device="cuda"))[:, None] >= torch.arange(off + c, device="cuda")
    library_ms, _ = timed("SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask))
    # q, the chunk's k / v, the cached rows, the lengths, valid, o and the
    # emitted k / v, as the fresh form's bound counts them (the cos / sin
    # tables are the wrapper's glue, not the attention's input); two FLOP
    # per product and per add of q.k and p.v over the keys each row sees
    n_bytes = 4 * (2 * b * c * h * d + 4 * b * c * g * d + 2 * b * off * g * d) + 8 * b
    ops = 4 * b * h * d * (c * off + c * (c + 1) // 2)
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"flash_prefill_chunk (b=6, C={c}, offset {off}, h=8, g=4, d=256, f32): kernel "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms "
          f"by {b_by} ({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(name="flash_prefill_chunk", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cuh",
                replaces="src/repro/kernels/flash_prefill.py:258", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel 1, expert form: DeepSeek-V3's routed experts in one launch
# ---------------------------------------------------------------------------

EXPERT_SHAPES = ((7168, 4096), (2048, 7168))  # w_gate‖w_up, w_down (K, N)


def expert_bmm_ms(torch, gen, xs_by_c):
    """bf16 ``torch.bmm`` over one MoE layer's two expert projections on
    random bf16 weights of the expert shapes, the library yardstick. For
    each C of ``xs_by_c`` (C -> the x of w_gu and of w_down): (the layer's
    time, [each projection's time]). Frees the 22 GB of weights."""
    ws = [torch.randn((256, k, n), generator=gen, device="cuda", dtype=torch.bfloat16)
          for k, n in EXPERT_SHAPES]
    out = {}
    for c, xs in xs_by_c.items():
        xb = [x.to(torch.bfloat16) for x in xs]
        layer, _ = timed(f"bf16 torch.bmm C={c}", lambda: [torch.bmm(a, w) for a, w in zip(xb, ws)],
                         iters=5)
        out[c] = (layer, [time_ms(lambda a=a, w=w: torch.bmm(a, w), iters=5)
                          for a, w in zip(xb, ws)])
    del ws
    torch.cuda.empty_cache()
    return out


def expert_operands(torch, gen, c, k, n, dtype=None, e=256):
    """Raw x (e, c, k) whose last slot is empty (zeros: no token took it) in
    every 7th expert, random packed pack2 bytes (e, k/4, n) and column
    scales (e, n)."""
    x = (torch.randn((e, c, k), generator=gen, device="cuda") * 3).to(dtype or torch.float32)
    x[::7, -1] = 0.0
    packed = torch.randint(0, 256, (e, k // 4, n), generator=gen, device="cuda",
                           dtype=torch.uint8)
    col = torch.rand((e, n), generator=gen, device="cuda") + 0.01
    return x, packed, col


def kernel1_expert_phase(torch, gen):
    from repro_torch.kernels import ternary_matmul as tm

    e = 256
    worst, cases = 0.0, 0
    for c in (1, 8):
        for k, n in EXPERT_SHAPES:
            for dtype in ((torch.float32, torch.bfloat16) if c == 1 else (torch.float32,)):
                x, p, col = expert_operands(torch, gen, c, k, n, dtype)
                got = tm.ternary_matmul_expert(x, p, col, k=k)
                ref = tm.ternary_matmul_expert(x, p, col, k=k, impl="plain")
                torch.cuda.synchronize()
                worst = max(worst, max_err(got, ref))
                cases += 1
                check(torch.equal(got, ref), f"ternary_matmul_expert not bit-identical: "
                                             f"E={e} C={c} K={k} N={n} {dtype}")
                check(not got[::7, -1].any(), "an empty expert slot is not exactly zero")
    print(f"ternary_matmul_expert: bit-identical to plain on {cases} cases "
          "(E=256, C=1/8, w_gu and w_down shapes, f32 + bf16 at C=1); empty slots exactly zero")

    # timing: one MoE layer's two expert launches at decode (C = 1, f32),
    # and each launch at prefill (C = 8: 6 prompts x 32 tokens, top-8 of 256)
    layer = [expert_operands(torch, gen, 1, k, n) for k, n in EXPERT_SHAPES]
    prefill = [expert_operands(torch, gen, 8, k, n) for k, n in EXPERT_SHAPES]

    def run(fn):
        return lambda: [fn(x, p, col, k) for (k, _), (x, p, col) in zip(EXPERT_SHAPES, layer)]

    ms, _ = timed("kernel", run(lambda x, p, col, k: tm.ternary_matmul_expert(x, p, col, k=k)),
                  only=TERNARY)
    plain_ms, _ = timed("plain", run(lambda x, p, col, k: tm.ternary_matmul_expert(
        x, p, col, k=k, impl="plain")), iters=2)
    bmm = expert_bmm_ms(torch, gen, {1: [x for x, _, _ in layer], 8: [x for x, _, _ in prefill]})
    library_ms = bmm[1][0]
    n_bytes = sum(e * (k * 4 + k // 4 * n + n * 4 + n * 4) for k, n in EXPERT_SHAPES)
    ops = sum(2 * e * k * n for k, n in EXPERT_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"ternary_matmul_expert MoE layer (2 launches, E=256, C=1, pack2, f32 x): kernel "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bf16 bmm {library_ms:.5f} ms, bound "
          f"{b_ms:.5f} ms ({n_bytes} B / 3.35 TB/s)")
    for (k, n), (x, p, col), bmm_ms in zip(EXPERT_SHAPES, prefill, bmm[8][1]):
        t = device_ms(lambda: tm.ternary_matmul_expert(x, p, col, k=k), only=TERNARY)
        t = time_ms(lambda: tm.ternary_matmul_expert(x, p, col, k=k)) if t is None else t
        nb = e * (8 * k * 4 + k // 4 * n + n * 4 + 8 * n * 4)
        print(f"ternary_matmul_expert prefill E=256 C=8 K={k} N={n}: kernel {t:.5f} ms, "
              f"bf16 bmm {bmm_ms:.5f} ms, bound "
              f"{bound_ms(nb, 2 * e * 8 * k * n, INT8_OPS)[0]:.5f} ms")
    worst = max(worst, mixtral_experts(torch, gen))
    return dict(name="ternary_matmul_actq_expert", route="cuda",
                source="src/repro_torch/csrc/ternary_matmul.cu",
                replaces="src/repro/kernels/ternary_matmul.py:381", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def mixtral_experts(torch, gen):
    """Kernel 1's expert form at mixtral-8x22b's E 8, w_gu and w_down:
    bit-identical to plain at the capacities of its decode step (2 and 5)
    and of its 4200-token admission (1313 and 4200), f32, empty slots
    exactly zero; one MoE layer timed at decode (C 2) beside plain, bf16
    ``torch.bmm`` and the bound, each launch at the admission's C 1313.
    Returns the largest |kernel - plain|."""
    from repro_torch.kernels import ternary_matmul as tm

    e, worst = 8, 0.0
    for c in (2, 5, 1313, 4200):
        for k, n in MIXTRAL_EXPERT:
            x, p, col = expert_operands(torch, gen, c, k, n, e=e)
            got = tm.ternary_matmul_expert(x, p, col, k=k)
            ref = tm.ternary_matmul_expert(x, p, col, k=k, impl="plain")
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            check(torch.equal(got, ref), f"ternary_matmul_expert not bit-identical at "
                                         f"mixtral-8x22b's E={e} C={c} K={k} N={n}")
            check(not got[::7, -1].any(), "an empty expert slot is not exactly zero")
            del x, p, col, got, ref
    print("ternary_matmul_expert: bit-identical to plain at mixtral-8x22b's E=8 w_gu / w_down, "
          "C 2 / 5 / 1313 / 4200 (f32); empty slots exactly zero")
    layer = [expert_operands(torch, gen, 2, k, n, e=e) for k, n in MIXTRAL_EXPERT]

    def run(fn):
        return lambda: [fn(x, p, col, k) for (k, _), (x, p, col) in zip(MIXTRAL_EXPERT, layer)]

    ms, _ = timed("kernel", run(lambda x, p, col, k: tm.ternary_matmul_expert(x, p, col, k=k)),
                  only=TERNARY)
    plain_ms, _ = timed("plain", run(lambda x, p, col, k: tm.ternary_matmul_expert(
        x, p, col, k=k, impl="plain")), iters=2)
    ws = [torch.randn((e, k, n), generator=gen, device="cuda", dtype=torch.bfloat16)
          for k, n in MIXTRAL_EXPERT]
    xb = [x.to(torch.bfloat16) for x, _, _ in layer]
    library_ms, _ = timed("bf16 torch.bmm", lambda: [torch.bmm(a, w) for a, w in zip(xb, ws)])
    nb = sum(e * (2 * k * 4 + k // 4 * n + n * 4 + 2 * n * 4) for k, n in MIXTRAL_EXPERT)
    b_ms, b_by = bound_ms(nb, sum(2 * e * 2 * k * n for k, n in MIXTRAL_EXPERT), INT8_OPS)
    print(f"ternary_matmul_expert mixtral-8x22b MoE layer (2 launches, E=8, C=2, pack2, f32 x): "
          f"kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, bf16 bmm {library_ms:.5f} ms, bound "
          f"{b_ms:.5f} ms by {b_by} ({nb} B / 3.35 TB/s)")
    c = 1313
    for (k, n), w in zip(MIXTRAL_EXPERT, ws):
        x, p, col = expert_operands(torch, gen, c, k, n, e=e)
        t = device_ms(lambda: tm.ternary_matmul_expert(x, p, col, k=k), only=TERNARY)
        t = time_ms(lambda: tm.ternary_matmul_expert(x, p, col, k=k)) if t is None else t
        xbf = x.to(torch.bfloat16)
        bmm = time_ms(lambda: torch.bmm(xbf, w), iters=5)
        nb = e * (c * k * 4 + k // 4 * n + n * 4 + c * n * 4)
        print(f"ternary_matmul_expert mixtral-8x22b admission E={e} C={c} K={k} N={n}: kernel "
              f"{t:.5f} ms, bf16 bmm {bmm:.5f} ms, bound "
              f"{bound_ms(nb, 2 * e * c * k * n, INT8_OPS)[0]:.5f} ms")
        del x, p, col, xbf
    del ws, xb, layer
    torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# kernel 3, MLA form: rope_dims 64 of 192, dv 128, g = h = 128, no emit
# ---------------------------------------------------------------------------


def kernel3_mla_phase(torch, gen, theta):
    from repro_torch.kernels import flash_prefill as fp

    b, h, dk, dv, rd = 6, 128, 192, 128, 64

    def case(s, dtype):
        q = torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, s, h, dk), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, s, h, dv), generator=gen, device="cuda").to(dtype)
        return q, k, v

    kw = dict(rope_theta=theta, rope_dims=rd, emit_kv=False, scale=dk ** -0.5)
    worst = 0.0
    checked = ((1, torch.float32), (32, torch.float32), (33, torch.float32), (77, torch.float32),
               (128, torch.float32), (32, torch.bfloat16), (128, torch.bfloat16))
    for s, dtype in checked:
        q, k, v = case(s, dtype)
        valid = torch.tensor([s, max(s - 5, 0), 0, s, 1, s], dtype=torch.int32, device="cuda")
        got = fp.flash_prefill_attention(q, k, v, valid=valid, **kw)
        ref = fp.flash_prefill_attention(q, k, v, valid=valid, impl="plain", **kw)
        torch.cuda.synchronize()
        worst = max(worst, max_err(got, ref))
        check(torch.equal(got, ref), f"flash_prefill MLA form not bit-identical (s={s}, {dtype}): "
                                     f"{max_err(got, ref)}")
    print("flash_prefill MLA form: bit-identical to plain at s=1/32/33/77/128 (f32) and 32/128 "
          "(bf16), valid (s, s-5, 0, s, 1, s)")

    out = {}
    for s in (32, 128):
        q, k, v = case(s, torch.float32)
        ms, _ = timed(f"kernel s={s}", lambda: fp.flash_prefill_attention(q, k, v, **kw),
                      only="prefill_kernel")
        plain_ms, _ = timed(f"plain s={s}", lambda: fp.flash_prefill_attention(
            q, k, v, impl="plain", **kw), iters=5 if s > 32 else 10)
        qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        library_ms, _ = timed(f"SDPA s={s}", lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
        n_bytes = 4 * b * s * h * (2 * dk + 2 * dv) + 4 * b
        ops = 2 * b * h * (dk + dv) * s * (s + 1) // 2
        b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
        print(f"flash_prefill MLA (b=6, s={s}, h=128, f32): kernel {ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms "
              f"({n_bytes} B / 3.35 TB/s; {b_by})")
        out[s] = (ms, plain_ms, library_ms, b_ms, b_by)
    ms, plain_ms, library_ms, b_ms, b_by = out[32]
    return dict(name="flash_prefill_mla", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cuh",
                replaces="src/repro/kernels/flash_prefill.py:258", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                s128={"ms": out[128][0], "plain_ms": out[128][1], "library_ms": out[128][2],
                      "bound_ms": out[128][3]})


# ---------------------------------------------------------------------------
# kernel 8: MLA absorbed latent decode
# ---------------------------------------------------------------------------


def latent_case(torch, gen, lengths, dtype, b=6, h=128, d=576, hot=32, cold=96):
    """q (f32) and a latent cache in ``dtype`` (f32, bf16 or fp8) whose
    rows at or past each slot's length hold NaN."""
    from repro_torch.core import kv_cache as kvc

    cache = kvc.init_cache(b, hot, cold, (d,), v_shape=(0,), device="cuda")
    cache = cache._replace(hot_k=torch.randn(cache.hot_k.shape, generator=gen, device="cuda"),
                           cold_k=torch.randn(cache.cold_k.shape, generator=gen, device="cuda"),
                           lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    # rows at or past each slot's length hold NaN: neither version may read them
    hot_valid, cold_valid = kvc.valid_masks(cache)
    cache = cache._replace(
        hot_k=kvc.to_tier(torch.where(hot_valid[..., None], cache.hot_k, float("nan")), dtype),
        cold_k=kvc.to_tier(torch.where(cold_valid[..., None], cache.cold_k, float("nan")), dtype))
    q = torch.randn((b, h, d), generator=gen, device="cuda")
    return q, cache


def kernel8_phase(torch, gen, smi):
    from repro_torch.kernels import flash_decode as fd

    scale, dv = 192 ** -0.5, 512
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for lengths in ([0, 1, 17, 31, 32, 20], [33, 64, 80, 100, 127, 128], [0] * 6):
            q, cache = latent_case(torch, gen, lengths, dtype)
            got = fd.flash_decode_attention_latent(q, cache, dv, scale)
            ref = fd.flash_decode_attention_latent(q, cache, dv, scale, impl="plain")
            torch.cuda.synchronize()
            check(torch.isfinite(got).all(), "latent decode output not finite (read a masked row?)")
            zero = torch.tensor(lengths, device="cuda") == 0
            check(not got[zero].any(), "length-0 slot not zero")
            worst = max(worst, max_err(got, ref))
            check(torch.equal(got, ref),
                  f"latent decode not bit-identical ({str(dtype)[6:]}, {lengths})")
    print("flash_decode_latent: bit-identical to plain in f32 and bf16 (hot only, hot + cold, "
          "length 0)")

    b, h, d = 6, 128, 576
    out = {}
    for length in (80, 128):  # the main path's middle state, and max_len
        q, cache = latent_case(torch, gen, [length] * b, torch.float32)
        print(f"flash_decode_latent at b=6, h=128, length {length}, f32:")
        ms, _ = timed("kernel", lambda: fd.flash_decode_attention_latent(q, cache, dv, scale),
                      only="latent_kernel")
        plain_ms, _ = timed("plain", lambda: fd.flash_decode_attention_latent(
            q, cache, dv, scale, impl="plain"))
        rows = torch.cat([cache.hot_k, cache.cold_k[:, : length - 32]], 1)  # (b, length, 576)
        kh = rows[:, None].expand(b, h, length, d).contiguous()
        vh = rows[:, None, :, :dv].expand(b, h, length, dv).contiguous()
        library_ms, _ = timed("SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], kh, vh, scale=scale))
        n_bytes = b * h * d * 4 + b * length * d * 4 + 4 * b + b * h * dv * 4
        ops = 2 * b * h * length * (d + dv)
        b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
        print(f"flash_decode_latent (b=6, h=128, length {length}, f32): kernel {ms:.5f} ms, "
              f"plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} "
              f"({n_bytes} B, {ops} FLOP) on {smi}")
        out[length] = (ms, plain_ms, library_ms, b_ms, b_by)
    ms, plain_ms, library_ms, b_ms, b_by = out[80]
    return dict(name="flash_decode_latent", route="cuda",
                source="src/repro_torch/csrc/flash_latent.cu",
                replaces="src/repro/kernels/flash_decode.py:579", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                len128={"ms": out[128][0], "plain_ms": out[128][1], "library_ms": out[128][2],
                        "bound_ms": out[128][3]})


# ---------------------------------------------------------------------------
# kernel 4: known-scale ternary matmul (the carried-scale path)
# ---------------------------------------------------------------------------


def kernel4_phase(torch, gen):
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import ternary_matmul as tm

    worst, cases = 0.0, 0
    # falcon3-1b's and deepseek-v3-671b-l5's shapes in both codecs (deepseek's
    # wo, K = 16384, and dense down, K = 18432, were past the first kernel's
    # pack243 cap), and qwen3-32b's down projection in pack2 (K = 25600, past
    # its pack2 cap). Each case also holds the act-quant kernel (the same x)
    # and the int32 kernel (the same codes) against it.
    grid = [(codec, k, n) for codec in ("pack2", "pack243")
            for k, n in DECODE_SHAPES + DEEPSEEK_SHAPES]
    grid += [("pack2",) + QWEN_DOWN]
    for codec, k, n in grid:
        for m in (6, 192):
            x, (p,), col = projection_operands(torch, gen, m, k, n, codec)
            q = act_quant(x)
            got = tm.ternary_matmul_fused(q.xq, p, q.scale, col, k=k, codec=codec)
            ref = tm.ternary_matmul_fused_plain(q.xq, p, q.scale, col, k, codec)
            prologue = tm.ternary_matmul_actq(x, p, col, k=k, codec=codec)
            acc = tm.ternary_matmul(q.xq, p, k=k, codec=codec)
            acc_ref = tm.ternary_acc_plain(q.xq, p, k, codec)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            cases += 1
            check(torch.equal(got, ref), f"ternary_matmul_known not bit-identical to plain: "
                                         f"{codec} M={m} K={k} N={n}")
            check(torch.equal(got, prologue), f"ternary_matmul_known != the act-quant "
                                              f"kernel on the same x: {codec} M={m} K={k}")
            check(torch.equal(acc, acc_ref), f"ternary_matmul_int32 not bit-identical to "
                                             f"plain: {codec} M={m} K={k} N={n}")
            del x, p, col, q, got, ref, prologue, acc, acc_ref
    print(f"ternary_matmul_known (and ternary_matmul_actq, ternary_matmul_int32): bit-identical "
          f"to plain on {cases} cases (M=6/192; falcon3-1b's 4 and deepseek-v3-671b-l5's 7 "
          f"projections in pack2/pack243, qwen3-32b's down {QWEN_DOWN} in pack2)")

    layer = [projection_operands(torch, gen, 6, k, n, copies=8) for k, n in DECODE_SHAPES]
    layer = [(act_quant(x), ps, col) for x, ps, col in layer]
    ms, _ = timed("kernel", layer_runner(layer, lambda q, p, col, k: tm.ternary_matmul_fused(
        q.xq, p, q.scale, col, k=k)), only=TERNARY)
    plain_ms, _ = timed("plain", layer_runner(layer, lambda q, p, col, k: (
        tm.ternary_matmul_fused_plain(q.xq, p, q.scale, col, k))), iters=5)
    library_ms, _ = timed("bf16 torch.matmul", dense_layer_matmul(
        torch, [(q.xq, ps, col) for q, ps, col in layer]))
    n_bytes = sum(6 * k + k // 4 * n + n * 4 + 6 * 4 + 6 * n * 4 for k, n in DECODE_SHAPES)
    ops = sum(2 * 6 * k * n for k, n in DECODE_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"ternary_matmul_known decode layer (4 launches, M=6, pack2): kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, bf16 matmul {library_ms:.5f} ms, bound {b_ms:.6f} ms "
          f"({n_bytes} B / 3.35 TB/s)")
    for k, n in DECODE_SHAPES:  # prefill: M = 192 (6 prompts x 32 tokens)
        x, (p,), col = projection_operands(torch, gen, 192, k, n)
        q = act_quant(x)
        t = device_ms(lambda: tm.ternary_matmul_fused(q.xq, p, q.scale, col, k=k),
                      only=TERNARY)
        t = time_ms(lambda: tm.ternary_matmul_fused(q.xq, p, q.scale, col, k=k)) if t is None else t
        nb = 192 * k + k // 4 * n + n * 4 + 192 * 4 + 192 * n * 4
        print(f"ternary_matmul_known prefill M=192 K={k} N={n}: kernel {t:.5f} ms, torch._int_mm "
              f"{fmt(int_mm_ms(torch, q.xq, p, k))}, bound "
              f"{bound_ms(nb, 2 * 192 * k * n, INT8_OPS)[0]:.5f} ms")
    return dict(name="ternary_matmul_known", route="cuda",
                source="src/repro_torch/csrc/ternary_matmul.cu",
                replaces="src/repro/kernels/ternary_matmul.py:185", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel 5: int8 x packed -> int32 (the ternary_matmul entry point)
# ---------------------------------------------------------------------------


def kernel5_phase(torch, gen):
    from repro_torch.core import packing
    from repro_torch.kernels import ref
    from repro_torch.kernels import ternary_matmul as tm

    def codes(m, k):
        return torch.randint(-128, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)

    worst, cases = 0.0, 0
    for codec in ("pack2", "pack243"):
        for m, k, n in [(8, 256, 64)] + [(m, k, n) for m in (6, 192) for k, n in DECODE_SHAPES]:
            xq = codes(m, k)
            p = packing.pack(torch.randint(-1, 2, (k, n), generator=gen, device="cuda",
                                           dtype=torch.int8), codec)
            got = tm.ternary_matmul(xq, p, k=k, codec=codec)
            plain = tm.ternary_acc_plain(xq, p, k, codec)
            oracle = ref.ternary_matmul_ref(xq, p, k, codec)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, plain))
            cases += 1
            check(got.dtype == torch.int32 and torch.equal(got, plain),
                  f"ternary_matmul_int32 not bit-identical to plain: {codec} M={m} K={k} N={n}")
            check(torch.equal(got, oracle), f"ternary_matmul_int32 != ref.ternary_matmul_ref: "
                                            f"{codec} M={m} K={k} N={n}")
    print(f"ternary_matmul_int32: bit-identical to plain and to ref.ternary_matmul_ref on "
          f"{cases} cases (pack2/pack243, quickstart's (8, 256) x (256, 64), falcon3-1b's 4 "
          "projections at M=6/192)")

    layer = [projection_operands(torch, gen, 6, k, n, copies=8) for k, n in DECODE_SHAPES]
    layer = [(codes(6, k), ps, col) for (k, _), (_, ps, col) in zip(DECODE_SHAPES, layer)]
    ms, _ = timed("kernel", layer_runner(layer, lambda xq, p, col, k: tm.ternary_matmul(
        xq, p, k=k)), only=TERNARY)
    plain_ms, _ = timed("plain", layer_runner(layer, lambda xq, p, col, k: tm.ternary_acc_plain(
        xq, p, k, "pack2")), iters=5)
    library_ms, _ = timed("bf16 torch.matmul", dense_layer_matmul(torch, layer))
    n_bytes = sum(6 * k + k // 4 * n + 6 * n * 4 for k, n in DECODE_SHAPES)
    ops = sum(2 * 6 * k * n for k, n in DECODE_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"ternary_matmul_int32 decode layer (4 launches, M=6, pack2): kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, bf16 matmul {library_ms:.5f} ms, bound {b_ms:.6f} ms "
          f"({n_bytes} B / 3.35 TB/s)")
    for k, n in DECODE_SHAPES:  # prefill: M = 192, with torch._int_mm as a second yardstick
        xq = codes(192, k)
        p = packing.pack(torch.randint(-1, 2, (k, n), generator=gen, device="cuda",
                                       dtype=torch.int8), "pack2")
        t = device_ms(lambda: tm.ternary_matmul(xq, p, k=k), only=TERNARY)
        t = time_ms(lambda: tm.ternary_matmul(xq, p, k=k)) if t is None else t
        nb = 192 * k + k // 4 * n + 192 * n * 4
        print(f"ternary_matmul_int32 prefill M=192 K={k} N={n}: kernel {t:.5f} ms, "
              f"torch._int_mm {fmt(int_mm_ms(torch, xq, p, k))}, bound "
              f"{bound_ms(nb, 2 * 192 * k * n, INT8_OPS)[0]:.5f} ms")
    return dict(name="ternary_matmul_int32", route="cuda",
                source="src/repro_torch/csrc/ternary_matmul.cu",
                replaces="src/repro/kernels/ternary_matmul.py:113", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel 7: known-scale expert matmul (MoE experts on the carried-scale path)
# ---------------------------------------------------------------------------


def kernel7_phase(torch, gen):
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import ternary_matmul as tm

    e = 256

    def operands(c, k, n):
        x, packed, col = expert_operands(torch, gen, c, k, n)
        return x, act_quant(x), packed, col

    worst, cases = 0.0, 0
    for c in (1, 8):
        for k, n in EXPERT_SHAPES:
            x, q, p, col = operands(c, k, n)
            got = tm.ternary_matmul_expert_fused(q.xq, p, q.scale, col, k=k)
            ref = tm.ternary_matmul_expert_fused(q.xq, p, q.scale, col, k=k, impl="plain")
            prologue = tm.ternary_matmul_expert(x, p, col, k=k)
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            cases += 1
            check(torch.equal(got, ref), f"ternary_matmul_known_expert not bit-identical: "
                                         f"E={e} C={c} K={k} N={n}")
            check(torch.equal(got, prologue), f"ternary_matmul_known_expert != the act-quant "
                                              f"expert kernel: C={c} K={k}")
            check(not got[::7, -1].any(), "an empty expert slot is not exactly zero")
    print(f"ternary_matmul_known_expert: bit-identical to plain and to ternary_matmul_expert on "
          f"{cases} cases (E=256, C=1/8, w_gu and w_down shapes); empty slots exactly zero")

    layer = [operands(1, k, n)[1:] for k, n in EXPERT_SHAPES]
    prefill = [operands(8, k, n)[1:] for k, n in EXPERT_SHAPES]

    def run(fn):
        return lambda: [fn(q, p, col, k) for (k, _), (q, p, col) in zip(EXPERT_SHAPES, layer)]

    ms, _ = timed("kernel", run(lambda q, p, col, k: tm.ternary_matmul_expert_fused(
        q.xq, p, q.scale, col, k=k)), only=TERNARY)
    plain_ms, _ = timed("plain", run(lambda q, p, col, k: tm.ternary_matmul_expert_fused(
        q.xq, p, q.scale, col, k=k, impl="plain")), iters=2)
    bmm = expert_bmm_ms(torch, gen, {1: [q.xq for q, _, _ in layer],
                                     8: [q.xq for q, _, _ in prefill]})
    library_ms = bmm[1][0]
    n_bytes = sum(e * (k + k // 4 * n + n * 4 + 4 + n * 4) for k, n in EXPERT_SHAPES)
    ops = sum(2 * e * k * n for k, n in EXPERT_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"ternary_matmul_known_expert MoE layer (2 launches, E=256, C=1, pack2): kernel "
          f"{ms:.5f} ms, plain {plain_ms:.5f} ms, bf16 bmm {library_ms:.5f} ms, bound "
          f"{b_ms:.6f} ms ({n_bytes} B / 3.35 TB/s)")
    for (k, n), (q, p, col), bmm_ms in zip(EXPERT_SHAPES, prefill, bmm[8][1]):  # C = 8
        t = device_ms(lambda: tm.ternary_matmul_expert_fused(q.xq, p, q.scale, col, k=k),
                      only=TERNARY)
        t = time_ms(lambda: tm.ternary_matmul_expert_fused(q.xq, p, q.scale, col, k=k)) \
            if t is None else t
        nb = e * (8 * k + k // 4 * n + n * 4 + 8 * 4 + 8 * n * 4)
        print(f"ternary_matmul_known_expert prefill E=256 C=8 K={k} N={n}: kernel {t:.5f} ms, "
              f"bf16 bmm {bmm_ms:.5f} ms, bound "
              f"{bound_ms(nb, 2 * e * 8 * k * n, INT8_OPS)[0]:.5f} ms")
    return dict(name="ternary_matmul_known_expert", route="cuda",
                source="src/repro_torch/csrc/ternary_matmul.cu",
                replaces="src/repro/kernels/ternary_matmul.py:263", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel 6: GQA decode over the post-append cache
# ---------------------------------------------------------------------------


def kernel6_phase(torch, gen, theta, smi):
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.layers import apply_rope

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for lengths in ([0, 1, 31, 32, 33, 128], [0] * 6):
            q, cache, _, _ = decode_case(torch, gen, lengths, dtype)  # NaN past each length
            got = fd.flash_decode_attention(q, cache)
            ref = fd.flash_decode_attention(q, cache, impl="plain")
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            check(torch.isfinite(got).all(), "post-append decode output not finite")
            check(not got[0].any(), "length-0 slot not zero")
            check(torch.equal(got, ref), f"post-append decode not bit-identical ({dtype}, "
                                         f"{lengths}): {max_err(got, ref)}")
    # kernel_bench's case: b = 4, g = 4, rep 4, d = 128, bf16, capacity 512, length 32
    q, cache, _, _ = decode_case(torch, gen, [32] * 4, torch.bfloat16, b=4, h=16, g=4, d=128,
                                 hot=32, cold=480)
    got = fd.flash_decode_attention(q, cache)
    check(torch.equal(got, fd.flash_decode_attention(q, cache, impl="plain")),
          "post-append decode not bit-identical at kernel_bench's case")
    # against kernel 2: its pre-append cache plus the pending token, appended
    lengths = [0, 1, 31, 32, 33, 100]
    q, cache, k_new, v_new = decode_case(torch, gen, lengths, torch.float32)
    o2, k_rot = fd.flash_decode_attention(q, cache, k_new=k_new, v_new=v_new, rope_theta=theta)
    post = kvc.append_decode(kvc.TieredKVCache(*(t.clone() for t in cache)), k_rot, v_new)
    q_rot = apply_rope(q[:, None], cache.lengths.long()[:, None], theta)[:, 0]
    o6 = fd.flash_decode_attention(q_rot, post)
    torch.cuda.synchronize()
    err2 = max_err(o6, o2)
    check(torch.equal(o6, o2), f"post-append decode off the fused kernel: {err2}")
    print("flash_decode_gqa: bit-identical to plain (f32 + bf16, lengths 0-128 with NaN past "
          "each, all-zero lengths, kernel_bench's b=4 d=128 cap 512 bf16 case) and, after the "
          "append, to flash_decode_gqa_fused on the pre-append cache (both fold absolute tiles)")

    # the main path's middle state (every slot at length 80 after the
    # append) and a full cache
    t80, t128 = (decode_timing(torch, gen, theta, n, False, smi) for n in (80, 128))
    return dict(name="flash_decode_gqa", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cuh",
                replaces="src/repro/kernels/flash_decode.py:402", max_abs_err=worst,
                **t80, len128=t128)


# ---------------------------------------------------------------------------
# fault 4: a decoded row equals the prefill's row at its position
# ---------------------------------------------------------------------------

DP_LENGTHS = [1, 31, 32, 33, 40, 63, 80, 127]


def decode_prefill_phase(torch, gen, theta):
    """Recompute-from-prefix needs the decode to fold a slot's keys as the
    chunked prefill does: absolute 32-key tiles, the pending token at lane
    p % 32 of tile p // 32. At falcon3-1b's heads (h 8, g 4, d 256), slots
    at lengths 1 / 31 / 32 / 33 / 40 / 63 / 80 / 127 (every fourth one
    inactive, NaN past each length), f32 and bf16 activations, tiers in the
    activations' dtype or fp8, hot 32 and hot 4 (tiles straddling the
    tiers), contiguous and paged (page size 32, shuffled): the fused decode
    kernel (its own entry point, one launch) equals its plain version, and
    the one-row chunk kernel over the same cache; with f32 tiers also the
    fresh prefill kernel's row p (the cache made from its own emit) and
    the post-append kernel after the append (and its plain version); all
    bit for bit."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models.layers import apply_rope

    b, h, g, d, s = len(DP_LENGTHS), 8, 4, 256, 128
    lens = torch.tensor(DP_LENGTHS, dtype=torch.int32, device="cuda")
    pos, slots = lens.long(), torch.arange(b, device="cuda")
    active = torch.tensor([i % 4 != 3 for i in range(b)], device="cuda")
    n = 0
    for act in (torch.float32, torch.bfloat16):
        seq = [torch.randn((b, s, k, d), generator=gen, device="cuda").to(act) for k in (h, g, g)]
        fresh, k_cast, v_cast = fp.flash_prefill_attention(*seq, rope_theta=theta)
        q, kn, vn = (t[slots, pos] for t in seq)  # each slot's row at its length
        for tier in ("same", "fp8"):
            for hot in (32, 4):
                full = kvc.init_cache(b, hot, s - hot, (g, d), act, device="cuda")
                kvc.fill_fresh(full, k_cast, v_cast)
                full.lengths.copy_(lens)
                oks = kvc.valid_masks(full)
                cache = kvc.TieredKVCache(
                    *(kvc.to_tier(torch.where(ok[:, :, None, None], t.float(), float("nan")),
                                  kvc.FP8 if tier == "fp8" else act)
                      for t, ok in zip(full[:4], (oks[0], oks[0], oks[1], oks[1]))), lens)
                for paged in (False, True):
                    c = paged_copy(torch, cache, 32, shuffle_seed=hot) if paged else cache
                    kern = {(False, False): fd.KERNEL, (True, False): fd.PAGED_KERNEL,
                            (False, True): fd.FP8_KERNEL,
                            (True, True): fd.FP8_PAGED_KERNEL}[(paged, tier == "fp8")]
                    label = (f"{kern.symbol}, {str(act)[6:]} activations, {tier} tiers, hot "
                             f"{hot}, {'paged' if paged else 'contiguous'}")
                    kw = dict(k_new=kn, v_new=vn, active=active, rope_theta=theta)
                    before = kern.launches
                    o, k_rot = fd.flash_decode_attention(q, c, **kw)
                    torch.cuda.synchronize()
                    check(kern.launches == before + 1, f"{label}: not one launch of its own")
                    o_p, k_rot_p = fd.flash_decode_attention(q, c, impl="plain", **kw)
                    chunk, _, _ = fp.flash_prefill_attention(
                        q[:, None], kn[:, None], vn[:, None], c, active.int(), rope_theta=theta)
                    check(torch.isfinite(o).all(), f"{label}: output not finite")
                    check(torch.equal(o, o_p) and torch.equal(k_rot, k_rot_p),
                          f"{label}: not bit-identical to plain: {max_err(o, o_p)}")
                    check(torch.equal(o, chunk[:, 0]),
                          f"{label}: differs from the one-row chunk kernel: "
                          f"{max_err(o, chunk[:, 0])}")
                    if act == torch.float32 and tier == "same":
                        row = fresh[slots, pos]
                        check(torch.equal(o[active], row[active]),
                              f"{label}: differs from the fresh prefill's row p: "
                              f"{max_err(o[active], row[active])}")
                        post = type(c)(*(t.clone() for t in c))
                        kvc.append_decode(post, k_rot, vn, active=active)
                        q_rot = apply_rope(q[:, None], pos[:, None], theta)[:, 0]
                        o6 = fd.flash_decode_attention(q_rot, post)
                        o6_p = fd.flash_decode_attention(q_rot, post, impl="plain")
                        check(torch.equal(o6, o6_p) and torch.equal(o6[active], o[active]),
                              f"{label}: the post-append kernel after the append differs: "
                              f"{max_err(o6[active], o[active])}")
                    n += 1
    print(f"decode = prefill: on {n} cases (f32 / bf16 activations x same / fp8 tiers x hot "
          f"32 / 4 x contiguous / paged shuffled; lengths {DP_LENGTHS}, every fourth slot "
          f"inactive, NaN past each length) the fused decode kernel equals its plain version "
          f"and the one-row chunk kernel, and with f32 tiers the fresh prefill kernel's row p "
          f"and the post-append kernel after the append, bit for bit")


# ---------------------------------------------------------------------------
# speculative decoding's kernel forms: the verify chunk and the draft decode
# ---------------------------------------------------------------------------

SPEC_KS = (1, 2, 4, 8)  # the verify chunk widths (C = K)
# slot lengths on both sides of hot_cap 32 and of the cold page boundaries
# at 64 and 96 (page size 32); each at most 120 so that K = 8 fits
SPEC_OFFSETS = [0, 29, 31, 32, 33, 61, 63, 64, 95, 120]


def as_bytes(t):
    """A tensor's bytes (NaN rows compare equal to themselves)."""
    import torch

    return t.contiguous().view(torch.uint8)


def spec_kernel_phase(torch, gen, theta, smi):
    """The kernel forms speculative decoding runs. (1) The verify chunk is
    kernel 3's chunked form with its emit and without the append: at C = K
    in SPEC_KS over a hot 32 / cold 96 cache at SPEC_OFFSETS (valid K, K - 1
    and 0 across the slots; NaN past each length), f32 and bf16
    activations, tiers in that dtype or fp8, contiguous and paged (page
    size 32, shuffled): one launch of the form's own kernel, o, k_cast and
    v_cast equal to the plain version's bit for bit (fp8 by their bytes),
    the cache's tensors unchanged. (2) With f32 tiers, verify row j equals
    the fused decode kernel's output for the same token after rows 0..j-1
    were appended (k_rot equal to the emitted k too), hot 32 and hot 4,
    contiguous and paged, bit for bit. (3) Kernel 2 at the draft's shape
    (falcon3-draft: h 8, g 4, d 128, rep 2) against its plain version,
    f32 and bf16, and timed at b 6, length 80. (4) Kernels 2 (fused
    decode) and 3 (chunked form) at the derived draft's shape of
    mixtral-8x22b's speculative serve (``make_draft_config``: h 4, g 4, d
    16, rep 1) against their plain versions, f32 and bf16."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp

    forms = {(False, False): fp.CHUNK_KERNEL, (True, False): fp.CHUNK_PAGED_KERNEL,
             (False, True): fp.FP8_CHUNK_KERNEL, (True, True): fp.FP8_CHUNK_PAGED_KERNEL}
    b, n = len(SPEC_OFFSETS), 0
    for k in SPEC_KS:
        valid = torch.tensor([(k, max(k - 1, 0), k, 0)[i % 4] for i in range(b)],
                             dtype=torch.int32, device="cuda")
        for act in (torch.float32, torch.bfloat16):
            for fp8 in (False, True):
                q, kk, vv, cache = chunk_case(torch, gen, k, act, SPEC_OFFSETS,
                                              tier=kvc.FP8 if fp8 else None)
                for paged in (False, True):
                    c = paged_copy(torch, cache, 32, shuffle_seed=k) if paged else cache
                    kern = forms[(paged, fp8)]
                    label = f"{kern.symbol} as the verify chunk, K {k}, {str(act)[6:]}"
                    before = [as_bytes(t).clone() for t in c]
                    n0 = kern.launches
                    got = fp.flash_prefill_attention(q, kk, vv, c, valid, rope_theta=theta)
                    torch.cuda.synchronize()
                    check(kern.launches == n0 + 1, f"{label}: not one launch of its own")
                    ref = fp.flash_prefill_attention(q, kk, vv, c, valid, rope_theta=theta,
                                                     impl="plain")
                    for name, a, b_ in zip(("o", "k_cast", "v_cast"), got, ref):
                        check(fp8_equal(torch, a, b_),
                              f"{label}: {name} not bit-identical to plain: {max_err(a, b_)}")
                    check(all(torch.equal(x, as_bytes(t)) for x, t in zip(before, c)),
                          f"{label}: the cache changed")
                    n += 1
    print(f"verify chunk (kernel 3's chunked form, emit and no append): {n} cases (K "
          f"{list(SPEC_KS)} x f32 / bf16 activations x same / fp8 tiers x contiguous / paged "
          f"shuffled; offsets {SPEC_OFFSETS}, valid K / K-1 / 0) one launch each, o, k_cast "
          f"and v_cast bit-identical to plain, the cache unchanged")

    # (2) verify row j = the decode row of the same token, f32 tiers
    k, n = 4, 0
    lens = [0, 1, 28, 29, 31, 32, 60, 63, 96, 124]
    active = torch.ones(len(lens), dtype=torch.bool, device="cuda")
    full = torch.full((len(lens),), k, dtype=torch.int32, device="cuda")
    for hot in (32, 4):
        for paged in (False, True):
            q, kk, vv, cache = chunk_case(torch, gen, k, torch.float32, lens, hot=hot,
                                          cold=128 - hot)
            c = paged_copy(torch, cache, 32, shuffle_seed=hot) if paged else cache
            c = type(c)(*(t.clone() for t in c))
            o, k_c, _ = fp.flash_prefill_attention(q, kk, vv, c, full, rope_theta=theta)
            for j in range(k):
                o_j, k_rot = fd.flash_decode_attention(q[:, j], c, k_new=kk[:, j],
                                                       v_new=vv[:, j], active=active,
                                                       rope_theta=theta)
                check(torch.equal(o_j, o[:, j]) and torch.equal(k_rot, k_c[:, j]),
                      f"verify row {j} != the decode row (hot {hot}, paged {paged}): "
                      f"{max_err(o_j, o[:, j])}")
                kvc.append_decode(c, k_rot, vv[:, j], active=active)
                n += 1
    torch.cuda.synchronize()
    print(f"verify row = decode row: {n} rows (K {k}, f32, lengths {lens}, hot 32 / 4, "
          f"contiguous / paged shuffled): the chunk kernel's row j equals the fused decode "
          f"kernel's output after rows 0..j-1 were appended, bit for bit")

    # (3) kernel 2 at the draft's shape
    lengths = [0, 1, 31, 32, 33, 127]
    act = torch.tensor([False, True, True, True, True, True], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype, d=128)
        kw = dict(k_new=k_new, v_new=v_new, active=act, rope_theta=theta)
        n0 = fd.KERNEL.launches
        o, k_rot = fd.flash_decode_attention(q, cache, **kw)
        torch.cuda.synchronize()
        o_p, k_rot_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
        check(fd.KERNEL.launches == n0 + 1 and torch.isfinite(o).all()
              and torch.equal(o, o_p) and torch.equal(k_rot, k_rot_p),
              f"flash_decode_gqa_fused at the draft's shape ({dtype}): {max_err(o, o_p)}")
    q, cache, k_new, v_new = decode_case(torch, gen, [80] * 6, torch.float32, d=128)
    kw = dict(k_new=k_new, v_new=v_new, active=torch.ones(6, dtype=torch.bool, device="cuda"),
              rope_theta=theta)
    ms, _ = timed("kernel", lambda: fd.flash_decode_attention(q, cache, **kw), only=GQA_DECODE)
    print(f"flash_decode_gqa_fused at the draft's shape (h 8, g 4, d 128, rep 2; lengths "
          f"{lengths}, f32 / bf16): bit-identical to plain; {ms:.5f} ms at b 6, length 80 on "
          f"{smi}")

    # (4) kernels 2 and 3 at the derived draft's shape (make_draft_config,
    # the draft of mixtral-8x22b's speculative serve: 4 / 4 heads of 16)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype, h=4, g=4, d=16)
        kw = dict(k_new=k_new, v_new=v_new, active=act, rope_theta=theta)
        n0 = fd.KERNEL.launches
        o, k_rot = fd.flash_decode_attention(q, cache, **kw)
        torch.cuda.synchronize()
        o_p, k_rot_p = fd.flash_decode_attention(q, cache, impl="plain", **kw)
        check(fd.KERNEL.launches == n0 + 1 and torch.isfinite(o).all()
              and torch.equal(o, o_p) and torch.equal(k_rot, k_rot_p),
              f"flash_decode_gqa_fused at d 16, rep 1 ({dtype}): {max_err(o, o_p)}")
        for c in (SPEC_K, 32):  # a draft's verify-width chunk and a prefill wave
            q, kk, vv, cache = chunk_case(torch, gen, c, dtype, CHUNK_OFFSETS, h=4, g=4, d=16)
            valid = torch.tensor([c, c - 1, 0, c, 1, c, c][: len(CHUNK_OFFSETS)],
                                 dtype=torch.int32, device="cuda")
            chunk_matches_plain(torch, fp, q, kk, vv, cache, valid, theta,
                                f"d 16, rep 1, C {c}, {dtype}")
            n += 1
    print(f"kernels 2 and 3 at the derived draft's shape (h 4, g 4, d 16, rep 1): the fused "
          f"decode (lengths {lengths}) and {n} chunked-form cases (C {SPEC_K} / 32, offsets "
          f"{CHUNK_OFFSETS}, f32 / bf16) bit-identical to plain, one launch each")


# ---------------------------------------------------------------------------
# the LoRA kernel: the adapter delta in a sum order fixed per row
# ---------------------------------------------------------------------------

LORA_SHAPES = ((2048, 1024), (2048, 2048), (8192, 2048))  # lora_v, lora_o, lora_down (K, N)
LORA_ROWS = (1, 6, 192, 576)  # decode, chunk wave (6 x 32), grouped admission (6 x 96)


def rows_against_one(torch, fn, x, ms=(2, 6, 32, 192, 576)):
    """For each M, how many of the first 8 rows of ``fn(x[:M])`` differ from
    the same rows computed one at a time (M = 1)."""
    one = torch.cat([fn(x[i:i + 1]) for i in range(8)])
    return {m: int((fn(x[:m])[:8] != one[: min(m, 8)]).any(dim=-1).sum()) for m in ms}


def m_dependence(torch, gen):
    """Why the LoRA products and rms_norm run in kernels of their own, the
    lm_head at a fixed M and the MoE router in a fixed order: on the card
    the rows of an f32 cuBLAS GEMM and of PyTorch's row reduction change
    with the number of rows; the kernels' rows and the router's do not
    (checked; the rest is reported)."""
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.models.moe import router_logits

    x = torch.randn((576, 2048), generator=gen, device="cuda")
    w = torch.randn((2048, 131072), generator=gen, device="cuda") * 2048 ** -0.5
    a = torch.randn((2048, 16), generator=gen, device="cuda") * 0.25
    b = torch.randn((16, 1024), generator=gen, device="cuda") * 0.02
    ln = torch.ones((2048,), device="cuda")

    def torch_rms(t):  # the port's rms_norm before its kernel: PyTorch's mean
        return t * torch.rsqrt((t * t).mean(dim=-1, keepdim=True) + 1e-6) * ln

    # mixtral-8x22b's router: d_model 6144 onto 8 experts
    xr = torch.randn((576, 6144), generator=gen, device="cuda")
    wr = torch.randn((6144, 8), generator=gen, device="cuda") * 6144 ** -0.5
    for label, fn, xx in (("lm_head x @ W (2048 x 131072)", lambda t: t @ w, x),
                          ("LoRA x @ A (2048 x 16)", lambda t: t @ a, x),
                          ("PyTorch rms_norm (2048)", torch_rms, x),
                          ("router x @ W (6144 x 8)", lambda t: t @ wr, xr)):
        print(f"rows differing from M = 1, by M: {label}: {rows_against_one(torch, fn, xx)}")
    for label, fn, xx in (("LoRA kernel", lambda t: kl.lora_delta(t, a, b, 2.0), x),
                          ("rms_norm kernel", lambda t: krms.rms_norm(t, ln), x),
                          ("router_logits", lambda t: router_logits(t, wr), xr)):
        rows = rows_against_one(torch, fn, xx)
        print(f"rows differing from M = 1, by M: {label}: {rows}")
        check(not any(rows.values()), f"{label}: rows depend on M: {rows}")
    del w


def lora_phase(torch, gen, smi):
    """The LoRA kernel at falcon3-1b's three adapter shapes, rank 16: equal
    to its plain version bit for bit at M = 1, 6, 192 and 576 in f32 and
    bf16; row i of an M = 576 launch equal to row i launched alone; one
    decode step's 54 launches (18 layers x 3 adapters at M = 6) timed with
    the torch.matmul pair at the same shapes and the byte bound."""
    from repro_torch.kernels import lora as kl

    m_dependence(torch, gen)
    worst, n = 0.0, 0
    ops_by_shape = {}
    for k, nn in LORA_SHAPES:
        a = torch.randn((k, 16), generator=gen, device="cuda") * 0.25
        b = torch.randn((16, nn), generator=gen, device="cuda") * 0.02
        x = torch.randn((max(LORA_ROWS), k), generator=gen, device="cuda")
        ops_by_shape[(k, nn)] = (x[:6].contiguous(), a, b)
        for dtype in (torch.float32, torch.bfloat16):
            xs, as_, bs = (t.to(dtype) for t in (x, a, b))
            for m in LORA_ROWS:
                before = kl.KERNEL.launches
                got = kl.lora_delta(xs[:m], as_, bs, 2.0)
                want = kl.lora_delta(xs[:m], as_, bs, 2.0, impl="plain")
                torch.cuda.synchronize()
                check(kl.KERNEL.launches == before + 1, "lora_delta: not one launch")
                worst = max(worst, max_err(got, want))
                check(torch.equal(got, want), f"lora_delta not bit-identical to plain (K {k}, "
                                              f"N {nn}, M {m}, {dtype}): {max_err(got, want)}")
                n += 1
        full = kl.lora_delta(x, a, b, 2.0)
        rows = torch.cat([kl.lora_delta(x[i:i + 1], a, b, 2.0) for i in range(x.shape[0])])
        torch.cuda.synchronize()
        check(torch.equal(full, rows), f"lora_delta rows depend on M (K {k}, N {nn}): "
                                       f"{max_err(full, rows)}")
    print(f"lora_delta: bit-identical to plain on {n} cases (falcon3-1b's lora_v / lora_o / "
          f"lora_down, rank 16, M {LORA_ROWS}, f32 and bf16); every row of an M = 576 launch "
          f"equal to the same row launched alone")
    router_through_lora(torch, gen)

    def step(fn):
        def run():
            for _ in range(18):
                for x, a, b in ops_by_shape.values():
                    fn(x, a, b)
        return run

    print("LoRA deltas of one falcon3-1b decode step (18 layers x 3 adapters, M = 6, f32):")
    ms, _ = timed("kernel", step(lambda x, a, b: kl.lora_delta(x, a, b, 2.0)), only="lora_kernel")
    plain_ms, _ = timed("plain", step(lambda x, a, b: kl.lora_delta(x, a, b, 2.0, impl="plain")),
                        iters=3)
    b2 = {key: (x, a, b * 2.0) for key, (x, a, b) in ops_by_shape.items()}
    library_ms, _ = timed("torch.matmul pair", lambda: [
        torch.matmul(torch.matmul(x, a), b) for _ in range(18) for x, a, b in b2.values()])
    n_bytes = 18 * sum(4 * (6 * k + 16 * k + 16 * nn + 6 * nn) for k, nn in LORA_SHAPES)
    ops = 18 * sum(2 * 6 * 16 * (k + nn) for k, nn in LORA_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"lora_delta per decode step (54 launches, M = 6, f32): kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, torch.matmul pair {library_ms:.5f} ms, bound {b_ms:.6f} ms by "
          f"{b_by} ({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(name="lora_delta", route="cuda", source="src/repro_torch/csrc/lora.cu",
                replaces="src/repro/core/lora.py:64", max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


def router_through_lora(torch, gen):
    """The MoE router's logits through the LoRA kernel (the identity as its
    second factor, models/moe.py ``router_logits``): bit-identical to the
    plain version at mixtral-8x22b's 6144 -> 8 and DeepSeek-V3's 7168 ->
    256 (eight launches of 32 columns), at a decode step's M 4, a chunk
    wave's 1024 and the 4200-token admission; mixtral's timed at M 4 and
    4200 beside the f32 torch.matmul."""
    from repro_torch.kernels import lora as kl
    from repro_torch.models.moe import router_logits

    for d, n_e in ((6144, 8), (7168, 256)):
        w = torch.randn((d, n_e), generator=gen, device="cuda") * d ** -0.5
        for m in (4, 1024, 4200):
            h = torch.randn((m, d), generator=gen, device="cuda")
            before = kl.KERNEL.launches
            got = router_logits(h, w)
            want = router_logits(h, w, impl="plain")
            torch.cuda.synchronize()
            check(kl.KERNEL.launches == before + -(-n_e // kl.MAX_RANK),
                  "router_logits: not one launch per 32 experts")
            check(torch.equal(got, want), f"router_logits not bit-identical to plain (d {d}, "
                                          f"E {n_e}, M {m}): {max_err(got, want)}")
            if n_e == 8 and m in (4, 4200):
                t, _ = timed(f"router kernel M={m}", lambda: router_logits(h, w),
                             only="lora_kernel")
                lib = time_ms(lambda: h @ w)
                print(f"router_logits mixtral-8x22b M={m}: kernel {t:.5f} ms, f32 torch.matmul "
                      f"{lib:.5f} ms")
    print("router_logits: bit-identical to plain at 6144 -> 8 and 7168 -> 256, M 4 / 1024 / "
          "4200")


def rms_norm_phase(torch, gen, smi):
    """The rms_norm kernel at falcon3-1b's width and DeepSeek-V3's (d_model,
    q and kv ranks): equal to its plain version bit for bit at M = 1, 6, 192
    and 576, x and w in f32 and bf16; one falcon3-1b decode step's 37 norms
    (2 a layer and the final one, M = 6) timed with F.rms_norm and the byte
    bound."""
    from repro_torch.kernels import rms_norm as krms

    n = 0
    for d in (2048, 7168, 1536, 512):
        x = torch.randn((576, d), generator=gen, device="cuda") * 3.0
        w = 1 + 0.1 * torch.randn((d,), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            for wdtype in (torch.float32, torch.bfloat16):
                for m in LORA_ROWS:
                    xs, ws = x[:m].to(dtype), w.to(wdtype)
                    before = krms.KERNEL.launches
                    got = krms.rms_norm(xs, ws, 1e-6)
                    want = krms.rms_norm(xs, ws, 1e-6, impl="plain")
                    torch.cuda.synchronize()
                    check(krms.KERNEL.launches == before + 1, "rms_norm: not one launch")
                    check(torch.equal(got, want), f"rms_norm not bit-identical to plain (D {d}, "
                                                  f"M {m}, {dtype}, w {wdtype}): "
                                                  f"{max_err(got, want)}")
                    n += 1
    print(f"rms_norm: bit-identical to plain on {n} cases (D 2048 / 7168 / 1536 / 512, M "
          f"{LORA_ROWS}, x and w in f32 / bf16)")
    x = torch.randn((6, 2048), generator=gen, device="cuda")
    w = 1 + 0.1 * torch.randn((2048,), generator=gen, device="cuda")

    def step(fn):
        return lambda: [fn() for _ in range(37)]

    print("rms_norm of one falcon3-1b decode step (37 norms, M = 6, D = 2048, f32):")
    ms, _ = timed("kernel", step(lambda: krms.rms_norm(x, w, 1e-6)), only="rms_norm_kernel")
    plain_ms, _ = timed("plain", step(lambda: krms.rms_norm(x, w, 1e-6, impl="plain")), iters=5)
    library_ms, _ = timed("F.rms_norm", step(
        lambda: torch.nn.functional.rms_norm(x, (2048,), w, 1e-6)))
    n_bytes = 37 * 4 * (2 * 6 * 2048 + 2048)
    ops = 37 * 4 * 6 * 2048
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"rms_norm per decode step (37 launches, M = 6, f32): kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, F.rms_norm {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(name="rms_norm", route="cuda", source="src/repro_torch/csrc/rms_norm.cu",
                replaces="src/repro/models/layers.py:12", max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# the paged forms of kernels 2, 6 and 3 (A1b, A2a, A3b)
# ---------------------------------------------------------------------------

PAGED_DECODE = "gqa_decode_paged_kernel"  # profiler key of both paged decode forms
PAGED_CHUNK = "chunk_paged_kernel"


def paged_copy(torch, cache, ps, shuffle_seed=None):
    """A ``PagedKVCache`` on the card holding ``cache``'s content: slot b's
    cold rows in pool pages b * pps + j (rows past the tier NaN) and one
    spare page, re-addressed through a seeded page permutation when
    ``shuffle_seed`` is given."""
    import numpy as np

    from repro_torch.core import kv_cache as kvc

    b, cold = cache.cold_k.shape[:2]
    pps = -(-cold // ps)
    n_pages = b * pps + 1
    pools = []
    for src in (cache.cold_k, cache.cold_v):  # built in f32 (exact), then in the tier dtype
        pool = torch.full((n_pages, ps) + tuple(src.shape[2:]), float("nan"), device=src.device)
        pad = torch.nn.functional.pad(src.float(), (0, 0, 0, 0, 0, pps * ps - cold),
                                      value=float("nan"))
        pool[: b * pps] = pad.reshape((b * pps, ps) + tuple(src.shape[2:]))
        pools.append(kvc.to_tier(pool, src.dtype))
    table = (torch.arange(b, device=src.device)[:, None] * pps
             + torch.arange(pps, device=src.device)[None]).to(torch.int32)
    if shuffle_seed is not None:
        perm = np.random.default_rng(shuffle_seed).permutation(n_pages)
        inv = torch.as_tensor(np.argsort(perm), device=src.device)
        pools = [p[inv] for p in pools]
        table = torch.as_tensor(perm, dtype=torch.int32, device=src.device)[table.long()]
    return kvc.PagedKVCache(cache.hot_k, cache.hot_v, pools[0], pools[1], table,
                            cache.lengths.clone())


def paged_variants(torch, cache):
    """(label, paged cache) over identity and shuffled tables at page size
    32 and 48 (a page that is not one key tile)."""
    return [(f"ps {ps}, {'shuffled' if sh is not None else 'identity'}",
             paged_copy(torch, cache, ps, sh)) for ps in (32, 48) for sh in (None, ps)]


def paged_timing(torch, name, paged_fn, cont_fn, plain_fn, library_fn, only, cont_only,
                 n_bytes, ops, smi):
    """Kernel, its contiguous form in the same call (contiguous, paged,
    paged, contiguous), plain, library and the bound of one paged form."""
    print(f"{name}:")
    c1, _ = timed("contiguous kernel", cont_fn, only=cont_only)
    ms, _ = timed("paged kernel", paged_fn, only=only)
    ms2, _ = timed("paged kernel again", paged_fn, only=only)
    c2, _ = timed("contiguous kernel again", cont_fn, only=cont_only)
    plain_ms, _ = timed("plain", plain_fn, iters=5)
    library_ms, _ = timed("library", library_fn)
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    ms = (ms + ms2) / 2
    print(f"{name}: paged kernel {ms:.5f} ms (contiguous {(c1 + c2) / 2:.5f}), plain "
          f"{plain_ms:.5f} ms, library {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(ms=ms, contiguous_ms=(c1 + c2) / 2, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=b_by)


def decode_sdpa(torch, q, cache, length, pend=None):
    """SDPA over a decode case's valid rows (and the pending token), k / v
    expanded to the query heads."""
    h, g = q.shape[1], cache.hot_k.shape[2]
    pk, pv = ([pend[0][:, None]], [pend[1][:, None]]) if pend else ([], [])
    kk = torch.cat([cache.hot_k, cache.cold_k[:, : length - 32]] + pk, 1)
    vv = torch.cat([cache.hot_v, cache.cold_v[:, : length - 32]] + pv, 1)
    kh = kk.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    vh = vv.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(q[:, :, None], kh, vh)


def paged_decode_phase(torch, gen, theta, smi, fused):
    """A1b (``fused``: kernel 2's paged form) or A2a (kernel 6's): at
    falcon3-1b's heads over hot 32 / cold 96 at lengths 0-128 (NaN past
    each), f32 and bf16, identity and shuffled tables at page size 32 and
    48: equal to its plain version and to the contiguous kernel on the same
    content, bit for bit, one launch of its own entry point each; timed
    beside the contiguous form at b 6, length 80."""
    from repro_torch.kernels import flash_decode as fd

    kern, cont_kern = (fd.PAGED_KERNEL, fd.KERNEL) if fused else (fd.GQA_PAGED_KERNEL,
                                                                  fd.GQA_KERNEL)
    lengths = [0, 1, 31, 32, 33, 80, 127, 128] if not fused else [0, 1, 31, 32, 33, 80, 127]
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype, b=len(lengths))
        active = torch.tensor([False] + [True] * (len(lengths) - 1), device="cuda")
        kw = dict(k_new=k_new, v_new=v_new, active=active, rope_theta=theta) if fused else {}
        want_c = fd.flash_decode_attention(q, cache, **kw)
        for label, paged in paged_variants(torch, cache):
            before = (kern.launches, cont_kern.launches)
            got = fd.flash_decode_attention(q, paged, **kw)
            torch.cuda.synchronize()
            check((kern.launches, cont_kern.launches) == (before[0] + 1, before[1]),
                  f"{kern.symbol}: not one launch of its own ({label})")
            want = fd.flash_decode_attention(q, paged, impl="plain", **kw)
            for x, y, z, part in zip(*(t if fused else (t,) for t in (got, want, want_c)),
                                     ("o", "k_rot")):
                worst = max(worst, max_err(x, y))
                check(torch.equal(x, y), f"{kern.symbol} {part} not bit-identical to plain "
                                         f"({label}, {dtype}): {max_err(x, y)}")
                check(torch.equal(x, z), f"{kern.symbol} {part} differs from the contiguous "
                                         f"kernel ({label}, {dtype}): {max_err(x, z)}")
            n += 1
    print(f"{kern.symbol}: bit-identical to plain and to {cont_kern.symbol} on {n} cases "
          f"(f32 / bf16 x page size 32 / 48 x identity / shuffled tables; lengths {lengths}, "
          f"NaN past each), one launch of its own entry point each")
    b, h, g, d, length = 6, 8, 4, 256, 80
    q, cache, k_new, v_new = decode_case(torch, gen, [length] * b, torch.float32)
    paged = paged_copy(torch, cache, 32, shuffle_seed=1)
    kw = dict(k_new=k_new, v_new=v_new, active=torch.ones(b, dtype=torch.bool, device="cuda"),
              rope_theta=theta) if fused else {}
    # as the contiguous form's bound, plus the page table's (b, pps) int32
    n_bytes = b * h * d * 4 + b * length * g * d * 4 * 2 + 4 * b + b * h * d * 4 + b * 3 * 4
    if fused:
        n_bytes += 2 * b * g * d * 4 + 4 * b + b * d * 4 + b * g * d * 4
    t = paged_timing(
        torch, f"{kern.symbol} (b 6, length {length}, page size 32, shuffled, f32)",
        lambda: fd.flash_decode_attention(q, paged, **kw),
        lambda: fd.flash_decode_attention(q, cache, **kw),
        lambda: fd.flash_decode_attention(q, paged, impl="plain", **kw),
        decode_sdpa(torch, q, cache, length, (k_new, v_new) if fused else None),
        PAGED_DECODE, GQA_DECODE, n_bytes, 4 * b * h * (length + int(fused)) * d, smi)
    ref_line = "src/repro/kernels/flash_decode.py:481" if fused else \
        "src/repro/kernels/flash_decode.py:402"
    return dict(name=kern.symbol, route="cuda", source="src/repro_torch/csrc/flash_decode.cuh",
                replaces=ref_line, max_abs_err=worst, **t)


def paged_chunk_phase(torch, gen, theta, smi):
    """A3b (kernel 3's paged chunked form): falcon3-1b's wave shape (h 8, g
    4, d 256, C 32) at offsets 0-96 with every valid count, f32 and bf16,
    identity and shuffled tables at page size 32 and 48: o, k_cast and
    v_cast equal to the plain version and to the contiguous chunk kernel,
    bit for bit, one launch of its own entry point each; timed beside the
    contiguous form at b 6, C 32, offset 96."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models.layers import apply_rope

    kern, cont_kern = fp.CHUNK_PAGED_KERNEL, fp.CHUNK_KERNEL
    worst, n, c = 0.0, 0, 32
    offs = [0, 5, 31, 32, 33, 64, 70, 96]
    valid = torch.tensor([32, 1, 27, 0, 32, 32, 26, 32], dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, cache = chunk_case(torch, gen, c, dtype, offs)
        want_c = fp.flash_prefill_attention(q, k, v, cache, valid, rope_theta=theta)
        for label, paged in paged_variants(torch, cache):
            before = (kern.launches, cont_kern.launches)
            got = fp.flash_prefill_attention(q, k, v, paged, valid, rope_theta=theta)
            torch.cuda.synchronize()
            check((kern.launches, cont_kern.launches) == (before[0] + 1, before[1]),
                  f"{kern.symbol}: not one launch of its own ({label})")
            want = fp.flash_prefill_attention(q, k, v, paged, valid, rope_theta=theta,
                                              impl="plain")
            for part, x, y, z in zip(("o", "k_cast", "v_cast"), got, want, want_c):
                worst = max(worst, max_err(x, y))
                check(torch.equal(x, y), f"{kern.symbol} {part} not bit-identical to plain "
                                         f"({label}, {dtype}): {max_err(x, y)}")
                check(torch.equal(x, z), f"{kern.symbol} {part} differs from the contiguous "
                                         f"kernel ({label}, {dtype}): {max_err(x, z)}")
            n += 1
    print(f"{kern.symbol}: o, k_cast and v_cast bit-identical to plain and to "
          f"{cont_kern.symbol} on {n} cases (f32 / bf16 x page size 32 / 48 x identity / "
          f"shuffled; C 32 at offsets {offs}, NaN past each length), one launch each")
    b, h, g, d, off = 6, 8, 4, 256, 96
    q, k, v, cache = chunk_case(torch, gen, c, torch.float32, [off] * b)
    paged = paged_copy(torch, cache, 32, shuffle_seed=2)
    pos = off + torch.arange(c, device="cuda")[None].expand(b, -1)
    qh = apply_rope(q, pos, theta).permute(0, 2, 1, 3).contiguous()
    kk = torch.cat([cache.hot_k, cache.cold_k[:, : off - 32], apply_rope(k, pos, theta)], 1)
    vv = torch.cat([cache.hot_v, cache.cold_v[:, : off - 32], v], 1)
    kh = kk.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    vh = vv.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    mask = (off + torch.arange(c, device="cuda"))[:, None] >= torch.arange(off + c, device="cuda")
    # as the contiguous chunked form's bound, plus the page table
    n_bytes = 4 * (2 * b * c * h * d + 4 * b * c * g * d + 2 * b * off * g * d) + 8 * b + 4 * b * 3
    ops = 4 * b * h * d * (c * off + c * (c + 1) // 2)
    t = paged_timing(
        torch, f"{kern.symbol} (b 6, C {c}, offset {off}, page size 32, shuffled, f32)",
        lambda: fp.flash_prefill_attention(q, k, v, paged, rope_theta=theta),
        lambda: fp.flash_prefill_attention(q, k, v, cache, rope_theta=theta),
        lambda: fp.flash_prefill_attention(q, k, v, paged, rope_theta=theta, impl="plain"),
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        PAGED_CHUNK, "gqa_chunk_kernel", n_bytes, ops, smi)
    return dict(name=kern.symbol, route="cuda", source="src/repro_torch/csrc/flash_prefill.cuh",
                replaces="src/repro/kernels/flash_prefill.py:258", max_abs_err=worst, **t)


# ---------------------------------------------------------------------------
# kernels 2 and 3 over the sliding-window ring (A1d, A3c): mixtral-8x22b
# ---------------------------------------------------------------------------

RING_DECODE = "gqa_decode_ring_kernel"  # profiler keys of the SWA forms
WINDOW_PREFILL = "gqa_window_kernel"
CHUNK_RING = "gqa_chunk_ring_kernel"
SWA_SHAPES = ((48, 8, 128), (8, 4, 256))  # (h, g, d): mixtral-8x22b's, falcon3-1b's


def window_live(q_pos, k_lo, k_hi, window):
    """Key-row pairs a causal window attends: rows at positions ``q_pos``
    see the keys of [max(k_lo, p - window + 1), min(k_hi, p + 1))."""
    return sum(max(min(k_hi, p + 1) - max(k_lo, p - window + 1), 0) for p in q_pos)


def ring_lengths(cold):
    """Slot lengths and activity of the ring cases: empty (inactive),
    before, at and past the wrap, window starts (length - cold + 1)
    unaligned (cold + 1, 3 cold + 5) and aligned to 32 (cold + 31, 2 cold
    + 63), an inactive wrapped slot."""
    import torch

    lengths = [0, cold - 1, cold, cold + 1, cold + 31, 3 * cold + 5, cold + 2, 2 * cold + 63]
    active = torch.tensor([False, True, True, True, True, True, False, True], device="cuda")
    return lengths, active


def one_row_ring_chunk(torch, fp, q, cache, k_new, v_new, active, theta):
    """Each slot's row of the one-row ring chunk, on the kernel (kernel 3's
    chunked ring form, A3c, at C = 1 with its emit and no append): an
    active slot's at window = the ring's width, an inactive one's at valid
    0 and no window (every ring row: the reference's rule for a slot that
    appends nothing) -> (b, h, d)."""
    args = (q[:, None], k_new[:, None], v_new[:, None], cache)
    o_act = fp.flash_prefill_attention(*args, valid=active.to(torch.int32),
                                       window=cache.cold_cap, ring=True, rope_theta=theta)[0]
    o_idle = fp.flash_prefill_attention(*args, valid=torch.zeros_like(active, dtype=torch.int32),
                                        ring=True, rope_theta=theta)[0]
    return torch.where(active[:, None, None], o_act[:, 0], o_idle[:, 0])


def ring_decode_phase(torch, gen, theta, smi):
    """A1d, the ring form of the fused GQA decode, which folds absolute
    32-key tiles: o and k_rot bit-identical to its plain version, and o to
    the one-row ring chunk kernel's row (``one_row_ring_chunk``), at
    mixtral-8x22b's heads (rep 6, d 128) and falcon3-1b's (rep 2, d 256),
    rings of 64 and 4096 rows, the lengths of ``ring_lengths`` (before, at
    and past the wrap, window starts aligned and unaligned to 32, inactive
    slots), f32 and bf16, NaN past each length; the post-append form over
    the same rings too. Held bit for bit and timed at b 4, h 48, g 8, d 128
    over a wrapped 4096-row ring (f32) beside SDPA with the evictee masked
    out."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp

    worst, n = 0.0, 0
    for h, g, d in SWA_SHAPES:
        for cold in (64, 4096):
            lengths, active = ring_lengths(cold)
            for dtype in (torch.float32, torch.bfloat16):
                q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype, b=len(lengths),
                                                     h=h, g=g, d=d, hot=0, cold=cold)
                kw = dict(k_new=k_new, v_new=v_new, active=active, rope_theta=theta)
                before = fd.RING_KERNEL.launches
                o, k_rot = fd.flash_decode_attention_ring(q, cache, **kw)
                torch.cuda.synchronize()
                check(fd.RING_KERNEL.launches == before + 1, "ring decode: not one launch")
                o_p, k_p = fd.flash_decode_attention_ring(q, cache, impl="plain", **kw)
                post = fd.flash_decode_attention_ring(q, cache)
                post_p = fd.flash_decode_attention_ring(q, cache, impl="plain")
                row = one_row_ring_chunk(torch, fp, q, cache, k_new, v_new, active, theta)
                torch.cuda.synchronize()
                check(torch.isfinite(o).all() and torch.isfinite(post).all(),
                      "ring decode output not finite (read a masked row?)")
                worst = max(worst, max_err(o, o_p), max_err(post, post_p))
                check(torch.equal(o, o_p) and torch.equal(k_rot, k_p),
                      f"ring decode not bit-identical to plain (h {h}, d {d}, ring {cold}, "
                      f"{dtype}): {max_err(o, o_p)}")
                check(torch.equal(o, row), f"ring decode row != the one-row ring chunk kernel's "
                                           f"(h {h}, d {d}, ring {cold}, {dtype}): "
                                           f"{max_err(o, row)}")
                check(torch.equal(post, post_p), f"post-append decode over the ring (ring {cold})"
                      f" not bit-identical: {max_err(post, post_p)}")
                n += 1
    print(f"{fd.RING_KERNEL.symbol}: o and k_rot bit-identical to plain and o to the one-row "
          f"ring chunk kernel's row on {n} cases (h/g/d {SWA_SHAPES}, rings 64 / 4096, lengths "
          f"{ring_lengths(64)[0]} at ring 64, window starts aligned and not, inactive slots, "
          f"f32 / bf16); the post-append form over the same rings too")
    b, (h, g, d), cold = 4, SWA_SHAPES[0], 4096
    length = cold + 80
    q, cache, k_new, v_new = decode_case(torch, gen, [length] * b, torch.float32, b=b, h=h, g=g,
                                         d=d, hot=0, cold=cold)
    act = torch.ones(b, dtype=torch.bool, device="cuda")
    kw = dict(k_new=k_new, v_new=v_new, active=act, rope_theta=theta)
    o, k_rot = fd.flash_decode_attention_ring(q, cache, **kw)
    o_p, k_p = fd.flash_decode_attention_ring(q, cache, impl="plain", **kw)
    torch.cuda.synchronize()
    worst = max(worst, max_err(o, o_p))
    check(torch.equal(o, o_p) and torch.equal(k_rot, k_p),
          f"ring decode not bit-identical at the timed case: {max_err(o, o_p)}")
    print(f"{fd.RING_KERNEL.symbol} at b {b}, h {h}, g {g}, d {d}, ring {cold}, length {length}: "
          f"o and k_rot bit-identical to plain")
    ms, _ = timed("kernel", lambda: fd.flash_decode_attention_ring(q, cache, **kw),
                  only=RING_DECODE)
    plain_ms, _ = timed("plain", lambda: fd.flash_decode_attention_ring(q, cache, impl="plain",
                                                                         **kw), iters=3)
    # SDPA over the ring rows and the pending token (rotated as the kernel
    # does), the evictee masked out
    from repro_torch.models.layers import apply_rope

    q_rot = apply_rope(q[:, None], cache.lengths.long()[:, None], theta)[:, 0]
    kk = torch.cat([cache.cold_k, k_rot[:, None]], 1).permute(0, 2, 1, 3)
    vv = torch.cat([cache.cold_v, v_new[:, None]], 1).permute(0, 2, 1, 3)
    kh = kk.repeat_interleave(h // g, dim=1).contiguous()
    vh = vv.repeat_interleave(h // g, dim=1).contiguous()
    mask = torch.ones((b, 1, 1, cold + 1), dtype=torch.bool, device="cuda")
    mask[:, :, :, (length % cold)] = False
    library_ms, _ = timed("SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
        q_rot[:, :, None], kh, vh, attn_mask=mask))
    # q, the ring rows the window still needs (every row but the evictee),
    # k_new, v_new, lengths, active, the cos / sin tables; o and k_rot
    rows = cold - 1
    n_bytes = (b * h * d * 4 + b * rows * g * d * 4 * 2 + 2 * b * g * d * 4 + 8 * b
               + b * d * 4 + b * h * d * 4 + b * g * d * 4)
    ops = 4 * b * h * (rows + 1) * d
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"{fd.RING_KERNEL.symbol} (b {b}, wrapped ring {cold}, f32): kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(name=fd.RING_KERNEL.symbol, route="cuda",
                source="src/repro_torch/csrc/flash_decode.cuh",
                replaces="src/repro/kernels/flash_decode.py:481", max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def qkv_case(torch, gen, b, s, h, g, d, dtype):
    return tuple(torch.randn(sh, generator=gen, device="cuda").to(dtype)
                 for sh in ((b, s, h, d), (b, s, g, d), (b, s, g, d)))


def window_sdpa(torch, q, k, v, q_pos, k_pos, k_ok, window, theta, h, g):
    """SDPA over rotated q / keys with the causal window as an explicit
    mask; keys given rotated, ``k_ok`` (b, S) the keys that exist."""
    from repro_torch.models.layers import apply_rope

    qr = apply_rope(q.float(), q_pos, theta).permute(0, 2, 1, 3)  # (b, h, s, d)
    kh = k.float().permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    vh = v.float().permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
    dq = q_pos[:, :, None] - k_pos[:, None, :]  # (b, s, S)
    mask = ((dq >= 0) & (dq < window) & k_ok[:, None, :])[:, None]
    return lambda: torch.nn.functional.scaled_dot_product_attention(qr, kh, vh, attn_mask=mask)


def window_prefill_phase(torch, gen, theta, smi):
    """A3c, fresh: ``flash_prefill_window`` against its plain version, o,
    k_cast and v_cast bit for bit, at mixtral-8x22b's heads and
    falcon3-1b's, s / window 40 / 8, 300 / 256 and 700 / 512, valid s, a
    part and 0, f32 and bf16. Timed at one 4200-token prompt under the
    4096 window (mixtral-8x22b's admission past its window), held bit for
    bit there too, beside SDPA with the window as an explicit mask."""
    from repro_torch.kernels import flash_prefill as fp

    worst, n = 0.0, 0
    for h, g, d in SWA_SHAPES:
        for s, window in ((40, 8), (300, 256), (700, 512)):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv_case(torch, gen, 3, s, h, g, d, dtype)
                valid = torch.tensor([s, s // 2 + 3, 0], dtype=torch.int32, device="cuda")
                before = fp.WINDOW_KERNEL.launches
                got = fp.flash_prefill_attention(q, k, v, valid=valid, window=window,
                                                 rope_theta=theta)
                want = fp.flash_prefill_attention(q, k, v, valid=valid, window=window,
                                                  rope_theta=theta, impl="plain")
                torch.cuda.synchronize()
                check(fp.WINDOW_KERNEL.launches == before + 1, "window prefill: not one launch")
                worst = max(worst, max_err(got[0], want[0]))
                check(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
                      f"window prefill not bit-identical (h {h}, d {d}, s {s}, window {window}, "
                      f"{dtype}): {max_err(got[0], want[0])}")
                n += 1
    print(f"{fp.WINDOW_KERNEL.symbol}: o, k_cast, v_cast bit-identical to plain on {n} cases")
    b, (h, g, d), s, window = 1, SWA_SHAPES[0], 4200, 4096
    q, k, v = qkv_case(torch, gen, b, s, h, g, d, torch.float32)
    valid = torch.full((b,), s, dtype=torch.int32, device="cuda")
    run = lambda impl: fp.flash_prefill_attention(q, k, v, valid=valid, window=window,  # noqa: E731
                                                  rope_theta=theta, impl=impl)
    got, want = run("auto"), run("plain")  # the plain call is its timing's warm-up too
    torch.cuda.synchronize()
    worst = max(worst, max_err(got[0], want[0]))
    check(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
          f"window prefill not bit-identical at s {s}, window {window}: "
          f"{max_err(got[0], want[0])}")
    print(f"{fp.WINDOW_KERNEL.symbol} at b {b}, s {s}, window {window}, h {h}, g {g}, d {d}: "
          f"o, k_cast, v_cast bit-identical to plain")
    ms, _ = timed("kernel", lambda: run("auto"), only=WINDOW_PREFILL, iters=5)
    plain_ms = time_ms(lambda: run("plain"), iters=1, warmup=0)
    print(f"  plain: CUDA events {plain_ms:.5f} ms per call")
    pos = torch.arange(s, device="cuda")[None]
    k_c = got[1]
    del want
    library_ms, _ = timed("SDPA", window_sdpa(torch, q, k_c, v, pos, pos,
                                              torch.ones((b, s), dtype=torch.bool, device="cuda"),
                                              window, theta, h, g), iters=5)
    # q, k, v, valid and the (s, d/2) cos / sin tables in; o, k_cast, v_cast out
    n_bytes = 4 * (b * s * h * d * 2 + 4 * b * s * g * d + s * d) + 4 * b
    ops = 4 * h * d * b * window_live(range(s), 0, s, window)
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"{fp.WINDOW_KERNEL.symbol} (s {s}, window {window}, f32): kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(name=fp.WINDOW_KERNEL.symbol, route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cuh",
                replaces="src/repro/kernels/flash_prefill.py:258", max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


def ring_chunk_phase(torch, gen, theta, smi):
    """A3c, chunked over the ring: ``flash_prefill_chunk_ring`` against its
    plain version (o on valid rows, k_cast, v_cast bit for bit) at both
    head shapes, rings of 64 (C 16 and 48) and 4096 (C 256) with the
    window the ring's size, offsets 0, inside, just past and far past the
    wrap, valid C, C - 5, 0 and C / 2, f32 and bf16, NaN past each length;
    and f32 chunks of 48 over a ring of 64 equal to the fresh window
    kernel while the prompt wraps three times. Held bit for bit and timed
    at mixtral-8x22b's chunk wave (4 slots, C 256, offsets past the wrap)
    beside SDPA over the materialised keys with the window mask."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_prefill as fp

    worst, n = 0.0, 0
    for h, g, d in SWA_SHAPES:
        for cold, c in ((64, 16), (64, 48), (4096, 256)):
            lens = [0, cold - 5, cold + 3, 3 * cold + 1]
            for dtype in (torch.float32, torch.bfloat16):
                _, cache, _, _ = decode_case(torch, gen, lens, dtype, b=4, h=h, g=g, d=d, hot=0,
                                             cold=cold)
                q, k, v = qkv_case(torch, gen, 4, c, h, g, d, dtype)
                valid = torch.tensor([c, c - 5, 0, c // 2], dtype=torch.int32, device="cuda")
                kw = dict(valid=valid, window=cold, ring=True, rope_theta=theta)
                before = fp.CHUNK_RING_KERNEL.launches
                got = fp.flash_prefill_attention(q, k, v, cache, **kw)
                want = fp.flash_prefill_attention(q, k, v, cache, impl="plain", **kw)
                torch.cuda.synchronize()
                check(fp.CHUNK_RING_KERNEL.launches == before + 1, "ring chunk: not one launch")
                for i, nv in enumerate(valid.tolist()):
                    worst = max(worst, max_err(got[0][i, :nv], want[0][i, :nv]))
                    check(torch.equal(got[0][i, :nv], want[0][i, :nv]),
                          f"ring chunk o not bit-identical (h {h}, d {d}, ring {cold}, C {c}, "
                          f"{dtype}, slot {i})")
                check(torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]),
                      f"ring chunk k_cast / v_cast not bit-identical (ring {cold}, {dtype})")
                n += 1
    b, (h, g, d), s, w = 2, SWA_SHAPES[0], 200, 64
    q, k, v = qkv_case(torch, gen, b, s, h, g, d, torch.float32)
    o, k_c, _ = fp.flash_prefill_attention(q, k, v, window=w, rope_theta=theta)
    cache = kvc.init_cache(b, 0, w, (g, d), device="cuda")
    for c0 in range(0, s, 48):
        sl = slice(c0, c0 + 48)
        oc, kc, vc = fp.flash_prefill_attention(q[:, sl], k[:, sl], v[:, sl], cache, window=w,
                                                ring=True, rope_theta=theta)
        check(torch.equal(oc, o[:, sl]) and torch.equal(kc, k_c[:, sl]),
              f"ring chunks at offset {c0} differ from the fresh window kernel")
        kvc.append(cache, kc, vc, ring=True)
    print(f"{fp.CHUNK_RING_KERNEL.symbol}: o (valid rows), k_cast, v_cast bit-identical to plain "
          f"on {n} cases; f32 chunks of 48 over a ring of 64 equal the fresh window kernel")
    b, c, cold = 4, 256, 4096
    offs = [cold + 104, cold + 1000, 2 * cold + 7, 3 * cold + 300]
    _, cache, _, _ = decode_case(torch, gen, offs, torch.float32, b=b, h=h, g=g, d=d, hot=0,
                                 cold=cold)
    q, k, v = qkv_case(torch, gen, b, c, h, g, d, torch.float32)
    valid = torch.full((b,), c, dtype=torch.int32, device="cuda")
    kw = dict(valid=valid, window=cold, ring=True, rope_theta=theta)
    got = fp.flash_prefill_attention(q, k, v, cache, **kw)
    want = fp.flash_prefill_attention(q, k, v, cache, impl="plain", **kw)  # and warm-up
    torch.cuda.synchronize()
    worst = max(worst, max_err(got[0], want[0]))
    check(all(torch.equal(a, b_) for a, b_ in zip(got, want)),
          f"ring chunk not bit-identical at the timed wave: {max_err(got[0], want[0])}")
    print(f"{fp.CHUNK_RING_KERNEL.symbol} at b {b}, C {c}, ring {cold}, offsets {offs}: o, "
          f"k_cast, v_cast bit-identical to plain")
    ms, _ = timed("kernel", lambda: fp.flash_prefill_attention(q, k, v, cache, **kw),
                  only=CHUNK_RING, iters=5)
    plain_ms = time_ms(lambda: fp.flash_prefill_attention(q, k, v, cache, impl="plain", **kw),
                       iters=1, warmup=0)
    print(f"  plain: CUDA events {plain_ms:.5f} ms per call")
    k_c = got[1]
    del want
    off = cache.lengths.long()
    ring_pos = kvc.ring_slot_positions(off, cold).long()  # (b, cold)
    k_pos = torch.cat([ring_pos, off[:, None] + torch.arange(c, device="cuda")[None]], 1)
    keys = torch.cat([cache.cold_k, k_c], 1)
    vals = torch.cat([cache.cold_v, v], 1)
    q_pos = off[:, None] + torch.arange(c, device="cuda")[None]
    library_ms, _ = timed("SDPA", window_sdpa(torch, q, keys, vals, q_pos, k_pos, k_pos >= 0,
                                              cold, theta, h, g), iters=5)
    # the chunk's q, k, v, valid, lengths and (b, C, d/2) tables in, the ring
    # rows some row's window sees (all but the oldest of a wrapped ring) in,
    # o, k_cast and v_cast out
    n_bytes = (4 * (b * c * h * d * 2 + 4 * b * c * g * d + b * c * d) + 8 * b
               + 4 * 2 * g * d * b * (cold - 1))
    ops = 4 * h * d * sum(window_live(range(o, o + c), o - cold, o + c, cold) for o in offs)
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"{fp.CHUNK_RING_KERNEL.symbol} (b {b}, C {c}, ring {cold}, f32): kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms by {b_by} "
          f"({n_bytes} B, {ops} FLOP) on {smi}")
    return dict(name=fp.CHUNK_RING_KERNEL.symbol, route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cuh",
                replaces="src/repro/kernels/flash_prefill.py:258", max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)


# ---------------------------------------------------------------------------
# fp8 (e4m3) tiers: the fp8 forms of kernels 2, 3, 6 and 8 (A1c, A3d, A4a)
# ---------------------------------------------------------------------------

# the emit's boundary values: 448, past it to 464 (the tie, to 448), past
# that NaN; the infinities and NaN; a subnormal tie; -0.0
FP8_SWEEP = (448.0, 449.0, 464.0, 464.01, 480.0, float("inf"), float("-inf"), float("nan"),
             2.0 ** -10, 1.5 * 2.0 ** -9, -0.0)
ACTS = ("float32", "bfloat16")  # the activation dtypes every fp8 form is held in


def fp8_equal(torch, a, b):
    """Equal, fp8 tensors by their bytes (NaN != NaN)."""
    from repro_torch.core import kv_cache as kvc

    return torch.equal(kvc.raw(a), kvc.raw(b))


def fp8_matches_plain(torch, kern, run, label):
    """``run(impl)`` once on the kernel, which launches ``kern`` exactly
    once, and once on the plain version: every output equal (fp8 ones by
    their bytes). Returns the first output's max |diff|."""
    before = kern.launches
    got = run("auto")
    torch.cuda.synchronize()
    check(kern.launches == before + 1, f"{kern.symbol}: not one launch ({label})")
    want = run("plain")
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for i, (x, y) in enumerate(zip(got, want)):
        check(fp8_equal(torch, x, y), f"{kern.symbol} output {i} not bit-identical to plain "
                                      f"({label}): {max_err(x, y)}")
    return max_err(got[0], want[0])


def upcast(cache):
    """A cache's tiers in f32: the keys SDPA reads (the library yardstick)."""
    return type(cache)(*(t.float() for t in cache[:4]), *cache[4:])


def with_sweep(torch, v):
    """``v`` with its first elements replaced by FP8_SWEEP (in v's dtype)."""
    out = v.clone()
    flat = out.view(-1)
    flat[: len(FP8_SWEEP)] = torch.tensor(FP8_SWEEP, device=v.device).to(v.dtype)
    return out


def emit_sweep(torch, kern, run, v, valid, label):
    """The emitting form ``run(v)`` -> (o, k_cast, v_cast) with v rows
    carrying FP8_SWEEP: v_cast's bytes equal the plain ``to_tier`` of v
    (rows past ``valid`` zero)."""
    from repro_torch.core import kv_cache as kvc

    vs = with_sweep(torch, v)
    before = kern.launches
    got = run(vs)[2]
    torch.cuda.synchronize()
    check(kern.launches == before + 1, f"{kern.symbol}: not one launch (emit sweep, {label})")
    keep = torch.arange(v.shape[1], device="cuda")[None, :, None, None] < valid[:, None, None, None]
    want = kvc.to_tier(torch.where(keep, vs, torch.zeros_like(vs)), kvc.FP8)
    check(fp8_equal(torch, got, want), f"{kern.symbol}: emitted v bytes differ from to_tier "
                                       f"on the boundary sweep ({label})")


def fp8_row(kern, source, replaces, worst, t):
    return dict(name=kern.symbol, route="cuda", source=source, replaces=replaces,
                max_abs_err=worst, **t)


def fp8_decode_phase(torch, gen, theta, smi, form):
    """The fp8-tier forms of the GQA decode: A1c (``form`` "fused", "fused
    paged", "ring": kernel 2 over contiguous, paged and ring tiers) and
    kernel 6 ("post", "post paged"). Each bit-identical to its plain
    version, one launch of its own entry point, with f32 and bf16
    activations at the cases of its f32 form's phase (falcon3-1b's heads
    over hot 32 / cold 96, lengths 0-128 with NaN past each; paged: page
    size 32 / 48, identity / shuffled; ring: mixtral-8x22b's and
    falcon3-1b's heads, rings 64 / 4096 at ``ring_lengths``, and o equal
    to the one-row ring chunk kernel's row). Timed at its f32 form's case
    beside SDPA over the upcast rows, the bound counting 1-byte tiers."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.layers import apply_rope

    kern = {"fused": fd.FP8_KERNEL, "post": fd.FP8_GQA_KERNEL, "fused paged": fd.FP8_PAGED_KERNEL,
            "post paged": fd.FP8_GQA_PAGED_KERNEL, "ring": fd.FP8_RING_KERNEL}[form]
    fused, paged, ring = form != "post" and form != "post paged", "paged" in form, form == "ring"
    entry = fd.flash_decode_attention_ring if ring else fd.flash_decode_attention
    if ring:
        cases = [(8, h, g, d, 0, cold, ring_lengths(cold)[0])
                 for h, g, d in SWA_SHAPES for cold in (64, 4096)]
        active = ring_lengths(64)[1]
    else:
        cases = [(6, 8, 4, 256, 32, 96, [0, 1, 31, 32, 33, 127 if fused else 128])]
        active = torch.tensor([False] + [True] * 5, device="cuda")
    worst, n = 0.0, 0
    for b, h, g, d, hot, cold, lengths in cases:
        for dt in ACTS:
            q, cache, k_new, v_new = decode_case(torch, gen, lengths, getattr(torch, dt), b=b, h=h,
                                                 g=g, d=d, hot=hot, cold=cold,
                                                 tier_dtype=kvc.FP8)
            kw = dict(k_new=k_new, v_new=v_new, active=active, rope_theta=theta) if fused else {}
            variants = paged_variants(torch, cache) if paged else [("contiguous", cache)]
            for label, c in variants:
                worst = max(worst, fp8_matches_plain(
                    torch, kern, lambda impl: entry(q, c, impl=impl, **kw),
                    f"h {h}, d {d}, tiers {hot} / {cold}, {label}, {dt} activations"))
                n += 1
            if ring:  # the decoded row is the one-row ring chunk's (A3d's ring form)
                from repro_torch.kernels import flash_prefill as fp

                o = entry(q, cache, **kw)[0]
                row = one_row_ring_chunk(torch, fp, q, cache, k_new, v_new, active, theta)
                check(torch.equal(o, row), f"{kern.symbol} row != the one-row fp8 ring chunk "
                                           f"kernel's (h {h}, ring {cold}, {dt}): "
                                           f"{max_err(o, row)}")
    print(f"{kern.symbol}: bit-identical to plain on {n} cases (fp8 tiers, f32 / bf16 "
          f"activations), one launch of its own entry point each"
          + ("; o equal to the one-row fp8 ring chunk kernel's row on each" if ring else ""))

    # the timed case of the f32 form: falcon3-1b's b 6, length 80 (paged:
    # 32-row pages, shuffled); ring: b 4, h 48, g 8, d 128, a wrapped 4096 ring
    if ring:
        b, (h, g, d), hot, cold, length = 4, SWA_SHAPES[0], 0, 4096, 4096 + 80
    else:
        b, h, g, d, hot, cold, length = 6, 8, 4, 256, 32, 96, 80
    q, cache, k_new, v_new = decode_case(torch, gen, [length] * b, torch.float32, b=b, h=h, g=g,
                                         d=d, hot=hot, cold=cold, tier_dtype=kvc.FP8)
    kw = dict(k_new=k_new, v_new=v_new, active=torch.ones(b, dtype=torch.bool, device="cuda"),
              rope_theta=theta) if fused else {}
    up = upcast(cache)
    if ring:
        _, k_rot = entry(q, cache, **kw)
        q_rot = apply_rope(q[:, None], cache.lengths.long()[:, None], theta)[:, 0]
        kh = torch.cat([up.cold_k, k_rot[:, None]], 1).permute(0, 2, 1, 3).repeat_interleave(
            h // g, dim=1).contiguous()
        vh = torch.cat([up.cold_v, v_new[:, None]], 1).permute(0, 2, 1, 3).repeat_interleave(
            h // g, dim=1).contiguous()
        mask = torch.ones((b, 1, 1, cold + 1), dtype=torch.bool, device="cuda")
        mask[:, :, :, length % cold] = False
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q_rot[:, :, None], kh, vh, attn_mask=mask)
        rows = cold - 1
    else:
        library = decode_sdpa(torch, q, up, length, (k_new, v_new) if fused else None)
        rows = length
    # q, the rows read (1-byte tiers), lengths, the output; fused also k_new,
    # v_new, active, the cos / sin tables and k_rot; paged the page table
    n_bytes = b * h * d * 4 + b * rows * g * d * 2 + 4 * b + b * h * d * 4
    if fused:
        n_bytes += 2 * b * g * d * 4 + 4 * b + b * d * 4 + b * g * d * 4
    ops = 4 * b * h * (rows + int(fused)) * d
    name = f"{kern.symbol} (b {b}, length {length}, fp8 tiers, f32 activations)"
    if paged:
        pc = paged_copy(torch, cache, 32, shuffle_seed=1)
        t = paged_timing(torch, name + ", page size 32, shuffled",
                         lambda: entry(q, pc, **kw), lambda: entry(q, cache, **kw),
                         lambda: entry(q, pc, impl="plain", **kw), library,
                         PAGED_DECODE, GQA_DECODE, n_bytes + b * 3 * 4, ops, smi)
    else:
        print(f"{name}:")
        ms, _ = timed("kernel", lambda: entry(q, cache, **kw),
                      only=RING_DECODE if ring else GQA_DECODE)
        plain_ms, _ = timed("plain", lambda: entry(q, cache, impl="plain", **kw),
                            iters=3 if ring else 20)
        library_ms, _ = timed("SDPA (f32 over the upcast rows)", library)
        b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
        print(f"{name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, "
              f"bound {b_ms:.6f} ms by {b_by} ({n_bytes} B, {ops} FLOP) on {smi}")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    return fp8_row(kern, "src/repro_torch/csrc/flash_decode.cuh",
                   "src/repro/kernels/flash_decode.py:" + ("481" if fused else "402"), worst, t)


def fp8_latent_phase(torch, gen, smi):
    """A4a, the latent decode over fp8 tiers: bit-identical to its plain
    version (q in f32 and in bf16, hot only, hot + cold, length 0; NaN
    past each length), one launch of its own entry point each; timed at
    b 6, h 128, length 80 beside SDPA over the upcast rows."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd

    kern, scale, dv = fd.LATENT_FP8_KERNEL, 192 ** -0.5, 512
    worst, n = 0.0, 0
    for dt in ACTS:
        for lengths in ([0, 1, 17, 31, 32, 20], [33, 64, 80, 100, 127, 128], [0] * 6):
            q, cache = latent_case(torch, gen, lengths, kvc.FP8)
            q = q.to(getattr(torch, dt))
            worst = max(worst, fp8_matches_plain(
                torch, kern, lambda impl: fd.flash_decode_attention_latent(
                    q, cache, dv, scale, impl=impl), f"{dt} q, lengths {lengths}"))
            n += 1
    print(f"{kern.symbol}: bit-identical to plain on {n} cases (fp8 latent tiers), one launch each")
    b, h, d, length = 6, 128, 576, 80
    q, cache = latent_case(torch, gen, [length] * b, kvc.FP8)
    name = f"{kern.symbol} (b 6, h 128, length {length}, fp8 tiers)"
    print(f"{name}:")
    ms, _ = timed("kernel", lambda: fd.flash_decode_attention_latent(q, cache, dv, scale),
                  only="latent_kernel")
    plain_ms, _ = timed("plain", lambda: fd.flash_decode_attention_latent(q, cache, dv, scale,
                                                                          impl="plain"))
    rows = torch.cat([cache.hot_k.float(), cache.cold_k[:, : length - 32].float()], 1)
    kh = rows[:, None].expand(b, h, length, d).contiguous()
    vh = rows[:, None, :, :dv].expand(b, h, length, dv).contiguous()
    library_ms, _ = timed("SDPA (f32 over the upcast rows)", lambda:
                          torch.nn.functional.scaled_dot_product_attention(q[:, :, None], kh, vh,
                                                                           scale=scale))
    n_bytes = b * h * d * 4 + b * length * d + 4 * b + b * h * dv * 4
    ops = 2 * b * h * length * (d + dv)
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"{name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, bound "
          f"{b_ms:.6f} ms by {b_by} ({n_bytes} B, {ops} FLOP) on {smi}")
    return fp8_row(kern, "src/repro_torch/csrc/flash_latent.cu",
                   "src/repro/kernels/flash_decode.py:579", worst,
                   dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                        bound_by=b_by))


def fp8_prefill_phase(torch, gen, theta, swa_theta, smi, form):
    """A3d, kernel 3's GQA forms with fp8 tiers and an fp8 emit: ``form``
    "fresh", "window", "chunk", "paged" (chunked over a paged cold tier)
    or "ring" (chunked over the ring). o, k_cast and v_cast (fp8, by their
    bytes) bit-identical to the plain version with f32 and bf16
    activations at the cases of the f32 form's phase (falcon3-1b's heads:
    s 32 / 77, or C 32 waves at offsets 0-96 over hot 32 / cold 96 with
    NaN past each length, paged at page size 32 / 48 identity / shuffled;
    the window forms at mixtral-8x22b's and falcon3-1b's heads, windows 8 /
    256 and rings 64 / 4096 past the wrap), valid 0 / partial / full; then
    the emit sweep (v rows carrying FP8_SWEEP: bytes equal to the plain
    ``to_tier``). Timed at the f32 form's case beside SDPA over the upcast
    keys, the bound counting 1-byte tiers and emit."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models.layers import apply_rope

    kern = {"fresh": fp.FP8_KERNEL, "window": fp.FP8_WINDOW_KERNEL, "chunk": fp.FP8_CHUNK_KERNEL,
            "paged": fp.FP8_CHUNK_PAGED_KERNEL, "ring": fp.FP8_CHUNK_RING_KERNEL}[form]
    swa = form in ("window", "ring")
    th = swa_theta if swa else theta
    F8 = kvc.FP8
    worst, n = 0.0, 0

    def run_on(q, k, cache, kw):
        return lambda v, impl="auto": fp.flash_prefill_attention(q, k, v, cache, rope_theta=th,
                                                                 kv_dtype=F8, impl=impl, **kw)

    cases = []  # (q, k, v, cache, kw, label)
    for dt in ACTS:
        dtype = getattr(torch, dt)
        if form == "fresh":
            for s in (32, 77):
                q, k, v = qkv_case(torch, gen, 6, s, 8, 4, 256, dtype)
                valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device="cuda")
                cases.append((q, k, v, None, dict(valid=valid), f"s {s}, {dt}"))
        elif form == "window":
            for h, g, d in SWA_SHAPES:
                for s, window in ((40, 8), (300, 256)):
                    q, k, v = qkv_case(torch, gen, 3, s, h, g, d, dtype)
                    valid = torch.tensor([s, s // 2 + 3, 0], dtype=torch.int32, device="cuda")
                    cases.append((q, k, v, None, dict(valid=valid, window=window),
                                  f"h {h}, d {d}, s {s}, window {window}, {dt}"))
        elif form == "ring":
            for h, g, d in SWA_SHAPES:
                for cold, c in ((64, 16), (64, 48), (4096, 256)):
                    lens = [0, cold - 5, cold + 3, 3 * cold + 1]
                    _, cache, _, _ = decode_case(torch, gen, lens, dtype, b=4, h=h, g=g, d=d,
                                                 hot=0, cold=cold, tier_dtype=F8)
                    q, k, v = qkv_case(torch, gen, 4, c, h, g, d, dtype)
                    valid = torch.tensor([c, c - 5, 0, c // 2], dtype=torch.int32, device="cuda")
                    cases.append((q, k, v, cache, dict(valid=valid, window=cold, ring=True),
                                  f"h {h}, d {d}, ring {cold}, C {c}, {dt}"))
        else:
            offs = [0, 5, 31, 32, 33, 64, 70, 96]
            valid = torch.tensor([32, 1, 27, 0, 32, 32, 26, 32], dtype=torch.int32, device="cuda")
            q, k, v, cache = chunk_case(torch, gen, 32, dtype, offs, tier=F8)
            variants = paged_variants(torch, cache) if form == "paged" else [("contiguous", cache)]
            for label, c in variants:
                cases.append((q, k, v, c, dict(valid=valid),
                              f"C 32, offsets {offs}, {label}, {dt}"))
    for q, k, v, cache, kw, label in cases:
        run = run_on(q, k, cache, kw)
        valid = kw["valid"]
        got = run(v)
        torch.cuda.synchronize()
        want = run(v, "plain")
        for i, nv in enumerate(valid.tolist()):  # o on the valid rows (the rest is don't-care)
            worst = max(worst, max_err(got[0][i, :nv], want[0][i, :nv]))
            check(torch.equal(got[0][i, :nv], want[0][i, :nv]),
                  f"{kern.symbol} o not bit-identical to plain ({label}, slot {i})")
        check(fp8_equal(torch, got[1], want[1]) and fp8_equal(torch, got[2], want[2]),
              f"{kern.symbol} k_cast / v_cast bytes differ from plain ({label})")
        emit_sweep(torch, kern, run, v, valid, label)
        n += 1
    print(f"{kern.symbol}: o (valid rows), k_cast and v_cast (bytes) bit-identical to plain on "
          f"{n} cases, and the emit sweep {FP8_SWEEP} byte-equal to to_tier on each (fp8 tiers "
          f"and emit, f32 / bf16 activations)")

    # the timed case of the f32 form, f32 activations
    if form == "fresh":
        b, s, h, g, d = 6, 32, 8, 4, 256
        q, k, v = qkv_case(torch, gen, b, s, h, g, d, torch.float32)
        run, its = run_on(q, k, None, {}), 20
        qh = q.permute(0, 2, 1, 3).contiguous()
        kh = k.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
        vh = v.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, is_causal=True)
        n_bytes = 4 * (2 * b * s * h * d + 2 * b * s * g * d) + 2 * b * s * g * d + 4 * b
        ops, only, case = 4 * b * h * d * s * (s + 1) // 2, "prefill_kernel", f"b {b}, s {s}"
    elif form == "window":
        b, (h, g, d), s, window = 1, SWA_SHAPES[0], 4200, 4096
        q, k, v = qkv_case(torch, gen, b, s, h, g, d, torch.float32)
        run, its = run_on(q, k, None, dict(window=window)), 5
        pos = torch.arange(s, device="cuda")[None]
        k_c = apply_rope(k, pos, th)
        library = window_sdpa(torch, q, k_c, v, pos, pos,
                              torch.ones((b, s), dtype=torch.bool, device="cuda"), window, th, h, g)
        n_bytes = 4 * (b * s * h * d * 2 + 2 * b * s * g * d + s * d) + 2 * b * s * g * d + 4 * b
        ops = 4 * h * d * b * window_live(range(s), 0, s, window)
        only, case = WINDOW_PREFILL, f"b {b}, s {s}, window {window}, h {h}"
    elif form == "ring":
        b, (h, g, d), c, cold = 4, SWA_SHAPES[0], 256, 4096
        offs = [cold + 104, cold + 1000, 2 * cold + 7, 3 * cold + 300]
        _, cache, _, _ = decode_case(torch, gen, offs, torch.float32, b=b, h=h, g=g, d=d, hot=0,
                                     cold=cold, tier_dtype=F8)
        q, k, v = qkv_case(torch, gen, b, c, h, g, d, torch.float32)
        run, its = run_on(q, k, cache, dict(window=cold, ring=True)), 5
        off = cache.lengths.long()
        k_pos = torch.cat([kvc.ring_slot_positions(off, cold).long(),
                           off[:, None] + torch.arange(c, device="cuda")[None]], 1)
        q_pos = off[:, None] + torch.arange(c, device="cuda")[None]
        keys = torch.cat([cache.cold_k.float(), apply_rope(k, q_pos, th)], 1)
        vals = torch.cat([cache.cold_v.float(), v], 1)
        library = window_sdpa(torch, q, keys, vals, q_pos, k_pos, k_pos >= 0, cold, th, h, g)
        n_bytes = (4 * (b * c * h * d * 2 + 2 * b * c * g * d + b * c * d) + 2 * b * c * g * d
                   + 8 * b + 2 * g * d * b * (cold - 1))
        ops = 4 * h * d * sum(window_live(range(o, o + c), o - cold, o + c, cold) for o in offs)
        only, case = CHUNK_RING, f"b {b}, C {c}, ring {cold}"
    else:
        b, c, off, h, g, d = 6, 32, 96, 8, 4, 256
        q, k, v, cache = chunk_case(torch, gen, c, torch.float32, [off] * b, tier=F8)
        pos = off + torch.arange(c, device="cuda")[None].expand(b, -1)
        qh = apply_rope(q, pos, th).permute(0, 2, 1, 3).contiguous()
        kk = torch.cat([cache.hot_k.float(), cache.cold_k[:, : off - 32].float(),
                        apply_rope(k, pos, th)], 1)
        vv = torch.cat([cache.hot_v.float(), cache.cold_v[:, : off - 32].float(), v], 1)
        kh = kk.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
        vh = vv.permute(0, 2, 1, 3).repeat_interleave(h // g, dim=1).contiguous()
        mask = (off + torch.arange(c, device="cuda"))[:, None] >= torch.arange(off + c,
                                                                                 device="cuda")
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qh, kh, vh, attn_mask=mask)
        n_bytes = 4 * (2 * b * c * h * d + 2 * b * c * g * d) + 2 * b * c * g * d \
            + 2 * b * off * g * d + 8 * b
        ops, its = 4 * b * h * d * (c * off + c * (c + 1) // 2), 5
        run, only, case = run_on(q, k, cache, {}), "chunk_kernel", f"b {b}, C {c}, offset {off}"
    name = f"{kern.symbol} ({case}, fp8 tiers and emit, f32 activations)"
    if form == "paged":
        pc = paged_copy(torch, cache, 32, shuffle_seed=2)
        t = paged_timing(torch, name + ", page size 32, shuffled",
                         lambda: run_on(q, k, pc, {})(v), lambda: run(v),
                         lambda: run_on(q, k, pc, {})(v, "plain"), library, PAGED_CHUNK,
                         "gqa_chunk_kernel", n_bytes + 4 * b * 3, ops, smi)
    else:
        got, want = run(v), run(v, "plain")  # bit for bit at the timed case (and warm-up)
        torch.cuda.synchronize()
        check(torch.equal(got[0], want[0]) and fp8_equal(torch, got[1], want[1])
              and fp8_equal(torch, got[2], want[2]),
              f"{kern.symbol} not bit-identical at the timed case")
        del got, want
        print(f"{name}: bit-identical to plain")
        ms, _ = timed("kernel", lambda: run(v), only=only, iters=its)
        if swa:  # one call of seconds: CUDA events, as the f32 window forms
            plain_ms = time_ms(lambda: run(v, "plain"), iters=1, warmup=0)
            print(f"  plain: CUDA events {plain_ms:.5f} ms per call")
        else:
            plain_ms, _ = timed("plain", lambda: run(v, "plain"), iters=5)
        library_ms, _ = timed("SDPA (f32 over the upcast keys)", library, iters=its)
        b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
        print(f"{name}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, SDPA {library_ms:.5f} ms, "
              f"bound {b_ms:.6f} ms by {b_by} ({n_bytes} B, {ops} FLOP) on {smi}")
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
    return fp8_row(kern, "src/repro_torch/csrc/flash_prefill.cuh",
                   "src/repro/kernels/flash_prefill.py:258", worst, t)


# ---------------------------------------------------------------------------
# slice phase: falcon3-1b served end to end
# ---------------------------------------------------------------------------


def counted(kernels, fn):
    """Run ``fn`` with every kernel's count set to 0 just before it; return
    its result and the counts read just after."""
    import torch

    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, {kern.symbol: kern.launches for kern in kernels}, time.perf_counter() - t0


def packed_leaves(tree):
    """Every packed projection leaf of a parameter tree."""
    if hasattr(tree, "packed"):
        yield tree
    elif isinstance(tree, (dict, list, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from packed_leaves(v)


def check_served(res, cfg, eng, seq_len, label, prompt_len=32):
    """Tokens in range, every row's ledger at the closed form, no weight
    reloaded."""
    from repro_torch.core import dr_edram

    tokens = res.tokens.numpy()
    check(tokens.shape == (6, seq_len - prompt_len)
          and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          f"{label}: generated tokens out of range or short")
    check(eng.weight_loads == 0, f"{label}: weights were reloaded")
    closed = dr_edram.closed_form_reduction(seq_len, 32)
    for f in res.finished:
        check(f.seq_len == seq_len, f"{label}: row {f.rid} seq_len {f.seq_len}")
        check(abs(f.external_reduction - closed) <= 1e-12,
              f"{label}: row {f.rid} external_reduction {f.external_reduction} != {closed}")
    print(f"{label} DR ledger: every row external_reduction = "
          f"{res.finished[0].external_reduction!r} (closed form {closed!r}), "
          f"weight_loads = {eng.weight_loads}")


def carried_scale_run(torch, cfg, packed, prompts, kw, new, kernels, fused, want):
    """The same requests served under ``fuse_act_quant=False`` (the
    reference's second packed path): a separate act-quant, then the
    known-scale kernels. Checks greedy tokens equal to ``want`` (the fused
    kernel run's, itself equal to the plain run's) on 6/6 rows, the
    ledger, ``weight_loads == 0``, no launch of an act-quant prologue
    kernel and one known-scale launch for every prologue launch of the
    fused run. ``fused`` is (engine, wall, launches) of the fused run; its
    engine serves once more after two carried-scale generates, so the two
    paths are timed in the order fused, carried, carried, fused."""
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serving.engine import Engine

    label = f"{cfg.name} carried-scale"
    ccfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, fuse_act_quant=False))
    eng = Engine(ccfg, packed, **kw)
    eng.generate(prompts[:, :8], max_new_tokens=2)  # warm-up
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts, max_new_tokens=new))
    tok_s = 6 * new / wall
    print(f"{label} generate 6 x (32 + {new}): {wall:.3f} s, {tok_s:.1f} tokens/s, "
          f"launches {launches}")
    check_served(res, ccfg, eng, 32 + new, label)
    same = int((res.tokens.numpy() == want).all(axis=1).sum())
    check(same == 6, f"{label}: greedy tokens differ from the fused and plain runs "
                     f"({same}/6 rows equal)")
    for prologue, known in ((tm.KERNEL, tm.KNOWN_KERNEL),
                            (tm.EXPERT_KERNEL, tm.KNOWN_EXPERT_KERNEL)):
        n_fused, n_known = fused[2].get(prologue.symbol, 0), launches.get(known.symbol, 0)
        check(launches.get(prologue.symbol, 0) == 0, f"{label}: {prologue.symbol} launched")
        check(n_known == n_fused, f"{label}: {n_known} {known.symbol} launches, the fused run "
                                  f"made {n_fused} {prologue.symbol} launches")
    check(all(n > 0 for sym, n in launches.items()
              if sym not in (tm.KERNEL.symbol, tm.EXPERT_KERNEL.symbol)),
          f"{label}: a kernel of the path never launched: {launches}")
    print(f"{label}: greedy tokens equal to the fused and plain runs (6/6 rows); "
          f"{cfg.name} act-quant kernel launches 0")
    walls = {"fused": [fused[1]], "carried": [wall]}
    for which, e in (("carried", eng), ("fused", fused[0])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.generate(prompts, max_new_tokens=new)
        torch.cuda.synchronize()
        walls[which].append(time.perf_counter() - t0)
    print(f"{cfg.name} generate walls in the order fused, carried, carried, fused: "
          f"fused {walls['fused']} s, carried {walls['carried']} s; mean tokens/s fused "
          f"{6 * new * 2 / sum(walls['fused']):.2f}, carried "
          f"{6 * new * 2 / sum(walls['carried']):.2f}")
    breakdown(torch, eng, prompts, label=label, new=16 if cfg.moe is None else 8)
    return launches, tok_s


def entry_point_path(torch, gen, packed, cache):
    """The two entry points no serving step calls, driven as a user calls
    them, on the served model's own state: ``ternary_matmul`` on
    quickstart's (8, 256) x (256, 64) (its step 5) and on every layer's
    four packed projections at decode width, each against
    ``ref.ternary_matmul_ref``; ``flash_decode_attention(q, cache)`` over
    every layer's post-append cache after prefill and one decode step, and
    over the same rows in a paged cache (shuffled 32-row pages: the paged
    form, 18 launches), each against its plain version. Returns the launch
    counts."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core import packing
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref
    from repro_torch.kernels import ternary_matmul as tm

    def run():
        xq = torch.randint(-128, 128, (8, 256), generator=gen, device="cuda", dtype=torch.int8)
        pk = packing.pack(torch.randint(-1, 2, (256, 64), generator=gen, device="cuda",
                                        dtype=torch.int8), "pack2")
        pairs = [(tm.ternary_matmul(xq, pk, k=256), ref.ternary_matmul_ref(xq, pk, 256, "pack2"))]
        for blk in packed["blocks"]:
            for leaf in (blk["attn"]["wqkv"], blk["attn"]["wo"], blk["mlp"]["wgu"],
                         blk["mlp"]["down"]):
                q = act_quant(torch.randn((6, leaf.k), generator=gen, device="cuda"))
                pairs.append((tm.ternary_matmul(q.xq, leaf.packed, k=leaf.k, codec=leaf.codec),
                              ref.ternary_matmul_ref(q.xq, leaf.packed, leaf.k, leaf.codec)))
        stack = cache["attn"]
        for i in range(stack.lengths.shape[0]):
            layer = kvc.layer(stack, i)
            q = torch.randn((6, 8, 256), generator=gen, device="cuda")
            pairs.append((fd.flash_decode_attention(q, layer),
                          fd.flash_decode_attention(q, layer, impl="plain")))
            # the paged form (A2a) over the same rows in shuffled 32-row pages
            paged = paged_copy(torch, layer, 32, shuffle_seed=i)
            pairs.append((fd.flash_decode_attention(q, paged),
                          fd.flash_decode_attention(q, paged, impl="plain")))
        return pairs

    pairs, launches, wall = counted([tm.INT32_KERNEL, fd.GQA_KERNEL, fd.GQA_PAGED_KERNEL], run)
    for got, want in pairs:
        check(torch.equal(got, want), f"entry-point path: kernel != oracle ({max_err(got, want)})")
    check(all(n > 0 for n in launches.values()), f"an entry point never launched: {launches}")
    check(launches[fd.GQA_PAGED_KERNEL.symbol] == 18,
          f"paged post-append decode launches {launches[fd.GQA_PAGED_KERNEL.symbol]} != 18")
    print(f"entry-point path (falcon3-1b state): {len(pairs)} results equal to their oracles "
          f"(int32 exact, decode bit-identical to plain) in {wall:.2f} s, launches {launches}")
    return launches


def counting(eng, name):
    """Count the calls of the engine's method ``name`` (one per chunk wave,
    decode step, draft wave or speculative round)."""
    calls = []
    fn = getattr(eng, name)

    def counted_call(*args):
        calls.append(1)
        return fn(*args)

    setattr(eng, name, counted_call)
    return calls


def counting_waves(eng):
    """Count the engine's chunk waves (one ``_chunk_step`` call each)."""
    return counting(eng, "_chunk_step")


def chunked_phase(torch, cfg, packed, kernels):
    """falcon3-1b admitted by chunk waves of 32 (``prefill_chunk=32``, hot 32,
    max_len 128): (a) ``generate`` 6 x (96 + 32), against grouped admission
    of the same prompts (6/6 rows), and at the depth cut to MAIN_PLAIN_CUT
    layers against the plain chunked run; (b) ``serve`` six requests of
    prompt lengths 5 / 31 / 32 / 33 / 77 / 100 through 4 slots, 24 new
    tokens each, ``sync_every`` 8 (slot reuse at another length, offsets
    into the cold tier, partial and idle chunks), against grouped admission
    of the same requests, and at the depth cut against the plain chunked
    run. Ledgers at the closed form, ``weight_loads == 0``, 18 chunk
    launches per wave and no fresh launch. Returns the launches of (a) and
    of (b)."""
    import numpy as np

    from repro_torch.core import dr_edram
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    kw = dict(hot_cap=32, max_len=128, slots=6, prefill_chunk=32)
    cfg_plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (6, 96)).astype(np.int32)
    label = "falcon3-1b chunked"
    eng = Engine(cfg, packed, **kw)
    waves = counting_waves(eng)
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts, max_new_tokens=32))
    print(f"{label} generate 6 x (96 + 32): {wall:.3f} s, {6 * 32 / wall:.1f} tokens/s, "
          f"{len(waves)} chunk waves, launches {launches}")
    check(len(waves) == 3, f"{label}: {len(waves)} chunk waves for 96-token prompts, not 3")
    check(launches[fp.CHUNK_KERNEL.symbol] == cfg.n_layers * 3 and launches[fp.KERNEL.symbol] == 0,
          f"{label}: not {cfg.n_layers} x 3 chunk launches and no fresh launch: {launches}")
    check(all(n > 0 for sym, n in launches.items() if sym != fp.KERNEL.symbol),
          f"{label}: a kernel of the path never launched: {launches}")
    check_served(res, cfg, eng, 128, label, prompt_len=96)
    check(eng.chunk_shapes == {(6, 32)}, f"{label}: chunk wave shapes {eng.chunk_shapes}")
    # the plain run at the depth cut (the full-depth run is held to grouped
    # admission below, and grouped to its plain run in the slice phase)
    cut = MAIN_PLAIN_CUT
    c_cut = dataclasses.replace(cfg, n_layers=cut)
    p_cut = dict(packed, blocks=packed["blocks"][:cut])
    plain_cut = dataclasses.replace(cfg_plain, n_layers=cut)
    t0 = time.perf_counter()
    tok_cut, tok_p = (Engine(c, p_cut, **kw).generate(prompts, max_new_tokens=32).tokens.numpy()
                      for c in (c_cut, plain_cut))
    torch.cuda.synchronize()
    tokens = res.tokens.numpy()
    same = int((tok_p == tok_cut).all(axis=1).sum())
    print(f"{label} kernel and plain runs at {cut} layers: {time.perf_counter() - t0:.2f} s; "
          f"greedy tokens equal on {same}/6 rows")
    check(same == 6, f"{label}: greedy tokens at {cut} layers differ from the plain chunked run "
                     f"({same}/6 rows)")
    grouped = Engine(cfg, packed, **{**kw, "prefill_chunk": 0}).generate(
        prompts, max_new_tokens=32).tokens.numpy()
    rows = (grouped == tokens).all(axis=1)
    first = [int(np.argmax(g != t)) if not ok else None
             for g, t, ok in zip(grouped, tokens, rows)]
    print(f"{label} against grouped admission of the same prompts: {int(rows.sum())}/6 rows "
          f"equal; first differing step per row {first}")
    check(bool(rows.all()), f"{label}: greedy tokens differ from grouped admission "
                            f"({int(rows.sum())}/6 rows equal; first differing steps {first})")
    breakdown(torch, eng, prompts, label=label, new=8)

    label_b = "falcon3-1b chunked serve"
    lens = (5, 31, 32, 33, 77, 100)
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32))
            for i, n in enumerate(lens)]
    skw = dict(slots=4, sync_every=8)
    eng_b = Engine(cfg, packed, **{**kw, "slots": 4})
    waves_b = counting_waves(eng_b)
    fin, launches_b, wall = counted(kernels, lambda: eng_b.serve(
        [Request(i, t, 24) for i, t in reqs], **skw))
    n_chunk = launches_b[fp.CHUNK_KERNEL.symbol]
    print(f"{label_b} (prompts {lens}, 24 new each, 4 slots, sync_every 8): {wall:.3f} s, "
          f"{len(waves_b)} chunk waves, launches {launches_b}; chunk launches per wave "
          f"{n_chunk / max(len(waves_b), 1):g}")
    check(n_chunk == cfg.n_layers * len(waves_b) and launches_b[fp.KERNEL.symbol] == 0,
          f"{label_b}: not {cfg.n_layers} chunk launches per wave: {launches_b}")
    t0 = time.perf_counter()
    grouped_b = {f.rid: f.tokens for f in Engine(cfg, packed, **{**kw, "slots": 4,
                                                                 "prefill_chunk": 0}).serve(
        [Request(i, t, 24) for i, t in reqs], **skw)}
    fin_cut, fin_p = ({f.rid: f.tokens for f in Engine(c, p_cut, **{**kw, "slots": 4}).serve(
        [Request(i, t, 24) for i, t in reqs], **skw)} for c in (c_cut, plain_cut))
    torch.cuda.synchronize()
    print(f"{label_b}: grouped serve and kernel and plain runs at {cut} layers: "
          f"{time.perf_counter() - t0:.2f} s")
    check(eng_b.weight_loads == 0, f"{label_b}: weights were reloaded")
    for rid in fin_cut:
        check(np.array_equal(fin_cut[rid], fin_p[rid]),
              f"{label_b}: request {rid} tokens at {cut} layers differ from the plain chunked run")
    for f in fin:
        check(np.array_equal(f.tokens, grouped_b[f.rid]),
              f"{label_b}: request {f.rid} tokens differ from grouped admission")
        closed = dr_edram.closed_form_reduction(f.seq_len, 32)
        check(f.seq_len == lens[f.rid] + 24 and abs(f.external_reduction - closed) <= 1e-12,
              f"{label_b}: request {f.rid} seq_len {f.seq_len}, reduction "
              f"{f.external_reduction} != {closed}")
    print(f"{label_b}: tokens equal to grouped admission (6/6 requests) and, at {cut} layers, to "
          f"the plain chunked run (6/6); every ledger at its closed form; weight_loads = 0")
    return launches, launches_b


def counting_steps(eng):
    """Count the engine's decode steps (one ``_step`` call each)."""
    return counting(eng, "_step")


def paged_requests(vocab):
    """The paged phase's eight requests (rid, prompt, new tokens) from one
    seeded 96-token prefix P: r0 = P + 8; r1-r3 unrelated prompts of 50, 77
    and 5 tokens; r4 = P + 17; r5 = P + 3; r6 = P[:70] + 30 other tokens
    (its match ends inside the cold page of rows 64-95: copy-on-write);
    r7 = P + 40 with 40 new tokens (its decode grows its pages mid-run).
    With 4 slots, r0-r3 take every slot in the first admission round and
    r4-r7 wait in the queue until slots free, at least 24 decode steps
    after r0's last prompt wave recorded P in the prefix tree; so every
    one of r4-r7 is matched against P."""
    import numpy as np

    rng = np.random.default_rng(22)
    p = rng.integers(0, vocab, 96).astype(np.int32)

    def tail(n):
        return rng.integers(0, vocab, n).astype(np.int32)

    other = ((p[70:] + 1 + rng.integers(0, vocab - 1, 26)) % vocab).astype(np.int32)
    return [(0, np.concatenate([p, tail(8)]), 24), (1, tail(50), 24), (2, tail(77), 24),
            (3, tail(5), 24), (4, np.concatenate([p, tail(17)]), 24),
            (5, np.concatenate([p, tail(3)]), 24),
            (6, np.concatenate([p[:70], other, tail(4)]), 24),
            (7, np.concatenate([p, tail(40)]), 40)]


def expected_reuse(specs, hot, ps):
    """The prefix tokens the port's ``PrefixCache`` rule gives r4-r7 once
    r0 is in the tree (r0-r3 are admitted into an empty one)."""
    from repro_torch.serving.paging import PagePool, PrefixCache, pages_needed

    pool = PagePool(64)
    tree = PrefixCache(pool, hot, ps)
    toks = specs[0][1]
    tree.insert(toks, pool.alloc(pages_needed(len(toks), hot, ps)), lambda ids: None)
    return {rid: (tree.match(t).length if rid >= 4 else 0) for rid, t, _ in specs}


def traced_serve(torch, eng, reqs_fn, label):
    """Wall time, device busy share and the top kernels of one traced
    ``serve``. The engine has served these requests before; the
    profiler's warm-up step serves only the shortest one, so that
    collection is running when the traced serve starts."""
    timing = {}

    def run():
        t0 = time.perf_counter()
        eng.serve(reqs_fn())
        torch.cuda.synchronize()
        timing["wall"] = (time.perf_counter() - t0) * 1e3

    def warm():
        shortest = min(reqs_fn(), key=lambda r: r.prompt_len + r.max_new_tokens)
        eng.serve([shortest])

    events = sorted(trace_events(run, warm=warm), key=_device_us, reverse=True)
    wall = timing["wall"]
    busy = sum(_device_us(e) for e in events) / 1e3
    if busy <= 0:
        print(f"{label} trace: device time not measured (the trace holds none); wall {wall:.2f} ms")
        return
    print(f"{label}, traced serve: wall {wall:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    for e in events[:8]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    for name, key in (("paged decode kernel", PAGED_DECODE), ("paged chunk kernel", PAGED_CHUNK),
                      ("LoRA kernel", "lora_kernel"), ("ternary kernels", TERNARY)):
        sel = [e for e in events if key in e.key]
        sel_ms = sum(_device_us(e) for e in sel) / 1e3
        print(f"  {name}: {sel_ms:.3f} ms device time in {sum(e.count for e in sel)} launches "
              f"({100 * sel_ms / busy:.2f} % of device busy)")


def paged_phase(torch, cfg, packed, kernels, smi):
    """falcon3-1b served with a paged cold tier and prefix sharing
    (``Engine(..., paged=True, page_size=32, prefix_sharing=True)``, hot 32,
    max_len 192, ``prefill_chunk`` 32, 4 slots, ``sync_every`` 8, the
    default pool) on ``paged_requests``, then unshared paged, contiguous
    chunked and grouped, and at the depth cut to PAGED_PLAIN_CUT layers the
    shared run and its plain run. Checks: tokens equal on 8/8 requests
    across the four full-depth runs and across the two cut ones;
    ``prefix_tokens_reused`` 0 for
    r0-r3 and the ``PrefixCache`` rule's for r4-r7 (capped at len - 1,
    copy-on-write rows for r6); per request and traffic key the unshared
    ledger minus the shared one equals (full - resumed) x token bytes; the
    unshared and contiguous ledgers at the closed form; ``weight_loads ==
    0``; in the shared run 18 paged chunk launches per wave, 18 paged
    decode launches per decode step and no contiguous chunk or decode
    launch. Then one traced shared serve. Returns the shared run's
    launches and its tokens by rid."""
    import numpy as np

    from repro_torch.core import dr_edram
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    label = "falcon3-1b paged"
    hot, ps = 32, 32
    specs = paged_requests(cfg.vocab_size)

    def reqs():
        return [Request(rid, t, n) for rid, t, n in specs]

    kw = dict(hot_cap=hot, max_len=192, prefill_chunk=32, slots=4, sync_every=8)
    pkw = dict(paged=True, page_size=ps)
    eng = Engine(cfg, packed, **kw, **pkw)
    waves, steps = counting_waves(eng), counting_steps(eng)
    fin, launches, wall = counted(kernels, lambda: eng.serve(reqs()))
    fin = {f.rid: f for f in fin}
    print(f"{label} shared serve (prompts {[len(t) for _, t, _ in specs]}, 4 slots, page size "
          f"{ps}): {wall:.3f} s, {len(waves)} chunk waves, {len(steps)} decode steps, launches "
          f"{launches}")
    n_l = cfg.n_layers
    check(launches[fp.CHUNK_PAGED_KERNEL.symbol] == n_l * len(waves),
          f"{label}: {launches[fp.CHUNK_PAGED_KERNEL.symbol]} paged chunk launches for "
          f"{len(waves)} waves, not {n_l} per wave")
    check(launches[fd.PAGED_KERNEL.symbol] == n_l * len(steps),
          f"{label}: {launches[fd.PAGED_KERNEL.symbol]} paged decode launches for "
          f"{len(steps)} decode steps, not {n_l} per step")
    check(launches[fp.CHUNK_KERNEL.symbol] == 0 and launches[fd.KERNEL.symbol] == 0
          and launches[fp.KERNEL.symbol] == 0,
          f"{label}: a contiguous-form attention kernel launched: {launches}")
    check(all(n > 0 for sym, n in launches.items()
              if sym not in (fp.CHUNK_KERNEL.symbol, fd.KERNEL.symbol, fp.KERNEL.symbol)),
          f"{label}: a kernel of the path never launched: {launches}")
    pool, tree = eng._last_pool, eng._last_ptree
    want_reuse = expected_reuse(specs, hot, ps)
    got_reuse = {rid: f.prefix_tokens_reused for rid, f in fin.items()}
    print(f"{label}: prefix tokens reused {got_reuse} (the PrefixCache rule: {want_reuse}); "
          f"pool {pool.n_pages} pages, {len(tree.tree_pages())} held by the tree after the serve, "
          f"{pool.available()} free")
    check(got_reuse == want_reuse and want_reuse[6] == 70 and min(want_reuse[i] for i in
                                                                  (4, 5, 7)) == 96,
          f"{label}: prefix reuse {got_reuse} != {want_reuse}")
    check(pool.available() == pool.n_pages - len(tree.tree_pages()),
          f"{label}: pages still held after every slot retired")

    runs = {}
    for name, c, extra in (("unshared paged", cfg, dict(pkw, prefix_sharing=False)),
                           ("contiguous chunked", cfg, {}),
                           ("grouped", cfg, dict(prefill_chunk=0))):
        e = Engine(c, packed, **{**kw, **extra})
        t0 = time.perf_counter()
        runs[name] = {f.rid: f for f in e.serve(reqs())}
        torch.cuda.synchronize()
        check(e.weight_loads == 0, f"{label} {name}: weights were reloaded")
        print(f"{label} {name} serve: {time.perf_counter() - t0:.2f} s")
    check(eng.weight_loads == 0, f"{label}: weights were reloaded")
    for name, other in runs.items():
        same = sum(np.array_equal(fin[rid].tokens, other[rid].tokens) for rid, _, _ in specs)
        print(f"{label}: shared run against {name}: greedy tokens equal on {same}/8 requests")
        check(same == 8, f"{label}: tokens differ from the {name} run ({same}/8 requests)")
    tb = eng._kv_token_bytes()
    unshared = runs["unshared paged"]
    for rid, toks, n in specs:
        f, u = fin[rid], unshared[rid]
        full = kvc.prompt_traffic_tokens(len(toks), hot)
        resumed = kvc.prompt_traffic_tokens_resumed(len(toks), f.prefix_tokens_reused, hot)
        for k in kvc.TRAFFIC_KEYS:
            check(u.traffic[k] - f.traffic[k] == (full[k] - resumed[k]) * tb,
                  f"{label}: request {rid} {k}: unshared {u.traffic[k]} - shared "
                  f"{f.traffic[k]} != {(full[k] - resumed[k]) * tb}")
        for name in ("unshared paged", "contiguous chunked"):
            r = runs[name][rid]
            closed = dr_edram.closed_form_reduction(r.seq_len, hot)
            check(r.seq_len == len(toks) + n and abs(r.external_reduction - closed) <= 1e-12,
                  f"{label} {name}: request {rid} seq_len {r.seq_len}, reduction "
                  f"{r.external_reduction} != {closed}")
    saved = {k: sum(unshared[r].traffic[k] - fin[r].traffic[k] for r in fin)
             for k in kvc.TRAFFIC_KEYS}
    # the plain run at the depth cut to PAGED_PLAIN_CUT layers (the run's
    # time), against the shared kernel run at that depth
    cut = PAGED_PLAIN_CUT
    c_cut = dataclasses.replace(cfg, n_layers=cut)
    p_cut = dict(packed, blocks=packed["blocks"][:cut])
    t0 = time.perf_counter()
    shared_cut, plain_cut = (
        {f.rid: f for f in Engine(c, p_cut, **kw, **pkw).serve(reqs())}
        for c in (c_cut, dataclasses.replace(c_cut, bitnet=dataclasses.replace(c_cut.bitnet,
                                                                               impl="plain"))))
    same = sum(np.array_equal(shared_cut[rid].tokens, plain_cut[rid].tokens)
               for rid, _, _ in specs)
    print(f"{label} at {cut} layers: shared run against its plain run ({time.perf_counter() - t0:.2f}"
          f" s): greedy tokens equal on {same}/8 requests")
    check(same == 8, f"{label} at {cut} layers: tokens differ from the plain run ({same}/8)")
    print(f"{label}: tokens equal on 8/8 requests across shared, unshared, contiguous and "
          f"grouped runs (and plain at {cut} layers); ledger bytes the sharing saved {saved} (each "
          f"request's delta = "
          f"(full - resumed prompt ledger) x {tb} B); unshared and contiguous ledgers at the "
          f"closed form; weight_loads = 0")
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    traced_serve(torch, eng, reqs, label)
    print(f"{label}: the traced serve {time.perf_counter() - t0:.2f} s (profiler: "
          f"{trace_line(before)})")
    return launches, {rid: f.tokens for rid, f in fin.items()}


# the sessions phase: warm and cold migration between replicas, the router
# the router runs' chaos seeds: r0 is killed busy at tick 1 (seed 1) or 3
# (seed 2), and r1's stale heartbeat drains it; the control plane reads no
# token value, so the run's ticks, kills and migrations are those of any
# weights at this geometry
SESSION_SEEDS = (1, 2)


def slot_rows(torch, ctx, s):
    """Slot ``s``'s rows in every cache stack, read from the device directly
    (the hot tier, and the cold rows through the host's page-table mirror):
    the bytes an export must carry."""
    import numpy as np

    from repro_torch.core import kv_cache as kvc

    out = {}
    for key, cache in ctx.state.cache.items():
        length = int(cache.lengths[0, s])
        n_hot, n_cold = min(length, cache.hot_cap), max(length - cache.hot_cap, 0)
        ps = cache.page_size
        pages = torch.as_tensor(ctx.host_table[s, : -(-n_cold // ps)].astype(np.int64),
                                device=cache.pool_k.device)
        rows = {}
        for name, hot, pool in (("k", cache.hot_k, cache.pool_k), ("v", cache.hot_v, cache.pool_v)):
            rows[f"hot_{name}"] = kvc.raw(hot)[:, s, :n_hot].cpu()
            cold = kvc.raw(pool)[:, pages]
            cold = cold.reshape((cold.shape[0], -1) + cold.shape[3:])
            rows[f"cold_{name}"] = cold[:, :n_cold].cpu()
        out[key] = rows
    return out


def sessions_phase(torch, cfg, packed, kernels, smi, paged_tokens):
    """falcon3-1b sessions at full width and depth, in the paged phase's
    geometry (hot 32, max_len 192, page size 32, ``prefill_chunk`` 32, 4
    slots, ``sync_every`` 8) on ``paged_requests``, f32 tiers held to
    equality with ``paged_tokens`` (the uninterrupted shared serve).

    (a) Warm migration: replica A serves until r0-r3 have finished and
    r4-r7 have decoded one iteration, then drains with handoffs; every
    payload crosses a ``LocalTransport`` and is imported on replica B (a
    second ``Engine`` over the same packed weights), where the drained
    requests are resubmitted. Tokens equal on 8/8; every payload seeds > 0
    tokens and each resumed request reuses at least that much (up to the
    prefix tree's cap of len - 1); both pools hold only tree pages;
    ``weight_loads == 0``; over A and B 18 paged chunk launches per wave,
    18 paged decode launches per step and no contiguous attention launch.
    (b) The same payloads each corrupted in flight: every import raises
    ``HandoffError``, the requests resume cold with the same tokens on
    8/8; B's chunk waves warm against cold printed (the match must spare
    waves). (c) A ``Router`` over two replicas under
    ``FleetChaosInjector`` (one kill, a corrupted handoff every tick) and a
    heartbeat-timeout drain of r1 on an injected clock, seeds SESSION_SEEDS:
    every request finishes once with the uninterrupted tokens,
    ``check_fleet_invariants`` green after every tick, ``RouterStats``
    printed. (d) fp8 tiers (``kv_fp8``): a decoding slot's payload equal to
    its device rows byte for byte after pack and unpack, its array bodies
    a quarter of the same rows packed from f32 tiers; the warm-migrated fp8
    serve's tokens against the unmigrated one's printed, with no limit (a
    resumed prefill reads its own rows at full precision where the decode
    read them fp8-rounded, in the reference too). Returns the launches of
    (a), with (d)'s fp8 forms."""
    import copy

    import numpy as np

    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.serving import (Engine, FleetChaosConfig, FleetChaosInjector, HandoffError,
                                     LocalTransport, Replica, Request, Router)

    label = "falcon3-1b sessions"
    specs = paged_requests(cfg.vocab_size)
    kw = dict(hot_cap=32, max_len=192, prefill_chunk=32, slots=4, sync_every=8, paged=True,
              page_size=32)
    n_l = cfg.n_layers

    def reqs():
        return [Request(rid, t, n) for rid, t, n in specs]

    def counted_engine(c, name):
        eng = Engine(c, packed, **kw)
        return Replica(name, eng), counting_waves(eng), counting_steps(eng)

    def migrate(c, rows_of_slot=False):
        """A's serve up to the drain; (replica, finished, drained, payloads,
        the device rows of one decoding slot when asked, its rid)."""
        rep, waves, steps = counted_engine(c, "A")
        rep.start()
        for r in reqs():
            rep.submit(r)
        while not (len(rep.ctx.finished) == 4 and rep.ctx.sched.active_slots()
                   and not rep.ctx.prefilling):
            check(rep.busy(), f"{label}: A went idle before r4-r7 decoded")
            rep.step()
        done = rep.take_finished()
        probe = None
        if rows_of_slot:
            s = rep.ctx.sched.active_slots()[-1]
            probe = (rep.ctx.sched.slot_req[s].rid, slot_rows(torch, rep.ctx, s))
        drained, handoffs = rep.drain(with_handoffs=True)
        tree_only(rep.engine, f"{label} A")
        return rep, done, drained, handoffs, probe, waves, steps

    def resume(c, drained, handoffs, transport, corrupt=False):
        rep, waves, steps = counted_engine(c, "B")
        rep.start()
        seeded, errors = {}, 0
        for r in drained:
            if r.rid in handoffs:
                if corrupt:
                    transport.corrupt_next()
                try:
                    seeded[r.rid] = rep.import_handoff(r.tokens, transport.send(handoffs[r.rid]))
                except HandoffError:
                    errors += 1
            check(rep.submit(r), f"{label}: B shed request {r.rid}")
        while rep.busy():
            rep.step()
        tree_only(rep.engine, f"{label} B")
        return rep, rep.take_finished(), seeded, errors, waves, steps

    def equal(fins, want):
        return sum(f.outcome == "finished" and np.array_equal(f.tokens, want[f.rid]) for f in fins)

    # (a) warm migration
    out = {}

    def warm():
        out["a"] = migrate(cfg)
        drained, handoffs = out["a"][2], out["a"][3]
        out["cold_in"] = copy.deepcopy(drained)
        out["b"] = resume(cfg, drained, handoffs, LocalTransport())

    _, launches, wall = counted(kernels, warm)
    rep_a, done_a, drained, handoffs, _, waves_a, steps_a = out["a"]
    rep_b, fin_b, seeded, errors, waves_b, steps_b = out["b"]
    same = equal(done_a + fin_b, paged_tokens)
    reused = {f.rid: f.prefix_tokens_reused for f in fin_b}
    lens = {r.rid: len(r.tokens) for r in drained}
    print(f"{label} (a) warm migration A -> B: {wall:.2f} s; A finished "
          f"{sorted(f.rid for f in done_a)} and drained {[r.rid for r in drained]} (folded lengths {lens}), payload bytes "
          f"{ {rid: len(b) for rid, b in handoffs.items()} }, seeded {seeded}, prefix tokens "
          f"reused on B {reused}; tokens equal to the uninterrupted serve on {same}/8; chunk "
          f"waves A {len(waves_a)} + B {len(waves_b)}, decode steps A {len(steps_a)} + B "
          f"{len(steps_b)}; launches {launches}")
    check(same == 8 and len(done_a) + len(fin_b) == 8, f"{label} (a): tokens differ ({same}/8)")
    check(sorted(handoffs) == [4, 5, 6, 7] and sorted(seeded) == [4, 5, 6, 7]
          and all(v > 0 for v in seeded.values()) and errors == 0,
          f"{label} (a): payloads {sorted(handoffs)}, seeded {seeded}, errors {errors}")
    check(all(reused[rid] >= min(seeded[rid], lens[rid] - 1) for rid in seeded),
          f"{label} (a): a resumed request reused less than was seeded: {reused}, {seeded}")
    check(rep_a.engine.weight_loads == 0 and rep_b.engine.weight_loads == 0,
          f"{label} (a): weights were reloaded")
    n_waves, n_steps = len(waves_a) + len(waves_b), len(steps_a) + len(steps_b)
    check(launches[fp.CHUNK_PAGED_KERNEL.symbol] == n_l * n_waves
          and launches[fd.PAGED_KERNEL.symbol] == n_l * n_steps,
          f"{label} (a): paged launches {launches} for {n_waves} waves / {n_steps} steps")
    check(launches[fp.CHUNK_KERNEL.symbol] == 0 and launches[fd.KERNEL.symbol] == 0
          and launches[fp.KERNEL.symbol] == 0,
          f"{label} (a): a contiguous-form attention kernel launched: {launches}")
    check(all(n > 0 for sym, n in launches.items()
              if sym not in (fp.CHUNK_KERNEL.symbol, fd.KERNEL.symbol, fp.KERNEL.symbol)),
          f"{label} (a): a kernel of the path never launched: {launches}")

    # (b) every payload corrupted in flight: cold resume
    t0 = time.perf_counter()
    transport = LocalTransport()
    _, fin_c, seeded_c, errors_c, waves_c, _ = resume(cfg, out["cold_in"], handoffs, transport,
                                                      corrupt=True)
    same = equal(done_a + fin_c, paged_tokens)
    print(f"{label} (b) corrupted transfer: {time.perf_counter() - t0:.2f} s; {errors_c} of "
          f"{len(handoffs)} imports raised HandoffError ({transport.corrupted} corrupted in "
          f"flight), resumed cold: tokens equal to the uninterrupted serve on {same}/8; B's "
          f"chunk waves warm {len(waves_b)} against cold {len(waves_c)}")
    check(errors_c == len(handoffs) and not seeded_c and same == 8,
          f"{label} (b): errors {errors_c}, seeded {seeded_c}, tokens equal {same}/8")
    check(len(waves_b) < len(waves_c), f"{label}: the warm resume spared no chunk wave "
                                       f"({len(waves_b)} against {len(waves_c)})")

    # (c) a router over two replicas under fleet chaos and a stale heartbeat
    for seed in SESSION_SEEDS:
        t0 = time.perf_counter()
        now = {"t": 0.0}

        def clock():
            now["t"] += 0.005
            return now["t"]

        reps = [Replica(f"r{i}", Engine(cfg, packed, **kw), clock=clock) for i in range(2)]
        router = Router(reps, seed=seed, clock=clock, sleep=lambda s: None,
                        straggler_drain=False, heartbeat_timeout=5.0)
        chaos = FleetChaosInjector(FleetChaosConfig(seed=seed, kill_rate=0.3, corrupt_rate=1.0,
                                                    max_kills=1))
        stale = []

        def on_tick(r):
            rep = r.replicas["r1"]
            if (not stale and not rep.dead and rep.busy()
                    and any(s not in rep.ctx.prefilling for s in rep.ctx.sched.active_slots())):
                rep.heartbeat = clock() - 100.0  # r1's heartbeat goes stale
                stale.append(r.stats.ticks)
            chaos.on_tick(r)  # the fleet invariants after every tick

        fins = router.serve(reqs(), on_tick=on_tick)
        same = equal(fins, paged_tokens)
        st = router.stats
        print(f"{label} (c) router, seed {seed}: {time.perf_counter() - t0:.2f} s; kills "
              f"{chaos.kills}, r1's heartbeat stale at tick {stale}; {st}; outcomes "
              f"{sorted(set(f.outcome for f in fins))}; tokens equal to the uninterrupted serve "
              f"on {same}/8; fleet invariants green after {st.ticks} ticks")
        check(len(fins) == 8 and same == 8, f"{label} (c) seed {seed}: tokens equal {same}/8")
        check(chaos.kills and st.cold_migrations > 0 and st.drains >= 1
              and st.handoff_corruptions >= 1,
              f"{label} (c) seed {seed}: no kill, cold migration, drain or corrupted handoff: {st}")
        check(all(r.engine.weight_loads == 0 for r in reps), f"{label} (c): weights reloaded")

    # (d) fp8 tiers
    t0 = time.perf_counter()
    c8 = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    want8 = {f.rid: f.tokens for f in Engine(c8, packed, **kw).serve(reqs())}
    fp8_kernels = kernels + [fd.FP8_PAGED_KERNEL, fp.FP8_CHUNK_PAGED_KERNEL]

    def warm8():
        out["a8"] = migrate(c8, rows_of_slot=True)
        out["b8"] = resume(c8, out["a8"][2], out["a8"][3], LocalTransport())

    _, launches8, _ = counted(fp8_kernels, warm8)
    _, done8, _, handoffs8, (rid, rows), waves8a, steps8a = out["a8"]
    _, fin8, seeded8, _, waves8b, steps8b = out["b8"]
    states = kvc.unpack_slot_state(handoffs8[rid])
    check(all(states[k][n].dtype == kvc.FP8 and kvc._bytes_of(kvc.raw(states[k][n]))
              == kvc._bytes_of(rows[k][n]) for k in states for n in rows[k]),
          f"{label} (d): rid {rid}'s unpacked payload differs from its device rows")
    as_f32 = {k: {n: (v.float() if isinstance(v, torch.Tensor) else v) for n, v in st.items()}
              for k, st in states.items()}
    blob32 = kvc.pack_slot_state(as_f32, 32)
    body8 = sum(states[k][n].numel() for k in states for n in rows[k])
    body32 = sum(as_f32[k][n].numel() * 4 for k in states for n in rows[k])
    same8 = equal(done8 + fin8, want8)
    print(f"{label} (d) fp8 tiers: rid {rid}'s payload {len(handoffs8[rid])} bytes (array bodies "
          f"{body8}), the same rows from f32 tiers {len(blob32)} bytes (bodies {body32}, "
          f"{body32 / body8:g}x), unpacked equal to the device rows byte for byte; seeded "
          f"{seeded8}; the warm-migrated fp8 serve against the unmigrated one: tokens equal on "
          f"{same8}/8 (printed, no limit); {time.perf_counter() - t0:.2f} s; launches {launches8}")
    # the frames differ only in the dtype names: 'float32' is 6 bytes
    # shorter than 'float8_e4m3fn', once per array
    n_arrays = sum(len(rows[k]) for k in rows)
    check(body32 == 4 * body8
          and len(blob32) - len(handoffs8[rid]) == body32 - body8 - 6 * n_arrays,
          f"{label} (d): payload {len(handoffs8[rid])} bytes, from f32 tiers {len(blob32)}: "
          f"the fp8 bodies are not a quarter of f32's")
    check(all(v > 0 for v in seeded8.values()) and len(done8) + len(fin8) == 8,
          f"{label} (d): seeded {seeded8}")
    n_waves8, n_steps8 = len(waves8a) + len(waves8b), len(steps8a) + len(steps8b)
    check(launches8[fp.FP8_CHUNK_PAGED_KERNEL.symbol] == n_l * n_waves8
          and launches8[fd.FP8_PAGED_KERNEL.symbol] == n_l * n_steps8
          and launches8[fp.CHUNK_PAGED_KERNEL.symbol] == 0
          and launches8[fd.PAGED_KERNEL.symbol] == 0,
          f"{label} (d): fp8 launches {launches8} for {n_waves8} waves / {n_steps8} steps")
    return {**launches, fd.FP8_PAGED_KERNEL.symbol: launches8[fd.FP8_PAGED_KERNEL.symbol],
            fp.FP8_CHUNK_PAGED_KERNEL.symbol: launches8[fp.FP8_CHUNK_PAGED_KERNEL.symbol]}


# ---------------------------------------------------------------------------
# the SDC plane: NaN rows through the path's kernels, then the scrub ladder
# ---------------------------------------------------------------------------


def nan_rows_phase(torch, gen, theta):
    """Each kernel of the SDC path on an input row that holds a NaN,
    against its plain version on the same inputs: the same rows come out
    finite (the poisoned row never does), and the finite rows are
    bit-identical. Kernel 1's act-quant form (falcon3-1b's four leaf shapes
    at M 1 / 6 / 32, f32 and bf16: its absmax keeps a NaN since this
    slice) and kernel 4 (a NaN row scale), A1b (the paged fused decode),
    A3b (the paged chunked prefill), the LoRA kernel and rms_norm at
    falcon3-1b's shapes. Without that, a NaN upset would reach the logits
    as finite garbage on the card and the sentinel would never latch."""
    from repro_torch.core import kv_cache as kvc
    from repro_torch.core.ternary import act_quant
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm

    cases = 0

    def finite_rows(t):
        return torch.isfinite(t.float()).reshape(t.shape[0], -1).all(dim=-1).tolist()

    def agrees(label, fn, args, row):
        nonlocal cases
        args = [a.clone() for a in args]
        args[0][row].view(-1)[0] = float("nan")
        got, want = fn(*args, impl="auto"), fn(*args, impl="plain")
        torch.cuda.synchronize()
        fin = finite_rows(want)
        keep = torch.as_tensor(fin, device=got.device)
        check(finite_rows(got) == fin and not fin[row] and torch.equal(got[keep], want[keep]),
              f"NaN rows: {label}: finite rows {finite_rows(got)} against the plain version's "
              f"{fin}, or a finite row differs")
        cases += 1

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    for k, n in DECODE_SHAPES:
        _, (p,), col = projection_operands(torch, gen, 1, k, n)
        for m in (1, 6, 32):
            for dtype in (torch.float32, torch.bfloat16):
                agrees(f"ternary_matmul_actq M={m} K={k} N={n} {dtype}",
                       lambda x, impl: tm.ternary_matmul_actq(x, p, col, k=k, impl=impl),
                       [rand(m, k, dtype=dtype)], m // 2)
            q = act_quant(rand(m, k))
            agrees(f"ternary_matmul_known M={m} K={k} N={n}",
                   lambda xs, impl: tm.ternary_matmul_fused(q.xq, p, xs, col, k=k, impl=impl),
                   [q.scale], m - 1)
    x, w = rand(6, 2048), rand(2048) + 1.0
    agrees("rms_norm", lambda x, impl: krms.rms_norm(x, w, 1e-6, impl=impl), [x], 2)
    a, b = rand(2048, 16) * 0.1, rand(16, 2048) * 0.1
    agrees("lora_delta", lambda x, impl: kl.lora_delta(x, a, b, 2.0, impl=impl), [x], 4)
    cache = kvc.init_paged_cache(4, 32, 160, (4, 256), page_size=32, device="cuda")
    for tier in (cache.hot_k, cache.hot_v, cache.pool_k, cache.pool_v):
        tier.copy_(rand(*tier.shape))
    cache.lengths.copy_(torch.tensor([80, 40, 100, 33], dtype=torch.int32, device="cuda"))
    k_new, v_new = rand(4, 4, 256), rand(4, 4, 256)
    active = torch.ones(4, dtype=torch.bool, device="cuda")

    def fresh():
        return type(cache)(*(t.clone() for t in cache))

    agrees("flash_decode_gqa_fused_paged (A1b)",
           lambda q, impl: fd.flash_decode_attention(q, fresh(), k_new=k_new, v_new=v_new,
                                                     active=active, rope_theta=theta,
                                                     impl=impl)[0], [rand(4, 8, 256)], 1)
    kc, vc = rand(4, 8, 4, 256), rand(4, 8, 4, 256)
    n_valid = torch.tensor([8, 3, 8, 5], dtype=torch.int32, device="cuda")
    agrees("flash_prefill_chunk_paged (A3b)",
           lambda q, impl: fp.flash_prefill_attention(q, kc, vc, fresh(), n_valid,
                                                      rope_theta=theta, impl=impl)[0],
           [rand(4, 8, 8, 256)], 2)
    print(f"NaN rows: {cases} cases (kernel 1's act-quant form and kernel 4 at falcon3-1b's "
          f"shapes, M 1 / 6 / 32; A1b; A3b; LoRA; rms_norm): the poisoned row non-finite and "
          f"every other row bit-identical to the plain version")


SDC_CUT = 4  # the depth of the SDC phase's chaos and fleet runs, (e) and (f)


def sdc_phase(torch, cfg, packed, kernels, smi, paged_tokens):
    """falcon3-1b's SDC plane at full width and depth, in the paged phase's
    geometry (hot 32, max_len 192, page size 32, ``prefill_chunk`` 32, 4
    slots, ``sync_every`` 8), f32 tiers, on ``paged_requests``, each run
    held to ``paged_tokens`` (the uninterrupted shared serve), with
    ``IntegrityConfig(scrub_every=4)`` unless said otherwise:

    (a) integrity on, no fault: tokens equal on 8/8, nothing detected, so
    kernel 4's ABFT probe gives no false positive at full width; its
    launches per weight scrub (one per layer and leaf path: 72), the
    scrubs, one weight and one page scrub's wall, and the serve's wall
    against the same serve without integrity; the probe agrees with its
    plain version on the clean and on a flipped tree. (b) a bit flipped by
    ``flip_packed_bit`` at iteration 2: detected within one scrub period,
    one reload, the golden copy restored, 8/8. (c) one bit flipped in a
    crc-stamped page through ``write_pool_pages``: the page quarantined,
    its readers rolled back, 8/8. (d) a NaN poked into a decoding slot's
    hot K: the sentinel latches on the card, that request ends
    ``"numerics"`` and the other seven equal. (e) a ``ChaosInjector`` with
    the three planes at the reference test's rates (0.2 / 0.1 / 0.1, seed
    0) and check 9 every iteration: every finished request equal, and
    ``sdc_detected`` = reloads + quarantined pages + contained slots. (f) a
    ``Router`` over two replicas, one of them with ``max_weight_strikes``
    2 under ``RomFaultInjector(7, rate=1.0, reassert=None)``: one SDC
    retirement, the retired replica dead and unhealthy, 8/8, the fleet
    invariants after every tick. (e) and (f) run at SDC_CUT layers, held
    to a faultless serve at that depth (at 18 layers they took 31.7 of the
    phase's 73.9 s on an H100). Returns the launches of (a)."""
    import numpy as np

    from repro_torch.core import bitlinear
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import pack as pack_lib
    from repro_torch.serving import (ChaosConfig, ChaosInjector, Engine, Replica, Request, Router,
                                     check_fleet_invariants, check_serving_invariants)
    from repro_torch.serving import sdc

    label = "falcon3-1b sdc"
    specs = paged_requests(cfg.vocab_size)
    kw = dict(hot_cap=32, max_len=192, prefill_chunk=32, slots=4, sync_every=8, paged=True,
              page_size=32)
    n_leaves = 4 * cfg.n_layers  # wqkv, wo, wgu, down in every layer

    def reqs():
        return [Request(rid, t, n) for rid, t, n in specs]

    def engine(scrub_every=4, c=cfg, p=packed, **ic):
        return Engine(c, p, integrity=sdc.IntegrityConfig(scrub_every=scrub_every, **ic), **kw)

    def timing(eng, name):
        calls = []
        fn = getattr(eng, name)

        def timed_call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t)
            return out

        setattr(eng, name, timed_call)
        return calls

    def session(eng, hook=None):
        ctx = eng.start_session(reqs(), on_iteration=hook)
        while eng.run_iteration(ctx):
            pass
        eng.finish_session(ctx)
        return ctx

    def equal(fins, want=paged_tokens):
        return sum(f.outcome == "finished" and np.array_equal(f.tokens, want[f.rid])
                   for f in fins)

    def pool_ok(ctx, what):
        pool, tp = ctx.pool, set(ctx.ptree.tree_pages())
        check(all(pool.refs[p] == (1 if p in tp else 0) for p in range(pool.n_pages))
              and pool.available() == pool.n_pages - len(tp) - len(pool.quarantined),
              f"{label} {what}: pages other than the tree's held after the serve")

    # (a) integrity on, no fault; the same serve without integrity first
    t0 = time.perf_counter()
    plain_serve = Engine(cfg, packed, **kw)
    t1 = time.perf_counter()
    base = {f.rid: f for f in plain_serve.serve(reqs())}
    torch.cuda.synchronize()
    wall_off = time.perf_counter() - t1
    check(sum(np.array_equal(f.tokens, paged_tokens[r]) for r, f in base.items()) == 8,
          f"{label}: the serve without integrity differs from the paged phase's")
    t1 = time.perf_counter()
    eng = engine()
    t_build = time.perf_counter() - t1
    w_calls, p_calls = timing(eng, "_scrub_weights"), timing(eng, "_scrub_pages")
    ctx_a, launches, wall_on = counted(kernels + [tm.KNOWN_KERNEL], lambda: session(eng))
    st = ctx_a.stats
    same = equal(ctx_a.finished)
    per_scrub = launches[tm.KNOWN_KERNEL.symbol] / max(len(w_calls), 1)
    print(f"{label} (a) integrity on, no fault: tokens equal to the uninterrupted serve on "
          f"{same}/8; sdc_detected {st.sdc_detected}; {len(w_calls)} weight scrubs and "
          f"{len(p_calls)} page scrubs in {st.iterations} iterations ({st.pages_scrubbed} page "
          f"checks); kernel-4 launches {launches[tm.KNOWN_KERNEL.symbol]} = {per_scrub:g} per "
          f"weight scrub (M = 1, one per layer and leaf path); a weight scrub "
          f"{1e3 * np.mean(w_calls):.1f} ms (crc32 of "
          f"{sum(s.size for _, s in pack_lib.iter_packed_leaves(eng.params))} packed bytes on "
          f"the host + the ABFT probe), a page scrub {1e3 * np.mean(p_calls):.2f} ms; serve "
          f"{wall_on:.2f} s against {wall_off:.2f} s without integrity ({wall_on / wall_off:.2f}x) "
          f"in this call; engine build with the stamps and the golden copy {t_build:.2f} s; "
          f"launches {launches}")
    check(same == 8 and st.sdc_detected == 0 and st.weight_reloads == 0,
          f"{label} (a): tokens equal {same}/8, sdc_detected {st.sdc_detected}")
    check(len(w_calls) > 0 and launches[tm.KNOWN_KERNEL.symbol] == n_leaves * len(w_calls),
          f"{label} (a): {launches[tm.KNOWN_KERNEL.symbol]} kernel-4 launches for "
          f"{len(w_calls)} weight scrubs (want {n_leaves} each)")
    check(all(n > 0 for sym, n in launches.items()
              if sym not in (fd.KERNEL.symbol, fp.CHUNK_KERNEL.symbol, fp.KERNEL.symbol)),
          f"{label} (a): a kernel of the path never launched: {launches}")
    check(eng.weight_loads == 0 and not eng.unhealthy, f"{label} (a): weights reloaded")
    pool_ok(ctx_a, "(a)")
    # the probe against its plain version, clean and with one flipped bit
    path0 = next(iter(pack_lib.iter_packed_leaves(eng.params)))[0]
    flipped = sdc.flip_packed_bit(eng.params, path0, 5, 2)
    for tree, want in ((eng.params, []), (flipped, [path0])):
        got, plain = sdc.abft_verify_tree(tree), sdc.abft_verify_tree(tree, impl="plain")
        check(got == plain == want, f"{label}: the probe {got}, its plain version {plain}, "
                                    f"want {want}")
    for path, stack in pack_lib.iter_packed_leaves(eng.params):
        sub = stack.layers[-1]
        x = torch.ones((1, sub.k), device="cuda")
        y, y_plain = (bitlinear.abft_check(sub, x, impl=impl)[0] for impl in ("auto", "plain"))
        check(torch.equal(y, y_plain), f"{label}: the probe's y differs from plain on {path}")
    del flipped
    print(f"{label}: the kernel-4 probe and its plain version flag the same paths on the clean "
          f"tree ([]) and with {path0} flipped ([{path0}]), y bit-identical on every path")

    # (b) one stuck ROM bit planted at iteration 2
    t0b = time.perf_counter()
    eng = engine()
    planted, detected = [], []

    def plant(ctx):
        if ctx.iteration == 2 and not planted:
            eng.params = sdc.flip_packed_bit(eng.params, path0, 5, 2)
            planted.append(ctx.iteration)
        if ctx.stats.weight_reloads and not detected:
            detected.append(ctx.iteration)

    ctx = session(eng, plant)
    same = equal(ctx.finished)
    print(f"{label} (b) weight flip ({path0}, byte 5, bit 2) at iteration {planted}: detected at "
          f"iteration {detected}, reloads {ctx.stats.weight_reloads}, strikes "
          f"{eng.weight_fault_strikes}, rollbacks {ctx.stats.preemptions}; tokens equal on "
          f"{same}/8; {time.perf_counter() - t0b:.2f} s")
    check(planted and detected and detected[0] <= planted[0] + 4
          and ctx.stats.weight_reloads == 1 and eng.weight_fault_strikes == 1
          and pack_lib.verify_packed(eng.params) == [] and same == 8,
          f"{label} (b): planted {planted}, detected {detected}, reloads "
          f"{ctx.stats.weight_reloads}, tokens equal {same}/8")

    # (c) one bit of a crc-stamped page
    t0c = time.perf_counter()
    eng = engine()
    hit = []

    def decay(ctx):
        if hit or not ctx.page_crc:
            return
        page = sorted(ctx.page_crc)[0]
        cache = ctx.state.cache[next(k for k in sorted(ctx.state.cache)
                                     if hasattr(ctx.state.cache[k], "page_table"))]
        kp, vp = kvc.gather_pool_pages(cache, [page])
        kp.view(torch.uint8).view(-1)[0] ^= 0x10
        kvc.write_pool_pages(cache, [page], kp, vp)
        hit.append(page)

    ctx = session(eng, decay)
    same = equal(ctx.finished)
    print(f"{label} (c) page {hit} flipped through write_pool_pages: quarantined "
          f"{sorted(ctx.pool.quarantined)}, sdc_detected {ctx.stats.sdc_detected}, rollbacks "
          f"{ctx.stats.preemptions}; tokens equal on {same}/8; {time.perf_counter() - t0c:.2f} s")
    check(hit and set(hit) <= ctx.pool.quarantined and ctx.stats.sdc_detected >= 1 and same == 8,
          f"{label} (c): flipped {hit}, quarantined {ctx.pool.quarantined}, equal {same}/8")
    check_serving_invariants(ctx, sdc_budget=dict(page_flips=len(hit)))
    pool_ok(ctx, "(c)")

    # (d) a NaN upset in a decoding slot
    t0d = time.perf_counter()
    eng = engine()
    poked = []

    def poke(ctx):
        decoding = [s for s in ctx.sched.active_slots() if s not in ctx.prefilling]
        if not poked and decoding and sdc.inject_activation_nan(ctx, decoding[0]):
            poked.append(ctx.sched.slot_req[decoding[0]].rid)

    ctx = session(eng, poke)
    outcomes = {f.rid: f.outcome for f in ctx.finished}
    same = equal(ctx.finished)
    print(f"{label} (d) NaN poked into rid {poked}'s hot K: outcomes {outcomes}, slots "
          f"contained {ctx.stats.slots_quarantined}; the other requests equal on {same}/7; "
          f"{time.perf_counter() - t0d:.2f} s")
    check(len(poked) == 1 and outcomes[poked[0]] == "numerics"
          and ctx.stats.slots_quarantined == 1 and same == 7,
          f"{label} (d): poked {poked}, outcomes {outcomes}, equal {same}/7")
    check_serving_invariants(ctx, sdc_budget=dict(nan_pokes=1))

    # (e) the three planes at once, check 9 every iteration, at SDC_CUT layers
    t0e = time.perf_counter()
    c_cut = dataclasses.replace(cfg, n_layers=SDC_CUT)
    p_cut = dict(packed, blocks=packed["blocks"][:SDC_CUT])
    cut_tokens = {f.rid: f.tokens for f in Engine(c_cut, p_cut, **kw).serve(reqs())}
    eng = engine(max_weight_strikes=10 ** 6, c=c_cut, p=p_cut)
    chaos = ChaosInjector(eng, ChaosConfig(seed=0, weight_flip_rate=0.2, page_decay_rate=0.1,
                                           nan_rate=0.1))
    ctx = session(eng, chaos.on_iteration)
    chaos.release_all(ctx)
    check_serving_invariants(ctx, sdc_budget=chaos.sdc_budget())
    st = ctx.stats
    fins = [f for f in ctx.finished if f.outcome == "finished"]
    same = equal(fins, cut_tokens)
    print(f"{label} (e) SDC chaos at {SDC_CUT} layers (seed 0; weight 0.2, pages 0.1, NaN 0.1): injected "
          f"{chaos.sdc_budget()}; detected {st.sdc_detected} = reloads {st.weight_reloads} + "
          f"quarantined pages {len(ctx.pool.quarantined)} + contained slots "
          f"{st.slots_quarantined}; rollbacks {st.preemptions}, iterations {st.iterations}; "
          f"outcomes {sorted((f.rid, f.outcome) for f in ctx.finished)}; finished requests "
          f"equal on {same}/{len(fins)}; {time.perf_counter() - t0e:.2f} s")
    check(len(ctx.finished) == 8 and same == len(fins)
          and {f.outcome for f in ctx.finished} <= {"finished", "numerics"},
          f"{label} (e): finished equal {same}/{len(fins)}")
    check(st.sdc_detected == st.weight_reloads + len(ctx.pool.quarantined) + st.slots_quarantined
          and st.slots_quarantined <= chaos.nan_pokes and st.sdc_detected > 0,
          f"{label} (e): the detection ledger does not reconcile: {st}")

    # (f) a replica that strikes out is retired; its work finishes on the other
    t0f = time.perf_counter()
    reps = [Replica("a", engine(max_weight_strikes=2, c=c_cut, p=p_cut)),
            Replica("b", engine(max_weight_strikes=10 ** 6, c=c_cut, p=p_cut))]
    router = Router(reps, seed=0, sleep=lambda s: None, straggler_drain=False)
    rom = sdc.RomFaultInjector(7, rate=1.0, reassert=None)

    def on_tick(r):
        a = r.replicas["a"]
        if not a.dead and a.ctx is not None:
            rom.on_iteration(a.engine, a.ctx)
        check_fleet_invariants(r)

    fins = router.serve(reqs(), on_tick=on_tick)
    check_fleet_invariants(router)
    same = equal(fins, cut_tokens)
    print(f"{label} (f) router at {SDC_CUT} layers, replica a under RomFaultInjector(7, rate 1.0, "
          f"reassert None): "
          f"{router.stats}; a dead {reps[0].dead}, unhealthy {reps[0].engine.unhealthy} after "
          f"{reps[0].engine.weight_fault_strikes} strikes ({rom.injected} bits asserted); tokens "
          f"equal on {same}/8; {time.perf_counter() - t0f:.2f} s")
    check(router.stats.sdc_retirements == 1 and router._sdc_retired == {"a"} and reps[0].dead
          and reps[0].engine.unhealthy and not reps[1].dead and len(fins) == 8 and same == 8,
          f"{label} (f): retirements {router.stats.sdc_retirements}, equal {same}/8")
    print(f"{label}: {time.perf_counter() - t0:.2f} s on {smi}")
    return launches


OVERLOAD_LENGTHS = (40, 56, 72, 88, 104, 64, 48, 96)
# The reference engine's control-plane counters for this geometry (hot 32,
# max_len 192, prefill_chunk 32, page size 32, 4 slots, sync_every 8,
# 64 new tokens each, no stop token): (preemptions, recompute_tokens,
# grown_pages, iterations, each request's n_preemptions), by pool size
# (None: the default pool). The control plane reads no token value, so
# they hold for any weights and prompts; tests/test_torch_overload.py
# holds the port's control plane against the reference engine's.
OVERLOAD_WANT = {None: (0, 0, 16, 16, [0] * 8), 6: (19, 1256, 16, 38, [0, 0, 3, 2, 1, 7, 4, 2])}
# the depth of the overload phase's checks past (a) and (b): 1 since the
# frontend families phase (2 before; the run's time)
OVERLOAD_CUT = 1


def overload_requests(vocab):
    """(rid, prompt) of the overload phase: prompts of OVERLOAD_LENGTHS
    tokens drawn in order from one seeded generator; no two share a
    prefix."""
    import numpy as np

    rng = np.random.default_rng(11)
    return [(rid, rng.integers(0, vocab, (n,)).astype(np.int32))
            for rid, n in enumerate(OVERLOAD_LENGTHS)]


def overload_counters(eng, fin):
    st = eng.last_stats
    return (st.preemptions, st.recompute_tokens, st.grown_pages, st.iterations,
            [fin[rid].n_preemptions for rid in sorted(fin)])


def tree_only(eng, label):
    """Only prefix-tree pages are held once every slot has retired."""
    pool, tree = eng._last_pool, eng._last_ptree
    tp = set(tree.tree_pages())
    check(all(pool.refs[p] == (1 if p in tp else 0) for p in range(pool.n_pages))
          and pool.available() == pool.n_pages - len(tp),
          f"{label}: pages other than the tree's still held after the serve")


def overload_phase(torch, cfg, packed, kernels, smi):
    """falcon3-1b under page pressure (the overload control plane): paged,
    page size 32, hot 32, max_len 192, ``prefill_chunk`` 32, 4 slots,
    ``sync_every`` 8, eight requests of OVERLOAD_LENGTHS prompt tokens and
    64 new tokens each.

    At full width and depth: (a) the default pool, no preemption; (b)
    ``n_pages=6`` (each request's peak of 3-5 pages fits alone) with
    ``check_serving_invariants`` after every iteration: every outcome
    finished, preemptions and recompute tokens > 0, the requests'
    ``n_preemptions`` summing to the stats, tokens equal to (a) on 8/8
    requests, only tree pages held at the end, 18 paged chunk launches per
    wave and 18 paged decode launches per step; the counters of (a) and (b)
    equal to the reference engine's (OVERLOAD_WANT).

    At the depth cut to OVERLOAD_CUT layers (the run's time: the plain
    versions take ~0.6 s a step at full depth): (b) equal to its plain run,
    with the same
    counters; (c) a priority-1 request submitted last preempts a weaker
    slot, and every request equals the unpressured serve; (d) an injected
    clock expires one queued and one active request (partial tokens, a
    prefix of the unpressured serve's), ``Engine.cancel`` from the hook
    ends one request mid-decode and one mid-prefill (``sync_every`` 2, so
    a 72-token prompt spans iterations), pages return; ``max_queue=2``
    sheds six requests as ``rejected``; (e) (b) over fp8 tiers equals its
    own plain run, fp8 (b) against fp8 (a) printed (a chunk reads its own
    keys at full precision and the cache at fp8, so recompute legitimately
    differs there). Returns the launches of (b) at full depth and the
    tokens of (a) by rid, at full depth and at the depth cut."""
    import numpy as np

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.serving.chaos import check_serving_invariants
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    label = "falcon3-1b overload"
    specs = overload_requests(cfg.vocab_size)
    kw = dict(hot_cap=32, max_len=192, prefill_chunk=32, slots=4, sync_every=8, paged=True,
              page_size=32)

    def reqs(per_rid=None):
        return [Request(rid, t, 64, **(per_rid or {}).get(rid, {})) for rid, t in specs]

    def stats_line(eng):
        st = eng.last_stats
        return (f"preemptions {st.preemptions}, recompute_tokens {st.recompute_tokens}, "
                f"grown_pages {st.grown_pages}, iterations {st.iterations}, iter_p50 "
                f"{st.iter_p50 * 1e3:.2f} ms, iter_max {st.iter_max * 1e3:.2f} ms")

    def same_tokens(fin, other, rids=range(len(specs))):
        return sum(np.array_equal(fin[rid].tokens, other[rid].tokens) for rid in rids)

    def serve(c, p, per_rid=None, **extra):
        eng = Engine(c, p, **{**kw, **extra})
        t0 = time.perf_counter()
        fin = {f.rid: f for f in eng.serve(reqs(per_rid), on_iteration=check_serving_invariants)}
        torch.cuda.synchronize()
        return eng, fin, time.perf_counter() - t0

    def want_counters(eng, fin, n_pages, what):
        got = overload_counters(eng, fin)
        check(got == OVERLOAD_WANT[n_pages],
              f"{label} {what}: counters {got} != the reference's {OVERLOAD_WANT[n_pages]}")

    # (a) the default pool, full depth
    eng_a = Engine(cfg, packed, **kw)
    fin_a, _, wall = counted(kernels, lambda: eng_a.serve(reqs()))
    fin_a = {f.rid: f for f in fin_a}
    print(f"{label} (a) default pool ({eng_a._last_pool.n_pages} pages), prompts "
          f"{list(OVERLOAD_LENGTHS)} + 64: {wall:.2f} s; {stats_line(eng_a)}")
    want_counters(eng_a, fin_a, None, "(a)")
    check(all(f.outcome == "finished" and len(f.tokens) == 64 for f in fin_a.values()),
          f"{label} (a): a request did not finish")

    # (b) six pages, full depth: eviction, preemption, recompute
    eng_b = Engine(cfg, packed, n_pages=6, **kw)
    waves, steps = counting_waves(eng_b), counting_steps(eng_b)
    checked = []

    def invariants(ctx):
        check_serving_invariants(ctx)
        checked.append(ctx.iteration)

    fin_b, launches, wall = counted(kernels, lambda: eng_b.serve(reqs(), on_iteration=invariants))
    fin_b = {f.rid: f for f in fin_b}
    st = eng_b.last_stats
    print(f"{label} (b) n_pages=6: {wall:.2f} s, {len(waves)} chunk waves, {len(steps)} decode "
          f"steps; {stats_line(eng_b)}; per-request n_preemptions "
          f"{[fin_b[r].n_preemptions for r, _ in specs]}; invariants green after "
          f"{len(checked)} iterations; launches {launches}")
    check(all(f.outcome == "finished" and len(f.tokens) == 64 for f in fin_b.values()),
          f"{label} (b): outcomes {[f.outcome for f in fin_b.values()]}")
    check(st.preemptions > 0 and st.recompute_tokens > 0, f"{label} (b): no preemption")
    check(sum(f.n_preemptions for f in fin_b.values()) == st.preemptions,
          f"{label} (b): per-request preemptions do not sum to the stats")
    check(len(checked) == st.iterations, f"{label} (b): the hook missed an iteration")
    same = same_tokens(fin_b, fin_a)
    print(f"{label}: (b) against (a): greedy tokens equal on {same}/8 requests")
    check(same == 8, f"{label}: preempted run differs from the unpressured one ({same}/8)")
    tree_only(eng_b, f"{label} (b)")
    want_counters(eng_b, fin_b, 6, "(b)")
    n_l = cfg.n_layers
    check(launches[fp.CHUNK_PAGED_KERNEL.symbol] == n_l * len(waves)
          and launches[fd.PAGED_KERNEL.symbol] == n_l * len(steps),
          f"{label} (b): paged launches {launches} for {len(waves)} waves / {len(steps)} steps")
    check(all(n > 0 for sym, n in launches.items()
              if sym not in (fp.CHUNK_KERNEL.symbol, fd.KERNEL.symbol, fp.KERNEL.symbol)),
          f"{label} (b): a kernel of the path never launched: {launches}")

    # the depth cut
    cut = OVERLOAD_CUT
    c4 = dataclasses.replace(cfg, n_layers=cut)
    p4 = dict(packed, blocks=packed["blocks"][:cut])
    plain4 = dataclasses.replace(c4, bitnet=dataclasses.replace(c4.bitnet, impl="plain"))
    e_a4, f_a4, t_a4 = serve(c4, p4)
    e_b4, f_b4, t_b4 = serve(c4, p4, n_pages=6)
    e_p4, f_p4, t_p4 = serve(plain4, p4, n_pages=6)
    same, vs_a = same_tokens(f_b4, f_p4), same_tokens(f_b4, f_a4)
    print(f"{label} at {cut} layers: (a) {t_a4:.2f} s, (b) {t_b4:.2f} s, plain (b) {t_p4:.2f} s; "
          f"(b) against its plain run: tokens equal on {same}/8, against (a) {vs_a}/8")
    check(same == 8 and vs_a == 8, f"{label} at {cut} layers: (b) differs ({same}, {vs_a} of 8)")
    for e, f, n_pages, what in ((e_a4, f_a4, None, f"(a) at {cut} layers"),
                                (e_b4, f_b4, 6, f"(b) at {cut} layers"),
                                (e_p4, f_p4, 6, f"plain (b) at {cut} layers")):
        want_counters(e, f, n_pages, what)

    # (c) a priority-1 request submitted last
    eng_c = Engine(c4, p4, n_pages=6, **kw)
    beneficiaries = []
    alloc = eng_c._paged_alloc

    def spy(ctx, n, beneficiary, exclude=()):
        before = ctx.stats.preemptions
        out = alloc(ctx, n, beneficiary, exclude)
        if ctx.stats.preemptions > before:
            beneficiaries.append(beneficiary.rid)
        return out

    eng_c._paged_alloc = spy
    t0 = time.perf_counter()
    fin_c = {f.rid: f for f in eng_c.serve(reqs({7: dict(priority=1)}),
                                           on_iteration=check_serving_invariants)}
    same = same_tokens(fin_c, f_a4)
    print(f"{label} (c) rid 7 at priority 1, {cut} layers: {time.perf_counter() - t0:.2f} s; "
          f"{stats_line(eng_c)}; per-request n_preemptions "
          f"{[fin_c[r].n_preemptions for r, _ in specs]}; rids whose claims preempted "
          f"{beneficiaries}; tokens equal to the unpressured serve on {same}/8")
    check(7 in beneficiaries and fin_c[7].n_preemptions == 0 and same == 8
          and all(f.outcome == "finished" for f in fin_c.values()),
          f"{label} (c): the priority request did not preempt a weaker slot, or tokens differ")

    # (d) deadlines and cancellation (sync_every 2), then the bounded queue
    clock = [0.0]
    eng_d = Engine(c4, p4, clock=lambda: clock[0], **{**kw, "sync_every": 2})
    mid_prefill = []

    def hook(ctx):
        if ctx.iteration == 0:
            mid_prefill.extend(ctx.sched.slot_req[s].rid for s in ctx.prefilling)
            eng_d.cancel(1)  # decoding since this iteration
            eng_d.cancel(2)  # its 72-token prompt still streams
        if ctx.iteration == 3:
            clock[0] = 2.0  # past rid 0's (active) and rid 7's (queued) deadlines
        check_serving_invariants(ctx)

    t0 = time.perf_counter()
    fin_d = {f.rid: f for f in eng_d.serve(
        reqs({0: dict(deadline=1.0), 7: dict(deadline=1.0)}), on_iteration=hook)}
    outcomes = {rid: (f.outcome, len(f.tokens)) for rid, f in sorted(fin_d.items())}
    print(f"{label} (d) deadlines and cancels, {cut} layers: {time.perf_counter() - t0:.2f} s; "
          f"(outcome, tokens) {outcomes}; mid-prefill at the cancel {mid_prefill}; "
          f"{stats_line(eng_d)}")
    check(2 in mid_prefill and 1 not in mid_prefill, f"{label} (d): rid 2 not mid-prefill")
    want = {0: "expired", 1: "cancelled", 2: "cancelled", 7: "expired"}
    for rid, f in fin_d.items():
        check(f.outcome == want.get(rid, "finished"), f"{label} (d): rid {rid} {f.outcome}")
        check(np.array_equal(f.tokens, f_a4[rid].tokens[: len(f.tokens)]),
              f"{label} (d): rid {rid}'s tokens are not a prefix of the unpressured serve's")
    check(0 < len(fin_d[0].tokens) < 64 and 0 < len(fin_d[1].tokens) < 64
          and len(fin_d[2].tokens) == 0 and len(fin_d[7].tokens) == 0
          and all(len(fin_d[r].tokens) == 64 for r in (3, 4, 5, 6)),
          f"{label} (d): partial tokens {outcomes}")
    check((eng_d.last_stats.expired, eng_d.last_stats.cancelled) == (2, 2),
          f"{label} (d): stats {eng_d.last_stats}")
    tree_only(eng_d, f"{label} (d)")
    eng_q, fin_q, _ = serve(c4, p4, max_queue=2)
    shed = sorted(r for r, f in fin_q.items() if f.outcome == "rejected")
    print(f"{label} (d) max_queue=2: rejected {shed}, rids 0 and 1 finished")
    check(shed == [2, 3, 4, 5, 6, 7] and eng_q.last_stats.rejected == 6
          and all(fin_q[r].outcome == "finished" for r in (0, 1))
          and same_tokens(fin_q, f_a4, (0, 1)) == 2
          and all(len(fin_q[r].tokens) == 0 for r in shed), f"{label} (d): shedding {fin_q}")

    # (e) over fp8 tiers
    c8 = dataclasses.replace(c4, bitnet=dataclasses.replace(c4.bitnet, kv_fp8=True))
    plain8 = dataclasses.replace(c8, bitnet=dataclasses.replace(c8.bitnet, impl="plain"))
    e_b8, f_b8, t_b8 = serve(c8, p4, n_pages=6)
    e_p8, f_p8, t_p8 = serve(plain8, p4, n_pages=6)
    e_a8, f_a8, _ = serve(c8, p4)
    same, vs_a = same_tokens(f_b8, f_p8), same_tokens(f_b8, f_a8)
    print(f"{label} (e) fp8 tiers, {cut} layers: (b) {t_b8:.2f} s, its plain run {t_p8:.2f} s: "
          f"tokens equal on {same}/8; against fp8 (a): {vs_a}/8 (printed only: under fp8 a "
          f"recompute reads its own keys at full precision); {stats_line(e_b8)}")
    check(same == 8, f"{label} (e): fp8 (b) differs from its plain run ({same}/8)")
    for e, f, n_pages, what in ((e_b8, f_b8, 6, "fp8 (b)"), (e_p8, f_p8, 6, "plain fp8 (b)"),
                                (e_a8, f_a8, None, "fp8 (a)")):
        want_counters(e, f, n_pages, what)
    return (launches, {rid: f.tokens for rid, f in fin_a.items()},
            {rid: f.tokens for rid, f in f_a4.items()})


FP8_CUT = 4  # the depth of the fp8 phase's plain grouped run and its chunked and paged serves
MAIN_PLAIN_CUT = 4  # the depth of the falcon3-1b generate's plain comparison
PAGED_PLAIN_CUT = 4  # the depth of the paged phase's plain comparison


def fp8_falcon_phase(torch, gen, cfg, packed, prompts, f32_tokens):
    """falcon3-1b at full width and depth over fp8 tiers (``kv_fp8``; the
    same packed weights): (a) grouped ``generate`` 6 x (32 + 96): tokens,
    prefill and first-step logits equal to the plain fp8 run, ledgers at
    the closed form, ``weight_loads == 0``, 18 fp8 fused decodes per step,
    18 fp8-emit prefills per admission and no f32-tier form; the
    post-append fp8 forms on the served caches (the entry-point path,
    contiguous and paged); (b) chunked admission (``prefill_chunk`` 32):
    generate 6 x (96 + 32) equal to the plain fp8 chunked run, 18 fp8 chunk
    launches per wave; (c) paged with prefix sharing (the paged phase's
    eight requests): equal to the plain fp8 shared run, 18 fp8 paged chunk
    launches per wave and 18 fp8 paged decodes per step. fp8 against f32
    tiers, chunked against grouped and shared against unshared under fp8
    are printed, not checked: the kernels attend to a chunk's own keys at
    full precision and to cached keys fp8-rounded, so admission changes
    the key values read (as in the reference). (b) and (c) run at the
    depth cut to FP8_CUT layers. Returns the launch counts of the four
    paths."""
    import numpy as np

    from repro_torch.core import dr_edram
    from repro_torch.core import kv_cache as kvc
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    cfg8 = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    plain8 = dataclasses.replace(cfg8, bitnet=dataclasses.replace(cfg8.bitnet, impl="plain"))
    label, L = "falcon3-1b fp8", cfg.n_layers
    kw = dict(hot_cap=32, max_len=128, slots=6)
    common = [tm.KERNEL, kl.KERNEL, krms.KERNEL]
    eng = Engine(cfg8, packed, **kw)
    eng.generate(prompts[:, :8], max_new_tokens=4)  # warm-up
    res, launches, wall = counted(common + [fd.FP8_KERNEL, fd.KERNEL, fp.FP8_KERNEL, fp.KERNEL],
                                  lambda: eng.generate(prompts, max_new_tokens=96))
    print(f"{label} generate 6 x (32 + 96): {wall:.3f} s, {6 * 96 / wall:.1f} tokens/s, "
          f"launches {launches}")
    check_served(res, cfg8, eng, 128, label)
    check(launches[fd.FP8_KERNEL.symbol] == L * 96 and launches[fp.FP8_KERNEL.symbol] == L
          and launches[fd.KERNEL.symbol] == 0 and launches[fp.KERNEL.symbol] == 0,
          f"{label}: not {L} fp8 decodes per step and {L} fp8 prefills per admission with no "
          f"f32-tier form: {launches}")
    check(all(launches[k.symbol] > 0 for k in common), f"{label}: a kernel never launched")
    tokens = res.tokens.numpy()
    # the plain fp8 run at the depth cut to FP8_CUT layers (the run's time),
    # against the kernel fp8 run at that depth
    p_cut = dict(packed, blocks=packed["blocks"][:FP8_CUT])
    tok_cut, tok_p = (Engine(dataclasses.replace(c, n_layers=FP8_CUT), p_cut, **kw).generate(
        prompts, max_new_tokens=96).tokens.numpy() for c in (cfg8, plain8))
    same = int((tok_p == tok_cut).all(axis=1).sum())
    check(same == 6, f"{label}: greedy tokens at {FP8_CUT} layers differ from the plain fp8 run "
                     f"({same}/6 rows)")
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        lg, cache = T.prefill(packed, cfg8, toks, hot_cap=32, max_len=128)
        lg_p, cache_p = T.prefill(packed, plain8, toks, hot_cap=32, max_len=128)
        first = lg.argmax(-1).to(torch.int32)
        s1, _ = T.decode_step(packed, cfg8, first, cache)
        s1_p, _ = T.decode_step(packed, plain8, first, cache_p)
    check(all(t.dtype == kvc.FP8 for t in cache["attn"][:4]), f"{label}: tiers not fp8")
    check(torch.equal(lg, lg_p) and torch.equal(s1, s1_p),
          f"{label}: prefill / first-step logits differ from the plain run: "
          f"{max_err(lg, lg_p)}, {max_err(s1, s1_p)}")
    check(all(fp8_equal(torch, a, b_) for a, b_ in zip(cache["attn"][:4], cache_p["attn"][:4])),
          f"{label}: the fp8 cache after a step differs from the plain run's")
    f32_rows = int((f32_tokens == tokens).all(axis=1).sum())
    print(f"{label}: tokens equal to the plain fp8 run at {FP8_CUT} layers (6/6 rows); prefill "
          f"and first-step logits and the fp8 cache bytes equal at full depth; 18 fp8 decodes per step; against the f32-tier run "
          f"{f32_rows}/6 rows equal (printed, not checked)")

    def entry_run():  # kernel 6 over fp8 tiers: every layer's post-append cache, then paged
        pairs, stack = [], cache["attn"]
        for i in range(L):
            layer = kvc.layer(stack, i)
            q = torch.randn((6, 8, 256), generator=gen, device="cuda")
            pairs.append((fd.flash_decode_attention(q, layer),
                          fd.flash_decode_attention(q, layer, impl="plain")))
            paged = paged_copy(torch, layer, 32, shuffle_seed=i)
            pairs.append((fd.flash_decode_attention(q, paged),
                          fd.flash_decode_attention(q, paged, impl="plain")))
        return pairs

    with torch.inference_mode():
        pairs, entry, _ = counted([fd.FP8_GQA_KERNEL, fd.FP8_GQA_PAGED_KERNEL, fd.GQA_KERNEL],
                                  entry_run)
    check(all(torch.equal(a, b_) for a, b_ in pairs), f"{label} entry points: kernel != plain")
    check(entry[fd.FP8_GQA_KERNEL.symbol] == L and entry[fd.FP8_GQA_PAGED_KERNEL.symbol] == L
          and entry[fd.GQA_KERNEL.symbol] == 0, f"{label} entry points: launches {entry}")
    print(f"{label} entry points: the post-append decode over the 18 fp8 layer caches, "
          f"contiguous and in shuffled pages, bit-identical to plain; launches {entry}")
    del cache, cache_p

    # the chunked and paged serves at the depth cut to FP8_CUT layers (the
    # run's time: their plain runs cost ~0.6 s a step at full depth)
    cfg8, plain8 = (dataclasses.replace(c, n_layers=FP8_CUT) for c in (cfg8, plain8))
    packed, L = dict(packed, blocks=packed["blocks"][:FP8_CUT]), FP8_CUT
    label = f"{label} ({FP8_CUT} layers)"
    kwc = dict(kw, prefill_chunk=32)
    p96 = np.random.default_rng(5).integers(0, cfg.vocab_size, (6, 96)).astype(np.int32)
    eng_c = Engine(cfg8, packed, **kwc)
    waves = counting_waves(eng_c)
    res_c, chunked, wall_c = counted(common + [fp.FP8_CHUNK_KERNEL, fp.CHUNK_KERNEL, fp.FP8_KERNEL,
                                               fd.FP8_KERNEL, fd.KERNEL],
                                     lambda: eng_c.generate(p96, max_new_tokens=32))
    print(f"{label} chunked generate 6 x (96 + 32): {wall_c:.3f} s, {len(waves)} waves, "
          f"launches {chunked}")
    check_served(res_c, cfg8, eng_c, 128, f"{label} chunked", prompt_len=96)
    check(chunked[fp.FP8_CHUNK_KERNEL.symbol] == L * len(waves) == L * 3
          and chunked[fp.CHUNK_KERNEL.symbol] == 0 and chunked[fp.FP8_KERNEL.symbol] == 0
          and chunked[fd.KERNEL.symbol] == 0, f"{label} chunked: launches {chunked}")
    ct = res_c.tokens.numpy()
    same = int((Engine(plain8, packed, **kwc).generate(p96, max_new_tokens=32).tokens.numpy()
                == ct).all(axis=1).sum())
    check(same == 6, f"{label} chunked: tokens differ from the plain fp8 chunked run ({same}/6)")
    grouped = Engine(cfg8, packed, **kw).generate(p96, max_new_tokens=32).tokens.numpy()
    print(f"{label} chunked: tokens equal to the plain fp8 chunked run (6/6 rows); against "
          f"grouped admission under fp8 {int((grouped == ct).all(axis=1).sum())}/6 rows equal "
          f"(printed, not checked)")

    specs = paged_requests(cfg.vocab_size)

    def reqs():
        return [Request(rid, t, n) for rid, t, n in specs]

    pkw = dict(hot_cap=32, max_len=192, prefill_chunk=32, slots=4, sync_every=8, paged=True,
               page_size=32)
    eng_p = Engine(cfg8, packed, **pkw)
    waves, steps = counting_waves(eng_p), counting_steps(eng_p)
    fin, paged, wall_p = counted(common + [fp.FP8_CHUNK_PAGED_KERNEL, fd.FP8_PAGED_KERNEL,
                                           fp.CHUNK_PAGED_KERNEL, fd.PAGED_KERNEL,
                                           fp.FP8_CHUNK_KERNEL, fd.FP8_KERNEL],
                                 lambda: eng_p.serve(reqs()))
    print(f"{label} paged shared serve: {wall_p:.3f} s, {len(waves)} waves, {len(steps)} steps, "
          f"launches {paged}")
    check(paged[fp.FP8_CHUNK_PAGED_KERNEL.symbol] == L * len(waves)
          and paged[fd.FP8_PAGED_KERNEL.symbol] == L * len(steps)
          and paged[fp.CHUNK_PAGED_KERNEL.symbol] == paged[fd.PAGED_KERNEL.symbol] == 0
          and paged[fp.FP8_CHUNK_KERNEL.symbol] == paged[fd.FP8_KERNEL.symbol] == 0,
          f"{label} paged: not {L} fp8 paged launches per wave and step alone: {paged}")
    check(eng_p.weight_loads == 0, f"{label} paged: weights were reloaded")
    fin = {f.rid: f for f in fin}
    plain = {f.rid: f for f in Engine(plain8, packed, **pkw).serve(reqs())}
    same = sum(np.array_equal(fin[r].tokens, plain[r].tokens) for r in fin)
    check(same == 8, f"{label} paged: tokens differ from the plain fp8 shared run ({same}/8)")
    unshared = {f.rid: f for f in Engine(cfg8, packed, **pkw, prefix_sharing=False).serve(reqs())}
    for f in unshared.values():
        closed = dr_edram.closed_form_reduction(f.seq_len, 32)
        check(abs(f.external_reduction - closed) <= 1e-12,
              f"{label} unshared: request {f.rid} reduction {f.external_reduction} != {closed}")
    print(f"{label} paged: tokens equal to the plain fp8 shared run (8/8 requests), prefix tokens "
          f"reused {[fin[r].prefix_tokens_reused for r in sorted(fin)]}; unshared ledgers at the "
          f"closed form; shared against unshared under fp8 "
          f"{sum(np.array_equal(fin[r].tokens, unshared[r].tokens) for r in fin)}/8 requests "
          f"equal (printed, not checked)")
    label = "falcon3-1b fp8"
    return {label: launches, f"{label} entry points": entry, f"{label} chunked": chunked,
            f"{label} paged": paged}, 6 * 96 / wall


# ---------------------------------------------------------------------------
# speculative decoding on falcon3-1b with the falcon3-draft model
# ---------------------------------------------------------------------------

SPEC_K = 4  # the served chunk width
SPEC_LENS = (5, 31, 32, 33, 77, 100)  # the chunked serve's prompts, 24 new tokens each
SPEC_FP8_CUT = 2  # the depth of the fp8 comparison (its plain run)


def draft_model(torch):
    """falcon3-draft at full width from seed 2, packed: (cfg, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params

    dcfg = get_config("falcon3-draft")
    return dcfg, pack_params(T.init_params(dcfg, seed=2, device="cuda"), dcfg)


def verify_equals_decode(torch, cfg, packed, dcfg, dparams, smi):
    """At falcon3-1b's full width and depth: one chunk wave fills 6 slots to
    lengths 28-33; a K = 4 verify chunk's logits (slots, 4, V) equal the
    logits of four decode steps of the same tokens, bit for bit (hot 32:
    the rows straddle hot_cap). One layer's no-append chunk form (y, k_c,
    v_c) equals its plain run, the cache untouched. Prints a verify's
    device ms against K target decode steps' and K draft decode steps'."""
    import numpy as np

    from repro_torch.core import kv_cache as kvc
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as T

    lens = [28, 29, 30, 31, 32, 33]
    b, k = len(lens), SPEC_K
    rng = np.random.default_rng(26)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, 40)), device="cuda")
    chunk = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, k)), device="cuda")
    n_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    full = torch.full((b,), k, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        cache = T.init_decode_cache(cfg, b, 128, 32, device="cuda")
        T.prefill_chunk_step(packed, cfg, prompt, cache, n_len)
        logits, _ = T.spec_verify_chunk(packed, cfg, chunk, cache, full)
        check(torch.equal(cache["attn"].lengths, n_len.expand_as(cache["attn"].lengths)),
              "the verify moved the cache's lengths")
        saved = [t.clone() for t in cache["attn"]]
        dec = torch.stack([T.decode_step(packed, cfg, chunk[:, j], cache)[0]
                           for j in range(k)], dim=1)
        check(torch.equal(logits, dec), f"falcon3-1b verify rows != decode rows: "
                                        f"{max_err(logits, dec)}")
        same = (logits.argmax(-1) == dec.argmax(-1)).all().item()
        print(f"falcon3-1b (18 layers) verify chunk K {k} at lengths {lens}: logits "
              f"(slots, K, V) bit-identical to {k} decode steps' (greedy equal: {same})")
        # one layer's no-append form against its plain run
        for t, s in zip(cache["attn"], saved):
            t.copy_(s)
        layer0 = kvc.layer(cache["attn"], 0)
        before = [t.clone() for t in layer0]
        x = torch.randn((b, k, cfg.d_model), device="cuda")
        plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
        y, (k_c, v_c) = attn.attention_prefill_chunk(packed["blocks"][0]["attn"], x, cfg,
                                                     layer0, full, append=False)
        y_p, (k_p, v_p) = attn.attention_prefill_chunk(packed["blocks"][0]["attn"], x, plain,
                                                       layer0, full, append=False)
        check(torch.equal(y, y_p) and torch.equal(k_c, k_p) and torch.equal(v_c, v_p),
              f"attention_prefill_chunk(append=False) differs from plain: {max_err(y, y_p)}")
        check(all(torch.equal(a, t) for a, t in zip(before, layer0)),
              "attention_prefill_chunk(append=False) changed the cache")
        print("attention_prefill_chunk(append=False), falcon3-1b layer 0: y, k_c, v_c "
              "bit-identical to the plain run, the cache unchanged")

        # device ms: one verify, K target decode steps, K draft decode steps
        dcache = T.init_decode_cache(dcfg, b, 128, 32, device="cuda")
        T.prefill_chunk_step(dparams, dcfg, prompt, dcache, n_len)

        def steps(params, c, stack):
            for j in range(k):
                T.decode_step(params, c, chunk[:, j], stack)
            for s_ in stack.values():
                kvc.truncate(s_, n_len)

        verify_ms, _ = timed("verify (18 layers)", lambda: T.spec_verify_chunk(
            packed, cfg, chunk, cache, full), iters=5)
        decode_ms, _ = timed(f"{k} target decode steps", lambda: steps(packed, cfg, cache),
                             iters=5)
        draft_ms, _ = timed(f"{k} draft decode steps", lambda: steps(dparams, dcfg, dcache),
                            iters=5)
        print(f"falcon3-1b device ms: one verify of K {k} {verify_ms:.3f}, {k} decode steps "
              f"{decode_ms:.3f} (ratio {verify_ms / decode_ms:.3f}), {k} falcon3-draft decode "
              f"steps {draft_ms:.3f}, on {smi}")


def speculative_phase(torch, cfg, packed, kernels, smi, paged_tokens, overload_tokens):
    """falcon3-1b (18 layers) served speculatively with the falcon3-draft
    model (4 layers, d_model 1024, tied embeddings; seed 2), K = SPEC_K.

    (a) Contiguous chunked (hot 32, max_len 128, ``prefill_chunk`` 32, 6
    slots, ``sync_every`` 8): the SPEC_LENS prompts + 24 new tokens, in
    three mixes: the seeded draft, draft = target (full accept) and
    ``spec_force="reject"``; each mix's tokens equal the non-speculative
    serve's on 6/6 requests; full accept gives accepted == drafted == 24 -
    rounds per request, forced reject accepted == 0; 18 chunk-form
    launches per verify round (plus 18 per target wave and 4 per draft
    wave), 4 x K draft decode launches per round, no other attention form;
    ``weight_loads == 0``. (b) Paged with prefix sharing (the paged phase's
    geometry and eight requests) with ``check_serving_invariants`` (check 7
    included) after every iteration: tokens equal to the non-speculative
    paged serve's on 8/8, the paged chunk form per round. (c) At the depth
    cut to OVERLOAD_CUT layers (full-depth preemption is held by the
    overload phase, full-depth speculation by (a) and (b)), the overload
    cell's requests on its 6-page pool: preemptions land between rounds,
    tokens equal to the unpressured speculative serve's and to the
    non-speculative serve's at that depth (``overload_tokens``) on 8/8.
    (d) fp8 tiers at SPEC_FP8_CUT layers: the speculative serve equals its
    own plain fp8 run; against the non-speculative fp8 serve printed.
    Prints each mix's acceptance rate and tokens/s against the
    non-speculative serve's. Returns the launches of
    (a) (seeded draft), (b), (c) and (d) by path."""
    import numpy as np

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.serving.chaos import check_serving_invariants
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    label = "falcon3-1b speculative"
    dcfg, dparams = draft_model(torch)
    verify_equals_decode(torch, cfg, packed, dcfg, dparams, smi)
    k, n_l = SPEC_K, cfg.n_layers
    rng = np.random.default_rng(6)
    specs = [(i, rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32), 24)
             for i, n in enumerate(SPEC_LENS)]

    def reqs(which=specs):
        return [Request(rid, t, n) for rid, t, n in which]

    kw = dict(hot_cap=32, max_len=128, prefill_chunk=32, slots=6, sync_every=8)
    base_eng = Engine(cfg, packed, **kw)
    base_eng.serve(reqs()[:2])  # warm-up
    base, _, base_wall = counted(kernels, lambda: base_eng.serve(reqs()))
    base = {f.rid: f for f in base}
    new = sum(n for _, _, n in specs)
    print(f"{label}: non-speculative chunked serve (prompts {SPEC_LENS} + 24, 6 slots): "
          f"{base_wall:.3f} s, {new / base_wall:.2f} tokens/s")
    paths = {}
    for mix, extra, d in (("mixed", {}, (dcfg, dparams)), ("full accept", {}, (cfg, packed)),
                          ("forced reject", dict(spec_force="reject"), (dcfg, dparams))):
        eng = Engine(cfg, packed, draft_cfg=d[0], draft_params=d[1], spec_k=k, **kw, **extra)
        rounds, waves = counting(eng, "_spec_step"), counting(eng, "_chunk_step")
        dwaves = counting(eng, "_draft_chunk_step")
        fin, launches, wall = counted(kernels, lambda: eng.serve(reqs()))
        fin = {f.rid: f for f in fin}
        st = eng.last_stats
        same = sum(np.array_equal(fin[r].tokens, base[r].tokens) for r in fin)
        rate = st.accepted_tokens / st.drafted_tokens if st.drafted_tokens else 0.0
        print(f"{label} {mix} (K {k}): {wall:.3f} s, {new / wall:.2f} tokens/s ("
              f"{base_wall / wall:.3f}x the non-speculative serve in this call), {len(rounds)} "
              f"rounds, {len(waves)} target / {len(dwaves)} draft chunk waves, drafted "
              f"{st.drafted_tokens}, accepted {st.accepted_tokens} (acceptance rate "
              f"{rate:.4f}); tokens equal to the non-speculative serve on {same}/6; launches "
              f"{launches}")
        check(same == 6, f"{label} {mix}: tokens differ from the non-speculative serve "
                         f"({same}/6)")
        check(eng.weight_loads == 0 and all(f.outcome == "finished" for f in fin.values()),
              f"{label} {mix}: weights reloaded or a request did not finish")
        check(st.drafted_tokens == sum(f.drafted_tokens for f in fin.values())
              and st.accepted_tokens == sum(f.accepted_tokens for f in fin.values()),
              f"{label} {mix}: the stats do not sum the requests")
        d_l = d[0].n_layers
        want_chunk = n_l * (len(waves) + len(rounds)) + d_l * len(dwaves)
        check(launches[fp.CHUNK_KERNEL.symbol] == want_chunk
              and launches[fd.KERNEL.symbol] == d_l * k * len(rounds)
              and launches[fp.KERNEL.symbol] == 0,
              f"{label} {mix}: launches {launches}, not {n_l} chunk launches per round and "
              f"wave, {d_l} per draft wave, {d_l} x {k} draft decodes per round")
        if mix == "full accept":
            for f in fin.values():
                r = -(-24 // k)
                check(f.accepted_tokens == f.drafted_tokens == 24 - r
                      and len(f.tokens) == f.accepted_tokens + r,
                      f"{label} full accept: rid {f.rid} drafted {f.drafted_tokens}, accepted "
                      f"{f.accepted_tokens}, not {24 - r}")
        if mix == "forced reject":
            check(st.accepted_tokens == 0, f"{label} forced reject accepted {st.accepted_tokens}")
        if mix == "mixed":
            unused = (fp.KERNEL.symbol, fd.PAGED_KERNEL.symbol, fp.CHUNK_PAGED_KERNEL.symbol)
            check(all(n > 0 for sym, n in launches.items() if sym not in unused),
                  f"{label}: a kernel of the path never launched: {launches}")
            paths[label] = launches
    print(f"{label}: 18 chunk-form launches per verify round, 4 x {k} draft decode launches "
          f"per round, tokens equal on 6/6 requests in every mix, on {smi}")

    # (b) paged with prefix sharing, the invariants every iteration
    pspecs = paged_requests(cfg.vocab_size)
    pkw = dict(hot_cap=32, max_len=192, prefill_chunk=32, slots=4, sync_every=8, paged=True,
               page_size=32)
    eng = Engine(cfg, packed, draft_cfg=dcfg, draft_params=dparams, spec_k=k, **pkw)
    rounds, waves = counting(eng, "_spec_step"), counting(eng, "_chunk_step")
    dwaves = counting(eng, "_draft_chunk_step")
    checked = []

    def invariants(ctx):
        check_serving_invariants(ctx)
        checked.append(ctx.iteration)

    fin, launches, wall = counted(kernels, lambda: eng.serve(reqs(pspecs),
                                                             on_iteration=invariants))
    fin = {f.rid: f for f in fin}
    st = eng.last_stats
    same = sum(np.array_equal(fin[r].tokens, paged_tokens[r]) for r in fin)
    print(f"{label} paged (the paged phase's eight requests, prefix sharing): {wall:.3f} s, "
          f"{len(rounds)} rounds, invariants (check 7 included) green after {len(checked)} "
          f"iterations, drafted {st.drafted_tokens}, accepted {st.accepted_tokens}, grown pages "
          f"{st.grown_pages}; tokens equal to the non-speculative paged serve on {same}/8; "
          f"prefix tokens reused {[fin[r].prefix_tokens_reused for r in sorted(fin)]}; "
          f"launches {launches}")
    check(same == 8, f"{label} paged: tokens differ from the non-speculative serve ({same}/8)")
    check(len(checked) == st.iterations and eng.weight_loads == 0, f"{label} paged: hook / reload")
    check(launches[fp.CHUNK_PAGED_KERNEL.symbol] == n_l * (len(waves) + len(rounds))
          and launches[fd.KERNEL.symbol] == dcfg.n_layers * k * len(rounds)
          and launches[fp.CHUNK_KERNEL.symbol] == dcfg.n_layers * len(dwaves)
          and launches[fd.PAGED_KERNEL.symbol] == 0,
          f"{label} paged: launches {launches}")
    tree_only(eng, f"{label} paged")
    paths[f"{label} paged"] = launches

    # (c) the overload cell's 6-page pool, at the depth cut
    okw = dict(pkw)
    ocut = OVERLOAD_CUT
    c_o = dataclasses.replace(cfg, n_layers=ocut)
    p_o = dict(packed, blocks=packed["blocks"][:ocut])
    ospecs = [(rid, t, 64) for rid, t in overload_requests(cfg.vocab_size)]
    eng_a = Engine(c_o, p_o, draft_cfg=dcfg, draft_params=dparams, spec_k=k, **okw)
    t0 = time.perf_counter()
    fin_a = {f.rid: f for f in eng_a.serve(reqs(ospecs))}
    wall_a = time.perf_counter() - t0
    eng_b = Engine(c_o, p_o, draft_cfg=dcfg, draft_params=dparams, spec_k=k, n_pages=6, **okw)
    fin_b, launches, wall = counted(kernels, lambda: eng_b.serve(
        reqs(ospecs), on_iteration=check_serving_invariants))
    fin_b = {f.rid: f for f in fin_b}
    st = eng_b.last_stats
    same_a = sum(np.array_equal(fin_b[r].tokens, fin_a[r].tokens) for r in fin_b)
    same_n = sum(np.array_equal(fin_b[r].tokens, overload_tokens[r]) for r in fin_b)
    print(f"{label} overload (6 pages, {ocut} layers): {wall:.2f} s (unpressured {wall_a:.2f} s), "
          f"preemptions {st.preemptions}, recompute_tokens {st.recompute_tokens}, iterations "
          f"{st.iterations}, drafted {st.drafted_tokens}, accepted {st.accepted_tokens}; tokens "
          f"equal to the unpressured speculative serve on {same_a}/8 and to the "
          f"non-speculative serve on {same_n}/8")
    check(st.preemptions > 0 and all(f.outcome == "finished" for f in fin_b.values()),
          f"{label} overload: no preemption, or a request did not finish")
    check(same_a == 8 and same_n == 8, f"{label} overload: tokens differ ({same_a}, {same_n})")
    check(st.drafted_tokens == sum(f.drafted_tokens for f in fin_b.values()),
          f"{label} overload: drafted tokens lost across preemptions")
    tree_only(eng_b, f"{label} overload")
    check(launches[fp.CHUNK_PAGED_KERNEL.symbol] > 0 and launches[fd.PAGED_KERNEL.symbol] == 0,
          f"{label} overload: launches {launches}")
    paths[f"{label} overload ({ocut} layers)"] = launches

    # (d) fp8 tiers at the depth cut: the speculative serve against its plain run
    cut = SPEC_FP8_CUT
    c8 = dataclasses.replace(cfg, n_layers=cut,
                             bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    p8 = dict(packed, blocks=packed["blocks"][:cut])
    plain8 = dataclasses.replace(c8, bitnet=dataclasses.replace(c8.bitnet, impl="plain"))
    runs = {}
    for name, c, spec in (("speculative", c8, True), ("plain speculative", plain8, True),
                          ("non-speculative", c8, False)):
        skw = dict(draft_cfg=dcfg, draft_params=dparams, spec_k=k) if spec else {}
        e = Engine(c, p8, **kw, **skw)
        out, l8, _ = counted(kernels + [fp.FP8_CHUNK_KERNEL, fd.FP8_KERNEL],
                             lambda: e.serve(reqs()))
        runs[name] = {f.rid: f.tokens for f in out}
        if name == "speculative":
            paths[f"{label} fp8 ({cut} layers)"] = l8
            check(l8[fp.FP8_CHUNK_KERNEL.symbol] > 0 and l8[fp.CHUNK_KERNEL.symbol] > 0,
                  f"{label} fp8: launches {l8}")
    same = sum(np.array_equal(runs["speculative"][r], runs["plain speculative"][r])
               for r in runs["speculative"])
    vs_seq = sum(np.array_equal(runs["speculative"][r], runs["non-speculative"][r])
                 for r in runs["speculative"])
    print(f"{label} fp8 tiers, {cut} layers: tokens equal to its plain run on {same}/6; against "
          f"the non-speculative fp8 serve {vs_seq}/6 (printed only: a verify reads its own rows "
          f"at full precision and cached ones fp8-rounded)")
    check(same == 6, f"{label} fp8: differs from its plain run ({same}/6)")
    return paths


def slice_phase(torch, gen, smi):
    """falcon3-1b served end to end: the fused kernel run, its plain run,
    the entry-point path, the carried-scale run, the chunked runs and the
    paged runs."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params
    from repro_torch.serving.engine import Engine

    cfg = get_config("falcon3-1b")
    t0 = t_slice = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    lgen = torch.Generator(device="cuda").manual_seed(1)
    for blk in params["blocks"]:
        for leaf in (blk["attn"]["lora_v"], blk["attn"]["lora_o"], blk["mlp"]["lora_down"]):
            leaf["b"].normal_(0.0, 0.02, generator=lgen)  # zero at init: exercise the adapters
    packed = pack_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"falcon3-1b: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 32)).astype(np.int32)
    kw = dict(hot_cap=32, max_len=128, slots=6)
    kernels = [tm.KERNEL, fd.KERNEL, fp.KERNEL, kl.KERNEL, krms.KERNEL]

    eng = Engine(cfg, packed, **kw)
    eng.generate(prompts[:, :8], max_new_tokens=4)  # warm-up (cuBLAS, allocator)
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts, max_new_tokens=96))
    tokens = res.tokens.numpy()
    print(f"falcon3-1b generate 6 x (32 + 96): {wall:.3f} s, {6 * 96 / wall:.1f} tokens/s, "
          f"launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check_served(res, cfg, eng, 128, "falcon3-1b")
    gqa = launches[fd.KERNEL.symbol]
    print(f"flash_decode_gqa_fused launches per falcon3-1b decode step: {gqa / 96:g} "
          f"({gqa} over 96 steps)")
    check(gqa == cfg.n_layers * 96, f"GQA decode launches {gqa} != {cfg.n_layers} per step")
    n_lora = launches[kl.KERNEL.symbol]
    print(f"lora_delta launches per falcon3-1b generate: {n_lora} (3 adapters x "
          f"{cfg.n_layers} layers x (96 decode steps + 1 admission))")
    check(n_lora == 3 * cfg.n_layers * 97, f"LoRA launches {n_lora} != 3 x 18 x 97")
    n_rms = launches[krms.KERNEL.symbol]
    print(f"rms_norm launches per falcon3-1b generate: {n_rms} ((2 x {cfg.n_layers} + 1) x "
          f"(96 decode steps + 1 admission))")
    check(n_rms == (2 * cfg.n_layers + 1) * 97, f"rms_norm launches {n_rms} != 37 x 97")

    cfg_plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    # the plain run at the depth cut to MAIN_PLAIN_CUT layers (the run's
    # time), against the kernel run at that depth; the chunked phase holds
    # its full-depth run to its plain run, and grouped to chunked
    cut = MAIN_PLAIN_CUT
    c_cut = dataclasses.replace(cfg, n_layers=cut)
    p_cut = dict(packed, blocks=packed["blocks"][:cut])
    t0 = time.perf_counter()
    tok_cut, tok_p = (Engine(c, p_cut, **kw).generate(prompts, max_new_tokens=96).tokens.numpy()
                      for c in (c_cut, dataclasses.replace(cfg_plain, n_layers=cut)))
    torch.cuda.synchronize()
    print(f"kernel and plain runs at {cut} layers: {time.perf_counter() - t0:.2f} s")
    same = int((tok_p == tok_cut).all(axis=1).sum())
    check(same == 6, f"greedy tokens at {cut} layers differ from the plain run ({same}/6 rows "
                     f"equal)")

    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        (lg, cache), admit, _ = counted(
            [fp.KERNEL], lambda: T.prefill(packed, cfg, toks, hot_cap=32, max_len=128))
        lg_p, cache_p = T.prefill(packed, cfg_plain, toks, hot_cap=32, max_len=128)
        first = lg.argmax(-1).to(torch.int32)
        s1, _ = T.decode_step(packed, cfg, first, cache)
        s1_p, _ = T.decode_step(packed, cfg_plain, first, cache_p)
    print(f"flash_prefill_fresh launches per falcon3-1b admission (T.prefill of 6 x 32): "
          f"{admit[fp.KERNEL.symbol]}")
    check(admit[fp.KERNEL.symbol] == cfg.n_layers, f"prefill launches per admission: {admit}")
    check(torch.allclose(lg, lg_p, **LOGIT_TOL), f"prefill logits off: {max_err(lg, lg_p)}")
    check(torch.allclose(s1, s1_p, **LOGIT_TOL), f"first-step logits off: {max_err(s1, s1_p)}")
    print(f"greedy tokens equal to the plain run at {cut} layers (6/6 rows); prefill logits max "
          f"|diff| "
          f"{max_err(lg, lg_p)}, first-step {max_err(s1, s1_p)} (tolerance {LOGIT_TOL})")
    with torch.inference_mode():
        entry = entry_point_path(torch, gen, packed, cache)
    del cache, cache_p
    carried, carried_tok_s = carried_scale_run(
        torch, cfg, packed, prompts, kw, 96,
        [tm.KERNEL, tm.KNOWN_KERNEL, fd.KERNEL, fp.KERNEL, kl.KERNEL, krms.KERNEL],
        (eng, wall, launches), tokens)
    check(carried[fd.KERNEL.symbol] == gqa,
          f"carried-scale run: {carried[fd.KERNEL.symbol]} GQA decode launches, fused run {gqa}")
    print(f"[falcon3-1b generate, plain, entry-point and carried-scale runs: "
          f"{time.perf_counter() - t_slice:.2f} s]")
    t0 = time.perf_counter()
    chunked, chunked_serve = chunked_phase(torch, cfg, packed,
                                           [tm.KERNEL, fd.KERNEL, fp.KERNEL, fp.CHUNK_KERNEL,
                                            kl.KERNEL, krms.KERNEL])
    print(f"[falcon3-1b chunked phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    served = [tm.KERNEL, fd.KERNEL, fd.PAGED_KERNEL, fp.KERNEL, fp.CHUNK_KERNEL,
              fp.CHUNK_PAGED_KERNEL, kl.KERNEL, krms.KERNEL]
    paged, paged_tokens = paged_phase(torch, cfg, packed, served, smi)
    print(f"[falcon3-1b paged phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    sessions = sessions_phase(torch, cfg, packed, served, smi, paged_tokens)
    print(f"[falcon3-1b sessions phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    nan_rows_phase(torch, gen, cfg.rope_theta)
    sdc = sdc_phase(torch, cfg, packed, served, smi, paged_tokens)
    print(f"[falcon3-1b sdc phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    overload, overload_tokens, overload_cut_tokens = overload_phase(torch, cfg, packed, served,
                                                                    smi)
    print(f"[falcon3-1b overload phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    spec_paths = speculative_phase(torch, cfg, packed, served, smi, paged_tokens,
                                   overload_cut_tokens)
    print(f"[falcon3-1b speculative phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    fp8_paths, fp8_tok_s = fp8_falcon_phase(torch, gen, cfg, packed, prompts, tokens)
    print(f"[falcon3-1b fp8 phase: {time.perf_counter() - t0:.2f} s]")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    breakdown(torch, eng, prompts, before="57.693 ms in 1224 launches on an H100")
    decode_glue_per_step(torch, cfg, kw, cfg.rope_theta)
    print(f"[falcon3-1b breakdown and decode glue: {time.perf_counter() - t0:.2f} s]")
    return {"falcon3-1b": launches, "falcon3-1b entry points": entry,
            "falcon3-1b carried-scale": carried, "falcon3-1b chunked": chunked,
            "falcon3-1b chunked serve": chunked_serve, "falcon3-1b paged": paged,
            "falcon3-1b sessions": sessions, "falcon3-1b sdc": sdc,
            "falcon3-1b overload": overload, **spec_paths,
            **fp8_paths}, {
                "falcon3-1b": 6 * 96 / wall, "falcon3-1b carried-scale": carried_tok_s,
                "falcon3-1b fp8": fp8_tok_s}


def fp8_deepseek_run(torch, cfg, packed, prompts, kw, f32_tokens):
    """deepseek-v3-671b-l5 over fp8 latent tiers (``kv_fp8``; the same
    weights): generate 6 x (32 + 32) equal to the plain fp8 run, ledgers
    at the closed form, ``weight_loads == 0``, 5 fp8 latent decodes per
    step and no f32-tier one; fp8 against f32 tiers printed. Returns the
    launches and tokens/s."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serving.engine import Engine

    label = f"{cfg.name} fp8"
    cfg8 = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    plain8 = dataclasses.replace(cfg8, bitnet=dataclasses.replace(cfg8.bitnet, impl="plain"))
    eng = Engine(cfg8, packed, **kw)
    eng.generate(prompts[:, :8], max_new_tokens=2)  # warm-up
    kernels = [tm.KERNEL, tm.EXPERT_KERNEL, fp.MLA_KERNEL, fd.LATENT_FP8_KERNEL, fd.LATENT_KERNEL,
               krms.KERNEL]
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts, max_new_tokens=32))
    print(f"{label} generate 6 x (32 + 32): {wall:.3f} s, {6 * 32 / wall:.1f} tokens/s, "
          f"launches {launches}")
    check_served(res, cfg8, eng, 64, label)
    check(launches[fd.LATENT_FP8_KERNEL.symbol] == cfg.n_layers * 32
          and launches[fd.LATENT_KERNEL.symbol] == 0
          and all(launches[k.symbol] > 0 for k in kernels if k is not fd.LATENT_KERNEL),
          f"{label}: not {cfg.n_layers} fp8 latent decodes per step alone: {launches}")
    tokens = res.tokens.numpy()
    same = int((Engine(plain8, packed, **kw).generate(prompts, max_new_tokens=32).tokens.numpy()
                == tokens).all(axis=1).sum())
    check(same == 6, f"{label}: greedy tokens differ from the plain fp8 run ({same}/6 rows)")
    print(f"{label}: tokens equal to the plain fp8 run (6/6 rows), 5 fp8 latent decodes per "
          f"step; against the f32-tier run {int((f32_tokens == tokens).all(axis=1).sum())}/6 "
          f"rows equal (printed, not checked)")
    return launches, 6 * 32 / wall


def deepseek_phase(torch):
    """deepseek-v3-671b-l5 (full width, 3 dense + 2 MoE layers) served end
    to end, held against its plain run, then served again under
    ``fuse_act_quant=False``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params
    from repro_torch.serving.engine import Engine

    cfg = get_config("deepseek-v3-671b-l5")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = pack_params(T.init_params(cfg, seed=0, device="cuda"), cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"deepseek-v3-671b-l5: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    shapes = {leaf.packed.dim(): set() for leaf in packed_leaves(packed)}
    for leaf in packed_leaves(packed):
        shapes[leaf.packed.dim()].add((leaf.k, leaf.packed.shape[-1]))
    check(shapes == {2: set(DEEPSEEK_SHAPES), 3: set(EXPERT_SHAPES)},
          f"deepseek-v3-671b-l5's packed shapes {shapes} are not the ones the kernel 4 and "
          "kernel 7 phases check")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 32)).astype(np.int32)
    kw = dict(hot_cap=32, max_len=128, slots=6)
    kernels = [tm.KERNEL, tm.EXPERT_KERNEL, fp.MLA_KERNEL, fd.LATENT_KERNEL, krms.KERNEL]
    # MLA cannot chunk (as in the reference): with prefill_chunk set the
    # engine keeps grouped admission
    eng = Engine(cfg, packed, **kw, prefill_chunk=32)
    check(eng._chunked_capable() is False, "deepseek-v3-671b-l5 reports chunked admission")
    t0 = time.perf_counter()
    eng.generate(prompts[:, :8], max_new_tokens=2)  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    print(f"warm-up generate 6 x (8 + 2): {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts, max_new_tokens=32))
    tokens = res.tokens.numpy()
    print(f"deepseek-v3-671b-l5 generate 6 x (32 + 32): {wall:.3f} s, {6 * 32 / wall:.1f} "
          f"tokens/s, launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check_served(res, cfg, eng, 64, "deepseek-v3-671b-l5")
    check(eng.chunk_shapes == set(), f"deepseek-v3-671b-l5 chunk waves ran: {eng.chunk_shapes}")
    print("deepseek-v3-671b-l5 with prefill_chunk=32: _chunked_capable() is False; served by "
          "grouped admission (no chunk wave)")
    latent = launches[fd.LATENT_KERNEL.symbol]
    print(f"flash_decode_latent launches per deepseek-v3-671b-l5 decode step: {latent / 32:g} "
          f"({latent} over 32 steps)")
    check(latent == cfg.n_layers * 32, f"latent launches {latent} != {cfg.n_layers} per step")

    cfg_plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    t0 = time.perf_counter()
    res_p = Engine(cfg_plain, packed, **kw).generate(prompts, max_new_tokens=32)
    torch.cuda.synchronize()
    same = int((res_p.tokens.numpy() == tokens).all(axis=1).sum())
    print(f"plain run: {time.perf_counter() - t0:.2f} s; greedy tokens equal on {same}/6 rows")
    check(same == 6, f"greedy tokens differ from the plain run ({same}/6 rows equal)")
    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        _, admit, _ = counted([fp.KERNEL, fp.MLA_KERNEL],
                              lambda: T.prefill(packed, cfg, toks, hot_cap=32, max_len=128))
    print(f"flash_prefill_mla launches per deepseek-v3-671b-l5 admission (T.prefill of 6 x 32): "
          f"{admit[fp.MLA_KERNEL.symbol]}, GQA form {admit[fp.KERNEL.symbol]}")
    check(admit == {fp.KERNEL.symbol: 0, fp.MLA_KERNEL.symbol: cfg.n_layers},
          f"MLA prefill launches per admission: {admit}")
    fp8, fp8_tok_s = fp8_deepseek_run(torch, cfg, packed, prompts, kw, tokens)
    carried, carried_tok_s = carried_scale_run(
        torch, cfg, packed, prompts, kw, 32,
        [tm.KERNEL, tm.EXPERT_KERNEL, tm.KNOWN_KERNEL, tm.KNOWN_EXPERT_KERNEL, fp.MLA_KERNEL,
         fd.LATENT_KERNEL, krms.KERNEL], (eng, wall, launches), tokens)
    breakdown(torch, eng, prompts, label="deepseek-v3-671b-l5", new=8,
              before="181.988 ms in 261 launches on an H100")
    latent_glue_per_step(torch, cfg, kw)
    name = cfg.name
    del eng, packed
    torch.cuda.empty_cache()
    pack243, pack243_tok_s = pack243_run(torch, cfg, prompts, kw, kernels, tokens)
    return ({name: launches, f"{name} carried-scale": carried, f"{name} pack243": pack243,
             f"{name} fp8": fp8},
            {name: 6 * 32 / wall, f"{name} carried-scale": carried_tok_s,
             f"{name} pack243": pack243_tok_s, f"{name} fp8": fp8_tok_s})


# ---------------------------------------------------------------------------
# the dense families: qwen3-32b (qk-norm, rep 8), gemma-7b (GeGLU, MHA,
# tied embeddings scaled by sqrt(d_model)), deepseek-coder-33b (rep 7)
# ---------------------------------------------------------------------------

DENSE_KW = dict(hot_cap=32, max_len=128, slots=6)
DENSE_NEW = 32  # 6 x (32 + 32): rows 33-64 come from the cold tier
DENSE_PLAIN_CUT = 2  # the depth of each model's plain comparison
QWEN_CHUNK_CUT = 4  # the depth of qwen3-32b's chunked-against-grouped check
# qwen3-32b's served depth: 64 -> 16 since the frontend families phase (the
# run's time; llava-next-34b serves a full-depth dense GQA model of its size)
QWEN_DEPTH = 16
CODER_DEPTH = 8  # deepseek-coder-33b served at full width, depth 62 -> 8


def dense_depth_cut(cfg, params, n):
    """``cfg`` and ``params`` cut to their first ``n`` layers."""
    return dataclasses.replace(cfg, n_layers=n), dict(params, blocks=params["blocks"][:n])


def dense_model_run(torch, cfg, label, smi):
    """One dense model served at full width from seed-0 weights packed layer
    by layer: generate 6 x (32 + 32) after a warm-up, the launches per
    decode step and per admission, the DR ledger and ``weight_loads``, then
    the same prompts at DENSE_PLAIN_CUT layers against the plain run.
    Returns (engine, params, prompts, tokens, launches, tokens/s)."""
    import numpy as np

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda", pack=True)
    torch.cuda.synchronize()
    print(f"{label}: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.activation}, qk_norm {cfg.qk_norm}, tied {cfg.tie_embeddings}, scaled "
          f"embeddings {cfg.scale_embed}) on {smi}")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 32)).astype(np.int32)
    kernels = [tm.KERNEL, fd.KERNEL, fp.KERNEL, kl.KERNEL, krms.KERNEL]
    eng = Engine(cfg, params, **DENSE_KW)
    t0 = time.perf_counter()
    eng.generate(prompts[:, :8], max_new_tokens=2)  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    print(f"{label} warm-up generate 6 x (8 + 2): {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts,
                                                                max_new_tokens=DENSE_NEW))
    tok_s = 6 * DENSE_NEW / wall
    print(f"{label} generate 6 x (32 + {DENSE_NEW}): {wall:.3f} s, {tok_s:.1f} tokens/s, "
          f"launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_served(res, cfg, eng, 32 + DENSE_NEW, label)
    n, steps = cfg.n_layers, DENSE_NEW
    norms = (4 if cfg.qk_norm else 2) * n + 1
    want = {tm.KERNEL.symbol: 4 * n * (steps + 1), fd.KERNEL.symbol: n * steps,
            fp.KERNEL.symbol: n, kl.KERNEL.symbol: 0, krms.KERNEL.symbol: norms * (steps + 1)}
    check(launches == want, f"{label}: launches {launches} != {want} (per decode step and "
                            f"admission: ternary {4 * n}, GQA decode {n} / 0, prefill 0 / "
                            f"{n}, rms_norm {norms}, LoRA 0)")
    print(f"{label} launches per decode step / admission: ternary {4 * n} / {4 * n}, "
          f"flash_decode_gqa_fused {n} / 0, flash_prefill_fresh 0 / {n}, rms_norm {norms} / "
          f"{norms}, lora_delta 0 / 0 (as checked)")
    tokens = res.tokens.numpy()
    cut = DENSE_PLAIN_CUT
    c_cut, p_cut = dense_depth_cut(cfg, params, cut)
    plain = dataclasses.replace(c_cut, bitnet=dataclasses.replace(c_cut.bitnet, impl="plain"))
    t0 = time.perf_counter()
    tok_k, tok_p = (Engine(c, p_cut, **DENSE_KW).generate(
        prompts, max_new_tokens=DENSE_NEW).tokens.numpy() for c in (c_cut, plain))
    same = int((tok_k == tok_p).all(axis=1).sum())
    print(f"{label} kernel and plain runs at {cut} layers: {time.perf_counter() - t0:.2f} s; "
          f"greedy tokens equal on {same}/6 rows")
    check(same == 6, f"{label}: greedy tokens at {cut} layers differ from the plain run "
                     f"({same}/6 rows equal)")
    return eng, params, prompts, tokens, launches, tok_s


def dense_families_phase(torch, smi):
    """The dense families at full width on the card: qwen3-32b at
    QWEN_DEPTH layers (chunked admission at QWEN_CHUNK_CUT layers against
    grouped; a traced generate), gemma-7b at full depth (28 layers),
    deepseek-coder-33b at CODER_DEPTH layers (a paged serve, page size 32,
    against the contiguous one: kernel 2's paged form at rep 7). Returns
    (launches by path, tokens/s by path)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.serving.engine import Engine

    paths, tok_s = {}, {}

    t0 = time.perf_counter()
    qwen = f"qwen3-32b-l{QWEN_DEPTH}"
    cfg = dataclasses.replace(get_config("qwen3-32b"), name=qwen, n_layers=QWEN_DEPTH)
    eng, params, prompts, tokens, launches, tok_s[qwen] = dense_model_run(torch, cfg, qwen, smi)
    paths[qwen] = launches
    c4, p4 = dense_depth_cut(cfg, params, QWEN_CHUNK_CUT)
    chunk_kernels = [tm.KERNEL, fd.KERNEL, fp.KERNEL, fp.CHUNK_KERNEL, krms.KERNEL]
    grouped = Engine(c4, p4, **DENSE_KW).generate(prompts, max_new_tokens=DENSE_NEW)
    chunked_eng = Engine(c4, p4, prefill_chunk=32, **DENSE_KW)
    chunked, chunk_launches, _ = counted(
        chunk_kernels, lambda: chunked_eng.generate(prompts, max_new_tokens=DENSE_NEW))
    same = int((chunked.tokens.numpy() == grouped.tokens.numpy()).all(axis=1).sum())
    print(f"qwen3-32b at {QWEN_CHUNK_CUT} layers, chunked admission (prefill_chunk 32, "
          f"waves {sorted(chunked_eng.chunk_shapes)}) against grouped: {same}/6 rows equal; "
          f"launches {chunk_launches}")
    check(same == 6, f"qwen3-32b chunked admission differs from grouped ({same}/6 rows)")
    check(chunk_launches[fp.CHUNK_KERNEL.symbol] == QWEN_CHUNK_CUT
          and chunk_launches[fp.KERNEL.symbol] == 0,
          f"qwen3-32b chunked: not {QWEN_CHUNK_CUT} chunk launches in one wave: "
          f"{chunk_launches}")
    paths[f"qwen3-32b chunked ({QWEN_CHUNK_CUT} layers)"] = chunk_launches
    del grouped, chunked, chunked_eng
    breakdown(torch, eng, prompts, label="qwen3-32b", new=8)
    del eng, params, p4
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[qwen3-32b: {time.perf_counter() - t0:.2f} s]")

    t0 = time.perf_counter()
    cfg = get_config("gemma-7b")
    eng, params, _, _, launches, tok_s["gemma-7b"] = dense_model_run(torch, cfg, "gemma-7b",
                                                                     smi)
    paths["gemma-7b"] = launches
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[gemma-7b: {time.perf_counter() - t0:.2f} s]")

    t0 = time.perf_counter()
    name = f"deepseek-coder-33b-l{CODER_DEPTH}"
    cfg = dataclasses.replace(get_config("deepseek-coder-33b"), name=name,
                              n_layers=CODER_DEPTH)
    eng, params, prompts, tokens, launches, tok_s[name] = dense_model_run(torch, cfg, name,
                                                                          smi)
    paths[name] = launches
    paged_kernels = [tm.KERNEL, fd.KERNEL, fd.PAGED_KERNEL, fp.KERNEL, fp.CHUNK_PAGED_KERNEL,
                     kl.KERNEL, krms.KERNEL]
    paged_eng = Engine(cfg, params, prefill_chunk=32, paged=True, page_size=32, **DENSE_KW)
    res, paged, wall = counted(paged_kernels,
                               lambda: paged_eng.generate(prompts, max_new_tokens=DENSE_NEW))
    same = int((res.tokens.numpy() == tokens).all(axis=1).sum())
    print(f"{name} paged (page size 32, prefill_chunk 32): {wall:.3f} s, tokens equal to the "
          f"contiguous grouped serve on {same}/6 rows; launches {paged}")
    check(same == 6, f"{name} paged serve differs from the contiguous one ({same}/6 rows)")
    check(paged[fd.PAGED_KERNEL.symbol] == CODER_DEPTH * DENSE_NEW
          and paged[fp.CHUNK_PAGED_KERNEL.symbol] == CODER_DEPTH
          and paged[fd.KERNEL.symbol] == paged[fp.KERNEL.symbol] == 0,
          f"{name} paged: not {CODER_DEPTH} paged decodes a step and paged chunks a wave "
          f"alone: {paged}")
    check_served(res, cfg, paged_eng, 32 + DENSE_NEW, f"{name} paged")
    paths[f"{name} paged"] = paged
    del eng, paged_eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{name}: {time.perf_counter() - t0:.2f} s]")
    return paths, tok_s


# ---------------------------------------------------------------------------
# the SSM and hybrid families: mamba2-130m, zamba2-7b
# ---------------------------------------------------------------------------

SSM_KW = dict(hot_cap=32, max_len=128, slots=6)
SSM_PROMPT, SSM_NEW = 96, 32  # 6 x (96 + 32): 3 SSD chunks of 32 per prompt
ZAMBA_PLAIN_CUT = 13  # zamba2-7b's plain comparison: 2 groups of 6 and a tail of 1
SSM_MIXED = (96, 64, 33, 17, 5, 3)  # mamba2-130m's mixed serve (prime lengths: chunk 1)


def ssm_launches(cfg):
    """Launches per decode step and per admission of an SSM or hybrid
    model: 2 ternary and 2 rms_norm per Mamba2 block (in_proj, out_proj;
    its two norms) and a LoRA (lora_out) when the config has adapters; per
    shared-block invocation 4 ternary (wqkv, wo, wgu, down), 2 rms_norm and
    3 LoRA (the group's lora_v, lora_o, lora_down) and, per decode step, one
    kernel 2; the final norm once."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm

    n = cfg.n_layers
    ng = n // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
    lora = (n + 3 * ng) if cfg.bitnet.lora_rank else 0
    step = {tm.KERNEL.symbol: 2 * n + 4 * ng, fd.KERNEL.symbol: ng, fp.KERNEL.symbol: 0,
            kl.KERNEL.symbol: lora, krms.KERNEL.symbol: 2 * n + 2 * ng + 1}
    admit = dict(step, **{fd.KERNEL.symbol: 0})
    return step, admit


def hybrid_depth_cut(cfg, params, n):
    """A hybrid ``cfg`` and ``params`` cut to their first ``n`` Mamba2 blocks:
    the whole groups (with their adapters), then the next group's first
    blocks as the tail (``n`` not a multiple of the group)."""
    ng, nt = divmod(n, cfg.hybrid_attn_every)
    return dataclasses.replace(cfg, n_layers=n), dict(
        params, mamba_groups=params["mamba_groups"][:ng],
        shared_lora_v=params["shared_lora_v"][:ng], mamba_tail=params["mamba_groups"][ng][:nt])


def check_ssm_served(fin, cfg, eng, label):
    """Every request's ledger: the closed form at its length over the shared
    block's cache (hybrid), zero bytes without attention (the token
    ledger still counts at 0 bytes a token, as the reference's does); no
    weight reloaded."""
    from repro_torch.core import dr_edram

    check(eng.weight_loads == 0, f"{label}: weights were reloaded")
    for f in fin:
        if cfg.attn_type == "none":
            check(not any(f.traffic.values()) and f.external_reduction == 0.0,
                  f"{label}: row {f.rid} ledger {f.traffic} on an attention-free model")
        else:
            closed = dr_edram.closed_form_reduction(f.seq_len, SSM_KW["hot_cap"])
            check(abs(f.external_reduction - closed) <= 1e-12,
                  f"{label}: row {f.rid} external_reduction {f.external_reduction} != {closed}")
    print(f"{label} DR ledger: bytes a token {eng._kv_token_bytes()}, row 0 external_reduction "
          f"{fin[0].external_reduction!r}, weight_loads = {eng.weight_loads}")


def ssm_model_run(torch, cfg, label, smi, plain_cut):
    """One SSM or hybrid model at full width and depth from seed-0 weights
    packed layer by layer: generate 6 x (96 + 32) after a warm-up, the
    launches per decode step and admission, the ledger, then the same
    prompts at ``plain_cut`` blocks against the plain run. Returns (engine,
    params, prompts, launches, tokens/s)."""
    import numpy as np

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda", pack=True)
    torch.cuda.synchronize()
    s = cfg.ssm
    print(f"{label}: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({cfg.n_layers} Mamba2 blocks, "
          f"d_model {cfg.d_model}, d_inner {s.d_inner(cfg.d_model)}, "
          f"{s.n_heads(cfg.d_model)} SSM heads of {s.head_dim}, {s.n_groups} groups of "
          f"{s.d_state} states, attention {cfg.attn_type}"
          + (f", a shared block every {cfg.hybrid_attn_every} ({cfg.n_heads} heads of "
             f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, LoRA rank {cfg.bitnet.lora_rank})"
             if cfg.family == "hybrid" else "")
          + f", vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}) on {smi}")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (6, SSM_PROMPT)).astype(np.int32)
    kernels = [tm.KERNEL, fd.KERNEL, fp.KERNEL, kl.KERNEL, krms.KERNEL]
    eng = Engine(cfg, params, **SSM_KW)
    t0 = time.perf_counter()
    eng.generate(prompts[:, :8], max_new_tokens=2)  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    print(f"{label} warm-up generate 6 x (8 + 2): {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts,
                                                                max_new_tokens=SSM_NEW))
    tok_s = 6 * SSM_NEW / wall
    print(f"{label} generate 6 x ({SSM_PROMPT} + {SSM_NEW}): {wall:.3f} s, {tok_s:.1f} tokens/s, "
          f"launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, on {smi}")
    tokens = res.tokens.numpy()
    check(tokens.shape == (6, SSM_NEW) and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          f"{label}: generated tokens out of range or short")
    check(all(f.seq_len == SSM_PROMPT + SSM_NEW for f in res.finished),
          f"{label}: a row's seq_len is not {SSM_PROMPT + SSM_NEW}")
    check_ssm_served(res.finished, cfg, eng, label)
    step, admit = ssm_launches(cfg)
    want = {k: step[k] * SSM_NEW + admit[k] for k in step}
    check(launches == want, f"{label}: launches {launches} != {want} (per decode step "
                            f"{step}, per admission {admit})")
    print(f"{label} launches per decode step / admission: ternary {step[tm.KERNEL.symbol]} / "
          f"{admit[tm.KERNEL.symbol]}, flash_decode_gqa_fused {step[fd.KERNEL.symbol]} / 0, "
          f"flash_prefill_fresh 0 / 0, rms_norm {step[krms.KERNEL.symbol]} / "
          f"{admit[krms.KERNEL.symbol]}, lora_delta {step[kl.KERNEL.symbol]} / "
          f"{admit[kl.KERNEL.symbol]} (as checked)")
    c_cut, p_cut = ((cfg, params) if plain_cut == cfg.n_layers
                    else hybrid_depth_cut(cfg, params, plain_cut))
    plain = dataclasses.replace(c_cut, bitnet=dataclasses.replace(c_cut.bitnet, impl="plain"))
    t0 = time.perf_counter()
    tok_k = (tokens if plain_cut == cfg.n_layers else Engine(c_cut, p_cut, **SSM_KW).generate(
        prompts, max_new_tokens=SSM_NEW).tokens.numpy())
    tok_p = Engine(plain, p_cut, **SSM_KW).generate(prompts,
                                                    max_new_tokens=SSM_NEW).tokens.numpy()
    same = int((tok_k == tok_p).all(axis=1).sum())
    print(f"{label} kernel and plain runs at {plain_cut} blocks: "
          f"{time.perf_counter() - t0:.2f} s; greedy tokens equal on {same}/6 rows")
    check(same == 6, f"{label}: greedy tokens at {plain_cut} blocks differ from the plain run "
                     f"({same}/6 rows equal)")
    return eng, params, prompts, launches, tok_s


def mamba_mixed_serve(torch, cfg, params, label):
    """mamba2-130m serving prompts of SSM_MIXED tokens + 32 over 6 slots
    (one group per length), equal to its plain serve; each request served
    alone against the batched serve, printed (the SSD scan's plain einsums
    run at the group's batch size)."""
    import numpy as np

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(5)
    specs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SSM_MIXED]

    def reqs():
        return [Request(rid=i, tokens=t, max_new_tokens=SSM_NEW) for i, t in enumerate(specs)]

    plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    t0 = time.perf_counter()
    eng = Engine(cfg, params, **SSM_KW)
    fin = {f.rid: f for f in eng.serve(reqs())}
    wall = time.perf_counter() - t0
    fin_p = {f.rid: f for f in Engine(plain, params, **SSM_KW).serve(reqs())}
    same = sum(np.array_equal(fin[r].tokens, fin_p[r].tokens) for r in fin)
    print(f"{label} mixed serve (prompts {SSM_MIXED} + {SSM_NEW}, 6 slots): {wall:.2f} s, "
          f"tokens equal to the plain serve on {same}/6 requests")
    check(same == 6 and all(len(f.tokens) == SSM_NEW for f in fin.values()),
          f"{label}: the mixed serve differs from its plain run ({same}/6 requests)")
    check_ssm_served(list(fin.values()), cfg, eng, f"{label} mixed serve")
    alone = []
    for r in reqs():
        f = Engine(cfg, params, **SSM_KW).serve([r])[0]
        alone.append(bool(np.array_equal(f.tokens, fin[r.rid].tokens)))
    print(f"{label}: each request served alone against the batched serve (prompts "
          f"{SSM_MIXED}): equal {alone} ({sum(alone)}/6)")


def ssm_families_phase(torch, smi):
    """mamba2-130m and zamba2-7b at full width and depth on the card (see the
    module docstring, item 6). Returns (launches by path, tokens/s by path)."""
    from repro_torch.configs import get_config

    paths, tok_s = {}, {}
    t0 = time.perf_counter()
    cfg = get_config("mamba2-130m")
    eng, params, _, paths["mamba2-130m"], tok_s["mamba2-130m"] = ssm_model_run(
        torch, cfg, "mamba2-130m", smi, plain_cut=cfg.n_layers)
    mamba_mixed_serve(torch, cfg, params, "mamba2-130m")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mamba2-130m: {time.perf_counter() - t0:.2f} s]")

    t0 = time.perf_counter()
    cfg = get_config("zamba2-7b")
    eng, params, prompts, paths["zamba2-7b"], tok_s["zamba2-7b"] = ssm_model_run(
        torch, cfg, "zamba2-7b", smi, plain_cut=ZAMBA_PLAIN_CUT)
    breakdown(torch, eng, prompts, label="zamba2-7b", new=8)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[zamba2-7b: {time.perf_counter() - t0:.2f} s]")
    return paths, tok_s


# ---------------------------------------------------------------------------
# the frontend families: llava-next-34b (vision), hubert-xlarge (audio)
# ---------------------------------------------------------------------------

VLM_KW = dict(hot_cap=32, max_len=640, slots=6)
VLM_TEXT, VLM_NEW = 32, 32  # 6 x (576 patches + 32 text + 32 new): S = 640
VLM_PLAIN_CUT = 2  # the depth of llava-next-34b's plain and alone-vs-batched checks
AUDIO_FRAMES = 512  # hubert-xlarge: 6 utterances of 512 frames (about 10 s of 16 kHz audio)


def vlm_model_run(torch, smi):
    """llava-next-34b at full width and depth (60 layers) from seed-0
    weights packed layer by layer: 6 requests of 576 seeded patch rows of
    1024 ahead of 32 text tokens, then VLM_NEW new tokens, after a
    warm-up; memory, launches per decode step and admission, the ledger at
    S = 640, ``weight_loads``; at VLM_PLAIN_CUT layers the kernel run
    against the plain run and each request served alone against the
    batched serve (printed); a traced generate. Returns (launches, tokens/s)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine

    label = "llava-next-34b"
    cfg = get_config(label)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda", pack=True)
    torch.cuda.synchronize()
    print(f"{label}: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, frontend "
          f"{cfg.frontend} {cfg.n_patches} x {cfg.frontend_dim}) on {smi}")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (6, VLM_TEXT)).astype(np.int32)
    patches = rng.standard_normal((6, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    kernels = [tm.KERNEL, fd.KERNEL, fp.KERNEL, kl.KERNEL, krms.KERNEL]
    eng = Engine(cfg, params, **VLM_KW)
    t0 = time.perf_counter()
    eng.generate(prompts[:, :8], max_new_tokens=2, patches=patches)  # warm-up
    torch.cuda.synchronize()
    print(f"{label} warm-up generate 6 x ({cfg.n_patches} + 8 + 2): "
          f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted(kernels, lambda: eng.generate(
        prompts, max_new_tokens=VLM_NEW, patches=patches))
    tok_s = 6 * VLM_NEW / wall
    p_len = cfg.n_patches + VLM_TEXT
    print(f"{label} generate 6 x ({cfg.n_patches} + {VLM_TEXT} + {VLM_NEW}): {wall:.3f} s, "
          f"{tok_s:.1f} tokens/s, launches {launches}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_served(res, cfg, eng, p_len + VLM_NEW, label, prompt_len=p_len)
    n, steps = cfg.n_layers, VLM_NEW
    want = {tm.KERNEL.symbol: 4 * n * (steps + 1), fd.KERNEL.symbol: n * steps,
            fp.KERNEL.symbol: n, kl.KERNEL.symbol: 0,
            krms.KERNEL.symbol: (2 * n + 1) * (steps + 1)}
    check(launches == want, f"{label}: launches {launches} != {want}")
    print(f"{label} launches per decode step / admission: ternary {4 * n} / {4 * n}, "
          f"flash_decode_gqa_fused {n} / 0, flash_prefill_fresh 0 / {n} (s {p_len}), rms_norm "
          f"{2 * n + 1} / {2 * n + 1}, lora_delta 0 / 0 (as checked)")
    cut = VLM_PLAIN_CUT
    c_cut, p_cut = dense_depth_cut(cfg, params, cut)
    plain = dataclasses.replace(c_cut, bitnet=dataclasses.replace(c_cut.bitnet, impl="plain"))
    t0 = time.perf_counter()
    tok_k, tok_p = (Engine(c, p_cut, **VLM_KW).generate(
        prompts, max_new_tokens=VLM_NEW, patches=patches).tokens.numpy() for c in (c_cut, plain))
    same = int((tok_k == tok_p).all(axis=1).sum())
    print(f"{label} kernel and plain runs at {cut} layers: {time.perf_counter() - t0:.2f} s; "
          f"greedy tokens equal on {same}/6 rows")
    check(same == 6, f"{label}: greedy tokens at {cut} layers differ from the plain run "
                     f"({same}/6 rows equal)")
    # the frontend's float products are cuBLAS GEMMs at M = rows x 576, whose
    # row values may change with M (ROADMAP fault 3): printed, no limit
    alone_eng = Engine(c_cut, p_cut, **VLM_KW)
    alone = [bool((alone_eng.generate(prompts[i:i + 1], max_new_tokens=VLM_NEW,
                                      patches=patches[i:i + 1]).tokens.numpy()[0]
                   == tok_k[i]).all()) for i in range(6)]
    print(f"{label} at {cut} layers, each request served alone against the batched serve: "
          f"equal {alone} ({sum(alone)}/6)")
    breakdown(torch, eng, prompts, label=label, new=8, patches=patches)
    del eng, alone_eng, params, p_cut
    return launches, tok_s


def audio_model_run(torch, smi):
    """hubert-xlarge at full width and depth (48 layers): the packed
    ``forward`` over 6 x AUDIO_FRAMES seeded frames of 512, its launches,
    its logits against the plain run's at full depth (argmax equal on every
    frame, the largest difference printed), and the engine's refusal.
    Returns the forward's launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine

    label = "hubert-xlarge"
    cfg = get_config(label)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda", pack=True)
    torch.cuda.synchronize()
    print(f"{label}: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.resolved_head_dim}, "
          f"d_ff {cfg.d_ff} {cfg.activation}, encoder {cfg.is_encoder}, frontend "
          f"{cfg.frontend} {cfg.frontend_dim}) on {smi}")
    frames = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (6, AUDIO_FRAMES, cfg.frontend_dim)).astype(np.float32),
        device=params["final_ln"].device)
    kernels = [tm.KERNEL, fd.KERNEL, fp.KERNEL, kl.KERNEL, krms.KERNEL]
    with torch.inference_mode():
        T.forward(params, cfg, {"frames": frames})  # warm-up
        torch.cuda.reset_peak_memory_stats()
        logits, launches, wall = counted(kernels, lambda: T.forward(params, cfg,
                                                                    {"frames": frames}))
        plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
        t0 = time.perf_counter()
        ref = T.forward(params, plain, {"frames": frames})
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    n = cfg.n_layers
    print(f"{label} forward 6 x {AUDIO_FRAMES} frames: {wall:.3f} s "
          f"({6 * AUDIO_FRAMES / wall:.0f} frames/s), plain run {plain_wall:.3f} s, launches "
          f"{launches}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = {tm.KERNEL.symbol: 4 * n, fd.KERNEL.symbol: 0, fp.KERNEL.symbol: 0,
            kl.KERNEL.symbol: 0, krms.KERNEL.symbol: 2 * n + 1}
    check(launches == want, f"{label}: launches {launches} != {want}")
    check(tuple(logits.shape) == (6, AUDIO_FRAMES, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{label}: logits {tuple(logits.shape)}")
    same = int((logits.argmax(-1) == ref.argmax(-1)).sum())
    print(f"{label} logits against the plain run at full depth: argmax equal on {same} / "
          f"{6 * AUDIO_FRAMES} frames, largest absolute difference {max_err(logits, ref)!r}")
    check(same == 6 * AUDIO_FRAMES, f"{label}: argmax differs from the plain run on "
                                    f"{6 * AUDIO_FRAMES - same} frames")
    eng = Engine(cfg, params, **VLM_KW)
    try:
        eng.generate(np.zeros((6, 8), np.int32), max_new_tokens=4)
        refused = None
    except ValueError as err:
        refused = str(err)
    check(refused is not None and "audio" in refused,
          f"{label}: the engine did not refuse the encoder ({refused!r})")
    print(f"{label}: Engine.generate refused with ValueError({refused!r})")
    del eng, params, logits, ref
    return launches


def frontend_families_phase(torch, smi):
    """llava-next-34b and hubert-xlarge at full width and depth on the card
    (the module docstring, item 7). Returns (launches by path, tokens/s by
    path)."""
    paths, tok_s = {}, {}
    t0 = time.perf_counter()
    paths["llava-next-34b"], tok_s["llava-next-34b"] = vlm_model_run(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[llava-next-34b: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    paths["hubert-xlarge forward"] = audio_model_run(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[hubert-xlarge: {time.perf_counter() - t0:.2f} s]")
    return paths, tok_s


# ---------------------------------------------------------------------------
# mixtral-8x22b: sliding-window attention over the ring, MoE top-2 of 8
# ---------------------------------------------------------------------------

# (prompt, new tokens): two inside the 4096 window, one that crosses it
# during decode (at its 47th token), one longer than it at admission
MIXTRAL_SPECS = ((1000, 48), (3000, 64), (4050, 64), (4200, 32))
MIXTRAL_KW = dict(hot_cap=32, max_len=4352, slots=4)
# the depth of mixtral-8x22b's dropless, chunked and speculative serves: 8
# since the frontend families phase (16 before; the run's time)
MIXTRAL_CUT = 8
MIXTRAL_SHAPES = {2: set(MIXTRAL_2D), 3: set(MIXTRAL_EXPERT)}


def mixtral_requests(vocab):
    """A function giving fresh Requests of MIXTRAL_SPECS (seeded prompts)."""
    import numpy as np

    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, vocab, (p,)).astype(np.int32) for p, _ in MIXTRAL_SPECS]
    return lambda: [Request(i, t, n) for i, (t, (_, n)) in enumerate(zip(prompts, MIXTRAL_SPECS))]


def check_requests(fin, cfg, eng, label):
    """Every request finished with its budget, tokens in range, no weight
    reloaded, and its ledger the reference's rule: the prompt in closed
    form plus one step ledger per decode step at the engine's hot_cap
    (which the SWA cache does not have; the reference charges it all the
    same), i.e. external_reduction at closed_form_reduction(seq_len,
    hot_cap)."""
    from repro_torch.core import dr_edram
    from repro_torch.core import kv_cache as kvc

    import torch

    hot, token_bytes = eng.hot_cap, eng._kv_token_bytes()
    check(len(fin) == len(MIXTRAL_SPECS), f"{label}: {len(fin)} requests finished")
    check(eng.weight_loads == 0, f"{label}: weights were reloaded")
    for f in fin:
        p, n = MIXTRAL_SPECS[f.rid]
        check(f.prompt_len == p and f.seq_len == p + n and len(f.tokens) == n
              and ((f.tokens >= 0) & (f.tokens < cfg.vocab_size)).all(),
              f"{label}: request {f.rid} finished as {f.prompt_len} + {len(f.tokens)}")
        steps = kvc.step_traffic_tokens(torch.arange(p, p + n, dtype=torch.int32), hot)
        prompt = kvc.prompt_traffic_tokens(p, hot)
        want = {k: (prompt[k] + int(steps[k].sum())) * token_bytes for k in kvc.TRAFFIC_KEYS}
        closed = dr_edram.closed_form_reduction(p + n, hot)
        check(f.traffic == want and abs(f.external_reduction - closed) <= 1e-12,
              f"{label}: request {f.rid} ledger {f.traffic} != {want} or reduction "
              f"{f.external_reduction} != {closed}")


def swa_decode_breakdown(torch, eng, label, length=4180, n_steps=16):
    """Where a mixtral-8x22b decode step's time goes: ``n_steps`` steps of
    the engine's decode (every slot active over a wrapped ring of seeded
    rows at ``length``), traced with torch.profiler after two warm-up
    steps."""
    state = eng._init_state(eng.slots, eng.max_len)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for stack in state.cache.values():
        for t in stack[:4]:
            if t.numel():
                t.normal_(generator=gen)
        stack.lengths.fill_(length)
    state.allocated.fill_(True)
    state.seq_len.fill_(length)
    state.max_new.fill_(1 << 20)
    state.tok = torch.randint(0, eng.cfg.vocab_size, (eng.slots,), generator=gen, device="cuda",
                              dtype=torch.int32)
    timing = {}

    def steps(k):
        for _ in range(k):
            eng._step(state, eng.max_len, None)

    def run():
        t0 = time.perf_counter()
        steps(n_steps)
        torch.cuda.synchronize()
        timing["wall"] = (time.perf_counter() - t0) * 1e3

    events = sorted(trace_events(run, warm=lambda: steps(2)), key=_device_us, reverse=True)
    wall, busy = timing["wall"], sum(_device_us(e) for e in events) / 1e3
    if busy <= 0:
        print(f"{label} decode breakdown: device time not measured (the trace holds none)")
        return
    print(f"{label} decode breakdown, {n_steps} steps of {eng.slots} slots at length {length}: "
          f"wall {wall:.2f} ms, device busy {busy:.2f} ms ({100 * busy / wall:.1f} %), idle "
          f"{100 * (1 - busy / wall):.1f} %; per step wall {wall / n_steps:.3f} ms")
    for e in events[:8]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    for name, key in (("ternary matmul kernels", TERNARY), ("ring decode kernel", RING_DECODE),
                      ("rms_norm kernel", "rms_norm_kernel")):
        sel = [e for e in events if key in e.key]
        sel_ms = sum(_device_us(e) for e in sel) / 1e3
        print(f"  {name}: {sel_ms:.3f} ms device time in {sum(e.count for e in sel)} launches "
              f"({100 * sel_ms / busy:.2f} % of device busy)")


# (rid, new tokens) of the 2-layer fp8 speculative check: 4200 + 16, its
# rounds committing into a ring wrapped at admission (4050 + 48 as well
# took the script past 900 s; the 16-layer f32 mixes serve both)
MIXTRAL_FP8_SPEC = ((3, 16),)


def oracle_draft(torch, eng, want, bad=None):
    """Make ``eng``'s draft propose a known continuation: each draft decode
    step keeps its real forward pass (the draft cache advances as it
    would) and replaces its logits by a one-hot at ``want[rid][i]``, the
    token the non-speculative serve emitted after the one being drafted
    (i = the draft's length before the step - prompt length + 1); where
    ``bad[rid][i]``, the next token id instead, which the target rejects.
    Returns a function that removes it. The oracle lives here only; the
    package's draft is a model."""
    from repro_torch.models import transformer as T

    decode = T.decode_step

    def step(params, cfg, tokens, cache, active=None):
        if params is not eng.draft_params:
            return decode(params, cfg, tokens, cache, active=active)
        pos = next(iter(cache.values())).lengths[0].tolist()  # before the append
        logits, cache = decode(params, cfg, tokens, cache, active=active)
        prop = logits.argmax(-1).tolist()
        for s, req in enumerate(eng._last_ctx.sched.slot_req):
            i = -1 if req is None else pos[s] - req.prompt_len + 1
            if 0 <= i < len(want[req.rid]):
                tok = int(want[req.rid][i])
                prop[s] = (tok + 1) % cfg.vocab_size if bad is not None and bad[req.rid][i] else tok
        hot = torch.zeros_like(logits)
        hot[torch.arange(len(prop), device=logits.device),
            torch.tensor(prop, device=logits.device)] = 1.0
        return hot, cache

    T.decode_step = step

    def remove():
        T.decode_step = decode

    return remove


def recording_rounds():
    """Record every speculative round's (seq0, chunk_valid, committed) as
    the engine charges them (``kv_cache.spec_traffic_tokens``); returns the
    list and a function that stops the recording."""
    from repro_torch.core import kv_cache as kvc

    charge, rounds = kvc.spec_traffic_tokens, []

    def spy(lengths, chunk_valid, committed, hot_cap):
        rounds.append((lengths.tolist(), chunk_valid.tolist(), committed.tolist()))
        return charge(lengths, chunk_valid, committed, hot_cap)

    kvc.spec_traffic_tokens = spy

    def stop():
        kvc.spec_traffic_tokens = charge

    return rounds, stop


def check_spec_requests(fin, eng, rounds, specs, label):
    """A speculative serve's requests: each finished with its budget, no
    weight reloaded, and its ledger the reference's rule for speculation:
    the prompt in closed form plus ``spec_traffic_tokens`` of every round
    its slot took part in (a ring charges the rows it committed). A slot's
    request is the one whose prompt length its first round started at."""
    from repro_torch.core import kv_cache as kvc

    import torch

    hot, token_bytes = eng.hot_cap, eng._kv_token_bytes()
    check(eng.weight_loads == 0, f"{label}: weights were reloaded")
    per_slot, committed = {}, {}
    for seq0, valid, comm in rounds:
        tr = kvc.spec_traffic_tokens(*(torch.tensor(x, dtype=torch.int32)
                                       for x in (seq0, valid, comm)), hot)
        for s, v in enumerate(valid):
            if v > 0:
                key = per_slot.setdefault(s, (seq0[s], {k: 0 for k in kvc.TRAFFIC_KEYS}))
                for k in kvc.TRAFFIC_KEYS:
                    key[1][k] += int(tr[k][s])
                committed[s] = committed.get(s, 0) + comm[s]
    by_prompt = {p: (s, led) for s, (p, led) in per_slot.items()}
    for f in fin:
        p, n = specs[f.rid]
        check(f.outcome == "finished" and f.prompt_len == p and f.seq_len == p + n
              and len(f.tokens) == n and p in by_prompt,
              f"{label}: request {f.rid} finished as {f.prompt_len} + {len(f.tokens)}")
        s, led = by_prompt[p]
        prompt = kvc.prompt_traffic_tokens(p, hot)
        want = {k: (prompt[k] + led[k]) * token_bytes for k in kvc.TRAFFIC_KEYS}
        check(f.traffic == want and committed[s] == n,
              f"{label}: request {f.rid} ledger {f.traffic} != {want}, or {committed[s]} rows "
              f"committed for {n} tokens")


def mixtral_speculative(torch, cfg, packed, reqs, base, kernels, smi):
    """Speculative decoding over the sliding-window ring, at the dropless
    cut ``cfg`` (MIXTRAL_CUT layers, capacity E / k) of mixtral-8x22b: the draft is
    ``make_draft_config(cfg)`` (2 dense layers, d_model 64, 4 / 4 heads of
    16, the 32768 vocabulary, tied) from seed 7; K = SPEC_K, chunked
    admission (``prefill_chunk`` 256). Three mixes over MIXTRAL_SPECS, each
    with tokens equal to ``base`` (the non-speculative grouped serve's) on
    4/4, including 4050 + 64 (the ring wraps inside a committed chunk) and
    4200 + 32 (wrapped at admission): (a) reject: the seeded draft with
    ``spec_force="reject"``, accepted 0; (b) full accept: ``oracle_draft``
    proposing ``base``'s tokens, accepted == drafted; (c) mixed: the oracle
    with a seeded third of its proposals corrupted. Each: one ring-chunk
    launch per layer per round and per wave, no target ring decode, 2 x K
    draft decodes per round, ledgers (``check_spec_requests``). Then over
    fp8 tiers at 2 layers: the speculative serve of MIXTRAL_FP8_SPEC equals
    its plain run. Prints acceptance rates and one verify's device ms
    against K ring decode steps'. Returns the mixed run's launches."""
    import numpy as np

    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params
    from repro_torch.serving import speculative as spec_lib
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    label, k, n_l = f"{cfg.name} speculative", SPEC_K, cfg.n_layers
    dcfg = spec_lib.make_draft_config(cfg)
    dparams = pack_params(T.init_params(dcfg, seed=7, device="cuda"), dcfg)
    kw = dict(MIXTRAL_KW, prefill_chunk=256)
    specs = dict(enumerate(MIXTRAL_SPECS))
    rng = np.random.default_rng(27)
    bad = {rid: rng.random(len(t)) < 1 / 3 for rid, t in base.items()}
    kernels = kernels + [fd.KERNEL, fp.CHUNK_KERNEL]
    kernels = list({kern.symbol: kern for kern in kernels}.values())
    out = None
    for mix, extra, oracle in (("reject", dict(spec_force="reject"), None),
                               ("full accept", {}, {}), ("mixed", {}, bad)):
        eng = Engine(cfg, packed, draft_cfg=dcfg, draft_params=dparams, spec_k=k, **kw, **extra)
        rounds_n, waves = counting(eng, "_spec_step"), counting(eng, "_chunk_step")
        dwaves = counting(eng, "_draft_chunk_step")
        remove = (oracle_draft(torch, eng, base, oracle or None) if oracle is not None
                  else (lambda: None))
        rounds, stop = recording_rounds()
        try:
            fin, launches, wall = counted(kernels, lambda: eng.serve(reqs()))
        finally:
            stop()
            remove()
        st = eng.last_stats
        same = sum(bool(np.array_equal(f.tokens, base[f.rid])) for f in fin)
        rate = st.accepted_tokens / st.drafted_tokens if st.drafted_tokens else 0.0
        print(f"{label} {mix} (K {k}): {wall:.3f} s, {len(rounds_n)} rounds, {len(waves)} target "
              f"/ {len(dwaves)} draft chunk waves, drafted {st.drafted_tokens}, accepted "
              f"{st.accepted_tokens} (acceptance rate {rate:.4f}); tokens equal to the "
              f"non-speculative serve on {same}/{len(fin)}; launches {launches}")
        check(same == len(MIXTRAL_SPECS) == len(fin),
              f"{label} {mix}: tokens differ from the non-speculative serve ({same})")
        check(launches[fp.CHUNK_RING_KERNEL.symbol] == n_l * (len(waves) + len(rounds_n))
              and launches[fd.RING_KERNEL.symbol] == 0
              and launches[fp.WINDOW_KERNEL.symbol] == 0
              and launches[fd.KERNEL.symbol] == dcfg.n_layers * k * len(rounds_n)
              and launches[fp.CHUNK_KERNEL.symbol] == dcfg.n_layers * len(dwaves),
              f"{label} {mix}: not {n_l} ring chunks per round and wave, no ring decode, "
              f"{dcfg.n_layers} x {k} draft decodes per round: {launches}")
        check(len(rounds) == len(rounds_n), f"{label} {mix}: rounds not charged once each")
        check_spec_requests(fin, eng, rounds, specs, f"{label} {mix}")
        check(st.accepted_tokens <= st.drafted_tokens
              and st.drafted_tokens == sum(f.drafted_tokens for f in fin)
              and st.accepted_tokens == sum(f.accepted_tokens for f in fin),
              f"{label} {mix}: drafted / accepted {st.drafted_tokens} / {st.accepted_tokens}")
        if mix == "reject":
            check(st.accepted_tokens == 0, f"{label} reject: accepted {st.accepted_tokens}")
        elif mix == "full accept":
            check(st.accepted_tokens == st.drafted_tokens > 0,
                  f"{label} full accept: accepted {st.accepted_tokens} of {st.drafted_tokens}")
        else:
            check(0 < st.accepted_tokens < st.drafted_tokens,
                  f"{label} mixed: accepted {st.accepted_tokens} of {st.drafted_tokens}")
            out = launches
        del eng

    # one verify against K ring decode steps, every slot at length 4180
    eng = Engine(cfg, packed, **MIXTRAL_KW)
    state = eng._init_state(eng.slots, eng.max_len)
    gen = torch.Generator(device="cuda").manual_seed(4)
    length = 4180
    for stack in state.cache.values():
        for t in stack[:4]:
            if t.numel():
                t.normal_(generator=gen)
        stack.lengths.fill_(length)
    chunk = torch.randint(0, cfg.vocab_size, (eng.slots, k), generator=gen, device="cuda",
                          dtype=torch.int32)
    full = torch.full((eng.slots,), k, dtype=torch.int32, device="cuda")

    def decode_steps():
        for j in range(k):
            T.decode_step(packed, cfg, chunk[:, j], state.cache)
        for stack in state.cache.values():
            stack.lengths.fill_(length)

    verify_ms, _ = timed(f"verify K {k} ({n_l} layers)", lambda: T.spec_verify_chunk(
        packed, cfg, chunk, state.cache, full), iters=3)
    decode_ms, _ = timed(f"{k} ring decode steps ({n_l} layers)", decode_steps, iters=3)
    print(f"{label} device ms at length {length}, 4 slots: one verify of K {k} "
          f"{verify_ms:.3f} against {k} decode steps {decode_ms:.3f} (ratio "
          f"{verify_ms / decode_ms:.3f}) on {smi}")
    del eng, state

    # fp8 tiers at 2 layers: the speculative serve against its plain run
    c8 = dataclasses.replace(cfg, name="mixtral-8x22b-l2", n_layers=2,
                             bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    plain8 = dataclasses.replace(c8, bitnet=dataclasses.replace(c8.bitnet, impl="plain"))
    p8 = dict(packed, moe_blocks=packed["moe_blocks"][:2])
    subset = [Request(rid, reqs()[rid].tokens, n) for rid, n in MIXTRAL_FP8_SPEC]
    runs = {}
    t0 = time.perf_counter()
    for name, c in (("kernel", c8), ("plain", plain8)):
        e = Engine(c, p8, draft_cfg=dcfg, draft_params=dparams, spec_k=k,
                   **dict(kw, slots=len(subset)))
        fin8, l8, _ = counted(kernels + [fp.FP8_CHUNK_RING_KERNEL], lambda: e.serve(
            [Request(r.rid, r.tokens, r.max_new_tokens) for r in subset]))
        runs[name] = {f.rid: f.tokens for f in fin8}
        if name == "kernel":
            check(l8[fp.FP8_CHUNK_RING_KERNEL.symbol] > 0
                  and l8[fp.CHUNK_RING_KERNEL.symbol] == l8[fd.RING_KERNEL.symbol] == 0,
                  f"{label} fp8: launches {l8}")
    same = sum(bool(np.array_equal(runs["kernel"][r], runs["plain"][r])) for r in runs["kernel"])
    print(f"{c8.name} fp8 speculative (K {k}; requests (rid, new) {MIXTRAL_FP8_SPEC}, "
          f"{len(subset)} slot(s)): kernel run against its plain run ({time.perf_counter() - t0:.2f} s): tokens "
          f"equal on {same}/{len(subset)}")
    check(same == len(subset), f"{label} fp8: the kernel run differs from its plain run")
    return out


def mixtral_phase(torch, smi):
    """mixtral-8x22b at full width and depth (56 layers, 48 / 8 heads of
    128, 8 experts top-2, window 4096), seeded, packed as drawn, served over
    4 slots (hot_cap 32 for the ledger, max_len 4352, a 4096-row ring) with
    the four requests of MIXTRAL_SPECS. At the published capacity factor
    1.25 (tokens past an expert's capacity drop): grouped admission (the
    window prefill and the ring realign), the launches of every kernel of
    the path, one ring decode and one router launch per layer per step,
    ledgers, a traced decode. Dropless (capacity factor E / k, every expert
    takes every token, so a token's output does not depend on the tokens
    batched with it), at the depth cut to MIXTRAL_CUT layers: grouped and chunked
    admission (prefill_chunk 256: the chunked ring form), tokens equal on
    every request, and served speculatively (``mixtral_speculative``). At
    the depth cut to 2 layers: the published run equal to its plain run
    (the same batching), and each request served alone equal to the
    dropless batched serve; over fp8 tiers, grouped and chunked admission
    each equal to their plain runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms
    from repro_torch.kernels import ternary_matmul as tm
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request

    cfg = get_config("mixtral-8x22b")
    # with the published 1.25 a token's experts, and so its output, depend
    # on the tokens batched with it (the reference's own semantics), so only
    # runs of the same batching can be held equal; runs that batch
    # differently are compared dropless
    cfg_d = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    label = cfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    packed = T.init_params(cfg, seed=0, device="cuda", pack=True)
    torch.cuda.synchronize()
    print(f"{label}: init + pack (layer by layer) {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, init peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    shapes = {leaf.packed.dim(): set() for leaf in packed_leaves(packed)}
    for leaf in packed_leaves(packed):
        shapes[leaf.packed.dim()].add((leaf.k, leaf.packed.shape[-1]))
    check(set(packed) == {"embed", "final_ln", "lm_head", "moe_blocks"}
          and len(packed["moe_blocks"]) == cfg.n_layers and shapes == MIXTRAL_SHAPES,
          f"{label}: tree {sorted(packed)} with packed shapes {shapes} is not the MoE stack "
          f"alone at {MIXTRAL_SHAPES}")
    print(f"{label} packed projection shapes (K, N): {shapes}")
    reqs = mixtral_requests(cfg.vocab_size)
    n_new = sum(n for _, n in MIXTRAL_SPECS)
    kernels = [tm.KERNEL, tm.EXPERT_KERNEL, fd.RING_KERNEL, fd.KERNEL, fp.WINDOW_KERNEL,
               fp.CHUNK_RING_KERNEL, fp.KERNEL, fp.CHUNK_KERNEL, kl.KERNEL, krms.KERNEL]
    eng = Engine(cfg, packed, **MIXTRAL_KW)
    t0 = time.perf_counter()
    eng.serve([Request(99, reqs()[0].tokens[:40], 2)])  # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    print(f"warm-up serve 1 x (40 + 2): {time.perf_counter() - t0:.2f} s")
    steps = counting_steps(eng)
    torch.cuda.reset_peak_memory_stats()
    fin, launches, wall = counted(kernels, lambda: eng.serve(reqs()))
    tok_s = n_new / wall
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} grouped serve of {MIXTRAL_SPECS} over 4 slots, capacity factor "
          f"{cfg.moe.capacity_factor}: {wall:.3f} s, {tok_s:.2f} tokens/s, {len(steps)} decode "
          f"steps, launches {launches}, peak device memory {peak:.2f} GiB")
    check_requests(fin, cfg, eng, label)
    L, n_adm = cfg.n_layers, len(MIXTRAL_SPECS)
    check(all(launches[k.symbol] > 0 for k in (tm.KERNEL, tm.EXPERT_KERNEL, fd.RING_KERNEL,
                                               fp.WINDOW_KERNEL, kl.KERNEL, krms.KERNEL)),
          f"{label}: a kernel of the path never launched: {launches}")
    check(launches[fd.RING_KERNEL.symbol] == L * len(steps) and launches[fd.KERNEL.symbol] == 0,
          f"{label}: not one ring decode per layer per step ({len(steps)} steps): {launches}")
    check(launches[fp.WINDOW_KERNEL.symbol] == L * n_adm
          and launches[fp.KERNEL.symbol] == 0 and launches[fp.CHUNK_RING_KERNEL.symbol] == 0,
          f"{label}: not one window prefill per layer per admission: {launches}")
    check(launches[kl.KERNEL.symbol] == L * (len(steps) + n_adm),
          f"{label}: not one router launch per layer per step and admission: {launches}")
    print(f"{label}: {launches[fd.RING_KERNEL.symbol] / len(steps):g} ring decode launches per "
          f"step, {launches[fp.WINDOW_KERNEL.symbol] / n_adm:g} window prefill launches per "
          f"admission, {L} router launches per step and admission; ledgers at the reference's "
          f"rule; weight_loads = 0")
    swa_decode_breakdown(torch, eng, label)

    # fp8 tiers (kv_fp8), the same grouped serve at the published capacity
    cfg8 = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, kv_fp8=True))
    kernels8 = kernels + [fd.FP8_RING_KERNEL, fp.FP8_WINDOW_KERNEL, fp.FP8_CHUNK_RING_KERNEL]
    eng8 = Engine(cfg8, packed, **MIXTRAL_KW)
    eng8.serve([Request(99, reqs()[0].tokens[:40], 2)])  # warm-up
    steps8 = counting_steps(eng8)
    torch.cuda.reset_peak_memory_stats()
    fin8, launches8, wall8 = counted(kernels8, lambda: eng8.serve(reqs()))
    peak8 = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label} fp8 grouped serve (capacity factor {cfg.moe.capacity_factor}): {wall8:.3f} "
          f"s, {len(steps8)} decode steps, launches {launches8}")
    check_requests(fin8, cfg8, eng8, f"{label} fp8")
    check(launches8[fd.FP8_RING_KERNEL.symbol] == L * len(steps8)
          and launches8[fp.FP8_WINDOW_KERNEL.symbol] == L * n_adm
          and launches8[fd.RING_KERNEL.symbol] == launches8[fp.WINDOW_KERNEL.symbol] == 0
          and launches8[fd.KERNEL.symbol] == launches8[fp.KERNEL.symbol] == 0
          and all(launches8[k.symbol] > 0 for k in (tm.KERNEL, tm.EXPERT_KERNEL, kl.KERNEL,
                                                    krms.KERNEL)),
          f"{label} fp8: not {L} fp8 ring decodes per step and {L} fp8 window prefills per "
          f"admission alone: {launches8}")
    same8 = sum(bool((f.tokens == g.tokens).all()) for f, g in zip(
        sorted(fin, key=lambda f: f.rid), sorted(fin8, key=lambda f: f.rid)))
    print(f"{label} f32 tiers against fp8 tiers, the same grouped serve in this call: "
          f"{tok_s:.2f} against {n_new / wall8:.2f} tokens/s, peak device memory {peak:.2f} "
          f"against {peak8:.2f} GiB; {L} fp8 ring decodes per step; tokens equal on "
          f"{same8}/{len(fin8)} requests (printed, not checked) on {smi}")
    del eng8

    # dropless: grouped against chunked admission, at the depth cut to
    # MIXTRAL_CUT layers (the run's time; the first layers' weights, full width)
    L16 = MIXTRAL_CUT
    cfg_d = dataclasses.replace(cfg_d, name=f"mixtral-8x22b-l{L16}", n_layers=L16)
    packed16 = dict(packed, moe_blocks=packed["moe_blocks"][:L16])
    torch.cuda.reset_peak_memory_stats()
    eng_d = Engine(cfg_d, packed16, **MIXTRAL_KW)
    t0 = time.perf_counter()
    fin_d = eng_d.serve(reqs())
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    check_requests(fin_d, cfg_d, eng_d, f"{label} dropless")
    grouped = {f.rid: f.tokens for f in fin_d}
    eng_c = Engine(cfg_d, packed16, **MIXTRAL_KW, prefill_chunk=256)
    waves, steps_c = counting_waves(eng_c), counting_steps(eng_c)
    fin_c, launches_c, wall_c = counted(kernels, lambda: eng_c.serve(reqs()))
    print(f"{cfg_d.name} dropless (capacity factor {cfg_d.moe.capacity_factor}): grouped serve "
          f"{wall_d:.3f} s, {n_new / wall_d:.2f} tokens/s; chunked serve (prefill_chunk 256) "
          f"{wall_c:.3f} s, {n_new / wall_c:.2f} tokens/s ({wall_d / wall_c:.3f} x the dropless "
          f"grouped serve's rate), {len(waves)} chunk waves, {len(steps_c)} decode steps, "
          f"launches {launches_c}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check_requests(fin_c, cfg_d, eng_c, f"{label} chunked")
    check(launches_c[fp.CHUNK_RING_KERNEL.symbol] == L16 * len(waves)
          and launches_c[fp.WINDOW_KERNEL.symbol] == 0
          and launches_c[fd.RING_KERNEL.symbol] == L16 * len(steps_c)
          and launches_c[kl.KERNEL.symbol] == L16 * (len(steps_c) + len(waves)),
          f"{label} chunked: not {L16} ring chunk and router launches per wave and {L16} ring "
          f"decodes and router launches per step: {launches_c}")
    same = [bool((grouped[f.rid] == f.tokens).all()) for f in sorted(fin_c, key=lambda f: f.rid)]
    print(f"{cfg_d.name} dropless: chunked against grouped admission, tokens equal on "
          f"{sum(same)}/{len(same)} requests")
    check(all(same), f"{label}: chunked and grouped admission differ: {same}")
    t0 = time.perf_counter()
    launches_s = mixtral_speculative(torch, cfg_d, packed16, reqs, grouped, kernels, smi)
    print(f"[{cfg_d.name} speculative: {time.perf_counter() - t0:.2f} s]")
    del eng_d, eng_c, packed16

    # the depth cut to 2 layers (the run's time; the weights are the first
    # two layers'): the published run against its plain run, and dropless,
    # each request served alone against the batched serve
    packed2 = dict(packed, moe_blocks=packed["moe_blocks"][:2])
    cfg2 = dataclasses.replace(cfg, name="mixtral-8x22b-l2", n_layers=2)
    cfg2_plain = dataclasses.replace(cfg2, bitnet=dataclasses.replace(cfg2.bitnet, impl="plain"))
    fin2 = Engine(cfg2, packed2, **MIXTRAL_KW).serve(reqs())
    t0 = time.perf_counter()
    fin2_p = Engine(cfg2_plain, packed2, **MIXTRAL_KW).serve(reqs())
    torch.cuda.synchronize()
    want = {f.rid: f.tokens for f in fin2_p}
    same = [bool((want[f.rid] == f.tokens).all()) for f in fin2]
    print(f"{cfg2.name} (capacity factor {cfg2.moe.capacity_factor}): kernel run against its "
          f"plain run ({time.perf_counter() - t0:.2f} s): tokens equal on {sum(same)}/"
          f"{len(same)} requests")
    check(all(same), f"{cfg2.name}: the kernel run differs from the plain run: {same}")
    eng2 = Engine(dataclasses.replace(cfg_d, name="mixtral-8x22b-l2", n_layers=2), packed2,
                  **MIXTRAL_KW)
    batched = {f.rid: f.tokens for f in eng2.serve(reqs())}
    t0 = time.perf_counter()
    same = [bool((batched[r.rid] == eng2.serve([r])[0].tokens).all()) for r in reqs()]
    print(f"{cfg2.name} dropless: each request served alone ({time.perf_counter() - t0:.2f} s): "
          f"tokens equal to the batched serve on {sum(same)}/{len(same)}")
    check(all(same), f"{cfg2.name}: a request served alone differs from the batched serve: "
                     f"{same}")
    # fp8 tiers at the depth cut: grouped and chunked admission, each kernel
    # run against its plain run (the same batching, the published capacity)
    cfg2_8 = dataclasses.replace(cfg2, bitnet=dataclasses.replace(cfg2.bitnet, kv_fp8=True))
    plain2_8 = dataclasses.replace(cfg2_8, bitnet=dataclasses.replace(cfg2_8.bitnet, impl="plain"))
    for chunk in (0, 256):
        eng_8 = Engine(cfg2_8, packed2, **MIXTRAL_KW, prefill_chunk=chunk)
        waves8 = counting_waves(eng_8)
        fin_8, launches_8, _ = counted(kernels8, lambda: eng_8.serve(reqs()))
        want = {f.rid: f.tokens for f in Engine(plain2_8, packed2, **MIXTRAL_KW,
                                                prefill_chunk=chunk).serve(reqs())}
        same = [bool((want[f.rid] == f.tokens).all()) for f in fin_8]
        how = f"chunked (prefill_chunk {chunk})" if chunk else "grouped"
        print(f"{cfg2.name} fp8 {how}: kernel run against its plain run: tokens equal on "
              f"{sum(same)}/{len(same)} requests; launches {launches_8}")
        check(all(same), f"{cfg2.name} fp8 {how}: the kernel run differs from the plain run")
        check_requests(fin_8, cfg2_8, eng_8, f"{cfg2.name} fp8 {how}")
        if chunk:
            launches8_c = launches_8
            check(launches_8[fp.FP8_CHUNK_RING_KERNEL.symbol] == 2 * len(waves8)
                  and launches_8[fp.CHUNK_RING_KERNEL.symbol] == 0
                  and launches_8[fp.FP8_WINDOW_KERNEL.symbol] == 0,
                  f"{cfg2.name} fp8 chunked: not 2 fp8 ring chunks per wave: {launches_8}")
    print(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"on {smi}")
    del eng, eng2, eng_8, packed, packed2
    torch.cuda.empty_cache()
    cut = f"({L16} layers)"
    return {label: launches, f"{label} chunked {cut}": launches_c, f"{label} fp8": launches8,
            f"{label} fp8 chunked (2 layers)": launches8_c,
            f"{label} speculative {cut}": launches_s}, {
        label: tok_s, f"{label} dropless {cut}": n_new / wall_d,
        f"{label} chunked {cut}": n_new / wall_c, f"{label} fp8": n_new / wall8}


def decode_glue_per_step(torch, cfg, kw, theta):
    """Device time and launches per falcon3-1b decode step of the fused
    GQA decode wrapper's own work around its kernel (kernels/flash_decode.py
    ``_launch``: the int32 casts, the rope_cos_sin table, contiguous copies
    of q and k_new), beside the kernel's, profiled alone: one call per
    layer on operands laid out as the serving step gives them (q and k_new
    views into the fused qkv projection's output, v_new the v adapter's own
    tensor, a bool active mask), every slot at length 80."""
    from repro_torch.kernels import flash_decode as fd

    b, h, g, d, iters = kw["slots"], cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, 10
    q, cache, _, _ = decode_case(torch, torch.Generator(device="cuda").manual_seed(2), [80] * b,
                                 torch.float32, b=b, h=h, g=g, d=d, hot=kw["hot_cap"],
                                 cold=kw["max_len"] - kw["hot_cap"])
    y = torch.randn((b, (h + 2 * g) * d), device="cuda")
    qv = y[:, : h * d].reshape(b, 1, h, d)[:, 0]
    kv = y[:, h * d: (h + g) * d].reshape(b, 1, g, d)[:, 0]
    vv = (y[:, (h + g) * d:] + 1.0).reshape(b, 1, g, d)[:, 0]
    act = torch.ones(b, dtype=torch.bool, device="cuda")

    def step():
        for _ in range(cfg.n_layers):
            fd.flash_decode_attention(qv, cache, k_new=kv, v_new=vv, active=act, rope_theta=theta)

    events = profiled_kernels(step, iters)
    if events is None:
        print("GQA decode glue: device time not measured (no complete trace)")
        return
    glue = [e for e in events if GQA_DECODE not in e.key]
    kern = [e for e in events if GQA_DECODE in e.key]
    per = {name: (sum(_device_us(e) for e in sel) / iters / 1e3,
                  sum(e.count for e in sel) // iters) for name, sel in (("glue", glue),
                                                                         ("kernel", kern))}
    print(f"decode_glue_per_step (falcon3-1b, {cfg.n_layers} layers, b {b}, length 80): fused "
          f"decode wrapper glue {per['glue'][0]:.4f} ms device time in {per['glue'][1]} launches; "
          f"its kernel {per['kernel'][0]:.4f} ms in {per['kernel'][1]} launches")


def latent_glue_per_step(torch, cfg, kw):
    """Device time and launches per decode step of the glue that
    fake-quantizes the latent cache copy before each latent decode launch
    (``models/attention.py`` ``_fake_quant_latent`` on the hot and the cold
    tier, once per layer), profiled alone at the serving cache's shapes."""
    from repro_torch.models import attention as attn

    m, bits, iters = cfg.mla, cfg.bitnet.act_bits, 10
    width = m.kv_lora_rank + m.qk_rope_head_dim
    tiers = [torch.randn((kw["slots"], cap, width), device="cuda")
             for cap in (kw["hot_cap"], kw["max_len"] - kw["hot_cap"])]

    def step():
        for _ in range(cfg.n_layers):
            for t in tiers:
                attn._fake_quant_latent(t, m.kv_lora_rank, bits)

    events = profiled_kernels(step, iters)
    if events is None:
        print("latent fake-quant glue: device time not measured (no complete trace)")
        return
    ms = sum(_device_us(e) for e in events) / iters / 1e3
    launches = sum(e.count for e in events) // iters
    print(f"latent fake-quant glue per deepseek-v3-671b-l5 decode step ({cfg.n_layers} layers, "
          f"tiers {kw['hot_cap']} + {kw['max_len'] - kw['hot_cap']} rows): {ms:.4f} ms device "
          f"time in {launches} launches")


def pack243_run(torch, cfg, prompts, kw, kernels, want):
    """deepseek-v3-671b-l5 packed in pack243 from the same seed (the same
    trits and scales, 5 to a byte) and served again: its wo (K = 16384) and
    dense down (K = 18432) are past the first kernel's pack243 cap. Greedy
    tokens equal to the pack2 kernel run's (``want``) on 6/6 rows, ledgers
    at the closed form, no weight reloaded, every kernel of the path
    launched."""
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params
    from repro_torch.serving.engine import Engine

    label = f"{cfg.name} pack243"
    cfg = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, codec="pack243"))
    t0 = time.perf_counter()
    packed = pack_params(T.init_params(cfg, seed=0, device="cuda"), cfg)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    codecs = {leaf.codec for leaf in packed_leaves(packed)}
    check(codecs == {"pack243"}, f"{label}: packed leaves in {codecs}")
    print(f"{label}: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    eng = Engine(cfg, packed, **kw)
    eng.generate(prompts[:, :8], max_new_tokens=2)  # warm-up
    res, launches, wall = counted(kernels, lambda: eng.generate(prompts, max_new_tokens=32))
    print(f"{label} generate 6 x (32 + 32): {wall:.3f} s, {6 * 32 / wall:.1f} tokens/s, "
          f"launches {launches}")
    check(all(n > 0 for n in launches.values()), f"{label}: a kernel never launched: {launches}")
    check_served(res, cfg, eng, 64, label)
    same = int((res.tokens.numpy() == want).all(axis=1).sum())
    check(same == 6, f"{label}: greedy tokens differ from the pack2 run ({same}/6 rows equal)")
    print(f"{label}: greedy tokens equal to the pack2 kernel run (6/6 rows)")
    del eng, packed
    torch.cuda.empty_cache()
    return launches, 6 * 32 / wall


def breakdown(torch, eng, prompts, label="falcon3-1b", new=16, before=None, patches=None):
    """Where a generate's time goes: device busy share, the kernels that
    take the most device time and the ternary matmul kernels' sum (beside
    ``before``, an earlier run's figure, when given), from a torch.profiler
    trace of one 6 x (prompt + new) generate (admission plus ``new``
    decode steps; a vision model's ``patches`` ahead of each prompt)."""
    timing = {}

    def run():
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=new, patches=patches)
        torch.cuda.synchronize()
        timing["wall"] = (time.perf_counter() - t0) * 1e3

    events = sorted(trace_events(run), key=_device_us, reverse=True)
    wall = timing["wall"]
    busy = sum(_device_us(e) for e in events) / 1e3
    if busy <= 0:
        print("breakdown: device time not measured (the trace holds none)")
        return
    rows = f"{prompts.shape[1]}" if patches is None else f"{patches.shape[1]} + {prompts.shape[1]}"
    print(f"breakdown of one {label} 6 x ({rows} + {new}) generate: wall {wall:.2f} "
          f"ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    for e in events[:8]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")
    tern = [e for e in events if TERNARY in e.key]
    print(f"  ternary matmul kernels: {sum(_device_us(e) for e in tern) / 1e3:.3f} ms device time "
          f"in {sum(e.count for e in tern)} launches per generate"
          + (f" (the first ternary kernel: {before})" if before else ""))
    for label, key in (("GQA decode kernel", GQA_DECODE),
                       ("flash prefill kernels", "prefill_kernel"),
                       ("chunked prefill kernel", "chunk_kernel"),
                       ("latent decode kernel", "latent_kernel")):
        sel = [e for e in events if key in e.key]
        if sel:
            sel_ms = sum(_device_us(e) for e in sel) / 1e3
            print(f"  {label}: {sel_ms:.3f} ms device time in {sum(e.count for e in sel)} "
                  f"launches per generate ({100 * sel_ms / busy:.2f} % of device busy)")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_decode, flash_prefill, ternary_matmul
    from repro_torch.kernels import lora as kl
    from repro_torch.kernels import rms_norm as krms

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s; each source's nvcc: "
          + ", ".join(f"{n} {t:.1f} s" for n, t in sorted(build.BUILD_SECONDS.items(),
                                                           key=lambda kv: -kv[1])))
    for name in build.KERNEL_SOURCES:
        if build.log_path(name).exists():
            for line in build.log_path(name).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    theta = get_config("falcon3-1b").rope_theta
    swa_theta = get_config("mixtral-8x22b").rope_theta
    gen = torch.Generator(device="cuda").manual_seed(0)
    tm, fd, fp = ternary_matmul, flash_decode, flash_prefill
    # (label, phase, its kernel, the path whose run gives its launches)
    phases = [("kernel 1", lambda: kernel1_phase(torch, gen), tm.KERNEL, "falcon3-1b"),
              ("kernel 2", lambda: kernel2_phase(torch, gen, theta, smi), fd.KERNEL, "falcon3-1b"),
              ("kernel 2 d 112 form", lambda: kernel2_d112_phase(
                  torch, gen, get_config("zamba2-7b").rope_theta, smi), fd.KERNEL, "zamba2-7b"),
              ("kernel 3", lambda: kernel3_phase(torch, gen, theta), fp.KERNEL, "falcon3-1b"),
              ("kernel 3 chunked form", lambda: kernel3_chunk_phase(torch, gen, theta, smi),
               fp.CHUNK_KERNEL, "falcon3-1b chunked"),
              ("kernel 1 expert form", lambda: kernel1_expert_phase(torch, gen),
               tm.EXPERT_KERNEL, "deepseek-v3-671b-l5"),
              ("kernel 3 MLA form", lambda: kernel3_mla_phase(
                  torch, gen, get_config("deepseek-v3-671b").rope_theta), fp.MLA_KERNEL,
               "deepseek-v3-671b-l5"),
              ("kernel 8", lambda: kernel8_phase(torch, gen, smi), fd.LATENT_KERNEL,
               "deepseek-v3-671b-l5"),
              ("kernel 4", lambda: kernel4_phase(torch, gen), tm.KNOWN_KERNEL,
               "falcon3-1b carried-scale"),
              ("kernel 5", lambda: kernel5_phase(torch, gen), tm.INT32_KERNEL,
               "falcon3-1b entry points"),
              ("kernel 6", lambda: kernel6_phase(torch, gen, theta, smi), fd.GQA_KERNEL,
               "falcon3-1b entry points"),
              ("kernel 7", lambda: kernel7_phase(torch, gen), tm.KNOWN_EXPERT_KERNEL,
               "deepseek-v3-671b-l5 carried-scale"),
              ("LoRA kernel", lambda: lora_phase(torch, gen, smi), kl.KERNEL, "falcon3-1b"),
              ("rms_norm kernel", lambda: rms_norm_phase(torch, gen, smi), krms.KERNEL,
               "falcon3-1b"),
              ("kernel 2 paged form", lambda: paged_decode_phase(torch, gen, theta, smi, True),
               fd.PAGED_KERNEL, "falcon3-1b paged"),
              ("kernel 6 paged form", lambda: paged_decode_phase(torch, gen, theta, smi, False),
               fd.GQA_PAGED_KERNEL, "falcon3-1b entry points"),
              ("kernel 3 paged chunked form", lambda: paged_chunk_phase(torch, gen, theta, smi),
               fp.CHUNK_PAGED_KERNEL, "falcon3-1b paged"),
              ("kernel 2 ring form", lambda: ring_decode_phase(torch, gen, swa_theta, smi),
               fd.RING_KERNEL, "mixtral-8x22b"),
              ("kernel 3 window form", lambda: window_prefill_phase(torch, gen, swa_theta, smi),
               fp.WINDOW_KERNEL, "mixtral-8x22b"),
              ("kernel 3 ring chunked form", lambda: ring_chunk_phase(torch, gen, swa_theta, smi),
               fp.CHUNK_RING_KERNEL, f"mixtral-8x22b chunked ({MIXTRAL_CUT} layers)")]
    # the fp8-tier forms (A1c, A3d, A4a): (label, form, theta, kernel, path)
    fp8_decode = [("kernel 2 fp8 form", "fused", theta, fd.FP8_KERNEL, "falcon3-1b fp8"),
                  ("kernel 6 fp8 form", "post", theta, fd.FP8_GQA_KERNEL,
                   "falcon3-1b fp8 entry points"),
                  ("kernel 2 fp8 paged form", "fused paged", theta, fd.FP8_PAGED_KERNEL,
                   "falcon3-1b fp8 paged"),
                  ("kernel 6 fp8 paged form", "post paged", theta, fd.FP8_GQA_PAGED_KERNEL,
                   "falcon3-1b fp8 entry points"),
                  ("kernel 2 fp8 ring form", "ring", swa_theta, fd.FP8_RING_KERNEL,
                   "mixtral-8x22b fp8")]
    fp8_prefill = [("kernel 3 fp8 form", "fresh", fp.FP8_KERNEL, "falcon3-1b fp8"),
                   ("kernel 3 fp8 chunked form", "chunk", fp.FP8_CHUNK_KERNEL,
                    "falcon3-1b fp8 chunked"),
                   ("kernel 3 fp8 paged chunked form", "paged", fp.FP8_CHUNK_PAGED_KERNEL,
                    "falcon3-1b fp8 paged"),
                   ("kernel 3 fp8 window form", "window", fp.FP8_WINDOW_KERNEL,
                    "mixtral-8x22b fp8"),
                   ("kernel 3 fp8 ring chunked form", "ring", fp.FP8_CHUNK_RING_KERNEL,
                    "mixtral-8x22b fp8 chunked (2 layers)")]
    phases += [(label, lambda f=form, t=th: fp8_decode_phase(torch, gen, t, smi, f), kern, path)
               for label, form, th, kern, path in fp8_decode]
    phases += [(label, lambda f=form: fp8_prefill_phase(torch, gen, theta, swa_theta, smi, f),
                kern, path) for label, form, kern, path in fp8_prefill]
    phases.append(("kernel 8 fp8 form", lambda: fp8_latent_phase(torch, gen, smi),
                   fd.LATENT_FP8_KERNEL, "deepseek-v3-671b-l5 fp8"))
    rows = []
    t_kernels, before = time.perf_counter(), dict(TRACE_SECONDS)
    for label, fn, _, _ in phases:
        t0 = time.perf_counter()
        rows.append(fn())
        print(f"[{label} phase: {time.perf_counter() - t0:.2f} s]")
    print(f"kernel phases: {time.perf_counter() - t_kernels:.2f} s, of which profiler traces "
          f"{trace_line(before)}")
    t0 = time.perf_counter()
    decode_prefill_phase(torch, gen, theta)
    print(f"[decode = prefill phase: {time.perf_counter() - t0:.2f} s]")
    t0 = time.perf_counter()
    spec_kernel_phase(torch, gen, theta, smi)
    print(f"[speculative kernel forms phase: {time.perf_counter() - t0:.2f} s]")
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    paths, tok_s = slice_phase(torch, gen, smi)
    print(f"[falcon3-1b phase: {time.perf_counter() - t0:.2f} s]")
    print(f"falcon3-1b phase's profiler traces: {trace_line(before)}")
    gc.collect()  # engines whose methods a phase wrapped hold their weights in a cycle
    torch.cuda.empty_cache()
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    ds_paths, ds_tok_s = deepseek_phase(torch)
    print(f"[deepseek-v3-671b-l5 phase: {time.perf_counter() - t0:.2f} s]")
    print(f"deepseek-v3-671b-l5 phase's profiler traces: {trace_line(before)}")
    paths.update(ds_paths)
    tok_s.update(ds_tok_s)
    gc.collect()
    torch.cuda.empty_cache()
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    dense_paths, dense_tok_s = dense_families_phase(torch, smi)
    print(f"[dense families phase: {time.perf_counter() - t0:.2f} s]")
    print(f"dense families phase's profiler traces: {trace_line(before)}")
    paths.update(dense_paths)
    tok_s.update(dense_tok_s)
    gc.collect()
    torch.cuda.empty_cache()
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    ssm_paths, ssm_tok_s = ssm_families_phase(torch, smi)
    print(f"[ssm families phase: {time.perf_counter() - t0:.2f} s]")
    print(f"ssm families phase's profiler traces: {trace_line(before)}")
    paths.update(ssm_paths)
    tok_s.update(ssm_tok_s)
    gc.collect()
    torch.cuda.empty_cache()
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    fe_paths, fe_tok_s = frontend_families_phase(torch, smi)
    print(f"[frontend families phase: {time.perf_counter() - t0:.2f} s]")
    print(f"frontend families phase's profiler traces: {trace_line(before)}")
    paths.update(fe_paths)
    tok_s.update(fe_tok_s)
    gc.collect()
    torch.cuda.empty_cache()
    t0, before = time.perf_counter(), dict(TRACE_SECONDS)
    mx_paths, mx_tok_s = mixtral_phase(torch, smi)
    print(f"[mixtral-8x22b phase: {time.perf_counter() - t0:.2f} s]")
    print(f"mixtral-8x22b phase's profiler traces: {trace_line(before)}")
    paths.update(mx_paths)
    tok_s.update(mx_tok_s)
    for row, (_, _, kern, main_path) in zip(rows, phases):
        row["launches"] = paths[main_path][kern.symbol]
        row["launches_by_path"] = {p: d[kern.symbol] for p, d in paths.items()
                                   if kern.symbol in d}
    print("tokens/s " + ", ".join(f"{p} {t:.2f}" for p, t in tok_s.items()) + f" on {smi}")
    print(f"profiler traces in all: {trace_line(dict.fromkeys(TRACE_SECONDS, 0.0))}")
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s on a host whose falcon3-1b "
          f"generate ran {tok_s['falcon3-1b']:.1f} tokens/s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
