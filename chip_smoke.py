#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

1. Prints the card's name and power limit, builds the three CUDA kernels
   from src/repro_torch/csrc and prints the build time.
2. Kernel phase: holds each kernel against its plain PyTorch version on the
   card at the shapes falcon3-1b's serving path gives it, and times both
   (plus a PyTorch library call of the same work as a yardstick).
3. Slice phase: builds falcon3-1b at full width and depth from a seeded
   generator (LoRA B factors filled with small seeded values), packs it,
   and serves 6 prompts x 32 tokens with max_new_tokens=96 through
   Engine.generate (hot_cap=32, max_len=128, 6 slots). Checks that every
   kernel launched, no weight was reloaded, each sequence's DR-traffic
   ledger equals the closed form for S=128 / 32 hot tokens, and the greedy
   tokens, prefill logits and first-step logits equal those of the same
   run on the plain versions.
4. Prints {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero. Run from the
repository root with no arguments: python3 chip_smoke.py
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s,
# f32 FLOP/s outside the tensor cores.
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12
TOL = dict(rtol=1e-5, atol=1e-5)  # f32 attention vs its plain version
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)  # bf16 tiers: one bf16 ulp of the output
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # whole-model logits, kernel vs plain run


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


def device_ms(fn, iters=20, only=None):
    """Device time per call from a torch.profiler trace: the summed
    durations of the kernels ``fn`` launches (only those whose name
    contains ``only``, when given). None when the trace holds no device
    time; the callers then keep the CUDA-event time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(e) for e in prof.key_averages() if only is None or only in e.key)
    return total / iters / 1e3 if total > 0 else None


def _device_us(event):
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else getattr(event, "self_cuda_time_total", 0.0)


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


def kernel1_phase(torch, gen):
    from repro_torch.core import packing
    from repro_torch.kernels import ternary_matmul as tm

    def operands(m, k, n, codec, dtype, copies=1):
        trits = torch.randint(-1, 2, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        packed = [packing.pack(trits, codec)]
        for _ in range(copies - 1):
            packed.append(packed[0].clone())
        x = (torch.randn((m, k), generator=gen, device="cuda") * 3).to(dtype)
        col = torch.rand((n,), generator=gen, device="cuda") + 0.01
        return x, packed, col

    worst = 0.0
    for codec in ("pack2", "pack243"):
        for dtype in (torch.float32, torch.bfloat16):
            for m in (6, 192):
                for k, n in DECODE_SHAPES:
                    for bits in ((8, 4) if (m, k, n) == (6, 2048, 4096) else (8,)):
                        x, (p,), col = operands(m, k, n, codec, dtype)
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
    layer = [operands(6, k, n, "pack2", torch.float32, copies=8) for k, n in DECODE_SHAPES]
    it = {"i": 0}

    def run(fn):
        def go():
            i = it["i"] = (it["i"] + 1) % 8
            for (k, n), (x, ps, col) in zip(DECODE_SHAPES, layer):
                fn(x, ps[i], col, k)
        return go

    ms, _ = timed("kernel", run(lambda x, p, col, k: tm.ternary_matmul_actq(x, p, col, k=k)),
                  only="actq_kernel")
    plain_ms, _ = timed("plain", run(lambda x, p, col, k: tm.ternary_matmul_actq_plain(
        x, p, col, k)), iters=5)
    dense = [((x.to(torch.bfloat16)), [torch.randn((k, n), generator=gen, device="cuda",
                                                  dtype=torch.bfloat16) for _ in range(2)])
             for (k, n), (x, _, _) in zip(DECODE_SHAPES, layer)]
    lib_it = {"i": 0}

    def lib():
        i = lib_it["i"] = 1 - lib_it["i"]
        for xb, ws in dense:
            torch.matmul(xb, ws[i])

    library_ms, _ = timed("bf16 torch.matmul", lib)
    n_bytes = sum(6 * k * 4 + (k // 4) * n + n * 4 + 6 * n * 4 for k, n in DECODE_SHAPES)
    ops = sum(2 * 6 * k * n for k, n in DECODE_SHAPES)
    b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS)
    print(f"ternary_matmul_actq decode layer (4 launches, M=6, pack2, f32 x): kernel {ms:.5f} ms, "
          f"plain {plain_ms:.5f} ms, bf16 matmul {library_ms:.5f} ms, bound {b_ms:.5f} ms "
          f"({n_bytes} B / 3.35 TB/s)")
    # prefill shapes for PERF.md: M = 192 (6 prompts x 32 tokens)
    for k, n in DECODE_SHAPES:
        x, (p,), col = operands(192, k, n, "pack2", torch.float32)
        t = device_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k), only="actq_kernel")
        t = time_ms(lambda: tm.ternary_matmul_actq(x, p, col, k=k)) if t is None else t
        print(f"ternary_matmul_actq prefill M=192 K={k} N={n}: kernel {t:.5f} ms, "
              f"bound {bound_ms(192 * k * 4 + k // 4 * n + n * 4 + 192 * n * 4, 2 * 192 * k * n, INT8_OPS)[0]:.5f} ms")
    return dict(name="ternary_matmul_actq", route="cuda",
                source="src/repro_torch/csrc/ternary_matmul_actq.cu",
                replaces="src/repro/kernels/ternary_matmul.py:381", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# kernel 2: fused-RoPE flash decode
# ---------------------------------------------------------------------------


def decode_case(torch, gen, lengths, dtype, b=6, h=8, g=4, d=256, hot=32, cold=96):
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
        torch.where(hot_valid[:, :, None, None], cache.hot_k, nan).to(dtype),
        torch.where(hot_valid[:, :, None, None], cache.hot_v, nan).to(dtype),
        torch.where(cold_valid[:, :, None, None], cache.cold_k, nan).to(dtype),
        torch.where(cold_valid[:, :, None, None], cache.cold_v, nan).to(dtype),
        cache.lengths)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    k_new = torch.randn((b, g, d), generator=gen, device="cuda").to(dtype)
    v_new = torch.randn((b, g, d), generator=gen, device="cuda").to(dtype)
    return q, cache, k_new, v_new


def kernel2_phase(torch, gen, theta):
    from repro_torch.kernels import flash_decode as fd

    worst, bitwise = 0.0, True
    lengths = [0, 1, 31, 32, 33, 127]
    active = torch.tensor([False, True, True, True, True, True], device="cuda")
    for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, TOL_BF16)):
        q, cache, k_new, v_new = decode_case(torch, gen, lengths, dtype)
        o, k_rot = fd.flash_decode_attention(q, cache, k_new=k_new, v_new=v_new, active=active,
                                             rope_theta=theta)
        o_p, k_rot_p = fd.flash_decode_attention(q, cache, k_new=k_new, v_new=v_new,
                                                 active=active, rope_theta=theta, impl="plain")
        torch.cuda.synchronize()
        check(torch.isfinite(o).all(), "flash_decode output not finite (read a masked row?)")
        check(torch.equal(k_rot, k_rot_p), f"flash_decode k_rot not bit-identical ({dtype})")
        check(torch.equal(o[0], torch.zeros_like(o[0])), "length-0 inactive slot not zero")
        check(torch.allclose(o.float(), o_p.float(), **tol),
              f"flash_decode output off its plain version ({dtype}): {max_err(o, o_p)}")
        worst = max(worst, max_err(o, o_p)) if dtype == torch.float32 else worst
        bitwise &= bool(torch.equal(o, o_p))
    print(f"flash_decode: within tolerance of plain (f32 {TOL}, bf16 {TOL_BF16}); "
          f"k_rot bit-identical; bit-identical output: {bitwise}")

    # timing at the main path's middle state: every slot at length 80, active
    length = 80
    q, cache, k_new, v_new = decode_case(torch, gen, [length] * 6, torch.float32)
    act = torch.ones(6, dtype=torch.bool, device="cuda")
    ms, _ = timed("kernel", lambda: fd.flash_decode_attention(
        q, cache, k_new=k_new, v_new=v_new, active=act, rope_theta=theta), only="decode_kernel")
    plain_ms, _ = timed("plain", lambda: fd.flash_decode_attention(
        q, cache, k_new=k_new, v_new=v_new, active=act, rope_theta=theta, impl="plain"))
    kk = torch.cat([cache.hot_k, cache.cold_k[:, : length - 32], k_new[:, None]], 1)
    vv = torch.cat([cache.hot_v, cache.cold_v[:, : length - 32], v_new[:, None]], 1)
    kh = kk.permute(0, 2, 1, 3).repeat_interleave(2, dim=1).contiguous()
    vh = vv.permute(0, 2, 1, 3).repeat_interleave(2, dim=1).contiguous()
    qh = q[:, :, None]
    library_ms, _ = timed("SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh))
    b, h, g, d = 6, 8, 4, 256
    n_bytes = (b * h * d * 4 + b * length * g * d * 4 * 2 + 2 * b * g * d * 4 + 8 * b
               + b * d * 4 + b * h * d * 4 + b * g * d * 4)
    ops = 4 * b * h * (length + 1) * d
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"flash_decode (b=6, length 80, f32): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms ({n_bytes} B / 3.35 TB/s)")
    return dict(name="flash_decode_gqa_fused", route="cuda",
                source="src/repro_torch/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:481", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


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

    worst, bitwise = 0.0, True
    for s, dtype, tol in ((32, torch.float32, TOL), (128, torch.float32, TOL),
                          (77, torch.float32, TOL), (32, torch.bfloat16, TOL_BF16)):
        q, k, v = case(s, dtype)
        valid = torch.tensor([s, s - 5, 0, s, 1, s], dtype=torch.int32, device="cuda")
        got = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=theta)
        ref = fp.flash_prefill_attention(q, k, v, valid=valid, rope_theta=theta, impl="plain")
        torch.cuda.synchronize()
        check(torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2]),
              f"flash_prefill k_cast/v_cast not bit-identical (s={s}, {dtype})")
        check(torch.allclose(got[0].float(), ref[0].float(), **tol),
              f"flash_prefill output off its plain version (s={s}, {dtype}): "
              f"{max_err(got[0], ref[0])}")
        if dtype == torch.float32:
            worst = max(worst, max_err(got[0], ref[0]))
        bitwise &= bool(torch.equal(got[0], ref[0]))
    print(f"flash_prefill: within tolerance of plain at s=32/128/77 (f32) and 32 (bf16); "
          f"k_cast/v_cast bit-identical; bit-identical output: {bitwise}")

    s, b, h, g, d = 32, 6, 8, 4, 256
    q, k, v = case(s, torch.float32)
    ms, _ = timed("kernel", lambda: fp.flash_prefill_attention(q, k, v, rope_theta=theta),
                  only="prefill_kernel")
    plain_ms, _ = timed("plain", lambda: fp.flash_prefill_attention(
        q, k, v, rope_theta=theta, impl="plain"))
    qh = q.permute(0, 2, 1, 3).contiguous()
    kh = k.permute(0, 2, 1, 3).repeat_interleave(2, dim=1).contiguous()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(2, dim=1).contiguous()
    library_ms, _ = timed("SDPA", lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    n_bytes = 4 * (2 * b * s * h * d + 4 * b * s * g * d) + 4 * b
    ops = 4 * b * h * d * s * (s + 1) // 2
    b_ms, b_by = bound_ms(n_bytes, ops, F32_FLOPS)
    print(f"flash_prefill (b=6, s=32, f32): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"SDPA {library_ms:.5f} ms, bound {b_ms:.6f} ms ({n_bytes} B / 3.35 TB/s)")
    q, k, v = case(128, torch.float32)
    t = device_ms(lambda: fp.flash_prefill_attention(q, k, v, rope_theta=theta),
                  only="prefill_kernel")
    print(f"flash_prefill (b=6, s=128, f32): kernel device time "
          f"{'not measured' if t is None else f'{t:.5f} ms'}")
    return dict(name="flash_prefill_fresh", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill.py:258", max_abs_err=worst,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


# ---------------------------------------------------------------------------
# slice phase: falcon3-1b served end to end
# ---------------------------------------------------------------------------


def slice_phase(torch, kernels):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import dr_edram
    from repro_torch.models import transformer as T
    from repro_torch.models.pack import pack_params
    from repro_torch.serving.engine import Engine

    cfg = get_config("falcon3-1b")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for blk in params["blocks"]:
        for leaf in (blk["attn"]["lora_v"], blk["attn"]["lora_o"], blk["mlp"]["lora_down"]):
            leaf["b"].normal_(0.0, 0.02, generator=gen)  # zero at init: exercise the adapters
    packed = pack_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"falcon3-1b: init + pack {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (6, 32)).astype(np.int32)
    kw = dict(hot_cap=32, max_len=128, slots=6)

    eng = Engine(cfg, packed, **kw)
    eng.generate(prompts[:, :8], max_new_tokens=4)  # warm-up (cuBLAS, allocator)
    for kern in kernels:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=96)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.symbol: kern.launches for kern in kernels}
    tokens = res.tokens.numpy()
    print(f"falcon3-1b generate 6 x (32 + 96): {wall:.3f} s, {6 * 96 / wall:.1f} tokens/s, "
          f"launches {launches}")
    check(tokens.shape == (6, 96) and ((tokens >= 0) & (tokens < cfg.vocab_size)).all(),
          "generated tokens out of range or short")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check(eng.weight_loads == 0, "weights were reloaded")
    closed = dr_edram.closed_form_reduction(128, 32)
    for f in res.finished:
        check(f.seq_len == 128, f"row {f.rid} seq_len {f.seq_len}")
        check(abs(f.external_reduction - closed) <= 1e-12,
              f"row {f.rid} external_reduction {f.external_reduction} != {closed}")
    print(f"DR ledger: every row external_reduction = {res.finished[0].external_reduction!r} "
          f"(closed form {closed!r}), weight_loads = {eng.weight_loads}")

    cfg_plain = dataclasses.replace(cfg, bitnet=dataclasses.replace(cfg.bitnet, impl="plain"))
    t0 = time.perf_counter()
    res_p = Engine(cfg_plain, packed, **kw).generate(prompts, max_new_tokens=96)
    torch.cuda.synchronize()
    print(f"plain run: {time.perf_counter() - t0:.2f} s")
    same = int((res_p.tokens.numpy() == tokens).all(axis=1).sum())
    check(np.array_equal(res_p.tokens.numpy(), tokens),
          f"greedy tokens differ from the plain run ({same}/6 rows equal)")

    toks = torch.as_tensor(prompts, device="cuda")
    with torch.inference_mode():
        lg, cache = T.prefill(packed, cfg, toks, hot_cap=32, max_len=128)
        lg_p, cache_p = T.prefill(packed, cfg_plain, toks, hot_cap=32, max_len=128)
        first = lg.argmax(-1).to(torch.int32)
        s1, _ = T.decode_step(packed, cfg, first, cache)
        s1_p, _ = T.decode_step(packed, cfg_plain, first, cache_p)
    check(torch.allclose(lg, lg_p, **LOGIT_TOL), f"prefill logits off: {max_err(lg, lg_p)}")
    check(torch.allclose(s1, s1_p, **LOGIT_TOL), f"first-step logits off: {max_err(s1, s1_p)}")
    print(f"greedy tokens equal to the plain run (6/6 rows); prefill logits max |diff| "
          f"{max_err(lg, lg_p)}, first-step {max_err(s1, s1_p)} (tolerance {LOGIT_TOL})")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    breakdown(torch, eng, prompts)
    return launches, 6 * 96 / wall


def breakdown(torch, eng, prompts):
    """Where a generate's time goes: device busy share and the kernels
    that take the most device time, from a torch.profiler trace of one
    6 x (32 + 16) generate (prefill plus 16 decode steps)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(), key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in events) / 1e3
    if busy <= 0:
        print("breakdown: device time not measured (the trace holds none)")
        return
    print(f"breakdown of one 6 x (32 + 16) generate: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f} %), idle {100 * (1 - busy / wall):.1f} %")
    for e in events[:8]:
        print(f"  {_device_us(e) / 1e3:9.3f} ms  {e.count:6d} x  {e.key[:90]}")


def main() -> int:
    import torch

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

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in build.KERNEL_SOURCES:
        if build.log_path(name).exists():
            for line in build.log_path(name).read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    theta = get_config("falcon3-1b").rope_theta
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [kernel1_phase(torch, gen), kernel2_phase(torch, gen, theta),
            kernel3_phase(torch, gen, theta)]
    kernels = [ternary_matmul.KERNEL, flash_decode.KERNEL, flash_prefill.KERNEL]
    launches, tok_s = slice_phase(torch, kernels)
    for row, kern in zip(rows, kernels):
        row["launches"] = launches[kern.symbol]
    print(f"tokens/s {tok_s:.2f} on {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
