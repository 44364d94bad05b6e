#!/usr/bin/env python3
"""Proof on one CUDA card that the PyTorch port (``nat_tpu_torch``) runs its
paths through its hand-written kernels: serving (``FILE → NDJSON``, argmin
through K1 and ``--stochastic`` through K2) and training (through K3).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failed check exits nonzero and prints no result):

1. build the RVQ kernels (``nat_tpu_torch/csrc/rvq_argmin.cu``) with nvcc;
2. K1: hold the argmin kernel against the plain PyTorch chain at the main
   path's shapes (N=4, K=4096, D=512; M = 81, 648, 88 and a ragged 200; a
   ragged K=1000; M=17 with K=4097; D=500) and time kernel, plain version
   and a library yardstick;
3. K2: the sampling kernel against the plain chain fed the uniforms the
   kernel's own Philox draws (M = 81 and 200, τ = 0.5), seed
   reproducibility and sensitivity, τ = 1e-4 against argmin, and times;
4. K3: the training encode (K1 forward, analytic straight-through
   backward) against autograd through the plain version at M = 88 (4 × 22)
   and 81: codes, ``grad_x`` and ``grad_cb``, and forward+backward times;
5. drive the serving path: ``AudioTokenizationPipeline.stream_audio`` at
   full default width (wav2vec2-base trunk with seeded random weights,
   D=512, K=4096, 4+4 quantizers, bf16 encoders) on a 10 s and a 70 s WAV
   made from a numpy seed, then ``python -m nat_tpu_torch`` once; the same
   in stochastic mode (K2), twice from one seed;
6. device parity in float32 (TF32 off): card against CPU on the 10 s input;
7. drive the training path at full width: the Trainer with
   ``build_optimizer`` (cosine, warmup 2, clip 1.0) for 8 steps of batch 4
   on eight 6-8 s clips (bf16 encoders over the seed's float32 params,
   cuDNN settings as ``train_cli`` sets them); warm steps timed and
   profiled under each cuDNN setting of ``TRAIN_MODES``; a checkpoint that
   survives save, restore and one more step bit for bit under
   deterministic algorithms;
8. the entry points as subprocesses: ``nat_tpu_torch.train_cli`` writes a
   float32 model, ``--model-path`` serves it, ``--stochastic --seed 7``
   twice gives identical frames;
9. report times, rates and the device's busy share (torch.profiler), and
   the kernel line, each beside the card's name and power limit.

Last, it profiles one K1 call in a process of its own (so no timing sees
the profiler's after-effect), which must launch at most N + 1 = 5
kernels.  ``python3 chip_smoke.py --kernels`` runs phases 1-4,
times K1 under each row tile the kernel takes (``[plan]`` lines), profiles
one K1 call and stops without a result.

The last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX
or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SR = 22050
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
TIE_BUDGET = 0.02        # share of codes allowed to differ on near-ties
QSUM_ATOL = 1e-4         # float32 sums of <= 4 codebook rows of N(0, 1)
ERR_RTOL = 1e-4          # ‖r‖² summed in another order
GRAD_ATOL = 1e-5         # STE gradients, as a share of each one's largest
TRAIN_STEPS, TRAIN_BATCH = 8, 4


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {message}")


def card_label() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, iters: int = 20, flush=None,
              lead_cycles: int = 2_000_000) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events, after warm-up.

    Each timed call is queued behind ``torch.cuda._sleep(lead_cycles)``,
    so the host has enqueued the whole call before the card reaches the
    start event: the events then time the device work alone, not the host's
    launch overhead.  ``flush`` (a large tensor) is overwritten before each
    call so the codebook is read cold from memory, as the forward leaves it."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(lead_cycles)
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def wall_ms(torch, fn, iters: int = 20) -> float:
    """Mean host-clock time of ``fn()`` in ms, synchronized after each
    call: what a caller waiting on the result sees."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_call(torch, fn) -> list:
    """Every device activity of one ``fn()`` under torch.profiler, in
    device order: ``[(name, start_us, duration_us)]``.  The caller warms
    ``fn`` up and leaves the card idle before, so the window holds this
    call's kernels only."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    return [(name, start, end - start) for start, end, name in spans]


def k1_call_split(torch, label: str) -> int:
    """Profile one K1 call at the main path's shape (M=81, K=4096, D=512,
    N=4, codebook cold) and print each device activity, its time and the
    idle gaps between them.  Returns the number of activities."""
    from nat_tpu_torch.ops import rvq_kernel

    rng = np.random.default_rng(77)
    cb = torch.from_numpy(rng.standard_normal((4, 4096, 512)).astype(
        np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((81, 512)).astype(
        np.float32)).cuda()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        rvq_kernel.rvq_encode_cuda(cb, x)
    flush.zero_()
    spans = profile_call(torch, lambda: rvq_kernel.rvq_encode_cuda(cb, x))
    check(spans, "the profiler recorded no device activity for one K1 call")
    t0 = spans[0][1]
    busy = sum(dur for _, _, dur in spans)
    gaps = [spans[i + 1][1] - (spans[i][1] + spans[i][2])
            for i in range(len(spans) - 1)]
    total = spans[-1][1] + spans[-1][2] - t0
    print(f"[kernel] profile of one K1 call (M=81 K=4096 D=512 N=4, cold "
          f"codebook): {len(spans)} device activities, {busy:.2f} us busy, "
          f"{sum(gaps):.2f} us of gaps, {total:.2f} us first start to last "
          f"end [{label}]")
    for i, (name, start, dur) in enumerate(spans):
        gap = f", then {gaps[i]:.2f} us idle" if i < len(gaps) else ""
        print(f"[kernel]   +{start - t0:8.2f} us {dur:8.2f} us  "
              f"{name[:70]}{gap}")
    del flush
    return len(spans)


def check_one_call_launches(label: str) -> None:
    """Profile one K1 call in a process of its own, which must launch at
    most N + 1 = 5 kernels.  There the profiler session is the process's
    first (after several in one process it recorded no device activity
    for a single call on the H100), and no timing of this run sees its
    after-effect."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.one_call_profile(sys.argv[1]))", label],
        capture_output=True, text=True, cwd=str(ROOT), timeout=600,
        stdin=subprocess.DEVNULL)
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"one-call profile rc {proc.returncode}: "
          f"{proc.stderr[-2000:]}")


def one_call_profile(label: str) -> int:
    import torch

    launched = k1_call_split(torch, label)
    check(launched <= 4 + 1, f"one K1 call launched {launched} kernels, more "
          f"than N + 1 = 5")
    return 0


def write_wav(path: Path, seconds: float, seed: int) -> None:
    from nat_tpu_torch.io.audio import write_wav as _write

    rng = np.random.default_rng(seed)
    n = np.arange(int(seconds * SR)) / SR
    sweep = np.sin(2 * np.pi * (180.0 + 40.0 * np.sin(0.3 * n)) * n)
    audio = 0.4 * sweep + 0.2 * np.sin(2 * np.pi * 660.0 * n) * (n % 1.0 < 0.5)
    audio = audio + 0.05 * rng.standard_normal(n.size)
    _write(str(path), audio.astype(np.float32), SR)


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills per kernel from
    ``nvcc -Xptxas -v`` output, keyed by a readable kernel name."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        props = re.search(r"Function properties for (\S+)", line)
        if props:
            mangled = props.group(1)
            base = re.findall(r"rvq_[a-z_]*kernel", mangled)
            name = base[-1] if base else mangled
            args = re.search(r"ILb([01])EE", mangled)
            if args:
                name += "<sample>" if args.group(1) == "1" else "<argmin>"
            report[name] = {}
        elif name and "spill" in line:
            report[name]["spills"] = line.strip()
        elif name and "registers" in line:
            report[name]["usage"] = line.split(":", 1)[-1].strip()
    return report


def phase_build(label: str):
    from nat_tpu_torch.ops import cuda_build, rvq_kernel

    t0 = time.time()
    path, log = cuda_build.build(rvq_kernel.SOURCE)
    print(f"[build] {rvq_kernel.SOURCE} -> {path.relative_to(ROOT)} in "
          f"{time.time() - t0:.2f} s [{label}]")
    report = ptxas_report(log)
    for name, info in sorted(report.items()):
        print(f"[build]   {name}: {info.get('usage', '?')}; "
              f"{info.get('spills', '?')}")
    for name, info in report.items():
        check("0 bytes spill stores, 0 bytes spill loads"
              in info.get("spills", ""), f"{name} spills: {info}")


def phase_kernel(torch, label: str) -> dict:
    """Kernel against the plain chain; returns the kernel line's numbers
    for the main path's shape (M=81, K=4096)."""
    from nat_tpu_torch.ops import rvq_kernel
    from nat_tpu_torch.quant import rvq as plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(1234)
    n = 4
    result = {}
    # The main path's shape, a kernel-phase batch, a ragged M, a ragged K,
    # K3's M, a ragged M with a ragged K, and a depth that is not a
    # multiple of the 32-deep slice.
    for m, k, d in ((81, 4096, 512), (648, 4096, 512), (200, 4096, 512),
                    (81, 1000, 512), (88, 4096, 512), (17, 4097, 512),
                    (81, 4096, 500)):
        cb = torch.from_numpy(rng.standard_normal((n, k, d)).astype(
            np.float32)).cuda()
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).cuda()
        codes, err, qsum = rvq_kernel.rvq_encode_cuda(cb, x)
        ref_codes, ref_err, ref_qsum = plain.rvq_chain(cb, x)
        torch.cuda.synchronize()
        codes = codes.long()
        where = f"M={m}, K={k}, D={d}"
        check(torch.equal(codes[0], ref_codes[0]),
              f"layer-0 codes differ at {where}")
        mismatch = (codes != ref_codes).float().mean().item()
        check(mismatch <= TIE_BUDGET,
              f"{mismatch:.4f} of codes differ at {where}")
        agree = (codes == ref_codes).all(dim=0)
        qsum_err = (qsum[agree] - ref_qsum[agree]).abs().max().item()
        err_rel = ((err[:, agree] - ref_err[:, agree]).abs()
                   / ref_err[:, agree].abs().clamp_min(1.0)).max().item()
        check(qsum_err <= QSUM_ATOL, f"qsum differs by {qsum_err} ({where})")
        check(err_rel <= ERR_RTOL, f"err differs by {err_rel} relative "
              f"({where})")

        def library_chain():
            # Yardstick only (never called by the port): per layer
            # torch.cdist + argmin + index.
            r = x
            for cb_n in cb:
                idx = torch.cdist(r, cb_n).argmin(dim=1)
                r = r - cb_n[idx]
            return r

        ms = device_ms(torch, lambda: rvq_kernel.rvq_encode_cuda(cb, x),
                       flush=flush)
        call_ms = wall_ms(torch, lambda: rvq_kernel.rvq_encode_cuda(cb, x))
        plain_ms = device_ms(torch, lambda: plain.rvq_chain(cb, x),
                             flush=flush)
        library_ms = device_ms(torch, library_chain, flush=flush)
        flops = 2.0 * m * n * k * d
        nbytes = 4.0 * (m * d + n * k * d + 2 * n * m + m * d)
        bound_ms = max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES) * 1e3
        bound_by = ("operations" if flops / PEAK_FP32_FLOPS
                    >= nbytes / PEAK_HBM_BYTES else "bytes")
        plan = rvq_kernel.launch_plan(m, k, *rvq_kernel.resident_blocks(
            0, False))
        print(f"[kernel] M={m} K={k} D={d}: plan row tile {plan.row_tile} x "
              f"{plan.row_tiles}, {plan.row_tiles * plan.code_chunks} items, "
              f"{plan.grid_blocks} blocks, {plan.smem_bytes} B shared; mismatch "
              f"{mismatch:.5f}, qsum max abs "
              f"err {qsum_err:.3g}, err max rel {err_rel:.3g}; kernel "
              f"{ms:.4f} ms (device; {call_ms:.4f} ms per synchronized "
              f"call on the host clock), plain {plain_ms:.4f} ms, library chain "
              f"(cdist+argmin+index, yardstick) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}) [{label}]")
        if (m, k, d) == (81, 4096, 512):
            check_plan_independence(torch, cb, x, None, label)
            result = dict(max_abs_err=qsum_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    del flush
    return result


def check_plan_independence(torch, cb, x, temperature, label: str) -> None:
    """The same rows give the same codes, errors and sums bit for bit under
    each row tile, and as the first 17 rows of a call of their own (one
    tile of 32 where 81 rows take one of 96)."""
    from nat_tpu_torch.ops import rvq_kernel

    m, k = x.shape[0], cb.shape[1]
    sms, per_sm = rvq_kernel.resident_blocks(0, temperature is not None)
    outs = [rvq_kernel.rvq_encode_cuda(cb, x, temperature, 5,
                                       rvq_kernel.plan_with_tile(
                                           m, k, tile, sms * blocks))
            for tile, blocks in zip(rvq_kernel.ROW_TILES, per_sm)]
    head = rvq_kernel.rvq_encode_cuda(cb, x[:17].contiguous(), temperature, 5)
    tiles = (rvq_kernel.launch_plan(17, k, sms, per_sm).row_tile,
             rvq_kernel.launch_plan(m, k, sms, per_sm).row_tile)
    mode = "K1" if temperature is None else f"K2 tau={temperature}"
    check(all(torch.equal(a, b) for other in outs[1:]
              for a, b in zip(outs[0], other)),
          f"{mode}: results depend on the row tile")
    check(all(torch.equal(a, b) for a, b in zip(
        head, (outs[0][0][:, :17], outs[0][1][:, :17], outs[0][2][:17]))),
        f"{mode}: 17 rows alone differ from the same rows in a call of {m}")
    print(f"[kernel] {mode} M={m} K={k}: codes, err and qsum bit-identical "
          f"under row tiles {rvq_kernel.ROW_TILES} (blocks an SM holds: "
          f"{per_sm}) and for the first 17 rows alone (tile {tiles[0]}, "
          f"against {tiles[1]}) [{label}]")


def phase_plans(torch, label: str) -> None:
    """K1's device time at the main path's shapes under each row tile the
    kernel takes, beside ``launch_plan``'s choice: the measurement the
    plan's rule rests on."""
    from nat_tpu_torch.ops import rvq_kernel

    sms, per_sm = rvq_kernel.resident_blocks(0, False)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(99)
    n, d = 4, 512
    for m, k in ((81, 4096), (88, 4096), (648, 4096), (81, 1000)):
        cb = torch.from_numpy(rng.standard_normal((n, k, d)).astype(
            np.float32)).cuda()
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).cuda()
        best = rvq_kernel.launch_plan(m, k, sms, per_sm)
        times = []
        for tile, blocks in zip(rvq_kernel.ROW_TILES, per_sm):
            plan = rvq_kernel.plan_with_tile(m, k, tile, sms * blocks)
            ms = device_ms(torch, lambda: rvq_kernel.rvq_encode_cuda(
                cb, x, plan=plan), flush=flush)
            mark = "*" if plan == best else ""
            times.append(f"{tile}x{plan.row_tiles}{mark} {ms:.4f}")
        print(f"[plan] K1 M={m} K={k} D={d}, device ms by row tile x tiles "
              f"(* = launch_plan's): {', '.join(times)} [{label}]")
    # What a call costs whatever its depth: one 32-deep slice a layer at
    # the main path's M and K, and a single row against a single code.
    fixed = []
    for m, k, d in ((81, 4096, 32), (1, 1, 3)):
        cb = torch.from_numpy(rng.standard_normal((n, k, d)).astype(
            np.float32)).cuda()
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).cuda()
        ms = device_ms(torch, lambda: rvq_kernel.rvq_encode_cuda(cb, x),
                       flush=flush)
        fixed.append(f"M={m} K={k} D={d} {ms:.4f} ms")
    print(f"[plan] K1 with almost no depth or width (launch, init, barriers "
          f"and updates of 4 layers): {', '.join(fixed)} [{label}]")
    del flush


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    from nat_tpu_torch.ops import rvq_kernel

    rvq_kernel.launches = 0
    rvq_kernel.sample_launches = 0
    rvq_kernel.train_launches = 0


def read_counts() -> dict:
    from nat_tpu_torch.ops import rvq_kernel

    return {"K1": rvq_kernel.launches, "K2": rvq_kernel.sample_launches,
            "K3": rvq_kernel.train_launches}


def chain_bound(m: int, n: int, k: int, d: int,
                extra_ops_per_score: float = 0.0,
                extra_bytes: float = 0.0) -> tuple[float, str]:
    """Least time of one RVQ chain call: its 2·M·N·K·D fp32 FMA flops (plus
    any per-score work) at the fp32 peak, against x, the codebook, codes,
    errors and qsum read or written once at the HBM rate."""
    ops = 2.0 * m * n * k * d + extra_ops_per_score * m * n * k
    nbytes = 4.0 * (m * d + n * k * d + 2 * n * m + m * d) + extra_bytes
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# Philox4x32-10 (10 rounds of 2 multiplies, 2 high halves, 4 xors and the
# key bumps), the uniform's bit trick, the clip, two logs, the square
# root, the division and the subtraction: about 100 operations per score.
K2_OPS_PER_SCORE = 100.0


def phase_k2(torch, label: str) -> dict:
    """The sampling kernel against the plain chain fed the uniforms the
    kernel's Philox draws; returns the kernel line's numbers at M=81."""
    from nat_tpu_torch.ops import rvq_kernel
    from nat_tpu_torch.quant import rvq as plain

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(4321)
    n, k, d, tau = 4, 4096, 512, 0.5
    result = {}
    for m in (81, 200):
        cb = torch.from_numpy(rng.standard_normal((n, k, d)).astype(
            np.float32)).cuda()
        x = torch.from_numpy(rng.standard_normal((m, d)).astype(
            np.float32)).cuda()
        seed = 900 + m
        codes, err, qsum = rvq_kernel.rvq_encode_cuda(cb, x, tau, seed)
        u = rvq_kernel.philox_uniforms_cuda(seed, n, m, k, x.device)
        host_u = np.stack([plain.philox_uniforms(seed, layer, m, k)
                           for layer in range(n)])
        check(torch.equal(u.cpu(), torch.from_numpy(host_u)),
              f"K2: the card's Philox uniforms differ from the host's (M={m})")
        ref_codes, ref_err, ref_qsum = plain.rvq_chain(cb, x, tau, u)
        torch.cuda.synchronize()
        codes = codes.long()
        mismatch = (codes != ref_codes).float().mean().item()
        check(mismatch <= TIE_BUDGET, f"K2: {mismatch:.4f} of codes differ "
              f"from the plain version at M={m}")
        agree = (codes == ref_codes).all(dim=0)
        qsum_err = (qsum[agree] - ref_qsum[agree]).abs().max().item()
        check(qsum_err <= QSUM_ATOL, f"K2: qsum differs by {qsum_err}")
        again = rvq_kernel.rvq_encode_cuda(cb, x, tau, seed)[0].long()
        other = rvq_kernel.rvq_encode_cuda(cb, x, tau, seed + 1)[0].long()
        argmin = rvq_kernel.rvq_encode_cuda(cb, x)[0].long()
        cold = rvq_kernel.rvq_encode_cuda(cb, x, 1e-4, seed)[0].long()
        check(torch.equal(again, codes), f"K2: seed {seed} not reproducible")
        other_share = (other != codes).float().mean().item()
        check(other_share > 0.5, f"K2: another seed changed only "
              f"{other_share:.3f} of codes")
        cold_miss = (cold != argmin).float().mean().item()
        check(cold_miss <= TIE_BUDGET, f"K2 at τ=1e-4: {cold_miss:.4f} of "
              "codes differ from argmin")
        warm_miss = (codes != argmin).float().mean().item()

        def library_chain():
            # Yardstick only (never called by the port): per layer
            # torch.cdist, Gumbel noise from torch's generator, argmin,
            # index.
            r = x
            for cb_n in cb:
                g = -torch.log(-torch.log(torch.rand(
                    (m, k), device=x.device).clamp(1e-7, 1 - 1e-7)))
                idx = (torch.cdist(r, cb_n) / tau - g).argmin(dim=1)
                r = r - cb_n[idx]
            return r

        ms = device_ms(torch, lambda: rvq_kernel.rvq_encode_cuda(
            cb, x, tau, seed), flush=flush)
        plain_ms = device_ms(torch, lambda: plain.rvq_chain(cb, x, tau, u),
                             flush=flush)
        library_ms = device_ms(torch, library_chain, flush=flush)
        bound_ms, bound_by = chain_bound(m, n, k, d, K2_OPS_PER_SCORE)
        print(f"[kernel] K2 M={m} K={k} tau={tau}: mismatch against the plain "
              f"version {mismatch:.5f}, qsum max abs err {qsum_err:.3g}; same "
              f"seed identical, next seed changes {other_share:.3f} of codes; "
              f"differs from argmin on {warm_miss:.3f} at tau={tau} and "
              f"{cold_miss:.5f} at tau=1e-4; kernel {ms:.4f} ms (device), "
              f"plain {plain_ms:.4f} ms (uniforms given), library chain "
              f"(cdist+Gumbel+argmin+index, yardstick) {library_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}) [{label}]")
        if m == 81:
            check_plan_independence(torch, cb, x, tau, label)
            result = dict(max_abs_err=qsum_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=library_ms)
    del flush
    return result


def phase_k3(torch, label: str) -> dict:
    """The training encode against autograd through the plain
    straight-through version; returns the kernel line's numbers at M=88."""
    from nat_tpu_torch.ops import rvq_kernel
    from nat_tpu_torch.quant import rvq as plain

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rng = np.random.default_rng(8765)
    n, k, d = 4, 4096, 512
    result = {}
    for b, t in ((4, 22), (1, 81)):
        m = b * t
        cb = torch.from_numpy(rng.standard_normal((n, k, d)).astype(
            np.float32)).cuda()
        x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
            np.float32)).cuda()
        w = torch.from_numpy(rng.standard_normal((b, t, d)).astype(
            np.float32)).cuda()

        def run(encode, cb_grad: bool):
            cb_ = cb.clone().requires_grad_(cb_grad)
            x_ = x.clone().requires_grad_(True)
            state = plain.RVQState(cb_, cb_.new_zeros((n, k)), cb_.detach())
            codes, q, losses = encode(state, x_)
            ((q * w).sum() + 0.3 * losses["commitment_loss"]
             + 0.7 * losses["codebook_loss"]
             + 0.2 * losses["total_vq_loss"]).backward()
            return codes.reshape(n, m), cb_.grad, x_.grad.reshape(m, d)

        codes, g_cb, g_x = run(rvq_kernel.rvq_encode_train, True)
        ref_codes, ref_g_cb, ref_g_x = run(plain.rvq_encode_ste, True)
        chain_codes = plain.rvq_chain(cb, x.reshape(m, d))[0]
        torch.cuda.synchronize()
        check(torch.equal(codes[0], chain_codes[0]),
              f"K3: layer-0 codes differ from rvq_chain at M={m}")
        mismatch = max((codes != chain_codes).float().mean().item(),
                       (codes != ref_codes).float().mean().item())
        check(mismatch <= TIE_BUDGET, f"K3: {mismatch:.4f} of codes differ "
              f"at M={m}")
        rows = (codes == ref_codes).all(dim=0)                     # [M]
        # Codebook rows picked by a frame whose codes disagree get other
        # gradients; compare the rest.
        touched = torch.zeros((n, k), dtype=torch.bool, device=cb.device)
        for c in (codes, ref_codes):
            for layer in range(n):
                touched[layer, c[layer][~rows]] = True
        gx_err = (g_x[rows] - ref_g_x[rows]).abs().max().item()
        gcb_err = (g_cb[~touched] - ref_g_cb[~touched]).abs().max().item()
        gx_scale = ref_g_x.abs().max().item()
        gcb_scale = ref_g_cb.abs().max().item()
        check(gx_err <= GRAD_ATOL * gx_scale, f"K3: grad_x differs by "
              f"{gx_err} (scale {gx_scale}) at M={m}")
        check(gcb_err <= GRAD_ATOL * gcb_scale, f"K3: grad_cb differs by "
              f"{gcb_err} (scale {gcb_scale}) at M={m}")

        # Timed as the train step runs it: the codebook takes no gradient.
        x_leaf = x.clone().requires_grad_(True)
        state = plain.RVQState(cb, cb.new_zeros((n, k)), cb)

        def fwd_bwd(encode):
            def fn():
                _, q, losses = encode(state, x_leaf)
                ((q * w).sum() + losses["commitment_loss"]).backward()
            return fn

        # A longer lead: autograd takes the host longer to queue than the
        # default lead lasts.
        ms = device_ms(torch, fwd_bwd(rvq_kernel.rvq_encode_train),
                       flush=flush, lead_cycles=20_000_000)
        plain_ms = device_ms(torch, fwd_bwd(plain.rvq_encode_ste),
                             flush=flush, lead_cycles=20_000_000)
        # Forward as K1; the backward re-gathers q (N·M·D) and reads the
        # quantized gradient, and writes grad_x (M·D).
        bound_ms, bound_by = chain_bound(
            m, n, k, d, extra_bytes=4.0 * (n * m * d + 2 * m * d))
        print(f"[kernel] K3 M={m} ({b}x{t}): codes equal rvq_chain "
              f"(mismatch {mismatch:.5f}); grad_x max abs err {gx_err:.3g} "
              f"(of {gx_scale:.3g}), grad_cb max abs err {gcb_err:.3g} (of "
              f"{gcb_scale:.3g}); forward+backward {ms:.4f} ms (device), "
              f"plain STE autograd {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}) [{label}]")
        if m == 88:
            result = dict(max_abs_err=gx_err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=None)
    del flush
    return result


def expected_frames(tok, samples: int) -> tuple[int, int]:
    """(frames, spans) from the span plan and the keep-mask arithmetic."""
    from nat_tpu_torch.runtime.bucketing import chunk_spans

    overlap = SR
    spans = chunk_spans(samples, SR, overlap=overlap)
    if len(spans) == 1:
        return tok._target_frames(samples, SR), 1
    total = 0
    for start, length in spans:
        ext_start = max(0, start - overlap)
        ext_len = min(samples, start + length + overlap) - ext_start
        valid_t = tok._target_frames(ext_len, SR)
        centers = ext_start + (np.arange(valid_t) + 0.5) * ext_len / valid_t
        total += int(((centers >= start) & (centers < start + length)).sum())
    return total, len(spans)


def check_stream(lines, frames: int, cb_size: int, where: str) -> None:
    events = [json.loads(line) for line in lines]
    head, body, end = events[0], events[1:-1], events[-1]
    check(head["event"] == "header" and head["format_version"] == "1.5"
          and head["schema"] == "lam_audio_tokens", f"{where}: bad header")
    check(len(head["layers"]) == 8, f"{where}: header layers")
    check(end["event"] == "end" and "stats" in end, f"{where}: bad end")
    check(len(body) == frames, f"{where}: {len(body)} frames, expected "
          f"{frames}")
    for i, ev in enumerate(body):
        check(ev["event"] == "frame" and ev["fi"] == i
              and len(ev["S"]) == 4 and len(ev["A"]) == 4
              and all(0 <= c < cb_size for c in ev["S"] + ev["A"]),
              f"{where}: bad frame {i}: {ev}")
    check(end["stats"]["total_tokens"] == 8 * frames, f"{where}: token count")


def phase_main_path(torch, tmp: Path, label: str) -> dict:
    from nat_tpu_torch.ops import rvq_kernel
    from nat_tpu_torch.runtime.pipeline import AudioTokenizationPipeline

    t0 = time.time()
    pipe = AudioTokenizationPipeline(
        sample_rate=SR, model_config={"semantic_arch": "wav2vec2"},
        device="cuda", deterministic_seed=42)
    tok = pipe.tokenizer
    print(f"[main] pipeline at full width ({tok.compute_dtype}, wav2vec2-base "
          f"random init, K={tok.codebook_size}) ready in "
          f"{time.time() - t0:.1f} s [{label}]")
    check(tok.compute_dtype == "bfloat16", "CUDA default must be bfloat16")
    stats = {}
    for seconds, seed in ((10, 1), (70, 2)):
        wav = tmp / f"smoke_{seconds}s.wav"
        write_wav(wav, seconds, seed)
        frames, spans = expected_frames(tok, seconds * SR)
        runs = []
        for _ in range(2):
            lines = []
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            result = pipe.stream_audio(str(wav), lines.append)
            torch.cuda.synchronize()
            wall = time.time() - t0
            counts = read_counts()
            launched = counts["K1"]
            check(counts == {"K1": 2 * spans, "K2": 0, "K3": 0},
                  f"{seconds} s: launches {counts} for {spans} spans")
            check(result["spans"] == spans, f"{seconds} s: span count")
            check_stream(lines, frames, tok.codebook_size, f"{seconds} s")
            runs.append((lines, wall, launched))
        check(runs[0][0][:-1] == runs[1][0][:-1],
              f"{seconds} s: two runs differ before the end line")
        wall = runs[1][1]
        print(f"[main] {seconds} s file: {spans} span(s), {frames} frames, "
              f"K1 launches {runs[1][2]} (= 2 x spans), warm wall {wall:.3f} "
              f"s ({1e3 * wall / spans:.1f} ms per span), "
              f"{seconds / wall:.2f} audio s per wall s, byte-identical "
              f"reruns [{label}]")
        stats[seconds] = dict(spans=spans, frames=frames, wall=wall,
                              launches=runs[1][2],
                              frame_lines=frame_lines(runs[0][0]))

    # Forward time of one span in the largest (30 s) bucket, device clock.
    wave = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 30 * SR)).astype(np.float32) * 0.1).to(tok.device)
    fwd_ms = device_ms(torch, lambda: tok.forward(wave, SR), iters=5,
                       lead_cycles=200_000_000)
    fwd_wall = wall_ms(torch, lambda: tok.forward(wave, SR), iters=5)
    print(f"[main] forward of one 30 s-bucket span: {fwd_ms:.2f} ms device, "
          f"{fwd_wall:.2f} ms per synchronized call on the host clock "
          f"({30e3 / fwd_wall:.1f} audio s per wall s) [{label}]")
    profile_run(torch, lambda: tok.forward(wave, SR),
                "one 30 s-bucket forward", fwd_wall, label)
    profile_run(torch, lambda: pipe.stream_audio(
        str(tmp / "smoke_70s.wav"), lambda line: None),
        "stream_audio of the 70 s file", 1e3 * stats[70]["wall"], label)

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "nat_tpu_torch", str(tmp / "smoke_10s.wav")],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=600,
        stdin=subprocess.DEVNULL)
    check(proc.returncode == 0, f"python -m nat_tpu_torch rc "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    check(proc.stderr == "", f"default mode wrote to stderr: {proc.stderr}")
    check_stream(proc.stdout.splitlines(), stats[10]["frames"],
                 tok.codebook_size, "python -m nat_tpu_torch")
    print("[main] python -m nat_tpu_torch smoke_10s.wav: rc 0, NDJSON only")
    stats["fwd_ms"] = fwd_ms
    return stats


# Kernel-name patterns → category for the forward's time breakdown.
KERNEL_GROUPS = (
    ("K1 rvq_argmin (this repo)", ("rvq_",)),
    ("attention (cuDNN SDPA)", ("sdpa", "flash", "fmha", "attention")),
    ("convolution (cuDNN)", ("conv", "cudnn", "cutlass", "fprop", "dgrad",
                             "nchwToNhwc", "nhwcToNchw", "implicit")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cublas")),
    ("FFT (cuFFT)", ("fft", "radix")),
    ("normalization", ("norm", "Moments")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in KERNEL_GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "elementwise, copies, other"


def profile_run(torch, fn, what: str, wall_ms_unprofiled: float,
                label: str) -> None:
    """Device kernel time of one ``fn()`` by category (torch.profiler
    kernel events only), against the same work's wall time measured
    without the profiler: the device's busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    groups: dict = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.device_time_total if hasattr(ev, "device_time_total") \
            else ev.cuda_time_total
        g = groups.setdefault(_group(ev.name), [0.0, 0])
        g[0] += us
        g[1] += 1
    if not groups:
        print(f"[profile] {what}: device time by kernel not measured (the "
              "profiler recorded no device events)")
        return
    busy = sum(us for us, _ in groups.values()) / 1e3
    print(f"[profile] {what}: kernels {busy:.2f} ms of {wall_ms_unprofiled:.2f}"
          f" ms unprofiled wall ({100 * busy / wall_ms_unprofiled:.1f}% busy, "
          f"{100 - 100 * busy / wall_ms_unprofiled:.1f}% idle) [{label}]")
    for name, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   {us / 1e3:8.3f} ms {100 * us / 1e3 / busy:5.1f}% "
              f"{count:5d} kernels  {name}")


def frame_lines(lines) -> list:
    return [line for line in lines if '"event":"frame"' in line]


def phase_stochastic(torch, tmp: Path, argmin_stats: dict, label: str) -> dict:
    """Serving with stochastic sampling: K2 twice per span, the same frames
    from the same seed, and other frames than argmin's from the same
    weights (seed 42, as the argmin run)."""
    from nat_tpu_torch.runtime.pipeline import AudioTokenizationPipeline

    wav = tmp / "smoke_70s.wav"
    spans, frames = argmin_stats["spans"], argmin_stats["frames"]
    runs = []
    for _ in range(2):
        # A new pipeline for each run, as a new process would build.
        pipe = AudioTokenizationPipeline(
            sample_rate=SR, model_config={"semantic_arch": "wav2vec2"},
            device="cuda", deterministic_seed=42, stochastic=True)
        tok = pipe.tokenizer
        lines = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        pipe.stream_audio(str(wav), lines.append)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        check(counts == {"K1": 0, "K2": 2 * spans, "K3": 0},
              f"stochastic 70 s: launches {counts} for {spans} spans")
        check_stream(lines, frames, tok.codebook_size, "stochastic 70 s")
        runs.append((frame_lines(lines), wall, counts["K2"]))
    check(runs[0][0] == runs[1][0], "stochastic: one seed, other frames")
    check(runs[0][0] != argmin_stats["frame_lines"],
          "stochastic frames equal the argmin frames")
    wall = runs[1][1]
    print(f"[stochastic] 70 s file, seed 42, tau {tok.temperature}: {spans} "
          f"span(s), {frames} frames, K2 launches {runs[1][2]} (= 2 x spans),"
          f" K1 launches 0, warm wall {wall:.3f} s ({70 / wall:.2f} "
          f"audio s per wall s), identical frames from one seed, other "
          f"frames than argmin [{label}]")
    return dict(launches=runs[1][2], wall=wall)


def synth_clip(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(110.0, 440.0)
    audio = (0.5 * np.sin(2 * np.pi * f0 * n * (1 + 0.02 * np.sin(2 * n)))
             + 0.2 * np.sin(2 * np.pi * 3 * f0 * n)
             + 0.05 * rng.standard_normal(n.size))
    return (audio / np.abs(audio).max()).astype(np.float32)


# cuDNN and determinism settings a training step can run under:
# (cudnn.benchmark, cudnn.deterministic, use_deterministic_algorithms).
TRAIN_MODES = {
    "default": (False, False, False),
    "cudnn.benchmark": (True, False, False),
    "cudnn.deterministic": (False, True, False),
    "deterministic algorithms": (False, True, True),
}
TIMED_EPOCHS = 3


def set_train_mode(torch, mode: str) -> None:
    benchmark, deterministic, algorithms = TRAIN_MODES[mode]
    torch.backends.cudnn.benchmark = benchmark
    torch.backends.cudnn.deterministic = deterministic
    torch.use_deterministic_algorithms(algorithms)


def train_cli_mode(torch) -> str:
    """The setting of TRAIN_MODES that ``train_cli`` runs under."""
    from nat_tpu_torch.train_cli import configure_cuda

    set_train_mode(torch, "default")
    configure_cuda()
    cudnn = torch.backends.cudnn
    flags = (cudnn.benchmark, cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    modes = [m for m, f in TRAIN_MODES.items() if f == flags]
    check(len(modes) == 1, f"train_cli's cuDNN settings {flags} are not "
          "one of TRAIN_MODES")
    return modes[0]


def phase_train(torch, tmp: Path, label: str) -> dict:
    """The training path at full width through K3."""
    from nat_tpu_torch.models.tokenizer import (MODULE_NAMES,
                                                NeuralAudioTokenizer)
    from nat_tpu_torch.runtime.bucketing import bucket_length
    from nat_tpu_torch.runtime.trainer import Trainer
    from nat_tpu_torch.train_cli import build_optimizer

    rng = np.random.default_rng(11)
    clips = [synth_clip(rng.uniform(6.0, 8.0), 100 + i) for i in range(8)]
    check({bucket_length(len(c), SR) for c in clips} == {8 * SR},
          "training clips must share the 8 s bucket")
    audio_s = sum(len(c) for c in clips) / SR
    cli_mode = train_cli_mode(torch)            # as train_cli runs
    t0 = time.time()
    tok = NeuralAudioTokenizer(sample_rate=SR, enable_reconstruction=True,
                               seed=42, device="cuda")
    opt = build_optimizer(1e-4, TRAIN_STEPS, schedule="cosine",
                          warmup_steps=2, grad_clip=1.0)
    trainer = Trainer(tok, optimizer=opt, log_every=TRAIN_STEPS, seed=0)
    params = trainer.state.params
    check(tok.compute_dtype == "bfloat16", "training must compute in bf16")
    n_params = sum(p.numel() for p in params.parameters())
    initial = [p.detach().clone() for p in params.parameters()]
    print(f"[train] Trainer at full width (wav2vec2-base random init, "
          f"D={tok.semantic_dim}, K={tok.codebook_size}, "
          f"{tok.num_semantic_layers}+{tok.num_acoustic_layers} quantizers, "
          f"{n_params / 1e6:.1f} M float32 params, bf16 encoders) ready in "
          f"{time.time() - t0:.1f} s [{label}]")
    # The train state starts from the seed's float32 values, which the
    # same seed gives on the CPU, not from the card modules' bf16 rounding.
    ref = NeuralAudioTokenizer(sample_rate=SR, enable_reconstruction=True,
                               seed=42, device="cpu")
    ref.ensure_initialized()
    tensors = off_grid = 0
    for name in MODULE_NAMES:
        ours = params[name].state_dict()
        for key, value in getattr(ref, name).state_dict().items():
            check(ours[key].dtype == torch.float32
                  and torch.equal(ours[key].cpu(), value),
                  f"train state {name}.{key} is not the float32 init")
            tensors += 1
            off_grid += not torch.equal(value.bfloat16().float(), value)
    del ref
    print(f"[train] train state equals the CPU's float32 init exactly; "
          f"{off_grid} of {tensors} tensors hold values bf16 cannot")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    history = trainer.fit(clips, num_steps=TRAIN_STEPS,
                          batch_size=TRAIN_BATCH)
    torch.cuda.synchronize()
    fit_wall = time.time() - t0
    counts = read_counts()
    check(counts == {"K1": 2 * TRAIN_STEPS, "K2": 0, "K3": 2 * TRAIN_STEPS},
          f"training: launches {counts} in {TRAIN_STEPS} steps")
    check(len(history) == TRAIN_STEPS and all(
        np.isfinite(h[key]) for h in history
        for key in ("loss", "reconstruction_loss", "commitment_loss")),
        f"training losses not finite: {history}")
    for name, rvq in (("semantic", trainer.state.sem_rvq),
                      ("acoustic", trainer.state.acc_rvq)):
        check(rvq.ema_count.sum().item() > 0, f"{name} ema_count is 0")
    changed = sum(not torch.equal(p, q) for p, q in
                  zip(params.parameters(), initial))
    check(changed > 0, "no parameter changed")
    print(f"[train] {TRAIN_STEPS} steps of batch {TRAIN_BATCH} (8 s bucket),"
          f" under {cli_mode} as train_cli: loss "
          f"{history[0]['loss']:.5f} -> {history[-1]['loss']:.5f}, "
          f"all finite; K3 launches {counts['K3']} (= 2 x steps), K1 "
          f"{counts['K1']}; {changed} of {len(initial)} param tensors "
          f"changed; ema_count > 0; fit wall {fit_wall:.2f} s with the "
          f"first step [{label}]")

    # Warm steps under each setting: after two steps that pick (or, with
    # benchmark, search) the algorithms, TIMED_EPOCHS epochs of both
    # batches (all eight clips), then a profiled step.
    batches = list(trainer._batches(clips, TRAIN_BATCH, 2))
    step_ms = {}
    for mode in TRAIN_MODES:
        set_train_mode(torch, mode)
        for batch in batches:
            trainer.step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_EPOCHS):
            for batch in batches:
                trainer.step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        epoch = (time.perf_counter() - t0) / TIMED_EPOCHS
        step_ms[mode] = 1e3 * epoch / len(batches)
        user = " (train_cli's setting)" if mode == cli_mode else ""
        print(f"[train] {mode}{user}: warm step {step_ms[mode]:.1f} ms (host "
              f"clock, synchronized, mean of {TIMED_EPOCHS} epochs of "
              f"{len(batches)} steps); {audio_s / epoch:.1f} audio s trained "
              f"per wall s ({audio_s:.1f} s of audio per epoch) [{label}]")
        profile_run(torch, lambda: trainer.step_fn(trainer.state, batches[0]),
                    f"one training step ({mode})", step_ms[mode], label)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[train] peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated) [{label}]")

    # Save, restore into a fresh trainer, one more step on each: bit for
    # bit only with deterministic algorithms (cuDNN's attention and
    # convolution backwards are otherwise free to reduce in any order).
    set_train_mode(torch, "deterministic algorithms")
    try:
        path = trainer.save_checkpoint(str(tmp / "train_state.pt"))
        other = Trainer(tok, optimizer=opt, seed=0)
        other.restore_checkpoint(path)
        check(state_diff(torch, trainer.state.state_dict(),
                         other.state.state_dict()) == [],
              "restored train state differs from the saved one")
        trainer.step_fn(trainer.state, batches[0])
        other.step_fn(other.state, batches[0])
        torch.cuda.synchronize()
        diff = state_diff(torch, trainer.state.state_dict(),
                          other.state.state_dict())
        check(diff == [], f"one more step after restore differs: {diff[:8]}")
    finally:
        set_train_mode(torch, "default")
    print(f"[train] checkpoint ({os.path.getsize(path) / 2 ** 20:.0f} MiB) "
          f"survives save, restore and one more step bit for bit "
          f"(deterministic algorithms) [{label}]")
    return dict(launches=counts["K3"])


def state_diff(torch, a, b, prefix: str = "") -> list:
    """Keys where two nested state dicts differ (tensors bit for bit)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [prefix or "<keys>"]
        return [k for key in a
                for k in state_diff(torch, a[key], b[key], f"{prefix}/{key}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [prefix]
        return [k for i, (x, y) in enumerate(zip(a, b))
                for k in state_diff(torch, x, y, f"{prefix}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a.cpu(), b.cpu()) else [prefix]
    return [] if a == b else [prefix]


def run_module(args, tmp: Path, check_stderr_empty: bool = False):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, cwd=str(tmp), env=env, timeout=600,
                          stdin=subprocess.DEVNULL)
    check(proc.returncode == 0, f"python -m {' '.join(args)}: rc "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    if check_stderr_empty:
        check(proc.stderr == "", f"default mode wrote to stderr: "
              f"{proc.stderr[-2000:]}")
    return proc


def phase_entry_points(torch, tmp: Path, frames_10s: int, label: str
                       ) -> None:
    """train_cli → --model-path, and --stochastic twice, as subprocesses."""
    for name, seconds, seed in (("a.wav", 3, 5), ("b.wav", 4, 6)):
        write_wav(tmp / name, seconds, seed)
    model = tmp / "m.pt"
    t0 = time.time()
    run_module(["nat_tpu_torch.train_cli", "a.wav", "b.wav", "--steps", "2",
                "--model-out", str(model), "--checkpoint-dir",
                str(tmp / "ckpt")], tmp)
    check(model.exists(), "train_cli wrote no model")
    saved = torch.load(model, map_location="cpu", weights_only=True)
    values = [v for sd in saved["params"].values() for v in sd.values()]
    check(all(v.dtype == torch.float32 for v in values),
          "train_cli's model is not float32")
    off_grid = sum(not torch.equal(v.bfloat16().float(), v) for v in values)
    check(off_grid > 0, "train_cli's model holds bf16-rounded params only")
    del saved, values
    print(f"[entry] python -m nat_tpu_torch.train_cli a.wav b.wav --steps 2 "
          f"--model-out m.pt: rc 0 in {time.time() - t0:.1f} s, "
          f"{model.stat().st_size / 2 ** 20:.0f} MiB model, float32 "
          f"params ({off_grid} tensors off the bf16 grid) [{label}]")
    proc = run_module(["nat_tpu_torch", "-v", "--model-path", str(model),
                       str(tmp / "smoke_10s.wav")], tmp)
    check("Loaded model checkpoint" in proc.stderr,
          f"--model-path did not load: {proc.stderr[-2000:]}")
    check_stream(proc.stdout.splitlines(), frames_10s, 4096, "--model-path")
    print("[entry] python -m nat_tpu_torch --model-path m.pt smoke_10s.wav: "
          "rc 0, checkpoint loaded, valid NDJSON")
    outs = []
    for _ in range(2):
        proc = run_module(["nat_tpu_torch", "--stochastic", "--seed", "7",
                           str(tmp / "smoke_10s.wav")], tmp,
                          check_stderr_empty=True)
        lines = proc.stdout.splitlines()
        check_stream(lines, frames_10s, 4096, "--stochastic")
        outs.append(frame_lines(lines))
    check(outs[0] == outs[1], "--stochastic --seed 7 twice: frames differ")
    print("[entry] python -m nat_tpu_torch --stochastic --seed 7 "
          "smoke_10s.wav twice: rc 0, identical frames")


def phase_parity(torch, tmp: Path) -> None:
    from nat_tpu_torch.io.audio import load_audio_file_ex, peak_normalize_ex
    from nat_tpu_torch.models.tokenizer import NeuralAudioTokenizer

    audio, sr, _ = load_audio_file_ex(str(tmp / "smoke_10s.wav"))
    audio, _ = peak_normalize_ex(audio)
    codes = {}
    for device in ("cuda", "cpu"):
        tok = NeuralAudioTokenizer(sample_rate=SR, semantic_arch="wav2vec2",
                                   compute_dtype="float32", seed=42,
                                   device=device)
        out = tok(audio[None, :], actual_sample_rate=sr, want_features=False)
        codes[device] = np.stack(out["semantic_codes"]
                                 + out["acoustic_codes"])
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 left on")
    check(codes["cuda"].shape == codes["cpu"].shape, "parity shapes differ")
    share = float((codes["cuda"] == codes["cpu"]).mean())
    print(f"[parity] float32, TF32 off: card and CPU tokens agree on "
          f"{share:.5f} of {codes['cpu'].size} codes")
    check(share >= 1.0 - TIE_BUDGET, f"card/CPU agreement {share:.4f}")


def main() -> int:
    # Deterministic algorithms refuse cuBLAS without a fixed workspace, and
    # torch reads this once, at the process's first matmul: it holds for
    # every phase, though only the training checkpoint check needs it.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this proof "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import nat_tpu_torch  # noqa: F401  (fails outside a checkout)

    label = card_label()
    print(f"[card] {label}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t_start = time.time()
    phase_build(label)
    k1 = phase_kernel(torch, label)
    k2 = phase_k2(torch, label)
    k3 = phase_k3(torch, label)
    if sys.argv[1:] == ["--kernels"]:
        # The kernel phases, the plan sweep and the profile, then stop: no
        # result line.
        phase_plans(torch, label)
        check_one_call_launches(label)
        print(f"[card] kernel phases passed in {time.time() - t_start:.0f} s "
              f"[{label}]")
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        stats = phase_main_path(torch, Path(tmp), label)
        sampled = phase_stochastic(torch, Path(tmp), stats[70], label)
        phase_parity(torch, Path(tmp))
        trained = phase_train(torch, Path(tmp), label)
        phase_entry_points(torch, Path(tmp), stats[10]["frames"], label)
    check_one_call_launches(label)
    print(f"[card] all phases passed in {time.time() - t_start:.0f} s "
          f"[{label}]")

    source = "nat_tpu_torch/csrc/rvq_argmin.cu"
    kernels = [{
        "name": "rvq_argmin (K1)", "route": "cuda", "source": source,
        "replaces": "nat_tpu/ops/rvq_pallas.py:41",
        "tpu_function": "_rvq_kernel (argmin)",
        "launches": stats[70]["launches"],
        "main_path_run": "stream_audio, 70 s file",
        "library": "per-layer torch.cdist + argmin + index (yardstick)",
        **k1,
    }, {
        "name": "rvq_sample (K2)", "route": "cuda", "source": source,
        "replaces": "nat_tpu/ops/rvq_pallas.py:73",
        "tpu_function": "_rvq_kernel (stochastic)",
        "launches": sampled["launches"],
        "main_path_run": "stream_audio --stochastic, 70 s file",
        "library": "per-layer torch.cdist + Gumbel + argmin + index "
                   "(yardstick)",
        **k2,
    }, {
        "name": "rvq_train_encode (K3)", "route": "cuda",
        "source": "nat_tpu_torch/ops/rvq_kernel.py",
        "kernel_source": source,
        "replaces": "nat_tpu/ops/rvq_pallas.py:326",
        "tpu_function": "rvq_encode_pallas_train (custom_vjp)",
        "launches": trained["launches"],
        "main_path_run": f"Trainer.fit, {TRAIN_STEPS} steps",
        "timed": "forward (K1) + analytic STE backward, codebook without "
                 "gradient as in the train step",
        **k3,
    }]
    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
