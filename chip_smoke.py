#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (crdr_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py               # from the root of a checkout; one GPU
    python3 chip_smoke.py --profile     # + device time by kernel, idle share,
                                        #   K1's, K2's and K3's shares
    python3 chip_smoke.py --ab-encode   # + the fixed-batch analysis A/B

Phases, each asserted (any failure exits non-zero):

1. card: the nvidia-smi name / power-limit line; the kernels build from the
   checkout's sources (nvcc for K1, K2 and K3, g++ for the host rANS coders,
   all started together) into build/crdr_tpu_torch/.
2. K1 (the Charm SliceTransform kernel) at the main path's shapes: batch 4,
   a 32x48 latent (a 512x768 image), Cin 480 (mean / scale) and 512 (LRP),
   seeded weights in a 10-slice packed stack, slice 7.  The library's SASS
   must hold HGMMA (wgmma) and no HMMA (mma.sync).  The kernel against its
   plain PyTorch twin (TF32 off), bit-stability across calls and batch
   sizes, and times: kernel at batch 4 and 1, each of its four launches
   (pad / cast, conv0, conv1, conv2) at batch 4 and 1 from the profiler
   (printed as not measured when the profiler records no device activity),
   its blocks per conv and their residency, plain twin, a cuDNN bf16 conv
   chain from the same f32 x (yardstick only, never called by the port) and
   the bound.  Kernel and cuDNN chain are timed as CUDA-graph replays
   (device time; the eager call's time, host enqueue included, is printed
   beside it).  Then K1's stage times at batch 4 and 1 for other cluster
   splits than the plan's, each held against the twin.
3. main path, compressai wire: the flagship BetaCondInterpCaHyperpriorCharmModel
   at full width from config/crdr_throughput.yaml, seeded random init, on 4
   seeded smooth synthetic 512x768 uint8 images: compress_batch ->
   decompress_batch with the K1 launch count, bit-exact y_hat,
   reconstruction sanity, real vs predicted bpp, a batch-1 decode of stream
   0 and a batch-1 encode of image 0 (both equal to the batch-4 ones), and
   the timings.
4. main path, device wire: the same model (wire_format: device,
   device_wire_encoder: host, set in its options, codec_setup again): the K2
   and K1 launch counts, y_hat bit-exact and equal to the compressai wire's,
   real vs predicted bpp, the decode chain enqueued with no host sync, and
   both wires' timings.
5. K2 (one lane-rans decode round) on the inputs the device-wire decode
   gave it (11 rounds: z, then the 10 y slices; the tables are the real
   ones, with their kernel-ready buffers): kernel == plain twin exactly
   (values, states, pointers), a flipped stream word changes the kernel's
   output, two launches are bit-identical, the global-table instantiation
   equals the plan's; the build's registers and spills (none) from the
   ptxas report and the plan's shared memory a block; times of a batch-4 y
   round and of the z round as CUDA-graph replays (eager beside them), of
   the prologue alone (m = 0), of the global-table instantiation and of the
   twin; cycles a step, measured ((round - prologue) x SM clock / steps,
   the clock sampled with nvidia-smi while the y round runs); the bound;
   and, as text only, two chain estimates (v1's binary search and v2's
   bucket search, at an assumed shared-memory latency).
6. K3 (GDN / inverse GDN) at the GDN path's three shapes ([4, 192, 256x384
   / 128x192 / 64x96] NCHW f32), both directions, seeded non-symmetric
   gamma: kernel vs plain twin (TF32 off) bit for bit (the count of
   differing elements printed) and elementwise within 2e-5 |plain| + 1e-6,
   a transposed gamma and the wrong direction fail that by > 10x,
   bit-stable across calls and batch 1 vs 4; the build's registers and
   spills (none) from the ptxas report, blocks resident an SM; times of the
   kernel (CUDA-graph replay, gamma^T copy included, and eager), the twin,
   the cuBLAS f32 product gamma . x^2 at each shape (yardstick only) and
   the bound.
7. GDN path: the Balle18 mean-scale hyperprior (HyperpriorModel) at full
   width from config/balle18_mean_scale.yaml on the same images, seeded
   init with every GDN's gamma re-drawn non-symmetric, the last analysis
   conv scaled so that y spans several bins, the scale half of the
   hyper-decoder's last bias raised so that the y tables carry the rate:
   the checks of phase 3 with 6 K3 launches per round trip and none of K1
   or K2, and the timings.  Then a yardstick of the synthesis: its
   transposed convs conv_2 and conv_4 as the port runs them and as
   sub-pixel convolutions plus pixel_shuffle (held within f32 tolerance).
8. model classes: the five other config/_base_/model/*.yaml at full width
   (elic_hyperprior, elic_charm, interp_ca_elic_hyperprior,
   interp_ca_elic_charm, beta_cond_interp_ca_elic_hyperprior) with
   crdr_throughput.yaml's codec options laid over each, seeded init, the y
   scale heads raised: the checks of phase 3 with K1 60 launches a round
   trip on the two Charm classes and none on the three hyperprior ones;
   interp_ca_elic_charm also on the device wire (the checks of phase 4,
   K2 11).  Each model is freed before the next.
9. TF32 chain: config/crdr_fastchain.yaml (codec_precision: default) on the
   flagship with K1 on, then off, each on both wires (the checks of phases
   3 and 4); TF32 really ran: the hyper-decoder's output on one z under
   TF32 differs from the f32 chain's, by at most 1e-2 of its range; then
   on each wire crdr_throughput.yaml and the two variants timed in turns.
10. entry points: the codec's uint8 -> f32 conversion on the card equals the
   host's uint8_to_tensor on all 256 values; run_model on the flagship at
   rates 0..4 (the encoder's last InterpCA gains spread so the rate
   matters), bpp / PSNR / MS-SSIM finite, bpp rising with the rate;
   validation (beta = max_beta / 2) per image, its bpp within 1e-3 of
   run_model's; then the CLI (python -m crdr_tpu_torch.cli.compress
   config/crdr_throughput.yaml --decompress --batch 4) as a subprocess on
   each wire: each .bin equals compress_batch's streams (of the PNGs read
   back; equal to those of the uint8 images), each .png decompress_batch's
   image, _avg_bitrate.json their mean real bpp.
11. one JSON line of kernel figures (launches by path, every path above),
   then the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Imports nothing of JAX or of the JAX package.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
N_IMG, IMG_H, IMG_W = 4, 512, 768
# kernel vs plain twin, max |diff|: a one-ulp f32 difference can flip a bf16
# intermediate; measured 4.6e-4 / 4.7e-4 (Cin 480 / 512) on an H100 at
# these inputs, outputs up to ~0.6 (PERF.md)
K1_ATOL = 2e-3
BPP_REL = 0.05       # real vs predicted bpp
TIMED_RUNS = 3       # timed batch round trips per wire (medians printed)
H100_BF16_FLOPS = 989e12   # dense, 700 W part (NVIDIA data sheet)
INT32_LANES_PER_SM = 64   # Hopper: 4 partitions x 16 INT32 units (NVIDIA
#                           H100 architecture white paper); times the SM count
#                           and max SM clock, the card's INT32 issue rate
H100_BYTES_PER_S = 3.35e12
SMEM_LATENCY_CYCLES = 30   # an ASSUMED latency of a dependent shared-memory
#                            load on Hopper, not measured: K2's chain
#                            estimates only, printed as text and kept out of
#                            the kernels line (K2's measured figure there is
#                            cycles_per_step)
FP32_FLOPS_PER_SM_CLOCK = 256  # Hopper: 128 FP32 lanes x 2 (FMA); times the
#                                SM count and max SM clock, the f32 peak
# K3 vs its plain twin, elementwise |kernel - plain| <= K3_RTOL |plain| +
# K3_ATOL: f32 sums of C non-negative terms in another order, then rsqrt
K3_RTOL, K3_ATOL = 2e-5, 1e-6
GDN_SHAPES = [(N_IMG, 192, IMG_H // s, IMG_W // s) for s in (2, 4, 8)]
Y_STD = 4.0          # GDN path: y's spread after the analysis gain, in bins


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each entry function in a build's ptxas
    report, {mangled name: {"registers": n, "spill_bytes": n}}; prints the
    report's register and spill lines."""
    res, entry = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                res[entry] = {"registers": None, "spill_bytes": 0}
            if "registers" not in line and "spill" not in line:
                continue
            print(f"  ptxas {os.path.basename(log)}:", line.strip())
            if entry and "spill stores" in line:
                res[entry]["spill_bytes"] += sum(
                    int(v) for v in re.findall(r"(\d+) bytes spill", line))
            m = re.search(r"Used (\d+) registers", line)
            if entry and m:
                res[entry]["registers"] = int(m.group(1))
    return res


def build_kernels() -> dict:
    """Builds every library in parallel; returns each kernel module's ptxas
    report, {"slice_transform" | "lane_decode" | "gdn": ptxas_report}."""
    from crdr_tpu_torch import runtime
    from crdr_tpu_torch.ops import gdn as k3
    from crdr_tpu_torch.ops import lane_decode as k2
    from crdr_tpu_torch.ops import slice_transform as k1

    results, threads = {}, []

    def run(name, fn):
        t0 = time.perf_counter()
        try:
            results[name] = (fn(), time.perf_counter() - t0)
        except Exception as e:  # reported below, then the run fails
            results[name] = (e, time.perf_counter() - t0)

    for name, fn in (("slice_transform (nvcc sm_90a)", k1.build),
                     ("lane_decode (nvcc sm_90a)", k2.build),
                     ("gdn (nvcc sm_90a)", k3.build),
                     ("host rANS (g++)", runtime.build)):
        threads.append(threading.Thread(target=run, args=(name, fn)))
        threads[-1].start()
    for t in threads:
        t.join()
    for name, (res, dt) in results.items():
        check(not isinstance(res, Exception), f"build of {name}: {res}")
        print(f"built {name} in {dt:.1f} s -> {os.path.relpath(res, ROOT)}")
    return {k.__name__.split(".")[-1]: ptxas_report(k.build() + ".log")
            for k in (k1, k2, k3)}


def max_sm_clock_ghz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0]) / 1e3


def sm_clock_under_load_ghz(fn, seconds: float = 1.5):
    """The SM clock while ``fn`` runs back to back for ``seconds``: the
    median of nvidia-smi's 100 ms samples taken meanwhile, in GHz, or None
    when nvidia-smi gave none."""
    import torch

    mon = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        mon.terminate()
        out = mon.communicate(timeout=60)[0]
    samples = sorted(float(v) for v in out.split()
                     if re.fullmatch(r"\d+(\.\d+)?", v))
    return samples[len(samples) // 2] / 1e3 if samples else None


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed between two events, so the host's enqueue time (Python,
    the wrapper, the driver) is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sass_counts(lib: str) -> dict:
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in a built library's
    SASS; raises if cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError("cuobjdump not found: K1's SASS cannot be counted")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return {op: sum(1 for line in sass.splitlines()
                    if re.search(rf"\b{op}\b", line))
            for op in ("HGMMA", "HMMA")}


def k1_stage_ms(fn, calls: int = 10, tries: int = 3):
    """Device time per stage of K1 (its four kernels in launch order: the
    pad / cast pass, conv0, conv1, conv2), mean over ``calls`` calls of
    ``fn``, from the profiler's kernel records.  None when the profiler
    records no device activity at all in ``tries`` sessions: CUPTI allows
    one subscriber a process, so a tracer outside this script, or a CUPTI
    that fails to start, leaves torch.profiler blind.  K1's own time is
    taken with CUDA events and does not depend on this."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if dev:
            break
    else:
        print(f"K1 stage times: not measured (torch.profiler recorded no "
              f"device activity in {tries} sessions)")
        return None
    evs = sorted((e for e in dev if "k1_" in e.name),
                 key=lambda e: e.time_range.start)
    check(len(evs) == 4 * calls, f"K1 profile: {len(evs)} kernel records "
                                 f"for {calls} calls (expected 4 each)")
    names = ("prep", "conv0", "conv1", "conv2")
    out = {k: 0.0 for k in names}
    for i, e in enumerate(evs):
        want = "k1_prep" if i % 4 == 0 else "k1_conv"
        check(want in e.name, f"K1 profile: record {i} is {e.name[:80]}")
        out[names[i % 4]] += e.time_range.elapsed_us() / 1e3 / calls
    return out


def stage_text(st) -> str:
    """K1's stage times as printed, or why there are none."""
    if st is None:
        return "not measured (the profiler saw no device activity)"
    return (", ".join(f"{k} {v:.4f}" for k, v in st.items())
            + f" ms, sum {sum(st.values()):.4f} ms")


def k1_phase(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from crdr_tpu_torch.ops import slice_transform as k1mod
    from crdr_tpu_torch.ops.slice_transform import (slice_transform,
                                                    slice_transform_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    n, h, w, S, idx = N_IMG, IMG_H // 16, IMG_W // 16, 10, 7
    c0, c1, cout = 224, 128, 32
    sass = sass_counts(k1mod.build())
    check(sass["HGMMA"] > 0 and sass["HMMA"] == 0,
          f"K1's library must use wgmma and no mma.sync: {sass}")
    rows = []
    for cin in (480, 512):
        def uni(shape, fan_in):
            b = 1.0 / fan_in ** 0.5
            return torch.empty(shape, device=dev).uniform_(-b, b, generator=g)

        x = torch.randn((n, h, w, cin), device=dev, generator=g)
        w0 = uni((S, 5, 5, cin, c0), 25 * cin).to(torch.bfloat16)
        w2 = uni((S, 5, 5, c0, c1), 25 * c0).to(torch.bfloat16)
        w4 = uni((S, 3, 3, c1, cout), 9 * c1).to(torch.bfloat16)
        # biases at the outputs' scale, so a dropped bias or another
        # slice's weights fail K1_ATOL (checked below)
        b0, b2, b4 = (0.1 * torch.randn((S, c), device=dev, generator=g)
                      for c in (c0, c1, cout))
        args = (w0, b0, w2, b2, w4, b4)
        own = tuple(t[idx] for t in args)

        out = slice_transform(x, *args, idx)
        again = slice_transform(x, *args, idx)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"K1 Cin {cin}: two launches differ")
        for i in range(n):
            one = slice_transform(x[i:i + 1].contiguous(), *args, idx)
            check(torch.equal(out[i:i + 1], one),
                  f"K1 Cin {cin}: batch-{n} image {i} != batch-1 launch")
        plain = slice_transform_plain(x, *own)
        err = float((out - plain).abs().max())
        scale = float(plain.abs().max())
        check(torch.isfinite(out).all(), f"K1 Cin {cin}: non-finite output")
        check(err <= K1_ATOL, f"K1 Cin {cin}: max|kernel - plain| {err} > "
                              f"{K1_ATOL}")
        # the check's power: the faults it must catch move the output more
        no_b4 = float((plain - own[5] - out).abs().max())
        other = slice_transform_plain(x, *(t[idx - 1] for t in args))
        wrong = float((other - out).abs().max())
        check(min(no_b4, wrong) > 10 * K1_ATOL,
              f"K1 Cin {cin}: the check is blind to a dropped bias "
              f"({no_b4:.3e}) or another slice's weights ({wrong:.3e})")

        # yardstick: cuDNN bf16 convolutions, channels-last, from the same
        # f32 x (the cast is part of the work; not used by the port)
        wl = [t.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last) for t in own[0::2]]

        def library():
            y = x.to(torch.bfloat16).permute(0, 3, 1, 2)
            y = torch.relu(F.conv2d(y, wl[0], own[1].to(torch.bfloat16),
                                    padding=2))
            y = torch.relu(F.conv2d(y, wl[1], own[3].to(torch.bfloat16),
                                    padding=2))
            return F.conv2d(y, wl[2], own[5].to(torch.bfloat16), padding=1)

        x1 = x[:1].contiguous()
        # device time per call (CUDA graph), and the eager call's time with
        # the host's enqueue in it
        ms = graph_time_ms(lambda: slice_transform(x, *args, idx))
        ms1 = graph_time_ms(lambda: slice_transform(x1, *args, idx))
        eager_ms = cuda_time_ms(lambda: slice_transform(x, *args, idx), 20)
        stages = k1_stage_ms(lambda: slice_transform(x, *args, idx))
        stages1 = k1_stage_ms(lambda: slice_transform(x1, *args, idx))
        with torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                         deterministic=False,
                                         allow_tf32=False):
            lib_ms = graph_time_ms(library)
        plain_ms = cuda_time_ms(lambda: slice_transform_plain(x, *own), 5, 1)
        flops = 2.0 * n * h * w * (25 * cin * c0 + 25 * c0 * c1 +
                                   9 * c1 * cout)
        nbytes = (4 * n * h * w * (cin + cout)
                  + 2 * (25 * cin * c0 + 25 * c0 * c1 + 9 * c1 * cout)
                  + 4 * (c0 + c1 + cout))
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        plans = k1mod.slice_transform_plan(h, w, cin, c0, c1, cout)
        grid = []
        for j, p in enumerate(plans):
            occ = k1mod.occupancy(p, last=j == 2)
            tiles = -(-p["tiles_x"] * p["tiles_y"] // p["pair"]) * p["pair"]
            blocks = p["split"] * tiles
            grid.append(dict(blocks_batch1=blocks, blocks=n * blocks,
                             split=p["split"], pair=p["pair"],
                             n_inst=p["n_inst"], **occ))
        row = dict(cin=cin, ms=ms, ms_batch1=ms1, eager_ms=eager_ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   max_abs_err=err, out_max_abs=scale, gflop=flops / 1e9,
                   ms_by_stage=stages, ms_by_stage_batch1=stages1,
                   grid=grid)
        rows.append(row)
        print(f"K1 Cin {cin}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s; eager, host enqueue included, {eager_ms:.4f} ms), "
              f"batch 1 {ms1:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuDNN bf16 chain {lib_ms:.4f} ms, bound "
              f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}); max|err| "
              f"{err:.3e} of |out| <= {scale:.3f} (dropped b4 would give "
              f"{no_b4:.3e}, slice {idx - 1}'s weights {wrong:.3e}); "
              f"bit-stable across calls and batch sizes [{card}]")
        print(f"K1 Cin {cin} by stage, batch {n}: {stage_text(stages)}; "
              f"batch 1: {stage_text(stages1)}; blocks (batch 1 / {n}), "
              "split x multicast pair, wgmma N, blocks per SM, clusters "
              "resident, shared memory: "
              + "; ".join(f"conv{j} {q['blocks_batch1']} / {q['blocks']}, "
                          f"{q['split']} x {q['pair']}, N {q['n_inst']}, "
                          f"{q['blocks_per_sm']}/SM, {q['clusters']} "
                          f"clusters, {q['smem_bytes']} B"
                          for j, q in enumerate(grid)) + f" [{card}]")
    print(f"K1 library SASS: {sass['HGMMA']} HGMMA, {sass['HMMA']} HMMA")
    return {"by_cin": {r["cin"]: r for r in rows}, "sass": sass}


def k1_split_phase(card: str, splits=((1, 1, 1), (2, 2, 2), (4, 4, 4),
                                        (8, 8, 4), (8, 8, 8))) -> None:
    """K1's device time by stage at batch 4 and 1 (Cin 480, 32x48) for other
    cluster splits than the plan's: the measurement the default split was
    chosen from."""
    import torch

    from crdr_tpu_torch.ops import slice_transform as k1mod

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    h, w, cin, c0, c1, cout = IMG_H // 16, IMG_W // 16, 480, 224, 128, 32
    x = torch.randn((N_IMG, h, w, cin), device=dev, generator=g)
    args = []
    for shape in ((1, 5, 5, cin, c0), (1, c0), (1, 5, 5, c0, c1), (1, c1),
                  (1, 3, 3, c1, cout), (1, cout)):
        b = (1.0 / np.prod(shape[1:4]) ** 0.5 if len(shape) == 5 else 0.1)
        args.append(torch.empty(shape, device=dev).uniform_(-b, b,
                                                            generator=g))
    plain = k1mod.slice_transform_plain(x, *(t[0] for t in args))
    for j in (0, 2, 4):
        args[j] = args[j].to(torch.bfloat16)
    for sp in splits:
        plan = tuple(k1mod.plan_ints(k1mod.slice_transform_plan(
            h, w, cin, c0, c1, cout, sp)))
        out = k1mod._launch(x, *args, 0, plan)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        check(err <= K1_ATOL, f"K1 split {sp}: max|kernel - plain| {err}")
        for xb in (x, x[:1].contiguous()):
            st = k1_stage_ms(lambda: k1mod._launch(xb, *args, 0, plan))
            print(f"K1 split {sp} batch {xb.shape[0]}: {stage_text(st)} "
                  f"[{card}]")


def smooth_images(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W].astype(np.float32) / IMG_W
    imgs = []
    for _ in range(N_IMG):
        f = rng.uniform(1.0, 9.0, (3, 3))
        ph = rng.uniform(0, 2 * np.pi, 3)
        chans = [0.5 + 0.25 * np.sin(f[c, 0] * xx + ph[c])
                 * np.cos(f[c, 1] * yy) + 0.2 * np.sin(f[c, 2] * (xx + yy))
                 for c in range(3)]
        imgs.append(np.stack(chans, -1))
    return np.clip(np.round(np.stack(imgs) * 255), 0, 255).astype(np.uint8)


def profile_phase(fn, label: str, card: str, kernels=()) -> None:
    """Device time by kernel and the device's busy share over ``fn()``
    (one stream: the kernels' summed time is the busy time); for each name
    in ``kernels``, the share of the device time whose name contains it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):  # device-side events only (kernels, copies, memsets)
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            return 0.0
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if dev_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f} [{card}]")
    for us, count, key in rows[:12]:
        print(f"  {us / 1e3:9.2f} ms {us / 1e4 / max(busy, 1e-9):6.1f}% "
              f"x{count:<5d} {key[:100]}")
    for kernel in kernels:
        mine = sum(r[0] for r in rows if kernel in r[2]) / 1e6
        print(f"  {kernel}: {mine * 1e3:.3f} ms, {mine / max(busy, 1e-9):.3f} "
              f"of the device time")


def raise_y_scales(model, bias: float = 8.0) -> None:
    """At the random init y is near 0 and z carries most of the rate;
    biasing the y scale heads (sigma ~ 8) makes the y Gaussian tables carry
    it, so the real-vs-predicted check exercises them (within 1% at 128x192
    on the CPU twin).  The heads: the Charm scale transforms' last conv, or
    the hyper-decoder's scale half."""
    import torch

    with torch.no_grad():
        if model.use_charm:
            for st in model.net.context_model.scale_slice_transforms:
                st.model[4].bias += bias
        else:
            model.net.hyperdecoder.hd_std.conv3.bias += bias


def build_model(card: str):
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "crdr_throughput.yaml"))
    t0 = time.perf_counter()
    model = build_comp_model(cfg)  # the GPU; seeded init (cfg seed / 0)
    raise_y_scales(model)
    model.codec_setup()
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.net.parameters())
    print(f"flagship {cfg.model_type}: {nparam / 1e6:.1f}M params, "
          f"fused_slice_kernel={model.fused_slice_kernel}, transform_dtype="
          f"{model.transform_dtype}, built in {time.perf_counter() - t0:.1f} "
          f"s [{card}]")
    check(model.fused_slice_kernel, "crdr_throughput.yaml must enable K1")
    return model


RATE, BETA = 2.0, 2.56


def round_trip(model, imgs):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encs = model.compress_batch(imgs, rate_ind=RATE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dec = model.decompress_batch([e["string_list"] for e in encs], beta=BETA)
    torch.cuda.synchronize()
    return encs, dec, t1 - t0, time.perf_counter() - t1


def counted_round_trip(model, imgs):
    """One batch round trip with every kernel's launch count set to 0 just
    before it; returns (encs, decoded, enc s, dec s, {kernel: launches})."""
    from crdr_tpu_torch.ops.gdn import gdn
    from crdr_tpu_torch.ops.lane_decode import lane_decode_round
    from crdr_tpu_torch.ops.slice_transform import slice_transform

    kernels = {"slice_transform": slice_transform,
               "lane_decode_round": lane_decode_round, "gdn": gdn}
    for k in kernels.values():
        k.launches = 0
    out = round_trip(model, imgs)
    return out + ({n: k.launches for n, k in kernels.items()},)


def check_round_trip(label, encs, fake, y_hat) -> None:
    y_enc = np.concatenate([e["y_hat"] for e in encs])
    check(np.array_equal(y_hat, y_enc), f"{label}: decoded y_hat != encoder "
                                        "y_hat")
    check(fake.shape == (N_IMG, IMG_H, IMG_W, 3), f"recon shape {fake.shape}")
    check(np.isfinite(fake).all(), f"{label}: non-finite reconstruction")
    check(fake.min() >= -1.0 and fake.max() <= 1.0 and fake.std() > 0,
          f"{label}: reconstruction out of [-1, 1] or constant")
    for i, e in enumerate(encs):
        real = sum(len(s) for s in e["string_list"][1:]) * 8 / (IMG_H * IMG_W)
        pred = e["pred_y_bpp"] + e["pred_z_bpp"]
        print(f"{label} image {i}: real {real:.4f} bpp, predicted "
              f"{pred:.4f} bpp")
        check(abs(real - pred) <= BPP_REL * pred,
              f"{label} image {i}: real bpp {real} vs predicted {pred}")


def timed_runs(model, imgs, label: str, card: str) -> dict:
    """Median encode / decode ms over TIMED_RUNS batch round trips."""
    enc, dec = [], []
    for _ in range(TIMED_RUNS):
        *_, e, d = round_trip(model, imgs)
        enc.append(e * 1e3)
        dec.append(d * 1e3)
    res = {"encode_ms": float(np.median(enc)), "decode_ms":
           float(np.median(dec)), "encode_runs_ms": enc, "decode_runs_ms": dec}
    mpix = N_IMG * IMG_H * IMG_W / 1e6
    print(f"{label} batch {N_IMG} {IMG_W}x{IMG_H}, median of {TIMED_RUNS}: "
          f"encode {res['encode_ms']:.1f} ms, decode {res['decode_ms']:.1f} "
          f"ms, {mpix / (res['encode_ms'] + res['decode_ms']) * 1e3:.4f} "
          f"Mpix/s (encode runs {[round(v, 1) for v in enc]}, decode runs "
          f"{[round(v, 1) for v in dec]}) [{card}]")
    return res


def host_wire_path(model, imgs, label: str, expected: dict, card: str):
    """A model on the compressai wire: kernel counts (``expected``, by
    kernel, per batch round trip), checks, batch-1 equality, times.  A model
    without rates or beta ignores RATE and BETA."""
    import torch

    round_trip(model, imgs)  # warm-up: cuDNN / library initialization
    encs, (fake, _, y_hat), enc_s, dec_s, counts = \
        counted_round_trip(model, imgs)
    check(counts == expected, f"{label}: kernel launches in one batch round "
                              f"trip {counts} (expected {expected})")
    check_round_trip(label, encs, fake, y_hat)
    dec_timing = model.last_decode_timing  # of the batch decode

    # batch 1 is a new shape for the decode's cuDNN calls: warm it up first
    model.decompress(model.compress(imgs[:1], rate_ind=RATE)["string_list"],
                     beta=BETA)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc1 = model.compress(imgs[:1], rate_ind=RATE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, _, y0 = model.decompress(encs[0]["string_list"], beta=BETA)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(np.array_equal(y0, encs[0]["y_hat"]),
          f"{label}: batch-1 decode of stream 0 != encoder y_hat")
    # the analysis runs at one fixed batch size: an image's stream does not
    # depend on the batch it was encoded in
    check(enc1["string_list"] == encs[0]["string_list"],
          f"{label}: batch-1 encode of image 0 != its batch-4 stream (y_hat "
          f"max |diff| "
          f"{float(np.abs(enc1['y_hat'] - encs[0]['y_hat']).max()):.3e})")
    print(f"{label}: batch-1 encode of image 0 equals its batch-{N_IMG} "
          "stream")
    print(f"{label} batch-1: encode {(t1 - t0) * 1e3:.1f} ms, decode "
          f"{(t2 - t1) * 1e3:.1f} ms; one batch round trip: encode "
          f"{enc_s * 1e3:.1f} ms, decode {dec_s * 1e3:.1f} ms; launches "
          f"{counts} [{card}]")
    print(f"timing of the batch round trip: encode "
          f"{json.dumps(encs[0]['timing'])} decode {json.dumps(dec_timing)}")
    times = timed_runs(model, imgs, label, card)
    return encs, counts, times


def device_wire_path(model, imgs, y_compressai, card: str,
                     label: str = "device wire"):
    """The device wire on the same model: counts, checks, a sync-free decode
    chain, times.  Returns the K2 inputs the warm-up decode recorded."""
    import torch

    from crdr_tpu_torch.models import codec_devicewire
    from crdr_tpu_torch.models.codec import codec_numerics

    model.opt.update(wire_format="device", device_wire_encoder="host")
    model.codec_setup()
    check(model.wire_format == "device", "the device wire is not set")
    real, recorded = codec_devicewire.lane_decode_round, []

    def recorder(*args):  # K2's inputs, as the decode gives them
        recorded.append(tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args))
        return real(*args)

    codec_devicewire.lane_decode_round = recorder
    try:
        round_trip(model, imgs)  # warm-up, and K2's inputs for its phase
    finally:
        codec_devicewire.lane_decode_round = real
    encs, (fake, _, y_hat), enc_s, dec_s, counts = \
        counted_round_trip(model, imgs)
    # K2: 1 z + num_slices y rounds per decode; K1 (when on): 3
    # SliceTransforms a slice, each way
    expected = {"slice_transform": 6 * model.num_slices
                if model.fused_slice_kernel else 0,
                "lane_decode_round": 1 + model.num_slices, "gdn": 0}
    check(counts == expected, f"{label}: kernel launches in one batch "
                              f"round trip {counts} (expected {expected})")
    check(all(e["string_list"][2][:4] == b"CRDW" for e in encs),
          f"{label}: the y streams are not lane containers")
    check_round_trip(label, encs, fake, y_hat)
    check(np.array_equal(y_hat, y_compressai),
          f"{label}: y_hat != the compressai wire's y_hat of the same images")

    # the decode chain enqueues every launch without a host sync
    strings = [e["string_list"] for e in encs]
    with codec_numerics(model._chain_tf32):
        z, y_lanes = model._device_wire_inputs(
            [s[1] for s in strings], [s[2] for s in strings],
            IMG_H // model.model_stride, IMG_W // model.model_stride)
        ri, bt = model._cond_arg(RATE, N_IMG), model._cond_arg(BETA, N_IMG)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            chain = model._charm_device_chain(
                z, y_lanes, IMG_H // model.model_stride,
                IMG_W // model.model_stride, ri, bt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check(np.array_equal(chain[2].cpu().numpy(), y_hat),
          f"{label}: the checked decode chain gave another y_hat")
    print(f"{label}: decode chain (z round, decode_begin, the slice steps "
          "with their K2 rounds, decode_final) enqueued with no host sync "
          "(sync debug mode 'error')")
    print(f"{label} one batch round trip: encode {enc_s * 1e3:.1f} ms, "
          f"decode {dec_s * 1e3:.1f} ms; launches {counts} [{card}]")
    print(f"timing encode {json.dumps(encs[0]['timing'])} decode "
          f"{json.dumps(model.last_decode_timing)}")
    times = timed_runs(model, imgs, label, card)
    return recorded, counts, times


def k2_bound(st, pt_in, pt_out, idx, cdf_len, clock_ghz: float) -> dict:
    """Bytes / operations figures of one K2 round on these inputs (the words
    it consumed, each symbol's binary-search depth over its row)."""
    import torch

    n, m = idx.shape
    k = st.shape[1]
    lens = cdf_len.long()[idx.long()]
    depth = torch.ceil(torch.log2((lens - 1).clamp(min=1).double())).long()
    nbytes = (4 * 2 * n * m                              # idx in, vals out
              + 2 * int((pt_out - pt_in).sum())          # 16-bit words read
              + (8 + 4) * 2 * n * k                      # states, ptrs in/out
              + 4 * int(cdf_len.sum()) + 4 * 2 * cdf_len.numel())
    ops = int((2 * depth + 12).sum())  # search + state update, per symbol
    int32_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                  * INT32_LANES_PER_SM * clock_ghz * 1e9)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / int32_rate
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, int32_rate=int32_rate,
                mean_search_depth=float(depth.double().mean()))


def k2_chain_ms(levels, k: int, loads: int, clock_ghz: float) -> float:
    """A chain estimate of one round: a warp's step waits for its deepest
    lane's ``levels`` (search loads, [N, m]) plus ``loads`` other dependent
    loads, each SMEM_LATENCY_CYCLES; the round waits for its slowest warp."""
    import torch

    n, m = levels.shape
    t_steps, warps = -(-m // k), -(-k // 32)
    d = torch.nn.functional.pad(levels.long(), (0, t_steps * k - m))
    d = torch.nn.functional.pad(d.reshape(n, t_steps, k),
                                (0, warps * 32 - k))
    warp_steps = (d.reshape(n, t_steps, warps, 32).amax(-1) + loads).sum(1)
    return float(warp_steps.max()) * SMEM_LATENCY_CYCLES / clock_ghz * 1e-6


def k2_launch_global(args):
    """One launch of K2's global-table instantiation on a round's inputs,
    past the plan, for its time; the wrapper's launch count does not see
    it."""
    from crdr_tpu_torch.ops.lane_decode import launch_round

    return launch_round(*args, plan={"in_smem": False})


def k2_phase(recorded, rounds: int, card: str, ptxas: dict) -> dict:
    """K2 against its twin on the main path's recorded rounds (z, then the
    y slices), then its times; ``ptxas`` is the lane_decode library's
    ``ptxas_report``."""
    import torch

    from crdr_tpu_torch.ops.device_rans import lane_decode_round_instep
    from crdr_tpu_torch.ops.lane_decode import (lane_decode_round,
                                                lane_decode_round_lookup,
                                                lane_plan, smem_cap)

    def plain(st, pt, words, idx, table, m):
        return lane_decode_round_instep(st, pt, words, idx, table.cdf,
                                        table.cdf_len, table.cdf_off, m)

    check(len(recorded) == rounds, f"recorded {len(recorded)} K2 rounds, "
                                   f"expected {rounds}")
    err = 0
    for r, args in enumerate(recorded):
        got = lane_decode_round(*args)
        again = lane_decode_round(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        for a, b, c, name in zip(got, again, ref,
                                 ("values", "states", "pointers")):
            check(torch.equal(a, b), f"K2 round {r}: two launches differ in "
                                     f"{name}")
            err = max(err, int((a.long() - c.long()).abs().max()))
            check(torch.equal(a, c), f"K2 round {r}: kernel != plain twin in "
                                     f"{name}")
    # the check's power: one flipped word of a lane this round reads
    y, z = recorded[1], recorded[0]  # y slice 0, the z round
    st, pt, words, idx, table, m = y
    _, _, pt_out = lane_decode_round(*y)
    lane = int(torch.argmax((pt_out - pt)[0]))
    bad = words.clone()
    bad[0, lane, int(pt[0, lane])] ^= 0x5A5A
    flipped = lane_decode_round(st, pt, bad, idx, table, m)
    ref = lane_decode_round(*y)
    check(not all(torch.equal(a, b) for a, b in zip(flipped, ref)),
          "K2: a flipped stream word left the output unchanged")
    glob = k2_launch_global(y)
    check(all(torch.equal(a, b) for a, b in zip(glob, ref)),
          "K2: the global-table instantiation != the shared-memory one")

    # the build: every instantiation's registers, no spills
    build = {e: r for e, r in ptxas.items() if "lane_decode_round_kernel" in e}
    check(len(build) == 2 and all(r["registers"] for r in build.values()),
          f"K2's ptxas report: {ptxas}")
    check(not any(r["spill_bytes"] for r in build.values()),
          f"K2 spills registers: {build}")

    def inst(plan):  # the instantiation's mangled-name tail
        return f"ILb{int(plan['in_smem'])}E"

    cap = smem_cap(st.device)
    plan_y = lane_plan(st.shape[1], table.buf.numel(), cap)
    plan_z = lane_plan(z[0].shape[1], z[4].buf.numel(), cap)
    regs = next(r["registers"] for e, r in build.items() if inst(plan_y) in e)
    max_clock = max_sm_clock_ghz()
    ms = graph_time_ms(lambda: lane_decode_round(*y))
    eager_ms = cuda_time_ms(lambda: lane_decode_round(*y), 50, warmup=3)
    z_ms = graph_time_ms(lambda: lane_decode_round(*z))
    z_eager_ms = cuda_time_ms(lambda: lane_decode_round(*z), 50, warmup=3)
    pro_ms = graph_time_ms(lambda: lane_decode_round(*y[:5], 0))
    pro_z_ms = graph_time_ms(lambda: lane_decode_round(*z[:5], 0))
    glob_ms = graph_time_ms(lambda: k2_launch_global(y))
    plain_ms = cuda_time_ms(lambda: plain(*y), 2, 1)
    # cycles a step at the SM clock sampled while the y round runs, else
    # (no sample) at the card's max SM clock, and labelled so
    clock = sm_clock_under_load_ghz(lambda: lane_decode_round(*y))
    clock_src = "sampled under load" if clock else "max SM clock"
    clock = clock or max_clock
    n, k = st.shape
    t_y, t_z = -(-m // k), -(-z[5] // z[0].shape[1])
    cyc = (ms - pro_ms) * 1e-3 * clock * 1e9 / t_y
    cyc_z = (z_ms - pro_z_ms) * 1e-3 * clock * 1e9 / t_z
    bound = k2_bound(st, pt, pt_out, idx, table.cdf_len, max_clock)
    levels = lane_decode_round_lookup(*y, levels=True)[3]
    depth = torch.ceil(torch.log2((table.cdf_len.long()[idx.long()] - 1)
                                  .clamp(min=1).double())).long()
    # v1: the binary search + ~4 dependent loads around it; v2: the bucket
    # search + the lookup and the low / freq loads
    chain_v1 = k2_chain_ms(depth, k, 4, max_clock)
    chain_v2 = k2_chain_ms(levels, k, 2, max_clock)
    print(f"K2 build: registers "
          + ", ".join(f"{e[e.index('ILb'):e.index('ILb') + 5]} "
                      f"{r['registers']}" for e, r in sorted(build.items()))
          + f", no spills; plan y {plan_y}, z {plan_z} [{card}]")
    print(f"K2 y round N{n} K{k} m {m} (table {tuple(table.cdf.shape)}, "
          f"buffer {4 * table.buf.numel()} B): kernel {ms:.4f} ms as a "
          f"CUDA-graph replay (eager {eager_ms:.4f}), prologue (m = 0) "
          f"{pro_ms:.4f} ms, {cyc:.1f} cycles a step over {t_y} steps at "
          f"{clock * 1e3:.0f} MHz ({clock_src}); global-table instantiation "
          f"{glob_ms:.4f} "
          f"ms; plain twin {plain_ms:.4f} ms; bound "
          f"{bound['bound_ms'] * 1e3:.3f} us ({bound['bound_by']}: "
          f"{bound['bytes'] / 1e6:.3f} MB, {bound['ops'] / 1e6:.2f} M int "
          f"ops at {bound['int32_rate'] / 1e12:.2f} T/s INT32); chain "
          f"estimates, not measured, at an ASSUMED {SMEM_LATENCY_CYCLES} "
          f"cycles a dependent load and the max SM clock: v1 "
          f"{chain_v1:.4f} ms (binary depth mean "
          f"{bound['mean_search_depth']:.2f}), v2 {chain_v2:.4f} ms (bucket "
          f"levels mean {float(levels.double().mean()):.4f}) [{card}]")
    print(f"K2 z round N{z[0].shape[0]} K{z[0].shape[1]} m {z[5]} (table "
          f"{tuple(z[4].cdf.shape)}, buffer {4 * z[4].buf.numel()} B): "
          f"kernel {z_ms:.4f} ms (eager {z_eager_ms:.4f}), prologue "
          f"{pro_z_ms:.4f} ms, {cyc_z:.1f} cycles a step over {t_z} steps; "
          f"kernel == twin on all {rounds} rounds, bit-stable, a flipped "
          f"word of lane {lane} changes the output [{card}]")
    return dict(ms=ms, eager_ms=eager_ms, z_ms=z_ms, z_eager_ms=z_eager_ms,
                prologue_ms=pro_ms, prologue_z_ms=pro_z_ms,
                global_table_ms=glob_ms, plain_ms=plain_ms,
                max_abs_err=err, cycles_per_step=cyc,
                cycles_per_step_z=cyc_z, cycles_clock_mhz=clock * 1e3,
                cycles_clock=clock_src, registers=regs,
                spill_bytes=sum(r["spill_bytes"] for r in build.values()),
                smem_bytes=plan_y["smem_bytes"],
                smem_bytes_z=plan_z["smem_bytes"],
                shape=f"N{n} K{k} m {m}, y table {tuple(table.cdf.shape)}",
                **bound)


def k3_phase(card: str, ptxas: dict) -> dict:
    """K3 against its twin at the GDN path's shapes, both directions;
    ``ptxas`` is the gdn library's ``ptxas_report``."""
    import torch

    from crdr_tpu_torch.ops.gdn import gdn, gdn_plain, occupancy

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    clock = max_sm_clock_ghz()
    f32_rate = (torch.cuda.get_device_properties(0).multi_processor_count
                * FP32_FLOPS_PER_SM_CLOCK * clock * 1e9)
    build = {}  # {(C, float4 path): report} of each instantiation
    for entry, r in ptxas.items():
        m = re.search(r"gdn_kernelILi(\d+)ELb([01])E", entry)
        if m:
            build[(int(m.group(1)), m.group(2) == "1")] = r
    check(len(build) == 8 and all(r["registers"] for r in build.values()),
          f"K3's ptxas report: {ptxas}")
    spills = {k: r["spill_bytes"] for k, r in build.items()
              if r["spill_bytes"]}
    check(not spills, f"K3 spills registers: {spills}")
    occ = occupancy(192)
    print("K3 build: registers by (C, float4 path) "
          + ", ".join(f"{c}{'v' if v else 's'} {r['registers']}"
                      for (c, v), r in sorted(build.items()))
          + f"; no spills; at C 192: {occ['blocks_per_sm']} blocks an SM, "
          f"{occ['tile_pixels']} pixels a block, {occ['smem_bytes']} B of "
          f"shared memory a block [{card}]")

    def excess(out, ref):  # max |out - ref| in units of the tolerance
        return float(((out - ref).abs() / (K3_RTOL * ref.abs() + K3_ATOL))
                     .max())

    rows = []
    for shape in GDN_SHAPES:
        n, c, h, w = shape
        x = torch.randn(shape, device=dev, generator=g)
        beta = torch.empty(c, device=dev).uniform_(0.5, 2.0, generator=g)
        # non-negative and non-symmetric: a transposed read must show
        gamma = torch.empty((c, c), device=dev).uniform_(0.0, 0.1,
                                                         generator=g)
        # yardstick only: cuBLAS's f32 product gamma . x^2 per image
        x2 = (x * x).view(n, c, h * w)
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            lib_ms = graph_time_ms(lambda: torch.matmul(gamma, x2))
            lib_eager_ms = cuda_time_ms(lambda: torch.matmul(gamma, x2), 20,
                                        3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        del x2
        transpose_ms = graph_time_ms(lambda: gamma.t().contiguous())
        for inverse in (False, True):
            tag = f"K3 {list(shape)} {'inverse' if inverse else 'forward'}"
            out = gdn(x, beta, gamma, inverse)
            again = gdn(x, beta, gamma, inverse)
            one = gdn(x[:1].contiguous(), beta, gamma, inverse)
            plain = gdn_plain(x, beta, gamma, inverse)
            torch.cuda.synchronize()
            check(torch.isfinite(out).all(), f"{tag}: non-finite output")
            check(torch.equal(out, again), f"{tag}: two launches differ")
            check(torch.equal(out[:1], one),
                  f"{tag}: image 0 alone != image 0 in the batch of {n}")
            ex = excess(out, plain)
            check(ex <= 1.0, f"{tag}: |kernel - plain| exceeds {K3_RTOL} "
                             f"|plain| + {K3_ATOL} ({ex:.3f}x)")
            # the kernel sums in the twin's order (cuDNN's f32 1x1 conv)
            differing = int((out != plain).sum())
            check(differing == 0, f"{tag}: {differing} elements differ from "
                                  "the twin's bits")
            ex_t = excess(out, gdn_plain(x, beta, gamma.t(), inverse))
            ex_d = excess(out, gdn_plain(x, beta, gamma, not inverse))
            check(min(ex_t, ex_d) > 10,
                  f"{tag}: the check is blind to a transposed gamma "
                  f"({ex_t:.1f}x) or the other direction ({ex_d:.1f}x)")
            diff = (out - plain).abs()
            big = plain.abs() >= 1e-3
            row = dict(shape=list(shape), inverse=inverse, excess=ex,
                       differing=differing, max_abs_err=float(diff.max()),
                       max_rel_err=float((diff[big] / plain.abs()[big])
                                         .max()),
                       library_ms=lib_ms, library_eager_ms=lib_eager_ms,
                       transpose_ms=transpose_ms)
            # device time per call (CUDA graph; the gamma^T copy inside),
            # and the eager call's time with the host's enqueue in it
            row["ms"] = graph_time_ms(lambda: gdn(x, beta, gamma, inverse))
            row["eager_ms"] = cuda_time_ms(
                lambda: gdn(x, beta, gamma, inverse), 20, 3)
            row["plain_ms"] = cuda_time_ms(
                lambda: gdn_plain(x, beta, gamma, inverse), 10, 2)
            m = n * h * w
            flops = 2.0 * m * c * c + 4.0 * m * c  # product + epilogue
            nbytes = 4 * (2 * m * c + c * c + c)
            t_ops, t_bytes = flops / f32_rate, nbytes / H100_BYTES_PER_S
            tiles = -(-h * w // occ["tile_pixels"]) * n
            row.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       gflop=flops / 1e9, mbytes=nbytes / 1e6, blocks=tiles)
            rows.append(row)
            print(f"{tag}: kernel {row['ms']:.4f} ms ("
                  f"{flops / row['ms'] / 1e9:.1f} TFLOP/s; eager, host "
                  f"enqueue included, {row['eager_ms']:.4f} ms; gamma^T copy "
                  f"{transpose_ms:.4f} ms of it), {tiles} blocks, plain "
                  f"{row['plain_ms']:.4f} ms, cuBLAS f32 product "
                  f"{lib_ms:.4f} ms (eager {lib_eager_ms:.4f}), bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
                  f"{flops / 1e9:.2f} GFLOP at {f32_rate / 1e12:.2f} TFLOP/s "
                  f"f32, {nbytes / 1e6:.1f} MB); {differing} elements differ "
                  f"from the twin, max|err| {row['max_abs_err']:.3e} "
                  f"({ex:.3f}x the tolerance; transposed gamma {ex_t:.0f}x, "
                  f"other direction {ex_d:.0f}x); bit-stable across calls "
                  f"and batch 1 vs {n} [{card}]")
        del x
    total = sum(r["ms"] for r in rows)
    eager = sum(r["eager_ms"] for r in rows)
    bound = sum(r["bound_ms"] for r in rows)
    print(f"K3, the six calls of a GDN round trip: {total:.4f} ms (graph "
          f"replays; eager {eager:.4f} ms) against a bound of {bound:.4f} ms "
          f"[{card}]")
    r192 = build[(192, True)]
    return {"rows": rows, "registers": r192["registers"],
            "spill_bytes": sum(r["spill_bytes"] for r in build.values()),
            **occ}


def subpixel_weights(wt):
    """A 5x5 stride-2 ConvTranspose2d's weight [Cin, Cout, 5, 5] (padding
    2, output padding 1) as one stride-1 3x3 conv's [4 Cout, Cin, 3, 3]:
    the four output phases (a, b) stacked in pixel_shuffle's channel order,
    phase (a, b) at tap (ty, tx) taking w[4 - 2 ty + a, 4 - 2 tx + b]."""
    cin, cout = wt.shape[:2]
    w4 = wt.new_zeros(cout, 2, 2, cin, 3, 3)
    for a in (0, 1):
        for b in (0, 1):
            for ty in range(3):
                for tx in range(3):
                    ky, kx = 4 - 2 * ty + a, 4 - 2 * tx + b
                    if ky <= 4 and kx <= 4:
                        w4[:, a, b, :, ty, tx] = wt[:, :, ky, kx].t()
    return w4.reshape(4 * cout, cin, 3, 3).contiguous()


def deconv_phase(model, card: str) -> list:
    """A yardstick only (the port's synthesis is unchanged): one
    ConvTranspose2d of the Balle18 decoder at two path shapes, as the port
    runs it (cuDNN, codec numerics) and as four stride-1 sub-pixel
    convolutions in one conv plus pixel_shuffle, held within f32 tolerance
    of the first."""
    import torch
    import torch.nn.functional as F

    from crdr_tpu_torch.models.codec import codec_numerics

    g = torch.Generator(device=model.device).manual_seed(17)
    rows = []
    dec = model.net.decoder
    for name, (h, w) in (("conv_2", (IMG_H // 8, IMG_W // 8)),
                         ("conv_4", (IMG_H // 4, IMG_W // 4))):
        conv = getattr(dec, name)
        x = torch.randn((N_IMG, conv.weight.shape[0], h, w),
                        device=model.device, generator=g)
        with codec_numerics():
            w4 = subpixel_weights(conv.weight)
            b4 = conv.bias.repeat_interleave(4)
            ref = conv(x)
            sub = F.pixel_shuffle(F.conv2d(x, w4, b4, padding=1), 2)
            torch.cuda.synchronize()
            err = float((ref - sub).abs().max())
            scale = float(ref.abs().max())
            check(err <= 1e-5 * scale + 1e-6,
                  f"sub-pixel {name}: max|diff| {err:.3e} of {scale:.3e}")
            port_ms = cuda_time_ms(lambda: conv(x), 10, 2)
            sub_ms = cuda_time_ms(lambda: F.pixel_shuffle(
                F.conv2d(x, w4, b4, padding=1), 2), 10, 2)
        rows.append(dict(layer=name, shape=list(x.shape), port_ms=port_ms,
                         subpixel_ms=sub_ms, max_abs_diff=err))
        print(f"GDN synthesis {name} {list(x.shape)} -> "
              f"{list(ref.shape[2:])}: ConvTranspose2d as the port runs it "
              f"{port_ms:.4f} ms, as sub-pixel conv + pixel_shuffle "
              f"{sub_ms:.4f} ms (max|diff| {err:.3e} of |out| <= "
              f"{scale:.3f}); codec numerics, yardstick only [{card}]")
    return rows


def build_gdn_model(imgs, card: str):
    """The GDN path's model: seeded init, then the edits of the module
    doc (phase 7)."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.nn import GDN, NonNegativeParam
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config",
                                        "balle18_mean_scale.yaml"))
    t0 = time.perf_counter()
    model = build_comp_model(cfg)  # the GPU; seeded init (cfg seed / 0)
    net = model.net
    g = torch.Generator(device=model.device).manual_seed(4321)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, GDN):  # about the init's weight, spread out
                c = m.gamma.shape[0]
                m.gamma.copy_(NonNegativeParam().init(torch.empty_like(
                    m.gamma).uniform_(0.0, 2.0 / c, generator=g)))
        # at the random init y sits within a bin of 0; a gain on the last
        # analysis conv spreads it over ~Y_STD bins, and the scale half of
        # the hyper-decoder's bias makes the y tables carry that rate
        x = torch.from_numpy(imgs[:1]).to(model.device)
        x = ((x.float() / 255.0 - 0.5) * 2.0).permute(0, 3, 1, 2)
        gain = Y_STD / float(net.encoder(x.contiguous()).std())
        net.encoder.conv_6.weight.mul_(gain)
        net.encoder.conv_6.bias.mul_(gain)
        half = net.hyperdecoder.c3.bias.numel() // 2
        net.hyperdecoder.c3.bias[half:] += Y_STD
    model.codec_setup()
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in net.parameters())
    print(f"GDN path {cfg.model_type} (Balle18, mean-scale): "
          f"{nparam / 1e6:.1f}M params, analysis gain {gain:.2f}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return model


def encode_ab_phase(model, imgs, card: str, pairs: int = 6) -> None:
    """Where image 0 of a batch-1 and a batch-4 analysis first differ with
    the whole-batch analysis (A), then A against the fixed-batch analysis
    (B), alternating A B B A, on the compressai wire."""
    import torch

    from crdr_tpu_torch.models.codec import _tf32, codec_numerics

    def whole_batch(x, rate_ind):  # A: one analysis call over the batch
        with _tf32(model._transform_tf32):
            return model.net.encode_latents(x, rate_ind, model._enc_t,
                                            model._henc_t)

    def use(variant):  # A shadows the method on the instance; B is the method
        if variant == "A":
            model._analysis = whole_batch
        else:
            model.__dict__.pop("_analysis", None)

    x = torch.from_numpy(imgs).to(model.device)
    mods = [(f"{tag}.{n}", mod) for tag, net in (("encoder", model._enc_t),
                                                 ("hyperencoder",
                                                  model._henc_t))
            for n, mod in net.named_modules() if not list(mod.children())]
    res = {"A": ([], [], []), "B": ([], [], [])}
    try:
        for variant in res:
            use(variant)
            calls = []  # per pass: (layer, image 0's output) in call order
            hooks = [mod.register_forward_hook(
                lambda _m, _i, o, name=name: calls[-1].append(
                    (name, o[:1].float().clone())) if torch.is_tensor(o)
                else None) for name, mod in mods]
            try:
                for xb in (x, x[:1]):
                    calls.append([])
                    with codec_numerics():
                        model.encode_head(xb, model._cond_arg(RATE, len(xb)))
            finally:
                for h in hooks:
                    h.remove()
            first = next(((name, float((a - b).abs().max()))
                          for (name, a), (_, b) in zip(*calls)
                          if not torch.equal(a, b)), None)
            label = "whole batch" if variant == "A" else "fixed batch 4"
            print(f"analysis ({label}): first of {len(calls[0])} layer calls "
                  f"where image 0 differs between a batch-1 and a "
                  f"batch-{N_IMG} call: {first or 'none'} [{card}]")
            check(variant == "A" or first is None,
                  f"fixed-batch analysis: image 0 differs at {first}")

        for variant in res:  # warm both up at both batch sizes
            use(variant)
            model.compress_batch(imgs, rate_ind=RATE)
            model.compress(imgs[:1], rate_ind=RATE)
        for _ in range(pairs):
            for variant in ("A", "B", "B", "A"):
                use(variant)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = model.compress_batch(imgs, rate_ind=RATE)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                one = model.compress(imgs[:1], rate_ind=RATE)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                res[variant][0].append((t1 - t0) * 1e3)
                res[variant][1].append((t2 - t1) * 1e3)
                res[variant][2].append(one["string_list"] ==
                                       batch[0]["string_list"])
    finally:
        use("B")
    for variant, (b4, b1, same) in res.items():
        print(f"encode A/B {variant} ("
              f"{'whole batch' if variant == 'A' else 'fixed batch 4'}), "
              f"{2 * pairs} runs in A B B A order: batch-{N_IMG} median "
              f"{np.median(b4):.1f} ms ({min(b4):.1f}-{max(b4):.1f}), batch-1 "
              f"median {np.median(b1):.1f} ms ({min(b1):.1f}-{max(b1):.1f}); "
              f"batch-1 stream of image 0 == batch-{N_IMG}: {sum(same)} of "
              f"{len(same)} [{card}]")


# the five model configs besides the flagship's (config/_base_/model/)
CLASS_CONFIGS = ("elic_hyperprior", "elic_charm", "interp_ca_elic_hyperprior",
                 "interp_ca_elic_charm", "beta_cond_interp_ca_elic_hyperprior")
# the codec options of config/crdr_throughput.yaml (and crdr.yaml under it)
THROUGHPUT_OPTIONS = ("codec_uint8_io", "transform_precision",
                      "transform_dtype", "fused_slice_kernel",
                      "fused_decode_loop")
TF32_REL = 1e-2      # fastchain vs highest hyper-decoder, max |diff| / max |ref|
BPP_AGREE = 1e-3     # validation (batch 1) vs run_model (batch 4) bpp


def class_model(name: str, card: str):
    """A model config at full width with crdr_throughput.yaml's codec
    options laid over it; seeded init, y scales raised."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.utils.config import Config

    cfg = Config.from_file(os.path.join(ROOT, "config", "_base_", "model",
                                        f"{name}.yaml"))
    served = Config.from_file(os.path.join(ROOT, "config",
                                           "crdr_throughput.yaml"))
    for key in THROUGHPUT_OPTIONS:
        cfg[key] = served[key]
    t0 = time.perf_counter()
    model = build_comp_model(cfg)
    raise_y_scales(model)
    model.codec_setup()
    torch.cuda.synchronize()
    nparam = sum(p.numel() for p in model.net.parameters())
    print(f"{name} ({cfg.model_type}): {nparam / 1e6:.1f}M params, "
          f"fused_slice_kernel={model.fused_slice_kernel}, built in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return model


def model_class_phase(imgs, card: str):
    """Each of CLASS_CONFIGS on the compressai wire (K1 60 a round trip on
    the Charm classes, none on the others), interp_ca_elic_charm also on the
    device wire (K2 11); the checks and times of host_wire_path /
    device_wire_path.  Returns ({path: launches}, {path: times})."""
    import torch

    counts, times = {}, {}
    for name in CLASS_CONFIGS:
        model = class_model(name, card)
        k1 = 6 * model.num_slices if model.use_charm else 0
        encs, counts[name], times[name] = host_wire_path(
            model, imgs, name,
            {"slice_transform": k1, "lane_decode_round": 0, "gdn": 0}, card)
        if name == "interp_ca_elic_charm":
            y_c = np.concatenate([e["y_hat"] for e in encs])
            label = f"{name} device wire"
            _, counts[label], times[label] = device_wire_path(
                model, imgs, y_c, card, label)
        del model, encs
        torch.cuda.empty_cache()
    return counts, times


def tf32_chain_phase(imgs, card: str):
    """config/crdr_fastchain.yaml (codec_precision: default: TF32 in the
    hyper-decoder and, with K1 off, in every Charm conv) on the flagship,
    K1 on and off, each on both wires with the checks of host_wire_path /
    device_wire_path; then, on each wire, the times of crdr_throughput.yaml
    and of both variants in turns (A B C C B A, TIMED_RUNS round trips
    each).  Returns ({path: launches}, {variant: TF32 max |diff|})."""
    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.models.codec import codec_numerics
    from crdr_tpu_torch.utils.config import Config

    counts, diffs, models = {}, {}, {"crdr_throughput": build_model(card)}
    for fused in (True, False):
        cfg = Config.from_file(os.path.join(ROOT, "config",
                                            "crdr_fastchain.yaml"))
        cfg["fused_slice_kernel"] = fused
        model = build_comp_model(cfg)
        raise_y_scales(model)
        model.codec_setup()
        check(model._chain_tf32 and model.fused_slice_kernel == fused,
              "crdr_fastchain.yaml must set codec_precision: default")
        tag = f"fastchain K1 {'on' if fused else 'off'}"
        k1 = 6 * model.num_slices if fused else 0
        encs, counts[tag], _ = host_wire_path(
            model, imgs, tag,
            {"slice_transform": k1, "lane_decode_round": 0, "gdn": 0}, card)

        # TF32 really ran: the hyper-decoder on one z_sym, f32 vs TF32
        with codec_numerics(False):
            x = torch.from_numpy(imgs[:1]).to(model.device)
            _, z_sym, _ = model.encode_head(x, model._cond_arg(RATE, 1))
            ref = torch.cat(model._hyper_decode(z_sym)[0], -1)
        with codec_numerics(True):
            tf = torch.cat(model._hyper_decode(z_sym)[0], -1)
        diff = float((tf - ref).abs().max())
        scale = float(ref.abs().max())
        diffs[tag] = diff
        print(f"{tag}: hyper-decoder output under TF32 vs f32 on one z: "
              f"max |diff| {diff:.3e} of max |out| {scale:.3f} "
              f"({diff / scale:.2e} relative) [{card}]")
        check(0 < diff <= TF32_REL * scale,
              f"{tag}: TF32 changed the hyper-decoder by {diff} (must be > 0 "
              f"and <= {TF32_REL} x {scale})")

        y_c = np.concatenate([e["y_hat"] for e in encs])
        label = f"{tag} device wire"
        _, counts[label], _ = device_wire_path(model, imgs, y_c, card, label)
        models[tag] = model
        del encs

    mpix = N_IMG * IMG_H * IMG_W / 1e6
    for wire in ("compressai", "device"):
        for model in models.values():
            model.opt.update(wire_format=wire, device_wire_encoder="host")
            model.codec_setup()
        runs = {name: ([], []) for name in models}
        for name in list(models) + list(models)[::-1]:
            t = timed_runs(models[name], imgs, f"{name} {wire} wire, in turns",
                           card)
            runs[name][0].extend(t["encode_runs_ms"])
            runs[name][1].extend(t["decode_runs_ms"])
        for name, (enc, dec) in runs.items():
            e, d = float(np.median(enc)), float(np.median(dec))
            print(f"TF32 chain, {wire} wire, batch {N_IMG}, median of "
                  f"{len(enc)} in turns (A B C C B A): {name}: encode "
                  f"{e:.1f} ms, decode {d:.1f} ms, "
                  f"{mpix / (e + d) * 1e3:.4f} Mpix/s (decode runs "
                  f"{[round(v, 1) for v in dec]}) [{card}]")
    del models
    torch.cuda.empty_cache()
    return counts, diffs


def spread_rates(model) -> None:
    """At the random init every InterpCA gain is 1 at every rate, so the
    rate changes nothing; give the encoder's last InterpCA gains 2^q
    (softplus^-1 of them), so y, and with it the bpp, grows with the rate
    (at gains below 1 the init's y rounds to 0 everywhere)."""
    import torch

    ca = model.net.encoder.interp_ca_list[-1]
    with torch.no_grad():
        for q in range(ca.weight.shape[0]):
            gain = torch.tensor(2.0 ** q)
            ca.weight[q] = torch.log(torch.expm1(gain))


def entry_point_phase(imgs, card: str) -> dict:
    """run_model / validation on the flagship at every rate, then the CLI
    as a subprocess on each wire, held against compress_batch /
    decompress_batch.  Returns {path: launches} of the in-process calls."""
    import tempfile

    import torch

    from crdr_tpu_torch.models import build_comp_model
    from crdr_tpu_torch.models.codec import device_uint8_to_tensor
    from crdr_tpu_torch.ops.gdn import gdn
    from crdr_tpu_torch.ops.lane_decode import lane_decode_round
    from crdr_tpu_torch.ops.slice_transform import slice_transform
    from crdr_tpu_torch.utils import codec_utils
    from crdr_tpu_torch.utils.config import Config
    from crdr_tpu_torch.utils.img_utils import (calc_ms_ssim, calc_psnr,
                                                imread, read_png,
                                                tensor_to_uint8,
                                                uint8_to_tensor, write_png)

    cfg_path = os.path.join(ROOT, "config", "crdr_throughput.yaml")
    model = build_comp_model(Config.from_file(cfg_path))
    spread_rates(model)

    # the codec's on-device uint8 conversion (encode_head) is the host's
    # uint8_to_tensor, bit for bit; a CPU-scalar divisor would not be
    # (CUDA divides by one as a multiply by its f32 reciprocal)
    v = torch.arange(256, dtype=torch.uint8, device=model.device)
    host = torch.from_numpy(uint8_to_tensor(np.arange(256, dtype=np.uint8)))
    scalar = ((v.float() / 255.0 - 0.5) * 2.0).cpu()
    exact = device_uint8_to_tensor(v).cpu()
    print(f"uint8 -> f32 on the card: a CPU-scalar divisor differs from the "
          f"host's uint8_to_tensor in {int((scalar != host).sum())} of 256 "
          f"values, the codec's device-tensor divisor in "
          f"{int((exact != host).sum())} [{card}]")
    check(torch.equal(exact, host), "the codec's uint8 conversion is not "
                                    "the host's")
    x = uint8_to_tensor(imgs)
    beta = model.max_beta / 2
    counts = {}
    kernels = {"slice_transform": slice_transform,
               "lane_decode_round": lane_decode_round, "gdn": gdn}
    for k in kernels.values():
        k.launches = 0
    by_rate = []
    for q in range(model.rate_level):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.run_model(x, rate_ind=float(q), beta=beta, is_train=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        psnr = calc_psnr(out["real_images"], out["fake_images"])
        msssim = calc_ms_ssim(out["real_images"], out["fake_images"])
        by_rate.append(out["bpp"])
        print(f"run_model rate {q} beta {beta}: bpp {np.round(out['bpp'], 4)}"
              f" (mean {out['bpp'].mean():.4f}, qbpp "
              f"{out['qbpp'].mean():.4f}), PSNR {psnr:.3f} dB, MS-SSIM "
              f"{msssim:.5f}; {dt * 1e3:.1f} ms for {N_IMG} images [{card}]")
        check(np.isfinite(out["bpp"]).all() and np.isfinite(psnr)
              and np.isfinite(msssim) and 0 < msssim <= 1,
              f"run_model rate {q}: non-finite metrics")
    counts["run_model"] = {n: k.launches for n, k in kernels.items()}
    means = [float(b.mean()) for b in by_rate]
    check(all(a < b for a, b in zip(means, means[1:])),
          f"run_model: bpp does not rise with the rate: {means}")

    t0 = time.perf_counter()
    rows = model.validation([{"real_images": x[i:i + 1]}
                             for i in range(N_IMG)])
    torch.cuda.synchronize()
    print(f"validation: {len(rows)} images x {model.rate_level} rates in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    check(len(rows) == N_IMG, f"validation gave {len(rows)} rows")
    for row in rows:
        print("validation row " + json.dumps(
            {k: round(v, 5) for k, v in row.items()}))
        for q in range(model.rate_level):
            bpp = row[f"bpp_{q + 1}"]
            check(np.isfinite([bpp, row[f"psnr_{q + 1}"],
                               row[f"ms_ssim_{q + 1}"]]).all(),
                  f"validation row {row['idx']}: non-finite metrics")
            want = float(by_rate[q][row["idx"] - 1])
            check(abs(bpp - want) <= BPP_AGREE * want,
                  f"validation bpp_{q + 1} of image {row['idx']}: {bpp} vs "
                  f"run_model's {want}")
    del model
    torch.cuda.empty_cache()

    # the CLI, as a user runs it: crdr_throughput.yaml, seeded init
    model = build_comp_model(Config.from_file(cfg_path))
    model.codec_setup()
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        img_dir = os.path.join(tmp, "img")
        names = [f"img{i}" for i in range(N_IMG)]
        for name, img in zip(names, imgs):
            write_png(os.path.join(img_dir, f"{name}.png"), img)
        for wire in ("compressai", "device"):
            if wire == "device":
                model.opt.update(wire_format="device",
                                 device_wire_encoder="host")
                model.codec_setup()
            out = os.path.join(tmp, wire)
            cmd = [sys.executable, "-m", "crdr_tpu_torch.cli.compress",
                   "config/crdr_throughput.yaml", "--img_dir", img_dir,
                   "--save_dir", out, "-q", str(RATE), "-b", str(BETA),
                   "--decompress", "--batch", str(N_IMG)]
            if wire == "device":
                cmd += ["--wire", "device"]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=600)
            dt = time.perf_counter() - t0
            check(proc.returncode == 0, f"the CLI ({wire}) exited "
                  f"{proc.returncode}:\n{proc.stdout[-3000:]}"
                  f"{proc.stderr[-3000:]}")
            print(f"CLI {wire} wire: {' '.join(cmd[1:])} ran in {dt:.1f} s "
                  f"(process start, model build and codec setup included) "
                  f"[{card}]")
            with open(os.path.join(out, "_bitrates.csv")) as f:
                print(f.read().strip())
            floats = np.stack([imread(os.path.join(img_dir, f"{n}.png"))
                               for n in names])
            for k in kernels.values():
                k.launches = 0
            encs = model.compress_batch(floats, rate_ind=RATE)
            fake, _, _ = model.decompress_batch(
                [e["string_list"] for e in encs], beta=BETA)
            counts[f"cli check {wire}"] = {n: k.launches
                                           for n, k in kernels.items()}
            check(all(e["string_list"] == u["string_list"] for e, u in
                      zip(encs, model.compress_batch(imgs, rate_ind=RATE))),
                  f"{wire}: the float and the uint8 input give other streams")
            real = []
            for name, enc, img in zip(names, encs, fake):
                got = codec_utils.load_byte_strings(
                    os.path.join(out, f"{name}.bin"))
                check(got == enc["string_list"],
                      f"CLI {wire}: {name}.bin != compress_batch's streams")
                size = len(codec_utils.pack_byte_strings(enc["string_list"]))
                real.append(size * 8 / (IMG_H * IMG_W))
                check(np.array_equal(read_png(os.path.join(
                    out, f"{name}.png")), tensor_to_uint8(img)),
                    f"CLI {wire}: {name}.png != decompress_batch's image")
            with open(os.path.join(out, "_avg_bitrate.json")) as f:
                avg = json.load(f)["avg_bpp"]
            check(avg == float(np.mean(real)), f"CLI {wire}: avg_bpp {avg} "
                  f"!= compress_batch's mean real bpp {np.mean(real)}")
            print(f"CLI {wire} wire: {N_IMG} .bin equal to compress_batch's "
                  f"streams, {N_IMG} .png equal to decompress_batch's "
                  f"images, avg_bpp {avg:.6f} == their mean real bpp")
    del model
    torch.cuda.empty_cache()
    return counts


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA GPU: the port's smoke run needs one")
    if not os.path.isdir(os.path.join(ROOT, "crdr_tpu_torch")):
        fail("crdr_tpu_torch/ not found: run from the root of a checkout")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    profiling = "--profile" in sys.argv[1:]

    card = card_line()
    print(f"card: {card}")
    ptxas = build_kernels()
    k1 = k1_phase(card)
    k1_split_phase(card)
    model = build_model(card)
    imgs = smooth_images(7)
    if "--ab-encode" in sys.argv[1:]:
        encode_ab_phase(model, imgs, card)
    encs_c, counts_c, times_c = host_wire_path(
        model, imgs, "compressai wire",
        {"slice_transform": 6 * model.num_slices,  # 3 a slice, each way
         "lane_decode_round": 0, "gdn": 0}, card)
    if profiling:
        profile_phase(lambda: model.compress_batch(imgs, rate_ind=RATE),
                      f"compressai encode batch {N_IMG}", card, ("k1_",))
        profile_phase(lambda: model.decompress_batch(
            [e["string_list"] for e in encs_c], beta=BETA),
            f"compressai decode batch {N_IMG}", card, ("k1_",))
    y_c = np.concatenate([e["y_hat"] for e in encs_c])
    recorded, counts_d, times_d = device_wire_path(model, imgs, y_c, card)
    if profiling:
        encs_d = model.compress_batch(imgs, rate_ind=RATE)
        profile_phase(lambda: model.decompress_batch(
            [e["string_list"] for e in encs_d], beta=BETA),
            f"device-wire decode batch {N_IMG}", card,
            ("k1_", "lane_decode_round_kernel"))
    k2 = k2_phase(recorded, 1 + model.num_slices, card,
                  ptxas["lane_decode"])
    print(f"both wires, batch {N_IMG}, medians: compressai encode "
          f"{times_c['encode_ms']:.1f} / decode {times_c['decode_ms']:.1f} ms; "
          f"device encode {times_d['encode_ms']:.1f} / decode "
          f"{times_d['decode_ms']:.1f} ms [{card}]")
    del model, recorded
    torch.cuda.empty_cache()

    k3 = k3_phase(card, ptxas["gdn"])
    gdn_model = build_gdn_model(imgs, card)
    encs_g, counts_g, _ = host_wire_path(
        gdn_model, imgs, "GDN path",  # 3 GDN in the analysis, 3 IGDN after
        {"slice_transform": 0, "lane_decode_round": 0, "gdn": 6}, card)
    deconv = deconv_phase(gdn_model, card)
    if profiling:
        profile_phase(lambda: gdn_model.compress_batch(imgs),
                      f"GDN path encode batch {N_IMG}", card,
                      ("gdn_kernel",))
        profile_phase(lambda: gdn_model.decompress_batch(
            [e["string_list"] for e in encs_g]),
            f"GDN path decode batch {N_IMG}", card, ("gdn_kernel",))

    del gdn_model
    torch.cuda.empty_cache()

    counts_m, _ = model_class_phase(imgs, card)
    counts_t, _ = tf32_chain_phase(imgs, card)
    counts_e = entry_point_phase(imgs, card)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    r = k1["by_cin"][480]
    k3r = k3["rows"]
    launches = {"compressai": counts_c, "device": counts_d, "gdn": counts_g,
                **counts_m, **counts_t, **counts_e}
    print(json.dumps({"kernels": [{
        "name": "slice_transform", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/slice_transform.cu",
        "replaces": "crdr_tpu/ops/pallas_slice_transform.py:75",
        "launches": counts_d["slice_transform"],
        "launches_by_path": {p: c["slice_transform"]
                             for p, c in launches.items()},
        "max_abs_err": max(x["max_abs_err"] for x in k1["by_cin"].values()),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "ms_batch1": r["ms_batch1"], "eager_ms": r["eager_ms"],
        "ms_by_stage": r["ms_by_stage"],
        "ms_by_stage_batch1": r["ms_by_stage_batch1"],
        "hgmma": k1["sass"]["HGMMA"], "hmma": k1["sass"]["HMMA"],
        "ms_cin512": k1["by_cin"][512]["ms"],
        "library_ms_cin512": k1["by_cin"][512]["library_ms"],
        "shape": f"N{N_IMG} {IMG_H // 16}x{IMG_W // 16} Cin 480->224->128->32",
        "card": card}, {
        "name": "lane_decode_round", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/lane_decode.cu",
        "replaces": "crdr_tpu/ops/pallas_lane_decode.py:116",
        "launches": counts_d["lane_decode_round"],
        "launches_by_path": {p: c["lane_decode_round"]
                             for p, c in launches.items()},
        "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
        "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"], "library_ms": None,
        **{key: k2[key] for key in (
            "eager_ms", "z_ms", "z_eager_ms", "prologue_ms", "prologue_z_ms",
            "global_table_ms", "cycles_per_step", "cycles_per_step_z",
            "cycles_clock_mhz", "cycles_clock", "registers", "spill_bytes",
            "smem_bytes", "smem_bytes_z", "shape")},
        "card": card}, {
        "name": "gdn", "route": "cuda",
        "source": "crdr_tpu_torch/csrc/gdn.cu",
        "replaces": "crdr_tpu/ops/pallas_gdn.py:37",
        "launches": counts_g["gdn"],
        "launches_by_path": {p: c["gdn"] for p, c in launches.items()},
        "max_abs_err": max(x["max_abs_err"] for x in k3r),
        "max_rel_err": max(x["max_rel_err"] for x in k3r),
        "differing": sum(x["differing"] for x in k3r),
        "ms": k3r[0]["ms"],
        "eager_ms": k3r[0]["eager_ms"], "plain_ms": k3r[0]["plain_ms"],
        "bound_ms": k3r[0]["bound_ms"], "bound_by": k3r[0]["bound_by"],
        "library_ms": k3r[0]["library_ms"],
        "transpose_ms": k3r[0]["transpose_ms"],
        "registers": k3["registers"], "spill_bytes": k3["spill_bytes"],
        "blocks_per_sm": k3["blocks_per_sm"],
        "tile_pixels": k3["tile_pixels"],
        "ms_by_call": {f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
                       x["ms"] for x in k3r},
        "eager_ms_by_call": {
            f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
            x["eager_ms"] for x in k3r},
        "bound_ms_by_call": {
            f"{x['shape']} {'igdn' if x['inverse'] else 'gdn'}":
            x["bound_ms"] for x in k3r},
        "library_ms_by_shape": {str(x["shape"]): x["library_ms"]
                                for x in k3r},
        "shape": f"{list(GDN_SHAPES[0])} NCHW f32 (ms: CUDA-graph replay, "
                 "gamma^T copy included; bound, plain, library); all six "
                 "path calls in ms_by_call",
        "deconv_yardstick": deconv,
        "card": card}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
