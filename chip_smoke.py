#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`xlstm_hved_torch`) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one line when it finishes (any failure exits non-zero;
no phase catches its own failure and nothing falls back to the CPU or to a
plain twin):
 1. device   the card's name and power limit from nvidia-smi; TF32 off
 2. build    every CUDA source of the port (mlstm_fwd.cu with its states
             variant, mlstm_bwd.cu, both including mlstm_wide.cuh), one
             nvcc each, all started together;
             ptxas's registers, shared memory and spills for each CUDA kernel
 3. kernel   each kernel (mlstm_fwd, mlstm_fwd_states, mlstm_bwd; one call of
             each is three CUDA launches, seven for mlstm_bwd on the wide
             path; on the narrow path (DH <= 16) the rows walked in groups
             of four by eight lanes, the scans one warp per 32 elements of
             a head's carry, the backward's carried dm in its columns
             launch) against its plain PyTorch twin at the shapes the main
             paths give it, with the true length S as the wrappers take it
             (the cotangent zero past S, as mlstm_backward pads it), and on
             the edge cases (one chunk, padding, extreme gates, the e^{-m}
             branch, DH 8, more blocks than one wave), at the ViL decoder's
             DH 8, S 32768 and 49152 (256 and 384 chunks in one scan), at
             the xLSTM families' head widths on the wide path (phase 11's
             shapes: DH 32 to 384, odd widths DH 15 and 45 zero-padded, one
             chunk with S < L) and at the wide path's edges (a last chunk's
             true rows ending inside a row tile, one chunk of 65 rows, DH
             512, B*NH 1 at DH 384, the e^{-m} branch at DH 384), at the gate
             regimes trained weights reach (an igate ramp 0..200 inside
             every chunk, a stabiliser below -60, igate +150 then
             underflow, a padded tail ending inside a chunk; at DH 16 S
             4096, DH 8 S 32768, DH 128),
             with the
             wide plan's blocks per launch (the narrow walk's most keys a
             lane) and its time beside the twin's and its bound, the narrow
             kernels' device us per CUDA launch (torch.profiler) at the
             timed narrow cases; mlstm_fwd's h bitwise equal to
             mlstm_fwd_states'; then the
             differentiable wrapper's h and five gradients against the plain
             chunkwise scan and its autograd at S 2000 and 6144 (the twins
             follow the kernels' phases; the scan is independent of them)
 4. forward  the flagship XLSTM_HVED seg+recon forward at full width (f_maps 4,
             4 levels, fp32, seeded random weights) at 128^3 and 128x192x128:
             finite, seg in [0, 1], one mLSTM kernel launch per forward, and
             equal within bounds to the same forward through the plain mLSTM;
             the same for the ViL-decoder preset U_HVEDConvXLSTMNet3D (its one
             ViL in seg decoder stage 0 at S 32768 / 49152, DH 8)
 5. requests the inference path as a user drives it: a 15-subset sliding-
             window sweep with recon over one 128x192x128 volume, patch 128^3
             (2 windows x 15 subsets); kernel launch counts are read around it
 6. train    the training path as a user drives it: the flagship G and
             Discriminator(f_maps 64, kernel 4) with the TrainConfig defaults
             (crop 128x192x128, batch 1, Adam lr 1e-4 + L2 1e-5, alpha 0.1,
             beta 0.2), init "reference", on a seeded synthetic volume and
             nested 3-channel mask. The G gradients through the kernels
             against the same call through the plain mLSTM; then 1 warm-up
             and 3 timed train steps: finite losses, G, D and the BatchNorm
             running statistics move, and exactly 2 mlstm_fwd, 2
             mlstm_fwd_states and 2 mlstm_bwd launches per step; the same
             step's time at 128^3
 7. cli      the training entry points as a user runs them, in-process
             through their main(argv) on --device cuda at the CLI defaults
             (crop 128x192x128, f_maps 4, Discriminator(64, 4), G and D in
             bf16 as the JAX CLIs default to), on a
             synthetic BraTS-layout dataset written by the port (2 training
             and 1 validation subject of 240x240x155, decoded by the native
             decoder, the datasets' default on a host with more than one
             core): cli.check --decode;
             cli.pretrain one epoch (the seg decoders bitwise frozen, the
             BatchNorm statistics unchanged, 1 mlstm_fwd, 1 mlstm_fwd_states
             and 1 mlstm_bwd per step, 2 mlstm_fwd per validation item);
             cli.train one epoch from the pretrain weights (the surgery's
             counts as the name/shape rule gives them, 2/2/2 launches per
             step); the same command with --num_epochs 2 and --remat
             resumes and runs epoch 2 only, with the same launches. Seconds
             per epoch and per step, the host's share of a step (loader
             waits and batch assembly) and peak memory
 8. eval     the evaluation entry point as a user runs it, in phase 7's
             directory: cli.test.main on --device cuda at the CLI defaults
             (crop 128x192x128, patch = stride = crop) against phase 7's
             best_dice checkpoint with --compute_hd95 --eval_recon
             --save_pred_dir --save_plots_dir: the restored checkpoint, 15
             subset lines and the average, finite metrics, one label volume
             in {0, 1, 2, 4} equal to the labels of the sweep run again,
             3 PNGs, 15 mlstm_fwd launches per volume (the labels against
             the sweep run again at the CLI's bf16); the volume's seconds
             split into spans and the host's share. Then the hoisted sweep
             against the plain one on a seeded 128x192x128 volume for
             XLSTM_HVED (level-0 hoist) and U_HVEDConvXLSTMNet3D (every level
             hoisted): max|d| of seg and recon, seconds (plain, hoisted,
             hoisted, plain) and peak memory
 9. precision the JAX precision policy and remat for the flagship at full
             width, on its own generator: the bf16 forward at 128^3 and
             128x192x128 against the fp32 forward on the same weights (the
             JAX-initialised weights of the goldens): ms and peak memory,
             mean, 99.9th-percentile and max |d| of seg and recon, one
             mlstm_fwd launch on fp32 inputs; the bf16 G gradient at 16^3
             against JAX's bf16 G gradient on the same weights and input
             (tests/torch_precision_ref.npz); the bf16 G+D step at
             128x192x128 (G and D bf16): ms, peak memory, the G gradient's
             relative L2 against the fp32 one, and one profiled step's
             device time and its grouped-conv weight-gradient share; the
             step with remat in fp32 and bf16: ms, peak memory, gradients
             against the step without remat (bitwise with the upsampling's
             backward made deterministic; on the model's own path within
             the run-to-run noise of 4 plain runs), 2/2/2 launches per step
 10. zoo     the two presets without a ViL, U_HVEDNet3D (ext-resnet) and
             FusionUNet3D (the fusion arm), at full width (f_maps 4, 4 levels,
             seeded weights): fp32 and bf16 forwards at 128^3 and
             128x192x128 (finite, seg in [0, 1], no mLSTM launch, ms and peak
             memory, bf16 against fp32: mean, 99.9th percentile and max |d|)
             and the fp32 forward at 64^3 against an fp64 copy on the card
             (phase 4's bounds); the 15-subset sweep of a 128x192x128 volume,
             patch 128^3: U_HVEDNet3D's hoisted sweep bit for bit its plain
             one (every level hoisted; plain, hoisted, hoisted, plain), and
             FusionUNet3D's plain sweep with subset_chunk 5, seconds and
             peak; the U_HVEDNet3D G+D step at 128x192x128 at the bf16
             defaults (Discriminator(64, 4)): finite losses, G and D move, ms
             and peak, and with remat its G gradient bit for bit the one
             without (phase 9's deterministic upsampling) with its peak;
             FusionUNet3D's step raises the JAX step's error (no KL term to
             average); cli.train --model_name U_HVEDNet3D one epoch on phase
             7's dataset, then cli.test on its best_dice checkpoint with
             --compute_hd95; the native NIfTI decoder on phase 7's
             240x240x155 files, bit for bit the Python reader, and both
             readers' seconds per subject, with phase 7's loader wait at the
             native default (phase 7's datasets decode natively: the host has
             more than one core); find_maximum_patch_size for the flagship
             forward, its shape and seconds
 11. xlstm   the xLSTM model families at full width, fp32, seeded weights,
             each forward through the kernels against the same forward
             through the plain mLSTM (phase 4's bound on every output),
             finite, with one mlstm_fwd launch per ViL layer, its ms and peak
             memory: UXlstmEnc and UXlstmBot from build_uxlstm_from_plans on
             the 3-D plans (patch 128^3, 6 stages, 32...320 features; ViLs at
             S 4096 DH 128, S 512 DH 160, channel tokens S 320 DH 32, the
             bottleneck S 64 DH 160) and the 2-D plans (192x160, 7 stages,
             32...512, the last pool [2, 1]; ViLs at S 1920 DH 64, channel
             tokens S 512 DH 60 and DH 15, the bottleneck S 15 DH 256), 4
             channels, 4 classes, deep supervision, batch 2;
             VisionLSTM (224^2, patch 16, dim 192, depth 12: S 196 DH 96),
             VisionLSTM3D (128^3, patch 8: S 4096 DH 96), ViL3DPatchEncoder
             at 128^3 (S 32768 DH 16 to S 64 DH 128), batch 1; U_HeMIS at
             128^3 from the registry (no mLSTM; a zeroed modality inferred
             equals the keep mask given). Then one UXlstmEnc 3-D backward at
             batch 2 of a seeded weighted sum of its outputs through the
             kernels against the plain mLSTM's, per tensor to phase 6's rule
             (cuDNN deterministic), 3 / 3 / 3 launches, ms and peak
 12. import  the upstream .pth import, on its own generator, cuDNN
             deterministic: the flagship (f_maps 4, fp32, seeded weights
             and BatchNorm statistics) and its Discriminator(64, 4) written
             under upstream key names (tests/_torch_upstream_names.py) with
             torch.save, as {'model_sd': ...} and as a bare dict, read back
             through load_reference_checkpoint / disc_params_from_torch into
             models seeded otherwise: the 128^3 seg+recon forward bit for bit
             the direct model's with one mlstm_fwd launch, D's output on the
             (seg, recon) pair bit for bit; U_HVEDNet3D, FusionUNet3D,
             U_HeMIS (128^3) and the 3-D UXlstmEnc of phase 11's plan (batch
             2, 128^3, 3 mlstm_fwd launches) through their importers, each
             forward bit for bit its direct twin's. Then the A9 blocks at full
             width, fp32, batch 1, the offset convs seeded to offsets of 1.5
             voxels (standard deviation) so the gather interpolates and
             clamps: DeformConv3d 32->32 at 64^3, ResFormerBlock(deform)
             16->32 at stride 2 from 128^3, AttDeformConv3d 32->32 at 64^3,
             DuRegisterDuSE(32) at 80x80x40, ParallelDecoder and FCNHead on
             16 ch 128^3, 32 ch 64^3, 64 ch 32^3: forward and the gradient of
             a seeded weighted sum finite, the forward against an fp64 copy
             on the card (phase 4's seg bound), ms and peak memory
 13. parallel data parallelism (xlstm_hved_torch/parallel/): cli.train one
             epoch on phase 7's dataset at the CLI defaults, plain, then
             --distributed in this process as the one rank of an env://
             group (NCCL, printed), cuDNN deterministic with phase 9's
             deterministic upsampling: the distributed run's CSV row bit
             for bit the plain run's, 2/2/2 launches per step; in that
             group the bf16
             step at 128x192x128 with and without the mesh (its G and D
             gradient all-reduce; plain, group, group, plain) and the
             gradient bytes all-reduced per step. Then the fp32 G+D step at
             128^3 on two ranks at batch 1 (two child processes of this
             script on this card, gloo: NCCL refuses two ranks on one
             device) against this process at batch 2 on the same weights
             and input, cuDNN deterministic: the G and D gradients (Adam's
             first moment after the first step) to phase 6's rule, loss and
             loss_d within 1e-5, the BatchNorm running statistics within
             1e-6, the ranks equal to each other, 2/2/2 launches per rank;
             the ranks' step time beside one rank's at batch 1; the sharded
             15-subset sweep of a 128x192x128 volume over the two ranks
             against the hoisted sweep (phase 4's bounds), seconds each
 14. protocol the full training protocol's driver as a user runs it:
             scripts/torch_full_scale_run.py --quick --subprocess
             --epoch_chunk 1 --compute_hd95 on the card in a temporary
             --out_root (32x48x32 volumes, crop 16x32x16, 4+2 subjects,
             1+2 epochs, Discriminator(64, 3), bf16, remat), each phase a
             process of its own: pretrain, the finetune's two one-epoch
             chunks (the second resumes from the first's latest), the
             15-subset sweep; every phase's rc 0, the finetune CSV one row
             per epoch, every CSV value finite, 15 finite subset rows, each
             mLSTM kernel launched in those processes and the plain scan
             never called (utils/phase_report.py), the phase lines (seconds,
             peak device memory, peak host RSS, launches) and the seconds
 15. chain   the protocol's chain over K steps (tests/_torch_chain.py's
             `run_chain`: the pretrain
             net, 6 pretrain steps with the seg decoders frozen, the surgery
             into the flagship, 6 G+D steps with Discriminator(8, 3), one
             evaluation step) at the JAX r5 recipe's crop 64x96x64 (ViL S
             768) and full width, from JAX's create_train_state draws
             (tests/torch_protocol_ref.npz) with the pinned subsets, latents
             and drop of tests/test_torch_protocol_parity.py, in three arms:
             fp32 through the kernels, fp32 through the plain scan
             (mlstm_kernel=False), the CLIs' bf16 defaults through the
             kernels, each the same bits run after run (cuDNN
             deterministic, phase 9's deterministic upsampling). Per step
             the loss terms, after each phase the updates,
             Adam's moments and the BatchNorm statistics' movement: the
             kernel arm against the plain arm and against the port's CPU
             chain (stored) to the chain bounds (CHAIN_*), bf16 against fp32
             to twice the larger of JAX's and the port's own bf16-vs-fp32
             distance on the same chain on the CPU (`bf16_bounds`);
             each kernel launched every step of the kernel arms (1 / 1 / 1 a
             pretrain step, 2 / 2 / 2 a G+D step), none and one plain-scan
             call a forward in the plain arm
Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.

Bounds:
- mlstm_fwd and mlstm_fwd_states against their twins: max|d| / max|ref| <=
  2e-5 and max|d| <= 5e-4 for h, and the scaled bound for the entry states
  (fp32 sums taken in another order; the normaliser lets |h| reach tens: on
  an H100 80GB HBM3 at 700 W the forward measured 1.2e-6 to 2.9e-6 scaled
  and up to 9.9e-5 absolute); the entry offsets m* are bitwise equal (the
  same fp32 operations), and so are the h of the two kernels (the same
  launches). The wrapper's h against the plain chunkwise scan: the same
  two bounds on h.
- mlstm_bwd against its twin: max|d| / max|ref| <= 1e-4 for each of dq, dk,
  dv, ds and dax (the adjoint sums run over up to 48 chunks in another
  order than the twin's batched products).
- the gate-regime cases (phase 3) hold the same bounds. Two of their
  inputs are chosen so that the fp32 twin itself is a reference there:
  the igate ramp's queries and keys are positive (with the ramp the
  normaliser's floor e^{-m} vanishes, m ~ 200, and where q.n* crosses 0
  the fp32 twin lies up to 8.5e-2 (scaled) from its fp64 run with signed
  q and k; 3e-6 with positive ones); and under underflow, where the floor
  vanishes too and h does not depend on the stabilisers, dax's exact
  value is 0 (the fp64 twin gives 1e-5 of rounding against a largest ds
  of 70), so dax is held at 1e-4 of the larger of max|dax| and max|ds|,
  the scale of the gate gradients whose rounding it carries.
- the wrapper's gradients against autograd through the plain scan: max|d| /
  max|ref| < 1e-3, the JAX package's own on-chip criterion for its fused
  backward.
- the whole forward with the kernel against the forward through the plain
  mLSTM: seg max|d| <= 1e-3 and recon max|d| <= 3.5e-3 (the graph's stacked
  InstanceNorms amplify the kernel's fp32 rounding, the same budget the CPU
  tests give the port against the JAX model). The same bounds hold the
  hoisted sweep against the plain one (on the CPU they agree bit for bit).
- the G gradients through the kernels against those through the plain
  mLSTM, with cuDNN set deterministic for that comparison: per tensor
  max|d| <= 1.5e-2 * max|ref| + 9e-4 * (the largest gradient of the
  network). The two paths differ in the mLSTM's backward formulation (the
  fused adjoint holds the stabilisers constant, autograd through the plain
  scan differentiates its max(); they agree up to the O(eps / denominator)
  term the JAX package documents) and in fp32 order, and the network's
  stacked InstanceNorms amplify that. scripts/torch_grad_margin.py settled
  what sets the margin: on 10 seeded inputs at 128^3 (an H100 80GB HBM3 at
  700 W) neither fp32 path lies farther than the other from an fp64 run of
  the plain path (all tensors at once, relative L2 7e-3 to 3.4e-2 for
  both, within 10 % of each other on every seed; the kernel path the
  farther on 59 to 118 of the 209 tensors), while this check's worst
  tensor reached 0.15 to 1.52 of the bound it had then (a third of
  today's; 1.52 on seed 2, where the kernel path was the nearer to fp64).
  The bound is three times that one: twice the worst seen. The floor is for
  the gradients that vanish analytically, or but for an InstanceNorm's eps
  (a conv ahead of an InstanceNorm whose output channel sees one input
  channel, a conv bias or a BatchNorm scale ahead of an InstanceNorm):
  sums of cancelling terms over the whole volume.

Timing: CUDA events, median over repeats after warm-up; a train step is
the host clock around a step that ends in torch.cuda.synchronize(). A
kernel's time ("ms") is one call with the host in it (the wrapper's Python
checks, allocations and ctypes call, then its launches), what a caller
pays; beside it, "device_ms" is the device time of one call: 20 calls
enqueued behind a device-side wait, so that the host's enqueueing is
hidden, over 20. A kernel's bound is the larger of its bytes (inputs read
once, outputs written once) over 3.35 TB/s and its fp32 operations over
67 TFLOP/s (H100 SXM data sheet).
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
KERNEL_SCALED, KERNEL_ATOL = 2e-5, 5e-4
BWD_SCALED = 1e-4
FUNCTION_SCALED = 1e-3
SEG_ATOL, RECON_ATOL = 1e-3, 3.5e-3
GRAD_SCALED, GRAD_FLOOR = 1.5e-2, 9e-4
CROPS = ((128, 128, 128), (128, 192, 128))
SOURCE_ROOT = "xlstm_hved_torch/csrc"
REPLACES = "xlstm_hved_tpu/ops/mlstm_pallas.py"
SLEEP_CYCLES = 50_000_000  # the device-side wait of device_ms, about 25 ms


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def done(phase: str, t0: float, detail: str):
    print(f"[{phase}] ok {time.perf_counter() - t0:.1f}s {detail}", flush=True)


def cuda_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median CUDA-event time of fn() in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls: int = 20, repeats: int = 5) -> float:
    """Median device time of one fn() in ms: `calls` calls enqueued behind a
    device-side wait (so the device runs them back to back, without waiting
    on the host), timed by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        wait, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t_host = time.perf_counter()
        wait.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host_ms = 1e3 * (time.perf_counter() - t_host)
        end.synchronize()
        if host_ms >= wait.elapsed_time(start):
            fail(f"device_ms: enqueueing took {host_ms:.2f} ms, longer than the device-side "
                 f"wait of {wait.elapsed_time(start):.2f} ms")
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def launch_us(fn, calls: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel that fn launches, in
    the order of their first launch (torch.profiler over `calls` calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for event in prof.events():
        if event.device_type.name == "CUDA":
            key = event.name.replace("(anonymous namespace)::", "").replace("mlstm_wide::", "")
            key = re.sub(r"<\((\w+)\)(\d+)>", r"<\1 \2>", key)  # <(Outer)0> -> <Outer 0>
            key = key.replace("void ", "").split("(")[0]
            times[key] = times.get(key, 0.0) + event.device_time / calls
    return times


def ptxas_report(log: str):
    """One line per CUDA kernel from nvcc's -Xptxas -v log: its short name,
    registers, shared memory, stack frame and spills."""
    lines, name, frame = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            # narrow kernels carry their DH, the wide ones their mode
            m = re.search(r"((?:mlstm|wide)_[a-z_]+?_kernel)(?:ILi(\d+)E|ILN\w*?E(\d+)E)?",
                          line)
            arg = m and (m.group(2) or m.group(3))
            name = (f"{m.group(1)}<{arg}>" if arg else m.group(1)) if m else line.split("'")[1]
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {frame}")
            name, frame = None, ""
    return lines


def chunk_rows(S: int, L: int):
    """The rows of each chunk of a sequence of S tokens in chunks of L: whole
    chunks, then the last one's true rows (the padding past S does no work)."""
    return [L] * (S // L) + ([S % L] if S % L else [])


def mlstm_cost(BH: int, S: int, DH: int, L: int, states: bool = False):
    """(bytes, fp32 operations) the chunkwise forward needs at the true
    sequence length S and head width DH: q, k, v, a, s, cm read once, out
    written once (and, with `states`, each chunk's entry C*, n*, m*); per
    chunk of r rows the causal r(r+1)/2 pairs cost a q.k dot, a decay exp and
    a weighted v row, plus the q.C* readout and the C*/n* update."""
    rows = chunk_rows(S, L)
    nbytes = 4 * (3 * BH * S * DH + 3 * BH * S + BH * S * DH)
    if states:
        nbytes += 4 * BH * len(rows) * (DH * DH + DH + 1)
    ops = sum(r * (r + 1) // 2 * (2 * DH + 4 + 2 * DH)     # q.k, decay, attn*v, rowsum
              + 2 * r * DH * DH + 2 * r * DH               # q.C*, q.n*
              + 2 * r * DH * DH + 3 * r * DH               # C* and n* update
              + 12 * r                                     # per-row stabilisers, denominator
              for r in rows)
    return nbytes, BH * ops


def mlstm_bwd_cost(BH: int, S: int, DH: int, L: int):
    """(bytes, fp32 operations) of the reverse-chunk backward at the true S
    and DH: q, k, v, g, a, s, cm and the entry states read once; dq, dk, dv,
    ds, dax written once. Per chunk of r rows: the readout recomputed once
    (as the forward), then per causal pair dattn = g'.v + drow, dqk, and the
    dq, dk, dv and ds sums; per row the denominator adjoints and the
    readout's C*/n* terms; per key the state-update adjoint; the carry
    update."""
    rows = chunk_rows(S, L)
    nbytes = 4 * (4 * BH * S * DH + 3 * BH * S + BH * len(rows) * (DH * DH + DH + 1)
                  + 3 * BH * S * DH + 2 * BH * S)
    ops = sum(r * (r + 1) // 2 * (4 * DH + 4) + r * (2 * DH * DH + 2 * DH + 12)  # recompute
              + r * (r + 1) // 2 * (8 * DH + 4)             # dattn, dqk, dq/dk/dv/ds sums
              + r * (4 * DH * DH + 9 * DH + 10)             # row adjoints, dC/dn reads
              + r * (4 * DH * DH + 6 * DH + 4)              # state-update adjoint
              + 4 * DH * DH                                 # dm and the carry update
              for r in rows)
    return nbytes, BH * ops


def bound_ms(nbytes: int, flops: int):
    """(least time in ms, what bounds it) at the H100 SXM's peak rates."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scaled_err(out, ref) -> float:
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def mlstm_inputs(gen, dev, B, NH, S, DH, kind):
    """q, k, v, igate, fgate as the main paths give them (realistic gates),
    or an edge case: extreme gates, or a tiny attention mass that makes the
    normaliser's e^{-m} branch live (igate about -8); or one of the gate
    regimes trained weights reach, after tests/test_torch_mlstm.py's cases
    for the plain scan: an igate ramp 0..200 inside every chunk of
    128 (with positive q and k, so that q.n* stays away from 0 where the
    floor e^{-m} vanishes), a stabiliser far below -60, igate +150 on the
    first 16 positions (the later chunks' state terms underflow to 0), the
    last 40 positions as padding (igate -1e30, fgate +1e30, zero keys and
    values)."""
    import torch

    q, k, v = (torch.randn(B, NH, S, DH, generator=gen, device=dev) for _ in range(3))
    ig = 0.5 * torch.randn(B, NH, S, generator=gen, device=dev)
    fg = 3.0 + 3.0 * torch.rand(B, NH, S, generator=gen, device=dev)
    if kind == "extreme":
        ig, fg = 10.0 * ig, fg - 12.0
    elif kind == "denominator":
        ig, fg = 2.0 * ig - 8.0, fg / 3.0
    elif kind == "wide_igate":
        ramp = torch.linspace(0.0, 200.0, 128, device=dev).repeat(-(-S // 128))[:S]
        ig, q, k = ramp.expand(B, NH, S).contiguous(), q.abs(), k.abs()
    elif kind == "deep_forget":
        ig, fg = ig - 100.0, fg - 20.0
    elif kind == "padding_tail":
        ig[..., -40:], fg[..., -40:] = -1e30, 1e30
        k[..., -40:, :], v[..., -40:, :] = 0.0, 0.0
    elif kind == "underflow":
        ig[..., :16] += 150.0
        q, k[..., :16, :] = q.abs(), k[..., :16, :].abs()
    return q, k, v, ig, fg


# the gate regimes trained weights reach, at the flagship's bottleneck
# (S 4096, DH 16), the ViL decoder's DH 8 and the wide path's DH 128; the
# padding ends inside a chunk (S 4000 = 31 chunks and 32 rows, S 32700)
GATE_REGIMES = ("wide_igate", "deep_forget", "underflow", "padding_tail")
GATE_REGIME_CASES = tuple(
    (f"S{S}{tag}_{kind}", B, 4, S, DH, kind)
    for tag, B, DH, full, padded in (("", 1, 16, 4096, 4000), ("_DH8", 1, 8, 32768, 32700),
                                      ("_DH128", 2, 128, 4096, 4000))
    for kind in GATE_REGIMES
    for S in [padded if kind == "padding_tail" else full])


KERNEL_CASES = (("S4096", 1, 4, 4096, 16, "realistic"),
                ("S6144", 1, 4, 6144, 16, "realistic"),
                ("S4000_padded", 1, 4, 4000, 16, "realistic"),
                ("S4096_extreme_gates", 1, 4, 4096, 16, "extreme"),
                ("S4096_denominator", 1, 4, 4096, 16, "denominator"),
                ("S1000_DH8", 2, 4, 1000, 8, "realistic"),
                ("S100_one_chunk", 1, 4, 100, 16, "realistic"),      # L = S = 100
                ("B2_S6144", 2, 4, 6144, 16, "realistic"),          # 384 blocks, > 1 wave
                # the ViL decoder of U_HVEDConvXLSTMNet3D: 32^3 / 32x48x32 stage-0 tokens
                ("S32768_DH8", 1, 4, 32768, 8, "realistic"),
                ("S49152_DH8", 1, 4, 49152, 8, "realistic"),
                # the wide path, at the xLSTM families' widths (phase 11):
                # UXlstmEnc 3-D at batch 2, stages 3 / 4 / 5 (channel tokens)
                ("S4096_DH128", 2, 4, 4096, 128, "realistic"),
                ("S512_DH160", 2, 4, 512, 160, "realistic"),
                ("S320_DH32_padded", 2, 4, 320, 32, "realistic"),   # 384 = 3 chunks
                # VisionLSTM3D (128^3, patch 8) and a ViT-B-wide VisionLSTM
                ("S4096_DH96", 1, 4, 4096, 96, "realistic"),
                ("S196_DH384", 1, 4, 196, 384, "realistic"),
                ("S4096_DH128_denominator", 1, 4, 4096, 128, "denominator"),
                # odd widths, zero-padded: the 2-D stage 6's channel tokens
                # (DH 15 -> 16), DH 45 -> 64
                ("S512_DH15", 2, 2, 512, 15, "realistic"),
                ("S1000_DH45", 1, 4, 1000, 45, "realistic"),
                # one chunk with S < L: the 3-D and 2-D UXlstmBot bottlenecks
                ("S64_DH160_one_chunk", 2, 4, 64, 160, "realistic"),
                ("S15_DH256_one_chunk", 2, 4, 15, 256, "realistic"),
                # the wide path's edges: the last chunk's true rows end inside
                # a row tile (72 and 1 rows), one chunk of 65 rows (a tile and
                # one row), the widest head, a grid below one wave, and the
                # e^{-m} branch at a ViT-B width
                ("S200_DH64", 1, 4, 200, 64, "realistic"),
                ("S129_DH64", 1, 4, 129, 64, "realistic"),
                ("S200_DH160", 1, 4, 200, 160, "realistic"),
                ("S129_DH160", 1, 4, 129, 160, "realistic"),
                ("S65_DH96_one_chunk", 1, 4, 65, 96, "realistic"),
                ("S200_DH512", 1, 2, 200, 512, "realistic"),
                ("S196_DH384_BNH1", 1, 1, 196, 384, "realistic"),
                ("S196_DH384_denominator", 1, 4, 196, 384, "denominator"),
                *GATE_REGIME_CASES)
# the cases timed into the kernels line: the main paths' bottleneck shape,
# and the ViL decoder's and the wide path's under their own keys
TIMED_CASES = ("S4096", "S32768_DH8", "S49152_DH8", "S4096_DH128", "S512_DH160",
               "S320_DH32_padded", "S4096_DH96", "S196_DH384")
# kernel -> (source file, line of the Pallas kernel body it replaces)
KERNELS = {"mlstm_fwd": ("mlstm_fwd.cu", 40),
           "mlstm_fwd_states": ("mlstm_fwd.cu", 107),
           "mlstm_bwd": ("mlstm_bwd.cu", 208)}


def absmax(t) -> float:
    return float(t.abs().max())


def finite(*tensors) -> bool:
    import torch

    return all(bool(torch.isfinite(t).all()) for t in tensors)


def check_kernels(dev):
    """Phase 3, each kernel against its twin on every case. Returns the
    kernels-line rows (timed at S 4096, the 128^3 shape) and each kernel's
    worst max|d|."""
    import torch
    from xlstm_hved_torch.ops import mlstm_cuda as mc

    gen = torch.Generator(device=dev).manual_seed(1)
    rows, worst = {}, dict.fromkeys(KERNELS, 0.0)
    regime_worst = dict.fromkeys(KERNELS, 0.0)   # the gate regimes' cases alone
    regimes = {case[0] for case in GATE_REGIME_CASES}
    for label, B, NH, S, DH, kind in KERNEL_CASES:
        q, k, v, ig, fg = mlstm_inputs(gen, dev, B, NH, S, DH, kind)
        prepared = mc.prepare(q, k, v, ig, fg, 128)
        qf, kf, vf, a, s, cm = prepared
        BH, Sp, DP = qf.shape    # DP: DH zero-padded to the kernels' width
        L = a.shape[-1]
        g = torch.randn(qf.shape, generator=gen, device=dev)
        # as mlstm_backward pads the cotangent: zero past DH and past S
        g[..., DH:] = 0.0
        g.view(B * NH, Sp, DP)[:, S:] = 0.0
        wide = DP > mc.NARROW_DH[-1]
        if wide:  # the blocks of each launch of the plan the wrappers take
            plan = mc.wide_plan(BH, Sp // L, L, DP)
            print(f"  {label}: wide plan row tile {plan.row_tile}, column groups "
                  f"{plan.col_groups}, blocks " + ", ".join(f"{n} {b}" for n, b in
                                                           plan.blocks.items()), flush=True)
        else:  # the balanced walk of the readout, rows and columns launches
            pairs = max(len(lane) for lane in mc.narrow_plan(L))
            print(f"  {label}: narrow walk {mc.NARROW_SPLIT} lanes to a group of four rows, at "
                  f"most {pairs} (row, key) pairs a lane (L {L}), {BH * (Sp // L)} blocks a "
                  f"launch", flush=True)
        with torch.inference_mode():
            out = mc.run_kernel(*prepared, dh=DH, seq_len=S)
            ref_states = mc.mlstm_forward_states_reference(*prepared, dh=DH)
            ref = ref_states[0]
            # the user-facing wrapper (prep + launch + unpad) on the raw inputs
            full = mc.mlstm_forward(q, k, v, ig, fg, chunk_size=128)
            states = mc.run_states_kernel(*prepared, dh=DH, seq_len=S)
            if not torch.equal(out, states[0]):
                fail(f"{label}: mlstm_fwd's h differs from mlstm_fwd_states' "
                     f"(max|d| {absmax(out - states[0]):.3e})")
            bwd_args = (qf, kf, vf, g, a, s, cm, *ref_states[1:])
            grads = mc.run_bwd_kernel(*bwd_args, dh=DH, seq_len=S)
            ref_grads = mc.mlstm_backward_reference(*bwd_args, dh=DH)
            torch.cuda.synchronize()
            err = max(absmax(out - ref),
                      absmax(full - ref.reshape(B, NH, -1, DP)[:, :, :S, :DH]))
            scaled = err / absmax(ref)
            if not (finite(out) and err <= KERNEL_ATOL and scaled <= KERNEL_SCALED):
                fail(f"mlstm_fwd {label}: max|d| {err:.3e}, scaled {scaled:.3e} "
                     f"(bounds {KERNEL_ATOL}, {KERNEL_SCALED})")
            s_errs = [scaled_err(x, r) for x, r in zip(states[:3], ref_states[:3])]
            s_abs = max(absmax(x - r) for x, r in zip(states[:3], ref_states[:3]))
            if not (finite(*states) and max(s_errs) <= KERNEL_SCALED
                    and absmax(states[0] - ref) <= KERNEL_ATOL
                    and torch.equal(states[3], ref_states[3])):
                fail(f"mlstm_fwd_states {label}: scaled out/cent/nent "
                     f"{['%.3e' % e for e in s_errs]}, m* equal "
                     f"{torch.equal(states[3], ref_states[3])} (bound {KERNEL_SCALED})")
            b_errs = [scaled_err(x, r) for x, r in zip(grads, ref_grads)]
            if kind == "underflow":   # dax's exact value is 0: the gate gradients' scale
                b_errs[4] = absmax(grads[4] - ref_grads[4]) / max(
                    absmax(ref_grads[4]), absmax(ref_grads[3]), 1e-30)
            b_abs = max(absmax(x - r) for x, r in zip(grads, ref_grads))
            if not (finite(*grads) and max(b_errs) <= BWD_SCALED):
                fail(f"mlstm_bwd {label}: scaled dq/dk/dv/ds/dax "
                     f"{['%.3e' % e for e in b_errs]} (bound {BWD_SCALED})")
            calls = {"mlstm_fwd": lambda: mc.run_kernel(*prepared, dh=DH, seq_len=S),
                     "mlstm_fwd_states": lambda: mc.run_states_kernel(*prepared, dh=DH,
                                                                      seq_len=S),
                     "mlstm_bwd": lambda: mc.run_bwd_kernel(*bwd_args, dh=DH, seq_len=S)}
            ms = {name: cuda_ms(fn) for name, fn in calls.items()}
            dev_ms = {name: device_ms(fn) for name, fn in calls.items()}
            plain_ms = {
                "mlstm_fwd": cuda_ms(lambda: mc.mlstm_forward_reference(*prepared, dh=DH), 2, 10),
                "mlstm_fwd_states": cuda_ms(
                    lambda: mc.mlstm_forward_states_reference(*prepared, dh=DH), 2, 10),
                "mlstm_bwd": cuda_ms(
                    lambda: mc.mlstm_backward_reference(*bwd_args, dh=DH), 1, 5)}
        # the work at the true width and length: the padded columns and rows
        # are zeros
        costs = {"mlstm_fwd": mlstm_cost(BH, S, DH, L),
                 "mlstm_fwd_states": mlstm_cost(BH, S, DH, L, states=True),
                 "mlstm_bwd": mlstm_bwd_cost(BH, S, DH, L)}
        for name, e in (("mlstm_fwd", err), ("mlstm_fwd_states", s_abs), ("mlstm_bwd", b_abs)):
            worst[name] = max(worst[name], e)
            if label in regimes:
                regime_worst[name] = max(regime_worst[name], e)
        print(f"  {label}: fwd max|d| {err:.3e} scaled {scaled:.3e} | states scaled "
              f"{max(s_errs):.3e} | bwd scaled dq {b_errs[0]:.3e} dk {b_errs[1]:.3e} "
              f"dv {b_errs[2]:.3e} ds {b_errs[3]:.3e} dax {b_errs[4]:.3e}", flush=True)
        for name in KERNELS:
            bound, by = bound_ms(*costs[name])
            print(f"    {name}: kernel {ms[name]:.4f} ms one call (device "
                  f"{dev_ms[name]:.4f} ms) | twin {plain_ms[name]:.4f} ms | bound "
                  f"{bound:.5f} ms by {by} ({costs[name][0]} B, {costs[name][1]} flop)",
                  flush=True)
            if label in TIMED_CASES and not wide:  # the narrow kernels, launch by launch
                with torch.inference_mode():
                    per = launch_us(calls[name])
                print("      " + ", ".join(f"{k} {us:.1f} us" for k, us in per.items()),
                      flush=True)
            timing = {"ms": ms[name], "device_ms": dev_ms[name], "plain_ms": plain_ms[name],
                      "bound_ms": bound, "bound_by": by}
            if label == "S4096":  # the shape the main paths give it (128^3 windows)
                source, line = KERNELS[name]
                rows[name] = {"name": name, "route": "cuda",
                              "source": f"{SOURCE_ROOT}/{source}",
                              "replaces": f"{REPLACES}:{line}",
                              **timing, "library_ms": None}
            elif label in TIMED_CASES:
                rows[name][label] = timing
    for name in KERNELS:
        rows[name]["gate_regimes"] = {"cases": len(GATE_REGIME_CASES),
                                      "max_abs_err": regime_worst[name]}
    return rows, worst, regime_worst


def check_wrapper_gradients(dev):
    """Phase 3, the differentiable wrapper: raw q, k, v, igate, fgate -> h
    and the five gradients through the kernels, against the plain
    chunkwise scan (the sequential walk over the chunks, not the twins'
    decomposition) and its autograd."""
    import torch
    from xlstm_hved_torch.ops import mlstm_cuda as mc
    from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise

    gen = torch.Generator(device=dev).manual_seed(2)
    for S in (2000, 6144):
        inputs = mlstm_inputs(gen, dev, 1, 4, S, 16, "realistic")
        cot = torch.randn(1, 4, S, 16, generator=gen, device=dev)
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out = mc.mlstm_forward(*leaves)
        got = torch.autograd.grad(out, leaves, cot)
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        ref = mlstm_chunkwise(*leaves)
        want = torch.autograd.grad(ref, leaves, cot)
        torch.cuda.synchronize()
        out, ref = out.detach(), ref.detach()
        h_err = absmax(out - ref)
        h_scaled = h_err / absmax(ref)
        if not (finite(out) and h_err <= KERNEL_ATOL and h_scaled <= KERNEL_SCALED):
            fail(f"mlstm_forward h at S {S} vs the plain scan: max|d| {h_err:.3e}, scaled "
                 f"{h_scaled:.3e} (bounds {KERNEL_ATOL}, {KERNEL_SCALED})")
        errs = [scaled_err(x, r) for x, r in zip(got, want)]
        if not (finite(*got) and max(errs) < FUNCTION_SCALED):
            fail(f"mlstm_forward gradients at S {S}: scaled dq/dk/dv/di/df "
                 f"{['%.3e' % e for e in errs]} (bound {FUNCTION_SCALED})")
        print(f"  mlstm_forward S{S} vs the plain scan: h max|d| {h_err:.3e} scaled "
              f"{h_scaled:.3e}; gradients vs its autograd: scaled dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e} digate {errs[3]:.3e} "
              f"dfgate {errs[4]:.3e}", flush=True)


def check_forward(dev, gen, name: str):
    """Phase 4, one preset's seg+recon forward at both crops through the
    kernel, against the same forward through the plain mLSTM. Returns the
    kernel model, its ms per crop and its mlstm_fwd launches per forward."""
    import torch
    from xlstm_hved_torch.models import find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda

    model = find_model_using_name(name, device=dev, seed=0)
    plain = find_model_using_name(name, device=dev, seed=0, mlstm_kernel=False)
    plain.load_state_dict(model.state_dict())
    keep = torch.ones(4, dtype=torch.bool, device=dev)
    forward_ms = {}
    for crop in CROPS:
        x = torch.rand(1, 4, *crop, generator=gen, device=dev)
        with torch.inference_mode():
            mlstm_cuda.run_kernel.launches = 0
            out = model(x, keep=keep, recon=True, deterministic=True)
            torch.cuda.synchronize()
            launches = mlstm_cuda.run_kernel.launches
            ref = plain(x, keep=keep, recon=True, deterministic=True)
            torch.cuda.synchronize()
            if launches != 1:
                fail(f"{name} forward at {crop}: {launches} mlstm_fwd launches, expected 1")
            if out.seg.shape != (1, 3, *crop) or out.recon.shape != (1, 4, *crop):
                fail(f"{name} forward at {crop}: shapes {out.seg.shape}, {out.recon.shape}")
            if not (torch.isfinite(out.seg).all() and torch.isfinite(out.recon).all()):
                fail(f"{name} forward at {crop}: non-finite output")
            if not (0.0 <= float(out.seg.min()) and float(out.seg.max()) <= 1.0):
                fail(f"{name} forward at {crop}: seg outside [0, 1]")
            seg_d = float((out.seg - ref.seg).abs().max())
            rec_d = float((out.recon - ref.recon).abs().max())
            if seg_d > SEG_ATOL or rec_d > RECON_ATOL:
                fail(f"{name} forward at {crop}: kernel vs plain mLSTM seg {seg_d:.3e}, "
                     f"recon {rec_d:.3e} (bounds {SEG_ATOL}, {RECON_ATOL})")
            run = lambda m=model, x=x: m(x, keep=keep, recon=True, deterministic=True)
            ms = cuda_ms(run, warmup=2, iters=5)
            ms_plain = cuda_ms(lambda x=x: plain(x, keep=keep, recon=True,
                                                 deterministic=True), warmup=1, iters=5)
        forward_ms["x".join(map(str, crop))] = ms
        print(f"  {name} forward {crop}: {ms:.2f} ms with the kernel, {ms_plain:.2f} ms "
              f"with the plain mLSTM | kernel vs plain seg max|d| {seg_d:.3e} "
              f"recon max|d| {rec_d:.3e} | mlstm_fwd launches {launches}", flush=True)
        del x, out, ref
    return model, forward_ms, launches


def synthetic_batch(gen, dev, crop):
    """A seeded random 4-modality volume and a nested WT/TC/ET mask of
    concentric spheres."""
    import torch

    x = torch.rand(1, 4, *crop, generator=gen, device=dev)
    axes = [torch.arange(n, device=dev, dtype=torch.float32) - n / 2 for n in crop]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    r = torch.sqrt(zz ** 2 + yy ** 2 + xx ** 2) / min(crop)
    mask = torch.stack([r < 0.25, r < 0.15, (r < 0.15) & (r > 0.08)]).float()[None]
    return x, mask


def check_train(dev, gen):
    """Phase 6, the training path at full width. Returns the launches and
    a summary."""
    import torch
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine.train import (create_train_state, make_grad_fn,
                                               make_train_step)
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc
    from xlstm_hved_torch.utils.subsets import subset_mask

    counters = {"mlstm_fwd": mc.run_kernel, "mlstm_fwd_states": mc.run_states_kernel,
                "mlstm_bwd": mc.run_bwd_kernel}
    per_step = dict.fromkeys(counters, 2)

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    cfg = TrainConfig()
    crop = tuple(cfg.crop_size)
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=0)
    disc = Discriminator(f_maps=cfg.disc_f_maps, kernel=cfg.disc_kernel)
    x, mask = synthetic_batch(gen, dev, crop)
    state = create_train_state(model, disc, cfg, seed=0, sample=x, init_scheme="reference")

    # 1. G gradients through the kernels against the plain mLSTM
    plain = find_model_using_name("XLSTM_HVED", device=dev, seed=0, mlstm_kernel=False)
    plain.load_state_dict(model.state_dict())
    keep = subset_mask(6, dev)
    torch.backends.cudnn.deterministic = True
    try:
        reset()
        loss_k, grads_k = make_grad_fn(model, disc, cfg)(x, mask, keep, deterministic=True)
        torch.cuda.synchronize()
        grad_launches = read()
        grad_plain = make_grad_fn(plain, disc, cfg)
        loss_p, grads_p = grad_plain(x, mask, keep, deterministic=True)
        # the same plain call again: the run-to-run noise of the atomics that
        # stay in the backward (trilinear upsampling, max pooling)
        _, grads_p2 = grad_plain(x, mask, keep, deterministic=True)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    if grad_launches != per_step:
        fail(f"make_grad_fn launched {grad_launches}, expected {per_step}")
    floor = GRAD_FLOOR * max(absmax(t) for t in grads_p.values())
    table = []
    for name, ref in grads_p.items():
        got = grads_k[name]
        if not finite(got):
            fail(f"G gradient {name}: not finite")
        err, noise, top = absmax(got - ref), absmax(grads_p2[name] - ref), absmax(ref)
        table.append((err / (GRAD_SCALED * top + floor), name, err, noise, top))
    table.sort(reverse=True)
    vil_scaled, vil_name = max((err / max(top, 1e-30), name) for _, name, err, _, top in table
                               if name.startswith("mvil."))
    for share, name, err, noise, top in table[:6]:
        print(f"    {name}: kernel vs plain max|d| {err:.3e}, plain vs plain {noise:.3e}, "
              f"max|ref| {top:.3e}, {share:.3f} of the bound", flush=True)
    share, share_name, err, noise, top = table[0]
    if share > 1.0:
        fail(f"G gradient {share_name}: kernel vs plain max|d| {err:.3e}, max|ref| "
             f"{top:.3e}, plain vs plain {noise:.3e} (bound {GRAD_SCALED} * max|ref| + "
             f"{floor:.3e})")
    loss_d = abs(float(loss_k) - float(loss_p))
    print(f"  G gradients through the kernels vs the plain mLSTM ({len(grads_p)} tensors): "
          f"loss |d| {loss_d:.3e}, worst {share:.3f} of the bound ({share_name}), mvil.* "
          f"worst max|d| / max|ref| {vil_scaled:.3e} ({vil_name}); launches "
          f"{grad_launches}", flush=True)
    del plain, grads_k, grads_p, grads_p2
    torch.cuda.empty_cache()

    # 2. steps at the TrainConfig crop
    step = make_train_step(model, disc, cfg)
    g_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    d_before = {n: p.detach().clone() for n, p in disc.named_parameters()}
    stats_before = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}

    def timed_steps(x, mask, n=3):
        nonlocal state
        state, _ = step(state, x, mask)  # warm-up
        torch.cuda.synchronize()
        reset()
        times, metrics = [], []
        for _ in range(n):
            t = time.perf_counter()
            state, m = step(state, x, mask)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            metrics.append(m)
        return times, metrics, read()

    torch.cuda.reset_peak_memory_stats(dev)
    times, metrics, launches = timed_steps(x, mask)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if launches != {name: 3 * n for name, n in per_step.items()}:
        fail(f"3 train steps launched {launches}, expected {per_step} per step")
    for m in metrics:
        bad = [k for k, v in m.items() if not math.isfinite(float(v))]
        if bad:
            fail(f"train step: non-finite {bad}")
    g_moved = sum(not torch.equal(g_before[n], p) for n, p in model.named_parameters())
    d_moved = sum(not torch.equal(d_before[n], p) for n, p in disc.named_parameters())
    s_moved = sum(not torch.equal(stats_before[n], b) for n, b in model.named_buffers()
                  if n in stats_before)
    if g_moved < 0.9 * len(g_before) or d_moved != len(d_before) or s_moved != len(stats_before):
        fail(f"train steps moved {g_moved}/{len(g_before)} G tensors, {d_moved}/"
             f"{len(d_before)} D tensors, {s_moved}/{len(stats_before)} running statistics")
    step_ms = statistics.median(times)
    last = metrics[-1]
    print(f"  train steps {'x'.join(map(str, crop))}: {step_ms:.1f} ms median of "
          f"{['%.1f' % t for t in times]}, peak {peak_gib:.2f} GiB | loss "
          f"{float(last['loss']):.4f} loss_d {float(last['loss_d']):.4f} | moved G "
          f"{g_moved}/{len(g_before)} D {d_moved}/{len(d_before)} running stats "
          f"{s_moved}/{len(stats_before)} | launches {launches}", flush=True)

    # 3. the same step at 128^3
    del x, mask
    x3, mask3 = synthetic_batch(gen, dev, (128, 128, 128))
    torch.cuda.reset_peak_memory_stats(dev)
    times3, metrics3, _ = timed_steps(x3, mask3)
    peak3 = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if not all(math.isfinite(float(m["loss"])) for m in metrics3):
        fail("train step at 128^3: non-finite loss")
    step3_ms = statistics.median(times3)
    print(f"  train steps 128x128x128: {step3_ms:.1f} ms median of "
          f"{['%.1f' % t for t in times3]}, peak {peak3:.2f} GiB", flush=True)
    summary = (f"{'x'.join(map(str, crop))} {step_ms:.1f} ms/step, peak {peak_gib:.2f} GiB; "
               f"128x128x128 {step3_ms:.1f} ms/step; launches per step {per_step}")
    measured = {name: n // len(times) for name, n in launches.items()}
    return {"per_step": measured, "launches": launches, "summary": summary,
            "step_ms": step_ms, "peak_gib": peak_gib}


CLI_SHAPE = (240, 240, 155)   # the volume size of the full reference protocol
CLI_PER_PRETRAIN_STEP = {"mlstm_fwd": 1, "mlstm_fwd_states": 1, "mlstm_bwd": 1}
CLI_PER_TRAIN_STEP = {"mlstm_fwd": 2, "mlstm_fwd_states": 2, "mlstm_bwd": 2}
CLI_PER_VALID_ITEM = {"mlstm_fwd": 2, "mlstm_fwd_states": 0, "mlstm_bwd": 0}


def read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def check_cli(dev, root):
    """Phase 7, the training entry points through their main(argv), writing
    the dataset and the runs under `root`. Returns the launches of the
    phase's runs, the launches per pretrain step as measured, and a
    summary."""
    import torch
    from xlstm_hved_torch.cli import check as check_main
    from xlstm_hved_torch.cli import pretrain as pretrain_main
    from xlstm_hved_torch.cli import train as train_main
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.data.synthetic import write_synthetic_dataset
    from xlstm_hved_torch.engine.checkpoint import CheckpointManager
    from xlstm_hved_torch.engine.train import create_train_state
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc

    counters = {"mlstm_fwd": mc.run_kernel, "mlstm_fwd_states": mc.run_states_kernel,
                "mlstm_bwd": mc.run_bwd_kernel}
    total = dict.fromkeys(counters, 0)

    def run(fn, argv):
        """main(argv) with the launch counts set to 0 just before it and read
        just after; the peak device memory of the run."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        summary = fn(argv)
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        for name, n in launches.items():
            total[name] += n
        return summary, launches, torch.cuda.max_memory_allocated(dev) / 2 ** 30

    def expect_launches(what, launches, summary, per_step):
        """The run's launches against the expected counts; returns its steps,
        validation items and measured launches per step."""
        steps = sum(e["steps"] for e in summary["epochs"])
        items = sum(e["valid_items"] for e in summary["epochs"])
        want = {n: steps * per_step[n] + items * CLI_PER_VALID_ITEM[n] for n in counters}
        if launches != want:
            fail(f"{what}: {steps} steps and {items} validation items launched "
                 f"{launches}, expected {want}")
        measured = {n: (launches[n] - items * CLI_PER_VALID_ITEM[n]) // steps for n in counters}
        return steps, items, measured

    def timing(what, summary, peak):
        epochs = summary["epochs"]
        sp = {k: sum(e["spans"][k] for e in epochs) for k in epochs[0]["spans"]}
        steps = sum(e["steps"] for e in epochs)
        host = sp["train_wait"] + sp["train_batch"]
        share = host / (host + sp["train_step"])
        line = (f"  {what}: epochs {['%.2f' % e['seconds'] for e in epochs]} s | per step "
                f"{sp['train_step'] / steps:.3f} s, batch assembly {sp['train_batch'] / steps:.3f}"
                f" s per item, loader wait {sp['train_wait'] / steps:.3f} s per step, host "
                f"share {share:.3f} | validation {sp['valid_step']:.2f} s + assembly "
                f"{sp['valid_batch']:.3f} s + wait {sp['valid_wait']:.3f} s | peak {peak:.2f} GiB")
        print(line, flush=True)
        return dict(spans=sp, steps=steps, host_share=share, peak_gib=peak,
                    epoch_s=[e["seconds"] for e in epochs])

    def csv_rows(path, n, what):
        rows = read_csv(path)
        if len(rows) != n:
            fail(f"{what}: {len(rows)} CSV rows in {path}, expected {n}")
        for row in rows:
            bad = [k for k, v in row.items() if v != "" and not math.isfinite(float(v))]
            if bad:
                fail(f"{what}: non-finite CSV values {bad}")
        return rows

    report = {}
    t = time.perf_counter()
    train_dir = write_synthetic_dataset(os.path.join(root, "train"), 2, CLI_SHAPE, seed=0)
    valid_dir = write_synthetic_dataset(os.path.join(root, "valid"), 1, CLI_SHAPE, seed=1)
    out = os.path.join(root, "results")
    print(f"  synthetic dataset, 3 subjects of {'x'.join(map(str, CLI_SHAPE))}: "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    common = ["--device", str(dev), "--num_epochs", "1", "--train_dir", train_dir,
              "--valid_dir", valid_dir, "--out_dir", out]

    # 1. check
    good, bad = check_main.main(["--data_dir", train_dir, "--decode",
                                 "--out_file", os.path.join(root, "subjects.txt")])
    if len(good) != 2 or bad:
        fail(f"cli.check: {good} OK, {bad} failed")

    # 2. pretrain
    summary, launches, peak = run(pretrain_main.main, common)
    pdir = os.path.join(out, "U_HVEDDuSFEmViLDFNet3D_pretrain")
    ckpt = CheckpointManager(pdir)
    if not (ckpt.exists("latest") and ckpt.exists("best_vloss")):
        fail(f"cli.pretrain: latest / best_vloss missing under {pdir}")
    csv_rows(os.path.join(pdir, "loss_and_metrics.csv"), 1, "cli.pretrain")
    steps, items, pretrain_per_step = expect_launches("cli.pretrain", launches, summary,
                                                      CLI_PER_PRETRAIN_STEP)
    after = ckpt.restore_raw("latest")[0]["model"]
    # the pretrain CLI's initial weights, drawn again from its seed
    args = pretrain_main.base_parser("").parse_args(common)
    first = find_model_using_name("U_HVEDDuSFEmViLDFNet3D", device=dev, seed=args.seed,
                                  shared_recon=False)
    create_train_state(first, Discriminator(f_maps=args.disc_fmaps, kernel=args.disc_kernel),
                       TrainConfig(), args.seed,
                       torch.zeros((1, 4, *args.crop_size), device=dev),
                       init_scheme=args.init_scheme)
    before = {n: t.detach().cpu() for n, t in first.state_dict().items()}
    params = dict(first.named_parameters())
    frozen = [n for n in params if "sdecoder" in n]
    moved = [n for n in params if not torch.equal(before[n], after[n])]
    stats = [n for n in before if "running_" in n]
    if not frozen or set(frozen) & set(moved):
        fail(f"cli.pretrain: sdecoder parameters moved: {sorted(set(frozen) & set(moved))}")
    if len(moved) < 0.9 * (len(params) - len(frozen)):
        fail(f"cli.pretrain: only {len(moved)} of {len(params) - len(frozen)} trainable "
             "parameters moved")
    if any(not torch.equal(before[n], after[n]) for n in stats):
        fail("cli.pretrain: BatchNorm running statistics moved (eval-mode BatchNorm)")
    del first, after
    report["pretrain"] = timing("cli.pretrain", summary, peak)
    print(f"  cli.pretrain: {steps} steps, {items} validation items, launches "
          f"{launches}; {len(frozen)} sdecoder tensors bitwise frozen, {len(moved)} of "
          f"{len(params) - len(frozen)} others moved, {len(stats)} running statistics "
          "unchanged", flush=True)

    # 3. train from the pretrain weights
    argv = common + ["--pretrain_weights", pdir]
    summary, launches, peak = run(train_main.main, argv)
    donor = ckpt.restore_raw("best_vloss")[0]["model"]
    target = find_model_using_name("XLSTM_HVED", device="cpu")
    rule = sum(n in donor and tuple(donor[n].shape) == tuple(p.shape)
               for n, p in target.named_parameters())
    rule = (rule, len(list(target.parameters())) - rule)
    if summary["surgery"] != rule:
        fail(f"cli.train: surgery loaded/skipped {summary['surgery']}, the name/shape "
             f"rule gives {rule}")
    tdir = os.path.join(out, "XLSTM_HVED")
    tckpt = CheckpointManager(tdir)
    if not all(tckpt.exists(n) for n in ("latest", "best_vloss", "best_dice")):
        fail(f"cli.train: latest / best_vloss / best_dice missing under {tdir}")
    csv_path = os.path.join(tdir, "loss_and_metrics.csv")
    csv_rows(csv_path, 1, "cli.train")
    steps, items, _ = expect_launches("cli.train", launches, summary, CLI_PER_TRAIN_STEP)
    report["train"] = timing("cli.train", summary, peak)
    print(f"  cli.train: surgery loaded {rule[0]}, skipped {rule[1]}; {steps} steps, "
          f"{items} validation items, launches {launches}", flush=True)

    # 4. the same command, two epochs, with --remat: resumes the checkpoint
    # of the run without remat, runs epoch 2 only, through the same kernels
    argv[argv.index("--num_epochs") + 1] = "2"
    argv.append("--remat")
    summary, launches, peak = run(train_main.main, argv)
    if [e["epoch"] for e in summary["epochs"]] != [2]:
        fail(f"cli.train resumed: ran epochs {[e['epoch'] for e in summary['epochs']]}, "
             "expected [2]")
    rows = csv_rows(csv_path, 2, "cli.train resumed")
    if [int(r["Epoch"]) for r in rows] != [1, 2]:
        fail(f"cli.train resumed: CSV epochs {[r['Epoch'] for r in rows]}")
    saved_step = tckpt.restore_raw("latest")[0]["step"]
    if summary["step"] != 2 * steps or saved_step != 2 * steps:
        fail(f"cli.train resumed: step {summary['step']}, saved {saved_step}, "
             f"expected {2 * steps}")
    expect_launches("cli.train resumed", launches, summary, CLI_PER_TRAIN_STEP)
    report["resume_remat"] = timing("cli.train resumed with --remat", summary, peak)
    print(f"  cli.train resumed with --remat: epoch 2 only, CSV epochs 1 and 2, step "
          f"{saved_step}, launches {launches}", flush=True)

    summary = " | ".join(
        f"{k} {v['spans']['train_step'] / v['steps']:.2f} s/step, host share "
        f"{v['host_share']:.3f}, peak {v['peak_gib']:.2f} GiB" for k, v in report.items())
    return {"launches": total, "pretrain_per_step": pretrain_per_step, "report": report,
            "summary": summary}


EVAL_PER_VOLUME = {"mlstm_fwd": 15, "mlstm_fwd_states": 0, "mlstm_bwd": 0}
EVAL_SPANS_DEVICE = ("sweep", "dice", "recon_metrics")   # the rest is the host's


def check_eval(dev, gen, root):
    """Phase 8, the evaluation entry point on phase 7's best_dice checkpoint,
    then the hoisted sweep against the plain one. Returns the CLI run's
    launches, the launches per volume and a summary."""
    import contextlib
    import io

    import numpy as np
    import torch
    from xlstm_hved_torch.cli import test as test_main
    from xlstm_hved_torch.cli.common import assemble_eval_batch
    from xlstm_hved_torch.data.brats import BraTSDataset
    from xlstm_hved_torch.data.nifti import read_nifti
    from xlstm_hved_torch.engine.checkpoint import CheckpointManager
    from xlstm_hved_torch.engine.evaluate import (default_apply_fn, label_volume_from_probs,
                                                  make_hoisted_subset_sweep, make_subset_sweep)
    from xlstm_hved_torch.models import find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc

    counters = {"mlstm_fwd": mc.run_kernel, "mlstm_fwd_states": mc.run_states_kernel,
                "mlstm_bwd": mc.run_bwd_kernel}

    def reset():
        for c in counters.values():
            c.launches = 0

    def read():
        return {name: c.launches for name, c in counters.items()}

    valid_dir, out = os.path.join(root, "valid"), os.path.join(root, "results")
    pred_dir, plots_dir = os.path.join(root, "preds"), os.path.join(root, "plots")
    argv = ["--device", str(dev), "--valid_dir", valid_dir, "--out_dir", out,
            "--compute_hd95", "--eval_recon", "--save_pred_dir", pred_dir,
            "--save_plots_dir", plots_dir]

    # 1. the CLI, its launch counts set to 0 just before and read just after
    buf = io.StringIO()
    reset()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        summary = test_main.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    text = buf.getvalue().splitlines()
    for line in text:
        if line.startswith(("restored", "WARNING", "volume ", "subset ", "average")):
            print(f"    {line}", flush=True)
    n = summary["volumes"]
    want = {name: n * k for name, k in EVAL_PER_VOLUME.items()}
    if "restored checkpoint best_dice" not in text:
        fail("cli.test: no 'restored checkpoint best_dice' line")
    if (sum(line.startswith("subset ") for line in text) != 15
            or sum(line.startswith("average") for line in text) != 1 or n != 1):
        fail(f"cli.test: {n} volumes, expected the 15 subset lines and the average of 1")
    if launches != want:
        fail(f"cli.test: {n} volumes launched {launches}, expected {want}")
    dice = summary["dice"]
    if not (np.isfinite(dice).all() and (dice >= 0).all() and (dice <= 1).all()):
        fail(f"cli.test: Dice not finite in [0, 1]: {dice}")
    for key in ("hd95", "psnr", "ssim"):
        if not np.isfinite(summary[key]).all():
            fail(f"cli.test: non-finite {key}: {summary[key]}")
    preds = sorted(os.listdir(pred_dir))
    pngs = sorted(os.listdir(plots_dir))
    if len(preds) != 1 or not preds[0].endswith("-pred.nii.gz") or len(pngs) != 3 * n:
        fail(f"cli.test: exported {preds} and {pngs}, expected one label volume and 3 PNGs")
    labels = read_nifti(os.path.join(pred_dir, preds[0]))[0]
    if not set(np.unique(labels).tolist()) <= {0, 1, 2, 4}:
        fail(f"cli.test: labels {np.unique(labels)} outside {{0, 1, 2, 4}}")
    # the labels against the sweep's all-modality subset, run again at the
    # CLI's compute dtype
    cli_args = test_main.parser().parse_args(argv)
    crop = tuple(cli_args.crop_size)
    model = find_model_using_name("XLSTM_HVED", device=dev, compute_dtype=cli_args.compute_dtype)
    model.load_state_dict(
        CheckpointManager(os.path.join(out, "XLSTM_HVED")).restore_raw("best_dice")[0]["model"])
    x, _, _ = assemble_eval_batch([BraTSDataset(valid_dir, m_full=True).load(0)], crop, dev)
    seg_all = make_hoisted_subset_sweep(model, crop, crop)(model, x)[14, 0].cpu().numpy()
    again = label_volume_from_probs(seg_all)
    if labels.shape != again.shape or not np.array_equal(labels, again):
        near = np.abs(seg_all - 0.5).min()
        fail(f"cli.test: exported labels differ from the sweep's in "
             f"{int((labels != again).sum())} voxels (closest |p - 0.5| {near:.3e})")
    vol = summary["per_volume"][0]
    device_s = sum(vol["spans"][k] for k in EVAL_SPANS_DEVICE)
    host_share = 1.0 - device_s / vol["seconds"]
    print(f"  cli.test: {cli_s:.2f} s, volume {vol['seconds']:.2f} s: "
          + " ".join(f"{k} {v:.3f}" for k, v in vol["spans"].items())
          + f" s | host share {host_share:.3f} | hd95 share {vol['spans']['hd95'] / vol['seconds']:.3f}"
          f" | peak {peak:.2f} GiB | launches {launches} | labels {np.unique(labels).tolist()}"
          f" equal the sweep's again", flush=True)
    del model, x

    # 2. the hoisted sweep against the plain one, plain / hoisted / hoisted / plain
    crop = CROPS[1]
    x = torch.rand(1, 4, *crop, generator=gen, device=dev)
    lines = []
    for name in ("XLSTM_HVED", "U_HVEDConvXLSTMNet3D"):
        model = find_model_using_name(name, device=dev, seed=0)
        sweeps = {"hoisted": make_hoisted_subset_sweep(model, crop, crop, recon_channels=4),
                  "plain": make_subset_sweep(default_apply_fn(model, recon=True), crop, crop,
                                             recon_channels=4)}
        outs, secs, peaks = {}, {k: [] for k in sweeps}, {}
        for kind in ("plain", "hoisted", "hoisted", "plain"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset()
            t = time.perf_counter()
            result = sweeps[kind](model, x)
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - t)
            peaks[kind] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if read()["mlstm_fwd"] != 15:
                fail(f"{name} {kind} sweep: {read()} launches, expected 15 mlstm_fwd")
            outs[kind] = result
            del result
        (seg_h, rec_h), (seg_p, rec_p) = outs["hoisted"], outs["plain"]
        seg_d, rec_d = absmax(seg_h - seg_p), absmax(rec_h - rec_p)
        if not finite(seg_h, rec_h) or seg_d > SEG_ATOL or rec_d > RECON_ATOL:
            fail(f"{name}: hoisted vs plain sweep seg max|d| {seg_d:.3e}, recon {rec_d:.3e} "
                 f"(bounds {SEG_ATOL}, {RECON_ATOL})")
        line = (f"{name} hoisted {secs['hoisted'][0]:.3f}, {secs['hoisted'][1]:.3f} s "
                f"(peak {peaks['hoisted']:.2f} GiB) vs plain {secs['plain'][0]:.3f}, "
                f"{secs['plain'][1]:.3f} s (peak {peaks['plain']:.2f} GiB); max|d| seg "
                f"{seg_d:.3e} recon {rec_d:.3e}")
        print(f"  {line}", flush=True)
        lines.append(line)
        del model, sweeps, outs, seg_h, rec_h, seg_p, rec_p
        torch.cuda.empty_cache()
    return {"launches": launches, "per_volume": launches["mlstm_fwd"] // n,
            "summary": f"volume {vol['seconds']:.2f} s, host share {host_share:.3f} | "
                       + " | ".join(lines)}


# Phase 9's bounds come from tests/torch_precision_ref.npz, JAX's side of
# tests/test_torch_precision.py (which holds the port's CPU runs to them):
# the bf16 forward's mean and 99.9th-percentile |d| against fp32 at most
# twice JAX's own on the same (JAX-initialised) weights at 32^3, recon's
# relative to max|recon|; max|d| is reported, not bounded (it grows with the
# voxel count: the port's seg max went 0.07, 0.34, 0.47 at 16^3, 32^3, 64^3
# on the CPU). The bf16 G gradient is held to JAX's bf16 G gradient itself
# at 16^3, on the same weights and input: over all parameters at once, its
# distance from JAX's at most GRAD_SHARE of JAX's own bf16-vs-fp32 distance
# (0.700 on the CPU; an fp32 gradient reads 1.000, a zero one 1.075, a
# random one of the same norm 1.45). At the TrainConfig crop the bf16 G
# gradient's distance from the fp32 one (the per-tensor relative L2 median
# and the value over all tensors) is reported and held within twice JAX's
# at 16^3, a bound that only a gross fault crosses: at init the network's
# bf16 gradient lies about its own norm from the fp32 one, in JAX as in the
# port.
PRECISION_REF = os.path.join("tests", "torch_precision_ref.npz")
PRECISION_FACTOR = 2.0
GRAD_SHARE = 0.85
PRECISION_KEEP = (True, False, True, False)
# remat against the same step without it, twice: bitwise with the
# upsampling's backward made deterministic (`deterministic_upsampling`) and
# cuDNN deterministic; and on the model's own path, where the trilinear
# upsampling's backward adds with atomics and the order moves a bf16
# gradient by percents, the worst tensor's max|d| (over the network's largest
# gradient, against each of NOISE_RUNS plain runs) within three times the
# largest such distance between two plain runs, plus 1e-6
REMAT_NOISE, REMAT_SCALED, NOISE_RUNS = 3.0, 1e-6, 4


@contextlib.contextmanager
def deterministic_upsampling():
    """Inside, the model's trilinear upsampling (by 2 on each axis,
    half-pixel centres, at least fp32 inside and returned in the input's
    dtype, as F.interpolate computes it) is slices and weighted sums, whose
    backward adds without atomics: with cuDNN deterministic a gradient is
    then the same bits run after run. Within 2.4e-7 of F.interpolate in fp32
    and equal in bf16 on the CPU."""
    import torch
    from xlstm_hved_torch.models import hved
    from xlstm_hved_torch.nn import blocks

    def resize(x, size):
        size = tuple(int(s) for s in size)
        if tuple(x.shape[2:]) == size:
            return x
        if size != tuple(2 * s for s in x.shape[2:]):
            raise ValueError(f"deterministic_upsampling: {tuple(x.shape[2:])} -> {size} "
                             "is not an upsampling by 2")
        y = blocks.at_least_fp32(x)
        for axis in (2, 3, 4):
            n = y.shape[axis]
            prev = torch.cat([y.narrow(axis, 0, 1), y.narrow(axis, 0, n - 1)], axis)
            nxt = torch.cat([y.narrow(axis, 1, n - 1), y.narrow(axis, n - 1, 1)], axis)
            y = torch.stack([0.75 * y + 0.25 * prev, 0.75 * y + 0.25 * nxt],
                            axis + 1).flatten(axis, axis + 1)
        return y.to(x.dtype)

    saved = blocks.resize_trilinear, hved.resize_trilinear
    blocks.resize_trilinear = hved.resize_trilinear = resize
    try:
        yield
    finally:
        blocks.resize_trilinear, hved.resize_trilinear = saved


def npz_tree(ref, prefix: str) -> dict:
    """The nested flax tree stored under `prefix` (`<prefix>.<a>.<b>...`)."""
    tree = {}
    for key in ref.files:
        if key.startswith(prefix + "."):
            *path, leaf = key[len(prefix) + 1:].split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = ref[key]
    return tree


def precision_ref() -> dict:
    """The JAX side of phase 9 from PRECISION_REF: "weights", the goldens'
    JAX-initialised XLSTM_HVED weights as the port's state_dict;
    "g_weights" and "d_weights", the G gradient's G and D weights;
    "grad_bf16", JAX's bf16 G gradient on them by parameter name;
    "numbers", JAX's numbers by name."""
    import numpy as np
    from xlstm_hved_torch.utils.convert import params_from_jax

    ref = np.load(os.path.join(HERE, PRECISION_REF))
    out = {"grad_bf16": {}, "numbers": {}}
    for name, prefix in (("weights", "golden"), ("g_weights", "gweights"),
                         ("d_weights", "dweights")):
        tree = npz_tree(ref, prefix)
        out[name] = params_from_jax(tree["params"], tree.get("batch_stats"))
    for key in ref.files:
        if key.startswith("grad.bf16."):
            out["grad_bf16"][key[len("grad.bf16."):]] = ref[key]
        elif key.startswith(("grad.", "forward32.")):
            out["numbers"][key] = float(ref[key])
    return out


def precision_g_inputs():
    """x, mask (NDHWC) of the G gradient held against JAX's at 16^3."""
    import numpy as np

    rng = np.random.RandomState(7)
    x = rng.rand(1, 16, 16, 16, 4).astype(np.float32)
    mask = (rng.rand(1, 16, 16, 16, 3) > 0.7).astype(np.float32)
    return x, mask


def bf16_gradient_share(grads, ref: dict) -> float:
    """A bf16 G gradient's L2 distance from JAX's bf16 one, over all
    parameters at once, as a share of JAX's own bf16-vs-fp32 distance.
    `grads`: {name: numpy array}."""
    import numpy as np

    names = sorted(ref["grad_bf16"])
    if sorted(grads) != names:
        fail(f"bf16 G gradient: parameter names differ from JAX's: "
             f"{sorted(set(grads) ^ set(names))[:5]}")
    sq = sum(float(np.sum((np.asarray(grads[n], np.float64) - ref["grad_bf16"][n]) ** 2))
             for n in names)
    return math.sqrt(sq) / ref["numbers"]["grad.dist"]


def check_precision(dev, gen, fp32_ref):
    """Phase 9, bf16 compute and remat for the flagship at full width:
    the bf16 forward at both crops against the fp32 forward on the same
    weights; the bf16 G gradient at 16^3 against JAX's; the bf16 G+D step at
    the TrainConfig crop (its G gradient against the fp32 one, its time,
    memory and device-time split); the step with remat in fp32 and bf16
    (memory, time, gradients against the step without remat, launch counts).
    `fp32_ref` holds phase 4's and phase 6's fp32 numbers. Returns a
    summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine.train import (create_train_state, make_grad_fn,
                                               make_train_step)
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc
    from xlstm_hved_torch.utils.subsets import subset_mask

    bf16 = torch.bfloat16
    counters = {"mlstm_fwd": mc.run_kernel, "mlstm_fwd_states": mc.run_states_kernel,
                "mlstm_bwd": mc.run_bwd_kernel}
    per_step = dict.fromkeys(counters, 2)

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counters.items()}

    def gib():
        return torch.cuda.max_memory_allocated(dev) / 2 ** 30

    lines = []

    # 1. the bf16 forward against the fp32 forward on the goldens' weights
    pref = precision_ref()
    weights, jax_ref = pref["weights"], pref["numbers"]
    m32 = find_model_using_name("XLSTM_HVED", device=dev)
    m32.load_state_dict(weights, strict=True)
    m16 = find_model_using_name("XLSTM_HVED", device=dev, compute_dtype="bfloat16")
    m16.load_state_dict(weights, strict=True)
    mlstm_in = set()
    m16.mvil.vil.layer.mlstm_cell.register_forward_pre_hook(
        lambda mod, args: mlstm_in.update(a.dtype for a in args))
    keep = torch.ones(4, dtype=torch.bool, device=dev)
    for crop in CROPS:
        key = "x".join(map(str, crop))
        x = torch.rand(1, 4, *crop, generator=gen, device=dev)
        with torch.inference_mode():
            torch.cuda.reset_peak_memory_stats(dev)
            ref = m32(x, keep=keep, recon=True, deterministic=True)
            torch.cuda.synchronize()
            peak32 = gib()
            torch.cuda.reset_peak_memory_stats(dev)
            reset()
            out = m16(x, keep=keep, recon=True, deterministic=True)
            torch.cuda.synchronize()
            peak16, launches = gib(), read()["mlstm_fwd"]
            ms16 = cuda_ms(lambda: m16(x, keep=keep, recon=True, deterministic=True),
                           warmup=2, iters=5)
        if launches != 1 or mlstm_in != {torch.float32}:
            fail(f"bf16 forward at {crop}: {launches} mlstm_fwd launches, mLSTM inputs "
                 f"{mlstm_in}; expected 1 launch on fp32")
        if out.seg.dtype != torch.float32 or not finite(out.seg, out.recon):
            fail(f"bf16 forward at {crop}: seg {out.seg.dtype}, finite "
                 f"{finite(out.seg, out.recon)}")
        top = absmax(ref.recon)
        got, maxes = {}, {}
        for head, d, scale in (("seg", (out.seg - ref.seg).abs(), 1.0),
                               ("recon", (out.recon - ref.recon).abs(),
                                top / jax_ref["forward32.recon.top"])):
            d = d.flatten()
            p999 = float(d.kthvalue(max(1, int(round(0.999 * d.numel())))).values)
            bound = PRECISION_FACTOR * scale
            got[f"{head} mean"] = (float(d.mean()), bound * jax_ref[f"forward32.{head}.mean"])
            got[f"{head} p99.9"] = (p999, bound * jax_ref[f"forward32.{head}.p999"])
            maxes[head] = float(d.max())
        bad = {name: v for name, v in got.items() if not v[0] <= v[1]}
        if bad:
            fail(f"bf16 forward at {crop} against fp32: {bad} (value, bound)")
        line = (f"bf16 forward {key}: {ms16:.2f} ms (fp32 {fp32_ref['forward_ms'][key]:.2f} "
                f"ms, phase 4), peak {peak16:.2f} GiB (fp32 {peak32:.2f}) | vs fp32 |d|: "
                + ", ".join(f"{name} {v:.3e} (bound {b:.3e})" for name, (v, b) in got.items())
                + f", seg max {maxes['seg']:.3e}, recon max {maxes['recon']:.3e} (max|recon| "
                f"{top:.3e}) | mlstm_fwd launches {launches}, its inputs "
                f"{sorted(map(str, mlstm_in))}")
        print(f"  {line}", flush=True)
        lines.append(line)
        del x, ref, out, d
    del m32, m16, weights
    torch.cuda.empty_cache()

    # 2. the bf16 G gradient against JAX's bf16 G gradient at 16^3, and the
    # fp32 one against it for scale (an fp32 gradient reads about 1)
    import numpy as np

    x, mask = (torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(dev)
               for a in precision_g_inputs())
    keep = torch.tensor(PRECISION_KEEP, device=dev)
    shares = {}
    for dtype in ("bfloat16", "float32"):
        model = find_model_using_name("XLSTM_HVED", device=dev, compute_dtype=dtype)
        model.load_state_dict(pref["g_weights"], strict=True)
        disc = Discriminator(f_maps=8, kernel=3, dtype=bf16 if dtype == "bfloat16" else None)
        disc.load_state_dict(pref["d_weights"], strict=True)
        reset()
        _, g = make_grad_fn(model, disc.to(dev), TrainConfig(crop_size=(16, 16, 16)))(
            x, mask, keep, deterministic=True)
        torch.cuda.synchronize()
        if read() != per_step or not finite(*g.values()):
            fail(f"{dtype} G gradient at 16^3: launches {read()} (expected {per_step}), "
                 f"finite {finite(*g.values())}")
        shares[dtype] = bf16_gradient_share({n: t.double().cpu().numpy() for n, t in g.items()},
                                            pref)
    if not shares["bfloat16"] <= GRAD_SHARE:
        fail(f"bf16 G gradient at 16^3: its distance from JAX's bf16 gradient is "
             f"{shares['bfloat16']:.3f} of JAX's own bf16-vs-fp32 distance, beyond "
             f"{GRAD_SHARE} (the fp32 gradient's {shares['float32']:.3f})")
    line = (f"bf16 G gradient 16^3 against JAX's bf16 gradient on the same weights: "
            f"distance {shares['bfloat16']:.3f} of JAX's bf16-vs-fp32 distance (bound "
            f"{GRAD_SHARE}; the fp32 gradient {shares['float32']:.3f}) | launches "
            f"{per_step}")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model, disc, g, x, mask

    # 3. the bf16 G+D step at the TrainConfig crop
    cfg = TrainConfig()
    crop = tuple(cfg.crop_size)
    x, mask = synthetic_batch(gen, dev, crop)
    keep6 = subset_mask(6, dev)

    def build(dtype, remat=False):
        model = find_model_using_name("XLSTM_HVED", device=dev, seed=0, compute_dtype=dtype,
                                      remat=remat)
        disc = Discriminator(f_maps=cfg.disc_f_maps, kernel=cfg.disc_kernel,
                             dtype=bf16 if dtype == "bfloat16" else None)
        state = create_train_state(model, disc, cfg, seed=0, sample=x,
                                   init_scheme="reference")
        return model, disc, state

    def grads_of(model, disc):
        reset()
        _, g = make_grad_fn(model, disc, cfg)(x, mask, keep6, deterministic=True)
        torch.cuda.synchronize()
        if read() != per_step:
            fail(f"make_grad_fn ({model.cfg.compute_dtype}, remat {model.cfg.remat}) "
                 f"launched {read()}, expected {per_step}")
        return g

    def timed_steps(model, disc, state, n=2):
        step = make_train_step(model, disc, cfg)
        state, _ = step(state, x, mask)   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        times = []
        for _ in range(n):
            t = time.perf_counter()
            state, m = step(state, x, mask)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            if not all(math.isfinite(float(v)) for v in m.values()):
                fail(f"{model.cfg.compute_dtype} step (remat {model.cfg.remat}): non-finite "
                     f"metrics {m}")
        if read() != {k: n * v for k, v in per_step.items()}:
            fail(f"{n} steps ({model.cfg.compute_dtype}, remat {model.cfg.remat}) launched "
                 f"{read()}, expected {per_step} per step")
        return statistics.median(times), gib(), (step, state)

    g32_model, g32_disc, _ = build("float32")
    g16_model, g16_disc, state16 = build("bfloat16")
    g16_model.load_state_dict(g32_model.state_dict())
    g16_disc.load_state_dict(g32_disc.state_dict())
    torch.backends.cudnn.deterministic = True
    try:
        ref32 = grads_of(g32_model, g32_disc)
        got16 = grads_of(g16_model, g16_disc)
    finally:
        torch.backends.cudnn.deterministic = False
    rel = sorted((float((got16[n] - r).norm()) / max(float(r.norm()), 1e-30), n)
                 for n, r in ref32.items())
    median = statistics.median(v for v, _ in rel)
    flat = lambda g: torch.cat([t.flatten() for t in g.values()])
    whole = float((flat(got16) - flat(ref32)).norm()) / float(flat(ref32).norm())
    grad_median = PRECISION_FACTOR * statistics.median(v for n, v in jax_ref.items()
                                        if n.startswith("grad.rel_l2."))
    grad_all = PRECISION_FACTOR * jax_ref["grad.rel_l2_all"]
    if not (finite(*got16.values()) and median <= grad_median and whole <= grad_all):
        fail(f"bf16 G gradient against fp32: median per-tensor relative L2 {median:.3e} "
             f"(bound {grad_median:.3e}), all tensors {whole:.3e} (bound {grad_all:.3e})")
    del ref32, got16, g32_model, g32_disc
    torch.cuda.empty_cache()
    ms16, peak16, (step16, state16) = timed_steps(g16_model, g16_disc, state16)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state16, _ = step16(state16, x, mask)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    wgrad = sum(e.self_device_time_total for e in kernels if "wgrad" in e.key.lower()) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:4]
    line = (f"bf16 G+D step {'x'.join(map(str, crop))}: {ms16:.1f} ms (fp32 "
            f"{fp32_ref['step_ms']:.1f} ms, phase 6), peak {peak16:.2f} GiB (fp32 "
            f"{fp32_ref['peak_gib']:.2f}) | G gradient vs fp32, relative L2 per tensor median "
            f"{median:.3e} (bound {grad_median:.3f}), worst {rel[-1][0]:.3e} "
            f"({rel[-1][1]}), all tensors {whole:.3e} (bound {grad_all:.3f}) | one "
            f"profiled step: device busy {busy:.1f} ms, kernels named *wgrad* {wgrad:.1f} ms "
            f"({wgrad / busy:.3f})")
    print(f"  {line}", flush=True)
    for e in top:
        ms = e.self_device_time_total / 1e3
        print(f"    {ms:9.1f} ms ({ms / busy:.3f}) x{e.count:<4d} {e.key[:100]}", flush=True)
    lines.append(line)
    del g16_model, g16_disc, state16, step16, prof
    torch.cuda.empty_cache()

    # 4. remat: the same step, fp32 and bf16, with and without it
    for dtype in ("float32", "bfloat16"):
        plain_model, plain_disc, plain_state = build(dtype)
        remat_model, remat_disc, remat_state = build(dtype, remat=True)
        remat_model.load_state_dict(plain_model.state_dict())
        remat_disc.load_state_dict(plain_disc.state_dict())
        torch.backends.cudnn.deterministic = True
        try:
            with deterministic_upsampling():
                det = [grads_of(m, d) for m, d in ((plain_model, plain_disc),
                                                   (remat_model, remat_disc),
                                                   (plain_model, plain_disc))]
            plains = [grads_of(plain_model, plain_disc) for _ in range(NOISE_RUNS)]
            g_r = grads_of(remat_model, remat_disc)
        finally:
            torch.backends.cudnn.deterministic = False
        n_tensors = len(g_r)
        det_remat = sum(torch.equal(det[1][n], det[0][n]) for n in det[0])
        det_plain = sum(torch.equal(det[2][n], det[0][n]) for n in det[0])
        if det_remat != n_tensors:
            fail(f"{dtype} remat gradients with the deterministic upsampling: "
                 f"{det_remat}/{n_tensors} tensors bitwise equal to the step without remat "
                 f"(plain against plain {det_plain}/{n_tensors})")
        top = max(absmax(g) for g in plains[0].values())
        noise = max(absmax(a[n] - b[n]) / top for i, a in enumerate(plains)
                    for b in plains[i + 1:] for n in a)
        worst = max((max(absmax(g_r[n] - p[n]) for p in plains) / top, n) for n in g_r)
        bitwise = sum(torch.equal(g_r[n], plains[0][n]) for n in g_r)
        if worst[0] > REMAT_NOISE * noise + REMAT_SCALED:
            fail(f"{dtype} remat gradients: worst max|d| {worst[0]:.3e} of the largest "
                 f"gradient ({worst[1]}), beyond {REMAT_NOISE} x the run-to-run noise "
                 f"{noise:.3e} (the largest of {NOISE_RUNS} plain runs' pairs) + "
                 f"{REMAT_SCALED}")
        del det, plains, g_r
        if dtype == "float32":
            ms_plain, peak_plain = fp32_ref["step_ms"], fp32_ref["peak_gib"]
            src = "phase 6"
        else:
            ms_plain, peak_plain = ms16, peak16
            src = "above"
        del plain_model, plain_disc, plain_state
        torch.cuda.empty_cache()
        ms_r, peak_r, _ = timed_steps(remat_model, remat_disc, remat_state)
        line = (f"{dtype} step with remat: {ms_r:.1f} ms ({ms_r / ms_plain:.3f} x the "
                f"{ms_plain:.1f} ms without, {src}), peak {peak_r:.2f} GiB ({peak_plain:.2f} "
                f"without, {peak_plain - peak_r:.2f} GiB less) | gradients vs without remat, "
                f"deterministic upsampling: {det_remat}/{n_tensors} bitwise (plain vs plain "
                f"{det_plain}/{n_tensors}); the model's own: {bitwise}/{n_tensors} bitwise, "
                f"worst max|d| {worst[0]:.3e} of the largest gradient ({worst[1]}), "
                f"run-to-run noise {noise:.3e} (bound {REMAT_NOISE * noise + REMAT_SCALED:.3e}) | "
                f"launches per step {per_step}")
        print(f"  {line}", flush=True)
        lines.append(line)
        del remat_model, remat_disc, remat_state
        torch.cuda.empty_cache()
    return {"summary": " | ".join(lines)}


ZOO_PRESETS = ("U_HVEDNet3D", "FusionUNet3D")
ZOO_F64_CROP = (64, 64, 64)
ZOO_READS = 3   # the native and Python readers' timings: median of 3


def mlstm_counters():
    from xlstm_hved_torch.ops import mlstm_cuda as mc

    return {"mlstm_fwd": mc.run_kernel, "mlstm_fwd_states": mc.run_states_kernel,
            "mlstm_bwd": mc.run_bwd_kernel}


def zoo_forwards(dev, gen, lines):
    """Phase 10, 1: the two presets' forwards in fp32 and bf16 at both crops
    (no mLSTM launch; ms, peak, bf16 vs fp32) and the fp32 forward at 64^3
    against an fp64 copy on the card."""
    import copy

    import torch
    from xlstm_hved_torch.models import find_model_using_name

    counters = mlstm_counters()
    keep = torch.ones(4, dtype=torch.bool, device=dev)
    for name in ZOO_PRESETS:
        m32 = find_model_using_name(name, device=dev, seed=0)
        m16 = find_model_using_name(name, device=dev, seed=0, compute_dtype="bfloat16")
        m16.load_state_dict(m32.state_dict(), strict=True)
        for crop in CROPS:
            key = "x".join(map(str, crop))
            x = torch.rand(1, 4, *crop, generator=gen, device=dev)
            outs, ms, peak = {}, {}, {}
            for label, model in (("fp32", m32), ("bf16", m16)):
                run = lambda m=model: m(x, keep=keep, recon=True, deterministic=True)
                with torch.inference_mode():
                    for c in counters.values():
                        c.launches = 0
                    torch.cuda.reset_peak_memory_stats(dev)
                    out = run()
                    torch.cuda.synchronize()
                    peak[label] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                    launches = sum(c.launches for c in counters.values())
                    ms[label] = cuda_ms(run, warmup=1, iters=3)
                if launches:
                    fail(f"{name} {label} forward at {crop}: {launches} mLSTM launches, "
                         "expected none (the preset has no ViL)")
                if out.seg.shape != (1, 3, *crop) or out.recon.shape != (1, 4, *crop):
                    fail(f"{name} {label} forward at {crop}: shapes {tuple(out.seg.shape)}, "
                         f"{tuple(out.recon.shape)}")
                if out.seg.dtype != torch.float32 or not finite(out.seg, out.recon):
                    fail(f"{name} {label} forward at {crop}: seg {out.seg.dtype}, finite "
                         f"{finite(out.seg, out.recon)}")
                if not (0.0 <= float(out.seg.min()) and float(out.seg.max()) <= 1.0):
                    fail(f"{name} {label} forward at {crop}: seg outside [0, 1]")
                outs[label] = out
            stats = []
            for head in ("seg", "recon"):
                d = (getattr(outs["bf16"], head) - getattr(outs["fp32"], head)).abs().flatten()
                p999 = float(d.kthvalue(max(1, int(round(0.999 * d.numel())))).values)
                stats.append(f"{head} mean {float(d.mean()):.3e} p99.9 {p999:.3e} "
                             f"max {float(d.max()):.3e}")
            line = (f"{name} forward {key}: fp32 {ms['fp32']:.2f} ms, peak "
                    f"{peak['fp32']:.2f} GiB; bf16 {ms['bf16']:.2f} ms, peak "
                    f"{peak['bf16']:.2f} GiB | bf16 vs fp32 |d|: " + "; ".join(stats)
                    + " | mLSTM launches 0")
            print(f"  {line}", flush=True)
            lines.append(line)
            del x, outs, out
        x = torch.rand(1, 4, *ZOO_F64_CROP, generator=gen, device=dev)
        m64 = copy.deepcopy(m32).double()
        with torch.inference_mode():
            out = m32(x, keep=keep, recon=True, deterministic=True)
            ref = m64(x.double(), keep=keep, recon=True, deterministic=True)
        seg_d, rec_d = absmax(out.seg.double() - ref.seg), absmax(out.recon.double() - ref.recon)
        if seg_d > SEG_ATOL or rec_d > RECON_ATOL:
            fail(f"{name} fp32 forward at {ZOO_F64_CROP} against fp64: seg max|d| "
                 f"{seg_d:.3e}, recon {rec_d:.3e} (bounds {SEG_ATOL}, {RECON_ATOL})")
        line = (f"{name} fp32 forward {'x'.join(map(str, ZOO_F64_CROP))} vs fp64: seg max|d| "
                f"{seg_d:.3e}, recon max|d| "
                f"{rec_d:.3e} (bounds {SEG_ATOL}, {RECON_ATOL})")
        print(f"  {line}", flush=True)
        lines.append(line)
        del m32, m16, m64, x, out, ref
        torch.cuda.empty_cache()


def zoo_sweeps(dev, gen, lines):
    """Phase 10, 2: the 15-subset sweep of one 128x192x128 volume, patch
    128^3: U_HVEDNet3D's hoisted sweep against its plain one, bitwise (plain,
    hoisted, hoisted, plain); FusionUNet3D's plain sweep with subset_chunk 5,
    as the eval CLI runs it."""
    import torch
    from xlstm_hved_torch.engine.evaluate import (default_apply_fn, make_hoisted_subset_sweep,
                                                  make_subset_sweep)
    from xlstm_hved_torch.models import find_model_using_name

    patch = CROPS[0]
    x = torch.rand(1, 4, *CROPS[1], generator=gen, device=dev)

    def timed(sweep, model):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        result = sweep(model, x)
        torch.cuda.synchronize()
        return result, time.perf_counter() - t, torch.cuda.max_memory_allocated(dev) / 2 ** 30

    model = find_model_using_name("U_HVEDNet3D", device=dev, seed=0)
    sweeps = {"hoisted": make_hoisted_subset_sweep(model, patch, recon_channels=4),
              "plain": make_subset_sweep(default_apply_fn(model, recon=True), patch,
                                         recon_channels=4)}
    outs, secs, peaks = {}, {"hoisted": [], "plain": []}, {}
    for kind in ("plain", "hoisted", "hoisted", "plain"):
        outs[kind], sec, peaks[kind] = timed(sweeps[kind], model)
        secs[kind].append(sec)
    (seg_h, rec_h), (seg_p, rec_p) = outs["hoisted"], outs["plain"]
    if not finite(seg_h, rec_h) or not (torch.equal(seg_h, seg_p) and torch.equal(rec_h, rec_p)):
        fail(f"U_HVEDNet3D hoisted vs plain sweep: seg max|d| {absmax(seg_h - seg_p):.3e}, "
             f"recon {absmax(rec_h - rec_p):.3e}; expected bit for bit")
    vol = "x".join(map(str, CROPS[1]))
    line = (f"U_HVEDNet3D sweep {vol} (2 windows x 15 subsets): hoisted "
            f"{secs['hoisted'][0]:.3f}, {secs['hoisted'][1]:.3f} s (peak "
            f"{peaks['hoisted']:.2f} GiB) vs plain {secs['plain'][0]:.3f}, "
            f"{secs['plain'][1]:.3f} s (peak {peaks['plain']:.2f} GiB); bit for bit")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model, sweeps, outs, seg_h, rec_h, seg_p, rec_p
    torch.cuda.empty_cache()

    model = find_model_using_name("FusionUNet3D", device=dev, seed=0)
    sweep = make_subset_sweep(default_apply_fn(model, recon=True), patch, recon_channels=4,
                              subset_chunk=5)
    (segs, recs), sec, peak = timed(sweep, model)
    if segs.shape != (15, 1, 3, *CROPS[1]) or not finite(segs, recs):
        fail(f"FusionUNet3D sweep: shape {tuple(segs.shape)}, finite {finite(segs, recs)}")
    # where only the first window reaches along H, the all-modality subset is
    # that window's forward itself
    only_first = CROPS[1][1] - patch[1]
    with torch.inference_mode():
        first = model(x[:, :, :, :patch[1]], recon=True, deterministic=True)
    d_first = absmax(segs[14][..., :only_first, :] - first.seg[..., :only_first, :])
    if d_first > SEG_ATOL:
        fail(f"FusionUNet3D sweep subset 14 differs from its first window by {d_first:.3e}")
    line = (f"FusionUNet3D plain sweep {vol}, subset_chunk 5: {sec:.3f} s, peak "
            f"{peak:.2f} GiB; all-modality subset vs its first window max|d| {d_first:.3e}")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model, sweep, segs, recs, first, x
    torch.cuda.empty_cache()


def zoo_train(dev, gen, lines):
    """Phase 10, 3: the U_HVEDNet3D G+D step at 128x192x128 at the bf16
    defaults (G and D bf16, Discriminator(64, 4), init "reference"): G and D
    move, losses finite, ms and peak; with remat, the G gradient bitwise the
    one without (cuDNN deterministic, phase 9's deterministic upsampling)
    and its peak; then FusionUNet3D's step raises as the JAX step does."""
    import torch
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine.train import (create_train_state, make_grad_fn,
                                               make_train_step)
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.utils.subsets import subset_mask

    cfg = TrainConfig()
    crop = tuple(cfg.crop_size)
    bf16 = torch.bfloat16
    model = find_model_using_name("U_HVEDNet3D", device=dev, seed=0, compute_dtype="bfloat16")
    disc = Discriminator(f_maps=cfg.disc_f_maps, kernel=cfg.disc_kernel, dtype=bf16)
    x, mask = synthetic_batch(gen, dev, crop)
    state = create_train_state(model, disc, cfg, seed=0, sample=x, init_scheme="reference")
    counters = mlstm_counters()

    # remat against the same gradient without it, bitwise
    remat = find_model_using_name("U_HVEDNet3D", device=dev, compute_dtype="bfloat16",
                                  remat=True)
    remat.load_state_dict(model.state_dict(), strict=True)
    keep = subset_mask(6, dev)
    grads, peaks = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        with deterministic_upsampling():
            for label, m in (("plain", model), ("plain again", model), ("remat", remat)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                _, grads[label] = make_grad_fn(m, disc, cfg)(x, mask, keep, deterministic=True)
                torch.cuda.synchronize()
                peaks[label] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    finally:
        torch.backends.cudnn.deterministic = False
    for label in ("plain again", "remat"):
        differ = [n for n, g in grads["plain"].items() if not torch.equal(grads[label][n], g)]
        if differ:
            fail(f"U_HVEDNet3D {label} G gradient differs from the plain one in "
                 f"{len(differ)} of {len(grads['plain'])} tensors: {differ[:4]}")
    n_grads = len(grads["plain"])
    del remat, grads
    torch.cuda.empty_cache()

    step = make_train_step(model, disc, cfg)
    g_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    d_before = {n: p.detach().clone() for n, p in disc.named_parameters()}
    stats_before = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    state, _ = step(state, x, mask)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    times, metrics = [], []
    for _ in range(3):
        t = time.perf_counter()
        state, m = step(state, x, mask)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    launches = sum(c.launches for c in counters.values())
    bad = [k for m in metrics for k, v in m.items() if not math.isfinite(float(v))]
    g_moved = sum(not torch.equal(g_before[n], p) for n, p in model.named_parameters())
    d_moved = sum(not torch.equal(d_before[n], p) for n, p in disc.named_parameters())
    s_moved = sum(not torch.equal(stats_before[n], b) for n, b in model.named_buffers()
                  if n in stats_before)
    if (bad or launches or g_moved < 0.9 * len(g_before) or d_moved != len(d_before)
            or s_moved != len(stats_before)):
        fail(f"U_HVEDNet3D train steps: non-finite {bad}, {launches} mLSTM launches, moved G "
             f"{g_moved}/{len(g_before)} D {d_moved}/{len(d_before)} running statistics "
             f"{s_moved}/{len(stats_before)}")
    line = (f"U_HVEDNet3D bf16 G+D step {'x'.join(map(str, crop))}: "
            f"{statistics.median(times):.1f} ms median of {['%.1f' % t for t in times]}, "
            f"peak {peak:.2f} GiB | loss {float(metrics[-1]['loss']):.4f} | moved G "
            f"{g_moved}/{len(g_before)} D {d_moved}/{len(d_before)} running statistics "
            f"{s_moved}/{len(stats_before)} | G gradient with remat bitwise the plain one "
            f"({n_grads} tensors; plain twice bitwise), peak {peaks['remat']:.2f} GiB against "
            f"{peaks['plain']:.2f} GiB | mLSTM launches 0")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model, disc, state, step, x, mask, g_before, d_before
    torch.cuda.empty_cache()

    small = (32, 32, 32)
    fusion = find_model_using_name("FusionUNet3D", device=dev, seed=0)
    disc = Discriminator(f_maps=8, kernel=3)
    xs, ms = synthetic_batch(gen, dev, small)
    fstate = create_train_state(fusion, disc, TrainConfig(crop_size=small), seed=0, sample=xs)
    try:
        make_train_step(fusion, disc, TrainConfig(crop_size=small))(fstate, xs, ms)
    except ValueError as e:
        if "at least one array to stack" not in str(e):
            raise
        line = f"FusionUNet3D train step raises as the JAX step does: ValueError({e})"
    else:
        fail("FusionUNet3D train step ran; the JAX step raises (a mean over no KL terms)")
    print(f"  {line}", flush=True)
    lines.append(line)


def zoo_cli(dev, root, lines):
    """Phase 10, 4: cli.train --model_name U_HVEDNet3D one epoch on phase 7's
    dataset at the CLI defaults, then cli.test on its best_dice checkpoint
    with --compute_hd95; no mLSTM launch in either."""
    import contextlib
    import io

    import numpy as np
    import torch
    from xlstm_hved_torch.cli import test as test_main
    from xlstm_hved_torch.cli import train as train_main
    from xlstm_hved_torch.engine.checkpoint import CheckpointManager

    counters = mlstm_counters()
    train_dir, valid_dir = os.path.join(root, "train"), os.path.join(root, "valid")
    out = os.path.join(root, "results")
    name = "U_HVEDNet3D"
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    summary = train_main.main(["--device", str(dev), "--num_epochs", "1", "--train_dir",
                               train_dir, "--valid_dir", valid_dir, "--out_dir", out,
                               "--model_name", name])
    torch.cuda.synchronize()
    train_s, train_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated(dev) / 2 ** 30
    ckpt = CheckpointManager(os.path.join(out, name))
    if not all(ckpt.exists(n) for n in ("latest", "best_vloss", "best_dice")):
        fail(f"cli.train {name}: latest / best_vloss / best_dice missing")
    epoch = summary["epochs"][0]
    steps, sp = epoch["steps"], epoch["spans"]
    buf = io.StringIO()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = test_main.main(["--device", str(dev), "--valid_dir", valid_dir, "--out_dir",
                                 out, "--model_name", name, "--compute_hd95"])
    torch.cuda.synchronize()
    test_s, test_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated(dev) / 2 ** 30
    text = buf.getvalue().splitlines()
    launches = sum(c.launches for c in counters.values())
    if "restored checkpoint best_dice" not in text or result["volumes"] != 1:
        fail(f"cli.test {name}: {result['volumes']} volumes, restored line "
             f"{'restored checkpoint best_dice' in text}")
    for key in ("dice", "hd95"):
        if not np.isfinite(result[key]).all():
            fail(f"cli.test {name}: non-finite {key}: {result[key]}")
    if launches:
        fail(f"cli.train / cli.test {name}: {launches} mLSTM launches, expected none")
    vol = result["per_volume"][0]
    line = (f"cli.train --model_name {name}: {train_s:.2f} s, {steps} steps, "
            f"{sp['train_step'] / steps:.3f} s per step, loader wait "
            f"{sp['train_wait'] / steps:.3f} s per step, peak {train_peak:.2f} GiB | cli.test on "
            f"best_dice with --compute_hd95: {test_s:.2f} s, volume {vol['seconds']:.2f} s "
            f"(sweep {vol['spans']['sweep']:.3f} s, hd95 {vol['spans']['hd95']:.3f} s), peak "
            f"{test_peak:.2f} GiB, mean Dice {float(np.mean(result['dice'])):.4f} | mLSTM "
            "launches 0")
    print(f"  {line}", flush=True)
    lines.append(line)


def zoo_native(root, lines, loader_wait):
    """Phase 10, 5: the native decoder on phase 7's 240x240x155 subjects,
    bitwise the Python reader on every file, and both readers' seconds per
    subject (4 modality files), median of ZOO_READS; phase 7's loader wait,
    at the native default."""
    import numpy as np
    from xlstm_hved_torch.data import native
    from xlstm_hved_torch.data.brats import BraTSDataset
    from xlstm_hved_torch.data.nifti import read_nifti

    suffixes = ("t1c", "t1n", "t2f", "t2w")
    files, t_native, t_python = 0, [], []
    for split in ("train", "valid"):
        data_dir = os.path.join(root, split)
        if not BraTSDataset(data_dir).use_native:
            fail(f"BraTSDataset({data_dir}) did not resolve to the native decoder on "
                 f"{os.cpu_count()} cores")
        for subject in sorted(os.listdir(data_dir)):
            for suffix in suffixes + ("seg",):
                path = os.path.join(data_dir, subject, f"{subject}-{suffix}.nii.gz")
                a, b = native.native_read_nifti(path), read_nifti(path)[0]
                if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                        a.view(np.uint32), b.view(np.uint32)):
                    fail(f"native decoder: {path} differs from the Python reader")
                files += 1
            for _ in range(ZOO_READS):
                t = time.perf_counter()
                native.native_read_subject(data_dir, subject, suffixes)
                t_native.append(time.perf_counter() - t)
                t = time.perf_counter()
                np.stack([read_nifti(os.path.join(data_dir, subject, f"{subject}-{s}.nii.gz"))[0]
                          for s in suffixes])
                t_python.append(time.perf_counter() - t)
    line = (f"native decoder: {files} files of phase 7's {'x'.join(map(str, CLI_SHAPE))} "
            f"subjects bit for bit the Python reader's | per subject (4 modality files, one "
            f"thread each) {statistics.median(t_native):.3f} s against the Python reader's "
            f"{statistics.median(t_python):.3f} s, median of "
            f"{len(t_native)} | phase 7's loader wait at the native default: "
            + ", ".join(f"{k} {v:.3f} s per step" for k, v in loader_wait.items()))
    print(f"  {line}", flush=True)
    lines.append(line)


def zoo_patch_probe(dev, lines):
    """Phase 10, 6: find_maximum_patch_size for the flagship forward."""
    import torch
    from xlstm_hved_torch.models import find_model_using_name
    from xlstm_hved_torch.utils.schedules import DEFAULT_PATCH_SHAPES, find_maximum_patch_size

    model = find_model_using_name("XLSTM_HVED", device=dev, seed=0)

    @torch.inference_mode()
    def forward(x):
        return model(x, recon=True, deterministic=True)

    t = time.perf_counter()
    best = find_maximum_patch_size(forward, 4, DEFAULT_PATCH_SHAPES, dev)
    sec = time.perf_counter() - t
    if best not in DEFAULT_PATCH_SHAPES:
        fail(f"find_maximum_patch_size returned {best}, not a shape of the list")
    line = (f"find_maximum_patch_size, XLSTM_HVED forward: {best} of "
            f"{len(DEFAULT_PATCH_SHAPES)} shapes, {sec:.2f} s")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model
    torch.cuda.empty_cache()


XLSTM_PLANS_3D = {"patch_size": [128, 128, 128], "conv_kernel_sizes": [[3, 3, 3]] * 6,
                  "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 5,
                  "n_conv_per_stage_encoder": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
                  "UNet_base_num_features": 32, "unet_max_num_features": 320}
# the last pool halves only the 192 axis: 160 / 32 = 5 cannot be halved
# again (nnU-Net pools an axis no further then); with [2, 2] there the
# channel-token schedule's floor division (3 x 2 voxels, ViL dim 6) and the
# stride-2 convs' map (3 x 3) disagree, and neither package builds the net
XLSTM_PLANS_2D = {"patch_size": [192, 160], "conv_kernel_sizes": [[3, 3]] * 7,
                  "pool_op_kernel_sizes": [[1, 1]] + [[2, 2]] * 5 + [[2, 1]],
                  "n_conv_per_stage_encoder": [2] * 7, "n_conv_per_stage_decoder": [2] * 6,
                  "UNet_base_num_features": 32, "unet_max_num_features": 512}


def xlstm_models():
    """Phase 11's forwards: (label, build(mlstm_kernel) -> module, input
    shape, ViL layers, so mlstm_fwd launches per forward)."""
    from xlstm_hved_torch.models import build_uxlstm_from_plans
    from xlstm_hved_torch.models.vision_lstm import (ViL3DPatchEncoder, VisionLSTM,
                                                     VisionLSTM3D)

    def plans(p, variant):
        return lambda k: build_uxlstm_from_plans(p, 4, 4, True, variant, mlstm_kernel=k)

    return (("UXlstmEnc 3-D", plans(XLSTM_PLANS_3D, "enc"), (2, 4, 128, 128, 128), 3),
            ("UXlstmBot 3-D", plans(XLSTM_PLANS_3D, "bot"), (2, 4, 128, 128, 128), 1),
            ("UXlstmEnc 2-D", plans(XLSTM_PLANS_2D, "enc"), (2, 4, 192, 160), 3),
            ("UXlstmBot 2-D", plans(XLSTM_PLANS_2D, "bot"), (2, 4, 192, 160), 1),
            ("VisionLSTM", lambda k: VisionLSTM(mlstm_kernel=k), (1, 3, 224, 224), 12),
            ("VisionLSTM3D", lambda k: VisionLSTM3D(mlstm_kernel=k), (1, 4, 128, 128, 128), 12),
            ("ViL3DPatchEncoder", lambda k: ViL3DPatchEncoder(mlstm_kernel=k),
             (1, 4, 128, 128, 128), 8))


def _seeded_pair(build, dev, seed: int = 0):
    """The model through the kernels and its twin through the plain mLSTM,
    on the same seeded weights, in eval mode on `dev`."""
    model = _seeded_module(lambda: build(None), seed)
    plain = build(False)
    plain.load_state_dict(model.state_dict())
    return model.to(dev).eval(), plain.to(dev).eval()


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def xlstm_forwards(dev, gen, lines):
    """Phase 11, 1: every xLSTM model's forward through the kernels against
    the plain mLSTM (phase 4's bound), its launches, ms and peak. Returns
    the mlstm_fwd launches of the kernel forwards."""
    import torch
    from xlstm_hved_torch.ops import mlstm_cuda as mc

    total = 0
    for label, build, shape, vil_layers in xlstm_models():
        model, plain = _seeded_pair(build, dev)
        x = torch.rand(*shape, generator=gen, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            mc.run_kernel.launches = 0
            out = _outputs(model(x))
            torch.cuda.synchronize()
            launches = mc.run_kernel.launches
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            ref = _outputs(plain(x))
            if launches != vil_layers:
                fail(f"{label} forward: {launches} mlstm_fwd launches, expected {vil_layers}")
            if not finite(*out):
                fail(f"{label} forward: non-finite output")
            errs = [absmax(o - r) for o, r in zip(out, ref)]
            if max(errs) > SEG_ATOL:
                fail(f"{label} forward: kernel vs plain mLSTM max|d| {max(errs):.3e} "
                     f"(bound {SEG_ATOL})")
            ms = cuda_ms(lambda: model(x), warmup=1, iters=3)
            ms_plain = cuda_ms(lambda: plain(x), warmup=1, iters=3)
        line = (f"{label} forward {tuple(shape)}: {ms:.2f} ms with the kernels, {ms_plain:.2f} "
                f"ms with the plain mLSTM, peak {peak:.2f} GiB | outputs "
                f"{[tuple(o.shape) for o in out]}, kernel vs plain max|d| {max(errs):.3e} "
                f"(max|out| {max(absmax(o) for o in out):.3e}) | mlstm_fwd launches {launches}")
        print(f"  {line}", flush=True)
        lines.append(line)
        total += launches
        del model, plain, x, out, ref
        torch.cuda.empty_cache()
    return total


def xlstm_hemis(dev, gen, lines):
    """Phase 11, 2: U_HeMIS at 128^3 from the registry: finite, seg a
    softmax, no mLSTM launch; a zeroed modality inferred equals the keep
    mask given."""
    import torch
    from xlstm_hved_torch.models import find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc

    model = find_model_using_name("U_HeMIS", device=dev, seed=0)
    x = torch.rand(1, 4, 128, 128, 128, generator=gen, device=dev)
    x[:, 2] = 0.0
    keep = torch.tensor([True, True, False, True], device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        mc.run_kernel.launches = 0
        seg, recon = model(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        seg_k, recon_k = model(x, keep=keep)
        if mc.run_kernel.launches:
            fail(f"U_HeMIS: {mc.run_kernel.launches} mlstm_fwd launches, expected 0")
        if seg.shape != (1, 3, 128, 128, 128) or recon.shape != (1, 4, 128, 128, 128):
            fail(f"U_HeMIS shapes {tuple(seg.shape)}, {tuple(recon.shape)}")
        if not finite(seg, recon) or absmax(seg.sum(1) - 1.0) > 1e-5:
            fail("U_HeMIS: non-finite output or seg not a softmax over classes")
        d_keep = max(absmax(seg - seg_k), absmax(recon - recon_k))
        if d_keep != 0.0:
            fail(f"U_HeMIS: the inferred keep mask differs from the given one ({d_keep:.3e})")
        ms = cuda_ms(lambda: model(x), warmup=1, iters=3)
    line = (f"U_HeMIS forward (1, 4, 128, 128, 128): {ms:.2f} ms, peak {peak:.2f} GiB, "
            f"a modality zeroed: inferred keep == given keep bit for bit, mlstm_fwd launches 0")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model, x, seg, recon, seg_k, recon_k
    torch.cuda.empty_cache()


def xlstm_gradient(dev, gen, lines):
    """Phase 11, 3: one UXlstmEnc 3-D backward at batch 2 of a seeded
    weighted sum of its deep-supervision outputs, through the kernels
    against the plain mLSTM, per tensor to phase 6's rule. Returns the
    launches of the kernel path."""
    import torch

    label, build, shape, vil_layers = xlstm_models()[0]
    model, plain = _seeded_pair(build, dev)
    x = torch.rand(*shape, generator=gen, device=dev)
    with torch.no_grad():
        weights = [torch.randn(o.shape, generator=gen, device=dev)
                   for o in _outputs(model(x[:1]))]
        weights = [w.expand(shape[0], *w.shape[1:]) for w in weights]
    counters = mlstm_counters()

    def grads(m):
        params = [p for _, p in m.named_parameters()]
        loss = sum((o * w).sum() for o, w in zip(_outputs(m(x)), weights))
        return float(loss.detach()), torch.autograd.grad(loss, params)

    torch.backends.cudnn.deterministic = True
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters.values():
            fn.launches = 0
        loss_k, got = grads(model)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        launches = {name: fn.launches for name, fn in counters.items()}
        loss_p, want = grads(plain)
        _, want2 = grads(plain)   # the run-to-run noise of the atomics left in the backward
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    # the time of a warm call on cuDNN's default algorithms (the first call
    # above also picks and sets up the deterministic ones)
    timed = []
    for _ in range(2):
        t0 = time.perf_counter()
        grads(model)
        torch.cuda.synchronize()
        timed.append(1e3 * (time.perf_counter() - t0))
    step_ms = timed[-1]
    if launches != dict.fromkeys(counters, vil_layers):
        fail(f"{label} gradient: launches {launches}, expected {vil_layers} of each")
    names = [n for n, _ in model.named_parameters()]
    floor = GRAD_FLOOR * max(absmax(t) for t in want)
    table = []
    for name, g, r, r2 in zip(names, got, want, want2):
        if not finite(g):
            fail(f"{label} gradient {name}: not finite")
        err, top = absmax(g - r), absmax(r)
        table.append((err / (GRAD_SCALED * top + floor), name, err, absmax(r2 - r), top))
    table.sort(reverse=True)
    share, name, err, noise, top = table[0]
    if share > 1.0:
        fail(f"{label} gradient {name}: kernel vs plain max|d| {err:.3e}, max|ref| {top:.3e}, "
             f"plain vs plain {noise:.3e} (bound {GRAD_SCALED} * max|ref| + {floor:.3e})")
    vil_share = max(t[0] for t in table if ".vil." in t[1])
    line = (f"{label} gradient at batch 2 ({len(table)} tensors): {step_ms:.1f} ms forward and "
            f"backward (the second of two calls on cuDNN's default algorithms; the first "
            f"{timed[0]:.1f} ms), peak "
            f"{peak:.2f} GiB, loss |d| {abs(loss_k - loss_p):.3e}, "
            f"worst {share:.3f} of the bound ({name}: max|d| {err:.3e}, plain vs plain "
            f"{noise:.3e}), worst ViL tensor {vil_share:.3f}; launches {launches}")
    print(f"  {line}", flush=True)
    lines.append(line)
    del model, plain, x, got, want, want2
    torch.cuda.empty_cache()
    return launches


def check_xlstm(dev, gen):
    """Phase 11, the xLSTM model families. Returns the launches of each
    kernel and a summary."""
    lines = []
    fwd_launches = xlstm_forwards(dev, gen, lines)
    xlstm_hemis(dev, gen, lines)
    launches = xlstm_gradient(dev, gen, lines)
    launches["mlstm_fwd"] += fwd_launches
    return {"launches": launches,
            "summary": f"{len(lines)} checks: " + " | ".join(l.split(":")[0] for l in lines)}


def check_zoo(dev, gen, root, loader_wait):
    """Phase 10, the last two presets, their sweeps, training and CLIs, the
    native decoder and the patch probe. Returns a summary."""
    lines = []
    zoo_forwards(dev, gen, lines)
    zoo_sweeps(dev, gen, lines)
    zoo_train(dev, gen, lines)
    zoo_cli(dev, root, lines)
    zoo_native(root, lines, loader_wait)
    zoo_patch_probe(dev, lines)
    return f"{len(lines)} checks: " + " | ".join(line.split(":")[0] for line in lines)


IMPORT_CROP = (128, 128, 128)   # the imported forwards and the blocks' finest scale
IMPORT_DUREG = (80, 80, 40)     # DuRegisterDuSE's upstream input size
IMPORT_BLOCK_OFFSET_STD = 1.5   # voxels: the gather interpolates and clamps


def _upstream_names():
    """The test-only inverse rename (tests/_torch_upstream_names.py, no JAX):
    the port's state dicts under upstream key names."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_upstream_names

    return _torch_upstream_names


def _seeded_module(build, seed: int):
    """build() under torch seed `seed` (the global RNG left as it was)."""
    import torch

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def _randomise_running_stats(model, gen):
    """Seeded BatchNorm running statistics, so an import must carry them."""
    import torch

    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=gen, device=buf.device))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen, device=buf.device))


def _bitwise(label, got, want, lines, launches=None, expected=None):
    got, want = _outputs(got), _outputs(want)
    d = max(absmax(g - w) for g, w in zip(got, want))
    if len(got) != len(want) or d != 0.0 or not finite(*got):
        fail(f"{label}: the imported model's output differs from its direct twin's "
             f"(max|d| {d:.3e}, finite {finite(*got)})")
    if expected is not None and launches != expected:
        fail(f"{label}: {launches} mlstm_fwd launches, expected {expected}")
    line = (f"{label}: imported == direct bit for bit on {[tuple(o.shape) for o in got]}"
            + ("" if launches is None else f", mlstm_fwd launches {launches}"))
    print(f"  {line}", flush=True)
    lines.append(line)


def import_flagship(dev, gen, root, lines):
    """Phase 12, 1: the flagship and its Discriminator written under upstream
    key names (as {'model_sd': ...} and as a bare dict), read back through
    load_reference_checkpoint / disc_params_from_torch into models seeded
    otherwise: the IMPORT_CROP seg+recon forward and D's output bit for bit
    the direct models'. Returns the imported forwards' mlstm_fwd launches."""
    import torch
    from xlstm_hved_torch.config import get_config
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc
    from xlstm_hved_torch.utils.torch_import import (disc_params_from_torch,
                                                     load_reference_checkpoint)

    names = _upstream_names()
    cfg = get_config("XLSTM_HVED")
    direct = find_model_using_name("XLSTM_HVED", device=dev, seed=0)
    _randomise_running_stats(direct, gen)
    disc = _seeded_module(lambda: Discriminator(f_maps=64, kernel=4), 0).to(dev).eval()
    upstream = {k: v.cpu() for k, v in names.hved_upstream(direct.state_dict(), cfg).items()}
    paths = {"model_sd": os.path.join(root, "xlstm_hved.pth"),
             "bare": os.path.join(root, "xlstm_hved_bare.pth")}
    torch.save({"model_sd": upstream, "epoch": 0}, paths["model_sd"])
    torch.save(upstream, paths["bare"])
    disc_path = os.path.join(root, "discriminator.pth")
    torch.save({k: v.cpu() for k, v in names.disc_upstream(disc.state_dict()).items()},
               disc_path)
    keep = torch.ones(4, dtype=torch.bool, device=dev)
    x = torch.rand(1, 4, *IMPORT_CROP, generator=gen, device=dev)
    total = 0
    crop = "x".join(map(str, IMPORT_CROP))
    with torch.inference_mode():
        want = direct(x, keep=keep, recon=True, deterministic=True)
        for form, path in paths.items():
            model = find_model_using_name("XLSTM_HVED", device=dev, seed=1)
            model.load_state_dict(load_reference_checkpoint(path, cfg), strict=True)
            mc.run_kernel.launches = 0
            got = model(x, keep=keep, recon=True, deterministic=True)
            torch.cuda.synchronize()
            total += mc.run_kernel.launches
            _bitwise(f"XLSTM_HVED from an upstream .pth ({form}) forward {crop}",
                     (got.seg, got.recon), (want.seg, want.recon), lines,
                     mc.run_kernel.launches, 1)
            del model, got
        fresh = _seeded_module(lambda: Discriminator(f_maps=64, kernel=4), 1).to(dev).eval()
        fresh.load_state_dict(disc_params_from_torch(torch.load(disc_path)), strict=True)
        pair = torch.cat([want.seg, want.recon], dim=1)
        _bitwise("Discriminator(64, 4) from an upstream .pth on the (seg, recon) pair",
                 fresh(pair), disc(pair), lines)
    del direct, disc, fresh, want, pair, x
    torch.cuda.empty_cache()
    return total


def import_others(dev, gen, lines):
    """Phase 12, 2: U_HVEDNet3D, FusionUNet3D, U_HeMIS and the 3-D UXlstmEnc
    of phase 11's plan through their importers into models seeded otherwise:
    each forward bit for bit its direct twin's. Returns the mlstm_fwd
    launches of the imported forwards."""
    import torch
    from xlstm_hved_torch.config import get_config
    from xlstm_hved_torch.models import build_uxlstm_from_plans, find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda as mc
    from xlstm_hved_torch.utils import torch_import as ti

    names = _upstream_names()
    keep = torch.ones(4, dtype=torch.bool, device=dev)
    hved_fwd = lambda m, x: (lambda o: (o.seg, o.recon))(
        m(x, keep=keep, recon=True, deterministic=True))
    plain_fwd = lambda m, x: m(x)
    uxlstm = lambda: build_uxlstm_from_plans(XLSTM_PLANS_3D, 4, 4, True, "enc")
    cases = (   # label, build(seed), upstream(state), import(upstream, model), input, fwd, ViLs
        ("U_HVEDNet3D", lambda s: find_model_using_name("U_HVEDNet3D", device=dev, seed=s),
         lambda st: names.hved_upstream(st, get_config("U_HVEDNet3D")),
         lambda sd, m: ti.hved_params_from_torch(sd, get_config("U_HVEDNet3D")),
         (1, 4, *IMPORT_CROP), hved_fwd, 0),
        ("FusionUNet3D", lambda s: find_model_using_name("FusionUNet3D", device=dev, seed=s),
         lambda st: names.fusion_upstream(st, get_config("FusionUNet3D")),
         lambda sd, m: ti.fusion_params_from_torch(sd, get_config("FusionUNet3D")),
         (1, 4, *IMPORT_CROP), hved_fwd, 0),
        ("U_HeMIS", lambda s: find_model_using_name("U_HeMIS", device=dev, seed=s),
         names.hemis_upstream, lambda sd, m: ti.hemis_params_from_torch(sd),
         (1, 4, *IMPORT_CROP), plain_fwd, 0),
        ("UXlstmEnc 3-D", lambda s: _seeded_module(uxlstm, s).to(dev).eval(),
         names.uxlstm_upstream, ti.uxlstm_params_from_torch,
         (2, 4, *XLSTM_PLANS_3D["patch_size"]), plain_fwd, 3),
    )
    total = 0
    for label, build, to_upstream, importer, shape, fwd, vils in cases:
        direct = build(0)
        _randomise_running_stats(direct, gen)
        upstream = {k: v.cpu() for k, v in to_upstream(direct.state_dict()).items()}
        model = build(1)
        model.load_state_dict(importer(upstream, model), strict=True)
        x = torch.rand(*shape, generator=gen, device=dev)
        with torch.inference_mode():
            want = fwd(direct, x)
            mc.run_kernel.launches = 0
            got = fwd(model, x)
            torch.cuda.synchronize()
            launches = mc.run_kernel.launches
        total += launches
        _bitwise(f"{label} imported forward {shape}", got, want, lines, launches, vils)
        del direct, model, x, want, got
        torch.cuda.empty_cache()
    return total


def _seed_offsets(block, xs, gen):
    """Seed every offset conv of `block` so that its offsets on the inputs
    `xs` have a standard deviation of IMPORT_BLOCK_OFFSET_STD voxels (before
    AttDeformConv3d's attention gate). Returns the number of offset convs."""
    import torch

    convs = [m for n, m in block.named_modules() if n.endswith("offset_conv")]
    if not convs:
        return 0
    seen = {}
    hooks = [c.register_forward_hook(lambda m, i, o: seen.__setitem__(m, float(o.std())))
             for c in convs]
    with torch.no_grad():
        for c in convs:
            c.weight.copy_(torch.randn(c.weight.shape, generator=gen, device=xs[0].device))
        block(*xs)
        for c in convs:
            c.weight.mul_(IMPORT_BLOCK_OFFSET_STD / seen[c])
    for h in hooks:
        h.remove()
    return len(convs)


def import_blocks(dev, gen, lines):
    """Phase 12, 3: the A9 blocks at full width, fp32, batch 1, the offset
    convs seeded to offsets of about +-1.5 voxels: forward and the gradient
    of a seeded weighted sum finite, the forward against an fp64 copy on the
    card (phase 4's bound), ms (forward; forward and backward) and peak."""
    import copy

    import torch
    from xlstm_hved_torch.nn.dusfe import DuRegisterDuSE
    from xlstm_hved_torch.nn.skr import FCNHead, ParallelDecoder, ResFormerBlock
    from xlstm_hved_torch.ops.deform import AttDeformConv3d, DeformConv3d

    # the flagship's levels 0-2 at IMPORT_CROP: 4 streams x f_maps 4 = 16
    # channels at full size, 32 at a half, 64 at a quarter
    sizes = [tuple(n // 2 ** i for n in IMPORT_CROP) for i in range(3)]
    scales = tuple((1, 16 * 2 ** i, *size) for i, size in enumerate(sizes))
    name = ["x".join(map(str, size)) for size in sizes]
    blocks = (   # label, build, input shapes
        (f"DeformConv3d 32->32 at {name[1]}", lambda: DeformConv3d(32, 32), scales[1:2]),
        (f"ResFormerBlock(deform) 16->32 stride 2 from {name[0]}",
         lambda: ResFormerBlock(16, 32, stride=2, deform=True), scales[:1]),
        (f"AttDeformConv3d 32->32 at {name[1]}", lambda: AttDeformConv3d(32, 32),
         ((1, 32, *sizes[1]),)),
        (f"DuRegisterDuSE(32) at {'x'.join(map(str, IMPORT_DUREG))}",
         lambda: DuRegisterDuSE(32, img_size=IMPORT_DUREG),
         ((1, 1, *IMPORT_DUREG), (1, 1, *IMPORT_DUREG))),
        ("ParallelDecoder(16, 32, 64 -> 3)", lambda: ParallelDecoder(16, 32, 64, 3), scales),
        ("FCNHead(16, 32, 64 -> 3)", lambda: FCNHead(16, 32, 64, 3), scales),
    )
    for label, build, shapes in blocks:
        block = _seeded_module(build, 0).to(dev).eval()
        _randomise_running_stats(block, gen)
        xs = [torch.rand(*s, generator=gen, device=dev) for s in shapes]
        n_offset = _seed_offsets(block, xs, gen)
        block64 = copy.deepcopy(block).double()
        with torch.no_grad():
            out = _outputs(block(*xs))
            ref = _outputs(block64(*[x.double() for x in xs]))
        d = max(absmax(o.double() - r) for o, r in zip(out, ref))
        top = max(absmax(r) for r in ref)
        weights = [torch.randn(o.shape, generator=gen, device=dev) for o in out]
        del block64, ref, out
        torch.cuda.empty_cache()
        params = list(block.parameters())
        xg = [x.requires_grad_() for x in xs]

        def step():
            loss = sum((o * w).sum() for o, w in zip(_outputs(block(*xg)), weights))
            return torch.autograd.grad(loss, xg + params)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        grads = step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        if not finite(*grads):
            fail(f"{label}: non-finite gradient")
        if d > SEG_ATOL:
            fail(f"{label}: fp32 forward against fp64 max|d| {d:.3e} (bound {SEG_ATOL})")
        del grads
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: block(*xs), warmup=1, iters=3)
        step_ms = cuda_ms(step, warmup=1, iters=3)
        line = (f"{label}: fp32 vs fp64 max|d| {d:.3e} (max|ref| {top:.3e}, bound {SEG_ATOL}), "
                f"gradients finite ({len(params)} parameters, {n_offset} offset convs at "
                f"{IMPORT_BLOCK_OFFSET_STD} voxels), forward {fwd_ms:.2f} ms, forward and "
                f"backward {step_ms:.2f} ms, peak {peak:.2f} GiB")
        if isinstance(block, DeformConv3d):
            line += " | forward split: " + deform_split(block, xs[0])
        print(f"  {line}", flush=True)
        lines.append(line)
        del block, xs, xg, params, weights
        torch.cuda.empty_cache()


def deform_split(block, x) -> str:
    """A DeformConv3d forward's parts, each timed alone (CUDA events), beside
    a dense 3^3 conv of the same widths (cuDNN)."""
    import torch
    from xlstm_hved_torch.nn.blocks import conv3d
    from xlstm_hved_torch.ops.deform import _same_pad, deform_gather

    ks, st = block.kernel_size, block.stride
    dense = conv3d(x.shape[1], block.proj.out_channels, ks, st, bias=False).to(x.device)
    with torch.no_grad():
        offsets = block.offset_conv(_same_pad(x, ks, st))
        gathered = deform_gather(x, offsets, ks, st)
        parts = {"offset conv": lambda: block.offset_conv(_same_pad(x, ks, st)),
                 "gather": lambda: deform_gather(x, offsets, ks, st),
                 "proj": lambda: block.proj(gathered),
                 "a dense 3^3 conv of the same widths": lambda: dense(x)}
        return ", ".join(f"{name} {cuda_ms(fn, warmup=1, iters=3):.2f} ms"
                         for name, fn in parts.items())


def check_import(dev, gen):
    """Phase 12, the upstream .pth import and the A9 blocks. Returns the
    mlstm_fwd launches of the imported forwards and a summary."""
    import torch

    lines = []
    torch.backends.cudnn.deterministic = True   # the bit-for-bit comparisons
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as root:
            launches = import_flagship(dev, gen, root, lines)
        launches += import_others(dev, gen, lines)
    finally:
        torch.backends.cudnn.deterministic = False
    import_blocks(dev, gen, lines)
    return {"launches": launches,
            "summary": f"{len(lines)} checks: " + " | ".join(l.split(":")[0] for l in lines)}


PARALLEL_RANKS = 2
PARALLEL_SEED = 13
PARALLEL_TIMEOUT_S = 600
# the two-rank fp32 step (batch 1 per rank) and the sharded sweep's volume
# and patch; the children read them from the settings the parent passes
PARALLEL_SETTINGS = {"crop": (128, 128, 128), "sweep_shape": CROPS[1],
                     "patch": (128, 128, 128), "disc": (64, 4)}
# JAX's own bound on data-parallel losses (tests/test_parallel.py), and the
# BatchNorm running statistics (momentum 0.01 of batch moments that differ
# in the fp32 order of their sums)
PARALLEL_LOSS_ATOL, PARALLEL_STATS_ATOL = 1e-5, 1e-6
PARALLEL_STEPS_PER_ARM = 3   # timed steps per arm of the world-1 step comparison


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parallel_inputs(dev, crop):
    """The two-rank step's global batch of 2, drawn alike in every process:
    seeded volumes and nested masks (the second rolled, so that the ranks'
    BatchNorm and dice sums differ)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED)
    x = torch.rand(2, 4, *crop, generator=gen, device=dev)
    _, mask = synthetic_batch(gen, dev, crop)
    mask = torch.cat([mask, mask.roll(shifts=crop[0] // 8, dims=2)])
    return x, mask


def parallel_state(dev, x, disc):
    """The flagship G (seed 0, fp32) and Discriminator(*disc), init
    "reference", with Adam, as every process builds them."""
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine.train import create_train_state
    from xlstm_hved_torch.models import Discriminator, find_model_using_name

    cfg = TrainConfig(crop_size=tuple(x.shape[2:]))
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=0)
    state = create_train_state(model, Discriminator(f_maps=disc[0], kernel=disc[1]), cfg,
                               seed=0, sample=x[:1], init_scheme="reference")
    return cfg, state


def step_record(state, metrics) -> dict:
    """A first step as the comparison reads it: its metrics, G's and D's
    gradients (Adam's first moment after the first step over 1 - beta1: the
    gradient plus the weight decay's 1e-5 * p, the same parameters in every
    process) and the BatchNorm running statistics, on the host."""

    def grads(opt, module):
        beta1 = opt.param_groups[0]["betas"][0]
        return {n: (opt.state[p]["exp_avg"] / (1.0 - beta1)).cpu()
                for n, p in module.named_parameters()}

    return dict(metrics={k: float(v) for k, v in metrics.items()},
                g=grads(state.opt_g, state.model), d=grads(state.opt_d, state.disc),
                stats={n: b.detach().to("cpu", copy=True)
                       for n, b in state.model.named_buffers() if "running_" in n})


def parallel_rank(rank: int, port: int, root: str, settings: dict):
    """One of the two ranks of phase 13, a process of its own on the card
    the parent uses (gloo: NCCL refuses two ranks on one device): the first
    step on its row of the global batch (cuDNN deterministic, deterministic
    upsampling), two more steps for the time, then the sharded sweep; rank
    0 also runs the one-process hoisted sweep. Writes its record under
    `root`."""
    import torch
    import torch.distributed as dist
    from xlstm_hved_torch.engine.evaluate import (make_hoisted_subset_sweep,
                                                  make_sharded_subset_sweep)
    from xlstm_hved_torch.engine.train import make_train_step
    from xlstm_hved_torch.models import find_model_using_name
    from xlstm_hved_torch.parallel.mesh import initialize_distributed, make_mesh, shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    initialize_distributed(f"127.0.0.1:{port}", PARALLEL_RANKS, rank, backend="gloo")
    mesh = make_mesh(device=settings["device"])
    dev = mesh.device
    counters = mlstm_counters()
    out = {"rank": rank, "backend": dist.get_backend()}
    with deterministic_upsampling():
        x, mask = parallel_inputs(dev, tuple(settings["crop"]))
        cfg, state = parallel_state(dev, x[:1], settings["disc"])
        x, mask = shard_batch(mesh, (x, mask))
        step = make_train_step(state.model, state.disc, cfg)
        for c in counters.values():
            c.launches = 0
        _sync(dev)
        t = time.perf_counter()
        with mesh:
            state, metrics = step(state, x, mask)
        _sync(dev)
        out["first_ms"] = 1e3 * (time.perf_counter() - t)
        out["launches"] = {name: c.launches for name, c in counters.items()}
        out["record"] = step_record(state, metrics)
        times = []
        for _ in range(2):
            t = time.perf_counter()
            with mesh:
                state, _ = step(state, x, mask)
            _sync(dev)
            times.append(1e3 * (time.perf_counter() - t))
        out["step_ms"] = times
    del state, step, x, mask
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    model = find_model_using_name("XLSTM_HVED", device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(PARALLEL_SEED + 1)
    vol = torch.rand(1, 4, *settings["sweep_shape"], generator=gen, device=dev)
    sweep = make_sharded_subset_sweep(model, mesh, settings["patch"], recon_channels=4)
    counters["mlstm_fwd"].launches = 0
    _sync(dev)
    t = time.perf_counter()
    seg, rec = sweep(model, vol)
    _sync(dev)
    out["sweep_s"] = time.perf_counter() - t
    out["sweep_launches"] = counters["mlstm_fwd"].launches
    out["sweep_shape"] = (tuple(seg.shape), tuple(rec.shape))
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        hoisted = make_hoisted_subset_sweep(model, settings["patch"], recon_channels=4)
        _sync(dev)
        t = time.perf_counter()
        seg1, rec1 = hoisted(model, vol)
        _sync(dev)
        out["hoisted_s"] = time.perf_counter() - t
        out["seg_d"], out["rec_d"] = absmax(seg - seg1), absmax(rec - rec1)
        out["finite"] = finite(seg, rec)
    torch.save(out, os.path.join(root, f"parallel_rank{rank}.pt"))


def parallel_cli(dev, root, train_dir, valid_dir, extra):
    """Phase 13, 1: cli.train one epoch on phase 7's dataset, plain, then
    --distributed in this process as the one rank of an env:// group (the
    backend the device asks for: NCCL on the card), with cuDNN deterministic
    and deterministic upsampling: the CSV rows bit for bit, the launches,
    the backend. Then, in the group, the step at the CLI defaults with and
    without the mesh (its gradient all-reduce), alternating. Returns the
    numbers and a summary; leaves no process group behind."""
    import torch
    import torch.distributed as dist
    from xlstm_hved_torch.cli import train as train_main
    from xlstm_hved_torch.config import TrainConfig
    from xlstm_hved_torch.engine.train import create_train_state, make_train_step
    from xlstm_hved_torch.models import Discriminator, find_model_using_name
    from xlstm_hved_torch.nn.blocks import compute_dtype
    from xlstm_hved_torch.parallel.mesh import backend_for, make_mesh

    counters = mlstm_counters()
    common = ["--device", dev.type, "--num_epochs", "1", "--train_dir", train_dir,
              "--valid_dir", valid_dir] + list(extra)

    def run(name, flags=()):
        for c in counters.values():
            c.launches = 0
        out = os.path.join(root, f"parallel_{name}")
        summary = train_main.main(common + ["--out_dir", out] + list(flags))
        _sync(dev)
        rows = read_csv(os.path.join(out, "XLSTM_HVED", "loss_and_metrics.csv"))
        if len(rows) != 1:
            fail(f"parallel cli {name}: {len(rows)} CSV rows")
        return summary, rows[0], {n: c.launches for n, c in counters.items()}

    env_keys = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
    saved = {k: os.environ.get(k) for k in env_keys}
    torch.backends.cudnn.deterministic = True
    try:
        with deterministic_upsampling():
            plain, row_p, _ = run("plain")
            os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                              RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
            group, row_g, launches = run("group", ["--distributed"])
            backend = dist.get_backend()
        torch.backends.cudnn.deterministic = False
        if backend != backend_for(dev):
            fail(f"cli.train --distributed on {dev.type}: backend {backend}")
        steps = sum(e["steps"] for e in group["epochs"])
        items = sum(e["valid_items"] for e in group["epochs"])
        want = {n: steps * CLI_PER_TRAIN_STEP[n] + items * CLI_PER_VALID_ITEM[n]
                for n in counters}
        if launches != want:
            fail(f"cli.train --distributed: {steps} steps, {items} validation items "
                 f"launched {launches}, expected {want}")
        if row_g != row_p:
            fail("cli.train --distributed CSV row differs from the plain run's: "
                 f"{ {k: (row_g[k], row_p[k]) for k in row_p if row_g[k] != row_p[k]} }")
        per_step = {k: v["epochs"][0]["spans"]["train_step"] / v["epochs"][0]["steps"]
                    for k, v in (("plain", plain), ("group", group))}

        # the step at the CLI defaults (bf16 G and D), with and without the
        # group's gradient all-reduce, alternating: plain, group, group, plain
        args = train_main.base_parser("").parse_args(common)
        crop = tuple(args.crop_size)
        model = find_model_using_name("XLSTM_HVED", device=dev, seed=0,
                                      compute_dtype=args.compute_dtype)
        disc = Discriminator(f_maps=args.disc_fmaps, kernel=args.disc_kernel,
                             dtype=compute_dtype(args.disc_dtype))
        x, mask = synthetic_batch(torch.Generator(device=dev).manual_seed(PARALLEL_SEED),
                                  dev, crop)
        cfg = TrainConfig(crop_size=crop)
        state = create_train_state(model, disc, cfg, seed=0, sample=x)
        step = make_train_step(model, disc, cfg)
        mesh = make_mesh(device=dev)
        grad_bytes = 4 * sum(p.numel() for m in (model, disc) for p in m.parameters())
        state, _ = step(state, x, mask)   # warm-up
        times = {"plain": [], "group": []}
        for arm in ("plain", "group", "group", "plain"):
            for _ in range(PARALLEL_STEPS_PER_ARM):
                _sync(dev)
                t = time.perf_counter()
                with mesh if arm == "group" else contextlib.nullcontext():
                    state, _ = step(state, x, mask)
                _sync(dev)
                times[arm].append(1e3 * (time.perf_counter() - t))
        del state, step, model, disc, x, mask
    finally:
        torch.backends.cudnn.deterministic = False
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    ms = {k: statistics.median(v) for k, v in times.items()}
    line = (f"  cli.train --distributed (world 1, backend {backend}): CSV row bit for bit "
            f"the plain run's; {steps} steps, {items} validation items, launches {launches}; "
            f"per step {per_step['plain']:.3f} / {per_step['group']:.3f} s (plain, group; "
            f"the first run's includes the warm-up) | step at "
            f"{'x'.join(map(str, crop))} {args.compute_dtype}: {ms['plain']:.1f} ms without "
            f"the group, {ms['group']:.1f} ms with it ({ms['group'] / ms['plain']:.3f}x; "
            f"{['%.1f' % t for t in times['plain']]} / {['%.1f' % t for t in times['group']]}), "
            f"{grad_bytes} gradient bytes all-reduced per step")
    print(line, flush=True)
    return dict(backend=backend, launches=launches, step_ms=ms)


def parallel_ranks(dev, root):
    """Phase 13, 2: the fp32 G+D step at PARALLEL_SETTINGS' crop on 2 ranks
    at batch 1 (child processes, gloo, on this card) against this process at
    batch 2 on the same weights and input, cuDNN deterministic: G and D
    gradients to phase 6's rule, the losses and the BatchNorm running
    statistics to their bounds, the ranks equal to each other, 2/2/2
    launches per rank; the sharded sweep against the hoisted one (phase 4's
    bounds). Returns the numbers and a summary."""
    import gc

    import torch
    from xlstm_hved_torch.engine.train import make_train_step

    settings = dict(PARALLEL_SETTINGS, device=str(dev))
    counters = mlstm_counters()
    torch.backends.cudnn.deterministic = True
    try:
        with deterministic_upsampling():
            x, mask = parallel_inputs(dev, tuple(settings["crop"]))
            cfg, state = parallel_state(dev, x, settings["disc"])
            step = make_train_step(state.model, state.disc, cfg)
            for c in counters.values():
                c.launches = 0
            state, metrics = step(state, x, mask)
            _sync(dev)
            ref_launches = {n: c.launches for n, c in counters.items()}
            ref = step_record(state, metrics)
            # the one-rank step at batch 1, for the time
            times = []
            for i in range(4):
                _sync(dev)
                t = time.perf_counter()
                state, _ = step(state, x[:1], mask[:1])
                _sync(dev)
                if i:
                    times.append(1e3 * (time.perf_counter() - t))
    finally:
        torch.backends.cudnn.deterministic = False
    del state, step, x, mask, metrics
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()   # the children need the memory

    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "chip_smoke.py"),
                               "--parallel-rank", str(r), str(port), root,
                               json.dumps(settings)], cwd=HERE)
             for r in range(PARALLEL_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=PARALLEL_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    children_s = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        fail(f"phase 13 ranks exited {[p.returncode for p in procs]}")
    ranks = [torch.load(os.path.join(root, f"parallel_rank{r}.pt"), weights_only=False)
             for r in range(PARALLEL_RANKS)]

    per_step = {n: CLI_PER_TRAIN_STEP[n] for n in counters}
    if ref_launches != per_step:
        fail(f"one-process step launched {ref_launches}, expected {per_step}")
    r0, r1 = ranks[0]["record"], ranks[1]["record"]
    for r in ranks:
        if r["backend"] != "gloo" or r["launches"] != per_step:
            fail(f"rank {r['rank']}: backend {r['backend']}, launches {r['launches']}, "
                 f"expected {per_step}")
    if r0["metrics"] != r1["metrics"]:
        fail(f"the ranks' metrics differ: {r0['metrics']} / {r1['metrics']}")
    worst = {}
    for part in ("g", "d"):
        floor = GRAD_FLOOR * max(absmax(t) for t in ref[part].values())
        shares = []
        for name, want in ref[part].items():
            got = r0[part][name]
            if not torch.equal(got, r1[part][name]):
                fail(f"{part} gradient {name}: the ranks differ")
            err = absmax(got - want)
            shares.append((err / (GRAD_SCALED * absmax(want) + floor), name, err))
        share, name, err = max(shares)
        if share > 1.0:
            fail(f"two ranks vs one process, {part.upper()} gradient {name}: max|d| "
                 f"{err:.3e}, {share:.3f} of phase 6's bound")
        worst[part] = (share, name, err)
    loss_d = {k: abs(r0["metrics"][k] - ref["metrics"][k]) for k in ("loss", "loss_d")}
    if max(loss_d.values()) > PARALLEL_LOSS_ATOL:
        fail(f"two ranks vs one process: loss |d| {loss_d} (bound {PARALLEL_LOSS_ATOL})")
    stats_d = max(absmax(r0["stats"][n] - w) for n, w in ref["stats"].items())
    if stats_d > PARALLEL_STATS_ATOL or any(
            not torch.equal(r0["stats"][n], r1["stats"][n]) for n in ref["stats"]):
        fail(f"two ranks vs one process: BatchNorm statistics max|d| {stats_d:.3e}, or the "
             "ranks differ")
    sweep = ranks[0]
    n_sub = 15
    want_shape = ((n_sub, 1, 3, *settings["sweep_shape"]), (n_sub, 1, 4, *settings["sweep_shape"]))
    if any(r["sweep_shape"] != want_shape for r in ranks) or not sweep["finite"]:
        fail(f"sharded sweep: shapes {[r['sweep_shape'] for r in ranks]}, finite "
             f"{sweep['finite']}")
    if sweep["seg_d"] > SEG_ATOL or sweep["rec_d"] > RECON_ATOL:
        fail(f"sharded sweep vs hoisted: seg {sweep['seg_d']:.3e}, recon "
             f"{sweep['rec_d']:.3e} (bounds {SEG_ATOL}, {RECON_ATOL})")
    one_ms = statistics.median(times)
    two_ms = statistics.median([t for r in ranks for t in r["step_ms"]])
    crop = "x".join(map(str, settings["crop"]))
    line = (f"  two ranks (gloo, one card) at {crop} fp32, batch 1 each, vs one process at "
            f"batch 2: G gradient worst {worst['g'][0]:.3f} of phase 6's bound "
            f"({worst['g'][1]}, max|d| {worst['g'][2]:.3e}), D {worst['d'][0]:.3f} "
            f"({worst['d'][1]}, {worst['d'][2]:.3e}); loss |d| {loss_d['loss']:.3e}, "
            f"loss_d |d| {loss_d['loss_d']:.3e}; BatchNorm statistics max|d| {stats_d:.3e}; "
            f"launches per rank {ranks[0]['launches']} | step {two_ms:.1f} ms per rank "
            f"(first {[round(r['first_ms'], 1) for r in ranks]}, then "
            f"{[[round(t, 1) for t in r['step_ms']] for r in ranks]}) against one rank's "
            f"{one_ms:.1f} ms at batch 1 ({two_ms / one_ms:.2f}x) | sharded sweep of a "
            f"{'x'.join(map(str, settings['sweep_shape']))} volume: seg max|d| "
            f"{sweep['seg_d']:.3e}, recon {sweep['rec_d']:.3e} against the hoisted sweep; "
            f"{[round(r['sweep_s'], 2) for r in ranks]} s on the two ranks, hoisted "
            f"{sweep['hoisted_s']:.2f} s; mlstm_fwd launches per rank "
            f"{[r['sweep_launches'] for r in ranks]} | children {children_s:.1f} s")
    print(line, flush=True)
    return dict(per_step=ranks[0]["launches"], two_ms=two_ms, one_ms=one_ms)


def check_parallel(dev, root, train_dir, valid_dir, cli_extra=()):
    """Phase 13, data parallelism: `parallel_cli`, then `parallel_ranks`.
    Returns the launches per step and a summary."""
    cli = parallel_cli(dev, root, train_dir, valid_dir, cli_extra)
    ranks = parallel_ranks(dev, root)
    summary = (f"world-1 {cli['backend']} CSV row bit for bit, step "
               f"{cli['step_ms']['group']:.1f} / {cli['step_ms']['plain']:.1f} ms with / "
               f"without the group | two ranks {ranks['two_ms']:.1f} ms per step vs "
               f"{ranks['one_ms']:.1f}, launches per rank {ranks['per_step']}")
    return {"per_step": ranks["per_step"], "summary": summary}


PROTOCOL_SCRIPT = os.path.join("scripts", "torch_full_scale_run.py")
PROTOCOL_ARGS = ("--quick", "--subprocess", "--epoch_chunk", "1", "--compute_hd95")
PROTOCOL_TIMEOUT_S = 600
PROTOCOL_PHASES = [("pretrain", [1, 1]), ("finetune", [1, 1]), ("finetune", [2, 2]),
                   ("sweep", None)]


def _finite_csv(path) -> int:
    """The rows of a metrics CSV; fails on a value that is not finite."""
    rows = read_csv(path)
    for row in rows:
        for key, value in row.items():
            if value != "" and not math.isfinite(float(value)):
                fail(f"protocol: {os.path.basename(os.path.dirname(path))} CSV epoch "
                     f"{row['Epoch']}: {key} = {value}")
    return len(rows)


def check_protocol():
    """Phase 14, the full training protocol's driver as a user runs it on
    the card: scripts/torch_full_scale_run.py --quick --subprocess
    --epoch_chunk 1 --compute_hd95 in a temporary --out_root, each phase a
    process of its own (pretrain, the finetune's two one-epoch chunks, the
    second resuming from the first's latest, the sweep). Every phase's rc
    0, the finetune CSV one row per epoch, every CSV value finite, 15
    subset rows of finite Dice, each mLSTM kernel launched in the phases
    (their processes' counts, which start at 0) and the plain scan never
    called. Returns the launches and a summary."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_protocol_") as root:
        t0 = time.perf_counter()
        cmd = [sys.executable, os.path.join(HERE, PROTOCOL_SCRIPT), *PROTOCOL_ARGS,
               "--out_root", root]
        with subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, start_new_session=True) as proc:
            try:
                out, _ = proc.communicate(timeout=PROTOCOL_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)   # the driver and the phase it runs
                proc.communicate()
                fail(f"protocol: no end within {PROTOCOL_TIMEOUT_S} s")
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"protocol: rc {proc.returncode}\n{out[-6000:]}")
        with open(os.path.join(root, "phases.json")) as f:
            phases = json.load(f)["phases"]
        if [(p["phase"], p["epochs"]) for p in phases] != PROTOCOL_PHASES or any(
                p["rc"] != 0 for p in phases):
            fail(f"protocol: phases {[(p['phase'], p['epochs'], p['rc']) for p in phases]}")
        launches = {k: sum(p["launches"][k] for p in phases) for k in phases[0]["launches"]}
        unused = [name for name in KERNELS if launches[name] < 1]
        if unused or launches["plain_scan"]:
            fail(f"protocol: launches {launches}: {unused} never launched, or the plain "
                 "scan ran")
        pre = _finite_csv(os.path.join(root, "XLSTM_HVED_pretrain", "loss_and_metrics.csv"))
        epochs = _finite_csv(os.path.join(root, "XLSTM_HVED", "loss_and_metrics.csv"))
        if (pre, epochs) != (1, 2):
            fail(f"protocol: {pre} pretrain and {epochs} finetune CSV rows, expected 1 and 2")
        with open(os.path.join(root, "subset_table.txt")) as f:
            rows = [ln for ln in f if ln.startswith("subset ")]
        dice = [float(v) for ln in rows for v in re.findall(r"-?\d+\.\d+", ln)[:3]]
        if len(rows) != 15 or not all(math.isfinite(d) for d in dice):
            fail(f"protocol: {len(rows)} subset rows, Dice finite "
                 f"{all(math.isfinite(d) for d in dice)}")
    for line in out.splitlines():
        if line.startswith("[phase") and " done in " in line:
            print(f"  {line}", flush=True)
    per_phase = " ".join(f"{p['phase']}{'' if p['epochs'] is None else p['epochs']} "
                         f"{p['seconds']:.1f}s" for p in phases)
    summary = (f"{PROTOCOL_SCRIPT} {' '.join(PROTOCOL_ARGS)}: {seconds:.1f} s ({per_phase}, "
               f"each in its process), every rc 0, finetune CSV 2 rows (epoch 2 resumed), "
               f"15 finite subset rows (all modalities WT/TC/ET {dice[-3:]}), "
               f"launches {launches}")
    return {"launches": launches, "seconds": seconds, "summary": summary}



# ---- the training chain over K steps (phase 15): tests/_torch_chain.py,
# which the CPU parity tests and the reference's generator share
# phase 15's arms: (label, run_chain keywords)
CHAIN_ARMS = (("kernel", {}),
              ("plain", {"mlstm_kernel": False}),
              ("bf16", {"compute_dtype": "bfloat16", "disc_dtype": "bfloat16"}))
# the vectors the bf16 arm is held on: those where PRECISION_FACTOR times
# JAX's own bf16 distance stays under 1 (a vector of zeros lies at 1); G's
# finetune update and moments and the pretrain's second moment lie 0.60 to
# 2.5 from fp32 in JAX's bf16 chain
BF16_VECTORS = {"pre": ("delta_g", "mu_g"), "ft": ("bn", "delta_d", "mu_d", "nu_d")}


def chain_module():
    """tests/_torch_chain.py, imported from this checkout."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import _torch_chain

    return _torch_chain


def chain_reference(ref, run: str) -> dict:
    """A stored chain of the chain's reference (`run`: jax32, jax16, cpu32
    or cpu16) in run_chain's layout: the losses and the evaluation, and the
    updates where they are stored."""
    rec = {}
    for phase in ("pre", "ft"):
        rec[phase] = {"losses": ref[f"{run}.{phase}.losses"]}
        for name in ("delta_g", "delta_d"):
            prefix = f"{run}.{phase}.{name}."
            vec = {k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}
            if vec:
                rec[phase][name] = vec
    rec["ft"]["eval"] = ref[f"{run}.ft.eval"]
    return rec


def bf16_bounds(ref, tc) -> dict:
    """The bf16 arm's bounds, from the same chain's bf16-vs-fp32 distances on
    the CPU (CHAIN_REF): per loss term (the largest relative difference over
    the steps) and for the evaluation PRECISION_FACTOR times the larger of
    JAX's (jaxbf16.*) and the port's (cpubf16.*), which holds each of JAX's
    loss terms within PRECISION_FACTOR (tests/test_torch_protocol_ref.py)
    but rounds at every op where XLA's CPU backend fuses; per vector of
    BF16_VECTORS (relative L2) PRECISION_FACTOR times JAX's."""
    import numpy as np

    def larger(key):
        return PRECISION_FACTOR * np.maximum(ref[f"jaxbf16.{key}"], ref[f"cpubf16.{key}"])

    out = {"eval": float(larger("eval_rel"))}
    for phase, keys in (("pre", tc.PRE_LOSS_KEYS), ("ft", tc.FT_LOSS_KEYS)):
        out[phase] = dict(zip(keys, map(float, larger(f"{phase}.loss_rel"))))
        for name in BF16_VECTORS[phase]:
            out[phase][name] = PRECISION_FACTOR * float(ref[f"jaxbf16.{phase}.{name}"])
            if not out[phase][name] < 1.0:
                fail(f"chain: the stored bf16 bound of {phase} {name} is "
                     f"{out[phase][name]:.3f}, which a vector of zeros meets")
    return out


def bf16_chain_faults(dist: dict, bounds: dict, tc) -> list:
    """The bf16 chain's distances from the fp32 one (`dist`) that break
    `bf16_bounds`, as lines."""
    faults = []
    for phase, keys in (("pre", tc.PRE_LOSS_KEYS), ("ft", tc.FT_LOSS_KEYS)):
        got = dict(zip(keys, dist[phase]["loss_rel"]))
        got.update((name, dist[phase][name]["rel_l2"]) for name in BF16_VECTORS[phase])
        faults += [f"bf16 {phase} {k}: {got[k]:.3e} > {b:.3e}"
                   for k, b in bounds[phase].items() if not got[k] <= b]
    if not dist["eval_rel"] <= bounds["eval"]:
        faults.append(f"bf16 evaluation: {dist['eval_rel']:.3e} > {bounds['eval']:.3e}")
    return faults


def check_chain(dev):
    """Phase 15, the protocol's chain over K steps on the card, at the JAX
    r5 recipe's crop (CHAIN_CROP) and full width, from JAX's weights and
    with the pinned draws of tests/test_torch_protocol_parity.py (CHAIN_REF,
    `run_chain`): (a) fp32 through the CUDA kernels, (b) fp32 through the
    plain scan (mlstm_kernel=False), (c) the CLIs' bf16 defaults through the
    kernels; each with cuDNN deterministic and `deterministic_upsampling`.
    (a) against (b) and (a) against the port's CPU chain (CHAIN_REF's
    cpu32) to the chain bounds (CHAIN_*), (c) against (a) to `bf16_bounds`;
    (a) and (c) launch each kernel every step and never call the plain
    scan, (b) launches none. Returns the kernel arm's launches and a
    summary."""
    import numpy as np
    import torch
    from xlstm_hved_torch.utils.phase_report import launch_counts, reset_counts

    tc = chain_module()
    ref = np.load(tc.CHAIN_REF)
    weights = tc.chain_weights(ref)
    batches = tc.chain_batches(tc.CHAIN_CROP)
    arms, counts, seconds = {}, {}, {}
    for label, kw in CHAIN_ARMS:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        # each arm the same bits run after run (as phase 9's gradients): the
        # chain amplifies any rounding, so the atomics of cuDNN's backward and
        # of the upsampling's would move the distances from run to run
        torch.backends.cudnn.deterministic = True
        try:
            with deterministic_upsampling():
                arms[label] = tc.run_chain(dev, weights, batches, **kw)
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        counts[label] = launch_counts()
        for phase in ("pre", "ft"):
            if not np.isfinite(arms[label][phase]["losses"]).all():
                fail(f"chain {label}: a {phase} loss is not finite")
        print(f"  arm {label}: {seconds[label]:.1f} s, launches {counts[label]}", flush=True)
    # every step of the kernel arms launches each kernel (one of each a
    # pretrain step, two a G+D step) and never calls the plain scan; every
    # step of the plain arm launches none and calls the scan once a forward
    for label in ("kernel", "bf16", "plain"):
        for phase, per in (("pre", 1), ("ft", 2)):
            kernel = label != "plain"
            want = dict.fromkeys(KERNELS, per if kernel else 0)
            want["plain_scan"] = 0 if kernel else per
            for i, got in enumerate(arms[label][phase]["launches"]):
                if got != want:
                    fail(f"chain {label}: {phase} step {i} launches {got}, expected {want}")
        total = {k: sum(s[k] for p in ("pre", "ft") for s in arms[label][p]["launches"])
                 for k in counts[label]}
        print(f"  arm {label}: per step launches as expected; the steps {total}", flush=True)
    faults = []
    for label, got, want in (("kernel vs plain", arms["kernel"], arms["plain"]),
                             ("kernel vs CPU", arms["kernel"], chain_reference(ref, "cpu32"))):
        dist = tc.chain_distances(got, want)
        print(f"  {label}:", flush=True)
        for line in tc.describe_distances(dist):
            print(f"    {line}", flush=True)
        faults += [f"{label}: {f}" for f in tc.chain_faults(dist)]
    dist = tc.chain_distances(arms["bf16"], arms["kernel"])
    bounds = bf16_bounds(ref, tc)
    print("  bf16 vs fp32 (kernel arms):", flush=True)
    for line in tc.describe_distances(dist):
        print(f"    {line}", flush=True)
    print("    bounds: " + "; ".join(
        f"{phase} " + ", ".join(f"{k} {b:.3e}" for k, b in bounds[phase].items())
        for phase in ("pre", "ft")) + f"; evaluation {bounds['eval']:.3e}", flush=True)
    faults += bf16_chain_faults(dist, bounds, tc)
    if faults:
        fail("chain: " + "; ".join(faults))
    k_ft = arms["kernel"]["ft"]["losses"]
    summary = (f"{tc.CHAIN_K_PRE} pretrain + {tc.CHAIN_K_FT} G+D steps at {tc.CHAIN_CROP} from "
               f"JAX's weights, arms kernel / plain / bf16 {seconds['kernel']:.1f} / "
               f"{seconds['plain']:.1f} / {seconds['bf16']:.1f} s; the kernel arm within the "
               f"chain bounds of the plain arm and of the CPU path, bf16 within "
               f"{PRECISION_FACTOR} x the CPU's bf16 distances; launches {counts['kernel']}; "
               f"last G loss {k_ft[-1][0]:.4f}")
    return {"launches": counts["kernel"], "summary": summary}


def main():
    if not os.path.isdir(os.path.join(HERE, "xlstm_hved_torch")):
        fail("xlstm_hved_torch/ is not beside chip_smoke.py; run it from a checkout")
    sys.path.insert(0, HERE)
    if sys.argv[1:2] == ["--parallel-rank"]:   # a child of phase 13
        rank, port, root, settings = sys.argv[2:6]
        parallel_rank(int(rank), int(port), root, json.loads(settings))
        return

    # ---- 1. device
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    done("device", t0, f"{torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
                       f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    from xlstm_hved_torch.utils import cuda_build
    from xlstm_hved_torch.ops import mlstm_cuda

    report = cuda_build.build(mlstm_cuda.SOURCES)
    for name, rep in report.items():
        for line in ptxas_report(rep["log"]):
            spills = re.findall(r"(\d+) bytes spill", line)
            flag = " [SPILLS]" if any(int(n) for n in spills) else ""
            print(f"  {name}: {line}{flag}")
    done("build", t0, " ".join(f"{n} {r['seconds']:.1f}s" for n, r in report.items()))

    # ---- 3. kernels against their twins
    t0 = time.perf_counter()
    rows, worst, regime_worst = check_kernels(dev)
    check_wrapper_gradients(dev)
    done("kernel", t0, "mlstm_fwd, mlstm_fwd_states and mlstm_bwd agree with their twins "
                       f"on {len(KERNEL_CASES)} cases; worst max|d| " +
                       " ".join(f"{n} {e:.3e}" for n, e in worst.items()) +
                       f"; the {len(GATE_REGIME_CASES)} gate-regime cases' worst " +
                       " ".join(f"{n} {e:.3e}" for n, e in regime_worst.items()))

    # ---- 4. forward: the flagship and the ViL-decoder preset
    t0 = time.perf_counter()
    model, forward_ms, _ = check_forward(dev, gen, "XLSTM_HVED")
    # its own generator: the later phases' seeded inputs stay as they were
    _, vil_ms, vil_launches = check_forward(dev, torch.Generator(device=dev).manual_seed(3),
                                            "U_HVEDConvXLSTMNet3D")
    rows["mlstm_fwd"]["launches_per_vil_decoder_forward"] = vil_launches
    torch.cuda.empty_cache()
    done("forward", t0, " ".join(f"{c} {m:.2f} ms" for c, m in forward_ms.items())
         + " | U_HVEDConvXLSTMNet3D " + " ".join(f"{c} {m:.2f} ms" for c, m in vil_ms.items()))
    keep = torch.ones(4, dtype=torch.bool, device=dev)

    # ---- 5. requests: the main path
    t0 = time.perf_counter()
    from xlstm_hved_torch.engine.evaluate import default_apply_fn, make_subset_sweep

    patch = (128, 128, 128)
    sweep = make_subset_sweep(default_apply_fn(model, recon=True), patch,
                              recon_channels=4)
    x = torch.rand(1, 4, *CROPS[1], generator=gen, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mlstm_cuda.run_kernel.launches = 0
    t_req = time.perf_counter()
    segs, recs = sweep(model, x)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t_req
    launches = mlstm_cuda.run_kernel.launches
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    windows = 2 * 15
    if launches != windows:
        fail(f"sweep: {launches} mlstm_fwd launches, expected {windows}")
    if segs.shape != (15, 1, 3, *CROPS[1]) or recs.shape != (15, 1, 4, *CROPS[1]):
        fail(f"sweep shapes {tuple(segs.shape)}, {tuple(recs.shape)}")
    if not (torch.isfinite(segs).all() and torch.isfinite(recs).all()):
        fail("sweep: non-finite output")
    # where only the first window reaches (H < 64) the sweep's all-modality
    # output is that window's forward itself
    with torch.inference_mode():
        first = model(x[:, :, :, :128], keep=keep, recon=True, deterministic=True)
    d_first = float((segs[14][..., :64, :] - first.seg[..., :64, :]).abs().max())
    if d_first > SEG_ATOL:
        fail(f"sweep subset 14 differs from its first window by {d_first:.3e}")
    done("requests", t0, f"15-subset sweep of a 128x192x128 volume (30 windows) "
                         f"{sweep_s:.2f} s, peak {peak_gib:.2f} GiB, "
                         f"{launches} mlstm_fwd launches, first window max|d| {d_first:.3e}")

    rows["mlstm_fwd"]["launches"] = launches

    # ---- 6. train: the training path
    t0 = time.perf_counter()
    del model, sweep, segs, recs, first, x
    torch.cuda.empty_cache()
    train = check_train(dev, gen)
    for name in ("mlstm_fwd", "mlstm_fwd_states", "mlstm_bwd"):
        rows[name]["launches_per_train_step"] = train["per_step"][name]
    for name in ("mlstm_fwd_states", "mlstm_bwd"):
        rows[name]["launches"] = train["launches"][name]
    done("train", t0, train["summary"])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as root:
        # ---- 7. cli: the training entry points
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        cli = check_cli(dev, root)
        for name in ("mlstm_fwd", "mlstm_fwd_states", "mlstm_bwd"):
            rows[name]["launches_cli"] = cli["launches"][name]
            rows[name]["launches_per_pretrain_step"] = cli["pretrain_per_step"][name]
        done("cli", t0, cli["summary"])

        # ---- 8. eval: the evaluation entry point, on phase 7's checkpoint
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        ev = check_eval(dev, torch.Generator(device=dev).manual_seed(4), root)
        for name in ("mlstm_fwd", "mlstm_fwd_states", "mlstm_bwd"):
            rows[name]["launches_eval_cli"] = ev["launches"][name]
        rows["mlstm_fwd"]["launches_per_eval_volume"] = ev["per_volume"]
        done("eval", t0, ev["summary"])

        # ---- 9. precision and remat, on its own generator
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        prec = check_precision(dev, torch.Generator(device=dev).manual_seed(9),
                               {"forward_ms": forward_ms, "step_ms": train["step_ms"],
                                "peak_gib": train["peak_gib"]})
        done("precision", t0, prec["summary"])

        # ---- 10. zoo: the last presets, the native decoder, the patch probe,
        # on its own generator and on phase 7's dataset
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        wait = {k: v["spans"]["train_wait"] / v["steps"] for k, v in cli["report"].items()}
        zoo = check_zoo(dev, torch.Generator(device=dev).manual_seed(10), root, wait)
        done("zoo", t0, zoo)

        # ---- 11. xlstm: the xLSTM model families, on its own generator
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        xl = check_xlstm(dev, torch.Generator(device=dev).manual_seed(11))
        for name in KERNELS:
            rows[name]["launches_xlstm"] = xl["launches"][name]
        done("xlstm", t0, xl["summary"])

        # ---- 12. import: the upstream .pth import and the A9 blocks, on its own generator
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        imp = check_import(dev, torch.Generator(device=dev).manual_seed(12))
        rows["mlstm_fwd"]["launches_import"] = imp["launches"]
        done("import", t0, imp["summary"])

        # ---- 13. parallel: data parallelism, on phase 7's dataset
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        par = check_parallel(dev, root, os.path.join(root, "train"),
                             os.path.join(root, "valid"))
        for name in KERNELS:
            rows[name]["launches_parallel_per_rank_step"] = par["per_step"][name]
        done("parallel", t0, par["summary"])

    # ---- 14. protocol: the full training protocol's driver, chunked in processes
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    proto = check_protocol()
    for name in KERNELS:
        rows[name]["launches_protocol"] = proto["launches"][name]
    done("protocol", t0, proto["summary"])

    # ---- 15. chain: the protocol's chain over K steps, three arms
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    chain = check_chain(dev)
    for name in KERNELS:
        rows[name]["launches_chain"] = chain["launches"][name]
    done("chain", t0, chain["summary"])

    for name, row in rows.items():
        row["max_abs_err"] = worst[name]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
