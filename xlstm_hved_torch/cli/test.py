"""15-subset missing-modality evaluation entry point (counterpart of
`xlstm_hved_tpu/cli/test.py`).

    python -m xlstm_hved_torch.cli.test --valid_dir D/valid --out_dir R \\
        [--ckpt best_dice] [--compute_hd95] [--eval_recon] \\
        [--save_pred_dir P] [--save_plots_dir Q]

Restores G from <out_dir>/<model_name>/<ckpt> (randomly initialised weights,
with a warning, when it is missing), centre-crops every validation volume to
--crop_size and runs the sliding window (patch = stride = crop) over all 15
modality subsets: the hoisted sweep for the MVAE models, else the plain sweep
five subsets at a time. It prints Dice WT / TC / ET per subset (with HD95,
and PSNR / SSIM of the recon, when asked) and the average, and exports the
all-modality labels (WT -> 2, TC -> 1, ET -> 4) as <subject>-pred.nii.gz
and mid-slice overlays as PNGs. One device (`--device`, the CUDA card by
default); `--profile_dir` writes a torch.profiler trace of the volumes there.

`main(argv)` returns a summary: the (15, 3) mean Dice and HD95, the (15,)
PSNR and SSIM, the volume count and, per volume, its seconds and where they
went (`spans`: load, transform_copy, sweep, dice, hd95, recon_metrics,
export).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from xlstm_hved_torch.cli.common import (assemble_eval_batch, base_parser, check_args,
                                         print_args)
from xlstm_hved_torch.data.brats import BraTSDataset
from xlstm_hved_torch.data.nifti import write_nifti
from xlstm_hved_torch.engine.checkpoint import CheckpointManager
from xlstm_hved_torch.engine.evaluate import (default_apply_fn, label_volume_from_probs,
                                              make_hoisted_subset_sweep, make_subset_sweep)
from xlstm_hved_torch.metrics import dice_regions, hd95_regions, psnr, ssim3d
from xlstm_hved_torch.models import find_model_using_name
from xlstm_hved_torch.nn.init_schemes import default_init
from xlstm_hved_torch.utils.logging import profiler_trace, span
from xlstm_hved_torch.utils.subsets import SUBSETS_MODALITIES

SPANS = ("load", "transform_copy", "sweep", "dice", "hd95", "recon_metrics", "export")


def parser():
    p = base_parser("15-subset missing-modality evaluation (PyTorch port)")
    p.add_argument("--ckpt", type=str, default="best_dice")
    p.add_argument("--compute_hd95", action="store_true")
    p.add_argument("--save_pred_dir", type=str, default="")
    p.add_argument("--eval_recon", action="store_true",
                   help="also sweep the reconstruction (PSNR / SSIM per subset)")
    p.add_argument("--save_plots_dir", type=str, default="",
                   help="write mid-slice segmentation overlays (PNG)")
    return p


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parser().parse_args(argv)
    device = check_args(args)
    print_args(args)

    validset = BraTSDataset(args.valid_dir, m_full=True, seed=0)
    crop = tuple(args.crop_size)
    model = find_model_using_name(args.model_name, device=device, seed=args.seed,
                                  compute_dtype=args.compute_dtype)
    ckpt = CheckpointManager(f"{args.out_dir}/{args.model_name}")
    if ckpt.exists(args.ckpt):
        model.load_state_dict(ckpt.restore_raw(args.ckpt)[0]["model"], strict=True)
        print(f"restored checkpoint {args.ckpt}")
    else:
        default_init(model, torch.Generator().manual_seed(0))
        print(f"WARNING: checkpoint {args.ckpt} not found; evaluating "
              "randomly-initialized weights")

    recon_channels = 4 if args.eval_recon else 0
    if model.cfg.mvae and not model.cfg.fusion:
        # the subset-invariant prefix runs once per window, not 15 times
        sweep = make_hoisted_subset_sweep(model, crop, crop, recon_channels=recon_channels)
    else:
        sweep = make_subset_sweep(default_apply_fn(model, recon=args.eval_recon), crop, crop,
                                  recon_channels=recon_channels, subset_chunk=5)

    n_sub = len(SUBSETS_MODALITIES)
    dice_sums, hd_sums = np.zeros((n_sub, 3)), np.zeros((n_sub, 3))
    psnr_sums, ssim_sums = np.zeros(n_sub), np.zeros(n_sub)
    per_volume = []
    with profiler_trace(args.profile_dir or None):
        for i in range(len(validset)):
            t0 = time.perf_counter()
            spans = dict.fromkeys(SPANS, 0.0)
            with span("load", spans):
                item = validset.load(i)
            if item is None:
                continue
            subject = validset.subjects[i]
            with span("transform_copy", spans):
                x, _xm, mask = assemble_eval_batch([item], crop, device)
                del item, _xm
            with span("sweep", spans):
                out = sweep(model, x)
                segs, recons = out if args.eval_recon else (out, None)
                _sync(device)
            with span("dice", spans):
                # the 45 Dice values of the volume in one device-to-host copy
                dice_sums += dice_regions(segs, mask).double().cpu().numpy()
            if args.compute_hd95:
                with span("hd95", spans):
                    hd_sums += hd95_regions((segs > 0.5).cpu().numpy(), mask.cpu().numpy())
            if args.eval_recon:
                with span("recon_metrics", spans):
                    values = torch.stack([torch.stack([psnr(recons[s], x),
                                                       ssim3d(recons[s], x)])
                                          for s in range(n_sub)]).double().cpu().numpy()
                    psnr_sums += values[:, 0]
                    ssim_sums += values[:, 1]
            if args.save_plots_dir or args.save_pred_dir:
                with span("export", spans):
                    seg_all = segs[-1, 0].cpu().numpy()  # the all-modality subset
                    if args.save_plots_dir:
                        from xlstm_hved_torch.utils.visualize import plot_segm

                        plot_segm(args.save_plots_dir, subject, x[0].cpu().numpy(), seg_all,
                                  mask[0].cpu().numpy())
                    if args.save_pred_dir:
                        os.makedirs(args.save_pred_dir, exist_ok=True)
                        write_nifti(os.path.join(args.save_pred_dir, f"{subject}-pred.nii.gz"),
                                    label_volume_from_probs(seg_all))
            del x, mask, segs, recons, out
            seconds = time.perf_counter() - t0
            per_volume.append(dict(subject=subject, seconds=seconds, spans=spans))
            print(f"volume {subject}: {seconds:.2f}s ("
                  + " ".join(f"{k} {v:.2f}s" for k, v in spans.items()) + ")", flush=True)

    count = len(per_volume)
    n = max(count, 1)
    print(f"\n=== {count} volumes, Dice (WT / TC / ET) per subset ===")
    for s, subset in enumerate(SUBSETS_MODALITIES):
        d = dice_sums[s] / n
        row = f"subset {s:2d} {str(subset):18s} {d[0]:.4f} {d[1]:.4f} {d[2]:.4f}"
        if args.compute_hd95:
            h = hd_sums[s] / n
            row += f"   HD95 {h[0]:7.2f} {h[1]:7.2f} {h[2]:7.2f}"
        if args.eval_recon:
            row += f"   PSNR {psnr_sums[s] / n:6.2f} SSIM {ssim_sums[s] / n:.4f}"
        print(row)
    avg = dice_sums.mean(axis=0) / n
    print(f"average{'':14s} {avg[0]:.4f} {avg[1]:.4f} {avg[2]:.4f}", flush=True)
    return dict(dice=dice_sums / n,
                hd95=hd_sums / n if args.compute_hd95 else None,
                psnr=psnr_sums / n if args.eval_recon else None,
                ssim=ssim_sums / n if args.eval_recon else None,
                volumes=count, per_volume=per_volume)


if __name__ == "__main__":
    main()
