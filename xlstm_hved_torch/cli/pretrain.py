"""Recon-decoder pretraining entry point (counterpart of
`xlstm_hved_tpu/cli/pretrain.py`).

    python -m xlstm_hved_torch.cli.pretrain --train_dir D/train --valid_dir D/valid \\
        --out_dir R

The net (default U_HVEDDuSFEmViLDFNet3D) has a recon decoder per modality
(`shared_recon=False`); the seg branch is skipped, the seg decoders are
frozen, and the loss is MSE recon + beta * KL. Every epoch validates: MSE,
PSNR and SSIM of the all-modality and the instance-missing recon (eval mode,
deterministic latents). Checkpoints go to <out_dir>/<name>_pretrain, whose
best_vloss the train CLI's --pretrain_weights reads. `main(argv)` returns a
summary as the train CLI's does.
"""
from __future__ import annotations

import time

import torch

from xlstm_hved_torch.cli.common import (assemble_eval_batch, assemble_train_batch,
                                         base_parser, check_args, epoch_line,
                                         print_args, train_cfg_from_args)
from xlstm_hved_torch.data.brats import BraTSDataset, prefetch_loader
from xlstm_hved_torch.engine.checkpoint import CheckpointManager
from xlstm_hved_torch.engine.train import (create_train_state, freeze_mask_for,
                                           make_pretrain_step)
from xlstm_hved_torch.metrics import psnr, ssim3d
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.nn.blocks import compute_dtype
from xlstm_hved_torch.utils.logging import CSVLogger, RunningAverage, timed_iter

CSV_FIELDS = ["Epoch", "Train_Loss", "Valid_Loss", "PSNR_f", "SSIM_f",
              "PSNR_m", "SSIM_m"]
VALID_KEYS = ("vloss", "psnr_f", "ssim_f", "psnr_m", "ssim_m")


@torch.no_grad()
def validate_recon(model, x, x_missing):
    """{vloss, psnr_f, ssim_f, psnr_m, ssim_m} of the all-modality and the
    instance-missing recon, eval mode, deterministic latents."""
    model.eval()
    out_f = model(x, seg=False, recon=True, deterministic=True)
    out_m = model(x_missing, instance_missing=True, seg=False, recon=True,
                  deterministic=True)
    values = torch.stack([torch.mean((out_m.recon - x) ** 2),
                          psnr(out_f.recon, x), ssim3d(out_f.recon, x),
                          psnr(out_m.recon, x), ssim3d(out_m.recon, x)]).tolist()
    return dict(zip(VALID_KEYS, values))


def main(argv=None):
    parser = base_parser("Pretrain the reconstruction decoders (PyTorch port)")
    parser.set_defaults(model_name="U_HVEDDuSFEmViLDFNet3D")
    args = parser.parse_args(argv)
    device = check_args(args)
    print_args(args)

    trainset = BraTSDataset(args.train_dir, m_full=False, seed=args.seed)
    validset = BraTSDataset(args.valid_dir, m_full=False, seed=args.seed + 1)
    steps_per_epoch = max(len(trainset) // args.train_batch, 1)
    cfg = train_cfg_from_args(args, steps_per_epoch)

    model = find_model_using_name(args.model_name, device=device, seed=args.seed,
                                  shared_recon=False, compute_dtype=args.compute_dtype,
                                  remat=args.remat)
    disc = Discriminator(f_maps=args.disc_fmaps, kernel=args.disc_kernel,
                         dtype=compute_dtype(args.disc_dtype))
    sample = torch.zeros((1, 4, *cfg.crop_size), device=device)
    state = create_train_state(model, disc, cfg, args.seed, sample, steps_per_epoch,
                               init_scheme=args.init_scheme)
    del sample
    step = make_pretrain_step(model, cfg, steps_per_epoch,
                              freeze_mask=freeze_mask_for(model, ("sdecoder",)))

    out = f"{args.out_dir}/{args.model_name}_pretrain"
    ckpt = CheckpointManager(out, backup_interval=args.backup_interval)
    state, epoch_start, best_vloss, _ = ckpt.load_or_initialize(state)
    csvlog = CSVLogger(f"{out}/loss_and_metrics.csv", CSV_FIELDS)
    # bounded process chunk (see --stop_after_epoch in cli/common.py)
    end_epoch = (min(args.num_epochs, args.stop_after_epoch)
                 if args.stop_after_epoch else args.num_epochs)

    summary = {"epochs": []}
    for epoch in range(epoch_start, end_epoch + 1):
        t0 = time.perf_counter()
        spans = dict.fromkeys(("train_wait", "train_batch", "train_step", "valid_wait",
                               "valid_batch", "valid_step"), 0.0)
        tr_loss = RunningAverage()
        steps = 0
        loader = prefetch_loader(trainset, args.train_batch, shuffle=True,
                                 seed=args.seed + epoch)
        for items in timed_iter(loader, spans, "train_wait"):
            t = time.perf_counter()
            x, _xm, _mask = assemble_train_batch(items, cfg.crop_size, state.rng, device)
            spans["train_batch"] += time.perf_counter() - t
            t = time.perf_counter()
            state, metrics = step(state, x)
            tr_loss.update(float(metrics["loss"]))
            spans["train_step"] += time.perf_counter() - t
            steps += 1
            del x, _xm, _mask, metrics

        va = {k: RunningAverage() for k in VALID_KEYS}
        items_seen = 0
        loader = prefetch_loader(validset, args.valid_batch, shuffle=False, seed=0)
        for items in timed_iter(loader, spans, "valid_wait"):
            t = time.perf_counter()
            x, xm, _mask = assemble_eval_batch(items, cfg.crop_size, device)
            spans["valid_batch"] += time.perf_counter() - t
            t = time.perf_counter()
            for k, v in validate_recon(model, x, xm).items():
                va[k].update(v)
            spans["valid_step"] += time.perf_counter() - t
            items_seen += len(items)
            del x, xm, _mask

        best_vloss, _ = ckpt.save_epoch(state, epoch, va["vloss"].avg, 0.0, best_vloss, 0.0)
        csvlog.append({"Epoch": epoch, "Train_Loss": tr_loss.avg,
                       "Valid_Loss": va["vloss"].avg,
                       "PSNR_f": va["psnr_f"].avg, "SSIM_f": va["ssim_f"].avg,
                       "PSNR_m": va["psnr_m"].avg, "SSIM_m": va["ssim_m"].avg})
        seconds = time.perf_counter() - t0
        print(epoch_line(epoch, args.num_epochs, seconds, spans,
                         f"loss {tr_loss.avg:.4f} vloss {va['vloss'].avg:.4f} "
                         f"PSNR_m {va['psnr_m'].avg:.2f}"), flush=True)
        summary["epochs"].append(dict(epoch=epoch, seconds=seconds, steps=steps,
                                      valid_items=items_seen, spans=spans))
    summary["step"] = state.step
    return summary


if __name__ == "__main__":
    main()
