"""Training entry point (counterpart of `xlstm_hved_tpu/cli/train.py`).

    python -m xlstm_hved_torch.cli.train --train_dir D/train --valid_dir D/valid \\
        --out_dir R [--pretrain_weights R/<name>_pretrain]

Adversarial seg+recon training with modality-subset dropout, validation
(all-modality and instance-missing passes) on the first epochs and every
`--validate_every`, a CSV metric log, latest / best_vloss / best_dice /
backup checkpoints, pretrained-weight surgery and resume from latest. One
process drives one device (`--device`, the CUDA card by default); a
threaded prefetcher decodes the volumes while the device steps.

With `--distributed` it is one rank of a data-parallel run (start the
ranks with torchrun, or give each --coordinator_address, --num_processes
and --process_id): every rank restores the checkpoint (or does the
surgery), rank 0's state is broadcast, each rank loads its strided shard of
the data, and the steps run inside the mesh, so that N ranks at
--train_batch b step as one process at batch N * b. The ranks take each
step together (`in_lockstep`: a rank whose shard is shorter ends the loop
for all), the epoch's metrics are averaged over the ranks so every rank
tracks the same bests, and only rank 0 prints and writes the checkpoints
and the CSV.

`main(argv)` returns a summary for the caller: per epoch its seconds, step
and validation counts and where the time went (`spans`: the loop's waits on
the loader, the host batch assembly, the steps up to their metrics on the
host, and the same for validation), and the surgery's counts.
"""
from __future__ import annotations

import time

import torch

from xlstm_hved_torch.cli.common import (assemble_eval_batch, assemble_train_batch,
                                         base_parser, check_args, epoch_line,
                                         make_datasets, maybe_init_distributed, print_args,
                                         train_cfg_from_args)
from xlstm_hved_torch.data.brats import prefetch_loader
from xlstm_hved_torch.data.sdm import compute_sdm
from xlstm_hved_torch.engine.checkpoint import CheckpointManager, surgical_restore
from xlstm_hved_torch.engine.train import (create_train_state, make_eval_step,
                                           make_train_step)
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.nn.blocks import compute_dtype
from xlstm_hved_torch.parallel.mesh import (allreduce_averages, in_lockstep, make_mesh,
                                            replicate)
from xlstm_hved_torch.utils.logging import (CSVLogger, RunningAverage, profiler_trace, span,
                                            timed_iter)

CSV_FIELDS = [
    "Epoch", "Train_Loss", "Train_dice", "Train_wt_dice", "Train_tc_dice",
    "Train_ec_dice", "Train_recon", "Train_kld", "Train_g_gan",
    "Train_loss_d", "Valid_Loss", "Valid_dice", "Valid_wt_dice",
    "Valid_tc_dice", "Valid_ec_dice", "Valid_wt_dice_m", "Valid_tc_dice_m",
    "Valid_ec_dice_m", "Valid_PSNR_f", "Valid_PSNR_m",
]
TRAIN_KEYS = ("loss", "train_dice", "wt_dice", "tc_dice", "ec_dice", "recon", "kld",
              "g_gan", "loss_d")
VALID_KEYS = ("vloss", "dice", "wt_dice", "tc_dice", "ec_dice", "wt_dice_m", "tc_dice_m",
              "ec_dice_m", "psnr_f", "psnr_m")


def read_metrics(metrics, keys):
    """The named 0-d device tensors as floats, in one device-to-host copy."""
    return dict(zip(keys, torch.stack([metrics[k].float() for k in keys]).tolist()))


def main(argv=None):
    args = base_parser("Train a model (XLSTM-HVED, PyTorch port)").parse_args(argv)
    rank, world = maybe_init_distributed(args)
    device = check_args(args)
    is_main = rank == 0
    if is_main:
        print_args(args)

    trainset, validset = make_datasets(args)
    # the steps each rank takes: one process at the global batch takes as many
    steps_per_epoch = max(len(trainset) // (args.train_batch * world), 1)
    cfg = train_cfg_from_args(args, steps_per_epoch)

    model = find_model_using_name(args.model_name, device=device, seed=args.seed,
                                  compute_dtype=args.compute_dtype, remat=args.remat)
    disc = Discriminator(f_maps=args.disc_fmaps, kernel=args.disc_kernel,
                         dtype=compute_dtype(args.disc_dtype))
    sample = torch.zeros((1, 4, *cfg.crop_size), device=device)
    state = create_train_state(model, disc, cfg, args.seed, sample, steps_per_epoch,
                               init_scheme=args.init_scheme)
    del sample

    summary = {"epochs": [], "surgery": None}
    ckpt = CheckpointManager(f"{args.out_dir}/{args.model_name}",
                             backup_interval=args.backup_interval)
    if args.pretrain_weights:
        # the pretrain net's tree differs from this one (a recon decoder per
        # modality, 1-channel heads), so load by name and shape
        donor, _meta = CheckpointManager(args.pretrain_weights).restore_raw("best_vloss")
        loaded, skipped = surgical_restore(model, donor["model"], verbose=is_main)
        summary["surgery"] = (len(loaded), len(skipped))
        del donor
    state, epoch_start, best_vloss, best_dice = ckpt.load_or_initialize(state)
    mesh = make_mesh(device=device)
    replicate(mesh, state)
    data_shard = (rank, world) if world > 1 else None

    train_step = make_train_step(model, disc, cfg, steps_per_epoch)
    eval_step = make_eval_step(model)
    csvlog = (CSVLogger(f"{args.out_dir}/{args.model_name}/loss_and_metrics.csv", CSV_FIELDS)
              if is_main else None)
    # bounded process chunk: stop (checkpointed) after --stop_after_epoch
    # while the LR schedule keeps the full --num_epochs horizon
    end_epoch = (min(args.num_epochs, args.stop_after_epoch)
                 if args.stop_after_epoch else args.num_epochs)

    with mesh, profiler_trace((args.profile_dir if is_main else "") or None):
        for epoch in range(epoch_start, end_epoch + 1):
            t0 = time.perf_counter()
            spans = dict.fromkeys(("train_wait", "train_batch", "train_step", "valid_wait",
                                   "valid_batch", "valid_step"), 0.0)
            tr = {k: RunningAverage() for k in TRAIN_KEYS}
            steps = 0
            loader = prefetch_loader(trainset, args.train_batch, shuffle=True,
                                     seed=args.seed + epoch, shard=data_shard)
            for items in timed_iter(in_lockstep(loader, mesh), spans, "train_wait"):
                with span("train_batch", spans):
                    x, _xm, mask = assemble_train_batch(items, cfg.crop_size, state.rng,
                                                        device)
                    sdm = None
                    if cfg.use_sdm:
                        sdm = torch.from_numpy(
                            compute_sdm(mask.cpu().numpy() > 0.5)).to(device)
                with span("train_step", spans):
                    state, metrics = train_step(state, x, mask, sdm)
                    for k, v in read_metrics(metrics, TRAIN_KEYS).items():
                        tr[k].update(v)
                steps += 1
                del x, mask, sdm, metrics

            va = {k: RunningAverage() for k in VALID_KEYS}
            did_validate = epoch < 5 or (epoch + 1) % args.validate_every == 0
            items_seen = 0
            if did_validate:
                loader = prefetch_loader(validset, args.valid_batch, shuffle=False, seed=0,
                                         shard=data_shard)
                for items in timed_iter(in_lockstep(loader, mesh), spans, "valid_wait"):
                    with span("valid_batch", spans):
                        x, xm, mask = assemble_eval_batch(items, cfg.crop_size, device)
                    with span("valid_step", spans):
                        for k, v in read_metrics(eval_step(x, xm, mask), VALID_KEYS).items():
                            va[k].update(v)
                    items_seen += len(items)
                    del x, xm, mask

            # every rank takes the same (global) numbers, so the bests agree
            trg = allreduce_averages(tr)
            vag = allreduce_averages(va) if did_validate else {}
            vloss = vag["vloss"] if did_validate else None
            vdice = vag["dice"] if did_validate else None
            epoch_summary = dict(epoch=epoch, steps=steps, valid_items=items_seen, spans=spans)
            summary["epochs"].append(epoch_summary)
            if not is_main:  # track the bests without rank 0's writes
                if did_validate:
                    best_vloss, best_dice = min(best_vloss, vloss), max(best_dice, vdice)
                epoch_summary["seconds"] = time.perf_counter() - t0
                continue
            best_vloss, best_dice = ckpt.save_epoch(state, epoch, vloss, vdice,
                                                    best_vloss, best_dice)
            row = {
                "Epoch": epoch, "Train_Loss": trg["loss"],
                "Train_dice": trg["train_dice"], "Train_wt_dice": trg["wt_dice"],
                "Train_tc_dice": trg["tc_dice"], "Train_ec_dice": trg["ec_dice"],
                "Train_recon": trg["recon"], "Train_kld": trg["kld"],
                "Train_g_gan": trg["g_gan"], "Train_loss_d": trg["loss_d"],
            }
            if did_validate:
                row.update({
                    "Valid_Loss": vloss, "Valid_dice": vdice,
                    "Valid_wt_dice": vag["wt_dice"], "Valid_tc_dice": vag["tc_dice"],
                    "Valid_ec_dice": vag["ec_dice"],
                    "Valid_wt_dice_m": vag["wt_dice_m"],
                    "Valid_tc_dice_m": vag["tc_dice_m"],
                    "Valid_ec_dice_m": vag["ec_dice_m"],
                    "Valid_PSNR_f": vag["psnr_f"], "Valid_PSNR_m": vag["psnr_m"],
                })
            csvlog.append(row)
            seconds = epoch_summary["seconds"] = time.perf_counter() - t0
            vtxt = (f"vloss {vloss:.4f} vdice {vdice:.4f} PSNR_m {vag['psnr_m']:.2f}"
                    if did_validate else "no-val")
            print(epoch_line(epoch, args.num_epochs, seconds, spans,
                             f"loss {trg['loss']:.4f} dice {trg['train_dice']:.4f} "
                             f"{vtxt}"), flush=True)
    summary["step"] = state.step
    return summary


if __name__ == "__main__":
    main()
