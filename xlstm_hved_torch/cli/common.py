"""Shared CLI plumbing (counterpart of `xlstm_hved_tpu/cli/common.py`): the
argument surface of the entry points and the host-to-device batch assembly.

The parser keeps every flag and default of the JAX `base_parser` (bf16
compute for G and D included), and adds `--device` (default `cuda`; the CPU
only when asked for). `maybe_init_distributed` joins the process group of a
`--distributed` run (NCCL on the card, gloo on the CPU), as JAX's joins
jax.distributed. One process drives one device, so `--num_data_devices`
is the number of processes: 0 or the world size (`check_args`). There is no
compile cache to enable (the JAX CLIs turn on XLA's): the CUDA kernels'
build cache is `xlstm_hved_torch/_build/`.
"""
from __future__ import annotations

import argparse
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.models import resolve_device
from xlstm_hved_torch.parallel.mesh import (backend_for, initialize_distributed, rank_device,
                                            sample_rows)


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run raises when a CUDA device is "
                        "asked for and none is present. Under --distributed "
                        "'cuda' is cuda:$LOCAL_RANK")
    p.add_argument("--num_epochs", type=int, default=3000)
    p.add_argument("--n_class", type=int, default=3)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_adv", type=float, default=0.1)
    p.add_argument("--weight_vae", type=float, default=0.2)
    p.add_argument("--validate_every", type=int, default=1)
    p.add_argument("--save_every", type=int, default=5)
    p.add_argument("--save_dir", default="model")
    p.add_argument("--crop_size", type=int, nargs=3, default=[128, 192, 128])
    p.add_argument("--train_batch", type=int, default=1)
    p.add_argument("--valid_batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--train_dir", type=str, default="data/BraTS2024/train")
    p.add_argument("--valid_dir", type=str, default="data/BraTS2024/test")
    p.add_argument("--backup_interval", type=int, default=5)
    p.add_argument("--out_dir", type=str, default="results")
    p.add_argument("--model_name", type=str, default="XLSTM_HVED")
    p.add_argument("--pretrain_weights", type=str, default="")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="G's compute dtype (parameters, gradients and Adam state "
                        "stay float32; the ViL and the mLSTM kernels run float32)")
    p.add_argument("--num_data_devices", type=int, default=0,
                   help="data-parallel size: 0 (all) or the number of processes, "
                        "one device each (start more with torchrun)")
    p.add_argument("--profile_dir", type=str, default="",
                   help="torch.profiler trace output dir (empty = off)")
    p.add_argument("--disc_kernel", type=int, default=4,
                   help="discriminator conv kernel (use 3 for crops < 48)")
    p.add_argument("--disc_fmaps", type=int, default=64)
    p.add_argument("--disc_dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="discriminator compute dtype")
    p.add_argument("--remat", action="store_true",
                   help="recompute the encoder, DRB and decoder stages in the "
                        "backward (less peak memory, more time)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process data parallelism (cli.train): join the "
                        "process group, NCCL for a CUDA --device, gloo for the CPU")
    p.add_argument("--coordinator_address", type=str, default="",
                   help="host:port of rank 0 (empty: torchrun's env://)")
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--dataset", type=str, default="brats",
                   choices=["brats", "isles", "brats_valid"],
                   help="brats: per-subject NIfTI dirs; isles: HDF5 with "
                        "Bernoulli(0.5) modality dropout; brats_valid: the "
                        "label-free BraTS2018 validation HDF5 (eval/export only)")
    p.add_argument("--h5_path", type=str, default="",
                   help="HDF5 file for --dataset isles / brats_valid")
    p.add_argument("--stop_after_epoch", type=int, default=0,
                   help="stop the epoch loop after this epoch (0 = run to "
                        "--num_epochs) without shortening the LR horizon; a "
                        "resume from latest continues where it stopped, so a "
                        "long training can run as bounded process chunks")
    p.add_argument("--init_scheme", type=str, default="reference",
                   choices=["reference", "default"],
                   help="fresh-start weight init: 'reference' (kaiming kernels, "
                        "N(0, 1) conv biases) or 'default' (the flax "
                        "initialisers). Ignored on checkpoint resume")
    p.add_argument("--sdm", action="store_true",
                   help="add the boundary loss <seg, SDM(gt)> to the generator "
                        "objective")
    p.add_argument("--weight_bd", type=float, default=0.5,
                   help="boundary-loss weight (only with --sdm)")
    return p


def maybe_init_distributed(args) -> Tuple[int, int]:
    """(rank, world size); joins the process group when --distributed is
    set (`parallel.mesh.initialize_distributed`, whose failure raises)."""
    if getattr(args, "distributed", False):
        initialize_distributed(args.coordinator_address or None,
                               args.num_processes or None,
                               args.process_id if args.process_id >= 0 else None,
                               backend=backend_for(args.device))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def check_args(args) -> torch.device:
    """Check --num_data_devices against the processes (one device each:
    0 or the world size) and return this process's device, which raises
    when it is a CUDA device and none is present; in a process group a bare
    'cuda' is cuda:$LOCAL_RANK, and an index the host lacks raises."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.num_data_devices not in (0, world):
        raise ValueError(
            f"--num_data_devices {args.num_data_devices}: one process drives one device "
            f"here and this run has {world}; start {args.num_data_devices} processes with "
            f"torchrun --nproc_per_node {args.num_data_devices} ... --distributed")
    if dist.is_initialized():
        return rank_device(args.device)
    return resolve_device(args.device)


def make_datasets(args):
    """(trainset, validset) per --dataset. BraTS: two NIfTI directory sets.
    ISLES: one HDF5 split 80/20 by index."""
    from xlstm_hved_torch.data.brats import (BraTSDataset, BraTSValidationSet,
                                             ISLESDataset)

    if args.dataset == "brats_valid":
        if not args.h5_path:
            raise ValueError("--dataset brats_valid requires --h5_path")
        # label-free: both slots get the validation set
        valid = BraTSValidationSet(args.h5_path, seed=args.seed + 1)
        return valid, valid
    if args.dataset == "isles":
        if not args.h5_path:
            raise ValueError("--dataset isles requires --h5_path")
        import h5py

        with h5py.File(args.h5_path, "r") as f:
            n = len(f["images"])
        split = max(int(n * 0.8), 1)
        train = ISLESDataset(args.h5_path, indices=range(split),
                             m_full=False, seed=args.seed)
        valid = ISLESDataset(args.h5_path, indices=range(split, n),
                             m_full=True, seed=args.seed + 1)
        return train, valid
    return (BraTSDataset(args.train_dir, m_full=True, seed=args.seed),
            BraTSDataset(args.valid_dir, m_full=True, seed=args.seed + 1))


def print_args(args) -> None:
    print("========== arguments ==========")
    for k in vars(args):
        print(f"{k}: {getattr(args, k)}")
    print("===============================")


def epoch_line(epoch: int, num_epochs: int, seconds: float, spans, text: str) -> str:
    """The per-epoch print line: metrics, then the epoch's seconds and where
    they went (`spans`, name -> seconds)."""
    host = " ".join(f"{k} {v:.2f}s" for k, v in spans.items())
    return f"Epoch [{epoch}/{num_epochs}] {text} ({seconds:.1f}s: {host})"


def train_cfg_from_args(args, steps_per_epoch=None) -> TrainConfig:
    return TrainConfig(
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        weight_decay=1e-5,
        weight_adv=args.weight_adv,
        weight_vae=args.weight_vae,
        use_sdm=getattr(args, "sdm", False),
        weight_bd=getattr(args, "weight_bd", 0.5),
        crop_size=tuple(args.crop_size),
        train_batch=args.train_batch,
        valid_batch=args.valid_batch,
        seed=args.seed,
        validate_every=args.validate_every,
        backup_interval=args.backup_interval,
        steps_per_epoch=steps_per_epoch,
    )


def _to_device(xs: Sequence[np.ndarray], masks: Sequence[np.ndarray],
               keeps: Sequence[np.ndarray], device):
    """Channels-last host arrays -> NCDHW (x, x_missing, mask) on `device`.
    The mask crosses as uint8 and is cast there; x_missing is formed there."""
    x = torch.from_numpy(np.stack(xs)).to(device).permute(0, 4, 1, 2, 3).contiguous()
    mask = torch.from_numpy(np.stack(masks)).to(device).permute(0, 4, 1, 2, 3)
    keep = torch.from_numpy(np.stack(keeps)).to(device, torch.float32)
    return x, x * keep[:, :, None, None, None], mask.contiguous().float()


def assemble_train_batch(items: List[Tuple], crop, generator: torch.Generator,
                         device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Host batch (list of (img, labels, keep, bg)) -> (x, x_missing, mask)
    NCDHW on `device`. Augmentation runs on the host (`host_augment`), so
    only the crop crosses to the device. Each item's augment seed is drawn
    from `generator`, a CPU torch.Generator (the JAX function draws them
    from a PRNG key: the same semantics, another stream). Under a data mesh
    the seeds are drawn for the global batch and each rank keeps its own."""
    from xlstm_hved_torch.data.transforms import host_augment

    seeds = sample_rows(lambda shape: torch.randint(0, 2 ** 31 - 1, shape, generator=generator),
                        (len(items),)).tolist()
    xs, keeps, masks = [], [], []
    for seed, (img, labels, keep, _bg) in zip(seeds, items):
        x, m = host_augment(np.random.RandomState(seed), img, labels, tuple(crop))
        xs.append(x)
        keeps.append(keep)
        masks.append(m)
    return _to_device(xs, masks, keeps, device)


def assemble_eval_batch(items: List[Tuple], crop, device
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """As `assemble_train_batch`, with the deterministic centre crop."""
    from xlstm_hved_torch.data.transforms import host_eval_transform

    xs, keeps, masks = [], [], []
    for img, labels, keep, _bg in items:
        x, m = host_eval_transform(img, labels, crop=tuple(crop))
        xs.append(x)
        keeps.append(keep)
        masks.append(m)
    return _to_device(xs, masks, keeps, device)
