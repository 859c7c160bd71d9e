#!/usr/bin/env python3
"""The training protocol over seeds: `scripts/torch_full_scale_run.py`
(data, `cli.pretrain`, `cli.train --pretrain_weights`, `cli.test --ckpt
best_dice --eval_recon --compute_hd95`, each a process of its own) with
`--seed S` given to every CLI, at a named recipe:

    python3 scripts/torch_protocol_seeds.py --recipe r5 --seeds 1 2 3 --out_root R
    python3 scripts/torch_protocol_seeds.py --recipe m32 --seeds 1 --device cpu

Recipes (the JAX package's runs they are set beside):
  r5   80x112x80 volumes, crop 64x96x64, 8+4 subjects, 3+10 epochs (JAX's
       post-fix round-5 run, docs/fullscale/run_r5_postfix/)
  m32  48x48x48 volumes, crop 32^3, 8+2 subjects, 3+15 epochs (the matched
       runs of both packages on the CPU, docs/fullscale/run_torch_h100/
       matched_32_cpu/)
  quick  the protocol script's --quick (the orchestration itself)
Each seed is one protocol run under <out_root>/<recipe>/seed<S>[tag]/, with
the protocol's data seeds 0 and 1000: data/, the two CSVs,
subset_table.txt, summary.json and phases.json as the protocol script
writes them.

`--init_from FILE` starts every net from the initial state dicts in FILE
("pre", "flag", "disc"; `tests/make_torch_jax_cli_init.py` writes those the
JAX package's CLIs draw for a seed), with the phases in this process; `--tag`
names the run directories.

After the first seed, `--probe` runs the bottleneck ViL of its best_dice
flagship over the validation volumes (all modalities, the evaluation crop)
and prints, per volume, the largest spread of the input gate within a
chunk, the smallest and largest entry stabiliser m* of the chunks after the
first (nan with one chunk) and any non-finite value: the gate regimes
training reached, beside those the kernel checks cover.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_full_scale_run as protocol  # noqa: E402

# the protocol script's flags for each recipe
RECIPES = {
    "r5": ["--shape", "80", "112", "80", "--crop", "64", "96", "64", "--n_train", "8",
           "--n_valid", "4", "--pretrain_epochs", "3", "--train_epochs", "10"],
    "m32": ["--shape", "48", "48", "48", "--crop", "32", "32", "32", "--n_train", "8",
            "--n_valid", "2", "--pretrain_epochs", "3", "--train_epochs", "15"],
    "quick": ["--quick"],
}
MODEL = "XLSTM_HVED"


def probe(out: str, valid_dir: str, crop, device: str) -> list:
    """The bottleneck ViL's gates, as its cell computes them, and the entry
    stabilisers they give through the plain twin of the kernels' chunk walk
    (chunk 128), over the validation volumes."""
    import torch

    from xlstm_hved_torch.cli.common import assemble_eval_batch
    from xlstm_hved_torch.data.brats import BraTSDataset
    from xlstm_hved_torch.engine.checkpoint import CheckpointManager
    from xlstm_hved_torch.models import find_model_using_name
    from xlstm_hved_torch.ops import mlstm_cuda

    dev = torch.device(device)
    model = find_model_using_name(MODEL, device=dev)
    saved, meta = CheckpointManager(os.path.join(out, MODEL)).restore_raw("best_dice")
    model.load_state_dict(saved["model"], strict=True)
    cell = model.mvil.vil.layer.mlstm_cell
    gates, seen = {}, []

    def keep(name):   # the gate's output, (B, NH, S) as the cell gives it to the scan
        def hook(module, args, out):
            gates[name] = out.detach().transpose(1, 2).float()
        return hook

    def read(module, args, out):
        q, k, v = args
        B, S, _ = q.shape
        NH = module.num_heads
        ig, fg = gates["igate"], gates["fgate"]
        heads = lambda t: t.reshape(B, S, NH, -1).transpose(1, 2).float()
        prepared = mlstm_cuda.prepare(heads(q), heads(k), heads(v), ig, fg, module.chunk_size)
        # the entry stabilisers of the chunks after the first (the first
        # enters from no state)
        m_star = mlstm_cuda.mlstm_forward_states_reference(*prepared,
                                                           dh=q.shape[-1] // NH)[3][:, 1:]
        if m_star.numel() == 0:
            m_star = torch.full((1,), float("nan"))
        L = min(module.chunk_size, S)
        chunks = ig[..., :S - S % L].reshape(B, NH, -1, L)
        seen.append(dict(S=S, igate_min=float(ig.min()), igate_max=float(ig.max()),
                         igate_chunk_spread=float((chunks.amax(-1) - chunks.amin(-1)).max()),
                         fgate_min=float(fg.min()), fgate_max=float(fg.max()),
                         m_star_min=float(m_star.min()), m_star_max=float(m_star.max()),
                         finite=bool(torch.isfinite(ig).all() and torch.isfinite(fg).all()
                                     and not torch.isinf(m_star).any())))

    handles = [cell.igate.register_forward_hook(keep("igate")),
               cell.fgate.register_forward_hook(keep("fgate")),
               cell.register_forward_hook(read)]
    data = BraTSDataset(valid_dir, m_full=True, seed=0)
    try:
        with torch.no_grad():
            for i in range(len(data)):
                item = data.load(i)
                if item is None:
                    continue
                x, _xm, _mask = assemble_eval_batch([item], crop, dev)
                out_v = model(x, recon=True, deterministic=True)
                seen[-1]["seg_finite"] = bool(torch.isfinite(out_v.seg).all())
    finally:
        for handle in handles:
            handle.remove()
    for i, rec in enumerate(seen):
        print(f"[probe] volume {i} (best_dice epoch {meta.get('epoch')}): S {rec['S']}, "
              f"igate [{rec['igate_min']:.3f}, {rec['igate_max']:.3f}], largest spread in a "
              f"chunk {rec['igate_chunk_spread']:.3f}, fgate [{rec['fgate_min']:.3f}, "
              f"{rec['fgate_max']:.3f}], m* [{rec['m_star_min']:.3f}, {rec['m_star_max']:.3f}], "
              f"all finite {rec['finite'] and rec['seg_finite']}", flush=True)
    with open(os.path.join(out, "gate_probe.json"), "w") as f:
        json.dump(seen, f, indent=1)
    return seen


def start_from(path: str) -> None:
    """Make the pretrain and train CLIs in this process start from the
    initial state dicts in `path` ("pre", "flag", "disc") in place of their
    own draws."""
    import torch

    from xlstm_hved_torch.cli import pretrain, train

    saved = torch.load(path, map_location="cpu", weights_only=True)

    def wrap(create, net):
        def create_train_state(model, disc, *args, **kwargs):
            state = create(model, disc, *args, **kwargs)
            model.load_state_dict(saved[net], strict=True)
            if net == "flag":
                disc.load_state_dict(saved["disc"], strict=True)
            return state
        return create_train_state

    pretrain.create_train_state = wrap(pretrain.create_train_state, "pre")
    train.create_train_state = wrap(train.create_train_state, "flag")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--recipe", choices=sorted(RECIPES), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out_root", default=os.path.join(ROOT, "runs", "protocol_seeds"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probe", action="store_true",
                    help="after the first seed, the bottleneck ViL's gate probe")
    ap.add_argument("--tag", default="",
                    help="suffix of the run directories (seed<S><tag>)")
    ap.add_argument("--init_from", default="",
                    help="the phases in this process, each net starting from the initial "
                         "state dicts in this file (tests/make_torch_jax_cli_init.py)")
    args = ap.parse_args(argv)
    if args.init_from:
        start_from(args.init_from)
    root = os.path.join(os.path.abspath(args.out_root), args.recipe)
    results = {}
    for n, seed in enumerate(args.seeds):
        out = os.path.join(root, f"seed{seed}{args.tag}")
        flags = RECIPES[args.recipe] + ["--out_root", out, "--device", args.device,
                                        "--compute_hd95"]
        summary = protocol.main(flags + (["--inprocess"] if args.init_from else []),
                                extra=["--seed", str(seed)])
        results[seed] = summary
        if args.probe and n == 0:
            probe(out, os.path.join(out, "data", "valid"), tuple(summary["crop"]), args.device)
    print(json.dumps({"recipe": args.recipe, "seeds": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
