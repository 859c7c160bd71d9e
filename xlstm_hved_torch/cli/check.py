"""Data sanity check (counterpart of `xlstm_hved_tpu/cli/check.py`): list
the subjects of a BraTS-layout directory, optionally decode every modality
and seg file, and write the good subjects' names to a file.

    python -m xlstm_hved_torch.cli.check --data_dir D/train --decode
"""
from __future__ import annotations

import argparse

from xlstm_hved_torch.data.brats import BraTSDataset


def main(argv=None):
    p = argparse.ArgumentParser(description="BraTS dataset sanity check")
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out_file", type=str, default="subjects.txt")
    p.add_argument("--decode", action="store_true",
                   help="fully decode every subject (slow)")
    args = p.parse_args(argv)

    ds = BraTSDataset(args.data_dir, m_full=True)
    good, bad = [], []
    for i, name in enumerate(ds.subjects):
        if args.decode:
            item = ds.load(i)
            (good if item is not None else bad).append(name)
        else:
            good.append(name)
    with open(args.out_file, "w") as f:
        for name in good:
            f.write(name + "\n")
    print(f"{len(good)} subjects OK, {len(bad)} failed -> {args.out_file}")
    if bad:
        print("failed:", bad)
    return good, bad


if __name__ == "__main__":
    main()
