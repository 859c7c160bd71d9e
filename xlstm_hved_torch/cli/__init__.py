"""Command-line entry points of the port: `train`, `pretrain` and `check`,
each `python -m xlstm_hved_torch.cli.<name>` or an `xhved-torch-<name>`
console script. They run on the CUDA card unless `--device cpu` is given."""
