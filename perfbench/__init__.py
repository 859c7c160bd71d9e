"""The benchmark of the PyTorch / CUDA port `xlstm_hved_torch` on NVIDIA
H100 cards: `python3 perfbench/run.py --workload <cell> ...` runs one cell
of `BENCHMARK.json` (see README.md)."""
