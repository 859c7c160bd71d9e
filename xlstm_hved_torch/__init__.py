"""xlstm_hved_torch — the PyTorch/CUDA port of the XLSTM-HVED inference path
for one NVIDIA H100.

It mirrors the layout of the JAX package `xlstm_hved_tpu` (the reference it
is held against) but imports nothing from it. Volumes are NCDHW
(B, C, D, H, W); expert stacks are (B, 5, C, D, H, W) with the prior at
expert 0. The bottleneck mLSTM runs through a hand-written CUDA kernel
(`csrc/mlstm_fwd.cu`, bound in `ops/mlstm_cuda.py`) when its tensors are on
the card, and through the plain PyTorch scan (`ops/mlstm.py`) when the
caller asked for the CPU.

Subpackages
-----------
- ops:     PoE/reparametrize, the plain mLSTM, the CUDA mLSTM forward wrapper
- nn:      conv blocks, ViL stack, skip-return gate, DuSE
- models:  HVEDFusionNet and the model-zoo factory
- engine:  sliding-window inference and the 15-subset sweep
- utils:   subset table, JAX-tree weight conversion, CUDA build helper
"""

__version__ = "0.1.0"
