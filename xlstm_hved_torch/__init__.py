"""xlstm_hved_torch — the PyTorch/CUDA port of XLSTM-HVED (the inference
path, the adversarial train step, the recon pretrain step and the training
entry points) for one NVIDIA H100.

It mirrors the layout of the JAX package `xlstm_hved_tpu` (the reference it
is held against) but imports nothing from it. Volumes are NCDHW
(B, C, D, H, W); expert stacks are (B, 5, C, D, H, W) with the prior at
expert 0. The mLSTM of every ViL runs through hand-written CUDA kernels
(`csrc/mlstm_fwd.cu` for the forward and the states-saving forward,
`csrc/mlstm_bwd.cu` for the backward, bound in `ops/mlstm_cuda.py`) when its
tensors are on the card, and through the plain PyTorch scan and its
autograd (`ops/mlstm.py`) when the caller asked for the CPU.

Subpackages
-----------
- ops:     PoE/reparametrize and the KL terms, the plain mLSTM, the CUDA
           mLSTM wrappers and their autograd Function
- nn:      conv blocks, flax-style BatchNorm, ViL stack, skip-return gate,
           DuSE, the discriminator block, the init schemes
- models:  HVEDFusionNet (a shared recon decoder or one per modality), the
           Discriminator and the model-zoo factory; the other families:
           U-HeMIS, the UxLSTM nnU-Nets (2-D and 3-D, from nnU-Net plans),
           the Vision-LSTM classifiers and the ViL patch encoder
- losses, metrics: the training objective's terms, dice, IoU, PSNR, SSIM
- engine:  the adversarial train step, the pretrain step and freeze masks,
           the eval step, sliding-window inference, the 15-subset sweep,
           checkpoints and pretrained-weight surgery
- data:    NIfTI I/O, synthetic BraTS volumes, host and device augmentation,
           signed distance maps, the datasets and the prefetching loader
- cli:     the train, pretrain and check entry points
- utils:   subset table and samplers, JAX-tree weight conversion, CUDA build,
           CSV logs, `span` (the program's named ranges on the profiler's
           clock, and the CLIs' wall-clock tables) and the profiler scope
"""

__version__ = "0.1.0"
