"""The chunkwise mLSTM forward on the card: wrapper, gate prep and plain twin.

`mlstm_forward` launches the hand-written CUDA kernel `csrc/mlstm_fwd.cu`,
the port of the Pallas TPU kernel `xlstm_hved_tpu/ops/mlstm_pallas.py::
_mlstm_kernel`. As on the TPU, the exact fp32 gate transforms stay tensor
ops around the launch (`prepare`): padding to a chunk multiple, the
per-chunk cumsum of logsigmoid(f), s = i - a and the chunk-local cummax.

`mlstm_forward_reference` is the kernel's plain PyTorch twin: it takes the
same prepared tensors and walks the chunks the way the kernel does, from
m* = -1e30. The tests hold it against the JAX Pallas kernel, and
`chip_smoke.py` holds the kernel against it on the card.

The wrapper runs on CUDA tensors only and never falls back: CPU tensors,
tensors that require grad (the backward kernel comes with training) and
head widths the kernel was not built for raise. `MatrixLSTMCell` picks the
plain scan in `ops/mlstm.py` when the caller asked for the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from xlstm_hved_torch.ops.mlstm import MLSTM_EPS, chunk_gates, pad_to_chunks, scan_chunks
from xlstm_hved_torch.utils import cuda_build

SOURCE = "mlstm_fwd"
SUPPORTED_DH = (8, 16)
MAX_CHUNK = 128

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = cuda_build.load(SOURCE)
        ptr = ctypes.c_void_p
        lib.mlstm_fwd_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ptr]
        lib.mlstm_fwd_launch.restype = ctypes.c_int
        lib.mlstm_fwd_error_string.argtypes = [ctypes.c_int]
        lib.mlstm_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def prepare(q, k, v, igate, fgate, chunk_size: int = 128):
    """Pad and precompute the fp32 gate transforms.

    q, k, v: (B, NH, S, DH); igate, fgate: (B, NH, S). Returns q, k, v as
    contiguous fp32 (B*NH, Sp, DH) and a, s, cm as contiguous fp32
    (B*NH, Sp // L, L), with L = min(chunk_size, S) and Sp a multiple of L.
    """
    B, NH, S, DH = q.shape
    qp, kp, vp, ip, fp, L = pad_to_chunks(q, k, v, igate, fgate, chunk_size)
    Sp = qp.shape[2]
    flat = [t.reshape(B * NH, Sp, DH).to(torch.float32).contiguous()
            for t in (qp, kp, vp)]
    gates = [t.contiguous() for t in chunk_gates(ip, fp, L)]
    return (*flat, *gates)


def mlstm_forward_reference(q, k, v, a, s, cm, eps: float = MLSTM_EPS):
    """Plain PyTorch twin of the kernel on `prepare`d inputs.
    Returns (B*NH, Sp, DH) fp32."""
    BH, _, DH = q.shape
    state = (q.new_zeros((BH, DH, DH)), q.new_zeros((BH, DH)),
             q.new_full((BH,), -1e30))
    return scan_chunks(q, k, v, a, s, cm, state, eps)[1]


def _check(q, k, v, igate, fgate, chunk_size):
    tensors = (q, k, v, igate, fgate)
    if any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "mlstm_forward has no backward kernel yet; call it under "
            "torch.no_grad() or torch.inference_mode()")
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a (B, NH, S, DH) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if igate.shape != q.shape[:3] or fgate.shape != q.shape[:3]:
        raise ValueError(f"gates must be (B, NH, S) = {tuple(q.shape[:3])}; got "
                         f"{tuple(igate.shape)}, {tuple(fgate.shape)}")
    if not all(t.is_floating_point() for t in tensors):
        raise TypeError("mlstm_forward takes floating-point tensors")
    if q.shape[-1] not in SUPPORTED_DH:
        raise ValueError(f"head width {q.shape[-1]} not built; the kernel "
                         f"supports DH in {SUPPORTED_DH}")
    if not 0 < chunk_size <= MAX_CHUNK:
        raise ValueError(f"chunk_size must be in (0, {MAX_CHUNK}]; got {chunk_size}")
    devices = {t.device for t in tensors}
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(
            f"mlstm_forward runs on CUDA tensors on one device; got "
            f"{sorted(map(str, devices))} (the CPU path is ops.mlstm.mlstm_chunkwise)")


def run_kernel(q, k, v, a, s, cm, eps: float = MLSTM_EPS):
    """One launch of the CUDA kernel on `prepare`d CUDA tensors
    (q, k, v: (BH, Sp, DH); a, s, cm: (BH, Sp // L, L), all contiguous
    fp32). Returns (BH, Sp, DH) fp32. Adds one to `run_kernel.launches`."""
    BH, Sp, DH = q.shape
    L = a.shape[-1]
    for t, shape in ((k, q.shape), (v, q.shape), (s, a.shape), (cm, a.shape)):
        if t.shape != shape:
            raise ValueError(f"shape {tuple(t.shape)} where {tuple(shape)} was expected")
    tensors = (q, k, v, a, s, cm)
    if (a.shape[:2] != (BH, Sp // L) or Sp % L or DH not in SUPPORTED_DH
            or L > MAX_CHUNK):
        raise ValueError(f"unsupported prepared shapes q {tuple(q.shape)}, a {tuple(a.shape)}")
    if not all(t.device == q.device and t.device.type == "cuda" and t.is_contiguous()
               and t.dtype == torch.float32 for t in tensors):
        raise ValueError("run_kernel takes contiguous fp32 CUDA tensors on one device")
    out = torch.empty_like(q)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.mlstm_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(), s.data_ptr(),
        cm.data_ptr(), out.data_ptr(), BH, Sp, L, DH, eps, q.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"mlstm_fwd launch failed: "
                           f"{lib.mlstm_fwd_error_string(rc).decode()} (code {rc})")
    run_kernel.launches += 1
    return out


# Kernel launches since the count was last set to 0 (read by chip_smoke.py).
run_kernel.launches = 0


def mlstm_forward(q, k, v, igate, fgate, chunk_size: int = 128,
                  eps: float = MLSTM_EPS):
    """Chunkwise mLSTM forward through the CUDA kernel.

    q, k, v: (B, NH, S, DH) CUDA tensors, cast to fp32 as the kernel reads
    them; igate, fgate: (B, NH, S). Returns (B, NH, S, DH) fp32.
    """
    _check(q, k, v, igate, fgate, chunk_size)
    B, NH, S, DH = q.shape
    out = run_kernel(*prepare(q, k, v, igate, fgate, chunk_size), eps)
    return out.reshape(B, NH, -1, DH)[:, :, :S]
