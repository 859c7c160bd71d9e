"""The chunkwise mLSTM on the card: forward, states-saving forward and
reverse-chunk backward kernels, their plain twins, and the autograd Function.

Three hand-written CUDA kernels port the Pallas TPU kernels of
`xlstm_hved_tpu/ops/mlstm_pallas.py`:

- `run_kernel` launches `mlstm_fwd` (`csrc/mlstm_fwd.cu`), the port of
  `_mlstm_kernel`: the readout h;
- `run_states_kernel` launches `mlstm_fwd_states` (same source), the port of
  `_mlstm_states_kernel`: h plus each chunk's entry state (C*, n*, m*);
- `run_bwd_kernel` launches `mlstm_bwd` (`csrc/mlstm_bwd.cu`), the port of
  `_mlstm_bwd_kernel`: the reverse-chunk adjoint with frozen stabilisers.

As on the TPU, the exact fp32 gate transforms stay tensor ops around the
launches: `prepare` (padding to a chunk multiple, the per-chunk cumsum of
logsigmoid(f), s = i - a, the chunk-local cummax) and `gate_grads` (the
dA -> d-fgate epilogue). The entry offsets m* come out of the states kernel,
which forms them with the same fp32 operations as the JAX `_m_entry_chain`.

Each kernel has a plain PyTorch twin on the same prepared tensors
(`mlstm_forward_reference`, `mlstm_forward_states_reference`,
`mlstm_backward_reference`); the tests hold the twins against the JAX
Pallas kernels and `chip_smoke.py` holds the kernels against the twins.

`mlstm_forward` is the differentiable entry point: `MLSTMFunction` mirrors
the `mlstm_pallas` custom VJP (forward: one `mlstm_fwd` launch, saving only
the raw inputs; backward: one states launch and one backward launch).
`bwd_mode="scan"` instead recomputes through `ops.mlstm.mlstm_chunkwise` and
its autograd, an oracle chosen only by the caller. The wrappers run on CUDA
tensors and never fall back: CPU tensors, head widths the kernels were not
built for and a failed build or launch raise. Only `mlstm_backward`, which
the Function calls, takes the twins when its tensors lie on the CPU, so the
CPU tests reach the same padding and epilogue code.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from xlstm_hved_torch.ops.mlstm import (MLSTM_EPS, _chunk_step, chunk_gates,
                                        mlstm_chunkwise, pad_to_chunks)
from xlstm_hved_torch.utils import cuda_build

SOURCES = ("mlstm_fwd", "mlstm_bwd")
SUPPORTED_DH = (8, 16)
MAX_CHUNK = 128
BWD_MODES = ("fused", "scan")

_launchers = {}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # function: (source, number of tensor pointers)
    "mlstm_fwd_launch": ("mlstm_fwd", 7),
    "mlstm_fwd_states_launch": ("mlstm_fwd", 10),
    "mlstm_bwd_launch": ("mlstm_bwd", 15),
}


def _launcher(fn_name: str):
    """The ctypes function `fn_name` and its library's error-string getter,
    declared once (the library builds on first use)."""
    if fn_name not in _launchers:
        source, n_ptr = _SIGNATURES[fn_name]
        lib = cuda_build.load(source)
        fn = getattr(lib, fn_name)
        fn.argtypes = [_PTR] * n_ptr + [_INT, _INT, _INT, _INT, _FLOAT, _INT, _PTR]
        fn.restype = _INT
        error_string = getattr(lib, f"{source}_error_string")
        error_string.argtypes = [_INT]
        error_string.restype = ctypes.c_char_p
        _launchers[fn_name] = fn, error_string
    return _launchers[fn_name]


def _launch(fn_name: str, tensors, BH: int, Sp: int, L: int, DH: int, eps: float):
    fn, error_string = _launcher(fn_name)
    dev = tensors[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*(t.data_ptr() for t in tensors), BH, Sp, L, DH, eps, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {error_string(rc).decode()} (code {rc})")


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


# ---------------------------------------------------------------- plain twins

def _entry_state(q):
    BH, _, DH = q.shape
    return (q.new_zeros((BH, DH, DH)), q.new_zeros((BH, DH)), q.new_full((BH,), -1e30))


def mlstm_forward_reference(q, k, v, a, s, cm, eps: float = MLSTM_EPS):
    """Plain twin of `mlstm_fwd` on `prepare`d inputs: walk the chunks from
    m* = -1e30. Returns h (B*NH, Sp, DH) fp32."""
    return mlstm_forward_states_reference(q, k, v, a, s, cm, eps)[0]


def mlstm_forward_states_reference(q, k, v, a, s, cm, eps: float = MLSTM_EPS):
    """Plain twin of `mlstm_fwd_states`: h and, for each chunk, the state it
    starts from. Returns h (BH, Sp, DH), cent (BH, nchunks, DH, DH),
    nent (BH, nchunks, DH) and ment (BH, nchunks), all fp32."""
    L = a.shape[-1]
    state = _entry_state(q)
    hs, entries = [], []
    for c in range(a.shape[1]):
        entries.append(state)
        sl = slice(c * L, (c + 1) * L)
        state, h = _chunk_step(state, q[:, sl], k[:, sl], v[:, sl],
                               a[:, c], s[:, c], cm[:, c], eps)
        hs.append(h)
    cent, nent, ment = (torch.stack(t, dim=1) for t in zip(*entries))
    return torch.cat(hs, dim=1), cent, nent, ment


def mlstm_backward_reference(q, k, v, g, a, s, cm, cent, nent, ment,
                             eps: float = MLSTM_EPS):
    """Plain twin of `mlstm_bwd`: a step-by-step mirror of the Pallas
    `_mlstm_bwd_kernel`, batched over heads, walking the chunks in reverse
    and carrying the adjoints (dC, dn, dm) of the chunk-entry state. Every
    max-based stabiliser is held constant (exact; see the JAX module
    docstring). q, k, v, g: (BH, Sp, DH); a, s, cm: (BH, nchunks, L); the
    entry states from the states kernel. Returns dq, dk, dv (BH, Sp, DH) and
    ds, dax (BH, nchunks, L), all fp32."""
    BH, Sp, DH = q.shape
    nchunks, L = a.shape[1:]
    scale = 1.0 / math.sqrt(DH)
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    dc = q.new_zeros((BH, DH, DH))
    dn = q.new_zeros((BH, DH))
    dm = q.new_zeros((BH,))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    ds, dax = torch.empty_like(a), torch.empty_like(a)
    tr = lambda t: t.transpose(1, 2)
    for c in reversed(range(nchunks)):
        sl = slice(c * L, (c + 1) * L)
        qs, kc, vc, gc = q[:, sl] * scale, k[:, sl], v[:, sl], g[:, sl]
        ac, sc, cmc = a[:, c], s[:, c], cm[:, c]
        c_in, n_in, m_in = cent[:, c], nent[:, c], ment[:, c]

        # ---- recompute the forward readout quantities
        m_col = torch.maximum(cmc, m_in[:, None])                 # (BH, L)
        dec = torch.exp((sc[:, None, :] - m_col[:, :, None]).masked_fill(~causal, float("-inf")))
        attn = (qs @ tr(kc)) * dec                                # (BH, L, L)
        inter = torch.exp(m_in[:, None] - m_col)                  # (BH, L)
        q_c = qs @ c_in                                           # (BH, L, DH)
        q_n = (qs @ n_in[..., None])[..., 0]                      # (BH, L)
        num = attn @ vc + inter[..., None] * q_c
        rowsum = attn.sum(-1) + inter * q_n
        e_neg = torch.exp(-torch.clamp(ac + m_col, min=-60.0))
        denom = torch.maximum(rowsum.abs(), e_neg) + eps
        act = rowsum.abs() >= e_neg

        # ---- readout backward
        g_over = gc / denom[..., None]
        ddenom = -(gc * num).sum(-1) / (denom * denom)
        drow = torch.where(act, torch.sign(rowsum) * ddenom, torch.zeros_like(ddenom))
        dax_c = torch.where(act, torch.zeros_like(ddenom), -e_neg * ddenom)
        dax_c[:, -1] += dm
        dattn = g_over @ tr(vc) + drow[..., None]
        dqk = dattn * dec
        dqs = dqk @ kc + inter[..., None] * (g_over @ tr(c_in) + drow[..., None] * n_in[:, None])
        dk_i = tr(dqk) @ qs
        dv_i = tr(attn) @ g_over
        dinter = (q_c * g_over).sum(-1) + drow * q_n
        dm_read = (dinter * inter).sum(-1)
        dc_read = tr(qs * inter[..., None]) @ g_over
        dn_read = ((inter * drow)[..., None] * qs).sum(1)
        ds_intra = (dattn * attn).sum(1)

        # ---- state-update backward
        m_new = torch.maximum(m_in, cmc[:, -1])
        w = torch.exp(sc - m_new[:, None])                        # (BH, L)
        e_dec = torch.exp(m_in - m_new)
        vdc = vc @ tr(dc)
        dk_s = w[..., None] * (vdc + dn[:, None])
        dv_s = w[..., None] * (kc @ dc)
        ds_state = w * ((kc * vdc).sum(-1) + (kc @ dn[..., None])[..., 0])
        dm_dec = e_dec * ((dc * c_in).sum((1, 2)) + (dn * n_in).sum(-1))

        dq[:, sl] = scale * dqs
        dk[:, sl] = dk_i + dk_s
        dv[:, sl] = dv_i + dv_s
        ds[:, c] = ds_intra + ds_state
        dax[:, c] = dax_c
        dc = e_dec[:, None, None] * dc + dc_read
        dn = e_dec[:, None] * dn + dn_read
        dm = dm_dec + dm_read
    return dq, dk, dv, ds, dax


# ---------------------------------------------------------------- launchers

def _check_prepared(name, q, a, tensors):
    BH, Sp, DH = q.shape
    L = a.shape[-1]
    if (a.shape[:2] != (BH, Sp // L) or Sp % L or DH not in SUPPORTED_DH
            or L > MAX_CHUNK):
        raise ValueError(f"{name}: unsupported prepared shapes q {tuple(q.shape)}, "
                         f"a {tuple(a.shape)}")
    if not all(t.device == q.device and t.device.type == "cuda" and t.is_contiguous()
               and t.dtype == torch.float32 for t in tensors):
        raise ValueError(f"{name} takes contiguous fp32 CUDA tensors on one device")
    return BH, Sp, DH, L


def _check_shapes(pairs):
    for t, shape in pairs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"shape {tuple(t.shape)} where {tuple(shape)} was expected")


def run_kernel(q, k, v, a, s, cm, eps: float = MLSTM_EPS):
    """One launch of `mlstm_fwd` on `prepare`d CUDA tensors
    (q, k, v: (BH, Sp, DH); a, s, cm: (BH, Sp // L, L), all contiguous
    fp32). Returns (BH, Sp, DH) fp32. Adds one to `run_kernel.launches`."""
    _check_shapes(((k, q.shape), (v, q.shape), (s, a.shape), (cm, a.shape)))
    BH, Sp, DH, L = _check_prepared("mlstm_fwd", q, a, (q, k, v, a, s, cm))
    out = torch.empty_like(q)
    _launch("mlstm_fwd_launch", (q, k, v, a, s, cm, out), BH, Sp, L, DH, eps)
    run_kernel.launches += 1
    return out


def run_states_kernel(q, k, v, a, s, cm, eps: float = MLSTM_EPS):
    """One launch of `mlstm_fwd_states`: as `run_kernel`, and also each
    chunk's entry state. Returns h (BH, Sp, DH), cent (BH, nchunks, DH, DH),
    nent (BH, nchunks, DH), ment (BH, nchunks). Adds one to
    `run_states_kernel.launches`."""
    _check_shapes(((k, q.shape), (v, q.shape), (s, a.shape), (cm, a.shape)))
    BH, Sp, DH, L = _check_prepared("mlstm_fwd_states", q, a, (q, k, v, a, s, cm))
    nchunks = Sp // L
    out = torch.empty_like(q)
    cent = q.new_empty((BH, nchunks, DH, DH))
    nent = q.new_empty((BH, nchunks, DH))
    ment = q.new_empty((BH, nchunks))
    _launch("mlstm_fwd_states_launch", (q, k, v, a, s, cm, out, cent, nent, ment),
            BH, Sp, L, DH, eps)
    run_states_kernel.launches += 1
    return out, cent, nent, ment


def run_bwd_kernel(q, k, v, g, a, s, cm, cent, nent, ment, eps: float = MLSTM_EPS):
    """One launch of `mlstm_bwd` on prepared CUDA tensors and the states
    kernel's entry states. Returns dq, dk, dv (BH, Sp, DH) and ds, dax
    (BH, nchunks, L). Adds one to `run_bwd_kernel.launches`."""
    BH, Sp, DH = q.shape
    nchunks = a.shape[1]
    _check_shapes(((k, q.shape), (v, q.shape), (g, q.shape), (s, a.shape),
                   (cm, a.shape), (cent, (BH, nchunks, DH, DH)),
                   (nent, (BH, nchunks, DH)), (ment, (BH, nchunks))))
    _, _, _, L = _check_prepared("mlstm_bwd", q, a,
                                 (q, k, v, g, a, s, cm, cent, nent, ment))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    ds, dax = torch.empty_like(a), torch.empty_like(a)
    _launch("mlstm_bwd_launch", (q, k, v, g, a, s, cm, cent, nent, ment,
                                 dq, dk, dv, ds, dax), BH, Sp, L, DH, eps)
    run_bwd_kernel.launches += 1
    return dq, dk, dv, ds, dax


# Kernel launches since each count was last set to 0 (read by chip_smoke.py).
run_kernel.launches = 0
run_states_kernel.launches = 0
run_bwd_kernel.launches = 0


# ---------------------------------------------------------------- autograd

def gate_grads(ds, dax, fgate, S: int):
    """The gate epilogue of the fused backward: di = ds; dA = dax - ds
    (s_p = i_p - A_p); A is the per-chunk cumsum of logsigmoid(f), so
    d logsigmoid(f) is the per-chunk reversed inclusive cumsum of dA, and
    d f = that * sigmoid(-f). ds, dax: (BH, nchunks, L); fgate: the raw
    (B, NH, S) gate. Returns di, df as fp32 (B, NH, S)."""
    B, NH = fgate.shape[:2]
    L = ds.shape[-1]
    d_a = dax - ds
    dlf = d_a.flip(-1).cumsum(-1).flip(-1)
    fpad = F.pad(fgate.to(torch.float32), (0, (-S) % L), value=1e30)
    dfg = dlf * torch.sigmoid(-fpad.reshape(dlf.shape))
    return (ds.reshape(B, NH, -1)[:, :, :S], dfg.reshape(B, NH, -1)[:, :, :S])


def mlstm_backward(q, k, v, igate, fgate, g, chunk_size: int = 128,
                   eps: float = MLSTM_EPS):
    """The fused mLSTM backward on raw inputs and the cotangent g of h:
    prepare, the states kernel, the backward kernel, the gate epilogue,
    then unpad and cast to the input dtypes. CUDA tensors launch the
    kernels; CPU tensors take their plain twins. Returns the gradients of
    q, k, v, igate, fgate."""
    B, NH, S, DH = q.shape
    prepared = prepare(q, k, v, igate, fgate, chunk_size)
    qf, kf, vf, a, s, cm = prepared
    Sp = qf.shape[1]
    gf = F.pad(g.to(torch.float32), (0, 0, 0, Sp - S)).reshape(B * NH, Sp, DH).contiguous()
    if q.device.type == "cuda":
        _, cent, nent, ment = run_states_kernel(*prepared, eps)
        grads = run_bwd_kernel(qf, kf, vf, gf, a, s, cm, cent, nent, ment, eps)
    else:
        _, cent, nent, ment = mlstm_forward_states_reference(*prepared, eps)
        grads = mlstm_backward_reference(qf, kf, vf, gf, a, s, cm, cent, nent, ment, eps)
    dq, dk, dv, ds, dax = grads
    di, df = gate_grads(ds, dax, fgate, S)
    unpad = lambda t: t.reshape(B, NH, Sp, DH)[:, :, :S]
    return (unpad(dq).to(q.dtype), unpad(dk).to(k.dtype), unpad(dv).to(v.dtype),
            di.to(igate.dtype), df.to(fgate.dtype))


class MLSTMFunction(torch.autograd.Function):
    """The `mlstm_pallas` custom VJP on the card: the forward saves only the
    raw inputs; the backward recomputes what it needs (`mlstm_backward`, or
    autograd through `mlstm_chunkwise` when bwd_mode is "scan")."""

    @staticmethod
    def forward(ctx, q, k, v, igate, fgate, chunk_size, eps, bwd_mode):
        ctx.save_for_backward(q, k, v, igate, fgate)
        ctx.chunk_size, ctx.eps, ctx.bwd_mode = chunk_size, eps, bwd_mode
        B, NH, S, DH = q.shape
        out = run_kernel(*prepare(q, k, v, igate, fgate, chunk_size), eps)
        return out.reshape(B, NH, -1, DH)[:, :, :S]

    @staticmethod
    def backward(ctx, g):
        inputs = ctx.saved_tensors
        if ctx.bwd_mode == "fused":
            grads = mlstm_backward(*inputs, g, ctx.chunk_size, ctx.eps)
        else:
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(True) for t in inputs]
                out = mlstm_chunkwise(*leaves, chunk_size=ctx.chunk_size, eps=ctx.eps)
                grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None)


def _check(q, k, v, igate, fgate, chunk_size, bwd_mode):
    tensors = (q, k, v, igate, fgate)
    if bwd_mode not in BWD_MODES:
        raise ValueError(f"bwd_mode must be one of {BWD_MODES}; got {bwd_mode!r}")
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


def mlstm_forward(q, k, v, igate, fgate, chunk_size: int = 128,
                  eps: float = MLSTM_EPS, bwd_mode: str = "fused"):
    """Chunkwise mLSTM through the CUDA kernels, differentiable.

    q, k, v: (B, NH, S, DH) CUDA tensors, cast to fp32 as the kernel reads
    them; igate, fgate: (B, NH, S). Returns (B, NH, S, DH) fp32. The
    gradient runs the states and backward kernels ("fused") or autograd
    through the plain scan ("scan").
    """
    _check(q, k, v, igate, fgate, chunk_size, bwd_mode)
    return MLSTMFunction.apply(q, k, v, igate, fgate, chunk_size, eps, bwd_mode)
