"""mLSTM cell in plain fp32 PyTorch: the quadratic form and the chunkwise
scan (counterpart of `xlstm_hved_tpu/ops/mlstm.py`, whose docstring derives
the chunk decomposition).

    lf_t  = logsigmoid(fgate_t)
    logw(t, j) = sum_{u=j+1..t} lf_u + i_j          (j <= t)
    m_t   = max_{j<=t} logw(t, j)
    C(t, j) = exp(logw(t, j) - m_t) * (q_t . k_j) / sqrt(DH)
    h_t   = sum_j C(t, j) v_j / (max(|sum_j C(t, j)|, exp(-m_t)) + eps)

The chunkwise scan is what the model runs on the CPU (its gradient is
autograd through the scan, the JAX package's bwd_mode="scan" oracle) and
what the CUDA kernels (`ops/mlstm_cuda.py`) are held against. Three details are
load-bearing and kept from the reference:
- the causal mask is applied in log space, before the exp, so masked
  entries never overflow to +inf (a finite forward with a NaN backward);
- the normaliser exponent is clamped at -60, so exp(-m_t) cannot overflow
  under deep forgetting;
- padded positions get igate -1e30 and fgate +1e30, so they add nothing to
  the state and do not decay it.
All gate and stabiliser math is fp32, and the q/k/v products are full fp32
(no TF32): the max(|rowsum|, e^{-m}) normaliser amplifies truncated products
to O(1) output error.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MLSTM_EPS = 1e-6


def mlstm_quadratic(q, k, v, igate, fgate, eps: float = MLSTM_EPS):
    """O(S^2) form. q, k, v: (B, NH, S, DH); igate, fgate: (B, NH, S).
    Returns (B, NH, S, DH) fp32."""
    S, DH = q.shape[-2:]
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    csum = torch.cumsum(F.logsigmoid(fgate.to(f32)), dim=-1)
    logw = csum[..., :, None] - csum[..., None, :] + igate.to(f32)[..., None, :]
    ltr = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logw = logw.masked_fill(~ltr, float("-inf"))
    max_log = logw.amax(dim=-1, keepdim=True)
    d_mat = torch.exp(logw - max_log)
    qk = q @ (k / math.sqrt(DH)).transpose(-1, -2)
    c_mat = qk * d_mat
    rowsum = c_mat.sum(dim=-1, keepdim=True)
    normalizer = torch.maximum(rowsum.abs(), torch.exp(-max_log)) + eps
    return (c_mat / normalizer) @ v


def pad_to_chunks(q, k, v, igate, fgate, chunk_size: int):
    """Pad S up to a multiple of L = min(chunk_size, S). Padded keys add
    nothing (igate -1e30) and padded forget gates do not decay (+1e30).
    Returns the padded tensors and L."""
    S = q.shape[2]
    L = min(chunk_size, S)
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        igate = F.pad(igate, (0, pad), value=-1e30)
        fgate = F.pad(fgate, (0, pad), value=1e30)
    return q, k, v, igate, fgate, L


def chunk_gates(igate, fgate, L: int):
    """The exact fp32 gate transforms of the chunked scan, for padded
    (B, NH, Sp) gates: per-chunk inclusive log-forget cumsum a, s = i - a,
    and the chunk-local cummax of s. Each is (B*NH, Sp // L, L)."""
    BH = igate.shape[0] * igate.shape[1]
    dt = torch.promote_types(igate.dtype, torch.float32)
    lf = F.logsigmoid(fgate.to(dt)).reshape(BH, -1, L)
    a = torch.cumsum(lf, dim=-1)
    s = igate.to(dt).reshape(BH, -1, L) - a
    cm = torch.cummax(s, dim=-1).values
    return a, s, cm


def _chunk_step(state, q, k, v, a, s, cm, eps: float):
    """One chunk, batched over heads. q, k, v: (BH, L, DH); a, s, cm:
    (BH, L); state (C (BH, DH, DH), n (BH, DH), m (BH,))."""
    c_state, n_state, m_state = state
    L, DH = q.shape[1:]
    scale = 1.0 / math.sqrt(DH)

    m_local = torch.maximum(cm, m_state[:, None])            # M_t
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    delta = (s[:, None, :] - m_local[:, :, None]).masked_fill(~causal, float("-inf"))
    qs = q * scale
    attn = (qs @ k.transpose(1, 2)) * torch.exp(delta)

    inter_w = torch.exp(m_state[:, None] - m_local)[..., None]
    num = attn @ v + inter_w * (qs @ c_state)
    rowsum = attn.sum(-1, keepdim=True) + inter_w * (qs @ n_state[..., None])
    max_log = (a + m_local)[..., None]                       # m_t
    denom = torch.maximum(rowsum.abs(),
                          torch.exp(-torch.clamp(max_log, min=-60.0))) + eps
    h = num / denom

    m_new = torch.maximum(m_state, cm[:, -1])                # max(m*, max s)
    kv_w = torch.exp(s - m_new[:, None])[..., None]
    decay_old = torch.exp(m_state - m_new)
    c_state = decay_old[:, None, None] * c_state + (k * kv_w).transpose(1, 2) @ v
    n_state = decay_old[:, None] * n_state + (k * kv_w).sum(dim=1)
    m_state = a[:, -1] + m_new
    return (c_state, n_state, m_state), h


def scan_chunks(q, k, v, a, s, cm, state, eps: float = MLSTM_EPS):
    """Walk the chunks in order. q, k, v: (BH, Sp, DH) fp32; a, s, cm:
    (BH, nchunks, L) from `chunk_gates`; state is the entry (C, n, m).
    Returns (final state, h (BH, Sp, DH))."""
    L = a.shape[-1]
    hs = []
    for c in range(a.shape[1]):
        sl = slice(c * L, (c + 1) * L)
        state, h = _chunk_step(state, q[:, sl], k[:, sl], v[:, sl],
                               a[:, c], s[:, c], cm[:, c], eps)
        hs.append(h)
    return state, torch.cat(hs, dim=1)


def mlstm_chunkwise(q, k, v, igate, fgate, chunk_size: int = 128,
                    eps: float = MLSTM_EPS, init_state=None, return_state: bool = False):
    """Linear-in-S chunkwise mLSTM, equal to `mlstm_quadratic` up to fp
    association. q, k, v: (B, NH, S, DH); igate, fgate: (B, NH, S).
    `init_state` is an optional boundary state (C, n, m) of shapes
    (B, NH, DH, DH), (B, NH, DH), (B, NH), e.g. carried in from the preceding
    sequence shard (`parallel/seq.py`); the zero state (m = -inf) otherwise.
    Returns (B, NH, S, DH) in fp32 (fp64 for fp64 inputs), and with
    `return_state` the final (C, n, m) as well."""
    B, NH, S, DH = q.shape
    f32 = torch.promote_types(q.dtype, torch.float32)
    qp, kp, vp, ip, fp, L = pad_to_chunks(q, k, v, igate, fgate, chunk_size)
    Sp = qp.shape[2]
    BH = B * NH
    qf, kf, vf = (t.reshape(BH, Sp, DH).to(f32) for t in (qp, kp, vp))
    a, s, cm = chunk_gates(ip, fp, L)
    if init_state is None:
        state = (q.new_zeros((BH, DH, DH), dtype=f32),
                 q.new_zeros((BH, DH), dtype=f32),
                 q.new_full((BH,), float("-inf"), dtype=f32))
    else:
        c0, n0, m0 = init_state
        state = (c0.reshape(BH, DH, DH).to(f32), n0.reshape(BH, DH).to(f32),
                 m0.reshape(BH).to(f32))
    final, h = scan_chunks(qf, kf, vf, a, s, cm, state, eps)
    h = h.reshape(B, NH, Sp, DH)[:, :, :S]
    if not return_state:
        return h
    c_f, n_f, m_f = final
    return h, (c_f.reshape(B, NH, DH, DH), n_f.reshape(B, NH, DH), m_f.reshape(B, NH))
