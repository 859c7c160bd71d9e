"""The mLSTM cell in plain fp32 PyTorch, written from its equations.

    lf_t       = logsigmoid(f_t)
    logw(t, j) = sum_{u=j+1..t} lf_u + i_j            (j <= t)
    m_t        = max_j logw(t, j)
    C(t, j)    = exp(logw(t, j) - m_t) * (q_t . k_j) / sqrt(DH)
    h_t        = sum_j C(t, j) v_j / (max(|sum_j C(t, j)|, exp(-max(m_t, -60))) + 1e-6)

`mlstm_quadratic` is the S x S form, the test oracle; `mlstm_chunked` the
same sum in chunks of `chunk` tokens: the causal block of each chunk
directly, the tokens before it through a carried state (C, n) kept at
scale exp(m). Both take q, k, v (B, NH, S, DH) and igate, fgate (B, NH, S)
and return h (B, NH, S, DH) in fp32. Autograd differentiates them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6
# the normaliser's floor exp(-m) is taken at m >= -60, so that it stays finite
FLOOR_LOG = -60.0


def mlstm_quadratic(q, k, v, igate, fgate):
    S, DH = q.shape[-2:]
    q, k, v, igate, fgate = (t.float() for t in (q, k, v, igate, fgate))
    cum = torch.cumsum(F.logsigmoid(fgate), dim=-1)
    logw = cum[..., :, None] - cum[..., None, :] + igate[..., None, :]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    logw = logw.masked_fill(~causal, float("-inf"))
    m = logw.amax(dim=-1, keepdim=True)
    c = (q @ k.transpose(-1, -2)) / math.sqrt(DH) * torch.exp(logw - m)
    rowsum = c.sum(dim=-1, keepdim=True)
    denom = torch.maximum(rowsum.abs(), torch.exp(-torch.clamp(m, min=FLOOR_LOG))) + EPS
    return (c / denom) @ v


def mlstm_chunked(q, k, v, igate, fgate, chunk: int = 128):
    B, NH, S, DH = q.shape
    q, k, v, igate, fgate = (t.float().reshape(B * NH, S, -1) if t.dim() == 4
                             else t.float().reshape(B * NH, S)
                             for t in (q, k, v, igate, fgate))
    scale = 1.0 / math.sqrt(DH)
    lf = F.logsigmoid(fgate)
    c_state = q.new_zeros(B * NH, DH, DH)
    n_state = q.new_zeros(B * NH, DH)
    m_state = q.new_full((B * NH,), float("-inf"))
    out = []
    for start in range(0, S, chunk):
        sl = slice(start, min(start + chunk, S))
        qc, kc, vc, ic = q[:, sl] * scale, k[:, sl], v[:, sl], igate[:, sl]
        L = qc.shape[1]
        a = torch.cumsum(lf[:, sl], dim=-1)          # log decay from the chunk's start
        key = ic - a                                 # a key's own log weight, less a
        best = torch.maximum(torch.cummax(key, dim=-1).values, m_state[:, None])
        m = a + best                                 # m_t
        causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        logw = (key[:, None, :] - best[:, :, None]).masked_fill(~causal, float("-inf"))
        w = (qc @ kc.transpose(1, 2)) * torch.exp(logw)
        carry = torch.exp(m_state[:, None] - best)[..., None]
        num = w @ vc + carry * (qc @ c_state)
        rowsum = w.sum(-1, keepdim=True) + carry * (qc @ n_state[..., None])
        floor = torch.exp(-torch.clamp(m, min=FLOOR_LOG))[..., None]
        out.append(num / (torch.maximum(rowsum.abs(), floor) + EPS))
        # carry the chunk's keys into the state, at the scale of its last row
        top = best[:, -1]
        kw = kc * torch.exp(key - top[:, None])[..., None]
        decay = torch.exp(m_state - top)
        c_state = decay[:, None, None] * c_state + kw.transpose(1, 2) @ vc
        n_state = decay[:, None] * n_state + kw.sum(dim=1)
        m_state = a[:, -1] + top
    return torch.cat(out, dim=1).reshape(B, NH, S, DH)
