"""Sequence-parallel mLSTM over the mesh's seq axis (counterpart of
`xlstm_hved_tpu/parallel/seq.py`).

The mLSTM carry is associative, so the token axis shards exactly: each rank
summarises its segment as (C, n, m, F), takes the exclusive prefix of its
predecessors' summaries, and runs its own chunkwise scan from that boundary
state.

Summary of a segment, relative to its end:
    w_j = i_j + sum_{u>j} lf_u,   m = max_j w_j,
    C = sum_j e^{w_j - m} k_j v_j^T,   n = sum_j e^{w_j - m} k_j,
    F = sum_u lf_u  (the total log-forget, which shifts earlier states).
Combine (A before B):
    m_AB = max(m_A + F_B, m_B)
    C_AB = e^{m_A + F_B - m_AB} C_A + e^{m_B - m_AB} C_B   (n likewise)
    F_AB = F_A + F_B

The JAX package passes the summaries around a ring (ppermute); here one
all-gather brings every rank's summary, and the prefix is combined in the
ring's order: the predecessors prepended one by one, nearest first. The
scan is the plain chunkwise one, as JAX's is. Gradients flow back through
the gathers, each rank's summing every rank's upstream gradient (the
convention of `parallel.mesh.global_sums`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from xlstm_hved_torch.ops.mlstm import MLSTM_EPS, mlstm_chunkwise
from xlstm_hved_torch.parallel.mesh import Mesh, active_mesh, all_gather

Summary = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def segment_summary(k: torch.Tensor, v: torch.Tensor, igate: torch.Tensor,
                    fgate: torch.Tensor) -> Summary:
    """(C, n, m, F) of a whole segment. k, v: (B, NH, S, DH); igate, fgate:
    (B, NH, S). fp32 (fp64 for fp64 inputs)."""
    f32 = torch.promote_types(k.dtype, torch.float32)
    k, v = k.to(f32), v.to(f32)
    a = torch.cumsum(F.logsigmoid(fgate.to(f32)), dim=-1)      # inclusive
    total = a[..., -1]
    w = igate.to(f32) + (total[..., None] - a)                 # i_j + sum_{u>j} lf_u
    m = w.amax(dim=-1)
    wt = torch.exp(w - m[..., None])
    C = torch.einsum("bhs,bhsk,bhsv->bhkv", wt, k, v)
    n = torch.einsum("bhs,bhsk->bhk", wt, k)
    return C, n, m, total


def combine_summaries(A: Summary, B: Summary) -> Summary:
    """The summary of segment A followed by segment B."""
    C_a, n_a, m_a, F_a = A
    C_b, n_b, m_b, F_b = B
    m_ab = torch.maximum(m_a + F_b, m_b)
    s_a = torch.exp(m_a + F_b - m_ab)
    s_b = torch.exp(m_b - m_ab)
    C = s_a[..., None, None] * C_a + s_b[..., None, None] * C_b
    n = s_a[..., None] * n_a + s_b[..., None] * n_b
    return C, n, m_ab, F_a + F_b


def identity_summary(B: int, NH: int, DH: int, device=None,
                     dtype: torch.dtype = torch.float32) -> Summary:
    """The summary of an empty segment."""
    return (torch.zeros((B, NH, DH, DH), dtype=dtype, device=device),
            torch.zeros((B, NH, DH), dtype=dtype, device=device),
            torch.full((B, NH), float("-inf"), dtype=dtype, device=device),
            torch.zeros((B, NH), dtype=dtype, device=device))


def _pack(summary: Summary) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in summary])


def _unpack(flat: torch.Tensor, like: Summary) -> Summary:
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return tuple(out)


def mlstm_sequence_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            igate: torch.Tensor, fgate: torch.Tensor,
                            mesh: Optional[Mesh] = None, chunk_size: int = 128,
                            eps: float = MLSTM_EPS) -> torch.Tensor:
    """This rank's h for its segment of the token axis, the segments in
    seq-rank order over `mesh` (default: the active mesh). Inputs are the
    local segment, (B, NH, S_local, DH) and (B, NH, S_local)."""
    mesh = mesh or active_mesh()
    B, NH, _, DH = q.shape
    local = segment_summary(k, v, igate, fgate)
    acc = identity_summary(B, NH, DH, device=q.device, dtype=local[0].dtype)
    if mesh is not None and mesh.seq > 1:
        gathered = all_gather(_pack(local), mesh.seq_group)
        # JAX's ring: step t brings the summary of segment i - 1 - t, which
        # is prepended while t < i. Every step is taken through a select, so
        # every rank's graph holds the gather and every rank joins its
        # backward's all-reduce.
        for t in range(mesh.seq - 1):
            j = (mesh.seq_rank - 1 - t) % mesh.seq
            new = combine_summaries(_unpack(gathered[j], local), acc)
            take = torch.tensor(t < mesh.seq_rank, device=q.device)
            acc = tuple(torch.where(take, a, b) for a, b in zip(new, acc))
    C0, n0, m0, _ = acc
    return mlstm_chunkwise(q, k, v, igate, fgate, chunk_size=chunk_size, eps=eps,
                           init_state=(C0, n0, m0))


def make_sharded_mlstm(mesh: Mesh, chunk_size: int = 128):
    """fn(q, k, v, igate, fgate) on the global (B, NH, S, DH) inputs, the
    same on every rank: each rank runs its S / seq tokens through
    `mlstm_sequence_parallel` and the segments are gathered back into the
    global h, as JAX's shard_map with the token axis over 'seq' returns it."""

    def fn(q, k, v, igate, fgate):
        S = q.shape[2]
        if S % mesh.seq:
            raise ValueError(f"S {S} does not split over {mesh.seq} seq ranks")
        s = S // mesh.seq
        part = slice(mesh.seq_rank * s, (mesh.seq_rank + 1) * s)
        h = mlstm_sequence_parallel(q[:, :, part], k[:, :, part], v[:, :, part],
                                    igate[:, :, part], fgate[:, :, part], mesh=mesh,
                                    chunk_size=chunk_size)
        if mesh.seq == 1:
            return h
        return torch.cat(all_gather(h, mesh.seq_group).unbind(0), dim=2)

    return fn
