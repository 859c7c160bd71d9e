"""The chunkwise mLSTM on the card: forward, states-saving forward and
reverse-chunk backward kernels, their plain twins, and the autograd Function.

Three hand-written CUDA kernels port the Pallas TPU kernels of
`xlstm_hved_tpu/ops/mlstm_pallas.py`:

- `run_kernel` runs `mlstm_fwd` (`csrc/mlstm_fwd.cu`), the port of
  `_mlstm_kernel`: the readout h;
- `run_states_kernel` runs `mlstm_fwd_states` (the same launches), the port
  of `_mlstm_states_kernel`: h, bitwise `run_kernel`'s, plus each chunk's
  entry state (C*, n*, m*);
- `run_bwd_kernel` runs `mlstm_bwd` (`csrc/mlstm_bwd.cu`), the port of
  `_mlstm_bwd_kernel`: the reverse-chunk adjoint with frozen stabilisers.

The Pallas kernels walk the chunks of a head in order (in reverse for the
backward). On the card only the chunk-to-chunk carry is sequential, so one
call of each wrapper is three CUDA launches (DH <= 16): per (head, chunk)
blocks for the work of each chunk, a scan over the chunks, one warp per 32
elements of a head's carry (C*, n* after the scalar m* chain forward; dC,
dn backward), then per (head, chunk) blocks again, which in the backward
also add the carried dm (`csrc/mlstm_narrow.cuh`: the rows walked in
groups of four by eight lanes, `narrow_plan`; the scan and the last launch
start as programmatic dependents). The wide path (DH > 16) runs the
forward in three launches as well (chunk states, scan, a fused readout per
row tile) and the
backward in seven (rows in two, the readout's state adjoints, scan,
columns per key tile, the last sums in two); `wide_plan` chooses its row
tiles and how many blocks share a tile's value columns. The wrappers
allocate every workspace; the kernels allocate nothing.

As on the TPU, the exact fp32 gate transforms stay tensor ops around the
launches: `prepare` (padding to a chunk multiple, the per-chunk cumsum of
logsigmoid(f), s = i - a, the chunk-local cummax) and `gate_grads` (the
dA -> d-fgate epilogue). The entry offsets m* come out of the forward's
scan, which forms them with the same fp32 operations as the JAX
`_m_entry_chain`.

Each kernel has a plain PyTorch twin on the same prepared tensors
(`mlstm_forward_reference`, `mlstm_forward_states_reference`,
`mlstm_backward_reference`), written in the kernel's three phases; the tests
hold the twins against the JAX Pallas kernels and `chip_smoke.py` holds the
kernels against the twins.

`mlstm_forward` is the differentiable entry point: `MLSTMFunction` mirrors
the `mlstm_pallas` custom VJP (forward: one `mlstm_fwd` call, saving only
the raw inputs; backward: one states call and one backward call).
`bwd_mode="scan"` instead recomputes through `ops.mlstm.mlstm_chunkwise` and
its autograd, an oracle chosen only by the caller. The wrappers run on CUDA
tensors and never fall back: CPU tensors, head widths past MAX_DH and a
failed build or launch raise. Only `mlstm_backward`, which the Function
calls, takes the twins when its tensors lie on the CPU, so the CPU tests
reach the same padding and epilogue code.

Head widths: every DH from 1 to MAX_DH. `prepare` zero-pads DH to
`padded_width(DH)`: 8 or 16 for the narrow kernels (the flagship's and the
ViL decoder's widths, a row's head in registers), else a multiple of 32 for
the wide path (`csrc/mlstm_wide.cuh`: products of register-tiled blocks,
the UxLSTM and Vision-LSTM ViLs' DH 32 to 384). Zero columns of q, k, v
and g are exact, so the kernels and the twins take the true width `dh` for
the scale 1/sqrt(DH), and the callers slice the padded columns off.

Sequence lengths: `prepare` pads S to whole chunks. The wrappers take the
true length as `seq_len` (default: all the prepared rows are true); the
wide path then skips the last chunk's padded rows and writes them as
zeros, which is what the twins give for padding (zero q, k, v and, in the
backward, a zero cotangent there: `mlstm_backward` pads g so).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from xlstm_hved_torch.ops.mlstm import (MLSTM_EPS, chunk_gates, mlstm_chunkwise,
                                        pad_to_chunks)
from xlstm_hved_torch.utils import cuda_build

SOURCES = ("mlstm_fwd", "mlstm_bwd")
NARROW_DH = (8, 16)   # the widths of the narrow kernels' instantiations
NARROW_SPLIT = 8      # lanes sharing a group of four rows (csrc/mlstm_narrow.cuh, kSplit)
WIDE_TILE = 32        # the wide path's head-dimension tile
MAX_DH = 512
MAX_CHUNK = 128
BWD_MODES = ("fused", "scan")
SMS = 132             # an H100 SXM's streaming multiprocessors: one wave of blocks
ROW_TILES = (64, 32)  # the wide path's row tiles, the larger first
KEY_TILE = 32         # the backward's key tiles (csrc/mlstm_bwd.cu, kKeyTile)
FINAL_SPAN = 4096     # entries of dC * C* per block of its last sums (kFinalSpan)

_launchers = {}
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # function: (source, number of tensor pointers, number of int sizes)
    "mlstm_fwd_launch": ("mlstm_fwd", 12, 8),
    "mlstm_bwd_launch": ("mlstm_bwd", 29, 8),
}


def _launcher(fn_name: str):
    """The ctypes function `fn_name` and its library's error-string getter,
    declared once (the library builds on first use)."""
    if fn_name not in _launchers:
        source, n_ptr, n_int = _SIGNATURES[fn_name]
        lib = cuda_build.load(source)
        fn = getattr(lib, fn_name)
        fn.argtypes = [_PTR] * n_ptr + [_INT] * n_int + [_FLOAT, _INT, _PTR]
        fn.restype = _INT
        error_string = getattr(lib, f"{source}_error_string")
        error_string.argtypes = [_INT]
        error_string.restype = ctypes.c_char_p
        _launchers[fn_name] = fn, error_string
    return _launchers[fn_name]


def _launch(fn_name: str, pointers, sizes, eps: float, dev):
    fn, error_string = _launcher(fn_name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(*pointers, *sizes, eps, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: {error_string(rc).decode()} (code {rc})")


def padded_width(dh: int) -> int:
    """The width a head of width dh runs at: 8 or 16 (the narrow kernels) up
    to 16, else the next multiple of WIDE_TILE (the wide path)."""
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head width {dh}: the kernels take DH from 1 to {MAX_DH}")
    if dh <= NARROW_DH[-1]:
        return next(w for w in NARROW_DH if dh <= w)
    return -(-dh // WIDE_TILE) * WIDE_TILE


class WidePlan(NamedTuple):
    """The wide path's grids for one call: row tiles of `row_tile` rows for
    the forward readout and the backward's rows (the same tiles, so that the
    backward recomputes the forward's denominators bit for bit) and key
    tiles of KEY_TILE keys for the backward's columns; each tile's value
    columns split over `col_groups` blocks."""
    row_tile: int
    col_groups: int
    blocks: dict   # launch -> blocks of its grid


def column_groups(units: int, groups: int):
    """The column units [begin, end) of each of `groups` blocks sharing
    `units` 32-wide units, ceil(units / groups) each, as the kernels cut
    them (csrc/mlstm_wide.cuh::column_group); a group past the end is
    empty."""
    per = -(-units // groups)
    return [(min(units, i * per), min(units, (i + 1) * per)) for i in range(groups)]


def _split(tiles: int, units: int) -> int:
    """The fewest column groups, none of them empty, that give tiles x
    groups >= SMS blocks (or every unit its own group)."""
    for n in range(1, units + 1):
        groups = sum(end > begin for begin, end in column_groups(units, n))
        if tiles * groups >= SMS:
            return groups
    return units


def wide_plan(BH: int, nchunks: int, L: int, DP: int) -> WidePlan:
    """Row tiles of 64 rows where the (head, chunk, row tile) blocks fill a
    wave of SMS, else 32; then the value columns split until the blocks fill
    a wave (each split recomputes its tile's scores). The backward's key
    tiles, no larger than the row tiles, split the same way."""
    tiles = lambda t: BH * nchunks * -(-L // t)
    row_tile = next((t for t in ROW_TILES if tiles(t) >= SMS), ROW_TILES[-1])
    units = DP // WIDE_TILE
    col_groups = _split(tiles(row_tile), units)
    split = tiles(row_tile) * col_groups
    blocks = {"outer": BH * nchunks * -(-DP // 64) * -(-DP // 128), "readout": split,
              "bwd_gnum": split, "bwd_rows": split, "bwd_cols": tiles(KEY_TILE) * col_groups}
    return WidePlan(row_tile, col_groups, blocks)


def narrow_plan(L: int, columns: bool = False):
    """The causal pairs each lane of a narrow row kernel walks, as
    csrc/mlstm_narrow.cuh::slot assigns them for a chunk of L rows: lane
    tid = NARROW_SPLIT p + u of row group p holds two slots of two adjacent
    rows, the long rows L-1-2p, L-2-2p (live where >= L // 2) and the short
    rows 2p+1, 2p (live where < L // 2); a row r of a slot takes keys j =
    first, first + NARROW_SPLIT, ... <= r, with first = u in slot 0 and the
    positions running on from slot 0's L - 2p keys in slot 1. Returns one
    list per lane of (row, key) pairs, or with `columns` the backward's
    columns walk, (key, row) pairs: the slot's keys L-1-hi and L-hi walk the
    rows t = L-1-hi + first + NARROW_SPLIT m at or below them."""
    plan = []
    for tid in range(MAX_CHUNK // 4 * NARROW_SPLIT):
        p, u = divmod(tid, NARROW_SPLIT)
        lane = []
        for s in (0, 1):
            if s == 0:
                hi, first = L - 1 - 2 * p, u
                live = (hi >= L // 2, hi - 1 >= L // 2)
            else:
                hi, first = 2 * p + 1, (u - (L - 2 * p)) % NARROW_SPLIT
                live = (hi < L // 2, hi - 1 < L // 2)
            for r, alive in zip((hi, hi - 1), live):
                if not alive:
                    continue
                if columns:
                    key = L - 1 - r
                    lane += [(key, t) for t in range(L - 1 - hi + first, L, NARROW_SPLIT)
                             if t >= key]
                else:
                    lane += [(r, j) for j in range(first, r + 1, NARROW_SPLIT)]
        plan.append(lane)
    return plan


def _aligned(t):
    """t, or a copy of it whose data starts on a 16-byte boundary (the
    kernels copy rows as 16-byte cp.async chunks)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def prepare(q, k, v, igate, fgate, chunk_size: int = 128):
    """Pad and precompute the fp32 gate transforms.

    q, k, v: (B, NH, S, DH); igate, fgate: (B, NH, S). Returns q, k, v as
    contiguous fp32 (B*NH, Sp, DP), zero-padded to DP = padded_width(DH),
    and a, s, cm as contiguous fp32 (B*NH, Sp // L, L), with
    L = min(chunk_size, S) and Sp a multiple of L.
    """
    B, NH, S, DH = q.shape
    DP = padded_width(DH)
    qp, kp, vp, ip, fp, L = pad_to_chunks(q, k, v, igate, fgate, chunk_size)
    Sp = qp.shape[2]
    widen = (lambda t: F.pad(t, (0, DP - DH))) if DP > DH else (lambda t: t)
    flat = [_aligned(widen(t.to(torch.float32)).reshape(B * NH, Sp, DP).contiguous())
            for t in (qp, kp, vp)]
    gates = [t.contiguous() for t in chunk_gates(ip, fp, L)]
    return (*flat, *gates)


# ---------------------------------------------------------------- plain twins

def _chunked(t, L: int):
    """(BH, Sp, ...) -> (BH, Sp // L, L, ...), a view."""
    return t.reshape(t.shape[0], -1, L, *t.shape[2:])


def _readout(qs, kc, vc, a, s, cm, cent, nent, ment, eps: float):
    """Every chunk's readout from its entry state, batched over chunks.
    qs (q / sqrt(DH)), kc, vc: (BH, nchunks, L, DH); a, s, cm: (BH,
    nchunks, L); the entry states (C*, n*, m*). Returns the causal decays
    e^{s_j - M_t}, attn, inter = e^{m* - M_t}, q.C*, q.n*, num, rowsum,
    e^{-max(a_t + M_t, -60)} and the denominator."""
    L = a.shape[-1]
    causal = torch.ones((L, L), dtype=torch.bool, device=qs.device).tril()
    m_col = torch.maximum(cm, ment[..., None])                            # M_t
    dec = torch.exp((s[..., None, :] - m_col[..., :, None]).masked_fill(~causal, float("-inf")))
    attn = (qs @ kc.transpose(-1, -2)) * dec                              # (BH, nc, L, L)
    inter = torch.exp(ment[..., None] - m_col)
    q_c = qs @ cent
    q_n = (qs @ nent[..., None])[..., 0]
    num = attn @ vc + inter[..., None] * q_c
    rowsum = attn.sum(-1) + inter * q_n
    e_neg = torch.exp(-torch.clamp(a + m_col, min=-60.0))
    denom = torch.maximum(rowsum.abs(), e_neg) + eps
    return dec, attn, inter, q_c, q_n, num, rowsum, e_neg, denom


def mlstm_forward_reference(q, k, v, a, s, cm, eps: float = MLSTM_EPS, *, dh: int):
    """Plain twin of `mlstm_fwd` on `prepare`d inputs (the same three phases
    as `mlstm_forward_states_reference`). Returns h (B*NH, Sp, DP) fp32."""
    return mlstm_forward_states_reference(q, k, v, a, s, cm, eps, dh=dh)[0]


def mlstm_forward_states_reference(q, k, v, a, s, cm, eps: float = MLSTM_EPS, *, dh: int):
    """Plain twin of `mlstm_fwd_states`, in the kernel's three phases:
    1. every chunk's local state relative to its largest s, cm_{L-1}:
       K_c = sum_p e^{s_p - cm_{L-1}} k_p v_p^T and n_c = sum_p e^{..} k_p;
    2. the carry scan from m* = -1e30: with M' = max(m*, cm_{L-1}),
       C*' = e^{m* - M'} C* + e^{cm_{L-1} - M'} K_c (n* likewise) and
       m*' = a_{L-1} + M', the fp32 operations of the JAX `_m_entry_chain`;
    3. every chunk's readout from its entry state, q scaled by 1/sqrt(dh),
       dh the true head width (the columns past it zero).
    Returns h (BH, Sp, DP), cent (BH, nchunks, DP, DP), nent (BH, nchunks,
    DP) and ment (BH, nchunks), all fp32."""
    BH, Sp, DH = q.shape
    nchunks, L = a.shape[1:]
    kc, vc = _chunked(k, L), _chunked(v, L)
    top = cm[..., -1]
    kw = kc * torch.exp(s - top[..., None])[..., None]
    k_loc, n_loc = kw.transpose(-1, -2) @ vc, kw.sum(2)
    c_state, n_state = q.new_zeros((BH, DH, DH)), q.new_zeros((BH, DH))
    m_state = q.new_full((BH,), -1e30)
    entries = []
    for c in range(nchunks):
        entries.append((c_state, n_state, m_state))
        m_new = torch.maximum(m_state, top[:, c])
        decay_old, decay_new = torch.exp(m_state - m_new), torch.exp(top[:, c] - m_new)
        c_state = decay_old[:, None, None] * c_state + decay_new[:, None, None] * k_loc[:, c]
        n_state = decay_old[:, None] * n_state + decay_new[:, None] * n_loc[:, c]
        m_state = a[:, c, -1] + m_new
    cent, nent, ment = (torch.stack(t, dim=1) for t in zip(*entries))
    scale = 1.0 / math.sqrt(dh)
    *_, num, _, _, denom = _readout(_chunked(q * scale, L), kc, vc, a, s, cm,
                                    cent, nent, ment, eps)
    return (num / denom[..., None]).reshape(BH, Sp, DH), cent, nent, ment


def mlstm_backward_reference(q, k, v, g, a, s, cm, cent, nent, ment,
                             eps: float = MLSTM_EPS, *, dh: int):
    """Plain twin of `mlstm_bwd`, in the kernel's three phases. Every
    max-based stabiliser is held constant (exact; see the JAX module
    docstring), as in the Pallas `_mlstm_bwd_kernel`.
    1. rows, every chunk from its entry state: the readout recomputed, dq,
       dax but for the carried dm term, and the readout's adjoints of the
       entry state (dC_read, dn_read, dm_read);
    2. the reverse scan from a zero carry at the last chunk: dC_c is the
       adjoint of chunk c's exit state, dC_{c-1} = e_dec_c dC_c + dC_read_c
       (dn likewise), and dm_{c-1} = e_dec_c (sum dC_c * C*_c + sum dn_c *
       n*_c) + dm_read_c lands on dax[c-1, L-1] (m*' = a_{L-1} + M');
    3. columns, every chunk: dk, dv and ds from the recomputed attention and
       the state update's adjoint under dC_c, dn_c.
    q, k, v, g: (BH, Sp, DP); a, s, cm: (BH, nchunks, L); the entry states
    from the states kernel; dh the true head width. Returns dq,
    dk, dv (BH, Sp, DP) and ds, dax (BH, nchunks, L), all fp32."""
    BH, Sp, DH = q.shape
    nchunks, L = a.shape[1:]
    scale = 1.0 / math.sqrt(dh)
    tr = lambda t: t.transpose(-1, -2)
    qs, kc, vc, gc = (_chunked(t, L) for t in (q * scale, k, v, g))
    dec, attn, inter, q_c, q_n, num, rowsum, e_neg, denom = _readout(
        qs, kc, vc, a, s, cm, cent, nent, ment, eps)
    act = rowsum.abs() >= e_neg

    # ---- 1. rows
    g_over = gc / denom[..., None]
    ddenom = -(gc * num).sum(-1) / (denom * denom)
    drow = torch.where(act, torch.sign(rowsum) * ddenom, torch.zeros_like(ddenom))
    dax = torch.where(act, torch.zeros_like(ddenom), -e_neg * ddenom)
    dattn = g_over @ tr(vc) + drow[..., None]
    dqk = dattn * dec
    dq = scale * (dqk @ kc + inter[..., None] * (g_over @ tr(cent)
                                                 + drow[..., None] * nent[:, :, None]))
    dinter = (q_c * g_over).sum(-1) + drow * q_n
    dm_read = (dinter * inter).sum(-1)                                    # (BH, nc)
    dc_read = tr(qs * inter[..., None]) @ g_over                          # (BH, nc, DH, DH)
    dn_read = ((inter * drow)[..., None] * qs).sum(2)

    # ---- 2. the reverse scan
    top = cm[..., -1]
    m_new = torch.maximum(ment, top)                                      # M'
    e_dec = torch.exp(ment - m_new)
    dc, dn = q.new_zeros((BH, DH, DH)), q.new_zeros((BH, DH))
    carries = []
    for c in reversed(range(nchunks)):
        carries.append((dc, dn))
        dc = e_dec[:, c, None, None] * dc + dc_read[:, c]
        dn = e_dec[:, c, None] * dn + dn_read[:, c]
    dc_out, dn_out = (torch.stack(t[::-1], dim=1) for t in zip(*carries))
    dm_entry = e_dec * ((dc_out * cent).sum((-1, -2)) + (dn_out * nent).sum(-1)) + dm_read
    dax[:, :-1, -1] += dm_entry[:, 1:]

    # ---- 3. columns
    w = torch.exp(s - m_new[..., None])                                   # e^{s_p - M'}
    vdc = vc @ tr(dc_out)
    dk = tr(dqk) @ qs + w[..., None] * (vdc + dn_out[:, :, None])
    dv = tr(attn) @ g_over + w[..., None] * (kc @ dc_out)
    ds = (dattn * attn).sum(-2) + w * ((kc * vdc).sum(-1) + (kc @ dn_out[..., None])[..., 0])
    flat = lambda t: t.reshape(BH, Sp, DH)
    return flat(dq), flat(dk), flat(dv), ds, dax


# ---------------------------------------------------------------- launchers

def _prepared_dims(name, q, a, dh, seq_len):
    """(BH, Sp, DP, L, rows_last) of prepared q (BH, Sp, DP) and a (BH,
    Sp // L, L) for heads of true width dh and a true length seq_len (None:
    Sp), if the kernels take them: DP is padded_width(dh), and seq_len ends
    in the last chunk (rows_last of its rows are true)."""
    if q.dim() != 3 or a.dim() != 3:
        raise ValueError(f"{name}: q and a must be 3-D; got {tuple(q.shape)}, {tuple(a.shape)}")
    BH, Sp, DP = q.shape
    nchunks, L = a.shape[1:]
    seq_len = Sp if seq_len is None else seq_len
    if (nchunks * L != Sp or L > MAX_CHUNK or not 1 <= dh <= MAX_DH
            or padded_width(dh) != DP or not Sp - L < seq_len <= Sp):
        raise ValueError(f"{name}: unsupported prepared shapes q {tuple(q.shape)}, "
                         f"a {tuple(a.shape)} for head width {dh} and length {seq_len}")
    return BH, Sp, DP, L, seq_len - (nchunks - 1) * L


def _pointers(name, tensors, shapes):
    """The data pointers of `tensors`, once each is a contiguous fp32 tensor
    of its shape on the first one's CUDA device, 16-byte aligned (one pass,
    as this runs before every launch); and that device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors; got {dev}")
    for t, shape in zip(tensors, shapes):
        if (t.shape != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} takes contiguous, 16-byte aligned fp32 tensors on {dev} "
                             f"of the prepared shapes; got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} where {tuple(shape)} was expected")
    return [t.data_ptr() for t in tensors], dev


_ALIGN = 64   # workspace pieces start on 256-byte boundaries


def _workspace(like, sizes):
    """One fp32 allocation cut into pieces of `sizes` elements, each
    starting on a 256-byte boundary: the buffer and each piece's offset in
    it. Workspaces the caller never sees need no tensor views, so one call
    allocates once, however many it has."""
    offsets, total = [], 0
    for n in sizes:
        offsets.append(total)
        total += -(-n // _ALIGN) * _ALIGN
    return like.new_empty(total), offsets


def _wide(DP: int) -> bool:
    return DP > NARROW_DH[-1]


def _plan_sizes(BH, Sp, L, DP, dh, rows_last):
    """The int arguments of a launch (the sizes, rows_last and the wide
    plan's row tile and column groups, which the narrow kernels ignore) and
    the plan."""
    plan = wide_plan(BH, Sp // L, L, DP) if _wide(DP) else WidePlan(ROW_TILES[0], 1, {})
    return (BH, Sp, L, DP, dh, rows_last, plan.row_tile, plan.col_groups), plan


def _forward_launch(name, q, k, v, a, s, cm, eps, dh, seq_len, states: bool):
    """The launches of `csrc/mlstm_fwd.cu`, the entry states and the chunks'
    local states in one workspace. Returns h, and with `states` the entry
    states as views of the workspace."""
    BH, Sp, DP, L, rows_last = _prepared_dims(name, q, a, dh, seq_len)
    nchunks = Sp // L
    ptrs, dev = _pointers(name, (q, k, v, a, s, cm), (q.shape,) * 3 + ((BH, nchunks, L),) * 3)
    n_c, n_n, n_m = BH * nchunks * DP * DP, BH * nchunks * DP, BH * nchunks
    out = torch.empty_like(q)
    buf, offsets = _workspace(q, (n_c, n_n, n_m, n_c, n_n))
    base = buf.data_ptr()
    sizes, _ = _plan_sizes(BH, Sp, L, DP, dh, rows_last)
    _launch("mlstm_fwd_launch", (*ptrs, out.data_ptr(), base + 4 * offsets[3],
                                 base + 4 * offsets[4], *(base + 4 * o for o in offsets[:3])),
            sizes, eps, dev)
    if not states:
        return out
    c0, n0, m0 = offsets[:3]
    return (out, buf[c0:c0 + n_c].view(BH, nchunks, DP, DP),
            buf[n0:n0 + n_n].view(BH, nchunks, DP), buf[m0:m0 + n_m].view(BH, nchunks))


def run_kernel(q, k, v, a, s, cm, eps: float = MLSTM_EPS, *, dh: int, seq_len=None):
    """One call of `mlstm_fwd` on `prepare`d CUDA tensors
    (q, k, v: (BH, Sp, DP); a, s, cm: (BH, Sp // L, L), all contiguous
    fp32; dh the true head width; seq_len the true length, default Sp): its
    launches, the entry states kept in a workspace. Returns (BH, Sp, DP)
    fp32, bitwise `run_states_kernel`'s h. Adds one to
    `run_kernel.launches`."""
    out = _forward_launch("mlstm_fwd", q, k, v, a, s, cm, eps, dh, seq_len, states=False)
    run_kernel.launches += 1
    return out


def run_states_kernel(q, k, v, a, s, cm, eps: float = MLSTM_EPS, *, dh: int, seq_len=None):
    """One call of `mlstm_fwd_states`: as `run_kernel`, and also each
    chunk's entry state. Returns h (BH, Sp, DP), cent (BH, nchunks, DP, DP),
    nent (BH, nchunks, DP), ment (BH, nchunks). Adds one to
    `run_states_kernel.launches`."""
    result = _forward_launch("mlstm_fwd_states", q, k, v, a, s, cm, eps, dh, seq_len,
                             states=True)
    run_states_kernel.launches += 1
    return result


def run_bwd_kernel(q, k, v, g, a, s, cm, cent, nent, ment, eps: float = MLSTM_EPS, *,
                   dh: int, seq_len=None):
    """One call of `mlstm_bwd` (its launches) on prepared CUDA tensors and
    the states kernel's entry states (dh the true head width; seq_len the
    true length, default Sp, with g zero past it). Returns dq, dk, dv (BH,
    Sp, DP) and ds, dax (BH, nchunks, L). Adds one to
    `run_bwd_kernel.launches`."""
    BH, Sp, DP, L, rows_last = _prepared_dims("mlstm_bwd", q, a, dh, seq_len)
    nchunks = Sp // L
    ptrs, dev = _pointers("mlstm_bwd", (q, k, v, g, a, s, cm, cent, nent, ment),
                          (q.shape,) * 4 + ((BH, nchunks, L),) * 3
                          + ((BH, nchunks, DP, DP), (BH, nchunks, DP), (BH, nchunks)))
    sizes, plan = _plan_sizes(BH, Sp, L, DP, dh, rows_last)
    # three allocations, not twenty: the outputs by shape, and one workspace
    # for each chunk's readout adjoints of its entry state and its incoming
    # carry, each row's denominator and d rowsum, and the wide path's row
    # and column scalars
    grads, chunk_grads = q.new_empty((3, *q.shape)), a.new_empty((2, *a.shape))
    n_c, n_n, n_a, n_m = BH * nchunks * DP * DP, BH * nchunks * DP, BH * Sp, BH * nchunks
    n_row, n_span = (n_a, n_m * -(-DP * DP // FINAL_SPAN)) if _wide(DP) else (0, 0)
    work, offsets = _workspace(q, (n_c, n_c, n_n, n_n, n_a, n_a, n_m, n_row, n_row,
                                   n_row * plan.col_groups, n_span, 2 * n_row * plan.col_groups,
                                   n_row, n_row))
    base = work.data_ptr()
    dc_read, dc_carry, dn_read, dn_carry, denom, drow, dm_read, *wide = (
        base + 4 * o for o in offsets)
    dq, dk, dv = grads.unbind(0)
    ds, dax = chunk_grads.unbind(0)
    _launch("mlstm_bwd_launch",
            (*ptrs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ds.data_ptr(), dax.data_ptr(),
             denom, drow, dc_read, dn_read, dm_read, dc_carry, dn_carry, *wide),
            sizes, eps, dev)
    run_bwd_kernel.launches += 1
    return dq, dk, dv, ds, dax


# Calls of each wrapper since its count was last set to 0 (read by
# chip_smoke.py). One call enqueues three CUDA kernels on the narrow path
# (chunk states, carry scan and readout for the forward wrappers; rows,
# reverse scan and columns with the carried dm for the backward), three
# (forward) or seven (backward) on the wide path.
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
    Sp, DP = qf.shape[1:]
    gf = _aligned(F.pad(g.to(torch.float32), (0, DP - DH, 0, Sp - S))
                  .reshape(B * NH, Sp, DP).contiguous())
    if q.device.type == "cuda":
        _, cent, nent, ment = run_states_kernel(*prepared, eps, dh=DH, seq_len=S)
        grads = run_bwd_kernel(qf, kf, vf, gf, a, s, cm, cent, nent, ment, eps, dh=DH,
                               seq_len=S)
    else:
        _, cent, nent, ment = mlstm_forward_states_reference(*prepared, eps, dh=DH)
        grads = mlstm_backward_reference(qf, kf, vf, gf, a, s, cm, cent, nent, ment, eps,
                                         dh=DH)
    dq, dk, dv, ds, dax = grads
    di, df = gate_grads(ds, dax, fgate, S)
    unpad = lambda t: t.reshape(B, NH, Sp, DP)[:, :, :S, :DH]
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
        out = run_kernel(*prepare(q, k, v, igate, fgate, chunk_size), eps, dh=DH, seq_len=S)
        return out.reshape(B, NH, -1, out.shape[-1])[:, :, :S, :DH]

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
    if not 1 <= q.shape[-1] <= MAX_DH:
        raise ValueError(f"head width {q.shape[-1]}: the kernels take DH from 1 to {MAX_DH}")
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
