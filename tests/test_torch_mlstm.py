"""PyTorch port: the plain mLSTMs, their gradients and the CUDA kernels'
plain twins against the JAX package (chunkwise scan and the Pallas kernels
in interpret mode). Tolerances are those of tests/test_mlstm.py for the
Pallas kernels. The wrapper's head-width padding (DH zero-padded to the
kernels' width, the scale from the true DH) runs here through the twins:
held to the unpadded plain scan and its autograd at 2e-5 (h) and 2e-5 of
max|ref| (the gradients), fp32 sums in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (TF32 off)
from xlstm_hved_tpu.ops.mlstm import mlstm_chunkwise as j_chunkwise
from xlstm_hved_tpu.ops.mlstm_pallas import _m_entry_chain, _pallas_forward, _prep, mlstm_pallas
from xlstm_hved_torch.nn.vil import MatrixLSTMCell
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise, mlstm_quadratic
from xlstm_hved_torch.ops.mlstm_cuda import (KEY_TILE, MAX_CHUNK, MAX_DH, NARROW_SPLIT, SMS,
                                             column_groups, mlstm_backward, mlstm_forward,
                                             mlstm_forward_reference,
                                             mlstm_forward_states_reference, narrow_plan,
                                             padded_width, prepare, run_bwd_kernel, run_kernel,
                                             run_states_kernel, wide_plan)

ATOL, RTOL = 2e-4, 1e-3


def _inputs(seed, B=1, NH=2, S=80, DH=16, case="realistic"):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, NH, S, DH).astype(np.float32) for _ in range(3))
    ig = (0.5 * rng.randn(B, NH, S)).astype(np.float32)
    fg = (3.0 + 3.0 * rng.rand(B, NH, S)).astype(np.float32)
    if case == "extreme":          # fast decay, large input gates
        ig, fg = ig * 10.0, fg - 12.0
    elif case == "wide_igate":     # igate ramp 0..200 inside one chunk
        ig = np.broadcast_to(np.linspace(0.0, 200.0, S, dtype=np.float32), ig.shape).copy()
    elif case == "deep_forget":    # m_t far below -60: the clamped normaliser
        ig, fg = ig - 100.0, fg - 20.0
    elif case == "denominator":    # tiny attention mass: the e^{-m} branch is live
        ig = (-8.0 + rng.randn(B, NH, S)).astype(np.float32)
        fg = (1.0 + rng.rand(B, NH, S)).astype(np.float32)
    elif case == "padding_tail":   # the last 40 positions as padding: whole chunks of it
        ig[..., -40:], fg[..., -40:] = -1e30, 1e30
        k[..., -40:, :], v[..., -40:, :] = 0.0, 0.0
    elif case == "underflow":      # igate +150 in the first 16 positions: the later
        ig[..., :16] += 150.0      # chunks' e^{cm_{L-1} - M'} underflow to 0, so their
        q, k[..., :16, :] = np.abs(q), np.abs(k[..., :16, :])  # rows read only that
        # state; positive q and keys keep their q.n* (the rowsum) away from 0
    return q, k, v, ig, fg


def _twin(q, k, v, ig, fg, L):
    B, NH, S, DH = q.shape
    out = mlstm_forward_reference(*prepare(*map(torch.from_numpy, (q, k, v, ig, fg)), L), dh=DH)
    return out.reshape(B, NH, -1, DH)[:, :, :S].numpy()


CASES = [
    (80, 32, "realistic"),
    (97, 32, "realistic"),
    (130, 64, "realistic"),
    (256, 64, "realistic"),     # several full chunks
    (80, 16, "extreme"),
    (64, 64, "wide_igate"),
    (64, 16, "wide_igate"),
    (48, 16, "deep_forget"),
]


@pytest.mark.parametrize("S,L,case", CASES)
def test_chunkwise_matches_jax(S, L, case):
    q, k, v, ig, fg = _inputs(S, S=S, case=case)
    ref = np.asarray(j_chunkwise(*map(jnp.asarray, (q, k, v, ig, fg)), chunk_size=L))
    out = mlstm_chunkwise(*map(torch.from_numpy, (q, k, v, ig, fg)), chunk_size=L)
    assert np.all(np.isfinite(out.numpy()))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("S,case", [(80, "realistic"), (97, "realistic"),
                                    (80, "extreme"), (64, "wide_igate")])
def test_quadratic_matches_jax_chunkwise(S, case):
    q, k, v, ig, fg = _inputs(S + 1, S=S, case=case)
    ref = np.asarray(j_chunkwise(*map(jnp.asarray, (q, k, v, ig, fg)), chunk_size=32))
    out = mlstm_quadratic(*map(torch.from_numpy, (q, k, v, ig, fg)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


# cases that only the chunk-parallel phases (local states, carry scan,
# per-chunk readout) can get wrong: one chunk (L = S), 63 chunks, whole
# chunks of padding, e^{cm_{L-1} - M'} underflowing, the e^{-m} branch
PHASE_CASES = [(50, 64, "realistic"), (1000, 16, "realistic"), (96, 16, "padding_tail"),
               (64, 16, "underflow"), (64, 16, "denominator")]


@pytest.mark.parametrize("S,L,case", [c for c in CASES if c[0] <= 130] + PHASE_CASES)
def test_kernel_twin_matches_pallas_interpret(S, L, case):
    q, k, v, ig, fg = _inputs(S + 2, S=S, case=case)
    ref = np.asarray(mlstm_pallas(*map(jnp.asarray, (q, k, v, ig, fg)), L, 1e-6, True))
    out = _twin(q, k, v, ig, fg, L)
    assert np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_kernel_twin_prepare_pads_like_pallas():
    q, k, v, ig, fg = _inputs(5, B=2, NH=3, S=97)
    qf, kf, vf, a, s, cm = prepare(*map(torch.from_numpy, (q, k, v, ig, fg)), 32)
    assert qf.shape == (6, 128, 16) and a.shape == (6, 4, 32)
    assert all(t.is_contiguous() and t.dtype == torch.float32 for t in (qf, kf, vf, a, s, cm))
    # padded tail: zero q/k/v, igate -1e30, no forget-gate decay
    assert torch.count_nonzero(qf[:, 97:]) == 0
    torch.testing.assert_close(a[:, -1, 1:], a[:, -1, 1:2].expand(-1, 31))
    assert float(s[:, -1, 1:].max()) < -1e29
    torch.testing.assert_close(cm, torch.cummax(s, dim=-1).values, rtol=0, atol=0)


def test_kernel_wrapper_refuses_what_it_cannot_run():
    q, k, v, ig, fg = map(torch.from_numpy, _inputs(6, S=64))
    with pytest.raises(ValueError, match="CUDA"):
        mlstm_forward(q, k, v, ig, fg)                     # CPU tensors
    with pytest.raises(ValueError, match="bwd_mode"):
        mlstm_forward(q, k, v, ig, fg, bwd_mode="xla")     # only "fused" and "scan"
    wide = [torch.nn.functional.pad(t, (0, MAX_DH + 1 - t.shape[-1])) for t in (q, k, v)]
    with pytest.raises(ValueError, match=f"head width {MAX_DH + 1}"):
        mlstm_forward(*wide, ig, fg)                       # past the widest the kernels take
    with pytest.raises(ValueError, match="chunk_size"):
        mlstm_forward(q, k, v, ig, fg, chunk_size=256)


def test_kernel_launchers_refuse_what_they_cannot_run():
    prepared = prepare(*map(torch.from_numpy, _inputs(7, S=64)), 32)
    qf, kf, vf, a, s, cm = prepared
    _, cent, nent, ment = mlstm_forward_states_reference(*prepared, dh=16)
    counters = (run_kernel, run_states_kernel, run_bwd_kernel)
    before = [fn.launches for fn in counters]
    for run in (run_kernel, run_states_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            run(*prepared, dh=16)                           # CPU tensors launch nothing
    with pytest.raises(ValueError, match="CUDA"):
        run_bwd_kernel(qf, kf, vf, qf, a, s, cm, cent, nent, ment, dh=16)
    with pytest.raises(ValueError, match="unsupported prepared shapes"):
        run_kernel(qf[:, :48].contiguous(), kf, vf, a, s, cm, dh=16)   # Sp is not the chunks' span
    with pytest.raises(ValueError, match="3-D"):
        run_bwd_kernel(qf[None], kf, vf, qf, a, s, cm, cent, nent, ment, dh=16)
    for seq_len in (32, 65):   # the true length ends in the last chunk
        with pytest.raises(ValueError, match=f"length {seq_len}"):
            run_kernel(*prepared, dh=16, seq_len=seq_len)
    assert [fn.launches for fn in counters] == before


# the five timed wide cases of chip_smoke.py: (B*NH, S, DH)
TIMED_WIDE = [(8, 4096, 128), (8, 512, 160), (8, 320, 32), (4, 4096, 96), (4, 196, 384)]


def _row_blocks(BH, nchunks, L, rows_last, tile):
    """The (chunk, first row, true rows, keys) of every block of a row-tiled
    launch, decoded as csrc/mlstm_wide.cuh::tile_coords decodes blockIdx.x."""
    tiles = -(-L // tile)
    for b in range(BH * nchunks * tiles):
        cidx, t0 = divmod(b, tiles)
        t0 *= tile
        rows = rows_last if cidx % nchunks == nchunks - 1 else L
        live = max(0, min(tile, rows - t0))
        yield cidx, t0, live, min(t0 + tile, rows)


@pytest.mark.parametrize("BH,S,DH", TIMED_WIDE + [(1, 65, 96), (1, 129, 64), (4, 200, 160),
                                                  (2, 200, 512), (1, 196, 384)])
def test_wide_plan_covers_every_true_row_once_and_fills_the_card(BH, S, DH):
    """The wide grids: every true row (and key) of every chunk in one row
    tile, no key loaded past the tile's last row (nothing above the
    diagonal), every column unit in one group, and at least SMS blocks in
    each L x L launch, or one block per (head, chunk, row tile) where
    there are fewer."""
    L = min(128, S)
    nchunks = -(-S // L)
    rows_last = S - (nchunks - 1) * L
    DP = padded_width(DH)
    plan = wide_plan(BH, nchunks, L, DP)
    seen = np.zeros((BH * nchunks, L), dtype=int)
    for cidx, t0, live, keys in _row_blocks(BH, nchunks, L, rows_last, plan.row_tile):
        seen[cidx, t0:t0 + live] += 1
        assert live == 0 or keys == t0 + live     # keys 0 .. the tile's last true row
    true_rows = np.zeros_like(seen)
    true_rows[:, :L] = 1
    true_rows.reshape(BH, nchunks, L)[:, -1, rows_last:] = 0
    np.testing.assert_array_equal(seen, true_rows)
    units = DP // 32
    groups = column_groups(units, plan.col_groups)
    assert all(end > begin for begin, end in groups)
    assert sum(end - begin for begin, end in groups) == units
    assert all(b == e for (_, e), (b, _) in zip(groups, groups[1:]))
    tiles = BH * nchunks * -(-L // plan.row_tile)
    launches = ("readout", "bwd_gnum", "bwd_rows", "bwd_cols")
    assert all(plan.blocks[n] == tiles * plan.col_groups for n in launches[:3])
    assert plan.blocks["bwd_cols"] == BH * nchunks * -(-L // KEY_TILE) * plan.col_groups
    for launch in launches:
        assert plan.blocks[launch] >= min(SMS, tiles)
    if plan.col_groups > 1:   # split only as far as a wave needs
        fewer = column_groups(units, plan.col_groups - 1)
        assert tiles * sum(end > begin for begin, end in fewer) < SMS


def test_wide_plan_at_the_timed_cases():
    """The plan chip_smoke.py prints for the five timed wide cases."""
    got = [tuple(wide_plan(BH, -(-S // min(128, S)), min(128, S), padded_width(DH))[:2])
           for BH, S, DH in TIMED_WIDE]
    assert got == [(64, 1), (32, 2), (32, 1), (64, 1), (32, 6)]


@pytest.mark.parametrize("columns", [False, True])
@pytest.mark.parametrize("L", [MAX_CHUNK, 127, 100, 33, 16, 7, 5, 2, 1])
def test_narrow_plan_walks_every_causal_pair_once(L, columns):
    """The narrow kernels' balanced walk (csrc/mlstm_narrow.cuh, with the
    lane count its header sets): every causal (row t, key j <= t) pair, or
    in the columns (key p, row t >= p), in exactly one lane, and no lane
    taking more than two pairs (its slot's two rows) at each of its
    ceil((L + 2) / NARROW_SPLIT) positions, nor more than ceil((L + 1) / 2)
    pairs."""
    import re
    from pathlib import Path

    header = (Path(__file__).resolve().parent.parent / "xlstm_hved_torch" / "csrc"
              / "mlstm_narrow.cuh").read_text()
    assert int(re.search(r"constexpr int kSplit = (\d+);", header).group(1)) == NARROW_SPLIT
    plan = narrow_plan(L, columns)
    walked = [pair for lane in plan for pair in lane]
    if columns:
        want = {(p, t) for p in range(L) for t in range(p, L)}
    else:
        want = {(t, j) for t in range(L) for j in range(t + 1)}
    assert len(walked) == len(set(walked)) == len(want) and set(walked) == want
    longest = max(len(lane) for lane in plan)
    assert longest <= 2 * -(-(L + 2) // NARROW_SPLIT) and longest <= -(-(L + 1) // 2)


@pytest.mark.parametrize("dh,width", [(1, 8), (6, 8), (8, 8), (9, 16), (16, 16), (17, 32),
                                      (45, 64), (96, 96), (130, 160), (384, 384),
                                      (MAX_DH, MAX_DH)])
def test_padded_width(dh, width):
    assert padded_width(dh) == width


@pytest.mark.parametrize("dh", [0, MAX_DH + 1])
def test_padded_width_refuses_what_no_kernel_takes(dh):
    with pytest.raises(ValueError, match=f"head width {dh}"):
        padded_width(dh)


@pytest.mark.parametrize("DH,S,L", [(6, 80, 32), (45, 97, 32), (3, 40, 16), (130, 70, 64)])
def test_padded_twins_match_unpadded_chunkwise(DH, S, L):
    """The wrapper's padding: q, k, v zero-padded to padded_width(DH) by
    `prepare`, the twins scaled by the true 1/sqrt(DH), h's padded columns
    exact zeros; `mlstm_backward` (which pads g the same way and runs the
    twins on CPU tensors) against autograd through the unpadded scan."""
    q, k, v, ig, fg = map(torch.from_numpy, _inputs(11, B=2, NH=2, S=S, DH=DH))
    prepared = prepare(q, k, v, ig, fg, L)
    DP = prepared[0].shape[-1]
    assert DP == padded_width(DH) > DH
    assert torch.count_nonzero(prepared[0][..., DH:]) == 0
    h = mlstm_forward_reference(*prepared, dh=DH).reshape(2, 2, -1, DP)
    assert torch.count_nonzero(h[..., DH:]) == 0
    ref = mlstm_chunkwise(q, k, v, ig, fg, chunk_size=L)
    torch.testing.assert_close(h[:, :, :S, :DH], ref, atol=2e-5, rtol=0)
    # the true width's scale matters: the padded width's is another function
    wrong = mlstm_forward_reference(*prepared, dh=DP).reshape(2, 2, -1, DP)[:, :, :S, :DH]
    assert float((wrong - ref).abs().max()) > 1e-3

    g = torch.from_numpy(np.random.RandomState(12).randn(2, 2, S, DH).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, ig, fg)]
    want = torch.autograd.grad(mlstm_chunkwise(*leaves, chunk_size=L), leaves, g)
    got = mlstm_backward(q, k, v, ig, fg, g, L)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 2e-5 * float(b.abs().max())


@pytest.mark.parametrize("S,DH", [(320, 32), (196, 384), (4096, 16), (100, 16)])
def test_kernel_bounds_count_true_rows(S, DH):
    """chip_smoke.py's bounds cost the function at its true length: a padded
    last chunk costs what a one-chunk sequence of its rows costs, and the
    padding to whole chunks adds no work."""
    import chip_smoke as cs

    L = min(128, S)
    full, rest = divmod(S, L)
    for cost in (cs.mlstm_cost, lambda *a: cs.mlstm_cost(*a, states=True), cs.mlstm_bwd_cost):
        nbytes, ops = cost(8, S, DH, L)
        whole = cost(8, full * L, DH, L)
        tail = cost(8, rest, DH, rest) if rest else (0, 0)
        assert ops == whole[1] + tail[1]
        assert nbytes == whole[0] + tail[0]
        if rest:
            assert ops < cost(8, (full + 1) * L, DH, L)[1]


def test_matrix_lstm_cell_dispatch_on_cpu():
    cell = MatrixLSTMCell(32, 4, chunk_size=16)
    x = torch.randn(1, 40, 32)
    with torch.no_grad():
        h = cell(x, x, x)
    assert h.shape == (1, 40, 32) and torch.isfinite(h).all()
    cell.mlstm_kernel = True  # asking for the kernel on CPU tensors raises
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        cell(x, x, x)


def _torch_grads(fn, inputs, weight):
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in inputs]
    (torch.from_numpy(weight) * torch.sin(fn(*leaves))).sum().backward()
    return [t.grad.numpy() for t in leaves]


def _jax_grads(fn, inputs, weight):
    loss = lambda args: jnp.sum(jnp.asarray(weight) * jnp.sin(fn(*args)))
    return [np.asarray(g) for g in jax.grad(loss)(tuple(map(jnp.asarray, inputs)))]


# the gradient cases of tests/test_mlstm.py: the wide igate spread (one and
# several chunks), deep forgetting, and the small multi-chunk cases
GRAD_CASES = [(64, 64, "wide_igate"), (64, 16, "wide_igate"), (48, 16, "deep_forget"),
              (48, 16, "realistic"), (40, 16, "realistic"), (97, 32, "realistic")]


@pytest.mark.parametrize("S,L,case", GRAD_CASES)
def test_chunkwise_autograd_matches_jax_grad(S, L, case):
    """Autograd through the plain scan (the bwd_mode="scan" oracle) against
    jax.grad of the JAX scan; finite on the JAX NaN regressions."""
    inputs = _inputs(S + 3, NH=2, S=S, DH=8, case=case)
    weight = np.random.RandomState(S).randn(1, 2, S, 8).astype(np.float32)
    got = _torch_grads(lambda *a: mlstm_chunkwise(*a, chunk_size=L), inputs, weight)
    want = _jax_grads(lambda *a: j_chunkwise(*a, chunk_size=L), inputs, weight)
    for g, w in zip(got, want):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)


def _check_states_twin(B, NH, S, DH, L, case):
    q, k, v, ig, fg = _inputs(S + 4, B=B, NH=NH, S=S, DH=DH, case=case)
    jin = tuple(map(jnp.asarray, (q, k, v, ig, fg)))
    out, cent, nent = _pallas_forward(*jin, L, 1e-6, True, save_states=True)
    m_ent = _m_entry_chain(*_prep(*jin, L)[4:6])
    prepared = prepare(*map(torch.from_numpy, (q, k, v, ig, fg)), L)
    h, c, n, m = mlstm_forward_states_reference(*prepared, dh=DH)
    np.testing.assert_allclose(h.reshape(B, NH, -1, DH)[:, :, :S].numpy(), np.asarray(out),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cent), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(n.numpy(), np.asarray(nent)[:, :, 0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ent), atol=ATOL, rtol=RTOL)
    # on the same gates the carry scan's m* is the JAX chain bit for bit
    a, s = (jnp.asarray(t.numpy()) for t in prepared[3:5])
    np.testing.assert_array_equal(m.numpy(), np.asarray(_m_entry_chain(a, s)))
    if case == "underflow":  # the case reaches what it is named for
        top = prepared[5][..., -1]
        assert float(torch.exp(top - torch.maximum(m, top)).min()) == 0.0


@pytest.mark.parametrize("S,L,case", [(97, 32, "realistic"), (130, 64, "extreme"),
                                      (64, 16, "denominator")] + PHASE_CASES[:-1])
def test_states_twin_matches_pallas_save_states(S, L, case):
    _check_states_twin(2, 3, S, 16, L, case)


@pytest.mark.parametrize("S,L,case", [(50, 64, "realistic"), (1000, 16, "realistic"),
                                      (96, 16, "padding_tail"), (64, 16, "denominator")])
def test_states_twin_matches_pallas_save_states_dh8(S, L, case):
    _check_states_twin(1, 2, S, 8, L, case)


# the wide path's edges: the widest head with a last chunk of 72 true rows,
# a last chunk of 1 true row, one chunk of 65 rows (a row tile and one row)
WIDE_EDGES = [(200, 512), (129, 64), (65, 96)]


@pytest.mark.parametrize("S,DH", WIDE_EDGES)
def test_states_twin_matches_pallas_save_states_wide(S, DH):
    _check_states_twin(1, 2, S, DH, 128, "realistic")


@pytest.mark.parametrize("B,NH,S,DH,L,case,atol,rtol", [
    (2, 3, 97, 16, 32, "realistic", 2e-4, 1e-3),      # padded, several chunks
    (2, 3, 130, 16, 64, "realistic", 2e-4, 1e-3),
    (1, 2, 64, 8, 16, "denominator", 3e-4, 2e-3),     # the e^{-m} branch
    (1, 2, 50, 16, 64, "realistic", 2e-4, 1e-3),      # one chunk
    (1, 2, 1000, 8, 16, "realistic", 2e-4, 1e-3),     # 63 chunks
    (1, 2, 2100, 8, 16, "realistic", 2e-4, 1e-3),     # 132 chunks: the carried dm per chunk
    (2, 2, 96, 16, 16, "padding_tail", 2e-4, 1e-3),
    (1, 2, 64, 16, 16, "underflow", 2e-4, 1e-3),
    (2, 3, 97, 16, 32, "denominator", 3e-4, 2e-3),
    *[(1, 2, S, DH, 128, "realistic", 2e-4, 1e-3) for S, DH in WIDE_EDGES],
])
def test_backward_twin_matches_pallas_vjp(B, NH, S, DH, L, case, atol, rtol):
    """The fused backward on CPU tensors (states twin, backward twin, gate
    epilogue, unpad) against jax.vjp of the Pallas custom VJP."""
    q, k, v, ig, fg = _inputs(S + 5, B=B, NH=NH, S=S, DH=DH, case=case)
    cot = np.random.RandomState(S + 6).randn(B, NH, S, DH).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: mlstm_pallas(*a, L, 1e-6, True),
                     *map(jnp.asarray, (q, k, v, ig, fg)))
    want = vjp(jnp.asarray(cot))
    got = mlstm_backward(*map(torch.from_numpy, (q, k, v, ig, fg, cot)), chunk_size=L)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=rtol)
