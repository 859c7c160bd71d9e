"""PyTorch port on the card: the CUDA mLSTM kernels (forward, states-saving
forward, backward) against their plain twins, at the ViL decoder's DH 8 and
S 32768 too, and on the wide path at the xLSTM families' head widths (DH 15
to 384, odd widths zero-padded) and its edges (a last chunk's true rows
ending inside a row tile, DH 512, a grid below one wave, the true length
skipping the padding), the differentiable wrapper against autograd
through the plain scan, the xLSTM models' kernel path against their plain
path, the model's kernel path (the forward, the train step, the pretrain
step) against its plain path, the hoisted 15-subset sweep against the
plain one (U_HVEDNet3D's too), the native NIfTI decoder built on that
machine, the patch-size probe, and the RSM gates' 7^3 conv kernel against
its twin (the cells' level shapes, ragged sizes, 2 to 16 input and 1 to 4
output channels, bf16 / fp32 / fp64), run to run and across the batch bit
for bit, its Function's gradients bit for bit autograd's through F.conv3d,
and its launches over a hoisted sweep and a train step. These need a CUDA
device and nvcc; without a card they skip. Run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: the suite's conftest.py imports JAX, which the card machine
need not have.)
"""
import pytest
import torch

from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.engine.evaluate import (default_apply_fn, make_hoisted_subset_sweep,
                                              make_subset_sweep)
from xlstm_hved_torch.engine.train import (create_train_state, freeze_mask_for, make_grad_fn,
                                           make_pretrain_step, make_train_step,
                                           pretrain_objective)
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.ops import mlstm_cuda
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise
from xlstm_hved_torch.utils.subsets import subset_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, NH, S, DH, seed=0, case="realistic"):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, NH, S, DH, generator=g, device=dev) for _ in range(3))
    ig = 0.5 * torch.randn(B, NH, S, generator=g, device=dev)
    fg = 3.0 + 3.0 * torch.rand(B, NH, S, generator=g, device=dev)
    if case == "denominator":  # tiny attention mass: the e^{-m} branch is live
        ig, fg = ig * 2.0 - 8.0, fg / 3.0
    elif case == "wide_igate":     # igate ramp 0..200 inside every chunk, q.n* > 0
        ramp = torch.linspace(0.0, 200.0, 128, device=dev).repeat(-(-S // 128))[:S]
        ig, q, k = ramp.expand(B, NH, S).contiguous(), q.abs(), k.abs()
    elif case == "deep_forget":    # m_t far below -60: the clamped normaliser
        ig, fg = ig - 100.0, fg - 20.0
    elif case == "padding_tail":   # the last 40 positions as padding
        ig[..., -40:], fg[..., -40:] = -1e30, 1e30
        k[..., -40:, :], v[..., -40:, :] = 0.0, 0.0
    elif case == "underflow":      # igate +150 in the first 16 positions: the later
        ig[..., :16] += 150.0      # chunks' state terms underflow to 0
        q, k[..., :16, :] = q.abs(), k[..., :16, :].abs()
    return q, k, v, ig, fg


def _scaled_err(out, ref):
    """max |out - ref| over max |ref|, the bound chip_smoke.py states."""
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


# (1, 4, 100) is one chunk (L = S); (2, 4, 6144) is 384 blocks, more than one wave;
# (1, 4, 32768, 8) and (1, 4, 49152, 8) are the ViL decoder of
# U_HVEDConvXLSTMNet3D at 128^3 and 128x192x128, 256 and 384 chunks
@pytest.mark.parametrize("B,NH,S,DH,L", [(1, 4, 4096, 16, 128), (1, 4, 6144, 16, 128),
                                         (2, 4, 1000, 8, 128), (1, 2, 97, 16, 32),
                                         (1, 4, 100, 16, 128), (2, 4, 6144, 16, 128),
                                         (1, 4, 32768, 8, 128), (1, 4, 49152, 8, 128)])
def test_kernel_matches_twin(dev, B, NH, S, DH, L):
    prepared = mlstm_cuda.prepare(*_inputs(dev, B, NH, S, DH), L)
    out = mlstm_cuda.run_kernel(*prepared, dh=DH)
    ref = mlstm_cuda.mlstm_forward_reference(*prepared, dh=DH)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = float((out - ref).abs().max())
    assert err <= 5e-4 and err / float(ref.abs().max()) <= 2e-5  # as chip_smoke.py
    # the states variant runs the same launches: the same h, bit for bit
    assert torch.equal(out, mlstm_cuda.run_states_kernel(*prepared, dh=DH)[0])


def test_mlstm_forward_matches_chunkwise_and_counts(dev):
    q, k, v, ig, fg = _inputs(dev, 1, 4, 300, 16, seed=1)
    before = mlstm_cuda.run_kernel.launches
    with torch.no_grad():
        out = mlstm_cuda.mlstm_forward(q, k, v, ig, fg, chunk_size=128)
    assert mlstm_cuda.run_kernel.launches == before + 1
    ref = mlstm_chunkwise(q, k, v, ig, fg, chunk_size=128)
    torch.testing.assert_close(out, ref, rtol=1e-3, atol=2e-4)
    with pytest.raises(ValueError, match="bwd_mode"):
        mlstm_cuda.mlstm_forward(q, k, v, ig, fg, bwd_mode="xla")


@pytest.mark.parametrize("B,NH,S,DH,L,case", [(1, 4, 4096, 16, 128, "realistic"),
                                              (1, 4, 4000, 16, 128, "realistic"),
                                              (1, 2, 200, 8, 64, "denominator"),
                                              (2, 2, 97, 16, 32, "realistic"),
                                              (1, 4, 100, 16, 128, "realistic"),
                                              (2, 4, 6144, 16, 128, "realistic"),
                                              (1, 4, 32768, 8, 128, "realistic"),
                                              (1, 4, 49152, 8, 128, "realistic")])
def test_states_and_backward_kernels_match_twins(dev, B, NH, S, DH, L, case):
    prepared = mlstm_cuda.prepare(*_inputs(dev, B, NH, S, DH, case=case), L)
    states = mlstm_cuda.run_states_kernel(*prepared, dh=DH)
    states_ref = mlstm_cuda.mlstm_forward_states_reference(*prepared, dh=DH)
    for got, want in zip(states, states_ref):
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= 2e-5
    # the entry offsets m* are formed by the same fp32 operations
    assert torch.equal(states[3], states_ref[3])
    g = torch.randn_like(prepared[0])
    args = (*prepared[:3], g, *prepared[3:], *states_ref[1:])
    grads = mlstm_cuda.run_bwd_kernel(*args, dh=DH)
    grads_ref = mlstm_cuda.mlstm_backward_reference(*args, dh=DH)
    torch.cuda.synchronize()
    for got, want in zip(grads, grads_ref):
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= 1e-4


@pytest.mark.parametrize("case", ["wide_igate", "deep_forget", "underflow", "padding_tail"])
@pytest.mark.parametrize("B,NH,S,DH", [(1, 4, 4096, 16), (1, 4, 32768, 8), (2, 4, 4096, 128)])
def test_kernels_at_trained_gate_regimes(dev, B, NH, S, DH, case):
    """The three kernels against their twins on the gate regimes trained
    weights reach (tests/test_torch_mlstm.py's cases for the plain scan), at
    the flagship's, the ViL decoder's and the wide path's widths, at
    chip_smoke.py's bounds; the padded tail ends inside a chunk. Under
    underflow dax's exact value is 0 (h does not depend on the
    stabilisers), so it is held at the scale of the gate gradients, the
    larger of max|dax| and max|ds|, as chip_smoke.py phase 3 holds it."""
    if case == "padding_tail":
        S -= 96 if S == 4096 else 68
    raw = _inputs(dev, B, NH, S, DH, seed=3, case=case)
    prepared = mlstm_cuda.prepare(*raw, 128)
    out = mlstm_cuda.run_kernel(*prepared, dh=DH, seq_len=S)
    states = mlstm_cuda.run_states_kernel(*prepared, dh=DH, seq_len=S)
    states_ref = mlstm_cuda.mlstm_forward_states_reference(*prepared, dh=DH)
    g = torch.randn_like(prepared[0])
    g[..., DH:] = 0.0
    g.view(-1, g.shape[-2], g.shape[-1])[:, S:] = 0.0
    args = (*prepared[:3], g, *prepared[3:], *states_ref[1:])
    grads = mlstm_cuda.run_bwd_kernel(*args, dh=DH, seq_len=S)
    grads_ref = mlstm_cuda.mlstm_backward_reference(*args, dh=DH)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in (out, *states, *grads))
    assert torch.equal(states[3], states_ref[3])
    assert float((out - states_ref[0]).abs().max()) <= 5e-4
    assert _scaled_err(out, states_ref[0]) <= 2e-5
    for got, want in zip(states[:3], states_ref[:3]):
        assert _scaled_err(got, want) <= 2e-5
    for got, want in zip(grads[:4], grads_ref[:4]):
        assert _scaled_err(got, want) <= 1e-4
    dax_scale = max(float(grads_ref[4].abs().max()),
                    float(grads_ref[3].abs().max()) if case == "underflow" else 0.0)
    assert float((grads[4] - grads_ref[4]).abs().max()) <= 1e-4 * dax_scale


@pytest.mark.parametrize("S,DH", [(4096, 16), (32768, 8), (49152, 8)])
def test_narrow_kernels_are_deterministic(dev, S, DH):
    """Two calls of each narrow kernel on the same inputs give the same bits:
    every sum runs in one block in a fixed order, no atomics."""
    prepared = mlstm_cuda.prepare(*_inputs(dev, 1, 4, S, DH, seed=5), 128)
    first = mlstm_cuda.run_states_kernel(*prepared, dh=DH)
    h = mlstm_cuda.run_kernel(*prepared, dh=DH)
    g = torch.randn_like(prepared[0])
    args = (*prepared[:3], g, *prepared[3:], *first[1:])
    grads = mlstm_cuda.run_bwd_kernel(*args, dh=DH)
    again = (mlstm_cuda.run_kernel(*prepared, dh=DH),
             *mlstm_cuda.run_states_kernel(*prepared, dh=DH),
             *mlstm_cuda.run_bwd_kernel(*args, dh=DH))
    for got, want in zip(again, (h, *first, *grads)):
        assert torch.equal(got, want)


# the wide path's edges: a last chunk whose true rows end inside a row tile
# (S 200: 72 rows, S 129: 1 row), one chunk of 65 rows (a row tile and one
# row), DH 512, B*NH 1 at DH 384 (a grid below one wave), the e^{-m} branch
# at DH 384
WIDE_EDGES = [(1, 4, 200, 64, 128, "realistic"), (1, 4, 129, 64, 128, "realistic"),
              (1, 4, 200, 160, 128, "realistic"), (1, 4, 129, 160, 128, "realistic"),
              (1, 4, 65, 96, 128, "realistic"), (1, 2, 200, 512, 128, "realistic"),
              (1, 1, 196, 384, 128, "realistic"), (1, 4, 196, 384, 128, "denominator")]


# the wide path at the xLSTM families' shapes (UXlstmEnc 3-D at batch 2,
# stages 3 / 4 / 5; VisionLSTM3D; a ViT-B-wide VisionLSTM; the 2-D stage 6's
# DH 15; the bottlenecks, one chunk with S < L), an odd width, the e^{-m}
# branch and the edges above
@pytest.mark.parametrize("B,NH,S,DH,L,case", [(2, 4, 4096, 128, 128, "realistic"),
                                              (2, 4, 512, 160, 128, "realistic"),
                                              (2, 4, 320, 32, 128, "realistic"),
                                              (1, 4, 4096, 96, 128, "realistic"),
                                              (1, 4, 196, 384, 128, "realistic"),
                                              (2, 2, 512, 15, 128, "realistic"),
                                              (1, 4, 1000, 45, 128, "realistic"),
                                              (2, 4, 64, 160, 128, "realistic"),
                                              (2, 4, 15, 256, 128, "realistic"),
                                              (1, 2, 300, 33, 64, "denominator"),
                                              (1, 4, 200, 6, 32, "realistic"),
                                              *WIDE_EDGES])
def test_kernels_match_twins_at_every_head_width(dev, B, NH, S, DH, L, case):
    prepared = mlstm_cuda.prepare(*_inputs(dev, B, NH, S, DH, case=case), L)
    DP = prepared[0].shape[-1]
    assert DP == mlstm_cuda.padded_width(DH)
    out = mlstm_cuda.run_kernel(*prepared, dh=DH)
    states = mlstm_cuda.run_states_kernel(*prepared, dh=DH)
    states_ref = mlstm_cuda.mlstm_forward_states_reference(*prepared, dh=DH)
    torch.cuda.synchronize()
    assert torch.equal(out, states[0])
    err = float((out - states_ref[0]).abs().max())
    assert err <= 5e-4 and _scaled_err(out, states_ref[0]) <= 2e-5   # as chip_smoke.py
    assert torch.count_nonzero(out[..., DH:]) == 0
    for got, want in zip(states[1:3], states_ref[1:3]):
        assert _scaled_err(got, want) <= 2e-5
    assert torch.equal(states[3], states_ref[3])
    g = torch.randn_like(prepared[0])
    g[..., DH:] = 0.0
    args = (*prepared[:3], g, *prepared[3:], *states_ref[1:])
    grads = mlstm_cuda.run_bwd_kernel(*args, dh=DH)
    grads_ref = mlstm_cuda.mlstm_backward_reference(*args, dh=DH)
    torch.cuda.synchronize()
    for got, want in zip(grads, grads_ref):
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= 1e-4


@pytest.mark.parametrize("B,NH,S,DH,L,case", WIDE_EDGES)
def test_wide_kernels_at_the_true_length(dev, B, NH, S, DH, L, case):
    """With the true length (as mlstm_forward and mlstm_backward pass it) the
    wide kernels skip the last chunk's padding and write it as zeros: held
    to the twins (the cotangent zero past S, as mlstm_backward pads it), h
    on the true rows bit for bit the all-rows call's."""
    prepared = mlstm_cuda.prepare(*_inputs(dev, B, NH, S, DH, case=case), L)
    BH, Sp, DP = prepared[0].shape
    states = mlstm_cuda.run_states_kernel(*prepared, dh=DH, seq_len=S)
    states_ref = mlstm_cuda.mlstm_forward_states_reference(*prepared, dh=DH)
    out = mlstm_cuda.run_kernel(*prepared, dh=DH, seq_len=S)
    every_row = mlstm_cuda.run_kernel(*prepared, dh=DH)
    torch.cuda.synchronize()
    assert torch.equal(out, states[0])
    assert torch.equal(out[:, :S], every_row[:, :S])
    assert torch.count_nonzero(out[:, S:]) == 0
    err = float((out - states_ref[0]).abs().max())
    assert err <= 5e-4 and _scaled_err(out, states_ref[0]) <= 2e-5   # as chip_smoke.py
    for got, want in zip(states[1:3], states_ref[1:3]):
        assert _scaled_err(got, want) <= 2e-5
    assert torch.equal(states[3], states_ref[3])
    g = torch.randn_like(prepared[0])
    g[..., DH:] = 0.0
    g[:, S:] = 0.0
    args = (*prepared[:3], g, *prepared[3:], *states_ref[1:])
    grads = mlstm_cuda.run_bwd_kernel(*args, dh=DH, seq_len=S)
    grads_ref = mlstm_cuda.mlstm_backward_reference(*args, dh=DH)
    torch.cuda.synchronize()
    for got, want in zip(grads, grads_ref):
        assert torch.isfinite(got).all()
        assert _scaled_err(got, want) <= 1e-4
    for got in grads[:3]:
        assert torch.count_nonzero(got[:, S:]) == 0


@pytest.mark.parametrize("DH", [45, 128])
def test_wide_gradients_match_autograd_through_scan(dev, DH):
    inputs = _inputs(dev, 1, 4, 300, DH, seed=4)
    w = torch.randn(1, 4, 300, DH, generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    (w * torch.tanh(mlstm_cuda.mlstm_forward(*leaves))).sum().backward()
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    (w * torch.tanh(mlstm_chunkwise(*ref_leaves))).sum().backward()
    for got, want in zip(leaves, ref_leaves):
        assert got.grad.shape == want.grad.shape
        assert _scaled_err(got.grad, want.grad) <= 1e-3


@pytest.mark.parametrize("S,bwd_mode", [(300, "fused"), (300, "scan"), (2000, "fused")])
def test_mlstm_forward_gradients_match_autograd_through_scan(dev, S, bwd_mode):
    inputs = _inputs(dev, 1, 4, S, 16, seed=2)
    w = torch.randn(1, 4, S, 16, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    counts = (mlstm_cuda.run_states_kernel.launches, mlstm_cuda.run_bwd_kernel.launches)
    (w * torch.tanh(mlstm_cuda.mlstm_forward(*leaves, bwd_mode=bwd_mode))).sum().backward()
    launched = (mlstm_cuda.run_states_kernel.launches - counts[0],
                mlstm_cuda.run_bwd_kernel.launches - counts[1])
    assert launched == ((1, 1) if bwd_mode == "fused" else (0, 0))
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    (w * torch.tanh(mlstm_chunkwise(*ref_leaves))).sum().backward()
    for got, want in zip(leaves, ref_leaves):
        assert torch.isfinite(got.grad).all()
        assert _scaled_err(got.grad, want.grad) <= 1e-3


@pytest.mark.parametrize("name", ["uxlstm_enc_3d", "uxlstm_bot_2d", "vision_lstm3d",
                                  "vil3d_patch_encoder"])
def test_xlstm_models_kernel_path_matches_plain_path(dev, name):
    from xlstm_hved_torch.models import UXlstmBot, UXlstmEnc
    from xlstm_hved_torch.models.vision_lstm import ViL3DPatchEncoder, VisionLSTM3D

    builds = {
        "uxlstm_enc_3d": (lambda k: UXlstmEnc((32, 32, 32), 4, (8, 16, 32, 64, 64), 4,
                                              strides=(1, 2, 2, 2, 2), deep_supervision=True,
                                              mlstm_kernel=k), (2, 4, 32, 32, 32), 2),
        "uxlstm_bot_2d": (lambda k: UXlstmBot((48, 40), 4, (8, 16, 32, 64), 4,
                                              strides=(1, 2, 2, 2), deep_supervision=True,
                                              mlstm_kernel=k), (2, 4, 48, 40), 1),
        "vision_lstm3d": (lambda k: VisionLSTM3D(dim=64, depth=2, patch_size=8,
                                                 img_size=(64, 64, 64), mlstm_kernel=k),
                          (1, 4, 64, 64, 64), 2),
        "vil3d_patch_encoder": (lambda k: ViL3DPatchEncoder(dims=(16, 32, 64),
                                                            depths=(1, 1, 1), mlstm_kernel=k),
                                (1, 4, 64, 64, 64), 3),
    }
    build, shape, vil_layers = builds[name]
    torch.manual_seed(0)
    model = build(None).to(dev).eval()
    plain = build(False).to(dev).eval()
    plain.load_state_dict(model.state_dict())
    x = torch.rand(*shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    before = mlstm_cuda.run_kernel.launches
    with torch.no_grad():
        out, ref = model(x), plain(x)
    assert mlstm_cuda.run_kernel.launches - before == vil_layers
    out = out if isinstance(out, (list, tuple)) else [out]
    ref = ref if isinstance(ref, (list, tuple)) else [ref]
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        assert float((o - r).abs().max()) <= 1e-3   # phase 4's bound, as chip_smoke.py


def test_model_kernel_path_matches_plain_path(dev):
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=3)
    plain = find_model_using_name("XLSTM_HVED", device=dev, seed=3, mlstm_kernel=False)
    plain.load_state_dict(model.state_dict())
    x = torch.rand(1, 4, 32, 32, 32, generator=torch.Generator(device=dev).manual_seed(2),
                   device=dev)
    before = mlstm_cuda.run_kernel.launches
    with torch.inference_mode():
        out = model(x, recon=True, deterministic=True)
        assert mlstm_cuda.run_kernel.launches == before + 1
        ref = plain(x, recon=True, deterministic=True)
    assert float((out.seg - ref.seg).abs().max()) <= 1e-3
    assert float((out.recon - ref.recon).abs().max()) <= 3.5e-3


def test_train_step_goes_through_the_kernels(dev):
    cfg = TrainConfig(crop_size=(32, 32, 32))
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=4)
    disc = Discriminator(f_maps=8, kernel=3)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(1, 4, 32, 32, 32, generator=gen, device=dev)
    mask = (torch.rand(1, 3, 32, 32, 32, generator=gen, device=dev) > 0.7).float()
    state = create_train_state(model, disc, cfg, 0, x, init_scheme="reference")
    step = make_train_step(model, disc, cfg)
    counters = (mlstm_cuda.run_kernel, mlstm_cuda.run_states_kernel, mlstm_cuda.run_bwd_kernel)
    before = [fn.launches for fn in counters]
    state, metrics = step(state, x, mask)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 2, 2]
    assert state.step == 1
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())


def test_pretrain_step_through_the_kernels_matches_plain(dev):
    """The pretrain objective's gradients through the kernels against those
    through the plain mLSTM, per tensor max|d| <= 5e-3 * max|ref| + 3e-4 *
    the largest gradient (a third of chip_smoke.py phase 6's bound), then
    one whole pretrain step: 1/1/1 launches and the seg decoders frozen."""
    cfg = TrainConfig(crop_size=(32, 32, 32))
    name = "U_HVEDDuSFEmViLDFNet3D"
    model = find_model_using_name(name, device=dev, seed=6, shared_recon=False)
    x = torch.rand(1, 4, 32, 32, 32, generator=torch.Generator(device=dev).manual_seed(7),
                   device=dev)
    state = create_train_state(model, Discriminator(f_maps=8, kernel=3), cfg, 0, x,
                               init_scheme="reference")
    plain = find_model_using_name(name, device=dev, seed=6, shared_recon=False,
                                  mlstm_kernel=False)
    plain.load_state_dict(model.state_dict())
    keep = subset_mask(6, dev)
    grads = []
    torch.backends.cudnn.deterministic = True
    try:
        for m in (model, plain):
            loss, _ = pretrain_objective(m, cfg)(x, keep, deterministic=True)
            names, params = zip(*m.named_parameters())
            got = torch.autograd.grad(loss, params, allow_unused=True)
            grads.append({n: g for n, g in zip(names, got) if g is not None})
    finally:
        torch.backends.cudnn.deterministic = False
    got, want = grads
    assert set(got) == set(want) and "mvil.vil.layer.mlstm_cell.igate.weight" in got
    floor = 3e-4 * max(float(g.abs().max()) for g in want.values())
    for n, ref in want.items():
        assert torch.isfinite(got[n]).all(), n
        assert float((got[n] - ref).abs().max()) <= 5e-3 * float(ref.abs().max()) + floor, n

    freeze = freeze_mask_for(model, ("sdecoder",))
    step = make_pretrain_step(model, cfg, freeze_mask=freeze)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    counters = (mlstm_cuda.run_kernel, mlstm_cuda.run_states_kernel, mlstm_cuda.run_bwd_kernel)
    counts = [fn.launches for fn in counters]
    state, metrics = step(state, x)
    torch.cuda.synchronize()
    assert [fn.launches - c for fn, c in zip(counters, counts)] == [1, 1, 1]
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    assert all(torch.equal(p, before[n]) for n, p in model.named_parameters()
               if freeze[n] == 0.0)


@pytest.mark.parametrize("name", ["XLSTM_HVED", "U_HVEDConvXLSTMNet3D"])
def test_hoisted_sweep_matches_plain_sweep(dev, name):
    """Level-0 hoist (skip-return) and the full-encoder hoist, two windows
    along D, within chip_smoke.py's forward bounds; 15 mlstm_fwd launches per
    window in both sweeps."""
    model = find_model_using_name(name, device=dev, seed=5)
    x = torch.rand(1, 4, 48, 32, 32, generator=torch.Generator(device=dev).manual_seed(6),
                   device=dev)
    patch = (32, 32, 32)
    before = mlstm_cuda.run_kernel.launches
    seg_h, rec_h = make_hoisted_subset_sweep(model, patch, recon_channels=4)(model, x)
    torch.cuda.synchronize()
    assert mlstm_cuda.run_kernel.launches - before == 2 * 15
    seg_p, rec_p = make_subset_sweep(default_apply_fn(model, recon=True), patch,
                                     recon_channels=4)(model, x)
    assert seg_h.shape == (15, 1, 3, 48, 32, 32) and torch.isfinite(rec_h).all()
    assert float((seg_h - seg_p).abs().max()) <= 1e-3
    assert float((rec_h - rec_p).abs().max()) <= 3.5e-3


@pytest.mark.parametrize("name", ["XLSTM_HVED", "U_HVEDConvXLSTMNet3D"])
def test_hoisted_sweep_equals_plain_sweep_in_bf16(dev, name):
    """At bf16 compute (the eval CLI's default) the hoisted sweep equals the
    plain one bit for bit, as in fp32: the grouped convs compute a kept
    stream from its own channels, the product of experts weights a dropped
    expert by an exact 0."""
    model = find_model_using_name(name, device=dev, seed=5, compute_dtype="bfloat16")
    x = torch.rand(1, 4, 48, 32, 32, generator=torch.Generator(device=dev).manual_seed(6),
                   device=dev)
    patch = (32, 32, 32)
    seg_h, rec_h = make_hoisted_subset_sweep(model, patch, recon_channels=4)(model, x)
    seg_p, rec_p = make_subset_sweep(default_apply_fn(model, recon=True), patch,
                                     recon_channels=4)(model, x)
    assert seg_h.dtype == torch.float32 and torch.isfinite(rec_h).all()
    assert torch.equal(seg_h, seg_p), float((seg_h - seg_p).abs().max())
    assert torch.equal(rec_h, rec_p), float((rec_h - rec_p).abs().max())


def test_bf16_forward_and_step_reach_the_kernels_in_fp32(dev):
    """bf16 compute (G and D): the forward and a train step run the CUDA
    kernels (1 launch per forward, 2/2/2 per step), and the mLSTM cell
    receives fp32 (the kernels' wrapper refuses anything else)."""
    cfg = TrainConfig(crop_size=(32, 32, 32))
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=8, compute_dtype="bfloat16")
    disc = Discriminator(f_maps=8, kernel=3, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand(1, 4, 32, 32, 32, generator=gen, device=dev)
    mask = (torch.rand(1, 3, 32, 32, 32, generator=gen, device=dev) > 0.7).float()
    state = create_train_state(model, disc, cfg, 0, x, init_scheme="reference")
    seen = set()
    model.mvil.vil.layer.mlstm_cell.register_forward_pre_hook(
        lambda mod, args: seen.update(a.dtype for a in args))
    counters = (mlstm_cuda.run_kernel, mlstm_cuda.run_states_kernel, mlstm_cuda.run_bwd_kernel)
    before = [fn.launches for fn in counters]
    with torch.inference_mode():
        out = model.eval()(x, recon=True, deterministic=True)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 0, 0]
    assert out.seg.dtype == torch.float32 and torch.isfinite(out.recon).all()
    before = [fn.launches for fn in counters]
    state, metrics = make_train_step(model, disc, cfg)(state, x, mask)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 2, 2]
    assert seen == {torch.float32}
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_gradients_match_on_the_card(dev, dtype):
    """remat against the same G objective without it, bitwise: cuDNN
    deterministic and the upsampling's backward without atomics
    (chip_smoke.deterministic_upsampling), the plain call run twice to show
    that the comparison is deterministic; and the same 2/2/2 launches."""
    from chip_smoke import deterministic_upsampling

    cfg = TrainConfig(crop_size=(32, 32, 32))
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=10, compute_dtype=dtype)
    remat = find_model_using_name("XLSTM_HVED", device=dev, compute_dtype=dtype, remat=True)
    disc = Discriminator(f_maps=8, kernel=3, dtype=model.dtype)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand(1, 4, 32, 32, 32, generator=gen, device=dev)
    mask = (torch.rand(1, 3, 32, 32, 32, generator=gen, device=dev) > 0.7).float()
    create_train_state(model, disc, cfg, 0, x, init_scheme="reference")
    remat.load_state_dict(model.state_dict())
    counters = (mlstm_cuda.run_kernel, mlstm_cuda.run_states_kernel, mlstm_cuda.run_bwd_kernel)
    grads = []
    torch.backends.cudnn.deterministic = True
    try:
        with deterministic_upsampling():
            for m in (model, model, remat):
                before = [fn.launches for fn in counters]
                _, g = make_grad_fn(m, disc, cfg)(x, mask, subset_mask(6, dev),
                                                  deterministic=True)
                torch.cuda.synchronize()
                assert [fn.launches - b for fn, b in zip(counters, before)] == [2, 2, 2]
                grads.append(g)
    finally:
        torch.backends.cudnn.deterministic = False
    g_a, g_b, g_r = grads
    assert [n for n in g_a if not torch.equal(g_b[n], g_a[n])] == []
    assert [n for n in g_a if not torch.equal(g_r[n], g_a[n])] == []


def test_bf16_g_gradient_matches_jax_on_the_card(dev):
    """The bf16 G gradient at 16^3 through the kernels against JAX's bf16 G
    gradient on the same weights and input (chip_smoke.py phase 9's check):
    their distance at most GRAD_SHARE of JAX's bf16-vs-fp32 distance."""
    import numpy as np
    from chip_smoke import (GRAD_SHARE, PRECISION_KEEP, bf16_gradient_share,
                            precision_g_inputs, precision_ref)

    ref = precision_ref()
    model = find_model_using_name("XLSTM_HVED", device=dev, compute_dtype="bfloat16")
    model.load_state_dict(ref["g_weights"], strict=True)
    disc = Discriminator(f_maps=8, kernel=3, dtype=torch.bfloat16)
    disc.load_state_dict(ref["d_weights"], strict=True)
    x, mask = (torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(dev)
               for a in precision_g_inputs())
    before = mlstm_cuda.run_bwd_kernel.launches
    _, g = make_grad_fn(model, disc.to(dev), TrainConfig(crop_size=(16, 16, 16)))(
        x, mask, torch.tensor(PRECISION_KEEP, device=dev), deterministic=True)
    assert mlstm_cuda.run_bwd_kernel.launches - before == 2
    share = bf16_gradient_share({n: t.double().cpu().numpy() for n, t in g.items()}, ref)
    assert share <= GRAD_SHARE, share


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_u_hvednet_hoisted_sweep_equals_plain_sweep(dev, dtype):
    """U_HVEDNet3D has no skip-return: every level is hoisted, and the
    hoisted sweep equals the plain one bit for bit in fp32 and bf16; no
    mLSTM launch (the preset has no ViL)."""
    model = find_model_using_name("U_HVEDNet3D", device=dev, seed=5, compute_dtype=dtype)
    x = torch.rand(1, 4, 48, 32, 32, generator=torch.Generator(device=dev).manual_seed(6),
                   device=dev)
    patch = (32, 32, 32)
    before = mlstm_cuda.run_kernel.launches
    seg_h, rec_h = make_hoisted_subset_sweep(model, patch, recon_channels=4)(model, x)
    seg_p, rec_p = make_subset_sweep(default_apply_fn(model, recon=True), patch,
                                     recon_channels=4)(model, x)
    torch.cuda.synchronize()
    assert mlstm_cuda.run_kernel.launches == before
    assert seg_h.shape == (15, 1, 3, 48, 32, 32) and torch.isfinite(rec_h).all()
    assert torch.equal(seg_h, seg_p), float((seg_h - seg_p).abs().max())
    assert torch.equal(rec_h, rec_p), float((rec_h - rec_p).abs().max())


def test_native_decoder_equals_the_python_reader_on_the_card_machine(dev, tmp_path):
    """The native decoder, built there with that machine's g++ and zlib,
    against the Python reader on synthetic subjects, bit for bit."""
    import os

    import numpy as np
    from xlstm_hved_torch.data import native
    from xlstm_hved_torch.data.nifti import read_nifti
    from xlstm_hved_torch.data.synthetic import write_synthetic_dataset

    root = write_synthetic_dataset(str(tmp_path), 2, (40, 36, 24), seed=3)
    suffixes = ("t1c", "t1n", "t2f", "t2w")
    for subject in ("SYN-0000", "SYN-0001"):
        got = native.native_read_subject(root, subject, suffixes)
        want = np.stack([read_nifti(os.path.join(root, subject, f"{subject}-{s}.nii.gz"))[0]
                         for s in suffixes])
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        seg = os.path.join(root, subject, f"{subject}-seg.nii.gz")
        np.testing.assert_array_equal(native.native_read_nifti(seg), read_nifti(seg)[0])


def test_find_maximum_patch_size_returns_a_listed_shape(dev):
    from xlstm_hved_torch.utils.schedules import DEFAULT_PATCH_SHAPES, find_maximum_patch_size

    model = find_model_using_name("XLSTM_HVED", device=dev, seed=0)

    @torch.inference_mode()
    def forward(x):
        return model(x, recon=True, deterministic=True)

    assert find_maximum_patch_size(forward, device=dev) in DEFAULT_PATCH_SHAPES


# ---------------------------------------------------------------- the RSM gate conv

# (batch, in, out, D, H, W): the seg decoder stages 0-2 at the 128x192x128
# crop (the enc gate 4 -> 1, the seg gate 2 -> 1), ragged sizes (a width
# that is no multiple of 8 stores value by value), batch 2, AttenModule's
# 10 -> 4 and the widest the kernel takes
GATE_SHAPES = [(1, 4, 1, 128, 192, 128), (1, 2, 1, 128, 192, 128), (1, 4, 1, 64, 96, 64),
               (1, 2, 1, 64, 96, 64), (1, 4, 1, 32, 48, 32), (1, 2, 1, 32, 48, 32),
               (2, 4, 1, 9, 13, 11), (1, 2, 1, 37, 21, 45), (1, 10, 4, 20, 24, 40),
               (1, 16, 3, 8, 8, 64)]
# unit roundoff of the output and of the sums (bf16 operands sum in fp32)
GATE_UNITS = {torch.bfloat16: (2.0 ** -8, 2.0 ** -24), torch.float32: (2.0 ** -24, 2.0 ** -24),
              torch.float64: (2.0 ** -53, 2.0 ** -53)}


def _gate_operands(dev, n, cin, cout, shape, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(n, cin, *shape, generator=g, device=dev).to(dtype)
    w = (0.05 * torch.randn(cout, cin, 7, 7, 7, generator=g, device=dev)).to(dtype)
    b = (0.1 * torch.randn(cout, generator=g, device=dev)).to(dtype)
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("n,cin,cout,D,H,W", GATE_SHAPES)
def test_gate_kernel_matches_twin(dev, n, cin, cout, D, H, W, dtype):
    """The kernel against the twin's conv in fp64 on the same operands, at
    each output within the rounding of the output type plus the error of a
    sum of n = C 343 + 1 terms in the accumulation type, n u sum|terms|
    (fp32 sums for bf16 operands; the fp64 reference's own error beside)."""
    import torch.nn.functional as F
    from xlstm_hved_torch.ops import gate_cuda

    x, w, b = _gate_operands(dev, n, cin, cout, (D, H, W), dtype)
    with torch.inference_mode():
        out = gate_cuda.run_gate_kernel(x, w, b)
        ref = gate_cuda.gate_conv_reference(x.double(), w.double(), b.double())
        mag = F.conv3d(x.double().abs(), w.double().abs(), b.double().abs(), padding=3)
    assert out.dtype == dtype and out.shape == (n, cout, D, H, W)
    unit, sum_unit = GATE_UNITS[dtype]
    bound = unit * ref.abs() + (2 * sum_unit + 2.0 ** -53) * (cin * 343 + 1) * mag
    assert bool(((out.double() - ref).abs() <= bound).all()), float(
        ((out.double() - ref).abs() / bound).max())


def test_gate_kernel_is_deterministic_and_batch_independent(dev):
    from xlstm_hved_torch.ops import gate_cuda

    x, w, b = _gate_operands(dev, 2, 4, 1, (128, 192, 128), torch.bfloat16, seed=1)
    with torch.inference_mode():
        first = gate_cuda.run_gate_kernel(x, w, b)
        assert torch.equal(first, gate_cuda.run_gate_kernel(x, w, b))
        assert torch.equal(first[1:], gate_cuda.run_gate_kernel(x[1:], w, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_gate_function_gradients_equal_autograd_through_conv3d(dev, dtype):
    """GateConvFunction's backward is the library call's: for one upstream
    gradient its input, weight and bias gradients are bit for bit those of
    autograd through F.conv3d (cuDNN deterministic for both)."""
    import torch.nn.functional as F
    from xlstm_hved_torch.ops import gate_cuda

    x, w, b = _gate_operands(dev, 1, 4, 1, (64, 96, 64), dtype, seed=2)
    g = torch.randn(1, 1, 64, 96, 64, generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev).to(dtype)
    grads = []
    torch.backends.cudnn.deterministic = True
    try:
        for fn in (gate_cuda.gate_conv, lambda *t: F.conv3d(*t, padding=3)):
            leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
            grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    finally:
        torch.backends.cudnn.deterministic = False
    for got, want in zip(*grads):
        assert torch.equal(got, want), float((got - want).abs().max())


def test_a_hoisted_sweep_and_a_step_launch_the_gate_kernel(dev):
    """90 launches over one hoisted 15-subset sweep of U_HVEDConvXLSTMNet3D
    (two gates in each of the seg decoder's three AttenModule2 joins), 12
    over a flagship train step (its two G forwards)."""
    from xlstm_hved_torch.ops import gate_cuda

    model = find_model_using_name("U_HVEDConvXLSTMNet3D", device=dev, seed=5,
                                  compute_dtype="bfloat16").eval()
    x = torch.rand(1, 4, 32, 48, 32, generator=torch.Generator(device=dev).manual_seed(6),
                   device=dev)
    sweep = make_hoisted_subset_sweep(model, (32, 48, 32), recon_channels=4)
    before = gate_cuda.run_gate_kernel.launches
    sweep(model, x)
    assert gate_cuda.run_gate_kernel.launches - before == 90

    cfg = TrainConfig(crop_size=(32, 32, 32))
    model = find_model_using_name("XLSTM_HVED", device=dev, seed=4, compute_dtype="bfloat16")
    disc = Discriminator(f_maps=8, kernel=3)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand(1, 4, 32, 32, 32, generator=gen, device=dev)
    mask = (torch.rand(1, 3, 32, 32, 32, generator=gen, device=dev) > 0.7).float()
    state = create_train_state(model, disc, cfg, 0, x, init_scheme="reference")
    step = make_train_step(model, disc, cfg)
    before = gate_cuda.run_gate_kernel.launches
    state, metrics = step(state, x, mask)
    torch.cuda.synchronize()
    assert gate_cuda.run_gate_kernel.launches - before == 12
    assert all(torch.isfinite(torch.as_tensor(float(v))) for v in metrics.values())


@pytest.mark.parametrize("S,DH", [(4096, 128), (512, 160), (320, 32)])
def test_wide_kernels_at_the_uxlstm_sites(dev, S, DH):
    """The three ViL mixers of UXlstmEnc 3-D at nnU-Net's BraTS plan, batch
    2: the forward, and the states-saving forward and backward the gradient
    runs, against autograd through the plain scan, at the bound of
    test_wide_gradients_match_autograd_through_scan."""
    inputs = _inputs(dev, 2, 4, S, DH, seed=6)
    w = torch.randn(2, 4, S, DH, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    counts = (mlstm_cuda.run_states_kernel.launches, mlstm_cuda.run_bwd_kernel.launches)
    out = mlstm_cuda.mlstm_forward(*leaves)
    (w * torch.tanh(out)).sum().backward()
    assert (mlstm_cuda.run_states_kernel.launches - counts[0],
            mlstm_cuda.run_bwd_kernel.launches - counts[1]) == (1, 1)
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref = mlstm_chunkwise(*ref_leaves)
    (w * torch.tanh(ref)).sum().backward()
    assert _scaled_err(out.detach(), ref.detach()) <= 1e-3
    for got, want in zip(leaves, ref_leaves):
        assert torch.isfinite(got.grad).all()
        assert _scaled_err(got.grad, want.grad) <= 1e-3


UXLSTM_SMALL_PLAN = {"patch_size": [32, 32, 32], "conv_kernel_sizes": [[3, 3, 3]] * 5,
                     "pool_op_kernel_sizes": [[1, 1, 1]] + [[2, 2, 2]] * 4,
                     "n_conv_per_stage_encoder": [2] * 5, "n_conv_per_stage_decoder": [2] * 4,
                     "UNet_base_num_features": 4, "unet_max_num_features": 64}


def test_ds_train_step_on_the_card_matches_the_cpu(dev):
    """Two fp32 steps of `engine/seg_train.py` on UXlstmEnc 3-D at a small
    plan (a patch-token and a channel-token ViL), on the card (cuDNN, the
    mLSTM kernels) and on the CPU (the plain scan), from the same weights:
    both losses within 1e-4 and the parameters' change over the two steps
    within 0.2 (relative L2), the fp32 bounds of
    tests/test_torch_uxlstm_train.py (this net's fp32 gradient is
    ill-conditioned at random weights); each step launches the forward,
    states and backward kernels once per ViL mixer."""
    import copy
    import math

    from xlstm_hved_torch.engine import seg_train as st
    from xlstm_hved_torch.models import build_uxlstm_from_plans

    torch.manual_seed(0)
    net = build_uxlstm_from_plans(UXLSTM_SMALL_PLAN, 4, 3, True)
    w0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    scales = st.deep_supervision_scales(UXLSTM_SMALL_PLAN["pool_op_kernel_sizes"])
    g = torch.Generator().manual_seed(1)
    batches = []
    for _ in range(2):
        x = torch.rand(2, 4, 32, 32, 32, generator=g)
        field = torch.rand(2, 1, 32, 32, 32, generator=g)
        batches.append((x, torch.cat([field < 0.6, field < 0.3, field < 0.1], dim=1).float()))
    runs = {}
    for device in (dev, torch.device("cpu")):
        model = copy.deepcopy(net).to(device)
        cfg = st.SegTrainConfig()
        state = st.SegTrainState(model, st.make_sgd(model.parameters(), cfg))
        step = st.make_ds_train_step(model, cfg)
        before = (mlstm_cuda.run_kernel.launches, mlstm_cuda.run_states_kernel.launches,
                  mlstm_cuda.run_bwd_kernel.launches)
        losses = []
        for x, regions in batches:
            state, loss = step(state, x.to(device),
                               st.deep_supervision_targets(regions.to(device), scales))
            losses.append(float(loss))
        launched = (mlstm_cuda.run_kernel.launches - before[0],
                    mlstm_cuda.run_states_kernel.launches - before[1],
                    mlstm_cuda.run_bwd_kernel.launches - before[2])
        assert launched == ((4, 4, 4) if device.type == "cuda" else (0, 0, 0))
        runs[device.type] = losses, {n: (p.detach().cpu() - w0[n]) for n, p in
                                     model.named_parameters()}
    (card, card_change), (cpu, cpu_change) = runs["cuda"], runs["cpu"]
    for a, b in zip(card, cpu):
        assert abs(a - b) <= 1e-4 * abs(b), (card, cpu)
    num = sum(float((card_change[n] - cpu_change[n]).double().square().sum()) for n in w0)
    den = sum(float(cpu_change[n].double().square().sum()) for n in w0)
    assert math.sqrt(num / den) <= 0.2
