"""PyTorch port: the evaluation CLI's metrics and plot export against the JAX
package: HD95 (surface points, the empty-set 0 and the sentinel) equal to
JAX's on seeded masks, the batched Dice bitwise the per-region one, and the
PNG overlays' pixels equal to those JAX's `plot_segm` writes through PIL
(which decodes the port's own PNG writer here)."""
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.ndimage import gaussian_filter

from _torch_port import ndhwc
from xlstm_hved_tpu import metrics as jm
from xlstm_hved_tpu.utils import visualize as jvis
from xlstm_hved_torch import metrics as tm
from xlstm_hved_torch.utils import visualize as tvis


def _blob(seed, shape=(20, 18, 16), fraction=0.3):
    """A smooth random mask: low-passed noise above its (1 - fraction)
    quantile."""
    noise = gaussian_filter(np.random.RandomState(seed).randn(*shape), 2.0)
    return noise > np.quantile(noise, 1.0 - fraction)


def test_edge_kernels_are_the_jax_packages():
    for name in ("_SOBEL_X", "_SOBEL_Y", "_SOBEL_Z"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))
    assert tm.HD95_SENTINEL == jm.HD95_SENTINEL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_surface_and_hd95_match_jax(seed):
    """The surface voxels are JAX's surface points; HD95 from the distance
    transform is bitwise JAX's KD-tree HD95 at unit spacing and at a
    spacing whose scaled coordinates are exact, and within a few ulps at an
    inexact one."""
    pred, target = _blob(seed), _blob(seed + 10, fraction=0.2)
    np.testing.assert_array_equal(np.argwhere(tm._surface(pred)).astype(np.float64),
                                  jm._surface_points(pred))
    for sp in ((1.0, 1.0, 1.0), (1.0, 1.5, 2.0)):
        got, want = tm.hd95(pred, target, sp), jm.hd95(pred, target, sp)
        assert got == want and 0.0 < got < jm.HD95_SENTINEL, (got, want)
    sp = (0.9, 1.1, 0.7)
    np.testing.assert_allclose(tm.hd95(pred, target, sp), jm.hd95(pred, target, sp),
                               rtol=1e-14)


@pytest.mark.parametrize("case", ["empty_pred", "empty_target", "both_empty"])
def test_hd95_empty_surface_is_zero(case):
    mask = _blob(3)
    empty = np.zeros_like(mask)
    pred, target = {"empty_pred": (empty, mask), "empty_target": (mask, empty),
                    "both_empty": (empty, empty)}[case]
    assert tm.hd95(pred, target) == jm.hd95(pred, target) == 0.0


def test_hd95_infinite_distance_gives_the_sentinel():
    # a z spacing of 1e200 keeps the points finite, their squared distance not
    a = np.zeros((8, 6, 6), bool)
    b = np.zeros((8, 6, 6), bool)
    a[1:3, 2:4, 2:4] = True
    b[5:7, 2:4, 2:4] = True
    spacing = (1e200, 1.0, 1.0)
    assert tm.hd95(a, b, spacing) == jm.hd95(a, b, spacing) == tm.HD95_SENTINEL


def test_hd95_region_matches_jax():
    """(B, 3, D, H, W) probabilities in the port, (B, D, H, W, 3) in JAX; the
    port takes boolean masks alike, as the CLI passes them."""
    rng = np.random.RandomState(4)
    pred = np.stack([np.stack([gaussian_filter(rng.rand(16, 14, 12), 1.5) for _ in range(3)])
                     for _ in range(2)]).astype(np.float32)
    target = np.stack([np.stack([_blob(20 + 3 * b + c, (16, 14, 12)) for c in range(3)])
                       for b in range(2)]).astype(np.float32)
    pred = (pred - pred.min()) / (pred.max() - pred.min())
    regions = ("WT", "TC", "EC", "ET")
    want = [jm.hd95_region(ndhwc(pred), ndhwc(target), region) for region in regions]
    for region, w in zip(regions, want):
        assert tm.hd95_region(pred, target, region) == w
        assert tm.hd95_region(pred > 0.5, target, region) == w
    # a leading subset axis: each entry is its own hd95_region
    stacked = tm.hd95_regions(np.stack([pred, pred[:, ::-1]]) > 0.5, target)
    assert stacked.shape == (2, 3) and list(stacked[0]) == want[:3]
    assert list(stacked[1]) == [tm.hd95_region(pred[:, ::-1], target, r) for r in regions[:3]]


def test_dice_regions_is_dice_region_bitwise():
    rng = np.random.RandomState(5)
    segs = torch.from_numpy(rng.rand(15, 2, 3, 12, 10, 8).astype(np.float32))
    mask = torch.from_numpy((rng.rand(2, 3, 12, 10, 8) > 0.6).astype(np.float32))
    got = tm.dice_regions(segs, mask)
    assert got.shape == (15, 3)
    for s in range(15):
        for r, region in enumerate(("WT", "TC", "EC")):
            assert got[s, r].item() == tm.dice_region(segs[s], mask, region).item()


def _inputs(seed=6, shape=(4, 12, 20, 16)):
    rng = np.random.RandomState(seed)
    image = (rng.rand(*shape) * 3.0).astype(np.float32)
    pred = gaussian_filter(rng.rand(3, *shape[1:]), 1.0).astype(np.float32)
    pred = (pred - pred.min()) / (pred.max() - pred.min())
    target = (gaussian_filter(rng.rand(3, *shape[1:]), 1.0) > 0.5).astype(np.float32)
    return image, pred, target


def test_overlay_matches_jax():
    image, pred, _ = _inputs()
    np.testing.assert_array_equal(tvis._to_uint8(image[0]), jvis._to_uint8(image[0]))
    np.testing.assert_array_equal(tvis.segmentation_overlay(image[0, 5], pred[:, 5]),
                                  jvis.segmentation_overlay(image[0, 5],
                                                            np.moveaxis(pred[:, 5], 0, -1)))
    assert not tvis._to_uint8(np.full((3, 3), 2.0)).any()


@pytest.mark.parametrize("with_target", [True, False])
def test_plot_segm_pixels_match_jax(tmp_path, with_target):
    image, pred, target = _inputs()
    got = tvis.plot_segm(str(tmp_path / "port"), "SYN-0000", image, pred,
                         target if with_target else None)
    want = jvis.plot_segm(str(tmp_path / "jax"), "SYN-0000", np.moveaxis(image, 0, -1),
                          np.moveaxis(pred, 0, -1),
                          np.moveaxis(target, 0, -1) if with_target else None)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == \
        ["SYN-0000_z3.png", "SYN-0000_z6.png", "SYN-0000_z9.png"]
    for g, w in zip(got, want):
        with Image.open(g) as a, Image.open(w) as b:
            assert a.mode == b.mode == "RGB"
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(Image.open(got[0])).shape == (20, 32 if with_target else 16, 3)


def test_write_png_refuses_other_layouts(tmp_path):
    with pytest.raises(ValueError, match="H, W, 3"):
        tvis.write_png(str(tmp_path / "a.png"), np.zeros((4, 4), np.uint8))
