"""PyTorch port: the evaluation entry point end to end on the CPU (the
counterpart of the cli.test cases of tests/test_cli_e2e.py) on a synthetic
BraTS-layout dataset at 16^3.

With a best_dice checkpoint written the way the train CLI writes it, the
summary's Dice equals `dice_region` of the port's hoisted sweep on that
checkpoint's weights exactly, its HD95 equals `hd95_region`, the exported
labels read back through the JAX package's `read_nifti` equal
`label_volume_from_probs` of the sweep's all-modality subset, and three
PNGs are written for the volume."""
import math
import os

import numpy as np
import pytest
import torch

from xlstm_hved_tpu.data.nifti import read_nifti as jax_read_nifti
from xlstm_hved_torch.cli import test as test_cli
from xlstm_hved_torch.cli.common import assemble_eval_batch, base_parser
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.data.brats import BraTSDataset
from xlstm_hved_torch.data.synthetic import write_synthetic_dataset
from xlstm_hved_torch.engine.checkpoint import CheckpointManager
from xlstm_hved_torch.engine.evaluate import label_volume_from_probs, make_hoisted_subset_sweep
from xlstm_hved_torch.engine.train import create_train_state
from xlstm_hved_torch.metrics import dice_region, hd95_region, psnr, ssim3d
from xlstm_hved_torch.models import Discriminator, find_model_using_name

CROP = (16, 16, 16)
# fp32: bf16 on the CPU is slower, and the test that is about the precision
# option (test_eval_cli_precision_and_remat_options_run) sets it
ARGS = ["--device", "cpu", "--crop_size", "16", "16", "16", "--disc_kernel", "3",
        "--disc_fmaps", "8", "--compute_dtype", "float32"]
# the JAX CLI's own flags on top of base_parser, with their defaults
TEST_FLAGS = {"ckpt": "best_dice", "compute_hd95": False, "save_pred_dir": "",
              "eval_recon": False, "save_plots_dir": ""}


@pytest.fixture(scope="module")
def valid_dir(tmp_path_factory):
    return write_synthetic_dataset(str(tmp_path_factory.mktemp("data") / "valid"), 1,
                                   (20, 18, 17), seed=1)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """<out>/XLSTM_HVED/best_dice as the train CLI saves it, from fresh
    weights ("reference" init, seed 3)."""
    out = str(tmp_path_factory.mktemp("results"))
    model = find_model_using_name("XLSTM_HVED", device="cpu", seed=3)
    state = create_train_state(model, Discriminator(f_maps=8, kernel=3),
                               TrainConfig(crop_size=CROP), 3, torch.zeros((1, 4, *CROP)),
                               init_scheme="reference")
    CheckpointManager(os.path.join(out, "XLSTM_HVED")).save_epoch(
        state, 1, 0.5, 0.5, float("inf"), 0.0)
    return out, model.state_dict()


def test_eval_cli_matches_the_hoisted_sweep(valid_dir, checkpoint, tmp_path, capsys):
    out, weights = checkpoint
    pred_dir, plots = str(tmp_path / "preds"), str(tmp_path / "plots")
    summary = test_cli.main(ARGS + ["--valid_dir", valid_dir, "--out_dir", out,
                                    "--compute_hd95", "--eval_recon",
                                    "--save_pred_dir", pred_dir, "--save_plots_dir", plots])
    text = capsys.readouterr().out
    assert "restored checkpoint best_dice" in text
    assert "Dice (WT / TC / ET) per subset" in text
    rows = [line for line in text.splitlines() if line.startswith("subset ")]
    assert len(rows) == 15 and all("HD95" in r and "PSNR" in r and "SSIM" in r for r in rows)
    assert any(line.startswith("average") for line in text.splitlines())
    assert summary["volumes"] == 1 and len(summary["per_volume"]) == 1
    vol = summary["per_volume"][0]
    assert set(vol["spans"]) == set(test_cli.SPANS) and vol["subject"] == "SYN-0000"
    assert sum(vol["spans"].values()) <= vol["seconds"]

    # the same sweep on the checkpoint's weights
    model = find_model_using_name("XLSTM_HVED", device="cpu")
    model.load_state_dict(weights)
    x, _, mask = assemble_eval_batch([BraTSDataset(valid_dir, m_full=True).load(0)], CROP,
                                     "cpu")
    segs, recons = make_hoisted_subset_sweep(model, CROP, CROP, recon_channels=4)(model, x)
    mask_np = mask.numpy()
    for s in range(15):
        for r, region in enumerate(("WT", "TC", "EC")):
            assert summary["dice"][s, r] == dice_region(segs[s], mask, region).item()
            assert summary["hd95"][s, r] == hd95_region(segs[s].numpy(), mask_np, region)
        np.testing.assert_allclose(summary["psnr"][s], psnr(recons[s], x).item(), rtol=1e-6)
        np.testing.assert_allclose(summary["ssim"][s], ssim3d(recons[s], x).item(), rtol=1e-6)
    assert all(math.isfinite(v) for v in np.concatenate(
        [summary["dice"].ravel(), summary["hd95"].ravel(), summary["psnr"], summary["ssim"]]))

    assert os.listdir(pred_dir) == ["SYN-0000-pred.nii.gz"]
    labels, _ = jax_read_nifti(os.path.join(pred_dir, "SYN-0000-pred.nii.gz"))
    want = label_volume_from_probs(segs[14, 0].numpy())
    np.testing.assert_array_equal(labels, want)
    assert set(np.unique(labels)) <= {0, 1, 2, 4}
    assert sorted(os.listdir(plots)) == ["SYN-0000_z12.png", "SYN-0000_z4.png",
                                         "SYN-0000_z8.png"]


def test_eval_cli_without_a_checkpoint(valid_dir, tmp_path, capsys):
    summary = test_cli.main(ARGS + ["--valid_dir", valid_dir, "--out_dir", str(tmp_path)])
    text = capsys.readouterr().out
    assert "WARNING: checkpoint best_dice not found" in text
    assert summary["hd95"] is None and summary["psnr"] is None
    assert summary["dice"].shape == (15, 3)
    assert np.all((summary["dice"] >= 0) & (summary["dice"] <= 1))
    spans = summary["per_volume"][0]["spans"]
    assert spans["hd95"] == spans["recon_metrics"] == spans["export"] == 0.0


def test_eval_parser_adds_the_jax_flags():
    got = vars(test_cli.parser().parse_args([]))
    base = vars(base_parser("port").parse_args([]))
    assert {k: got[k] for k in TEST_FLAGS} == TEST_FLAGS
    assert {k: v for k, v in got.items() if k not in TEST_FLAGS} == base


@pytest.mark.parametrize("extra", [["--distributed"], ["--num_data_devices", "2"]])
def test_eval_cli_unported_options_raise(valid_dir, tmp_path, extra):
    """The evaluation CLI joins no process group, as JAX's does not:
    --distributed runs it as one process; a --num_data_devices other than
    its one process raises, naming torchrun."""
    argv = ARGS + ["--valid_dir", valid_dir, "--out_dir", str(tmp_path)] + extra
    if extra == ["--distributed"]:
        assert test_cli.main(argv)["dice"].shape == (15, 3)
        return
    with pytest.raises(ValueError, match="torchrun"):
        test_cli.main(argv)


@pytest.mark.parametrize("extra,dtype", [(["--compute_dtype", "bfloat16"], "bfloat16"),
                                         (["--remat"], "float32")], ids=["bf16", "remat"])
def test_eval_cli_precision_and_remat_options_run(valid_dir, checkpoint, extra, dtype):
    """The option runs the sweep (remat has nothing to recompute without a
    gradient) on the checkpoint's fp32 parameters; the Dice equal the sweep's
    at the option's compute dtype."""
    out, weights = checkpoint
    summary = test_cli.main(ARGS + ["--valid_dir", valid_dir, "--out_dir", out] + extra)
    assert all(t.dtype in (torch.float32, torch.int64) for t in weights.values())
    model = find_model_using_name("XLSTM_HVED", device="cpu", compute_dtype=dtype)
    model.load_state_dict(weights)
    x, _, mask = assemble_eval_batch([BraTSDataset(valid_dir, m_full=True).load(0)], CROP,
                                     "cpu")
    segs = make_hoisted_subset_sweep(model, CROP, CROP)(model, x)
    for s in (0, 14):
        assert summary["dice"][s, 0] == dice_region(segs[s], mask, "WT").item()
    assert summary["volumes"] == 1 and np.isfinite(summary["dice"]).all()


def test_eval_cli_cuda_request_without_a_card_raises(valid_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_cli.main(["--valid_dir", valid_dir, "--out_dir", str(tmp_path)])
