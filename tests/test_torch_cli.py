"""PyTorch port: the training entry points end to end on the CPU (the
counterpart of tests/test_cli_e2e.py) on a synthetic BraTS-layout dataset at
16^3: train one epoch and resume, pretrain one epoch, train from the
pretrain weights, check; and the argument surface against the JAX
`base_parser`."""
import csv
import math
import os

import pytest
import torch

from xlstm_hved_tpu.cli.common import base_parser as jax_base_parser
from xlstm_hved_torch.cli import check, pretrain, train
from xlstm_hved_torch.cli.common import base_parser
from xlstm_hved_torch.data.synthetic import write_synthetic_dataset
from xlstm_hved_torch.engine.checkpoint import CheckpointManager

SHAPE = (16, 16, 16)
# fp32 for G and D: bf16 on the CPU is slower, and the tests that are about
# the precision options (test_precision_and_remat_options_run) set them
ARGS_COMMON = ["--device", "cpu", "--crop_size", "16", "16", "16", "--num_epochs", "1",
               "--disc_kernel", "3", "--disc_fmaps", "8", "--compute_dtype", "float32",
               "--disc_dtype", "float32"]
# the port's departures from the JAX defaults
PORT_DEFAULTS = {"device": "cuda"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    return (write_synthetic_dataset(str(root / "train"), 2, SHAPE, seed=0),
            write_synthetic_dataset(str(root / "valid"), 1, SHAPE, seed=1))


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _argv(dataset, out_dir):
    return ARGS_COMMON + ["--train_dir", dataset[0], "--valid_dir", dataset[1],
                          "--out_dir", out_dir]


def test_train_cli_one_epoch_and_resume(dataset, tmp_path):
    argv = _argv(dataset, str(tmp_path / "results"))
    summary = train.main(argv)
    model_dir = tmp_path / "results" / "XLSTM_HVED"
    ckpt = CheckpointManager(str(model_dir))
    assert all(ckpt.exists(n) for n in ("latest", "best_vloss", "best_dice"))
    rows = _rows(model_dir / "loss_and_metrics.csv")
    assert len(rows) == 1 and float(rows[0]["Train_Loss"]) > 0
    assert all(math.isfinite(float(v)) for v in rows[0].values())
    assert [e["epoch"] for e in summary["epochs"]] == [1] and summary["step"] == 2
    assert summary["epochs"][0]["steps"] == 2 and summary["epochs"][0]["valid_items"] == 1

    # resume: runs epoch 2 only, the step count carries on
    argv[argv.index("--num_epochs") + 1] = "2"
    summary = train.main(argv)
    assert [e["epoch"] for e in summary["epochs"]] == [2] and summary["step"] == 4
    assert [int(r["Epoch"]) for r in _rows(model_dir / "loss_and_metrics.csv")] == [1, 2]
    assert ckpt.restore_raw("latest")[0]["step"] == 4


def test_train_cli_sdm_and_stop_after_epoch(dataset, tmp_path):
    """--sdm adds the boundary loss (SDMs from the NCDHW mask on the host);
    --stop_after_epoch ends the loop early, checkpointed."""
    argv = _argv(dataset, str(tmp_path / "results")) + ["--sdm", "--stop_after_epoch", "1"]
    argv[argv.index("--num_epochs") + 1] = "3"
    summary = train.main(argv)
    assert [e["epoch"] for e in summary["epochs"]] == [1]
    rows = _rows(tmp_path / "results" / "XLSTM_HVED" / "loss_and_metrics.csv")
    assert len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0].values())
    meta = CheckpointManager(str(tmp_path / "results" / "XLSTM_HVED")).restore_raw("latest")[1]
    assert meta["epoch"] == 1


def test_pretrain_then_train_from_its_weights(dataset, tmp_path, capsys):
    out_dir = str(tmp_path / "results")
    pretrain.main(_argv(dataset, out_dir))
    pdir = os.path.join(out_dir, "U_HVEDDuSFEmViLDFNet3D_pretrain")
    pckpt = CheckpointManager(pdir)
    assert pckpt.exists("latest") and pckpt.exists("best_vloss")
    rows = _rows(os.path.join(pdir, "loss_and_metrics.csv"))
    assert len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0].values())
    donor = pckpt.restore_raw("best_vloss")[0]["model"]
    assert "rdecoder_3_0.basic.conv1.Conv3DFast_0.weight" in donor

    summary = train.main(_argv(dataset, out_dir) + ["--pretrain_weights", pdir])
    assert summary["surgery"] == (204, 5)
    assert "surgical_restore: loaded 204, skipped 5" in capsys.readouterr().out
    trained = CheckpointManager(os.path.join(out_dir, "XLSTM_HVED")).restore_raw("latest")[0]
    assert trained["step"] == 2 and "rdecoder_1_0.basic.conv1.Conv3DFast_0.weight" not in \
        trained["model"]


def test_train_and_eval_clis_run_the_ext_resnet_and_fusion_presets(dataset, tmp_path, capsys):
    """cli.train --model_name U_HVEDNet3D one epoch, then cli.test on its
    best_dice checkpoint (the hoisted sweep); FusionUNet3D evaluates through
    the plain sweep and, having no experts, cannot train (as in the JAX
    package)."""
    from xlstm_hved_torch.cli import test as test_cli

    out = str(tmp_path / "results")
    argv = _argv(dataset, out) + ["--model_name", "U_HVEDNet3D"]
    summary = train.main(argv)
    assert summary["epochs"][0]["steps"] == 2
    assert CheckpointManager(os.path.join(out, "U_HVEDNet3D")).exists("best_dice")
    eval_argv = ["--device", "cpu", "--crop_size", "16", "16", "16", "--valid_dir", dataset[1],
                 "--out_dir", out, "--compute_dtype", "float32"]
    result = test_cli.main(eval_argv + ["--model_name", "U_HVEDNet3D"])
    assert "restored checkpoint best_dice" in capsys.readouterr().out
    assert result["volumes"] == 1 and result["dice"].shape == (15, 3)
    result = test_cli.main(eval_argv + ["--model_name", "FusionUNet3D"])
    assert result["volumes"] == 1 and math.isfinite(float(result["dice"].mean()))
    with pytest.raises(ValueError, match="at least one array to stack"):
        train.main(_argv(dataset, out) + ["--model_name", "FusionUNet3D"])


def test_check_cli(dataset, tmp_path):
    out_file = str(tmp_path / "subjects.txt")
    good, bad = check.main(["--data_dir", dataset[0], "--decode", "--out_file", out_file])
    assert (good, bad) == (["SYN-0000", "SYN-0001"], [])
    with open(out_file) as f:
        assert f.read().split() == good


def test_parser_matches_jax_but_for_the_port_defaults():
    got = vars(base_parser("port").parse_args([]))
    want = vars(jax_base_parser("jax").parse_args([]))
    assert set(got) == set(want) | {"device"}
    assert {k: got[k] for k in PORT_DEFAULTS} == PORT_DEFAULTS
    assert {k: v for k, v in got.items() if k not in PORT_DEFAULTS} == \
        {k: v for k, v in want.items() if k not in PORT_DEFAULTS}


@pytest.mark.parametrize("extra", [["--distributed"], ["--num_data_devices", "2"]])
@pytest.mark.parametrize("main", [train.main, pretrain.main], ids=["train", "pretrain"])
def test_unported_options_raise(dataset, tmp_path, monkeypatch, main, extra):
    """The data-parallel options outside a group of their size raise before
    anything is written: --num_data_devices 2 in one process (one device per
    process; the error names torchrun), and train's --distributed with no
    rendezvous (torchrun's environment unset, no coordinator address): no
    quiet fall-back to one process. The pretrain CLI joins no group, as
    JAX's does not, and runs --distributed as one process."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    argv = _argv(dataset, str(tmp_path)) + extra
    if extra == ["--distributed"] and main is pretrain.main:
        assert main(argv)["step"] == 2
        return
    error, match = ((ValueError, "torchrun") if "--num_data_devices" in extra
                    else (ValueError, "env://"))
    with pytest.raises(error, match=match):
        main(argv)
    assert not os.listdir(tmp_path)


# each precision option on its own (the other dtype at float32), and --remat
# at the bf16 defaults
PRECISION_OPTIONS = {
    "bf16-compute": ["--compute_dtype", "bfloat16"],
    "bf16-disc": ["--disc_dtype", "bfloat16"],
    "remat": ["--remat", "--compute_dtype", "bfloat16", "--disc_dtype", "bfloat16"],
}


@pytest.mark.parametrize("extra", list(PRECISION_OPTIONS.values()),
                         ids=list(PRECISION_OPTIONS))
@pytest.mark.parametrize("main", [train.main, pretrain.main], ids=["train", "pretrain"])
def test_precision_and_remat_options_run(dataset, tmp_path, main, extra):
    """One epoch with the option; the checkpoint holds fp32 G and D
    parameters and Adam state whatever the compute dtypes."""
    main(_argv(dataset, str(tmp_path)) + extra)
    name = "XLSTM_HVED" if main is train.main else "U_HVEDDuSFEmViLDFNet3D_pretrain"
    raw = CheckpointManager(str(tmp_path / name)).restore_raw("latest")[0]
    assert raw["step"] == 2
    for net in ("model", "disc"):
        assert all(t.dtype in (torch.float32, torch.int64) for t in raw[net].values()), net
    moments = [t for s in raw["opt_g"]["state"].values() for t in s.values() if t.ndim > 0]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    rows = _rows(tmp_path / name / "loss_and_metrics.csv")
    assert len(rows) == 1 and all(math.isfinite(float(v)) for v in rows[0].values())


def test_cuda_request_without_a_card_raises(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = [a for a in _argv(dataset, str(tmp_path)) if a not in ("--device", "cpu")]
    for main in (train.main, pretrain.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
