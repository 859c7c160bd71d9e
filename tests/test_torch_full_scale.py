"""PyTorch port: the full training protocol, `scripts/torch_full_scale_run.py`,
against its JAX counterpart `scripts/full_scale_run.py`: the same flags and
defaults (plus --device), the artifact set of a quick run in process, the
chunked finetune resuming in processes of their own, the weight surgery
loading and skipping the same tensors as JAX's, and the CSV headers and
subset-table lines laid out as the committed JAX run's
(docs/fullscale/run_r4b_40ep/)."""
import ast
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

import pytest
import torch

import _torch_port as tp
from xlstm_hved_tpu.engine.checkpoint import surgical_restore as jax_surgical_restore
from xlstm_hved_torch.engine.checkpoint import surgical_restore
from xlstm_hved_torch.models import find_model_using_name

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = REPO / "scripts" / "full_scale_run.py"
PORT_SCRIPT = REPO / "scripts" / "torch_full_scale_run.py"
JAX_RUN = REPO / "docs" / "fullscale" / "run_r4b_40ep"
SMALL = ["--quick", "--device", "cpu", "--n_train", "2", "--n_valid", "1"]
FLOAT = r"-?\d+\.\d+"


def _port_script():
    spec = importlib.util.spec_from_file_location("torch_full_scale_run", PORT_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _env():
    """The child processes take this worker's share of the cores."""
    return dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()),
                PYTHONPATH=str(REPO))


def _flags(script):
    out = subprocess.run([sys.executable, str(script), "--help"], capture_output=True,
                         text=True, check=True, timeout=120, env=_env()).stdout
    return set(re.findall(r"--\w+", out))


def _jax_defaults():
    """flag -> its add_argument keywords (default, type, action, nargs, dest)
    as the JAX script's source states them; `RUNS` stands for its own path."""
    out = {}
    for node in ast.walk(ast.parse(JAX_SCRIPT.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            out[node.args[0].value] = {k.arg: ast.unparse(k.value) for k in node.keywords
                                       if k.arg != "help"}
    return out


def test_flags_and_defaults_are_the_jax_scripts_plus_device():
    assert _flags(PORT_SCRIPT) == _flags(JAX_SCRIPT) | {"--device"}
    port = {a.option_strings[-1]: a for a in _port_script().parser()._actions}
    for flag, kw in _jax_defaults().items():
        a = port[flag]
        assert a.dest == ast.literal_eval(kw.get("dest", repr(flag[2:]))), flag
        if "action" in kw:
            assert kw["action"] == "'store_true'" and (a.const, a.default) == (True, False)
            continue
        if flag == "--out_root":   # a root of its own beside the JAX script's
            assert kw["default"] == "RUNS" and a.default.endswith("runs/fullscale_torch")
        else:
            assert a.default == ast.literal_eval(kw.get("default", "None")), flag
        assert (a.type.__name__ if a.type else None) == kw.get("type"), flag
        assert a.nargs == ast.literal_eval(kw.get("nargs", "None")), flag
    assert port["--device"].default == "cuda"


def test_a_cuda_run_without_a_card_raises_before_any_work(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port_script().main(["--quick", "--out_root", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def _subset_rows(table: str):
    rows = [ln for ln in table.splitlines() if ln.startswith("subset ")]
    return rows, [[float(v) for v in re.findall(FLOAT, ln)[:3]] for ln in rows]


def _layout(lines):
    """Each line as its text with the numbers replaced by their decimals,
    and the columns where its first number and its labels (HD95, PSNR,
    SSIM) start: the fixed-width fields before them."""
    out = []
    for ln in lines:
        ln = re.sub(r"=== \d+ volumes", "=== N volumes", ln)
        text = re.sub(FLOAT, lambda m: "#" * len(m[0].split(".")[1]), ln)
        first = re.search(FLOAT, ln)
        out.append((re.sub(r"\s+", " ", text), first and first.start(),
                    [m.start() for m in re.finditer(r"\b[A-Z][A-Z0-9]+\b", ln)]))
    return out


def _table_block(table: str):
    lines = table.splitlines()
    start = next(i for i, ln in enumerate(lines) if ln.startswith("=== "))
    end = next(i for i, ln in enumerate(lines) if ln.startswith("average"))
    return lines[start:end + 1]


def test_quick_run_in_process_writes_the_jax_artifacts(tmp_path, capsys):
    root = tmp_path / "run"
    summary = _port_script().main(SMALL + ["--inprocess", "--compute_hd95",
                                           "--out_root", str(root)])
    printed = capsys.readouterr().out
    for i in (1, 2, 3):
        assert re.search(rf"\[phase {i}/3\] done in \d+s.*peak host RSS {FLOAT} GiB", printed)
    assert {p.name for p in root.iterdir()} == {
        "data", "XLSTM_HVED_pretrain", "XLSTM_HVED", "subset_table.txt", "summary.json",
        "phases.json"}
    assert sorted(os.listdir(root / "data" / "train")) == ["SYN-0000", "SYN-0001"]
    jax_summary = json.loads((JAX_RUN / "summary.json").read_text())
    written = json.loads((root / "summary.json").read_text())
    assert set(written) == set(jax_summary) and written == json.loads(json.dumps(summary))
    assert (written["crop"], written["n_train"], written["n_valid"],
            written["pretrain_epochs"], written["train_epochs"]) == ([16, 32, 16], 2, 1, 1, 2)

    table = (root / "subset_table.txt").read_text()
    rows, dice = _subset_rows(table)
    assert len(rows) == 15 and all(math.isfinite(d) for r in dice for d in r)
    assert "restored checkpoint best_dice" in table
    # the layout of the committed JAX run's files
    for ours, theirs in ((root / "XLSTM_HVED_pretrain", "pretrain_loss_and_metrics.csv"),
                         (root / "XLSTM_HVED", "finetune_loss_and_metrics.csv")):
        header = (ours / "loss_and_metrics.csv").read_text().splitlines()[0]
        assert header == (JAX_RUN / theirs).read_text().splitlines()[0]
    jax_block = _table_block((JAX_RUN / "subset_table.txt").read_text())
    assert _layout(_table_block(table)) == _layout(jax_block)

    phases = json.loads((root / "phases.json").read_text())["phases"]
    assert [(p["phase"], p["epochs"], p["rc"]) for p in phases] == [
        ("pretrain", [1, 1], 0), ("finetune", [1, 2], 0), ("sweep", None, 0)]
    # the CPU runs the plain scan: no kernel, no device memory
    assert all(p["peak_device_gib"] is None and p["launches"]["mlstm_fwd"] == 0
               and p["launches"]["plain_scan"] > 0 and p["peak_rss_gib"] > 0 for p in phases)


def test_chunked_finetune_resumes_in_processes_of_their_own(tmp_path, monkeypatch, capfd):
    root = tmp_path / "run"
    monkeypatch.setenv("OMP_NUM_THREADS", _env()["OMP_NUM_THREADS"])
    _port_script().main(SMALL + ["--subprocess", "--epoch_chunk", "1", "--out_root", str(root)])
    printed = capfd.readouterr().out
    phases = json.loads((root / "phases.json").read_text())["phases"]
    assert [(p["phase"], p["epochs"], p["rc"]) for p in phases] == [
        ("pretrain", [1, 1], 0), ("finetune", [1, 1], 0), ("finetune", [2, 2], 0),
        ("sweep", None, 0)]
    # one row per epoch: the second chunk resumed at epoch 2
    csv = (root / "XLSTM_HVED" / "loss_and_metrics.csv").read_text().splitlines()
    assert [ln.split(",")[0] for ln in csv[1:]] == ["1", "2"]
    assert printed.count("Epoch [1/2]") == 1 and printed.count("Epoch [2/2]") == 1
    assert "[phase 2/3] epochs 1-1 done" in printed
    meta = json.loads((root / "XLSTM_HVED" / "latest.meta.json").read_text())
    assert meta["epoch"] == 2
    rows, dice = _subset_rows((root / "subset_table.txt").read_text())
    assert len(rows) == 15 and all(math.isfinite(d) for r in dice for d in r)


def test_surgery_loads_and_skips_the_jax_tensors():
    """The protocol's surgery: the pretrain net (the flagship with a recon
    decoder per modality) into the flagship, by name and shape."""
    _, loaded, skipped = jax_surgical_restore(
        tp.jax_param_zeros("XLSTM_HVED"), tp.jax_param_zeros("XLSTM_HVED", shared_recon=False))
    donor = find_model_using_name("XLSTM_HVED", device="cpu", seed=1,
                                  shared_recon=False).state_dict()
    target = find_model_using_name("XLSTM_HVED", device="cpu", seed=2)
    got_loaded, got_skipped = surgical_restore(target, donor)
    assert set(got_loaded) == {tp.torch_param_name(k) for k in loaded}
    assert set(got_skipped) == {tp.torch_param_name(k) for k in skipped}
    assert len(got_loaded) == len(loaded) and len(got_skipped) == len(skipped)
    # the heads whose widths differ (docs/fullscale/README.md: 204 loaded, 5 skipped)
    assert sorted(got_skipped) == ['final_conv.weight', 'rfinal_0.bias', 'rfinal_0.weight',
                                   'sfinal_0.bias', 'sfinal_0.weight']
    params = dict(target.named_parameters())
    assert all(torch.equal(params[n], donor[n]) for n in got_loaded)


def test_phase_report_counts_the_mlstm_path_and_follows_rss():
    """measure() sets the counts to 0 and reads them after its block; the
    plain scan counts its calls; rss_samples follows a process until it
    ends."""
    from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise
    from xlstm_hved_torch.utils import phase_report

    q = torch.randn(1, 2, 40, 8)
    g = torch.randn(1, 2, 40)
    mlstm_chunkwise(q, q, q, g, g, chunk_size=16)
    with phase_report.measure() as record:
        for _ in range(3):
            mlstm_chunkwise(q, q, q, g, g, chunk_size=16)
    assert record["launches"] == {"mlstm_fwd": 0, "mlstm_fwd_states": 0, "mlstm_bwd": 0,
                                  "plain_scan": 3}
    assert record["peak_device_gib"] is None and record["peak_rss_gib"] > 0
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(0.6)"])
    with phase_report.rss_samples(proc.pid, every=0.05) as samples:
        proc.wait(timeout=30)
        time.sleep(0.3)
        n = len(samples)
        time.sleep(0.3)   # the process is gone: the sampler has stopped on its own
        assert len(samples) == n
    assert n >= 3 and all(rss > 0 for _, rss in samples)
    assert [t for t, _ in samples] == sorted(t for t, _ in samples)
