"""The manifest against the benchmark's contract, and the files it names.

    python -m pytest -q perfbench/tests

A later PR adds a configuration, a cell or a per-layer metric as new files
and manifest entries; `test_added_cell_runs_from_new_files` does that in a
temporary copy and runs the new cell there on the CPU.
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert all(one_line(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (ROOT / p).is_dir()
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_check_fits_the_full_benchmark():
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compiling a cell,
    1200 s spare: within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (MANIFEST["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys():
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(("cell", w["name"]))
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(pairs) // 4)


def test_every_cell_reports_what_the_contract_asks():
    e2e = MANIFEST["end_to_end"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for w in MANIFEST["workloads"]:
        reported = {m["name"] for m in e2e if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in MANIFEST["per_layer"]
                 if m["moves"] in reported and w["name"] in m.get("workloads", [w["name"]])]
        assert layer


def test_moves_names_a_metric_every_listed_cell_reports():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = [w["name"] for w in MANIFEST["workloads"]]
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def test_every_file_is_found_by_name():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        traffic = json.loads((ROOT / "perfbench/traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench/drivers" / f"{traffic['driver']}.py").is_file()
        assert traffic["unit_metric"] in {m["name"] for m in MANIFEST["end_to_end"]}
        assert (ROOT / "perfbench/limits" / f"{w['name']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (ROOT / "perfbench/layer_metrics" / f"{m['name'].split('.')[0]}.py").is_file()


def test_the_program_states_each_configured_field():
    """Each configuration's "model" fields are the preset's own (the file
    states the configuration as it is run)."""
    sys.path.insert(0, str(ROOT))
    from perfbench.drivers import program

    for c in MANIFEST["configs"]:
        body = json.loads((ROOT / c["file"]).read_text())
        program.program_config(body["model"])


EXTRA = {
    "config": {"name": "extra_cfg", "source": "https://github.com/Quanato607/XLSTM-HVED",
               "file": "perfbench/configs/extra_cfg.json", "reduced": [],
               "why": "a configuration added as a file"},
    "cell": {"name": "extra_cfg.tiny_sweep", "config": "extra_cfg", "traffic": "tiny_sweep",
             "chips": 1, "why": "a cell added as files"},
    "metric": {"name": "units_done", "unit": "sweeps", "better": "higher",
               "source": "host_clock", "layer": "device", "moves": "sweep_ms",
               "workloads": ["extra_cfg.tiny_sweep"]},
}


def test_added_cell_runs_from_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell's
    limits and a per-layer reader as new files and manifest entries, and
    run the new cell's driver on the CPU there: no existing file edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append(EXTRA["config"])
    manifest["workloads"].append(EXTRA["cell"])
    manifest["per_layer"].append(EXTRA["metric"])
    for m in manifest["end_to_end"]:
        if m["name"] == "sweep_ms":
            m["workloads"].append(EXTRA["cell"]["name"])
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    cfg = json.loads((ROOT / "perfbench/configs/u_hved_conv_xlstm.json").read_text())
    cfg["model"]["compute_dtype"] = "float32"
    (copy / "perfbench/configs/extra_cfg.json").write_text(json.dumps(cfg))
    (copy / "perfbench/traffic/tiny_sweep.json").write_text(json.dumps(
        {"driver": "sweep", "unit_metric": "sweep_ms", "crop": [32, 32, 32],
         "pool": 2, "warmup": 1, "draw_from": 1, "subsets_checked": 4}))
    (copy / "perfbench/limits/extra_cfg.tiny_sweep.json").write_text(
        json.dumps({"stage_gap": 1e-3, "vil_gap": 1e-3, "recon_gap": 1e-3}))
    (copy / "perfbench/layer_metrics/units_done.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    script = textwrap.dedent(f"""
        import sys, time, json
        sys.path[:0] = [{str(copy)!r}, {str(ROOT)!r}]
        import torch
        torch.set_num_threads(2)
        from perfbench import harness
        assert harness.ROOT == __import__("pathlib").Path({str(copy)!r})
        import run
        cell = harness.load_cell("extra_cfg.tiny_sweep")
        from perfbench.drivers import sweep
        w = sweep.run(cell, 2**31 + 99, 0.01, False, torch.device("cpu"), time.perf_counter())
        print(json.dumps({{"correct": harness.correct(w.checks), "units": w.units,
                          "e2e": run.metrics_of(cell, w, False),
                          "layer": run.metrics_of(cell, w, True)}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=copy / "perfbench", timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["units"] >= 1
    assert set(result["e2e"]) == {"setup_s", "sweep_ms"}
    assert result["layer"] == {"units_done": {"value": float(result["units"]), "unit": "sweeps"}}
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("seed", [2**31 + 17])
def test_inputs_repeat_from_the_seed(seed):
    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench import synthetic

    a = synthetic.pool(torch.Generator().manual_seed(seed), 1, (16, 16, 16))
    b = synthetic.pool(torch.Generator().manual_seed(seed), 1, (16, 16, 16))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    masks = a[1][0]
    assert torch.all(masks[1] <= masks[0]) and torch.all(masks[2] <= masks[1])


def test_weights_repeat_from_the_seed():
    """Every value of G's and D's state dicts follows from the seed, the
    construction values of the templates included."""
    import json as _json

    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench.drivers import program

    config = _json.loads((ROOT / "perfbench/configs/xlstm_hved.json").read_text())
    draws = []
    for _ in range(2):
        torch.rand(7)  # the process's own random state moves between draws
        draws.append(program.make_weights(config, torch.Generator().manual_seed(2**31 + 3),
                                          disc=True))
    for a, b in zip(*draws):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
