"""The manifest against the benchmark's contract, and the files it names.

    python -m pytest -q perfbench/tests

A later PR adds a configuration, a cell or a per-layer metric as new files
and manifest entries; `test_added_cell_runs_from_new_files` does that in a
temporary copy and runs the new cell there on the CPU, and
`test_added_family_runs_from_new_files` adds a model family the harness has
not seen, with its own builder and driver, and holds the copy to the
manifest checks (`MANIFEST_CHECKS`, each taking the checkout's root).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def manifest_of(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@pytest.fixture
def root() -> Path:
    """The checkout whose manifest the checks read."""
    return ROOT


def test_top_level_keys_and_sizes(root):
    manifest = manifest_of(root)
    assert set(manifest) == KEYS
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert manifest["command"] == ["python3", "perfbench/run.py"]
    assert all(one_line(w) for w in manifest["command"])
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and (root / p).is_dir()
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_check_fits_the_full_benchmark(root):
    """2 + 14 x 24 runs of run_seconds + 60 s, 2 x 90 s of compiling a cell,
    1200 s spare: within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (manifest_of(root)["run_seconds"] + 60) + cells * 180 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys(root):
    manifest = manifest_of(root)
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(("cell", w["name"]))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(1, len(pairs) // 4)


def test_every_cell_reports_what_the_contract_asks(root):
    manifest = manifest_of(root)
    e2e = manifest["end_to_end"]
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    for w in manifest["workloads"]:
        reported = {m["name"] for m in e2e if w["name"] in m.get("workloads", [w["name"]])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = [m for m in manifest["per_layer"]
                 if m["moves"] in reported and w["name"] in m.get("workloads", [w["name"]])]
        assert layer


def test_moves_names_a_metric_every_listed_cell_reports(root):
    manifest = manifest_of(root)
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def test_every_file_is_found_by_name(root):
    manifest = manifest_of(root)
    configs = {c["name"]: c for c in manifest["configs"]}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"].startswith("perfbench/") and (root / c["file"]).is_file()
        body = json.loads((root / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert (root / "perfbench/drivers" / f"{body.get('builder', 'program')}.py").is_file()
    for w in manifest["workloads"]:
        traffic = json.loads((root / "perfbench/traffic" / f"{w['traffic']}.json").read_text())
        assert (root / "perfbench/drivers" / f"{traffic['driver']}.py").is_file()
        assert traffic["unit_metric"] in {m["name"] for m in manifest["end_to_end"]}
        assert (root / "perfbench/limits" / f"{w['name']}.json").is_file()
    for m in manifest["per_layer"]:
        assert (root / "perfbench/layer_metrics" / f"{m['name'].split('.')[0]}.py").is_file()


def test_the_program_states_each_configured_field(root):
    """Each configuration's "model" fields are the program's own, as its
    builder constructs it (the file states the configuration as it is
    run)."""
    sys.path.insert(0, str(root))
    from perfbench import harness

    for c in manifest_of(root)["configs"]:
        body = json.loads((root / c["file"]).read_text())
        harness.builder(body).program_config(body["model"])


MANIFEST_CHECKS = (test_top_level_keys_and_sizes, test_check_fits_the_full_benchmark,
                   test_names_units_and_entry_keys,
                   test_every_cell_reports_what_the_contract_asks,
                   test_moves_names_a_metric_every_listed_cell_reports,
                   test_every_file_is_found_by_name,
                   test_the_program_states_each_configured_field)


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


def checkout_with(tmp_path: Path, extra: dict, unit_metric: str):
    """A copy of the benchmark (its tests left out) whose manifest has the
    `extra` configuration, cell and per-layer metric added, the cell among
    those of `unit_metric`; (the copy's root, its files' bytes before
    anything else was added)."""
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (copy / "perfbench").rglob("*") if p.is_file()}
    manifest = manifest_of(ROOT)
    manifest["configs"].append(extra["config"])
    manifest["workloads"].append(extra["cell"])
    manifest["per_layer"].append(extra["metric"])
    for m in manifest["end_to_end"]:
        if m["name"] == unit_metric:
            m["workloads"].append(extra["cell"]["name"])
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))
    return copy, before


def test_added_cell_runs_from_new_files(tmp_path):
    """Copy the benchmark, add a configuration, a traffic mix, a cell's
    limits and a per-layer reader as new files and manifest entries, and
    run the new cell's driver on the CPU there: no existing file edited."""
    copy, before = checkout_with(tmp_path, EXTRA, "sweep_ms")
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


# A model family the harness has not seen: UxLSTM's residual block
# (xlstm_hved_torch/models/uxlstm.py `ResBlockND`), with a builder, a driver
# that times its forward and holds it to a plain recomputation, a traffic
# mix, a limits file and a reader, all new files.
FAMILY = {
    "config": {"name": "uxlstm_resblock",
               "source": "https://arxiv.org/abs/2407.01530 (a residual block of UxLSTM's encoder)",
               "file": "perfbench/configs/uxlstm_resblock.json", "reduced": [],
               "why": "a family outside the HVED presets, added as files"},
    "cell": {"name": "uxlstm_resblock.forward", "config": "uxlstm_resblock",
             "traffic": "resblock_forward", "chips": 1,
             "why": "closed loop of one block's forward at 16^3, batch 2"},
    "metric": {"name": "forwards_done", "unit": "forwards", "better": "higher",
               "source": "host_clock", "layer": "device", "moves": "step_ms",
               "workloads": ["uxlstm_resblock.forward"]},
}
FAMILY_FILES = {
    "configs/uxlstm_resblock.json": json.dumps({
        "source": FAMILY["config"]["source"], "reduced": [], "builder": "resblock_model",
        "model": {"ndim": 3, "cin": 4, "features": 8, "kernel_size": 3, "stride": 1}}),
    "traffic/resblock_forward.json": json.dumps({
        "driver": "resblock_forward", "unit_metric": "step_ms", "crop": [16, 16, 16],
        "batch": 2, "warmup": 1}),
    "limits/uxlstm_resblock.forward.json": json.dumps({"out_gap": 1e-4}),
    "layer_metrics/forwards_done.py": "def read(ctx):\n    return float(ctx.units)\n",
    "drivers/resblock_model.py": textwrap.dedent('''
        """The builder of UxLSTM's residual block: the program's module, its
        weights drawn from a generator, and its plain reference."""
        import torch
        import torch.nn.functional as F

        def program_block(model):
            from xlstm_hved_torch.models.uxlstm import ResBlockND

            return ResBlockND(model["ndim"], model["cin"], model["features"],
                              model["kernel_size"], model["stride"])

        def program_config(model):
            conv = program_block(model).conv1
            built = {"ndim": conv.weight.dim() - 2, "cin": conv.in_channels,
                     "features": conv.out_channels, "kernel_size": conv.kernel_size[0],
                     "stride": conv.stride[0]}
            for key, value in model.items():
                if built[key] != value:
                    raise ValueError(f"ResBlockND.{key} is {built[key]!r}, "
                                     f"the file states {value!r}")
            return model

        def make_weights(model, gen):
            c, f, k = model["cin"], model["features"], model["kernel_size"]
            dev = gen.device
            draw = lambda *shape: torch.randn(shape, generator=gen, device=dev) / 4
            return {"conv1.weight": draw(f, c, k, k, k), "conv1.bias": draw(f),
                    "norm1.weight": 1 + draw(f), "norm1.bias": draw(f),
                    "conv2.weight": draw(f, f, k, k, k), "conv2.bias": draw(f),
                    "norm2.weight": 1 + draw(f), "norm2.bias": draw(f),
                    "conv3.weight": draw(f, c, 1, 1, 1), "conv3.bias": draw(f)}

        def build_program(model, weights, device):
            with torch.device(device):
                block = program_block(model)
            block.load_state_dict(weights, strict=True)
            return block

        def reference(model, w, x):
            def norm(y, name):
                mean = y.mean(dim=(2, 3, 4), keepdim=True)
                var = ((y - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
                shape = (1, -1, 1, 1, 1)
                return ((y - mean) / torch.sqrt(var + 1e-5) * w[name + ".weight"].view(shape)
                        + w[name + ".bias"].view(shape))

            pad = model["kernel_size"] // 2
            y = F.leaky_relu(norm(F.conv3d(x, w["conv1.weight"], w["conv1.bias"], padding=pad),
                                  "norm1"), 1e-2)
            y = norm(F.conv3d(y, w["conv2.weight"], w["conv2.bias"], padding=pad), "norm2")
            return F.leaky_relu(y + F.conv3d(x, w["conv3.weight"], w["conv3.bias"]), 1e-2)
    '''),
    "drivers/resblock_forward.py": textwrap.dedent('''
        """A closed loop of the residual block's forward on one batch made from
        the seed; after the window its last output against the plain reference
        (`out_gap`, relative L2). Traffic parameters: "crop", "batch", "warmup"."""
        import contextlib
        import time

        import torch

        from perfbench import harness
        from perfbench.drivers import resblock_model as builder

        def inputs(cell, seed, device):
            gen = torch.Generator(device=device).manual_seed(seed)
            tr, model = cell.traffic, cell.config["model"]
            x = torch.randn((tr["batch"], model["cin"], *tr["crop"]), generator=gen, device=device)
            return x, builder.make_weights(model, gen)

        def out_gap(cell, x, w, out, dtype=torch.float32):
            cast = lambda t: t.to(dtype).float()
            ref = builder.reference(cell.config["model"], w, x)
            mine = out if dtype == torch.float32 else builder.reference(
                cell.config["model"], {k: cast(v) for k, v in w.items()}, cast(x))
            return float((mine - ref).norm() / ref.norm())

        def run(cell, seed, seconds, trace, device, t0):
            x, w = inputs(cell, seed, device)
            block = builder.build_program(cell.config["model"], w, device)
            times = []
            with torch.no_grad():
                for _ in range(cell.traffic["warmup"]):
                    block(x)
                setup_s = time.perf_counter() - t0
                tracer = harness.Trace() if trace else contextlib.nullcontext()
                with tracer:
                    start = time.perf_counter()
                    while not times or time.perf_counter() - start < seconds:
                        t = time.perf_counter()
                        out = block(x)
                        times.append(time.perf_counter() - t)
                    window_s = time.perf_counter() - start
            got = {"out_gap": out_gap(cell, x, w, out)}
            return harness.Window(units=len(times), window_s=window_s, setup_s=setup_s,
                                  unit_times=times, memory_peak_bytes=0,
                                  checks={k: (got[k], lim) for k, lim in cell.limits.items()},
                                  attempted=len(times), failed=0,
                                  trace=tracer if trace else None, notes={"readings": got})

        def calibrate_seed(cell, seed, device, emit, control):
            emit(seed, "program", run(cell, seed, 1e-3, False, device, time.perf_counter())
                 .notes["readings"], [])
            if control:  # the reference in bf16, in the program's place
                x, w = inputs(cell, seed, device)
                emit(seed, "control", {"out_gap": out_gap(cell, x, w, None, torch.bfloat16)}, [])
    '''),
}


def test_added_family_runs_from_new_files(tmp_path):
    """Copy the benchmark and add a model family it has never seen as new
    files and manifest entries: a configuration naming its own builder, a
    traffic mix naming a new driver (`run`, `calibrate_seed`), a limits
    file and a per-layer reader. The copy passes the manifest checks, the
    new cell runs correct on the CPU and calibrates, and no file that was
    in the copy changes."""
    copy, before = checkout_with(tmp_path, FAMILY, "step_ms")
    for name, text in FAMILY_FILES.items():
        (copy / "perfbench" / name).write_text(text)
    tests = Path(__file__).resolve().parent
    script = textwrap.dedent(f"""
        import sys, time, json
        from pathlib import Path
        sys.path[:0] = [{str(copy)!r}, {str(tests)!r}, {str(ROOT)!r}]
        import torch
        torch.set_num_threads(2)
        from perfbench import harness
        assert harness.ROOT == Path({str(copy)!r})
        import test_perfbench_manifest as manifest_checks
        for check in manifest_checks.MANIFEST_CHECKS:
            check(Path({str(copy)!r}))
        import run
        cell = harness.load_cell("uxlstm_resblock.forward")
        w = harness.driver(cell.traffic).run(cell, 2**31 + 98, 0.01, False, torch.device("cpu"),
                                             time.perf_counter())
        print(json.dumps({{"correct": harness.correct(w.checks), "units": w.units,
                          "e2e": run.metrics_of(cell, w, False),
                          "layer": run.metrics_of(cell, w, True)}}))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=copy / "perfbench", timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["units"] >= 1
    assert set(result["e2e"]) == {"setup_s", "step_ms"}
    assert result["layer"] == {"forwards_done": {"value": float(result["units"]),
                                                 "unit": "forwards"}}

    seed = 2**31 + 97
    out = subprocess.run([sys.executable, "perfbench/calibrate.py", "--workload",
                          "uxlstm_resblock.forward", "--seeds", str(seed), "--device", "cpu"],
                         capture_output=True, text=True, cwd=copy, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(line) for line in out.stdout.strip().splitlines()]
    sides = {line["side"]: line["numbers"]["out_gap"] for line in lines}
    assert {line["workload"] for line in lines} == {"uxlstm_resblock.forward"}
    assert {line["seed"] for line in lines} == {seed}
    assert sides["program"] <= 1e-4 < sides["control"], sides
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_calibrate_names_a_driver_without_calibrate_seed(monkeypatch):
    """A driver with no `calibrate_seed` stops calibrate.py with its name;
    it does not fall through to another driver's code."""
    sys.path.insert(0, str(ROOT))
    from perfbench import calibrate, harness

    cell = harness.Cell("some.cell", 1, {}, {"driver": "program"}, {}, [], [])
    monkeypatch.setattr(harness, "load_cell", lambda name: cell)
    with pytest.raises(SystemExit, match="the driver 'program' of some.cell"):
        calibrate.main(["--workload", "some.cell", "--seeds", "1", "--device", "cpu"])


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
