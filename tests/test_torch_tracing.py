"""PyTorch port: the program's spans (`utils.logging.span`). Under a
recording profiler a train step records each of its phases once, nested
under `train.step`, with the ViL's conv and the RSM gates inside G's
forward; a hoisted sweep records its prefix once and a suffix per subset,
with six gates in each suffix. With no profiler a span
builds no profiler range, and a step is bitwise the same with and without
one. The CLIs' timers are spans: with --profile_dir their names are in the
trace too."""
import glob
import json
import time

import pytest
import torch

from xlstm_hved_torch.cli import pretrain, test as test_cli
from xlstm_hved_torch.config import TrainConfig
from xlstm_hved_torch.data.synthetic import write_synthetic_dataset
from xlstm_hved_torch.engine.evaluate import make_hoisted_subset_sweep
from xlstm_hved_torch.engine.train import create_train_state, make_train_step
from xlstm_hved_torch.models import Discriminator, find_model_using_name
from xlstm_hved_torch.nn.blocks import AttenModule2
from xlstm_hved_torch.nn.vil import CausalConv1d
from xlstm_hved_torch.utils.logging import span, timed_iter

CROP = (32, 32, 32)
STEP_SPANS = ("train.g_forward", "train.g_backward", "train.g_adam", "train.d_forward",
              "train.d_backward", "train.d_adam")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _step_and_inputs(seed=0):
    cfg = TrainConfig(crop_size=CROP)
    model = find_model_using_name("XLSTM_HVED", device="cpu", seed=seed,
                                  compute_dtype="float32")
    disc = Discriminator(f_maps=8, kernel=3)
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(1, 4, *CROP, generator=gen)
    mask = (torch.rand(1, 3, *CROP, generator=gen) > 0.7).float()
    state = create_train_state(model, disc, cfg, seed, x)
    return state, make_train_step(model, disc, cfg), x, mask


def _ranges(prof, names):
    """(name, start_ns, end_ns) of the profiler's host ranges named in `names`."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.name() in names]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def test_a_train_step_records_each_phase_once_under_the_step():
    state, step, x, mask = _step_and_inputs()
    prof, _ = _profiled(lambda: step(state, x, mask))
    ranges = _ranges(prof, ("train.step", "vil.conv1d") + STEP_SPANS)
    steps = [r for r in ranges if r[0] == "train.step"]
    assert len(steps) == 1
    for name in STEP_SPANS:
        mine = [r for r in ranges if r[0] == name]
        assert len(mine) == 1, name
        assert _inside(mine[0], steps[0]), name
    order = [r[0] for r in sorted(ranges, key=lambda r: r[1]) if r[0] in STEP_SPANS]
    assert order == list(STEP_SPANS)
    # the flagship's mid-ViL, once in each of G's two forwards
    (g_forward,) = [r for r in ranges if r[0] == "train.g_forward"]
    convs = [r for r in ranges if r[0] == "vil.conv1d"]
    assert len(convs) == 2 and all(_inside(c, g_forward) for c in convs)


def test_a_hoisted_sweep_records_one_prefix_and_fifteen_suffixes():
    model = find_model_using_name("U_HVEDConvXLSTMNet3D", device="cpu", seed=2,
                                  compute_dtype="float32").eval()
    x = torch.rand(1, 4, *CROP, generator=torch.Generator().manual_seed(3))
    sweep = make_hoisted_subset_sweep(model, CROP, CROP, recon_channels=4)
    prof, _ = _profiled(lambda: sweep(model, x))
    ranges = _ranges(prof, ("sweep.prefix", "sweep.suffix", "vil.conv1d"))
    prefix = [r for r in ranges if r[0] == "sweep.prefix"]
    suffixes = [r for r in ranges if r[0] == "sweep.suffix"]
    assert len(prefix) == 1 and len(suffixes) == 15
    # the ViL is in the decoder: once in each suffix, never in the prefix
    convs = [r for r in ranges if r[0] == "vil.conv1d"]
    assert len(convs) == 15
    assert all(sum(_inside(c, s) for s in suffixes) == 1 for c in convs)


def test_the_rsm_gates_record_six_spans_in_each_suffix():
    """The seg decoder's three AttenModule2 joins, two gates each, run in
    every subset's suffix and never in the hoisted prefix."""
    model = find_model_using_name("U_HVEDConvXLSTMNet3D", device="cpu", seed=2,
                                  compute_dtype="float32").eval()
    x = torch.rand(1, 4, *CROP, generator=torch.Generator().manual_seed(3))
    sweep = make_hoisted_subset_sweep(model, CROP, CROP, recon_channels=4)
    prof, _ = _profiled(lambda: sweep(model, x))
    ranges = _ranges(prof, ("sweep.prefix", "sweep.suffix", "rsm.gate"))
    (prefix,) = [r for r in ranges if r[0] == "sweep.prefix"]
    suffixes = [r for r in ranges if r[0] == "sweep.suffix"]
    gates = [r for r in ranges if r[0] == "rsm.gate"]
    assert len(gates) == 6 * 15 and not any(_inside(g, prefix) for g in gates)
    for s in suffixes:
        assert sum(_inside(g, s) for g in gates) == 6


def test_an_atten_module2_call_records_two_gates():
    module = AttenModule2()
    seg, enc = torch.rand(1, 4, 8, 8, 8), torch.rand(1, 4, 8, 8, 8)
    prof, _ = _profiled(lambda: module(seg, enc))
    assert len(_ranges(prof, ("rsm.gate",))) == 2


def test_a_flagship_g_forward_records_six_gates_and_a_step_twelve():
    model = find_model_using_name("XLSTM_HVED", device="cpu", seed=0,
                                  compute_dtype="float32")
    x = torch.rand(1, 4, *CROP, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        prof, _ = _profiled(lambda: model(x, recon=True, deterministic=True))
    assert len(_ranges(prof, ("rsm.gate",))) == 6
    state, step, x, mask = _step_and_inputs()
    prof, _ = _profiled(lambda: step(state, x, mask))
    ranges = _ranges(prof, ("train.g_forward", "rsm.gate"))
    (g_forward,) = [r for r in ranges if r[0] == "train.g_forward"]
    gates = [r for r in ranges if r[0] == "rsm.gate"]
    assert len(gates) == 12 and all(_inside(g, g_forward) for g in gates)


def test_with_no_profiler_a_span_builds_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with span("vil.conv1d"):
        pass
    conv = CausalConv1d(8)
    conv(torch.rand(1, 16, 8))
    table = {}
    with span("load", table):
        time.sleep(0.01)
    items = list(timed_iter(iter([1, 2]), table, "wait"))
    assert items == [1, 2] and table["load"] >= 0.01 and set(table) == {"load", "wait"}


def test_a_step_is_bitwise_the_same_under_a_profiler():
    runs = []
    for traced in (False, True):
        state, step, x, mask = _step_and_inputs(seed=5)
        if traced:
            _, (state, metrics) = _profiled(lambda: step(state, x, mask))
        else:
            state, metrics = step(state, x, mask)
        runs.append((metrics, state))
    (m0, s0), (m1, s1) = runs
    assert m0.keys() == m1.keys()
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    for a, b in ((s0.model, s1.model), (s0.disc, s1.disc)):
        for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
            assert torch.equal(p, q), n


@pytest.mark.parametrize("main", ["pretrain", "test"])
def test_cli_timers_are_in_the_profile_dir_trace(tmp_path, main):
    shape = (16, 16, 16)
    train_dir = write_synthetic_dataset(str(tmp_path / "train"), 2, shape, seed=0)
    valid_dir = write_synthetic_dataset(str(tmp_path / "valid"), 1, shape, seed=1)
    argv = ["--device", "cpu", "--crop_size", "16", "16", "16", "--num_epochs", "1",
            "--disc_kernel", "3", "--disc_fmaps", "8", "--compute_dtype", "float32",
            "--disc_dtype", "float32", "--train_dir", train_dir, "--valid_dir", valid_dir,
            "--out_dir", str(tmp_path / "results"), "--profile_dir", str(tmp_path / "prof")]
    if main == "pretrain":
        summary = pretrain.main(argv)
        timers = summary["epochs"][0]["spans"]
        program = {"train.g_backward", "train.g_adam"}
    else:
        summary = test_cli.main(argv)
        timers = summary["per_volume"][0]["spans"]
        program = {"sweep.prefix", "sweep.suffix"}
    (path,) = glob.glob(str(tmp_path / "prof" / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    opened = {k for k, v in timers.items() if v > 0}
    assert opened and opened <= names
    assert program <= names
