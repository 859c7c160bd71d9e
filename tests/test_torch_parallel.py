"""PyTorch port: data and sequence parallelism (`xlstm_hved_torch/parallel/`)
on the CPU under gloo, against one process and against the JAX package
(the counterpart of tests/test_parallel.py and tests/test_multiprocess.py).

The multi-process cases run `tests/_torch_dp_worker.py` once per rank, each
a process of its own joined at tcp://127.0.0.1 on a free port, under a
subprocess timeout of its own (a deadlocked collective fails the case). One
module fixture starts all of them at once (2 ranks at batch 2, the one-
process reference at batch 4, 4 ranks for the sharded sweep and the
sequence-parallel mLSTM) and runs the JAX side meanwhile.

Held to the JAX package's own bounds (tests/test_parallel.py): 2 ranks at
batch 2 against one process at batch 4, the flagship XLSTM_HVED at 16^3 with
Discriminator(8, kernel 3), fp32, on JAX-initialised weights
(`_torch_port.random_variables`).
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port as tp
import xlstm_hved_tpu.models.hved as jax_hved
from xlstm_hved_tpu.config import TrainConfig as JaxTrainConfig
from xlstm_hved_tpu.config import get_config
from xlstm_hved_tpu.engine import train as jtrain
from xlstm_hved_tpu.ops import mlstm as jmlstm
from xlstm_hved_tpu.parallel import seq as jseq
from xlstm_hved_torch.cli import pretrain, train
from xlstm_hved_torch.data.synthetic import write_synthetic_dataset
from xlstm_hved_torch.ops.mlstm import mlstm_chunkwise, mlstm_quadratic
from xlstm_hved_torch.parallel import mesh as pmesh
from xlstm_hved_torch.parallel import seq as pseq
from xlstm_hved_torch.utils.convert import params_from_jax
from xlstm_hved_torch.utils.logging import RunningAverage

S = 16
KEEP = np.array([True, False, True, True])
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dp_worker.py")
TIMEOUT_S = 120
# the port's G gradient against JAX's, relative L2 over all tensors
# (test_grad_fn_two_ranks_equal_jax says why)
JAX_REL_L2 = 3e-2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(commands):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    return [subprocess.Popen(c, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for c in commands]


def _start(job, world, workdir):
    port = _free_port()
    return _spawn([[sys.executable, WORKER, job, str(r), str(world), str(port), workdir]
                   for r in range(world)])


def _start_cli(root):
    """cli.train --distributed on 2 ranks over 3 training subjects (the
    strided shard gives rank 0 two, rank 1 one) and 2 validation subjects,
    each rank writing to its own out_dir."""
    train_dir = write_synthetic_dataset(os.path.join(root, "train"), 3, (S, S, S), seed=0)
    valid_dir = write_synthetic_dataset(os.path.join(root, "valid"), 2, (S, S, S), seed=1)
    port = _free_port()
    return _spawn([[sys.executable, "-c", CLI_RUN] + CLI_ARGS +
                   ["--coordinator_address", f"127.0.0.1:{port}", "--process_id", str(r),
                    "--train_dir", train_dir, "--valid_dir", valid_dir,
                    "--out_dir", os.path.join(root, f"out{r}")] for r in range(2)])


def _finish(procs):
    """Wait for the ranks (TIMEOUT_S from now); a rank that hangs or fails
    fails the case, and every rank is stopped. Returns their output."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _seq_inputs(B=1, NH=2, S_=64, DH=8, seed=0):
    """tests/test_parallel.py's shapes and gate ranges, drawn with numpy."""
    r = np.random.RandomState(seed)
    q, k, v = (r.randn(B, NH, S_, DH).astype(np.float32) for _ in range(3))
    ig = (0.5 * r.randn(B, NH, S_)).astype(np.float32)
    fg = (3.0 + 3.0 * r.rand(B, NH, S_)).astype(np.float32)
    return q, k, v, ig, fg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("dp"))
    jmodel = jax_hved.HVEDFusionNet(get_config("XLSTM_HVED", compute_dtype="float32",
                                               use_pallas_mlstm=False))
    jdisc = jax_hved.Discriminator(f_maps=8, kernel=3)
    rng = np.random.RandomState(7)
    x = rng.rand(4, S, S, S, 4).astype(np.float32)
    mask = (rng.rand(4, S, S, S, 3) > 0.7).astype(np.float32)
    gvars = tp.random_variables(jmodel, jnp.asarray(x[:1]), seed=8, deterministic=True,
                                recon=True)
    dvars = tp.random_variables(jdisc, jnp.asarray(np.zeros((1, S, S, S, 7), np.float32)),
                                seed=9)
    sweep_x = np.random.RandomState(0).rand(1, 24, S, S, 4).astype(np.float32)
    sweep_vars = tp.random_variables(jmodel, jnp.asarray(sweep_x[:, :S]), seed=1,
                                     deterministic=True, recon=True)
    inputs = dict(g=params_from_jax(gvars["params"], gvars["batch_stats"]),
                  d=params_from_jax(dvars["params"]), x=tp.ncdhw(x), mask=tp.ncdhw(mask),
                  keep=torch.from_numpy(KEEP),
                  sweep_g=params_from_jax(sweep_vars["params"], sweep_vars["batch_stats"]),
                  sweep_x=tp.ncdhw(sweep_x),
                  seq=tuple(torch.from_numpy(a) for a in _seq_inputs()))
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    jobs = {"dp": _start("dp", 2, workdir), "ref": _start("ref", 1, workdir),
            "seq": _start("seq", 4, workdir), "cli": _start_cli(workdir)}
    try:
        # meanwhile, the JAX G gradient at the global batch (latents at the
        # mean, as the port's deterministic=True)
        state = jtrain.TrainState(step=0, params_g=tp.to_jax(gvars["params"]),
                                  batch_stats_g=tp.to_jax(gvars["batch_stats"]),
                                  opt_state_g=None, params_d=tp.to_jax(dvars["params"]),
                                  opt_state_d=None)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_hved, "reparametrize",
                       lambda key, mu, lv, deterministic=False: mu)
            grad_fn = jtrain.make_grad_fn(jmodel, jdisc, JaxTrainConfig(crop_size=(S,) * 3))
            jloss, jgrads = grad_fn(state, jnp.asarray(x), jnp.asarray(mask),
                                    jnp.asarray(KEEP), jax.random.PRNGKey(1),
                                    jax.random.PRNGKey(2))
    finally:
        logs = {job: _finish(procs) for job, procs in jobs.items()}
    out = {job: [torch.load(os.path.join(workdir, f"{job}_rank{r}.pt"), weights_only=False)
                 for r in range(len(procs))] for job, procs in jobs.items() if job != "cli"}
    out["cli"] = dict(logs=logs["cli"], root=workdir)
    out["jax"] = dict(loss=float(jloss), grads=params_from_jax(jax.device_get(jgrads)))
    out["inputs"] = inputs
    return out


def _scaled(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


# ------------------------------------------------------------ data parallel steps

def test_grad_fn_two_ranks_equal_one_process(runs):
    """JAX's test_grads_dp_equal_single_device: the averaged G gradient of 2
    ranks at batch 2 against one process at batch 4, scaled error < 1e-4,
    loss within 1e-5; both ranks hold the same gradient."""
    ref = runs["ref"][0]
    r0, r1 = runs["dp"]
    assert set(r0["grads"]) == set(ref["grads"])
    for name, want in ref["grads"].items():
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
        assert _scaled(r0["grads"][name], want) < 1e-4, name
    assert r0["grad_loss"] == r1["grad_loss"]
    assert abs(r0["grad_loss"] - ref["grad_loss"]) < 1e-5


def test_grad_fn_two_ranks_equal_jax(runs):
    """The 2-rank G gradient against the JAX package's make_grad_fn at the
    global batch on the same weights: relative L2 over all tensors <=
    JAX_REL_L2, the loss to rtol 1e-4. At this input JAX's fp32 gradient is
    the noisy one: an fp64 run of the port lies 2.03e-2 (relative L2) from
    JAX's fp32 gradient and 1.13e-3 from the port's fp32 one (the one
    process at batch 4 and the 2 ranks alike), so the bound is 1.5 times
    JAX's own distance. A gradient off by the rank count fails it, and so
    does per-rank BatchNorm; per-rank dice stays inside it and fails the
    one-process comparison above."""
    want, got = runs["jax"]["grads"], runs["dp"][0]["grads"]
    assert set(got) == set(want)
    num = sum(float(((got[n].double() - w.double()) ** 2).sum()) for n, w in want.items())
    den = sum(float((w.double() ** 2).sum()) for w in want.values())
    assert (num / den) ** 0.5 <= JAX_REL_L2
    np.testing.assert_allclose(runs["dp"][0]["grad_loss"], runs["jax"]["loss"], rtol=1e-4)


def test_train_step_two_ranks_equal_one_process(runs):
    """JAX's test_train_step_dp_equals_single_device, and the BatchNorm
    running statistics: equal on both ranks, and to the one process within
    1e-6. The metrics are the same on both ranks."""
    ref = runs["ref"][0]
    r0, r1 = runs["dp"]
    assert r0["step_metrics"] == r1["step_metrics"]
    for key in ("loss", "loss_d"):
        assert abs(r0["step_metrics"][key] - ref["step_metrics"][key]) < 1e-5, key
    assert r0["step_metrics"]["subset_idx"] == ref["step_metrics"]["subset_idx"]
    for part in ("step_g", "step_d"):
        for name, want in ref[part].items():
            assert torch.equal(r0[part][name], r1[part][name]), name
            assert _max_abs(r0[part][name], want) < 3e-4, name
    assert r0["step_stats"]
    for name, want in ref["step_stats"].items():
        assert torch.equal(r0["step_stats"][name], r1["step_stats"][name]), name
        assert _max_abs(r0["step_stats"][name], want) < 1e-6, name


def test_pretrain_step_two_ranks_equal_one_process(runs):
    ref = runs["ref"][0]
    r0, r1 = runs["dp"]
    assert r0["pre_metrics"] == r1["pre_metrics"]
    assert abs(r0["pre_metrics"]["loss"] - ref["pre_metrics"]["loss"]) < 1e-5
    for name, want in ref["pre_g"].items():
        assert _max_abs(r0["pre_g"][name], want) < 3e-4, name


# ------------------------------------------------------------ the sharded sweep

@pytest.mark.parametrize("job,world", [("dp", 2), ("seq", 4)], ids=["world2", "world4"])
def test_sharded_sweep_equals_hoisted(runs, job, world):
    """JAX's test_sharded_subset_sweep_equals_single_device: every rank
    returns the whole 15-subset result, equal to the one-process hoisted
    sweep within 2e-6 (the one process, like the ranks, on one thread: the
    CPU convolutions sum in another order on another thread count)."""
    seg_1, rec_1 = runs["ref"][0]["hoisted"]
    assert len(runs[job]) == world
    for out in runs[job]:
        assert out["seg"].shape == (15, 1, 3, 24, S, S)
        np.testing.assert_allclose(out["seg"].numpy(), seg_1.numpy(), atol=2e-6)
        np.testing.assert_allclose(out["rec"].numpy(), rec_1.numpy(), atol=2e-6)


# ------------------------------------------------------------ collectives

def test_allreduce_averages_uneven_ranks(runs):
    """JAX's tests/test_multiprocess.py case: rank 0 holds [1, 2], the
    others [3, 4, 5]; every rank gets the global mean."""
    for out in runs["dp"]:
        assert out["avg"] == pytest.approx(3.0, abs=1e-12)
    for out in runs["seq"]:
        assert out["avg"] == pytest.approx((3.0 + 3 * 12.0) / 11.0, abs=1e-12)


def test_allreduce_averages_single_process():
    a, b = RunningAverage(), RunningAverage()
    a.update(1.0), a.update(3.0)
    b.update(10.0, n=4)
    assert pmesh.allreduce_averages({"a": a, "b": b}) == {"a": 2.0, "b": 10.0}


def test_global_sum_and_its_gradient(runs):
    """Rank r contributes (r + 1) * x; the backward sums every rank's
    upstream gradient: d sum(y) / dx = world * (r + 1)."""
    for job in ("dp", "seq"):
        world = len(runs[job])
        for r, out in enumerate(runs[job]):
            assert torch.equal(out["sum"], torch.full((3,), world * (world + 1) / 2.0))
            assert torch.equal(out["dsum"], torch.full((3,), float(world * (r + 1))))


def test_one_process_collectives_do_nothing():
    """No group: the reductions return their inputs, the gradients and
    metrics pass as they are, the mesh is one rank."""
    x, y = torch.ones(3), torch.zeros(2)
    mesh = pmesh.make_mesh(device="cpu")
    assert (mesh.data, mesh.seq, mesh.world) == (1, 1, 1) and mesh.data_group is None
    with mesh:
        sx, sy = pmesh.global_sums(x, y)
        assert sx is x and sy is y
        grads = [x, y]
        assert all(a is b for a, b in zip(pmesh.average_gradients(grads), grads))
        m = x[0]
        assert pmesh.average_metrics({"m": m})["m"] is m
        assert list(pmesh.in_lockstep([1, 2], mesh)) == [1, 2]
    with pytest.raises(ValueError, match="needs 2 ranks"):
        pmesh.make_mesh(data=2, device="cpu")


def test_local_rank_past_the_device_count_raises(monkeypatch):
    """A bare 'cuda' is cuda:$LOCAL_RANK, an explicit index is kept, and an
    index the host does not have raises: never a quiet remap."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="LOCAL_RANK 2"):
        pmesh.rank_device("cuda")
    with pytest.raises(ValueError, match="cuda:3"):
        pmesh.rank_device("cuda:3")
    assert pmesh.rank_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "0")
    assert pmesh.rank_device("cuda") == torch.device("cuda", 0)
    assert pmesh.rank_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------ sequence parallelism

def test_segment_summary_and_combine_match_jax():
    q, k, v, ig, fg = _seq_inputs(S_=32)
    t = [torch.from_numpy(a) for a in (k, v, ig, fg)]
    want = jseq.segment_summary(*(jnp.asarray(a) for a in (k, v, ig, fg)))
    got = pseq.segment_summary(*t)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    halves = [pseq.segment_summary(*(a[..., sl, :] if a.ndim == 4 else a[..., sl]
                                     for a in t)) for sl in (slice(0, 16), slice(16, 32))]
    jhalves = [jseq.segment_summary(*(jnp.asarray(a[..., sl, :] if a.ndim == 4 else a[..., sl])
                                      for a in (k, v, ig, fg)))
               for sl in (slice(0, 16), slice(16, 32))]
    combined = pseq.combine_summaries(*halves)
    for a, b, c in zip(combined, jseq.combine_summaries(*jhalves), got):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-4, atol=1e-4)
    ident = pseq.identity_summary(1, 2, 8)
    for a, b in zip(pseq.combine_summaries(ident, got), got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_chunkwise_init_state_matches_jax():
    """The boundary state carried from one half into the other, against JAX's
    mlstm_chunkwise(init_state=...), and the two halves stitched against the
    whole sequence."""
    q, k, v, ig, fg = _seq_inputs()
    t = [torch.from_numpy(a) for a in (q, k, v, ig, fg)]
    first = [a[:, :, :32] for a in t]
    second = [a[:, :, 32:] for a in t]
    h1, st = mlstm_chunkwise(*first, chunk_size=16, return_state=True)
    h2 = mlstm_chunkwise(*second, chunk_size=16, init_state=st)
    jh1, jst = jmlstm.mlstm_chunkwise(*(jnp.asarray(a[:, :, :32]) for a in (q, k, v, ig, fg)),
                                      chunk_size=16, return_state=True)
    jh2 = jmlstm.mlstm_chunkwise(*(jnp.asarray(a[:, :, 32:]) for a in (q, k, v, ig, fg)),
                                 chunk_size=16, init_state=jst)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(jh2), rtol=1e-4, atol=1e-5)
    full = mlstm_chunkwise(*t, chunk_size=16)
    np.testing.assert_allclose(torch.cat([h1, h2], dim=2).numpy(), full.numpy(),
                               rtol=1e-3, atol=1e-4)


def test_sequence_parallel_four_ranks_matches_quadratic(runs):
    """JAX's test_sequence_parallel_matches_quadratic: the token axis over 4
    ranks (16 tokens each, chunk 8) against the whole-sequence quadratic
    form, atol 1e-4, rtol 1e-3; every rank returns the whole h."""
    want = mlstm_quadratic(*runs["inputs"]["seq"])
    for out in runs["seq"]:
        np.testing.assert_allclose(out["h"].numpy(), want.numpy(), atol=1e-4, rtol=1e-3)


def test_sequence_parallel_gradient_matches_quadratic(runs):
    """Each of the 4 ranks backpropagates sum(h) of the whole gathered h; the
    gradients reach each segment's owner through the gathers' backward, so
    the ranks' input gradients added up are 4 times the whole-sequence
    quadratic form's gradient of sum(h), for q, k, v and both gates."""
    inputs = [t.clone().requires_grad_(True) for t in runs["inputs"]["seq"]]
    mlstm_quadratic(*inputs).sum().backward()
    for i, t in enumerate(inputs):
        got = sum(out["grads"][i] for out in runs["seq"])
        np.testing.assert_allclose(got.numpy(), 4 * t.grad.numpy(), atol=1e-3, rtol=1e-3)


# ------------------------------------------------------------ the train CLI

CLI_ARGS = ["--distributed", "--device", "cpu", "--crop_size", "16", "16", "16",
            "--num_epochs", "1", "--disc_kernel", "3", "--disc_fmaps", "8",
            "--compute_dtype", "float32", "--disc_dtype", "float32", "--num_processes", "2",
            "--num_data_devices", "2"]
CLI_RUN = ("import json, sys; from xlstm_hved_torch.cli import train; "
           "s = train.main(sys.argv[1:]); "
           "print('SUMMARY ' + json.dumps({'step': s['step'], "
           "'epochs': [(e['steps'], e['valid_items']) for e in s['epochs']]}))")


def test_cli_train_distributed_two_ranks(runs):
    """cli.train --distributed on 2 gloo ranks with an uneven shard (3
    training subjects): both ranks end, with the same step count (the
    shorter shard's); only rank 0 prints the epoch and writes."""
    logs, root = runs["cli"]["logs"], runs["cli"]["root"]
    summaries = [json.loads(next(l for l in log.splitlines() if l.startswith("SUMMARY "))[8:])
                 for log in logs]
    assert summaries[0] == summaries[1] == {"step": 1, "epochs": [[1, 1]]}
    assert "Epoch [1/1]" in logs[0] and "Epoch [" not in logs[1]
    out0 = os.path.join(root, "out0", "XLSTM_HVED")
    assert os.path.isfile(os.path.join(out0, "latest", "state.pt"))
    with open(os.path.join(out0, "loss_and_metrics.csv")) as f:
        assert len(f.read().splitlines()) == 2
    written = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(root, "out1"))
               for f in fs]
    assert written == []


def test_num_data_devices_must_match_the_processes(tmp_path):
    """One process drives one device: --num_data_devices is 0 or the number
    of processes, and another count raises naming torchrun, for every CLI
    (here one process, so 3 is refused before anything is written)."""
    argv = ["--device", "cpu", "--num_data_devices", "3", "--out_dir", str(tmp_path),
            "--train_dir", str(tmp_path), "--valid_dir", str(tmp_path)]
    for main in (train.main, pretrain.main):
        with pytest.raises(ValueError, match="torchrun"):
            main(argv)
    assert not os.listdir(tmp_path)
