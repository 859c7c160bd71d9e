"""One rank of the data- and sequence-parallel checks of
`tests/test_torch_parallel.py`, on the CPU under gloo:

    python tests/_torch_dp_worker.py JOB RANK WORLD PORT WORKDIR

joins the group at tcp://127.0.0.1:PORT and runs the job's parts on the
inputs the test wrote to WORKDIR/inputs.pt, writing WORKDIR/JOB_rankR.pt.
JOB "ref" is the one-process reference (no group): the "dp" part at the
global batch and the hoisted sweep. Imports torch and the port only.
"""
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from xlstm_hved_torch.config import TrainConfig  # noqa: E402
from xlstm_hved_torch.engine.evaluate import (make_hoisted_subset_sweep,  # noqa: E402
                                              make_sharded_subset_sweep)
from xlstm_hved_torch.engine.train import (create_train_state, make_grad_fn,  # noqa: E402
                                           make_pretrain_step, make_train_step)
from xlstm_hved_torch.models import Discriminator, find_model_using_name  # noqa: E402
from xlstm_hved_torch.parallel.mesh import (allreduce_averages, global_sums,  # noqa: E402
                                            initialize_distributed, make_mesh, shard_batch)
from xlstm_hved_torch.parallel.seq import make_sharded_mlstm  # noqa: E402
from xlstm_hved_torch.utils.logging import RunningAverage  # noqa: E402

torch.set_num_threads(1)
SEED = 3


def models(inp):
    model = find_model_using_name("XLSTM_HVED", device="cpu")
    disc = Discriminator(f_maps=8, kernel=3)
    model.load_state_dict(inp["g"], strict=True)
    disc.load_state_dict(inp["d"], strict=True)
    return model, disc


def fresh_state(inp, cfg, x):
    """A train state (Adam for G and D, the seeded generators) on the
    test's weights: create_train_state draws its own, which are replaced."""
    model, disc = models(inp)
    state = create_train_state(model, disc, cfg, SEED, x)
    model.load_state_dict(inp["g"], strict=True)
    disc.load_state_dict(inp["d"], strict=True)
    return state


def stats(model):
    return {n: b.clone() for n, b in model.named_buffers() if "running_" in n}


def dp_part(inp, mesh):
    """make_grad_fn, one make_train_step and one make_pretrain_step on this
    rank's rows (all of them with no group)."""
    cfg = TrainConfig(crop_size=tuple(inp["x"].shape[2:]), num_epochs=10)
    x, mask = shard_batch(mesh, (inp["x"], inp["mask"]))
    out = {}
    with mesh:
        model, disc = models(inp)
        loss, grads = make_grad_fn(model, disc, cfg)(x, mask, inp["keep"], deterministic=True)
        out["grad_loss"], out["grads"] = float(loss), grads

        state = fresh_state(inp, cfg, x)
        state, m = make_train_step(state.model, state.disc, cfg)(state, x, mask)
        out["step_metrics"] = {k: float(v) for k, v in m.items()}
        out["step_g"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        out["step_d"] = {n: p.detach().clone() for n, p in state.disc.named_parameters()}
        out["step_stats"] = stats(state.model)

        state = fresh_state(inp, cfg, x)
        state, m = make_pretrain_step(state.model, cfg)(state, x)
        out["pre_metrics"] = {k: float(v) for k, v in m.items()}
        out["pre_g"] = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    return out


def sweep_part(inp, mesh=None):
    """The sharded 15-subset sweep over the mesh's data axis; with no mesh
    the one-process hoisted sweep."""
    model = find_model_using_name("XLSTM_HVED", device="cpu")
    model.load_state_dict(inp["sweep_g"], strict=True)
    S = inp["sweep_x"].shape[-1]
    if mesh is None:
        sweep = make_hoisted_subset_sweep(model, (S, S, S), recon_channels=4)
        return {"hoisted": sweep(model, inp["sweep_x"])}
    sweep = make_sharded_subset_sweep(model, mesh, patch=(S, S, S), recon_channels=4)
    seg, rec = sweep(model, inp["sweep_x"])
    return {"seg": seg, "rec": rec}


def seq_part(inp, world):
    """The sequence-parallel mLSTM over every rank, and the gradient of the
    gathered sum(h) with respect to the (global) inputs on this rank."""
    mesh = make_mesh(data=1, seq=world, device="cpu")
    inputs = [t.clone().requires_grad_(True) for t in inp["seq"]]
    h = make_sharded_mlstm(mesh, chunk_size=8)(*inputs)
    h.sum().backward()
    return {"h": h.detach(), "grads": [t.grad for t in inputs]}


def collectives_part(rank):
    """allreduce_averages of uneven accumulators, and the gradient of a
    global sum (every rank's upstream gradient summed)."""
    avg = RunningAverage()
    for v in ([1.0, 2.0] if rank == 0 else [3.0, 4.0, 5.0]):
        avg.update(v)
    x = torch.ones(3, requires_grad=True)
    with make_mesh(device="cpu"):
        (y,) = global_sums(x * (rank + 1))
    y.sum().backward()
    return {"avg": allreduce_averages({"m": avg})["m"], "sum": y.detach(), "dsum": x.grad}


def main():
    job, rank, world, port, workdir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    if job == "ref":
        out = dp_part(inp, make_mesh(device="cpu"))
        out.update(sweep_part(inp))
    else:
        initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
        mesh = make_mesh(device="cpu")
        out = collectives_part(rank)
        out.update(sweep_part(inp, mesh))
        if job == "dp":
            out.update(dp_part(inp, mesh))
        else:
            out.update(seq_part(inp, world))
    torch.save(out, os.path.join(workdir, f"{job}_rank{rank}.pt"))


if __name__ == "__main__":
    main()
