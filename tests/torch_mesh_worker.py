"""One rank of the port's multi-process CPU tests (``gloo``), started by
``tests/test_torch_multiprocess.py`` as ``python tests/torch_mesh_worker.py
MODE PAYLOAD OUT`` with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``). Imports torch and the port only.

Modes:
  * ``multihost``: ``initialize_distributed`` from the environment, an
    all-reduce across the processes, ``is_main_process`` gating a file;
  * ``mesh``: the tiny system of ``PAYLOAD`` on a ``(data, fsdp, model)``
    mesh of ``PAYLOAD["mesh"]``: train steps (also at non-zero dropout
    rates, from a seeded generator), the masked loss with rows whose masks
    differ, greedy and sampled generation, checkpoints both ways.
    Rank 0 writes what the test compares into ``OUT``.
"""

import os
import sys

import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vaura_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed,
    is_main_process,
)


def multihost(out):
    import torch.distributed as dist

    assert initialize_distributed(device_type="cpu")
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == int(os.environ["WORLD_SIZE"]) and rank == int(
        os.environ["RANK"])
    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    assert x.item() == world * (world + 1) / 2, x
    if is_main_process():
        with open(os.path.join(out, "main.txt"), "a") as f:
            f.write(f"main from rank {rank}\n")
    dist.barrier()
    print(f"MULTIHOST-OK rank={rank} sum={x.item()}")


def _system(payload):
    from vaura_tpu_torch.models.vaura import VauraSystem

    scfg, dcfg, ecfg = payload["configs"]
    system = VauraSystem(scfg, dcfg, ecfg, device="cpu",
                         freeze_feature_extractor=payload.get("freeze", False))
    system.load_state_dicts(payload["state_dicts"])
    return system


def _sharded(payload, mesh):
    from vaura_tpu_torch.parallel import shard_module

    system = _system(payload)
    shard_module(system, mesh)
    return system


def _train(payload, mesh, opt_kw, batches, generator=None):
    """Steps of the sharded system from the payload's weights (masks from
    ``generator``); returns the losses, the per-codebook losses and the
    state."""
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import (
        batch_to_device,
        make_train_step,
        split_params,
    )

    system = _sharded(payload, mesh)
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(**opt_kw),
                              system.placement)
    step = make_train_step(system)
    losses, per_cb = [], []
    for b in batches:
        state, m = step(state, batch_to_device(b, "cpu", mesh=mesh),
                        generator)
        losses.append(float(m["loss"]))
        per_cb.append(m["loss_per_codebook"].clone())
    return system, state, losses, per_cb


def _masked_loss(payload, system):
    """Every rank's rows of one global batch of logits whose masks differ
    from row to row: the whole batch's loss and its gradient, gathered."""
    from vaura_tpu_torch.ops.losses import masked_codebook_cross_entropy

    pl = system.placement
    g = payload["masked"]
    rows = slice(pl.batch_rank * g["logits"].shape[0] // pl.batch_size,
                 (pl.batch_rank + 1) * g["logits"].shape[0] // pl.batch_size)
    logits = g["logits"][rows].clone().requires_grad_(True)
    loss, per_cb = masked_codebook_cross_entropy(
        logits, g["targets"][rows], g["mask"][rows], pl.batch_sum)
    loss.backward()
    return {"loss": pl.batch_sum(loss), "per_cb": pl.batch_sum(per_cb),
            "grad": pl.gather_rows(logits.grad, "all")}


def mesh_run(payload, out):
    from vaura_tpu_torch.parallel import make_mesh

    initialize_distributed(device_type="cpu")  # no group for a world of 1
    d, f, m = payload["mesh"]
    mesh = make_mesh(d, f, m, device_type="cpu")
    result = {}
    batches = payload["batches"]
    if "train" in payload:
        system, state, losses, per_cb = _train(
            payload, mesh, payload["train"], batches)
        sd = state.state_dict()  # every rank: gathers the whole leaves
        result.update(losses=losses, per_cb=per_cb, state=sd)
        result["masked"] = _masked_loss(payload, system)
    if "train_norm" in payload:
        _, state, losses, _ = _train(payload, mesh, payload["train_norm"],
                                     batches)
        result.update(norm_losses=losses, norm_state=state.state_dict())
    if "stochastic" in payload:
        st = payload["stochastic"]
        _, state, losses, _ = _train(
            {**payload, "configs": st["configs"]}, mesh, payload["train"],
            batches, torch.Generator().manual_seed(st["seed"]))
        result.update(stochastic_losses=losses,
                      stochastic_state=state.state_dict())
    if "resume" in payload:
        # a one-process checkpoint into the mesh, and back out whole
        from vaura_tpu_torch.train.state import TrainState, make_optimizer
        from vaura_tpu_torch.train.steps import split_params

        system = _sharded(payload, mesh)
        trainable, _ = split_params(system)
        state = TrainState.create(trainable,
                                  make_optimizer(**payload["train"]),
                                  system.placement)
        state.load_state_dict(payload["resume"])
        result["resumed"] = state.state_dict()
    gen = payload.get("generate")
    if gen is not None:
        from vaura_tpu_torch.parallel.mesh import batch_rows

        system = _sharded(payload, mesh)
        frames = gen["frames"][batch_rows(mesh, gen["frames"].shape[0])]
        for tag, kw in gen["runs"].items():
            r = system.generate(frames, gather="main", **kw)
            if is_main_process():
                result[tag] = {k: r[k] for k in ("codes", "audio") if k in r}
    if is_main_process():
        torch.save(result, os.path.join(out, "result.pt"))
    print(f"MESH-OK rank={torch.distributed.get_rank()}")


if __name__ == "__main__":
    mode, payload_path, out_dir = sys.argv[1:4]
    if mode == "multihost":
        multihost(out_dir)
    else:
        mesh_run(torch.load(payload_path, weights_only=False), out_dir)
    torch.distributed.destroy_process_group()
