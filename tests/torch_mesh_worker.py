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
    differ, greedy and sampled generation, greedy generation with LoRA
    adapters (``PAYLOAD["lora"]``), checkpoints both ways; with
    ``PAYLOAD["lora_train"]`` those adapters trained on the mesh
    (``_lora_train``).
    Rank 0 writes what the test compares into ``OUT``;
  * ``serve``: the generation server (``vaura_tpu_torch/scripts/serve.py``)
    of the tiny ``dummy.yaml`` geometry, one ``GenerationService`` per
    scenario of ``PAYLOAD["scenarios"]`` on every rank: rank 0 serves HTTP
    on a free port and drives the scenario's requests (bursts, lone
    requests, streams, clips, reloads, health), recording every batch its
    ``_generate`` ran; the other ranks follow (a scenario with ``control``
    sets the control channel's timeout and heartbeat, and its followers
    record when each header came). A scenario may instead call
    ``_generate`` on every rank with a float32 system, or expect the
    service to raise. Every rank writes ``result<rank>.pt`` into ``OUT``;
  * ``serve_fail``: ``run_server`` (the ``action=serve`` CLI, argv in
    ``PAYLOAD``), with rank 1's ``GenerationService._generate`` patched to
    raise on its first call after the warm-up.
"""

import contextlib
import os
import sys
import time

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


def _system(payload, lora=None):
    """The payload's system; with ``lora`` (``PAYLOAD["lora"]``) its
    adapters too."""
    from vaura_tpu_torch.models.vaura import VauraSystem

    scfg, dcfg, ecfg = payload["configs"]
    sds = payload["state_dicts"]
    kw = {}
    if lora is not None:
        kw = dict(lora_rank=lora["rank"], lora_alpha=lora["alpha"])
        sds = dict(sds, lora_sampler=lora["state_dict"])
    system = VauraSystem(scfg, dcfg, ecfg, device="cpu",
                         freeze_feature_extractor=payload.get("freeze", False),
                         **kw)
    system.load_state_dicts(sds)
    return system


def _sharded(payload, mesh, lora=None):
    from vaura_tpu_torch.parallel import shard_module

    system = _system(payload, lora)
    shard_module(system, mesh)
    return system


def _train(payload, mesh, opt_kw, batches, generator=None, lora=None):
    """Steps of the sharded system from the payload's weights (masks from
    ``generator``; with ``lora``, its adapters train); returns the losses,
    the per-codebook losses and the state."""
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import (
        batch_to_device,
        make_train_step,
        split_params,
    )

    system = _sharded(payload, mesh, lora)
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


def _lora_train(payload, mesh, batches):
    """The adapters of ``PAYLOAD["lora"]`` trained on the mesh: two steps
    with value clipping, two with norm clipping, two with the stochastic
    configs (remat, every rate on) from a seeded generator; each run's
    losses and gathered state, the base sampler gathered after the first,
    and ``PAYLOAD["lora_train"]["resume"]`` (a one-process LoRA state) into
    the mesh and gathered back."""
    from vaura_tpu_torch.train.state import TrainState, make_optimizer
    from vaura_tpu_torch.train.steps import split_params

    lora, st = payload["lora"], payload["stochastic"]
    out = {}
    for tag, opt, extra, gen in (
            ("value", payload["train"], {}, None),
            ("norm", payload["train_norm"], {}, None),
            ("stochastic", payload["train"], {"configs": st["configs"]},
             torch.Generator().manual_seed(st["seed"]))):
        system, state, losses, _ = _train({**payload, **extra}, mesh, opt,
                                          batches, gen, lora)
        out[tag] = {"losses": losses, "state": state.state_dict()}
        if tag == "value":  # every rank gathers the base
            pl = system.placement
            out["base"] = {n: pl.full(f"sampler.{n}", p) for n, p in
                           system.sampler.named_parameters()}
    system = _sharded(payload, mesh, lora)
    trainable, _ = split_params(system)
    state = TrainState.create(trainable, make_optimizer(**payload["train"]),
                              system.placement)
    state.load_state_dict(payload["lora_train"]["resume"])
    out["resumed"] = state.state_dict()
    return out


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
    if payload.get("lora_train"):
        result["lora_train"] = _lora_train(payload, mesh, batches)
    gen = payload.get("generate")
    if gen is not None:
        from vaura_tpu_torch.parallel.mesh import batch_rows

        system = _sharded(payload, mesh)
        frames = gen["frames"][batch_rows(mesh, gen["frames"].shape[0])]
        for tag, kw in gen["runs"].items():
            r = system.generate(frames, gather="main", **kw)
            if is_main_process():
                result[tag] = {k: r[k] for k in ("codes", "audio") if k in r}
    lora = payload.get("lora")
    if lora is not None:  # adapters placed for generation alone
        from vaura_tpu_torch.parallel import shard_module
        from vaura_tpu_torch.parallel.mesh import batch_rows

        system = _system(payload, lora)
        shard_module(system, mesh, train=False)
        frames = gen["frames"][batch_rows(mesh, gen["frames"].shape[0])]
        r = system.generate(frames, gather="main", decode_to_audio=False,
                            **lora["kw"])
        if is_main_process():
            result["lora"] = {"codes": r["codes"]}
    if is_main_process():
        torch.save(result, os.path.join(out, "result.pt"))
    print(f"MESH-OK rank={torch.distributed.get_rank()}")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _serve_cfg(overrides):
    from vaura_tpu_torch.config import assemble_config

    cfg = dict(assemble_config(
        [f"config={os.path.join(REPO, 'configs/experiments/dummy.yaml')}",
         "trainer.platform=cpu"],
        defaults_path=os.path.join(REPO, "configs", "vaura_defaults.yaml"),
        base_dir=REPO))
    cfg.update(overrides)
    return cfg


def _post(base, path, payload):
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _drive(svc, base, op):
    """One request op of a scenario on rank 0; returns its record."""
    import concurrent.futures
    import json
    import urllib.request

    import numpy as np

    kind = op["op"]
    if kind in ("burst", "lone"):
        feats = op["feats"] if kind == "burst" else [op["feats"]]
        with concurrent.futures.ThreadPoolExecutor(len(feats)) as ex:
            got = list(ex.map(lambda f: _post(
                base, "/generate?raw=codes", {"features": f.tolist()}),
                feats))
        return {"codes": [np.asarray(body["codes"]) for _, body in got],
                "status": [code for code, _ in got]}
    if kind == "stream":
        # the chunks' codes, tapped from the served system's stream
        increments, codes, seed = [], [], svc._next_seed
        system = svc.system
        for name in ("generate_long_stream", "generate_long_kv_stream"):
            def tapped(*a, _fn=getattr(system, name), **k):
                for chunk in _fn(*a, **k):
                    codes.append(chunk["codes"].clone())
                    yield chunk

            setattr(system, name, tapped)
        try:
            svc.submit_stream(op["feats"], increments.append)
        finally:
            del system.generate_long_stream, system.generate_long_kv_stream
        return {"increments": increments, "codes": codes, "seed": seed}
    if kind == "frames":
        feats = svc.frames_to_features(op["frames"])
        code, body = _post(base, "/generate?raw=codes",
                           {"features": feats.tolist()})
        return {"features": feats, "status": code,
                "codes": np.asarray(body["codes"])}
    if kind == "reload":
        code, body = _post(base, "/reload", {"ckpt_path": op["path"]})
        return {"status": code, "body": body}
    if kind == "busy":
        # one lone request after another for op["seconds"]: the queue is
        # never empty for long, so a heartbeat sent only while idle stops
        t0, status = time.monotonic(), []
        rng = np.random.default_rng(0)
        while time.monotonic() - t0 < op["seconds"]:
            code, _ = _post(base, "/generate?raw=codes", {
                "features": rng.standard_normal((4, 24)).tolist()})
            status.append(code)
        return {"status": status, "seconds": time.monotonic() - t0}
    if kind == "health":
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
        metrics = urllib.request.urlopen(base + "/metrics").read().decode()
        return {"healthz": health, "metrics": metrics}
    raise ValueError(kind)


def _scenario(sc):
    """One scenario on this rank; rank 0's record of it."""
    import threading
    from http.server import ThreadingHTTPServer

    from vaura_tpu_torch.scripts.serve import GenerationService, make_handler

    cfg = _serve_cfg(sc["cfg"])
    if sc.get("expect_error"):
        try:
            GenerationService(cfg)
        except ValueError as e:
            return {"error": str(e)}
        raise AssertionError(f"{sc['name']}: the service did not raise")
    svc = GenerationService(cfg)
    rec = {"leader": svc.leader, "mesh": svc.mesh_shape,
           "holds_system": svc.system is not None}
    if sc.get("gate") is not None:
        svc._quantize_min_agreement = sc["gate"]
    f32 = sc.get("f32")
    if f32 is not None:  # _generate of a float32 system, on every rank
        from vaura_tpu_torch.models.factory import build_system
        from vaura_tpu_torch.parallel import shard_module

        system = build_system(f32["model"], precision="f32", device="cpu")
        system.load_state_dicts(f32["state_dicts"])
        system.requires_grad_(False)
        shard_module(system, svc.mesh, train=False)
        svc.system = system
        with torch.inference_mode():
            out = svc._generate(svc._put_batch(f32["feats"]), f32["seed"])
        if svc.leader:
            rec.update(codes=out["codes"].clone(),
                       audio=out["audio"].float().clone())
        return rec
    svc.start()
    if not svc.leader:
        if sc.get("control"):  # when each header reached this rank
            rec["headers"] = [(time.monotonic(), "start")]
            broadcast = svc.channel.broadcast

            def timed(*a, **k):
                header, tensors = broadcast(*a, **k)
                rec["headers"].append((time.monotonic(), header["kind"]))
                return header, tensors

            svc.channel.broadcast = timed
        svc.follow()
        return rec
    batches, generate = [], svc._generate

    def record(feats, seed, sampling=None):
        out = generate(feats, seed, sampling)
        batches.append({"feats": feats.clone(), "seed": seed,
                        "reloads": svc._metrics["reloads_total"],
                        "codes": out["codes"].clone(),
                        "audio": out["audio"].float().clone()})
        return out

    svc._generate = record
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        rec["ops"] = [_drive(svc, base, op) for op in sc["ops"]]
    finally:
        httpd.shutdown()
        rec["drained"] = svc.close(timeout=60)
    if svc.failed is not None:
        raise RuntimeError(f"{sc['name']}: the server stopped") from svc.failed
    rec["batches"] = batches
    return rec


@contextlib.contextmanager
def _control(control):
    """The control channel's timeout and heartbeat of a scenario (seconds;
    the defaults without ``control``)."""
    from vaura_tpu_torch.parallel import multihost as mh

    saved = mh.CONTROL_TIMEOUT_S, mh.HEARTBEAT_S
    if control:
        mh.CONTROL_TIMEOUT_S = control["timeout_s"]
        mh.HEARTBEAT_S = control["heartbeat_s"]
    try:
        yield
    finally:
        mh.CONTROL_TIMEOUT_S, mh.HEARTBEAT_S = saved


def serve_run(payload, out):
    initialize_distributed(device_type="cpu")
    rank = torch.distributed.get_rank()
    result = {}
    for sc in payload["scenarios"]:
        with _control(sc.get("control")):
            result[sc["name"]] = _scenario(sc)
        print(f"SCENARIO-OK {sc['name']} rank={rank}", flush=True)
    torch.save(result, os.path.join(out, f"result{rank}.pt"))
    print(f"SERVE-OK rank={rank}", flush=True)


def serve_fail(payload):
    """The ``action=serve`` CLI (``main`` of ``PAYLOAD["argv"]``); rank 1
    raises in its first ``_generate`` after the warm-up (one call a
    bucket)."""
    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.scripts import serve

    if int(os.environ["RANK"]) == 1:
        generate, calls = serve.GenerationService._generate, []

        def fail_after_warmup(self, *args, **kwargs):
            calls.append(1)
            if len(calls) > len(self.batch_buckets):
                raise RuntimeError("a follower's job fails (test patch)")
            return generate(self, *args, **kwargs)

        serve.GenerationService._generate = fail_after_warmup
    main(payload["argv"])


if __name__ == "__main__":
    mode, payload_path, out_dir = sys.argv[1:4]
    if mode == "multihost":
        multihost(out_dir)
    elif mode == "serve":
        serve_run(torch.load(payload_path, weights_only=False), out_dir)
    elif mode == "serve_fail":
        serve_fail(torch.load(payload_path, weights_only=False))
    else:
        mesh_run(torch.load(payload_path, weights_only=False), out_dir)
    torch.distributed.destroy_process_group()
