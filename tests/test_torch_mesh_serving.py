"""The port's server across several processes (``mesh_serving``,
``vaura_tpu_torch/scripts/serve.py``) on the CPU with gloo, at the tiny
``dummy.yaml`` geometry of ``tests/test_torch_serve.py``.

One spawn of 2 processes (``tests/torch_mesh_worker.py serve``) runs a
``GenerationService`` per scenario on both ranks: rank 0 serves HTTP and
drives the requests, recording every batch its ``_generate`` ran (padded
features, seed, codes, audio); rank 1 follows. Held against one process's
``GenerationService`` of the same config, here:

  * (a) bursts over buckets [2, 4] on a data mesh of 2: every batch's
    codes equal one process's ``_generate`` on the same padded batch and
    seed, sampled and greedy (audio within 1e-4 relative RMS: each rank
    decodes its rows); each reply is its row of its batch;
  * (b) a stream in each ``stream_mode``: the chunks' codes equal one
    process's and the audio increments within 1e-5;
  * (c) ``/reload``: the batches after it equal one process's after the
    same reload (both ranks' rows); a reload the int8 gate refuses answers
    400 and the batches after it keep the old weights' codes;
  * (d) ``quantize=true`` and ``quantize=cache`` serve on the mesh (their
    batches equal one process's);
  * (e) a clip's frames through the encoder as a job of every rank: the
    features equal one process's, also with the encoder (unfrozen) and the
    sampler sharded over fsdp 2, whose reload places new modules;
  * (f) a bucket that ``data * fsdp`` does not divide raises ``ValueError``;
  * (i) ``mesh_serving=false``: rank 0 serves alone, rank 1 holds no
    model; under requests that keep rank 0 busy for longer than the
    control channel's timeout, rank 1 gets heartbeats and stays up;
  * the JAX package's ``GenerationService._generate`` against the mesh
    server's, greedy in float32 on the same converted weights: codes equal,
    audio within 1e-3 relative RMS.

Two launches through ``torchrun`` (``python -m torch.distributed.run
--nproc_per_node=2``): (h) ``action=serve`` serves, and SIGTERM to both
workers drains rank 0, ends rank 1 through rank 0's shutdown header, and
every process exits 0; (g) a follower patched to raise in its first job
(inside the worker script) ends the run non-zero within the time limit.
"""

import concurrent.futures
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_multiprocess import spawn, wait
from test_torch_serve import (
    GEOMETRY,
    _cfg,
    _random_trainable_checkpoint,
    jax_service_tree,
    make_jax_service,
)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_mesh_worker.py"
TIMEOUT_S = 180
# a data mesh of 2: buckets [2, 4], a 0.6 s stream geometry
MESH = dict(GEOMETRY, batch=4, batch_buckets="2")
GREEDY = dict(use_sampling=False, cfg_scale=3.0)
KV = dict(stream_mode="kv", stream_chunk_steps=16, stream_window_chunks=2)
# rank 0 serving alone under requests that never leave it idle for longer
# than the control channel's timeout (seconds)
BUSY_CONTROL = {"timeout_s": 5.0, "heartbeat_s": 0.5}
BUSY_S = 7.0


def _feats(rng, n, cond=24, tv=8):
    return [rng.standard_normal((int(rng.integers(3, tv + 1)), cond)).astype(
        np.float32) for _ in range(n)]


def _segments(rng):
    return rng.standard_normal((1, 8, 24)).astype(np.float32)


def _fsdp_overrides():
    """An unfrozen encoder, the sampler and the encoder sharded over fsdp
    2 (data 1)."""
    base = _cfg()
    model = dict(base["model"], freeze_feature_extractor=False)
    trainer = dict(base.get("trainer") or {}, mesh={"data": 1, "fsdp": 2})
    return dict(MESH, model=model, trainer=trainer)


def _scenarios(root, jax_parts):
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.scripts.serve import GenerationService

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (17, 224, 224, 3), dtype=np.uint8)
    ckpt = {}
    for name, over in (("sampled", MESH), ("int8", dict(MESH, quantize=True)),
                       ("fsdp", _fsdp_overrides())):
        ref = GenerationService(_cfg(**over))
        ckpt[name] = str(_random_trainable_checkpoint(ref, root / name, 7))
    jcfg, _, tree = jax_parts
    f32 = np.zeros((2, 8, 24), np.float32)
    f32[:, :5] = np.random.default_rng(4).standard_normal((2, 5, 24))
    return [
        {"name": "sampled", "cfg": MESH, "ops": [
            {"op": "burst", "feats": _feats(rng, 6)},
            {"op": "lone", "feats": _feats(rng, 1)[0]},
            {"op": "health"},
            {"op": "stream", "feats": _segments(rng)},
            {"op": "frames", "frames": frames},
            {"op": "reload", "path": ckpt["sampled"]},
            {"op": "burst", "feats": _feats(rng, 3)},
            {"op": "health"}]},
        {"name": "greedy", "cfg": dict(MESH, **GREEDY), "ops": [
            {"op": "burst", "feats": _feats(rng, 5)}]},
        {"name": "cache_kv", "cfg": dict(MESH, quantize="cache", **KV),
         "ops": [{"op": "burst", "feats": _feats(rng, 3)},
                 {"op": "stream", "feats": _segments(rng)}]},
        {"name": "int8", "gate": 1.1,
         "cfg": dict(MESH, quantize=True, quantize_min_agreement=0),
         "ops": [{"op": "burst", "feats": _feats(rng, 2)},
                 {"op": "reload", "path": ckpt["int8"]},
                 {"op": "burst", "feats": _feats(rng, 2)}]},
        {"name": "fsdp", "cfg": _fsdp_overrides(), "ops": [
            {"op": "burst", "feats": _feats(rng, 3)},
            {"op": "frames", "frames": frames},
            {"op": "reload", "path": ckpt["fsdp"]},
            {"op": "burst", "feats": _feats(rng, 2)}]},
        {"name": "solo", "cfg": dict(MESH, mesh_serving=False), "ops": [
            {"op": "burst", "feats": _feats(rng, 3)}, {"op": "health"}]},
        {"name": "solo_busy", "cfg": dict(MESH, mesh_serving=False),
         "control": BUSY_CONTROL,
         "ops": [{"op": "busy", "seconds": BUSY_S}]},
        {"name": "bad_buckets", "cfg": dict(MESH, batch_buckets="1"),
         "expect_error": True},
        {"name": "f32", "cfg": dict(MESH, **GREEDY),
         "f32": {"model": _cfg()["model"], "feats": f32, "seed": 3,
                 "state_dicts": from_jax_params(tree)}},
    ]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The spawn's records (rank 0's and rank 1's) and the JAX service,
    made while the spawn runs."""
    root = tmp_path_factory.mktemp("mesh_serving")
    parts = jax_service_tree()
    scenarios = _scenarios(root, parts)
    procs = spawn("serve", 2, {"scenarios": scenarios}, root / "out")
    jax_service = make_jax_service(parts)
    wait(procs)
    got = [torch.load(root / "out" / f"result{r}.pt", weights_only=False)
           for r in range(2)]
    return {"scenarios": {s["name"]: s for s in scenarios}, "rank0": got[0],
            "rank1": got[1], "jax": jax_service}


@contextlib.contextmanager
def _one_thread():
    """The workers' one thread (their float32 sums in the same order)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _reference(served, name, reload=None):
    """One process's service of scenario ``name``'s config (after
    ``reload``, a checkpoint path)."""
    from vaura_tpu_torch.scripts.serve import GenerationService

    sc = served["scenarios"][name]
    svc = GenerationService(_cfg(**sc["cfg"]))
    if sc.get("gate") is not None:
        svc._quantize_min_agreement = sc["gate"]
    if reload is not None:
        svc.reload(reload)
    return svc


def _assert_batches(served, name, reload_path=None):
    """Every batch of scenario ``name`` equals one process's ``_generate``
    on its padded features and seed (with the weights of as many reloads);
    returns the batches."""
    batches = served["rank0"][name]["batches"]
    assert batches
    refs = {}
    for b in batches:
        n = b["reloads"]
        if n not in refs:
            refs[n] = _reference(served, name, reload_path if n else None)
        with torch.inference_mode(), _one_thread():
            want = refs[n]._generate(b["feats"], b["seed"])
        np.testing.assert_array_equal(b["codes"].numpy(),
                                      want["codes"].numpy())
        # the codec decodes each rank's rows as a batch of their own, and
        # the CPU's convolutions sum a batch of another size in another
        # order: single samples near the tanh's saturation move by ~1e-4
        got, ref = b["audio"].numpy(), want["audio"].float().numpy()
        rel = np.sqrt(((got - ref) ** 2).mean() / (ref ** 2).mean())
        assert got.shape == ref.shape and rel <= 1e-4, rel
    return batches


def _assert_replies(rec, batches):
    """Each reply of a burst or lone request is the row of the batch that
    holds its padded features."""
    for op, sc_op in rec:
        for feats, codes, status in zip(
                sc_op["feats"] if sc_op["op"] == "burst" else [sc_op["feats"]],
                op["codes"], op["status"]):
            assert status == 200
            padded = np.zeros((8, 24), np.float32)
            padded[:feats.shape[0]] = feats
            rows = [(b, i) for b in batches for i in range(b["feats"].shape[0])
                    if np.array_equal(b["feats"][i].numpy(), padded)]
            assert len(rows) == 1
            b, i = rows[0]
            np.testing.assert_array_equal(codes, b["codes"][i].numpy())


def _requests(served, name):
    sc = served["scenarios"][name]
    rec = served["rank0"][name]["ops"]
    return [(r, op) for r, op in zip(rec, sc["ops"])
            if op["op"] in ("burst", "lone")]


@pytest.mark.parametrize("name", ["sampled", "greedy"])
def test_bursts_equal_one_process(served, name):
    """(a) Sampled and greedy bursts: every batch's codes and audio are one
    process's; each reply its row. The mesh and buckets as configured."""
    batches = _assert_batches(served, name,
                              served["scenarios"][name]["ops"][5]["path"]
                              if name == "sampled" else None)
    assert {b["feats"].shape[0] for b in batches} <= {2, 4}
    _assert_replies(_requests(served, name), batches)
    assert served["rank0"][name]["mesh"] == {"data": 2, "fsdp": 1,
                                            "model": 1}
    assert served["rank1"][name] == {"leader": False, "holds_system": True,
                                     "mesh": {"data": 2, "fsdp": 1,
                                              "model": 1}}
    assert served["rank0"][name]["drained"]


def test_health_and_metrics_report_the_mesh(served):
    rec = served["rank0"]["sampled"]["ops"]
    first, last = rec[2], rec[7]
    assert first["healthz"]["mesh"] == {"data": 2, "fsdp": 1, "model": 1}
    assert first["healthz"]["batch_buckets"] == [2, 4]
    for axis, n in (("data", 2), ("fsdp", 1), ("model", 1)):
        assert f'vaura_mesh_size{{axis="{axis}"}} {n}' in first["metrics"]
    assert "vaura_reloads_total 1" in last["metrics"]
    assert "vaura_stream_requests_total 1" in last["metrics"]


def _tap_stream(system, codes):
    for name in ("generate_long_stream", "generate_long_kv_stream"):
        fn = getattr(system, name)

        def tapped(*a, _fn=fn, **k):
            for chunk in _fn(*a, **k):
                codes.append(chunk["codes"].clone())
                yield chunk

        setattr(system, name, tapped)


@pytest.mark.parametrize("name", ["sampled", "cache_kv"])
def test_streams_equal_one_process(served, name):
    """(b) A reprefill stream and a rolling-KV stream (int8 cache), run
    replicated on both ranks: the chunks' codes equal one process's stream
    of the same seed, the increments within 1e-5."""
    sc = served["scenarios"][name]
    i = [op["op"] for op in sc["ops"]].index("stream")
    got = served["rank0"][name]["ops"][i]
    ref = _reference(served, name)
    codes, increments = [], []
    _tap_stream(ref.system, codes)
    with torch.inference_mode(), _one_thread():
        n, lost = ref._stream(torch.from_numpy(sc["ops"][i]["feats"])[None],
                              got["seed"], ref.stream_mode,
                              increments.append)
    assert lost is None and n == len(got["codes"]) > 1
    for a, b in zip(got["codes"], codes):
        assert torch.equal(a, b)
    assert len(got["increments"]) == len(increments)
    for a, b in zip(got["increments"], increments):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    hop = ref.system.dac.cfg.hop_length
    assert sum(a.size for a in increments) == ref.stream_tokens * hop


def test_reload_changes_codes_on_every_rank(served):
    """(c) The accepted reload: the batches after it are one process's
    after the same reload (checked in ``test_bursts_equal_one_process``);
    here they differ from the old weights' codes at the same seed."""
    rec = served["rank0"]["sampled"]
    reload = rec["ops"][5]
    assert reload["status"] == 200 and reload["body"]["reloaded"]
    after = [b for b in rec["batches"] if b["reloads"] == 1]
    assert after
    old = _reference(served, "sampled")
    with torch.inference_mode():
        was = old._generate(after[0]["feats"], after[0]["seed"])["codes"]
    assert not torch.equal(was, after[0]["codes"])


def test_refused_reload_keeps_the_old_weights(served):
    """(c, d) ``quantize=true`` with a gate no reload passes: 400 with the
    gate's message, and every batch (both ranks' rows, before and after)
    equals one process's that never reloaded."""
    rec = served["rank0"]["int8"]
    status, body = rec["ops"][1]["status"], rec["ops"][1]["body"]
    assert status == 400 and "reload refused" in body["error"]
    batches = _assert_batches(served, "int8")
    assert len(batches) >= 2 and all(b["reloads"] == 0 for b in batches)
    _assert_replies(_requests(served, "int8"), batches)


def test_int8_cache_serves_on_the_mesh(served):
    """(d) ``quantize=cache``: the batches equal one process's."""
    batches = _assert_batches(served, "cache_kv")
    _assert_replies(_requests(served, "cache_kv"), batches)


@pytest.mark.parametrize("name", ["sampled", "fsdp"])
def test_frames_run_the_encoder_on_every_rank(served, name):
    """(e) A clip's frames through ``frames_to_features`` (a job of every
    rank): its features are one process's; its request is served. Under
    ``fsdp`` the encoder is unfrozen and sharded over fsdp 2."""
    sc = served["scenarios"][name]
    i = [op["op"] for op in sc["ops"]].index("frames")
    got = served["rank0"][name]["ops"][i]
    ref = _reference(served, name)
    with _one_thread():
        want = ref.frames_to_features(sc["ops"][i]["frames"])
    assert got["features"].shape == (8, 24)
    np.testing.assert_allclose(got["features"], want, rtol=0, atol=1e-6)
    assert got["status"] == 200 and got["codes"].shape == (3, 12)


def test_fsdp_mesh_serves_and_reloads(served):
    """The sampler and an unfrozen encoder sharded over fsdp 2: the batches
    before and after a reload (new modules placed on the mesh) equal one
    process's."""
    sc = served["scenarios"]["fsdp"]
    rec = served["rank0"]["fsdp"]
    assert rec["mesh"] == {"data": 1, "fsdp": 2, "model": 1}
    assert rec["ops"][2]["status"] == 200
    batches = _assert_batches(served, "fsdp", sc["ops"][2]["path"])
    assert {b["reloads"] for b in batches} == {0, 1}


def test_indivisible_bucket_raises(served):
    """(f) Bucket 1 on a data mesh of 2."""
    for rank in ("rank0", "rank1"):
        err = served[rank]["bad_buckets"]["error"]
        assert "batch_buckets [1] not divisible by data*fsdp=2" in err


def test_without_mesh_rank0_serves_alone(served):
    """(i) ``mesh_serving=false``: rank 0 serves alone (its batches equal
    one process's), rank 1 builds no model and waits for the shutdown."""
    rec = served["rank0"]["solo"]
    assert rec["mesh"] is None and rec["holds_system"]
    assert rec["ops"][1]["healthz"]["mesh"] is None
    assert served["rank1"]["solo"] == {"leader": False, "mesh": None,
                                       "holds_system": False}
    batches = _assert_batches(served, "solo")
    _assert_replies(_requests(served, "solo"), batches)


def test_solo_follower_outlives_its_timeout_under_load(served):
    """(i) ``mesh_serving=false`` with a control timeout of 5 s and
    requests one after another for 7 s: rank 0 sends rank 1 a no-op header
    whenever 0.5 s passed since its last header, not only while idle, so
    rank 1's waits stay below the timeout, it ends on the shutdown, and
    every request is answered."""
    busy = served["rank0"]["solo_busy"]["ops"][0]
    assert busy["seconds"] > BUSY_CONTROL["timeout_s"]
    assert len(busy["status"]) >= 2 and set(busy["status"]) == {200}
    headers = served["rank1"]["solo_busy"]["headers"]
    kinds = [k for _, k in headers]
    assert kinds[-1] == "shutdown" and set(kinds[1:-1]) == {"noop"}
    assert len(kinds) - 2 >= BUSY_S / (4 * BUSY_CONTROL["heartbeat_s"])
    gaps = np.diff([t for t, _ in headers])
    assert gaps.max() < BUSY_CONTROL["timeout_s"], gaps


def test_mesh_server_matches_jax_service_in_float32(served):
    """The JAX package's ``GenerationService._generate`` and the 2-process
    server's on the same padded batch, converted float32 weights, greedy
    with CFG 3: codes equal, audio within 1e-3 relative RMS."""
    jsvc, jsys, tree, _ = served["jax"]
    jsvc.system = jsys
    jsvc.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    f32 = served["scenarios"]["f32"]["f32"]
    jo = jsvc._generate(jsvc._put_batch(f32["feats"]), f32["seed"])
    got = served["rank0"]["f32"]
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(jo["codes"]))
    ja = np.asarray(jo["audio"], np.float32)
    ta = got["audio"].numpy()
    assert ta.shape == ja.shape
    rel = np.sqrt(((ta - ja) ** 2).mean() / max((ja ** 2).mean(), 1e-12))
    assert rel <= 1e-3, rel


# --------------------------------------------------------------------------
# torchrun launches

def _torchrun(args):
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", *args], cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1"))


def _until(proc, patterns, lines):
    """Read ``proc``'s stderr into ``lines`` until every regex of
    ``patterns`` matched a line; returns the first match of each."""
    found = {}
    for line in proc.stderr:
        lines.append(line)
        for p in patterns:
            m = re.search(p, line)
            if m and p not in found:
                found[p] = m
        if len(found) == len(patterns):
            return [found[p] for p in patterns]
    raise AssertionError("the server did not start:\n" + "".join(lines)[-4000:])


def _post_codes(base, feats):
    req = urllib.request.Request(
        base + "/generate?raw=codes",
        data=json.dumps({"features": feats.tolist()}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["codes"]


def _finish(proc, lines):
    try:
        proc.wait(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        pytest.fail(f"the run outlived {TIMEOUT_S} s")
    lines.extend(proc.stderr.read().splitlines(keepends=True))
    return "".join(lines)


def test_torchrun_server_drains_on_sigterm():
    """(h) ``torchrun --nproc_per_node=2 -m vaura_tpu_torch ...
    action=serve``: requests are served; SIGTERM to both workers drains
    rank 0, rank 1 waits for rank 0's shutdown header, and every process
    exits 0."""
    proc = _torchrun(["-m", "vaura_tpu_torch",
                      "config=configs/experiments/dummy.yaml", "action=serve",
                      "trainer.platform=cpu", "port=0", "batch=2",
                      "duration=0.15", "top_k=8"])
    lines = []
    try:
        serving, follower = _until(proc, [
            r"serving on (http://\S+) \(batch=2, pid (\d+)\)",
            r"rank 1 follows rank 0's jobs \(pid (\d+)\)"], lines)
        base = serving.group(1)
        feats = np.random.default_rng(0).standard_normal((4, 24)).astype(
            np.float32)
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            codes = list(ex.map(lambda _: _post_codes(base, feats), range(3)))
        assert all(len(c) == 3 and len(c[0]) == 12 for c in codes)
        health = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert health["mesh"] == {"data": 2, "fsdp": 1, "model": 1}
        for pid in (int(follower.group(1)), int(serving.group(2))):
            os.kill(pid, signal.SIGTERM)
        text = _finish(proc, lines)
        assert proc.returncode == 0, text[-4000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert "signal 15: rank 1 waits for rank 0's shutdown" in text
    assert "rank 1: shutdown from rank 0" in text
    assert "shutdown complete (drained=True)" in text


def test_failed_follower_stops_the_run(tmp_path):
    """(g) Rank 1 raises in its first job after the warm-up (a patch in the
    worker script): the request is not answered 200, and the run ends
    non-zero within the time limit, no process left."""
    payload = tmp_path / "payload.pt"
    torch.save({"argv": ["config=configs/experiments/dummy.yaml",
                         "action=serve", "trainer.platform=cpu", "port=0",
                         "batch=2", "duration=0.15", "top_k=8"]}, payload)
    t0 = time.time()
    proc = _torchrun([str(WORKER), "serve_fail", str(payload), str(tmp_path)])
    lines = []
    try:
        (serving,) = _until(proc, [r"serving on (http://\S+) "], lines)
        feats = np.zeros((4, 24), np.float32)
        with pytest.raises((urllib.error.HTTPError, urllib.error.URLError,
                            ConnectionError)) as e:
            _post_codes(serving.group(1), feats)
        if isinstance(e.value, urllib.error.HTTPError):
            assert e.value.code == 500
        text = _finish(proc, lines)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0, text[-4000:]
    assert "a follower's job fails (test patch)" in text
    assert time.time() - t0 < TIMEOUT_S
