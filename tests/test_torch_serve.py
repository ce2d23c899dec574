"""The port's generation server (``vaura_tpu_torch/scripts/serve.py``) on
the CPU, at the tiny ``dummy.yaml`` geometry of ``tests/test_serve.py``.

* The cases of ``tests/test_serve.py`` on the port's service: health,
  coalescing, burst fill, input validation, the fixed conditioning length,
  ``.npy`` bodies, both stream modes, stream geometry rejection, metrics,
  hot reload from a checkpoint of the port, batch buckets, drain, the int8
  modes and their gate, ``video_b64`` requests.
* Parity with the JAX package: the port's server driven by the JAX
  package's own client (``scripts/client.py``); ``_parse_batch_buckets``
  over a table; ``GenerationService._generate`` of both packages on the
  same padded batch with the same converted float32 weights, greedy: codes
  equal token for token, audio within 1e-3 relative RMS.
* Parity with the port's own system: a lone ``raw=codes`` request gives the
  codes of ``VauraSystem.generate`` on the padded features and the seed the
  server used.
* ``run_server`` through ``python -m vaura_tpu_torch ... action=serve``:
  SIGTERM drains and exits 0.
"""

import concurrent.futures
import copy
import io
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
import wave
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaura_tpu_torch.train.checkpoint import CheckpointManager
from vaura_tpu_torch.train.state import TrainState, make_optimizer

REPO = Path(__file__).resolve().parents[1]
# the geometry of tests/test_serve.py's module fixture
GEOMETRY = dict(
    batch=2, batch_buckets="1", duration=0.15, top_k=8, max_wait_ms=50,
    stream_duration=0.6, stream_tokens=60, stream_stride_tokens=20,
    stream_max_tokens=30,
)


def _cfg(**overrides):
    from vaura_tpu_torch.config import assemble_config

    cfg = dict(assemble_config(
        [f"config={REPO / 'configs/experiments/dummy.yaml'}",
         "trainer.platform=cpu"],
        defaults_path=REPO / "configs" / "vaura_defaults.yaml",
        base_dir=REPO))
    cfg.update(overrides)
    return cfg


def _http(service):
    from vaura_tpu_torch.scripts.serve import make_handler

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    from vaura_tpu_torch.scripts.serve import GenerationService

    service = GenerationService(_cfg(**GEOMETRY))
    service.start()
    httpd, base = _http(service)
    yield base, service
    httpd.shutdown()
    service.close(timeout=10)


def _post(base, path, payload):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req).read()


def _metrics(base):
    text = urllib.request.urlopen(base + "/metrics").read().decode()
    return {line.split()[0]: float(line.split()[1])
            for line in text.splitlines()
            if not line.startswith("#") and "{" not in line}


def test_healthz(server):
    base, service = server
    info = json.loads(urllib.request.urlopen(base + "/healthz").read())
    assert info["status"] == "ok"
    assert info["batch"] == 2 and info["cond_dim"] == service.cond_dim
    assert info["sample_rate"] == 44100 and info["max_feature_rows"] == 8


def test_concurrent_requests_coalesce_into_one_batch(server):
    base, service = server
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((4, service.cond_dim)).astype(np.float32)
    payload = {"features": feats.tolist()}
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f_wav = ex.submit(_post, base, "/generate", payload)
        f_codes = ex.submit(_post, base, "/generate?raw=codes", payload)
        wav_bytes, codes_bytes = f_wav.result(60), f_codes.result(60)
    with wave.open(io.BytesIO(wav_bytes)) as w:
        assert w.getframerate() == service.sample_rate
        assert w.getnframes() == service.tokens * 8
    codes = json.loads(codes_bytes)["codes"]
    assert len(codes) == service.system.num_codebooks
    assert all(0 <= c <= service.system.special_token_id
               for row in codes for c in row)


def test_burst_double_buffered_batches_fill(server):
    """A burst larger than the batch queues while a batch computes; the
    next collection takes it at once, so the batches coalesce."""
    base, service = server
    rng = np.random.default_rng(3)
    n = 8  # 4x the batch of 2
    feats = [rng.standard_normal((4, service.cond_dim)).astype(np.float32)
             for _ in range(n)]
    with service._metrics_lock:
        before = service._metrics["batches_total"]
    with concurrent.futures.ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(_post, base, "/generate?raw=codes",
                          {"features": f.tolist()}) for f in feats]
        results = [f.result(120) for f in futs]
    assert len(results) == n
    for body in results:
        assert len(json.loads(body)["codes"]) == service.system.num_codebooks
    with service._metrics_lock:
        batches = service._metrics["batches_total"] - before
    assert batches <= n - 1, f"burst of {n} dispatched {batches} batches"


def test_batch_replied_before_the_next_dispatch(server, monkeypatch):
    """The eager dispatch runs a batch to its end, so the worker fetches
    (and replies to) batch N before it dispatches batch N+1."""
    base, service = server
    events = []
    dispatch, fetch = service._dispatch, service._fetch

    def record_dispatch(slots):
        events.append(("dispatch", len(slots)))
        return dispatch(slots)

    def record_fetch(p):
        events.append(("fetch", len(p["slots"])))
        fetch(p)

    monkeypatch.setattr(service, "_dispatch", record_dispatch)
    monkeypatch.setattr(service, "_fetch", record_fetch)
    feats = np.zeros((4, service.cond_dim), np.float32)
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(service.submit, feats, "codes") for _ in range(4)]:
            f.result(120)
    kinds = [k for k, _ in events]
    assert kinds == ["dispatch", "fetch"] * (len(kinds) // 2), events
    assert sum(n for k, n in events if k == "fetch") == 4


def test_input_validation(server):
    base, service = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/generate", {"nope": 1})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/generate", {"features": [[0.0] * 7]})
    assert e.value.code == 400
    assert str(service.cond_dim) in e.value.read().decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/nope", {})
    assert e.value.code == 404


def test_fixed_conditioning_length(server):
    base, service = server
    too_long = np.zeros((service.tv + 1, service.cond_dim), np.float32)
    with pytest.raises(ValueError, match="features too long"):
        service.submit(too_long)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/generate", {"features": too_long.tolist()})
    assert e.value.code == 400


def test_binary_npy_request(server):
    base, service = server
    feats = np.random.default_rng(1).standard_normal(
        (4, service.cond_dim)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, feats)
    req = urllib.request.Request(
        base + "/generate", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with wave.open(io.BytesIO(urllib.request.urlopen(req).read())) as w:
        assert w.getframerate() == service.sample_rate
        assert w.getnframes() > 0
    bad = io.BytesIO()
    np.save(bad, np.zeros((4, 7), np.float32))
    req = urllib.request.Request(
        base + "/generate", data=bad.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400


def test_generate_long_streams_wav_increments(server):
    """/generate_long (``stream_mode=reprefill``) returns a live WAV whose
    samples match the stream geometry, while a concurrent short request is
    still answered."""
    base, service = server
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((1, 8, service.cond_dim)).astype(np.float32)
    buf = io.BytesIO()
    np.save(buf, feats)
    req = urllib.request.Request(
        base + "/generate_long", data=buf.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    short = rng.standard_normal((4, service.cond_dim)).astype(np.float32)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f_stream = ex.submit(lambda: urllib.request.urlopen(req, timeout=600))
        f_short = ex.submit(_post, base, "/generate",
                            {"features": short.tolist()})
        resp = f_stream.result(600)
        header = resp.read(44)
        assert header[:4] == b"RIFF" and header[8:12] == b"WAVE"
        assert header[36:40] == b"data"
        pcm = resp.read()
        wav_bytes = f_short.result(600)
    with wave.open(io.BytesIO(wav_bytes)) as w:
        assert w.getnframes() > 0
    hop = service.system.dac.cfg.hop_length
    assert len(pcm) // 2 == service.stream_tokens * hop
    audio = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32767.0
    assert np.abs(audio).max() <= 1.0 and np.abs(audio).max() > 0


def test_generate_long_rejects_bad_geometry(server):
    base, service = server
    bad = io.BytesIO()
    np.save(bad, np.zeros((3, 8, service.cond_dim), np.float32))  # S != 1
    req = urllib.request.Request(
        base + "/generate_long", data=bad.getvalue(),
        headers={"Content-Type": "application/octet-stream"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == 400
    assert "stream features must be" in e.value.read().decode()


def test_metrics_endpoint(server):
    base, service = server
    service.submit(np.zeros((4, service.cond_dim), np.float32), want="codes")
    vals = _metrics(base)
    assert vals["vaura_requests_total"] >= 1
    assert vals["vaura_batches_total"] >= 1
    assert 0 < vals["vaura_batch_fill_ratio"] <= 1
    assert vals["vaura_batch_seconds_avg"] > 0
    assert vals["vaura_inflight"] == 0
    assert vals["vaura_draining"] == 0
    assert vals["vaura_compiled_batch"] == service.batch


def test_lone_request_codes_equal_direct_generate(server):
    """A lone ``raw=codes`` request pads to bucket 1 and samples with the
    seed the server hands it: the codes of ``VauraSystem.generate`` on
    the padded features with that seed."""
    base, service = server
    feats = np.random.default_rng(8).standard_normal(
        (5, service.cond_dim)).astype(np.float32)
    seed = service._next_seed
    codes = np.asarray(json.loads(
        _post(base, "/generate?raw=codes", {"features": feats.tolist()})
    )["codes"])
    padded = np.zeros((1, service.tv, service.cond_dim), np.float32)
    padded[0, :5] = feats
    with torch.inference_mode():
        want = service.system.generate(
            vis_feats=torch.from_numpy(padded),
            generator=torch.Generator().manual_seed(seed),
            max_new_tokens=service.tokens, tokens_per_frame=7,
            decode_to_audio=False, **service.sampling)["codes"][0].numpy()
    np.testing.assert_array_equal(codes, want)


def _random_trainable_checkpoint(service, root, seed):
    """A ``CheckpointManager`` checkpoint of a ``TrainState`` over fresh
    seeded values of every trainable leaf of ``service``."""
    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)).to(v.dtype) for k, v in service._trainable_like.items()}
    return CheckpointManager(root).save(
        TrainState.create(params, make_optimizer(1e-3)), 0, 1, 1.0)


def test_hot_reload(server, tmp_path):
    """POST /reload swaps the serving weights between batches: new values,
    the next request served, ``vaura_reloads_total 1``, and a 400 without a
    checkpoint."""
    from scripts import client

    base, service = server
    ckpt = _random_trainable_checkpoint(service, tmp_path / "ckpts", 7)
    old = service.system
    before = next(old.sampler.parameters()).detach().clone()
    info = client.reload_weights(base, str(ckpt))
    assert info["reloaded"] and info["ckpt_path"] == str(ckpt)
    after = next(service.system.sampler.parameters())
    assert not torch.equal(before, after)
    # the old view keeps its modules (a running batch finishes on them)
    assert torch.equal(next(old.sampler.parameters()), before)
    assert service.system.dac is old.dac  # frozen modules are shared

    codes = service.submit(np.zeros((4, service.cond_dim), np.float32),
                           want="codes")
    assert codes.shape[0] == service.system.num_codebooks

    info = json.loads(urllib.request.urlopen(base + "/healthz").read())
    assert info["ckpt_path"] == str(ckpt)
    text = urllib.request.urlopen(base + "/metrics").read().decode()
    assert "vaura_reloads_total 1" in text

    service.ckpt_path = None
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base, "/reload", {})
    assert e.value.code == 400
    assert "no checkpoint to reload" in e.value.read().decode()


def test_batch_buckets(server):
    base, service = server
    assert service.batch_buckets == [1, 2]
    info = json.loads(urllib.request.urlopen(base + "/healthz").read())
    assert info["batch_buckets"] == [1, 2]
    before = dict(service._bucket_counts)
    feats = np.zeros((4, service.cond_dim), np.float32)
    service.submit(feats, want="codes")  # lone request -> bucket 1
    assert service._bucket_counts[1] == before[1] + 1
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        payload = {"features": feats.tolist()}
        f1 = ex.submit(_post, base, "/generate?raw=codes", payload)
        f2 = ex.submit(_post, base, "/generate?raw=codes", payload)
        f1.result(60), f2.result(60)
    assert service._bucket_counts[2] >= before[2] + 1
    text = urllib.request.urlopen(base + "/metrics").read().decode()
    assert 'vaura_bucket_batches_total{bucket="1"}' in text
    assert 0 < _metrics(base)["vaura_batch_fill_ratio"] <= 1


@pytest.mark.parametrize("client_module", ["scripts.client",
                                           "vaura_tpu_torch.scripts.client"])
def test_client_library(server, client_module):
    """The JAX package's client and the port's copy of it drive every
    endpoint of the port's server: the wire format is shared."""
    import importlib

    client = importlib.import_module(client_module)
    base, service = server
    assert client.health(base)["status"] == "ok"
    rng = np.random.default_rng(11)
    feats = rng.standard_normal((4, service.cond_dim)).astype(np.float32)
    with wave.open(io.BytesIO(client.generate(base, feats))) as w:
        assert w.getnframes() == service.tokens * 8
    codes = client.generate(base, feats, want="codes")
    assert codes.shape == (service.system.num_codebooks, service.tokens)
    seg = rng.standard_normal((1, 8, service.cond_dim)).astype(np.float32)
    stream = b"".join(client.generate_long_stream(base, seg))
    assert stream[:4] == b"RIFF"
    assert (len(stream) - 44) // 2 == service.stream_tokens * 8


def test_port_client_loadtest(server):
    from vaura_tpu_torch.scripts import client

    base, service = server
    feats = np.zeros((4, service.cond_dim), np.float32)
    stats = client.loadtest(base, feats, n_requests=4, concurrency=2)
    assert stats["requests"] == 4 and stats["errors"] == 0
    assert list(stats) == ["requests", "errors", "wall_s", "req_per_s",
                           "p50_s", "p90_s", "p95_s", "p99_s", "mean_s"]
    assert 0 < stats["p50_s"] <= stats["p95_s"] <= stats["p99_s"]


# the keys of the JSON line of scripts/burst_bench.py (the load test's
# ``requests`` overwrites the burst's, in the burst's place)
BURST_KEYS = ["mode", "batch", "requests", "concurrency", "health_after_s",
              "first_request_s", "audio_sec_per_s", "errors", "wall_s",
              "req_per_s", "p50_s", "p90_s", "p95_s", "p99_s", "mean_s"]


def test_burst_bench_measure(server):
    """``burst_bench.measure`` against a running server: JAX's keys, the
    burst answered whole, the device the server runs on."""
    from vaura_tpu_torch.scripts import burst_bench

    base, service = server
    args = burst_bench.build_parser().parse_args(
        ["--config", "configs/experiments/dummy.yaml", "--batch", "2",
         "--requests", "4", "--concurrency", "2", "--duration", "0.15"])
    out = burst_bench.measure(base, args, t_health=1.0)
    assert list(out) == BURST_KEYS + ["device"]
    assert out["requests"] == 4 and out["errors"] == 0
    assert out["mode"] == "bf16" and out["batch"] == 2
    assert out["health_after_s"] == 1.0 and out["first_request_s"] > 0
    assert out["audio_sec_per_s"] == round(out["req_per_s"] * service.duration, 2)
    assert out["device"] == "cpu"


def test_burst_bench_server_command():
    """The burst bench starts the port's server with the keys
    ``scripts/burst_bench.py`` gives ``scripts/serve.py``."""
    from vaura_tpu_torch.scripts import burst_bench

    args = burst_bench.build_parser().parse_args(
        ["--config", "configs/generate_vgg.yaml", "--batch", "8", "--port",
         "8123", "--quantize", "cache", "--extra", "batch_buckets=1,8",
         "trainer.platform=cpu"])
    cmd = burst_bench.server_command(args)
    assert cmd == [sys.executable, "-m", "vaura_tpu_torch",
                   "config=configs/generate_vgg.yaml", "action=serve",
                   "port=8123", "batch=8", "duration=2.56", "quantize=cache",
                   "batch_buckets=1,8", "trainer.platform=cpu"]
    args.quantize = None
    assert "quantize=false" in burst_bench.server_command(args)


@pytest.mark.parametrize("buckets,batch", [
    (None, 8), ("", 8), ("1,4", 8), ([1, 4], 8), (1, 8), ("4, 2,4", 8),
    ([8], 8), ("16", 8), ("0,8", 8), ("1", 1)])
def test_batch_buckets_parse_matches_jax(buckets, batch):
    from scripts.serve import _parse_batch_buckets as j_parse
    from vaura_tpu_torch.scripts.serve import _parse_batch_buckets

    try:
        want = j_parse(buckets, batch)
    except ValueError:
        with pytest.raises(ValueError, match="batch_buckets"):
            _parse_batch_buckets(buckets, batch)
        return
    assert _parse_batch_buckets(buckets, batch) == want


def test_batch_buckets_validation():
    from vaura_tpu_torch.scripts.serve import GenerationService

    with pytest.raises(ValueError, match="batch_buckets"):
        GenerationService(_cfg(batch=2, batch_buckets="3", duration=0.15))
    with pytest.raises(ValueError, match="batch_buckets and aot_export"):
        GenerationService(_cfg(batch=2, batch_buckets="1", duration=0.15,
                               aot_load="x.pt2"))
    with pytest.raises(ValueError, match="stream_mode"):
        GenerationService(_cfg(batch=2, stream_mode="bogus"))


def test_stream_mode_kv_service():
    """``stream_mode=kv``: the RoPE table raised to cover the horizon, the
    increments (more than one) summing to the geometry's samples."""
    from vaura_tpu_torch.scripts.serve import GenerationService

    svc = GenerationService(_cfg(
        **{**GEOMETRY, "stream_mode": "kv", "stream_chunk_steps": 16,
           "stream_window_chunks": 2}))
    try:
        assert svc.stream_mode == "kv"
        assert svc.system.sampler_config.block_size >= 60 + 64
        svc.start()
        feats = np.random.default_rng(3).standard_normal(
            (svc.stream_segments, svc.stream_t, svc.cond_dim)
        ).astype(np.float32)
        got = []
        svc.submit_stream(feats, got.append)
        assert len(got) >= 2
        hop = svc.system.dac.cfg.hop_length
        assert sum(a.shape[-1] for a in got) == svc.stream_tokens * hop
        assert svc._metrics["stream_requests_total"] == 1
    finally:
        assert svc.close(timeout=10)


def test_graceful_drain():
    """begin_drain: accepted work finishes, new work gets DrainingError
    (HTTP 503), drain() reports complete; close() ends the worker."""
    from vaura_tpu_torch.scripts.serve import DrainingError, GenerationService

    service = GenerationService(_cfg(batch=1, duration=0.15, top_k=8,
                                     max_wait_ms=10))
    service.start()
    feats = np.zeros((4, service.cond_dim), np.float32)
    service.submit(feats, want="codes")
    service.begin_drain()
    with pytest.raises(DrainingError):
        service.submit(feats, want="codes")
    assert service.drain(timeout=10)
    httpd, base = _http(service)
    try:
        info = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert info["status"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/generate", {"features": feats.tolist()})
        assert e.value.code == 503
    finally:
        httpd.shutdown()
    assert service.close(timeout=10)
    assert not service._worker.is_alive()
    assert service.close(timeout=1)  # idempotent


def test_quantize_gate_and_cache_mode():
    """``quantize=true``: int8 sampler weights behind the agreement gate (an
    impossible gate refuses to serve); ``quantize=cache``: bf16 weights,
    int8 cache, no weight quantization on reload."""
    from vaura_tpu_torch.scripts.serve import GenerationService

    with pytest.raises(RuntimeError, match="argmax agreement"):
        GenerationService(_cfg(batch=1, duration=0.15, quantize=True,
                               quantize_min_agreement=1.1))
    svc = GenerationService(_cfg(batch=1, duration=0.15, quantize=True,
                                 quantize_min_agreement=0.5))
    assert svc.system.sampler_config.quantize_weights
    assert svc.system.sampler.lm_head.kernel_q.dtype == torch.int8

    svc = GenerationService(_cfg(batch=1, duration=0.15, quantize="cache"))
    try:
        cfg = svc.system.sampler_config
        assert cfg.quantize_cache and not cfg.quantize_weights
        assert not svc._quantize
        assert svc.system.sampler.lm_head.weight.dtype == torch.bfloat16
        svc.start()
        out = svc.submit(np.zeros((4, svc.cond_dim), np.float32), "codes")
        assert out.shape[0] == svc.system.num_codebooks
    finally:
        svc.close()


def test_hot_reload_quantized_gate_refusal(tmp_path):
    """A reload that fails the int8 gate raises and keeps the current
    weights serving; a passing one quantizes the new weights."""
    from vaura_tpu_torch.scripts.serve import GenerationService

    service = GenerationService(_cfg(batch=1, duration=0.15, top_k=8,
                                     quantize=True, quantize_min_agreement=0))
    service.start()
    try:
        ckpt = _random_trainable_checkpoint(service, tmp_path / "ckpts", 5)

        def leaf():
            return service.system.sampler.lm_head.kernel_q.clone()

        before = leaf()
        service._quantize_min_agreement = 1.1
        with pytest.raises(RuntimeError, match="reload refused"):
            service.reload(str(ckpt))
        assert torch.equal(before, leaf())
        assert service.ckpt_path is None
        service._quantize_min_agreement = 0.01
        info = service.reload(str(ckpt))
        assert info["reloaded"] and 0.0 <= info["int8_agreement"] <= 1.0
        assert not torch.equal(before, leaf())
        assert leaf().dtype == torch.int8
        codes = service.submit(np.zeros((4, service.cond_dim), np.float32),
                               want="codes")
        assert codes.shape[0] == service.system.num_codebooks
    finally:
        service.close(timeout=10)


def test_video_b64_request_and_feature_normalization(tmp_path):
    """The video endpoint runs the encoder on [-1, 1]-normalized frames
    (the training transform), and too-short clips 400."""
    import base64

    from vaura_tpu_torch.data import media
    from vaura_tpu_torch.scripts.serve import GenerationService

    if not media.available():
        pytest.skip("native media module unavailable")
    service = GenerationService(_cfg(batch=1, duration=0.64, top_k=8,
                                     max_wait_ms=10))
    frames = np.random.default_rng(3).integers(
        0, 256, size=(17, 224, 224, 3), dtype=np.uint8)
    path = tmp_path / "clip.mp4"
    media.write_video(path, frames.copy(), fps=25.0)
    video_bytes = path.read_bytes()
    feats = service.video_to_features(video_bytes)
    assert feats.shape == (8, service.cond_dim)
    dec, _, _ = media.read_video(str(path), fps=25.0, duration=0.65,
                                 want_audio=False)
    x = (dec[:16].astype(np.float32) / 255.0 - 0.5) / 0.5
    x = x.transpose(3, 0, 1, 2).reshape(3, 1, 16, 224, 224)
    x = x.transpose(1, 0, 2, 3, 4)[None]
    with torch.inference_mode():
        want = service.system.visual_features(torch.from_numpy(
            np.ascontiguousarray(x))).float().numpy()[0]
    np.testing.assert_array_equal(feats, want)

    service.start()
    httpd, base = _http(service)
    try:
        wav_bytes = _post(base, "/generate", {
            "video_b64": base64.b64encode(video_bytes).decode()})
        with wave.open(io.BytesIO(wav_bytes)) as w:
            assert w.getnframes() == service.tokens * 8
        short = tmp_path / "short.mp4"
        media.write_video(short, frames[:4].copy(), fps=25.0)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, "/generate", {
                "video_b64": base64.b64encode(short.read_bytes()).decode()})
        assert e.value.code == 400
        assert "too short" in e.value.read().decode()
    finally:
        httpd.shutdown()
        service.close(timeout=10)


# --------------------------------------------------------------------------
# the two services' _generate on the same converted float32 weights

@pytest.fixture(scope="module")
def jax_service():
    return make_jax_service()


def jax_service_tree():
    """The JAX package's config at the served geometry (greedy, CFG 3), its
    float32 system and a float32 parameter tree of its model's codec and
    sampler (seeded, random heads; what ``_generate`` on features runs)."""
    from torch_port_util import randomize_sampler_heads

    from vaura_tpu.config import assemble_config as j_assemble
    from vaura_tpu.models.factory import build_system as j_build

    cfg = dict(j_assemble(
        [f"config={REPO / 'configs/experiments/dummy.yaml'}"],
        defaults_path=REPO / "configs" / "vaura_defaults.yaml",
        base_dir=REPO))
    cfg.update(GEOMETRY, use_sampling=False, cfg_scale=3.0)
    jsys = j_build(copy.deepcopy(cfg["model"]), precision="f32")
    r_dac, r_sam = jax.random.split(jax.random.PRNGKey(1))
    scfg = jsys.sampler_config
    tree = {
        "dac": jax.jit(lambda r: jsys.dac.init(
            r, jnp.zeros((1, scfg.num_codebooks, 2), jnp.int32),
            method=jsys.dac.decode))(r_dac)["params"],
        "sampler": jax.jit(lambda r: jsys.sampler.init(
            {"params": r, "dropout": r, "cfg_dropout": r},
            jnp.zeros((1, scfg.num_codebooks, 16), jnp.int32),
            jnp.zeros((1, 8, scfg.cond_in_dim)), False))(r_sam)["params"],
    }
    tree = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)
    tree["sampler"] = randomize_sampler_heads(tree["sampler"], 2)
    return cfg, jsys, tree


def make_jax_service(parts=None):
    """The JAX package's ``GenerationService`` at the same geometry, greedy
    with CFG 3, over ``jax_service_tree()``'s tree (``parts``, when it was
    made already). The service is made with ``init_params`` returning that
    tree (op by op it takes about 50 s on a CPU)."""
    from scripts.serve import GenerationService as JService
    from vaura_tpu.models.vaura import VauraSystem as JSystem

    cfg, jsys, tree = parts or jax_service_tree()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JSystem, "init_params", lambda self, rng: jax.tree_util.
                   tree_map(jnp.asarray, tree))
        service = JService(cfg)
    return service, jsys, tree, cfg


def test_generate_matches_jax_service_in_float32(jax_service):
    """Both services hold the same converted weights in float32 (the JAX
    service's ``system`` rebuilt at f32 and ``params`` set to the float32
    tree; the port's ``system`` likewise): ``_generate`` on the same padded
    batch, greedy with CFG 3, gives equal codes and audio within 1e-3
    relative RMS."""
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.models.factory import build_system as t_build
    from vaura_tpu_torch.scripts.serve import GenerationService

    jsvc, jsys, tree, jcfg = jax_service
    jsvc.system = jsys
    jsvc.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tsvc = GenerationService(_cfg(**GEOMETRY, use_sampling=False,
                                  cfg_scale=3.0))
    assert tsvc.sampling == jsvc.sampling
    assert (tsvc.tokens, tsvc.tv, tsvc.dac_chunk_size) == (
        jsvc.tokens, jsvc.tv, jsvc.dac_chunk_size)
    tsvc.system = t_build(copy.deepcopy(jcfg["model"]), precision="f32",
                          device="cpu")
    tsvc.system.load_state_dicts(from_jax_params(tree))
    tsvc.system.requires_grad_(False)

    feats = np.zeros((2, jsvc.tv, jsvc.cond_dim), np.float32)
    feats[:, :5] = np.random.default_rng(4).standard_normal(
        (2, 5, jsvc.cond_dim))
    jo = jsvc._generate(jsvc._put_batch(feats), 3)
    with torch.inference_mode():
        to = tsvc._generate(tsvc._put_batch(feats), 3)
    np.testing.assert_array_equal(to["codes"].numpy(), np.asarray(jo["codes"]))
    ja = np.asarray(jo["audio"], np.float32)
    ta = to["audio"].float().numpy()
    assert ta.shape == ja.shape
    rel = np.sqrt(((ta - ja) ** 2).mean() / max((ja ** 2).mean(), 1e-12))
    assert rel <= 1e-3, rel


# --------------------------------------------------------------------------
def test_run_server_drains_on_sigterm(tmp_path):
    """``python -m vaura_tpu_torch ... action=serve`` on the CPU: it serves
    a request, and SIGTERM drains and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vaura_tpu_torch",
         "config=configs/experiments/dummy.yaml", "action=serve",
         "trainer.platform=cpu", "port=0", "batch=1", "duration=0.15",
         "top_k=8"],
        cwd=REPO, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        base = None
        for line in proc.stderr:
            if "serving on http://" in line:
                base = line.split("serving on ")[1].split()[0]
                break
        assert base is not None, "the server did not start"
        feats = np.zeros((4, 24), np.float32)
        codes = json.loads(_post(base, "/generate?raw=codes",
                                 {"features": feats.tolist()}))["codes"]
        assert len(codes) == 3
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        assert proc.wait(timeout=60) == 0
        assert "shutdown complete (drained=True)" in rest
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
