"""Rules of the PyTorch port that no parity test sees: it imports nothing
of JAX, nor the JAX package's root tools (``scripts``, ``bench.py``,
``main.py``, ``demo.py``), and its entry points never fall back to the CPU
unasked."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vaura_tpu",
             "scripts", "bench", "main", "demo")


def _port_files():
    files = sorted((ROOT / "vaura_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_port_imports_no_jax_and_nothing_of_vaura_tpu():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for mod, line in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, "\n".join(bad)


def test_entry_point_without_device_raises_when_cuda_is_absent(monkeypatch):
    from vaura_tpu_torch.models.dac.model import DacConfig
    from vaura_tpu_torch.models.sampler import SamplerConfig
    from vaura_tpu_torch.models.vaura import VauraSystem
    from vaura_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    tiny = SamplerConfig(num_layers=1, d_model=48, d_codebook=16,
                         num_codebooks=3, nhead=4, cond_in_dim=24,
                         codebook_dim=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VauraSystem(tiny, DacConfig(), use_visual_conditioning=False)
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_modules_are_covered_and_need_a_device(monkeypatch):
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("ops/divided_attention.py", "ops/losses.py", "ops/dropout.py",
                "ops/schedules.py", "train/state.py", "train/steps.py"):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch.flagship import flagship_system

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        flagship_system(training=True, sampler_layers=1, encoder_depth=1)


def test_every_kernel_source_is_built_and_counted():
    """Each CUDA source under ``csrc/`` is in the build list, and its
    wrapper module keeps a launch counter."""
    from vaura_tpu_torch.kernels import build
    from vaura_tpu_torch.ops import decode_attention, divided_attention
    from vaura_tpu_torch.ops import encoder_fused, snake

    on_disk = {p.stem for p in (ROOT / "vaura_tpu_torch" / "csrc").glob("*.cu")}
    assert on_disk == set(build.SOURCES)
    assert divided_attention.launches == 0 and decode_attention.launches == 0
    assert encoder_fused.attention_launches == 0
    assert encoder_fused.mlp_launches == 0
    assert snake.launches == 0


def test_a_changed_header_rebuilds_every_library(tmp_path, monkeypatch):
    """A library's file name carries a hash of its source, of every shared
    header and of the flags: editing ``gemm.cuh`` or ``group_attention.cuh``
    must not leave a stale build in use."""
    from vaura_tpu_torch.kernels import build

    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert {"common.cuh", "gemm.cuh", "group_attention.cuh"} <= headers
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    changed_header = build._target("k")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert len({first, changed_header, build._target("k")}) == 3


def test_port_imports_no_yaml():
    """The port reads its configs with its own YAML subset reader
    (``config/yaml_subset.py``): PyYAML is not a dependency of it."""
    bad = [f"{f.relative_to(ROOT)}:{line} imports yaml"
           for f in _port_files() for mod, line in _imported_roots(f)
           if mod == "yaml"]
    assert not bad, "\n".join(bad)


def test_generate_entry_point_loads_nothing_of_jax_or_yaml():
    import subprocess
    import sys

    code = ("import sys\n"
            "import vaura_tpu_torch.main, vaura_tpu_torch.scripts.generate\n"
            "import vaura_tpu_torch.scripts.serve\n"
            "import vaura_tpu_torch.bench, vaura_tpu_torch.scripts.burst_bench\n"
            "import vaura_tpu_torch.scripts.precompute_codes\n"
            "import vaura_tpu_torch.data.vggsound, vaura_tpu_torch.models.convert\n"
            "from vaura_tpu_torch.config import registry\n"
            "registry.ensure_aliases()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('yaml',)!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_serve_and_checkpoint_modules_are_covered_and_need_a_device(
        monkeypatch):
    """``action=serve`` runs on the card: without CUDA and without
    ``trainer.platform=cpu`` it raises before serving."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("scripts/serve.py", "train/checkpoint.py"):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch.main import main

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["config=configs/experiments/dummy.yaml", "action=serve",
              "port=0"])


def test_trainer_modules_write_tensorboard_without_its_packages():
    """The Trainer and its TensorBoard record run on the card's machine,
    which has neither ``tensorboardX``, ``tensorboard`` nor PIL: the event
    files, WAV bytes and GIFs are written with the standard library and
    numpy."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    mods = ("train/loop.py", "utils/tb.py", "utils/viz.py", "scripts/train.py",
            "scripts/test.py")
    for mod in mods:
        assert f"vaura_tpu_torch/{mod}" in names, mod
    bad = [f"{mod}:{line} imports {name}" for mod in mods
           for name, line in _imported_roots(ROOT / "vaura_tpu_torch" / mod)
           if name in ("tensorboardX", "tensorboard", "PIL")]
    assert not bad, "\n".join(bad)
    import subprocess
    import sys

    code = ("import sys\n"
            "import vaura_tpu_torch.scripts.train, vaura_tpu_torch.scripts.test\n"
            "import vaura_tpu_torch.data.vjepa, vaura_tpu_torch.data.audioset\n"
            "import vaura_tpu_torch.data.greatesthit\n"
            "import vaura_tpu_torch.data.motionformer_data\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('yaml', 'tensorboardX', 'tensorboard', 'PIL')!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_finetune_and_eval_modules_are_covered_and_need_a_device(
        monkeypatch, tmp_path):
    """``action=finetune`` and ``action=eval`` run on the card: without
    CUDA and without ``trainer.platform=cpu`` they raise before writing
    anything; their modules are under the import rule above and load
    nothing of JAX or PyYAML."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("train/lora.py", "scripts/finetune.py", "ops/fad.py",
                "ops/vggish.py", "ops/panns.py", "scripts/eval_metrics.py"):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch.main import main

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for action, extra in (("finetune", [f"trainer.log_dir={tmp_path}"]),
                          ("eval", [f"generated_dir={tmp_path}",
                                    f"reference_dir={tmp_path}"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["config=configs/experiments/dummy.yaml",
                  f"action={action}", *extra])
    assert not any(tmp_path.iterdir())
    import subprocess
    import sys

    code = ("import sys\n"
            "import vaura_tpu_torch.scripts.finetune\n"
            "import vaura_tpu_torch.scripts.eval_metrics\n"
            "import vaura_tpu_torch.ops.vggish, vaura_tpu_torch.ops.panns\n"
            "import vaura_tpu_torch.ops.fad, vaura_tpu_torch.train.lora\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('yaml',)!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_multi_device_and_demo_modules_are_covered_and_need_a_device(
        monkeypatch, tmp_path):
    """The mesh, the multi-process start-up, the dry run and the demo are
    under the import rule above, load nothing of JAX or PyYAML, and run on
    the card unless the CPU is asked: without CUDA they raise, a process
    group of several ranks on the card never forms without it (every
    action of ``main.py`` may start one), and the dry run spawns its CPU
    processes (``--n``) only with ``--platform cpu``."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/multihost.py", "parallel/partitioning.py",
                "parallel/tensor_parallel.py", "dryrun.py", "demo.py",
                "utils/demo_utils.py"):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch import demo, dryrun
    from vaura_tpu_torch.main import main
    from vaura_tpu_torch.parallel.multihost import initialize_distributed

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        initialize_distributed("127.0.0.1:1", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.run(None)
    # its CPU processes only when the CPU is asked, before spawning any
    for argv in (["--n", "2"], ["--n", "2", "--platform", "cuda"]):
        with pytest.raises(SystemExit) as exit_:
            dryrun.main(argv)
        assert exit_.value.code == 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.main(["--frames", str(tmp_path / "x.npy"),
                   "--out", str(tmp_path / "out")])
    # a run of several processes may start every action of main.py
    from vaura_tpu_torch.main import _MULTI_PROCESS

    tree = ast.parse((ROOT / "main.py").read_text())
    actions = {c.value for node in ast.walk(tree)
               if isinstance(node, ast.Compare)
               and getattr(node.left, "id", None) == "action"
               for cmp in node.comparators
               for c in ast.walk(cmp) if isinstance(c, ast.Constant)}
    assert len(actions) == 7 and actions == set(_MULTI_PROCESS), actions
    # which join NCCL on the cards: without CUDA they raise before any
    # group forms or any file is written
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    for action in ("finetune", "test", "eval"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["config=configs/experiments/dummy.yaml",
                  f"action={action}", f"trainer.log_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())
    import subprocess
    import sys

    code = ("import sys\n"
            "import vaura_tpu_torch.parallel, vaura_tpu_torch.dryrun\n"
            "import vaura_tpu_torch.demo, vaura_tpu_torch.utils.demo_utils\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('yaml',)!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_mesh_serving_modules_are_covered_and_need_a_device(monkeypatch):
    """The server across several processes (``scripts/serve.py`` over the
    control channel of ``parallel/multihost.py``, the placements of
    ``parallel/partitioning.py``, ``VauraSystem.replicated``, LoRA under a
    mesh, the tracked files' replicated forward) is under the import rule
    above and loads nothing of JAX or PyYAML; ``action=serve`` started by a
    launcher of two processes joins NCCL on the cards, and without CUDA it
    raises before any group forms."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("scripts/serve.py", "parallel/multihost.py",
                "parallel/partitioning.py", "models/vaura.py",
                "train/loop.py", "train/lora.py", "train/steps.py",
                "main.py"):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch.main import main

    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in (("WORLD_SIZE", "2"), ("RANK", "0"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["config=configs/experiments/dummy.yaml", "action=serve",
              "port=0"])
    import subprocess
    import sys

    code = ("import sys\n"
            "import vaura_tpu_torch.scripts.serve, vaura_tpu_torch.main\n"
            "import vaura_tpu_torch.train.loop\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + ('yaml',)!r}]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_benchmark_modules_are_covered_and_need_a_device(monkeypatch,
                                                         tmp_path):
    """The benchmark (``bench.py``), the burst bench, its client and the
    codes precompute tool are under the import rule above, load nothing of
    JAX, PyYAML or the JAX package's root tools (the import check of
    ``test_generate_entry_point_loads_nothing_of_jax_or_yaml``), and run on
    the card unless the CPU is asked: without CUDA they raise before writing
    anything."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    for mod in ("bench.py", "scripts/burst_bench.py", "scripts/client.py",
                "scripts/precompute_codes.py"):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch import bench
    from vaura_tpu_torch.scripts import precompute_codes

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        precompute_codes.main([str(ROOT / "configs/experiments/dummy.yaml"),
                               "--out", str(tmp_path / "codes")])
    assert not any(tmp_path.iterdir())


def test_aot_and_host_tool_modules_are_covered_and_need_a_device(
        monkeypatch, tmp_path):
    """The exported serving graphs (``utils/aot.py``, the registered
    decode-attention operator of ``kernels/ops.py``) and the host tools
    (``scripts/convert_checkpoints.py``, ``generate_video.py``,
    ``reencode_videos.py``, ``preprocess_greatest_hit.py``,
    ``make_demo_assets.py``, ``io_overlap_bench.py``) are under the import
    rule above and load nothing of JAX or PyYAML; the loader of an artifact
    loads nothing of the models either. The loader and the overlap bench run
    on the card unless the CPU is asked: without CUDA they raise before
    reading or writing anything."""
    names = {str(f.relative_to(ROOT)) for f in _port_files()}
    tools = ("convert_checkpoints", "generate_video", "reencode_videos",
             "preprocess_greatest_hit", "make_demo_assets",
             "io_overlap_bench")
    for mod in ("utils/aot.py", "kernels/ops.py",
                *(f"scripts/{t}.py" for t in tools)):
        assert f"vaura_tpu_torch/{mod}" in names, mod
    from vaura_tpu_torch.scripts import io_overlap_bench
    from vaura_tpu_torch.utils.aot import load_generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_generate(tmp_path / "missing.pt2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        io_overlap_bench.main(["--tiny"])
    assert not any(tmp_path.iterdir())
    import subprocess
    import sys

    for imports, extra in (
            (["vaura_tpu_torch.utils.aot", "vaura_tpu_torch.kernels.ops"],
             "or m.startswith('vaura_tpu_torch.models')"),
            ([f"vaura_tpu_torch.scripts.{t}" for t in tools], "")):
        code = ("import sys\n"
                + "".join(f"import {m}\n" for m in imports)
                + "bad = [m for m in sys.modules if m.split('.')[0] in "
                f"{FORBIDDEN + ('yaml',)!r} {extra}]\n"
                "assert not bad, bad\n")
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           capture_output=True, text=True)
        assert r.returncode == 0, r.stderr
