"""Rules of the PyTorch port that no parity test sees: it imports nothing
of JAX, and its entry points never fall back to the CPU unasked."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vaura_tpu")


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
    from vaura_tpu_torch.ops import encoder_fused

    on_disk = {p.stem for p in (ROOT / "vaura_tpu_torch" / "csrc").glob("*.cu")}
    assert on_disk == set(build.SOURCES)
    assert divided_attention.launches == 0 and decode_attention.launches == 0
    assert encoder_fused.attention_launches == 0
    assert encoder_fused.mlp_launches == 0


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
