"""The port's finetune action (``python -m vaura_tpu_torch
action=finetune``, ``vaura_tpu_torch/scripts/finetune.py``) against the JAX
package's (``scripts/finetune.py``) on ``configs/experiments/dummy.yaml``
with ``trainer.platform=cpu``, and generation from the LoRA experiment.

Both finetunes start from one base: the JAX package's seeded
initialisation of the dummy model with a random LM head (the zero head of
a fresh init passes no gradient), saved as an orbax tree for the JAX
action and as the port's whole tree (``state.pt``) for the port's. The CFG
token drop is set to 0 on both sides (the two random streams differ).
LoRA: the JAX run's initial adapters are carried into the port's run
(``from_jax_params``) before its ``fit``. Every logged loss (the two steps,
the validation, the test) within 1e-5, the tolerance of
``tests/test_torch_trainer.py``.

Also here: the JAX package's generate action on a LoRA experiment whose
base came from ``finetune.init_from`` merges the adapters into a freshly
seeded base; the port loads the base the adapters trained over (the run's
``frozen/`` save, which holds the ``init_from`` weights)."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)
from torch_port_util import np_tree, randomize_sampler_heads

import vaura_tpu.train.loop as jloop
import vaura_tpu_torch.models.vaura as tvaura
import vaura_tpu_torch.train.loop as tloop
from vaura_tpu.config import assemble_config
from vaura_tpu_torch.convert import from_jax_params
from vaura_tpu_torch.main import main as port_main
from vaura_tpu_torch.train.checkpoint import load_state
from vaura_tpu_torch.train.lora import merge_lora

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
# ``action=finetune`` assembles the config as ``main.py`` does for it: the
# experiment file alone, without the defaults (which only ``train`` merges)
ARGV = [f"config={REPO / 'configs/experiments/dummy.yaml'}",
        "action=finetune", "trainer.fast_dev_run=2",
        "model.sampler_config.params.class_dropout_prob=0.0"]
LORA = ["finetune.lora_rank=4", "finetune.lora_alpha=8.0"]


def _jax_cfg(extra):
    return assemble_config(ARGV + extra,
                           defaults_path=REPO / "configs" / "vaura_defaults.yaml",
                           base_dir=REPO)


def _losses(root):
    acc = EventAccumulator(str(root), size_guidance={"scalars": 0})
    acc.Reload()
    return {t: [(e.step, e.value) for e in acc.Scalars(t)]
            for t in acc.Tags()["scalars"] if "loss" in t}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The base checkpoints, the JAX finetunes (full with the encoder
    unfrozen, LoRA) and the port's, each from ``init_from``."""
    import orbax.checkpoint as ocp

    from scripts.finetune import finetune as j_finetune
    from vaura_tpu.models.factory import build_system as j_build

    root = tmp_path_factory.mktemp("finetune")
    cfg = _jax_cfg([])
    jsys = j_build(cfg["model"], precision="f32")
    tree = np_tree(jsys.init_params(jax.random.PRNGKey(11)))
    tree["sampler"] = randomize_sampler_heads(tree["sampler"], 12)
    with ocp.StandardCheckpointer() as ckptr:  # the save is asynchronous
        ckptr.save((root / "base_orbax").resolve(), tree)
        ckptr.wait_until_finished()
    (root / "base_port").mkdir()
    torch.save({"params": {f"{top}.{k}": v for top, sd in
                           from_jax_params(tree).items()
                           for k, v in sd.items()}},
               root / "base_port" / "state.pt")

    jax_adapters, jax_trainers = {}, []
    j_fit = jloop.Trainer.fit

    def capture(self, params, *a, **k):
        jax_trainers.append(self)
        if "lora_sampler" in params:
            jax_adapters.update(np_tree(params["lora_sampler"]))
        return j_fit(self, params, *a, **k)

    t_fit = tloop.Trainer.fit

    def carry(self, *a, **k):
        if self.system.lora_sampler is not None:
            self.system.load_state_dicts(
                {"lora_sampler": from_jax_params(
                    {"lora_sampler": jax_adapters})["lora_sampler"]})
        return t_fit(self, *a, **k)

    out = {"root": root, "tree": tree}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop.Trainer, "fit", capture)
        mp.setattr(tloop.Trainer, "fit", carry)
        for name, extra in (("full", ["finetune.unfreeze_encoder=true"]),
                            ("lora", LORA)):
            jcfg = _jax_cfg(extra + [f"trainer.log_dir={root / 'jax' / name}"])
            jcfg = dict(jcfg)
            jcfg["finetune"] = dict(jcfg["finetune"],
                                    init_from=str(root / "base_orbax"))
            jres = j_finetune(jcfg)
            jax_trainers.pop().tb.close()  # drains tensorboardX's queue
            tres = port_main(ARGV + extra + [
                "trainer.platform=cpu",
                f"trainer.log_dir={root / 'port' / name}",
                f"finetune.init_from={root / 'base_port'}"])
            out[name] = {"jax": jres, "port": tres}
    return out


@pytest.mark.parametrize("name", ["full", "lora"])
def test_finetune_losses_match_jax(runs, name):
    want = _losses(runs[name]["jax"]["dirs"]["root"])
    got = _losses(runs[name]["port"]["dirs"]["root"])
    assert sorted(got) == sorted(want)
    assert [s for s, _ in got["train_loss_step"]] == [1, 2]
    for tag in want:
        assert [s for s, _ in got[tag]] == [s for s, _ in want[tag]], tag
        np.testing.assert_allclose([v for _, v in got[tag]],
                                   [v for _, v in want[tag]], rtol=0,
                                   atol=TOL, err_msg=tag)
    np.testing.assert_allclose(runs[name]["port"]["metrics"]["test_loss"],
                               runs[name]["jax"]["metrics"]["test_loss"],
                               rtol=0, atol=TOL)
    # the finetune moved the loss off the base's
    steps = [v for _, v in got["train_loss_step"]]
    assert steps[0] != steps[1]


def test_lora_run_checkpoints_hold_the_adapters_only(runs):
    dirs = runs["lora"]["port"]["dirs"]
    (ckpt,) = [p for p in dirs["checkpoints"].iterdir()
               if p.name.startswith("epoch=")]
    params = load_state(ckpt)["params"]
    assert params and all(k.startswith("lora_sampler.") for k in params)
    assert len(params) == 2 * 5 * 2  # a and b of 5 layers x 2 blocks
    hp = (dirs["experiment"] / "hparams.yaml").read_text()
    assert '"lora_rank": 4' in hp and "base_port" in hp
    # the full run trained the unfrozen encoder too
    full = runs["full"]["port"]["dirs"]["checkpoints"] / "last"
    tops = {k.split(".", 1)[0] for k in load_state(full)["params"]}
    assert tops == {"sampler", "encoder"}


def _generate_cfg(root, tmp_path, extra=()):
    return ARGV[:1] + ARGV[2:] + ["action=generate", "trainer.platform=cpu",
                   f"experiment_path={root}", "duration=0.15",
                   "model_max_duration=0.64", "top_k=8",
                   "dataloader.batch_size=1", "max_batches=1",
                   f"output_dir={tmp_path}", *extra]


def test_generate_from_the_lora_experiment(runs, tmp_path, monkeypatch):
    """The port's generate action restores the LoRA run: the base it
    trained over, the ``finetune.init_from`` weights (from the run's
    ``frozen/`` save; rounded to bf16, as every generation weight),
    the adapters from its checkpoint, merged once per call into ``W +
    (alpha / r) b a``; with ``quantize`` it refuses."""
    exp = runs["lora"]["port"]["dirs"]["root"]
    seen = {}
    gen = tvaura.VauraSystem.generate

    def spy(self, *a, **k):
        seen["base"] = {n: m.weight.detach().clone()
                        for n, m in self.sampler.named_modules()
                        if hasattr(m, "merged")}
        seen["merged"] = {k2: v.detach().clone() for k2, v in
                          merge_lora(self.sampler, self.lora_sampler,
                                     self.lora_alpha).items()}
        seen["adapters"] = {k2: v.detach().clone() for k2, v in
                            self.lora_sampler.state_dict().items()}
        return gen(self, *a, **k)

    monkeypatch.setattr(tvaura.VauraSystem, "generate", spy)
    out = port_main(_generate_cfg(exp, tmp_path))
    assert out["num_generated"] == 1 and (tmp_path / "0.wav").exists()
    base = from_jax_params({"sampler": runs["tree"]["sampler"]})["sampler"]
    for name, w in seen["base"].items():
        want = base[f"{name}.weight"].to(torch.bfloat16)
        assert torch.equal(w, want), name
    (ckpt,) = [p for p in (exp / "checkpoints").iterdir()
               if p.name.startswith("epoch=")]
    trained = load_state(ckpt)["params"]
    assert any(torch.any(v != 0) for k, v in trained.items()
               if k.endswith("lora_b"))
    for name, w in seen["merged"].items():
        a = trained[f"lora_sampler.{name}.lora_a"].to(torch.bfloat16).float()
        b = trained[f"lora_sampler.{name}.lora_b"].to(torch.bfloat16).float()
        want = (seen["base"][name].float() + (8.0 / 4) * (b @ a)).to(
            torch.bfloat16)
        torch.testing.assert_close(w.float(), want.float(), rtol=0,
                                   atol=float(want.float().abs().max()) / 64)
    with pytest.raises(ValueError, match="cannot be merged into int8"):
        port_main(_generate_cfg(exp, tmp_path / "q", ["quantize=true"]))


def test_lora_base_is_the_runs_frozen_save(runs, tmp_path):
    """A LoRA run's base is read from the run's own ``frozen/`` save, which
    holds the weights the adapters trained over, also when the
    ``finetune.init_from`` its hparams name has changed since; a run
    without that save falls back to ``init_from``."""
    import shutil

    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.scripts.generate import load_lora_base_
    from vaura_tpu_torch.utils.experiment import (
        load_hparams,
        resolve_experiment_paths,
        save_hparams,
    )

    run = tmp_path / "run"
    shutil.copytree(runs["lora"]["port"]["dirs"]["root"], run)
    hp_path = resolve_experiment_paths(run)["hparams"]
    hp = load_hparams(hp_path)
    changed = tmp_path / "changed_base"
    changed.mkdir()
    params = load_state(Path(hp["finetune"]["init_from"]))["params"]
    torch.save({"params": {k: v + 1.0 if k.startswith("sampler.") else v
                           for k, v in params.items()}},
               changed / "state.pt")
    hp["finetune"]["init_from"] = str(changed)
    save_hparams(hp_path.parent, hp)
    want = from_jax_params({"sampler": runs["tree"]["sampler"]})["sampler"]

    def base():
        system = build_system(hp["model"], device="cpu")
        load_lora_base_(system, {"experiment_path": str(run)}, None)
        return system.sampler.state_dict()

    got = base()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    shutil.rmtree(run / "checkpoints" / "frozen")
    got = base()
    for k, v in want.items():
        assert torch.equal(got[k], v + 1.0), k


def test_jax_generate_merges_into_a_fresh_base(runs, tmp_path, monkeypatch):
    """JAX fault: its generate action builds the sampler from the seeded
    initialisation and restores only the adapters, so the LoRA run's base
    (``finetune.init_from``) is not what the adapters merge into. The
    parameters it hands its jitted generation are caught here (and the
    generation stopped): their base sampler is the seed's (bf16), not the
    ``init_from`` one, which the port's action loads (test above)."""
    import scripts.generate as j_gen_mod
    from vaura_tpu.models.factory import build_system as j_build

    seen = {}

    def catch(store, name, key, fn):
        def stop(params, *args):
            seen["params"] = params
            raise RuntimeError("stop after the parameters")
        return stop

    monkeypatch.setattr(j_gen_mod, "cached_jit", catch)
    exp = runs["lora"]["jax"]["dirs"]["root"]
    cfg = dict(_jax_cfg(["action=generate"]))
    cfg.update(experiment_path=str(exp), duration=0.15,
               model_max_duration=0.64, max_batches=1,
               output_dir=str(tmp_path),
               dataloader=dict(cfg["dataloader"], batch_size=1))
    j_gen_mod.generate(cfg)
    assert "lora_sampler" in seen["params"]
    wq = np_tree(seen["params"]["sampler"])["layers"]["attention"]["wqkv"][
        "kernel"]
    base = runs["tree"]["sampler"]["layers"]["attention"]["wqkv"]["kernel"]
    assert np.abs(wq - base).max() > 0.1  # not the init_from base
    jsys = j_build(dict(_jax_cfg(LORA)["model"], lora_rank=4))
    _, init_rng = jax.random.split(jax.random.PRNGKey(666))
    fresh = np_tree(jsys.init_params(init_rng)["sampler"])
    np.testing.assert_allclose(  # the seeded init, rounded to bf16
        wq, fresh["layers"]["attention"]["wqkv"]["kernel"], rtol=1e-2,
        atol=1e-3)


def test_serve_the_lora_experiment(runs):
    """The server restores the LoRA run as the generate action does (the
    ``init_from`` base, the adapters from the checkpoint), generates with
    them merged, hot-reloads new adapters (also while a batch is in
    flight), and refuses ``quantize=true``."""
    from vaura_tpu_torch.main import get_config
    from vaura_tpu_torch.scripts.serve import GenerationService

    exp = runs["lora"]["port"]["dirs"]["root"]
    cfg = dict(get_config(ARGV[:1] + ["action=serve", "trainer.platform=cpu"]))
    cfg.update(experiment_path=str(exp), batch=1, duration=0.15, top_k=8,
               use_sampling=False)
    svc = GenerationService(cfg)
    try:
        system = svc.system
        base = from_jax_params({"sampler": runs["tree"]["sampler"]})["sampler"]
        wqkv = system.sampler.get_submodule("layers.1.attention.wqkv")
        assert torch.equal(wqkv.weight, base["layers.1.attention.wqkv.weight"]
                           .to(torch.bfloat16))
        (ckpt,) = [p for p in (exp / "checkpoints").iterdir()
                   if p.name.startswith("epoch=")]
        trained = load_state(ckpt)["params"]
        for k, v in system.lora_sampler.state_dict().items():
            assert torch.equal(v, trained[f"lora_sampler.{k}"].to(
                torch.bfloat16).float()), k
        feats = svc._put_batch(np.random.default_rng(0).standard_normal(
            (1, svc.tv, svc.cond_dim)).astype(np.float32))
        first = svc._generate(feats, seed=0)["codes"]
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():  # other adapters: other codes
            for p in system.lora_sampler.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        assert not torch.equal(svc._generate(feats, seed=0)["codes"], first)
        info = svc.reload(str(ckpt))
        assert info["reloaded"] and svc.system.lora_sampler is not \
            system.lora_sampler
        assert svc.system.sampler is system.sampler
        assert torch.equal(svc._generate(feats, seed=0)["codes"], first)
        # a reload while a batch is in flight (here from inside its decode,
        # with the merged weights installed): the batch after it still
        # merges the adapters
        dense = svc.system.sampler.get_submodule("layers.0.attention.wqkv")
        reloads = []

        def reload_once(module, args):
            if not reloads:
                assert module.merged is not None
                reloads.append(svc.reload(str(ckpt)))

        handle = dense.register_forward_pre_hook(reload_once)
        try:
            svc._generate(feats, seed=0)
        finally:
            handle.remove()
        assert reloads and reloads[0]["reloaded"]
        assert dense.merged is None
        merged_at = []
        handle = dense.register_forward_pre_hook(
            lambda module, args: merged_at.append(module.merged is not None))
        try:
            assert torch.equal(svc._generate(feats, seed=0)["codes"], first)
        finally:
            handle.remove()
        assert merged_at and all(merged_at)
    finally:
        svc.close(timeout=10)
    with pytest.raises(ValueError, match="cannot be merged into int8"):
        GenerationService(dict(cfg, quantize=True))
    svc = GenerationService(dict(cfg, quantize="cache"))
    svc.close(timeout=10)
