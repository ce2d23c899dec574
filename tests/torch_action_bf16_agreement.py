"""How far the port's generate action agrees with the JAX package's with the
shipped bf16-cast weights, on the CPU (a script, not a test):

    JAX_PLATFORMS=cpu python tests/torch_action_bf16_agreement.py

On the synthetic reference experiment of ``torch_reference_util`` it runs
both actions greedily (one chunk, ``quantize=true``, ``long_mode=stream_kv``)
and prints, for each, how many codes agree and the relative RMS of the WAV
difference; then, for the one-chunk run, the top-2 logit margin of every
greedy choice of the port (teacher-forced on the JAX action's codes, as a
fraction of the logits' standard deviation), smallest first, beside the
choices where the two actions differ. ``tests/test_torch_generate_action.py``
holds the same pieces in float32 token for token.
"""

import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

from torch_reference_util import write_reference_experiment  # noqa: E402

COMMON = ["config=configs/experiments/dummy.yaml", "action=generate",
          "use_sampling=false", "return_sampled_indices=true", "max_batches=1",
          "dataloader.batch_size=1", "cfg_scale=3.0"]
MODES = {
    "one_chunk": ["duration=0.15", "model_max_duration=0.64"],
    "quantize": ["duration=0.15", "model_max_duration=0.64", "quantize=true"],
    "stream_kv": ["duration=1.28", "model_max_duration=0.64", "stride=0.64",
                  "long_mode=stream_kv"],
}


def run_actions(exp: Path, out: Path):
    from scripts.generate import generate as j_generate
    from vaura_tpu.config import assemble_config as j_assemble
    from vaura_tpu.ops.audio import read_wav
    from vaura_tpu_torch.config import assemble_config as t_assemble
    from vaura_tpu_torch.scripts.generate import generate as t_generate

    codes = {}
    for mode, extra in MODES.items():
        argv = COMMON + extra + [f"experiment_path={exp}"]
        j_generate(j_assemble(argv + [f"output_dir={out / mode / 'jax'}"],
                              base_dir=REPO))
        t_generate(t_assemble(argv + [f"output_dir={out / mode / 'port'}",
                                      "trainer.platform=cpu"], base_dir=REPO))
        a = np.load(out / mode / "jax" / "0.codes.npy")
        b = np.load(out / mode / "port" / "0.codes.npy")
        wa, wb = (read_wav(out / mode / side / "0.wav")[0]
                  for side in ("jax", "port"))
        rel = np.sqrt(((wa - wb) ** 2).mean() / max((wa ** 2).mean(), 1e-12))
        print(f"{mode}: {int((a == b).sum())} of {a.size} codes agree; WAV "
              f"relative RMS difference {rel:.3g}; differ at (codebook, t) "
              f"{np.argwhere(a != b).tolist()[:6]}")
        codes[mode] = a
    return codes


def margins(exp: Path, jax_codes: np.ndarray):
    """Top-2 margins of the port's bf16 one-chunk decode, teacher-forced on
    ``jax_codes`` ``[K, T]``: ``[(margin / std, step, codebook)]``."""
    from vaura_tpu_torch.models.factory import build_system
    from vaura_tpu_torch.ops.sampling import cfg_blend
    from vaura_tpu_torch.scripts.generate import _round_params_to_bf16_
    from vaura_tpu_torch.utils.reference_ckpt import load_reference_experiment

    cfg, sds, _ = load_reference_experiment(exp)
    system = build_system(cfg, device="cpu", param_dtype=torch.bfloat16)
    system.load_state_dicts(sds)
    system.requires_grad_(False)
    _round_params_to_bf16_(system)
    K, T = jax_codes.shape
    pattern, valid, S = system.prepare_generation(T)
    seq, _, _ = pattern.build_pattern_sequence(
        torch.from_numpy(jax_codes)[None].long(), system.special_token_id)
    frames = torch.zeros(1, 4, 3, 16, 224, 224)  # the dummy datamodule's item 0
    cond = system.build_cond_seq_for_generation(
        system.visual_features(frames), S, 7, cfg=True)
    cache = system.sampler.init_cache(2, S)
    out = []
    with torch.no_grad():
        for s in range(1, S):
            logits = system.sampler.decode_step(
                seq[:, :, s - 1:s].repeat(2, 1, 1), cond[:, s - 1:s], cache, s - 1)
            blend = cfg_blend(logits[:1], logits[1:], 3.0).float().reshape(K, -1)
            top = torch.topk(blend, 2, dim=-1).values
            for k in range(K):
                if valid[k, s]:
                    out.append((float((top[k, 0] - top[k, 1]) / blend[k].std()),
                                s, k))
    return sorted(out)


def main():
    with tempfile.TemporaryDirectory() as tmp:
        exp = write_reference_experiment(Path(tmp) / "exp")
        codes = run_actions(exp, Path(tmp) / "out")
        print("one_chunk, the closest greedy calls (margin / std, step, "
              "codebook):")
        for m in margins(exp, codes["one_chunk"])[:5]:
            print(f"  {m[0]:.4f} at step {m[1]}, codebook {m[2]}")


if __name__ == "__main__":
    main()
