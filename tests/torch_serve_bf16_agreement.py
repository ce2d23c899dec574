"""How far the port's server agrees with the JAX package's with the shipped
bf16-cast weights, on the CPU (a script, not a test):

    JAX_PLATFORMS=cpu python tests/torch_serve_bf16_agreement.py

Both ``GenerationService``s are made at the tiny ``dummy.yaml`` geometry of
``tests/test_torch_serve.py``, greedy with CFG 3, from the same float32
codec and sampler weights (the JAX service through ``init_params``, the
port's loaded through ``from_jax_params``), each put through what the
service does at startup: the codec's codebooks into the sampler's
embeddings, every parameter rounded to bf16. For batches of 2 padded requests it prints how
many codes of ``_generate`` agree and the relative RMS of the audio
difference. ``tests/test_torch_serve.py`` holds the same call in float32,
token for token.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "tests")]

import test_torch_serve as T  # noqa: E402


def main():
    from vaura_tpu_torch.convert import from_jax_params
    from vaura_tpu_torch.scripts.generate import _round_params_to_bf16_
    from vaura_tpu_torch.scripts.serve import GenerationService

    jsvc, _, tree, _ = T.make_jax_service()
    tsvc = GenerationService(T._cfg(**T.GEOMETRY, use_sampling=False,
                                    cfg_scale=3.0))
    # what each service does at startup: the DAC codebooks into the
    # sampler's embeddings, then every parameter rounded to bf16
    tsvc.system.load_state_dicts(from_jax_params(tree))
    tsvc.system.load_dac_embeddings_into_sampler()
    _round_params_to_bf16_(tsvc.system)
    rng = np.random.default_rng(0)
    same = total = 0
    for seed in range(4):
        feats = np.zeros((2, jsvc.tv, jsvc.cond_dim), np.float32)
        feats[:, :5] = rng.standard_normal((2, 5, jsvc.cond_dim))
        jo = jsvc._generate(jsvc._put_batch(feats), seed)
        with torch.inference_mode():
            to = tsvc._generate(tsvc._put_batch(feats), seed)
        jc, tc = np.asarray(jo["codes"]), to["codes"].numpy()
        ja, ta = np.asarray(jo["audio"], np.float32), to["audio"].float().numpy()
        rel = np.sqrt(((ta - ja) ** 2).mean() / max((ja ** 2).mean(), 1e-12))
        same += int((jc == tc).sum())
        total += jc.size
        print(f"batch {seed}: {int((jc == tc).sum())} of {jc.size} codes "
              f"agree; audio relative RMS difference {rel:.3e}")
    print(f"all: {same} of {total} codes agree ({same / total:.1%})")


if __name__ == "__main__":
    main()
