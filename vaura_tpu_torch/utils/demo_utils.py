"""Demo checkpoint resolution.

Counterpart of ``vaura_tpu/utils/demo_utils.py`` (reference
``utils/demo_utils.py``): the released V-AURA checkpoint and the
Segment-AVCLIP (Synchformer stage-I) weights live at ``VAURA_CKPT_URL`` and
``AVCLIP_CKPT_URL``. The port downloads nothing: ``load_demo_model`` loads a
tree already on disk (the extracted ``v-aura-visual-sound`` archive under
``cache_dir``, or any reference experiment directory or ``.ckpt``) and
otherwise raises with both URLs, as the JAX function does offline.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

# released artifact URLs (reference demo_utils.py:12-14)
VAURA_CKPT_URL = (
    "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a"
    "/v-aura-public/v-aura-visual-sound.tar.gz"
)
AVCLIP_CKPT_URL = (
    "https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a"
    "/sync/sync_models/24-01-04T16-39-21/epoch_best.pt"
)
EXTRACTED = "v-aura-visual-sound"


def load_demo_model(cache_dir: str | Path = "./checkpoints"
                    ) -> Tuple[Dict[str, Any], Dict[str, Any], Path]:
    """``(model_cfg, state_dicts, ckpt_path)`` of the released checkpoint
    (``utils/reference_ckpt.py::load_reference_experiment``: the best
    ``val_loss`` ``.ckpt`` of the tree and its ``hparams.yaml``), for
    ``build_system`` and ``VauraSystem.load_state_dicts``. ``cache_dir``
    holds the extracted archive (``<cache_dir>/v-aura-visual-sound``) or is
    itself a reference experiment; else ``FileNotFoundError`` names the
    URLs to fetch by hand."""
    from vaura_tpu_torch.utils.reference_ckpt import (
        is_reference_checkpoint,
        load_reference_experiment,
    )

    cache = Path(cache_dir)
    for tree in (cache / EXTRACTED, cache):
        if tree.exists() and is_reference_checkpoint(tree):
            return load_reference_experiment(tree)
    raise FileNotFoundError(
        f"no demo checkpoint under {cache}. This package downloads "
        f"nothing: fetch\n  {VAURA_CKPT_URL}\n  {AVCLIP_CKPT_URL}\n"
        f"extract the first into {cache / EXTRACTED} and pass --ckpt (or "
        "cache_dir) to the demo")
