"""Run the quantization proxies' overfit recipe (``quant_proxy.overfit``,
the one both quantization-quality scripts train) several times in one
process and report how far the runs end apart: each run's loss after every
step, the final losses and the first step at which the runs' losses part.

With ``--deterministic`` the runs take PyTorch's deterministic algorithms
(``torch.use_deterministic_algorithms``; the cuBLAS workspace is set as that
needs, before the first product), so that a spread which remains is not the
order of atomic sums. The flagship recipe by default, as the scripts train
it; ``--mid``/``--tiny`` as theirs. Prints one JSON object.

    python -m vaura_tpu_torch.scripts.overfit_repeat [--runs 2]
        [--deterministic] [--steps 150] [--mid | --tiny] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import torch

from vaura_tpu_torch.scripts.quant_proxy import (
    overfit,
    proxy_config,
    proxy_device,
)

LR = 3e-4  # the scripts' learning rate


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=221)
    ap.add_argument("--platform", type=str, default=None)
    ap.add_argument("--mid", action="store_true", help="6L x 512d proxy")
    ap.add_argument("--tiny", action="store_true", help="2L x 192d")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    if args.deterministic:
        # read when cuBLAS makes its handle: before any product
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _repeat(args)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def _repeat(args) -> dict:
    device = proxy_device(args.platform)
    cfg = proxy_config(args.tiny, args.mid)
    tokens = min(args.tokens, 48) if args.tiny else args.tokens
    runs, warned = [], set()
    for _ in range(args.runs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            system, _, run = overfit(cfg, device, steps=args.steps,
                                     batch=args.batch, lr=LR, tokens=tokens)
        warned |= {str(w.message).split("\n")[0] for w in caught
                   if "deterministic" in str(w.message)}
        runs.append({"losses": run["losses"], "seconds": run["seconds"]})
        del system
        if device.type == "cuda":
            torch.cuda.empty_cache()
    first = runs[0]["losses"]
    parted = next((i for i in range(len(first))
                   if any(r["losses"][i] != first[i] for r in runs[1:])),
                  None)
    finals = [r["losses"][-1] for r in runs]
    out = {"runs": args.runs, "deterministic": args.deterministic,
           "steps": args.steps, "final_losses": finals,
           "spread": max(finals) - min(finals),
           "first_step_apart": parted,
           "seconds": [r["seconds"] for r in runs],
           "nondeterministic_ops": sorted(warned),
           "losses": [r["losses"] for r in runs]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
