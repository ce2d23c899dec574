"""``python -m vaura_tpu_torch config=<yaml> [key=value ...]``."""

from vaura_tpu_torch.main import main

main()
