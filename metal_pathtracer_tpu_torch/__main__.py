"""``python -m metal_pathtracer_tpu_torch``: the headless CLI."""

import sys

from metal_pathtracer_tpu_torch.cli import main

sys.exit(main())
