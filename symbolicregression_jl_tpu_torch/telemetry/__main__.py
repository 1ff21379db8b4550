"""``python -m symbolicregression_jl_tpu_torch.telemetry`` entry point."""

import sys

from .report import main

if __name__ == "__main__":
    sys.exit(main())
