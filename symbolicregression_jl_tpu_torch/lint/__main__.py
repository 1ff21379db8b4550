"""Entry point: ``python -m symbolicregression_jl_tpu_torch.lint``."""

import os
import sys

from .cli import main

try:
    code = main()
except BrokenPipeError:
    # downstream pager/head closed the pipe — conventional silent exit
    devnull = os.open(os.devnull, os.O_WRONLY)
    os.dup2(devnull, sys.stdout.fileno())
    code = 0
sys.exit(code)
