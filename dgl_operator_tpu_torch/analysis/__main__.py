"""``python -m dgl_operator_tpu_torch.analysis`` — the port's lint."""

import sys

from dgl_operator_tpu_torch.analysis.cli import main

try:
    sys.exit(main())
except BrokenPipeError:      # report piped into head/grep that closed
    sys.exit(0)
