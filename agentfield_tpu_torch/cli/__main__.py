"""``python -m agentfield_tpu_torch.cli``: the ``aftpu`` CLI."""

import sys

from agentfield_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
