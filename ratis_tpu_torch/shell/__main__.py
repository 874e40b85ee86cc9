"""``python -m ratis_tpu_torch.shell`` — the admin CLI entry point
(reference ratis-shell/src/main/bin + RatisShell.main:60)."""

import sys

from ratis_tpu_torch.shell.cli import main

sys.exit(main())
