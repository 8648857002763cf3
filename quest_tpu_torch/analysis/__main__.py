"""``python -m quest_tpu_torch.analysis`` — run quest-lint over the port."""

import sys

from quest_tpu_torch.analysis.cli import main

sys.exit(main(sys.argv[1:]))
