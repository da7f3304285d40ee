import sys

from repro_torch.lint.cli import main

sys.exit(main())
