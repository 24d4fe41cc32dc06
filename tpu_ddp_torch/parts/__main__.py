"""``python -m tpu_ddp_torch.parts part{1,2a,2b,3} [flags]``."""

import sys

from tpu_ddp_torch.parts.common import main

sys.exit(main())
