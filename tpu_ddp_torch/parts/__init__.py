"""The ladder's entry points: ``python -m tpu_ddp_torch.parts partN``."""

from tpu_ddp_torch.parts.common import parse_arguments, run_part  # noqa: F401
