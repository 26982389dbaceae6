"""Config, schedule and console logging of the port."""

from commefficient_tpu_torch.utils.config import Config, parse_args
from commefficient_tpu_torch.utils.schedule import piecewise_linear_lr

__all__ = ["Config", "parse_args", "piecewise_linear_lr"]
