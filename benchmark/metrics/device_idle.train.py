"""The device's idle share of the traced window: 1 - busy / window, where
busy is the union of the device's operation intervals, in %."""
from common.readers import idle_share as read  # noqa: F401
