"""Layers of the port's ``nn``."""

from .loss import *  # noqa: F401,F403
from .loss import __all__
