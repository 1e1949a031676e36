"""Sample sources (files and SDR devices), sinks and the WAV writer (numpy,
host side)."""

from . import rtl_tcp as _rtl_tcp  # noqa: F401  registers the "rtl_tcp" SdrSource driver
