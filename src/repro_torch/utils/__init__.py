"""Shared helpers of the port (copies of what it needs from `repro/utils`)."""
