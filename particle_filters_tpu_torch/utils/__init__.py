"""Utilities of the port: device-synchronised timing (``timing``)."""
