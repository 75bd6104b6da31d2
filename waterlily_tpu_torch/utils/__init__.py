"""Diagnostics of the port (`metrics`)."""
