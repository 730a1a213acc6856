"""Launchers: ``serve`` (oneshot / async RMQ serving CLI)."""
