"""Shared utilities: timing and logging."""
