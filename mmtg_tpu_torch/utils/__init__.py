"""Shared utilities: timing, logging and the roofline accounting."""
