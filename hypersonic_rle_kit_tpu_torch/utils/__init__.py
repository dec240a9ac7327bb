"""Shared utilities: bit IO, timing, entropy metrics."""
