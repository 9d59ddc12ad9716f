"""Slide readers and synthetic slides."""
