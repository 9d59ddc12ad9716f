"""Patch-grid arithmetic."""
