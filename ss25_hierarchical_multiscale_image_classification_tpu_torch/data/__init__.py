"""Inference-time preprocessing (normalize, resize)."""
