"""Evaluation: uncertainty estimates."""
