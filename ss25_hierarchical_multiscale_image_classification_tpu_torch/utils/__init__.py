"""Directory restructure and data-integrity tools (``utils/structure.py``)."""
