"""Utilities of the port (``utils/render.py`` so far)."""
