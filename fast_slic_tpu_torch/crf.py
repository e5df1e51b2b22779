"""Compat re-export matching ``fast_slic/crf.py``."""
from .models.crf import SimpleCRF, SimpleCRFFrame  # noqa: F401
