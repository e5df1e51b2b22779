"""Compat shim for ``fast_slic.neon`` imports; the device, not the arch
name, chooses the implementation."""
from .models.slic import BaseSlic


class SlicNeon(BaseSlic):
    arch_name = "arm/neon"
