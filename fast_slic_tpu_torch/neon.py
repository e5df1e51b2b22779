"""Compat shim for ``fast_slic.neon`` imports; the device, not the arch
name, chooses the implementation."""
from .models.slic import LSC, BaseSlic


class SlicNeon(BaseSlic):
    arch_name = "arm/neon"


class LSCNeon(LSC):
    arch_name = "arm/neon"
