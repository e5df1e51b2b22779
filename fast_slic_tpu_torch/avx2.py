"""Compat shim for ``fast_slic.avx2`` imports (`from fast_slic.avx2 import
SlicAvx2` ports with the package rename).  The arch name does not choose
the implementation here: the device does."""
from .models.slic import LSC, BaseSlic


class SlicAvx2(BaseSlic):
    arch_name = "x64/avx2"


class LSCAvx2(LSC):
    arch_name = "x64/avx2"
