"""PyTorch port: fixed-point CIELAB against the JAX package.

The port's plain PyTorch conversion (the CPU side of the LAB kernel
wrapper) must equal the JAX package's numpy oracle on every one of the 2^24
RGB values, and its Pallas LAB kernel (interpret mode) on an image.
Exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fast_slic_tpu.ops.cielab import rgb_to_lab_quantized_np
from fast_slic_tpu.pallas.lut_tpu import rgb_to_lab_planar as lab_pallas
from fast_slic_tpu_torch.kernels import lab as lab_kernel
from fast_slic_tpu_torch.ops import cielab as port_cielab
from torch_threads import one_torch_thread  # noqa: F401


def test_tables_equal_jax_package():
    from fast_slic_tpu.ops import cielab as jax_cielab
    for name in ("_SRGB_TBL_NP", "_CB_NP", "_LAB_TBL_NP"):
        np.testing.assert_array_equal(getattr(port_cielab, name),
                                      getattr(jax_cielab, name))


def test_all_rgb_values_match_numpy_oracle():
    v = np.arange(1 << 24, dtype=np.uint32)
    cube = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                    -1).astype(np.uint8).reshape(4096, 4096, 3)
    for c in range(16):  # 2^20 pixels a chunk keeps memory small
        chunk = cube[c * 256:(c + 1) * 256]
        got = lab_kernel.rgb_to_lab_planar(torch.from_numpy(chunk)).numpy()
        ref = np.moveaxis(rgb_to_lab_quantized_np(chunk), -1, 0)
        np.testing.assert_array_equal(got, ref.astype(np.int32))


def test_matches_pallas_lab_kernel_interpret(rng):
    img = rng.integers(0, 256, size=(45, 67, 3)).astype(np.uint8)
    img[0, 0] = (0, 0, 0)
    img[0, 1] = (255, 255, 255)
    ref = np.asarray(lab_pallas(jnp.asarray(img), interpret=True))
    got = lab_kernel.rgb_to_lab_planar(torch.from_numpy(img))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 45, 67)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrapper_rejects_bad_shape():
    with pytest.raises(ValueError):
        lab_kernel.rgb_to_lab_planar(torch.zeros((4, 4), dtype=torch.uint8))
