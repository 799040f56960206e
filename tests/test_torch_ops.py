"""The PyTorch port's ops against the JAX package's, on the same numpy inputs.

Both sides compute in float32 with the same coefficients and weight
matrices; they differ only in summation order, so the bars are the
1e-6 to 1e-5 of tests/test_ops.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelslim_depth_tpu import ops as jops
from gelslim_depth_tpu_torch import ops as tops

IMG_PARAMS = ([1.0, 2.0, 3.0], [250.0, 240.0, 230.0], [100.0, 110.0, 120.0], [30.0, 31.0, 32.0])
SHORT_IMG_PARAMS = ([1.0], [250.0, 240.0], [100.0], [30.0, 31.0])
DEPTH_PARAMS = (-1.9180814027786255, 0.0, -0.25, 0.42)


def test_difference_image(rng):
    x = rng.uniform(0, 255, (2, 3, 8, 9)).astype(np.float32)
    b = rng.uniform(0, 255, (2, 3, 8, 9)).astype(np.float32)
    got = tops.get_difference_image(torch.from_numpy(x), torch.from_numpy(b)).numpy()
    want = np.asarray(jops.get_difference_image(jnp.asarray(x), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "in_size,out_size",
    [
        ((32, 427), (16, 213)),   # the shipped non-integer 427 -> 213 axis
        ((16, 21), (40, 53)),     # upsampling, as the mm back-resize does
        ((20, 30), (7, 11)),      # non-integer on both axes
    ],
)
def test_area_resize(rng, in_size, out_size):
    x = rng.uniform(0, 255, (2, 3, *in_size)).astype(np.float32)
    got = tops.area_resize(torch.from_numpy(x), out_size).numpy()
    want = np.asarray(jops.area_resize(jnp.asarray(x), out_size))
    assert got.shape == (2, 3, *out_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_area_resize_identity_short_circuit(rng):
    x = torch.from_numpy(rng.uniform(0, 255, (1, 3, 8, 9)).astype(np.float32))
    assert tops.area_resize(x, (8, 9)) is x


@pytest.mark.parametrize("user_precision", ["highest", "high", "medium"])
def test_area_resize_contracts_at_highest_precision(monkeypatch, user_precision):
    """The contractions run at float32 matmul precision "highest" (no TF32)
    whatever the caller set, and the caller's setting is restored."""
    seen = []
    einsum = torch.einsum

    def spy(*a, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return einsum(*a, **kw)

    monkeypatch.setattr(torch, "einsum", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(user_precision)
    try:
        tops.area_resize(torch.zeros((1, 3, 8, 9)), (4, 5))
        assert seen == ["highest", "highest"]
        assert torch.get_float32_matmul_precision() == user_precision
    finally:
        torch.set_float32_matmul_precision(prev)


def test_resize_only_area_is_ported(rng):
    """'area', 'bilinear' and 'nearest' are ported (tests/test_torch_resize.py);
    the other jax.image.resize kernels the JAX package passes through are not."""
    x = torch.zeros((1, 1, 4, 4))
    for method in ("bicubic", "lanczos3"):
        with pytest.raises(ValueError, match="interp_method"):
            tops.resize(x, (2, 2), method)


@pytest.mark.parametrize("params", [IMG_PARAMS, SHORT_IMG_PARAMS], ids=["full", "short"])
@pytest.mark.parametrize("method", tops.normalize.IMAGE_NORMALIZATION_METHODS)
def test_image_normalization(rng, method, params):
    x = rng.uniform(0, 255, (4, 3, 10, 12)).astype(np.float32)
    got = tops.normalize_tactile_image(torch.from_numpy(x), method, 0.9, params).numpy()
    want = np.asarray(jops.normalize_tactile_image(jnp.asarray(x), method, 0.9, params))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    back = tops.denormalize_tactile_image(torch.from_numpy(got), method, 0.9, params).numpy()
    want_back = np.asarray(jops.denormalize_tactile_image(jnp.asarray(got), method, 0.9, params))
    np.testing.assert_allclose(back, want_back, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", tops.normalize.DEPTH_NORMALIZATION_METHODS)
def test_depth_normalization(rng, method):
    x = rng.uniform(-1.9, 0, (4, 1, 10, 12)).astype(np.float32)
    got = tops.normalize_depth_image(torch.from_numpy(x), method, 0.9, DEPTH_PARAMS).numpy()
    want = np.asarray(jops.normalize_depth_image(jnp.asarray(x), method, 0.9, DEPTH_PARAMS))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    back = tops.denormalize_depth_image(torch.from_numpy(got), method, 0.9, DEPTH_PARAMS).numpy()
    want_back = np.asarray(jops.denormalize_depth_image(jnp.asarray(got), method, 0.9, DEPTH_PARAMS))
    np.testing.assert_allclose(back, want_back, rtol=1e-6, atol=1e-6)


def test_norm_coeffs_identical(rng):
    """The float64 coefficient math is a copy: it must agree exactly."""
    for method in tops.normalize.IMAGE_NORMALIZATION_METHODS:
        for a, b in zip(
            tops.image_norm_coeffs(method, 0.9, SHORT_IMG_PARAMS, 5),
            jops.image_norm_coeffs(method, 0.9, SHORT_IMG_PARAMS, 5),
        ):
            np.testing.assert_array_equal(a, b)
    for method in tops.normalize.DEPTH_NORMALIZATION_METHODS:
        assert tops.depth_norm_coeffs(method, 0.9, DEPTH_PARAMS) == jops.depth_norm_coeffs(
            method, 0.9, DEPTH_PARAMS
        )
