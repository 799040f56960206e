"""The port's fused preprocess against the JAX Pallas kernel.

On the CPU the port's wrapper computes its plain twin; the JAX kernel runs
in Pallas interpret mode, as tests/test_pallas_preprocess.py runs it. Both
compute the same float32 window sums in another order: 1e-5, the bar of
tests/test_pallas_preprocess.py. The CUDA kernel itself is held against
the twin by the card-only test at the end and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelslim_depth_tpu.ops.pallas.preprocess_kernel import (
    fused_preprocess_dual as jax_fused_preprocess_dual,
    fused_preprocess_dual_reference as jax_reference,
)
from gelslim_depth_tpu_torch.ops.kernels import (
    fused_preprocess_dual,
    fused_preprocess_dual_reference,
)

MULT = np.asarray([1 / 255.0, 1 / 255.0, 1 / 255.0], np.float32)
ADD = np.zeros(3, np.float32)


@pytest.mark.parametrize("use_diff", [True, False])
def test_matches_jax_kernel(rng, use_diff):
    frames = rng.uniform(0, 255, (3, 6, 64, 86)).astype(np.float32)
    base = rng.uniform(0, 255, (6, 64, 86)).astype(np.float32)
    got = fused_preprocess_dual(
        torch.from_numpy(frames), torch.from_numpy(base), MULT, ADD,
        out_size=(32, 43), use_diff=use_diff,
    ).numpy()
    want = jax_fused_preprocess_dual(
        jnp.asarray(frames), jnp.asarray(base), MULT, ADD,
        out_size=(32, 43), use_diff=use_diff, interpret=True,
    )
    assert got.shape == (6, 3, 32, 43)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_finger_order():
    """Left-finger samples occupy rows [0, N), right rows [N, 2N)."""
    frames = np.zeros((2, 6, 32, 43), np.float32)
    frames[:, 0:3] = 200.0  # left bright
    frames[:, 3:6] = 50.0   # right dark
    base = np.full((6, 32, 43), 100.0, np.float32)
    out = fused_preprocess_dual(
        torch.from_numpy(frames), torch.from_numpy(base), MULT, ADD, out_size=(16, 21)
    ).numpy()
    want = np.asarray(jax_fused_preprocess_dual(
        jnp.asarray(frames), jnp.asarray(base), MULT, ADD, out_size=(16, 21), interpret=True
    ))
    np.testing.assert_allclose(out[:2], ((200 - 100 + 255) / 2) / 255.0, rtol=1e-5)
    np.testing.assert_allclose(out[2:], ((50 - 100 + 255) / 2) / 255.0, rtol=1e-5)
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_nonuniform_channel_coeffs(rng):
    frames = rng.uniform(0, 255, (1, 6, 32, 43)).astype(np.float32)
    base = rng.uniform(0, 255, (6, 32, 43)).astype(np.float32)
    mult = np.asarray([0.01, 0.02, 0.03], np.float32)
    add = np.asarray([-1.0, 0.5, 2.0], np.float32)
    got = fused_preprocess_dual(
        torch.from_numpy(frames), torch.from_numpy(base), mult, add, out_size=(16, 21)
    ).numpy()
    want = jax_fused_preprocess_dual(
        jnp.asarray(frames), jnp.asarray(base), mult, add, out_size=(16, 21), interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    oracle = jax_reference(jnp.asarray(frames), jnp.asarray(base), mult, add, out_size=(16, 21))
    np.testing.assert_allclose(got, np.asarray(oracle), rtol=1e-5, atol=1e-5)


def test_upsampling_matches_jax_oracle(rng):
    """Window 1 and 2 along both axes (the kernel takes any (H,W)->(h,w))."""
    frames = rng.uniform(0, 255, (2, 6, 16, 21)).astype(np.float32)
    base = rng.uniform(0, 255, (6, 16, 21)).astype(np.float32)
    got = fused_preprocess_dual(
        torch.from_numpy(frames), torch.from_numpy(base), MULT, ADD, out_size=(32, 43)
    ).numpy()
    want = jax_reference(jnp.asarray(frames), jnp.asarray(base), MULT, ADD, out_size=(32, 43))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_twin_and_launch_nothing(rng, monkeypatch):
    frames = torch.from_numpy(rng.uniform(0, 255, (2, 6, 32, 43)).astype(np.float32))
    base = torch.from_numpy(rng.uniform(0, 255, (6, 32, 43)).astype(np.float32))
    calls = []

    def spy(*a, **kw):
        calls.append(1)
        return fused_preprocess_dual_reference(*a, **kw)

    from gelslim_depth_tpu_torch.ops.kernels import preprocess_kernel

    monkeypatch.setattr(preprocess_kernel, "fused_preprocess_dual_reference", spy)
    before = fused_preprocess_dual.launches
    out = fused_preprocess_dual(frames, base, MULT, ADD, out_size=(16, 21))
    assert calls == [1]
    assert fused_preprocess_dual.launches == before
    assert out.shape == (4, 3, 16, 21) and out.dtype == torch.float32


def test_empty_batch_gives_an_empty_output():
    before = fused_preprocess_dual.launches
    out = fused_preprocess_dual(
        torch.zeros((0, 6, 32, 43)), torch.zeros((6, 32, 43)), MULT, ADD, out_size=(16, 21)
    )
    assert out.shape == (0, 3, 16, 21) and out.dtype == torch.float32
    assert fused_preprocess_dual.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    frames = torch.zeros((1, 6, 8, 9))
    with pytest.raises(ValueError):
        fused_preprocess_dual(torch.zeros((1, 3, 8, 9)), None, MULT, ADD, out_size=(4, 4), use_diff=False)
    with pytest.raises(ValueError):
        fused_preprocess_dual(frames, torch.zeros((6, 8, 8)), MULT, ADD, out_size=(4, 4))
    with pytest.raises(TypeError):
        fused_preprocess_dual(frames.double(), None, MULT, ADD, out_size=(4, 4), use_diff=False)
    with pytest.raises(ValueError):
        fused_preprocess_dual(frames, None, MULT[:2], ADD, out_size=(4, 4), use_diff=False)


@pytest.mark.cuda
def test_cuda_kernel_matches_twin_at_flagship_shape():
    """The compiled kernel at the flagship shape, against its twin on the
    card: max |diff| < 1e-5, the Mosaic bar of test_pallas_preprocess.py."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator(device="cuda").manual_seed(0)
    frames = torch.rand((2, 6, 320, 427), generator=g, device="cuda") * 255
    base = torch.rand((6, 320, 427), generator=g, device="cuda") * 255
    for use_diff in (True, False):
        before = fused_preprocess_dual.launches
        got = fused_preprocess_dual(frames, base, MULT, ADD, out_size=(160, 213), use_diff=use_diff)
        want = fused_preprocess_dual_reference(frames, base, MULT, ADD, out_size=(160, 213), use_diff=use_diff)
        torch.cuda.synchronize()
        assert fused_preprocess_dual.launches == before + 1
        assert (got - want).abs().max().item() < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,frame,out_size,use_diff,misaligned,coeffs", [
    (3, (33, 47), (16, 23), True, False, "uniform"),    # plane bytes not a multiple of 16
    (3, (33, 47), (16, 23), False, False, "uniform"),
    (3, (33, 47), (16, 23), True, True, "uniform"),     # frames[1:] and base[1:]: data_ptr off 16 B
    (3, (33, 47), (16, 23), False, True, "nonuniform"),
    (2, (321, 427), (160, 213), True, False, "uniform"),  # row windows overlap the next tile
    (5, (320, 427), (160, 213), True, False, "nonuniform"),  # N that no frame chunk divides
    (13, (320, 427), (160, 213), True, False, "uniform"),
    (3, (64, 86), (16, 21), True, False, "nonuniform"),  # windows of 4-5: loops of any extent
])
def test_cuda_kernel_matches_twin_on_ragged_shapes(n, frame, out_size, use_diff, misaligned, coeffs):
    """Shapes whose spans start or end off 16 B, overlap between tiles, or
    split unevenly into frame chunks: max |diff| < 1e-5 against the twin, or
    rtol/atol 1e-5 with non-uniform coefficients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    g = torch.Generator(device="cuda").manual_seed(1)
    k = int(misaligned)
    frames = (torch.rand((n + k, 6, *frame), generator=g, device="cuda") * 255)[k:]
    base = (torch.rand((6 + k, *frame), generator=g, device="cuda") * 255)[k:]
    if misaligned:
        assert frames.data_ptr() % 16 and base.data_ptr() % 16
    mult, add = (MULT, ADD) if coeffs == "uniform" else ([0.01, 0.02, 0.03], [-1.0, 0.5, 2.0])
    before = fused_preprocess_dual.launches
    got = fused_preprocess_dual(frames, base, mult, add, out_size=out_size, use_diff=use_diff)
    want = fused_preprocess_dual_reference(frames, base, mult, add, out_size=out_size, use_diff=use_diff)
    torch.cuda.synchronize()
    assert fused_preprocess_dual.launches == before + 1
    assert got.shape == (2 * n, 3, *out_size)
    if coeffs == "uniform":
        assert (got - want).abs().max().item() < 1e-5
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_empty_batch_launches_nothing():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    before = fused_preprocess_dual.launches
    out = fused_preprocess_dual(
        torch.zeros((0, 6, 32, 43), device="cuda"), torch.zeros((6, 32, 43), device="cuda"),
        MULT, ADD, out_size=(16, 21),
    )
    assert out.shape == (0, 3, 16, 21) and fused_preprocess_dual.launches == before
