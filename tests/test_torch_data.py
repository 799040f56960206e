"""The port's data path against the JAX package's on the same inputs: the
Gaussian blur, `.pt` IO in both directions, the synthetic fixtures,
``bake_dataset`` (blur, subsetting, the extra directory, bf16 storage,
the statistics hook) and ``BatchIterator``'s permutations.

The bake is numpy on the host in both packages, so its arrays and
statistics agree bit for bit; the blur op runs float32 contractions in
another order (1e-6, the bar of tests/test_ops.py).
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelslim_depth_tpu.data import dataset as jax_dataset
from gelslim_depth_tpu.data import pt_io as jax_pt_io
from gelslim_depth_tpu.data import synthetic as jax_synthetic
from gelslim_depth_tpu.ops import image as jax_image
from gelslim_depth_tpu_torch import ops
from gelslim_depth_tpu_torch.data import BatchIterator, GeneralDataset, bake_dataset, load_pt, save_pt
from gelslim_depth_tpu_torch.data import synthetic
from tests.torch_port_helpers import torch_threads

BAKE = dict(use_difference_image=True, image_normalization_method="mean_std",
            depth_normalization_method="min_max_to_0_-1", norm_scale=0.9, downsample_factor=0.5)



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield

def _objects(seed, n_objects=2, n=5, size=(32, 43)):
    rng = np.random.RandomState(seed)
    return [synthetic.make_synthetic_object(rng, n=n, image_size=size) for _ in range(n_objects)]


def _assert_baked_equal(got, want, bf16=False):
    want_img = np.asarray(want.tactile_image)
    if bf16:
        assert got.tactile_image.dtype == torch.bfloat16 and want_img.dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(got.tactile_image.float().numpy(), want_img.astype(np.float32))
    else:
        np.testing.assert_array_equal(got.tactile_image.numpy(), want_img)
    np.testing.assert_array_equal(got.depth_image.numpy(), np.asarray(want.depth_image))
    np.testing.assert_array_equal(got.object_index.numpy(), np.asarray(want.object_index))
    assert got.object_index.dtype == torch.int32
    assert got.depth_normalization_parameters == want.depth_normalization_parameters
    assert got.image_normalization_parameters == want.image_normalization_parameters
    assert got.input_tactile_image_size == want.input_tactile_image_size


@pytest.mark.parametrize("k", [1, 3, 5])
def test_gaussian_blur_matches_jax(k):
    x = np.random.RandomState(k).uniform(-2, 0, (2, 1, 17, 23)).astype(np.float32)
    got = ops.blur_depth_images(torch.from_numpy(x), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_image.blur_depth_images(jnp.asarray(x), k)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ops.image._gaussian_kernel_1d(k), jax_image._gaussian_kernel_1d(k))
    with pytest.raises(ValueError):
        ops.gaussian_blur(torch.from_numpy(x), 4)


def test_synthetic_objects_match_jax():
    got, want = _objects(3, 1)[0], jax_synthetic.make_synthetic_object(np.random.RandomState(3), n=5,
                                                                       image_size=(32, 43))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("blur,subset,extra,bf16,diff", [
    (1, None, False, False, True),
    (3, 3, True, True, True),
    (5, 4, False, False, False),
])
def test_bake_matches_jax(blur, subset, extra, bf16, diff):
    objs, extra_objs = _objects(4), (_objects(5, 1) if extra else None)
    kw = dict(BAKE, use_difference_image=diff, depth_image_blur_kernel=blur, max_datapoints_per_object=subset,
              seed=7, extra_preloaded=extra_objs)
    got = bake_dataset(preloaded=objs, device="cpu", image_store_dtype=torch.bfloat16 if bf16 else None, **kw)
    want = jax_dataset.bake_dataset(preloaded=objs, image_store_dtype=jnp.bfloat16 if bf16 else None, **kw)
    _assert_baked_equal(got, want, bf16)
    # val/test take the train split's statistics
    frozen = dict(depth_normalization_parameters=got.depth_normalization_parameters,
                  image_normalization_parameters=got.image_normalization_parameters)
    val = _objects(6, 1)
    _assert_baked_equal(bake_dataset(preloaded=val, device="cpu", **BAKE, **frozen),
                        jax_dataset.bake_dataset(preloaded=val, **BAKE, **frozen))


def test_bake_from_a_directory_tree_matches_jax(tmp_path):
    """Files written by the port's write_synthetic_dataset_tree hold the JAX
    writer's arrays; both bakes of them, with the real_data extra
    directory, agree, and the facade exposes the reference attributes."""
    synthetic.write_synthetic_dataset_tree(str(tmp_path / "p"), n_per_object=3, image_size=(24, 31))
    jax_synthetic.write_synthetic_dataset_tree(str(tmp_path / "j"), n_per_object=3, image_size=(24, 31))
    for sub, name in (("train_data", "peg1_train.pt"), ("real_data", "button.pt")):
        a, b = load_pt(str(tmp_path / "p" / sub / name)), jax_pt_io.load_pt(str(tmp_path / "j" / sub / name))
        for key in b:
            np.testing.assert_array_equal(a[key].numpy(), b[key])
    root = str(tmp_path / "p")
    files = ["pattern_31_rod_train.pt", "peg1_train.pt"]
    args = (os.path.join(root, "train_data"), files, os.path.join(root, "real_data"), ["button.pt"])
    got = bake_dataset(*args, device="cpu", **BAKE)
    want = jax_dataset.bake_dataset(*args, **BAKE)
    _assert_baked_equal(got, want)
    assert got.object_index.tolist() == [0] * 6 + [1] * 6 + [0] * 6  # the extra directory restarts at 0
    facade = GeneralDataset(*args, device="cpu", **BAKE)
    assert len(facade) == 18 and facade.input_tactile_image_size == (12, 15)
    assert facade.depth_normalization_parameters == want.depth_normalization_parameters
    item = facade[4]
    np.testing.assert_array_equal(item["tactile_image"], np.asarray(want.tactile_image[4]))
    assert item["depth_image"].shape == (1, 12, 15) and int(item["object_index"]) == 0
    with pytest.raises(FileNotFoundError):
        bake_dataset(str(tmp_path / "missing"), files, device="cpu")


def test_depth_images_alias_and_stats_hook():
    objs = _objects(8, 1)
    aliased = [{("depth_images" if k == "depth_image" else k): v for k, v in o.items()} for o in objs]
    calls = []

    def reduce(tactile, depth):
        calls.append((tactile.shape, depth.shape))
        return (-2.0, 0.0, -1.0, 0.5), ([0.0] * 3, [255.0] * 3, [100.0] * 3, [20.0] * 3)

    got = bake_dataset(preloaded=aliased, device="cpu", stats_reduce=reduce, **BAKE)
    want = jax_dataset.bake_dataset(preloaded=objs, stats_reduce=reduce, **BAKE)
    _assert_baked_equal(got, want)
    assert calls == [((10, 3, 16, 21), (10, 1, 16, 21))] * 2


def test_bake_refuses_what_is_not_ported():
    """NHWC and the 'bilinear' and 'nearest' bakes are ported
    (tests/test_torch_nhwc.py, tests/test_torch_resize.py); a resize kernel
    of jax.image.resize beyond those is not."""
    objs = _objects(9, 1)
    with pytest.raises(ValueError, match="interp_method"):
        bake_dataset(preloaded=objs, device="cpu", interp_method="lanczos3")


def test_batch_iterator_matches_jax():
    objs = _objects(10, 3)
    got_ds = bake_dataset(preloaded=objs, device="cpu", **BAKE)
    want_ds = jax_dataset.bake_dataset(preloaded=objs, **BAKE)
    it, jit_ = BatchIterator(got_ds, 4, seed=1000), jax_dataset.BatchIterator(want_ds, 4, seed=1000)
    assert len(it) == len(jit_) == 8  # 30 samples
    for (gi, gd, go), (wi, wd, wo) in zip(it.epoch(), jit_.epoch(), strict=True):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    for pad in (None, 3):  # the next epoch's permutation, and a device-count multiple
        (gp, gm), (wp, wm) = it.padded_epoch_indices(pad), jit_.padded_epoch_indices(pad)
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gm, wm)
    for (gi, gd, gm), (wi, wd, wm) in zip(it.padded_epoch(), jit_.padded_epoch(), strict=True):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    fixed = [img for img, _, _ in BatchIterator(got_ds, 7, shuffle=False).epoch()]
    assert [len(b) for b in fixed] == [7, 7, 7, 7, 2]
    assert torch.equal(torch.cat(fixed), got_ds.tactile_image)


def test_pt_io_reads_both_jax_writers_and_jax_reads_the_port(tmp_path):
    rng = np.random.RandomState(11)
    arrays = {"f": rng.randn(2, 3, 4).astype(np.float32), "i": np.arange(5, dtype=np.int64),
              "u": rng.randint(0, 255, (3, 2)).astype(np.uint8)}
    bf = rng.randn(3, 4).astype(ml_dtypes.bfloat16)
    jax_pt_io._save_pt_torchfree({**arrays, "b": bf}, str(tmp_path / "torchfree.pt"))
    jax_pt_io.save_pt({**arrays, "b": bf}, str(tmp_path / "torch.pt"))
    for name in ("torchfree.pt", "torch.pt"):
        got = load_pt(str(tmp_path / name))
        for key, v in arrays.items():
            assert got[key].dtype == torch.from_numpy(v).dtype
            np.testing.assert_array_equal(got[key].numpy(), v)
        assert got["b"].dtype == torch.bfloat16
        np.testing.assert_array_equal(got["b"].float().numpy(), bf.astype(np.float32))
    save_pt({**arrays, "b": torch.from_numpy(bf.astype(np.float32)).bfloat16()}, str(tmp_path / "port.pt"))
    back = jax_pt_io.load_pt(str(tmp_path / "port.pt"), native=False)
    for key, v in arrays.items():
        np.testing.assert_array_equal(back[key], v)
    assert back["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["b"].astype(np.float32), bf.astype(np.float32))
    # a bf16 dataset file bakes as its float32 values do
    obj = _objects(12, 1)[0]
    save_pt({k: torch.from_numpy(v).bfloat16() if v.ndim == 4 else v for k, v in obj.items()},
            str(tmp_path / "obj.pt"))
    got = bake_dataset(str(tmp_path), ["obj.pt"], device="cpu", **BAKE)
    as_f32 = {k: torch.from_numpy(v).bfloat16().float().numpy() if v.ndim == 4 else v for k, v in obj.items()}
    _assert_baked_equal(got, jax_dataset.bake_dataset(preloaded=[as_f32], **BAKE))
