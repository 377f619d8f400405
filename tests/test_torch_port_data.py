"""The port's data pipeline against the JAX package's, on the CPU: the disk
datasets (written in the reference layouts by scripts/make_disk_datasets.py
at 96x128), the procedural one, the EXR reader and writer, and the loader's
batches and order. The samples must be equal, key for key."""

import os.path as osp
import sys

import numpy as np
import pytest
import torch

from implicit_depth_torch.config import load_config
from implicit_depth_torch.data import datasets as port_ds
from implicit_depth_torch.data.exr import read_exr, write_exr
from implicit_depth_torch.data.loader import DataLoader
from implicit_depth_tpu.config import load_config as jax_load_config
from implicit_depth_tpu.data import datasets as jax_ds
from implicit_depth_tpu.data.exr import read_exr as jax_read_exr
from implicit_depth_tpu.data.exr import write_exr as jax_write_exr
from implicit_depth_tpu.data.loader import DataLoader as JaxDataLoader

sys.path.insert(0, osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                            "scripts"))

torch.set_num_threads(2)
H_SRC, W_SRC = 96, 128


@pytest.fixture(scope="module")
def disk_root(tmp_path_factory):
    from make_disk_datasets import (
        write_cleargrasp_real,
        write_cleargrasp_syn,
        write_omniverse,
    )
    root = str(tmp_path_factory.mktemp("port_datasets_disk"))
    rng = np.random.default_rng(0)
    cg = osp.join(root, "cleargrasp")
    hw = (H_SRC, W_SRC)
    write_cleargrasp_syn(osp.join(cg, "cleargrasp-dataset-train"), 4, rng, hw)
    write_cleargrasp_syn(osp.join(cg, "cleargrasp-dataset-test-val",
                                  "synthetic-val"), 2, rng, hw)
    write_cleargrasp_syn(osp.join(cg, "cleargrasp-dataset-test-val",
                                  "synthetic-test"), 2, rng, hw)
    write_cleargrasp_real(osp.join(cg, "cleargrasp-dataset-test-val",
                                   "real-val"), 2, rng, hw, "d415")
    write_cleargrasp_real(osp.join(cg, "cleargrasp-dataset-test-val",
                                   "real-test"), 2, rng, hw, "d435")
    write_omniverse(osp.join(root, "omniverse", "train"), 4, rng, hw)
    write_omniverse(osp.join(root, "omniverse", "small_test"), 2, rng, hw)
    return root


def dataset_overrides(disk_root, kind, **extra):
    return {"dataset": {
        "type": kind,
        "cleargrasp_root_dir": osp.join(disk_root, "cleargrasp"),
        "omniverse_root_dir": osp.join(disk_root, "omniverse"),
        "img_width": 64, "img_height": 48,
        "use_data_augmentation": True, "depth_aug": True,
        "corrupt_table": True, "synthetic_len": 6, **extra}}


# The GP depth noise of augmented train samples is a float32 INTER_CUBIC
# resize, which this OpenCV build hands to Intel IPP: the port's twin gives
# OpenCV's own bits (IPP off, tests/test_torch_port_codecs.py) and lies
# within 6e-9 of IPP's field (largest difference measured there, 5.6e-9). Added to
# xyz, that moves xyz_corrupt by at most one float32 ulp of the value plus
# the field's difference; every other field stays exact.
CUBIC_RTOL, CUBIC_ATOL = 2.0 ** -23, 1e-8


def assert_samples_equal(got, want, near=()):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, str):
            assert got[k] == v, k
        else:
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
            if k in near:
                np.testing.assert_allclose(got[k], v, rtol=CUBIC_RTOL,
                                           atol=CUBIC_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)


# (dataset type, exp_type, obj_type, extra dataset settings)
CASES = [
    ("cleargrasp_synthetic", "train", "known", {}),
    ("cleargrasp_synthetic", "train", "known", {"corrupt_table": False,
                                                "corrupt_all_pix": True}),
    ("cleargrasp_synthetic", "valid", "known", {}),
    ("cleargrasp_synthetic", "valid", "novel", {}),
    ("cleargrasp_real", "valid", "known", {}),
    ("cleargrasp_real", "test", "novel", {}),
    ("omniverse", "train", "known", {}),
    ("omniverse", "train", "known", {"omni_corrupt_all": False}),
    ("omniverse", "valid", "known", {}),
    ("omniverse", "test", "known", {}),
    ("mixed", "train", "known", {}),
    ("synthetic", "train", "known", {}),
    ("synthetic", "valid", "known", {}),
    ("cleargrasp_synthetic", "valid", "known", {"provide_pred_mask": True}),
]


@pytest.mark.parametrize("kind,exp_type,obj_type,extra", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{i}"
                              for i, c in enumerate(CASES)])
def test_get_dataset_samples_equal_jax(disk_root, kind, exp_type, obj_type,
                                       extra):
    ov = dataset_overrides(disk_root, kind, **extra)
    ds = port_ds.get_dataset(load_config(overrides=ov).dataset, exp_type,
                             obj_type, base_seed=3)
    jds = jax_ds.get_dataset(jax_load_config(overrides=ov).dataset, exp_type,
                             obj_type, base_seed=3)
    assert type(ds).__name__ == type(jds).__name__
    assert len(ds) == len(jds) > 0
    near = {"xyz_corrupt"} if exp_type == "train" and kind != "synthetic" \
        else ()
    for idx in sorted({0, len(ds) - 1}):
        for epoch in (0, 2):
            assert_samples_equal(ds.__getitem__(idx, epoch),
                                 jds.__getitem__(idx, epoch), near)


def test_pred_mask_dir_samples_equal_jax(disk_root, tmp_path):
    """PredMaskDataset reading an external mask PNG (nearest-resized)."""
    from implicit_depth_tpu.data.seg_io import imwrite_indexed
    ov = dataset_overrides(disk_root, "cleargrasp_synthetic",
                           pred_mask_dir=str(tmp_path))
    ds = port_ds.get_dataset(load_config(overrides=ov).dataset, "valid")
    jds = jax_ds.get_dataset(jax_load_config(overrides=ov).dataset, "valid")
    name = osp.splitext(ds[0]["item_path"].replace("/", "_"))[0]
    mask = (np.random.default_rng(1).random((H_SRC, W_SRC)) > 0.5) * 255
    imwrite_indexed(str(tmp_path / f"{name}.png"), mask)
    assert not np.array_equal(ds[0]["pred_mask"], ds[0]["corrupt_mask"])
    for idx in range(len(ds)):
        assert_samples_equal(ds[idx], jds[idx])


@pytest.mark.parametrize("compression", [0, 2, 3])
def test_exr_round_trip_equals_jax(tmp_path, compression):
    rng = np.random.default_rng(compression)
    chans = {"R": rng.random((37, 53)).astype(np.float32),
             "G": (rng.random((37, 53)) * 100).astype(np.float32)}
    port_path, jax_path = str(tmp_path / "p.exr"), str(tmp_path / "j.exr")
    write_exr(port_path, chans, compression=compression)
    jax_write_exr(jax_path, chans, compression=compression)
    assert open(port_path, "rb").read() == open(jax_path, "rb").read()
    for path in (port_path, jax_path):
        got, want = read_exr(path), jax_read_exr(path)
        assert set(got) == set(want) == set(chans)
        for k in chans:
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], chans[k])


def test_exr_reads_the_disk_depth_as_jax(disk_root):
    from glob import glob
    path = sorted(glob(osp.join(disk_root, "**", "*.exr"), recursive=True))[0]
    got, want = read_exr(path), jax_read_exr(path)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("worker_type", ["thread", "process"])
@pytest.mark.parametrize("host_id", [0, 1])
def test_loader_batches_equal_jax(worker_type, host_id):
    params = {"img_height": 24, "img_width": 32}
    ds = port_ds.SyntheticDataset(7, params, base_seed=5)
    jds = jax_ds.SyntheticDataset(7, params, base_seed=5)
    kw = dict(batch_size=2, shuffle=True, seed=11, num_workers=2,
              host_id=host_id, num_hosts=2, worker_type=worker_type)
    loader, jloader = DataLoader(ds, **kw), JaxDataLoader(jds, **kw)
    try:
        assert loader.steps_per_epoch() == jloader.steps_per_epoch() == 2
        for epoch in range(2):
            got, want = list(loader.epoch(epoch)), list(jloader.epoch(epoch))
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert_samples_equal(g, w)
    finally:
        loader.close()
        jloader.close()
