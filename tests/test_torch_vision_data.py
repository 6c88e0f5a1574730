"""The port's vision data and LeNet vs the JAX package's.

- Every dataset's synthetic fallback (no local files, ``download=True``)
  is the reference's bit for bit: MNIST/FashionMNIST (train, test),
  Cifar10/100, SyntheticImageNet, Flowers and VOC2012, arrays and items;
  and ``io.SyntheticImageDataset``'s augmented items.
- Local files parse the same: MNIST idx.gz, a CIFAR tarball, a
  ``root/class/x.png`` tree (``DatasetFolder``, ``ImageFolder``,
  ``image_load``).
- Every transform, function and class, on HWC uint8 and float images,
  within 1e-6 of the reference; the random ones under one
  ``random.seed`` (both draw from Python's ``random``).
- LeNet: the reference's parameter names and shapes, and the forward
  within 1e-5 with the weights carried across by ``load_numpy_state``.
"""
import gzip
import io as _io
import os
import pickle
import random
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io.synthetic as rsyn
import paddle_tpu.vision.datasets as rds
import paddle_tpu.vision.transforms as rtf
import paddle_tpu_torch.io.synthetic as psyn
import paddle_tpu_torch.vision.datasets as pds
import paddle_tpu_torch.vision.transforms as ptf
from paddle_tpu.vision.models import LeNet as JaxLeNet
from paddle_tpu_torch.nlp.convert import load_numpy_state
from paddle_tpu_torch.vision.models import LeNet
from torch_threads import one_torch_thread  # noqa: F401


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _same_items(p, r, idx):
    for i in idx:
        pi, ri = p[i], r[i]
        pi = pi if isinstance(pi, (tuple, list)) else [pi]
        ri = ri if isinstance(ri, (tuple, list)) else [ri]
        assert len(pi) == len(ri)
        for a, b in zip(pi, ri):
            _same(a, b)


SYNTHETIC = {
    "mnist_train": lambda m: m.MNIST(mode="train"),
    "mnist_test": lambda m: m.MNIST(mode="test", download=True),
    "fashion_mnist": lambda m: m.FashionMNIST(mode="train"),
    "cifar10_train": lambda m: m.Cifar10(mode="train"),
    "cifar10_test": lambda m: m.Cifar10(mode="test"),
    "cifar100": lambda m: m.Cifar100(mode="train"),
    "imagenet": lambda m: m.SyntheticImageNet(n=70, image_size=32),
    "flowers_train": lambda m: m.Flowers(mode="train"),
    "flowers_test": lambda m: m.Flowers(mode="test", n=16, image_size=24),
    "voc2012": lambda m: m.VOC2012(mode="train"),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_datasets_bit_for_bit(name):
    p, r = SYNTHETIC[name](pds), SYNTHETIC[name](rds)
    assert len(p) == len(r)
    for attr in ("images", "labels", "_cache", "_synthetic"):
        if hasattr(r, attr):
            pa, ra = getattr(p, attr), getattr(r, attr)
            for a, b in (zip(pa, ra) if isinstance(ra, tuple)
                         else [(pa, ra)]):
                _same(a, b)
    _same_items(p, r, [0, 1, len(r) // 2, len(r) - 1])


def test_synthetic_image_dataset_items():
    p, r = psyn.SyntheticImageDataset(8, 40, 24), \
        rsyn.SyntheticImageDataset(8, 40, 24)
    assert len(p) == len(r) == 8
    _same_items(p, r, range(8))


def test_mnist_from_local_idx_files(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (12, 28, 28), dtype=np.uint8)
    labs = rng.integers(0, 10, 12).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lab.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 12, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, 12) + labs.tobytes())
    p = pds.MNIST(image_path=ip, label_path=lp, mode="train")
    r = rds.MNIST(image_path=ip, label_path=lp, mode="train")
    _same(p.images, imgs)
    _same(p.labels, r.labels)
    _same_items(p, r, range(12))


def test_cifar_from_a_local_tarball(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "cifar.tar.gz")
    with tarfile.open(path, "w:gz") as tf:
        for name in ("data_batch_1", "data_batch_2", "test_batch"):
            blob = pickle.dumps({
                b"data": rng.integers(0, 256, (5, 3072), dtype=np.uint8),
                b"labels": rng.integers(0, 10, 5).tolist()})
            info = tarfile.TarInfo(f"cifar-10-batches-py/{name}")
            info.size = len(blob)
            tf.addfile(info, _io.BytesIO(blob))
    for mode in ("train", "test"):
        p = pds.Cifar10(data_file=path, mode=mode)
        r = rds.Cifar10(data_file=path, mode=mode)
        assert len(p) == len(r) == (10 if mode == "train" else 5)
        _same(p.images, r.images)
        _same_items(p, r, range(len(r)))


def test_folder_datasets(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(2)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls / "sub")
        for i in range(3):
            arr = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
            where = tmp_path / cls / ("sub" if i == 2 else "") / f"{i}.png"
            Image.fromarray(arr).save(where)
        (tmp_path / cls / "notes.txt").write_text("not an image")
    tf = ptf.Compose([ptf.ToTensor()])
    rtfc = rtf.Compose([rtf.ToTensor()])
    p = pds.DatasetFolder(str(tmp_path), transform=tf)
    r = rds.DatasetFolder(str(tmp_path), transform=rtfc)
    assert p.classes == r.classes == ["cat", "dog"]
    assert p.samples == r.samples and len(p) == 6
    _same_items(p, r, range(6))
    pf = pds.ImageFolder(str(tmp_path))
    rf = rds.ImageFolder(str(tmp_path))
    assert pf.samples == rf.samples
    _same_items(pf, rf, range(len(rf)))
    _same(pds.image_load(p.samples[0][0]), rds.image_load(r.samples[0][0]))
    with pytest.raises(ValueError, match="exactly one"):
        pds.DatasetFolder(str(tmp_path), extensions=(".png",),
                          is_valid_file=lambda x: True)


def _img(dtype, seed=0, shape=(17, 23, 3)):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape).astype(np.float32)


# (name, factory over a transforms module) -> a callable on an HWC image
TRANSFORMS = {
    "to_tensor": lambda t: t.to_tensor,
    "to_tensor_hwc": lambda t: lambda x: t.to_tensor(x, "HWC"),
    "normalize_chw": lambda t: lambda x: t.normalize(
        t.to_tensor(x), [0.4, 0.5, 0.6], [0.2, 0.25, 0.3]),
    "normalize_hwc": lambda t: lambda x: t.normalize(
        x.astype(np.float32), [0.4, 0.5, 0.6], [0.2, 0.25, 0.3], "HWC"),
    "resize_int": lambda t: lambda x: t.resize(x, 11),
    "resize_pair": lambda t: lambda x: t.resize(x, (31, 9)),
    "resize_nearest": lambda t: lambda x: t.resize(x, (8, 40), "nearest"),
    "hflip": lambda t: t.hflip,
    "vflip": lambda t: t.vflip,
    "crop": lambda t: lambda x: t.crop(x, 2, 3, 9, 11),
    "center_crop": lambda t: lambda x: t.center_crop(x, (10, 12)),
    "pad_constant": lambda t: lambda x: t.pad(x, 3, fill=7),
    "pad_reflect": lambda t: lambda x: t.pad(x, (1, 2), padding_mode="reflect"),
    "pad_edge4": lambda t: lambda x: t.pad(x, (1, 2, 3, 4), padding_mode="edge"),
    "pad_symmetric": lambda t: lambda x: t.pad(x, 2,
                                               padding_mode="symmetric"),
    "adjust_brightness": lambda t: lambda x: t.adjust_brightness(x, 1.3),
    "adjust_contrast": lambda t: lambda x: t.adjust_contrast(x, 0.7),
    "adjust_hue": lambda t: lambda x: t.adjust_hue(x, 0.2),
    "to_grayscale": lambda t: lambda x: t.to_grayscale(x, 3),
    "erase": lambda t: lambda x: t.erase(x, 2, 3, 4, 5, 9),
    "affine": lambda t: lambda x: t.affine(x, 17.0, (2, -1), 1.1, (5.0, 3.0)),
    "affine_bilinear": lambda t: lambda x: t.affine(
        x, -30.0, (0, 0), 0.9, 4.0, interpolation="bilinear", fill=3),
    "perspective": lambda t: lambda x: t.perspective(
        x, [(0, 0), (22, 0), (22, 16), (0, 16)],
        [(2, 1), (20, 0), (21, 15), (1, 14)]),
    "rotate": lambda t: lambda x: t.rotate(x, 33.0),
    "rotate_expand_bilinear": lambda t: lambda x: t.rotate(
        x, -47.0, "bilinear", expand=True, fill=1),
    "Compose": lambda t: t.Compose([t.Resize((12, 14)), t.ToTensor(),
                                    t.Normalize(0.5, 0.25)]),
    "Transpose": lambda t: t.Transpose(),
    "CenterCrop": lambda t: t.CenterCrop(9),
    "Pad": lambda t: t.Pad(2, padding_mode="edge"),
    "Grayscale": lambda t: t.Grayscale(),
    "RandomHorizontalFlip": lambda t: t.RandomHorizontalFlip(0.5),
    "RandomVerticalFlip": lambda t: t.RandomVerticalFlip(0.5),
    "RandomCrop": lambda t: t.RandomCrop(10),
    "RandomCrop_padded": lambda t: t.RandomCrop((20, 30), padding=2,
                                                pad_if_needed=True),
    "RandomResizedCrop": lambda t: t.RandomResizedCrop(12),
    "BrightnessTransform": lambda t: t.BrightnessTransform(0.4),
    "ContrastTransform": lambda t: t.ContrastTransform(0.4),
    "SaturationTransform": lambda t: t.SaturationTransform(0.4),
    "HueTransform": lambda t: t.HueTransform(0.3),
    "ColorJitter": lambda t: t.ColorJitter(0.3, 0.3, 0.3, 0.1),
    "RandomRotation": lambda t: t.RandomRotation(40),
    "RandomErasing": lambda t: t.RandomErasing(prob=1.0),
    "RandomAffine": lambda t: t.RandomAffine(20, translate=(0.1, 0.2),
                                             scale=(0.8, 1.2),
                                             shear=(-5, 5, -3, 3)),
    "RandomPerspective": lambda t: t.RandomPerspective(prob=1.0),
}


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_match(name, dtype):
    x = _img(dtype)
    fp, fr = TRANSFORMS[name](ptf), TRANSFORMS[name](rtf)
    for draw in range(4):  # several draws of the random ones
        random.seed(100 + draw)
        np.random.seed(100 + draw)
        got = np.asarray(fp(x.copy()))
        random.seed(100 + draw)
        np.random.seed(100 + draw)
        want = np.asarray(fr(x.copy()))
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=0,
                                   atol=1e-6)


def test_to_pil_image():
    x = _img("uint8")
    p, r = ptf.ToPILImage()(x), rtf.ToPILImage()(x)
    _same(np.asarray(p), np.asarray(r))


def test_transforms_export_the_reference_names():
    assert set(rtf.__all__) <= set(dir(ptf))
    assert ptf.__all__ == rtf.__all__


def test_lenet_names_and_forward():
    paddle.seed(3)
    jm = JaxLeNet()
    state = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    pm = LeNet(device="cpu")
    assert [(n, tuple(p.shape)) for n, p in pm.named_parameters()] == \
        [(n, tuple(np.shape(state[n]))) for n in state]
    load_numpy_state(pm, state)
    x = np.random.default_rng(4).random((5, 1, 28, 28)).astype(np.float32)
    want = np.asarray(jm(paddle.to_tensor(x))._value)
    got = pm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert LeNet(num_classes=0, device="cpu")(
        torch.from_numpy(x)).shape == (5, 16, 5, 5)


def test_lenet_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        LeNet()
