"""Vision datasets of the port (counterpart of
``paddle_tpu/vision/datasets.py``, ref: python/paddle/vision/datasets/*).

A copy of the reference, which never imported jax. Datasets parse local
files when present (MNIST idx / CIFAR pickle formats, identical parsers to
the reference) and otherwise fall back to a deterministic synthetic set
with the same shapes and dtypes, bit for bit the reference's. There is no
download: ``download=True`` without a local file takes the synthetic set.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "SyntheticImageNet"]


def _synthetic_images(n, shape, n_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n).astype(np.int64)
    # class-dependent means so models can actually learn
    imgs = (rng.rand(n, *shape) * 64 +
            labels[:, None, None].reshape(n, *([1] * len(shape))) *
            (192.0 / max(n_classes - 1, 1))).astype(np.uint8)
    return imgs, labels


class MNIST(Dataset):
    NUM_CLASSES = 10

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        images = labels = None
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), dtype=np.uint8
                                       ).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), dtype=np.uint8).astype(np.int64)
        if images is None:
            n = 6000 if mode == "train" else 1000
            images, labels = _synthetic_images(
                n, (28, 28), 10, seed=0 if mode == "train" else 1)
        self.images = images
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None] / 255.0
        return img, np.int64(label)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.transform = transform
        images = labels = None
        if data_file and os.path.exists(data_file):
            batches = ([f"data_batch_{i}" for i in range(1, 6)]
                       if mode == "train" else ["test_batch"])
            imgs, labs = [], []
            with tarfile.open(data_file) as tf:
                for m in tf.getmembers():
                    base = os.path.basename(m.name)
                    if base in batches:
                        d = pickle.load(tf.extractfile(m), encoding="bytes")
                        imgs.append(d[b"data"].reshape(-1, 3, 32, 32))
                        labs.extend(d.get(b"labels", d.get(b"fine_labels")))
            if imgs:
                images = np.concatenate(imgs).transpose(0, 2, 3, 1)
                labels = np.asarray(labs, dtype=np.int64)
        if images is None:
            n = 5000 if mode == "train" else 1000
            images, labels = _synthetic_images(
                n, (32, 32, 3), self.NUM_CLASSES,
                seed=2 if mode == "train" else 3)
        self.images = images
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.int64(label)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100


class SyntheticImageNet(Dataset):
    """Deterministic fake ImageNet for throughput benchmarking (the
    reference benchmarks use DALI/file pipelines; perf here is bounded by
    device compute, which is what bench.py measures)."""

    def __init__(self, n=1280, image_size=224, num_classes=1000,
                 transform=None, dtype=np.float32):
        rng = np.random.RandomState(42)
        self.labels = rng.randint(0, num_classes, size=n).astype(np.int64)
        self.n = n
        self.image_size = image_size
        self.transform = transform
        self.dtype = dtype
        self._cache = (rng.rand(64, 3, image_size, image_size) * 2 - 1).astype(dtype)

    def __getitem__(self, idx):
        img = self._cache[idx % len(self._cache)]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return self.n


# ---------------------------------------------------------------------
# Folder datasets (ref: python/paddle/vision/datasets/folder.py)
# ---------------------------------------------------------------------

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm",
                    ".tif", ".tiff", ".webp")


def image_load(path, backend=None):
    """Default image loader. backend=None/'numpy' returns an HWC uint8
    array (what this framework's numpy-based transforms consume);
    backend='pil' returns the PIL Image (reference default backend).
    ref: paddle.vision.image_load."""
    from PIL import Image
    with Image.open(path) as img:
        img = img.convert("RGB")
        if backend == "pil":
            img.load()
            return img
        return np.asarray(img, dtype=np.uint8)


def _has_valid_ext(path, extensions):
    return path.lower().endswith(tuple(e.lower() for e in extensions))


def _resolve_filter(extensions, is_valid_file):
    """One validity predicate from the (extensions, is_valid_file) pair;
    passing both is rejected like the reference does."""
    if extensions is not None and is_valid_file is not None:
        raise ValueError(
            "both 'extensions' and 'is_valid_file' were given — pass "
            "exactly one")
    if is_valid_file is not None:
        return is_valid_file, None
    if extensions is None:
        extensions = IMAGE_EXTENSIONS
    return (lambda p: _has_valid_ext(p, extensions)), extensions


def _iter_valid_files(directory, valid):
    for root, _, files in sorted(os.walk(directory, followlinks=True)):
        for fname in sorted(files):
            path = os.path.join(root, fname)
            if valid(path):
                yield path


def _make_samples(directory, class_to_idx, valid):
    samples = []
    for cls in sorted(class_to_idx):
        cdir = os.path.join(directory, cls)
        for path in _iter_valid_files(cdir, valid):
            samples.append((path, class_to_idx[cls]))
    return samples


class DatasetFolder(Dataset):
    """Generic `root/class_x/xxx.ext` directory-tree dataset
    (ref: paddle.vision.datasets.DatasetFolder — the workhorse for real
    image training directories).

    classes are the sorted sub-directory names of `root`; samples are
    (path, class_index) pairs; __getitem__ returns (image, label) with
    `transform` applied to the loaded image.
    """

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        super().__init__()
        self.root = root
        self.transform = transform
        self.loader = loader if loader is not None else image_load
        valid, self.extensions = _resolve_filter(extensions, is_valid_file)
        classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
        if not classes:
            raise RuntimeError(f"no class directories found under {root}")
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = _make_samples(root, self.class_to_idx, valid)
        if not self.samples:
            raise RuntimeError(
                f"found no valid files under {root}; supported "
                f"extensions: {self.extensions}")
        self.targets = [t for _, t in self.samples]

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(target)

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    """Unlabeled flat image set: every image under `root`, recursively
    (ref: paddle.vision.datasets.ImageFolder). __getitem__ returns
    [image] (a one-element list, matching the reference)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        super().__init__()
        self.root = root
        self.transform = transform
        self.loader = loader if loader is not None else image_load
        valid, extensions = _resolve_filter(extensions, is_valid_file)
        self.samples = list(_iter_valid_files(root, valid))
        if not self.samples:
            raise RuntimeError(
                f"found no valid files under {root}; supported "
                f"extensions: {extensions}")

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]

    def __len__(self):
        return len(self.samples)


__all__ += ["DatasetFolder", "ImageFolder", "image_load",
            "IMAGE_EXTENSIONS"]


class Flowers(Dataset):
    """Oxford 102 Flowers (ref: python/paddle/vision/datasets/flowers.py).

    data_file=(images_dir_or_tgz, labels_mat, setid_mat) parses the real
    release: jpg images, imagelabels.mat (1-based labels), setid.mat
    (trnid/valid/tstid index splits — mode train/valid/test). Without
    data_file: deterministic synthetic set with the same shapes."""

    NUM_CLASSES = 102
    _SPLIT_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 n=128, image_size=64, backend=None):
        self.transform = transform
        self.backend = backend
        if data_file is not None:
            import scipy.io
            images, labels_mat, setid_mat = data_file
            labels = scipy.io.loadmat(labels_mat)["labels"].ravel()
            setid = scipy.io.loadmat(setid_mat)
            ids = setid[self._SPLIT_KEY[mode]].ravel()
            self._images_root = images
            self._tar = None
            self._tar_index = None
            if os.path.isfile(images) and tarfile.is_tarfile(images):
                # the release tarball itself: index members by basename,
                # read lazily (lock: TarFile handles are not thread-safe
                # under DataLoader workers)
                import threading
                self._tar_lock = threading.Lock()
                self._tar = tarfile.open(images, "r:*")
                self._tar_index = {
                    os.path.basename(m.name): m
                    for m in self._tar.getmembers() if m.isfile()}
            # image_%05d.jpg, 1-based ids; labels 1-based -> 0-based
            self.samples = [(f"image_{i:05d}.jpg", int(labels[i - 1]) - 1)
                            for i in ids]
            self._synthetic = None
            return
        imgs, labels = _synthetic_images(
            n, (image_size, image_size, 3), self.NUM_CLASSES,
            7 if mode == "train" else 8)
        self._synthetic = (imgs, labels)
        self._tar = None
        self.samples = list(range(n))

    def __getitem__(self, idx):
        if self._synthetic is not None:
            img, label = (self._synthetic[0][idx],
                          self._synthetic[1][idx])
        else:
            fname, label = self.samples[idx]
            if self._tar is not None:
                import io as _io
                from PIL import Image
                with self._tar_lock:
                    data = self._tar.extractfile(
                        self._tar_index[fname]).read()
                with Image.open(_io.BytesIO(data)) as im:
                    im = im.convert("RGB")
                    if self.backend == "pil":
                        im.load()
                        img = im
                    else:
                        img = np.asarray(im, dtype=np.uint8)
            else:
                img = image_load(os.path.join(self._images_root, fname),
                                 backend=self.backend)
            label = np.int64(label)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.int64(label)

    def __len__(self):
        return len(self.samples)


class VOC2012(Dataset):
    """Pascal VOC 2012 segmentation (ref:
    python/paddle/vision/datasets/voc2012.py — (image, segmentation
    mask) pairs).

    data_file = the VOCdevkit/VOC2012 root (extracted): reads
    ImageSets/Segmentation/{train,val,trainval}.txt, JPEGImages/*.jpg
    and SegmentationClass/*.png. Without data_file: synthetic pairs."""

    _MODE_FILE = {"train": "train.txt", "valid": "val.txt",
                  "test": "val.txt", "trainval": "trainval.txt"}

    def __init__(self, data_file=None, mode="train", transform=None,
                 n=64, image_size=64, backend=None):
        self.transform = transform
        self.backend = backend
        if data_file is not None:
            root = data_file
            lst = os.path.join(root, "ImageSets", "Segmentation",
                               self._MODE_FILE[mode])
            with open(lst) as f:
                names = [l.strip() for l in f if l.strip()]
            if not names:
                raise ValueError(f"empty split list {lst}")
            self._root = root
            self.samples = names
            self._synthetic = None
            return
        rng = np.random.RandomState(9 if mode == "train" else 10)
        self._synthetic = (
            (rng.rand(n, image_size, image_size, 3) * 255).astype(np.uint8),
            rng.randint(0, 21, (n, image_size, image_size)).astype(np.uint8))
        self.samples = list(range(n))

    def __getitem__(self, idx):
        if self._synthetic is not None:
            img, mask = self._synthetic[0][idx], self._synthetic[1][idx]
        else:
            name = self.samples[idx]
            img = image_load(os.path.join(self._root, "JPEGImages",
                                          name + ".jpg"),
                             backend=self.backend)
            from PIL import Image
            with Image.open(os.path.join(self._root, "SegmentationClass",
                                         name + ".png")) as m:
                mask = np.asarray(m, dtype=np.uint8)   # palette indices
        if self.transform is not None:
            img = self.transform(img)
        return img, mask

    def __len__(self):
        return len(self.samples)


__all__ += ["Flowers", "VOC2012"]
