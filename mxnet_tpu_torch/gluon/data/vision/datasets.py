"""Vision datasets from local files.

Counterpart of ``mxnet_tpu/gluon/data/vision/datasets.py``: MNIST and
FashionMNIST (idx files, optionally gzipped), CIFAR10 and CIFAR100 (the
python pickles), ImageRecordDataset and ImageFolderDataset. Nothing is
downloaded: a missing file raises ``FileNotFoundError``.
"""
from __future__ import annotations

import os
import pickle

import numpy as _np

from .... import ndarray as nd
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset"]


class _LocalDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_LocalDataset):
    """``(28, 28, 1)`` uint8 images and int32 labels from the idx files
    under ``root``."""

    _train_files = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
    _test_files = ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        from ....io.io import _read_mnist_images, _read_mnist_labels

        img_name, lbl_name = self._train_files if self._train \
            else self._test_files
        for ext in ("", ".gz"):
            img_path = os.path.join(self._root, img_name + ext)
            if os.path.exists(img_path):
                break
        else:
            raise FileNotFoundError(
                f"MNIST files not found under {self._root}: place "
                f"{img_name}[.gz] there (nothing is downloaded)")
        images = _read_mnist_images(img_path)
        labels = _read_mnist_labels(os.path.join(self._root, lbl_name + ext))
        self._data = nd.array(images[..., None], dtype=_np.uint8)
        self._label = labels.astype(_np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_LocalDataset):
    """``(32, 32, 3)`` uint8 images and int32 labels from the pickled
    batches under ``root`` (or its ``cifar-10-batches-py``)."""

    _batch_files_train = [f"data_batch_{i}" for i in range(1, 6)]
    _batch_files_test = ["test_batch"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _unpickle(self, path):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        if b"labels" in d:
            labels = d[b"labels"]
        else:
            key = b"fine_labels" if getattr(self, "_fine", True) \
                else b"coarse_labels"
            labels = d[key]
        return d[b"data"], _np.asarray(labels)

    def _get_data(self):
        files = self._batch_files_train if self._train \
            else self._batch_files_test
        roots = [self._root, os.path.join(self._root, "cifar-10-batches-py")]
        base = next((r for r in roots
                     if os.path.exists(os.path.join(r, files[0]))), None)
        if base is None:
            raise FileNotFoundError(
                f"CIFAR batches not found under {self._root} (nothing is "
                "downloaded)")
        data, labels = [], []
        for fname in files:
            d, lb = self._unpickle(os.path.join(base, fname))
            data.append(d)
            labels.append(lb)
        data = _np.concatenate(data).reshape(-1, 3, 32, 32)
        self._data = nd.array(data.transpose(0, 2, 3, 1), dtype=_np.uint8)
        self._label = _np.concatenate(labels).astype(_np.int32)


class CIFAR100(CIFAR10):
    _batch_files_train = ["train"]
    _batch_files_test = ["test"]

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=True, train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)


class ImageRecordDataset(RecordFileDataset):
    """``(image, label)`` from a RecordIO file of packed images (RGB;
    ``flag=0``: one gray channel)."""

    def __init__(self, filename, flag=1, transform=None):
        super().__init__(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        from .... import image, recordio

        header, img_bytes = recordio.unpack(super().__getitem__(idx))
        img = image.imdecode(img_bytes, self._flag)
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """``root/<class name>/<image>``: labels numbered by the sorted class
    folders; ``.jpg``, ``.jpeg``, ``.png`` and ``.npy`` files."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".npy"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image

        path, label = self.items[idx]
        if path.endswith(".npy"):
            img = nd.array(_np.load(path))
        else:
            with open(path, "rb") as f:
                img = image.imdecode(f.read(), self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
