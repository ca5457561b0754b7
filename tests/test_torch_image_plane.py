"""The JPEG input plane (data/image.py) against the JAX package's, on the
same cv2.

decode/encode, the crops and resizes and the train/eval per-sample
transforms give the JAX package's pixels bit for bit from the same bytes
and generator state; ``make_synthetic_jpeg_dataset`` writes the same
files; the loader over a ``JpegFileListSource`` streams the JAX loader's
batches inline, with a decode thread pool and with worker processes;
``pack_jpeg_list`` writes the JAX package's packed file; and
``imagenet_train --data-format jpeg`` trains on the CPU. The port
imports cv2 only when a JPEG function runs.
"""

import ast
import os
from pathlib import Path

import numpy as np
import pytest

from edl_tpu.data import image as jimg
from edl_tpu.data import packed_records as jpr
from edl_tpu.data import pipeline as jpipe
from edl_tpu_torch.data import image as timg
from edl_tpu_torch.data import packed_records as tpr
from edl_tpu_torch.data import pipeline as tpipe
from edl_tpu_torch.examples import imagenet_train
from edl_tpu_torch.utils.exceptions import EdlDataError
from test_torch_mp_loader import assert_streams_equal, copy_stream
from test_torch_world import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpegs")
    list_file = timg.make_synthetic_jpeg_dataset(str(d), 16, classes=5,
                                                 hw=(40, 56), seed=7)
    return str(d), list_file


def test_synthetic_dataset_is_the_jax_package_s(jpeg_dir, tmp_path):
    root, _ = jpeg_dir
    jimg.make_synthetic_jpeg_dataset(str(tmp_path), 16, classes=5,
                                     hw=(40, 56), seed=7)
    assert sorted(os.listdir(root)) == sorted(os.listdir(tmp_path))
    for name in os.listdir(root):
        assert (Path(root) / name).read_bytes() == \
            (tmp_path / name).read_bytes()


def test_decode_encode_match(jpeg_dir):
    root, _ = jpeg_dir
    raw = (Path(root) / "img_000003.jpg").read_bytes()
    a, b = timg.decode_jpeg(raw), jimg.decode_jpeg(raw)
    assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert timg.encode_jpeg(a, 80) == jimg.encode_jpeg(a, 80)
    with pytest.raises(EdlDataError):
        timg.decode_jpeg(b"not a jpeg")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_crops_and_resizes_match(jpeg_dir, seed):
    root, _ = jpeg_dir
    img = timg.decode_jpeg((Path(root) / f"img_00000{seed}.jpg")
                           .read_bytes())
    for fn_t, fn_j, args in (
            (timg.random_resized_crop, jimg.random_resized_crop, (24,)),
            (timg.random_rotate, jimg.random_rotate, ()),
            (timg.random_flip_lr_sample, jimg.random_flip_lr_sample, ())):
        a = fn_t(img, np.random.default_rng(seed), *args)
        b = fn_j(img, np.random.default_rng(seed), *args)
        assert np.array_equal(a, b)
    assert np.array_equal(timg.center_crop(timg.resize_short(img, 30), 24),
                          jimg.center_crop(jimg.resize_short(img, 30), 24))


@pytest.mark.parametrize("rotate", [False, True])
def test_train_and_eval_transforms_match(jpeg_dir, rotate):
    root, _ = jpeg_dir
    sample = {"jpeg": (Path(root) / "img_000005.jpg").read_bytes(),
              "label": np.int32(2)}
    for t, j in ((timg.train_image_transform(20, rotate=rotate),
                  jimg.train_image_transform(20, rotate=rotate)),
                 (timg.eval_image_transform(20, short=24),
                  jimg.eval_image_transform(20, short=24))):
        a = t(dict(sample), np.random.default_rng(4))
        b = j(dict(sample), np.random.default_rng(4))
        assert set(a) == set(b) == {"image", "label"}
        assert np.array_equal(a["image"], b["image"])


@pytest.mark.parametrize("mode", [dict(decode_threads=0),
                                  dict(decode_threads=3),
                                  dict(num_workers=2)],
                         ids=["inline", "threads", "workers"])
def test_jpeg_loader_streams_match_jax(jpeg_dir, mode):
    root, list_file = jpeg_dir
    want = copy_stream(jpipe.DataLoader(
        jimg.JpegFileListSource(list_file, root=root), 4, seed=5,
        sample_transforms=(jimg.train_image_transform(16),),
        num_workers=0).epoch(2))
    with tpipe.DataLoader(timg.JpegFileListSource(list_file, root=root), 4,
                          seed=5,
                          sample_transforms=(timg.train_image_transform(16),),
                          **mode) as ld:
        got = copy_stream(ld.epoch(2))
    assert_streams_equal(want, got)


def test_file_list_contract(tmp_path):
    with pytest.raises(EdlDataError, match="exactly one"):
        timg.JpegFileListSource()
    (tmp_path / "empty.txt").write_text("\n")
    with pytest.raises(EdlDataError, match="empty"):
        timg.JpegFileListSource(str(tmp_path / "empty.txt"))
    src = timg.JpegFileListSource(entries=[("a.jpg", 3)], root=str(tmp_path))
    assert len(src) == 1
    with pytest.raises(EdlDataError, match="samples"):
        tpipe.DataLoader(src.entries, 1,
                         sample_transforms=(timg.eval_image_transform(8),))


def test_packed_jpeg_list_is_the_jax_package_s(jpeg_dir, tmp_path):
    root, list_file = jpeg_dir
    ours, theirs = str(tmp_path / "o.pack"), str(tmp_path / "t.pack")
    tpr.pack_jpeg_list(list_file, root, ours, size=16, batch_size=5)
    jpr.pack_jpeg_list(list_file, root, theirs, size=16, batch_size=5)
    assert Path(ours).read_bytes() == Path(theirs).read_bytes()


def test_cv2_is_imported_lazily():
    tree = ast.parse(Path(timg.__file__).read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any("cv2" in ast.unparse(n) for n in top)


def test_imagenet_train_on_the_jpeg_plane(tmp_path, capsys):
    rc = imagenet_train.main([
        "--data-dir", str(tmp_path), "--data-format", "jpeg",
        "--make-synthetic", "24", "--model", "ResNetTiny", "--image-size",
        "16", "--num-classes", "5", "--batch-size", "8", "--epochs", "1",
        "--decode-threads", "2", "--device", "cpu", "--fused-opt", "fp32"])
    assert rc == 0
    assert (tmp_path / "train.txt").exists()
    with pytest.raises(SystemExit, match="pack the list first"):
        imagenet_train.main([
            "--data-dir", str(tmp_path), "--data-format", "jpeg",
            "--augment-device", "1", "--device", "cpu"])
