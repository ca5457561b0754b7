"""DistillReader format demo: all three reference reader formats (port of
``edl_tpu.examples.reader_demo``).

The SAME data source expressed as a sample generator, a sample-list
generator, and a batch generator, each wrapped by DistillReader and
checked to come back in its ORIGINAL structure with the teacher's
prediction slot appended.

By default spins an in-process teacher (a fixed numpy projection) over a
real TCP socket; pass ``--teachers h:p,...`` to use external
teacher_server processes instead.

Run:  python -m edl_tpu_torch.examples.reader_demo [--format all]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.teacher_server import TeacherServer
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.reader_demo")

BATCH_NUM = 10
BATCH_SIZE = 16
IMG_SHAPE = (1, 28, 28)
NUM_CLASSES = 10


def get_random_images_and_labels(rng):
    image = rng.random(size=IMG_SHAPE).astype(np.float32)
    label = rng.integers(0, NUM_CLASSES, size=(1,)).astype(np.int64)
    return image, label


def sample_generator_creator():
    """Yields ONE (image, label) sample per iteration."""
    def __reader__():
        rng = np.random.default_rng(0)
        for _ in range(BATCH_NUM * BATCH_SIZE):
            yield get_random_images_and_labels(rng)

    return __reader__


def sample_list_generator_creator():
    """Yields a LIST of BATCH_SIZE samples per iteration."""
    def __reader__():
        rng = np.random.default_rng(0)
        for _ in range(BATCH_NUM):
            yield [get_random_images_and_labels(rng)
                   for _ in range(BATCH_SIZE)]

    return __reader__


def batch_generator_creator():
    """Yields stacked (images, labels) arrays per iteration."""
    def __reader__():
        rng = np.random.default_rng(0)
        for _ in range(BATCH_NUM):
            images = rng.random(
                size=(BATCH_SIZE,) + IMG_SHAPE).astype(np.float32)
            labels = rng.integers(
                0, NUM_CLASSES, size=(BATCH_SIZE, 1)).astype(np.int64)
            yield images, labels

    return __reader__


def make_teacher_predict(seed: int = 42):
    """Deterministic linear 'teacher': logits from a fixed projection. A
    TeacherServer predict returns the fetch callable."""
    w = np.random.default_rng(seed).normal(
        size=(int(np.prod(IMG_SHAPE)), NUM_CLASSES)).astype(np.float32)

    def predict(feeds):
        images = feeds["img"].reshape(feeds["img"].shape[0], -1)
        out = {"fc_0.tmp_2": images @ w}
        return lambda: out

    return predict


def make_reader(teachers, fmt: str) -> DistillReader:
    dr = DistillReader(ins=["img", None], predicts=["fc_0.tmp_2"],
                       teacher_batch_size=BATCH_SIZE)
    dr.set_fixed_teacher(teachers)
    if fmt == "sample_generator":
        dr.set_sample_generator(sample_generator_creator())
    elif fmt == "sample_list_generator":
        dr.set_sample_list_generator(sample_list_generator_creator())
    elif fmt == "batch_generator":
        dr.set_batch_generator(batch_generator_creator())
    else:
        raise ValueError(f"unsupported data format {fmt!r}")
    return dr


def run_format(teachers, fmt: str) -> None:
    train_reader = make_reader(teachers, fmt)
    if fmt == "sample_generator":
        step = 0
        for img, label, prediction in train_reader():
            assert img.shape == IMG_SHAPE
            assert label.shape == (1,)
            assert prediction.shape == (NUM_CLASSES,)
            step += 1
        assert step == BATCH_NUM * BATCH_SIZE
        log.info("sample_generator: %d samples, last prediction[:3]=%s",
                 step, prediction[:3])
    elif fmt == "sample_list_generator":
        n = 0
        for sample_list in train_reader():
            assert len(sample_list) == BATCH_SIZE
            for img, label, prediction in sample_list:
                assert img.shape == IMG_SHAPE
                assert label.shape == (1,)
                assert prediction.shape == (NUM_CLASSES,)
            n += 1
        assert n == BATCH_NUM
        log.info("sample_list_generator: %d lists of %d", n, BATCH_SIZE)
    else:
        n = 0
        for img, label, prediction in train_reader():
            assert img.shape == (BATCH_SIZE,) + IMG_SHAPE
            assert label.shape == (BATCH_SIZE, 1)
            assert prediction.shape == (BATCH_SIZE, NUM_CLASSES)
            n += 1
        assert n == BATCH_NUM
        log.info("batch_generator: %d batches of %d", n, BATCH_SIZE)
    train_reader.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.examples.reader_demo")
    parser.add_argument("--teachers", default="",
                        help="external teacher endpoints h:p,... "
                             "(default: in-process teacher)")
    parser.add_argument("--format", default="all",
                        choices=("all", "sample_generator",
                                 "sample_list_generator",
                                 "batch_generator"))
    args = parser.parse_args(argv)

    server = None
    if args.teachers:
        teachers = args.teachers
    else:
        server = TeacherServer(make_teacher_predict(),
                               host="127.0.0.1").start()
        teachers = f"127.0.0.1:{server.port}"
    formats = (("sample_generator", "sample_list_generator",
                "batch_generator") if args.format == "all"
               else (args.format,))
    try:
        for fmt in formats:
            run_format(teachers, fmt)
    finally:
        if server is not None:
            server.stop()
    print(f"ok formats={','.join(formats)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
