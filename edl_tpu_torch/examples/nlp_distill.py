"""NLP distillation: big teacher -> BOW student over the distill plane
(port of ``edl_tpu.examples.nlp_distill``).

The reference's ERNIE->BOW pipeline end to end: the teacher is a CNN
text classifier fine-tuned in process (the ERNIE stand-in), served
through `TeacherServer` and consumed through `DistillReader`'s
exactly-once pipeline; the student is the BOW model distilling with
temperature-T KL and (optionally) hard-label CE. On the card unless
``--device cpu``.

Reported at the end, as the reference's README table: teacher acc,
student-alone acc (trained from scratch, no teacher), distilled student
acc (``teacher_acc= alone_acc= distill_acc=``).

Modes (as mnist_distill's):
  --all-in-one          in-process teacher, no external services;
  --teachers h:p,...    fixed endpoints (teacher_server CLI instances);
  --discovery h:p       dynamic discovery via the balancer daemon.

Data is synthetic sentiment (deterministic, no downloads): each sequence
is token ids whose label is decided by whether more ids fall in the
"positive" or the "negative" vocabulary band, plus neutral noise:
BOW-learnable, but noisy enough that the bigger teacher generalizes
better.

  python -m edl_tpu_torch.examples.nlp_distill --all-in-one --device cpu
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from edl_tpu_torch import resolve_device
from edl_tpu_torch.data.pipeline import ArraySource, DataLoader
from edl_tpu_torch.distill.reader import DistillReader
from edl_tpu_torch.distill.sharded_teacher import sharded_predict_fn
from edl_tpu_torch.distill.teacher_server import TeacherServer
from edl_tpu_torch.examples.mnist_distill import on_device
from edl_tpu_torch.models.bow import BOWClassifier, CNNClassifier
from edl_tpu_torch.train.classification import (accuracy_topk,
                                                create_state,
                                                make_distill_step,
                                                make_eval_step,
                                                smoothed_labels,
                                                soft_cross_entropy)
from edl_tpu_torch.train.state import adam
from edl_tpu_torch.train.step import make_train_step
from edl_tpu_torch.utils.logging import get_logger

log = get_logger("edl_tpu_torch.examples.nlp_distill")

VOCAB = 4000
SEQ_LEN = 64
NUM_CLASSES = 2
POS_BAND = (100, 400)   # ids voting positive
NEG_BAND = (400, 700)   # ids voting negative


def synthetic_sentiment(n: int, seed: int = 0, noise: float = 0.15):
    """(ids (n, SEQ_LEN) int32, label (n,) int32): band-vote labels."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, VOCAB, size=(n, SEQ_LEN)).astype(np.int32)
    # random pad tail (id 0) so masking matters
    lengths = rng.integers(SEQ_LEN // 2, SEQ_LEN + 1, size=n)
    for i, ln in enumerate(lengths):
        ids[i, ln:] = 0
    pos = ((ids >= POS_BAND[0]) & (ids < POS_BAND[1])).sum(axis=1)
    neg = ((ids >= NEG_BAND[0]) & (ids < NEG_BAND[1])).sum(axis=1)
    label = (pos + rng.normal(scale=noise * SEQ_LEN ** 0.5, size=n)
             > neg).astype(np.int32)
    return {"ids": ids, "label": label}


def _pure_ce_step():
    """CE-only step over {'ids', 'label'} batches (teacher-free fit)."""

    def loss_fn(model, batch):
        model.train()
        logits = model(batch["ids"])
        loss = soft_cross_entropy(
            logits, smoothed_labels(batch["label"], NUM_CLASSES))
        return loss, {"acc1": accuracy_topk(logits.detach(),
                                            batch["label"], 1)}

    return make_train_step(loss_fn)


def _fit(model, data, *, epochs: int, batch_size: int, lr: float,
         seed: int, device):
    """Plain supervised fit; returns the trained state."""
    state = create_state(model, adam(lr))
    loader = DataLoader(ArraySource(data), batch_size, seed=seed,
                        num_workers=0)
    step = _pure_ce_step()
    for epoch in range(epochs):
        for batch in loader.epoch(epoch):
            state, _ = step(state, on_device(batch, device))
    return state


def _acc(state, data, eval_step, device) -> float:
    return float(eval_step(state, on_device(data, device))["acc1"])


def train(args) -> int:
    device = resolve_device(args.device)
    train_data = synthetic_sentiment(args.samples, seed=args.seed)
    test_data = synthetic_sentiment(args.samples // 4, seed=args.seed + 1)
    eval_step = make_eval_step(input_key="ids")

    # -- teacher: "fine-tune the big model" (fine_tune.py analogue) --------
    server = None
    teachers = None
    if args.all_in_one:
        log.info("fine-tuning the teacher (CNN) in process...")
        # The teacher's edge is the ERNIE story: it was trained on much
        # more data than the labeled set the students get (the stand-in
        # for pretraining), so its soft labels carry signal the small
        # train set alone does not.
        teacher_model = CNNClassifier(vocab_size=VOCAB, embed_dim=128,
                                      num_classes=NUM_CLASSES,
                                      device=device, seed=args.seed)
        teacher_data = synthetic_sentiment(args.samples * 4,
                                           seed=args.seed + 7)
        tstate = _fit(teacher_model, teacher_data,
                      epochs=args.teacher_epochs,
                      batch_size=args.batch_size, lr=args.lr,
                      seed=args.seed, device=device)
        teacher_acc = _acc(tstate, test_data, eval_step, device)
        predict, _ = sharded_predict_fn(lambda m, x: m(x), teacher_model,
                                        device, input_key="ids",
                                        output_key="teacher_logits")
        server = TeacherServer(predict, host="127.0.0.1",
                               max_batch=args.teacher_batch_size * 4).start()
        teachers = [f"127.0.0.1:{server.port}"]
    else:
        teacher_acc = float("nan")
        if args.teachers:
            teachers = args.teachers.split(",")

    # -- student baseline: train-from-scratch BOW (train.py analogue) ------
    def student():
        return BOWClassifier(vocab_size=VOCAB, embed_dim=args.embed_dim,
                             num_classes=NUM_CLASSES, device=device,
                             seed=args.seed)

    alone = _fit(student(), train_data, epochs=args.epochs,
                 batch_size=args.batch_size, lr=args.lr, seed=args.seed,
                 device=device)
    alone_acc = _acc(alone, test_data, eval_step, device)

    # -- distilled student (distill.py analogue) ---------------------------
    # The student distills over the labeled set PLUS unlabeled text the
    # teacher soft-labels on the fly (--distill-extra; the transfer-set
    # trick: with hard_weight=0 those extra rows contribute teacher
    # signal only, their synthetic labels are never in the loss).
    if args.distill_extra:
        extra = synthetic_sentiment(args.distill_extra, seed=args.seed + 11)
        distill_data = {k: np.concatenate([train_data[k], extra[k]])
                        for k in train_data}
    else:
        distill_data = train_data
    loader = DataLoader(ArraySource(distill_data), args.batch_size,
                        seed=args.seed, num_workers=0)
    state = create_state(student(), adam(args.lr))
    step = make_distill_step(NUM_CLASSES, temperature=args.temperature,
                             hard_weight=args.hard_weight, input_key="ids")
    try:
        for epoch in range(args.epochs):
            dr = DistillReader(
                lambda e=epoch: loader.epoch(e), feeds=["ids"],
                predicts=["teacher_logits"], teachers=teachers,
                discovery=args.discovery or None, service=args.service,
                teacher_batch_size=args.teacher_batch_size)
            losses = []
            try:
                for batch in dr():
                    state, metrics = step(state, on_device(batch, device))
                    # a device scalar: reading it here would sync every
                    # step against the reader pipeline
                    losses.append(metrics["loss"])
            finally:
                dr.close()
            losses = [float(x) for x in losses]
            log.info("epoch %d distill loss=%.4f student_acc=%.3f", epoch,
                     float(np.mean(losses)),
                     _acc(state, test_data, eval_step, device))
        distilled_acc = _acc(state, test_data, eval_step, device)
        log.info("teacher=%.3f student_alone=%.3f student_distilled=%.3f",
                 teacher_acc, alone_acc, distilled_acc)
        print(f"teacher_acc={teacher_acc:.3f} alone_acc={alone_acc:.3f} "
              f"distill_acc={distilled_acc:.3f}")
        return 0
    finally:
        if server is not None:
            server.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="edl_tpu_torch.examples.nlp_distill")
    parser.add_argument("--all-in-one", action="store_true")
    parser.add_argument("--teachers", default="")
    parser.add_argument("--discovery", default="")
    parser.add_argument("--service", default="nlp_teacher")
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--teacher-epochs", type=int, default=4)
    parser.add_argument("--samples", type=int, default=4096)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--teacher-batch-size", type=int, default=32)
    parser.add_argument("--embed-dim", type=int, default=32)
    parser.add_argument("--distill-extra", type=int, default=None,
                        help="unlabeled rows the teacher soft-labels "
                             "(default 3x --samples)")
    parser.add_argument("--temperature", type=float, default=2.0)
    parser.add_argument("--hard-weight", type=float, default=0.0)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.distill_extra is None:
        args.distill_extra = args.samples * 3
    if not (args.all_in_one or args.teachers or args.discovery):
        parser.error("pick --all-in-one, --teachers or --discovery")
    return train(args)


if __name__ == "__main__":
    sys.exit(main())
