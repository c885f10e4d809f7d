"""ShapeNet part-segmentation training CLI (counterpart of the
repository's ``train_partseg.py``)::

    python -m pointcloudlib_tpu_torch.cli.train_partseg --model dgcnn \\
        --data-root data/shapenet_part_seg_hdf5_data
    python -m pointcloudlib_tpu_torch.cli.train_partseg --model pointnet2 \\
        --synthetic --device cpu --epochs 1 --steps-per-epoch 2

Every flag of the JAX CLI, with its default, plus ``--device`` (``cuda``
by default; without a card the run raises unless it is ``cpu``);
``--debug`` exits naming its ROADMAP item. ``--n-devices``, ``--dp`` and
``--multihost`` run data-parallel as in ``train_cls`` (the loss and
accuracy over the global valid points, the gradients summed). SGD carries the
reference's weight decay 1e-4 at the flat lr of the batches kept
(``drop_last``). The eval reports per-point accuracy, the balanced
accuracy over the 50 parts and the mean shape IoU; the best checkpoint
is kept by IoU under ``<checkpoint-dir>/<model>_partseg``. The loop, the
seeding and the checkpoints are ``train_cls``'s.

``main(argv)`` returns a summary dict: for training ``start_epoch``,
``best_at_start`` (a resumed run's bar), ``epochs``,
``steps``, ``first_loss``, ``last_loss``, ``test_iou``, ``test_acc``,
``test_balanced_acc`` and ``samples_per_s`` by epoch, ``best_iou``; for
``--eval`` ``eval_acc``, ``eval_balanced_acc`` and ``eval_iou``;
``checkpoints`` and, from a spawned run, ``ranks`` as in ``train_cls``.
"""

from __future__ import annotations

import argparse
import functools
import time
from pathlib import Path

import numpy as np
import torch

from pointcloudlib_tpu_torch.cli import common


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Part segmentation (PyTorch port)")
    p.add_argument("--model", default="pointnet2")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_points", type=int, default=2048)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint and continue")
    p.add_argument("--data-root", default="data/shapenet_part_seg_hdf5_data")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--class-choice", default=None,
                   help="restrict to one category")
    p.add_argument("--synthetic-size", type=int, default=256)
    p.add_argument("--steps-per-epoch", type=int, default=None)
    p.add_argument("--n-devices", type=int, default=None,
                   help="data-parallel processes, one a device (default: "
                        "every visible card; one with --device cpu)")
    p.add_argument("--dp", default="auto",
                   choices=["auto", "spmd", "shard_map"],
                   help="multi-device mode; all three run the same "
                        "sync-BN step (auto = shard_map on >1 device)")
    p.add_argument("--debug", action="store_true",
                   help="not ported yet")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's process group (MASTER_ADDR, "
                        "RANK, WORLD_SIZE, LOCAL_RANK)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=0,
                   help="forked batch-assembly processes; 0 = prefetch "
                        "thread only")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--log-dir", default=None,
                   help="write JSONL metrics here")
    common.add_device_flag(p)
    return p.parse_args(argv)


def _prep(batch, model_name):
    """Attach the 16-way category one-hot; PointNet++ also takes xyz as
    its point features."""
    out = {
        "xyz": batch["xyz"],
        "seg": batch["seg"],
        "cls_onehot": np.eye(16, dtype=np.float32)[batch["label"]],
    }
    if "valid" in batch:
        out["valid"] = batch["valid"]
    if model_name.startswith("pointnet2"):
        out["feats"] = batch["xyz"]
    return out


def main(argv=None) -> dict:
    args = parse_args(argv)
    common.refuse_unported(args)
    return common.launch(_run, args)


def _run(args, group) -> dict:
    """The run on one rank of ``group`` (``None``: one process)."""
    from pointcloudlib_tpu_torch.parallel import rank_seed, replicate

    dev = common.device_of(args) if group is None else group.device
    rank = 0 if group is None else group.rank
    world = 1 if group is None else group.world
    say = print if rank == 0 else common.quiet

    from pointcloudlib_tpu_torch.data import make_shapenet, prefetch
    from pointcloudlib_tpu_torch.data import seg_batches
    from pointcloudlib_tpu_torch.models import get_seg_model
    from pointcloudlib_tpu_torch.train import (
        balanced_accuracy,
        make_seg_eval_step,
        make_seg_train_step,
        shape_ious,
    )
    from pointcloudlib_tpu_torch.utils.checkpoint import CheckpointManager
    from pointcloudlib_tpu_torch.utils.logging import MetricsLogger

    say(f"device: {common.device_name(dev)}, model={args.model}, "
        f"N={args.num_points}, B={args.batch_size}"
        + (f", devices={world}, dp={common.dp_mode(args, world)}"
           if world > 1 else ""))
    train_ds = make_shapenet(
        "trainval", args.num_points, data_root=args.data_root,
        synthetic=args.synthetic, synthetic_size=args.synthetic_size,
        seed=args.seed, class_choice=args.class_choice)
    test_ds = make_shapenet(
        "test", args.num_points, data_root=args.data_root,
        synthetic=args.synthetic,
        synthetic_size=max(64, args.synthetic_size // 4), seed=args.seed,
        class_choice=args.class_choice)

    with_xyz = args.model.startswith("pointnet2")
    model = common.seeded_model(lambda: get_seg_model(
        args.model, part_num=50, feat_channels=3 if with_xyz else 0),
        args.seed).to(dev)
    # the reference's weight decay; the loader drops the last partial
    # batch, so the flat lr counts whole batches
    opt = common.make_optimizer(args, model, len(train_ds),
                                weight_decay=1e-4, drop_last=True)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"params: {n_params/1e6:.2f}M")
    train_step = make_seg_train_step(model, opt, device=dev, group=group)
    eval_step = make_seg_eval_step(model, device=dev, group=group)
    ckpt = CheckpointManager(
        Path(args.checkpoint_dir) / f"{args.model}_partseg")

    def evaluate():
        correct = total = 0
        ious, trues, preds = [], [], []
        for batch in seg_batches(test_ds, args.batch_size, drop_last=False):
            pred = eval_step(_prep(batch, args.model)).cpu().numpy()
            valid = batch["valid"]
            correct += ((pred == batch["seg"]) & valid[:, None]).sum()
            total += valid.sum() * pred.shape[1]
            ious.append(shape_ious(pred[valid], batch["seg"][valid],
                                   batch["label"][valid]))
            trues.append(batch["seg"][valid].reshape(-1))
            preds.append(pred[valid].reshape(-1))
        bal = 100.0 * balanced_accuracy(
            np.concatenate(trues), np.concatenate(preds), 50)
        return (100.0 * float(correct) / max(int(total), 1),
                100.0 * float(np.mean(np.concatenate(ious))), bal)

    if args.eval:
        if ckpt.restore_variables(model, name="current") is None:
            say(f"no checkpoint under {ckpt.directory}: evaluating the "
                "initial weights")
        if group is not None:
            replicate(group, model)
        acc, iou, bal = evaluate()
        say(f"eval acc: {acc:.2f}%  balanced: {bal:.2f}%  "
            f"mean shape IoU: {iou:.2f}%")
        return {"eval_acc": acc, "eval_balanced_acc": bal, "eval_iou": iou,
                "checkpoints": 0}

    best_iou, step_count, start_epoch = 0.0, 0, 0
    if args.resume:
        restored = ckpt.restore_with_step(model, opt)
        if restored is not None:
            step_count, start_epoch = restored
            start_epoch += 1
            best_iou = ckpt.best_metric() or 0.0
            say(f"resumed from epoch {start_epoch - 1} "
                f"(best IoU so far {best_iou:.2f}%)")
    if group is not None:
        replicate(group, model)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(args.seed, rank))
    mlog = MetricsLogger(args.log_dir if rank == 0 else None,
                         run_name=f"partseg_{args.model}")
    summary = {"start_epoch": start_epoch, "best_at_start": best_iou,
               "epochs": [], "steps": step_count, "first_loss": None,
               "last_loss": None, "test_iou": {}, "test_acc": {},
               "test_balanced_acc": {}, "samples_per_s": {},
               "checkpoints": 0}
    first = None
    try:
        for epoch in range(start_epoch, args.epochs):
            t0, seen, pending = time.perf_counter(), 0, None
            batches = seg_batches(
                train_ds, args.batch_size, shuffle=True,
                seed=args.seed + epoch, drop_last=True,
                workers=args.num_workers)
            prep = functools.partial(_prep, model_name=args.model)
            for i, batch in enumerate(prefetch(common.staged(
                    batches, dev, prep))):
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
                # metrics read later: no sync; a data-parallel step
                # takes the global batch and copies its own rows
                pending = train_step(batch if group is not None
                                     else common.to_device(batch, dev), gen)
                if first is None:
                    first = pending["loss"]
                seen += args.batch_size
                step_count += 1
                if (i + 1) % args.log_every == 0:
                    say(f"epoch {epoch} step {i+1}: "
                        f"loss={float(pending['loss']):.4f} "
                        f"acc={float(pending['acc'])*100:.2f}%")
            common.synchronize(dev)
            dt = time.perf_counter() - t0
            loss = (float(pending["loss"]) if pending is not None
                    else float("nan"))
            acc, iou, bal = evaluate()
            say(f"epoch {epoch}: loss={loss:.4f} test acc={acc:.2f}% "
                f"bal={bal:.2f}% IoU={iou:.2f}% "
                f"({seen/dt:.1f} samples/s)")
            mlog.log("epoch", epoch=epoch, loss=loss, test_acc=acc,
                     test_balanced_acc=bal, test_iou=iou,
                     samples_per_sec=seen / dt)
            if rank == 0:
                ckpt.save(model, opt, step=epoch, best=iou > best_iou,
                          metric=iou, train_steps=step_count)
                summary["checkpoints"] += 1
            best_iou = max(best_iou, iou)
            summary["epochs"].append(epoch)
            summary["last_loss"] = loss
            summary["test_iou"][epoch] = iou
            summary["test_acc"][epoch] = acc
            summary["test_balanced_acc"][epoch] = bal
            summary["samples_per_s"][epoch] = seen / dt
    finally:
        mlog.close()
    say(f"best IoU: {best_iou:.2f}%")
    summary.update(steps=step_count, best_iou=best_iou,
                   first_loss=None if first is None else float(first))
    return summary


if __name__ == "__main__":
    main()
