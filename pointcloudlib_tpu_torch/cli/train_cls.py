"""ModelNet40 classification training CLI (counterpart of the repository's
``train_cls.py``)::

    python -m pointcloudlib_tpu_torch.cli.train_cls --model pointnet2 \\
        --data-root data/modelnet40_normal_resampled
    python -m pointcloudlib_tpu_torch.cli.train_cls --model dgcnn \\
        --synthetic --device cpu --epochs 1 --steps-per-epoch 2

Every flag of the JAX CLI, with its default, plus ``--device`` (``cuda``
by default; without a card the run raises unless it is ``cpu``). The
activation audit and ``--debug`` are not ported yet: those flags exit
naming their ROADMAP item.

Data parallelism: ``--n-devices`` W processes (by default every visible
card), one a device, each on its rows of every global batch with sync-BN
and the gradients summed (``common.launch``, ``parallel/``); ``--dp``
takes the JAX CLI's three modes, all one step; ``--multihost`` joins
``torchrun``'s process group. Every rank runs the same seeded loader and
KPConv calibration (rank 0's broadcast); dropout draws from a generator
seeded by ``(seed, rank)``; rank 0 alone prints, logs and writes
checkpoints.

The loop is the JAX CLI's: shuffled epochs (seed ``seed + epoch``) that
drop the last partial batch, batches assembled in a prefetch thread (and
with ``--num-workers`` in forked processes), the train step's metrics
read back only every ``--log-every`` steps and at the end of an epoch,
the test set in padded batches masked by ``valid``, a checkpoint every
epoch under ``<checkpoint-dir>/<model>`` (``current.pt``; ``best.pt`` by
test OA), ``--eval`` / ``--confusion`` / ``--votes`` from ``current``
and ``--resume``. The model's parameters are made on the CPU under
``torch.manual_seed(seed)`` and then moved; dropout draws from one
generator on the device, seeded by ``seed``.

KPConv (``--model kpconv | kpconv_deform``) takes the JAX CLI's branch:
the training set without the ModelNet augmentation but permuted, the
pyramid calibrated on 64 clouds augmented by ``kpconv_augment`` (with
``--kp-buckets`` > 1 per occupancy bucket, one train step per bucket
over one set of parameters, the merged shapes for the model that
evaluates; ``--kp-cap-quantile`` the caps' occupancy quantile, a
negative value the truncation-free maxima with margin 1.15), epochs of
potential-sampled, augmented clouds (``kpconv_cls_batches``, up to
``steps-per-epoch`` (300) × B clouds), the reference recipe with
``--optimizer sgd`` (the gradients clipped to a global norm of 100,
momentum 0.98, lr 1e-2 decayed by 0.1^(1/100) each epoch's worth of
steps, the deformable offsets' updates scaled by
``--deform-lr-factor``), ``--votes`` by ``evaluate_voting_kpconv`` and a
``VOXEL-OVERFLOW`` note on an epoch whose last step's caps cut voxels.

``main(argv)`` returns a summary dict: for training ``start_epoch``,
``best_at_start`` (a resumed run's bar), ``epochs``,
``steps``, ``first_loss``, ``last_loss``, ``test_oa``,
``samples_per_s`` and ``voxel_overflow`` (KPConv) by epoch, ``best_oa``,
and for KPConv ``calibration`` and, with buckets, ``steps_by_bucket``;
for ``--eval`` ``eval_oa``; ``checkpoints``, the number of checkpoint
saves this rank made; a spawned run adds ``ranks``, every rank's
summary.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from pointcloudlib_tpu_torch.cli import common

KP_CALIBRATION_CLOUDS = 64
KP_EPOCH_STEPS = 300          # the reference epoch's steps


def _kpconv_calibration(args, train_ds, dev, say=print):
    """``(calibration, bucketed or None, rng)``: the pyramid's shapes from
    the first 64 training clouds, each augmented by ``kpconv_augment``
    from ``default_rng(seed + 1)``, which the epochs then go on
    drawing from."""
    from pointcloudlib_tpu_torch.data import kpconv_augment
    from pointcloudlib_tpu_torch.models.kpconv.adapter import (
        FIRST_SUBSAMPLING_DL,
    )
    from pointcloudlib_tpu_torch.models.kpconv.calibrate import (
        calibrate_buckets,
        calibrate_pyramid,
    )
    from pointcloudlib_tpu_torch.models.kpconv.model import (
        KPConvConfig,
        deformable_architecture,
    )

    base = KPConvConfig()
    arch = base.architecture
    if args.model == "kpconv_deform":
        arch = deformable_architecture(arch)
    rng = np.random.default_rng(args.seed + 1)
    n_cal = min(len(train_ds), KP_CALIBRATION_CLOUDS)
    clouds = np.stack([kpconv_augment(train_ds[i][0], rng)
                       for i in range(n_cal)])
    kw = dict(cap_quantile=(None if args.kp_cap_quantile < 0
                            else args.kp_cap_quantile),
              margin=1.0 if args.kp_cap_quantile >= 0 else 1.15,
              device=dev)
    if args.kp_buckets > 1:
        bcal = calibrate_buckets(clouds, FIRST_SUBSAMPLING_DL,
                                 base.conv_radius, base.deform_radius, arch,
                                 n_buckets=args.kp_buckets, **kw)
        say(f"kpconv calibration ({n_cal} clouds, {args.kp_buckets} "
            f"buckets): {bcal.describe()}")
        return bcal.merged(), bcal, rng
    calib = calibrate_pyramid(clouds, FIRST_SUBSAMPLING_DL, base.conv_radius,
                              base.deform_radius, arch, **kw)
    say(f"kpconv calibration ({n_cal} clouds): {calib.describe()}")
    return calib, None, rng


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Point cloud classification (PyTorch port)")
    p.add_argument("--model", default="pointnet2",
                   help="pointnet | pointnet2 | pointnet2_msg | dgcnn | "
                        "pointcnn | pointconv | kpconv | kpconv_deform")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_points", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adam"])
    p.add_argument("--eval", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint and continue")
    p.add_argument("--confusion", action="store_true",
                   help="print per-class accuracy at eval (fast_confusion)")
    p.add_argument("--votes", type=int, default=1,
                   help="voting eval: average softmax over N re-augmented "
                        "passes")
    p.add_argument("--data-root", default="data/modelnet40_normal_resampled")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the procedural synthetic dataset")
    p.add_argument("--synthetic-size", type=int, default=512)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="cap steps per epoch (smoke tests)")
    p.add_argument("--deform-lr-factor", type=float, default=0.0,
                   help="lr factor of kpconv_deform's offset parameters "
                        "(0 keeps them where they are; 0.1 is the "
                        "original KPConv recipe's)")
    p.add_argument("--kp-buckets", type=int, default=2,
                   help="KPConv occupancy buckets, each calibrated and "
                        "trained at its own pyramid shapes; 1 = one shape")
    p.add_argument("--kp-cap-quantile", type=float, default=0.9,
                   help="KPConv voxel caps from this occupancy quantile "
                        "(clouds above it lose voxels, counted as "
                        "VOXEL-OVERFLOW); negative = the maxima, margin "
                        "1.15")
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
                   help="forked batch-assembly processes; 0 = assemble "
                        "in the prefetch thread")
    p.add_argument("--diff-checkpoint", default=None, metavar="CK.pt",
                   help="activation audit; not ported yet")
    p.add_argument("--diff-trace", default=None, metavar="NPZ",
                   help="activation audit; not ported yet")
    p.add_argument("--dump-trace", default=None, metavar="NPZ",
                   help="activation audit; not ported yet")
    p.add_argument("--diff-atol", type=float, default=1e-2,
                   help="activation audit; not ported yet")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--log-dir", default=None,
                   help="write JSONL metrics here")
    common.add_device_flag(p)
    return p.parse_args(argv)


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

    from pointcloudlib_tpu_torch.data import (
        PotentialSampler,
        cls_batches,
        kpconv_augment,
        kpconv_cls_batches,
        make_modelnet40,
        prefetch,
    )
    from pointcloudlib_tpu_torch.models import get_cls_model
    from pointcloudlib_tpu_torch.train import (
        KPCONV_CLIP_NORM,
        fast_confusion,
        kpconv_optimizer,
        make_cls_eval_step,
        make_cls_pred_step,
        make_cls_train_step,
    )
    from pointcloudlib_tpu_torch.utils.checkpoint import CheckpointManager
    from pointcloudlib_tpu_torch.utils.logging import MetricsLogger

    say(f"device: {common.device_name(dev)}, model={args.model}, "
        f"N={args.num_points}, B={args.batch_size}"
        + (f", devices={world}, dp={common.dp_mode(args, world)}"
           if world > 1 else ""))
    # only PointNet++ takes normals as features
    with_normals = args.model.startswith("pointnet2")
    is_kpconv = args.model.startswith("kpconv")
    # KPConv augments in its own epoch iterator; the points stay permuted
    train_ds = make_modelnet40(
        args.num_points, train=True, data_root=args.data_root,
        synthetic=args.synthetic, synthetic_size=args.synthetic_size,
        seed=args.seed, augment=False if is_kpconv else None,
        permute=True if is_kpconv else None)
    test_size = max(64, args.synthetic_size // 4)
    test_ds = make_modelnet40(
        args.num_points, train=False, data_root=args.data_root,
        synthetic=args.synthetic, synthetic_size=test_size, seed=args.seed)

    model_kw, calib, kp_bcal = {}, None, None
    if is_kpconv:
        calib, kp_bcal, kp_rng = _kpconv_calibration(args, train_ds, dev,
                                                     say)
        calib, kp_bcal = common.from_rank0((calib, kp_bcal), group)
        model_kw = dict(caps=calib.caps,
                        neighborhood_limits=calib.neighborhood_limits)
        kp_sampler = PotentialSampler(len(train_ds), seed=args.seed)
    model = common.seeded_model(lambda: get_cls_model(
        args.model, n_classes=40, feat_channels=3 if with_normals else 0,
        **model_kw), args.seed).to(dev)
    set_lr, clip = None, None
    if is_kpconv and args.optimizer == "sgd":
        opt, set_lr = kpconv_optimizer(
            model, args.steps_per_epoch or max(1, len(train_ds)
                                               // args.batch_size),
            args.deform_lr_factor)
        clip = KPCONV_CLIP_NORM
    else:
        opt = common.make_optimizer(args, model, len(train_ds))
    n_params = sum(p.numel() for p in model.parameters())
    say(f"params: {n_params/1e6:.2f}M")
    train_step = make_cls_train_step(model, opt, device=dev, clip_norm=clip,
                                     group=group)
    eval_step = make_cls_eval_step(model, device=dev, group=group)
    # one step per occupancy bucket, each model at its bucket's shapes
    # and sharing every parameter, buffer and the optimizer
    bucket_steps = None if kp_bcal is None else [
        make_cls_train_step(model.with_shapes(c.caps, c.neighborhood_limits),
                            opt, device=dev, clip_norm=clip, group=group)
        for c in kp_bcal.buckets]
    ckpt = CheckpointManager(Path(args.checkpoint_dir) / args.model)

    def evaluate(confusion=False):
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        trues, preds = [], []
        # one forward a batch: the ids come back and the counts are made
        # from them on the host
        pred_step = make_cls_pred_step(model, device=dev, group=group) \
            if confusion else None
        for batch in cls_batches(test_ds, args.batch_size,
                                 with_normals=with_normals):
            if confusion:
                pred = pred_step(batch).cpu().numpy()
                valid = batch["valid"]
                correct += int(((pred == batch["label"]) & valid).sum())
                total += int(valid.sum())
                trues.append(batch["label"][valid])
                preds.append(pred[valid])
            else:
                c, t = eval_step(batch)
                correct += c
                total += t
        if confusion and trues:
            cm = fast_confusion(np.concatenate(trues),
                                np.concatenate(preds), 40)
            per_class = np.diag(cm) / np.maximum(cm.sum(1), 1)
            for c_id in np.nonzero(cm.sum(1))[0]:
                say(f"  class {c_id:2d}: acc {per_class[c_id]*100:5.1f}% "
                    f"({cm[c_id].sum()} samples)")
        return 100.0 * int(correct) / max(int(total), 1)

    def evaluate_voting(n_votes):
        """The softmax averaged over ``n_votes`` passes of the test set,
        each re-augmented (the reference's incremental average)."""
        prob_step = make_cls_pred_step(model, probs=True, device=dev,
                                       group=group)
        vote_ds = make_modelnet40(
            args.num_points, train=False, data_root=args.data_root,
            synthetic=args.synthetic, synthetic_size=test_size,
            seed=args.seed, augment=True)
        probs, labels, valids = None, [], []
        for v in range(n_votes):
            pv, first = [], probs is None
            for batch in cls_batches(vote_ds, args.batch_size,
                                     with_normals=with_normals):
                pv.append(prob_step(batch).cpu().numpy())
                if first:
                    labels.append(batch["label"])
                    valids.append(batch["valid"])
            pv = np.concatenate(pv)
            probs = pv if first else probs + (pv - probs) / (v + 1)
        labels = np.concatenate(labels)
        valid = np.concatenate(valids)
        pred = probs.argmax(-1)
        return 100.0 * ((pred == labels) & valid).sum() / valid.sum()

    kp_summary = {} if calib is None else {"calibration": {
        "caps": list(calib.caps),
        "neighborhood_limits": list(calib.neighborhood_limits),
        "buckets": None if kp_bcal is None else [
            {"caps": list(c.caps),
             "neighborhood_limits": list(c.neighborhood_limits)}
            for c in kp_bcal.buckets]}}

    def evaluate_voting_kpconv(n_votes):
        """KPConv's voting test (the JAX CLI's): each pass samples the
        test set by fresh potentials and augments every cloud by
        ``kpconv_augment``; each item's probabilities are the incremental
        average of its passes."""
        prob_step = make_cls_pred_step(model, probs=True, device=dev,
                                       group=group)
        vote_ds = make_modelnet40(
            args.num_points, train=False, data_root=args.data_root,
            synthetic=args.synthetic, synthetic_size=test_size,
            seed=args.seed, augment=False, permute=True)
        n = len(vote_ds)
        labels = np.array([vote_ds[i][2] for i in range(n)], np.int32)
        sampler = PotentialSampler(n, seed=args.seed + 7)
        rng = np.random.default_rng(args.seed + 8)
        probs = np.zeros((n, 40), np.float32)
        counts = np.zeros((n,), np.int32)
        for _ in range(n_votes):
            order = sampler.sample(n)
            for start in range(0, n, args.batch_size):
                chunk = order[start:start + args.batch_size]
                clouds = [kpconv_augment(vote_ds[int(i)][0], rng)
                          for i in chunk]
                while len(clouds) < args.batch_size:
                    clouds.append(clouds[-1])
                batch = {"xyz": np.stack(clouds).astype(np.float32),
                         "label": np.zeros(args.batch_size, np.int32),
                         "valid": np.ones(args.batch_size, bool)}
                p = prob_step(batch).cpu().numpy()[:len(chunk)]
                probs[chunk] += (p - probs[chunk]) / (counts[chunk, None]
                                                      + 1)
                counts[chunk] += 1
        return 100.0 * (probs.argmax(-1) == labels).mean()

    if args.eval:
        if ckpt.restore_variables(model, name="current") is None:
            say(f"no checkpoint under {ckpt.directory}: evaluating the "
                "initial weights")
        if group is not None:
            replicate(group, model)
        if args.votes > 1:
            vote = evaluate_voting_kpconv if is_kpconv else evaluate_voting
            oa = float(vote(args.votes))
            say(f"eval OA ({args.votes} votes): {oa:.2f}%")
        else:
            oa = evaluate(confusion=args.confusion)
            say(f"eval OA: {oa:.2f}%")
        return {"eval_oa": oa, "votes": args.votes, "checkpoints": 0,
                **kp_summary}

    best_oa, step_count, start_epoch = 0.0, 0, 0
    if args.resume:
        restored = ckpt.restore_with_step(model, opt)
        if restored is not None:
            step_count, start_epoch = restored
            start_epoch += 1
            best_oa = ckpt.best_metric() or 0.0
            say(f"resumed from epoch {start_epoch - 1} "
                f"(best OA so far {best_oa:.2f}%)")
    if group is not None:
        replicate(group, model)
    gen = torch.Generator(device=dev).manual_seed(rank_seed(args.seed, rank))
    mlog = MetricsLogger(args.log_dir if rank == 0 else None,
                         run_name=f"cls_{args.model}")
    summary = {"start_epoch": start_epoch, "best_at_start": best_oa,
               "epochs": [], "steps": step_count, "first_loss": None,
               "last_loss": None, "test_oa": {}, "samples_per_s": {},
               "voxel_overflow": {}, "steps_by_bucket": {},
               "checkpoints": 0, **kp_summary}
    first = None
    try:
        for epoch in range(start_epoch, args.epochs):
            t0, seen, pending = time.perf_counter(), 0, None
            if is_kpconv:
                epoch_n = (args.steps_per_epoch or KP_EPOCH_STEPS) * \
                    args.batch_size
                batches = kpconv_cls_batches(
                    train_ds, args.batch_size, kp_sampler, kp_rng,
                    epoch_n=min(epoch_n, len(train_ds)),
                    bucket_of=None if kp_bcal is None else kp_bcal.bucket_of)
            else:
                batches = cls_batches(
                    train_ds, args.batch_size, shuffle=True,
                    seed=args.seed + epoch, drop_last=True,
                    with_normals=with_normals, workers=args.num_workers)
            for i, batch in enumerate(prefetch(common.staged(batches,
                                                              dev))):
                if args.steps_per_epoch and i >= args.steps_per_epoch:
                    break
                bucket = batch.pop("bucket", None)
                step_fn = train_step
                if bucket_steps is not None and bucket is not None:
                    bucket = int(bucket)
                    step_fn = bucket_steps[bucket]
                    by = summary["steps_by_bucket"]
                    by[bucket] = by.get(bucket, 0) + 1
                if set_lr is not None:
                    set_lr(step_count)
                # metrics read later: no sync; a data-parallel step
                # takes the global batch and copies its own rows
                pending = step_fn(batch if group is not None
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
            oa = evaluate()
            extra = ""
            if is_kpconv:
                pot = kp_sampler.potentials
                extra = (f" potentials=[{pot.min():.2f},{pot.max():.2f}]"
                         " (kpconv_augment active)")
                overflow = (0.0 if pending is None
                            else float(pending["voxel_overflow"]))
                summary["voxel_overflow"][epoch] = overflow
                if overflow > 0:
                    extra += (f" VOXEL-OVERFLOW={int(overflow)} (pyramid "
                              "caps truncating; re-calibrate)")
            say(f"epoch {epoch}: loss={loss:.4f} test OA={oa:.2f}% "
                f"({seen/dt:.1f} samples/s){extra}")
            mlog.log("epoch", epoch=epoch, loss=loss, test_oa=oa,
                     samples_per_sec=seen / dt)
            if rank == 0:
                ckpt.save(model, opt, step=epoch, best=oa > best_oa,
                          metric=oa, train_steps=step_count)
                summary["checkpoints"] += 1
            best_oa = max(best_oa, oa)
            summary["epochs"].append(epoch)
            summary["last_loss"] = loss
            summary["test_oa"][epoch] = oa
            summary["samples_per_s"][epoch] = seen / dt
    finally:
        mlog.close()
    say(f"best OA: {best_oa:.2f}%")
    summary.update(steps=step_count, best_oa=best_oa,
                   first_loss=None if first is None else float(first))
    return summary


if __name__ == "__main__":
    main()
