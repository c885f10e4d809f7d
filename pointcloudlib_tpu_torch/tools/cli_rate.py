"""The training CLIs' samples/s on the card, by host data path.

    python -m pointcloudlib_tpu_torch.tools.cli_rate [--epochs 3] \\
        [--steps 32] [--workers 4] [--points 10000]

Runs ``train_cls --model pointnet2`` (B=32, N=1024, normals as features)
and ``train_partseg --model dgcnn`` (B=16, N=2048) for ``--epochs``
epochs of ``--steps`` steps, each with the prefetch thread alone and with
``--workers`` forked workers:

* ``train_cls`` on a ModelNet40 archive of synthetic clouds of
  ``--points`` points (the reference files hold 10,000; the loader's
  vectorised ``get_batch`` picks 1,024 of them, normalizes and augments),
  written to a temporary directory first, and on ``--synthetic`` (each
  item made and augmented in numpy);
* ``train_partseg`` on ``--synthetic``.

Prints one JSON line: the card's name and power limit, the host's CPU
count, and per run the samples/s that each epoch printed (the first epoch
includes the warm-up) and the seconds of the run. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from pointcloudlib_tpu_torch.cli import train_cls, train_partseg
from pointcloudlib_tpu_torch.data import SyntheticModelNet


def _archive(path: str, n_train: int, n_test: int, points: int) -> str:
    """``<path>.npz`` with ``points_{train,test}`` ``[M, points, 6]`` f32
    and their labels, from the synthetic sets → the data root ``path``."""
    arrays = {}
    for split, size in (("train", n_train), ("test", n_test)):
        xyz, nrm, labels = SyntheticModelNet(
            n_points=points, size=size, train=split == "train",
            augment=False).batch(0, size)
        arrays[f"points_{split}"] = np.concatenate([xyz, nrm], -1)
        arrays[f"labels_{split}"] = labels
    np.savez(path + ".npz", **arrays)
    return path


def _run(main, argv):
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = main(argv)
    return {"samples_per_s": list(out["samples_per_s"].values()),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--points", type=int, default=10_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("cli_rate: needs a CUDA device")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = _archive(os.path.join(tmp, "modelnet40"), 32 * args.steps,
                        64, args.points)
        common = ["--epochs", str(args.epochs), "--steps-per-epoch",
                  str(args.steps), "--checkpoint-dir", tmp]
        cls = ["--model", "pointnet2", "--batch_size", "32",
               "--num_points", "1024", *common]
        seg = ["--model", "dgcnn", "--batch_size", "16", "--num_points",
               "2048", "--synthetic", "--synthetic-size",
               str(16 * args.steps), *common]
        for name, main_fn, argv in (
                ("train_cls pointnet2 archive", train_cls.main,
                 cls + ["--data-root", root]),
                ("train_cls pointnet2 synthetic", train_cls.main,
                 cls + ["--synthetic", "--synthetic-size",
                        str(32 * args.steps)]),
                ("train_partseg dgcnn synthetic", train_partseg.main, seg)):
            for workers in (0, args.workers):
                runs[f"{name} workers={workers}"] = _run(
                    main_fn, argv + ["--num-workers", str(workers)])
    print(json.dumps({"card": power, "host_cpus": os.cpu_count(),
                      "epochs": args.epochs, "steps": args.steps,
                      "points": args.points, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
