"""The port's checkpoints, serving from a checkpoint, the prediction
step, the metrics log and both training CLIs, on the CPU, with PointNet
(the cheapest full-width model, no kernel) at B=4, N=64 on synthetic
data: the checkpoint round trip and the step after a restore, the
predictors built from a checkpoint, ``make_cls_pred_step`` against the
JAX pred step, ``MetricsLogger``'s records, two epochs of each CLI with
``--eval``, ``--resume``, ``--votes`` and ``--confusion``, the flags
against the JAX CLIs' parsers and the refusal of the flags not ported;
KPConv's branch of ``train_cls``: its recipe's updates against the JAX
CLI's optax chain, and a deformable run on the CPU (full width, B=8,
N=64, two occupancy buckets) whose offsets stay where they were at
``--deform-lr-factor 0``, then its voting test."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import train_cls as jax_train_cls
import train_partseg as jax_train_partseg
from pointcloudlib_tpu.models import get_cls_model as jax_cls_model
from pointcloudlib_tpu.train.state import TrainState
from pointcloudlib_tpu.train.trainer import (
    make_cls_pred_step as jax_pred_step,
)
from pointcloudlib_tpu.utils.logging import MetricsLogger as JaxLogger

from pointcloudlib_tpu_torch.cli import common, train_cls, train_partseg
from pointcloudlib_tpu_torch.data import SyntheticModelNet
from pointcloudlib_tpu_torch.inference import (
    Predictor,
    SegPredictor,
    _pad_points,
)
from pointcloudlib_tpu_torch.models import get_cls_model, get_seg_model
from pointcloudlib_tpu_torch.train import (
    KPCONV_CLIP_NORM,
    clip_grad_global_norm,
    kpconv_optimizer,
    make_cls_pred_step,
    make_cls_train_step,
    sgd_momentum,
)
from pointcloudlib_tpu_torch.utils.checkpoint import CheckpointManager
from pointcloudlib_tpu_torch.utils.interop import (
    from_jax_variables,
    random_jax_variables,
)
from pointcloudlib_tpu_torch.utils.logging import MetricsLogger

B, N = 4, 64


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The port's CPU work on 2 threads beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed):
    xyz, _, label = SyntheticModelNet(n_points=N, size=B, seed=seed).batch(
        0, B)
    return {"xyz": xyz, "label": label}


def _trained(seed=0):
    """A PointNet one SGD step (momentum 0.9) from its seeded start, with
    its optimizer and the dropout generator after the step."""
    model = common.seeded_model(lambda: get_cls_model("pointnet"), seed)
    opt = sgd_momentum(model.parameters(), 0.05)
    gen = torch.Generator().manual_seed(seed)
    make_cls_train_step(model, opt, device="cpu")(_batch(1), gen)
    return model, opt, gen


def _state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_checkpoint_round_trip(tmp_path):
    """Parameters, BN buffers, SGD momentum, step, ``save_step`` and the
    best metric survive a save; ``step_0050.pt`` at the periodic gap;
    the step after a restore into a fresh model and optimizer equals the
    uninterrupted step bit for bit; the file names are not the JAX
    manager's (``current``, ``best``, ``step_0050``,
    ``best_metric.json``)."""
    mgr = CheckpointManager(tmp_path / "ck")
    assert mgr.restore(get_cls_model("pointnet")) is None
    assert mgr.best_metric() is None
    assert not (tmp_path / "ck").exists()
    model, opt, gen = _trained()
    mgr.save(model, opt, step=50, best=True, metric=12.5, train_steps=7)
    mgr.save(model, opt, step=51, metric=3.0, train_steps=8)
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["best.pt", "current.pt", "step_0050.pt"]
    assert not {"current", "best", "step_0050", "best_metric.json"} & \
        set(names)
    assert mgr.best_metric() == 12.5

    fresh = get_cls_model("pointnet")
    fresh_opt = sgd_momentum(fresh.parameters(), 0.05)
    assert mgr.restore_with_step(fresh, fresh_opt) == (8, 51)
    _state_equal(fresh.state_dict(), model.state_dict())
    assert any(k.endswith("running_mean") for k in model.state_dict())
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           fresh_opt.state[q]["momentum_buffer"])
    assert mgr.restore(get_cls_model("pointnet"), name="step_0050") == 7
    CheckpointManager(tmp_path / "bare").save(model, None, step=1)
    with pytest.raises(ValueError, match="no optimizer"):
        CheckpointManager(tmp_path / "bare").restore(fresh, fresh_opt)

    gen2 = torch.Generator().manual_seed(0)
    gen2.set_state(gen.get_state())
    batch = _batch(2)
    want = make_cls_train_step(model, opt, device="cpu")(batch, gen)
    got = make_cls_train_step(fresh, fresh_opt, device="cpu")(batch, gen2)
    assert torch.equal(got["loss"], want["loss"])
    _state_equal(fresh.state_dict(), model.state_dict())


def test_predictors_from_checkpoint(tmp_path):
    """``from_checkpoint`` serves the saved weights: equal to a predictor
    on the model in memory; ``best`` falls back to ``current``; a
    directory without either raises."""
    model, opt, _ = _trained()
    CheckpointManager(tmp_path / "cls").save(model, opt, step=0)
    clouds, normals, _ = SyntheticModelNet(n_points=50, size=3,
                                           seed=4).batch(0, 3)
    got = Predictor.from_checkpoint(tmp_path / "cls", "pointnet",
                                    batch_size=2, device="cpu")
    want = Predictor(model, batch_size=2, device="cpu")
    assert not got.with_normals
    np.testing.assert_array_equal(got.predict_proba(clouds),
                                  want.predict_proba(clouds))
    with pytest.raises(FileNotFoundError, match="refusing to serve"):
        Predictor.from_checkpoint(tmp_path / "none", "pointnet",
                                  device="cpu")

    seg = common.seeded_model(lambda: get_seg_model("pointnet"), 1)
    seg.train()
    with torch.no_grad():  # move the BN statistics off their start
        seg(torch.from_numpy(clouds), torch.eye(16)[[0, 3, 5]])
    CheckpointManager(tmp_path / "seg").save(seg, None, step=0, best=True)
    labels = np.array([0, 3, 5])
    got = SegPredictor.from_checkpoint(tmp_path / "seg", "pointnet",
                                       batch_size=2, device="cpu")
    want = SegPredictor(seg, batch_size=2, device="cpu")
    np.testing.assert_array_equal(got.predict_proba(clouds, labels),
                                  want.predict_proba(clouds, labels))
    with pytest.raises(FileNotFoundError):
        SegPredictor.from_checkpoint(tmp_path / "none", "pointnet",
                                     device="cpu")


def test_pred_step_matches_jax():
    """``make_cls_pred_step`` (ids and probabilities) against the JAX
    pred step's probabilities on the same variables (one jitted JAX
    forward); f32 on both sides."""
    model = get_cls_model("pointnet")
    variables = random_jax_variables(model, seed=3)
    from_jax_variables(model, variables)
    state = TrainState.create(
        apply_fn=None, params=variables["params"],
        batch_stats=variables["batch_stats"], tx=optax.identity())
    batch = _batch(5)
    want = np.asarray(jax_pred_step(jax_cls_model("pointnet"), probs=True)(
        state, {"xyz": jnp.asarray(batch["xyz"])}))
    probs = make_cls_pred_step(model, probs=True, device="cpu")(batch)
    ids = make_cls_pred_step(model, device="cpu")(batch)
    np.testing.assert_allclose(probs.numpy(), want, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(ids.numpy(), want.argmax(-1))


def test_metrics_logger_records(tmp_path):
    """The JAX logger's records: ``event``, ``t`` and the fields, tensor
    and numpy scalars as floats."""
    fields = dict(epoch=3, loss=torch.tensor(0.25), oa=np.float32(0.5),
                  name="x")
    for cls, sub in ((MetricsLogger, "port"), (JaxLogger, "jax")):
        log = cls(str(tmp_path / sub), run_name="cls_pointnet")
        log.log("epoch", **fields)
        log.close()
    got, want = ([json.loads(line) for line in
                  (tmp_path / sub / "cls_pointnet.jsonl").read_text()
                  .splitlines()] for sub in ("port", "jax"))
    assert [r.pop("t") >= 0 for r in got + want] == [True, True]
    assert got == want == [{"event": "epoch", "epoch": 3, "loss": 0.25,
                            "oa": 0.5, "name": "x"}]
    MetricsLogger(None).log("epoch", x=1)  # no directory: nothing written


def _args(tmp_path, *extra):
    return ["--model", "pointnet", "--synthetic", "--synthetic-size", "16",
            "--batch_size", str(B), "--num_points", str(N),
            "--steps-per-epoch", "2", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck"),
            "--log-dir", str(tmp_path / "log"), *extra]


def test_train_cls_trains_evaluates_resumes(tmp_path):
    """Two epochs, then ``--eval`` gives the last epoch's test OA, as do
    ``--confusion`` and ``Predictor.from_checkpoint``; ``--votes 2``
    runs; ``--resume --epochs 3`` continues at epoch 2 with the best OA
    and the step count; the JSONL log holds one record an epoch."""
    run = train_cls.main(_args(tmp_path, "--epochs", "2"))
    assert run["epochs"] == [0, 1] and run["steps"] == 4
    assert np.isfinite(run["first_loss"]) and np.isfinite(run["last_loss"])
    last = run["test_oa"][1]
    assert train_cls.main(_args(tmp_path, "--eval"))["eval_oa"] == last
    assert train_cls.main(_args(tmp_path, "--eval", "--confusion")
                          )["eval_oa"] == last
    voted = train_cls.main(_args(tmp_path, "--eval", "--votes", "2"))
    assert voted["votes"] == 2 and 0 <= voted["eval_oa"] <= 100

    test = SyntheticModelNet(n_points=N, size=64, seed=0)
    clouds, _, labels = test.batch(0, 64)
    served = Predictor.from_checkpoint(tmp_path / "ck" / "pointnet",
                                       "pointnet", which="current",
                                       batch_size=B, device="cpu")
    assert 100.0 * (served.predict(clouds) == labels).mean() == last

    resumed = train_cls.main(_args(tmp_path, "--resume", "--epochs", "3"))
    assert resumed["epochs"] == [2] and resumed["steps"] == 6
    assert resumed["best_oa"] == max(run["best_oa"], resumed["test_oa"][2])
    records = [json.loads(line) for line in
               (tmp_path / "log" / "cls_pointnet.jsonl").read_text()
               .splitlines()]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    assert records[1]["test_oa"] == last


def test_train_partseg_trains_evaluates_resumes(tmp_path):
    run = train_partseg.main(_args(tmp_path, "--epochs", "2"))
    assert run["epochs"] == [0, 1] and run["steps"] == 4
    last = (run["test_acc"][1], run["test_balanced_acc"][1],
            run["test_iou"][1])
    got = train_partseg.main(_args(tmp_path, "--eval"))
    assert (got["eval_acc"], got["eval_balanced_acc"],
            got["eval_iou"]) == last
    assert (tmp_path / "ck" / "pointnet_partseg" / "best.pt").exists()
    resumed = train_partseg.main(_args(tmp_path, "--resume", "--epochs",
                                       "3", "--class-choice", "mug"))
    assert resumed["epochs"] == [2] and resumed["steps"] == 6


@pytest.mark.parametrize("cli,jax_cli", [
    (train_cls, jax_train_cls), (train_partseg, jax_train_partseg)])
def test_flags_are_the_jax_flags(cli, jax_cli):
    """Every flag of the JAX parser, with its default, and ``--device``
    (``cuda``) besides."""
    got, want = vars(cli.parse_args([])), vars(jax_cli.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


UNPORTED = {
    "train_cls": [["--diff-checkpoint", "a.pt"], ["--diff-trace", "a.npz"],
                  ["--dump-trace", "b.npz"], ["--diff-atol", "1e-4"],
                  ["--debug"]],
    "train_partseg": [["--debug"]],
}


@pytest.mark.parametrize("name,flags", [
    (name, flags) for name, cases in UNPORTED.items() for flags in cases],
    ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_unported_flags_exit_naming_their_item(name, flags):
    cli = {"train_cls": train_cls, "train_partseg": train_partseg}[name]
    with pytest.raises(SystemExit, match=r"ROADMAP.md queue 1, item [89]"):
        cli.main(["--device", "cpu", *flags])


@pytest.fixture(scope="module")
def dp_cls_run(tmp_path_factory):
    """``train_cls --n-devices 2 --device cpu``: two gloo ranks (spawned
    processes) for one epoch of two steps."""
    tmp = tmp_path_factory.mktemp("dp_cls")
    return tmp, train_cls.main(_args(tmp, "--epochs", "1",
                                     "--n-devices", "2"))


PARALLEL_FLAGS = [["--n-devices", "2"], ["--dp", "shard_map"],
                  ["--multihost"]]


@pytest.mark.parametrize("name,flags", [
    (name, flags) for name in ("train_cls", "train_partseg")
    for flags in PARALLEL_FLAGS],
    ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_parallel_flags_train(name, flags, dp_cls_run, tmp_path):
    """``--n-devices 2 --device cpu`` (two gloo ranks), ``--dp
    shard_map`` and ``--multihost`` (no ``torchrun`` environment: one
    process) each run two CPU steps of both CLIs on synthetic data; the
    two ranks report the same steps and losses."""
    if name == "train_cls" and flags[0] == "--n-devices":
        run = dp_cls_run[1]
    else:
        cli = {"train_cls": train_cls, "train_partseg": train_partseg}[name]
        run = cli.main(_args(tmp_path, "--epochs", "1", *flags))
    assert run["steps"] == 2 and np.isfinite(run["last_loss"])
    ranks = run.get("ranks", [run])
    assert len(ranks) == (2 if flags[0] == "--n-devices" else 1)
    for r in ranks:
        assert r["steps"] == 2 and r["last_loss"] == run["last_loss"]


def test_rank_0_alone_writes_checkpoints(dp_cls_run):
    """Of the two ranks, rank 0 alone saves (one checkpoint an epoch) and
    logs; the files it wrote serve."""
    tmp, run = dp_cls_run
    assert [r["checkpoints"] for r in run["ranks"]] == [1, 0]
    directory = tmp / "ck" / "pointnet"
    assert (directory / "current.pt").exists()
    records = (tmp / "log" / "cls_pointnet.jsonl").read_text().splitlines()
    assert len(records) == 1
    served = Predictor.from_checkpoint(directory, "pointnet",
                                       which="current", batch_size=B,
                                       device="cpu")
    clouds, _, labels = SyntheticModelNet(n_points=N, size=64,
                                          seed=0).batch(0, 64)
    oa = 100.0 * (served.predict(clouds) == labels).mean()
    assert oa == run["test_oa"][0]


@pytest.mark.parametrize("flags", [
    ["--model", "kpconv"], ["--model", "kpconv_deform"],
    ["--kp-buckets", "1"], ["--kp-cap-quantile", "0.5"],
    ["--deform-lr-factor", "0.1"]], ids=" ".join)
def test_kpconv_flags_are_taken(flags):
    """KPConv's model names and flags pass the refusal (they exited
    naming their ROADMAP item before KPConv was ported)."""
    args = train_cls.parse_args(["--device", "cpu", *flags])
    common.refuse_unported(args)
    assert vars(args)[flags[0][2:].replace("-", "_")] == (
        flags[1] if flags[0] == "--model" else float(flags[1]))


class _Offsets(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.w = torch.nn.Parameter(torch.randn(3, 4, generator=g))
        self.offset_bias = torch.nn.Parameter(torch.randn(5, generator=g))


@pytest.mark.parametrize("factor", [0.0, 0.5])
def test_kpconv_recipe_matches_optax(factor):
    """The KPConv recipe (``train.kpconv_optimizer`` and the step's
    clip) against the JAX CLI's chain: ``clip_by_global_norm(100)``, SGD
    at ``exponential_decay(1e-2, steps an epoch, 0.1^(1/100),
    staircase)`` with momentum 0.98, the offsets' updates scaled by the
    factor; five steps over three epochs of 2 steps, the first gradient
    above the clip norm. At factor 0 the offsets stay where they were."""
    model = _Offsets()
    opt, set_lr = kpconv_optimizer(model, 2, factor)
    params = {k: jnp.asarray(p.detach().numpy())
              for k, p in model.named_parameters()}
    sched = optax.exponential_decay(1e-2, transition_steps=2,
                                    decay_rate=0.1 ** (1 / 100),
                                    staircase=True)
    tx = optax.chain(
        optax.chain(optax.clip_by_global_norm(100.0),
                    optax.sgd(sched, momentum=0.98)),
        optax.masked(optax.scale(factor),
                     {"w": False, "offset_bias": True}))
    state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(1)
    for step in range(5):
        grads = {k: rng.standard_normal(p.shape).astype(np.float32)
                 * (60.0 if step == 0 else 0.5) for k, p in params.items()}
        updates, state = update({k: jnp.asarray(g)
                                 for k, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        set_lr(step)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        norm = clip_grad_global_norm(model.parameters(), KPCONV_CLIP_NORM)
        assert (float(norm) > 100.0) == (step == 0)
        opt.step()
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {step}")
    if factor == 0.0:
        assert torch.equal(model.offset_bias, _Offsets().offset_bias)


def test_train_cls_kpconv_deform_on_the_cpu(tmp_path, capsys):
    """``--model kpconv_deform`` at full width on the CPU: the pyramid
    calibrated into two occupancy buckets, one epoch of potential-sampled
    clouds at the buckets' shapes, the offsets unchanged at the default
    ``--deform-lr-factor 0`` while every other parameter moved, the
    voxel overflow and the sampler's potentials in the epoch's line; then
    ``--eval --votes 2`` through ``evaluate_voting_kpconv`` and
    ``Predictor.from_checkpoint`` at the uncalibrated shapes."""
    argv = ["--model", "kpconv_deform", "--synthetic", "--synthetic-size",
            "32", "--batch_size", str(2 * B), "--num_points", str(N),
            "--steps-per-epoch", "2", "--device", "cpu", "--checkpoint-dir",
            str(tmp_path / "ck")]
    run = train_cls.main(argv + ["--epochs", "1"])
    out = capsys.readouterr().out
    assert run["epochs"] == [0] and 1 <= run["steps"] <= 2
    assert sum(run["steps_by_bucket"].values()) == run["steps"]
    assert len(run["calibration"]["buckets"]) == 2
    assert "kpconv calibration (32 clouds, 2 buckets)" in out
    assert "potentials=[" in out and 0 in run["voxel_overflow"]
    assert ("VOXEL-OVERFLOW" in out) == (run["voxel_overflow"][0] > 0)
    init = common.seeded_model(lambda: get_cls_model(
        "kpconv_deform", **{k: run["calibration"][k] for k in
                            ("caps", "neighborhood_limits")}), 0)
    trained = get_cls_model("kpconv_deform")
    CheckpointManager(tmp_path / "ck" / "kpconv_deform").restore_variables(
        trained, name="current")
    before = dict(init.named_parameters())
    offsets = moved = 0
    for k, p in trained.named_parameters():
        if "offset" in k:
            offsets += 1
            assert torch.equal(p, before[k]), k
        else:
            moved += not torch.equal(p, before[k])
    assert offsets == 10 and moved == len(before) - offsets
    voted = train_cls.main(argv + ["--eval", "--votes", "2"])
    assert voted["votes"] == 2 and 0 <= voted["eval_oa"] <= 100
    assert voted["calibration"] == run["calibration"]
    clouds = SyntheticModelNet(n_points=N, size=B, seed=0).batch(0, B)[0]
    served = Predictor.from_checkpoint(
        tmp_path / "ck" / "kpconv_deform", "kpconv_deform", which="current",
        batch_size=B, device="cpu").predict_proba(clouds)
    [padded] = _pad_points([clouds], N)  # the served bucket, 128 points
    with torch.no_grad():
        want = torch.softmax(trained.eval()(torch.from_numpy(padded)), -1)
    np.testing.assert_allclose(served, want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cli", [train_cls, train_partseg])
def test_no_card_raises_without_device_cpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "--checkpoint-dir", str(tmp_path)])
    assert not (tmp_path / "pointnet2").exists()
