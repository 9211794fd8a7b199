"""The attack-training orchestrator, single device (port of
audiobd_tpu/train/trainer.py:91-392).

Build the model and its optimizer (``make_optimizer``: optax's adam, or sgd
with momentum), keep every split on the device, run epochs with early
stopping on ``0.5*(clean_test_loss + bd_test_loss)`` (reference
badnets.py:156; model selection deliberately uses the attacked test set,
SURVEY §6b.10), write the best state's checkpoint each time the monitored
loss improves, then the loss/acc CSVs and the curve PNGs. ``resume`` picks
up the model, the optimizer's state and the step from that checkpoint;
``profile_dir`` traces epochs 1-2. ``train_clean`` is the reference's plain
supervised loop with val-loss early stopping, on the same epoch engine.

Under a group of more than one rank (``torchrun``; parallel/distributed.py)
``train_attack`` trains data-parallel (reference trainer.py:207-250) on the
same epoch engine, each rank on its shard of every split, BatchNorm synced
over the mesh's data axis; every rank
runs the same epochs and stops at the same one, and rank 0 alone writes
the checkpoint, CSVs and PNGs and prints the epoch lines; every rank writes
its own trace.
``train_clean`` stays single-device work, each rank running it whole.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from audiobd_tpu_torch.configs import AttackConfig, linear_features_for
from audiobd_tpu_torch.data.speech_commands import mfcc_params
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.ops import launches
from audiobd_tpu_torch.parallel.distributed import agreed, is_main, world_size
from audiobd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_replicated
from audiobd_tpu_torch.train.checkpoint import checkpoint_dir, load_checkpoint, load_train_state, save_checkpoint
from audiobd_tpu_torch.train.loop import ArraySet, EarlyStopping
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_eval_epoch, run_train_epoch
from audiobd_tpu_torch.train.state import SGD, Adam
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.device import rank_label, resolve_device
from audiobd_tpu_torch.utils.logging import save_attack_csvs
from audiobd_tpu_torch.utils.profiling import span, trace


@dataclass
class TrainResult:
    history: dict[str, list] = field(default_factory=dict)
    model: Any = None
    optimizer: Any = None  # train/state.py's Adam or SGD, as the run left it
    step: int = 0  # train steps taken, counting those of a resumed checkpoint
    epochs_ran: int = 0
    clips_per_sec: float = 0.0
    # The wall of each best-state checkpoint write, seconds.
    checkpoint_walls: list[float] = field(default_factory=list)


def resolve_fused_conv(cfg: AttackConfig, device: torch.device) -> bool:
    """'auto' → the kernel-backward first block on CUDA in a world of one
    rank only (reference trainer.py:50-58)."""
    mode = cfg.train.fused_conv_block
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"fused_conv_block must be auto, on or off, got {mode!r}")
    return mode == "on" or (mode == "auto" and device.type == "cuda" and world_size() == 1)


def resolve_fused_block2(cfg: AttackConfig, field: str = "fused_block2") -> bool:
    """'on' → the kernel-backward second (or third, ``field="fused_block3"``)
    block in a world of one rank; 'auto' and 'off' → off, as the reference
    (trainer.py:68-76) keeps it until measurements say otherwise."""
    mode = getattr(cfg.train, field)
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"{field} must be auto, on or off, got {mode!r}")
    return mode == "on" and world_size() == 1


def resolve_compute_dtype(cfg: AttackConfig) -> torch.dtype:
    """TrainConfig.compute_dtype → the models' torch dtype (the reference's
    trainer.py:81: bf16 activations and matmuls, f32 parameters, BN
    statistics and loss)."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.train.compute_dtype not in dtypes:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {cfg.train.compute_dtype!r}")
    return dtypes[cfg.train.compute_dtype]


def build_attack_model(cfg: AttackConfig, device: torch.device, **streams: str):
    """The attack's model; ``streams`` may name its ``init_stream`` and
    ``dropout_stream`` (models.build_model)."""
    return build_model(
        cfg.model, cfg.num_classes, linear_features_for(cfg.name, cfg.model), device,
        cfg.train.seed, n_mfcc=mfcc_params(cfg).n_out, fused=resolve_fused_conv(cfg, device),
        fused_block2=resolve_fused_block2(cfg), fused_block3=resolve_fused_block2(cfg, "fused_block3"),
        compute_dtype=resolve_compute_dtype(cfg), **streams,
    )


def make_optimizer(cfg: AttackConfig, params):
    """optax.adam(lr), or optax.sgd(lr, momentum=0.9) for "sgd_momentum", in
    the formulas of train/state.py (reference trainer.py:91-96)."""
    if cfg.train.optimizer == "adam":
        return Adam(params, cfg.train.learning_rate)
    if cfg.train.optimizer == "sgd_momentum":
        return SGD(params, cfg.train.learning_rate, momentum=0.9)
    raise ValueError(cfg.train.optimizer)


def snapshot(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A copy of the model's state_dict, on its device."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def train_clean(
    cfg: AttackConfig,
    train_set: ArraySet,
    val_set: ArraySet,
    model=None,
    max_epochs: int | None = None,
    patience: int | None = None,
    verbose: bool = True,
):
    """Plain supervised training with val-loss early stopping (reference
    trainer.py:99-140; the PyTorch reference's clean_train/clean_test loop,
    utils/training_tools.py:136-180), on ``cfg.device``. Without ``model``
    one is built with weights from ``torch_generator(seed, "clean_params")``
    and dropout from ``"clean_dropout"``; a torch ``model`` given is trained
    from the weights it holds. Shuffles from ``np_rng(seed,
    "clean_shuffle")``. Returns (model, the best epoch's state_dict,
    history)."""
    device = resolve_device(cfg.device)
    if model is None:
        model = build_attack_model(cfg, device, init_stream="clean_params", dropout_stream="clean_dropout")
    opt = make_optimizer(cfg, model.parameters())
    d_train, d_val = DeviceDataset(train_set, device), DeviceDataset(val_set, device)
    best: dict[str, torch.Tensor] = {}
    stopper = EarlyStopping(patience or cfg.train.patience, save_fn=lambda: best.update(snapshot(model)),
                            verbose=False)
    np_rng = rnd.np_rng(cfg.train.seed, "clean_shuffle")
    history: dict[str, list] = {"train_loss": [], "train_acc": [], "val_loss": [], "val_acc": []}
    for epoch in range(1, (max_epochs or cfg.train.num_epochs) + 1):
        tr = run_train_epoch(model, opt, d_train, cfg.train.batch_size, np_rng)
        ev = run_eval_epoch(model, d_val, cfg.train.batch_size)
        history["train_loss"].append(tr["loss"])
        history["train_acc"].append(tr["mix_acc"])
        history["val_loss"].append(ev["loss"])
        history["val_acc"].append(ev["acc"])
        if verbose:
            print(f"Epoch {epoch}: Train loss: {tr['loss']:.4f}, "
                  f"Train acc: {tr['mix_acc']:.4f}, Val acc: {ev['acc']:.4f}")
        if stopper(ev["loss"]):
            break
    return model, best or snapshot(model), history


def train_attack(
    cfg: AttackConfig,
    bd_train: ArraySet,
    clean_test: ArraySet,
    bd_test: ArraySet,
    verbose: bool = True,
    save: bool = True,
    resume: bool = False,
    profile_dir: str | None = None,
) -> TrainResult:
    device = resolve_device(cfg.device)
    mesh = make_mesh(cfg.mesh.data, cfg.mesh.model)
    sharded = mesh.size > 1
    if sharded:
        _check_shardable(mesh, cfg.train.batch_size, bd_train, clean_test, bd_test)
    # Each data shard draws its own dropout masks (the reference folds the
    # shard's index into the step key); shard 0 keeps the one-rank stream.
    model = build_attack_model(cfg, device, **({"dropout_stream": f"dropout_{mesh.data_index}"}
                                               if mesh.data_index else {}))
    if sharded:
        model.sync_batchnorm(mesh.data_group)
    opt = make_optimizer(cfg, model.parameters())
    record_dir = cfg.record_dir
    main = is_main()
    verbose = verbose and main
    step = 0  # train steps taken; the checkpoint saves it beside the optimizer's state
    if resume and agreed(os.path.exists(checkpoint_dir(record_dir)), checkpoint_dir(record_dir)):
        # Restart from the last best checkpoint: the model, the optimizer's
        # state and the step. The epoch loop, the early stopper and the
        # shuffle and dropout streams start afresh, as in the reference
        # (trainer.py:177-197); no checkpoint means a cold start.
        train_state = load_train_state(record_dir)
        model.load_state_dict(load_checkpoint(record_dir)[0])
        opt.load_state_dict(train_state["optimizer"])
        step = train_state["step"]
        if verbose:
            print(f"resumed from step {step}")
    if sharded:
        # Every rank starts from rank 0's state (reference shard_replicated),
        # the step and Adam's count included.
        counts = torch.tensor([step, getattr(opt, "count", 0)])
        shard_replicated([*model.state_dict().values(), *_optimizer_tensors(opt), counts])
        step = int(counts[0])
        if hasattr(opt, "count"):
            opt.count = int(counts[1])
    d_train, d_clean, d_bd = (DeviceDataset(s, device, mesh) for s in (bd_train, clean_test, bd_test))
    steps_per_epoch = d_train.n_batches(cfg.train.batch_size)

    model_spec = {
        "attack": cfg.name,
        "model": cfg.model,
        "num_classes": cfg.num_classes,
        "feature_size": linear_features_for(cfg.name, cfg.model),
        "n_mfcc": mfcc_params(cfg).n_out,
        "dataset": cfg.dataset,
        "batch_size": cfg.train.batch_size,
    }
    checkpoint_walls: list[float] = []

    def save_best():
        # Written at each improvement, so a killed run leaves its last best
        # state on disk.
        t0 = time.perf_counter()
        save_checkpoint(record_dir, model.state_dict(), model_spec, opt.state_dict(), step)
        checkpoint_walls.append(time.perf_counter() - t0)

    stopper = EarlyStopping(cfg.train.patience, save_fn=save_best if save else None, verbose=verbose)
    np_rng = rnd.np_rng(cfg.train.seed, "shuffle")
    history: dict[str, list] = {
        k: []
        for k in (
            "train_loss", "train_mix_acc", "train_asr",
            "test_clean_loss", "test_bd_loss", "test_clean_acc", "test_asr",
        )
    }

    n_clips = 0
    epochs_ran = 0
    t_start = time.perf_counter()
    with contextlib.ExitStack() as profiler:
        if profile_dir:
            profiler.enter_context(trace(profile_dir, device))
        for epoch in range(1, cfg.train.num_epochs + 1):
            with span("epoch"):
                tr = run_train_epoch(model, opt, d_train, cfg.train.batch_size, np_rng)
                ev_clean = run_eval_epoch(model, d_clean, cfg.train.batch_size)
                ev_bd = run_eval_epoch(model, d_bd, cfg.train.batch_size)
            if epoch >= 2:
                profiler.close()  # two epochs of trace, as the reference
            step += steps_per_epoch
            n_clips += len(d_train)
            epochs_ran = epoch

            history["train_loss"].append(tr["loss"])
            history["train_mix_acc"].append(tr["mix_acc"])
            history["train_asr"].append(tr["asr"])
            history["test_clean_loss"].append(ev_clean["loss"])
            history["test_bd_loss"].append(ev_bd["loss"])
            history["test_clean_acc"].append(ev_clean["acc"])
            history["test_asr"].append(ev_bd["asr"])

            monitored = 0.5 * (ev_clean["loss"] + ev_bd["loss"])
            if verbose:
                print(
                    f"Epoch {epoch}: Train loss: {tr['loss']:.4f}, Train asr: {tr['asr']:.4f}, "
                    f"Clean acc: {ev_clean['acc']:.4f}, ASR: {ev_bd['asr']:.4f}"
                )
            if stopper(monitored):
                if verbose:
                    print("Early stopping")
                break
    wall = time.perf_counter() - t_start
    if sharded:
        print(f"{rank_label(device)}: {replica_line(model, bd_train)}", flush=True)

    if save:
        save_attack_csvs(record_dir, history)
        _plot_curves(record_dir, history)
    return TrainResult(
        history=history, model=model, optimizer=opt, step=step, epochs_ran=epochs_ran,
        clips_per_sec=n_clips / max(wall, 1e-9), checkpoint_walls=checkpoint_walls,
    )


def _check_shardable(mesh: Mesh, batch_size: int, *splits: ArraySet) -> None:
    """The conditions of sharding every split over the data axis; where the
    reference would fall back to its per-batch path (trainer.py:216-220),
    this raises."""
    n_data = mesh.shape["data"]
    if batch_size % n_data:
        raise ValueError(f"batch size {batch_size} does not split over {n_data} data shards")
    if min(len(s) for s in splits) < n_data:
        raise ValueError(f"a split of {min(len(s) for s in splits)} rows cannot give each of "
                         f"{n_data} data shards a row")


def _optimizer_tensors(opt) -> list[torch.Tensor]:
    """The tensors of the optimizer's state (Adam's mu and nu, SGD's trace)."""
    return [t for v in opt.state_dict().values() if isinstance(v, list) for t in v]


def sha256_hex(*arrays) -> str:
    """The sha256 of the arrays' bytes, one after another (tensors read back
    to the host; None skipped)."""
    digest = hashlib.sha256()
    for a in arrays:
        if a is None:
            continue
        a = a.detach().cpu().contiguous().numpy() if isinstance(a, torch.Tensor) else np.ascontiguousarray(a)
        digest.update(a.tobytes())
    return digest.hexdigest()


def replica_line(model: torch.nn.Module, bd_train: ArraySet) -> str:
    """A digest of the model's parameters and buffers, this process's kernel
    launches, and a digest of the split it trained on (``bd_train``'s
    features, labels and indicators): equal digests across ranks mean equal
    replicas trained on one poisoned split."""
    digest = hashlib.sha256()
    for name, t in model.state_dict().items():
        digest.update(name.encode())
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return (f"parameters sha256 {digest.hexdigest()}; kernel launches {json.dumps(launches())}; "
            f"bd_train sha256 {sha256_hex(bd_train.feats, bd_train.labels, bd_train.indicators)}")


def _plot_curves(record_dir: str, history: dict[str, list]) -> None:
    """loss.png and "acc-like metrics.png" (reference trainer.py:375-391):
    optional artefacts of a finished run. Where matplotlib is missing or
    fails, the run says so and ends as it would have."""
    from audiobd_tpu_torch.utils.visual import plot_loss, plot_metrics

    try:
        plot_loss(
            history["train_loss"], history["test_clean_loss"], history["test_bd_loss"],
            os.path.join(record_dir, "loss.png"),
        )
        plot_metrics(
            history["train_mix_acc"], history["train_asr"], history["test_clean_acc"], history["test_asr"],
            os.path.join(record_dir, "acc-like metrics.png"),
        )
    except Exception as e:  # as the reference: no plot failure ends a trained run
        print(f"plotting skipped: {e}")
