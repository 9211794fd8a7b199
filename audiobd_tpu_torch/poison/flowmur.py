"""FlowMur: a gradient-optimized universal waveform trigger (port of
audiobd_tpu/poison/flowmur.py).

Pipeline (reference utils/flowmur_generate_trigger.py + flowmur.py:42-127):
  1. surrogates: ``surrogate_runs`` SmallCNNs trained on the clean MFCCs,
     80/20 split (random_state 35), Adam 1e-4, patience 20 on the
     validation loss (train/ensemble.py, one member after another); the
     last member's best state is the surrogate;
  2. trigger search: Adam on a 0.5 s waveform trigger initialized at 0.1,
     placed at a random position in each host clip with an SNR-scaled
     blend, clipped to [-1, 1], driven through the plain differentiable
     MFCC (dsp.mfcc_features: the MFCC kernel has no backward, and the JAX
     package also takes its XLA path for this gradient) into the frozen
     eval-mode surrogate toward the target class, clamped to
     ±``flowmur_clamp`` after each step. ``flowmur_update`` "per_batch"
     steps on each batch's own gradient; "accumulated" (the reference's
     rule) steps every batch on the prefix sum of the epoch's gradients;
  3. poisoning: a ``poisoning_rate`` fraction of the target-class train
     rows get the trigger at ``snr_db``, and the indicator marks ALL
     target-class rows (quirk 6b.6, reference flowmur.py:88-89); the test
     split drops the target class and the rest get (wav + trigger) / 2.
     Only the injected rows' MFCCs are recomputed (kernel A on the card).

Random streams: permutations and poison draws come from the reference's
``np_rng`` names, so they match it exactly; the search's positions come
from ``torch_generator(seed, "flowmur_positions" + suffix)``, since JAX's
threefry has no torch twin.

On the card the surrogate's block 1 is the fused op, so each search step's
backward launches kernel C alone: the surrogate's parameters are frozen.

Under a profiler session a search records its spans (utils/profiling.py):
``search_call`` (``upload``; a ``search_epoch`` an epoch with ``plan``, a
``search_step`` a batch and ``summary``; ``result``), each ``search_step``
with ``deploy``, ``mfcc``, ``surrogate``, ``backward`` and ``adam``.
"""

from __future__ import annotations

import contextlib
import copy
import os
import shutil
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from audiobd_tpu_torch.configs import AttackConfig, linear_features_for
from audiobd_tpu_torch.data.speech_commands import CleanData, batched_mfcc_device, mfcc_params, split_indices
from audiobd_tpu_torch.dsp import MFCCParams, mfcc_features
from audiobd_tpu_torch.models import build_model
from audiobd_tpu_torch.parallel.distributed import main_rank_only, world_size
from audiobd_tpu_torch.parallel.mesh import shard_replicated
from audiobd_tpu_torch.poison.badnets import save_bd_arrays
from audiobd_tpu_torch.poison.device_prep import scatter_rows
from audiobd_tpu_torch.train.checkpoint import save_checkpoint
from audiobd_tpu_torch.train.ensemble import MemberResult, train_member
from audiobd_tpu_torch.train.loop import ArraySet
from audiobd_tpu_torch.train.scan_epoch import DeviceDataset
from audiobd_tpu_torch.train.state import Adam
from audiobd_tpu_torch.train.trainer import resolve_fused_conv, sha256_hex, train_attack
from audiobd_tpu_torch.utils import random as rnd
from audiobd_tpu_torch.utils.device import rank_label, resolve_device
from audiobd_tpu_torch.utils.logging import save_npy
from audiobd_tpu_torch.utils.profiling import span, to_device, to_host

SURROGATE_LR = 1e-4  # reference utils/flowmur_generate_trigger.py:27
SURROGATE_PATIENCE = 20


def _on_device(dev: torch.Tensor | None, host: np.ndarray, device: torch.device) -> torch.Tensor:
    return dev.to(device) if dev is not None else torch.from_numpy(np.asarray(host)).to(device)


# ---------------------------------------------------------------------------
# 1. Surrogates


def surrogate_datasets(cfg: AttackConfig, clean: CleanData, device: torch.device) -> tuple[DeviceDataset, ...]:
    """(train, validation): the 80/20 split of the clean train MFCCs
    (reference utils/flowmur_generate_trigger.py:20, random_state 35)."""
    feats = _on_device(clean.train_mfcc_dev, clean.train_mfcc, device)
    return tuple(
        DeviceDataset(ArraySet(feats[torch.from_numpy(idx).to(device)], clean.train_label[idx]), device)
        for idx in split_indices(len(clean.train_label))
    )


def build_surrogate(cfg: AttackConfig, run: int, device: torch.device) -> nn.Module:
    """Member ``run``: SmallCNN from ``torch_generator(seed,
    f"surrogate_{run}")``, dropout from ``f"surrogate_{run}_dropout"``; block
    1 fused as the victim's is (``--fused_conv_block``)."""
    return build_model("smallcnn", cfg.num_classes, linear_features_for("flowmur", "smallcnn"), device,
                       cfg.train.seed, fused=resolve_fused_conv(cfg, device), init_stream=f"surrogate_{run}",
                       dropout_stream=f"surrogate_{run}_dropout")


def pretrain_surrogate(
    cfg: AttackConfig,
    clean: CleanData,
    runs: int | None = None,
    max_epochs: int | None = None,
    verbose: bool = True,
) -> tuple[nn.Module, list[MemberResult]]:
    """Train ``runs`` surrogate SmallCNNs (``build_surrogate``) on the clean
    MFCCs, member ``run`` shuffled by ``np_rng(seed,
    f"surrogate_shuffle_{run}")``; save each best state under
    ``poisoning_record/surrogate_{run}``. Returns the last member with its
    best state, and every member's result."""
    device = resolve_device(cfg.device)
    runs = runs or cfg.surrogate_runs
    max_epochs = max_epochs or cfg.surrogate_epochs
    train_set, val_set = surrogate_datasets(cfg, clean, device)
    members = [build_surrogate(cfg, run, device) for run in range(runs)]
    results = [
        train_member(m, train_set, val_set, rnd.np_rng(cfg.train.seed, f"surrogate_shuffle_{run}"),
                     lr=SURROGATE_LR, batch_size=cfg.train.batch_size, max_epochs=max_epochs,
                     patience=SURROGATE_PATIENCE, verbose=verbose, label=f"member {run}")
        for run, m in enumerate(members)
    ]
    spec = {"attack": "flowmur", "model": "smallcnn", "num_classes": cfg.num_classes,
            "feature_size": linear_features_for("flowmur", "smallcnn"), "n_mfcc": cfg.dsp.n_mfcc}
    for run, res in enumerate(results):
        save_checkpoint(os.path.join(cfg.record_dir, "poisoning_record", f"surrogate_{run}"), res.state, spec)
    if verbose:
        print(f"surrogates: best epochs {[r.epochs_to_best for r in results]}")
    model = members[-1]
    model.load_state_dict(results[-1].state)
    return model, results


# ---------------------------------------------------------------------------
# 2. Trigger search


def place(trigger: torch.Tensor, positions: torch.Tensor, total_len: int) -> torch.Tensor:
    """(B, total_len): the trigger (L,) at each of ``positions`` (B,), zeros
    elsewhere; differentiable in the trigger."""
    idx = positions[:, None] + torch.arange(trigger.shape[-1], device=positions.device)
    out = torch.zeros((positions.shape[0], total_len), dtype=trigger.dtype, device=trigger.device)
    return out.scatter(1, idx, trigger.expand(positions.shape[0], -1))


def deploy_trigger(wavs: torch.Tensor, trigger: torch.Tensor, positions: torch.Tensor,
                   snr_db: float = 30.0) -> torch.Tensor:
    """SNR-blended random-position injection (reference
    deploy_trigger_to_waveform, utils/flowmur_generate_trigger.py:49-62):
        out = (scale·wav + placed_trigger) / (scale + 1),
        scale = 10^(snr/20) · ‖trigger‖ / ‖wav‖   (per clip).
    wavs (B, T), trigger (L,), positions (B,) ints."""
    wav_rms = torch.linalg.vector_norm(wavs, dim=-1, keepdim=True)
    trig_rms = torch.linalg.vector_norm(trigger)
    scale = (10.0 ** (snr_db / 20.0)) * trig_rms / torch.clamp(wav_rms, min=1e-12)
    placed = place(trigger, positions, wavs.shape[-1])
    return (scale * wavs + placed) / (scale + 1.0)


def trigger_loss(surrogate: nn.Module, trigger: torch.Tensor, wavs: torch.Tensor, positions: torch.Tensor,
                 params: MFCCParams, target: int, snr_db: float) -> torch.Tensor:
    """Mean cross-entropy toward ``target`` of the surrogate on the clips
    with the trigger deployed: deploy → clip to [-1, 1] → MFCC → logits."""
    with span("deploy"):
        mixed = torch.clamp(deploy_trigger(wavs, trigger, positions, snr_db), -1.0, 1.0)
    with span("mfcc"):
        feats = mfcc_features(mixed, params)
    with span("surrogate"):
        logits = surrogate(feats)
        labels = torch.full((wavs.shape[0],), target, dtype=torch.int64, device=wavs.device)
        return F.cross_entropy(logits.float(), labels)


def trigger_step(surrogate: nn.Module, opt: Adam, wavs: torch.Tensor, positions: torch.Tensor,
                 params: MFCCParams, cfg: AttackConfig, grad_sum: torch.Tensor | None = None) -> torch.Tensor:
    """One batch of the search on ``opt``'s one parameter, the trigger:
    loss, gradient, Adam step (optax's formula), clamp. With ``grad_sum``
    (the accumulated rule) the gradient is added to it in place and the step
    takes the sum. Returns the loss, detached."""
    trigger = opt.params[0]
    loss = trigger_loss(surrogate, trigger, wavs, positions, params, cfg.target_label, cfg.snr_db)
    with span("backward"):
        (grad,) = torch.autograd.grad(loss, trigger)
    with span("adam"):
        if grad_sum is not None:
            grad = grad_sum.add_(grad)
        opt.step([grad])
        with torch.no_grad():
            trigger.clamp_(-cfg.flowmur_clamp, cfg.flowmur_clamp)
    return loss.detach()


def trigger_batches(np_rng: np.random.Generator, n: int, batch_size: int) -> np.ndarray:
    """(n_batches, batch_size) host indices of one search epoch: one
    permutation, the remainder dropped (reference flowmur.py run_epoch)."""
    n_batches = max(n // batch_size, 1)
    return np_rng.permutation(n)[: n_batches * batch_size].reshape(n_batches, batch_size)


@contextlib.contextmanager
def _frozen(model: nn.Module):
    """Eval mode with every parameter's requires_grad off; both restored after."""
    mode, flags = model.training, [p.requires_grad for p in model.parameters()]
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    try:
        yield
    finally:
        model.train(mode)
        for p, flag in zip(model.parameters(), flags):
            p.requires_grad_(flag)


def optimize_trigger(
    cfg: AttackConfig,
    surrogate: nn.Module,
    waveforms: np.ndarray,  # (N, 1, T): host clips, driven toward the target
    epochs: int | None = None,
    batch_size: int | None = None,
    verbose: bool = True,
    save_snapshots: bool = True,
    loss_history: list | None = None,
    restart: int = 0,
) -> np.ndarray:
    """The trigger (1, L) after ``epochs`` search epochs over the hosts;
    ``loss_history`` gets each epoch's summed loss. ``restart`` > 0 draws
    from streams of its own (suffix ``_r<restart>``), and its snapshots
    ``sp_trigger<epoch>.npy`` (every 100 epochs) carry the suffix.

    Under a group of ranks every rank searches apart (its surrogate may
    differ from rank 0's in last bits: cuDNN's default algorithms), and the
    trigger returned is rank 0's, broadcast, so a run poisons with one
    trigger, the one rank 0's snapshots record. Each rank prints the sha256
    of its own search's trigger and of the one it returns."""
    if cfg.flowmur_update not in ("per_batch", "accumulated"):
        raise ValueError(f"flowmur_update must be per_batch or accumulated, got {cfg.flowmur_update!r}")
    device = resolve_device(cfg.device)
    epochs = epochs or cfg.flowmur_opt_epochs
    params = mfcc_params(cfg)
    length = int(cfg.trigger_duration * cfg.dsp.sample_rate)
    with span("search_call"):
        with span("upload"):
            wavs = to_device(np.ascontiguousarray(waveforms[:, 0, :], dtype=np.float32), device)
        n, t = wavs.shape
        bs = min(batch_size or cfg.train.batch_size, n)  # small host pools must not over-slice
        trigger = torch.full((length,), 0.1, dtype=torch.float32, device=device, requires_grad=True)
        opt = Adam([trigger], cfg.flowmur_opt_lr)
        accumulated = cfg.flowmur_update == "accumulated"
        suffix = "" if restart == 0 else f"_r{restart}"
        np_rng = rnd.np_rng(cfg.train.seed, "flowmur_trigger_shuffle" + suffix)
        positions_gen = rnd.torch_generator(cfg.train.seed, "flowmur_positions" + suffix, device)
        snap_dir = os.path.join(cfg.record_dir, "poisoning_record")
        with _frozen(surrogate):
            for epoch in range(1, epochs + 1):
                with span("search_epoch"):
                    with span("plan"):
                        batches = to_device(trigger_batches(np_rng, n, bs), device)
                    grad_sum = torch.zeros_like(trigger) if accumulated else None  # the sum resets each epoch
                    losses = torch.empty(batches.shape[0], dtype=torch.float32, device=device)
                    for i in range(batches.shape[0]):
                        with span("search_step"):
                            positions = torch.randint(0, t - length + 1, (bs,), generator=positions_gen,
                                                      device=device)
                            losses[i] = trigger_step(surrogate, opt, wavs[batches[i]], positions, params, cfg,
                                                     grad_sum)
                    with span("summary"):
                        loss = float(to_host(losses.sum()))
                    if loss_history is not None:
                        loss_history.append(loss)
                    if verbose and (epoch % 25 == 0 or epoch == 1):
                        print(f"flowmur trigger epoch {epoch}: summed loss {loss:.4f}")
                    if save_snapshots and epoch % 100 == 0:
                        save_npy(os.path.join(snap_dir, f"sp_trigger{epoch}{suffix}.npy"),
                                 to_host(trigger.detach())[None, :])
        with span("result"):
            found = trigger.detach().clone()
            searched = sha256_hex(to_host(found)) if world_size() > 1 else None
            shard_replicated([found])  # one trigger a run: rank 0's
            result = to_host(found)[None, :]
            if searched is not None:
                print(f"{rank_label(device)}: flowmur trigger search{suffix} sha256 {searched} on this rank, "
                      f"{sha256_hex(result)} after rank 0's broadcast", flush=True)
    return result


@main_rank_only
def _promote_snapshots(snap_dir: str, best_r: int) -> None:
    """Copy restart ``best_r``'s sp_trigger<epoch>_r<best_r>.npy snapshots to
    the canonical sp_trigger<epoch>.npy names; the per-restart files stay."""
    if not os.path.isdir(snap_dir):
        return
    tag = f"_r{best_r}.npy"
    for fname in sorted(os.listdir(snap_dir)):
        if fname.startswith("sp_trigger") and fname.endswith(tag):
            shutil.copyfile(os.path.join(snap_dir, fname), os.path.join(snap_dir, fname[: -len(tag)] + ".npy"))


def select_trigger(cfg: AttackConfig, surrogate: nn.Module, hosts: np.ndarray, clean: CleanData,
                   verbose: bool = True, save_snapshots: bool = True,
                   loss_history: list | None = None) -> np.ndarray:
    """``cfg.flowmur_restarts`` searches, each candidate ranked by the best
    ASR of a ``flowmur_probe_epochs``-epoch probe victim (not in the
    reference; audiobd_tpu/poison/flowmur.py:309-355). One restart is the
    reference's single search."""
    k = int(cfg.flowmur_restarts)
    if k <= 1:
        return optimize_trigger(cfg, surrogate, hosts, verbose=verbose, save_snapshots=save_snapshots,
                                loss_history=loss_history)
    pcfg = copy.deepcopy(cfg)
    pcfg.train.num_epochs = int(cfg.flowmur_probe_epochs)
    pcfg.train.patience = 10**6
    best, best_asr, best_r = None, -1.0, 0
    for r in range(k):
        trig = optimize_trigger(cfg, surrogate, hosts, verbose=verbose, save_snapshots=save_snapshots,
                                loss_history=loss_history, restart=r)
        poisoned = poison(pcfg, clean, trig, save=False)
        res = train_attack(pcfg, poisoned.bd_train, poisoned.clean_test, poisoned.bd_test,
                           verbose=False, save=False)
        probe_asr = max(res.history["test_asr"])
        if verbose:
            print(f"flowmur restart {r}: probe ASR@{pcfg.train.num_epochs}ep {probe_asr:.2f}")
        if probe_asr > best_asr:
            best, best_asr, best_r = trig, probe_asr, r
    if save_snapshots and best_r != 0:
        _promote_snapshots(os.path.join(cfg.record_dir, "poisoning_record"), best_r)
    if verbose:
        print(f"flowmur selected trigger with probe ASR {best_asr:.2f} (restart {best_r})")
    return best


# ---------------------------------------------------------------------------
# 3. Poisoning


@dataclass
class FlowmurPoisoned:
    bd_train: ArraySet
    bd_test: ArraySet
    clean_test: ArraySet
    trigger: np.ndarray
    chosen: np.ndarray           # the injected train rows
    train_positions: np.ndarray  # their trigger positions
    test_positions: np.ndarray   # the kept test rows' trigger positions


def _inject_snr(wavs: torch.Tensor, trigger: torch.Tensor, positions: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Train-set injection (reference flowmur.py:78-85), (N, 1, T) →
    (N, 1, T): wav + scale·placed(trigger), scale = sqrt(‖wav‖²/‖trig‖² ·
    10^(−snr/10)) per clip; trigger (1, L)."""
    w, trig = wavs[:, 0, :], trigger[0]
    wav_rms = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    trig_rms = torch.linalg.vector_norm(trig)
    scale = torch.sqrt((wav_rms**2) / (trig_rms**2) * (10.0 ** (-snr_db / 10.0)))
    return (w + scale * place(trig, positions, w.shape[-1]))[:, None, :]


def _inject_half(wavs: torch.Tensor, trigger: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Test-set injection (reference flowmur.py:101-106): (wav + placed(trigger)) / 2."""
    w = wavs[:, 0, :]
    return ((w + place(trigger[0], positions, w.shape[-1])) / 2.0)[:, None, :]


def poison(cfg: AttackConfig, clean: CleanData, trigger: np.ndarray, save: bool = True) -> FlowmurPoisoned:
    device = resolve_device(cfg.device)
    params = mfcc_params(cfg)
    t = clean.train_wav.shape[-1]
    length = trigger.shape[-1]
    trig = torch.from_numpy(np.asarray(trigger, np.float32)).to(device)
    rng = rnd.np_rng(cfg.train.seed, "flowmur_poison")

    target_rows = np.flatnonzero(clean.train_label == cfg.target_label)
    poison_num = int(len(target_rows) * cfg.poisoning_rate)
    chosen = rng.choice(target_rows, size=poison_num, replace=False)
    bd_train_wav = clean.train_wav.copy()
    train_feats = _on_device(clean.train_mfcc_dev, clean.train_mfcc, device)
    train_pos = np.zeros(0, dtype=np.int64)
    if poison_num:
        train_pos = rng.integers(0, t - length + 1, size=poison_num)
        injected = _inject_snr(torch.from_numpy(bd_train_wav[chosen]).to(device), trig,
                               torch.from_numpy(train_pos).to(device), cfg.snr_db)
        bd_train_wav[chosen] = injected.cpu().numpy()
        sub_feats = batched_mfcc_device(injected, params, device)
        train_feats = scatter_rows(train_feats, sub_feats, torch.from_numpy(chosen).to(device))
    ind_train = (clean.train_label == cfg.target_label).astype(np.int64)  # quirk 6b.6: every target row

    keep = clean.test_label != cfg.target_label
    test_pos = rng.integers(0, t - length + 1, size=int(keep.sum()))
    bd_test_wav = _inject_half(torch.from_numpy(clean.test_wav[keep]).to(device), trig,
                               torch.from_numpy(test_pos).to(device))
    bd_test_feats = batched_mfcc_device(bd_test_wav, params, device)
    bd_test_label = np.full(len(test_pos), cfg.target_label, dtype=np.int64)
    ind_test = np.ones(len(test_pos), dtype=np.int64)

    if save:
        save_bd_arrays(
            cfg,
            bd_train_wav=bd_train_wav,
            bd_train_mfcc=train_feats.cpu().numpy(),
            bd_train_label=clean.train_label,
            poison_index_train=ind_train,
            bd_test_wav=bd_test_wav.cpu().numpy(),
            bd_test_mfcc=bd_test_feats.cpu().numpy(),
            bd_test_label=bd_test_label,
            poison_index_test=ind_test,
        )
    return FlowmurPoisoned(
        bd_train=ArraySet(train_feats, clean.train_label, ind_train),
        bd_test=ArraySet(bd_test_feats, bd_test_label, ind_test),
        clean_test=ArraySet(_on_device(clean.test_mfcc_dev, clean.test_mfcc, device), clean.test_label),
        trigger=trigger,
        chosen=chosen,
        train_positions=train_pos,
        test_positions=test_pos,
    )


def select_trigger_hosts(cfg: AttackConfig, clean: CleanData, n_hosts: int = 5000) -> np.ndarray:
    """The ``n_hosts`` random rows of the 80% train split that the search
    runs on (reference flowmur.py:58-61)."""
    tr_wav = clean.train_wav[split_indices(len(clean.train_label))[0]]
    rng = rnd.np_rng(cfg.train.seed, "flowmur_hosts")
    return tr_wav[rng.choice(len(tr_wav), size=min(n_hosts, len(tr_wav)), replace=False)]
