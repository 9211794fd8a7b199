"""Typed, YAML-loadable, CLI-overridable configuration.

An own copy of the reference's config tree (audiobd_tpu/configs.py:47-356),
trimmed to the fields the five ported attacks read, plus the ``device``
the entry points run on. YAML is parsed only when ``--config`` is given
(PyYAML is imported there and nowhere else).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Any

# Label sets per dataset (reference prepare_dataset.py:88-97).
DATASET_LABELS: dict[str, list[str]] = {
    "SCDv1-10": ["yes", "no", "up", "down", "left", "right", "on", "off", "stop", "go"],
    "SCDv1-30": [
        "bed", "bird", "cat", "dog", "down", "eight", "five", "four", "go",
        "happy", "house", "left", "marvin", "nine", "no", "off", "on", "one",
        "right", "seven", "sheila", "six", "stop", "three", "tree", "two",
        "up", "wow", "yes", "zero",
    ],
    "SCDv2-10": ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine"],
    "SCDv2-26": [
        "zero", "backward", "bed", "bird", "cat", "dog", "down", "follow",
        "forward", "go", "happy", "house", "learn", "left", "marvin", "no",
        "off", "on", "right", "sheila", "stop", "tree", "up", "visual",
        "wow", "yes",
    ],
}

# Where each dataset's wav tree lies (reference audiobd_tpu/configs.py:39-44).
DATASET_PATHS: dict[str, str] = {
    "SCDv1-10": "./data/SpeechCommands/speech_commands_v0.01",
    "SCDv1-30": "./data/SpeechCommands/speech_commands_v0.01",
    "SCDv2-10": "./data/SpeechCommands/speech_commands_v0.02",
    "SCDv2-26": "./data/speech_commands_v0.02",
}


@dataclass
class DSPConfig:
    """Audio front-end parameters (reference attack_config.txt:1-9)."""

    sample_rate: int = 16000
    n_mfcc: int = 40
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 128
    # "torchaudio": htk mel / no filterbank norm / reflect pad / amplitude_to_DB
    #   with per-clip top_db=80. "librosa": slaney mel + slaney norm /
    #   constant pad / power_to_db.
    parity: str = "torchaudio"


@dataclass
class TrainConfig:
    learning_rate: float = 1e-4
    batch_size: int = 256
    num_epochs: int = 300
    patience: int = 20
    seed: int = 35
    # "adam" or "sgd_momentum" (train/trainer.py::make_optimizer).
    optimizer: str = "adam"
    # Early stopping monitors 0.5*(clean_test_loss + bd_test_loss)
    # (reference badnets.py:156); no code reads this field, as in the reference.
    monitor: str = "mean_test_loss"
    # First SmallCNN block through ops/conv1_bn_pool (CUDA-kernel backward).
    # "auto" = on for CUDA, off elsewhere.
    fused_conv_block: str = "auto"
    # Second/third SmallCNN/SmallLSTM blocks through ops/conv2_bn_pool
    # (train mode only; CUDA-kernel backward). "auto" = off everywhere, as in
    # the reference (audiobd_tpu/configs.py:112-117); "on" turns it on.
    fused_block2: str = "auto"
    fused_block3: str = "auto"
    # "float32" (the default) or "bfloat16": bf16 activations and matmuls
    # with f32 parameters, BN statistics and loss (audiobd_tpu/configs.py:93-95).
    compute_dtype: str = "float32"


COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class MeshConfig:
    """The (data, model) grid of ranks (reference audiobd_tpu/configs.py:131-136;
    parallel/mesh.py::make_mesh)."""

    data: int = -1   # -1 = every rank not on the model axis
    model: int = 1   # ranks a data shard is replicated over


@dataclass
class AttackConfig:
    name: str = "badnets"
    model: str = "smallcnn"
    dataset: str = "SCDv1-10"
    num_classes: int = 10
    target_label: int = 2          # hardcoded torch.tensor(2) in reference
    poisoning_rate: float = 0.1
    result: str = "badnets_smallcnn"
    load_clean_data: bool = True
    trigger_size: int = 5
    # Ultrasonic (reference audiobd_tpu/configs.py:152-154).
    trigger_pos: str = "start"
    trigger_cont: bool = True
    ultra_trigger_size: int = 60   # percent of the 1 s trigger kept
    # JingleBack (reference audiobd_tpu/configs.py:155-156): the style chain 0-5.
    style: int = 0
    # DABA (reference audiobd_tpu/configs.py:157-162). ``poison_label`` is
    # read by no code (the target is ``target_label``); ``po_db`` is a dBFS
    # number, "auto" (match the host) or "keep".
    poison_label: str = "up"
    trigger_selection_mode: str = "Cer&Inf"
    variant: bool = True
    po_db: float | str = -20.0
    host_candidates: int = 3000
    # FlowMur (reference audiobd_tpu/configs.py:163-183).
    trigger_duration: float = 0.5
    snr_db: int = 30
    flowmur_opt_epochs: int = 300
    flowmur_opt_lr: float = 1e-3
    flowmur_clamp: float = 0.2
    # "per_batch": an Adam step + clamp per batch on that batch's gradient.
    # "accumulated": the reference's rule, an Adam step + clamp per batch on
    # the prefix sum of the epoch's gradients so far.
    flowmur_update: str = "per_batch"
    # Trigger searches, each ranked by a probe victim of flowmur_probe_epochs
    # epochs; 1 = the reference's single search.
    flowmur_restarts: int = 1
    flowmur_probe_epochs: int = 10
    surrogate_runs: int = 3
    surrogate_epochs: int = 1000
    # None = CUDA (raises if there is none); "cpu" or "cuda:N" to choose.
    device: str | None = None

    dsp: DSPConfig = field(default_factory=DSPConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @property
    def labels(self) -> list[str]:
        return DATASET_LABELS[self.dataset]

    @property
    def data_path(self) -> str:
        return DATASET_PATHS[self.dataset]

    @property
    def record_dir(self) -> str:
        return f"record/{self.result}"

    @property
    def features(self) -> str:
        """The input the model takes, as the model declares it
        (``models.zoo.model_features``): "mfcc", or "logmel" for AST."""
        from audiobd_tpu_torch.models.zoo import model_features

        return model_features(str(self.model))


# The reference's per-attack DSP + model-shape table (attack_config.txt:1-23;
# audiobd_tpu/configs.py:205-246).
# BadNets alone also trains AST (models/zoo.py::AST) on 128-band log-mel
# frames: its feature size is AST's input_tdim, the 128 frames it pads to.
ATTACK_PRESETS: dict[str, dict[str, Any]] = {
    "badnets": {
        "dsp": dict(sample_rate=16000, n_mfcc=40, n_fft=400, hop_length=160, parity="torchaudio"),
        "linear_features": {
            "smallcnn": 3072, "largecnn": 12288, "smalllstm": 128,
            "lstmwithattention": 101, "rnn": 40, "resnet": 384, "ast": 128,
        },
        "result": "badnets_smallcnn",
    },
    "jingleback": {
        "dsp": dict(sample_rate=16000, n_mfcc=40, n_fft=400, hop_length=160, parity="torchaudio"),
        "linear_features": {
            "smallcnn": 3072, "largecnn": 12288, "smalllstm": 128,
            "lstmwithattention": 101, "rnn": 40, "resnet": 384,
        },
        "result": "jingleback_smallcnn",
    },
    "ultrasonic": {
        "dsp": dict(sample_rate=44100, n_mfcc=40, n_fft=1103, hop_length=441, parity="torchaudio"),
        "linear_features": {
            "smallcnn": 3072, "largecnn": 12288, "smalllstm": 128,
            "lstmwithattention": 100, "rnn": 40, "resnet": 384,
        },
        "result": "ultrasonic_smallcnn",
    },
    "daba": {
        "dsp": dict(sample_rate=16000, n_mfcc=40, n_fft=2048, hop_length=512, parity="librosa"),
        "linear_features": {
            "smallcnn": 896, "largecnn": 3072, "smalllstm": 128,
            "lstmwithattention": 32, "rnn": 40, "resnet": 128,
        },
        "result": "daba_smallcnn",
    },
    "flowmur": {
        "dsp": dict(sample_rate=16000, n_mfcc=13, n_fft=2048, hop_length=512, parity="torchaudio"),
        "linear_features": {
            "smallcnn": 224, "largecnn": 768, "smalllstm": 32,
            "lstmwithattention": 32, "rnn": 13, "resnet": 64,
        },
        "result": "flowmur_smallcnn",
    },
}


def linear_features_for(attack: str, model: str) -> int:
    """Flatten/seq size the model constructor needs for this attack's shapes;
    a model missing from the attack's table is one the attack does not train."""
    table = ATTACK_PRESETS[attack]["linear_features"]
    if model.lower() not in table:
        raise ValueError(f"{attack} does not train --model {model}; it trains {', '.join(table)}")
    return table[model.lower()]


def make_config(attack: str, **overrides: Any) -> AttackConfig:
    """Build an AttackConfig from the attack preset plus keyword overrides."""
    preset = ATTACK_PRESETS[attack]
    cfg = AttackConfig(name=attack, result=preset["result"])
    cfg.dsp = DSPConfig(**preset["dsp"])
    if attack == "flowmur":
        cfg.model = "smallcnn"  # the surrogate and the victim (reference flowmur.py)
    for key, value in overrides.items():
        if value is None:
            continue
        # The reference's order: a key of AttackConfig wins, so "model" names
        # the architecture and MeshConfig.model is set only from code.
        for target in (cfg, cfg.dsp, cfg.train, cfg.mesh):
            if hasattr(target, key):
                setattr(target, key, value)
                break
        else:
            raise KeyError(f"Unknown config key: {key}")
    if cfg.train.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, got {cfg.train.compute_dtype!r}")
    return cfg


def config_from_yaml(path: str, attack: str | None = None, **cli_overrides: Any) -> AttackConfig:
    """YAML first, then CLI overrides on top (CLI wins)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    named = raw.pop("attack", None) or raw.pop("name", None)
    attack = attack or named
    if attack is None:
        raise ValueError(f"YAML {path} must name an 'attack'")
    nested = {}
    for section in ("dsp", "train", "mesh"):
        nested.update(raw.pop(section, None) or {})
    raw.update(nested)
    raw.update({k: v for k, v in cli_overrides.items() if v is not None})
    return make_config(attack, **raw)


def add_common_args(parser: argparse.ArgumentParser) -> None:
    """Flags mirroring the reference scripts' argparse (badnets.py:17-36)."""
    parser.add_argument("--config", type=str, default=None, help="YAML config path")
    parser.add_argument("--model", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--load_clean_data", type=lambda s: s.lower() != "false", default=None)
    parser.add_argument("--sample_rate", type=int, default=None)
    parser.add_argument("--n_mfcc", type=int, default=None)
    parser.add_argument("--n_fft", type=int, default=None)
    parser.add_argument("--hop_length", type=int, default=None)
    parser.add_argument("--poisoning_rate", type=float, default=None)
    parser.add_argument("--learning_rate", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--num_classes", type=int, default=None)
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--patience", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--result", type=str, default=None)
    parser.add_argument(
        "--fused_conv_block", type=str, default=None, choices=["auto", "on", "off"],
        help="CUDA-kernel-backward first conv block (TrainConfig.fused_conv_block)",
    )
    parser.add_argument(
        "--fused_block2", type=str, default=None, choices=["auto", "on", "off"],
        help="CUDA-kernel-backward second conv block (TrainConfig.fused_block2)",
    )
    parser.add_argument(
        "--fused_block3", type=str, default=None, choices=["auto", "on", "off"],
        help="CUDA-kernel-backward third conv block (TrainConfig.fused_block3)",
    )
    parser.add_argument(
        "--device", type=str, default=None,
        help="torch device to run on (default: cuda; raises if CUDA is missing)",
    )


def _is_config_key(key: str) -> bool:
    probe = AttackConfig()
    return any(hasattr(target, key) for target in (probe, probe.dsp, probe.train, probe.mesh))


def config_from_args(attack: str, args: argparse.Namespace, **extra: Any) -> AttackConfig:
    """Config keys from argparse (CLI-only flags like --synthetic are
    ignored here and handled by the entry script itself). A model the attack
    does not train is refused here, before any prep."""
    cli = {
        k: v for k, v in vars(args).items()
        if k != "config" and v is not None and _is_config_key(k)
    }
    cli.update({k: v for k, v in extra.items() if v is not None})
    if getattr(args, "config", None):
        cfg = config_from_yaml(args.config, attack=attack, **cli)
    else:
        cfg = make_config(attack, **cli)
    linear_features_for(attack, str(cfg.model))
    return cfg

