"""The seven keyword-spotting models: the reference's six (port of
audiobd_tpu/models/zoo.py; reference utils/models.py), SmallCNN, LargeCNN,
SmallLSTM, LSTMWithAttention, RNN and ResNet, and AST, the Audio Spectrogram
Transformer (Gong, Chung and Glass, Interspeech 2021, arXiv:2104.01778;
github.com/YuanGongND/ast, ``src/models/ast_models.py::ASTModel``), which
BadNets alone trains, on log-mel frames.

Input NCHW features (B, 1, frames, n_mfcc; n_mels for AST), raw logits out (the
reference's log_softmax is a no-op under cross-entropy). ``compute_dtype``
(torch.float32 or torch.bfloat16, the reference's ``dtype``) is the dtype
of the activations and the logits; the parameters stay f32 (models/layers.py
says where the casts are). The fused conv blocks (``ops/conv1_bn_pool``,
``ops/conv2_bn_pool``) exist on SmallCNN and SmallLSTM only, as in the
reference.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F

from audiobd_tpu_torch.models.layers import (
    BatchNorm2d,
    conv2d,
    conv_bn_pool_block1,
    LN_EPS,
    Attention,
    Mlp,
    PatchEmbedding,
    conv_bn_pool_block2,
    dropout,
    init_tree_,
    layer_norm,
    linear,
    lstm,
)
from audiobd_tpu_torch.utils.random import torch_generator


class _Model(nn.Module):
    """What the seven models share: the compute dtype, the dropout generator,
    and weights drawn by ``init_tree_``. ``final_layer`` names the final
    classifier, whose input the reference sows as ``features``
    (audiobd_tpu/models/zoo.py:87, 118, 164, 201, 219, 281). ``features``
    names the input the model takes (``dsp.mfcc.FEATURES``), which the prep
    computes (``model_features``)."""

    final_layer = "fc2"
    features = "mfcc"

    def __init__(self, compute_dtype: torch.dtype):
        super().__init__()
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"the models compute in float32 or bfloat16, got {compute_dtype}")
        self.compute_dtype = compute_dtype
        self.dropout_generator: torch.Generator | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_tree_(self, generator)

    def sync_batchnorm(self, group) -> None:
        """Hand every BatchNorm of the model the data axis's process group
        (the reference's ``bn_axis``, audiobd_tpu/train/scan_epoch.py:274-277);
        None goes back to local statistics."""
        for m in self.modules():
            if isinstance(m, BatchNorm2d):
                m.group = group


class ConvStack(_Model):
    """The three (conv2x2 → relu → BN → maxpool) blocks SmallCNN and
    SmallLSTM share.

    ``fused_block1`` routes block 1 through ops/conv1_bn_pool and
    ``fused_block2`` / ``fused_block3`` route blocks 2 and 3 through
    ops/conv2_bn_pool in training mode: the same parameters and forward, a
    CUDA-kernel backward. ``dropout_generator`` draws the dropout masks.
    Under sync-BN every block takes the unfused chain, whatever the flags
    (reference zoo.py:66-77): the kernels compute batch statistics from
    their own rows only."""

    def __init__(self, fused_block1: bool = False, fused_block2: bool = False, fused_block3: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        self.conv1 = nn.Conv2d(1, 64, 2)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 2)
        self.bn2 = BatchNorm2d(64)
        self.conv3 = nn.Conv2d(64, 32, 2)
        self.bn3 = BatchNorm2d(32)
        self.fused_block1 = fused_block1
        self.fused_block2 = fused_block2
        self.fused_block3 = fused_block3

    def block1(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block1(self.conv1, self.bn1, x, self.fused_block1 and self.bn1.group is None,
                                   self.compute_dtype)

    def block2(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block2(self.conv2, self.bn2, x, self.fused_block2 and self.bn2.group is None, (1, 1),
                                   self.compute_dtype)

    def block3(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_pool_block2(self.conv3, self.bn3, x, self.fused_block3 and self.bn3.group is None, (0, 1),
                                   self.compute_dtype)


class SmallCNN(ConvStack):
    """The conv stack + dropout + 2 FC. ``dropout_rates`` may be zeroed to
    compare with a deterministic reference."""

    def __init__(self, num_classes: int, linear_features: int, fused_block1: bool = False,
                 fused_block2: bool = False, fused_block3: bool = False,
                 dropout_rates: tuple[float, float] = (0.4, 0.5), compute_dtype: torch.dtype = torch.float32):
        super().__init__(fused_block1, fused_block2, fused_block3, compute_dtype)
        self.fc1 = nn.Linear(linear_features, 128)
        self.fc2 = nn.Linear(128, num_classes)
        self.linear_features = linear_features
        self.dropout_rates = dropout_rates

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.block1(x))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after block 1: blocks 2-3, dropout, the FC layers."""
        return self.classifier(self.block3(self.block2(x)))

    def classifier(self, x: torch.Tensor) -> torch.Tensor:
        """Everything after block 3: dropout and the FC layers."""
        x = dropout(x, self.dropout_rates[0], self.training, self.dropout_generator)
        x = x.flatten(1)
        if x.shape[-1] != self.linear_features:
            raise ValueError(f"smallcnn flatten {x.shape[-1]} != configured {self.linear_features}")
        x = F.relu(linear(self.fc1, x, self.compute_dtype))
        x = dropout(x, self.dropout_rates[1], self.training, self.dropout_generator)
        return linear(self.fc2, x, self.compute_dtype)


class SmallLSTM(ConvStack):
    """The conv stack → dropout → 2-layer LSTM(rnn_features → 128) → FC on
    the last step. ``rnn_features`` = W·C after the conv stack.

    ``nn.LSTM`` computes what the reference's scan LSTM does (gate order i,
    f, g, o, both biases; tests/test_models.py holds the two equal). In bf16
    it runs on bf16 copies of its f32 weights, the whole recurrence in bf16
    as the reference's (audiobd_tpu/models/layers.py:236-259); the gates'
    sums round in cuDNN's or ATen's order, not the reference's."""

    hidden = 128

    def __init__(self, num_classes: int, rnn_features: int, fused_block1: bool = False,
                 fused_block2: bool = False, fused_block3: bool = False, dropout_rate: float = 0.4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(fused_block1, fused_block2, fused_block3, compute_dtype)
        self.lstm = nn.LSTM(rnn_features, self.hidden, num_layers=2, batch_first=True)
        self.fc2 = nn.Linear(self.hidden, num_classes)
        self.rnn_features = rnn_features
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.block3(self.block2(self.block1(x)))
        x = dropout(x, self.dropout_rate, self.training, self.dropout_generator)
        b, c, h, w = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, h, w * c)  # (B, H, W·C), the reference's NHWC order
        if x.shape[-1] != self.rnn_features:
            raise ValueError(f"smalllstm features {x.shape[-1]} != configured {self.rnn_features}")
        x = lstm(self.lstm, x, self.compute_dtype)
        return linear(self.fc2, x[:, -1], self.compute_dtype)


class LargeCNN(_Model):
    """AlexNet-style 5 conv + 3 FC (reference zoo.py:91-119): conv 96 → pool
    2 → conv 256 → pool 2 (these two without relu) → 3 × (conv, relu) →
    maxpool 3 stride 2 → relu(fc1) → dropout → relu(fc2) → dropout → fc3.
    Every conv is 3×3 with padding 1."""

    final_layer = "fc3"

    def __init__(self, num_classes: int, linear_features: int, dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        widths = (1, 96, 256, 384, 384, 256)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, padding=1) for a, b in zip(widths, widths[1:]))
        self.fc1 = nn.Linear(linear_features, 256)
        self.fc2 = nn.Linear(256, 128)
        self.fc3 = nn.Linear(128, num_classes)
        self.linear_features = linear_features
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.max_pool2d(conv2d(self.convs[0], x, dt), 2)
        x = F.max_pool2d(conv2d(self.convs[1], x, dt), 2)
        for conv in self.convs[2:]:
            x = F.relu(conv2d(conv, x, dt))
        x = F.max_pool2d(x, 3, stride=2).flatten(1)
        if x.shape[-1] != self.linear_features:
            raise ValueError(f"largecnn flatten {x.shape[-1]} != configured {self.linear_features}")
        x = dropout(F.relu(linear(self.fc1, x, dt)), self.dropout_rate, self.training, self.dropout_generator)
        x = dropout(F.relu(linear(self.fc2, x, dt)), self.dropout_rate, self.training, self.dropout_generator)
        return linear(self.fc3, x, dt)


class LSTMWithAttention(_Model):
    """Two "SAME" (5, 1) convs, each conv → relu → BN, → two two-direction
    one-layer LSTMs of 64 → one-query soft attention over time → dense 64 →
    dropout → dense 32 → output (reference zoo.py:168-202). ``time_len`` is
    n_mfcc, ``seq_len`` the frame count."""

    final_layer = "output"

    def __init__(self, num_classes: int, time_len: int, seq_len: int, dropout_rate: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        self.conv1 = nn.Conv2d(1, 10, (5, 1), padding=(2, 0))
        self.bn1 = BatchNorm2d(10)
        self.conv2 = nn.Conv2d(10, 1, (5, 1), padding=(2, 0))
        self.bn2 = BatchNorm2d(1)
        self.rnn1 = nn.LSTM(time_len, 64, batch_first=True, bidirectional=True)
        self.rnn2 = nn.LSTM(128, 64, batch_first=True, bidirectional=True)
        self.dense1 = nn.Linear(128, 128)
        self.attention = nn.Linear(128, 128)
        self.dense2 = nn.Linear(seq_len, 64)
        self.dense3 = nn.Linear(64, 32)
        self.output = nn.Linear(32, num_classes)
        self.seq_len = seq_len
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = self.bn1(F.relu(conv2d(self.conv1, x, dt)))
        x = self.bn2(F.relu(conv2d(self.conv2, x, dt))).squeeze(1)  # (B, seq, time_len)
        if x.shape[1] != self.seq_len:
            raise ValueError(f"lstmwithattention sequence {x.shape[1]} != configured {self.seq_len}")
        x = lstm(self.rnn2, lstm(self.rnn1, x, dt), dt)  # (B, seq, 128)
        query = F.relu(linear(self.dense1, x[:, -1], dt))
        att = torch.softmax(linear(self.attention, query, dt), dim=-1)
        att_vector = torch.einsum("bk,btk->bt", att, x)  # (B, seq)
        y = F.relu(linear(self.dense2, att_vector, dt))
        y = dropout(y, self.dropout_rate, self.training, self.dropout_generator)
        y = F.relu(linear(self.dense3, y, dt))
        return linear(self.output, y, dt)


class RNN(_Model):
    """Three-layer LSTM(n_mfcc → 768) → FC on the last step (reference
    zoo.py:205-220); the input is cast to f32 first, as there."""

    final_layer = "fc"
    hidden = 768

    def __init__(self, num_classes: int, time_len: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        self.lstm = nn.LSTM(time_len, self.hidden, num_layers=3, batch_first=True)
        self.fc = nn.Linear(self.hidden, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = lstm(self.lstm, x.squeeze(1).to(torch.float32), self.compute_dtype)
        return linear(self.fc, x[:, -1], self.compute_dtype)


class ResidualBlock(nn.Module):
    """relu(BN(conv3x3(relu(BN(conv3x3_s(x))))) + residual), the residual a
    3×3 conv with the stride and BN where ``downsample`` (reference
    zoo.py:223-245). The convs have no bias."""

    def __init__(self, cin: int, features: int, stride: int, downsample: bool, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(features)
        self.down_conv = nn.Conv2d(cin, features, 3, stride=stride, padding=1, bias=False) if downsample else None
        self.down_bn = BatchNorm2d(features) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.relu(self.bn1(conv2d(self.conv1, x, dt)))
        y = self.bn2(conv2d(self.conv2, y, dt))
        residual = x if self.down_conv is None else self.down_bn(conv2d(self.down_conv, x, dt))
        return F.relu(y + residual)


class ResNet(_Model):
    """Conv stem (16, no bias) → BN → relu → 3 stages of 2 residual blocks,
    16/32/64 channels at strides 1/2/2 → 1×1 conv stride (2, 1) with bias →
    AvgPool(4) → FC (reference zoo.py:248-292)."""

    final_layer = "fc"

    def __init__(self, num_classes: int, linear_features: int, layers: tuple[int, int, int] = (2, 2, 2),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        self.conv1 = nn.Conv2d(1, 16, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(16)
        stages, cin = [], 16
        for feats, stride, n in zip((16, 32, 64), (1, 2, 2), layers):
            blocks = []
            for block in range(n):
                first = block == 0
                blocks.append(ResidualBlock(cin, feats, stride if first else 1,
                                            first and (stride != 1 or cin != feats), compute_dtype))
                cin = feats
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)
        self.conv2d = nn.Conv2d(64, 64, 1, stride=(2, 1))
        self.fc = nn.Linear(linear_features, num_classes)
        self.linear_features = linear_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.relu(self.bn1(conv2d(self.conv1, x, dt)))
        for stage in self.stages:
            x = stage(x)
        x = F.avg_pool2d(conv2d(self.conv2d, x, dt), 4).flatten(1)
        if x.shape[-1] != self.linear_features:
            raise ValueError(f"resnet flatten {x.shape[-1]} != configured {self.linear_features}")
        return linear(self.fc, x, dt)


class TransformerBlock(nn.Module):
    """timm's pre-LN ViT block, as AST's: x + Attn(LN(x)), then
    x + MLP(LN(x)), LayerNorm eps 1e-6, no dropout and no drop-path."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = x + self.attn(layer_norm(self.norm1, x, dt), dt)
        return x + self.mlp(layer_norm(self.norm2, x, dt), dt)


# AST's published widths (ASTModel with timm's deit_base_distilled_patch16_384,
# egs/speechcommands/run_sc.sh): patch 16 at stride 10 on both axes, 12 blocks
# of 768 with 12 heads and an MLP of 3,072. 85,376,266 parameters at ten
# classes and 128 x 128 input, 146 tokens.
AST_WIDTHS = dict(patch=16, stride=10, dim=768, depth=12, heads=12, mlp_dim=3072)


class AST(_Model):
    """The Audio Spectrogram Transformer: (B, 1, frames, n_mels) log-mel
    frames, zero frames appended up to ``input_tdim`` (frames past it cut, as
    AST's loader does), transposed to (n_mels, input_tdim), the patch
    embedding with its cls and distillation tokens and learned positions,
    ``depth`` pre-LN blocks, the final LayerNorm, (x[:, 0] + x[:, 1]) / 2,
    then ``mlp_head``: LayerNorm (eps 1e-5) → Linear.

    Departures from AST, for the framework's BadNets run: weights from the
    seed (``init_tree_``; ImageNet's are not in the repo); the framework's
    10-class synthetic Speech Commands (AST: v2, 35 classes); the attack's
    cross-entropy and Adam at AST's lr 2.5e-4, without mixup, SpecAugment or
    a schedule; log-mel in dB from the framework's STFT (n_fft 400, hop 160,
    Hann, centred, 101 frames; ``dsp/mfcc.py``'s log-mel mode), not Kaldi's
    fbank; μ and σ from the training split in the prep
    (``data/speech_commands.py::normalize_features``), where AST fixes them a
    dataset; the padded frames are 0 after normalisation (AST pads before)."""

    final_layer = "head"
    features = "logmel"

    def __init__(self, num_classes: int, input_fdim: int = 128, input_tdim: int = 128, patch: int = 16,
                 stride: int = 10, dim: int = 768, depth: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(compute_dtype)
        grid = ((input_fdim - patch) // stride + 1) * ((input_tdim - patch) // stride + 1)
        self.embed = PatchEmbedding(dim, patch, stride, grid + 2)
        self.blocks = nn.ModuleList(TransformerBlock(dim, heads, mlp_dim, compute_dtype) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head_norm = nn.LayerNorm(dim)
        self.head = nn.Linear(dim, num_classes)
        self.input_fdim, self.input_tdim = input_fdim, input_tdim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if x.shape[-1] != self.input_fdim:
            raise ValueError(f"ast mel bands {x.shape[-1]} != configured {self.input_fdim}")
        x = F.pad(x, (0, 0, 0, self.input_tdim - x.shape[-2])).transpose(-1, -2)  # (B, 1, n_mels, input_tdim)
        x = self.embed(x, dt)
        for block in self.blocks:
            x = block(x)
        x = layer_norm(self.norm, x, dt)
        return linear(self.head, layer_norm(self.head_norm, (x[:, 0] + x[:, 1]) / 2, dt), dt)


@contextlib.contextmanager
def final_layer_inputs(model: nn.Module):
    """Yields a list that gets the input of ``model``'s final classifier,
    detached, at each forward inside the block (the reference's sown
    ``features``). A forward hook on the layer: the f32 layers call it as a
    module, the bf16 ones call ``F.linear`` and are not seen."""
    seen: list[torch.Tensor] = []
    hook = getattr(model, model.final_layer).register_forward_hook(lambda _m, args, _out: seen.append(args[0].detach()))
    try:
        yield seen
    finally:
        hook.remove()


def build_model(name: str, num_classes: int, feature_size: int, device: torch.device, seed: int,
                n_mfcc: int | None = None, fused: bool = False, fused_block2: bool = False,
                fused_block3: bool = False, init_stream: str = "params", dropout_stream: str = "dropout",
                compute_dtype: torch.dtype = torch.float32) -> nn.Module:
    """The model as the reference's ``build_model`` (zoo.py:295-329) builds
    it, with weights drawn from ``torch_generator(seed, init_stream)`` and
    dropout from ``torch_generator(seed, dropout_stream, device)``.
    ``feature_size`` is the attack's flatten size, LSTM features or sequence
    length (``configs.linear_features_for``; AST's input_tdim). ``n_mfcc`` is
    the features' values a frame (``MFCCParams.n_out``): LSTMWithAttention's
    and RNN's coefficients, AST's mel bands (its input_fdim); AST takes
    ``AST_WIDTHS`` besides. ``fused`` is block 1's flag; the fused flags
    apply to SmallCNN and SmallLSTM and are ignored elsewhere."""
    name = name.lower()
    if name in ("smallcnn", "smalllstm"):
        cls = SmallCNN if name == "smallcnn" else SmallLSTM
        model = cls(num_classes, feature_size, fused_block1=fused, fused_block2=fused_block2,
                    fused_block3=fused_block3, compute_dtype=compute_dtype)
    elif name in ("largecnn", "resnet"):
        model = (LargeCNN if name == "largecnn" else ResNet)(num_classes, feature_size, compute_dtype=compute_dtype)
    elif name in ("lstmwithattention", "rnn"):
        if n_mfcc is None:
            raise ValueError(f"{name} needs n_mfcc")
        model = (LSTMWithAttention(num_classes, n_mfcc, feature_size, compute_dtype=compute_dtype)
                 if name == "lstmwithattention" else RNN(num_classes, n_mfcc, compute_dtype=compute_dtype))
    elif name == "ast":
        if n_mfcc is None:
            raise ValueError("ast needs its mel bands, the features' values a frame (n_mfcc)")
        model = AST(num_classes, input_fdim=n_mfcc, input_tdim=feature_size, compute_dtype=compute_dtype,
                    **AST_WIDTHS)
    else:
        raise ValueError(f"Unknown model {name}")
    model.reset_parameters(torch_generator(seed, init_stream))
    model.to(device)
    model.dropout_generator = torch_generator(seed, dropout_stream, device)
    return model


MODELS = {cls.__name__.lower(): cls for cls in (SmallCNN, LargeCNN, SmallLSTM, LSTMWithAttention, RNN, ResNet, AST)}


def model_features(name: str) -> str:
    """The input model ``name`` takes: "mfcc", or "logmel" (AST)."""
    cls = MODELS.get(name.lower())
    if cls is None:
        raise ValueError(f"Unknown model {name}")
    return cls.features
