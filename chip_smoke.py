#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (audiobd_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); exits non-zero, printing
no result, without them. Phases, each printing its own lines:
  0. the card's name and power limit; build every kernel from csrc/.
  1. each kernel against its plain PyTorch version at the shapes of the
     path that runs it (max abs error within the stated tolerance), with the kernel's
     time, the plain version's and a one-call PyTorch yardstick's, and the
     least time the card could take for the same work (bound): 1a kernel
     A's routes (the FFT path and the Bluestein path with everything in
     shared memory; the buffers alone in shared memory, n_fft 2205 by
     radix-7 stages; the buffers in device memory, n_fft 4097; FlowMur's
     n_fft 2048, 13 coefficients; DABA's n_fft 2048 in librosa parity at its
     2048-clip chunk), 1b kernels B and C (both in train mode at
     the main path's shape, and B in eval mode there too, as the defenses'
     SAM and unlearning steps launch it, on a row of its own; at FlowMur's
     (256, 1, 32, 13) B in train mode, as its surrogates and victim train,
     and C in eval mode, as its search runs; B in train mode at Ultrasonic's
     (256, 1, 100, 40) and DABA's (256, 1, 32, 40)),
     1c kernels D and E (E on the routing a D call wrote),
     1d kernel F's three routes (the ladder at k = 0 and the phaser of
     JingleBack's style 5, and the resonant ladder) held exactly equal to
     their plain loops at (256, 16000) and (37, 4001), with the plain loop's
     wall, the bytes bound and the route's chain bound (the recursion's
     dependent operations a sample), and the one-thread kernel on the k = 0
     ladder's work timed beside its pipeline.
  2. the main path through the CLI entry point: 20,000 synthetic one-second
     16 kHz clips → MFCC (kernel A, FFT path) → BadNets patch → full-width SmallCNN
     trained 2 epochs at batch 256 in f32, block-1 backward through kernel B.
  3. the block-2/3 path: the same run with --model smalllstm --fused_block2 on
     --fused_block3 on (blocks 2-3 backward through kernels D and E);
     3b. the same flags on SmallCNN, cut to 5,000 clips.
  4. the FlowMur path through its CLI: the same 20,000 clips → MFCC (kernel
     A at n_fft 2048) → 3 SmallCNN surrogates (kernel B) → trigger search
     through the frozen surrogate (kernel C, one launch a step, no B) →
     poisoning → victim (kernel B), 2 epochs a stage; each stage's wall.
  1b/1c (bf16). kernels B, C, D and E in their bf16 mode (a bf16 g; x f32
     for B and C, bf16 for D and E) against their plain versions at the same
     shapes, g from the bf16 model; the yardstick is autograd through cuDNN's
     bf16 conv2d → relu → BN (f32 statistics) → max_pool2d chain.
  5. path 1 of the bf16 slice: the main path's CLI run with --config naming
     a YAML of train: {compute_dtype: bfloat16} (BadNets → SmallCNN in bf16,
     block-1 backward through kernel B's bf16 mode);
     5b. path 2: SmallLSTM in bf16 with --fused_block2 on --fused_block3 on
     (B, D and E in bf16), cut to 5,000 clips.
  6. Ultrasonic from a wav tree the phase writes (10 classes x 2,000
     one-second 16 kHz PCM16 clips, plus 5 shorter and 5 at 44.1 kHz a
     class): python -m audiobd_tpu_torch ultrasonic, 2 epochs at batch 256:
     native decode, the 1-s filter, resampling to 44.1 kHz on the card,
     kernel A's Bluestein route (n_fft 1103) in the prep and the poisoning,
     full-width SmallCNN with kernel B once a step at (256, 1, 100, 40);
     the prep's walls (decode, resample, MFCC), train clips/s, launches.
     Phase 1b also holds B at that shape.
     6b. LargeCNN, LSTMWithAttention, RNN and ResNet at full width through
     ultrasonic --synthetic --model <m> (3,000 clips, 2 epochs each).
  7. the defense chain on phase 2's record (kept for it): python -m
     audiobd_tpu_torch fp; ft_reg --ft_epochs 10; tsbd; tsbd --only_finetune
     false --unlearn_epochs 100 --ft_epochs 10; correlation_analysis. Each
     run's wall, outputs, CSVs and artifacts, and kernel B's launches by
     mode (train: the fine-tunes; eval: the SAM steps and the unlearning).
  8. JingleBack at full width: python -m audiobd_tpu_torch jingleback
     --synthetic --synthetic_per_class 2000 --style 5 --num_epochs 2 (20,000
     clips; 1,600 train and every non-target test row restyled through
     kernel F; kernel A on the styled rows; SmallCNN with kernel B), run
     under torch.profiler (device activity only); stage walls (prep, poison,
     train), train clips/s, launches of A, B and F, and F's device time in
     the poison stage.
     8b. each of the six style boards on one 256-clip chunk on the card: its
     wall (after a warm-up call) and its launches (reverb's in style 4).
  9. DABA at full width: python -m audiobd_tpu_torch daba --synthetic
     --synthetic_per_class 2000 --num_epochs 2 (librosa parity at n_fft 2048
     through kernel A in the prep, the victim's scoring of the 60-clip pool
     and 3,000 host candidates, and the overlaid rows; 1,600 hosts with
     variant gains; SmallCNN at its 896-feature flatten, kernel B at (256,
     1, 32, 40)); the selected trigger, stage walls (prep, select, poison,
     train), train clips/s, launches of A and B.
  10. serving on phase 2's record: python -m audiobd_tpu_torch infer --wav
     <tree> --json over a tree it writes (10 classes x 400 one-second 16 kHz
     clips, 20 one-second and 5 half-second 44.1 kHz clips, all PCM16;
     resampled on the card, kernel A's FFT route, the eval model at batch
     256): the walls of read, resample, MFCC and forward, clips/s, A's
     launches; top-1 against the same model on A's plain version for the
     same clips; then --eval_clean against the clean accuracy phase 2's CSV
     logged at its best epoch (within 0.05 points).
  11. last, the restart: phase 2's badnets run with --resume --num_epochs 1
     --profile_dir <tmp> on its record: "resumed from step N" with N = 63 x
     phase 2's best epoch, B's launches, a trace naming epoch_1 and B's
     kernel, Adam's state in torch_checkpoint/train_state.pt, and the
     checkpoint write's ms beside the epoch's wall (every CLI run prints its
     writes).
  12. data-parallel training, two ranks on the one card (gloo; NCCL refuses
     two ranks on one device), which they time-share: 12a. one step of
     full-width SmallCNN on a global batch of 256 of phase 2's features, 128
     rows a rank, from ranks spawned by torch.multiprocessing (file://
     rendezvous), against the same step in this process, unfused and with
     block 1 on kernel B, and all three against the float64 step; the step
     written out in f32 with the batch's statistics, with the ranks'
     (halves averaged), and run as the ranks run it, with the max-pool
     windows whose chosen input differs between them (the source of the
     two-rank step's distance from one process); the ranks' parameters
     bit-equal; the gradient buffer's all-reduce timed. 12b. the main path's badnets CLI through
     python -m torch.distributed.run --nproc_per_node 2: rank 0 alone writes
     (every rank's writes under the run's directory recorded by audit
     hooks), each rank's kernel launches (A 10, B 0: sync-BN takes the
     unfused chain) and parameter digest, accuracy against phase 2's.
  13. tensor parallel (parallel/mesh.py::shard_params_tp, min_features
     128; the column-parallel routes of parallel/tp.py), ranks spawned on the
     card as in 12a, each case one step on a global batch of 256 of phase 2's
     features from shared weights against the same step in this process (and
     the float64 step): 13a LargeCNN (flatten 12288) on a 1 x 2 and a 2 x 2
     mesh; 13b SmallCNN with block 1 on kernel B (1 x 2: BatchNorm keeps
     local statistics, so B runs on each rank); 13c RNN (3 x 768 LSTM, 101
     steps: the gate-sharded loop against cuDNN); 13d LargeCNN in bf16. Each
     rank's parameter and Adam-moment bytes against the replicated layout,
     the gathers and row all-reduces a step, the walls of the step and of a
     second one, B's launches a rank.
  Kernel launch counts are zeroed just before each CLI run and read just
  after it; the ranks of phases 12 and 13 count their own.
Then one JSON line listing the kernels, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(f"  {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        failures.append(what)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the CUDA kernels' durations under torch.profiler
    over ``iters`` calls after a warm-up call, summed. For calls so short
    that back-to-back launches timed by CUDA events measure the host's
    launch path instead (kernel C at FlowMur's shape: ~0.01 ms)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters


def max_err(torch, got, ref, rtol: float, atol: float) -> tuple[float, float, bool]:
    """(max abs error, max error relative to max |ref|, within atol + rtol*|ref|)."""
    diff = (got.double() - ref.double()).abs()
    scale = ref.double().abs()
    ok = bool((diff <= atol + rtol * scale).all())
    mx = float(diff.max())
    return mx, mx / max(float(scale.max()), 1e-30), ok


def mfcc_bound(wav, params) -> tuple[float, str, float, float]:
    """Least time for waveform → MFCC on ``wav`` (B, T): (ms, by, flops, bytes).

    Operations per frame of the function, not of the kernel's transforms:
    the window (n_fft multiplies); a real-input FFT of size n_fft at the
    conventional 2.5·n·log2(n) (half of a complex FFT's 5·n·log2(n)); the
    power (3 per bin); the mel product over the filterbank's nonzeros only
    (2 each: the triangles overlap at most pairwise, so the dense product
    would count ~65x too much); the dB scale and top_db floor (3 per mel);
    the dense DCT (2·n_mels·n_mfcc). Bytes: the PCM read, the MFCCs written,
    the mel and DCT tables read.
    """
    from audiobd_tpu_torch.dsp.stft import num_frames

    batch, n_samples = wav.shape
    frames = num_frames(n_samples, params.n_fft, params.hop_length)
    n, bins = params.n_fft, params.n_fft // 2 + 1
    mel = params.mel_fb()
    per_frame = (n + 2.5 * n * math.log2(n) + 3 * bins + 2 * int((mel != 0).sum())
                 + 3 * params.n_mels + 2 * params.n_mels * params.n_mfcc)
    flops = batch * frames * per_frame
    nbytes = (wav.numel() * wav.element_size() + 4 * batch * frames * params.n_mfcc
              + 4 * (mel.size + params.n_mels * params.n_mfcc))
    ms, by = bound(flops, nbytes)
    return ms, by, flops, nbytes


def mfcc_float64(torch, wav, params):
    """dsp.mfcc's function in float64 with torch.fft, as a reference for both
    f32 versions."""
    from audiobd_tpu_torch.dsp.mel import amplitude_to_db
    from audiobd_tpu_torch.dsp.stft import frame_signal, hann_window

    frames = frame_signal(wav.double(), params.n_fft, params.hop_length, pad_mode=params.pad_mode)
    spec = torch.fft.rfft(frames * torch.from_numpy(hann_window(params.n_fft)).cuda(), dim=-1).abs() ** 2
    mel = spec @ torch.from_numpy(params.mel_fb()).cuda().double()
    return amplitude_to_db(mel, top_db=params.top_db) @ torch.from_numpy(params.dct()).cuda().double()


def phase_mfcc(torch, ctx) -> list[dict]:
    from audiobd_tpu_torch.dsp import MFCCParams, mfcc
    from audiobd_tpu_torch.dsp.mel import amplitude_to_db
    from audiobd_tpu_torch.dsp.stft import num_frames
    from audiobd_tpu_torch.ops import mfcc as op
    from audiobd_tpu_torch.poison.device_prep import dequantize_pcm

    print("phase 1a: MFCC kernel (A), every route, vs plain dsp.mfcc; tolerance rtol 1e-4, atol 1e-3 (f32 "
          "both; sums in another order)", flush=True)
    rtol, atol = 1e-4, 1e-3
    gen = torch.Generator(device="cuda").manual_seed(0)
    # The main path's prep launches A on f32 chunks of 2048 clips and one
    # 1568-clip tail (20,000 clips); the other cases cover int16 PCM, librosa
    # parity and a batch that is not a multiple of anything. n_fft 1103
    # (Ultrasonic's 44.1 kHz setting, prime) takes the Bluestein path, at the
    # 2048-clip chunk that Ultrasonic's prep will launch; n_fft 2205 (3²·5·7²)
    # the FFT path by radix-7 stages with its buffers alone in shared memory;
    # n_fft 4097 (17·241, L = 8232) the Bluestein path in device memory, at
    # 256 clips and at more clips than the route's grid has blocks.
    wav = torch.randn(2048, 16000, device="cuda", generator=gen) * 0.1
    tail = wav[:1568]
    pcm = torch.clamp(torch.round(wav[:256] * 32768.0), -32768, 32767).to(torch.int16)
    wav44 = torch.randn(2048, 44100, device="cuda", generator=gen) * 0.1
    ta = MFCCParams()
    lib = MFCCParams(n_fft=2048, hop_length=512, parity="librosa")
    us = MFCCParams(sample_rate=44100, n_fft=1103, hop_length=441)
    wide = MFCCParams(sample_rate=44100, n_fft=2205, hop_length=441)
    deep = MFCCParams(sample_rate=44100, n_fft=4097, hop_length=441)
    flow = MFCCParams(n_mfcc=13, n_fft=2048, hop_length=512)  # FlowMur's front end
    kernels = {k.name: k for k in (op.MFCC_FFT_KERNEL, op.MFCC_BLUESTEIN_KERNEL, op.MFCC_LARGE_KERNEL,
                                   op.MFCC_DEVICE_KERNEL)}
    worst = dict.fromkeys(kernels, 0.0)
    errs = {}
    daba_case = "librosa f32 (2048, 16000) n_fft 2048 hop 512, DABA's chunk"
    pcm44 = torch.clamp(torch.round(wav44[:64] * 32768.0), -32768, 32767).to(torch.int16)
    # The device-memory route's grid is two blocks an SM, each looping over
    # clips: 37 clips more make blocks take a second clip.
    loop = 2 * torch.cuda.get_device_properties(0).multi_processor_count + 37
    for name, w, params in (
        ("torchaudio f32 (2048, 16000), main-path chunk", wav, ta),
        ("torchaudio f32 (1568, 16000), main-path tail", tail, ta),
        ("torchaudio int16 (256, 16000)", pcm, ta),
        ("librosa f32 (64, 16000) n_fft 2048", wav[:64], lib),
        (daba_case, wav, lib),
        ("torchaudio f32 ragged (257, 16000)", torch.cat([wav[:256], wav[:1] * 0.5]), ta),
        ("torchaudio f32 (2048, 16000) n_fft 2048 hop 512, 13 coefficients, FlowMur's chunk", wav, flow),
        ("torchaudio f32 (2048, 44100) n_fft 1103 hop 441, Ultrasonic's chunk", wav44, us),
        ("torchaudio int16 (64, 44100) n_fft 1103 hop 441", pcm44, us),
        ("torchaudio f32 (2048, 44100) n_fft 2205 hop 441, radix 7", wav44, wide),
        ("torchaudio int16 (64, 44100) n_fft 2205 hop 441", pcm44, wide),
        ("torchaudio f32 (256, 44100) n_fft 4097 hop 441, device memory", wav44[:256], deep),
        (f"torchaudio f32 ({loop}, 9000) n_fft 4097 hop 441, device memory, blocks loop over clips",
         wav44[:loop, :9000], deep),
    ):
        path = op.mfcc_route(params, num_frames(w.shape[1], params.n_fft, params.hop_length)).kernel.name
        before = {p: k.launches for p, k in kernels.items()}
        got = op.fused_mfcc(w, params)
        torch.cuda.synchronize()
        ran = {p: k.launches - before[p] for p, k in kernels.items()}
        ref = mfcc(dequantize_pcm(w), params)
        err, rel, ok = max_err(torch, got, ref, rtol, atol)
        worst[path] = max(worst[path], err)
        errs[name] = err
        check(ok and tuple(got.shape) == tuple(ref.shape) and ran == {p: int(p == path) for p in kernels},
              f"{name} [{path} path, launches {ran}]: shape {tuple(got.shape)} max abs err {err:.3e} "
              f"(rel to max {rel:.3e})")
        del got, ref

    # The kernel's FFT rounds otherwise than the plain version's matrix DFT, so
    # the card's kernels and the plain version are each also held against a float64 MFCC.
    for w, params, label in ((wav, ta, "FFT kernel (2048, 16000)"),
                             (wav44, us, "Bluestein kernel (2048, 44100) n_fft 1103"),
                             (wav44[:512], wide, "radix-7 kernel (512, 44100) n_fft 2205")):
        truth = mfcc_float64(torch, w, params)
        for name, got in ((label, op.fused_mfcc(w, params)), (f"plain dsp.mfcc at n_fft {params.n_fft}",
                                                               mfcc(w, params))):
            err = float((got.double() - truth).abs().max())
            check(err <= atol, f"{name} against a float64 MFCC: max abs err {err:.3e}")
            del got
        del truth

    def yardstick(w, params):
        mel_fb = torch.from_numpy(params.mel_fb()).cuda()
        dct = torch.from_numpy(params.dct()).cuda()
        window = torch.hann_window(params.n_fft, periodic=True, device="cuda")

        def library():
            spec = torch.stft(w, params.n_fft, params.hop_length, window=window, center=True,
                              pad_mode=params.pad_mode, return_complex=True).abs().pow(2)
            return amplitude_to_db(spec.transpose(-1, -2) @ mel_fb, top_db=params.top_db) @ dct

        err_lib, _, ok_lib = max_err(torch, library(), mfcc(w, params), rtol, atol)
        check(ok_lib, f"yardstick torch.stft+matmul at n_fft {params.n_fft} agrees: max abs err {err_lib:.3e}")
        return library

    rows = []
    for path, w, params, label in (("mfcc_fft", wav, ta, "(2048, 16000) f32"),
                                   ("mfcc_bluestein", wav44, us, "(2048, 44100) f32"),
                                   ("mfcc_fft_large", wav44, wide, "(2048, 44100) f32"),
                                   ("mfcc_fft_device", wav44[:256], deep, "(256, 44100) f32")):
        kernel = kernels[path]
        library = yardstick(w, params)
        ms = time_ms(torch, lambda: op.fused_mfcc(w, params), 10)
        plain_ms = time_ms(torch, lambda: mfcc(w, params), 5, warmup=1)
        library_ms = time_ms(torch, library, 10)
        bms, by, flops, nbytes = mfcc_bound(w, params)
        print(f"  MFCC {path} path {label} n_fft {params.n_fft}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.stft yardstick {library_ms:.4f} ms, bound {bms:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB)", flush=True)
        rows.append({"name": kernel.name, "route": "cuda", "source": "audiobd_tpu_torch/csrc/mfcc.cu",
                     "replaces": "audiobd_tpu/ops/pallas_mfcc.py:129", "max_abs_err": worst[path], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by, "library_ms": library_ms})
    narrow = wav44[:64]
    library = yardstick(narrow, wide)
    print(f"  MFCC mfcc_fft_large path (64, 44100) f32 n_fft 2205: kernel "
          f"{time_ms(torch, lambda: op.fused_mfcc(narrow, wide), 10):.4f} ms, torch.stft yardstick "
          f"{time_ms(torch, library, 10):.4f} ms, bound {mfcc_bound(narrow, wide)[0]:.4f} ms", flush=True)
    library = yardstick(wav, flow)
    route = op.mfcc_route(flow, num_frames(16000, flow.n_fft, flow.hop_length)).kernel.name
    flow_ms = time_ms(torch, lambda: op.fused_mfcc(wav, flow), 10)
    flow_plain = time_ms(torch, lambda: mfcc(wav, flow), 5, warmup=1)
    bms, by, flops, nbytes = mfcc_bound(wav, flow)
    print(f"  MFCC {route} path (2048, 16000) f32 n_fft 2048 hop 512, 13 coefficients (FlowMur): kernel "
          f"{flow_ms:.4f} ms, plain {flow_plain:.4f} ms, torch.stft yardstick {time_ms(torch, library, 10):.4f} ms, "
          f"bound {bms:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB)", flush=True)
    ctx["flowmur_route"] = route
    tail_ms = time_ms(torch, lambda: op.fused_mfcc(tail, ta), 10)
    print(f"  MFCC fft path (1568, 16000) f32 tail: kernel {tail_ms:.4f} ms, bound {mfcc_bound(tail, ta)[0]:.4f} ms",
          flush=True)
    lib_ms = time_ms(torch, lambda: op.fused_mfcc(wav[:64], lib), 10)
    print(f"  MFCC fft path (64, 16000) f32 n_fft 2048: kernel {lib_ms:.4f} ms, bound "
          f"{mfcc_bound(wav[:64], lib)[0]:.4f} ms", flush=True)
    library = yardstick(wav, lib)
    route = op.mfcc_route(lib, num_frames(16000, lib.n_fft, lib.hop_length)).kernel.name
    bms, by, flops, nbytes = mfcc_bound(wav, lib)
    print(f"  MFCC {route} path (2048, 16000) f32 n_fft 2048 hop 512, librosa parity (DABA): kernel "
          f"{time_ms(torch, lambda: op.fused_mfcc(wav, lib), 10):.4f} ms, plain "
          f"{time_ms(torch, lambda: mfcc(wav, lib), 5, warmup=1):.4f} ms, torch.stft yardstick "
          f"{time_ms(torch, library, 10):.4f} ms, bound {bms:.4f} ms ({by}: {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB); max abs err {errs[daba_case]:.3e}",
          flush=True)
    ctx["daba_route"] = route
    # The sizes that ran two blocks an SM before keep them; the larger
    # transforms state theirs.
    for params, n_samples, two_blocks in ((ta, 16000, True), (lib, 16000, True), (us, 44100, True),
                                          (wide, 44100, False), (deep, 44100, False)):
        route, blocks = op.fft_occupancy(params, n_samples, torch.device("cuda"))
        print(f"  kernel A ({route.kernel.name}, {route.path} path) at n_fft {params.n_fft}, transform "
              f"{route.size}, {route.groups} thread group(s): {route.smem} B shared memory a block, {blocks} "
              f"blocks ({blocks * 512} threads) per SM", flush=True)
        if two_blocks:
            check(blocks * 512 >= 1024, f"kernel A at n_fft {params.n_fft} keeps >= 1024 threads per SM")
    ctx["feats"] = op.fused_mfcc(wav[:256], ta)[:, None]
    ctx["flowmur_feats"] = op.fused_mfcc(wav[:256], flow)[:, None]
    ctx["ultrasonic_feats"] = op.fused_mfcc(wav44[:256], us)[:, None]  # (256, 1, 100, 40): n_fft 1103 is odd
    ctx["daba_feats"] = op.fused_mfcc(wav[:256], lib)[:, None]  # (256, 1, 32, 40)
    return rows


def phase_conv1(torch, ctx) -> list[dict]:
    import torch.nn.functional as F

    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    print("phase 1b: block-1 backward kernels (B, C) vs plain; tolerance max abs err <= "
          "1e-3 * max|ref| + 1e-6 (f32 sums over ~1e6 terms per channel in another order; "
          "train-mode dw is a difference of such sums)", flush=True)
    model = build_model("smallcnn", 10, 3072, torch.device("cuda"), seed=35, fused=True)
    model.train()
    x = ctx["feats"].contiguous()
    out1 = model.block1(x)
    out1d = out1.detach().requires_grad_(True)
    labels = torch.randint(0, 10, (x.shape[0],), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    loss = F.cross_entropy(model.head(out1d), labels)
    g = torch.autograd.grad(loss, out1d)[0].contiguous()
    w, b = model.conv1.weight.detach(), model.conv1.bias.detach()
    gamma, beta = model.bn1.weight.detach(), model.bn1.bias.detach()
    r = torch.clamp(F.conv2d(x, w, b), min=0.0)
    mu = r.mean(dim=(0, 2, 3))
    var = (r * r).mean(dim=(0, 2, 3)) - mu * mu
    inv = torch.rsqrt(var + op.EPS)
    scale = gamma * inv
    shift = beta - mu * scale
    w5 = op._w5(w, b)
    names = ("dx", "dweight", "dbias", "dgamma", "dbeta")

    def compare(got, ref, label):
        worst = 0.0
        for n, a, e in zip(names, got, ref):
            if a is None:
                continue
            err, rel, _ = max_err(torch, a, e, 0.0, 0.0)
            ok = err <= 1e-3 * float(e.abs().max()) + 1e-6
            check(ok, f"{label} {n} {tuple(a.shape)}: max abs err {err:.3e} (rel to max {rel:.3e})")
            worst = max(worst, err)
        return worst

    # Kernel B (train) and kernel C in train and eval mode.
    out_b = op.conv1_bn_pool_bwd_params(x, g, w5, mu, inv, scale, shift, train_bn=True)
    dx_t = op.conv1_bn_pool_bwd_input(x, g, w5, mu, inv, scale, shift, out_b[7:9].contiguous(), train_bn=True)
    got_t = (dx_t, out_b[:4].t().reshape(w.shape), out_b[4], out_b[5], out_b[6])
    ref_t = op.conv1_bn_pool_backward_plain(x, g, w, b, mu, inv, scale, shift, train_bn=True, need_dx=True)
    err_b = compare((None, *got_t[1:]), ref_t, "train")
    err_c = compare((got_t[0], None, None, None, None), ref_t, "train")
    rmean = mu * 0.9 + 0.05
    rinv = torch.rsqrt(var * 1.1 + op.EPS)
    rscale = gamma * rinv
    rshift = beta - rmean * rscale
    got_e = op.conv1_bn_pool_backward(x, g, w, b, rmean, rinv, rscale, rshift, train_bn=False, need_dx=True)
    ref_e = op.conv1_bn_pool_backward_plain(x, g, w, b, rmean, rinv, rscale, rshift, train_bn=False, need_dx=True)
    err_be = compare((None, *got_e[1:]), ref_e, "eval")
    err_c = max(err_c, compare((got_e[0], None, None, None, None), ref_e, "eval"))
    torch.cuda.synchronize()

    h12 = out_b[7:9].contiguous()
    ms_b = time_ms(torch, lambda: op.conv1_bn_pool_bwd_params(x, g, w5, mu, inv, scale, shift, train_bn=True), 20)
    ms_c = time_ms(torch, lambda: op.conv1_bn_pool_bwd_input(x, g, w5, mu, inv, scale, shift, h12, train_bn=True), 20)
    plain_b = time_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g, w, b, mu, inv, scale, shift, train_bn=True, need_dx=False), 5, warmup=1)
    plain_bc = time_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g, w, b, mu, inv, scale, shift, train_bn=True, need_dx=True), 5, warmup=1)

    # Yardstick: autograd through conv2d → relu → BN (batch stats) → max_pool2d.
    xg = x.detach().clone().requires_grad_(True)
    params = [t.detach().clone().requires_grad_(True) for t in (w, b, gamma, beta)]
    rr = torch.clamp(F.conv2d(xg, params[0], params[1]), min=0.0)
    m_ = rr.mean(dim=(0, 2, 3))
    v_ = (rr * rr).mean(dim=(0, 2, 3)) - m_ * m_
    c4 = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    z = (rr - c4(m_)) * c4(torch.rsqrt(v_ + op.EPS)) * c4(params[2]) + c4(params[3])
    pooled = F.max_pool2d(z, (1, 3))
    lib_b = time_ms(torch, lambda: torch.autograd.grad(pooled, params, g, retain_graph=True), 20)
    lib_c = time_ms(torch, lambda: torch.autograd.grad(pooled, xg, g, retain_graph=True), 20)

    # Bounds from this run's data (train mode, as timed). Per (pooled
    # position, channel): recompute the 3 conv outputs (4 mul + 4 add, relu,
    # z mul + add: 11 each) and pick the winner (2 compares). Only the
    # winning phase carries dz, so S1, S2 (3) and x̂ (2) are counted there,
    # and dwA (4 multiply-adds + 1 add) only where the winner's relu is
    # active. The BN-mean terms dwB (5 adds) and dwC (4 multiply-adds + 1
    # add) and their x̂ run on every active phase.
    _, r_win, z_win = op._windows(x, w5, scale, shift)
    winner, active = op._first_match(z_win), r_win > 0
    n_pc = winner.numel() // 3
    n_active = int(active.sum())
    n_win_active = int((winner & active).sum())
    n_xhat = int((winner | active).sum())
    del r_win, z_win, winner, active
    x_bytes, g_bytes = 4 * x.numel(), 4 * g.numel()
    c = w.shape[0]
    flops_b = n_pc * (33 + 2 + 3) + 2 * n_xhat + 9 * n_win_active + 14 * n_active
    # Kernel C: the same recompute, then per active phase x̂ (2), dr =
    # [scale·dz] − h1 − x̂·h2 (3, and 1 more on the winner) and four dp
    # multiply-adds (8); plus at most three adds per x element in the gather.
    flops_c = n_pc * (33 + 2) + 13 * n_active + n_win_active + 3 * x.numel()
    print(f"  data: {n_pc} (position, channel) pairs, {n_active} active phases of "
          f"{3 * n_pc}, {n_win_active} active winners", flush=True)
    bb, byb = bound(flops_b, x_bytes + g_bytes + 4 * 11 * c)
    bc, byc = bound(flops_c, 2 * x_bytes + g_bytes + 4 * 13 * c)
    print(f"  B params bwd (partial pass + finish, one wrapper call): kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, "
          f"autograd yardstick {lib_b:.4f} ms, bound {bb:.4f} ms ({byb})", flush=True)
    print(f"  C input bwd, train mode, main path's shape x {tuple(x.shape)}: kernel {ms_c:.4f} ms, plain (B+C) "
          f"{plain_bc:.4f} ms, autograd dx yardstick {lib_c:.4f} ms, bound {bc:.4f} ms ({byc})", flush=True)
    # B in eval mode (running statistics; the parameter gradients alone), as
    # the defenses' SAM and unlearning steps launch it at this shape (phase 7).
    out_be = op.conv1_bn_pool_bwd_params(x, g, w5, rmean, rinv, rscale, rshift, train_bn=False)
    ref_be = op.conv1_bn_pool_backward_plain(x, g, w, b, rmean, rinv, rscale, rshift, train_bn=False, need_dx=False)
    err_be = max(err_be, compare((None, out_be[:4].t().reshape(w.shape), out_be[4], out_be[5], out_be[6]), ref_be,
                                 "eval, parameters alone"))
    del ref_be
    ms_be = time_ms(torch, lambda: op.conv1_bn_pool_bwd_params(x, g, w5, rmean, rinv, rscale, rshift,
                                                               train_bn=False), 20)
    plain_be = time_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g, w, b, rmean, rinv, rscale, rshift, train_bn=False, need_dx=False), 5, warmup=1)
    # Yardstick: autograd for the parameters through cuDNN's eval chain
    # conv2d → relu → BN (running statistics) → max_pool2d.
    params_e = [t.detach().clone().requires_grad_(True) for t in (w, b, gamma, beta)]
    rr_e = torch.clamp(F.conv2d(x, params_e[0], params_e[1]), min=0.0)
    pooled_e = F.max_pool2d((rr_e - c4(rmean)) * c4(rinv) * c4(params_e[2]) + c4(params_e[3]), (1, 3))
    lib_be = time_ms(torch, lambda: torch.autograd.grad(pooled_e, params_e, g, retain_graph=True), 20)
    del rr_e, pooled_e
    # Eval mode's work, counted as train mode's above without the BN-mean
    # terms: per pair the recompute and the winner (35), S1, S2 and x̂ on the
    # winner (5); dwA on the active winners (9). The same bytes.
    _, r_win, z_win = op._windows(x, w5, rscale, rshift)
    n_win_active_e = int((op._first_match(z_win) & (r_win > 0)).sum())
    del r_win, z_win
    bbe, bybe = bound(n_pc * (33 + 2 + 3 + 2) + 9 * n_win_active_e, x_bytes + g_bytes + 4 * 11 * c)
    print(f"  B params bwd, eval mode, main path's shape x {tuple(x.shape)} (the defenses' SAM and unlearning "
          f"steps): kernel {ms_be:.4f} ms, plain {plain_be:.4f} ms, autograd yardstick (cuDNN, running statistics) "
          f"{lib_be:.4f} ms, bound {bbe:.4f} ms ({bybe}); {n_win_active_e} active winners", flush=True)
    flow = flowmur_block1(torch, ctx["flowmur_feats"].contiguous(), compare)
    ultra = block1_train(torch, ctx["ultrasonic_feats"].contiguous(), compare, "Ultrasonic", 3072, seed=4)
    daba = block1_train(torch, ctx["daba_feats"].contiguous(), compare, "DABA", 896, seed=5, device_time=True)
    src = "audiobd_tpu_torch/csrc/conv1_bn_pool.cu"
    return [
        # B's row is the main path's shape; FlowMur's is checked and printed above.
        {"name": "conv1_bn_pool_bwd_params", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block.py:226",
         "max_abs_err": max(err_b, flow["err_b"], ultra["err_b"], daba["err_b"]), "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bb, "bound_by": byb, "library_ms": lib_b},
        # B's eval mode, its launches from the defense chain (phase 7).
        {"name": "conv1_bn_pool_bwd_params_eval", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block.py:226", "max_abs_err": err_be, "ms": ms_be,
         "plain_ms": plain_be, "bound_ms": bbe, "bound_by": bybe, "library_ms": lib_be},
        # C's caller is FlowMur's trigger search: the row is its eval-mode shape.
        {"name": "conv1_bn_pool_bwd_input", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block.py:243", "max_abs_err": max(err_c, flow["err"]),
         "ms": flow["ms"], "plain_ms": flow["plain_ms"], "bound_ms": flow["bound_ms"], "bound_by": flow["bound_by"],
         "library_ms": flow["library_ms"]},
    ]


def block1_train(torch, x, compare, label: str, linear_features: int, seed: int, device_time: bool = False) -> dict:
    """Kernel B in train mode (batch statistics) at another attack's training
    shape (Ultrasonic's x (256, 1, 100, 40), g (256, 64, 99, 13); DABA's x
    (256, 1, 32, 40), g (256, 64, 31, 13)), against the plain version; its
    time, the plain version's, the cuDNN autograd yardstick's and the bound
    on this run's data, as phase_conv1 counts it at the main path's shape.
    ``device_time``: times under torch.profiler, for calls so short that
    events over back-to-back launches time the host (FlowMur's shape)."""
    import torch.nn.functional as F

    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    model = build_model("smallcnn", 10, linear_features, torch.device("cuda"), seed=35, fused=True)
    model.train()
    out1d = model.block1(x).detach().requires_grad_(True)
    labels = torch.randint(0, 10, (x.shape[0],), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(seed))
    g = torch.autograd.grad(F.cross_entropy(model.head(out1d), labels), out1d)[0].contiguous()
    w, b = model.conv1.weight.detach(), model.conv1.bias.detach()
    gamma, beta = model.bn1.weight.detach(), model.bn1.bias.detach()
    r = torch.clamp(F.conv2d(x, w, b), min=0.0)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + op.EPS)
    del r
    w5 = op._w5(w, b)
    vecs = (mu, inv, gamma * inv, beta - mu * gamma * inv)
    out_b = op.conv1_bn_pool_bwd_params(x, g, w5, *vecs, train_bn=True)
    ref = op.conv1_bn_pool_backward_plain(x, g, w, b, *vecs, train_bn=True, need_dx=False)
    err_b = compare((None, out_b[:4].t().reshape(w.shape), out_b[4], out_b[5], out_b[6]), ref, f"{label} train")
    kernel = lambda: op.conv1_bn_pool_bwd_params(x, g, w5, *vecs, train_bn=True)  # noqa: E731
    plain = lambda: op.conv1_bn_pool_backward_plain(x, g, w, b, *vecs, train_bn=True, need_dx=False)  # noqa: E731
    if device_time:
        ms, plain_ms = device_ms(torch, kernel, 50), device_ms(torch, plain, 10)
    else:
        ms, plain_ms = time_ms(torch, kernel, 20), time_ms(torch, plain, 5, warmup=1)
    library_ms = block_yardstick(torch, x, w, b, gamma, beta, (1, 3), 0, g, torch.float32)[0]
    _, r_win, z_win = op._windows(x, w5, vecs[2], vecs[3])
    winner, active = op._first_match(z_win), r_win > 0
    n_pc, n_active = winner.numel() // 3, int(active.sum())
    n_win_active, n_xhat = int((winner & active).sum()), int((winner | active).sum())
    del r_win, z_win, winner, active
    bms, by = bound(n_pc * (33 + 2 + 3) + 2 * n_xhat + 9 * n_win_active + 14 * n_active,
                    4 * (x.numel() + g.numel() + 11 * w.shape[0]))
    print(f"  data ({label}, train): {n_pc} (position, channel) pairs, {n_active} active phases, "
          f"{n_win_active} active winners", flush=True)
    print(f"  B params bwd, train mode, {label}'s shape x {tuple(x.shape)}, g {tuple(g.shape)}"
          f"{', device times' if device_time else ''}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, autograd "
          f"yardstick (cuDNN, events) {library_ms:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return dict(err_b=err_b, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by)


def flowmur_block1(torch, x, compare) -> dict:
    """Kernels B and C at FlowMur's shape: x (256, 1, 32, 13), C 64. B in
    train mode with batch statistics, as surrogate and victim training launch
    it. C in eval mode with running statistics, frozen parameters (no kernel
    B, no h12), as the trigger search launches it. Each against the plain
    version; their times and bounds by this run's data, and C's cuDNN
    autograd yardstick."""
    import torch.nn.functional as F

    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    model = build_model("smallcnn", 10, 224, torch.device("cuda"), seed=35, fused=True)
    w, b = model.conv1.weight.detach(), model.conv1.bias.detach()
    gamma, beta = model.bn1.weight.detach(), model.bn1.bias.detach()
    labels = torch.randint(0, 10, (x.shape[0],), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(3))
    model.train()  # also sets the running statistics C reads below from this batch
    out1d = model.block1(x).detach().requires_grad_(True)
    g_t = torch.autograd.grad(F.cross_entropy(model.head(out1d), labels), out1d)[0].contiguous()
    r = torch.clamp(F.conv2d(x, w, b), min=0.0)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + op.EPS)
    del r
    w5 = op._w5(w, b)
    vecs_t = (mu, inv, gamma * inv, beta - mu * gamma * inv)
    out_b = op.conv1_bn_pool_bwd_params(x, g_t, w5, *vecs_t, train_bn=True)
    ref_b = op.conv1_bn_pool_backward_plain(x, g_t, w, b, *vecs_t, train_bn=True, need_dx=False)
    err_b = compare((None, out_b[:4].t().reshape(w.shape), out_b[4], out_b[5], out_b[6]), ref_b, "FlowMur train")
    kernel_b = lambda: op.conv1_bn_pool_bwd_params(x, g_t, w5, *vecs_t, train_bn=True)  # noqa: E731
    ms_b, event_b = device_ms(torch, kernel_b, 50), time_ms(torch, kernel_b, 50)
    plain_b = device_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g_t, w, b, *vecs_t, train_bn=True, need_dx=False), 10)
    # B's bound counted as at the main path's shape (phase_conv1).
    _, r_win, z_win = op._windows(x, w5, vecs_t[2], vecs_t[3])
    winner, active = op._first_match(z_win), r_win > 0
    n_pc_t, n_active = winner.numel() // 3, int(active.sum())
    n_win_active, n_xhat = int((winner & active).sum()), int((winner | active).sum())
    del r_win, z_win, winner, active
    bb, byb = bound(n_pc_t * (33 + 2 + 3) + 2 * n_xhat + 9 * n_win_active + 14 * n_active,
                    4 * (x.numel() + g_t.numel() + 11 * w.shape[0]))
    print(f"  data (FlowMur, train): {n_pc_t} (position, channel) pairs, {n_active} active phases, "
          f"{n_win_active} active winners", flush=True)
    print(f"  B params bwd, train mode, FlowMur's shape x {tuple(x.shape)}, g {tuple(g_t.shape)}, device times: "
          f"kernel {ms_b:.4f} ms (CUDA events over back-to-back calls {event_b:.4f}), plain {plain_b:.4f} ms, "
          f"bound {bb:.4f} ms ({byb})", flush=True)

    model.eval()
    out1d = model.block1(x).detach().requires_grad_(True)
    labels = torch.full((x.shape[0],), 2, device="cuda")  # FlowMur's target class
    g = torch.autograd.grad(F.cross_entropy(model.head(out1d), labels), out1d)[0].contiguous()
    rmean, rinv = model.bn1.running_mean, torch.rsqrt(model.bn1.running_var + op.EPS)
    scale = gamma * rinv
    shift = beta - rmean * scale
    vecs = (rmean, rinv, scale, shift)
    dx = op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, train_bn=False)
    ref = op.conv1_bn_pool_backward_plain(x, g, w, b, *vecs, train_bn=False, need_dx=True, need_params=False)
    err = compare((dx, None, None, None, None), ref, "FlowMur eval")
    # Device times (profiler): at ~0.01 ms a call, CUDA events over
    # back-to-back launches time the host's launch path (events printed too).
    kernel = lambda: op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, train_bn=False)  # noqa: E731
    ms, event_ms = device_ms(torch, kernel, 50), time_ms(torch, kernel, 50)
    plain_ms = device_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g, w, b, *vecs, train_bn=False, need_dx=True, need_params=False), 10)
    # Yardstick: autograd dx through conv2d → relu → BN (running statistics) → max_pool2d.
    xg = x.detach().clone().requires_grad_(True)
    c4 = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    rr = torch.clamp(F.conv2d(xg, w, b), min=0.0)
    pooled = F.max_pool2d((rr - c4(rmean)) * c4(rinv) * c4(gamma) + c4(beta), (1, 3))
    library_ms = device_ms(torch, lambda: torch.autograd.grad(pooled, xg, g, retain_graph=True), 50)
    # Bound on this run's data, eval mode: per (position, channel) the
    # recompute (33) and the winner (2); on each active winner scale·g (1)
    # and four dp multiply-adds (8); at most three adds per x element in the
    # gather. No h terms. Bytes: x and g read, dx written, taps and three
    # vectors read.
    _, r_win, z_win = op._windows(x, w5, scale, shift)
    n_pc = r_win.numel() // 3
    n_win_active = int((op._first_match(z_win) & (r_win > 0)).sum())
    del r_win, z_win
    flops = n_pc * (33 + 2) + 9 * n_win_active + 3 * x.numel()
    bound_ms, bound_by = bound(flops, 4 * (2 * x.numel() + g.numel() + 8 * w.shape[0]))
    print(f"  data: {n_pc} (position, channel) pairs, {n_win_active} active winners", flush=True)
    print(f"  C input bwd, eval mode, FlowMur's shape x {tuple(x.shape)}, g {tuple(g.shape)}, device times: "
          f"kernel {ms:.4f} ms (CUDA events over back-to-back calls {event_ms:.4f}), plain {plain_ms:.4f} ms, "
          f"autograd dx yardstick {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    return dict(err_b=err_b, err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def block_yardstick(torch, x, w, b, gamma, beta, pool, padding, g, dtype):
    """Autograd through cuDNN's chain conv2d → relu → BN (batch statistics) →
    max_pool2d in ``dtype``: (ms for the parameters' gradients, ms for
    dx's)."""
    import torch.nn.functional as F

    xg = x.detach().clone().requires_grad_(True)
    params = [t.detach().clone().requires_grad_(True) for t in (w, b, gamma, beta)]
    c4 = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
    rr = torch.clamp(F.conv2d(xg.to(dtype), params[0].to(dtype)) + c4(params[1].to(dtype)), min=0.0).float()
    m_ = rr.mean(dim=(0, 2, 3))
    v_ = (rr * rr).mean(dim=(0, 2, 3)) - m_ * m_
    z = ((rr - c4(m_)) * c4(torch.rsqrt(v_ + 1e-5)) * c4(params[2]) + c4(params[3])).to(dtype)
    pooled = F.max_pool2d(z, pool, padding=padding)
    lib_p = time_ms(torch, lambda: torch.autograd.grad(pooled, params, g, retain_graph=True), 20)
    lib_x = time_ms(torch, lambda: torch.autograd.grad(pooled, xg, g, retain_graph=True), 20)
    return lib_p, lib_x


def bf16_compare(torch, names, got, ref, label) -> tuple[float, float]:
    """The bf16 modes against their plain versions: parameter gradients
    within 1e-3 * max|ref| + 1e-6 (f32 sums in another order, the same
    routing); dx, a bf16 sum of bf16 taps each summed over the channels in
    another order, within 2 bf16 ulps of max|dx|. (worst param, dx error)."""
    worst = {"params": 0.0, "dx": 0.0}
    for n, a, e in zip(names, got, ref):
        if a is None:
            continue
        err, rel, _ = max_err(torch, a.float(), e.float(), 0.0, 0.0)
        limit = 2 * 2.0 ** -7 * float(e.float().abs().max()) if n == "dx" else 1e-3 * float(e.abs().max()) + 1e-6
        same = float((a.float() == e.float()).double().mean()) if n == "dx" else None
        check(err <= limit, f"{label} {n} {tuple(a.shape)} {a.dtype}: max abs err {err:.3e} (rel to max "
              f"{rel:.3e}){'' if same is None else f', {100 * same:.2f}% bit-equal'}")
        key = "dx" if n == "dx" else "params"
        worst[key] = max(worst[key], err)
    return worst["params"], worst["dx"]


def phase_conv1_bf16(torch, ctx) -> list[dict]:
    import torch.nn.functional as F

    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv1_bn_pool as op

    bf16 = torch.bfloat16
    print("phase 1b (bf16): kernels B and C in bf16 mode vs plain at the main path's shape (x f32, g bf16); "
          "tolerance: parameter gradients max abs err <= 1e-3 * max|ref| + 1e-6, dx within 2 bf16 ulps of "
          "max|dx|", flush=True)
    model = build_model("smallcnn", 10, 3072, torch.device("cuda"), seed=35, fused=True, compute_dtype=bf16)
    model.train()
    x = ctx["feats"].contiguous()
    out1d = model.block1(x).detach().requires_grad_(True)
    labels = torch.randint(0, 10, (x.shape[0],), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    g = torch.autograd.grad(F.cross_entropy(model.head(out1d).float(), labels), out1d)[0].contiguous()
    check(g.dtype == bf16 and out1d.dtype == bf16, f"the bf16 model's block-1 output and its gradient are "
          f"{out1d.dtype}, {g.dtype}")
    w, b = model.conv1.weight.detach(), model.conv1.bias.detach()
    gamma, beta = model.bn1.weight.detach(), model.bn1.bias.detach()
    r = op._conv_relu(x, w, b, bf16)
    mu = r.mean(dim=(0, 2, 3))
    inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + op.EPS)
    del r
    scale = gamma * inv
    shift = beta - mu * scale
    vecs = (mu, inv, scale, shift)
    w5 = op._w5(w, b)
    names = ("dx", "dweight", "dbias", "dgamma", "dbeta")
    out_b = op.conv1_bn_pool_bwd_params(x, g, w5, *vecs, train_bn=True)
    h12 = out_b[7:9].contiguous()
    dx = op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, h12, train_bn=True)
    ref = op.conv1_bn_pool_backward_plain(x, g, w, b, *vecs, train_bn=True, need_dx=True)
    err_b, err_c = bf16_compare(torch, names, (dx, out_b[:4].t().reshape(w.shape), out_b[4], out_b[5], out_b[6]),
                                ref, "bf16 train")
    del ref
    ms_b = time_ms(torch, lambda: op.conv1_bn_pool_bwd_params(x, g, w5, *vecs, train_bn=True), 20)
    ms_c = time_ms(torch, lambda: op.conv1_bn_pool_bwd_input(x, g, w5, *vecs, h12, train_bn=True), 20)
    plain_b = time_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g, w, b, *vecs, train_bn=True, need_dx=False), 5, warmup=1)
    plain_bc = time_ms(torch, lambda: op.conv1_bn_pool_backward_plain(
        x, g, w, b, *vecs, train_bn=True, need_dx=True), 5, warmup=1)
    lib_b, lib_c = block_yardstick(torch, x, w, b, gamma, beta, (1, 3), 0, g, bf16)
    # Bounds counted as phase 1b counts them, on the bf16 routing; bytes: x
    # f32, g bf16 (2 bytes), dx f32 (the model input's dtype).
    _, r_win, z_win = op._windows(op.round_to(x, bf16), op.round_to(w5, bf16), scale, shift, bf16)
    winner, active = op._first_match(z_win), r_win > 0
    n_pc, n_active = winner.numel() // 3, int(active.sum())
    n_win_active, n_xhat = int((winner & active).sum()), int((winner | active).sum())
    del r_win, z_win, winner, active
    c = w.shape[0]
    x_bytes, g_bytes = 4 * x.numel(), 2 * g.numel()
    bb, byb = bound(n_pc * (33 + 2 + 3) + 2 * n_xhat + 9 * n_win_active + 14 * n_active,
                    x_bytes + g_bytes + 4 * 11 * c)
    bc, byc = bound(n_pc * (33 + 2) + 13 * n_active + n_win_active + 3 * x.numel(),
                    2 * x_bytes + g_bytes + 4 * 13 * c)
    print(f"  data (bf16): {n_pc} (position, channel) pairs, {n_active} active phases, {n_win_active} active "
          f"winners", flush=True)
    print(f"  B params bwd, bf16: kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms, autograd yardstick (cuDNN bf16) "
          f"{lib_b:.4f} ms, bound {bb:.4f} ms ({byb})", flush=True)
    print(f"  C input bwd, bf16, train mode, x {tuple(x.shape)}: kernel {ms_c:.4f} ms, plain (B+C) {plain_bc:.4f} ms, "
          f"autograd dx yardstick (cuDNN bf16) {lib_c:.4f} ms, bound {bc:.4f} ms ({byc})", flush=True)
    src = "audiobd_tpu_torch/csrc/conv1_bn_pool.cu"
    return [
        {"name": "conv1_bn_pool_bwd_params_bf16", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block.py:226", "max_abs_err": err_b, "ms": ms_b,
         "plain_ms": plain_b, "bound_ms": bb, "bound_by": byb, "library_ms": lib_b},
        {"name": "conv1_bn_pool_bwd_input_bf16", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block.py:243", "max_abs_err": err_c, "ms": ms_c,
         "plain_ms": plain_bc, "bound_ms": bc, "bound_by": byc, "library_ms": lib_c},
    ]


def conv2_bound(torch, op2, x, w257, scale, shift, pool_padding, nbytes_d, nbytes_e, dtype=None):
    """Least times for kernels D and E on this run's data: (D ms, by, E ms,
    by). D: per (conv position, channel) the recompute: 4·Cin products and
    sums, the bias, relu, z (8·Cin + 4). Per (window, channel) 3 compares for
    the winner. Only windows with output carry dz: S1, S2 (3) there. xhat (2)
    where it is used: active phases and winners. D's dwA (2K, K = 4·Cin + 1
    taps with the bias) only on active winners; dwB (K) and dwC (2K) on every
    active phase. E, from D's routing: per active phase xhat (2), dy (4) and
    the transposed product's 4·Cin multiply-adds. ``dtype`` is the compute
    dtype whose rounding routes the windows (f32 by default)."""
    dtype = dtype or torch.float32
    cin = x.shape[1]
    k = 4 * cin + 1
    p = op2._phase_patches(x.float(), pool_padding)
    r, z = op2._recompute(p, op2.round_to(w257, dtype), scale, shift, dtype)
    del p
    valid = torch.isfinite(z)
    winner = op2._first_match(z) & valid
    active = r > 0
    _, _, ho, wo, hc, wc = op2.pool_dims(x.shape[2], x.shape[3], pool_padding)
    has_out = torch.zeros((hc, wc), dtype=torch.bool, device=x.device)
    has_out[:ho, :wo] = True
    n_valid = int(valid.sum())
    n_win = winner.numel() // 4
    n_out = int((winner & has_out[None, None, :, :, None]).sum())
    n_active = int(active.sum())
    n_win_active = int((winner & active & has_out[None, None, :, :, None]).sum())
    n_xhat = int((winner | active).sum())
    del r, z, valid, winner, active
    recompute = n_valid * (8 * cin + 4) + 3 * n_win
    flops_d = recompute + 3 * n_out + 2 * n_xhat + 2 * k * n_win_active + 3 * k * n_active
    flops_e = n_active * (2 + 4 + 8 * cin)
    print(f"  data: {n_valid} (position, channel) pairs, {n_active} active, {n_win_active} active "
          f"winners with output; D {flops_d / 1e9:.3f} GFLOP, E {flops_e / 1e9:.3f} GFLOP", flush=True)
    return (*bound(flops_d, nbytes_d), *bound(flops_e, nbytes_e))


def phase_conv2(torch, ctx) -> list[dict]:
    import torch.nn.functional as F

    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv2_bn_pool as op2

    print("phase 1c: block-2/3 backward kernels (D, E) vs plain; tolerance max abs err <= "
          "1e-3 * max|ref| + 1e-6 per output (f32 sums of ~3e5 terms per entry in another order; "
          "dw is a difference of such sums)", flush=True)
    model = build_model("smallcnn", 10, 3072, torch.device("cuda"), seed=35, fused=True,
                        fused_block2=True, fused_block3=True)
    model.train()
    labels = torch.randint(0, 10, (ctx["feats"].shape[0],), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        x2 = model.block1(ctx["feats"]).contiguous()
        x3 = model.block2(x2).contiguous()
    x3d = x3.clone().requires_grad_(True)
    out3 = model.block3(x3d)
    out3d = out3.detach().requires_grad_(True)
    g3 = torch.autograd.grad(F.cross_entropy(model.classifier(out3d), labels), out3d)[0].contiguous()
    g2 = torch.autograd.grad(out3, x3d, g3)[0].contiguous()
    del x3d, out3, out3d
    names = ("dx", "dweight", "dbias", "dgamma", "dbeta")
    results = []
    for label, x, g, conv, bn, pad in (("block 2", x2, g2, model.conv2, model.bn2, (1, 1)),
                                       ("block 3", x3, g3, model.conv3, model.bn3, (0, 1))):
        w, b = conv.weight.detach(), conv.bias.detach()
        gamma, beta = bn.weight.detach(), bn.bias.detach()
        r = torch.clamp(F.conv2d(x, w, b), min=0.0)
        mu = r.mean(dim=(0, 2, 3))
        var = (r * r).mean(dim=(0, 2, 3)) - mu * mu
        inv = torch.rsqrt(var + op2.EPS)
        scale = gamma * inv
        shift = beta - mu * scale
        del r
        vecs = (mu, inv, scale, shift)
        got = op2.conv2_bn_pool_backward(x, g, w, b, *vecs, pool_padding=pad)  # kernels D, E
        torch.cuda.synchronize()
        ref = op2.conv2_bn_pool_backward_plain(x, g, w, b, *vecs, pool_padding=pad)
        errs = {}
        for n, a, e in zip(names, got, ref):
            errs[n], rel, _ = max_err(torch, a, e, 0.0, 0.0)
            check(errs[n] <= 1e-3 * float(e.abs().max()) + 1e-6,
                  f"{label} {n} {tuple(a.shape)}: max abs err {errs[n]:.3e} (rel to max {rel:.3e})")
        del got, ref

        w257 = op2.w257(w, b)
        k4 = 4 * x.shape[1]
        out_d, routing = op2.conv2_bn_pool_bwd_params(x, g, w257, *vecs, pool_padding=pad)
        h12 = out_d[k4 + 3 : k4 + 5].contiguous()
        enc_ref = op2.conv2_routing_plain(x, w257, scale, shift, pool_padding=pad)
        same_pattern = bool(torch.equal(torch.sign(routing.enc), torch.sign(enc_ref)))
        enc_err = float((routing.enc - enc_ref).abs().max())
        check(same_pattern and enc_err <= 1e-6 * float(enc_ref.abs().max()),
              f"{label} D's routing {tuple(routing.enc.shape)}: zero/sign pattern "
              f"{'equal' if same_pattern else 'DIFFERS'}, max abs err {enc_err:.3e}")
        del enc_ref
        ms_d = time_ms(torch, lambda: op2.conv2_bn_pool_bwd_params(x, g, w257, *vecs, pool_padding=pad), 20)
        ms_e = time_ms(torch, lambda: op2.conv2_bn_pool_bwd_input(routing, g, w257, mu, inv, scale, h12,
                                                                  pool_padding=pad), 20)
        plain_d = time_ms(torch, lambda: op2.conv2_bn_pool_backward_plain(
            x, g, w, b, *vecs, pool_padding=pad, need_dx=False), 3, warmup=1)
        plain_de = time_ms(torch, lambda: op2.conv2_bn_pool_backward_plain(
            x, g, w, b, *vecs, pool_padding=pad), 3, warmup=1)
        # Yardstick: autograd through conv2d → relu → BN (batch stats) → max_pool2d.
        xg = x.detach().clone().requires_grad_(True)
        params = [t.detach().clone().requires_grad_(True) for t in (w, b, gamma, beta)]
        rr = torch.clamp(F.conv2d(xg, params[0], params[1]), min=0.0)
        m_ = rr.mean(dim=(0, 2, 3))
        v_ = (rr * rr).mean(dim=(0, 2, 3)) - m_ * m_
        c4 = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
        pooled = F.max_pool2d((rr - c4(m_)) * c4(torch.rsqrt(v_ + op2.EPS)) * c4(params[2]) + c4(params[3]),
                              (2, 2), padding=pad)
        lib_d = time_ms(torch, lambda: torch.autograd.grad(pooled, params, g, retain_graph=True), 20)
        lib_e = time_ms(torch, lambda: torch.autograd.grad(pooled, xg, g, retain_graph=True), 20)
        del xg, params, rr, pooled

        # Bytes: x, g, the taps and the per-channel vectors read once; D's
        # (4·Cin + 5, C) result and routing written once; E reads the
        # routing, g, the taps and five vectors and writes dx.
        c = w.shape[0]
        route_n = routing.enc.numel()
        nbytes_d = 4 * (x.numel() + g.numel() + w257.numel() + 4 * c + (k4 + 5) * c + route_n)
        nbytes_e = 4 * (route_n + g.numel() + w257.numel() + 5 * c + x.numel())
        bd, byd, be, bye = conv2_bound(torch, op2, x, w257, scale, shift, pad, nbytes_d, nbytes_e)
        print(f"  {label} x {tuple(x.shape)}, g {tuple(g.shape)}, pool pad {pad}:", flush=True)
        print(f"    D params bwd: kernel {ms_d:.4f} ms, plain {plain_d:.4f} ms, autograd yardstick "
              f"{lib_d:.4f} ms, bound {bd:.4f} ms ({byd})", flush=True)
        print(f"    E input bwd from D's routing: kernel {ms_e:.4f} ms, plain (D+E) {plain_de:.4f} ms, "
              f"autograd dx yardstick {lib_e:.4f} ms, bound {be:.4f} ms ({bye})", flush=True)
        del routing
        results.append(dict(err_d=max(errs[n] for n in names[1:]), err_e=errs["dx"], ms_d=ms_d, ms_e=ms_e,
                            plain_d=plain_d, plain_de=plain_de, lib_d=lib_d, lib_e=lib_e,
                            bd=bd, byd=byd, be=be, bye=bye))
    # The row's times are block 2's, the larger of the two launches of each kernel a step.
    b2, src = results[0], "audiobd_tpu_torch/csrc/conv2_bn_pool.cu"
    return [
        {"name": "conv2_bn_pool_bwd_params", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block2.py:247",
         "max_abs_err": max(r["err_d"] for r in results), "ms": b2["ms_d"], "plain_ms": b2["plain_d"],
         "bound_ms": b2["bd"], "bound_by": b2["byd"], "library_ms": b2["lib_d"]},
        {"name": "conv2_bn_pool_bwd_input", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block2.py:265",
         "max_abs_err": max(r["err_e"] for r in results), "ms": b2["ms_e"], "plain_ms": b2["plain_de"],
         "bound_ms": b2["be"], "bound_by": b2["bye"], "library_ms": b2["lib_e"]},
    ]


def phase_conv2_bf16(torch, ctx) -> list[dict]:
    import torch.nn.functional as F

    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.ops import conv2_bn_pool as op2

    bf16 = torch.bfloat16
    print("phase 1c (bf16): kernels D and E in bf16 mode vs plain (x, g bf16); tolerance: parameter gradients "
          "max abs err <= 1e-3 * max|ref| + 1e-6, dx within 2 bf16 ulps of max|dx|, D's routing bit-equal",
          flush=True)
    model = build_model("smallcnn", 10, 3072, torch.device("cuda"), seed=35, fused=True, fused_block2=True,
                        fused_block3=True, compute_dtype=bf16)
    model.train()
    labels = torch.randint(0, 10, (ctx["feats"].shape[0],), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        x2 = model.block1(ctx["feats"]).contiguous()
        x3 = model.block2(x2).contiguous()
    x3d = x3.clone().requires_grad_(True)
    out3 = model.block3(x3d)
    out3d = out3.detach().requires_grad_(True)
    g3 = torch.autograd.grad(F.cross_entropy(model.classifier(out3d).float(), labels), out3d)[0].contiguous()
    g2 = torch.autograd.grad(out3, x3d, g3)[0].contiguous()
    del x3d, out3, out3d
    names = ("dx", "dweight", "dbias", "dgamma", "dbeta")
    results = []
    for label, x, g, conv, bn, pad in (("block 2", x2, g2, model.conv2, model.bn2, (1, 1)),
                                       ("block 3", x3, g3, model.conv3, model.bn3, (0, 1))):
        check(x.dtype == g.dtype == bf16, f"{label} bf16: x {x.dtype}, g {g.dtype}")
        w, b = conv.weight.detach(), conv.bias.detach()
        gamma, beta = bn.weight.detach(), bn.bias.detach()
        r = op2._conv_relu(x, w, b, bf16)
        mu = r.mean(dim=(0, 2, 3))
        inv = torch.rsqrt((r * r).mean(dim=(0, 2, 3)) - mu * mu + op2.EPS)
        del r
        scale = gamma * inv
        shift = beta - mu * scale
        vecs = (mu, inv, scale, shift)
        got = op2.conv2_bn_pool_backward(x, g, w, b, *vecs, pool_padding=pad)  # kernels D, E in bf16
        torch.cuda.synchronize()
        ref = op2.conv2_bn_pool_backward_plain(x, g, w, b, *vecs, pool_padding=pad)
        err_d, err_e = bf16_compare(torch, names, got, ref, f"{label} bf16")
        del got, ref
        w257 = op2.w257(w, b)
        k4 = 4 * x.shape[1]
        out_d, routing = op2.conv2_bn_pool_bwd_params(x, g, w257, *vecs, pool_padding=pad)
        h12 = out_d[k4 + 3 : k4 + 5].contiguous()
        enc_ref = op2.conv2_routing_plain(x, w257, scale, shift, pool_padding=pad, compute_dtype=bf16)
        same = float((routing.enc == enc_ref).double().mean())
        check(same == 1.0, f"{label} bf16 D's routing {tuple(routing.enc.shape)}: {100 * same:.4f}% bit-equal "
              f"to the plain routing")
        del enc_ref
        ms_d = time_ms(torch, lambda: op2.conv2_bn_pool_bwd_params(x, g, w257, *vecs, pool_padding=pad), 20)
        ms_e = time_ms(torch, lambda: op2.conv2_bn_pool_bwd_input(routing, g, w257, mu, inv, scale, h12,
                                                                  pool_padding=pad), 20)
        plain_d = time_ms(torch, lambda: op2.conv2_bn_pool_backward_plain(
            x, g, w, b, *vecs, pool_padding=pad, need_dx=False), 3, warmup=1)
        plain_de = time_ms(torch, lambda: op2.conv2_bn_pool_backward_plain(x, g, w, b, *vecs, pool_padding=pad),
                           3, warmup=1)
        lib_d, lib_e = block_yardstick(torch, x, w, b, gamma, beta, (2, 2), pad, g, bf16)
        # Bytes: x, g and dx bf16 (2 bytes), the routing, taps, vectors and
        # D's result f32.
        c = w.shape[0]
        route_n = routing.enc.numel()
        nbytes_d = 2 * (x.numel() + g.numel()) + 4 * (w257.numel() + 4 * c + (k4 + 5) * c + route_n)
        nbytes_e = 4 * (route_n + w257.numel() + 5 * c) + 2 * (g.numel() + x.numel())
        bd, byd, be, bye = conv2_bound(torch, op2, x, w257, scale, shift, pad, nbytes_d, nbytes_e, dtype=bf16)
        print(f"  {label} bf16 x {tuple(x.shape)}, g {tuple(g.shape)}, pool pad {pad}:", flush=True)
        print(f"    D params bwd: kernel {ms_d:.4f} ms, plain {plain_d:.4f} ms, autograd yardstick (cuDNN bf16) "
              f"{lib_d:.4f} ms, bound {bd:.4f} ms ({byd})", flush=True)
        print(f"    E input bwd from D's routing: kernel {ms_e:.4f} ms, plain (D+E) {plain_de:.4f} ms, "
              f"autograd dx yardstick (cuDNN bf16) {lib_e:.4f} ms, bound {be:.4f} ms ({bye})", flush=True)
        del routing
        results.append(dict(err_d=err_d, err_e=err_e, ms_d=ms_d, ms_e=ms_e, plain_d=plain_d, plain_de=plain_de,
                            lib_d=lib_d, lib_e=lib_e, bd=bd, byd=byd, be=be, bye=bye))
    b2, src = results[0], "audiobd_tpu_torch/csrc/conv2_bn_pool.cu"
    return [
        {"name": "conv2_bn_pool_bwd_params_bf16", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block2.py:247",
         "max_abs_err": max(r["err_d"] for r in results), "ms": b2["ms_d"], "plain_ms": b2["plain_d"],
         "bound_ms": b2["bd"], "bound_by": b2["byd"], "library_ms": b2["lib_d"]},
        {"name": "conv2_bn_pool_bwd_input_bf16", "route": "cuda", "source": src,
         "replaces": "audiobd_tpu/ops/fused_conv_block2.py:265",
         "max_abs_err": max(r["err_e"] for r in results), "ms": b2["ms_e"], "plain_ms": b2["plain_de"],
         "bound_ms": b2["be"], "bound_by": b2["bye"], "library_ms": b2["lib_e"]},
    ]


# The recursions' loop-carried chains a sample, by route, counted from
# csrc/effects.cu: the ladder at k = 0 (style 5's route) a one-pole's s → s′
# (u − s, ·G, + s, + v: 4; tanhf and stages 3-4 lie on no loop-carried chain,
# stage 2's chain runs behind stage 1's); the resonant ladder's s4 → s4 runs
# k·s4, the subtraction, tanhf (counted as one), then u − s1, ·G, + s1,
# u − lp1, and three more one-poles of 3 and the state add (17); the phaser's
# stages pipeline across samples, so its chain is one stage's a_t·ys_i and
# subtraction (2).
LADDER_CHAIN_OPS, LADDER_RESONANT_CHAIN_OPS, PHASER_CHAIN_OPS = 4, 17, 2
# f32 operations a sample the function needs: the k = 0 ladder x·drive, tanh
# (as one), 2 one-poles of 4 and 2 taps (12); the resonant ladder 2
# multiplies, a subtraction, tanh, 4 one-poles of 4, 2 taps (22); the phaser
# 4 a stage and the mix's 3.
LADDER_OPS, LADDER_RESONANT_OPS = 12, 22
FP32_LATENCY_CYCLES = 4  # a dependent f32 add or multiply on Hopper
# Kernel F's times at (256, 16000) before its redesign, the one-thread-a-row
# kernels (chip_smoke.py of that tree, H100 80GB HBM3 at 700.00 W), printed
# beside this run's.
F_ONE_THREAD_MS = {"effects_ladder": 1.546, "effects_ladder_resonant": 1.543, "effects_phaser": 1.066}


def phaser_ops(stages: int) -> int:
    return 4 * stages + 3


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def effects_inputs(torch, fx, rows: int, t: int):
    """Phase 1d's rows: tones of 200-1800 Hz with noise (seed 7), the same
    rows after style 5's 12 dB gain, and the phaser's a_t."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    n = torch.arange(t, device="cuda", dtype=torch.float32) / 16000
    f0 = 200.0 + 1600.0 * torch.rand(rows, 1, device="cuda", generator=gen)
    x = 0.4 * torch.sin(2 * math.pi * f0 * n) + 0.02 * torch.randn(rows, t, device="cuda", generator=gen)
    return x, fx.gain(x, 12.0), torch.from_numpy(fx.phaser_coefficients(t, 16000)).cuda()


def phase_effects(torch) -> list[dict]:
    """Phase 1d: kernel F's three routes against their plain loops on the
    card, each held exactly equal (torch.equal): at (256, 16000), the rows
    of a style-5 chunk, the k = 0 ladder with the chain's parameters (after
    its 12 dB gain), the resonant, driven ladder and the phaser with 6
    stages; at (37, 4001), a last chunk with an odd T, the k = 0 ladder, the
    phaser with 4 stages and the resonant ladder. At (256, 16000) each
    route's time (CUDA events over 20 launches after a warm-up) beside the
    one-thread kernels' before the redesign, and the one-thread kernel on
    the k = 0 ladder's work timed in this run; the plain loop's wall for one
    call, the bytes bound and the route's chain bound: T x the chain's
    dependent operations a sample x 4 cycles at the card's top SM clock."""
    from audiobd_tpu_torch.ops import effects as op
    from audiobd_tpu_torch.ops.build import ptr
    from audiobd_tpu_torch.poison import effects as fx

    print("phase 1d: kernel F (the effects' per-sample recursions) vs its plain loops; tolerance: exactly equal "
          "(the JAX step's order, no FMA, the same tanhf; the k = 0 ladder leaves out stages 3-4, which can change "
          "only a zero's sign)", flush=True)
    clock = sm_clock_hz()
    g = math.tan(math.pi * 1000.0 / 16000)
    big_g = g / (1 + g)
    results = {}
    for rows, t in ((256, 16000), (37, 4001)):
        x, chain_x, a = effects_inputs(torch, fx, rows, t)
        stages = 6 if rows == 256 else 4
        routes = (
            ("effects_ladder", "ladder, k = 0, the chain's parameters (after gain 12 dB; cutoff 1 kHz)",
             lambda: op.ladder_hpf12(chain_x, big_g, 0.0, 1.0),
             lambda: op.ladder_hpf12_plain(chain_x, big_g, 0.0, 1.0), LADDER_OPS, LADDER_CHAIN_OPS, 0),
            ("effects_ladder_resonant", "ladder, resonance 0.3 (k = 1.2), drive 6 dB",
             lambda: op.ladder_hpf12(x, big_g, 1.2, 10 ** (6 / 20)),
             lambda: op.ladder_hpf12_plain(x, big_g, 1.2, 10 ** (6 / 20)), LADDER_RESONANT_OPS,
             LADDER_RESONANT_CHAIN_OPS, 0),
            ("effects_phaser", f"phaser, {stages} stages, mix 0.5", lambda: op.phaser(x, a, stages, 0.5),
             lambda: op.phaser_plain(x, a, stages, 0.5), phaser_ops(stages), PHASER_CHAIN_OPS, 4 * t),
        )
        for name, label, kernel, plain, ops, chain, extra_bytes in routes:
            got = kernel()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = plain()
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = float((got - ref).abs().max())
            check(torch.equal(got, ref) and bool(torch.isfinite(got).all()) and got.shape == x.shape,
                  f"{label} at ({rows}, {t}): shape {tuple(got.shape)}, equal to the plain loop (max abs err "
                  f"{err:.3e}, {float((got == ref).double().mean()) * 100:.2f}% bit-equal)")
            row = results.setdefault(name, dict(err=0.0))
            row["err"] = max(row["err"], err)
            if rows == 256:
                ms = time_ms(torch, kernel, 20)
                nbytes = 2 * 4 * x.numel() + extra_bytes
                bms, by = bound(ops * x.numel(), nbytes)
                chain_ms = t * chain * FP32_LATENCY_CYCLES / clock * 1e3
                print(f"  {label}: kernel {ms:.4f} ms (one-thread kernel before the redesign "
                      f"{F_ONE_THREAD_MS[name]:.3f}), plain loop {plain_s * 1e3:.1f} ms (one call), bound "
                      f"{bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB), chain bound {chain_ms:.4f} ms ({t} samples x "
                      f"{chain} dependent operations x {FP32_LATENCY_CYCLES} cycles at {clock / 1e9:.3f} GHz), "
                      f"{chain_ms / ms * 100:.0f}% of it", flush=True)
                row.update(ms=ms, plain_ms=plain_s * 1e3, bound_ms=bms, bound_by=by)
            del got, ref
        if rows == 256:
            # The one-thread kernel (the resonant route's) on the k = 0 ladder's work, timed in this run.
            y = torch.empty_like(chain_x)
            one_thread_ms = time_ms(torch, lambda: op.LADDER_RESONANT_KERNEL(
                chain_x.device, ptr(chain_x), ptr(y), rows, t, big_g, 0.0, 1.0), 20)
            same = torch.equal(y, op.ladder_hpf12(chain_x, big_g, 0.0, 1.0))
            check(same, "the one-thread kernel at k = 0 equals the k = 0 pipeline")
            print(f"  the one-thread kernel on the k = 0 ladder's work: {one_thread_ms:.4f} ms; the pipeline "
                  f"{results['effects_ladder']['ms'] / one_thread_ms:.3f}x of it", flush=True)
    src = "audiobd_tpu_torch/csrc/effects.cu"
    replaces = {"effects_ladder": "audiobd_tpu/poison/effects.py:261",
                "effects_ladder_resonant": "audiobd_tpu/poison/effects.py:261",
                "effects_phaser": "audiobd_tpu/poison/effects.py:300"}
    return [{"name": name, "route": "cuda", "source": src, "replaces": replaces[name], "max_abs_err": r["err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": None} for name, r in results.items()]


MAIN_PER_CLASS = 2000  # the main path's synthetic clips a class
TRAIN_CLIPS = 16_000  # 80% of 20,000 synthetic clips
# Phases 3b and 5b, cut in depth to 5,000 clips to keep the script's wall
# near its earlier length; each still launches every kernel it drives.
CUT_PER_CLASS = 500
BATCH = 256


def run_cli(torch, kernels, label: str, flags: list[str], compute_dtype: str = "float32", workdir: str | None = None,
            per_class: int | None = None) -> tuple[dict[str, int], float, int]:
    """One CLI run of 2 epochs on ``10 * per_class`` synthetic clips (20,000
    unless cut) with ``flags``; checks its losses, CSV and checkpoint. A
    bf16 ``compute_dtype`` is given as a user gives it, by --config and a
    YAML with train: {compute_dtype: bfloat16}. The run's record tree goes to a temporary
    directory, or to ``workdir``, which outlives the call. Returns
    (launches, clips/s, train steps)."""
    import contextlib

    import numpy as np

    from audiobd_tpu_torch.cli import badnets as cli
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    per_class = per_class or MAIN_PER_CLASS
    cwd = os.getcwd()
    with contextlib.nullcontext(workdir) if workdir else tempfile.TemporaryDirectory() as tmp:
        if compute_dtype != "float32":
            yaml_path = os.path.join(tmp, "compute_dtype.yaml")
            with open(yaml_path, "w") as f:
                f.write(f"train:\n  compute_dtype: {compute_dtype}\n")
            flags = ["--config", yaml_path, *flags]
        print(f"{label}: python -m audiobd_tpu_torch badnets --synthetic --synthetic_per_class {per_class} "
              f"--num_epochs 2 {' '.join(flags)} ({10 * per_class:,} clips, batch {BATCH}, {compute_dtype})",
              flush=True)
        os.chdir(tmp)
        try:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            result = cli.main(["--synthetic", "--synthetic_per_class", str(per_class), "--num_epochs", "2",
                               "--patience", "20", "--result", "chip_smoke", *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            h = result.history
            print(f"  wall {wall:.1f} s; train clips/s {result.clips_per_sec:.1f}", flush=True)
            print(f"  checkpoint writes: {', '.join(f'{w * 1e3:.2f}' for w in result.checkpoint_walls)} ms beside "
                  f"an epoch wall of {8 * per_class / result.clips_per_sec * 1e3:.1f} ms", flush=True)
            for e in range(result.epochs_ran):
                print(f"  epoch {e + 1}: train loss {h['train_loss'][e]:.5f} clean loss "
                      f"{h['test_clean_loss'][e]:.5f} bd loss {h['test_bd_loss'][e]:.5f} "
                      f"clean acc {h['test_clean_acc'][e]:.2f} ASR {h['test_asr'][e]:.2f} "
                      f"train ASR {h['train_asr'][e]:.2f}", flush=True)
            print(f"  launches: {launches}", flush=True)
            check(result.epochs_ran == 2, "2 epochs ran")
            check(result.model.compute_dtype == getattr(torch, compute_dtype),
                  f"the trained model computes in {result.model.compute_dtype}")
            losses = h["train_loss"] + h["test_clean_loss"] + h["test_bd_loss"]
            check(all(math.isfinite(v) for v in losses), "every loss is finite")
            rec = os.path.join("record", "chip_smoke")
            with open(os.path.join(rec, "loss_result.csv")) as f:
                check(len(f.read().strip().splitlines()) == 3, "loss_result.csv has a header and 2 rows")
            sd, spec = load_checkpoint(rec)
            reloaded = build_model(spec["model"], spec["num_classes"], spec["feature_size"],
                                   torch.device("cpu"), seed=0)
            reloaded.load_state_dict(sd)
            feats = torch.from_numpy(np.load(os.path.join(rec, "SCDv1-10", "bd", "bd_test_mfcc.npy"))[:64])
            check(tuple(feats.shape[1:]) == (1, 101, 40), f"bd features shaped {tuple(feats.shape)}")
            with torch.no_grad():
                logits = reloaded.eval()(feats)
            check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (64, 10),
                  f"checkpoint reloads as {type(reloaded).__name__} on the CPU and gives finite "
                  f"(64, 10) logits")
            steps = result.epochs_ran * -(-(8 * per_class) // BATCH)  # 80% of the clips train
        finally:
            os.chdir(cwd)
    return launches, result.clips_per_sec, steps


def phase_main_path(torch, kernels, workdir: str) -> tuple[dict[str, int], float, tuple[float, float]]:
    """Phase 2; its record tree stays in ``workdir`` for phase 7. Returns
    its launches, clips/s, and clean accuracy and ASR at epoch 2 (for phase
    12b)."""
    launches, clips, _ = run_cli(torch, kernels, "phase 2: main path", [], workdir=workdir)
    check(launches["mfcc_fft"] > 0, f"MFCC kernel, FFT path, launched {launches['mfcc_fft']} times")
    for name in ("mfcc_bluestein", "mfcc_fft_large", "mfcc_fft_device"):
        check(launches[name] == 0, f"MFCC kernel {name} launched {launches[name]} times (none on this path)")
    check(launches["conv1_bn_pool_bwd_params"] > 0,
          f"block-1 backward kernel launched {launches['conv1_bn_pool_bwd_params']} times")
    acc = _csv_rows(os.path.join(workdir, "record", "chip_smoke", "acc_result.csv"))[-1]
    return launches, clips, (float(acc[2]), float(acc[3]))


def _csv_rows(path: str) -> list[list[str]]:
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def _finite_rows(rows: list[list[str]]) -> bool:
    """Every cell of the rows below the header that is a number is finite."""
    values = []
    for row in rows[1:]:
        for cell in row:
            try:
                values.append(float(cell))
            except ValueError:
                pass
    return bool(values) and all(math.isfinite(v) for v in values)


DEFENSE_RUNS = (
    # (name, argv, the depth cut against the reference)
    ("fp", ["fp"], "defaults: one fine-tune epoch, as the reference"),
    ("ft_reg", ["ft_reg", "--ft_epochs", "10"], "10 SAM epochs (the reference runs 300)"),
    ("tsbd", ["tsbd"], "the default branch, stage A: one fine-tune epoch, as the reference"),
    ("tsbd_full", ["tsbd", "--only_finetune", "false", "--unlearn_epochs", "100", "--ft_epochs", "10"],
     "at most 100 unlearning epochs and 10 + 1 fine-tune epochs a ratio (the reference runs 1,000 and 51 + 1), "
     "all 11 ratios"),
    ("correlation", ["correlation_analysis"], "defaults: 10 unlearning epochs a copy, as the reference"),
)


def phase_defenses(torch, kernels, workdir: str) -> dict[str, int]:
    """Phase 7: the three defenses and the correlation analysis at full
    width, each through ``python -m audiobd_tpu_torch <defense>`` on phase
    2's record (BadNets → SmallCNN, 20,000 clips, 2 epochs; the 5% val split
    is 800 clips, 4 steps at batch 256). Block 1 is fused: the fine-tunes
    launch kernel B in train mode, FT-reg's SAM steps (2 a step) and the
    unlearning ascents (1 a step) in eval mode, each counted apart. Checks
    every CSV and artifact, finite numbers, r in [-1, 1], and each run's
    launches by mode against its step count. Returns the launches summed
    over the five runs."""
    import numpy as np

    from audiobd_tpu_torch.__main__ import main as cli

    base = os.path.join(workdir, "record", "chip_smoke", "defense")
    steps = -(-int(TRAIN_CLIPS * 0.05) // BATCH)  # fine-tune and SAM steps an epoch on the val split
    totals = {k.name: 0 for k in kernels}
    print(f"phase 7: the defense chain on phase 2's record (SmallCNN, f32, block 1 fused; val split "
          f"{int(TRAIN_CLIPS * 0.05)} clips, {steps} steps an epoch at batch {BATCH})", flush=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for name, argv, cut in DEFENSE_RUNS:
            print(f"  {name}: python -m audiobd_tpu_torch {' '.join(argv)} --result chip_smoke; depth: {cut}",
                  flush=True)
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            result = cli([*argv, "--result", "chip_smoke"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels if k.launches}
            for k in kernels:
                totals[k.name] += k.launches
            train = launches.get("conv1_bn_pool_bwd_params", 0)
            ev = launches.get("conv1_bn_pool_bwd_params_eval", 0)
            print(f"  {name}: wall {wall:.2f} s; kernel B launches: train mode {train}, eval mode {ev}; all "
                  f"launches {launches}", flush=True)
            if name == "fp":
                print(f"  fp: pruned {result.pruned_channels} of 128 inputs of fc2; after the fine-tune clean acc "
                      f"{result.test_acc:.2f}, ASR {result.test_asr:.2f}", flush=True)
                rows = _csv_rows(os.path.join(base, "fp", "pruning_data.csv"))
                ft = _csv_rows(os.path.join(base, "fp", "ft_data.csv"))
                check(rows[0] == ["num_pruned", "pruning_ratio", "test_acc", "test_asr"] and len(rows) >= 2
                      and _finite_rows(rows) and len(ft) == 2 and _finite_rows(ft),
                      f"fp: pruning_data.csv ({len(rows) - 1} levels) and ft_data.csv written, finite")
                want = (steps, 0)
            elif name == "ft_reg":
                for ratio, acc, asr in result.per_ratio:
                    print(f"  ft_reg: prune ratio {ratio}: clean acc {acc:.2f}, ASR {asr:.2f}", flush=True)
                rows = _csv_rows(os.path.join(base, "ft_reg", "pruning_data.csv"))
                check(len(rows) == 12 and _finite_rows(rows) and np.isfinite(result.scores).all()
                      and result.scores.shape == (160,), "ft_reg: pruning_data.csv has 11 finite rows, 160 scores")
                want = (0, 2 * steps * 10)
            elif name == "tsbd":
                print(f"  tsbd (stage A): clean acc {result.test_acc:.2f}, ASR {result.test_asr:.2f}", flush=True)
                rows = _csv_rows(os.path.join(base, "tsbd", "finetuning_data.csv"))
                check(result.stage == "finetune" and len(rows) == 2 and _finite_rows(rows),
                      "tsbd stage A: finetuning_data.csv has one finite row")
                want = (steps, 0)
            elif name == "tsbd_full":
                print(f"  tsbd (full): {result.unlearn_epochs} unlearning epochs", flush=True)
                for ratio, acc, asr in result.per_ratio:
                    print(f"  tsbd: reinit ratio {ratio}: clean acc {acc:.2f}, ASR {asr:.2f} after the fine-tune",
                          flush=True)
                ckpt = os.path.join(base, "tsbd", "checkpoint")
                files = [os.path.join(ckpt, f) for f in ("ucn.txt", "n2w_dict.json", "unlearned_model.pt",
                                                         "grad_avg_conv3.weight.csv", "grad_var_conv3.weight.csv")]
                missing = [f for f in files if not os.path.exists(f)]
                prune = _csv_rows(os.path.join(base, "tsbd", "pruning_data.csv"))
                ft = _csv_rows(os.path.join(base, "tsbd", "finetuning_data.csv"))
                grads = _csv_rows(files[3])
                check(not missing and len(prune) == 12 and len(ft) == 1 + 11 * 2 and _finite_rows(prune)
                      and _finite_rows(ft) and len(grads) == 1 + result.unlearn_epochs and _finite_rows(grads)
                      and 1 <= result.unlearn_epochs <= 100,
                      f"tsbd full: ucn.txt, n2w_dict.json, unlearned_model.pt, the grad CSVs "
                      f"({result.unlearn_epochs} rows), pruning_data.csv (11 rows) and finetuning_data.csv (22 "
                      f"rows: epochs 0 and 10 of each ratio) written, finite (missing: {missing})")
                want = (11 * 11 * steps, result.unlearn_epochs)
            else:
                print(f"  correlation: Pearson r {result.pearson_r:.4f}", flush=True)
                rows = _csv_rows(os.path.join(base, "correlation", "nwc_correlation.csv"))
                check(-1.0 <= result.pearson_r <= 1.0 and len(rows) == 161 and _finite_rows(rows),
                      f"correlation: r = {result.pearson_r:.4f} in [-1, 1], nwc_correlation.csv has 160 finite rows")
                want = (0, 2 * 10)
            check((train, ev) == want, f"{name}: kernel B launched {train} times in train mode and {ev} in eval "
                  f"mode (expected {want[0]} and {want[1]})")
            if name in ("ft_reg", "tsbd_full", "correlation"):
                check(ev > 0, f"{name}: kernel B's eval mode launched ({ev})")
    finally:
        os.chdir(cwd)
    return totals


def phase_block23_paths(torch, kernels, main_clips: float) -> dict[str, int]:
    flags = ["--fused_block2", "on", "--fused_block3", "on"]
    launches, lstm_clips, steps = run_cli(
        torch, kernels, "phase 3: block-2/3 path, SmallLSTM", ["--model", "smalllstm", *flags])
    for name in ("conv2_bn_pool_bwd_params", "conv2_bn_pool_bwd_input"):
        check(launches[name] == 2 * steps,
              f"{name} launched {launches[name]} times (2 blocks x {steps} steps)")
    check(launches["conv1_bn_pool_bwd_params"] > 0,
          f"block-1 backward kernel launched {launches['conv1_bn_pool_bwd_params']} times")
    cnn_launches, cnn_clips, cnn_steps = run_cli(
        torch, kernels, "phase 3b: block-2/3 kernels on SmallCNN", flags, per_class=CUT_PER_CLASS)
    check(cnn_launches["conv2_bn_pool_bwd_params"] == 2 * cnn_steps,
          f"conv2_bn_pool_bwd_params launched {cnn_launches['conv2_bn_pool_bwd_params']} times on SmallCNN")
    print(f"  train clips/s: SmallCNN default {main_clips:.1f} (phase 2), SmallLSTM blocks 2-3 on D/E "
          f"{lstm_clips:.1f} (phase 3); SmallCNN blocks 2-3 on D/E {cnn_clips:.1f} (phase 3b, "
          f"{10 * CUT_PER_CLASS:,} clips)", flush=True)
    return launches


def phase_bf16_paths(torch, kernels) -> dict[str, int]:
    """Phases 5 and 5b: the bf16 slice's paths through the CLI. Returns the
    launches of both runs, each kernel's count from the run that drives it
    (B's from phase 5, D's and E's from phase 5b)."""
    launches, clips, steps = run_cli(torch, kernels, "phase 5: path 1, BadNets → SmallCNN in bf16", [],
                                     compute_dtype="bfloat16")
    check(launches["conv1_bn_pool_bwd_params_bf16"] == steps and launches["conv1_bn_pool_bwd_params"] == 0,
          f"kernel B launched {launches['conv1_bn_pool_bwd_params_bf16']} times in bf16 mode ({steps} steps), "
          f"{launches['conv1_bn_pool_bwd_params']} in f32")
    check(launches["mfcc_fft"] > 0, f"MFCC kernel, FFT path, launched {launches['mfcc_fft']} times")
    lstm, lstm_clips, lstm_steps = run_cli(
        torch, kernels, "phase 5b: path 2, BadNets → SmallLSTM in bf16, blocks 2-3 on D/E",
        ["--model", "smalllstm", "--fused_block2", "on", "--fused_block3", "on"], compute_dtype="bfloat16",
        per_class=CUT_PER_CLASS)
    for name in ("conv2_bn_pool_bwd_params_bf16", "conv2_bn_pool_bwd_input_bf16"):
        check(lstm[name] == 2 * lstm_steps, f"{name} launched {lstm[name]} times (2 blocks x {lstm_steps} steps)")
    check(lstm["conv1_bn_pool_bwd_params_bf16"] == lstm_steps,
          f"kernel B launched {lstm['conv1_bn_pool_bwd_params_bf16']} times in bf16 mode on SmallLSTM")
    f32 = [n for n in ("conv1_bn_pool_bwd_params", "conv2_bn_pool_bwd_params", "conv2_bn_pool_bwd_input")
           if launches[n] or lstm[n]]
    check(not f32, f"no f32 block kernel launched in the bf16 runs (launched: {f32})")
    print(f"  train clips/s in bf16: SmallCNN {clips:.1f} (phase 5), SmallLSTM blocks 2-3 on D/E {lstm_clips:.1f} "
          f"(phase 5b, {10 * CUT_PER_CLASS:,} clips)", flush=True)
    return {**launches, **{n: lstm[n] for n in ("conv2_bn_pool_bwd_params_bf16", "conv2_bn_pool_bwd_input_bf16")}}


FLOWMUR_HOSTS, FLOWMUR_OPT_EPOCHS = 5000, 2


def _r(values) -> list[float]:
    return [round(float(v), 5) for v in values]


def phase_flowmur(torch, kernels, route: str) -> dict[str, int]:
    """Phase 4: the FlowMur CLI at full width (SmallCNN surrogates and victim
    at FlowMur's 224-feature flatten, 3 members, 5,000 hosts, batch 256, a
    0.5 s trigger), cut in depth to 2 epochs a stage."""
    import numpy as np

    from audiobd_tpu_torch.cli import flowmur as cli
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    flags = ["--synthetic", "--synthetic_per_class", "2000", "--surrogate_epochs", "2", "--opt_epochs",
             str(FLOWMUR_OPT_EPOCHS), "--num_epochs", "2", "--patience", "20", "--result", "chip_smoke_flowmur"]
    print(f"phase 4: FlowMur path: python -m audiobd_tpu_torch flowmur {' '.join(flags)} (20,000 clips, 3 "
          f"surrogates, {FLOWMUR_HOSTS} hosts, batch {BATCH}, 0.5 s trigger, f32)", flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            run = cli.main(flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            stages = run.stages
            steps = (FLOWMUR_HOSTS // BATCH) * FLOWMUR_OPT_EPOCHS
            print(f"  wall {wall:.1f} s; launches: {launches}", flush=True)
            for name, st in stages.items():
                extra = f", {st['wall_s'] * 1e3 / steps:.2f} ms a step over {steps} steps" if name == "trigger" else ""
                print(f"  stage {name}: wall {st['wall_s']:.3f} s{extra}; launches {st['launches']}", flush=True)
            for i, m in enumerate(run.surrogates):
                print(f"  surrogate {i}: train loss {_r(m.history['train_loss'])}, val loss "
                      f"{_r(m.history['val_loss'])}, val acc {_r(m.history['val_acc'])}", flush=True)
            h = run.victim.history
            print(f"  trigger search summed losses {_r(run.trigger_losses)}; victim train loss {_r(h['train_loss'])}, "
                  f"clean acc {_r(h['test_clean_acc'])}, ASR {_r(h['test_asr'])}", flush=True)
            losses = run.trigger_losses + h["train_loss"] + h["test_clean_loss"] + h["test_bd_loss"]
            losses += [v for m in run.surrogates for v in m.history["train_loss"] + m.history["val_loss"]]
            check(len(run.surrogates) == 3 and len(run.trigger_losses) == FLOWMUR_OPT_EPOCHS
                  and run.victim.epochs_ran == 2, "3 surrogates, 2 search epochs and 2 victim epochs ran")
            check(all(math.isfinite(v) for v in losses), f"every surrogate, trigger and victim loss is finite "
                  f"({len(losses)} losses)")
            trig = run.trigger
            check(trig.shape == (1, 8000) and float(np.abs(trig).max()) <= 0.2 and not np.allclose(trig, 0.1),
                  f"trigger shaped {trig.shape}, max |trigger| {float(np.abs(trig).max()):.4f} <= 0.2, moved off 0.1")
            c_search = stages["trigger"]["launches"].get("conv1_bn_pool_bwd_input", 0)
            check(c_search == steps and launches["conv1_bn_pool_bwd_input"] == steps,
                  f"kernel C launched {c_search} times in the search, {launches['conv1_bn_pool_bwd_input']} in "
                  f"all: one a search step ({FLOWMUR_HOSTS // BATCH} x {FLOWMUR_OPT_EPOCHS})")
            b = {name: st["launches"].get("conv1_bn_pool_bwd_params", 0) for name, st in stages.items()}
            check(b["trigger"] == 0 and b["surrogates"] > 0 and b["victim"] > 0,
                  f"kernel B launched {b['trigger']} times in the search, {b['surrogates']} in surrogate and "
                  f"{b['victim']} in victim training")
            prep_a = stages["prep"]["launches"].get(route, 0)
            check(prep_a > 0, f"kernel A's route for n_fft 2048 ({route}) launched {prep_a} times in the prep")
            rec = os.path.join("record", "chip_smoke_flowmur")
            data = os.path.join(rec, "SCDv1-10")
            clean_files = [os.path.join(data, "clean", n + ".npy") for n in (
                "clean_train_wav", "clean_test_wav", "clean_train_mfcc", "clean_test_mfcc", "clean_train_label",
                "clean_test_label")]
            bd_files = [os.path.join(data, "bd", n + ".npy") for n in (
                "bd_train_wav", "bd_train_mfcc", "bd_train_label", "poison_index_train", "bd_test_wav",
                "bd_test_mfcc", "bd_test_label", "poison_index_test")]
            members = [os.path.join(rec, "poisoning_record", f"surrogate_{i}", "torch_checkpoint", "model.pt")
                       for i in range(3)]
            csvs = [os.path.join(rec, n) for n in ("loss_result.csv", "acc_result.csv")]
            missing = [f for f in clean_files + bd_files + members + csvs if not os.path.exists(f)]
            check(not missing, f"the six clean npys, eight bd npys, three member checkpoints and the victim's "
                  f"CSVs exist (missing: {missing})")
            sd, spec = load_checkpoint(rec)
            reloaded = build_model(spec["model"], spec["num_classes"], spec["feature_size"],
                                   torch.device("cpu"), seed=0)
            reloaded.load_state_dict(sd)
            feats = torch.from_numpy(np.load(bd_files[5])[:64])
            with torch.no_grad():
                logits = reloaded.eval()(feats)
            check(tuple(feats.shape[1:]) == (1, 32, 13) and bool(torch.isfinite(logits).all())
                  and tuple(logits.shape) == (64, 10),
                  f"victim checkpoint reloads on the CPU: finite {tuple(logits.shape)} logits on "
                  f"{tuple(feats.shape[1:])} features")
        finally:
            os.chdir(cwd)
    return launches


ULTRA_PER_CLASS, ULTRA_EXTRA = 2000, 5  # 1-s 16 kHz clips a class; clips shorter than 1 s, and at 44.1 kHz, a class


def write_wav_tree(root: str, labels: list[str], per_class: int = ULTRA_PER_CLASS, at_44k: int = ULTRA_EXTRA,
                   short_16k: int = ULTRA_EXTRA, short_44k: int = 0) -> None:
    """A tree of PCM16 clips at ``root/<label>/*.wav``, per class:
    ``per_class`` one-second 16 kHz clips (a tone burst of the class's
    pitch and noise, as the synthetic set's), ``at_44k`` one-second 44.1 kHz
    clips of the same kind, ``short_16k`` 16 kHz noise clips shorter than 1
    s (8,000 to 15,999 samples) and ``short_44k`` half-second 44.1 kHz tone
    bursts. Ultrasonic's ingest (phase 6) keeps the first two kinds (its
    1-s filter drops the short clips; 44.1 kHz needs no resampling there);
    the serving phase (10) classifies every clip."""
    import numpy as np

    from audiobd_tpu_torch.data.wavio import write_wav

    rng = np.random.default_rng(8)

    def bursts(rate: int, n: int, count: int, cls: int) -> np.ndarray:
        t = np.arange(n, dtype=np.float32) / rate
        f0 = (200.0 + 160.0 * cls) * (1.0 + 0.03 * rng.standard_normal((count, 1)))
        env = np.exp(-((t - rng.uniform(0.3, 0.7, (count, 1)) * n / rate) ** 2) / 0.05)
        wav = 0.4 * env * np.sin(2 * np.pi * f0 * t + rng.uniform(0, 2 * np.pi, (count, 1)))
        wav += 0.3 * env * np.sin(4 * np.pi * f0 * t) + 0.02 * rng.standard_normal((count, n))
        return wav.astype(np.float32)

    for cls, label in enumerate(labels):
        d = os.path.join(root, label)
        os.makedirs(d)
        for rate, count in ((16000, per_class), (44100, at_44k)):
            for i, clip in enumerate(bursts(rate, rate, count, cls)):
                write_wav(os.path.join(d, f"{rate}_{i:05d}.wav"), clip, rate)
        for i, n in enumerate(np.linspace(8000, 15999, short_16k).astype(int)):
            write_wav(os.path.join(d, f"short_{i}.wav"), (0.1 * rng.standard_normal(n)).astype(np.float32), 16000)
        for i, clip in enumerate(bursts(44100, 22050, short_44k, cls)):
            write_wav(os.path.join(d, f"short44k_{i}.wav"), clip, 44100)


def phase_ultrasonic(torch, kernels) -> dict[str, int]:
    """Phase 6: ``python -m audiobd_tpu_torch ultrasonic`` on a wav tree of
    16 kHz clips at full width (SmallCNN, its 3072-feature flatten), batch
    256, cut to 2 epochs: native decode, resampling to 44.1 kHz on the card,
    kernel A's Bluestein route (n_fft 1103) in the prep and the poisoning,
    kernel B once a training step at (256, 1, 100, 40)."""
    import numpy as np

    from audiobd_tpu_torch.cli import ultrasonic as cli
    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    cfg = make_config("ultrasonic")
    n_labels = len(cfg.labels)
    print(f"phase 6: Ultrasonic from a wav tree: python -m audiobd_tpu_torch ultrasonic --num_epochs 2 "
          f"({n_labels} classes x ({ULTRA_PER_CLASS} one-second 16 kHz clips + {ULTRA_EXTRA} shorter + {ULTRA_EXTRA} "
          f"at 44.1 kHz), batch {BATCH}, f32)", flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            write_wav_tree(cfg.data_path, cfg.labels)
            print(f"  wrote the wav tree in {time.perf_counter() - t0:.1f} s; {shutil.disk_usage(tmp).free / 1e9:.1f} "
                  f"GB free where the run writes", flush=True)
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            run = cli.main(["--num_epochs", "2", "--patience", "20"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            h, st = run.result.history, run.stages
            walls = run.prep_walls or {}
            print(f"  wall {wall:.1f} s; prep {st['prep']['wall_s']:.3f} s (decode {walls.get('decode', 0):.3f} s, "
                  f"resample {walls.get('resample', 0):.3f} s, MFCC {walls.get('mfcc', 0):.3f} s, the rest the npy "
                  f"cache), poison {st['poison']['wall_s']:.3f} s, train {st['train']['wall_s']:.3f} s; train "
                  f"clips/s {run.result.clips_per_sec:.1f}", flush=True)
            for e in range(run.result.epochs_ran):
                print(f"  epoch {e + 1}: train loss {h['train_loss'][e]:.5f} clean loss {h['test_clean_loss'][e]:.5f} "
                      f"bd loss {h['test_bd_loss'][e]:.5f} clean acc {h['test_clean_acc'][e]:.2f} ASR "
                      f"{h['test_asr'][e]:.2f}", flush=True)
            print(f"  launches: {launches}; by stage {({n: v['launches'] for n, v in st.items()})}", flush=True)
            n_clips = n_labels * (ULTRA_PER_CLASS + ULTRA_EXTRA)
            check(run.n_clips == n_clips, f"{run.n_clips} clips pass the 1-s filter (expected {n_clips}: the "
                  f"{n_labels * ULTRA_EXTRA} shorter ones dropped)")
            data = os.path.join(cfg.record_dir, cfg.dataset)
            ind = {s: np.load(os.path.join(data, "bd", f"poison_index_{s}.npy")) for s in ("train", "test")}
            chunks = lambda n: -(-int(n) // 2048)  # noqa: E731  (batched_mfcc_device's chunk)
            want = {"prep": chunks(n_labels * ULTRA_EXTRA) + chunks(n_labels * ULTRA_PER_CLASS),
                    "poison": chunks(ind["train"].sum()) + chunks(ind["test"].sum())}
            for stage, n in want.items():
                got = st[stage]["launches"]
                check(got.get("mfcc_bluestein", 0) == n and set(got) == {"mfcc_bluestein"},
                      f"kernel A's Bluestein route launched {got.get('mfcc_bluestein', 0)} times in the {stage} stage "
                      f"(expected {n}), no other kernel there ({got})")
            others = [n for n in ("mfcc_fft", "mfcc_fft_large", "mfcc_fft_device") if launches[n]]
            check(not others, f"no other route of kernel A launched (launched: {others})")
            steps = run.result.epochs_ran * -(-len(ind["train"]) // BATCH)
            check(launches["conv1_bn_pool_bwd_params"] == steps,
                  f"kernel B launched {launches['conv1_bn_pool_bwd_params']} times ({steps} training steps)")
            losses = h["train_loss"] + h["test_clean_loss"] + h["test_bd_loss"]
            check(run.result.epochs_ran == 2 and all(math.isfinite(v) for v in losses),
                  "2 epochs ran and every loss is finite")
            check_record(torch, build_model, load_checkpoint, cfg.record_dir, data)
        finally:
            os.chdir(cwd)
    return launches


def check_record(torch, build_model, load_checkpoint, record: str, data: str,
                 feats_shape: tuple[int, ...] = (1, 100, 40)) -> None:
    """The six clean npys, the eight bd npys and the CSVs exist, and the
    checkpoint reloads on the CPU and gives finite logits on ``feats_shape``
    features."""
    import numpy as np

    names = [os.path.join("clean", f"clean_{s}_{k}.npy") for s in ("train", "test") for k in ("wav", "mfcc", "label")]
    names += [os.path.join("bd", f"{n}.npy") for n in (
        "bd_train_wav", "bd_test_wav", "bd_train_mfcc", "bd_test_mfcc", "bd_train_label", "bd_test_label",
        "poison_index_train", "poison_index_test")]
    files = [os.path.join(data, n) for n in names] + [os.path.join(record, n) for n in ("loss_result.csv",
                                                                                       "acc_result.csv")]
    missing = [f for f in files if not os.path.exists(f)]
    check(not missing, f"the six clean npys, eight bd npys and the CSVs exist (missing: {missing})")
    sd, spec = load_checkpoint(record)
    reloaded = build_model(spec["model"], spec["num_classes"], spec["feature_size"], torch.device("cpu"), seed=0,
                           n_mfcc=spec["n_mfcc"])
    reloaded.load_state_dict(sd)
    feats = torch.from_numpy(np.load(os.path.join(data, "bd", "bd_test_mfcc.npy"), mmap_mode="r")[:64].copy())
    with torch.no_grad():
        logits = reloaded.eval()(feats)
    check(tuple(feats.shape[1:]) == feats_shape and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (64, 10),
          f"checkpoint reloads as {type(reloaded).__name__} on the CPU: finite {tuple(logits.shape)} logits on "
          f"{tuple(feats.shape[1:])} features")


ULTRA_MODELS = ("largecnn", "lstmwithattention", "rnn", "resnet")
ULTRA_MODELS_PER_CLASS = 300


def phase_ultrasonic_models(torch, kernels) -> None:
    """Phase 6b: the four models without a fused block, each at full width
    through ``ultrasonic --synthetic --model <m>`` on 3,000 synthetic 44.1 kHz
    clips, batch 256, 2 epochs."""
    from audiobd_tpu_torch.cli import ultrasonic as cli
    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    cwd = os.getcwd()
    for name in ULTRA_MODELS:
        flags = ["--synthetic", "--synthetic_per_class", str(ULTRA_MODELS_PER_CLASS), "--model", name,
                 "--num_epochs", "2", "--patience", "20"]
        print(f"phase 6b: python -m audiobd_tpu_torch ultrasonic {' '.join(flags)} ({10 * ULTRA_MODELS_PER_CLASS} "
              f"clips, batch {BATCH}, f32)", flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                for k in kernels:
                    k.launches = 0
                run = cli.main(flags)
                torch.cuda.synchronize()
                launches = {k.name: k.launches for k in kernels if k.launches}
                h = run.result.history
                print(f"  {name}: train clips/s {run.result.clips_per_sec:.1f}; train loss {_r(h['train_loss'])}, "
                      f"clean acc {_r(h['test_clean_acc'])}, ASR {_r(h['test_asr'])}; launches {launches}", flush=True)
                losses = h["train_loss"] + h["test_clean_loss"] + h["test_bd_loss"]
                check(type(run.result.model).__name__.lower() == name and run.result.epochs_ran == 2
                      and all(math.isfinite(v) for v in losses), f"{name}: 2 epochs ran, every loss finite")
                check(set(launches) == {"mfcc_bluestein"}, f"{name}: kernel A's Bluestein route alone launched "
                      f"({launches}); the model has no fused block")
                cfg = make_config("ultrasonic", model=name)
                check_record(torch, build_model, load_checkpoint, cfg.record_dir,
                             os.path.join(cfg.record_dir, cfg.dataset))
            finally:
                os.chdir(cwd)


def _chunks(n, size: int) -> int:
    return -(-int(n) // size)


def _print_stages(run) -> None:
    for name, st in run.stages.items():
        print(f"  stage {name}: wall {st['wall_s']:.3f} s; launches {st['launches']}", flush=True)
    h = run.result.history
    print(f"  train clips/s {run.result.clips_per_sec:.1f}; train loss {_r(h['train_loss'])}, clean acc "
          f"{_r(h['test_clean_acc'])}, ASR {_r(h['test_asr'])}", flush=True)
    losses = h["train_loss"] + h["test_clean_loss"] + h["test_bd_loss"]
    check(run.result.epochs_ran == 2 and all(math.isfinite(v) for v in losses), "2 epochs ran, every loss finite")


def phase_jingleback(torch, kernels) -> dict[str, int]:
    """Phase 8: ``python -m audiobd_tpu_torch jingleback --style 5`` at full
    width (20,000 synthetic clips, SmallCNN with its 3072-feature flatten,
    batch 256, f32), cut to 2 epochs: the 1,600 poisoned train rows and every
    non-target test row go through gain → ladder → phaser in chunks of 256
    (kernel F, one launch a mode a chunk), their MFCCs through kernel A."""
    import numpy as np

    from audiobd_tpu_torch.cli import jingleback as cli
    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    flags = ["--synthetic", "--synthetic_per_class", "2000", "--style", "5", "--num_epochs", "2", "--patience", "20"]
    print(f"phase 8: JingleBack: python -m audiobd_tpu_torch jingleback {' '.join(flags)} (20,000 clips, batch "
          f"{BATCH}, f32)", flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            # Device activity only (no host ops recorded): kernel F's time in the poison stage, by kernel name.
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                run = cli.main(flags)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            print(f"  wall {wall:.1f} s (under torch.profiler, device activity only); launches: "
                  f"{({k: v for k, v in launches.items() if v})}", flush=True)
            _print_stages(run)
            f_names = ("ladder_pipeline_kernel", "phaser_kernel", "ladder_kernel")
            f_us = [e.time_range.end - e.time_range.start for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and any(n in e.name for n in f_names)]
            poison_s = run.stages["poison"]["wall_s"]
            print(f"  kernel F in the poison stage: {sum(f_us) / 1e3:.3f} ms of device time over {len(f_us)} "
                  f"kernels the profiler saw ({launches['effects_ladder'] + launches['effects_phaser']} launched; "
                  f"{sum(f_us) / 1e3 / max(len(f_us), 1):.4f} ms each), {sum(f_us) / 1e4 / poison_s:.2f}% of the "
                  f"stage's {poison_s:.3f} s wall", flush=True)
            cfg = make_config("jingleback")
            data = os.path.join(cfg.record_dir, cfg.dataset)
            ind = {s: np.load(os.path.join(data, "bd", f"poison_index_{s}.npy")) for s in ("train", "test")}
            styled = {s: int(ind[s].sum()) for s in ind}
            f_want = _chunks(styled["train"], 256) + _chunks(styled["test"], 256)
            poison = run.stages["poison"]["launches"]
            check(poison.get("effects_ladder", 0) == poison.get("effects_phaser", 0) == f_want
                  and launches["effects_ladder"] == launches["effects_phaser"] == f_want
                  and launches["effects_ladder_resonant"] == 0,
                  f"kernel F launched {launches['effects_ladder']} times as the k = 0 ladder, "
                  f"{launches['effects_ladder_resonant']} as the resonant one and "
                  f"{launches['effects_phaser']} as the phaser, all in the poison stage (expected {f_want}, {f_want}, 0: "
                  f"{styled['train']} train and {styled['test']} test rows in chunks of 256)")
            a_want = {"prep": _chunks(20000, 2048), "poison": _chunks(styled["train"], 2048)
                      + _chunks(styled["test"], 2048)}
            for stage, n in a_want.items():
                got = run.stages[stage]["launches"].get("mfcc_fft", 0)
                check(got == n, f"kernel A (mfcc_fft) launched {got} times in the {stage} stage (expected {n})")
            steps = 2 * _chunks(len(ind["train"]), BATCH)
            check(launches["conv1_bn_pool_bwd_params"] == steps,
                  f"kernel B launched {launches['conv1_bn_pool_bwd_params']} times ({steps} training steps)")
            wav = np.load(os.path.join(data, "bd", "bd_train_wav.npy"), mmap_mode="r")
            rows = np.flatnonzero(ind["train"])[:64]
            check(bool(np.isfinite(wav[rows]).all()), "the styled train rows are finite")
            check_record(torch, build_model, load_checkpoint, cfg.record_dir, data, feats_shape=(1, 101, 40))
        finally:
            os.chdir(cwd)
    return launches


def card_operations(torch, fn) -> int:
    """The aten operations that ``fn`` dispatches with a result on the card,
    views and bare allocations excluded: each launches a kernel or a copy.
    Counted at dispatch, so the count does not depend on a profiler's trace
    window (torch.profiler has dropped the kernels of such short windows)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            view = any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)
            on_card = any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(out))
            if on_card and not view and not str(func).startswith("aten.empty"):
                self.n += 1
            return out

    with Count() as count:
        fn()
    return count.n


def phase_boards(torch) -> None:
    """Phase 8b: each of the six style boards on one 256-clip chunk of
    one-second 16 kHz clips on the card (the synthetic set's tone bursts):
    the wall of a call after a warm-up call, and its launches: the aten
    operations it dispatches (``card_operations``) and kernel F's."""
    from audiobd_tpu_torch.ops import effects as op
    from audiobd_tpu_torch.poison.jingleback import STYLE_CHUNK, get_boards

    print(f"phase 8b: the six style boards on one {STYLE_CHUNK}-clip chunk (256, 16000) on the card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    n = torch.arange(16000, device="cuda", dtype=torch.float32) / 16000
    f0 = 200.0 + 1440.0 * torch.rand(STYLE_CHUNK, 1, device="cuda", generator=gen)
    env = torch.exp(-((n - 0.3 - 0.4 * torch.rand(STYLE_CHUNK, 1, device="cuda", generator=gen)) ** 2) / 0.05)
    x = env * (0.4 * torch.sin(2 * math.pi * f0 * n) + 0.3 * torch.sin(4 * math.pi * f0 * n))
    x = x + 0.02 * torch.randn(STYLE_CHUNK, 16000, device="cuda", generator=gen)
    for style, board in enumerate(get_boards(16000)):
        board(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = board(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        f_kernels = (op.LADDER_KERNEL, op.LADDER_RESONANT_KERNEL, op.PHASER_KERNEL)
        before = sum(k.launches for k in f_kernels)
        ops = card_operations(torch, lambda: board(x))
        f = sum(k.launches for k in f_kernels) - before
        check(tuple(y.shape) == tuple(x.shape) and bool(torch.isfinite(y).all())
              and float((y - x).abs().max()) > 1e-3, f"style {style}: finite, shaped {tuple(y.shape)}, changed")
        print(f"  style {style}: wall {wall * 1e3:.2f} ms, {ops + f} launches ({ops} aten operations on the card, "
              f"{f} of kernel F)", flush=True)


def phase_daba(torch, kernels, route: str) -> dict[str, int]:
    """Phase 9: ``python -m audiobd_tpu_torch daba`` at full width (20,000
    synthetic clips; librosa parity at n_fft 2048; 3,000 host candidates,
    1,600 hosts with variant gains; SmallCNN with its 896-feature flatten,
    batch 256, f32), cut to 2 epochs. Kernel A on ``route`` in the prep, the
    victim's scoring (the 60-clip pool, the trigger, the hosts in chunks of
    512) and the overlaid rows; kernel B at (256, 1, 32, 40)."""
    import numpy as np

    from audiobd_tpu_torch.cli import daba as cli
    from audiobd_tpu_torch.configs import make_config
    from audiobd_tpu_torch.models import build_model
    from audiobd_tpu_torch.poison.daba import INF_CHUNK
    from audiobd_tpu_torch.train.checkpoint import load_checkpoint

    flags = ["--synthetic", "--synthetic_per_class", "2000", "--num_epochs", "2", "--patience", "20"]
    print(f"phase 9: DABA: python -m audiobd_tpu_torch daba {' '.join(flags)} (20,000 clips, n_fft 2048 librosa "
          f"parity, 3,000 host candidates, batch {BATCH}, f32)", flush=True)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            run = cli.main(flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.launches for k in kernels}
            print(f"  wall {wall:.1f} s; selected trigger #{run.trigger_index}, {run.n_poisoned} hosts poisoned; "
                  f"launches: {({k: v for k, v in launches.items() if v})}", flush=True)
            _print_stages(run)
            cfg = make_config("daba")
            data = os.path.join(cfg.record_dir, cfg.dataset)
            ind = {s: np.load(os.path.join(data, "bd", f"poison_index_{s}.npy")) for s in ("train", "test")}
            check(run.n_poisoned == int(ind["train"].sum()) == round(0.1 * len(ind["train"])),
                  f"{run.n_poisoned} hosts poisoned (10% of {len(ind['train'])} train clips)")
            a_want = {"prep": _chunks(20000, 2048), "select": 2 + _chunks(cfg.host_candidates, INF_CHUNK),
                      "poison": _chunks(ind["train"].sum(), 2048) + _chunks(ind["test"].sum(), 2048)}
            for stage, n in a_want.items():
                got = run.stages[stage]["launches"]
                check(got.get(route, 0) == n and set(got) == {route},
                      f"kernel A ({route}) launched {got.get(route, 0)} times in the {stage} stage (expected {n}), "
                      f"no other kernel there ({got})")
            steps = 2 * _chunks(len(ind["train"]), BATCH)
            check(launches["conv1_bn_pool_bwd_params"] == steps,
                  f"kernel B launched {launches['conv1_bn_pool_bwd_params']} times ({steps} training steps)")
            check(os.path.exists(os.path.join(cfg.record_dir, "trigger.wav")), "trigger.wav written")
            check_record(torch, build_model, load_checkpoint, cfg.record_dir, data, feats_shape=(1, 32, 40))
        finally:
            os.chdir(cwd)
    return launches


SERVE_PER_CLASS, SERVE_AT_44K, SERVE_SHORT_44K = 400, 20, 5  # phase 10's tree, a class


def _best_epoch(record: str) -> tuple[int, list[list[str]]]:
    """(the 1-based epoch whose 0.5·(clean + bd loss) is least, as the early
    stopper picks it, first on ties; the rows of acc_result.csv)."""
    losses = _csv_rows(os.path.join(record, "loss_result.csv"))[1:]
    monitored = [0.5 * (float(r[1]) + float(r[2])) for r in losses]
    return monitored.index(min(monitored)) + 1, _csv_rows(os.path.join(record, "acc_result.csv"))


def phase_serving(torch, kernels, workdir: str) -> dict[str, int]:
    """Phase 10: ``python -m audiobd_tpu_torch infer`` on phase 2's record
    (SmallCNN, f32) over a wav tree it writes: 10 classes x (400 one-second
    16 kHz clips, 20 one-second 44.1 kHz clips, 5 half-second 44.1 kHz
    clips), resampled on the card, kernel A (FFT route, n_fft 400) in chunks
    of 2,048, the eval model at batch 256. Its walls by stage, clips/s and
    A's launches; top-1 against the same model on A's plain version
    (``dsp.mfcc`` on the card) for the same clips; then ``--eval_clean``
    against the clean accuracy phase 2's CSV logged at its best epoch."""
    import contextlib
    import io

    import numpy as np

    from audiobd_tpu_torch.__main__ import main as cli
    from audiobd_tpu_torch.cli import infer
    from audiobd_tpu_torch.configs import DATASET_LABELS
    from audiobd_tpu_torch.data.speech_commands import mfcc_params
    from audiobd_tpu_torch.dsp.mfcc import mfcc

    n_clips = 10 * (SERVE_PER_CLASS + SERVE_AT_44K + SERVE_SHORT_44K)
    print(f"phase 10: serving, python -m audiobd_tpu_torch infer --result chip_smoke --wav <tree> --json "
          f"({n_clips:,} clips: {SERVE_PER_CLASS} one-second 16 kHz, {SERVE_AT_44K} one-second and "
          f"{SERVE_SHORT_44K} half-second 44.1 kHz a class), then --eval_clean", flush=True)
    cwd = os.getcwd()
    tree = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    os.chdir(workdir)
    try:
        write_wav_tree(tree, DATASET_LABELS["SCDv1-10"], per_class=SERVE_PER_CLASS, at_44k=SERVE_AT_44K,
                       short_16k=0, short_44k=SERVE_SHORT_44K)
        for k in kernels:
            k.launches = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            probs = cli(["infer", "--result", "chip_smoke", "--wav", tree, "--json"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels if k.launches}
        walls = json.loads(err.getvalue().split("infer walls (s): ", 1)[1].splitlines()[0])
        rows = [json.loads(line) for line in out.getvalue().splitlines()]
        stages = sum(walls[s] for s in ("read", "resample", "mfcc", "forward"))
        print(f"  wall {wall:.3f} s ({n_clips / wall:.1f} clips/s; model load included); stages: read "
              f"{walls['read']:.4f} s, resample {walls['resample']:.4f} s, MFCC {walls['mfcc']:.4f} s, forward "
              f"{walls['forward']:.4f} s; {n_clips / stages:.1f} clips/s over the four stages", flush=True)
        print(f"  launches: {launches}", flush=True)
        want_a = -(-n_clips // 2048)
        check(launches.get("mfcc_fft") == want_a and set(launches) == {"mfcc_fft"},
              f"infer launched kernel A's FFT route {launches.get('mfcc_fft')} times ({want_a} chunks of 2,048) "
              "and no other kernel")
        check(len(rows) == n_clips and probs.shape == (n_clips, 10) and bool(np.isfinite(probs).all())
              and float(np.abs(probs.sum(-1) - 1.0).max()) < 1e-5
              and all(r["label"] == r["top"][0]["label"] for r in rows),
              f"{len(rows)} JSON lines; probabilities ({n_clips}, 10), finite, each row summing to 1")

        cfg, model = infer.load_model("chip_smoke")
        device = next(model.parameters()).device
        wavs, _ = infer.load_waveforms(cfg, infer.expand_wavs([tree]), device)
        params = mfcc_params(cfg)
        with torch.no_grad():
            feats = torch.cat([mfcc(wavs[s : s + 2048], params)[:, None] for s in range(0, n_clips, 2048)])
        ref = infer.classify(model, feats, cfg.train.batch_size)
        top2 = np.sort(ref, axis=-1)[:, -2:]
        agree = int((probs.argmax(-1) == ref.argmax(-1)).sum())
        check(agree == n_clips,
              f"served top-1 equals the model on A's plain version for {agree} of {n_clips} clips (largest "
              f"probability difference {float(np.abs(probs - ref).max()):.3e}; smallest top-2 margin "
              f"{float((top2[:, 1] - top2[:, 0]).min()):.3e})")
        print(f"  served classes: {np.bincount(probs.argmax(-1), minlength=10).tolist()}", flush=True)

        for k in kernels:
            k.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            ev = cli(["infer", "--result", "chip_smoke", "--eval_clean", "--json"])
        torch.cuda.synchronize()
        print(f"  --eval_clean: {out.getvalue().strip()} in {time.perf_counter() - t0:.3f} s", flush=True)
        best, acc_rows = _best_epoch(os.path.join("record", "chip_smoke"))
        logged = float(acc_rows[best][2])
        check(abs(ev["acc"] - logged) <= 0.05 and math.isfinite(ev["loss"]),
              f"--eval_clean accuracy {ev['acc']:.4f} within 0.05 points of phase 2's clean accuracy "
              f"{logged:.4f} at its best epoch ({best})")
    finally:
        os.chdir(cwd)
        shutil.rmtree(tree, ignore_errors=True)
    return launches


def phase_restart(torch, kernels, workdir: str) -> dict[str, int]:
    """Phase 11, last: phase 2's badnets run again on its record with
    --resume --num_epochs 1 --profile_dir <tmp>: it must resume at 63 x the
    best epoch's steps, take one epoch through kernel B, write a trace that
    names epoch_1 and B, and leave the optimizer's state in
    torch_checkpoint/train_state.pt. Prints the checkpoint write's ms beside
    the epoch's wall."""
    import contextlib
    import io

    from audiobd_tpu_torch.cli import badnets as cli
    from audiobd_tpu_torch.train.checkpoint import load_train_state

    record = os.path.join(workdir, "record", "chip_smoke")
    steps = -(-TRAIN_CLIPS // BATCH)
    best, _ = _best_epoch(record)
    n = steps * best
    prof = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    flags = ["--synthetic", "--synthetic_per_class", str(MAIN_PER_CLASS), "--num_epochs", "1", "--patience", "20",
             "--result", "chip_smoke", "--resume", "--profile_dir", prof]
    print(f"phase 11: restart, python -m audiobd_tpu_torch badnets {' '.join(flags)} (phase 2's record, best "
          f"epoch {best})", flush=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for k in kernels:
            k.launches = 0
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            result = cli.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels if k.launches}
        text = out.getvalue()
        for line in text.splitlines():
            if line.startswith(("resumed", "Epoch", "done", "plotting")):
                print(f"  {line}", flush=True)
        print(f"  wall {wall:.1f} s; launches: {launches}", flush=True)
        check(f"resumed from step {n}\n" in text, f"the run printed 'resumed from step {n}' ({steps} x epoch {best})")
        saved = load_train_state(record)
        opt = saved["optimizer"]
        n_params = len(list(result.model.parameters()))
        check(result.step == saved["step"] == opt["count"] == n + steps and len(opt["mu"]) == len(opt["nu"]) == n_params
              and all(bool(torch.isfinite(t).all()) for t in opt["mu"] + opt["nu"]),
              f"torch_checkpoint/train_state.pt holds Adam's mu and nu ({n_params} tensors each, finite) and count "
              f"at step {saved['step']} (expected {n + steps})")
        check(launches.get("conv1_bn_pool_bwd_params") == steps,
              f"kernel B launched {launches.get('conv1_bn_pool_bwd_params')} times in the resumed epoch")
        traces = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".json")]
        body = open(traces[0]).read() if len(traces) == 1 else ""
        check('"epoch_1"' in body and "bwd_params_partial" in body,
              f"one trace in --profile_dir ({len(body) / 1e6:.1f} MB) names epoch_1 and kernel B's bwd_params_partial")
        epoch_ms = TRAIN_CLIPS / result.clips_per_sec * 1e3
        print(f"  checkpoint write: {', '.join(f'{w * 1e3:.2f}' for w in result.checkpoint_walls)} ms beside the "
              f"profiled epoch's {epoch_ms:.1f} ms", flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(prof, ignore_errors=True)
    return launches

# ---------------------------------------------------------------------------
# Phase 12: data-parallel training, two ranks on the one card (gloo: NCCL
# refuses two ranks on one device). Two ranks time-share the card, so its
# walls are the cost of the collectives and the duplicated prep, not a
# scaling figure.

DP_RANKS = 2
# Phase 12a's gradients, each relative to its tensor's largest entry: the
# two-rank step's distance from the float64 step may be at most
# DP_GRAD_RATIO times the one-process step's (or DP_GRAD_FLOOR, where both
# are at f32's last digits), and never more than DP_GRAD_CAP.
DP_GRAD_RATIO, DP_GRAD_FLOOR, DP_GRAD_CAP = 1.5, 1e-5, 1.5e-3
DP_LR = 1e-4  # TrainConfig's learning rate
DP_TIMEOUT_S = 300


def _dp_rank(rank: int, tmp: str) -> None:
    """Phase 12a's rank: one sharded step of the global batch on cuda:0,
    then the gradient buffer's all-reduce timed; results to ``tmp``."""
    import torch

    from audiobd_tpu_torch.models import SmallCNN
    from audiobd_tpu_torch.ops import KERNELS
    from audiobd_tpu_torch.parallel.distributed import all_reduce_flat, destroy, maybe_initialize_distributed
    from audiobd_tpu_torch.parallel.mesh import make_mesh
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import ShardedDeviceDataset, run_train_epoch_sharded
    from audiobd_tpu_torch.train.state import Adam
    from audiobd_tpu_torch.utils.device import resolve_device

    maybe_initialize_distributed(f"file://{tmp}/rendezvous", DP_RANKS, rank)
    device = resolve_device(None)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh()
    model = SmallCNN(10, 3072, fused_block1=True, dropout_rates=(0.0, 0.0))
    model.load_state_dict(inputs["state"])
    model.to(device).sync_batchnorm(mesh.data_group)
    opt = Adam(model.parameters(), DP_LR)
    grads = _grad_recorder(opt)
    dset = ShardedDeviceDataset(ArraySet(*inputs["batch"]), mesh, device)
    out = {"train": run_train_epoch_sharded(model, opt, dset, len(inputs["batch"][1]), None),
           "launches": {k.name: k.launches for k in KERNELS if k.launches}, "device": str(device)}
    out["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
    out["grads"] = [g.cpu() for g in grads[0]]
    buf = [g.clone() for g in grads[0]]
    for _ in range(2):
        all_reduce_flat(buf, mesh.data_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        all_reduce_flat(buf, mesh.data_group)
    torch.cuda.synchronize()
    out["allreduce_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    out["allreduce_bytes"] = sum(g.numel() for g in buf) * 4
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    destroy()


def _grad_recorder(opt) -> list:
    """Copies of the gradients of each ``opt.step``."""
    seen: list = []
    step = opt.step

    def recording(grads):
        seen.append([g.detach().clone() for g in grads])
        return step(grads)

    opt.step = recording
    return seen


def _rel_err(got, ref) -> float:
    return float((got.double() - ref.double()).abs().max() / ref.double().abs().max().clamp_min(1e-12))


def smallcnn_grads_ref(torch, state: dict, x, y, dtype, mode: str = "whole") -> tuple[dict, list, list]:
    """The gradients of SmallCNN's batch-mean loss (dropout off, batch
    statistics, flax's fast variance E[x²] − E[x]²) written out in ``dtype``
    on the card; each BatchNorm's largest E[x²]/var over its channels (how
    many digits the fast variance cancels); and each max-pool's indices, the
    input each window passes its gradient to. ``mode``: "whole" takes the
    batch at once; "stats" takes each BatchNorm's mean and E[x²] as the mean
    of the two halves' (the ranks' forward arithmetic), the rest whole;
    "ranks" runs each half apart with those statistics, as the two ranks do.
    In float64 "whole" is the reference phase 12a judges the f32 steps by."""
    import torch.nn.functional as F

    params = {k: v.to("cuda", dtype).requires_grad_(True) for k, v in state.items() if "running" not in k}
    ratios, indices = [], []

    def block(hs, i, pool, padding):
        rs = [F.relu(F.conv2d(h, params[f"conv{i}.weight"], params[f"conv{i}.bias"])) for h in hs]
        if mode == "stats":
            halves = rs[0].chunk(DP_RANKS)
            mean = sum(r.mean(dim=(0, 2, 3)) for r in halves) / DP_RANKS
            mean2 = sum((r * r).mean(dim=(0, 2, 3)) for r in halves) / DP_RANKS
        else:
            mean = sum(r.mean(dim=(0, 2, 3)) for r in rs) / len(rs)
            mean2 = sum((r * r).mean(dim=(0, 2, 3)) for r in rs) / len(rs)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        ratios.append(float((mean2 / var.clamp_min(1e-30)).max().detach()))
        mul = torch.rsqrt(var + 1e-5) * params[f"bn{i}.weight"]
        c = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
        pooled = [F.max_pool2d((r - c(mean)) * c(mul) + c(params[f"bn{i}.bias"]), pool, padding=padding,
                               return_indices=True) for r in rs]
        indices.append(torch.cat([p[1] for p in pooled]).cpu())
        return [p[0] for p in pooled]

    h = torch.as_tensor(x, device="cuda", dtype=dtype)
    labels = torch.as_tensor(y, device="cuda").long()
    hs = list(h.chunk(DP_RANKS)) if mode == "ranks" else [h]
    hs = block(block(block(hs, 1, (1, 3), 0), 2, (2, 2), (1, 1)), 3, (2, 2), (0, 1))
    loss = 0.0
    for hk, yk in zip(hs, labels.chunk(len(hs))):
        logits = F.linear(F.relu(F.linear(hk.flatten(1), params["fc1.weight"], params["fc1.bias"])),
                          params["fc2.weight"], params["fc2.bias"])
        loss = loss + F.cross_entropy(logits, yk, reduction="sum") / len(labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, (g.cpu() for g in grads))), ratios, indices


def phase_dp_step(torch, kernels, record_dir: str) -> None:
    """Phase 12a: the two-rank step against the same step in this process."""
    import numpy as np

    import torch.multiprocessing as mp

    from audiobd_tpu_torch.models import SmallCNN
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_train_epoch
    from audiobd_tpu_torch.train.state import Adam
    from audiobd_tpu_torch.utils.random import torch_generator

    bd = os.path.join(record_dir, "record", "chip_smoke", "SCDv1-10", "bd")
    x = np.load(os.path.join(bd, "bd_train_mfcc.npy"))[:BATCH].astype(np.float32)
    y = np.load(os.path.join(bd, "bd_train_label.npy"))[:BATCH]
    ind = np.load(os.path.join(bd, "poison_index_train.npy"))[:BATCH]
    model = SmallCNN(10, 3072, dropout_rates=(0.0, 0.0))
    model.reset_parameters(torch_generator(35, "params"))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    print(f"phase 12a: one data-parallel step, {DP_RANKS} ranks on cuda:0 (gloo, file:// rendezvous), full-width "
          f"SmallCNN (badnets, flatten 3072, dropout 0), global batch {BATCH} of phase 2's features "
          f"{tuple(x.shape)}, {BATCH // DP_RANKS} rows a rank, sync-BN; against this process's step, unfused and "
          f"with block 1 on kernel B, and the float64 step; tolerance: loss rtol 1e-5; each gradient's distance "
          f"from float64 at most max({DP_GRAD_RATIO} x the one-process step's, {DP_GRAD_FLOOR:.0e}) and at most "
          f"{DP_GRAD_CAP:.1e}, and within 1e-4 of this process's step written out with the ranks' statistics; "
          f"running statistics 1e-4, all relative to the tensor's largest entry; parameters after one Adam step "
          f"0.25 lr; the ranks' parameters bit-equal", flush=True)
    refs = {}
    for fused in (False, True):
        ref = SmallCNN(10, 3072, fused_block1=fused, dropout_rates=(0.0, 0.0))
        ref.load_state_dict(state)
        ref.to("cuda")
        opt = Adam(ref.parameters(), DP_LR)
        grads = _grad_recorder(opt)
        for k in kernels:
            k.launches = 0
        tr = run_train_epoch(ref, opt, DeviceDataset(ArraySet(x, y, ind), torch.device("cuda")), BATCH, None)
        b = next(k.launches for k in kernels if k.name == "conv1_bn_pool_bwd_params")
        check(b == (1 if fused else 0), f"single process, block 1 {'on kernel B' if fused else 'unfused'}: "
                                        f"B launched {b} times")
        refs["kernel B" if fused else "unfused"] = (tr, [g.cpu() for g in grads[0]],
                                                    {k: v.cpu() for k, v in ref.state_dict().items()})
    # The same one-process step on the rows in another order: the same
    # function, summed in another order.
    perm = np.random.default_rng(12).permutation(BATCH)
    ref = SmallCNN(10, 3072, fused_block1=False, dropout_rates=(0.0, 0.0))
    ref.load_state_dict(state)
    ref.to("cuda")
    opt = Adam(ref.parameters(), DP_LR)
    grads = _grad_recorder(opt)
    run_train_epoch(ref, opt, DeviceDataset(ArraySet(x[perm], y[perm], ind[perm]), torch.device("cuda")), BATCH,
                    None)
    permuted = [g.cpu() for g in grads[0]]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        torch.save({"state": state, "batch": (x, y, ind)}, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        ctx = mp.start_processes(_dp_rank, args=(tmp,), nprocs=DP_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + DP_TIMEOUT_S
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish in {DP_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(DP_RANKS)]
        print(f"  {DP_RANKS} ranks spawned, stepped and joined in {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = [n for n, _ in model.named_parameters()]
    # The ranks average their halves' BatchNorm statistics. That changes the
    # statistics' last digits, and so which of a max-pool window's
    # near-equal inputs is the largest: on phase 2's features one window of
    # pool 2 (of 5.7 M) then sends its gradient to another input, which
    # moves conv1's, bn1's and conv2's gradients by up to 6.5e-4 of their
    # largest entry (the f32 one-process step itself routes 3 windows
    # otherwise than the float64 step). So the two-rank step is held (1) to
    # the float64 step, beside the one-process step's own distance from it,
    # and (2) within 1e-4 to the one-process step written out with the
    # ranks' statistics (smallcnn_grads_ref, "ranks").
    g64, cancel, idx64 = smallcnn_grads_ref(torch, state, x, y, torch.float64)
    print("  float64: each BatchNorm's largest E[x²]/var over its channels: "
          + ", ".join(f"bn{i + 1} {v:.3g}" for i, v in enumerate(cancel)), flush=True)
    steps = {label: grads for label, (_, grads, _) in refs.items()}
    steps["unfused, rows permuted"] = permuted
    steps["two ranks"] = outs[0]["grads"]
    to64 = {label: {n: _rel_err(g, g64[n]) for n, g in zip(names, grads)} for label, grads in steps.items()}
    for label, errs in to64.items():
        print(f"  {label} vs float64 (relative to each tensor's largest entry): "
              + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()), flush=True)
    # The step written out in f32 (smallcnn_grads_ref): whole, with the
    # ranks' statistics, and run as the ranks run it, to find which part of
    # the ranks' arithmetic moves the gradients.
    idx = {"float64": idx64}
    for mode in ("whole", "stats", "ranks"):
        g32, _, idx[mode] = smallcnn_grads_ref(torch, state, x, y, torch.float32, mode)
        steps[f"f32 written out, {mode}"] = [g32[n] for n in names]
    for label, a, b in (("f32 stats vs f32 whole", "stats", "whole"), ("f32 ranks vs f32 whole", "ranks", "whole"),
                        ("f32 whole vs float64", "whole", "float64")):
        print(f"  max-pool windows that pass their gradient to another input, {label}: "
              + ", ".join(f"pool{i + 1} {int((ia != ib).sum())} of {ia.numel()}"
                          for i, (ia, ib) in enumerate(zip(idx[a], idx[b]))), flush=True)
    for label, against in (("unfused, rows permuted", "unfused"), ("two ranks", "unfused"),
                           ("f32 written out, whole", "unfused"), ("f32 written out, ranks", "two ranks"),
                           ("f32 written out, stats", "f32 written out, whole"),
                           ("f32 written out, ranks", "f32 written out, whole")):
        print(f"  {label} vs {against} (relative to each tensor's largest entry): "
              + ", ".join(f"{n} {_rel_err(g, gr):.1e}" for n, g, gr in zip(names, steps[label], steps[against])),
              flush=True)
    for r, out in enumerate(outs):
        check(out["device"] == "cuda:0" and not out["launches"],
              f"rank {r} on {out['device']}, kernel launches {out['launches']} (sync-BN: block 1 unfused, no B)")
        same = max(_rel_err(g, gr) for g, gr in zip(out["grads"], steps["f32 written out, ranks"]))
        check(same <= 1e-4, f"rank {r} vs this process's step with the ranks' statistics (written out): gradients "
                            f"{same:.1e} of each tensor's largest entry at most (bound 1e-4)")
        for label, (tr, grads, ref_state) in refs.items():
            loss_err = abs(out["train"]["loss"] - tr["loss"]) / abs(tr["loss"])
            diffs = {n: _rel_err(g, gr) for n, g, gr in zip(names, out["grads"], grads)}
            to64_r = {n: _rel_err(g, g64[n]) for n, g in zip(names, out["grads"])}
            bound = {n: min(max(DP_GRAD_RATIO * to64[label][n], DP_GRAD_FLOOR), DP_GRAD_CAP) for n in names}
            worst = max(names, key=lambda n: to64_r[n] / bound[n])
            stat_err = max(_rel_err(out["state"][k], ref_state[k]) for k in ref_state if "running" in k)
            param_err = max(float((out["state"][n] - ref_state[n]).abs().max()) for n in names) / DP_LR
            check(loss_err <= 1e-5 and to64_r[worst] <= bound[worst] and stat_err <= 1e-4 and param_err <= 0.25
                  and out["train"]["mix_acc"] == tr["mix_acc"],
                  f"rank {r} vs single process ({label}): loss {out['train']['loss']:.6f} vs {tr['loss']:.6f} "
                  f"(rel {loss_err:.1e}); gradients from float64, nearest its bound: {worst} {to64_r[worst]:.1e} "
                  f"(one process {to64[label][worst]:.1e}, bound {bound[worst]:.1e}), from the one-process step "
                  f"at most {max(diffs.values()):.1e}; running statistics {stat_err:.1e}; parameters after the "
                  f"step {param_err:.3f} lr")
    equal = all(torch.equal(outs[0]["state"][k], outs[1]["state"][k]) for k in outs[0]["state"])
    check(equal, "the two ranks' parameters and running statistics after the step are bit-equal")
    for r, out in enumerate(outs):
        print(f"  rank {r}: all-reduce of the gradient buffer ({out['allreduce_bytes'] / 1e6:.2f} MB f32, gloo on "
              f"CUDA tensors, mean of 20 calls): {out['allreduce_ms']:.3f} ms", flush=True)


# Phase 12b's rank writes: a sitecustomize the ranks import at start records
# every file each rank opens for writing, creates, renames or removes under
# the run's directory (the interpreter's audit hooks), then hands on to any
# sitecustomize it shadows.
AUDIT_SITECUSTOMIZE = """
import importlib.machinery, importlib.util, os, sys

def _audit():
    root, logs = os.environ["CHIP_SMOKE_AUDIT_ROOT"], os.environ["CHIP_SMOKE_AUDIT_LOGS"]
    fd = os.open(os.path.join(logs, "rank" + os.environ.get("RANK", "-agent") + ".txt"),
                 os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    writing = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def hook(event, args):
        if event == "open":
            mode, flags = args[1], args[2]
            if not (any(c in mode for c in "wax+") if isinstance(mode, str) else flags & writing):
                return
        elif event not in ("os.mkdir", "os.rename", "os.remove", "os.rmdir"):
            return
        if not isinstance(args[0], (str, bytes, os.PathLike)):
            return
        path = os.path.abspath(os.fsdecode(args[0]))
        if path.startswith(root):
            os.write(fd, (event + " " + path + "\\n").encode())

    sys.addaudithook(hook)

_audit()
_here = os.path.dirname(os.path.abspath(__file__))
_rest = [p for p in sys.path if os.path.abspath(p or ".") != _here]
_spec = importlib.machinery.PathFinder.find_spec("sitecustomize", _rest)
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def phase_dp_cli(torch, main_acc: tuple[float, float]) -> None:
    """Phase 12b: the BadNets CLI through torchrun, two ranks on the card."""
    import signal

    flags = ["badnets", "--synthetic", "--synthetic_per_class", str(MAIN_PER_CLASS), "--num_epochs", "2",
             "--patience", "20"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(DP_RANKS),
           "-m", "audiobd_tpu_torch", *flags]
    print(f"phase 12b: python -m torch.distributed.run --standalone --nproc_per_node {DP_RANKS} -m audiobd_tpu_torch "
          f"{' '.join(flags)} (the main path, {10 * MAIN_PER_CLASS:,} clips, global batch {BATCH}, f32, full width; "
          f"both ranks on cuda:0, which they time-share)", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_torchrun_")
    site, logs, run = (os.path.join(tmp, d) for d in ("site", "logs", "run"))
    for d in (site, logs, run):
        os.makedirs(d)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(AUDIT_SITECUSTOMIZE)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, site, os.environ.get("PYTHONPATH", "")]),
               CHIP_SMOKE_AUDIT_ROOT=run, CHIP_SMOKE_AUDIT_LOGS=logs)
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=run, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                start_new_session=True)
        try:
            text, _ = proc.communicate(timeout=DP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            text, _ = proc.communicate()
        wall = time.perf_counter() - t0
        lines = text.splitlines()
        for line in lines:
            if line.startswith(("distributed:", "Epoch", "done", "rank ", "Traceback", "RuntimeError", "ValueError")):
                print(f"  {line[:400]}", flush=True)
        check(proc.returncode == 0, f"torchrun exited {proc.returncode} after {wall:.1f} s")
        if proc.returncode != 0:
            print("\n".join(f"  | {line}" for line in lines[-40:]), flush=True)
            return
        rec = os.path.join(run, "record", "badnets_smallcnn")
        rows = _csv_rows(os.path.join(rec, "loss_result.csv"))
        check(len(rows) == 3 and _finite_rows(rows), f"loss_result.csv: a header and 2 rows, every loss finite "
                                                     f"({rows[1:]})")
        check(os.path.exists(os.path.join(rec, "torch_checkpoint", "model.pt")), "torch_checkpoint/ written")
        acc = _csv_rows(os.path.join(rec, "acc_result.csv"))[-1]
        clean_acc, asr = float(acc[2]), float(acc[3])
        check(abs(clean_acc - main_acc[0]) <= 5 and abs(asr - main_acc[1]) <= 5,
              f"epoch 2: clean acc {clean_acc:.2f}, ASR {asr:.2f}; phase 2's {main_acc[0]:.2f}, {main_acc[1]:.2f} "
              f"(within 5 points)")
        writes = {}
        for r in range(DP_RANKS):
            with open(os.path.join(logs, f"rank{r}.txt")) as f:
                writes[r] = f.read().splitlines()
        check(any(w.endswith("loss_result.csv") for w in writes[0]) and writes[1] == [],
              f"rank 0 made {len(writes[0])} writes under the run's directory, rank 1 {len(writes[1])} "
              f"{writes[1][:3]}")
        replicas = {}
        for line in lines:
            if line.startswith("rank ") and "parameters sha256" in line:
                r = int(line.split()[1].split("/")[0])
                digest = line.split("sha256 ")[1].split(";")[0]
                replicas[r] = (digest, json.loads(line.split("kernel launches ")[1]))
        check(sorted(replicas) == list(range(DP_RANKS)), f"each rank printed its digest ({sorted(replicas)})")
        for r, (_, launches) in sorted(replicas.items()):
            a, b = launches.get("mfcc_fft"), launches.get("conv1_bn_pool_bwd_params")
            check(a == 10 and b == 0, f"rank {r}: A launched {a} times, B {b}")
        check(len({d for d, _ in replicas.values()}) == 1, "the ranks' final parameter digests are equal")
        done = [line for line in lines if line.startswith("done:")]
        clips = [float(line.split("throughput=")[1].split()[0]) for line in done]
        print(f"  wall {wall:.1f} s (2 process starts, each rank's whole prep, 2 epochs); train clips/s "
              f"{', '.join(f'{c:.1f}' for c in clips)} (by rank; two ranks time-share one card: the cost of the "
              f"collectives and the duplicated prep, not a scaling figure)", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 13: tensor parallel. The ranks share the one card over gloo, spawned
# as phase 12a's (NCCL refuses two ranks on one device), so a collective goes
# device → host → device: the walls measure that host path, not NVLink TP.
TP_MODEL = 2  # ranks a grid row (the mesh's model axis)
TP_TIMEOUT_S = 300
# f32, against one process's step on the card: logits within 1e-5 of their
# largest entry; loss and metric sums as phase 12a; each gradient's distance
# from the float64 step at most max(DP_GRAD_RATIO x the one-process step's,
# DP_GRAD_FLOOR) and at most DP_GRAD_CAP, relative to the tensor's largest
# entry; running statistics 1e-4; parameters after one Adam step 0.25 lr.
TP_LOGITS_RTOL = 1e-5
# LargeCNN's sharded convs round otherwise than one process's, which moves
# relu and max-pool near-ties: a moved tie shifts a conv gradient by ~1e-3
# of its largest entry, so its f32 steps are judged against the float64 step
# run on their own routing (largecnn_step), within 1e-4 (the CPU tests'
# gradient tolerance), and within 1e-4 of the step written out as the ranks
# run it.
TP_ROUTED_RTOL = 1e-4
# bf16 (13d), against one process's bf16 step: logits within 1e-2 of their
# largest entry, loss 1e-2 relative, gradients 2e-2 of each tensor's largest
# entry (a sharded layer's input gradient is the sum of the ranks' bf16
# partial products: one bf16 rounding more than one process's).
TP_BF16_RTOL, TP_BF16_GRAD = 1e-2, 2e-2
TP_CASES = (  # label, model, compute dtype, block 1 on kernel B, world sizes (1 x 2, 2 x 2)
    ("13a LargeCNN", "largecnn", "float32", False, (2, 4)),
    ("13b SmallCNN, fused_conv_block on", "smallcnn", "float32", True, (2,)),
    ("13c RNN", "rnn", "float32", False, (2,)),
    ("13d LargeCNN bf16", "largecnn", "bfloat16", False, (2,)),
)


def _tp_model(torch, kind: str, dtype: str, fused: bool):
    """Phase 13's models at full width (BadNets' shapes), dropout off."""
    from audiobd_tpu_torch.models import RNN, LargeCNN, SmallCNN

    dt = getattr(torch, dtype)
    if kind == "largecnn":
        return LargeCNN(10, 12288, dropout_rate=0.0, compute_dtype=dt)
    if kind == "smallcnn":
        return SmallCNN(10, 3072, fused_block1=fused, dropout_rates=(0.0, 0.0), compute_dtype=dt)
    return RNN(10, 40, compute_dtype=dt)


def _tp_rank(rank: int, tmp: str, world: int) -> None:
    """Phase 13's rank of a (world / 2) x 2 mesh on cuda:0: for each case,
    shard_params_tp (min_features 128), one step on the global batch from
    the shared weights, then one more on the same batch for a warm wall;
    results to ``tmp``."""
    import torch

    from audiobd_tpu_torch.ops import KERNELS
    from audiobd_tpu_torch.parallel import tp
    from audiobd_tpu_torch.parallel.distributed import destroy, maybe_initialize_distributed
    from audiobd_tpu_torch.parallel.mesh import make_mesh, shard_params_tp, unshard_params_tp
    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import ShardedDeviceDataset, run_train_epoch_sharded
    from audiobd_tpu_torch.train.state import Adam
    from audiobd_tpu_torch.utils.device import resolve_device

    maybe_initialize_distributed(f"file://{tmp}/rendezvous{world}", world, rank)
    device = resolve_device(None)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    mesh = make_mesh(world // TP_MODEL, TP_MODEL)
    dset = ShardedDeviceDataset(ArraySet(*inputs["batch"]), mesh, device)
    out = {"device": str(device), "mesh": (mesh.data_index, mesh.model_index)}
    for label, kind, dtype, fused, worlds in TP_CASES:
        if world not in worlds:
            continue
        model = _tp_model(torch, kind, dtype, fused)
        model.load_state_dict(inputs["state"][kind])
        model.to(device)
        if mesh.shape["data"] > 1:  # a 1 x 2 mesh keeps local statistics, so block 1 keeps kernel B
            model.sync_batchnorm(mesh.data_group)
        opt = Adam(model.parameters(), DP_LR)
        shard_params_tp(mesh, model, opt)
        grads = _grad_recorder(opt)
        logits = []
        hook = model.register_forward_hook(lambda _m, _a, y: logits.append(y.detach().float().cpu()))
        res = {"walls_ms": []}
        for step in range(2):
            for k in KERNELS:
                k.launches = 0
            before = dict(tp.COUNTS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train = run_train_epoch_sharded(model, opt, dset, BATCH, None)
            torch.cuda.synchronize()
            res["walls_ms"].append((time.perf_counter() - t0) * 1e3)
            if step == 0:
                res.update(train=train, logits=logits[0], grads=[g.float().cpu() for g in grads[0]],
                           launches={k.name: k.launches for k in KERNELS if k.launches},
                           collectives={k: tp.COUNTS[k] - before[k] for k in before},
                           local={k: v.cpu() for k, v in model.state_dict().items()},
                           full={k: v.cpu() for k, v in unshard_params_tp(mesh, model).items()},
                           sharded={k: (s.n, s.index, s.full) for k, s in model.tp_sharded.items()},
                           bytes=sum(t.numel() * t.element_size() for t in (*opt.params, *opt.mu, *opt.nu)))
        hook.remove()
        out[label] = res
        del model, opt, grads
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}_of_{world}.pt"))
    destroy()


def _tp_grads64(torch, kind: str, state: dict, x, y) -> dict:
    """The float64 gradients of SmallCNN's and RNN's batch-mean loss on the
    card (SmallCNN written out, as phase 12a's reference; RNN's LSTM and
    head in float64; LargeCNN's come from largecnn_step)."""
    import torch.nn.functional as F

    if kind == "smallcnn":
        return smallcnn_grads_ref(torch, state, x, y, torch.float64)[0]
    model = _tp_model(torch, kind, "float32", False)
    model.load_state_dict(state)
    model.to("cuda", torch.float64).train()
    h = torch.as_tensor(x, device="cuda", dtype=torch.float64)
    with torch.backends.cudnn.flags(enabled=False):  # ATen's LSTM in float64
        logits = model.fc(model.lstm(h.squeeze(1))[0][:, -1])
    loss = F.cross_entropy(logits, torch.as_tensor(y, device="cuda").long())
    names = [n for n, _ in model.named_parameters()]
    return dict(zip(names, (g.cpu() for g in torch.autograd.grad(loss, list(model.parameters())))))


def largecnn_step(torch, state: dict, x, y, dtype: str, n_data: int, blocks: int, routes=None) -> tuple:
    """LargeCNN's step (models/zoo.py::LargeCNN, dropout 0) written out in
    this process, each of ``n_data`` data shards' rows apart and their
    gradients summed. With ``blocks`` = TP_MODEL, as the ranks of an n_data
    x TP_MODEL mesh run it: each layer shard_params_tp shards (dim 0 at
    least 128 and splitting over TP_MODEL) as ``blocks`` products on the
    blocks of its weight, joined along the feature axis, then the bias (the
    casts of models/layers.py in bf16); with 1, as one process runs it.
    Each relu and max pool records its routing, the inputs it passes the
    gradient to; given ``routes`` (another call's), it takes those instead:
    a float64 step on an f32 step's routing. Returns (logits on the CPU,
    {name: gradient} on the CPU, routes on the card)."""
    import torch.nn.functional as F

    from audiobd_tpu_torch.train.loop import cross_entropy

    dt = getattr(torch, dtype)
    full = torch.float64 if dt == torch.float64 else torch.float32  # the parameters' dtype
    params = {k: v.to("cuda", full, copy=True).requires_grad_(True) for k, v in state.items()}
    replay = None if routes is None else iter(routes)
    taken = []

    def layer(h, name: str, conv: bool):
        w, b = params[f"{name}.weight"], params[f"{name}.bias"]
        op = (lambda a, ww, bb: F.conv2d(a, ww, bb, padding=1)) if conv else F.linear
        if blocks > 1 and w.shape[0] >= 128 and w.shape[0] % blocks == 0:
            y = torch.cat([op(h.to(dt), wb.to(dt), None) for wb in w.chunk(blocks)], dim=1 if conv else -1)
        elif dt != torch.bfloat16:
            return op(h, w, b)
        else:
            y = op(h.to(dt), w.to(dt), None)
        return y + (b.to(dt).reshape(1, -1, 1, 1) if conv else b.to(dt))

    def relu(z):
        if replay is None:
            taken.append(z > 0)
            return F.relu(z)
        taken.append(next(replay))
        return z * taken[-1]

    def pool(z, k: int, stride: int):
        if replay is None:
            out, idx = F.max_pool2d(z, k, stride=stride, return_indices=True)
            taken.append(idx)
            return out
        taken.append(next(replay))
        return z.flatten(2).gather(2, taken[-1].flatten(2)).view(taken[-1].shape)

    grads, logits = None, []
    xs_all = torch.as_tensor(x, device="cuda", dtype=full)
    for xs, ys in zip(xs_all.chunk(n_data), torch.as_tensor(y, device="cuda").chunk(n_data)):
        h = pool(layer(xs, "convs.0", True), 2, 2)
        h = pool(layer(h, "convs.1", True), 2, 2)
        for i in (2, 3, 4):
            h = relu(layer(h, f"convs.{i}", True))
        h = pool(h, 3, 2).flatten(1)
        h = relu(layer(relu(layer(h, "fc1", False)), "fc2", False))
        out = layer(h, "fc3", False)
        loss = cross_entropy(out, ys.long()).sum() / len(x) if full == torch.float32 else \
            F.cross_entropy(out, ys.long(), reduction="sum") / len(x)
        g = torch.autograd.grad(loss, list(params.values()))
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        logits.append(out.detach().float().cpu())
    return torch.cat(logits), dict(zip(params, (g.cpu() for g in grads))), taken


def _routing_diffs(a: list, b: list) -> tuple[int, int]:
    """(decisions that differ, decisions) between two calls' routes."""
    return sum(int((u != v).sum()) for u, v in zip(a, b)), sum(u.numel() for u in a)


def _adam_first_step(p, g, lr: float):
    """Parameters after one optax-adam step from zero moments on gradient g."""
    return p - lr * g / (g.abs() + 1e-8)


def _tp_block(full, sharded: dict, name: str):
    """The block of ``full`` that a rank with layout ``sharded`` holds."""
    if name not in sharded:
        return full
    n, index, size = sharded[name]
    return full[index * size // n:(index + 1) * size // n]


def phase_tp(torch, record_dir: str) -> None:
    """Phase 13: tensor-parallel train steps (shard_params_tp and the
    column-parallel routes) by 2 and 4 ranks on the card, each against the
    same step in this process."""
    import numpy as np

    import torch.multiprocessing as mp

    from audiobd_tpu_torch.train.loop import ArraySet
    from audiobd_tpu_torch.train.scan_epoch import DeviceDataset, run_train_epoch
    from audiobd_tpu_torch.train.state import Adam
    from audiobd_tpu_torch.utils.random import torch_generator

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    bd = os.path.join(record_dir, "record", "chip_smoke", "SCDv1-10", "bd")
    x = np.array(np.load(os.path.join(bd, "bd_train_mfcc.npy"), mmap_mode="r")[:BATCH], np.float32)
    y = np.load(os.path.join(bd, "bd_train_label.npy"))[:BATCH]
    ind = np.load(os.path.join(bd, "poison_index_train.npy"))[:BATCH]
    print(f"phase 13: tensor parallel (shard_params_tp, min_features 128), ranks on cuda:0 ({smi}; gloo, file:// "
          f"rendezvous: a collective goes through the host, so walls are gloo's on one shared card, not NVLink TP); "
          f"one step on a global batch {tuple(x.shape)} of phase 2's features, full width, dropout 0, against this "
          f"process's step from the same weights (cuDNN deterministic, as shard_params_tp sets it); f32 bounds: loss "
          f"rtol 1e-5, metric sums equal, logits {TP_LOGITS_RTOL:.0e} of their largest entry, running statistics "
          f"1e-4 and gradients relative to each tensor's largest entry: each gradient's distance from float64 at "
          f"most max({DP_GRAD_RATIO} x the one-process step's, {DP_GRAD_FLOOR:.0e}) and at most {DP_GRAD_CAP:.1e} "
          f"(SmallCNN, RNN); LargeCNN's within {TP_ROUTED_RTOL:.0e} of float64 on the step's own relu and max-pool "
          f"routing and of the step written out as the ranks run it; parameters after one Adam step 0.25 lr (of "
          f"that step's update for LargeCNN); bf16: loss and logits {TP_BF16_RTOL:.0e}, gradients "
          f"{TP_BF16_GRAD:.0e} of the written-out bf16 step; a row's ranks bit-equal in what they replicate, a "
          f"column's in everything", flush=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    states, refs, g64, written, routes = {}, {}, {}, {}, {}
    for kind in ("largecnn", "smallcnn", "rnn"):
        model = _tp_model(torch, kind, "float32", False)
        model.reset_parameters(torch_generator(35, "params"))
        states[kind] = {k: v.clone() for k, v in model.state_dict().items()}
    dset = DeviceDataset(ArraySet(x, y, ind), torch.device("cuda"))
    for label, kind, dtype, fused, worlds in TP_CASES:
        model = _tp_model(torch, kind, dtype, fused)
        model.load_state_dict(states[kind])
        model.to("cuda")
        opt = Adam(model.parameters(), DP_LR)
        grads = _grad_recorder(opt)
        logits = []
        model.register_forward_hook(lambda _m, _a, out: logits.append(out.detach().float().cpu()))
        train = run_train_epoch(model, opt, dset, BATCH, None)
        refs[label] = {"train": train, "logits": logits[0], "grads": [g.float().cpu() for g in grads[0]],
                       "state": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
                       "names": [n for n, _ in model.named_parameters()]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_train_epoch(model, opt, dset, BATCH, None)  # a second step: the warm wall
        torch.cuda.synchronize()
        refs[label]["wall_ms"] = (time.perf_counter() - t0) * 1e3
        if dtype == "float32" and kind == "largecnn":
            _, g64[kind], routes["float64"] = largecnn_step(torch, states[kind], x, y, "float64", 1, 1)
            routes["one process"] = largecnn_step(torch, states[kind], x, y, dtype, 1, 1)[2]
            g64["largecnn, one process's routing"] = largecnn_step(torch, states[kind], x, y, "float64", 1, 1,
                                                                   routes["one process"])[1]
        elif dtype == "float32":
            g64[kind] = _tp_grads64(torch, kind, states[kind], x, y)
        for world in worlds if kind == "largecnn" else ():
            n_data = world // TP_MODEL
            w_logits, w_grads, tp_routes = largecnn_step(torch, states[kind], x, y, dtype, n_data, TP_MODEL)
            written[label, world] = {"logits": w_logits, "grads": w_grads}
            if dtype == "float32":
                written[label, world]["routed64"] = largecnn_step(torch, states[kind], x, y, "float64", n_data, 1,
                                                                  tp_routes)[1]
                k = len(tp_routes) // n_data
                whole = [torch.cat(tp_routes[i::k]) for i in range(k)]  # the data shards' rows, in order
                written[label, world]["routing"] = {
                    "row vs float64": _routing_diffs(whole, routes["float64"]),
                    "one process vs float64": _routing_diffs(routes["one process"], routes["float64"]),
                    "row vs one process": _routing_diffs(whole, routes["one process"])}
        del model, opt, grads
        torch.cuda.empty_cache()
    routes.clear()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    outs = {}
    try:
        torch.save({"state": states, "batch": (x, y, ind)}, os.path.join(tmp, "inputs.pt"))
        for world in (2, 4):
            t0 = time.perf_counter()
            ctx = mp.start_processes(_tp_rank, args=(tmp, world), nprocs=world, join=False, start_method="spawn")
            deadline = time.monotonic() + TP_TIMEOUT_S
            try:
                while not ctx.join(timeout=1):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the {world} ranks did not finish in {TP_TIMEOUT_S} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            outs[world] = [torch.load(os.path.join(tmp, f"rank{r}_of_{world}.pt"), weights_only=False)
                           for r in range(world)]
            print(f"  {world} ranks ({world // TP_MODEL} x {TP_MODEL}) spawned, stepped and joined in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    devices = {world: [out["device"] for out in ranks] for world, ranks in outs.items()}
    check(all(d == "cuda:0" for ds in devices.values() for d in ds), f"the ranks' devices: {devices}")
    for label, kind, dtype, fused, worlds in TP_CASES:
        ref = refs[label]
        names = ref["names"]
        for world in worlds:
            ranks = outs[world]
            n_data = world // TP_MODEL
            tag = f"{label}, {n_data} x {TP_MODEL}"
            w = written.get((label, world))
            for r, out in enumerate(ranks):
                res = out[label]
                d, m = out["mesh"]
                rows = np.arange(BATCH).reshape(n_data, -1)[d]
                sharded = res["sharded"]
                loss_err = abs(res["train"]["loss"] - ref["train"]["loss"]) / abs(ref["train"]["loss"])
                logit_err = _rel_err(res["logits"], ref["logits"][rows])
                grad_err = {n: _rel_err(g, _tp_block(gr, sharded, n)) for n, g, gr in zip(names, res["grads"],
                                                                                          ref["grads"])}
                same = res["train"]["mix_acc"] == ref["train"]["mix_acc"] and res["train"]["asr"] == ref["train"]["asr"]
                to_w = ""
                if w is not None:
                    w_err = {n: _rel_err(g, _tp_block(w["grads"][n], sharded, n)) for n, g in zip(names, res["grads"])}
                    w_logit = _rel_err(res["logits"], w["logits"][rows])
                    to_w = (f"; from the step written out as the ranks run it: gradients at most "
                            f"{max(w_err.values()):.1e} ({max(w_err, key=w_err.get)}), logits {w_logit:.1e}")
                if dtype == "float32":
                    own64 = {n: _rel_err(g, _tp_block(g64[kind][n], sharded, n)) for n, g in zip(names, res["grads"])}
                    one64 = {n: _rel_err(_tp_block(g, sharded, n), _tp_block(g64[kind][n], sharded, n))
                             for n, g in zip(names, ref["grads"])}
                    stat_err = max([_rel_err(res["full"][k], ref["state"][k]) for k in ref["state"] if "running" in k],
                                   default=0.0)
                    if w is None:  # the row routes every relu and max-pool tie as one process does
                        to64 = own64
                        lim = {n: min(max(DP_GRAD_RATIO * one64[n], DP_GRAD_FLOOR), DP_GRAD_CAP) for n in names}
                        judged = "from float64"
                        after = {n: ref["state"][n] for n in names}
                        ok_w = True
                    else:  # sharded convs round otherwise and move near-ties: judged on their own routing
                        to64 = {n: _rel_err(g, _tp_block(w["routed64"][n], sharded, n))
                                for n, g in zip(names, res["grads"])}
                        lim = {n: TP_ROUTED_RTOL for n in names}
                        judged = "from float64 on this step's relu and max-pool routing"
                        after = {n: _adam_first_step(states[kind][n], w["grads"][n], DP_LR) for n in names}
                        ok_w = max(w_err.values()) <= 1e-4 and w_logit <= TP_LOGITS_RTOL
                    worst = max(names, key=lambda n: to64[n] / lim[n])
                    param_err = max(float((res["full"][n] - after[n]).abs().max()) for n in names) / DP_LR
                    check(loss_err <= 1e-5 and same and logit_err <= TP_LOGITS_RTOL and to64[worst] <= lim[worst]
                          and stat_err <= 1e-4 and param_err <= 0.25 and ok_w,
                          f"{tag}, rank {r} (d {d}, m {m}) vs one process: loss {res['train']['loss']:.6f} vs "
                          f"{ref['train']['loss']:.6f} (rel {loss_err:.1e}), mix_acc {res['train']['mix_acc']:.4f} "
                          f"vs {ref['train']['mix_acc']:.4f}, asr {res['train']['asr']:.4f} vs "
                          f"{ref['train']['asr']:.4f}; logits {logit_err:.1e}; gradients {judged}, nearest its "
                          f"bound: {worst} {to64[worst]:.1e} (bound {lim[worst]:.1e}), from the one-process step at "
                          f"most {max(grad_err.values()):.1e}{to_w}; running statistics {stat_err:.1e}; parameters "
                          f"after the step {param_err:.3f} lr")
                    if r == 0:
                        print(f"  {tag}: gradients' distance from the float64 step, this rank / one process "
                              f"(relative to each tensor's largest entry): "
                              + ", ".join(f"{n} {own64[n]:.1e} / {one64[n]:.1e}" for n in names), flush=True)
                        if w is not None:
                            one_routed = g64["largecnn, one process's routing"]
                            print(f"  {tag}: from float64 on each f32 step's own relu and max-pool routing, this "
                                  f"rank / one process: "
                                  + ", ".join(f"{n} {to64[n]:.1e} / "
                                              f"{_rel_err(_tp_block(g, sharded, n), _tp_block(one_routed[n], sharded, n)):.1e}"
                                              for n, g in zip(names, ref["grads"])), flush=True)
                            print(f"  {tag}: relu and max-pool decisions (the input each passes its gradient to) "
                                  f"that differ: " + ", ".join(f"{k} {a:,} of {b:,}" for k, (a, b) in
                                                               w["routing"].items()), flush=True)
                else:
                    check(loss_err <= TP_BF16_RTOL and logit_err <= TP_BF16_RTOL
                          and max(w_err.values()) <= TP_BF16_GRAD and w_logit <= TP_BF16_RTOL,
                          f"{tag}, rank {r} vs one process (bf16): loss {res['train']['loss']:.6f} vs "
                          f"{ref['train']['loss']:.6f} (rel {loss_err:.1e}), mix_acc {res['train']['mix_acc']:.4f} vs "
                          f"{ref['train']['mix_acc']:.4f}; logits {logit_err:.1e}; gradients at most "
                          f"{max(grad_err.values()):.1e}{to_w}")
                if r == 0:
                    errs = {n: _rel_err(res["full"][n], ref["state"][n]) for n in names}
                    print(f"  {tag}: gathered parameters after the step vs one process, largest relative error "
                          f"(to each tensor's largest entry): " + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()),
                          flush=True)
            res0 = ranks[0][label]
            whole = sum(ref["state"][n].numel() for n in names) * 4 * 3  # parameters, mu, nu (f32)
            cut = sum(ref["state"][n].numel() for n in res0["sharded"]) * 4 * 3
            want = whole - cut + cut // TP_MODEL
            rank_bytes = [o[label]["bytes"] for o in ranks]
            check(all(b == want for b in rank_bytes) and cut > 0,
                  f"{tag}: parameters + Adam moments a rank {', '.join(f'{b / 1e6:.2f}' for b in rank_bytes)} MB "
                  f"against {whole / 1e6:.2f} MB replicated; sharded tensors {cut / 1e6:.2f} MB of it "
                  f"({len(res0['sharded'])}: {', '.join(res0['sharded'])}), so {want / 1e6:.2f} MB expected "
                  f"({smi})")
            unequal = set()
            for r in range(world):
                d, m = divmod(r, TP_MODEL)
                for k, v in ranks[r][label]["local"].items():
                    partners = [] if k in res0["sharded"] else [d * TP_MODEL + j for j in range(TP_MODEL)]
                    partners += [e * TP_MODEL + m for e in range(n_data)]
                    unequal |= {k for p in partners if not torch.equal(v, ranks[p][label]["local"][k])}
            check(not unequal, f"{tag}: a row's ranks bit-equal in every replicated tensor, a column's in every "
                               f"tensor (unequal: {sorted(unequal)})")
            counts = res0["collectives"]
            check(counts["gathers"] > 0, f"{tag}: a step's collectives a rank: {counts['gathers']} gathers (forward), "
                                          f"{counts['row_all_reduces']} row all-reduces (backward)")
            launches = [o[label]["launches"] for o in ranks]
            b = [lc.get("conv1_bn_pool_bwd_params", 0) for lc in launches]
            if fused:
                check(all(v > 0 for v in b), f"{tag}: kernel B launched {b} times a rank in the step "
                                             f"(block 1 replicated, local statistics)")
            print(f"  {tag}: launches a rank {launches}; step wall a rank, first and second step "
                  + "; ".join(f"rank {r} {w[0]:.1f}, {w[1]:.1f} ms" for r, w in
                              enumerate(o[label]["walls_ms"] for o in ranks))
                  + f" (one process {ref['wall_ms']:.1f} ms, second step; {smi}; gloo on one shared card)",
                  flush=True)

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from audiobd_tpu_torch.ops import KERNELS
        from audiobd_tpu_torch.ops.build import BUILD_DIR, build_all
        from audiobd_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: the audiobd_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2

    resolve_device(None)  # the entry points' settings: CUDA, TF32 off
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"phase 0: device {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"  kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{', '.join(p.name for p in libs.values())}", flush=True)
    for log in sorted(BUILD_DIR.glob("*.log")):
        for line in log.read_text(errors="replace").splitlines():
            if "Compiling entry function" in line:
                print(f"  {log.stem}: {line.split('entry function')[-1].split(' for ')[0].strip()}")
            elif "registers" in line or "spill" in line:
                print(f"  {log.stem}:   {line.strip()}")

    ctx: dict = {}
    main_rows = [*phase_mfcc(torch, ctx), *phase_conv1(torch, ctx)]
    block23_rows = phase_conv2(torch, ctx)
    bf16_rows = [*phase_conv1_bf16(torch, ctx), *phase_conv2_bf16(torch, ctx)]
    effects_rows = phase_effects(torch)
    flowmur_route, daba_route = ctx["flowmur_route"], ctx["daba_route"]
    del ctx
    torch.cuda.empty_cache()
    record_dir = tempfile.mkdtemp(prefix="chip_smoke_record_")  # phase 2's record, read again by phases 7, 10, 11
    try:
        rows = run_paths(torch, KERNELS, flowmur_route, daba_route, main_rows, block23_rows, bf16_rows, effects_rows,
                         record_dir)
    finally:
        shutil.rmtree(record_dir, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}))
    if failures:
        print(f"chip_smoke: {len(failures)} check(s) failed: {failures}", file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def run_paths(torch, kernels, flowmur_route, daba_route, main_rows, block23_rows, bf16_rows, effects_rows,
              record_dir) -> list[dict]:
    """Phases 2-13; each kernel row gets its launches from the path that runs
    it (A's FFT route and B's train mode from phase 2; phases 10-13 print
    their own). Returns the rows of the ``kernels`` line."""
    launches, main_clips, main_acc = phase_main_path(torch, kernels, record_dir)
    for row in main_rows:
        row["launches"] = launches[row["name"]]
    block23 = phase_block23_paths(torch, kernels, main_clips)
    for row in block23_rows:
        row["launches"] = block23[row["name"]]
    flowmur = phase_flowmur(torch, kernels, flowmur_route)
    for row in main_rows:
        if row["name"] == "conv1_bn_pool_bwd_input":
            row["launches"] = flowmur[row["name"]]
    bf16 = phase_bf16_paths(torch, kernels)
    for row in bf16_rows:
        # C's bf16 mode has no caller on any path (as in the reference): 0.
        row["launches"] = bf16[row["name"]]
    ultrasonic = phase_ultrasonic(torch, kernels)
    for row in main_rows:
        if row["name"] == "mfcc_bluestein":
            row["launches"] = ultrasonic[row["name"]]
    phase_ultrasonic_models(torch, kernels)
    defenses = phase_defenses(torch, kernels, record_dir)
    for row in main_rows:
        if row["name"] == "conv1_bn_pool_bwd_params_eval":
            row["launches"] = defenses[row["name"]]
    phase_serving(torch, kernels, record_dir)
    jingleback = phase_jingleback(torch, kernels)
    for row in effects_rows:
        row["launches"] = jingleback[row["name"]]
    phase_boards(torch)
    phase_daba(torch, kernels, daba_route)
    phase_restart(torch, kernels, record_dir)
    phase_dp_step(torch, kernels, record_dir)
    phase_dp_cli(torch, main_acc)
    phase_tp(torch, record_dir)
    return main_rows + block23_rows + bf16_rows + effects_rows


if __name__ == "__main__":
    sys.exit(main())
