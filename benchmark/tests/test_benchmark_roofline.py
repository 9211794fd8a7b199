"""The frozen counts of ``roofline/`` against counts worked by hand at small
shapes, and the cells' step counts at their own shapes."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import harness
from benchmark.reference.mfcc import mel_filterbank
from benchmark.roofline import conv1_bn_pool_bwd_input as kernel_c
from benchmark.roofline import conv1_bn_pool_bwd_params as kernel_b
from benchmark.roofline import mfcc, peaks, smallcnn


def test_bound_takes_the_larger_time():
    assert peaks.bound_s(67e12, 0.0) == (1.0, "operations")
    assert peaks.bound_s(0.0, 3.35e12) == (1.0, "bytes")


def test_smallcnn_products_by_hand():
    # (8, 10) frames: conv1 → (7, 9), pool (1, 3) → (7, 3); conv2 → (6, 2), pool 2x2 pad (1, 1) → (4, 2);
    # conv3 → (3, 1), pool 2x2 pad (0, 1) → (1, 1): flatten 32.
    macs, flat = smallcnn.macs(8, 10, 3)
    assert macs == [64 * 7 * 9 * 4, 64 * 6 * 2 * 64 * 4, 32 * 3 * 1 * 64 * 4, 32 * 128, 128 * 3]
    assert flat == 32


def test_smallcnn_flatten_at_the_cells_shapes():
    assert smallcnn.macs(101, 40, 10)[1] == 3072
    assert smallcnn.macs(32, 13, 10)[1] == 224


def test_training_and_frozen_backward():
    macs, _ = smallcnn.macs(8, 10, 3)
    train = smallcnn.clip_flops(8, 10, 3, train=True, input_grad=False)
    frozen = smallcnn.clip_flops(8, 10, 3, train=False, input_grad=True)
    assert train["forward"] == 2 * sum(macs)
    assert train["backward"] == 2 * sum(macs) + 2 * sum(macs[1:])  # weights everywhere, inputs past conv1
    assert frozen["backward"] == 2 * sum(macs)  # inputs only, down to the features


def test_kernel_bounds_by_hand():
    x, g = 2 * 5 * 10, 2 * 64 * 4 * 3  # x (2, 1, 5, 10); g (2, 64, 4, 3)
    assert smallcnn.block1_shapes(2, 5, 10) == (x, g)
    assert kernel_b.call_bound_s(2, 5, 10) == pytest.approx(max(4 * (x + g + 11 * 64) / 3.35e12, 38 * g / 67e12))
    assert kernel_c.call_bound_s(2, 5, 10) == pytest.approx(max(4 * (2 * x + g + 8 * 64) / 3.35e12,
                                                                (35 * g + 3 * x) / 67e12))


def test_kernel_b_at_the_main_paths_shape():
    # x (256, 1, 101, 40) and g (256, 64, 100, 13): 89.3 MB read, bytes bound, 0.0267 ms (PERF.md's figure).
    assert kernel_b.call_bound_s(256, 101, 40) == pytest.approx(4 * (256 * 101 * 40 + 256 * 64 * 100 * 13 + 704)
                                                                / 3.35e12)
    assert kernel_b.call_bound_s(256, 101, 40) == pytest.approx(2.6668e-05, rel=1e-4)


def test_mfcc_frame_count():
    n = 8
    assert mfcc.frame_flops(n, 4, 2, 6) == n + 2.5 * n * 3 + 3 * 5 + 12 + 12 + 16
    assert mfcc.num_frames(16000, 400, 160) == 101 and mfcc.num_frames(16000, 2048, 512) == 32
    fb = mel_filterbank(16000, 2048, 128)
    assert 0 < mfcc.mel_nonzeros(fb) < fb.size and np.all(fb >= 0)
    assert math.isclose(float(fb.max()), 1.0, rel_tol=0.2)


def test_step_counts_of_each_configuration():
    train = harness.load_cell("badnets_smallcnn.train_b1024")
    work = harness.load_module("roofline", train.config_name).counts_for(train.config, train.traffic)
    macs = sum(smallcnn.macs(101, 40, 10)[0])
    assert work["eval_clip_flops"] == 2 * macs
    assert work["train_clip_flops"] == 6 * macs - 2 * 64 * 100 * 39 * 4  # no input gradient for conv1
    assert work["kernels"]["conv1_bn_pool_bwd_params"]["bound_s"] == kernel_b.call_bound_s(1024, 101, 40)
    search = harness.load_cell("flowmur_smallcnn.search_b1024")
    cfg = search.config
    work = harness.load_module("roofline", search.config_name).counts_for(cfg, search.traffic)
    nnz = mfcc.mel_nonzeros(mel_filterbank(16000, 2048, 128))
    frame = 2048 + 2.5 * 2048 * 11 + 3 * 1025 + 2 * nnz + 3 * 128 + 2 * 128 * 13
    clip = 12 * 16000 + 2 * 32 * frame + 4 * sum(smallcnn.macs(32, 13, 10)[0])
    assert work["search_step_flops"] == pytest.approx(cfg["batch_size"] * clip + 12 * 8000)
    assert work["kernels"]["conv1_bn_pool_bwd_input"]["bound_s"] == kernel_c.call_bound_s(1024, 32, 13)
