"""Counts of ``badnets_ast``: AST on (101, 128) log-mel frames padded to 128,
ten classes; a training clip is its forward and the gradients a training step
produces, an eval clip its forward; the forward attention's least time a
call at the training batch."""

from __future__ import annotations

from benchmark.roofline import ast, ast_attention


def counts_for(cfg: dict, traffic: dict) -> dict:
    w, n_mels, classes = cfg["widths"], cfg["dsp"]["n_mels"], cfg["num_classes"]
    flops = ast.clip_flops(n_mels, w, classes)
    _, t = ast.tokens(n_mels, w["input_tdim"], w["patch"], w["stride"])
    bound, by = ast_attention.call_bound(cfg["batch_size"], t, w["heads"], w["dim"] // w["heads"])
    return {
        "train_clip_flops": flops["forward"] + flops["backward"],
        "eval_clip_flops": flops["forward"],
        "attention": {"span": ast_attention.SPAN, "bound_s": bound, "bound_by": by},
    }
