"""CSV metric logging with the reference's file/column contract
(audiobd_tpu/utils/logging.py): ``loss_result.csv`` and ``acc_result.csv``
under ``record/<result>/``; a defense's CSVs get their rows first and the
header prepended last, as the reference's add_csv_head does. Also the
record's other small writers (an npy, a removal). Rank 0 alone runs each."""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np

from audiobd_tpu_torch.parallel.distributed import main_rank_only


@main_rank_only
def write_csv(path: str, header: Sequence[str], rows: Sequence[Sequence]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(rows)


@main_rank_only
def append_csv_row(path: str, row: Sequence) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a", newline="") as f:
        csv.writer(f).writerow(row)


@main_rank_only
def prepend_csv_header(path: str, header: Sequence[str]) -> None:
    """The reference's add_csv_head (fp.py:78-85): ``header`` above the rows
    already written."""
    with open(path, newline="") as f:
        lines = list(csv.reader(f))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(lines)


@main_rank_only
def save_npy(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, arr)


@main_rank_only
def remove_file(path: str) -> None:
    """Remove ``path`` where it exists (a CSV a defense starts afresh)."""
    if os.path.exists(path):
        os.remove(path)


def save_attack_csvs(record_dir: str, history: dict[str, list]) -> None:
    """loss_result.csv + acc_result.csv, reference column order."""
    write_csv(
        os.path.join(record_dir, "loss_result.csv"),
        ["train_loss", "test_clean_loss", "test_bd_loss"],
        list(zip(history["train_loss"], history["test_clean_loss"], history["test_bd_loss"])),
    )
    write_csv(
        os.path.join(record_dir, "acc_result.csv"),
        ["train_acc", "train_asr", "test_clean_acc", "test_asr"],
        list(
            zip(
                history["train_mix_acc"],
                history["train_asr"],
                history["test_clean_acc"],
                history["test_asr"],
            )
        ),
    )
