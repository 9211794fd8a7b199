"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out from the same inputs. Each is
held to its own limit (``limits/<cell>.json``)."""

from __future__ import annotations

import math
import statistics

import torch

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a conv bias in front of BatchNorm): it is left
# out of the leaf-wise gaps.
NOUGHT_SHARE = 1e-3


def max_rel(got: list[float], ref: list[float]) -> float:
    """The widest |got − ref| / |ref| over matching entries."""
    if len(got) != len(ref):
        return math.inf
    return max(abs(g - r) / max(abs(r), 1e-30) for g, r in zip(got, ref))


def rel_max_abs(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got − ref| / max |ref|."""
    if got.shape != ref.shape:
        return math.inf
    diff = (got.double() - ref.double()).abs().max()
    return float(diff / torch.clamp(ref.double().abs().max(), min=1e-30))


def kept_leaves(ref_grad: list[torch.Tensor]) -> list[bool]:
    """Leaves whose reference gradient norm is at least NOUGHT_SHARE of the
    median leaf's."""
    norms = [float(g.double().norm()) for g in ref_grad]
    med = statistics.median(norms)
    return [n >= NOUGHT_SHARE * med for n in norms]


def leaf_gaps(got: list[torch.Tensor], ref: list[torch.Tensor], keep: list[bool]) -> list[float]:
    """Each kept leaf's |‖got‖ − ‖ref‖| over the larger of its ‖ref‖ and the
    median kept leaf's ‖ref‖."""
    pairs = [(float(g.double().norm()), float(r.double().norm())) for g, r, k in zip(got, ref, keep) if k]
    med = statistics.median(r for _, r in pairs)
    return [abs(g - r) / max(r, med, 1e-30) for g, r in pairs]


def leaf_gap(got: list[torch.Tensor], ref: list[torch.Tensor], keep: list[bool]) -> float:
    """The worst kept leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, ref, keep)) if len(got) == len(ref) else math.inf


def median_leaf_gap(got: list[torch.Tensor], ref: list[torch.Tensor], keep: list[bool]) -> float:
    """The median kept leaf's gap (``leaf_gaps``): steady from seed to seed
    where the worst leaf is a small one whose Adam steps turn on rounding."""
    return statistics.median(leaf_gaps(got, ref, keep)) if len(got) == len(ref) else math.inf


def sums_gap(got: list[list[int]], ref: list[list[int]], near_ties: list[int]) -> float:
    """The widest difference of an eval pass's metric counts beyond the
    pass's near-tie rows (whose class either side may pick)."""
    return float(max(max(abs(int(g) - int(r)) - t, 0) for gs, rs, t in zip(got, ref, near_ties)
                     for g, r in zip(gs, rs)))


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number finite and within its limit, {name: {"value", "limit"}})."""
    checks = {name: {"value": numbers.get(name, math.inf), "limit": limit} for name, limit in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
