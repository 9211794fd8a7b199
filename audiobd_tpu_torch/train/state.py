"""Optimizers in optax's formulas: the adam the reference trains with
(audiobd_tpu/train/trainer.py:91-96) and the sgd with momentum its defenses
fine-tune with (audiobd_tpu/defend/ft_reg.py:204, tsbd.py:314).

An optimizer holds ``params`` (the tensors it updates in place) and takes
``step(grads)``, the gradients in the same order. ``state_dict()`` and
``load_state_dict()`` carry its state (optax's) across a restart."""

from __future__ import annotations

import torch


class Adam:
    """optax.adam(lr) with its defaults (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0) and its formula:

        mu ← (1−b1)·g + b1·mu,  nu ← (1−b2)·g² + b2·nu,  t ← t+1
        p  ← p − lr · (mu/(1−b1ᵗ)) / (√(nu/(1−b2ᵗ)) + eps)

    torch.optim.Adam divides √nu and the bias correction in another order.
    The update is in place, with multi-tensor (foreach) ops.
    """

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        self.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1.0 - b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(updates, -self.lr)
        torch._foreach_add_(self.params, updates)

    def state_dict(self) -> dict:
        """optax's ScaleByAdamState: ``mu`` and ``nu`` in parameter order, and
        ``count``, the steps taken."""
        return {"mu": list(self.mu), "nu": list(self.nu), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.mu = _placed(state["mu"], self.params)
        self.nu = _placed(state["nu"], self.params)
        self.count = int(state["count"])


class SGD:
    """optax.sgd(lr, momentum) with nesterov off: t ← g + momentum·t (t
    starting at 0), p ← p + (−lr·t). In place, with multi-tensor ops."""

    def __init__(self, params, lr: float, momentum: float = 0.9):
        self.params = list(params)
        self.lr, self.momentum = lr, momentum
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, grads)
        torch._foreach_add_(self.params, torch._foreach_mul(self.trace, -self.lr))

    def state_dict(self) -> dict:
        """optax's TraceState: ``trace`` in parameter order."""
        return {"trace": list(self.trace)}

    def load_state_dict(self, state: dict) -> None:
        self.trace = _placed(state["trace"], self.params)


def _placed(tensors: list[torch.Tensor], params: list[torch.Tensor]) -> list[torch.Tensor]:
    """Copies of ``tensors`` on their parameters' devices, in their dtypes;
    a shape that differs from its parameter's raises."""
    if len(tensors) != len(params):
        raise ValueError(f"optimizer state holds {len(tensors)} tensors for {len(params)} parameters")
    out = []
    for t, p in zip(tensors, params):
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"optimizer state tensor shaped {tuple(t.shape)} for a parameter {tuple(p.shape)}")
        out.append(t.detach().to(device=p.device, dtype=p.dtype, copy=True))
    return out
