"""PyTorch/CUDA port of audiobd_tpu (audio backdoor attacks and defenses).

The JAX package ``audiobd_tpu`` is the reference; this package runs the same
pipeline on an NVIDIA GPU with hand-written CUDA kernels (``csrc/``) where the
reference has Pallas kernels. It imports nothing of JAX or of ``audiobd_tpu``.

Entry point: ``python -m audiobd_tpu_torch badnets --synthetic ...``.
"""
