"""Where the attack trigger assets are found (port of
audiobd_tpu/utils/assets.py).

The reference ships ``resources/Ultrasonic/trigger.wav`` (1 s mono 44.1 kHz
with >20 kHz content) and ``resources/DABA/trigger_pool/*.wav``. A genuine
asset is used when one is found; the attacks synthesize a deterministic
stand-in otherwise. Search order:

1. ``$AUDIOBD_RESOURCES`` (a directory laid out like the reference's
   ``resources/``),
2. ``resources/`` under the current working directory.

The JAX package also looks in a fixed reference checkout of its validation
fixture; the port reaches such a checkout through ``$AUDIOBD_RESOURCES``.
"""

from __future__ import annotations

import os

_KNOWN_ROOTS = ("resources",)


def resource_roots() -> list[str]:
    env = os.environ.get("AUDIOBD_RESOURCES")
    return ([env] if env else []) + list(_KNOWN_ROOTS)


def find_resource(relpath: str) -> str | None:
    """The first existing ``<root>/<relpath>`` across the search roots. A
    directory counts only if it holds at least one wav."""
    for root in resource_roots():
        path = os.path.join(root, relpath)
        if os.path.isfile(path):
            return path
        if os.path.isdir(path) and any(name.endswith(".wav") for name in os.listdir(path)):
            return path
    return None
